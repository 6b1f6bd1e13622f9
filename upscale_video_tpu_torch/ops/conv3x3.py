"""K4: one SAME 3x3 conv + bias + activation — CUDA kernel wrapper + plain version.

Port of ``upscale_video_tpu/ops/conv_pallas.py:56-199`` (``_kernel`` /
``conv3x3_fused`` / ``conv3x3_fused_batch``).  ``x`` is a plain
``(N, H, W, cin)`` NHWC batch and one launch covers all of it (the JAX
package unrolls ``conv3x3_fused`` per frame); the frame's zero border is
predicated inside the kernel, so no padded copy is made.  Products are
bf16 with an f32 sum; bias and the activation are applied in f32 and the
result rounds once to ``out_dtype``.

``act`` is one of :mod:`~upscale_video_tpu_torch.ops.common`'s codes:
``ACT_PRELU`` takes a ``(cout,)`` slope tensor, ``ACT_LEAKY`` one slope as
a float, ``ACT_NONE``/``ACT_RELU`` none.

:func:`conv3x3_fused` dispatches on the input's device: a CPU tensor takes
:func:`conv3x3_fused_plain`; a CUDA tensor launches the kernel in
``csrc/conv3x3_fused.cu`` or raises.  ``conv3x3_fused.launches`` counts
kernel launches (one per call).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import no_tf32, oihw

MAX_CIN = 512
MAX_COUT = 256
OUT_DTYPES = (torch.bfloat16, torch.float32)

Slope = Optional[Union[float, torch.Tensor]]


def _check(x, wmat, bias, slope, act, out_dtype) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if wmat.ndim != 2 or wmat.shape[0] != 9 * cin:
        raise ValueError(f"wmat {tuple(wmat.shape)} is not (9*{cin}, cout)")
    cout = wmat.shape[1]
    if not (0 < cin <= MAX_CIN and 0 < cout <= MAX_COUT):
        raise ValueError(f"{cin} -> {cout} channels outside the kernel's "
                         f"1..{MAX_CIN} -> 1..{MAX_COUT}")
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({cout},)")
    if act not in (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU):
        raise ValueError(f"unknown activation {act}")
    if act == ACT_PRELU and (not torch.is_tensor(slope)
                             or tuple(slope.shape) != (cout,)):
        raise ValueError(f"PReLU takes a ({cout},) slope tensor")
    if act == ACT_LEAKY and not isinstance(slope, (int, float)):
        raise ValueError("leaky ReLU takes its slope as a float")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {OUT_DTYPES}")


def conv3x3_fused_plain(x: torch.Tensor, wmat: torch.Tensor,
                        bias: torch.Tensor, slope: Slope = None,
                        act: int = ACT_NONE,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of K4: ``F.conv2d`` in f32 (TF32 off) over
    bf16-rounded ``x`` and ``wmat``, + bias, the activation in f32, one
    rounding to ``out_dtype``."""
    _check(x, wmat, bias, slope, act, out_dtype)
    xin = x.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    with no_tf32():
        y = F.conv2d(xin, oihw(wmat.to(torch.bfloat16)), padding=1)
    y = y.permute(0, 2, 3, 1) + bias.to(torch.float32)
    if act == ACT_RELU:
        y = torch.clamp_min(y, 0.0)
    elif act == ACT_PRELU:
        y = torch.where(y >= 0, y, y * slope.to(torch.float32))
    elif act == ACT_LEAKY:
        y = torch.where(y >= 0, y, y * float(slope))
    return y.to(out_dtype).contiguous()


def conv3x3_fused(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
                  slope: Slope = None, act: int = ACT_NONE,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME 3x3 stride-1 conv + bias + activation over ``x`` ``(N, H, W,
    cin)``; ``wmat`` ``(9*cin, cout)`` with rows in (dy, dx, cin) order,
    ``bias`` ``(cout,)`` f32.  Returns ``(N, H, W, cout)`` in
    ``out_dtype``."""
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, wmat, bias, slope, act, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused: unsupported device {x.device}")
    _check(x, wmat, bias, slope, act, out_dtype)
    tensors = [("x", x, torch.bfloat16), ("wmat", wmat, torch.bfloat16),
               ("bias", bias, torch.float32)]
    if act == ACT_PRELU:
        tensors.append(("slope", slope, torch.float32))
    for name, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"conv3x3_fused: {name} must be {dt}, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv3x3_fused: {name} must be contiguous on {x.device}")
        if name in ("x", "wmat") and t.data_ptr() % 16:  # 16-byte vector loads
            raise ValueError(f"conv3x3_fused: {name} is not 16-byte aligned")
    from upscale_video_tpu_torch.kernels import build

    n, h, w, cin = x.shape
    cout = wmat.shape[1]
    out = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    lib = build.library()
    code = lib.uvt_conv3x3_fused(
        x.data_ptr(), out.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
        slope.data_ptr() if act == ACT_PRELU else None,
        float(slope) if act == ACT_LEAKY else 0.0,
        n, h, w, cin, cout, act, int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "conv3x3_fused launch")
    conv3x3_fused.launches += 1
    return out


conv3x3_fused.launches = 0
