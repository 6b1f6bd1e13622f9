"""K4: one SAME 3x3 conv + bias + activation — CUDA kernel wrappers + plain version.

Port of ``upscale_video_tpu/ops/conv_pallas.py:56-199`` (``_kernel`` /
``conv3x3_fused`` / ``conv3x3_fused_batch``).  ``x`` is a plain
``(N, H, W, cin)`` NHWC batch and one launch covers all of it (the JAX
package unrolls ``conv3x3_fused`` per frame); the frame's zero border is
made inside the kernel, so no padded copy is made.  Products are bf16
with an f32 sum; bias and the activation are applied in f32 and the
result rounds once to ``out_dtype``.

``act`` is one of :mod:`~upscale_video_tpu_torch.ops.common`'s codes:
``ACT_PRELU`` takes a ``(cout,)`` slope tensor, ``ACT_LEAKY`` one slope as
a float, ``ACT_NONE``/``ACT_RELU`` none.

Channel slices: ``x`` may be a channel view ``buf[..., a:a+cin]`` of a
contiguous NHWC buffer, and with ``out=`` the result is written to
channels ``[out_off, out_off+cout)`` of a contiguous NHWC buffer (its
other channels untouched) and that view is returned.  An ESRGAN dense
block so runs on one shared buffer (``models/executor.py``).

:func:`conv3x3_fused` dispatches on the input's device: a CPU tensor takes
:func:`conv3x3_fused_plain`; a CUDA tensor launches a kernel or raises.
The kernel is chosen by shape alone (:func:`sm90_takes`): bf16 output with
cin a multiple of 32 in 32..192 and cout a multiple of 16 runs the
persistent TMA + wgmma kernel in ``csrc/conv3x3_fused_sm90.cu``, which
reads and writes the slices in place; every other call the WMMA kernel in
``csrc/conv3x3_fused.cu``, on a contiguous copy of a sliced input.
``conv3x3_fused.launches`` counts kernel launches (one per call),
``conv3x3_fused.launches_sm90`` those on the sm90 kernel.
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
SM90_MAX_CIN = 192  # three 64-channel slices: a 32-wide chunk's weights
                    # (110,592 B) beside four halo parts
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


def _check_out(out, x, cout, out_off, out_dtype) -> None:
    """``out`` must be a contiguous ``(N, H, W, C)`` buffer of ``out_dtype``
    on ``x``'s device with room for ``cout`` channels at ``out_off``."""
    if (out.ndim != 4 or tuple(out.shape[:3]) != tuple(x.shape[:3])
            or not 0 <= out_off <= out.shape[-1] - cout):
        raise ValueError(f"out {tuple(out.shape)} has no channels "
                         f"[{out_off}, {out_off + cout}) for x {tuple(x.shape)}")
    if out.dtype != out_dtype or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {out_dtype} buffer on {x.device}")


def _deliver(y: torch.Tensor, out: Optional[torch.Tensor], out_off: int):
    """``y`` itself, or ``y`` written to its channel slice of ``out`` and
    that view."""
    if out is None:
        return y
    view = out[..., out_off:out_off + y.shape[-1]]
    view.copy_(y)
    return view


def conv3x3_fused_plain(x: torch.Tensor, wmat: torch.Tensor,
                        bias: torch.Tensor, slope: Slope = None,
                        act: int = ACT_NONE,
                        out_dtype: torch.dtype = torch.bfloat16,
                        out: Optional[torch.Tensor] = None,
                        out_off: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K4: ``F.conv2d`` in f32 (TF32 off) over
    bf16-rounded ``x`` and ``wmat``, + bias, the activation in f32, one
    rounding to ``out_dtype``; written to ``out``'s channel slice when
    ``out`` is given (see :func:`conv3x3_fused`)."""
    _check(x, wmat, bias, slope, act, out_dtype)
    if out is not None:
        _check_out(out, x, wmat.shape[1], out_off, out_dtype)
    xin = x.to(torch.bfloat16).to(torch.float32).contiguous().permute(0, 3, 1, 2)
    with no_tf32():
        y = F.conv2d(xin, oihw(wmat.to(torch.bfloat16)), padding=1)
    y = y.permute(0, 2, 3, 1) + bias.to(torch.float32)
    if act == ACT_RELU:
        y = torch.clamp_min(y, 0.0)
    elif act == ACT_PRELU:
        y = torch.where(y >= 0, y, y * slope.to(torch.float32))
    elif act == ACT_LEAKY:
        y = torch.where(y >= 0, y, y * float(slope))
    return _deliver(y.to(out_dtype).contiguous(), out, out_off)


def sm90_takes(cin: int, cout: int, out_dtype: torch.dtype) -> bool:
    """Whether a K4 call runs on the sm90 kernel: bf16 output, cin a
    multiple of 32 in 32..192 (whole or half 64-channel slices, the
    weights of a 32-wide cout chunk resident), cout a multiple of 16 up to
    256 (``csrc/conv3x3_fused_sm90.cu``).  The 3- and 12-channel heads and
    f32 output stay on the WMMA kernel."""
    return (out_dtype == torch.bfloat16 and cin % 32 == 0
            and 32 <= cin <= SM90_MAX_CIN and cout % 16 == 0
            and 16 <= cout <= MAX_COUT)


def _pixel_stride(x: torch.Tensor) -> int:
    """The channel count of the contiguous NHWC buffer ``x`` is a channel
    view of (its pixel stride); raises for any other layout."""
    n, h, w, cin = x.shape
    c = x.stride(2)
    if (x.stride(3) != 1 or c < cin or (h > 1 and x.stride(1) != w * c)
            or (n > 1 and x.stride(0) != h * w * c)):
        raise ValueError(f"conv3x3_fused: x {tuple(x.shape)} with strides "
                         f"{x.stride()} is no channel view of an NHWC buffer")
    return c


def conv3x3_fused(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
                  slope: Slope = None, act: int = ACT_NONE,
                  out_dtype: torch.dtype = torch.bfloat16,
                  out: Optional[torch.Tensor] = None,
                  out_off: int = 0) -> torch.Tensor:
    """SAME 3x3 stride-1 conv + bias + activation over ``x`` ``(N, H, W,
    cin)``, which may be a channel view of a contiguous NHWC buffer;
    ``wmat`` ``(9*cin, cout)`` with rows in (dy, dx, cin) order, ``bias``
    ``(cout,)`` f32.  Returns ``(N, H, W, cout)`` in ``out_dtype``; with
    ``out`` (a contiguous ``(N, H, W, C)`` buffer) the result goes to its
    channels ``[out_off, out_off+cout)`` and that view is returned."""
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, wmat, bias, slope, act, out_dtype, out,
                                   out_off)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused: unsupported device {x.device}")
    _check(x, wmat, bias, slope, act, out_dtype)
    cin, cout = wmat.shape[0] // 9, wmat.shape[1]
    if out is not None:
        _check_out(out, x, cout, out_off, out_dtype)
    c_in_total = _pixel_stride(x)
    tensors = [("wmat", wmat, torch.bfloat16), ("bias", bias, torch.float32)]
    if act == ACT_PRELU:
        tensors.append(("slope", slope, torch.float32))
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_fused: x must be bfloat16, got {x.dtype}")
    for name, t, dt in tensors:
        if t.dtype != dt:
            raise TypeError(f"conv3x3_fused: {name} must be {dt}, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv3x3_fused: {name} must be contiguous on {x.device}")
    sm90 = sm90_takes(cin, cout, out_dtype)
    if not sm90:  # the WMMA kernel reads and writes whole NHWC tensors
        x = x.contiguous()
    for name, t in (("x", x), ("wmat", wmat)):
        if t.data_ptr() % 16:  # 16-byte vector loads
            raise ValueError(f"conv3x3_fused: {name} is not 16-byte aligned")
    from upscale_video_tpu_torch.kernels import build

    n, h, w, _ = x.shape
    lib = build.library()
    slope_ptr = slope.data_ptr() if act == ACT_PRELU else None
    leaky = float(slope) if act == ACT_LEAKY else 0.0
    if sm90:
        dst = out if out is not None else torch.empty(
            (n, h, w, cout), dtype=out_dtype, device=x.device)
        c_out_total = dst.shape[-1]
        if c_in_total % 8 or c_out_total % 8 or out_off % 8 or dst.data_ptr() % 16:
            raise ValueError(
                f"conv3x3_fused: the sm90 kernel takes 16-byte aligned pixels "
                f"and slices (in stride {c_in_total}, out stride {c_out_total}, "
                f"offset {out_off})")
        build.launch(
            lib.uvt_conv3x3_fused_sm90, x.device, "conv3x3_fused sm90 launch",
            x.data_ptr(), dst.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
            slope_ptr, leaky, n, h, w, cin, c_in_total, cout, c_out_total,
            out_off, act)
        y = dst if out is None else out[..., out_off:out_off + cout]
    else:
        y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
        build.launch(
            lib.uvt_conv3x3_fused, x.device, "conv3x3_fused launch",
            x.data_ptr(), y.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
            slope_ptr, leaky, n, h, w, cin, cout, act,
            int(out_dtype == torch.float32))
        y = _deliver(y, out, out_off)
    conv3x3_fused.launches += 1
    conv3x3_fused.launches_sm90 += sm90
    return y


conv3x3_fused.launches = 0
conv3x3_fused.launches_sm90 = 0
