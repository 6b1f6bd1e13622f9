"""K8: the int8 bordered SAME-3x3 conv stack — CUDA kernel wrapper + plain
version.

Port of ``upscale_video_tpu/ops/conv_chain_q8.py``.  Activations live in
K1's bordered NHWC layout as **int8** (symmetric, zero-point 0, so the zero
ring is exact conv padding) at the layers' real widths; each layer is an
int8 x int8 -> int32 conv, then an f32 epilogue ``y * scale + bias``
(``scale`` per output channel, ``s_in * s_w``), the activation, and either
the requantisation ``clip(round_half_even(y * inv_out), -127, 127)`` to the
next layer's int8 or, for the last layer, bf16.

:func:`conv3x3_chain_q8` dispatches on the input's device: a CPU tensor
takes :func:`conv3x3_chain_q8_plain` (also the port's :func:`q8_oracle`); a
CUDA tensor launches the kernel in ``csrc/conv_chain_q8.cu`` or raises.
``conv3x3_chain_q8.launches`` counts kernel launches (one per layer per
call).  Unlike the JAX helper, the input is not lane-padded to 128
channels.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import (
    check_layers, embed, per_channel, run_bordered,
)


class Q8ChainLayer(NamedTuple):
    wmat: torch.Tensor     # (9*cin, cout) int8, rows in (dy, dx, cin) order
    scale: torch.Tensor    # (cout,) f32: s_in * s_w (per-channel dequant)
    bias: torch.Tensor     # (cout,) f32 (applied after the dequant)
    slope: torch.Tensor    # (cout,) f32 PReLU slopes, the leaky slope
                           # broadcast, or zeros
    inv_out: float         # 1 / s_out of this layer's int8 output
    act: int               # ACT_NONE / ACT_PRELU / ACT_LEAKY / ACT_RELU

    @property
    def cin(self) -> int:
        return self.wmat.shape[0] // 9

    @property
    def cout(self) -> int:
        return self.wmat.shape[1]


def make_q8_layer(wq, scale, bias=None, slope=None, inv_out=1.0,
                  act: int = ACT_NONE,
                  device: "torch.device | str" = "cpu") -> Q8ChainLayer:
    """A :class:`Q8ChainLayer` from numpy/tensor fields: ``wq`` int8 HWIO
    (3, 3, cin, cout) or pre-flattened (9*cin, cout); ``scale`` per-cout or
    scalar."""
    w = torch.as_tensor(np.asarray(wq, dtype=np.int8))
    if w.ndim == 4:
        kh, kw, cin, cout = w.shape
        if (kh, kw) != (3, 3):
            raise ValueError(f"unsupported q8 chain weight shape {tuple(w.shape)}")
        w = w.reshape(9 * cin, cout)
    if w.ndim != 2 or w.shape[0] % 9:
        raise ValueError(f"unsupported q8 chain weight shape {tuple(w.shape)}")
    cout = w.shape[1]
    return Q8ChainLayer(w.to(device).contiguous(),
                        per_channel(np.asarray(scale, np.float32), cout, device),
                        per_channel(bias, cout, device),
                        per_channel(slope, cout, device),
                        float(np.float32(inv_out)), int(act))


def q8_layers_from_jax(layer_dicts, device: "torch.device | str" = "cpu"
                       ) -> List[Q8ChainLayer]:
    """The JAX ``conv3x3_chain_q8`` layer dicts (``wq``, ``scale``, optional
    ``bias``/``slope``, ``inv_out``, ``act``) as :class:`Q8ChainLayer` s."""
    return [make_q8_layer(d["wq"], d["scale"], d.get("bias"), d.get("slope"),
                          d.get("inv_out", 1.0), int(d.get("act", ACT_NONE)),
                          device=device)
            for d in layer_dicts]


def _check(x8: torch.Tensor, layers: Sequence[Q8ChainLayer]) -> None:
    if x8.dtype != torch.int8:
        raise ValueError(f"conv3x3_chain_q8 expects int8 input, got {x8.dtype}")
    if x8.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C), got {tuple(x8.shape)}")
    for i, l in enumerate(layers):
        if l.wmat.dtype != torch.int8 or l.wmat.ndim != 2 or l.wmat.shape[0] % 9:
            raise ValueError(f"layer {i}: wmat must be (9*cin, cout) int8")
        for t in (l.scale, l.bias, l.slope):
            if t.shape != (l.cout,) or t.dtype != torch.float32:
                raise ValueError(f"layer {i}: scale/bias/slope must be "
                                 f"({l.cout},) float32")
    check_layers(layers, x8.shape[-1])


def _epilogue(y: torch.Tensor, layer: Q8ChainLayer) -> torch.Tensor:
    """int32 NCHW conv sums -> the activated f32 values, step for step as
    ``conv_chain_q8.py:119-126``: dequant multiply, bias add, activation."""
    yf = y.to(torch.float32) * layer.scale.view(1, -1, 1, 1)
    yf = yf + layer.bias.view(1, -1, 1, 1)
    if layer.act == ACT_RELU:
        return torch.clamp_min(yf, 0.0)
    if layer.act == ACT_LEAKY:
        return torch.where(yf >= 0, yf, yf * layer.slope[0])
    if layer.act == ACT_PRELU:
        return torch.where(yf >= 0, yf, yf * layer.slope.view(1, -1, 1, 1))
    return yf


def requantize(yf: torch.Tensor, inv_out: float) -> torch.Tensor:
    """f32 -> int8: round half to even, then saturate at +-127."""
    q = torch.round(yf * inv_out)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def conv3x3_chain_q8_plain(x8: torch.Tensor,
                           layers: Sequence[Q8ChainLayer]) -> torch.Tensor:
    """The plain PyTorch version of K8 and the port's integer oracle.  The
    integer conv is an f64 ``F.conv2d`` of the int8 values cast to int32:
    exact, since every product is at most 127^2 and |sum| < 9*128*127^2 <
    2^53 (f32 is not: the sum passes 2^24 at cin 128; TF32 does not touch
    f64).  Returns ``(N, H, W, cout_last)`` bf16."""
    _check(x8, layers)
    y8 = x8.permute(0, 3, 1, 2)
    last = len(layers) - 1
    for idx, l in enumerate(layers):
        w = l.wmat.to(torch.float64).reshape(3, 3, l.cin, l.cout)
        y = F.conv2d(y8.to(torch.float64), w.permute(3, 2, 0, 1), padding=1)
        yf = _epilogue(y.to(torch.int32), l)
        if idx < last:
            y8 = requantize(yf, l.inv_out)
        else:
            out = yf.to(torch.bfloat16)
    return out.permute(0, 2, 3, 1).contiguous()


q8_oracle = conv3x3_chain_q8_plain


def _check_cuda(x8: torch.Tensor, layers: Sequence[Q8ChainLayer]) -> None:
    for i, l in enumerate(layers):
        for t in (l.wmat, l.scale, l.bias, l.slope):
            if t.device != x8.device:
                raise ValueError(f"layer {i}: tensor on {t.device}, input on {x8.device}")
            if not t.is_contiguous():
                raise ValueError(f"layer {i}: tensors must be contiguous")


def launch_q8_layer(src: torch.Tensor, dst: torch.Tensor,
                    layer: Q8ChainLayer) -> None:
    """One K8 launch: bordered int8 ``src`` -> interior of bordered ``dst``
    (int8 to requantise, bf16 for the last layer; its ring must be zero)
    on the current stream."""
    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, cin = src.shape
    if (dst.shape != (n, hp, wp, layer.cout) or cin != layer.cin
            or not src.is_contiguous() or not dst.is_contiguous()
            or src.dtype != torch.int8
            or dst.dtype not in (torch.int8, torch.bfloat16)):
        raise ValueError(
            f"bordered buffers {tuple(src.shape)}/{src.dtype} -> "
            f"{tuple(dst.shape)}/{dst.dtype} do not fit layer "
            f"{layer.cin}->{layer.cout} (contiguous int8 -> int8|bf16)")
    lib = build.library()
    code = lib.uvt_conv3x3_chain_q8_layer(
        src.data_ptr(), dst.data_ptr(), layer.wmat.data_ptr(),
        layer.scale.data_ptr(), layer.bias.data_ptr(), layer.slope.data_ptr(),
        layer.inv_out, n, hp - 2, wp - 2, layer.cin, layer.cout, layer.act,
        int(dst.dtype == torch.int8),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    build.check(code, "conv3x3_chain_q8 layer launch")
    conv3x3_chain_q8.launches += 1


def conv3x3_chain_q8(x8: torch.Tensor,
                     layers: Sequence[Q8ChainLayer]) -> torch.Tensor:
    """Run a quantised stack of SAME 3x3 convs over int8 ``x8``
    ``(N, H, W, cin)``, already quantised to the first layer's input scale.
    Returns ``(N, H, W, cout_last)`` bf16: the last layer leaves the int8
    domain so its consumer keeps full precision."""
    if x8.device.type == "cpu":
        return conv3x3_chain_q8_plain(x8, layers)
    if x8.device.type != "cuda":
        raise ValueError(f"conv3x3_chain_q8: unsupported device {x8.device}")
    _check(x8, layers)
    _check_cuda(x8, layers)
    h, w = x8.shape[1:3]
    dtypes = [torch.int8] * (len(layers) - 1) + [torch.bfloat16]
    out = run_bordered(embed(x8, torch.int8), layers, launch_q8_layer, dtypes)
    return out[:, 1:h + 1, 1:w + 1, :].contiguous()


conv3x3_chain_q8.launches = 0
