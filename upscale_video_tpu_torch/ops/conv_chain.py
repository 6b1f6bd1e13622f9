"""K1: the bordered SAME-3x3 conv stack — CUDA kernel wrapper + plain version.

Port of ``upscale_video_tpu/ops/conv_chain.py:61-259``.  The activations of
the whole stack live in bordered bf16 NHWC buffers ``(N, H+2, W+2, C)``
whose one-pixel ring is zero: the input is embedded once, each layer is
one kernel launch over the whole frame batch that writes only the
interior of a ring-zeroed output buffer, and two buffers per width
alternate.  With ``crop=False`` the last bordered buffer goes straight to
the tail kernel (:mod:`upscale_video_tpu_torch.ops.tail`).

:func:`conv3x3_chain` dispatches on the input's device: a CPU tensor takes
:func:`conv3x3_chain_plain`; a CUDA tensor launches the kernel in
``csrc/conv3x3_chain.cu`` or raises.  ``conv3x3_chain.launches`` counts
kernel launches (one per layer per call).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)

MAX_CHANNELS = 128


class ChainLayer(NamedTuple):
    wmat: torch.Tensor   # (9*cin, cout), rows in (dy, dx, cin) order; bf16
                         # on the kernel path, the compute dtype otherwise
    bias: torch.Tensor   # (cout,) f32
    slope: torch.Tensor  # (cout,) f32: PReLU slopes, or the leaky slope
                         # broadcast; zeros when unused
    act: int             # ACT_NONE / ACT_PRELU / ACT_LEAKY / ACT_RELU

    @property
    def cin(self) -> int:
        return self.wmat.shape[0] // 9

    @property
    def cout(self) -> int:
        return self.wmat.shape[1]


def make_layer(weight_hwio, bias=None, slope=None, act: int = ACT_NONE,
               dtype: torch.dtype = torch.bfloat16,
               device: "torch.device | str" = "cpu") -> ChainLayer:
    """A :class:`ChainLayer` from numpy/tensor HWIO weights (the JAX
    ``conv3x3_chain`` layer-dict fields)."""
    w = torch.as_tensor(weight_hwio, dtype=torch.float32)
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"3x3 weights expected, got {tuple(w.shape)}")
    wmat = w.reshape(9 * cin, cout).to(device=device, dtype=dtype).contiguous()
    return ChainLayer(wmat, per_channel(bias, cout, device),
                      per_channel(slope, cout, device), int(act))


def per_channel(v, cout: int, device: "torch.device | str" = "cpu"
                ) -> torch.Tensor:
    """A contiguous ``(cout,)`` f32 tensor from ``None`` (zeros), a scalar
    or one value (broadcast, as the leaky slope is), or ``cout`` values."""
    t = (torch.zeros(cout) if v is None
         else torch.as_tensor(v, dtype=torch.float32).reshape(-1))
    t = t.expand(cout) if t.numel() == 1 else t.reshape(cout)
    return t.to(device=device, dtype=torch.float32).contiguous()


@contextlib.contextmanager
def no_tf32():
    """Full-f32 convolutions for the plain versions: cuDNN's TF32 default
    would blur a kernel-vs-plain comparison on the card."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def apply_act(y: torch.Tensor, layer, cdim: int) -> torch.Tensor:
    """A layer's activation in f32 along channel dim ``cdim`` (its slope
    per channel, the leaky slope broadcast)."""
    if layer.act == ACT_RELU:
        return torch.clamp_min(y, 0.0)
    if layer.act in (ACT_PRELU, ACT_LEAKY):
        shape = [1] * y.ndim
        shape[cdim] = -1
        return torch.where(y >= 0, y, y * layer.slope.view(shape))
    return y


def oihw(wmat: torch.Tensor) -> torch.Tensor:
    """(9*cin, cout) -> float32 OIHW for ``F.conv2d``."""
    cin, cout = wmat.shape[0] // 9, wmat.shape[1]
    return wmat.to(torch.float32).reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def _check_layers(layers: Sequence[ChainLayer], cin0: int) -> None:
    for i, l in enumerate(layers):
        if l.wmat.ndim != 2 or l.wmat.shape[0] % 9:
            raise ValueError(f"layer {i}: wmat {tuple(l.wmat.shape)} is not (9*cin, cout)")
    check_layers(layers, cin0)


def check_layers(layers: Sequence, cin0: int) -> None:
    """What every bordered chain's layers must satisfy (their weight shapes
    checked first): channels chain from ``cin0`` within 1..128, a known
    activation, ``(cout,)`` bias and slope."""
    if not layers:
        raise ValueError("empty conv chain")
    prev = cin0
    for i, l in enumerate(layers):
        if l.cin != prev:
            raise ValueError(f"layer {i}: cin {l.cin} != incoming {prev}")
        if not (0 < l.cin <= MAX_CHANNELS and 0 < l.cout <= MAX_CHANNELS):
            raise ValueError(f"layer {i}: {l.cin}->{l.cout} channels "
                             f"outside 1..{MAX_CHANNELS}")
        if l.act not in (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU):
            raise ValueError(f"layer {i}: unknown activation {l.act}")
        if l.bias.shape != (l.cout,) or l.slope.shape != (l.cout,):
            raise ValueError(f"layer {i}: bias/slope must be ({l.cout},)")
        prev = l.cout


def conv3x3_chain_plain(x: torch.Tensor, layers: Sequence[ChainLayer],
                        crop: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K1, same rounding points: the input
    rounds to the compute dtype (``wmat``'s dtype) once, then every layer
    computes its conv in f32 (``F.conv2d``, TF32 off), adds bias, applies
    the activation in f32, and rounds once to the compute dtype.  Returns
    ``(N, H, W, cout)`` or, with ``crop=False``, the bordered
    ``(N, H+2, W+2, cout)`` layout the kernel path hands to the tail."""
    _check_layers(layers, x.shape[-1])
    dt = layers[0].wmat.dtype
    y = x.to(dt).permute(0, 3, 1, 2)  # NCHW view of the NHWC frames
    with no_tf32():
        for l in layers:
            z = F.conv2d(y.to(torch.float32), oihw(l.wmat), padding=1)
            z = apply_act(z + l.bias.view(1, -1, 1, 1), l, 1)
            y = z.to(dt)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y if crop else F.pad(y, (0, 0, 1, 1, 1, 1))


def check_cuda(x: torch.Tensor, layers: Sequence,
               weights: Sequence[torch.Tensor]) -> None:
    """The bf16 chain kernels' inputs: ``x`` (N, H, W, C) bf16; each
    layer's weight (``weights[i]``) bf16, its bias and slope f32, all
    contiguous on ``x``'s device."""
    if x.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA conv chain takes bf16 input, got {x.dtype}")
    for i, (l, wt) in enumerate(zip(layers, weights)):
        if wt.dtype != torch.bfloat16:
            raise TypeError(f"layer {i}: weights must be bf16, got {wt.dtype}")
        if l.bias.dtype != torch.float32 or l.slope.dtype != torch.float32:
            raise TypeError(f"layer {i}: bias/slope must be float32")
        for t in (wt, l.bias, l.slope):
            if t.device != x.device:
                raise ValueError(f"layer {i}: tensor on {t.device}, input on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"layer {i}: tensors must be contiguous")


def launch_chain_layer(src: torch.Tensor, dst: torch.Tensor,
                       layer: ChainLayer) -> None:
    """One K1 launch: bordered ``src`` -> interior of bordered ``dst``
    (whose ring must be zero) on the current stream."""
    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, cin = src.shape
    if (dst.shape != (n, hp, wp, layer.cout) or cin != layer.cin
            or not src.is_contiguous() or not dst.is_contiguous()
            or src.dtype != torch.bfloat16 or dst.dtype != torch.bfloat16):
        raise ValueError(
            f"bordered buffers {tuple(src.shape)}/{src.dtype} -> "
            f"{tuple(dst.shape)}/{dst.dtype} do not fit layer "
            f"{layer.cin}->{layer.cout} (contiguous bf16 required)")
    lib = build.library()
    code = lib.uvt_conv3x3_chain_layer(
        src.data_ptr(), dst.data_ptr(), layer.wmat.data_ptr(),
        layer.bias.data_ptr(), layer.slope.data_ptr(),
        n, hp - 2, wp - 2, layer.cin, layer.cout, layer.act,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    build.check(code, "conv3x3_chain layer launch")
    conv3x3_chain.launches += 1


def embed(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16
          ) -> torch.Tensor:
    """(N, H, W, C) -> ring-zeroed bordered (N, H+2, W+2, C) of ``dtype``."""
    n, h, w, c = x.shape
    buf = torch.zeros((n, h + 2, w + 2, c), dtype=dtype, device=x.device)
    buf[:, 1:h + 1, 1:w + 1, :] = x
    return buf


def run_bordered(src: torch.Tensor, layers: Sequence,
                 launch: Callable[[torch.Tensor, torch.Tensor, object], None],
                 dtypes: Optional[Sequence[torch.dtype]] = None
                 ) -> torch.Tensor:
    """Launch each layer from bordered ``src`` into a ring-zeroed bordered
    buffer of its width and ``dtypes[i]`` (bf16 by default); returns the
    last.  A consumed input recycles as a later layer's output: its ring
    is still zero and the next write covers its whole interior."""
    n, hp, wp, _ = src.shape
    free: Dict[Tuple[int, torch.dtype], List[torch.Tensor]] = {}
    for i, layer in enumerate(layers):
        dt = dtypes[i] if dtypes else torch.bfloat16
        pool = free.get((layer.cout, dt))
        dst = pool.pop() if pool else torch.zeros(
            (n, hp, wp, layer.cout), dtype=dt, device=src.device)
        launch(src, dst, layer)
        free.setdefault((src.shape[-1], src.dtype), []).append(src)
        src = dst
    return src


def conv3x3_chain(x: torch.Tensor, layers: Sequence[ChainLayer],
                  crop: bool = True) -> torch.Tensor:
    """Run a stack of SAME 3x3 convs (+bias, +activation) over ``x``
    ``(N, H, W, cin)``.  Returns ``(N, H, W, cout_last)`` in the compute
    dtype, or with ``crop=False`` the bordered ``(N, H+2, W+2, cout)``
    buffer (zero ring) for the fused tail."""
    if x.device.type == "cpu":
        return conv3x3_chain_plain(x, layers, crop)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_chain: unsupported device {x.device}")
    _check_layers(layers, x.shape[-1])
    check_cuda(x, layers, [l.wmat for l in layers])
    h, w = x.shape[1:3]
    out = run_bordered(embed(x), layers, launch_chain_layer)
    return out[:, 1:h + 1, 1:w + 1, :].contiguous() if crop else out


conv3x3_chain.launches = 0
