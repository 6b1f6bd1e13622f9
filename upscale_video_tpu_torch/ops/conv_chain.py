"""K1: the bordered SAME-3x3 conv stack — CUDA kernel wrapper + plain version.

Port of ``upscale_video_tpu/ops/conv_chain.py:61-259``.  The activations of
the whole stack live in bordered bf16 NHWC buffers ``(N, H+2, W+2, C)``
whose one-pixel ring is zero: the input is embedded once, each layer is
one kernel launch over the whole frame batch that writes only the
interior of a ring-zeroed output buffer, and two buffers per width
alternate.  With ``crop=False`` the last bordered buffer goes straight to
the tail kernel (:mod:`upscale_video_tpu_torch.ops.tail`).

:func:`conv3x3_chain` dispatches on the input's device: a CPU tensor takes
:func:`conv3x3_chain_plain`; a CUDA tensor launches a kernel per layer or
raises.  The kernel is chosen by the layer's shape alone
(:func:`chain_kernel`): 64->64 layers run the persistent TMA + wgmma kernel
in ``csrc/conv3x3_chain_sm90.cu``; 24->24, 3->64, 3->24, 24->3 and 64->3
(:data:`NARROW_SHAPES`) the narrow Hopper kernel in
``csrc/conv3x3_chain_narrow_sm90.cu``, whose 3-channel buffers are 8
channels wide and whose weights are packed once (:func:`pack_narrow_weights`,
``ChainLayer.wpack``); every other shape the WMMA kernel in
``csrc/conv3x3_chain.cu``.  ``conv3x3_chain.launches`` counts every layer
launch, ``conv3x3_chain.launches_sm90`` those on either Hopper kernel and
``conv3x3_chain.launches_narrow`` those on the narrow one.
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
    wpack: Optional[torch.Tensor] = None  # the narrow kernel's packed
                         # weights (pack_narrow_weights), for its shapes in bf16

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
                      per_channel(slope, cout, device), int(act),
                      pack_narrow_weights(wmat))


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


# the shapes the narrow Hopper kernel (csrc/conv3x3_chain_narrow_sm90.cu)
# takes: the anime chain's 3->24, 24->24 and 24->3, the default head's
# 3->64, the RRDBNets' 64->3 conv_last
NARROW_SHAPES = frozenset({(24, 24), (3, 64), (3, 24), (24, 3), (64, 3)})
# a 3-channel bordered buffer's width on the narrow kernel: 16 bytes a
# pixel, so TMA's strides and ldmatrix's rows are 16-byte aligned
NARROW_PAD3 = 8


def chain_kernel(cin: int, cout: int) -> str:
    """The kernel a chain layer runs on, by its shape alone: ``"sm90"``
    (64 -> 64, ``csrc/conv3x3_chain_sm90.cu``, whose resident weights and
    3-stage halo ring are sized for that width), ``"narrow"``
    (:data:`NARROW_SHAPES`, ``csrc/conv3x3_chain_narrow_sm90.cu``) or
    ``"wmma"`` (every other shape, ``csrc/conv3x3_chain.cu``)."""
    if cin == 64 and cout == 64:
        return "sm90"
    return "narrow" if (cin, cout) in NARROW_SHAPES else "wmma"


def sm90_takes(cin: int, cout: int) -> bool:
    """Whether a chain layer runs on a Hopper kernel (either sm90 kernel,
    :func:`chain_kernel`)."""
    return chain_kernel(cin, cout) != "wmma"


def in_width(layer) -> int:
    """The channel width of the bordered buffer ``layer`` reads on the
    kernel path: a 3-channel input of the narrow kernel is 8 wide (its
    channels 3..7 zero), every other input its ``cin``."""
    return (NARROW_PAD3 if layer.cin == 3
            and chain_kernel(layer.cin, layer.cout) == "narrow" else layer.cin)


def out_width(layer) -> int:
    """The channel width of the bordered buffer ``layer`` writes on the
    kernel path: the narrow kernel's 3-channel output is 8 wide (its zero
    padded weights and bias write channels 3..7 as 0), every other output
    its ``cout``."""
    return (NARROW_PAD3 if layer.cout == 3
            and chain_kernel(layer.cin, layer.cout) == "narrow" else layer.cout)


def narrow_plan(cin: int, cout: int) -> Tuple[int, int, int, int]:
    """The narrow kernel's plan of a shape: ``(cs, n, ks, atoms)``, the
    input buffer's channels (3 stored 8 wide), wgmma's N (cout rounded up
    to 8), the k16 steps of the dx-folded K (3*cs rounded up to 16) and
    the 64-wide K atoms that hold them, per dy."""
    cs = NARROW_PAD3 if cin == 3 else cin
    ks = -(-3 * cs // 16)
    return cs, -(-cout // 8) * 8, ks, -(-ks // 4)


def pack_narrow_weights(wmat: torch.Tensor) -> Optional[torch.Tensor]:
    """A bf16 ``(9*cin, cout)`` weight matrix of a shape the narrow kernel
    takes as its resident B image (:func:`pack_ring_weights` with the
    shape's :func:`narrow_plan`), else None (other shapes and the f32 CPU
    path need none).  Packed once per layer (``make_layer``, the
    executor's ``prepare``), never per call."""
    cin, cout = wmat.shape[0] // 9, wmat.shape[1]
    if wmat.dtype != torch.bfloat16 or chain_kernel(cin, cout) != "narrow":
        return None
    cs, n, _, _ = narrow_plan(cin, cout)
    return pack_ring_weights(wmat, cs, n)


def pack_ring_weights(wmat: torch.Tensor, cs: int, n: int) -> torch.Tensor:
    """The resident B image of the ring mainloop
    (``csrc/conv3x3_ring_sm90.cuh``, K1's narrow layers and K2's Hopper
    tail) for a ``(9*cin, cout)`` weight matrix read from a bordered buffer
    ``cs >= cin`` channels wide, wgmma's N ``n >= cout``: flat bf16 on
    ``wmat``'s device.  ``B[dy, k, col]`` with k = ``dx * cs + c`` holds
    ``wmat[(dy*3 + dx)*cin + c, col]``, every padded K row (c >= cin,
    k >= 3*cs) and column (col >= cout) zero; per dy, ``atoms`` (3*cs
    rounded up to 64, over 64) blocks of ``n`` lines of 64 values (one
    128-byte line per output column, K-major), 16-byte chunk ``j`` of line
    ``col`` stored at chunk ``j ^ (col % 8)``: wgmma's 128-byte-swizzled B
    layout, read through ``desc_sw128`` (``csrc/sm90_common.cuh``)."""
    cin, cout = wmat.shape[0] // 9, wmat.shape[1]
    atoms = -(-3 * cs // 64)
    b = torch.zeros((3, 3, cs, n), dtype=torch.float32)
    b[:, :, :cin, :cout] = wmat.detach().to("cpu", torch.float32).view(3, 3, cin, cout)
    full = torch.zeros((3, 64 * atoms, n), dtype=torch.float32)
    full[:, :3 * cs] = b.view(3, 3 * cs, n)
    k = torch.arange(64 * atoms).view(1, -1, 1)
    col = torch.arange(n).view(1, 1, -1)
    dy = torch.arange(3).view(-1, 1, 1)
    index = ((dy * atoms + k // 64) * n * 64 + col * 64
             + ((k % 64 // 8) ^ (col % 8)) * 8 + k % 8)
    img = torch.zeros(3 * atoms * n * 64, dtype=torch.float32)
    img[index.reshape(-1)] = full.reshape(-1)
    return img.to(device=wmat.device, dtype=torch.bfloat16)


def launch_chain_layer(src: torch.Tensor, dst: torch.Tensor,
                       layer: ChainLayer) -> None:
    """One K1 launch: bordered ``src`` -> interior of bordered ``dst``
    (whose ring must be zero) on the current stream, on the kernel
    :func:`chain_kernel` names for the layer's shape; the buffers are
    :func:`in_width` and :func:`out_width` channels wide.  A failed launch,
    or a narrow layer without its packed weights, raises."""
    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, cs = src.shape
    kernel = chain_kernel(layer.cin, layer.cout)
    if (dst.shape != (n, hp, wp, out_width(layer)) or cs != in_width(layer)
            or not src.is_contiguous() or not dst.is_contiguous()
            or src.dtype != torch.bfloat16 or dst.dtype != torch.bfloat16):
        raise ValueError(
            f"bordered buffers {tuple(src.shape)}/{src.dtype} -> "
            f"{tuple(dst.shape)}/{dst.dtype} do not fit layer "
            f"{layer.cin}->{layer.cout} (contiguous bf16 required)")
    lib = build.library()
    weights = layer.wmat
    fn = {"sm90": lib.uvt_conv3x3_chain_layer_sm90,
          "narrow": lib.uvt_conv3x3_chain_layer_narrow_sm90,
          "wmma": lib.uvt_conv3x3_chain_layer}[kernel]
    if kernel == "narrow":
        weights = layer.wpack
        _, ncol, _, atoms = narrow_plan(layer.cin, layer.cout)
        if (weights is None or weights.dtype != torch.bfloat16
                or weights.device != src.device or not weights.is_contiguous()
                or weights.numel() != 3 * atoms * ncol * 64
                or weights.data_ptr() % 16):
            raise ValueError(
                f"layer {layer.cin}->{layer.cout}: the narrow kernel needs "
                "its packed weights (ChainLayer.wpack from "
                "pack_narrow_weights, contiguous bf16 on the input's device)")
    build.launch(
        fn, src.device, f"conv3x3_chain {kernel} layer launch",
        src.data_ptr(), dst.data_ptr(), weights.data_ptr(),
        layer.bias.data_ptr(), layer.slope.data_ptr(),
        n, hp - 2, wp - 2, layer.cin, layer.cout, layer.act,
    )
    conv3x3_chain.launches += 1
    conv3x3_chain.launches_sm90 += kernel != "wmma"
    conv3x3_chain.launches_narrow += kernel == "narrow"


def embed(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
          width: Optional[int] = None) -> torch.Tensor:
    """(N, H, W, C) -> ring-zeroed bordered (N, H+2, W+2, ``width``) of
    ``dtype`` (``width`` C by default; channels C.. are zero)."""
    n, h, w, c = x.shape
    buf = torch.zeros((n, h + 2, w + 2, width or c), dtype=dtype,
                      device=x.device)
    buf[:, 1:h + 1, 1:w + 1, :c] = x
    return buf


def run_bordered(src: torch.Tensor, layers: Sequence,
                 launch: Callable[[torch.Tensor, torch.Tensor, object], None],
                 dtypes: Optional[Sequence[torch.dtype]] = None,
                 widths: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch each layer from bordered ``src`` into a ring-zeroed bordered
    buffer ``widths[i]`` channels wide (its cout by default) of
    ``dtypes[i]`` (bf16 by default); returns the last.  A consumed input
    recycles as a later layer's output: its ring is still zero and the
    next write covers its whole interior."""
    n, hp, wp, _ = src.shape
    free: Dict[Tuple[int, torch.dtype], List[torch.Tensor]] = {}
    for i, layer in enumerate(layers):
        dt = dtypes[i] if dtypes else torch.bfloat16
        width = widths[i] if widths else layer.cout
        pool = free.get((width, dt))
        dst = pool.pop() if pool else torch.zeros(
            (n, hp, wp, width), dtype=dt, device=src.device)
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
    cout = layers[-1].cout
    out = run_bordered(embed(x, width=in_width(layers[0])), layers,
                       _launch_adapted, widths=[out_width(l) for l in layers])
    if crop:
        return out[:, 1:h + 1, 1:w + 1, :cout].contiguous()
    return out if out.shape[-1] == cout else out[..., :cout].contiguous()


def _launch_adapted(src: torch.Tensor, dst: torch.Tensor,
                    layer: ChainLayer) -> None:
    """:func:`launch_chain_layer`, after giving a 3-channel ``src`` the
    width the layer reads where its producer wrote another (the narrow
    kernel's 8-wide buffer between it and the WMMA kernel, either way)."""
    need = in_width(layer)
    if src.shape[-1] != need:
        src = F.pad(src[..., :layer.cin], (0, need - layer.cin)).contiguous()
    launch_chain_layer(src, dst, layer)


conv3x3_chain.launches = 0
conv3x3_chain.launches_sm90 = 0
conv3x3_chain.launches_narrow = 0
