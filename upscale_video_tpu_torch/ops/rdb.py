"""K5: one Valar/ESRGAN residual dense block — CUDA kernel wrapper + plain version.

Port of ``upscale_video_tpu/ops/rdb_pallas.py:253`` ``_rdb_kernel`` (reached
via ``rdb_apply_canvas`` :675 and ``rdb_apply`` :544).  One call computes a
whole Valar dense block over ``(N, H, W, 64)`` frames::

    c1 = lrelu(conv(x))
    c2 = lrelu(conv(x, c1)) + conv1x1(x)
    c3 = lrelu(conv(x, c1, c2))
    c4 = lrelu(conv(x, c1, c2, c3)) + c2
    c5 = conv(x, c1, c2, c3, c4)
    out = x + 0.2 * c5

with the TPU kernel's rounding points: the conv of source ``s`` into target
``t`` is accumulated in f32 and rounded to bf16 on its own (one piece per
source, summed in f32 in source order x, c1, c2, ...); bias, lrelu, the
skip and the c2 re-add run in f32 (c4 adds c2's f32 value before its
rounding); c1..c4 are rounded once to bf16; ``out = bf16(f32(x) + 0.2 *
c5)``.  Every conv is zero-padded at the frame edge.

The weights travel packed (:func:`pack_rdb_weights`): one bf16 matrix per
target ``t`` of shape ``(width_t, 9 * cin_t)`` whose row holds, per source
in order, that source's taps in ``(dy, dx, channel)`` order — the
per-source slices of ``pack_rdb_weights`` in the JAX package (:160), here
transposed to one row per output channel — then the
1x1 skip transposed ``(32, 64)``; and the f32 biases ``b1..b5, b_skip``.
The Hopper kernels read the same values, each once, in the order their
stages keep them resident (:func:`pack_rdb_weights_sm90`,
:func:`sm90_blocks`): per stage and 32-column cout chunk, per 64-channel
slice the stage walks (x, then c1|c2, then c3|c4; stage 2 c1 before x),
per tap, 32 output lines of the slice's channels; c2's skip after stage
2's slices.

:func:`rdb_block` dispatches on the input's device: a CPU tensor takes
:func:`rdb_block_plain`; a CUDA tensor launches ``csrc/rdb_block_sm90.cu``
(one C call: five stage kernels on the current stream, over a bf16
scratch for c1..c4 and an f32 one for c2, both ``torch.empty`` per call)
or raises.  ``rdb_block.launches`` and ``rdb_block.launches_sm90`` both
count its calls (one per dense block).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.conv_chain import no_tf32

NF = 64   # trunk width
GC = 32   # growth channels
WIDTHS = (GC, GC, GC, GC, NF)                    # c1..c5
CINS = tuple(NF + t * GC for t in range(5))      # 64, 96, 128, 160, 192
SOURCE_CH = (NF, GC, GC, GC, GC)                 # x, c1..c4
SOURCE_OFF = (0, NF, NF + GC, NF + 2 * GC, NF + 3 * GC)
W_OFFS = tuple(int(v) for v in np.cumsum(
    [0] + [WIDTHS[t] * 9 * CINS[t] for t in range(5)]))
SKIP_W_OFF = W_OFFS[5]
WPACK_NUMEL = SKIP_W_OFF + GC * NF               # 241,664
B_OFFS = (0, GC, 2 * GC, 3 * GC, 4 * GC)
SKIP_B_OFF = 4 * GC + NF
BPACK_NUMEL = SKIP_B_OFF + GC                    # 224
MACS_PER_PIXEL = WPACK_NUMEL                     # one MAC per weight per pixel


SCRATCH_CH = 4 * GC                              # c1..c4, bf16
C2F_CH = GC                                      # c2 before rounding, f32
STAGE_CHUNKS = (1, 1, 1, 1, NF // GC)            # 32-column cout chunks


def sm90_slices(t: int) -> tuple:
    """The 64-channel slices stage ``t`` (0..4 for c1..c5) walks, in order:
    ``(first source, channels)`` (source 0 = x; ``s >= 1`` holds c_s and,
    with 64 channels, c_{s+1}), then ``(-1, 64)`` for c2's 1x1 skip."""
    if t == 1:
        return ((1, GC), (0, NF), (-1, NF))
    return ((0, NF),) + tuple((s, min(2, t + 1 - s) * GC)
                              for s in range(1, t + 1, 2))


class SM90Block(NamedTuple):
    """One block of the Hopper pack: stage ``t`` (0..4 for c1..c5), cout
    chunk ``chunk`` (output channels ``32 * chunk`` ..), slice ``slice`` of
    :func:`sm90_slices` with first source ``s`` (0 = x, -1 = c2's skip),
    ``tap`` (dy*3+dx; 0 for the skip); ``32`` rows (output channels) of
    ``k`` channels at element ``offset``, row-major."""
    t: int
    chunk: int
    slice: int
    s: int
    tap: int
    k: int
    offset: int


@functools.lru_cache(maxsize=1)
def sm90_blocks() -> tuple:
    """The blocks in the order the Hopper stages copy them into shared
    memory: per stage, per cout chunk, per slice, per tap."""
    out, off = [], 0
    for t in range(5):
        for chunk in range(STAGE_CHUNKS[t]):
            for i, (s, k) in enumerate(sm90_slices(t)):
                for tap in range(1 if s < 0 else 9):
                    out.append(SM90Block(t, chunk, i, s, tap, k, off))
                    off += GC * k
    assert off == WPACK_NUMEL
    return tuple(out)


@functools.lru_cache(maxsize=1)
def sm90_gather_index() -> torch.Tensor:
    """``wpack_sm90 = wpack[index]``: for each element of the Hopper
    pack, its position in :func:`pack_rdb_weights`' ``wpack``."""
    idx = np.empty(WPACK_NUMEL, np.int64)
    for b in sm90_blocks():
        row = np.arange(GC)[:, None]                 # output channel in chunk
        kk = np.arange(b.k)[None, :]                 # channel in the slice
        o = GC * b.chunk + row
        if b.s < 0:
            src = SKIP_W_OFF + o * NF + kk
        elif b.s == 0:
            src = W_OFFS[b.t] + o * 9 * CINS[b.t] + b.tap * NF + kk
        else:
            s = b.s + kk // GC                       # c_s, then c_{s+1}
            src = (W_OFFS[b.t] + o * 9 * CINS[b.t] + 9 * np.take(SOURCE_OFF, s)
                   + b.tap * GC + kk % GC)
        idx[b.offset:b.offset + GC * b.k] = src.reshape(-1)
    return torch.from_numpy(idx)


def pack_rdb_weights_sm90(wpack: torch.Tensor) -> torch.Tensor:
    """:func:`pack_rdb_weights`' ``wpack`` as the Hopper stages' pack
    (:func:`sm90_blocks`): the same values, each once, moved."""
    if wpack.shape != (WPACK_NUMEL,):
        raise ValueError(f"wpack {tuple(wpack.shape)} != ({WPACK_NUMEL},)")
    return wpack[sm90_gather_index().to(wpack.device)].contiguous()


class RDBWeights(NamedTuple):
    wpack: torch.Tensor  # (WPACK_NUMEL,) in the compute dtype (bf16 for K5)
    bpack: torch.Tensor  # (BPACK_NUMEL,) f32
    slope: float         # the leaky slope of c1..c4 (the graph's, 0.2)
    # wpack as the Hopper stages' pack (bf16 packs only)
    wpack_sm90: Optional[torch.Tensor] = None


def _f32(a, shape) -> torch.Tensor:
    """numpy array or tensor -> f32 tensor of ``shape`` (same element
    order: an HWIO weight or its ``(kh*kw*cin, cout)`` matrix)."""
    t = torch.as_tensor(a).detach().to(torch.float32)
    if t.numel() != int(np.prod(shape)):
        raise ValueError(f"weight of {t.numel()} values does not fit {shape}")
    return t.reshape(shape)


def pack_rdb_weights(ws: Sequence, bs: Sequence, skip_w, skip_b=None,
                     slope: float = 0.2, dtype: torch.dtype = torch.bfloat16,
                     device: "torch.device | str | None" = None) -> RDBWeights:
    """Five conv weights ``(3, 3, cin_t, width_t)`` (HWIO, or the same
    values as a ``(9*cin_t, width_t)`` matrix) with their biases (None =
    zeros), and the 1x1 skip ``(1, 1, 64, 32)`` with an optional bias ->
    :class:`RDBWeights` on ``device`` (default: the weights' own)."""
    wt: List[torch.Tensor] = []
    for t in range(5):
        w = _f32(ws[t], (3, 3, CINS[t], WIDTHS[t]))
        wt.append(torch.cat([
            w[:, :, SOURCE_OFF[s]:SOURCE_OFF[s] + SOURCE_CH[s], :]
            .reshape(9 * SOURCE_CH[s], WIDTHS[t]).T
            for s in range(t + 1)], dim=1))
    sk = _f32(skip_w, (NF, GC))
    wpack = torch.cat([m.reshape(-1) for m in wt] + [sk.T.reshape(-1)])
    biases = [torch.zeros(n, device=wpack.device) if b is None
              else _f32(b, (n,)).to(wpack.device)
              for b, n in zip(list(bs) + [skip_b], WIDTHS + (GC,))]
    bpack = torch.cat(biases)
    device = wpack.device if device is None else device
    wpack = wpack.to(device=device, dtype=dtype).contiguous()
    return RDBWeights(wpack, bpack.to(device=device).contiguous(), float(slope),
                      pack_rdb_weights_sm90(wpack) if dtype == torch.bfloat16
                      else None)


def _source_weight(wpack: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """Source ``s``'s slice of target ``t`` as f32 OIHW ``(width_t, cs, 3, 3)``."""
    k = 9 * CINS[t]
    wt = wpack[W_OFFS[t]:W_OFFS[t + 1]].reshape(WIDTHS[t], k)
    k0 = 9 * SOURCE_OFF[s]
    cs = SOURCE_CH[s]
    blk = wt[:, k0:k0 + 9 * cs].to(torch.float32)
    return blk.reshape(WIDTHS[t], 3, 3, cs).permute(0, 3, 1, 2)


def rdb_block_plain(x: torch.Tensor, weights: RDBWeights) -> torch.Tensor:
    """The plain PyTorch version of K5, with its rounding points: each
    source's conv (``F.conv2d`` in f32 on compute-dtype values, TF32 off)
    is rounded to the compute dtype (``wpack``'s) on its own, the pieces
    are summed in f32 in source order, and the rest follows the module
    docstring.  ``x``: ``(N, H, W, 64)``; returns the same shape in the
    compute dtype."""
    _check_shapes(x, weights)
    cd = weights.wpack.dtype
    wp, bp, slope = weights.wpack, weights.bpack.to(torch.float32), weights.slope
    xs = x.to(cd).permute(0, 3, 1, 2).to(torch.float32)   # NCHW, cd values
    srcs = [xs]
    c2 = c5 = None
    with no_tf32():
        for t in range(5):
            total = None
            for s, src in enumerate(srcs):
                piece = F.conv2d(src, _source_weight(wp, t, s), padding=1)
                piece = piece.to(cd).to(torch.float32)
                total = piece if total is None else total + piece
            b = bp[B_OFFS[t]:B_OFFS[t] + WIDTHS[t]].view(1, -1, 1, 1)
            val = total + b
            if t == 4:
                c5 = val
                break
            val = torch.where(val >= 0, val, val * slope)
            if t == 1:
                wsk = wp[SKIP_W_OFF:].reshape(GC, NF).to(torch.float32)
                skip = F.conv2d(xs, wsk.view(GC, NF, 1, 1))
                val = val + (skip + bp[SKIP_B_OFF:].view(1, -1, 1, 1))
                c2 = val
            elif t == 3:
                val = val + c2
            srcs.append(val.to(cd).to(torch.float32))
    y = (xs + 0.2 * c5).to(cd)
    return y.permute(0, 2, 3, 1).contiguous()


def _check_shapes(x: torch.Tensor, weights: RDBWeights) -> None:
    if x.ndim != 4 or x.shape[-1] != NF:
        raise ValueError(f"rdb_block takes (N, H, W, {NF}), got {tuple(x.shape)}")
    if weights.wpack.shape != (WPACK_NUMEL,) or \
            weights.bpack.shape != (BPACK_NUMEL,):
        raise ValueError(
            f"packed weights {tuple(weights.wpack.shape)} / "
            f"{tuple(weights.bpack.shape)} != ({WPACK_NUMEL},) / ({BPACK_NUMEL},)")


def rdb_block(x: torch.Tensor, weights: RDBWeights) -> torch.Tensor:
    """One dense block over ``x`` ``(N, H, W, 64)``: the plain version for a
    CPU tensor, the Hopper stages for a CUDA tensor (bf16 in, bf16 out, the
    weights' ``wpack_sm90`` pack); raises on what the kernels do not
    take."""
    if x.device.type == "cpu":
        return rdb_block_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"rdb_block: unsupported device {x.device}")
    _check_shapes(x, weights)
    wstream = weights.wpack_sm90
    if wstream is None:
        raise ValueError("rdb_block: the weights carry no Hopper stream "
                         "(pack_rdb_weights with dtype=torch.bfloat16)")
    for name, t, dt in (("x", x, torch.bfloat16),
                        ("wpack_sm90", wstream, torch.bfloat16),
                        ("bpack", weights.bpack, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"rdb_block: {name} must be {dt}, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"rdb_block: {name} must be contiguous on {x.device}")
    if wstream.numel() != WPACK_NUMEL:
        raise ValueError(f"rdb_block: wpack_sm90 has {wstream.numel()} values")
    from upscale_video_tpu_torch.kernels import build

    n, h, w, _ = x.shape
    out = torch.empty_like(x)
    # c1..c4 and c2's f32 value, from the caching allocator: every element
    # is written before it is read, and both are free again on return
    scratch = torch.empty((n, h, w, SCRATCH_CH), dtype=torch.bfloat16,
                          device=x.device)
    c2f = torch.empty((n, h, w, C2F_CH), dtype=torch.float32, device=x.device)
    build.launch(
        build.library().uvt_rdb_block_sm90, x.device,
        "uvt_rdb_block_sm90 launch",
        x.data_ptr(), out.data_ptr(), wstream.data_ptr(),
        weights.bpack.data_ptr(), scratch.data_ptr(), c2f.data_ptr(), n, h, w,
        ctypes.c_float(weights.slope),
    )
    rdb_block.launches += 1
    rdb_block.launches_sm90 += 1
    return out


rdb_block.launches = 0
rdb_block.launches_sm90 = 0
