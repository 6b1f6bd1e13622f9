"""SwinIR's token ops for the graph walk: LayerNorm over a token's
channels, token linears, and the shifted-window attention.

No kernel of the port's own: each is one or a few PyTorch calls on the
NHWC blobs the graph walk holds, in which a pixel's channels are already
its token (``models/executor.py`` plans them; the ncnn layers are in
``models/param_parser.py``'s dialect list).

- :func:`token_norm`: ``F.layer_norm`` over the last axis, its statistics
  in f32, ``gamma`` and ``beta`` rounded to the input's dtype.
- :func:`token_linear`: a 1x1 convolution as ``F.linear`` over the last
  axis, a cuBLAS GEMM on the card (the operands in the compute dtype, the
  sum and the bias in f32, one rounding), so its kernels are told apart
  by name from the convolutions'.
- :func:`window_attention`: SwinIR's ``WindowAttention`` between its
  ``qkv`` and ``proj`` linears: the map rolled by ``-shift``, cut into
  ``window`` x ``window`` windows, per window and head ``softmax(q k^T *
  d^-0.5 + B[idx] + M) v`` with ``B`` the ``((2w-1)^2, heads)``
  relative-position bias table and ``M`` the shift mask (-100 between
  tokens of different regions of the rolled map, computed from the
  running map size), merged and rolled back.  The products run in
  ``F.scaled_dot_product_attention`` with ``B[idx] + M`` as its additive
  mask, on the card pinned to the memory-efficient (CUTLASS) backend:
  no silent fall-back to the math path.  The head dim is zero-padded to
  a multiple of 8, as that backend needs (exact: the pad adds nothing to
  ``q k^T``, and the pad's outputs are dropped); the scale stays that of
  the unpadded dim.  The softmax is summed in f32 inside the kernel.  A
  CPU tensor takes PyTorch's own choice of backend, the plain version.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

HEAD_ALIGN = 8  # head-dim multiple of the memory-efficient backend (bf16)
MASK_VALUE = -100.0  # SwinIR's calculate_mask


def token_norm(x: torch.Tensor, size: int, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor], eps: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis of ``x``, which must be ``size`` long
    (its statistics in f32; the affine part in ``x``'s dtype, as CUDA's
    LayerNorm takes it), rounded to ``out_dtype``."""
    if gamma is not None and gamma.dtype != x.dtype:
        gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    return F.layer_norm(x, (size,), gamma, beta, eps).to(out_dtype)


def token_linear(x: torch.Tensor, wmat: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``x @ wmat + bias`` over the last axis of ``x`` ``(..., cin)``:
    ``wmat`` ``(cin, cout)`` and ``bias`` ``(cout,)`` in ``x``'s dtype."""
    return F.linear(x, wmat.t(), bias)


@functools.lru_cache(maxsize=8)
def relative_position_index(window: int, device: torch.device) -> torch.Tensor:
    """``(T*T,)`` rows of the bias table for each (query, key) pair of a
    window of ``T = window**2`` tokens in row-major order: the pair's
    offset ``(dy, dx)`` as ``(dy + w - 1) * (2w - 1) + dx + w - 1``."""
    yx = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                    indexing="ij")).flatten(1)
    rel = yx[:, :, None] - yx[:, None, :] + (window - 1)
    return (rel[0] * (2 * window - 1) + rel[1]).flatten().to(device)


@functools.lru_cache(maxsize=4)
def shift_mask(h: int, w: int, window: int, shift: int,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``(nW, 1, T, T)`` shift mask of an ``h`` x ``w`` map rolled by
    ``-shift``: 0 between tokens of one region, -100 between two.  The
    rolled map's regions are the bands ``[0, n - window)``, ``[n - window,
    n - shift)`` and ``[n - shift, n)`` of each axis, as SwinIR's
    ``calculate_mask``; windows in row-major order."""
    def bands(n):
        r = torch.zeros(n, dtype=torch.long)
        r[n - window:] = 1
        r[n - shift:] = 2
        return r

    region = (bands(h)[:, None] * 3 + bands(w)[None, :])
    win = region.reshape(h // window, window, w // window, window)
    win = win.permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] != win[:, :, None]
    mask = torch.where(diff, MASK_VALUE, 0.0)[:, None]
    return mask.to(device=device, dtype=dtype)


def attention_bias(table: torch.Tensor, window: int, shift: int, h: int,
                   w: int, dtype: torch.dtype) -> torch.Tensor:
    """``B[idx]`` ``(1, heads, T, T)`` from the ``((2w-1)^2, heads)``
    table, plus the shift mask ``(nW, 1, T, T)`` on a shifted block: the
    additive mask of one frame's windows, in ``dtype``."""
    t = window * window
    idx = relative_position_index(window, table.device)
    bias = table[idx].reshape(t, t, -1).permute(2, 0, 1)[None]
    bias = bias.to(dtype).contiguous()
    if shift:
        bias = bias + shift_mask(h, w, window, shift, table.device, dtype)
    return bias


def _sdpa(q, k, v, mask, scale: float) -> torch.Tensor:
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)


@functools.lru_cache(maxsize=8)
def window_order(h: int, w: int, window: int, shift: int,
                 device: torch.device) -> torch.Tensor:
    """``(h*w,)`` token indices of an ``h`` x ``w`` map in the order of
    the windows of the map rolled by ``-shift``: window-major (windows in
    row-major order), row-major inside a window.  One gather by it is the
    roll and the partition; one scatter by it the merge and the roll
    back."""
    ys = (torch.arange(h).reshape(h // window, 1, window, 1) + shift) % h
    xs = (torch.arange(w).reshape(1, w // window, 1, window) + shift) % w
    return (ys * w + xs).flatten().to(device)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                     window: int, shift: int) -> torch.Tensor:
    """SwinIR's shifted-window attention: ``qkv`` ``(N, H, W, 3C)`` (the
    ``qkv`` linear's output, channels ``s*C + head*d + i`` for ``s`` in
    q, k, v) -> ``(N, H, W, C)`` in ``qkv``'s dtype, before ``proj``.
    ``H`` and ``W`` are multiples of ``window``.  The frames go through
    one at a time (a shifted block's mask is made once a call): the
    tokens gathered in window order (:func:`window_order`), q, k and v
    laid out per head with the head dim padded, the attention, and its
    output scattered back to the map."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if c3 != 3 * c or c != heads * d or h % window or w % window:
        raise ValueError(f"window attention: qkv {tuple(qkv.shape)} with "
                         f"{heads} heads and window {window}")
    dp = -(-d // HEAD_ALIGN) * HEAD_ALIGN
    t = window * window
    order = window_order(h, w, window, shift, qkv.device)
    mask = attention_bias(table, window, shift, h, w, qkv.dtype)
    out = torch.empty((n, h * w, heads, d), dtype=qkv.dtype, device=qkv.device)
    for i in range(n):
        x = qkv[i].reshape(h * w, c3).index_select(0, order)
        x = x.reshape(-1, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        x = F.pad(x, (0, dp - d))  # (3, nW, heads, T, dp), contiguous
        y = _sdpa(x[0], x[1], x[2], mask, d ** -0.5)[..., :d]
        out[i].index_copy_(0, order, y.transpose(1, 2).reshape(-1, heads, d))
    return out.reshape(n, h, w, c)
