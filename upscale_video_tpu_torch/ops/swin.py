"""SwinIR's token ops for the graph walk: LayerNorm over a token's
channels, token linears, and the shifted-window attention.

Each works on the NHWC blobs the graph walk holds, in which a pixel's
channels are already its token (``models/executor.py`` plans them; the
ncnn layers are in ``models/param_parser.py``'s dialect list).

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
  running map size), merged and rolled back.  Its route is chosen by
  :func:`attention_route` from what the call can see, never by a flag:

  - ``k9``, a CUDA bf16 ``qkv`` at window 8 with at most 8 heads of an even
    head dim up to 32 (SwinIR-L's 8 x 30, SwinIR-M's 6 x 30, the
    lightweight 6 x 10): :func:`window_attention_k9`, K9
    (``csrc/window_attention_sm90.cu``), one launch for the whole batch
    that reads ``qkv`` in place, rolls, partitions, adds bias and mask and
    merges back by its own index arithmetic;
  - ``sdpa``, any other CUDA call: :func:`window_attention_sdpa`, the
    windows gathered in order, q, k and v laid out per head and padded to
    a multiple of 8, ``F.scaled_dot_product_attention`` pinned to the
    memory-efficient (CUTLASS) backend with ``B[idx] + M`` as its additive
    mask, the output scattered back;
  - ``plain``, a CPU tensor: :func:`window_attention_plain`, K9's
    arithmetic in plain PyTorch (scores and softmax in f32, ``P`` rounded
    to the input's dtype before ``P v``, the division by the row sum
    after).

  ``window_attention.launches`` counts K9 launches and
  ``window_attention.routes`` the calls of each route.
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


K9_WINDOW = 8  # csrc/window_attention_sm90.cu: kWin
K9_MAX_HEADS = 8  # one warp a head
K9_MAX_HEAD_DIM = 32  # the head dim padded to 32 in registers


def _split(shape, heads: int, window: int):
    """``(n, h, w, c, d)`` of a ``qkv`` blob; raises where it is no
    ``(N, H, W, 3 heads d)`` blob of whole windows."""
    n, h, w, c3 = shape
    c = c3 // 3
    d = c // heads
    if c3 != 3 * c or c != heads * d or h % window or w % window:
        raise ValueError(f"window attention: qkv {tuple(shape)} with "
                         f"{heads} heads and window {window}")
    return n, h, w, c, d


def attention_route(shape, heads: int, window: int, device_type: str,
                    dtype: torch.dtype) -> str:
    """The route of a :func:`window_attention` call on a ``qkv`` of
    ``shape`` ``(N, H, W, 3C)``: ``plain`` off the card, ``k9`` where K9
    takes the shape and dtype, else ``sdpa``."""
    if device_type != "cuda":
        return "plain"
    _, _, _, c, d = _split(shape, heads, window)
    takes = (dtype == torch.bfloat16 and window == K9_WINDOW
             and 1 <= heads <= K9_MAX_HEADS and d % 2 == 0
             and 2 <= d <= K9_MAX_HEAD_DIM)
    return "k9" if takes else "sdpa"


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                     window: int, shift: int) -> torch.Tensor:
    """SwinIR's shifted-window attention: ``qkv`` ``(N, H, W, 3C)`` (the
    ``qkv`` linear's output, channels ``s*C + head*d + i`` for ``s`` in
    q, k, v) -> ``(N, H, W, C)`` in ``qkv``'s dtype, before ``proj``.
    ``H`` and ``W`` are multiples of ``window``; ``table`` is the
    ``((2w-1)^2, heads)`` bias table.  The route by
    :func:`attention_route`."""
    route = attention_route(tuple(qkv.shape), heads, window, qkv.device.type,
                            qkv.dtype)
    window_attention.routes[route] += 1
    if route == "k9":
        return window_attention_k9(qkv.contiguous(), table, heads, window,
                                   shift)
    if route == "sdpa":
        return window_attention_sdpa(qkv, table, heads, window, shift)
    return window_attention_plain(qkv, table, heads, window, shift)


window_attention.launches = 0
window_attention.routes = {"k9": 0, "sdpa": 0, "plain": 0}


def window_attention_k9(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                        window: int, shift: int) -> torch.Tensor:
    """K9 over the whole batch in one launch.  Checks what the C entry
    cannot see: a CUDA bf16 ``qkv``, contiguous and 16-byte aligned, whose
    channels are ``3 heads d`` over a map of whole windows at window 8, and
    a ``((2w-1)^2, heads)`` table.  The entry refuses the rest (more than 8
    heads, an odd head dim or one over 32, a shift outside ``[0, 8)``) with
    ``cudaErrorInvalidValue``, which :func:`build.launch` raises."""
    if qkv.device.type != "cuda":
        raise ValueError(f"window attention K9: unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window attention K9 takes bf16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("window attention K9 takes a contiguous, 16-byte "
                         "aligned qkv")
    if window != K9_WINDOW:
        raise ValueError(f"window attention K9 takes window {K9_WINDOW}, "
                         f"got {window}")
    n, h, w, c, d = _split(qkv.shape, heads, window)
    if tuple(table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"window attention K9: table {tuple(table.shape)}")
    from upscale_video_tpu_torch.kernels import build

    tab = table.to(device=qkv.device, dtype=torch.float32).contiguous()
    out = torch.empty((n, h, w, c), dtype=qkv.dtype, device=qkv.device)
    build.launch(
        build.library().uvt_window_attention_sm90, qkv.device,
        "window attention launch", qkv.data_ptr(), out.data_ptr(),
        tab.data_ptr(), n, h, w, heads, d, shift, d ** -0.5,
    )
    window_attention.launches += 1
    return out


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           heads: int, window: int,
                           shift: int) -> torch.Tensor:
    """The plain PyTorch version of K9, on either device: the tokens
    gathered in window order (:func:`window_order`), per window and head
    the scores ``q k^T * d^-0.5 + B[idx] + M`` in f32, ``P = exp(S -
    max)`` and its row sum ``l`` in f32, ``(P in qkv's dtype) v / l``
    rounded to ``qkv``'s dtype, scattered back to the map, a frame at a
    time."""
    n, h, w, c, d = _split(qkv.shape, heads, window)
    t = window * window
    order = window_order(h, w, window, shift, qkv.device)
    idx = relative_position_index(window, qkv.device)
    bias = table.to(device=qkv.device, dtype=torch.float32)[idx]
    bias = bias.reshape(t, t, heads).permute(2, 0, 1)
    if shift:
        bias = bias + shift_mask(h, w, window, shift, qkv.device,
                                 torch.float32)
    out = torch.empty((n, h * w, heads, d), dtype=qkv.dtype, device=qkv.device)
    for i in range(n):
        x = qkv[i].reshape(h * w, 3 * c).index_select(0, order)
        q, k, v = x.reshape(-1, t, 3, heads, d).permute(2, 0, 3, 1, 4).float()
        s = q @ k.transpose(-1, -2) * d ** -0.5 + bias
        p = torch.exp(s - s.amax(-1, keepdim=True))
        y = (p.to(qkv.dtype).float() @ v) / p.sum(-1, keepdim=True)
        out[i].index_copy_(0, order, y.to(qkv.dtype).transpose(1, 2)
                           .reshape(-1, heads, d))
    return out.reshape(n, h, w, c)


def window_attention_sdpa(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                          window: int, shift: int) -> torch.Tensor:
    """The ``sdpa`` route: the frames go through one at a time (a shifted
    block's mask is made once a call): the tokens gathered in window order
    (:func:`window_order`), q, k and v laid out per head with the head dim
    padded, the attention, and its output scattered back to the map."""
    n, h, w, c, d = _split(qkv.shape, heads, window)
    c3 = 3 * c
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
