"""Haloed spatial tiling for frames over the activation budget.

Port of ``upscale_video_tpu/ops/tiling.py:39-134`` with the same geometry,
which decides output bytes: the geometry-fit tile (:func:`fit_tile_grid`),
zero padding of the frame in the model domain by ``halo`` and up to a tile
multiple, uniform ``(tile + 2*halo)`` tiles, and the scaled-halo crop.
Tiles are independent, so :func:`tiled_apply` hands them to ``fn`` in
batches of ``tiles_per_step`` (bit-neutral: the model treats batch items
apart); the batch bounds peak device memory, not program size as on the
TPU.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F


def fit_tile_grid(h: int, w: int, budget: int) -> Tuple[int, int]:
    """Geometry-fit rectangular tile for an (h, w) frame: keep the grid a
    square ``budget`` tile implies (``ceil(dim / budget)`` tiles per axis)
    but shrink each tile, in multiples of 8, to just cover the frame.  At
    1080p with budget 544 this is (544, 480): a 2x4 grid."""
    gy = max(1, math.ceil(h / budget))
    gx = max(1, math.ceil(w / budget))
    th = min(budget, 8 * math.ceil(h / gy / 8))
    tw = min(budget, 8 * math.ceil(w / gx / 8))
    while gy > 1 and (gy - 1) * th >= h:
        gy -= 1
    while gx > 1 and (gx - 1) * tw >= w:
        gx -= 1
    return th, tw


def tiled_apply(
    fn: Callable[[torch.Tensor], torch.Tensor],
    img: torch.Tensor,
    tile: Union[int, Tuple[int, int]] = 512,
    halo: int = 16,
    scale: int = 1,
    tiles_per_step: Optional[int] = None,
) -> torch.Tensor:
    """Apply ``fn`` ((N, th, tw, C) -> (N, th*scale, tw*scale, C')) over
    haloed tiles of one ``(H, W, C)`` frame, ``tiles_per_step`` tiles per
    call (None: all at once); returns ``(H*scale, W*scale, C')``."""
    h, w, _ = img.shape
    tile_h = tile if isinstance(tile, int) else tile[0]
    ph = math.ceil(h / tile_h) * tile_h - h
    rows = F.pad(img, (0, 0, 0, 0, halo, halo + ph))
    return tiled_apply_rows(fn, rows, tile, halo, scale,
                            tiles_per_step)[:h * scale]


def tiled_apply_rows(
    fn: Callable[[torch.Tensor], torch.Tensor],
    rows: torch.Tensor,
    tile: Union[int, Tuple[int, int]] = 512,
    halo: int = 16,
    scale: int = 1,
    tiles_per_step: Optional[int] = None,
) -> torch.Tensor:
    """:func:`tiled_apply` over whole tile rows of a frame: ``rows`` holds
    ``k`` tile rows with their ``halo`` rows above and below, ``(k*th +
    2*halo, W, C)`` (zeros beyond the frame); returns their output,
    ``(k*th*scale, W*scale, C')``.  A shard of ``--parallel sp`` calls it
    for its own tile rows."""
    hr, w, _ = rows.shape
    tile_h, tile_w = (tile, tile) if isinstance(tile, int) else tile
    ty = (hr - 2 * halo) // tile_h
    tx = math.ceil(w / tile_w)
    pw = tx * tile_w - w
    x = F.pad(rows, (0, 0, halo, halo + pw))
    span_h = tile_h + 2 * halo
    span_w = tile_w + 2 * halo
    tiles = torch.stack([
        x[i * tile_h:i * tile_h + span_h, j * tile_w:j * tile_w + span_w, :]
        for i in range(ty) for j in range(tx)
    ])
    n = tiles.shape[0]
    step = n if tiles_per_step is None else tiles_per_step
    hs = halo * scale
    ts_h, ts_w = tile_h * scale, tile_w * scale
    inner = torch.cat([fn(tiles[k:k + step])[:, hs:hs + ts_h, hs:hs + ts_w, :]
                       for k in range(0, n, step)])
    c_out = inner.shape[-1]
    full = (inner.reshape(ty, tx, ts_h, ts_w, c_out).permute(0, 2, 1, 3, 4)
            .reshape(ty * ts_h, tx * ts_w, c_out))
    return full[:, :w * scale, :]
