"""Spatial parallelism: one frame sharded across GPUs by image rows.

Port of ``upscale_video_tpu/parallel/spatial.py``.  The JAX package's
shipped ``--parallel sp`` shards the H axis of one fused program and gets
exact math from GSPMD's per-conv halo exchange.  The port gets the same
result in a simpler way (:func:`sp_sharded_fn`): each shard runs the
**whole step** on its band of rows, widened by the step's receptive radius
``R`` (:func:`receptive_radius`) and clipped at the frame edges, then drops
the widening.  A row at least ``R`` from the widened band's cut edge is
computed from the same inputs by the same per-pixel arithmetic as on one
device; at the true frame edges the band's own SAME padding is the frame's.

A tiled step (``-m r``, ``--tile_size``) is not translation-invariant (its
tile grid is anchored to the frame), so its bands are cut between tile rows
of the grid that ``fit_tile_grid`` makes for the (padded) frame, and each
shard computes its own tile rows (:class:`Band` tells it where it is): the
output is the single-device tiled output.  ``--tta`` over a tiled SR stage
runs on the first GPU with only each dihedral pass's tiled stage spread
(:func:`sp_tiled_fn`: every pass cut on its own tile grid; a rotated pass
bands the frame's columns), under the same row padding
(:func:`row_padded_fn`).

:func:`spatial_forward` is the explicit fixed-halo form (neighbour rows
exchanged, zero rows at the frame border), which the tests hold against
the shipped path, and :func:`shard_frame_batch` places a batch over a
``dp`` x ``sp`` mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, List, Optional, Tuple

import torch

from upscale_video_tpu_torch.models.ops import conv_geometry
from upscale_video_tpu_torch.ops.pixel import pad_to_multiple
from upscale_video_tpu_torch.parallel.data import (
    ShardedStep, as_batch, host_tensor, on_device, record_done, run_to_host,
)
from upscale_video_tpu_torch.parallel.mesh import Mesh

# NL-means' reach: 5x5 patches (radius 2) compared over a 9x9 search
# (radius 4), as ops/nlmeans.py's PAD
NLMEANS_RADIUS = 2 + 4


@dataclass(frozen=True)
class Band:
    """One shard's rows of a frame of ``frame_h`` rows: it is given rows
    ``[top, bottom)`` (its core widened by the radius, clipped to the
    frame) and returns the output of its core rows ``[lo, hi)``."""

    top: int
    bottom: int
    lo: int
    hi: int
    frame_h: int

    def crop(self, y: torch.Tensor) -> torch.Tensor:
        """The core rows of a whole-frame output ``y`` of rows ``[top,
        bottom)``, at the program's own row ratio."""
        rows = self.bottom - self.top
        ratio, rem = divmod(y.shape[1], rows)
        if rem:
            raise ValueError(f"output rows {y.shape[1]} are no multiple of "
                             f"the band's {rows} input rows")
        return y[:, (self.lo - self.top) * ratio:(self.hi - self.top) * ratio]


def plan_bands(h: int, n: int, radius: int, period: int = 1
               ) -> List[Optional[Band]]:
    """Cut ``h`` rows into ``n`` cores at multiples of ``period`` (as evenly
    as whole periods allow; a shard left without rows gets None), each
    widened by ``radius`` rows and clipped to ``[0, h)``."""
    units = -(-h // period)
    cuts = [min(h, period * (i * units // n)) for i in range(n + 1)]
    return [Band(max(0, lo - radius), min(h, hi + radius), lo, hi, h)
            if hi > lo else None
            for lo, hi in zip(cuts, cuts[1:])]


def whole_frame(fn: Callable) -> Callable:
    """A whole-frame step as a band step: run it on the band, keep the
    core."""
    return lambda x, band: band.crop(fn(x))


def _upload_rows(x: torch.Tensor, top: int, bottom: int,
                 device: torch.device) -> torch.Tensor:
    """Rows ``[top, bottom)`` of every frame of ``x`` in a new tensor on
    ``device``, frame by frame (each a contiguous non-blocking copy)."""
    out = torch.empty((x.shape[0], bottom - top, *x.shape[2:]),
                      dtype=x.dtype, device=device)
    for j in range(x.shape[0]):
        out[j].copy_(x[j, top:bottom], non_blocking=True)
    return out


class SpatialStep(ShardedStep):
    """:func:`sp_sharded_fn`'s step."""

    def __init__(self, band_step_of_device: Callable, mesh: Mesh,
                 radius: int, axis: str, period):
        self.devices = mesh.axis_devices(axis)
        self.steps = {d: band_step_of_device(d)
                      for d in dict.fromkeys(self.devices)}
        self.radius = radius
        self.period = period

    def launch(self, batch):
        x = as_batch(batch)
        n, h = len(self.devices), x.shape[1]
        pinned = any(d.type == "cuda" for d in self.devices)
        x, (ph, _) = pad_to_multiple(x, n, 1)
        if ph and pinned:
            x = x.pin_memory()
        hp = h + ph
        period = (self.period(hp, x.shape[2]) if callable(self.period)
                  else self.period)
        outs = []
        for dev, band in zip(self.devices,
                             plan_bands(hp, n, self.radius, period)):
            if band is None:
                continue
            with on_device(dev):
                xs = _upload_rows(x, band.top, band.bottom, dev)
                outs.append((dev, band, self.steps[dev](xs, band)))
        _, b0, y0 = outs[0]
        ratio = y0.shape[1] // (b0.hi - b0.lo)
        h_out = h * ratio  # the edge rows' output cropped
        host = host_tensor((x.shape[0], h_out, *y0.shape[2:]), y0.dtype,
                           pinned)
        events = []
        for dev, band, y in outs:
            if y.shape[1] != (band.hi - band.lo) * ratio:
                raise ValueError(f"band {band} returned {y.shape[1]} rows "
                                 f"at ratio {ratio}")
            r0, r1 = band.lo * ratio, min(band.hi * ratio, h_out)
            if r1 <= r0:
                continue
            with on_device(dev):
                for j in range(x.shape[0]):
                    host[j, r0:r1].copy_(y[j, :r1 - r0], non_blocking=True)
                ev = record_done(dev)
            if ev is not None:
                events.append(ev)
        return host, events


def sp_sharded_fn(band_step_of_device: Callable[[torch.device], Callable],
                  mesh: Mesh, radius: int, axis: str = "sp",
                  period: "int | Callable[[int, int], int]" = 1
                  ) -> ShardedStep:
    """The shipped ``--parallel sp``: uint8 ``(N, H, W, C)`` in, the
    step's layout out (frames ``(N, s*H, ...)``, planar and the packed
    4:2:0-planar ``(N, H, ...)``), on the host.

    H not divisible by the axis size is edge-padded to the next multiple
    (:func:`~upscale_video_tpu_torch.ops.pixel.pad_to_multiple`) and the
    padding cropped after, scaled by the program's own row ratio, as in
    the JAX package.  The padded frame is cut into one band per entry of
    ``axis`` at multiples of ``period`` (an int, or a function of the
    padded frame's ``(H, W)``: the tile height of a tiled step), each
    widened by ``radius`` rows.  ``band_step_of_device(device)`` returns
    the band step on that device, ``fn(rows, band) -> core output``
    (:func:`whole_frame` makes one of a whole-frame step); it is called
    once per distinct device here."""
    return SpatialStep(band_step_of_device, mesh, radius, axis, period)


class RowPaddedStep(ShardedStep):
    """:func:`row_padded_fn`'s step."""

    def __init__(self, step: Callable, mesh: Mesh, axis: str):
        self.step = step
        self.n = mesh.shape[axis]
        self.device = mesh.axis_devices(axis)[0]

    def launch(self, batch):
        x = as_batch(batch)
        h = x.shape[1]
        x, (ph, _) = pad_to_multiple(x, self.n, 1)
        if ph and self.device.type == "cuda":
            x = x.pin_memory()

        def cropped(xd):
            y = self.step(xd)
            return y[:, :h * (y.shape[1] // x.shape[1])]

        return run_to_host(cropped, x, self.device)


def row_padded_fn(step: Callable, mesh: Mesh, axis: str = "sp") -> ShardedStep:
    """A step that spreads its own work over ``mesh[axis]`` (``--tta`` over
    a tiled SR stage, :func:`sp_tiled_fn`) under the sp contract: the host
    batch edge-padded to a multiple of the axis size in rows, as
    :func:`sp_sharded_fn` pads it, run on the axis's first device, the
    padding cropped at the output's row ratio, the output on the host."""
    return RowPaddedStep(step, mesh, axis)


class TiledBands:
    """:func:`sp_tiled_fn`'s callable."""

    def __init__(self, band_step_of_device: Callable, mesh: Mesh,
                 radius: int, period: Callable[[int, int], int], axis: str):
        self.devices = mesh.axis_devices(axis)
        self.steps = {d: band_step_of_device(d)
                      for d in dict.fromkeys(self.devices)}
        self.radius = radius
        self.period = period

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        bands = plan_bands(h, len(self.devices), self.radius,
                           self.period(h, w))
        parts = []
        for dev, band in zip(self.devices, bands):
            if band is None:
                continue
            with on_device(dev):
                y = self.steps[dev](x[:, band.top:band.bottom].to(dev), band)
            parts.append(y.to(x.device))
        return torch.cat(parts, dim=1)


def sp_tiled_fn(band_step_of_device: Callable[[torch.device], Callable],
                mesh: Mesh, radius: int, period: Callable[[int, int], int],
                axis: str = "sp") -> Callable[[torch.Tensor], torch.Tensor]:
    """A tiled stage's rows spread over ``mesh[axis]``, called on the
    axis's first device: ``fn(x)`` cuts ``x`` ``(N, H, W, C)`` into one
    band per entry at multiples of ``period(H, W)`` (its tile height),
    widened by ``radius`` (the halo), runs each band's step on its device
    (``band_step_of_device(device)`` returns ``fn(rows, band) -> core
    output``, the engine's tiled band step) and concatenates the outputs on
    ``x``'s device: the tiled stage's own output.  Under ``--tta`` each
    dihedral pass calls it on its transformed frame, so every pass is cut
    on its own tile grid."""
    return TiledBands(band_step_of_device, mesh, radius, period, axis)


def _row_reach(layer, scale: Fraction) -> int:
    """Input rows one layer adds to the receptive radius at blob scale
    ``scale`` (output rows per input row)."""
    if layer.type in ("Convolution", "ConvolutionDepthWise"):
        kh, _, (sh, _), (dh, _), (pt, pb, _, _) = conv_geometry(layer)
        extent = (kh - 1) * dh
        k = (max(pt, pb, extent - min(pt, pb)) if min(pt, pb) >= 0
             else extent)
        return math.ceil((k + sh - 1) / scale)
    if layer.type == "Interp":
        if layer.attr_i(3, 0) or layer.attr_i(4, 0):
            raise NotImplementedError(
                f"{layer.name}: an Interp to a fixed size is not row-local")
        # bilinear reads 1 neighbour, bicubic 2; +1 for the half-pixel map
        taps = {2: 1, 3: 2}.get(layer.attr_i(0, 0), 0)
        return math.ceil(taps / scale) + 1 if taps else 0
    if layer.type == "Reorg":
        return math.ceil((layer.attr_i(0, 1) - 1) / scale)
    return 0


def _scale_after(layer, scale: Fraction) -> Fraction:
    if layer.type == "Interp":
        return scale * Fraction(layer.attr_f(1, 1.0)).limit_denominator(64)
    if layer.type == "PixelShuffle":
        return scale * layer.attr_i(0, 1)
    if layer.type == "Reorg":
        return scale / layer.attr_i(0, 1)
    if layer.type in ("Convolution", "ConvolutionDepthWise"):
        return scale / conv_geometry(layer)[2][0]
    return scale


def graph_radius(graph) -> int:
    """The receptive radius of an ncnn graph in input rows: along its
    deepest path, each spatial conv's reach (``(k//2)*dilation`` for SAME)
    divided by the resolution it runs at (through Interp, PixelShuffle and
    Reorg), rounded up per layer, so an output row's inputs lie within the
    radius of its input row."""
    scale: dict = {}
    reach: dict = {}
    for layer in graph.layers:
        if layer.type == "Input" or not layer.inputs:
            for b in layer.outputs:
                scale[b], reach[b] = Fraction(1), 0
            continue
        s = scale[layer.inputs[0]]
        r = max(reach[b] for b in layer.inputs) + _row_reach(layer, s)
        s = _scale_after(layer, s)
        for b in layer.outputs:
            scale[b], reach[b] = s, r
    return reach[graph.output_blobs[0]]


def receptive_radius(engine, sr: bool = True) -> int:
    """The rows a chain step reaches on either side of an output row, in
    input rows: NL-means' 2 + 4 for ``n=K``, then the anime model's graph,
    then (with ``sr``) the SR model's graph."""
    r = NLMEANS_RADIUS if engine.spec.denoise else 0
    if engine.anime_model is not None:
        r += graph_radius(engine.anime_model.graph)
    if sr and engine.sr_model is not None:
        r += graph_radius(engine.sr_model.graph)
    return r


def _exchange_halo(parts: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
    """Extend each ``(N, Hloc, W, C)`` slice with its neighbours' rows
    (moved to its device); the first slice's top halo and the last's bottom
    halo are zeros, as conv zero padding at the true frame border."""
    out = []
    for i, x in enumerate(parts):
        zeros = torch.zeros_like(x[:, :halo])
        top = parts[i - 1][:, -halo:].to(x.device) if i else zeros
        bot = (parts[i + 1][:, :halo].to(x.device) if i + 1 < len(parts)
               else zeros)
        out.append(torch.cat([top, x, bot], dim=1))
    return out


def spatial_forward(fwd: Callable, params, x: torch.Tensor, mesh: Mesh,
                    axis: str = "sp", halo: int = 16, scale: int = 2,
                    extra_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Run ``fwd(params, x)`` with the H axis sharded over ``mesh[axis]``
    (and N over ``extra_axes[0]``, e.g. ``("dp",)``): each slice gets
    ``halo`` neighbour rows (zeros at the frame border), runs, and loses
    ``halo * scale`` output rows on each side.  ``x``: ``(N, H, W, C)``
    with H divisible by the axis size.  Returns the full ``(N, H*scale,
    ...)`` output on ``x``'s device."""
    n_sp = mesh.shape[axis]
    if x.shape[1] % n_sp:
        raise ValueError(f"H={x.shape[1]} not divisible by {axis}={n_sp}")
    pieces = shard_frame_batch(x, mesh, extra_axes[0] if extra_axes else None,
                               axis)
    hs = halo * scale
    rows = []
    for row in pieces:
        outs = []
        for dev, y in zip(row["devices"],
                          _exchange_halo(row["parts"], halo)):
            with on_device(dev):
                z = fwd(params, y)
            outs.append(z[:, hs:z.shape[1] - hs].to(x.device))
        rows.append(torch.cat(outs, dim=1))
    return torch.cat(rows, dim=0)


def shard_frame_batch(x: torch.Tensor, mesh: Mesh,
                      batch_axis: Optional[str] = "dp",
                      h_axis: str = "sp") -> List[dict]:
    """Place a host ``(N, H, W, C)`` batch with N over ``batch_axis`` and H
    over ``h_axis`` (an axis the mesh lacks is not split): one entry per
    batch shard, ``{"devices": [...], "parts": [...]}`` over the H shards,
    each part on its device."""
    shape = mesh.shape
    nb = shape.get(batch_axis, 1) if batch_axis else 1
    nh = shape.get(h_axis, 1)
    if x.shape[0] % nb or x.shape[1] % nh:
        raise ValueError(f"{tuple(x.shape)} not divisible by "
                         f"{batch_axis}={nb}, {h_axis}={nh}")
    kb, kh = x.shape[0] // nb, x.shape[1] // nh
    names = mesh.axis_names
    out = []
    for a in range(nb):
        devs = []
        for b in range(nh):
            idx = [0] * len(names)
            if batch_axis in names:
                idx[names.index(batch_axis)] = a
            if h_axis in names:
                idx[names.index(h_axis)] = b
            devs.append(mesh.devices[tuple(idx)])
        parts = [x[a * kb:(a + 1) * kb, b * kh:(b + 1) * kh].to(d)
                 for b, d in enumerate(devs)]
        out.append({"devices": devs, "parts": parts})
    return out
