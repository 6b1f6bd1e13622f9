"""Model-chain engine over the port's kernels, and the batched stepper.

Port of ``upscale_video_tpu/pipeline/chain.py:35-162, 166-522, 703-741,
747-822``, restricted to the chains the port covers, on one device.  A
step is uint8 frames -> model domain -> the pre-SR stages -> the SR stage
-> the contract's uint8 layout (the packed 4:2:0 one written by an SRVGG
tail itself, or packed after the frames):

- pre-SR stages (``_prelude``, in the JAX order): ``n=K``, NL-means at
  strength K over the frame batch (one K6 launch), then ``a``, the 1x
  SRVGG anime deblur model (one K1 chain + its skip add);
- SR, the empty chain's 2x (or 4x) SRVGG Compact model, whole-frame: K1
  (the 17-layer body for 2x Compact) -> K2 (the fused tail, emitting the
  step's output layout); with ``--tile_size``, haloed tiles -> K1 -> K2's
  f32 model layout -> the scaled-halo crop;
- SR, ``-m r``'s 4x Valar RRDBNet, tiled: haloed tiles -> the graph walk
  (K5 per dense block, K4 per solo 3x3 conv, one K1 chain for the last
  three) -> scaled-halo crop;
- SR, ``-m sr=<stem>``, an imported model (``vsr-import-torch``),
  whole-frame unless ``--tile_size``, 4 frames a step, bf16 under
  ``auto``: an SRVGG on K1 + K2 or, where its body is no chain, the graph
  walk with K4 and K3; an RRDBNet such as RealESRGAN_x4plus on the graph
  walk (K4 per 3x3 conv outside its one K1 chain); a SwinIR on the graph
  walk (its token linears on cuBLAS, its window attention on K9 where the
  shape allows, ``ops/swin.py``; K4 and one K1 chain for its convs),
  which ``--parallel sp`` and ``tp`` refuse;
- ``--tta`` averages the SR stage's model-domain output over the 8
  dihedral transforms (K2's f32 layout for Compact);
- scale 1 has no SR stage: the pre-SR stages' output is quantized.

``--conv_impl`` (``ChainEngine.build``'s ``conv_impl``) picks the kernels
as the JAX package reads the flag: ``auto`` is the routes above, ``pallas``
the same but ``-m r``'s dense blocks on K4 in place of K5, ``rdb`` K5
alone, ``xla`` no kernel (every conv a generic ``F.conv2d``, NL-means on
its plain version; the aten route, which f32 takes for the convs whatever
the flag).

``ChainEngine.stage_fn`` runs one of these stages alone, uint8 in and out,
for the PNG plane (``pipeline/stages.py``); ``ChainEngine.process`` one
host batch through the step, for calibration
(``pipeline/calibrate.py``).  ``ChainEngine.use_chips`` puts every step on
a mesh of GPUs: ``dp`` (frames), ``sp`` (rows) or ``tp`` (each conv's
output channels, ``parallel/tensor.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from upscale_video_tpu_torch.models.executor import has_window_attention
from upscale_video_tpu_torch.models.zoo import (
    Model, load_model, make_synthetic_model, make_synthetic_rrdb_model,
)
from upscale_video_tpu_torch.ops.nlmeans import (
    nl_means_denoise, nl_means_denoise_plain,
)
from upscale_video_tpu_torch.ops.pixel import frames_to_model, model_to_frames
from upscale_video_tpu_torch.ops.tiling import (
    fit_tile_grid, tiled_apply, tiled_apply_rows,
)
from upscale_video_tpu_torch.ops.tta import tta_apply
from upscale_video_tpu_torch.ops.yuv import i420_to_model, yuv420_from_frames
from upscale_video_tpu_torch.parallel.data import ShardedStep, data_parallel_fn
from upscale_video_tpu_torch.parallel.mesh import (  # noqa: F401 (parse_chips)
    Mesh, make_mesh, parse_chips, select_devices,
)
from upscale_video_tpu_torch.parallel.spatial import (
    NLMEANS_RADIUS, Band, graph_radius, receptive_radius, row_padded_fn,
    sp_sharded_fn, sp_tiled_fn, whole_frame,
)
from upscale_video_tpu_torch.parallel.tensor import (
    TensorParallelModel, tensor_parallel_fn, tp_routes,
)
from upscale_video_tpu_torch.utils.trace import NO_TRACE

log = logging.getLogger(__name__)


@dataclass
class ChainSpec:
    """Parsed ``-m`` model chain (host copy of the JAX ``ChainSpec``)."""

    anime: bool = False
    denoise: Optional[int] = None  # 1..30 or None
    real_life: bool = False
    sr_file: Optional[str] = None  # custom SR model stem suffix (sr=...)

    @classmethod
    def parse(cls, models: Optional[str]) -> "ChainSpec":
        """Parse ``"a,n=3,r"`` with the reference's clamping semantics
        (n>30 -> 30, n<=0 -> off); ``sr=<stem>`` picks a custom SR file."""
        spec = cls()
        if not models:
            return spec
        for item in models.split(","):
            item = item.strip()
            if item == "a":
                spec.anime = True
            elif item == "r":
                spec.real_life = True
            elif item.startswith("n="):
                level = int(item[2:])
                spec.denoise = min(level, 30) if level > 0 else None
            elif item.startswith("sr="):
                spec.sr_file = item[3:]
                if not spec.sr_file:
                    raise ValueError("sr= needs a model file stem suffix")
            elif item:
                raise ValueError(f"unknown model chain item {item!r}")
        if spec.real_life and spec.sr_file:
            raise ValueError("'r' and 'sr=' both select the SR model — "
                             "pass one")
        return spec

    def effective_scale(self, scale: int) -> int:
        """'r' forces scale 4."""
        return 4 if self.real_life else scale

    def stage_names(self) -> List[str]:
        out = []
        if self.denoise:
            out.append(f"denoise(h={self.denoise})")
        if self.anime:
            out.append("anime-deblur")
        if self.sr_file:
            out.append(f"sr({self.sr_file})")
        else:
            out.append("valar-4x" if self.real_life else "compact-sr")
        return out

    def is_default(self) -> bool:
        return not (self.anime or self.denoise or self.real_life
                    or self.sr_file)


def precision_dtypes(precision: str, spec: "ChainSpec | None" = None):
    """``--precision`` -> ``(compute_dtype, residual_dtype)`` as in the JAX
    package: ``auto`` is ``mixed`` for ``-m r`` and bf16 otherwise."""
    if precision == "auto":
        precision = "mixed" if spec is not None and spec.real_life else "bf16"
    if precision == "f32":
        return torch.float32, None
    if precision not in ("bf16", "mixed"):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.bfloat16, (torch.float32 if precision == "mixed" else None)


def default_frames_per_step(spec: ChainSpec) -> int:
    """4 frames per step for the Compact family, 1 for ``-m r``."""
    return 1 if spec.real_life else 4


# ``-m r``'s tile budget: at 1080p it fits (544, 480), a 2x4 grid of
# 576x512 haloed tiles (the JAX package's VALAR_DEFAULT_TILE).
VALAR_DEFAULT_TILE = 544
# Tiles per model call: a 1080p frame's 8 tiles in one call, so a 2160p
# frame's 32 go in four and the peak device memory stays that of one
# 1080p frame: 19.58 GB at 23 RRDBs on an NVIDIA H100 80GB HBM3
# (chip_smoke.py's [valar_step_vs_plain] reports it).
TILES_PER_STEP = 8


def default_tile(spec: ChainSpec) -> "int | tuple":
    """Whole-frame (0) for the Compact family; ``-m r`` tiles at
    :data:`VALAR_DEFAULT_TILE`."""
    return VALAR_DEFAULT_TILE if spec.real_life else 0


@dataclass
class ChainEngine:
    """Executes the model chain on batches of uint8 frames on one device.

    Step callables take and return device tensors: uint8 ``(N, H, W, 3)``
    frames (or flat I420 ``(N, h*w*3//2)`` under ``i420_in``) in, the
    contract's uint8 layout out.  ``sr_model`` is None at scale 1;
    ``anime_model`` is the ``a`` stage or None.  ``tile`` is 0 (whole
    frame), a budget (:func:`~upscale_video_tpu_torch.ops.tiling.fit_tile_grid`)
    or an exact ``(th, tw)`` pair; ``halo`` is the tiles' context border;
    ``tta`` averages the SR stage over the 8 dihedral transforms;
    ``conv_impl`` is ``--conv_impl`` (the models carry it for their convs,
    the engine for NL-means)."""

    spec: ChainSpec
    scale: int
    sr_model: Optional[Model]
    device: torch.device
    anime_model: Optional[Model] = None
    tile: "int | tuple" = 0
    halo: int = 16
    tta: bool = False
    channel_order: str = "bgr"
    conv_impl: str = "auto"
    _steps: dict = field(default=None, repr=False)
    _mesh: Optional[Mesh] = field(default=None, repr=False)
    _mesh_mode: str = field(default="dp", repr=False)
    _replicas: dict = field(default=None, repr=False)
    _tp: Optional["ChainEngine"] = field(default=None, repr=False)
    _tp_warned: bool = field(default=False, repr=False)
    _tiles: Optional[Callable] = field(default=None, repr=False)

    @classmethod
    def build(cls, spec: ChainSpec, scale: int, device: "torch.device | str",
              model_path: Optional[str] = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              synthetic: bool = False,
              residual_dtype: Optional[torch.dtype] = None,
              tile: "int | tuple | None" = None,
              halo: int = 16, tta: bool = False,
              conv_impl: str = "auto") -> "ChainEngine":
        """Load the chain's models on ``device``: the anime role (scale 1)
        for ``a``; for the SR stage (none at scale 1) the stock Compact
        role, the Valar role for ``-m r`` (forcing 4x), or the file
        ``{scale}{stem}`` for ``sr=<stem>`` (JAX chain.py:264-276).
        ``synthetic`` takes random-weight stand-ins of the same
        architectures (for ``a`` the JAX chain's ``make_synthetic_model(
        scale=1, num_conv=8, num_feat=24)``, for ``-m r`` the 23-RRDB
        ``make_rrdb_graph``, for ``sr=`` the Compact, the stem ignored, as
        in JAX).  ``tile=None`` takes the family's default
        (:func:`default_tile`); every SR model takes a tile.
        ``residual_dtype`` (``mixed``) reaches the anime model too, as in
        the JAX chain (chain.py:248).  ``conv_impl`` is ``--conv_impl``
        (:func:`~upscale_video_tpu_torch.models.executor.conv_routes`)."""
        device = torch.device(device)
        scale = spec.effective_scale(scale)
        if tile is None:
            tile = default_tile(spec)
        anime = None
        if spec.anime:
            anime = (make_synthetic_model(
                        scale=1, num_conv=8, num_feat=24, device=device,
                        compute_dtype=compute_dtype,
                        residual_dtype=residual_dtype, conv_impl=conv_impl)
                     if synthetic else
                     load_model("anime", 1, device, model_path,
                                compute_dtype, residual_dtype, conv_impl))
            anime.frames_forward("model")  # plan now
        model = None
        if scale > 1 and spec.real_life:
            model = (make_synthetic_rrdb_model(
                        scale=scale, num_rrdb=23, device=device,
                        compute_dtype=compute_dtype,
                        residual_dtype=residual_dtype, conv_impl=conv_impl)
                     if synthetic else
                     load_model("valar", scale, device, model_path,
                                compute_dtype, residual_dtype, conv_impl))
            model.frames_forward("model")  # plan now
        elif scale > 1:
            model = (make_synthetic_model(scale=scale, device=device,
                                          compute_dtype=compute_dtype,
                                          residual_dtype=residual_dtype,
                                          conv_impl=conv_impl)
                     if synthetic else
                     load_model(spec.sr_file or "compact", scale, device,
                                model_path, compute_dtype, residual_dtype,
                                conv_impl))
            # plan now: an unsupported graph raises before any frame is read
            model.frames_forward("planar" if model.planar_scale
                                 and not (tile or tta) else "model")
        return cls(spec=spec, scale=scale, sr_model=model, device=device,
                   anime_model=anime, tile=tile, halo=halo, tta=tta,
                   conv_impl=conv_impl)

    def _to_model(self, frames_u8: torch.Tensor) -> torch.Tensor:
        return frames_to_model(frames_u8.to(self.device), self.channel_order)

    def _denoise(self, x: torch.Tensor) -> torch.Tensor:
        """NL-means at strength ``n=K`` over the whole frame batch: one K6
        launch on the card, or its plain version under ``--conv_impl xla``
        or ``rdb`` (the JAX package runs its NL-means kernel only under
        ``pallas``).  K6 computes in f32, so f32 keeps it."""
        if self.conv_impl in ("xla", "rdb"):
            return nl_means_denoise_plain(x, float(self.spec.denoise))
        return nl_means_denoise(x.contiguous(), float(self.spec.denoise))

    def _prelude(self, x: torch.Tensor) -> torch.Tensor:
        """The pre-SR stages on model-domain frames, denoise then anime
        (JAX chain.py:328-335): the one place their order lives."""
        if self.spec.denoise:
            x = self._denoise(x)
        if self.anime_model is not None:
            x = self.anime_model.frames_forward("model")(
                self.anime_model.state, x)
        return x

    def _tile_hw(self, h: int, w: int) -> Tuple[int, int]:
        return (self.tile if isinstance(self.tile, tuple)
                else fit_tile_grid(h, w, self.tile))

    def _tiled_sr(self, x: torch.Tensor) -> torch.Tensor:
        """Model-domain (N, H, W, 3) -> (N, sH, sW, 3) f32 over haloed
        tiles; each frame's tiles go through the model in batches of
        :data:`TILES_PER_STEP`.  Under ``--parallel sp`` with ``--tta``
        each pass's frame is cut into bands of tile rows instead, one per
        GPU (``_tiles``, :func:`~upscale_video_tpu_torch.parallel.spatial.
        sp_tiled_fn`)."""
        if self._tiles is not None:
            return self._tiles(x)
        fwd = self.sr_model.frames_forward("model")
        state = self.sr_model.state
        tile_hw = self._tile_hw(int(x.shape[1]), int(x.shape[2]))
        return torch.stack([
            tiled_apply(lambda t: fwd(state, t), x[i], tile_hw, self.halo,
                        self.scale, TILES_PER_STEP)
            for i in range(x.shape[0])
        ])

    def _tiled_sr_band(self, x: torch.Tensor, band: Band) -> torch.Tensor:
        """:meth:`_tiled_sr`'s output rows ``[band.lo, band.hi)`` of a frame
        of ``band.frame_h`` rows, from its model-domain rows ``[band.top,
        band.bottom)`` (exact from ``band.lo - halo`` to the tile rows'
        end plus ``halo``): the tile rows of the frame's own grid that the
        band's core covers."""
        fwd = self.sr_model.frames_forward("model")
        state = self.sr_model.state
        n, _, w, c = x.shape
        th, tw = self._tile_hw(band.frame_h, int(w))
        first = band.lo - self.halo  # frame row of rows[:, 0]
        k = -(-(band.hi - band.lo) // th)
        rows = x.new_zeros((n, k * th + 2 * self.halo, w, c))
        a, b = max(first, 0), min(first + rows.shape[1], band.frame_h)
        rows[:, a - first:b - first] = x[:, a - band.top:b - band.top]
        out = torch.stack([
            tiled_apply_rows(lambda t: fwd(state, t), rows[i], (th, tw),
                             self.halo, self.scale, TILES_PER_STEP)
            for i in range(n)
        ])
        return out[:, :(band.hi - band.lo) * self.scale]

    def _sr_frames(self, x: torch.Tensor) -> torch.Tensor:
        """The SR stage emitting uint8 RGB frames: tiled or whole-frame,
        averaged over the dihedral transforms under ``tta``."""
        if self.tta:
            if self.tile:
                apply = self._tiled_sr
            else:
                fwd = self.sr_model.frames_forward("model")
                apply = lambda v: fwd(self.sr_model.state, v)  # noqa: E731
            return model_to_frames(tta_apply(apply, x), self.channel_order)
        if self.tile:
            return model_to_frames(self._tiled_sr(x), self.channel_order)
        return self.sr_model.frames_forward("frames")(self.sr_model.state, x)

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-SR output -> uint8 RGB frames (the SR stage, if any)."""
        if self.sr_model is None:
            return model_to_frames(x, self.channel_order)
        return self._sr_frames(x)

    @property
    def step(self) -> Callable:
        """uint8 RGB (N, H, W, 3) -> uint8 RGB (N, sH, sW, 3)."""
        return self._finalize(("step",))

    @property
    def planar_scale(self) -> Optional[int]:
        """Shuffle factor of the shuffle-planar contract, or None (scale 1,
        ``tta``, the tiled path, RRDBNet's Interp tail).  The tail kernel
        writes the planar layout directly, so every planned SRVGG model has
        it whole-frame (the JAX Pallas path turns it off instead,
        chain.py:431)."""
        if self.sr_model is None or self.tile or self.tta:
            return None
        return self.sr_model.planar_scale

    @property
    def planar_step(self) -> Callable:
        """uint8 RGB (N, H, W, 3) -> uint8 planar (N, H, W, 3*s*s)."""
        return self._finalize(("planar",))

    def yuv_step(self, full_range: bool, planar: bool,
                 i420_in: Optional[Tuple[int, int, bool]] = None) -> Callable:
        """Step emitting the packed 4:2:0 contract from RGB frames or, with
        ``i420_in=(src_h, src_w, in_full_range)``, flat I420 input.  With
        ``planar`` the SR model's tail emits the packed layout (``emit=
        "yuv420"``: on the card one tail launch, no separate pack)."""
        return self._finalize(("yuv", full_range, planar, i420_in))

    def stage_fn(self, stage: str) -> Callable:
        """One stage alone as a uint8 RGB (N, H, W, 3) -> uint8 RGB step,
        for the PNG plane, which writes each stage's frames to disk (JAX
        chain.py:703-741): ``denoise`` is K6, ``anime`` the anime model's
        K1 chain, ``sr`` the SR stage (whole-frame K1 then K2 in its frames
        layout; tiled and ``--tta`` as :meth:`_sr_frames`)."""
        return self._finalize(("stage", stage))

    def _single(self, kind: tuple) -> Callable:
        """The step ``kind`` on this engine's device (``step``, ``planar``,
        ``yuv`` with its key, ``stage`` with its name); raises where the
        chain has no such step."""
        order = self.channel_order
        if kind[0] == "step":
            return lambda f: self._frames(self._prelude(self._to_model(f)))
        if kind[0] == "planar":
            fwd = self.sr_model.frames_forward("planar")
            return lambda f: fwd(self.sr_model.state,
                                 self._prelude(self._to_model(f)))
        if kind[0] == "yuv":
            return self._yuv_single(*kind[1:])
        stage = kind[1]
        if stage == "denoise":
            if not self.spec.denoise:
                raise ValueError("chain has no denoise stage")
            return lambda f: model_to_frames(self._denoise(self._to_model(f)),
                                             order)
        if stage == "anime":
            if self.anime_model is None:
                raise ValueError("chain has no anime stage")
            model = self.anime_model
            fwd = model.frames_forward("model")
            return lambda f: model_to_frames(fwd(model.state, self._to_model(f)),
                                             order)
        if stage == "sr":
            if self.sr_model is None:
                raise ValueError("chain has no SR stage (scale 1)")
            return lambda f: self._sr_frames(self._to_model(f))
        raise ValueError(f"unknown stage {stage!r}")

    def _yuv_single(self, full_range: bool, planar: bool,
                    i420_in: Optional[Tuple[int, int, bool]]) -> Callable:
        order = self.channel_order
        s = self.planar_scale
        if planar and (not s or s % 2):
            raise ValueError(f"planar yuv contract unavailable (planar_scale={s})")

        def fn(x):
            x = x.to(self.device)
            if i420_in is None:
                m = frames_to_model(x, order)
            else:
                src_h, src_w, in_full = i420_in
                m = i420_to_model(x, src_h, src_w, in_full, order)
            m = self._prelude(m)
            if planar:  # the tail writes the packed 4:2:0 layout itself
                return self.sr_model.frames_forward("yuv420")(
                    self.sr_model.state, m, full_range=full_range)
            return yuv420_from_frames(self._frames(m), full_range)

        return fn

    def _finalize(self, kind: tuple) -> Callable:
        """The step ``kind`` on whatever :meth:`use_mesh` selected (cached
        per kind): on one device the step itself; under ``dp`` a replica on
        each GPU takes its share of the batch
        (:func:`~upscale_video_tpu_torch.parallel.data.data_parallel_fn`);
        under ``sp`` each GPU takes a band of every frame's rows
        (:func:`~upscale_video_tpu_torch.parallel.spatial.sp_sharded_fn`;
        with ``--tta`` over a tiled SR stage, a band of each dihedral
        pass's tile rows, :meth:`_sp_tta`); under ``tp`` the step runs on
        the first GPU with its models' convs split over all of them
        (:func:`~upscale_video_tpu_torch.parallel.tensor.tensor_parallel_fn`)."""
        if self._steps is None:
            self._steps = {}
        if kind in self._steps:
            return self._steps[kind]
        if self._mesh is None:
            fn = self._single(kind)
        elif self._mesh_mode == "tp":
            self._warn_narrow_tp(self._mesh)
            fn = tensor_parallel_fn(self._tp._single(kind), self._mesh)
        elif (self._mesh_mode == "sp" and self.tta and self.tile
              and self.sr_model is not None
              and kind in (("step",), ("stage", "sr"))):
            fn = self._sp_tta(kind)
        elif self._mesh_mode == "sp":
            radius, period, tiled = self._sp_plan(kind)
            fn = sp_sharded_fn(
                lambda d: self.replica(d)._band(kind, tiled), self._mesh,
                radius, period=period)
        else:
            fn = data_parallel_fn(lambda d: self.replica(d)._single(kind),
                                  self._mesh)
        self._steps[kind] = fn
        return fn

    def _sp_plan(self, kind: tuple):
        """``(radius, period, tiled)`` of the step ``kind`` under ``sp``:
        a whole-frame step's bands are widened by its receptive radius (a
        multiple of the SR model's Reorg stride, at whose multiples they
        are cut); a tiled SR stage's are cut between tile rows and widened
        by the halo plus the pre-SR stages' radius."""
        if kind[0] == "yuv" and (kind[3] is not None or not kind[2]):
            raise ValueError(
                "--parallel sp takes uint8 frames in and the planar packed "
                "4:2:0 layout out (flat I420 input has no row axis; the "
                "full-frame packed layout halves the rows)")
        stage = kind[1] if kind[0] == "stage" else None
        if stage == "denoise":
            return NLMEANS_RADIUS, 1, False
        if stage == "anime":
            return graph_radius(self.anime_model.graph), 1, False
        pre = 0 if stage == "sr" else receptive_radius(self, sr=False)
        if self.sr_model is None:
            return pre, 1, False
        if self.tile:
            return (self.halo + pre,
                    lambda h, w: self._tile_hw(h, w)[0], True)
        align = max([l.attr_i(0, 1) for l in self.sr_model.graph.layers
                     if l.type == "Reorg"] or [1])
        radius = pre + graph_radius(self.sr_model.graph)
        return -(-radius // align) * align, align, False

    def _sp_tta(self, kind: tuple):
        """``--tta`` over a tiled SR stage under ``sp``: the step on the
        first GPU over the frame sp pads, each dihedral pass's frame cut
        into bands of its own tile grid's rows, one per GPU
        (:func:`~upscale_video_tpu_torch.parallel.spatial.sp_tiled_fn`;
        a rotated pass bands the frame's columns), each band's output
        gathered there before the pass is inverse-transformed and averaged
        in f32 as on one device.  The pre-SR stages run on the first GPU."""
        tiles = sp_tiled_fn(
            lambda d: self.replica(d)._tiled_sr_band, self._mesh, self.halo,
            lambda h, w: self._tile_hw(h, w)[0])
        first = dataclasses.replace(
            self.replica(self._mesh.axis_devices("sp")[0]), _tiles=tiles,
            _steps=None, _mesh=None, _mesh_mode="dp", _replicas=None)
        return row_padded_fn(first._single(kind), self._mesh)

    def _warn_narrow_tp(self, mesh: Mesh) -> None:
        """The guardrail of ``--parallel tp`` (JAX chain.py:566-590): with
        the widest conv under 128 channels per GPU, tp's exchange of every
        layer's activation almost certainly loses to dp or sp; say so.
        Once per engine (several steps get finalized)."""
        if self._tp_warned:
            return
        self._tp_warned = True
        widths = [int(p.wmat.shape[-1])
                  for m in (self.anime_model, self.sr_model) if m is not None
                  for p in m.state.values() if hasattr(p, "wmat")]
        n = mesh.size
        if widths and max(widths) < 128 * n:
            log.warning(
                "--parallel tp: widest conv is %d channels over %d GPUs "
                "(%d per GPU): tp exchanges every layer's activation between "
                "the GPUs, so dp (throughput) or sp (latency) is likely "
                "faster for these widths", max(widths), n, max(widths) // n)

    def _band(self, kind: tuple, tiled: bool) -> Callable:
        """The band step of ``kind`` on this engine's device for
        :func:`~upscale_video_tpu_torch.parallel.spatial.sp_sharded_fn`."""
        if not tiled:
            return whole_frame(self._single(kind))
        order = self.channel_order
        if kind[0] == "stage":
            return lambda f, band: model_to_frames(
                self._tiled_sr_band(self._to_model(f), band), order)
        return lambda f, band: model_to_frames(
            self._tiled_sr_band(self._prelude(self._to_model(f)), band),
            order)

    def replica(self, device: "torch.device | str") -> "ChainEngine":
        """This engine on ``device`` (itself on its own device): the same
        chain, its models' weights and packed images made there (cached)."""
        device = torch.device(device)
        if device == self.device:
            return self
        if self._replicas is None:
            self._replicas = {}
        if device not in self._replicas:
            self._replicas[device] = dataclasses.replace(
                self, device=device,
                sr_model=(self.sr_model.replicate(device)
                          if self.sr_model is not None else None),
                anime_model=(self.anime_model.replicate(device)
                             if self.anime_model is not None else None),
                _steps=None, _mesh=None, _mesh_mode="dp", _replicas=None,
                _tp=None, _tiles=None)
        return self._replicas[device]

    def process(self, frames_u8: np.ndarray) -> np.ndarray:
        """Run one host batch through :attr:`step`: uint8 RGB ``(N, H, W,
        3)`` in, uint8 RGB out on the host (the copy back waits for the
        devices' work)."""
        x = torch.from_numpy(np.ascontiguousarray(frames_u8))
        return self.step(x).cpu().numpy()

    @property
    def row_sharded(self) -> bool:
        """Whether steps run under ``--parallel sp`` (each frame's rows cut
        over the mesh)."""
        return self._mesh is not None and self._mesh_mode == "sp"

    @property
    def input_rank_flexible(self) -> bool:
        """Whether steps accept non-rank-4 inputs (the flat I420 input
        contract): ``sp`` cuts each input's rows and so needs rank-4 frames;
        one device, ``dp`` and ``tp`` are rank-agnostic (JAX chain.py:522)."""
        return not self.row_sharded

    def use_mesh(self, mesh: Mesh, mode: str = "dp") -> None:
        """Run every step over ``mesh``: ``dp`` splits each batch over its
        devices, ``sp`` each frame's rows, ``tp`` each conv's output
        channels.  Replicas of the models are made now on every device of
        the mesh but this engine's (under ``tp`` each entry's weight slices
        instead, :meth:`_use_tp`).  A mesh may list a device more than once
        (its shards then run on it in turn)."""
        if mode not in ("dp", "sp", "tp"):
            raise ValueError(f"unknown --parallel {mode!r} (dp, sp or tp)")
        if mode not in mesh.axis_names:
            raise ValueError(f"--parallel {mode} needs a mesh with a {mode!r} "
                             f"axis, got {mesh}")
        if mode != "dp" and any(
                has_window_attention(m.graph)
                for m in (self.sr_model, self.anime_model) if m is not None):
            raise ValueError(
                f"--parallel {mode} cannot split a shifted-window attention "
                "model (SwinIR): its windows see past any band of rows, and "
                "its token linears are no convs to split; use --parallel dp")
        self._mesh, self._mesh_mode = mesh, mode
        self._steps = None
        self._tp = None
        if mode == "tp":
            self._use_tp(mesh)
            return
        for d in mesh.distinct_devices():
            self.replica(d)

    def _use_tp(self, mesh: Mesh) -> None:
        """The engine the ``tp`` steps run: this one on the mesh's first
        device with each model over the mesh.  ``auto`` takes the
        ``pallas`` plan there; ``--conv_impl rdb`` keeps each dense block
        whole on every GPU, with the JAX package's warning (chain.py:
        621-653)."""
        base = self.replica(mesh.axis_devices("tp")[0])
        models = [m for m in (base.sr_model, base.anime_model) if m is not None]
        n = mesh.shape["tp"]
        if self.conv_impl == "auto":
            log.info("--parallel tp over %d GPUs: auto conv_impl takes the "
                     "pallas plan (no K5, no K1 chain: every conv on K4, its "
                     "output channels split)", n)
        elif any(tp_routes(m.conv_impl, m.compute_dtype)[1] for m in models):
            log.warning(
                "conv_impl=%s under --parallel tp over %d GPUs: K5 runs each "
                "dense block whole on every GPU; expect no multi-GPU speedup "
                "on kernel-claimed layers", self.conv_impl, n)
        self._tp = dataclasses.replace(
            base,
            sr_model=(TensorParallelModel(base.sr_model, mesh)
                      if base.sr_model is not None else None),
            anime_model=(TensorParallelModel(base.anime_model, mesh)
                         if base.anime_model is not None else None),
            _steps=None, _mesh=None, _mesh_mode="dp", _replicas=None,
            _tp=None, _tiles=None)

    def use_chips(self, chips: Optional[str], mode: str = "dp") -> int:
        """Apply a ``-g`` chip multiset: returns the batch multiplier.

        ``mode="dp"`` (default): several distinct GPUs -> frame-level data
        parallelism (the reference's primary axis, SURVEY.md §2.4);
        repetition of a chip id deepens the per-GPU batch instead of adding
        workers (README:39-63 intent).  ``mode="sp"``: each frame's rows are
        split across the GPUs (lower latency per frame instead of higher
        throughput); ``mode="tp"``: each conv's output channels are split
        across the GPUs (``parallel/tensor.py``).  Chip ``i`` is
        ``cuda:i``; on the CPU (``--device cpu``) ids are logical shards of
        the one CPU device."""
        chip_ids, multiplier = parse_chips(chips)
        if len(chip_ids) > 1:
            devices = select_devices(chip_ids, self.device.type)
            self.use_mesh(make_mesh({mode: len(devices)}, devices=devices),
                          mode)
        return multiplier

    def configure_chips(self, chips: Optional[str], frames_per_step: int,
                        mode: str = "dp") -> int:
        """Apply a ``-g`` multiset and return the adjusted frames-per-step
        (scaled by chip repetition; rounded up to a multiple of the dp
        mesh size so the batch splits evenly), as in JAX chain.py:638.
        Every workflow routes chip selection through here."""
        if not chips:
            return frames_per_step
        multiplier = self.use_chips(chips, mode=mode)
        frames_per_step = max(frames_per_step * multiplier, frames_per_step)
        n_chips = self._mesh.size if self._mesh is not None else 1
        if n_chips > 1 and mode == "dp" and frames_per_step % n_chips:
            frames_per_step = ((frames_per_step // n_chips) + 1) * n_chips
        log.info("chips %s -> frames_per_step %d over %d chip(s)",
                 chips, frames_per_step, n_chips)
        return frames_per_step

    def describe(self) -> str:
        return " -> ".join(self.spec.stage_names()) + f" (scale {self.scale}x)"


class BatchedStepper:
    """Accumulates frames into fixed-size device batches, one batch in
    flight: results come back one batch behind, as in the JAX stepper
    (chain.py:787-795), so the host decodes batch i+1 while the device
    runs batch i.

    On CUDA the two input buffers are pinned host tensors (ping-pong): a
    batch goes up with a non-blocking copy whose completion event is
    waited on before that buffer is refilled.  Each result comes down into
    a fresh pinned tensor (PyTorch's caching host allocator recycles them)
    with a non-blocking copy; its CUDA event is synchronised before the
    host reads it, since the copy call returns before the bytes land.  A
    step over a mesh (:class:`~upscale_video_tpu_torch.parallel.data.
    ShardedStep`) takes the pinned buffer itself, uploads each shard to its
    GPU and returns its pinned output with one event per shard, which
    stand for both.

    With a :class:`~upscale_video_tpu_torch.utils.trace.LoopTrace` it
    records the parts of the loop's ``infer`` stage: ``loop.pack`` (a frame
    into the pinned buffer), ``loop.h2d_wait`` (the buffer's last upload),
    ``loop.dispatch`` (upload, step and queued download, or
    ``ShardedStep.launch``) and ``loop.d2h_wait`` (the previous batch's
    download), each step's but ``loop.pack`` once per frame.
    """

    def __init__(self, step_fn: Callable, frames_per_step: int,
                 device: "torch.device | str", trace=None):
        self.step_fn = step_fn
        self.n = frames_per_step
        self.device = torch.device(device)
        self._trace = NO_TRACE if trace is None else trace
        self._cuda = self.device.type == "cuda"
        self._count = 0
        self._pending = None  # (host tensor, events, valid count)
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._h2d_done: List[list] = [[], []]
        self._slot = 0

    def _buf_for(self, frame: np.ndarray) -> np.ndarray:
        buf = self._bufs[self._slot]
        if buf is None or tuple(buf.shape[1:]) != frame.shape:
            if self._count:
                raise ValueError(
                    f"frame shape changed mid-batch: buffer holds "
                    f"{self._count} frame(s) of {tuple(buf.shape[1:])}, "
                    f"got {frame.shape}"
                )
            buf = torch.empty((self.n, *frame.shape),
                              dtype=torch.from_numpy(np.empty(0, frame.dtype)).dtype,
                              pin_memory=self._cuda)
            self._bufs[self._slot] = buf
            self._h2d_done[self._slot] = []
        if self._count == 0:
            # the previous upload from this buffer must have landed
            with self._trace.span("loop.h2d_wait"):
                for ev in self._h2d_done[self._slot]:
                    ev.synchronize()
            self._h2d_done[self._slot] = []
        return buf.numpy()

    def _collect(self) -> List[np.ndarray]:
        if self._pending is None:
            return []
        host, events, valid = self._pending
        self._pending = None
        with self._trace.span("loop.d2h_wait"):
            for ev in events:
                ev.synchronize()
        arr = host.numpy()
        return [arr[i] for i in range(valid)]

    def _dispatch(self, valid: int) -> List[np.ndarray]:
        buf = self._bufs[self._slot]
        with self._trace.span("loop.dispatch"):
            if isinstance(self.step_fn, ShardedStep):
                host, events = self.step_fn.launch(buf)
                self._h2d_done[self._slot] = events
            elif self._cuda:
                with torch.cuda.device(self.device):
                    stream = torch.cuda.current_stream(self.device)
                    dev_in = buf.to(self.device, non_blocking=True)
                    up = torch.cuda.Event()
                    up.record(stream)
                    self._h2d_done[self._slot] = [up]
                    out = self.step_fn(dev_in)
                    host = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                events = [ev]
            else:
                host = self.step_fn(buf)  # a new tensor: never aliases buf
                events = []
        done = self._collect()
        self._pending = (host, events, valid)
        self._slot = 1 - self._slot
        return done

    def feed(self, frame: np.ndarray) -> List[np.ndarray]:
        """Add one frame; returns any completed output frames (in order)."""
        buf = self._buf_for(frame)
        with self._trace.span("loop.pack"):
            np.copyto(buf[self._count], frame)
        self._count += 1
        if self._count < self.n:
            return []
        self._count = 0
        return self._dispatch(self.n)

    def flush(self) -> List[np.ndarray]:
        """Process the trailing partial batch (padded with its last frame)
        and drain the pipeline."""
        out: List[np.ndarray] = []
        if self._count:
            valid = self._count
            buf = self._bufs[self._slot].numpy()
            for i in range(valid, self.n):
                np.copyto(buf[i], buf[valid - 1])
            self._count = 0
            out.extend(self._dispatch(valid))
        out.extend(self._collect())
        return out
