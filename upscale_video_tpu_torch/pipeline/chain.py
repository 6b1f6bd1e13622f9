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
  step's output layout);
- SR, ``-m r``'s 4x Valar RRDBNet, tiled: haloed tiles -> the graph walk
  (K5 per dense block, K4 per solo 3x3 conv, one K1 chain for the last
  three) -> scaled-halo crop;
- SR, ``-m sr=<stem>``, an imported model (``vsr-import-torch``),
  whole-frame unless ``--tile_size``: an SRVGG on K1 + K2 or, where its
  body is no chain, the graph walk with K4 and K3; an RRDBNet such as
  RealESRGAN_x4plus on the graph walk (K4 per 3x3 conv outside its one K1
  chain);
- ``--tta`` averages the SR stage's model-domain output over the 8
  dihedral transforms (K2's f32 layout for Compact);
- scale 1 has no SR stage: the pre-SR stages' output is quantized.

``ChainEngine.stage_fn`` runs one of these stages alone, uint8 in and out,
for the PNG plane (``pipeline/stages.py``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from upscale_video_tpu_torch.models.zoo import (
    Model, load_model, make_synthetic_model, make_synthetic_rrdb_model,
)
from upscale_video_tpu_torch.ops.nlmeans import nl_means_denoise
from upscale_video_tpu_torch.ops.pixel import frames_to_model, model_to_frames
from upscale_video_tpu_torch.ops.tiling import fit_tile_grid, tiled_apply
from upscale_video_tpu_torch.ops.tta import tta_apply
from upscale_video_tpu_torch.ops.yuv import i420_to_model, yuv420_from_frames

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


def parse_chips(chips: Optional[str]) -> Tuple[List[int], int]:
    """``"0,0,1"`` -> (unique ids [0, 1], multiplier 2), as the JAX
    ``parallel.mesh.parse_chips``."""
    if not chips:
        return [0], 1
    try:
        ids = [int(g) for g in chips.split(",")]
    except ValueError as e:
        raise ValueError(f"invalid chips spec {chips!r}") from e
    uniq = sorted(set(ids))
    return uniq, max(ids.count(i) for i in uniq)


@dataclass
class ChainEngine:
    """Executes the model chain on batches of uint8 frames on one device.

    Step callables take and return device tensors: uint8 ``(N, H, W, 3)``
    frames (or flat I420 ``(N, h*w*3//2)`` under ``i420_in``) in, the
    contract's uint8 layout out.  ``sr_model`` is None at scale 1;
    ``anime_model`` is the ``a`` stage or None.  ``tile`` is 0 (whole
    frame), a budget (:func:`~upscale_video_tpu_torch.ops.tiling.fit_tile_grid`)
    or an exact ``(th, tw)`` pair; ``halo`` is the tiles' context border;
    ``tta`` averages the SR stage over the 8 dihedral transforms."""

    spec: ChainSpec
    scale: int
    sr_model: Optional[Model]
    device: torch.device
    anime_model: Optional[Model] = None
    tile: "int | tuple" = 0
    halo: int = 16
    tta: bool = False
    channel_order: str = "bgr"
    _yuv_steps: dict = field(default=None, repr=False)

    @classmethod
    def build(cls, spec: ChainSpec, scale: int, device: "torch.device | str",
              model_path: Optional[str] = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              synthetic: bool = False,
              residual_dtype: Optional[torch.dtype] = None,
              tile: "int | tuple | None" = None,
              halo: int = 16, tta: bool = False) -> "ChainEngine":
        """Load the chain's models on ``device``: the anime role (scale 1)
        for ``a``; for the SR stage (none at scale 1) the stock Compact
        role, the Valar role for ``-m r`` (forcing 4x), or the file
        ``{scale}{stem}`` for ``sr=<stem>`` (JAX chain.py:264-276).
        ``synthetic`` takes random-weight stand-ins of the same
        architectures (for ``a`` the JAX chain's ``make_synthetic_model(
        scale=1, num_conv=8, num_feat=24)``, for ``-m r`` the 23-RRDB
        ``make_rrdb_graph``, for ``sr=`` the Compact, the stem ignored, as
        in JAX).  ``tile=None`` takes the family's default
        (:func:`default_tile`); ``-m r`` and ``sr=`` take a tile.
        ``residual_dtype`` (``mixed``) is for ``-m r`` and ``sr=`` graphs on
        the graph walk (an SRVGG on K1 + K2 refuses it at plan time), and
        reaches the anime model too, as in the JAX chain (chain.py:248)."""
        device = torch.device(device)
        scale = spec.effective_scale(scale)
        if tile is None:
            tile = default_tile(spec)
        if tile and not (spec.real_life or spec.sr_file):
            raise NotImplementedError(
                "tiling is ported for -m r and sr= only (Compact runs "
                "whole-frame)")
        if residual_dtype is not None and not (spec.real_life or spec.sr_file):
            raise NotImplementedError(
                "--precision mixed is ported for -m r and sr= only")
        anime = None
        if spec.anime:
            anime = (make_synthetic_model(
                        scale=1, num_conv=8, num_feat=24, device=device,
                        compute_dtype=compute_dtype,
                        residual_dtype=residual_dtype)
                     if synthetic else
                     load_model("anime", 1, device, model_path,
                                compute_dtype, residual_dtype))
            anime.frames_forward("model")  # plan now
        model = None
        if scale > 1 and spec.real_life:
            model = (make_synthetic_rrdb_model(
                        scale=scale, num_rrdb=23, device=device,
                        compute_dtype=compute_dtype,
                        residual_dtype=residual_dtype)
                     if synthetic else
                     load_model("valar", scale, device, model_path,
                                compute_dtype, residual_dtype))
            model.frames_forward("model")  # plan now
        elif scale > 1:
            model = (make_synthetic_model(scale=scale, device=device,
                                          compute_dtype=compute_dtype,
                                          residual_dtype=residual_dtype)
                     if synthetic else
                     load_model(spec.sr_file or "compact", scale, device,
                                model_path, compute_dtype, residual_dtype))
            # plan now: an unsupported graph raises before any frame is read
            model.frames_forward("planar" if model.planar_scale else "model")
        return cls(spec=spec, scale=scale, sr_model=model, device=device,
                   anime_model=anime, tile=tile, halo=halo, tta=tta)

    def _to_model(self, frames_u8: torch.Tensor) -> torch.Tensor:
        return frames_to_model(frames_u8.to(self.device), self.channel_order)

    def _denoise(self, x: torch.Tensor) -> torch.Tensor:
        """NL-means at strength ``n=K`` over the whole frame batch: one K6
        launch on the card."""
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

    def _tiled_sr(self, x: torch.Tensor) -> torch.Tensor:
        """Model-domain (N, H, W, 3) -> (N, sH, sW, 3) f32 over haloed
        tiles; each frame's tiles go through the model in batches of
        :data:`TILES_PER_STEP`."""
        fwd = self.sr_model.frames_forward("model")
        state = self.sr_model.state
        tile_hw = (self.tile if isinstance(self.tile, tuple)
                   else fit_tile_grid(int(x.shape[1]), int(x.shape[2]),
                                      self.tile))
        return torch.stack([
            tiled_apply(lambda t: fwd(state, t), x[i], tile_hw, self.halo,
                        self.scale, TILES_PER_STEP)
            for i in range(x.shape[0])
        ])

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
        return lambda f: self._frames(self._prelude(self._to_model(f)))

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
        fwd = self.sr_model.frames_forward("planar")
        return lambda f: fwd(self.sr_model.state,
                             self._prelude(self._to_model(f)))

    def yuv_step(self, full_range: bool, planar: bool,
                 i420_in: Optional[Tuple[int, int, bool]] = None) -> Callable:
        """Step emitting the packed 4:2:0 contract from RGB frames or, with
        ``i420_in=(src_h, src_w, in_full_range)``, flat I420 input.  With
        ``planar`` the SR model's tail emits the packed layout (``emit=
        "yuv420"``: on the card one tail launch, no separate pack)."""
        if self._yuv_steps is None:
            self._yuv_steps = {}
        key = (full_range, planar, i420_in)
        if key in self._yuv_steps:
            return self._yuv_steps[key]
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

        self._yuv_steps[key] = fn
        return fn

    def stage_fn(self, stage: str) -> Callable:
        """One stage alone as a uint8 RGB (N, H, W, 3) -> uint8 RGB step,
        for the PNG plane, which writes each stage's frames to disk (JAX
        chain.py:703-741): ``denoise`` is K6, ``anime`` the anime model's
        K1 chain, ``sr`` the SR stage (whole-frame K1 then K2 in its frames
        layout; tiled and ``--tta`` as :meth:`_sr_frames`)."""
        order = self.channel_order
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

    @property
    def input_rank_flexible(self) -> bool:
        """Steps accept the flat I420 input (no row sharding here)."""
        return True

    def configure_chips(self, chips: Optional[str],
                        frames_per_step: int) -> int:
        """Apply a ``-g`` multiset on one GPU: repetition of the one id
        deepens the batch (as in JAX); more than one GPU raises."""
        ids, multiplier = parse_chips(chips)
        if len(ids) > 1:
            raise NotImplementedError(
                f"-g {chips}: multi-GPU runs are not ported yet (one GPU)")
        if chips:
            frames_per_step = max(frames_per_step * multiplier, frames_per_step)
            log.info("chips %s -> frames_per_step %d", chips, frames_per_step)
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
    host reads it, since the copy call returns before the bytes land.
    """

    def __init__(self, step_fn: Callable, frames_per_step: int,
                 device: "torch.device | str"):
        self.step_fn = step_fn
        self.n = frames_per_step
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._count = 0
        self._pending = None  # (host tensor, event or None, valid count)
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._h2d_done: List[Optional[torch.cuda.Event]] = [None, None]
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
            self._h2d_done[self._slot] = None
        if self._count == 0 and self._h2d_done[self._slot] is not None:
            # the previous upload from this buffer must have landed
            self._h2d_done[self._slot].synchronize()
            self._h2d_done[self._slot] = None
        return buf.numpy()

    def _collect(self) -> List[np.ndarray]:
        if self._pending is None:
            return []
        host, ev, valid = self._pending
        self._pending = None
        if ev is not None:
            ev.synchronize()
        arr = host.numpy()
        return [arr[i] for i in range(valid)]

    def _dispatch(self, valid: int) -> List[np.ndarray]:
        buf = self._bufs[self._slot]
        if self._cuda:
            dev_in = buf.to(self.device, non_blocking=True)
            up = torch.cuda.Event()
            up.record()
            self._h2d_done[self._slot] = up
            out = self.step_fn(dev_in)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host = self.step_fn(buf)  # a new tensor: never aliases buf
            ev = None
        done = self._collect()
        self._pending = (host, ev, valid)
        self._slot = 1 - self._slot
        return done

    def feed(self, frame: np.ndarray) -> List[np.ndarray]:
        """Add one frame; returns any completed output frames (in order)."""
        buf = self._buf_for(frame)
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
