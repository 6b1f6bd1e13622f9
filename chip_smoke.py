"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``upscale_video_tpu_torch/csrc/`` with
nvcc, holds each against its plain PyTorch version on the card at its main
path's shapes, and drives the ported paths end to end through
``upscale-video-torch`` on hermetic 1080p Y4M clips under both device
contracts, counting kernel launches:

- the default path: 2x Compact (K1 + K2), 4 frames per step, 1080p -> 4K;
  its 4:2:0 contract writes the packed layout from K2's one launch;
- ``-m r``: the 4x Valar RRDBNet at full width and depth (23 RRDBs, K5
  per dense block on its Hopper kernel ``csrc/rdb_block_sm90.cu``, K4 for
  conv_first, conv_trunk and conv_up1, one K1 chain for the last three
  convs), mixed precision, 544-budget tiles with halo 16, 1 frame per
  step, 1080p -> 4K;
- ``-m a,n=3``: NL-means at strength 3 (K6 on its Hopper kernel
  ``csrc/nlmeans_sm90.cu``, one launch per step), the 1x
  SubCompact anime deblur model (nf 24, one 10-layer K1 chain), then the
  default 2x Compact (K1 + K2), 4 frames per step;
- ``--tta`` on the default path: one 1080p frame through the 8 dihedral
  transforms (K2's f32 layout);
- ``-m sr=x_RealESRGAN_x4plus``: RealESRGAN_x4plus's architecture (basicsr
  RRDBNet, 23 RRDBs, nf 64, gc 32) as a state dict made from a seed,
  converted by ``vsr-import-torch``, whole-frame, bf16, 1 frame per step:
  348 K4 launches per frame (347 on its sm90 kernel, each dense block's
  five convs on one shared 192-channel buffer, no torch.cat) and one
  3-layer K1 chain;
- ``-m sr=`` of a wide SRVGGNetCompact (nf 160, 4x), converted the same
  way: K4 per body conv (PReLU fused; the 160->160 body on sm90), one K3
  launch per step;
- ``[png_plane]``: ``--data_plane png --pipe_pix rgb24`` on the default
  path's 12-frame clip, the default chain (K1 then K2 in its frames
  layout per fragment; its output byte-compared with the stream plane's
  rgb24 output) and ``-m a,n=3`` (K6 and the anime K1 chain over all 12
  frames, then SR per fragment; held to its three ``stage_fn``s on the
  plain versions), with the port's PNG codec timed on a 4K frame;
- ``[workflows]``: ``upscale-only-torch`` and ``merge-only-torch`` (equal
  to the png plane's output), ``-x``, ``test-images-torch -m n=3`` (K6),
  ``fix-frames-torch`` (equal to the zipped frames) and
  ``vsr-compare-torch`` on the card;
- ``[flags]``: the flags the port took last, through the CLI under both
  contracts: ``--conv_impl xla`` (no kernel launch; against the default
  run), ``-m n=3 --conv_impl xla`` (no kernel, NL-means plain; against
  ``-m n=3`` on the default route), ``--conv_impl pallas -m r`` (no K5, every dense conv on K4's sm90
  kernel; against the ``-m r`` run), ``--precision f32`` on the default
  path and ``-m r`` (no conv kernel; one small frame within 1 LSB of the
  CPU), ``--tile_size 256`` (K2 in its f32 model layout on the tile
  batches), ``--precision mixed`` (byte-equal to the default run),
  ``--trace_dir`` (the trace names K1's sm90 kernel), ``--tta``, ``-s 1
  -m a,n=3``, ``-s 4``, ``-m n=3,r`` and ``-m a,r``; then
  ``test-chips-torch`` on the default chain and on ``-m r`` with one tile.
  ``[K4_valar]`` holds K4 at Valar's five dense-block shapes on the
  ``-m r`` tile batch (the ``pallas`` route's) and ``[K2_tiles]`` K2's
  model layout at ``--tile_size 256``'s tile batch, each against its plain
  version.

K2 and K3 run on their Hopper kernels (``csrc/sr_tail_sm90.cu``: K2 on
K1's narrow ring mainloop for Cf 64, K3 on K4's halo mainloop for Cf a
multiple of 32 up to 192, at 2x and 4x) and every other shape on the WMMA
kernels of ``csrc/sr_tail.cu``: ``[K2]`` holds K2 at the main path's
4x1080p in every layout (planar, frames, model, yuv420 in both ranges)
against its plain version, ``[K2_ab]`` times it beside its WMMA kernel,
the plain version and cuDNN's bf16 conv of the same shape alone (a
yardstick), ``[K2_yuv_ab]`` the fused 4:2:0 launch against planar +
``yuv420_from_planar``; ``[K3]`` and ``[K3_ab]`` do the same for K3 at
``K3_CASES``; every CLI run, ``--tta`` and ``[yuv420_step]`` check that
each K2 and K3 launch ran on the Hopper kernel and no 4:2:0 pack ran
outside it.

- the conv-body research path: ``upscale_video_tpu_torch.tools.wino_bench``
  (cuDNN, K1, K7 row-Winograd) and ``tools.q8_bench`` (K8 int8, K1,
  cuDNN), each run at its defaults (16 x 64->64 PReLU convs on a 1080p
  frame) as a subprocess through ``python -m``; their ``[launches]`` lines
  give K7's and K8's launch counts, each counted from 0 in that process,
  and every 64->64 K7 launch of ``wino_bench`` and K8 launch of
  ``q8_bench`` must be on the sm90 kernel.

Weights are synthetic (seed 0).  K1 runs its 64->64 layers on the
persistent TMA + wgmma kernel (``csrc/conv3x3_chain_sm90.cu``), its
24->24, 3->64, 3->24, 24->3 and 64->3 layers on the narrow Hopper kernel
(``csrc/conv3x3_chain_narrow_sm90.cu``) and every other shape on the WMMA
kernel: ``[K1_sm90]`` holds one sm90 layer per activation against the
plain version at 4x1080p and two ragged shapes (ring checked),
``[K1_ab]`` times one 64->64 PReLU layer at 4x1080p on the WMMA kernel
(called directly), the sm90 kernel and cuDNN; ``[K1_narrow]`` holds each
narrow shape per activation at 4x1080p and three ragged sizes, and at
its path's size (4x1080p; the 64->3 layer also at ``-m r``'s and ESRGAN's
4x sizes), finite, ring and padding checked, on the narrow kernel;
``[K1_shapes_ab]`` times each of those layers on the narrow kernel, the
WMMA kernel (called directly) and cuDNN, each with its share of the
bound; and every CLI run counts the Hopper launches (all 17 of the
default step's layers, all 10 of the anime chain's, all three of the last
RRDBNet chain's) and the narrow ones among them.  K4 runs every bf16 conv with cin a multiple
of 32 (up to 192) and cout a multiple of 16 on the persistent TMA + wgmma
kernel (``csrc/conv3x3_fused_sm90.cu``) and the 3- and 12-channel heads on
the WMMA kernel: ``[K4_sm90]`` holds every ``K4_SHAPES`` row against the
plain version (the kernel each took, and a sliced call: input read from a
wider buffer, output written at a channel offset of a sentinel-filled one,
bit-equal to the contiguous call, sentinels untouched) and each conv of a
dense block run on one shared buffer; ``[K4_ab]`` times each dense shape
and one dense block on the sm90 kernel, the WMMA kernel (called directly)
and cuDNN; every CLI run counts the sm90 launches.  ``[K5_sm90]`` holds
K5's Hopper kernel against its plain version at four shapes, ``[K5_ab]``
times it beside the plain version and two yardsticks (the block's convs on
K4's sm90 kernel and on cuDNN), and ``[valar_profile]`` splits one 1080p
``-m r`` step's device time by kernel.  K1 is held against its plain version at
every path's shapes (the Compact stack and the anime chain at 4x1080p;
``-m r``'s last three convs on a 1080p frame's tiles at 4x), K4 at every
ESRGAN conv shape at 1080p (and ``-m r``'s three solo convs), K3 at
4x1080p, K6 at 4x1080p, 2x37x53 and 1x7x33 (``[K6_time]`` beside
its registers and its main loop's instructions from ``cuobjdump``, each
pipe's count priced as an estimated floor), and the whole 1080p ``-m r``,
ESRGAN and ``--tta`` steps against the same steps on the plain versions; K7 over the benches'
16-layer body at 4x1080p, a ragged 3->64->64 stack (split 1 WMMA + 1
sm90 launch, ring checked) and one layer alone (K7 runs its 64->64 layers on the persistent TMA + wgmma kernel
``csrc/conv_winograd_sm90.cu`` and every other shape on the WMMA kernel:
``[K7_sm90]`` holds one sm90 layer per activation at 4x1080p and four
ragged shapes against the plain version (finite, ring checked),
``[K7_ab]`` times one 64->64 PReLU layer at 4x1080p on the sm90 kernel,
K7's WMMA kernel, K1's sm90 layer and cuDNN), K8
over the body at 1x1080p (all 16 layers on the sm90 kernel) and the
ragged 3->64->64 stack (1 mma.sync + 1 sm90 launch), bit for bit (K8 runs
its 64->64 layers on the persistent TMA + wgmma kernel
``csrc/conv_chain_q8_sm90.cu`` and every other shape on the mma.sync
kernel ``csrc/conv_chain_q8.cu``: ``[K8_sm90]`` holds one sm90 layer,
int8 and bf16 out, at 4x1080p (PReLU) and for each activation at five
ragged shapes against its plain step bit for bit, ring checked;
``[K8_ab]`` times one 64->64 PReLU int8 -> int8 layer at 4x1080p on the
sm90 kernel and the mma.sync kernel (called directly), and the bf16-out
layer, each with its share of the per-layer bound), then the
body's A/B at 4x1080p (K1, K7, K7 on its WMMA kernel, K8, cuDNN, each with
its bound and the per-layer HBM floor).  It then times each step against its plain version.  Every phase prints one line; any failure
raises and the script exits non-zero without printing a result.  The last
three lines are a JSON object with each kernel's figures (its bound
computed from the card's published peaks), the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np

N, H, W = 4, 1080, 1920       # the main path's step: 4 frames of 1080p
CLIP_FRAMES = 12               # 3 steps; 2 fragments of 6 frames (1 min each)
CLIP_RATE = "1:10"             # 0.1 fps: -b 1 (one minute) = 6 frames
VALAR_CLIP_FRAMES = 3          # 3 steps of 1 frame; fragments of 2 + 1
VALAR_CLIP_RATE = "1:30"       # -b 1 (one minute) = 2 frames
VALAR_BLOCKS = 69              # 23 RRDBs x 3 dense blocks: K5 launches/step
VALAR_SOLOS = 3                # first, trunk, up1: K4 launches per step
VALAR_SOLOS_SM90 = 2           # trunk and up1 (64->64) on K4's sm90 kernel
VALAR_CHAIN = 3                # up2 -> hr -> last: one K1 chain per step
LAST_CHAIN_SM90 = 3            # all three on Hopper: up2 and hr (64->64) on
                               # the sm90 kernel, last (64->3) on the narrow one
COMPACT_HOPPER = 17            # all 17 layers on Hopper: the body on the sm90
                               # kernel, the 3->64 head on the narrow one
# each 3x3 conv of -m r with the factor its 1080p tiles are upscaled by
# there: the three solo convs run on K4, the last three on K1
VALAR_K4_LAYERS = (("conv_first", 1), ("conv_trunk", 1), ("conv_up1", 2))
VALAR_K1_LAYERS = (("conv_up2", 4), ("conv_hr", 4), ("conv_last", 4))
ESRGAN_RRDBS = 23              # RealESRGAN_x4plus: 23 RRDBs, nf 64, gc 32
ESRGAN_STEM = "x_RealESRGAN_x4plus"
ESRGAN_CLIP_FRAMES = 3         # 3 steps of 1 frame; fragments of 2 + 1
# the 1080p sr=RealESRGAN_x4plus step (bf16) vs the same step on the
# plain versions, per RRDB count: (min dB, max u8 LSB).  Same rounding
# points, so only f32 summation order differs; a K4 output one bf16 ulp
# apart propagates and grows with depth through the synthetic weights.
# Measured on an NVIDIA H100 80GB HBM3: 63.52 dB / 1 LSB at 2 RRDBs,
# 48.77 dB / 7 LSB at 23 (22% of the output clips); both paths are
# deterministic, so the bounds keep ~7 dB of margin
ESRGAN_PLAIN_BOUNDS = {2: (55.0, 4), ESRGAN_RRDBS: (42.0, 32)}
WIDE_NF, WIDE_CONVS = 160, 8   # the wide SRVGG: 9 body convs of nf 160, 4x
WIDE_STEM = "x_wide_srvgg_nf160"
WIDE_CLIP_FRAMES = 4           # 2 fragments of 2 frames: 2 padded steps
# its planar step vs the same step on the plain versions (74.93 dB, 1 LSB
# measured on an NVIDIA H100 80GB HBM3)
WIDE_MIN_PSNR = 60.0
# K3's f32 layout: the same f32 value summed in another order
K3_MODEL_ATOL = 1e-4
# K4 at the ESRGAN conv shapes on one 1080p frame, (cin, cout, act, h, w):
# conv_first, the five dense convs, conv_up1 at 4K, a wide SRVGG body
# layer, and the x2plus conv_first at a ragged shape
K4_SHAPES = ((3, 64, "none", H, W), (64, 32, "leaky", H, W),
             (96, 32, "leaky", H, W), (128, 32, "leaky", H, W),
             (160, 32, "leaky", H, W), (192, 64, "none", H, W),
             (64, 64, "leaky", 2 * H, 2 * W), (160, 160, "prelu", H, W),
             (12, 64, "none", 37, 53))
K4_DENSE = ((64, 32), (96, 32), (128, 32), (160, 32), (192, 64))
K3_CASES = ((64, 2), (64, 4), (160, 2), (160, 4))  # (Cf, s) at 4x1080p
# the tails' layouts, (layout, full_range): yuv420 in both ranges
TAIL_LAYOUTS = (("planar", False), ("frames", False), ("model", False),
                ("yuv420", False), ("yuv420", True))
TILES = (8, 576, 512)          # one 1080p frame: 2x4 tiles of 544x480 + halo
# K1 after 17 layers: each layer rounds once to bf16 after an f32 sum whose
# order differs from cuDNN's, so a value may land one bf16 ulp apart and
# the ulp propagates through later layers (tests/test_conv_chain.py:70).
K1_ATOL, K1_RTOL = 5e-2, 2e-2
# K1 or K4 as one layer: the one rounding may land one bf16 ulp (<= 2**-7
# * |v|) away after an f32 sum in another order; atol for sums near 0
K1_LAYER_ATOL, K1_LAYER_RTOL = 2.0 ** -10, 2.0 ** -7
# K1 over the 10-layer anime chain: its output is small (the synthetic
# N(0, 0.05) weights shrink the signal layer by layer), so the whole-chain
# bound is a few bf16 ulps of the output scale: a flipped rounding cascades
# through the later layers (measured at most 2**-11 on an NVIDIA H100 80GB
# HBM3).  A layer that drops a channel or a tap moves this damped output by
# little, so each layer is also held alone at unit-scale inputs to the
# one-rounding class above.
K1_ANIME_ATOL, K1_ANIME_RTOL = 2.0 ** -10, 2.0 ** -7
K2_MAX_LSB = 1                 # u8: an ulp-level difference at a boundary
TAIL_YARDSTICK = ("cuDNN bf16 conv of the tail's shape alone (F.conv2d, "
                  "channels-last): a yardstick, not the same function")
# (yuv420: the pack of a planar byte one LSB away moves its 4:2:0 bytes by
# at most one LSB; the pack itself equals yuv420_from_planar's arithmetic)
E2E_MIN_PSNR = 40.0            # bf16 CUDA step vs the f32 plain path, dB
# K5: a per-source piece may round one bf16 ulp away from the plain
# version's (tensor-core vs cuDNN f32 summation order); through 0.2 * c5 it
# moves the output by up to 2**-6 + 2**-7 * |out| at the synthetic Valar
# weights (measured at most 0.015625 on an NVIDIA H100 80GB HBM3)
K5_ATOL, K5_RTOL = 2.0 ** -6, 2.0 ** -7
# [K5_sm90]: the -m r tiles of a 1080p frame, a ragged batch, a frame
# smaller than one 12x16 tile, one whose rows and columns fit no whole tile
K5_SM90_SHAPES = (TILES, (2, 37, 53), (1, 5, 7), (1, 61, 70))
# [K5_ab]: the least share of its bound K5 must reach at TILES (an earlier
# mma.sync version reached 0.093, the Hopper kernel 0.181 on an NVIDIA
# H100 80GB HBM3 at 700 W)
K5_MIN_BOUND_SHARE = 0.12
VALAR_MIN_PSNR = 36.0          # mixed -m r step vs the f32 plain path, dB
# (37.15 dB measured on an NVIDIA H100 80GB HBM3 for the 1x64x96 frame at
# 23 RRDBs below; PARITY.md's bf16 quality class for the model is 34.5 dB)
# the 1080p -m r step vs the same step on the plain versions, per RRDB
# count: (min dB, max u8 LSB).  Both paths are deterministic; one ulp moved
# anywhere grows with depth through the synthetic weights (the output
# reaches about +-40 in the model domain at 23 RRDBs, so most pixels
# clip): measured on an NVIDIA H100 80GB HBM3, 57.25 dB / 2 LSB at 2
# RRDBs and 36.10 dB / 138 LSB at 23, where swapping K1 or K5 alone gives
# the same 36 dB.  23 RRDBs take the model's bf16 quality class, 34 dB.
VALAR_PLAIN_BOUNDS = {2: (50.0, 4), 23: (34.0, 255)}
# K6: the box sum and channel mean in another f32 order than the plain
# version (shared row pairs, shuffle pairs), the scales folded into one and
# the SFU's ex2; weights exp(-d/h^2) amplify d's ulps by d/h^2 (<= ~20
# where a weight still counts), so a few f32 ulps of v
K6_ATOL, K6_RTOL = 1e-5, 1e-5
PRELUDE = "a,n=3"              # the pre-SR path: denoise at 3, anime deblur
ANIME_LAYERS = 10              # 3->24, 8 x 24->24 (PReLU), 24->3: one chain
# the K1 shapes on the narrow Hopper kernel, each at its path's size:
# (cin, cout, act, (n, h, w), where it runs)
K1_NARROW_SHAPES = (
    (24, 24, "prelu", (N, H, W), "anime layers 1-8"),
    (3, 64, "prelu", (N, H, W), "default head"),
    (3, 24, "prelu", (N, H, W), "anime layer 0"),
    (24, 3, "none", (N, H, W), "anime layer 9"),
    (64, 3, "none", (TILES[0], 4 * TILES[1], 4 * TILES[2]), "-m r conv_last"),
    (64, 3, "none", (1, 4 * H, 4 * W), "ESRGAN conv_last"),
)
# [K1_narrow]'s ragged sizes: W no multiple of the 64-wide tile, H none of
# its rows, and a frame smaller than one tile
K1_NARROW_RAGGED = ((2, 37, 53), (1, 67, 130), (1, 5, 7))
TTA_MIN_PSNR = 45.0            # --tta step vs the same step on the plain versions
# --tile_size on the default chain vs the same tiled step on the plain
# versions: the --tta bound (the same kernels at other shapes)
TILED_MIN_PSNR = 45.0
TILE_BUDGET = 256              # [flags]' --tile_size: 40 tiles of 216x240 at 1080p
# --conv_impl xla vs the default route on the default chain, over the
# output files' Y4M payloads: the bound tests/test_torch_slice.py holds
# the same two routes to on the CPU.  The tail's one rounding point moves
# (bf16 sum of conv and skip, or K2's f32 one: 1 LSB), and on the card
# each body layer's f32 sum runs in another order (cuDNN's, K1's), so a
# bf16 ulp may move and propagate, as for -m r at 2 RRDBs (50 dB, 4 LSB);
# under -m n=3 NL-means (K6, or its plain version under xla) sums its f32
# box sums in another order too, which moves the SR input by f32 ulps
XLA_MIN_PSNR, XLA_MAX_LSB = 50.0, 4
F32_MAX_LSB = 1                # f32 on the card vs the same run on the CPU
NO_KERNEL = "no kernel"        # [flags]: a run that launches no hand kernel
VALAR_DENSE = VALAR_BLOCKS * 5  # --conv_impl pallas -m r: K4 per dense conv
TRACE_K1 = "chain_layer_sm90"  # K1's sm90 kernel, as a profiler trace names it
# [png_plane]: the png plane's -m a,n=3 output vs the same three stages
# (u8 between them, as the plane stores them) on the plain versions, PSNR
# over the output files' Y4M payloads: only summation-order ulps differ
# (58.76 dB, 2 LSB measured on an NVIDIA H100 80GB HBM3 at 700 W), the
# bound ~7 dB under that reading
PNG_PRELUDE_MIN_PSNR = 52.0
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense, at
# 700 W): HBM bytes/s and
# operations/s per type.  The SFU's exp rate is 16 per clock per SM
# against FP32's 256 flops, so a sixteenth of the FP32 peak.
PEAK_HBM = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "exp": 67e12 / 16}
# the conv-body benches' default body: 16 x 64->64 3x3 convs with PReLU
BODY_LAYERS, BODY_C = 16, 64
# [K8_sm90]'s ragged sizes: a frame smaller than one 3x64 tile, W no
# multiple of 64, H none of 3, N = 3, a frame under 64 columns
K8_RAGGED = ((1, 5, 7), (2, 37, 53), (1, 67, 130), (3, 18, 70), (1, 9, 40))
# K7 over that body and one layer alone take K1's bounds (K1_ATOL/RTOL,
# K1_LAYER_ATOL/RTOL): each M_a is an f32 sum in another order than
# cuDNN's, then the same f32 output transform and one bf16 rounding.  K8
# sums exactly in int32 and runs the plain version's f32 epilogue op for
# op, so it must equal its plain version bit for bit.


def roofline(nbytes: float, ops: dict):
    """``(ms, "bytes" | "operations")``: the least time the card could
    take, the larger of moving ``nbytes`` through HBM and doing the
    operations of each type at its peak (units run concurrently)."""
    t_bytes = nbytes / PEAK_HBM
    t_ops = max(n / PEAK_OPS[kind] for kind, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's top SM clock, as ``nvidia-smi`` reports it."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


# an SM's rates in warp instructions a clock on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput): issue 4
# (one a scheduler); f32 add, multiply, fma and min/max 4 (128 lanes);
# shuffles and 32-bit shared loads 1 (32 lanes, 32 banks); the SFU's ex2
# 0.5 (16 lanes).  [K6_time]'s estimated floors price K6's SASS with them.
SM90_WARP_RATES = {"issue": 4.0, "f32": 4.0, "mio": 1.0, "sfu": 0.5}
SASS_PIPE = {"FADD": "f32", "FMUL": "f32", "FFMA": "f32", "FMNMX": "f32",
             "SHFL": "mio", "LDS": "mio", "MUFU": "sfu"}


def cuobjdump(*args: str) -> str:
    """``cuobjdump`` (beside nvcc) over the kernel library built in this
    run: it reads the compiled code, it compiles nothing."""
    from upscale_video_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    r = subprocess.run([tool, *args, str(build.library_path())],
                       capture_output=True, text=True, timeout=300, check=True)
    return r.stdout


def kernel_resources(tag: str):
    """``(mangled name, {"REG": .., "STACK": .., "SHARED": .., "LOCAL": ..})``
    of the one kernel of the built library whose name holds ``tag``."""
    import re

    lines = cuobjdump("--dump-resource-usage").splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function (\S+):", line)
        if m and tag in m.group(1):
            usage = " ".join(lines[i:i + 2])
            return m.group(1), {k: int(v) for k, v in
                                re.findall(r"\b([A-Z]+):(\d+)", usage)}
    raise SystemExit(f"no kernel named *{tag}* in the built library")


def sass_loop_mix(kernel: str) -> dict:
    """The instructions of ``kernel``'s longest loop in the built library's
    SASS (from the target of its longest backward branch to that branch),
    counted by pipe (``SASS_PIPE``, else "other") and in all ("issue")."""
    import re
    from collections import Counter

    labels, pending, insts = {}, [], []
    for line in cuobjdump("-sass", "-fun", kernel).splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            insts.append((addr, m.group(2).strip()))
    loops = []
    for addr, text in insts:
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b)", text)
        if m:
            target = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
            if target < addr:
                loops.append((addr - target, target, addr))
    if not loops:
        raise SystemExit(f"no loop in the SASS of {kernel}")
    _, lo, hi = max(loops)
    mix = Counter()
    for addr, text in insts:
        if lo <= addr <= hi:
            op = re.sub(r"^@\S+\s+", "", text).split()[0].split(".")[0]
            mix[SASS_PIPE.get(op, "other")] += 1
            mix["issue"] += 1
    return dict(mix)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare(got, want, atol: float, rtol: float):
    """``(max |got - want|, share of values that differ, all within
    atol + rtol * |want|)``, one batch entry at a time to bound memory."""
    worst, differ, ok = 0.0, 0, True
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        worst = max(worst, d.max().item())
        differ += int((d > 0).sum().item())
        ok = ok and bool((d <= atol + rtol * w.float().abs()).all())
    return worst, differ / got.numel(), ok


def write_clip(path: str, c420: bool, seed: int, frames: int = CLIP_FRAMES,
               rate: str = CLIP_RATE) -> None:
    """A hermetic Y4M clip: smooth gradients plus noise, so the model sees
    image-like content; C420jpeg writes I420 planes, C444 RGB frames."""
    from upscale_video_tpu_torch.video import Y4MSink

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    with Y4MSink(path, W, H, rate.replace(":", "/"),
                 colorspace="C420jpeg" if c420 else "C444") as sink:
        for t in range(frames):
            base = 128 + 60 * np.sin(xx / (97 + t) + yy / 131)
            if c420:
                y = np.clip(base + rng.normal(0, 12, (H, W)), 0, 255)
                c = np.clip(128 + 40 * np.cos(
                    xx[::2, ::2] / 151 - yy[::2, ::2] / (89 + t)), 0, 255)
                planes = [y, c, 255 - c]
                sink.write(np.concatenate(
                    [p.astype(np.uint8).ravel() for p in planes]))
            else:
                rgb = np.stack([base, base[::-1], 255 - base], -1)
                rgb = rgb + rng.normal(0, 12, (H, W, 3))
                sink.write(np.clip(rgb, 0, 255).astype(np.uint8))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = smi_line()
    dev = torch.device("cuda", 0)
    say("device", nvidia_smi=repr(smi), cuda=torch.version.cuda,
        torch=torch.__version__, count=torch.cuda.device_count())

    from upscale_video_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        nvcc_seconds=build.last_build_seconds, library=build.library_path().name)

    from upscale_video_tpu_torch.models.executor import chain_layers
    from upscale_video_tpu_torch.models.zoo import make_synthetic_model
    from upscale_video_tpu_torch.ops.conv3x3 import (
        conv3x3_fused, conv3x3_fused_plain,
    )
    from upscale_video_tpu_torch.ops.conv_chain import (
        conv3x3_chain, conv3x3_chain_plain, embed, run_bordered,
    )
    from upscale_video_tpu_torch.ops.pixel import frames_to_model
    from upscale_video_tpu_torch.ops.tail import sr_tail_chain, sr_tail_fused

    model = make_synthetic_model(scale=2, seed=0, device=dev)
    fwd = model.frames_forward("planar")
    layers = chain_layers(fwd.items, model.state)
    tail = model.state[fwd.tail["conv"]]
    assert len(layers) == 17, len(layers)
    rng = np.random.default_rng(0)
    errs = {}

    # K1 against its plain version: main-path shape and a ragged one
    for (n, h, w) in ((N, H, W), (2, 37, 53)):
        frames = torch.from_numpy(
            rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)).to(dev)
        x = frames_to_model(frames).to(torch.bfloat16)
        got = conv3x3_chain(x, layers, crop=False)
        want = conv3x3_chain_plain(x, layers, crop=False)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        bound = K1_ATOL + K1_RTOL * want.float().abs()
        ok = bool((d <= bound).all())
        say("K1", shape=f"{n}x{h}x{w}", layers=len(layers),
            max_abs_err=d.max().item(),
            frac_differ=f"{(d > 0).float().mean().item():.3e}",
            bound=f"atol={K1_ATOL},rtol={K1_RTOL}", ok=ok)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at {n}x{h}x{w}")
        errs["K1"] = max(errs.get("K1", 0.0), d.max().item())
        if (n, h, w) == (N, H, W):
            main_x, main_buf = x, got
        del got, want, d, bound

    k1_ms = cuda_ms(lambda: conv3x3_chain(main_x, layers, crop=False), 5)
    k1_wmma_ms = cuda_ms(
        lambda: run_bordered(embed(main_x), layers, wmma_layer), 3)
    k1_plain_ms = cuda_ms(
        lambda: conv3x3_chain_plain(main_x, layers, crop=False), 2)
    k1_lib_ms = cuda_ms(lambda: cudnn_stack(main_x, layers), 5)
    flop = 2 * 9 * N * H * W * sum(l.cin * l.cout for l in layers)
    wbytes = sum(l.wmat.numel() * 2 + l.bias.numel() * 4 + l.slope.numel() * 4
                 for l in layers)
    k1_bound = roofline(main_x.numel() * 2 + wbytes
                        + N * (H + 2) * (W + 2) * layers[-1].cout * 2,
                        {"bf16": flop})
    say("K1_time", ms=f"{k1_ms:.3f}", wmma_only_ms=f"{k1_wmma_ms:.3f}",
        plain_ms=f"{k1_plain_ms:.3f}",
        cudnn_ms=f"{k1_lib_ms:.3f}", bound_ms=f"{k1_bound[0]:.3f}",
        bound_by=k1_bound[1], tflops=f"{flop / k1_ms / 1e9:.1f}",
        per="17-layer stack, 4x1080p (16 layers on sm90, the 3->64 head "
            "on the narrow kernel)")
    # where the stack's time goes: one call under torch.profiler, device
    # time of the 64->64 layers, the narrow head and the rest (the embed
    # and the zeroed bordered buffers)
    say("K1_profile", per="17-layer stack, 4x1080p, one call",
        **profile_shares(lambda: conv3x3_chain(main_x, layers, crop=False),
                         {"sm90": "chain_layer_sm90", "narrow":
                          "chain_layer_narrow", "wmma": "chain_layer"}))
    k1_layer_ms = k1_sm90_phases(dev, errs)
    k1_shapes = k1_narrow_phases(dev, errs)

    # K2 against its plain version on the same bordered K1 output, in every
    # layout, then timed beside its WMMA kernel, the plain version and cuDNN
    k2_row = k2_phases(errs, main_buf, main_x, tail)
    del main_buf
    torch.cuda.empty_cache()

    # the whole step is right: bf16 on the card vs the f32 plain path
    from upscale_video_tpu_torch.ops.pixel import psnr
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True)
    ref_eng = ChainEngine.build(ChainSpec(), 2, "cpu",
                                compute_dtype=torch.float32, synthetic=True)
    small = torch.from_numpy(
        rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8))
    out = eng.planar_step(small.to(dev)).cpu().numpy()
    ref = ref_eng.planar_step(small).numpy()
    quality = psnr(out, ref)
    say("step_vs_f32", shape=out.shape, psnr_db=f"{quality:.2f}",
        max_lsb=int(np.abs(out.astype(int) - ref.astype(int)).max()),
        bound=f">={E2E_MIN_PSNR}dB", ok=quality >= E2E_MIN_PSNR)
    if not quality >= E2E_MIN_PSNR:
        raise SystemExit("the CUDA step disagrees with the f32 plain path")

    del eng, ref_eng
    torch.cuda.empty_cache()

    # K6 against its plain version: the main-path batch (4x1080p) and two
    # ragged ones (2x37x53; 1x7x33, narrower than a warp's 28 columns), at
    # the path's strength 3, at the strongest, 30, and with sigma 5
    from upscale_video_tpu_torch.ops.nlmeans import (
        FLOPS_PER_PAIR, ROWS, SEARCH_RADIUS, WARPS_X, WARPS_Y,
        nl_means_denoise, nl_means_denoise_plain, nlm_launch_plan,
    )

    for (n, h, w) in ((N, H, W), (2, 37, 53), (1, 7, 33)):
        x = image_like(n, h, w, seed=n * h, device=dev)
        for strength, sigma in ((3.0, 0.0), (30.0, 0.0), (3.0, 5.0)):
            got = nl_means_denoise(x, strength, sigma)
            want = nl_means_denoise_plain(x, strength, sigma)
            torch.cuda.synchronize()
            worst, differ, ok = compare(got, want, K6_ATOL, K6_RTOL)
            ok = ok and bool(torch.isfinite(got).all())
            say("K6", shape=f"{n}x{h}x{w}x3", h=strength, sigma=sigma,
                max_abs_err=worst, frac_differ=f"{differ:.3e}",
                bound=f"atol={K6_ATOL},rtol={K6_RTOL}", ok=ok)
            if not ok:
                raise SystemExit(f"K6 disagrees with its plain version at "
                                 f"{n}x{h}x{w}, h={strength}, sigma={sigma}")
            errs["K6"] = max(errs.get("K6", 0.0), worst)
            del got, want
        if (n, h, w) == (N, H, W):
            k6_x = x
    k6_ms = cuda_ms(lambda: nl_means_denoise(k6_x, 3.0), 10)
    k6_plain_ms = cuda_ms(lambda: nl_means_denoise_plain(k6_x, 3.0), 2)
    pairs = 81 * N * H * W
    k6_bound = roofline(2 * k6_x.numel() * 4,
                        {"f32": FLOPS_PER_PAIR * pairs, "exp": pairs})
    # estimates, not readings: the kernel's main loop (the dx loop, one trip
    # per column offset) counted from its SASS, each pipe's count over that
    # pipe's rate at the card's top SM clock, for every warp of the launch
    k6_name, k6_res = kernel_resources("nl_means_sm90")
    mix = sass_loop_mix(k6_name)
    trips = 2 * SEARCH_RADIUS + 1
    if mix.get("sfu") != trips * ROWS:  # one ex2 a (pixel, offset) pair
        raise SystemExit(f"K6's SASS loop holds {mix.get('sfu')} MUFU, not "
                         f"the {trips * ROWS} pairs of one dx trip")
    warps = int(np.prod(nlm_launch_plan(N, H, W))) * WARPS_X * WARPS_Y
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    est = {p: 1e3 * warps * trips * mix.get(p, 0)
           / (sms * SM90_WARP_RATES[p] * clock) for p in SM90_WARP_RATES}
    say("K6_time", ms=f"{k6_ms:.4f}", plain_ms=f"{k6_plain_ms:.3f}",
        bound_ms=f"{k6_bound[0]:.4f}", bound_by=k6_bound[1],
        share_of_bound=f"{k6_bound[0] / k6_ms:.3f}",
        gpairs_per_s=f"{pairs / k6_ms / 1e6:.1f}",
        sass_loop=",".join(f"{k}:{v}" for k, v in sorted(mix.items())),
        sass_per_pair=f"{mix['issue'] / mix['sfu']:.2f}",
        **{f"est_{p}_floor_ms": f"{t:.4f}" for p, t in est.items()},
        top_clock_mhz=f"{clock / 1e6:.0f}",
        regs=k6_res.get("REG"), stack=k6_res.get("STACK"),
        local=k6_res.get("LOCAL"), shared=k6_res.get("SHARED"),
        per="one launch, 4x1080p, h=3")
    del k6_x
    torch.cuda.empty_cache()

    # K1 at the anime chain's shapes: the 10-layer nf-24 stack at 4x1080p
    anime = make_synthetic_model(scale=1, num_conv=8, num_feat=24, seed=0,
                                 device=dev)
    afwd = anime.frames_forward("model")
    (achain,) = afwd.chains.values()
    from upscale_video_tpu_torch.models.executor import chain_layers

    alayers = chain_layers(achain["items"], anime.state)
    if len(alayers) != ANIME_LAYERS:
        raise SystemExit(f"anime chain has {len(alayers)} layers")
    ax = frames_to_model(torch.from_numpy(
        rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(dev)
    ).to(torch.bfloat16)
    before = k1_counts()
    got = conv3x3_chain(ax, alayers)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(k1_counts(), before)]
    want = conv3x3_chain_plain(ax, alayers)
    worst, differ, ok = compare(got, want, K1_ANIME_ATOL, K1_ANIME_RTOL)
    ok = ok and launched == [ANIME_LAYERS] * 3
    say("K1_anime", shape=f"{N}x{H}x{W}", layers=len(alayers),
        widths="3->24,8x24->24,24->3", max_abs_err=worst,
        mean_abs_want=want.float().abs().mean().item(),
        frac_differ=f"{differ:.3e}", bound="atol=2**-10,rtol=2**-7",
        launches=launched[0], hopper_launches=launched[1],
        narrow_launches=launched[2], ok=ok)
    if not ok:
        raise SystemExit("K1 disagrees with its plain version on the anime "
                         "chain, or a layer missed the narrow kernel")
    errs["K1"] = max(errs["K1"], worst)
    del got, want
    # each anime layer alone at the same shape, unit-scale inputs
    for i, layer in enumerate(alayers):
        x = torch.randn((N, H, W, layer.cin), generator=torch.Generator(
            device=dev).manual_seed(i), device=dev).to(torch.bfloat16)
        before = k1_counts()
        got = conv3x3_chain(x, [layer])
        want = conv3x3_chain_plain(x, [layer])
        launched = [a - b for a, b in zip(k1_counts(), before)]
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        ok = ok and launched == [1, 1, 1]
        say("K1_anime_layer", layer=i, cin=layer.cin, cout=layer.cout,
            act=layer.act, max_abs_err=worst,
            mean_abs_want=want.float().abs().mean().item(),
            frac_differ=f"{differ:.3e}", bound="atol=2**-10,rtol=2**-7",
            hopper_launches=launched[1], narrow_launches=launched[2], ok=ok)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at anime "
                             f"layer {i}")
        errs["K1"] = max(errs["K1"], worst)
        del x, got, want
    a_plain_ms = cuda_ms(lambda: conv3x3_chain_plain(ax, alayers), 2)
    a_lib_ms = cuda_ms(lambda: cudnn_stack(ax, alayers), 5)
    a_flop = 2 * 9 * N * H * W * sum(l.cin * l.cout for l in alayers)
    # the chain's bound: each layer's input read and output written once
    # (the per-layer HBM floor; every layer is bytes-bound)
    a_bound = 0.0
    for l in alayers:
        nbytes, flop = conv_work(N, H, W, l.cin, l.cout)
        a_bound += roofline(nbytes, {"bf16": flop})[0]
    before = k1_counts()
    a_ms = cuda_ms(lambda: conv3x3_chain(ax, alayers), 5)  # 7 calls
    launched = [a - b for a, b in zip(k1_counts(), before)]
    say("K1_anime_time", ms=f"{a_ms:.3f}", plain_ms=f"{a_plain_ms:.3f}",
        cudnn_ms=f"{a_lib_ms:.3f}", tflops=f"{a_flop / a_ms / 1e9:.1f}",
        bound_ms=f"{a_bound:.3f}", bound_by="bytes",
        share_of_bound=f"{a_bound / a_ms:.3f}",
        calls=7, launches=launched[0], hopper_launches=launched[1],
        narrow_launches=launched[2], per="10-layer nf-24 chain, 4x1080p")
    if a_ms >= a_lib_ms:
        raise SystemExit("K1's anime chain is no faster than cuDNN's")
    del ax, anime
    torch.cuda.empty_cache()

    # the a,n=3 step is right: bf16 on the card vs the f32 plain path
    peng = ChainEngine.build(ChainSpec.parse(PRELUDE), 2, dev, synthetic=True)
    pref = ChainEngine.build(ChainSpec.parse(PRELUDE), 2, "cpu",
                             compute_dtype=torch.float32, synthetic=True)
    small = torch.from_numpy(np.stack(
        [write_frame(64, 96, t, rng) for t in range(2)]))
    out = peng.planar_step(small.to(dev)).cpu().numpy()
    ref = pref.planar_step(small).numpy()
    quality = psnr(out, ref)
    say("prelude_vs_f32", chain=PRELUDE, shape=out.shape,
        psnr_db=f"{quality:.2f}",
        max_lsb=int(np.abs(out.astype(int) - ref.astype(int)).max()),
        bound=f">={E2E_MIN_PSNR}dB", ok=quality >= E2E_MIN_PSNR)
    if not quality >= E2E_MIN_PSNR:
        raise SystemExit("the a,n=3 CUDA step disagrees with the f32 plain path")
    del pref

    # K5 against its plain version with the first dense block's weights
    # ([K5_sm90], [K5_ab])
    from upscale_video_tpu_torch.ops.rdb import RDBWeights, rdb_block

    veng = ChainEngine.build(ChainSpec(real_life=True), 4, dev, synthetic=True,
                             residual_dtype=torch.float32)
    vfwd = veng.sr_model.frames_forward("model")
    if len(vfwd.rdb_triggers) != VALAR_BLOCKS:
        raise SystemExit(f"{len(vfwd.rdb_triggers)} dense blocks planned, "
                         f"expected {VALAR_BLOCKS}")
    trig, blk = next(iter(vfwd.rdb_triggers.items()))
    pw = veng.sr_model.state[trig]
    wts = RDBWeights(pw.wpack, pw.bpack, blk["slope"], pw.wpack_sm90)
    k5_row = k5_sm90_phases(dev, errs, veng, blk, wts, rng)
    torch.cuda.empty_cache()

    # the -m r path's six 3x3 convs, each with its activation at the shape
    # the 1080p step gives it (the frame's 8 tiles at 1x, 2x, 4x): K4 for
    # the solo 3->64 and 64->64 none and 64->64 leaky, K1 for the chain's
    # 64->64 leaky twice (sm90) and 64->3 none (narrow), each layer alone
    from upscale_video_tpu_torch.models.executor import _solo_args

    gen = torch.Generator(device=dev).manual_seed(0)
    (vchain,) = vfwd.chains.values()
    vlayers = dict(zip([it["name"] for it in vchain["items"]],
                       chain_layers(vchain["items"], veng.sr_model.state)))
    for name, f in VALAR_K4_LAYERS + VALAR_K1_LAYERS:
        if name in vfwd.solos:
            wmat, bias, slope, act = _solo_args(vfwd.solos[name],
                                                veng.sr_model.state)
            kernel, cin, cout = "K4", wmat.shape[0] // 9, wmat.shape[1]
            run = lambda x: conv3x3_fused(x, wmat, bias, slope, act)  # noqa: E731
            run_plain = lambda x: conv3x3_fused_plain(x, wmat, bias, slope, act)  # noqa: E731
        else:
            layer = vlayers[name]
            kernel, cin, cout, act = "K1", layer.cin, layer.cout, layer.act
            run = lambda x: conv3x3_chain(x, [layer])  # noqa: E731
            run_plain = lambda x: conv3x3_chain_plain(x, [layer])  # noqa: E731
        shape = (TILES[0], TILES[1] * f, TILES[2] * f, cin)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        got, want = run(x), run_plain(x)
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        say(kernel, path="-m r", conv=name, shape="x".join(map(str, shape)),
            cout=cout, act=act, max_abs_err=worst,
            frac_differ=f"{differ:.3e}", bound="atol=2**-10,rtol=2**-7", ok=ok)
        if not ok:
            raise SystemExit(f"{kernel} disagrees with its plain version at {name}")
        errs[kernel] = max(errs.get(kernel, 0.0), worst)
        del x, got, want
        torch.cuda.empty_cache()

    # the -m r step at full depth: mixed on the card vs the f32 plain path
    vref = ChainEngine.build(ChainSpec(real_life=True), 4, "cpu",
                             compute_dtype=torch.float32, synthetic=True)
    small = torch.from_numpy(rng.integers(0, 256, (1, 64, 96, 3), dtype=np.uint8))
    out = veng.step(small.to(dev)).cpu().numpy()
    ref = vref.step(small).numpy()
    quality = psnr(out, ref)
    say("valar_step_vs_f32", shape=out.shape, rrdbs=23, precision="mixed",
        psnr_db=f"{quality:.2f}",
        max_lsb=int(np.abs(out.astype(int) - ref.astype(int)).max()),
        bound=f">={VALAR_MIN_PSNR}dB", ok=quality >= VALAR_MIN_PSNR)
    if not quality >= VALAR_MIN_PSNR:
        raise SystemExit("the -m r step disagrees with the f32 plain path")
    del vref

    k4_row = k4_phases(dev, errs)
    k4_row["valar_dense"] = k4_valar_phase(dev, errs, veng)
    k2_row["tiles_ms"] = k2_tiles_phase(dev, errs)

    # K3 against its plain version at 4x1080p in every layout: the wide
    # SRVGG's tail (Cf 160) and a 64-wide one, at 2x and 4x; then timed
    k3_row = k3_phases(dev, errs)

    # sr= imports: RealESRGAN_x4plus's architecture at full depth and at 2
    # RRDBs, and a wide SRVGGNetCompact, as state dicts made from a seed,
    # each converted by vsr-import-torch
    from upscale_video_tpu_torch.cli.import_model import main as import_main

    model_dir = tempfile.TemporaryDirectory()
    mdir = os.path.join(model_dir.name, "models")
    for name, sd in ((ESRGAN_STEM[2:], esrgan_state_dict(0, ESRGAN_RRDBS)),
                     (f"{ESRGAN_STEM[2:]}_rrdb2", esrgan_state_dict(0, 2)),
                     (WIDE_STEM[2:], srvgg_state_dict(0, WIDE_CONVS, WIDE_NF, 4))):
        pth = os.path.join(model_dir.name, name + ".pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        t0 = time.perf_counter()
        rc = import_main(["-i", pth, "-o", mdir])
        say("import", checkpoint=name + ".pth", tensors=len(sd), rc=rc,
            seconds=f"{time.perf_counter() - t0:.2f}", ok=rc == 0)
        if rc != 0:
            raise SystemExit(f"vsr-import-torch failed on {name}.pth")

    # the 1080p sr=RealESRGAN_x4plus step (whole-frame, bf16: K4 per solo
    # 3x3 conv, one K1 chain) against the same step on the plain versions,
    # at 2 RRDBs and at full depth; bounds per depth as for -m r
    esr_engines = {}
    frame1 = torch.from_numpy(
        rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)).to(dev)
    for rrdbs in (2, ESRGAN_RRDBS):
        stem = ESRGAN_STEM + ("" if rrdbs == ESRGAN_RRDBS else f"_rrdb{rrdbs}")
        engine = ChainEngine.build(ChainSpec.parse(f"sr={stem}"), 4, dev,
                                   model_path=mdir)
        efwd = engine.sr_model.frames_forward("frames")
        blocks = len({d["block"] for d in efwd.dense.values()})
        if (len(efwd.solos) != esrgan_k4(rrdbs) or len(efwd.chains) != 1
                or blocks != 3 * rrdbs or len(efwd.dense) != 15 * rrdbs
                or efwd.rdb_triggers or engine.tile or engine.planar_scale):
            raise SystemExit(f"sr={stem}: {len(efwd.solos)} K4 convs, "
                             f"{len(efwd.chains)} chains, {blocks} dense-buffer "
                             "blocks planned")
        esr_engines[rrdbs] = engine
        min_db, max_lsb = ESRGAN_PLAIN_BOUNDS[rrdbs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = engine.step(frame1)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out = out.cpu().numpy()
        ref = plain_call(engine.step, frame1).cpu().numpy()
        quality = psnr(out, ref)
        lsb = np.abs(out.astype(int) - ref.astype(int))
        ok = quality >= min_db and lsb.max() <= max_lsb
        say("esrgan_step_vs_plain", shape=out.shape, rrdbs=rrdbs,
            precision="bf16", dense_buffer_blocks=blocks,
            psnr_db=f"{quality:.2f}", max_lsb=int(lsb.max()),
            frac_differ=f"{(lsb > 0).mean():.3e}",
            out_mean=f"{out.mean():.1f}", out_std=f"{out.std():.1f}",
            clipped=f"{np.mean((out == 0) | (out == 255)):.3f}",
            bound=f">={min_db}dB,max_lsb<={max_lsb}",
            peak_device_gb=f"{peak_gb:.2f}", ok=ok)
        if not ok:
            raise SystemExit(f"the 1080p sr= ESRGAN step at {rrdbs} RRDBs "
                             "disagrees with its plain step")
        del out, ref
    eeng = esr_engines[ESRGAN_RRDBS]
    del esr_engines
    torch.cuda.empty_cache()

    # where the ESRGAN step's device time goes: one step under
    # torch.profiler, kernel time by K4, K1, torch.cat and the rest; the
    # step's bound is its convs' bounds summed (each at its resolution)
    step_ms = cuda_ms(lambda: eeng.step(frame1), 1)
    up = {"conv_up1": 2, "conv_up2": 4, "conv_hr": 4, "conv_last": 4}
    step_bound = 0.0
    for name, p in eeng.sr_model.state.items():
        if hasattr(p, "wmat"):
            f = up.get(name, 1)
            nbytes, flop = conv_work(1, H * f, W * f, p.wmat.shape[0] // 9,
                                     p.wmat.shape[1])
            step_bound += roofline(nbytes, {"bf16": flop})[0]
    say("esrgan_profile", step_ms=f"{step_ms:.2f}",
        bound_ms=f"{step_bound:.2f}",
        **profile_shares(lambda: eeng.step(frame1)))

    # the wide SRVGG import: K4 per body conv (PReLU fused), its tail one
    # K3 launch writing the planar layout; against its plain step
    weng = ChainEngine.build(ChainSpec.parse(f"sr={WIDE_STEM}"), 4, dev,
                             model_path=mdir)
    wfwd = weng.sr_model.frames_forward("planar")
    if len(wfwd.solos) != WIDE_CONVS + 1 or wfwd.tail is None \
            or weng.planar_scale != 4:
        raise SystemExit(f"sr={WIDE_STEM}: {len(wfwd.solos)} K4 convs planned")
    small = torch.from_numpy(np.stack(
        [write_frame(270, 480, t, rng) for t in range(N)])).to(dev)
    k4, k4_sm90, k3, k3_sm90 = (conv3x3_fused.launches, conv3x3_fused.launches_sm90,
                                sr_tail_fused.launches, sr_tail_fused.launches_sm90)
    out = weng.planar_step(small)
    torch.cuda.synchronize()
    launched = (conv3x3_fused.launches - k4, conv3x3_fused.launches_sm90 - k4_sm90,
                sr_tail_fused.launches - k3, sr_tail_fused.launches_sm90 - k3_sm90)
    out = out.cpu().numpy()
    ref = plain_call(weng.planar_step, small).cpu().numpy()
    quality = psnr(out, ref)
    ok = (quality >= WIDE_MIN_PSNR
          and launched == (WIDE_CONVS + 1, WIDE_CONVS, 1, 1))
    say("wide_srvgg_step_vs_plain", shape=out.shape, nf=WIDE_NF,
        k4_launches=launched[0], k4_sm90_launches=launched[1],
        k3_launches=launched[2], k3_sm90_launches=launched[3],
        psnr_db=f"{quality:.2f}",
        max_lsb=int(np.abs(out.astype(int) - ref.astype(int)).max()),
        bound=f">={WIDE_MIN_PSNR}dB", ok=ok)
    if not ok:
        raise SystemExit("the wide SRVGG planar step disagrees with its plain step")
    del out, ref

    # end to end through the CLI, both contracts, counting kernel launches
    from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
    from upscale_video_tpu_torch.video import (
        HermeticBackend, Y4MSource, calc_batches, frames_per_batch,
    )

    seen_fragments = []
    concat = HermeticBackend.concat

    def observe_concat(self, num_batches, output_file, workdir):
        seen_fragments.append(sorted(os.listdir(workdir)))
        return concat(self, num_batches, output_file, workdir)

    HermeticBackend.concat = observe_concat
    counters = {"K1": conv3x3_chain, "K2": sr_tail_chain, "K3": sr_tail_fused,
                "K4": conv3x3_fused, "K5": rdb_block, "K6": nl_means_denoise}
    launches = dict.fromkeys(
        [*counters, "K1_sm90", "K1_narrow", "K2_sm90", "K3_sm90", "K4_sm90",
         "K5_sm90", "K2_model", "K3_model", "yuv_composed"], 0)

    def tail_counts(k):
        """K2's and K3's Hopper shares, their model-layout launches and
        their composed 4:2:0 packs."""
        k["K2_sm90"] = sr_tail_chain.launches_sm90
        k["K3_sm90"] = sr_tail_fused.launches_sm90
        k["K2_model"] = sr_tail_chain.launches_model
        k["K3_model"] = sr_tail_fused.launches_model
        k["yuv_composed"] = sr_tail_chain.yuv_composed + sr_tail_fused.yuv_composed
        return k

    def zero_tail_counts():
        for fn in (sr_tail_chain, sr_tail_fused):
            fn.launches_sm90 = fn.launches_model = fn.yuv_composed = 0

    def tails_on_hopper(k):
        """Every K2 and K3 launch of a product path on its Hopper kernel,
        every 4:2:0 pack folded into it."""
        return (k["K2_sm90"] == k["K2"] and k["K3_sm90"] == k["K3"]
                and k["yuv_composed"] == 0)
    e2e = {}

    def counted(fn, *args):
        """``fn(*args)`` with every kernel's launch counts from zero: its
        result, the counts (also added to the run's totals) and its wall
        seconds."""
        for wrapper in counters.values():
            wrapper.launches = 0
        conv3x3_chain.launches_sm90 = conv3x3_fused.launches_sm90 = 0
        conv3x3_chain.launches_narrow = rdb_block.launches_sm90 = 0
        zero_tail_counts()
        t0 = time.perf_counter()
        result = fn(*args)
        wall = time.perf_counter() - t0
        counts = {k: wrapper.launches for k, wrapper in counters.items()}
        counts["K1_sm90"] = conv3x3_chain.launches_sm90
        counts["K1_narrow"] = conv3x3_chain.launches_narrow
        counts["K4_sm90"] = conv3x3_fused.launches_sm90
        counts["K5_sm90"] = rdb_block.launches_sm90
        tail_counts(counts)
        for k, v in counts.items():
            launches[k] += v
        return result, counts, wall

    def drive(tmp, name, c420, frames, rate, extra, synthetic=True, keep=False):
        """One CLI run; its kernel launch counts from zero.  ``keep`` leaves
        its output at ``{tmp}/{name}.out.y4m``."""
        src = os.path.join(tmp, f"{name}.y4m")
        out_path = os.path.join(tmp, f"{name}.out.y4m")
        work = os.path.join(tmp, f"work_{name}")
        write_clip(src, c420, seed=1, frames=frames, rate=rate)
        rc, counts, wall = counted(cli_main, [
            "-i", src, "-o", out_path, "-t", work, "-b", "1", "-r",
            *(["--synthetic_models"] if synthetic else []), *extra])
        with Y4MSource(out_path) as o:
            geom, cs = (o.width, o.height), o.colorspace
            count = 0
            while o.skip(1):
                count += 1
        left = sorted(os.listdir(os.path.join(work, "upscale_video")))
        frags = seen_fragments[-1]
        if not keep:
            os.remove(out_path)
        ok = (rc == 0 and count == frames and tails_on_hopper(counts)
              and cs.startswith("C420" if c420 else "C444")
              and "1.y4m" in frags and "2.y4m" in frags
              and "metadata.json" in frags
              and left == ["completed.txt", "metadata.json"])
        e2e[name] = frames / wall
        return ok, geom, cs, count, counts, frags, left, wall

    def steps_of(frames, rate, per_step):
        per_batch = frames_per_batch(float(Fraction(rate.replace(":", "/"))),
                                     frames, 1)
        return sum(-(-(e - s + 1) // per_step)
                   for s, e in calc_batches(frames, per_batch).values())

    with tempfile.TemporaryDirectory() as tmp:
        steps = steps_of(CLIP_FRAMES, CLIP_RATE, N)
        for name, c420 in (("c420jpeg", True), ("c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, CLIP_FRAMES, CLIP_RATE, [], keep=not c420)
            ok = (ok and geom == (2 * W, 2 * H) and k["K1"] == 17 * steps
                  and k["K2"] == steps
                  and k["K3"] == k["K4"] == k["K5"] == k["K6"] == 0)
            say("e2e", path="default", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=steps, k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"], k1_narrow_launches=k["K1_narrow"],
                k2_launches=k["K2"], k2_sm90_launches=k["K2_sm90"],
                yuv_composed=k["yuv_composed"], k5_launches=k["K5"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.2f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end run on the {name} clip failed")
            if (k["K1_sm90"] != COMPACT_HOPPER * steps
                    or k["K1_narrow"] != steps):
                raise SystemExit(
                    f"the default step ran {k['K1_sm90']} K1 layers on Hopper "
                    f"({k['K1_narrow']} narrow), not {COMPACT_HOPPER * steps} "
                    f"({steps})")
        # -m r: one frame per step, every dense block one K5 launch over
        # the frame's 8 tiles, the three solo 3x3 convs one K4 launch each,
        # the last three one K1 chain
        vsteps = steps_of(VALAR_CLIP_FRAMES, VALAR_CLIP_RATE, 1)
        for name, c420 in (("valar_c420jpeg", True), ("valar_c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, VALAR_CLIP_FRAMES, VALAR_CLIP_RATE,
                ["-m", "r"], keep=not c420)
            ok = (ok and geom == (4 * W, 4 * H)
                  and k["K5"] == VALAR_BLOCKS * vsteps
                  and k["K5_sm90"] == VALAR_BLOCKS * vsteps
                  and k["K4"] == VALAR_SOLOS * vsteps
                  and k["K4_sm90"] == VALAR_SOLOS_SM90 * vsteps
                  and k["K1"] == VALAR_CHAIN * vsteps
                  and k["K1_sm90"] == LAST_CHAIN_SM90 * vsteps
                  and k["K1_narrow"] == vsteps
                  and k["K2"] == k["K3"] == k["K6"] == 0)
            say("e2e", path="-m r", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=vsteps,
                k5_launches=k["K5"], k5_launches_sm90=k["K5_sm90"],
                k4_launches=k["K4"],
                k4_sm90_launches=k["K4_sm90"], k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"], k1_narrow_launches=k["K1_narrow"],
                k2_launches=k["K2"], fragments_before_concat=frags,
                workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end -m r run on the {name} clip failed")
        # -m a,n=3: per step one K6 launch over the batch, the anime
        # chain's 10 K1 launches and Compact's 17, one K2 launch
        for name, c420 in (("prelude_c420jpeg", True), ("prelude_c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, CLIP_FRAMES, CLIP_RATE, ["-m", PRELUDE])
            ok = (ok and geom == (2 * W, 2 * H) and k["K6"] == steps
                  and k["K1"] == (ANIME_LAYERS + 17) * steps
                  and k["K1_sm90"] == (ANIME_LAYERS + COMPACT_HOPPER) * steps
                  and k["K1_narrow"] == (ANIME_LAYERS + 1) * steps
                  and k["K2"] == steps and k["K3"] == k["K4"] == k["K5"] == 0)
            say("e2e", path=f"-m {PRELUDE}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=steps, k6_launches=k["K6"], k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"], k1_narrow_launches=k["K1_narrow"],
                k2_launches=k["K2"], k2_sm90_launches=k["K2_sm90"],
                yuv_composed=k["yuv_composed"], k5_launches=k["K5"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.2f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end -m {PRELUDE} run on the {name} "
                                 "clip failed")
        # sr=RealESRGAN_x4plus from the files vsr-import-torch wrote: one
        # frame per step, whole-frame, every solo 3x3 conv one K4 launch,
        # conv_up2 -> conv_hr -> conv_last one K1 chain
        esteps = steps_of(ESRGAN_CLIP_FRAMES, VALAR_CLIP_RATE, 1)
        for name, c420 in (("esrgan_c420jpeg", True), ("esrgan_c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, ESRGAN_CLIP_FRAMES, VALAR_CLIP_RATE,
                ["-m", f"sr={ESRGAN_STEM}", "-s", "4", "--model_path", mdir,
                 "--frames_per_step", "1"], synthetic=False)
            ok = (ok and geom == (4 * W, 4 * H)
                  and k["K4"] == esrgan_k4(ESRGAN_RRDBS) * esteps
                  and k["K4_sm90"] == (esrgan_k4(ESRGAN_RRDBS) - 1) * esteps
                  and k["K1"] == 3 * esteps
                  and k["K1_sm90"] == LAST_CHAIN_SM90 * esteps
                  and k["K1_narrow"] == esteps
                  and k["K2"] == k["K3"] == k["K5"] == k["K6"] == 0)
            say("e2e", path=f"-m sr={ESRGAN_STEM}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=esteps, k4_launches=k["K4"],
                k4_sm90_launches=k["K4_sm90"], k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"], k1_narrow_launches=k["K1_narrow"],
                k2_launches=k["K2"], k3_launches=k["K3"], k5_launches=k["K5"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end sr= ESRGAN run on the {name} "
                                 "clip failed")
        # the wide SRVGG import, 4 frames per step: 9 K4 launches (PReLU
        # fused) and one K3 launch per step, shuffle-planar and 4:2:0
        wsteps = steps_of(WIDE_CLIP_FRAMES, VALAR_CLIP_RATE, N)
        for name, c420 in (("wide_c420jpeg", True), ("wide_c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, WIDE_CLIP_FRAMES, VALAR_CLIP_RATE,
                ["-m", f"sr={WIDE_STEM}", "-s", "4", "--model_path", mdir],
                synthetic=False)
            ok = (ok and geom == (4 * W, 4 * H)
                  and k["K4"] == (WIDE_CONVS + 1) * wsteps
                  and k["K4_sm90"] == WIDE_CONVS * wsteps
                  and k["K3"] == wsteps
                  and k["K1"] == k["K1_sm90"] == k["K1_narrow"] == k["K2"]
                  == k["K5"] == k["K6"] == 0)
            say("e2e", path=f"-m sr={WIDE_STEM}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=wsteps, k4_launches=k["K4"],
                k4_sm90_launches=k["K4_sm90"], k3_launches=k["K3"],
                k3_sm90_launches=k["K3_sm90"], yuv_composed=k["yuv_composed"],
                k1_launches=k["K1"], k2_launches=k["K2"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end sr= wide SRVGG run on the {name} "
                                 "clip failed")
        # the png data plane and the companion workflows on the default
        # path's clip (c444.y4m), held against its stream-plane output
        stream_out = os.path.join(tmp, "c444.out.y4m")
        png_out = png_plane_phases(tmp, drive, e2e, peng, tails_on_hopper,
                                   steps_of(CLIP_FRAMES, CLIP_RATE, N), stream_out)
        workflow_phases(tmp, counted, os.path.join(tmp, "c444.y4m"), png_out,
                        stream_out, tails_on_hopper,
                        steps_of(CLIP_FRAMES, CLIP_RATE, N))
        flag_phases(dev, tmp, drive, counted, steps_of, rng)
    HermeticBackend.concat = concat

    # device throughput at 1080p -> 4K: the default and a,n=3 steps (4
    # frames), the --tta and -m r steps (1 frame), beside plain versions
    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True)
    frames = torch.from_numpy(
        rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(dev)
    flat = torch.from_numpy(
        rng.integers(0, 256, (N, H * W * 3 // 2), dtype=np.uint8)).to(dev)
    yuv = eng.yuv_step(True, planar=True, i420_in=(H, W, True))
    pyuv = peng.yuv_step(True, planar=True, i420_in=(H, W, True))
    # the default 4:2:0 step: the tail writes the packed layout in its one
    # Hopper launch, no yuv420_from_planar
    zero_tail_counts()
    k2_before = sr_tail_chain.launches
    packed = yuv(flat)
    torch.cuda.synchronize()
    k = tail_counts({"K2": sr_tail_chain.launches - k2_before, "K3": 0})
    ok = (k["K2"] == 1 and tails_on_hopper(k)
          and tuple(packed.shape) == (N, H, W, 6))
    say("yuv420_step", shape=tuple(packed.shape), k2_launches=k["K2"],
        k2_sm90_launches=k["K2_sm90"], yuv_composed=k["yuv_composed"], ok=ok)
    if not ok:
        raise SystemExit("the default 4:2:0 step did not fold the pack into K2")
    del packed

    # --tta: one 1080p frame of the default step, 8 dihedral passes (K1
    # and K2's f32 layout at 1080x1920 and 1920x1080), against the same
    # step on the plain versions
    teng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True, tta=True)
    for fn in counters.values():
        fn.launches = 0
    conv3x3_chain.launches_sm90 = conv3x3_chain.launches_narrow = 0
    zero_tail_counts()
    out = teng.step(frames[:1])
    torch.cuda.synchronize()
    k = tail_counts({name: fn.launches for name, fn in counters.items()})
    k["K1_sm90"] = conv3x3_chain.launches_sm90
    k["K1_narrow"] = conv3x3_chain.launches_narrow
    out = out.cpu().numpy()
    ref = plain_call(teng.step, frames[:1]).cpu().numpy()
    quality = psnr(out, ref)
    ok = (quality >= TTA_MIN_PSNR and out.shape == (1, 2 * H, 2 * W, 3)
          and k["K1"] == 8 * 17 and k["K1_sm90"] == 8 * COMPACT_HOPPER
          and k["K1_narrow"] == 8 and k["K2"] == 8 and tails_on_hopper(k))
    say("tta", shape=out.shape, k1_launches=k["K1"],
        k1_sm90_launches=k["K1_sm90"], k1_narrow_launches=k["K1_narrow"],
        k2_launches=k["K2"], k2_sm90_launches=k["K2_sm90"],
        psnr_vs_plain_db=f"{quality:.2f}",
        max_lsb=int(np.abs(out.astype(int) - ref.astype(int)).max()),
        bound=f">={TTA_MIN_PSNR}dB", ok=ok)
    if not ok:
        raise SystemExit("the --tta step disagrees with its plain step")
    del out, ref

    # the 1080p -m r step (K5 and K1 at every main-path shape, the tiling)
    # against the same step on the plain versions: same rounding points,
    # so only summation-order ulps differ, but the synthetic weights
    # amplify them with depth.  2 RRDBs take the tight bound, the full
    # depth the quality-class one (VALAR_PLAIN_BOUNDS)
    from upscale_video_tpu_torch.models.zoo import make_synthetic_rrdb_model

    shallow = ChainEngine(
        spec=ChainSpec(real_life=True), scale=4, device=dev, tile=veng.tile,
        halo=veng.halo, sr_model=make_synthetic_rrdb_model(
            num_rrdb=2, device=dev, residual_dtype=torch.float32))
    for rrdbs, engine in ((2, shallow), (23, veng)):
        min_db, max_lsb = VALAR_PLAIN_BOUNDS[rrdbs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = engine.step(frames[:1])
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out = out.cpu().numpy()
        ref = plain_call(engine.step, frames[:1]).cpu().numpy()
        quality = psnr(out, ref)
        lsb = np.abs(out.astype(int) - ref.astype(int))
        ok = quality >= min_db and lsb.max() <= max_lsb
        say("valar_step_vs_plain", shape=out.shape, rrdbs=rrdbs,
            precision="mixed", psnr_db=f"{quality:.2f}", max_lsb=int(lsb.max()),
            frac_differ=f"{(lsb > 0).mean():.3e}",
            bound=f">={min_db}dB,max_lsb<={max_lsb}",
            peak_device_gb=f"{peak_gb:.2f}", ok=ok)
        if not ok:
            raise SystemExit(f"the 1080p -m r step at {rrdbs} RRDBs disagrees "
                             "with its plain step")
    del shallow

    # where the -m r step's device time goes: one 1080p step under
    # torch.profiler, kernel time by K5, K4, K1 and the rest; the step's
    # bound is its 69 dense blocks' and six convs' bounds summed (each at
    # the shape its 8 tiles give it)
    vstep_ms = cuda_ms(lambda: veng.step(frames[:1]), 1)
    vbound = VALAR_BLOCKS * k5_row["bound_ms"]
    for name, f in VALAR_K4_LAYERS + VALAR_K1_LAYERS:
        wm = veng.sr_model.state[name].wmat
        nbytes, flop = conv_work(TILES[0], TILES[1] * f, TILES[2] * f,
                                 wm.shape[0] // 9, wm.shape[1])
        vbound += roofline(nbytes, {"bf16": flop})[0]
    say("valar_profile", step_ms=f"{vstep_ms:.2f}", bound_ms=f"{vbound:.2f}",
        frames_per_s=f"{1000.0 / vstep_ms:.3f}", card=repr(smi),
        **profile_shares(lambda: veng.step(frames[:1])))

    # the flags' steps: the whole step on library convs (--conv_impl xla,
    # and f32 with TF32 off), -m r with its dense blocks on K4, and the
    # default chain tiled
    flag_engines = {
        name: ChainEngine.build(ChainSpec.parse(models), 2, dev,
                                synthetic=True, **kw)
        for name, models, kw in (
            ("xla", None, dict(conv_impl="xla")),
            ("f32", None, dict(compute_dtype=torch.float32)),
            ("tiled", None, dict(tile=TILE_BUDGET)),
            ("n3", "n=3", {}),
            ("xla_n3", "n=3", dict(conv_impl="xla")),
            ("xla_valar", "r", dict(conv_impl="xla",
                                    residual_dtype=torch.float32)),
            ("pallas_valar", "r", dict(conv_impl="pallas",
                                       residual_dtype=torch.float32)),
            ("f32_valar", "r", dict(compute_dtype=torch.float32)))}
    fe = flag_engines
    rates = {}
    for name, fn, reps, per in (
        ("planar_step", lambda: eng.planar_step(frames), 5, N),
        ("yuv420_step_i420_in", lambda: yuv(flat), 5, N),
        ("plain_planar_step", lambda: plain_call(eng.planar_step, frames), 2, N),
        ("plain_yuv420_step", lambda: plain_call(yuv, flat), 2, N),
        ("prelude_planar_step", lambda: peng.planar_step(frames), 5, N),
        ("prelude_yuv420_step_i420_in", lambda: pyuv(flat), 5, N),
        ("plain_prelude_planar_step",
         lambda: plain_call(peng.planar_step, frames), 1, N),
        ("tta_step", lambda: teng.step(frames[:1]), 2, 1),
        ("valar_step", lambda: veng.step(frames[:1]), 2, 1),
        ("plain_valar_step", lambda: plain_call(veng.step, frames[:1]), 1, 1),
        ("esrgan_step", lambda: eeng.step(frames[:1]), 2, 1),
        ("plain_esrgan_step", lambda: plain_call(eeng.step, frames[:1]), 1, 1),
        ("wide_srvgg_planar_step", lambda: weng.planar_step(frames), 3, N),
        ("plain_wide_srvgg_planar_step",
         lambda: plain_call(weng.planar_step, frames), 1, N),
        ("xla_planar_step", lambda: fe["xla"].planar_step(frames), 3, N),
        ("f32_planar_step", lambda: fe["f32"].planar_step(frames), 2, N),
        ("tiled_step", lambda: fe["tiled"].step(frames), 3, N),
        ("n3_planar_step", lambda: fe["n3"].planar_step(frames), 3, N),
        ("xla_n3_planar_step", lambda: fe["xla_n3"].planar_step(frames), 2, N),
        ("xla_valar_step", lambda: fe["xla_valar"].step(frames[:1]), 1, 1),
        ("pallas_valar_step", lambda: fe["pallas_valar"].step(frames[:1]), 1, 1),
        ("f32_valar_step", lambda: fe["f32_valar"].step(frames[:1]), 1, 1),
    ):
        ms = cuda_ms(fn, reps)
        rates[name] = per * 1000.0 / ms
        say("throughput", step=name, ms_per_step=f"{ms:.2f}",
            frames_per_step=per, frames_per_s=f"{rates[name]:.3f}",
            card=repr(smi))

    # where --conv_impl pallas -m r's step goes: K4's dense convs, K1, the glue
    say("valar_pallas_profile", step_ms=f"{1000.0 / rates['pallas_valar_step']:.2f}",
        card=repr(smi),
        **profile_shares(lambda: fe["pallas_valar"].step(frames[:1])))
    del eng, peng, teng, veng, eeng, weng, frames, flat, yuv, pyuv
    del fe, flag_engines
    torch.cuda.empty_cache()
    k7_layer = k7_sm90_phases(dev, errs)
    torch.cuda.empty_cache()
    k8_layer = k8_sm90_phases(dev, errs)
    torch.cuda.empty_cache()
    body = conv_body_phases(dev, errs)
    torch.cuda.empty_cache()
    bench_launches = {}
    for tool, kernel in (("wino_bench", "winograd_chain"),
                         ("q8_bench", "conv3x3_chain_q8")):
        bench_launches[kernel] = run_bench(tool, kernel)
    # wino_bench's body is 16 x 64->64: every K7 launch on the sm90 kernel
    k7_launches, k7_sm90 = bench_launches["winograd_chain"]
    if k7_sm90 != k7_launches:
        raise SystemExit(f"wino_bench ran {k7_launches - k7_sm90} of its "
                         f"{k7_launches} 64->64 K7 layers off the sm90 kernel")
    # and q8_bench's: every K8 launch on the sm90 kernel
    k8_launches, k8_sm90 = bench_launches["conv3x3_chain_q8"]
    if k8_sm90 != k8_launches:
        raise SystemExit(f"q8_bench ran {k8_launches - (k8_sm90 or 0)} of its "
                         f"{k8_launches} 64->64 K8 layers off the sm90 kernel")

    # library_ms: K1's is cuDNN's bf16 conv (F.conv2d with bias, one call
    # per layer, channels-last) over the same 17 layers, without the
    # PReLUs; K4's the same over one ESRGAN dense block's five convs,
    # without the leaky ReLUs; K2's and K3's the tail conv alone on cuDNN,
    # a yardstick (no PyTorch call computes their function: skip, shuffle,
    # u8 or 4:2:0); K5 and K6 have no PyTorch call computing their
    # function; K7's is the same cuDNN call over the 16-layer conv body;
    # PyTorch has no int8 convolution on CUDA for K8
    model_dir.cleanup()
    kernels = [
        {"name": "conv3x3_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv3x3_chain_sm90.cu",
         "source_narrow":
             "upscale_video_tpu_torch/csrc/conv3x3_chain_narrow_sm90.cu",
         "source_wmma": "upscale_video_tpu_torch/csrc/conv3x3_chain.cu",
         "replaces": "upscale_video_tpu/ops/conv_chain.py:61",
         "launches": launches["K1"], "launches_sm90": launches["K1_sm90"],
         "launches_narrow": launches["K1_narrow"],
         "max_abs_err": errs["K1"],
         "ms": k1_ms, "ms_wmma": k1_wmma_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": k1_lib_ms, "layer_ms": k1_layer_ms,
         "anime_ms": a_ms, "anime_plain_ms": a_plain_ms,
         "anime_library_ms": a_lib_ms, "anime_bound_ms": a_bound,
         "anime_bound_by": "bytes", "shapes": k1_shapes},
        {"name": "sr_tail_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/sr_tail_sm90.cu",
         "source_sm90": "upscale_video_tpu_torch/csrc/sr_tail_sm90.cu",
         "source_wmma": "upscale_video_tpu_torch/csrc/sr_tail.cu",
         "replaces": "upscale_video_tpu/ops/tail_pallas.py:155",
         "launches": launches["K2"], "launches_sm90": launches["K2_sm90"],
         "max_abs_err": errs["K2"], **k2_row, "library_call": TAIL_YARDSTICK},
        {"name": "sr_tail_fused", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/sr_tail_sm90.cu",
         "source_sm90": "upscale_video_tpu_torch/csrc/sr_tail_sm90.cu",
         "source_wmma": "upscale_video_tpu_torch/csrc/sr_tail.cu",
         "replaces": "upscale_video_tpu/ops/tail_pallas.py:31",
         "launches": launches["K3"], "launches_sm90": launches["K3_sm90"],
         "max_abs_err": errs["K3"], **k3_row, "library_call": TAIL_YARDSTICK},
        {"name": "conv3x3_fused", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv3x3_fused_sm90.cu",
         "source_wmma": "upscale_video_tpu_torch/csrc/conv3x3_fused.cu",
         "replaces": "upscale_video_tpu/ops/conv_pallas.py:56",
         "launches": launches["K4"], "launches_sm90": launches["K4_sm90"],
         "max_abs_err": errs["K4"], **k4_row},
        {"name": "rdb_block", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/rdb_block_sm90.cu",
         "replaces": "upscale_video_tpu/ops/rdb_pallas.py:253",
         "launches": launches["K5"], "launches_sm90": launches["K5_sm90"],
         "max_abs_err": errs["K5"], **k5_row},
        {"name": "nl_means", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/nlmeans_sm90.cu",
         "replaces": "upscale_video_tpu/ops/nlmeans_pallas.py:54",
         "launches": launches["K6"], "max_abs_err": errs["K6"],
         "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound[0],
         "bound_by": k6_bound[1], "library_ms": None},
        {"name": "winograd_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv_winograd_sm90.cu",
         "source_wmma": "upscale_video_tpu_torch/csrc/conv_winograd.cu",
         "replaces": "upscale_video_tpu/ops/conv_winograd.py:73",
         "launches": k7_launches, "launches_sm90": k7_sm90,
         "max_abs_err": errs["K7"], **body["K7"],
         "ms_wmma": body["K7_wmma"]["ms"],
         "library_ms": body["cudnn"]["ms"], "layer_ms": k7_layer["sm90"],
         "layer_ms_wmma": k7_layer["wmma"],
         "layer_library_ms": k7_layer["cudnn"]},
        {"name": "conv3x3_chain_q8", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv_chain_q8_sm90.cu",
         "source_mma_sync": "upscale_video_tpu_torch/csrc/conv_chain_q8.cu",
         "replaces": "upscale_video_tpu/ops/conv_chain_q8.py:68",
         "launches": k8_launches, "launches_sm90": k8_sm90,
         "max_abs_err": errs["K8"], **body["K8"], "library_ms": None,
         "layer_ms": k8_layer["sm90"], "layer_ms_mma_sync": k8_layer["mma_sync"],
         "layer_bf16_out_ms": k8_layer["sm90_bf16_out"],
         "layer_bound_ms": k8_layer["bound_ms"],
         "layer_bound_by": k8_layer["bound_by"],
         "layer_bf16_out_bound_ms": k8_layer["bf16_out_bound_ms"]},
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the path was never launched")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise SystemExit("jax was imported on the port's path")
    if any(m == "upscale_video_tpu" or m.startswith("upscale_video_tpu.")
           for m in sys.modules):
        raise SystemExit("the JAX package was imported on the port's path")
    if any(m == "PIL" or m.startswith("PIL.") for m in sys.modules):
        raise SystemExit("PIL was imported on the port's path")
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels, "frames_per_s": rates,
                      "e2e_wall_fps": e2e}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def y4m_payload(path):
    """The bytes of a Y4M file after its header line (the frames)."""
    data = np.fromfile(path, np.uint8)
    return data[int(np.argmax(data == ord("\n"))) + 1:]


def png_plane_phases(tmp, drive, e2e, engine, tails_on_hopper, frag_steps,
                     stream_out):
    """``[png_plane]``: ``--data_plane png --pipe_pix rgb24`` through the CLI
    on the 12-frame 1080p clip, the default chain and ``-m a,n=3``, with
    their kernel launches (the pre-SR passes step over all 12 frames, SR
    over each fragment); the default chain against the stream plane's
    rgb24 output (``stream_out``), ``a,n=3`` against its three stage_fns on
    the plain versions (``engine`` is that chain's); the port codec's ms
    per 4K frame.  Returns the default run's output path."""
    import importlib.metadata

    import torch

    from upscale_video_tpu_torch.ops.pixel import psnr
    from upscale_video_tpu_torch.video import Y4MSink, Y4MSource
    from upscale_video_tpu_torch.video.png import read_png, write_png

    try:
        pil = importlib.metadata.version("Pillow")
    except importlib.metadata.PackageNotFoundError:
        pil = "absent"
    png = ["--data_plane", "png", "--pipe_pix", "rgb24"]
    pre_steps = -(-CLIP_FRAMES // N)  # the pre-SR passes: all 12 frames
    runs = (("png_c444", [], "c444"), ("png_prelude_c444", ["-m", PRELUDE],
                                       "prelude_c444"))
    for name, extra, stream_name in runs:
        ok, geom, cs, count, k, frags, left, wall = drive(
            tmp, name, False, CLIP_FRAMES, CLIP_RATE, extra + png, keep=True)
        anime = ANIME_LAYERS * pre_steps if extra else 0
        ok = (ok and geom == (2 * W, 2 * H)
              and k["K6"] == (pre_steps if extra else 0)
              and k["K1"] == anime + 17 * frag_steps
              and k["K1_sm90"] == k["K1"]  # every K1 launch on Hopper
              and k["K1_sm90"] == anime + COMPACT_HOPPER * frag_steps
              and k["K1_narrow"] == anime + frag_steps
              and k["K2"] == frag_steps
              and k["K3"] == k["K4"] == k["K5"] == 0)
        got = y4m_payload(os.path.join(tmp, f"{name}.out.y4m"))
        if not extra:  # the stream plane's rgb24 output of the same clip
            want = y4m_payload(stream_out)
            vs = "stream plane rgb24"
        else:  # the three stages on the plain versions, u8 between them
            with Y4MSource(os.path.join(tmp, f"{name}.y4m")) as src:
                frames = np.stack(list(src))
            ref_path = os.path.join(tmp, f"{name}.plain.y4m")
            with plain_kernels(), Y4MSink(ref_path, 2 * W, 2 * H,
                                          CLIP_RATE.replace(":", "/")) as sink:
                for i in range(0, CLIP_FRAMES, N):
                    x = torch.from_numpy(frames[i:i + N]).to(engine.device)
                    for stage in ("denoise", "anime", "sr"):
                        x = engine.stage_fn(stage)(x)
                    for f in x.cpu().numpy():
                        sink.write(f)
            want = y4m_payload(ref_path)
            os.remove(ref_path)
            vs = "plain stage_fns"
        same_size = got.size == want.size
        lsb = int(np.abs(got.astype(int) - want.astype(int)).max()) \
            if same_size else -1
        differ = int((got != want).sum()) if same_size else -1
        quality = psnr(got, want) if same_size else float("nan")
        ok = ok and same_size and (
            lsb <= 1 if not extra else quality >= PNG_PRELUDE_MIN_PSNR)
        say("png_plane", path=f"-m {PRELUDE}" if extra else "default",
            clip=name, out=f"{geom[0]}x{geom[1]}", frames=count,
            pre_sr_steps=pre_steps if extra else 0, sr_steps=frag_steps,
            k6_launches=k["K6"], k1_launches=k["K1"],
            k1_sm90_launches=k["K1_sm90"], k1_narrow_launches=k["K1_narrow"],
            k2_launches=k["K2"], k2_sm90_launches=k["K2_sm90"],
            yuv_composed=k["yuv_composed"], vs=vs, differing_bytes=differ,
            max_lsb=lsb, psnr_db=f"{quality:.2f}",
            bound=(f">={PNG_PRELUDE_MIN_PSNR}dB" if extra else "max_lsb<=1"),
            workdir_after=left, wall_s=f"{wall:.2f}",
            wall_fps=f"{e2e[name]:.2f}",
            stream_wall_fps=f"{e2e[stream_name]:.2f}", ok=ok)
        if not ok:
            raise SystemExit(f"the png plane's {name} run failed")
    # the codec on one 4K output frame: write and read, median of 3
    with Y4MSource(os.path.join(tmp, "png_c444.out.y4m")) as src:
        frame = src.read()
    path = os.path.join(tmp, "codec.png")
    times = {"write": [], "read": []}
    for _ in range(3):
        t0 = time.perf_counter()
        write_png(path, frame)
        times["write"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = read_png(path)
        times["read"].append(time.perf_counter() - t0)
    ok = bool(np.array_equal(back, frame))
    say("png_plane", codec="video/png.py", frame=f"{frame.shape[1]}x{frame.shape[0]}",
        write_ms=f"{1e3 * float(np.median(times['write'])):.1f}",
        read_ms=f"{1e3 * float(np.median(times['read'])):.1f}",
        file_mb=f"{os.path.getsize(path) / 1e6:.2f}", pil=pil, ok=ok)
    os.remove(path)
    if not ok:
        raise SystemExit("the PNG codec did not read back what it wrote")
    return os.path.join(tmp, "png_c444.out.y4m")


def workflow_phases(tmp, counted, clip, png_out, stream_out, tails_on_hopper,
                    frag_steps):
    """``[workflows]``: the companion CLIs on the card over the 12-frame
    clip: ``upscale-only-torch`` then ``merge-only-torch`` (equal to the png
    plane's output), ``-x``, ``test-images-torch -m n=3`` on frames 1 and 3
    (K6 on the card), ``fix-frames-torch -b 2,5`` after deleting their
    extracted frames (equal to the zipped frames 2 and 5), and
    ``vsr-compare-torch`` of the png plane's output against the stream
    plane's."""
    import io
    import zipfile

    from upscale_video_tpu_torch.cli.compare import main as compare_main
    from upscale_video_tpu_torch.cli.fix_frames import main as fix_main
    from upscale_video_tpu_torch.cli.merge_only import main as merge_main
    from upscale_video_tpu_torch.cli.test_images import main as images_main
    from upscale_video_tpu_torch.cli.upscale_only import main as upscale_main
    from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
    from upscale_video_tpu_torch.video.png import read_png

    def sr_on_hopper(k, steps):
        return (k["K1"] == k["K1_sm90"] == 17 * steps
                and k["K1_narrow"] == steps and k["K2"] == steps
                and tails_on_hopper(k))

    split, out_dir = os.path.join(tmp, "wf_split"), os.path.join(tmp, "wf_out")
    os.makedirs(out_dir)
    rc, k, wall = counted(upscale_main, ["-i", clip, "-t", split, "-b", "1",
                                         "--synthetic_models"])
    zipped = {}
    with zipfile.ZipFile(os.path.join(split, "upscale_video", "1.zip")) as zf:
        for f in (2, 5):
            path = os.path.join(tmp, f"zipped_{f}.png")
            with open(path, "wb") as fh:
                fh.write(zf.read(f"{f}.png"))
            zipped[f] = read_png(path)
    rc2, _, wall2 = counted(merge_main, ["-o", out_dir, "-t", split])
    merged = os.path.join(out_dir, "c444.upscaled.y4m")
    equal = bool(np.array_equal(y4m_payload(merged), y4m_payload(png_out)))
    ok = rc == rc2 == 0 and sr_on_hopper(k, frag_steps) and equal
    say("workflows", step="upscale-only-torch + merge-only-torch",
        k1_launches=k["K1"], k1_sm90_launches=k["K1_sm90"],
        k2_launches=k["K2"], k2_sm90_launches=k["K2_sm90"],
        equals_png_plane=equal, upscale_s=f"{wall:.2f}",
        merge_s=f"{wall2:.2f}", ok=ok)
    if not ok:
        raise SystemExit("the split-machine workflow failed")

    xdir = os.path.join(tmp, "wf_x")
    work = os.path.join(xdir, "upscale_video")
    rc, k, wall = counted(cli_main, ["-i", clip, "-t", xdir, "-x", "-r"])
    extracted = sorted(n for n in os.listdir(work) if n.endswith(".extract.png"))
    samples = os.path.join(tmp, "wf_samples")
    rc2, k2, wall2 = counted(images_main, ["-i", "1,3", "-t", xdir, "-o",
                                           samples, "-m", "n=3",
                                           "--synthetic_models"])
    names = sorted(os.listdir(samples))
    want = sorted(f"{f}.{t}.png" for f in (1, 3)
                  for t in ("extract", "denoise", "n=3"))
    ok = (rc == rc2 == 0 and len(extracted) == CLIP_FRAMES
          and sum(k.values()) == 0 and names == want and k2["K6"] == 1
          and sr_on_hopper(k2, 1))
    say("workflows", step="-x + test-images-torch -m n=3 -i 1,3",
        extracted=len(extracted), outputs=names, k6_launches=k2["K6"],
        k1_launches=k2["K1"], k2_launches=k2["K2"], extract_s=f"{wall:.2f}",
        sample_s=f"{wall2:.2f}", ok=ok)
    if not ok:
        raise SystemExit("the -x and test-images workflow failed")

    for f in (2, 5):
        os.remove(os.path.join(work, f"{f}.extract.png"))
    rc, k, wall = counted(fix_main, ["-i", clip, "-b", "2,5", "-t", xdir,
                                     "--synthetic_models"])
    equal = {f: bool(np.array_equal(read_png(os.path.join(work, f"{f}.png")),
                                    zipped[f])) for f in (2, 5)}
    ok = rc == 0 and sr_on_hopper(k, 1) and all(equal.values())
    say("workflows", step="fix-frames-torch -b 2,5", k1_launches=k["K1"],
        k2_launches=k["K2"], equals_png_plane_frames=equal,
        fix_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise SystemExit("the fix-frames workflow failed")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = compare_main(["-a", stream_out, "-b", png_out, "--json"])
    wall = time.perf_counter() - t0
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    ok = (rc == 0 and stats["frames"] == CLIP_FRAMES
          and (stats["identical"] or stats["min_psnr_db"] >= 48.0))
    say("workflows", step="vsr-compare-torch stream vs png", **stats,
        compare_s=f"{wall:.2f}", ok=ok)
    if not ok:
        raise SystemExit("vsr-compare-torch of the two planes failed")


def flag_phases(dev, tmp, drive, counted, steps_of, rng):
    """``[flags]``: the flags ported last, each through the CLI on the
    stream plane under both contracts (one each: ``--trace_dir``), with its
    launch counts: ``--conv_impl xla`` (no kernel), on the default chain
    and on ``-m n=3`` (NL-means plain), and ``pallas -m r`` (no K5) against
    the default route's runs, ``--precision f32`` (no conv
    kernel) on the default path and ``-m r`` with one small frame against
    the CPU, ``--tile_size`` (K2's model layout on tile batches),
    ``--precision mixed`` (byte-equal to bf16), ``--trace_dir`` and the
    drives ``--tta``, ``-s 1 -m a,n=3``, ``-s 4``, ``-m n=3,r`` and ``-m
    a,r``; then ``test-chips-torch`` on the default chain and on ``-m r``
    with one tile."""
    import json
    import logging

    import torch

    from upscale_video_tpu_torch.cli import test_chips
    from upscale_video_tpu_torch.ops.pixel import psnr
    from upscale_video_tpu_torch.ops.tiling import fit_tile_grid
    from upscale_video_tpu_torch.pipeline.chain import (
        TILES_PER_STEP, ChainEngine, ChainSpec,
    )

    steps = steps_of(CLIP_FRAMES, CLIP_RATE, N)
    vsteps = steps_of(VALAR_CLIP_FRAMES, VALAR_CLIP_RATE, 1)
    s4steps = steps_of(VALAR_CLIP_FRAMES, VALAR_CLIP_RATE, N)
    def ceil(a, b):
        return -(-a // b)

    th, tw = fit_tile_grid(H, W, TILE_BUDGET)
    tile_calls = N * ceil(ceil(H, th) * ceil(W, tw), TILES_PER_STEP) * steps
    conv = ("K1", "K2", "K3", "K4", "K5")
    trace_dir = os.path.join(tmp, "trace")
    valar = dict(K5=VALAR_BLOCKS * vsteps, K5_sm90=VALAR_BLOCKS * vsteps,
                 K4=VALAR_SOLOS * vsteps, K4_sm90=VALAR_SOLOS_SM90 * vsteps,
                 K1=VALAR_CHAIN * vsteps, K1_sm90=LAST_CHAIN_SM90 * vsteps,
                 K2=0, K3=0)
    # name, extra flags, clip (frames, rate), output scale, the launch
    # counts each run must show (NO_KERNEL: every count, the Hopper and
    # model-layout shares too, is 0), (reference run, min dB, max LSB) or
    # None
    runs = (
        ("xla", ["--conv_impl", "xla"], (CLIP_FRAMES, CLIP_RATE), 2,
         NO_KERNEL, ("c444", XLA_MIN_PSNR, XLA_MAX_LSB)),
        # -m n=3 on the default route, the reference of the same chain
        # under --conv_impl xla: NL-means on its plain version, no kernel
        ("n3", ["-m", "n=3"], (CLIP_FRAMES, CLIP_RATE), 2,
         dict(K6=steps, K1=17 * steps, K2=steps, K3=0, K4=0, K5=0), None),
        ("n3_xla", ["-m", "n=3", "--conv_impl", "xla"],
         (CLIP_FRAMES, CLIP_RATE), 2, NO_KERNEL,
         ("n3_c444", XLA_MIN_PSNR, XLA_MAX_LSB)),
        ("pallas_valar", ["-m", "r", "--conv_impl", "pallas"],
         (VALAR_CLIP_FRAMES, VALAR_CLIP_RATE), 4,
         dict(K5=0, K4=(VALAR_DENSE + VALAR_SOLOS) * vsteps,
              K4_sm90=(VALAR_DENSE + VALAR_SOLOS_SM90) * vsteps,
              K1=VALAR_CHAIN * vsteps, K2=0, K3=0),
         ("valar_c444", *VALAR_PLAIN_BOUNDS[23])),
        ("f32", ["--precision", "f32"], (CLIP_FRAMES, CLIP_RATE), 2,
         dict.fromkeys(conv, 0), None),
        ("f32_valar", ["-m", "r", "--precision", "f32"],
         (VALAR_CLIP_FRAMES, VALAR_CLIP_RATE), 4, dict.fromkeys(conv, 0), None),
        ("tiled", ["--tile_size", str(TILE_BUDGET)], (CLIP_FRAMES, CLIP_RATE),
         2, dict(K1=17 * tile_calls, K1_sm90=COMPACT_HOPPER * tile_calls,
                 K2=tile_calls, K2_model=tile_calls, K3=0, K4=0, K5=0), None),
        ("mixed", ["--precision", "mixed"], (CLIP_FRAMES, CLIP_RATE), 2,
         dict(K1=17 * steps, K2=steps, K2_model=0, K5=0), ("c444", 99.0, 0)),
        ("trace", ["--trace_dir", trace_dir], (CLIP_FRAMES, CLIP_RATE), 2,
         dict(K1=17 * steps, K2=steps), None),
        ("tta", ["--tta"], (CLIP_FRAMES, CLIP_RATE), 2,
         dict(K1=8 * 17 * steps, K1_sm90=8 * COMPACT_HOPPER * steps,
              K2=8 * steps, K2_model=8 * steps), None),
        ("s1_prelude", ["-s", "1", "-m", PRELUDE], (CLIP_FRAMES, CLIP_RATE), 1,
         dict(K6=steps, K1=ANIME_LAYERS * steps,
              K1_narrow=ANIME_LAYERS * steps, K2=0), None),
        ("s4", ["-s", "4"], (VALAR_CLIP_FRAMES, VALAR_CLIP_RATE), 4,
         dict(K1=17 * s4steps, K1_sm90=COMPACT_HOPPER * s4steps,
              K2=s4steps, K2_sm90=s4steps, K5=0), None),
        ("n3_valar", ["-m", "n=3,r"], (VALAR_CLIP_FRAMES, VALAR_CLIP_RATE), 4,
         dict(valar, K6=vsteps), None),
        ("anime_valar", ["-m", "a,r"], (VALAR_CLIP_FRAMES, VALAR_CLIP_RATE), 4,
         dict(valar, K1=(ANIME_LAYERS + VALAR_CHAIN) * vsteps,
              K1_sm90=(ANIME_LAYERS + LAST_CHAIN_SM90) * vsteps, K6=0), None),
    )
    # the runs whose c444 output a later run is held against
    own = {f"{r[0]}_c444" for r in runs}
    refs = {ref[0] for *_, ref in runs if ref and ref[0] in own}
    for name, extra, (frames, rate), scale, want, ref in runs:
        for c420 in ((False,) if name == "trace" else (True, False)):
            run = f"{name}_{'c420jpeg' if c420 else 'c444'}"
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, run, c420, frames, rate, extra,
                keep=ref is not None or run in refs)
            ok = (ok and geom == (scale * W, scale * H)
                  and (all(v == 0 for v in k.values()) if want is NO_KERNEL
                       else all(k[key] == v for key, v in want.items())))
            vs = {}
            if ref is not None and not c420:
                got = y4m_payload(os.path.join(tmp, f"{run}.out.y4m"))
                base = y4m_payload(os.path.join(tmp, f"{ref[0]}.out.y4m"))
                same = got.size == base.size
                lsb = (int(np.abs(got.astype(int) - base.astype(int)).max())
                       if same else -1)
                quality = psnr(got, base) if same else float("nan")
                vs = dict(vs=ref[0], psnr_db=f"{quality:.2f}", max_lsb=lsb,
                          bound=f">={ref[1]}dB,max_lsb<={ref[2]}")
                ok = ok and same and quality >= ref[1] and 0 <= lsb <= ref[2]
            if ref is not None:
                os.remove(os.path.join(tmp, f"{run}.out.y4m"))
                if not c420 and ref[0] in refs:
                    os.remove(os.path.join(tmp, f"{ref[0]}.out.y4m"))
            if name == "trace":  # the trace names K1's sm90 kernel
                (trace,) = os.listdir(trace_dir)
                with open(os.path.join(trace_dir, trace)) as f:
                    events = json.load(f)["traceEvents"]
                k1_sm90 = sum(TRACE_K1 in str(e.get("name", "")) for e in events)
                vs = dict(trace=trace, events=len(events),
                          k1_sm90_events=k1_sm90)
                ok = ok and k1_sm90 > 0
            os.remove(os.path.join(tmp, f"{run}.y4m"))
            say("flags", run=run, flags=" ".join(extra).replace(tmp, "<tmp>"),
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                **{f"{key.lower()}_launches": v for key, v in k.items() if v},
                **vs, wall_s=f"{wall:.2f}", ok=ok)
            if not ok:
                raise SystemExit(f"the {run} run failed: expected {want}")

    # f32 on the card: no conv kernel, and one small frame within
    # F32_MAX_LSB of the same step on the CPU, default path and -m r
    small = torch.from_numpy(np.stack([write_frame(64, 96, 0, rng)]))
    for models, scale in ((None, 2), ("r", 4)):
        spec = ChainSpec.parse(models)
        card = ChainEngine.build(spec, scale, dev, compute_dtype=torch.float32,
                                 synthetic=True)
        cpu = ChainEngine.build(spec, scale, "cpu", compute_dtype=torch.float32,
                                synthetic=True)
        out, k, _ = counted(lambda: card.step(small.to(dev)).cpu().numpy())
        ref = cpu.step(small).numpy()
        lsb = int(np.abs(out.astype(int) - ref.astype(int)).max())
        ok = lsb <= F32_MAX_LSB and all(k[key] == 0 for key in conv)
        say("flags", check="f32 card vs cpu", path=f"-m {models}" if models
            else "default", shape=out.shape, max_lsb=lsb,
            frac_differ=f"{(out != ref).mean():.3e}",
            conv_launches=sum(k[key] for key in conv),
            bound=f"max_lsb<={F32_MAX_LSB}", ok=ok)
        if not ok:
            raise SystemExit(f"f32 on the card disagrees with the CPU "
                             f"({models or 'default'})")
        del card, cpu
    torch.cuda.empty_cache()

    # test-chips-torch in this process (its launches counted): the default
    # chain over two depths, -m r at 1080p with one tile
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep()
    logging.getLogger("upscale_video_tpu_torch.pipeline.calibrate").addHandler(keep)
    # the tool's default frame for each: 540x960, and 1080p for -m r
    for path, argv, points, kernel in (
            ("default", ["-r", "3", "--batch_depths", "1,4", "--height",
                         str(H // 2), "--width", str(W // 2)], 2, "K2"),
            ("-m r", ["-m", "r", "-r", "1", "--batch_depths", "1",
                      "--tiles", "544x480", "--height", str(H), "--width",
                      str(W)], 1, "K5")):
        lines.clear()
        rc, k, wall = counted(test_chips.main, ["--synthetic_models", "--device",
                                                str(dev), *argv])
        timed = [ln for ln in lines if "frames_per_step=" in ln]
        best = [ln for ln in lines if ln.startswith("best: ")]
        ok = rc == 0 and len(timed) == points and len(best) == 1 and k[kernel] > 0
        say("test_chips", path=path, points=" | ".join(timed),
            best=best[0] if best else None,
            **{f"{key.lower()}_launches": v for key, v in k.items() if v},
            wall_s=f"{wall:.2f}", ok=ok)
        if not ok:
            raise SystemExit(f"test-chips-torch ({path}) failed")
    logging.getLogger("upscale_video_tpu_torch.pipeline.calibrate").removeHandler(keep)


def k2_tiles_phase(dev, errs) -> dict:
    """``[K2_tiles]``: K1 then K2 in its f32 model layout over the tile
    batch ``--tile_size 256`` gives the SR stage at 1080p (8 tiles of
    216x240 plus a 16-pixel halo) and over 8 of (256+32)x(256+32), each
    against K2's plain version on the same K1 output; timed beside it;
    then the tiled 1080p step against the same step on the plain
    versions."""
    import torch

    from upscale_video_tpu_torch.models.executor import chain_layers
    from upscale_video_tpu_torch.models.zoo import make_synthetic_model
    from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain
    from upscale_video_tpu_torch.ops.pixel import psnr
    from upscale_video_tpu_torch.ops.tail import (
        sr_tail_chain, sr_tail_chain_plain,
    )
    from upscale_video_tpu_torch.ops.tiling import fit_tile_grid
    from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec

    model = make_synthetic_model(scale=2, seed=0, device=dev)
    fwd = model.frames_forward("model")
    layers = chain_layers(fwd.items, model.state)
    tail = model.state[fwd.tail["conv"]]
    th, tw = fit_tile_grid(H, W, TILE_BUDGET)
    row = {}
    for h, w in ((th + 32, tw + 32), (TILE_BUDGET + 32, TILE_BUDGET + 32)):
        x = image_like(8, h, w, seed=h, device=dev).to(torch.bfloat16)
        buf = conv3x3_chain(x, layers, crop=False)
        args = (buf, x, tail.wmat, tail.bias, 2, "model")
        before = sr_tail_chain.launches_model
        got = sr_tail_chain(*args, False, tail.wpack_tail)
        if sr_tail_chain.launches_model != before + 1:
            raise SystemExit("K2 did not count its model-layout launch")
        tail_check("K2_tiles", got, sr_tail_chain_plain(*args), layout="model",
                   tiles=f"8x{h}x{w}", kernel="sm90")
        ms = cuda_ms(lambda: sr_tail_chain(*args, False, tail.wpack_tail), 20)
        plain_ms = cuda_ms(lambda: sr_tail_chain_plain(*args), 3)
        nbytes = (buf.numel() * 2 + x.numel() * 2 + tail.wmat.numel() * 2
                  + 8 * h * w * 12 * 4)
        bound = roofline(nbytes, {"bf16": 2 * 9 * 64 * 12 * 8 * h * w})
        say("K2_tiles", tiles=f"8x{h}x{w}", layout="model", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
            bound_by=bound[1], share=f"{bound[0] / ms:.3f}")
        row[f"{h}x{w}"] = ms
        del x, buf, got
    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True,
                            tile=TILE_BUDGET)
    frame = torch.from_numpy(np.stack([write_frame(H, W, 0,
                                                   np.random.default_rng(2))]))
    out = eng.step(frame.to(dev)).cpu().numpy()
    ref = plain_call(eng.step, frame.to(dev)).cpu().numpy()
    quality = psnr(out, ref)
    ok = quality >= TILED_MIN_PSNR and out.shape == (1, 2 * H, 2 * W, 3)
    say("tiled_step_vs_plain", tile=f"{th}x{tw}", shape=out.shape,
        psnr_db=f"{quality:.2f}",
        max_lsb=int(np.abs(out.astype(int) - ref.astype(int)).max()),
        bound=f">={TILED_MIN_PSNR}dB", ok=ok)
    if not ok:
        raise SystemExit("the tiled step disagrees with its plain step")
    del eng
    torch.cuda.empty_cache()
    return row


def k4_valar_phase(dev, errs, veng) -> dict:
    """``[K4_valar]``: K4 at Valar's five dense-block shapes as ``--conv_impl
    pallas`` runs them on the ``-m r`` tile batch (8x576x512): each conv
    reads its channel prefix of one 192-channel buffer and writes its
    channels behind it (the last a tensor of its own), with block r0d0's
    weights, against its plain version on the same channels; each timed
    beside the plain version and cuDNN, with its bound."""
    import torch

    from upscale_video_tpu_torch.models.executor import _solo_args, build_forward
    from upscale_video_tpu_torch.ops.conv3x3 import (
        conv3x3_fused, conv3x3_fused_plain,
    )

    model = veng.sr_model
    pfwd = build_forward(model.graph, dev, torch.bfloat16, "model",
                         torch.float32, conv_impl="pallas")
    names = [f"r0d0_c{k}" for k in (1, 4, 9, 12, 16)]
    plans = [pfwd.dense[n] for n in names]
    if [p["cin"] for p in plans] != [c for c, _ in K4_DENSE]:
        raise SystemExit(f"the pallas plan's dense convs read {plans}")
    g = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn((*TILES, K4_DENSE[-1][0]), generator=g,
                      device=dev).to(torch.bfloat16)
    times = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, plan, (cin, cout) in zip(names, plans, K4_DENSE):
        args = _solo_args(pfwd.solos[name], model.state)
        x = buf[..., :cin]
        dst = buf.clone() if plan["out_off"] is not None else None
        before = conv3x3_fused.launches_sm90

        def run():
            return conv3x3_fused(x, *args, out=dst, out_off=plan["out_off"] or 0)

        got = run()
        if conv3x3_fused.launches_sm90 != before + 1:
            raise SystemExit(f"K4 at Valar's {cin}->{cout} missed its sm90 kernel")
        want = conv3x3_fused_plain(x, *args)
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        if dst is not None:  # only its own channels written
            ok = ok and torch.equal(dst[..., :plan["out_off"]],
                                    buf[..., :plan["out_off"]])
        ms = cuda_ms(run, 5)
        plain_ms = cuda_ms(lambda: conv3x3_fused_plain(x, *args), 2)
        w_cl, b16 = conv_weight_cl(args[0]), args[1].to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: cudnn_conv(x, w_cl, b16), 5)
        nbytes, flop = conv_work(*TILES, cin, cout)
        bound = roofline(nbytes, {"bf16": flop})
        say("K4_valar", conv=name, shape="x".join(map(str, (*TILES, cin))),
            cout=cout, out_off=plan["out_off"], post_add=plan["post_add"],
            max_abs_err=worst, frac_differ=f"{differ:.3e}",
            bound="atol=2**-10,rtol=2**-7", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.3f}", cudnn_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
            share_of_bound=f"{bound[0] / ms:.3f}", ok=ok)
        if not ok:
            raise SystemExit(f"K4 disagrees with its plain version at Valar's "
                             f"{name}")
        errs["K4"] = max(errs["K4"], worst)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound[0])):
            times[key] += v
        del got, want, dst
    del buf
    torch.cuda.empty_cache()
    say("K4_valar", per="the five convs of one Valar dense block, 8x576x512",
        **{k: f"{v:.3f}" for k, v in times.items()})
    return times


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper the engines call swapped for its plain version
    (K1 -> conv3x3_chain_plain, K2 -> sr_tail_chain_plain, K3 ->
    sr_tail_fused_plain, K4 -> conv3x3_fused_plain, K5 -> rdb_block_plain,
    K6 -> nl_means_denoise_plain); fails if a kernel launched inside."""
    from upscale_video_tpu_torch.models import executor
    from upscale_video_tpu_torch.ops import (
        conv3x3, conv_chain, nlmeans, rdb, tail,
    )
    from upscale_video_tpu_torch.pipeline import chain

    def tail_chain_plain(buf, skip, wmat, bias, scale, layout="planar",
                         full_range=False, wpack=None):
        return tail.sr_tail_chain_plain(buf, skip, wmat, bias, scale, layout,
                                        full_range)

    swaps = [(executor, "conv3x3_chain", conv_chain.conv3x3_chain_plain),
             (executor, "sr_tail_chain", tail_chain_plain),
             (executor, "sr_tail_fused", tail.sr_tail_fused_plain),
             (executor, "conv3x3_fused", conv3x3.conv3x3_fused_plain),
             (executor, "rdb_block", rdb.rdb_block_plain),
             (chain, "nl_means_denoise", nlmeans.nl_means_denoise_plain)]
    wrappers = (conv_chain.conv3x3_chain, tail.sr_tail_chain,
                tail.sr_tail_fused, conv3x3.conv3x3_fused, rdb.rdb_block,
                nlmeans.nl_means_denoise)
    before = [w.launches for w in wrappers]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    if [w.launches for w in wrappers] != before:
        raise SystemExit("a plain step launched a kernel")


def plain_call(fn, *args):
    """``fn(*args)`` with every kernel swapped for its plain version."""
    with plain_kernels():
        return fn(*args)


def tail_check(name, got, want, **where) -> float:
    """One tail layout against its plain version: u8 within K2_MAX_LSB,
    f32 within K3_MODEL_ATOL; prints the share of values that differ."""
    import torch

    torch.cuda.synchronize()
    layout = where["layout"]
    bound = K3_MODEL_ATOL if layout == "model" else K2_MAX_LSB
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit(f"{name} ({layout}) returned {tuple(got.shape)}/{got.dtype}, "
                         f"not {tuple(want.shape)}/{want.dtype}")
    worst, differ = 0.0, 0
    for g, w in zip(got, want):  # one frame at a time to bound memory
        d = (g.float() - w.float()).abs()
        worst = max(worst, d.max().item())
        differ += int((d > 0).sum().item())
    ok = worst <= bound and bool(torch.isfinite(got.float()).all())
    say(name, **where, shape=tuple(got.shape), max_abs_err=worst,
        frac_differ=f"{differ / got.numel():.3e}", bound=bound, ok=ok)
    if not ok:
        raise SystemExit(f"{name} ({where}) disagrees with its plain version")
    return worst


def k2_phases(errs, buf, x, tail) -> dict:
    """[K2]: K2's Hopper kernel against its plain version on the main path's
    bordered K1 output (4x1080p, Cf 64, 2x) in every layout; [K2_ab]: the
    planar launch on the Hopper kernel, the WMMA kernel (called directly),
    the plain version and, as a yardstick, cuDNN's bf16 conv of the same
    shape alone (it is not the same function: no skip, shuffle or u8);
    [K2_yuv_ab]: the fused yuv420 launch against the planar launch followed
    by yuv420_from_planar (Hopper and WMMA)."""
    import torch
    import torch.nn.functional as F

    from upscale_video_tpu_torch.kernels import build
    from upscale_video_tpu_torch.ops.tail import sr_tail_chain, sr_tail_chain_plain
    from upscale_video_tpu_torch.ops.yuv import yuv420_from_planar

    args = (buf, x, tail.wmat, tail.bias, 2)
    for layout, full in TAIL_LAYOUTS:
        before = sr_tail_chain.launches_sm90
        got = sr_tail_chain(*args, layout, full, tail.wpack_tail)
        if sr_tail_chain.launches_sm90 != before + 1:
            raise SystemExit("K2 at Cf 64 did not run on its Hopper kernel")
        worst = tail_check("K2", got, sr_tail_chain_plain(*args, layout, full),
                           layout=layout, full_range=full, kernel="sm90")
        if layout != "model":
            errs["K2"] = max(errs.get("K2", 0.0), worst)
        del got
    n, hp, wp, cf = buf.shape
    h, w = hp - 2, wp - 2
    planar = torch.empty((n, h, w, 12), dtype=torch.uint8, device=buf.device)
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def wmma():
        build.check(lib.uvt_sr_tail(buf.data_ptr(), x.data_ptr(), tail.wmat.data_ptr(),
                                    tail.bias.data_ptr(), planar.data_ptr(), n, h, w, cf,
                                    2, 0, stream), "sr_tail (WMMA)")
        return planar

    w_cl, b16 = conv_weight_cl(tail.wmat), tail.bias.to(torch.bfloat16)
    sm90 = lambda layout="planar", full=False: sr_tail_chain(  # noqa: E731
        *args, layout, full, tail.wpack_tail)
    ms = cuda_ms(sm90, 20)
    ms_wmma = cuda_ms(wmma, 10)
    plain_ms = cuda_ms(lambda: sr_tail_chain_plain(*args, "planar"), 3)
    cudnn_ms = cuda_ms(lambda: F.conv2d(buf.permute(0, 3, 1, 2), w_cl, b16), 10)
    ms_again = cuda_ms(sm90, 20)
    fixed = buf.numel() * 2 + x.numel() * 2 + tail.wmat.numel() * 2 + tail.bias.numel() * 4
    flop = {"bf16": 2 * 9 * cf * 12 * n * h * w}
    bound = roofline(fixed + n * h * w * 12, flop)
    say("K2_ab", ms=f"{ms:.4f}", ms_again=f"{ms_again:.4f}", wmma_ms=f"{ms_wmma:.4f}",
        plain_ms=f"{plain_ms:.4f}", cudnn_yardstick_ms=f"{cudnn_ms:.4f}",
        bound_ms=f"{bound[0]:.4f}", bound_by=bound[1], share=f"{bound[0] / ms:.3f}",
        per="one launch, 4x1080p, Cf 64 -> planar u8 (cuDNN: the 64->12 conv alone)")
    yuv_ms = cuda_ms(lambda: sm90("yuv420", True), 20)
    composed_ms = cuda_ms(lambda: yuv420_from_planar(sm90(), 2, True), 10)
    wmma_composed_ms = cuda_ms(lambda: yuv420_from_planar(wmma(), 2, True), 10)
    yuv_bound = roofline(fixed + n * h * w * 6, flop)
    say("K2_yuv_ab", fused_ms=f"{yuv_ms:.4f}", planar_then_pack_ms=f"{composed_ms:.4f}",
        wmma_planar_then_pack_ms=f"{wmma_composed_ms:.4f}",
        bound_ms=f"{yuv_bound[0]:.4f}", bound_by=yuv_bound[1],
        share=f"{yuv_bound[0] / yuv_ms:.3f}",
        per="4x1080p -> packed 4:2:0 u8, full range")
    return {"ms": ms, "ms_wmma": ms_wmma, "plain_ms": plain_ms, "library_ms": cudnn_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "yuv420_ms": yuv_ms,
            "yuv420_composed_ms": composed_ms, "yuv420_bound_ms": yuv_bound[0]}


def k3_phases(dev, errs) -> dict:
    """[K3]: K3's Hopper kernel against its plain version at 4x1080p for
    each K3_CASES tail in every layout; [K3_ab]: the nf-160 import's
    160 -> 48 tail (planar) on the Hopper kernel, the WMMA kernel (called
    directly), the plain version and cuDNN's bf16 conv of the same shape
    alone as a yardstick."""
    import torch
    import torch.nn.functional as F

    from upscale_video_tpu_torch.kernels import build
    from upscale_video_tpu_torch.ops.tail import sr_tail_fused, sr_tail_fused_plain

    for cf, s in K3_CASES:
        g = torch.Generator(device=dev).manual_seed(cf + s)
        u = (torch.randn((N, H, W, cf), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
        skip = torch.rand((N, H, W, 3), generator=g, device=dev).to(torch.bfloat16)
        wmat = (torch.randn((9 * cf, 3 * s * s), generator=g, device=dev)
                * 0.3 / (9 * cf) ** 0.5).to(torch.bfloat16)
        bias = torch.randn((3 * s * s,), generator=g, device=dev) * 0.05
        args = (u, skip, wmat, bias, s)
        for layout, full in TAIL_LAYOUTS:
            before = sr_tail_fused.launches_sm90
            got = sr_tail_fused(*args, layout, full)
            if sr_tail_fused.launches_sm90 != before + 1:
                raise SystemExit(f"K3 at Cf {cf} did not run on its Hopper kernel")
            worst = tail_check("K3", got, sr_tail_fused_plain(*args, layout, full),
                               cf=cf, scale=s, layout=layout, full_range=full)
            if layout != "model":
                errs["K3"] = max(errs.get("K3", 0.0), worst)
            del got
        if (cf, s) != K3_CASES[-1]:
            del u, skip, args
        torch.cuda.empty_cache()
    cf, s = K3_CASES[-1]
    planar = torch.empty((N, H, W, 3 * s * s), dtype=torch.uint8, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def wmma():
        build.check(lib.uvt_sr_tail_plain(u.data_ptr(), skip.data_ptr(), wmat.data_ptr(),
                                          bias.data_ptr(), planar.data_ptr(), N, H, W,
                                          cf, s, 0, stream), "sr_tail_plain (WMMA)")

    w_cl, b16 = conv_weight_cl(wmat), bias.to(torch.bfloat16)
    ms = cuda_ms(lambda: sr_tail_fused(*args, "planar"), 10)
    ms_wmma = cuda_ms(wmma, 5)
    plain_ms = cuda_ms(lambda: sr_tail_fused_plain(*args, "planar"), 2)
    cudnn_ms = cuda_ms(lambda: cudnn_conv(u, w_cl, b16), 10)
    ms_again = cuda_ms(lambda: sr_tail_fused(*args, "planar"), 10)
    yuv_ms = cuda_ms(lambda: sr_tail_fused(*args, "yuv420", True), 10)
    bound = roofline(N * H * W * (2 * cf + 2 * 3 + 3 * s * s)
                     + 9 * cf * 3 * s * s * 2 + 3 * s * s * 4,
                     {"bf16": 2 * 9 * cf * 3 * s * s * N * H * W})
    say("K3_ab", ms=f"{ms:.4f}", ms_again=f"{ms_again:.4f}", wmma_ms=f"{ms_wmma:.4f}",
        plain_ms=f"{plain_ms:.4f}", cudnn_yardstick_ms=f"{cudnn_ms:.4f}",
        yuv420_ms=f"{yuv_ms:.4f}", bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
        share=f"{bound[0] / ms:.3f}",
        per=f"one launch, {N}x1080p, Cf {cf}, {s}x -> planar u8 (cuDNN: the "
            f"{cf}->{3 * s * s} conv alone)")
    del u, skip, args, planar
    torch.cuda.empty_cache()
    return {"ms": ms, "ms_wmma": ms_wmma, "plain_ms": plain_ms, "library_ms": cudnn_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "yuv420_ms": yuv_ms}


def k1_sm90_phases(dev, errs) -> float:
    """[K1_sm90] and [K1_ab]: one 64->64 layer per activation on the sm90
    kernel against its plain version at 4x1080p and two ragged shapes (W
    no multiple of the 64-wide tile, H none of its 4 rows), ring checked;
    then one PReLU layer at 4x1080p timed on the WMMA kernel (called
    directly), the sm90 kernel and cuDNN.  Returns the sm90 layer's ms."""
    import torch

    from upscale_video_tpu_torch.ops.common import (
        ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
    )
    from upscale_video_tpu_torch.ops.conv_chain import (
        conv3x3_chain, conv3x3_chain_plain, embed, launch_chain_layer,
        make_layer, sm90_takes,
    )

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    c = BODY_C
    assert sm90_takes(c, c)

    def layer(act):
        slope = (rng.uniform(0.1, 0.3, (c,)).astype(np.float32)
                 if act == ACT_PRELU else 0.2 if act == ACT_LEAKY else None)
        return make_layer(rng.normal(0, 0.15, (3, 3, c, c)).astype(np.float32),
                          rng.normal(0, 0.05, (c,)).astype(np.float32), slope,
                          act, device=dev)

    for shape in ((N, H, W), (2, 37, 53), (1, 67, 130)):
        x = torch.randn((*shape, c), generator=gen, device=dev).to(torch.bfloat16)
        src = embed(x)
        for act in (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU):
            lay = layer(act)
            dst = torch.zeros_like(src)
            sm90 = conv3x3_chain.launches_sm90
            launch_chain_layer(src, dst, lay)
            torch.cuda.synchronize()
            want = conv3x3_chain_plain(x, [lay], crop=False)
            worst, differ, ok = compare(dst, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
            ring = torch.ones(dst.shape[1:3], dtype=torch.bool, device=dev)
            ring[1:-1, 1:-1] = False
            ring_zero = int(torch.count_nonzero(dst[:, ring])) == 0
            on_sm90 = conv3x3_chain.launches_sm90 - sm90 == 1
            ok = ok and ring_zero and on_sm90
            say("K1_sm90", shape="x".join(map(str, shape)), act=act,
                max_abs_err=worst, frac_differ=f"{differ:.3e}",
                bound=f"atol={K1_LAYER_ATOL},rtol={K1_LAYER_RTOL}",
                ring_zero=ring_zero, on_sm90=on_sm90, ok=ok)
            if not ok:
                raise SystemExit(f"K1's sm90 layer disagrees with its plain "
                                 f"version at {shape}, act {act}")
            errs["K1"] = max(errs.get("K1", 0.0), worst)
            del dst, want
        del x, src

    # the A/B at 4x1080p: the bound counts the interior read and written
    # once with the weights (bytes) against 2*9*c*c operations per pixel
    x = torch.randn((N, H, W, c), generator=gen, device=dev).to(torch.bfloat16)
    src = embed(x)
    dst = torch.zeros_like(src)
    lay = layer(ACT_PRELU)
    w_cl = conv_weight_cl(lay.wmat)
    b16 = lay.bias.to(torch.bfloat16)
    nbytes, flop = conv_work(N, H, W, c, c)
    bound = roofline(nbytes, {"bf16": flop})
    ops_ms = 1e3 * flop / PEAK_OPS["bf16"]
    out = {}
    for name, fn in (
            ("wmma", lambda: wmma_layer(src, dst, lay)),
            ("sm90", lambda: launch_chain_layer(src, dst, lay)),
            ("cudnn", lambda: cudnn_conv(x, w_cl, b16))):
        out[name] = cuda_ms(fn, 10)
    for name, ms in out.items():
        say("K1_ab", impl=name, shape=f"{N}x{H}x{W}", layer=f"{c}->{c} prelu",
            ms=f"{ms:.4f}", tflops=f"{flop / ms / 1e9:.1f}",
            ops_bound_ms=f"{ops_ms:.4f}", share_of_ops_bound=f"{ops_ms / ms:.3f}",
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
            vs_wmma=f"{ms / out['wmma']:.3f}")
    if out["sm90"] >= out["wmma"]:
        raise SystemExit("K1's sm90 layer is no faster than its WMMA layer")
    return out["sm90"]


def k1_counts():
    """K1's launch counters: every launch, those on either Hopper kernel,
    those on the narrow one."""
    from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain

    return [conv3x3_chain.launches, conv3x3_chain.launches_sm90,
            conv3x3_chain.launches_narrow]


def k1_narrow_phases(dev, errs) -> dict:
    """[K1_narrow] and [K1_shapes_ab]: each narrow shape on the narrow
    Hopper kernel against its plain version at 4x1080p and the
    ``K1_NARROW_RAGGED`` sizes under every activation, and each path size
    of ``K1_NARROW_SHAPES`` under its path's activation: the one-layer
    class, finite, ring zero, an 8-wide output's channels 3..7 zero, and
    on the narrow kernel (its counter moved by one; a miss ends the run).
    Then [K1_shapes_ab]; returns its figures."""
    import torch

    from upscale_video_tpu_torch.ops.common import (
        ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
    )
    from upscale_video_tpu_torch.ops.conv_chain import (
        chain_kernel, conv3x3_chain_plain, embed, in_width,
        launch_chain_layer, out_width,
    )

    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev).manual_seed(9)
    acts = {"none": ACT_NONE, "prelu": ACT_PRELU}
    shapes = list(dict.fromkeys((cin, cout) for cin, cout, *_ in K1_NARROW_SHAPES))
    cases = [(cin, cout, size, act)
             for cin, cout in shapes for size in ((N, H, W),) + K1_NARROW_RAGGED
             for act in (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU)]
    cases += [(cin, cout, size, acts[act])
              for cin, cout, act, size, _ in K1_NARROW_SHAPES if size != (N, H, W)]
    for cin, cout, size, act in cases:
        if chain_kernel(cin, cout) != "narrow":
            raise SystemExit(f"K1's {cin}->{cout} layer is not routed to the "
                             "narrow kernel")
        lay = narrow_layer(rng, cin, cout, act, dev)
        x = torch.randn((*size, cin), generator=gen, device=dev).to(torch.bfloat16)
        src = embed(x, width=in_width(lay))
        dst = torch.zeros((*src.shape[:3], out_width(lay)), dtype=torch.bfloat16,
                          device=dev)
        before = k1_counts()
        launch_chain_layer(src, dst, lay)
        torch.cuda.synchronize()
        on_narrow = k1_counts()[2] - before[2] == 1
        want = conv3x3_chain_plain(x, [lay], crop=False)
        worst, differ, ok = compare(dst[..., :cout], want, K1_LAYER_ATOL,
                                    K1_LAYER_RTOL)
        ring = torch.ones(dst.shape[1:3], dtype=torch.bool, device=dev)
        ring[1:-1, 1:-1] = False
        ring_zero = int(torch.count_nonzero(dst[:, ring])) == 0
        pad_zero = int(torch.count_nonzero(dst[..., cout:])) == 0
        finite = all(bool(torch.isfinite(d).all()) for d in dst)
        say("K1_narrow", shape="x".join(map(str, size)), layer=f"{cin}->{cout}",
            act=act, max_abs_err=worst, frac_differ=f"{differ:.3e}",
            bound=f"atol={K1_LAYER_ATOL},rtol={K1_LAYER_RTOL}", finite=finite,
            ring_zero=ring_zero, pad_zero=pad_zero, on_narrow=on_narrow,
            ok=ok and finite and ring_zero and pad_zero and on_narrow)
        if not on_narrow:
            raise SystemExit(f"a {cin}->{cout} K1 layer missed the narrow kernel")
        if not (ok and finite and ring_zero and pad_zero):
            raise SystemExit(f"K1's narrow kernel disagrees with its plain "
                             f"version at {cin}->{cout} {size}, act {act}")
        errs["K1"] = max(errs.get("K1", 0.0), worst)
        del x, src, dst, want
        torch.cuda.empty_cache()
    return k1_shapes_ab(dev)


def narrow_layer(rng, cin, cout, act, dev):
    """A seeded K1 layer of one narrow shape (weights N(0, 0.15), bias
    N(0, 0.05), PReLU slopes U(0.1, 0.3), the leaky slope 0.2)."""
    from upscale_video_tpu_torch.ops.common import ACT_LEAKY, ACT_PRELU
    from upscale_video_tpu_torch.ops.conv_chain import make_layer

    slope = (rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
             if act == ACT_PRELU else 0.2 if act == ACT_LEAKY else None)
    return make_layer(rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
                      rng.normal(0, 0.05, (cout,)).astype(np.float32), slope,
                      act, device=dev)


def k1_shapes_ab(dev, impls=("narrow", "wmma", "cudnn")) -> dict:
    """[K1_shapes_ab]: each ``K1_NARROW_SHAPES`` row alone at its path's
    size, timed on each of ``impls``: the narrow Hopper kernel (what the
    port launches), K1's WMMA kernel called directly, and cuDNN's bf16
    conv (no activation), each with its share of the layer's bound (the
    real channels read and written once, ``conv_work``).  Returns
    ``{"cin->cout@NxHxW": {impl: ms, "bound_ms": ..}}``."""
    import torch

    from upscale_video_tpu_torch.ops.common import ACT_NONE, ACT_PRELU
    from upscale_video_tpu_torch.ops.conv_chain import (
        embed, in_width, launch_chain_layer, out_width,
    )

    rng = np.random.default_rng(11)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for cin, cout, act, (n, h, w), where in K1_NARROW_SHAPES:
        lay = narrow_layer(rng, cin, cout,
                           ACT_PRELU if act == "prelu" else ACT_NONE, dev)
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        nbytes, flop = conv_work(n, h, w, cin, cout)
        bound = roofline(nbytes, {"bf16": flop})
        fns = {}
        if "narrow" in impls:
            nsrc = embed(x, width=in_width(lay))
            ndst = torch.zeros((*nsrc.shape[:3], out_width(lay)),
                               dtype=torch.bfloat16, device=dev)
            fns["narrow"] = lambda: launch_chain_layer(nsrc, ndst, lay)
        if "wmma" in impls:
            src = embed(x)
            dst = torch.zeros((*src.shape[:3], cout), dtype=torch.bfloat16,
                              device=dev)
            fns["wmma"] = lambda: wmma_layer(src, dst, lay)
        if "cudnn" in impls:
            w_cl = conv_weight_cl(lay.wmat)
            b16 = lay.bias.to(torch.bfloat16)
            fns["cudnn"] = lambda: cudnn_conv(x, w_cl, b16)
        key = f"{cin}->{cout}@{n}x{h}x{w}"
        row = {"bound_ms": bound[0], "bound_by": bound[1], "where": where}
        for name, fn in fns.items():
            row[name] = cuda_ms(fn, 10)
        for name in fns:
            ms = row[name]
            say("K1_shapes_ab", shape=key, act=act, where=repr(where),
                impl=name, ms=f"{ms:.4f}", bound_ms=f"{bound[0]:.4f}",
                bound_by=bound[1], share_of_bound=f"{bound[0] / ms:.3f}",
                gb_per_s=f"{nbytes / ms / 1e6:.1f}",
                vs_cudnn=f"{ms / row['cudnn']:.3f}" if "cudnn" in row else "-")
        out[key] = row
        del fns, x
        torch.cuda.empty_cache()
    return out


def k4_phases(dev, errs) -> dict:
    """[K4_sm90], [K4_time] and [K4_ab]: K4 against its plain version at
    every ``K4_SHAPES`` row (unit-scale inputs), the kernel each shape took
    (``launches_sm90``), and for the shapes the sm90 kernel takes the same
    conv read from channels [0, cin) of a wider buffer (junk past cin) and
    written at channel offset 8 of a sentinel-filled one: equal to the
    contiguous call bit for bit, every other channel untouched.  Then each
    shape's time beside its plain version, cuDNN's bf16 conv and its bound;
    the dense shapes and one dense block on the sm90 kernel, the WMMA
    kernel (called directly) and cuDNN.  Returns the kernels line's K4
    figures: one dense block's five convs on one 192-channel buffer."""
    import torch

    from upscale_video_tpu_torch.ops.common import (
        ACT_LEAKY, ACT_NONE, ACT_PRELU,
    )
    from upscale_video_tpu_torch.ops.conv3x3 import (
        conv3x3_fused, conv3x3_fused_plain, sm90_takes,
    )

    acts = {"none": ACT_NONE, "leaky": ACT_LEAKY, "prelu": ACT_PRELU}
    sentinel = 7.0
    dense = {}
    for cin, cout, act_name, h, w in K4_SHAPES:
        n = 2 if (h, w) == (37, 53) else 1
        g = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
        x = torch.randn((n, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
        wmat = (torch.randn((9 * cin, cout), generator=g, device=dev)
                / (9 * cin) ** 0.5).to(torch.bfloat16)
        bias = torch.randn((cout,), generator=g, device=dev) * 0.1
        act = acts[act_name]
        slope = (torch.rand((cout,), generator=g, device=dev) * 0.2 + 0.1
                 if act == ACT_PRELU else 0.2 if act == ACT_LEAKY else None)
        args = (wmat, bias, slope, act)
        sm90 = conv3x3_fused.launches_sm90
        got = conv3x3_fused(x, *args)
        torch.cuda.synchronize()
        route = "sm90" if conv3x3_fused.launches_sm90 - sm90 else "wmma"
        want = conv3x3_fused_plain(x, *args)
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        ok = ok and (route == "sm90") == sm90_takes(cin, cout, torch.bfloat16)
        sliced = "-"
        if route == "sm90":
            src = torch.randn((n, h, w, cin + 32), generator=g, device=dev
                              ).to(torch.bfloat16) * 100
            src[..., :cin] = x
            buf = torch.full((n, h, w, cout + 24), sentinel,
                             dtype=torch.bfloat16, device=dev)
            view = conv3x3_fused(src[..., :cin], *args, out=buf, out_off=8)
            torch.cuda.synchronize()
            same = torch.equal(view, got)
            untouched = bool((buf[..., :8] == sentinel).all()
                             and (buf[..., 8 + cout:] == sentinel).all())
            sliced = f"equal={same},sentinel_untouched={untouched}"
            ok = ok and same and untouched
            del src, buf, view
        shape = f"{n}x{h}x{w}x{cin}"
        say("K4_sm90", shape=shape, cout=cout, act=act_name, kernel=route,
            max_abs_err=worst, frac_differ=f"{differ:.3e}",
            bound="atol=2**-10,rtol=2**-7", sliced=sliced, ok=ok)
        if not ok:
            raise SystemExit(f"K4 disagrees with its plain version at {shape}->{cout}")
        errs["K4"] = max(errs.get("K4", 0.0), worst)
        del got, want
        w_cl, b16 = conv_weight_cl(wmat), bias.to(torch.bfloat16)
        ms = cuda_ms(lambda: conv3x3_fused(x, *args), 5)
        plain_ms = cuda_ms(lambda: conv3x3_fused_plain(x, *args), 2)
        lib_ms = cuda_ms(lambda: cudnn_conv(x, w_cl, b16), 5)
        nbytes, flop = conv_work(n, h, w, cin, cout)
        bound = roofline(nbytes, {"bf16": flop})
        say("K4_time", shape=shape, cout=cout, kernel=route, ms=f"{ms:.3f}",
            plain_ms=f"{plain_ms:.3f}", cudnn_ms=f"{lib_ms:.3f}",
            bound_ms=f"{bound[0]:.3f}", bound_by=bound[1],
            tflops=f"{flop / ms / 1e9:.1f}",
            share_of_bound=f"{bound[0] / ms:.3f}")
        if (cin, cout) in K4_DENSE and (h, w) == (H, W):
            dense[cin] = (x, args, ms, nbytes, flop)
        else:
            del x
        torch.cuda.empty_cache()

    # the A/B: each dense shape, then one dense block (five convs) on the
    # sm90 kernel over one 192-channel buffer (the ESRGAN path), on the
    # WMMA kernel over contiguous sources (PR 4's path after torch.cat)
    # and on cuDNN (bf16 conv with bias, channels-last, no activation)
    def ab(what, fns, nbytes, flop):
        bound = roofline(nbytes, {"bf16": flop})
        out = {}
        for impl, fn in fns.items():
            out[impl] = cuda_ms(fn, 5)
        for impl, ms in out.items():
            say("K4_ab", what=what, impl=impl, ms=f"{ms:.4f}",
                tflops=f"{flop / ms / 1e9:.1f}", bound_ms=f"{bound[0]:.4f}",
                bound_by=bound[1], share_of_bound=f"{bound[0] / ms:.3f}",
                vs_sm90=f"{ms / out['sm90']:.3f}")
        return out, bound

    parts = []
    for cin, cout in K4_DENSE:
        x, args, _, nbytes, flop = dense[cin]
        y = torch.empty((1, H, W, cout), dtype=torch.bfloat16, device=dev)
        w_cl, b16 = conv_weight_cl(args[0]), args[1].to(torch.bfloat16)
        ab(f"{cin}->{cout} 1x{H}x{W}", {
            "sm90": lambda: conv3x3_fused(x, *args),
            "wmma": lambda: wmma_conv(x, y, *args),
            "cudnn": lambda: cudnn_conv(x, w_cl, b16)}, nbytes, flop)
        parts.append((x, y, args, w_cl, b16))
    buf = torch.randn((1, H, W, K4_DENSE[-1][0]), device=dev).to(torch.bfloat16)

    def block(conv):
        """The five convs on ``buf`` as the dense-buffer forward runs them."""
        for cin, cout in K4_DENSE[:-1]:
            conv(buf[..., :cin], *dense[cin][1], out=buf, out_off=cin)
        return conv(buf, *dense[K4_DENSE[-1][0]][1])

    # each conv of the block against its plain version on the channels it
    # read (later convs write only behind them)
    last = block(conv3x3_fused)
    torch.cuda.synchronize()
    for cin, cout in K4_DENSE:
        got = last if cin == K4_DENSE[-1][0] else buf[..., cin:cin + cout]
        want = conv3x3_fused_plain(buf[..., :cin], *dense[cin][1])
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        say("K4_sm90", shape=f"1x{H}x{W}x{cin}", cout=cout, buffer="shared 192",
            max_abs_err=worst, frac_differ=f"{differ:.3e}",
            bound="atol=2**-10,rtol=2**-7", ok=ok)
        if not ok:
            raise SystemExit(f"K4 disagrees with its plain version on the "
                             f"shared dense-block buffer at {cin}->{cout}")
        errs["K4"] = max(errs["K4"], worst)
        del got, want
    nbytes = sum(dense[cin][3] for cin, _ in K4_DENSE)
    flop = sum(dense[cin][4] for cin, _ in K4_DENSE)
    times, bound = ab("dense block 1x1080p", {
        "sm90": lambda: block(conv3x3_fused),
        "wmma": lambda: [wmma_conv(p[0], p[1], *p[2]) for p in parts],
        "cudnn": lambda: [cudnn_conv(p[0], p[3], p[4]) for p in parts]},
        nbytes, flop)
    plain_ms = cuda_ms(lambda: block(conv3x3_fused_plain), 2)
    say("K4_time", shape=f"1x{H}x{W}", convs="64,96,128,160->32;192->64",
        ms=f"{times['sm90']:.3f}", wmma_ms=f"{times['wmma']:.3f}",
        plain_ms=f"{plain_ms:.3f}", cudnn_ms=f"{times['cudnn']:.3f}",
        bound_ms=f"{bound[0]:.3f}", bound_by=bound[1],
        tflops=f"{flop / times['sm90'] / 1e9:.1f}",
        per="one ESRGAN dense block's five convs on one 192-channel buffer, 1080p")
    del parts, dense, buf, last
    torch.cuda.empty_cache()
    return {"ms": times["sm90"], "ms_wmma": times["wmma"], "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": times["cudnn"]}


def k5_sm90_phases(dev, errs, veng, blk, wts, rng) -> dict:
    """[K5_sm90], [K5_time] and [K5_ab]: K5's Hopper kernel (what the
    path runs) against its plain version at ``K5_SM90_SHAPES``, each call
    counted on ``launches_sm90``; then at ``TILES`` the Hopper kernel and
    the plain version timed, one run each, beside two yardsticks that
    skip K5's per-source rounding and its adds: the block's five convs
    (leaky on c1..c4) on K4's sm90 kernel over one 192-channel buffer with
    the 1x1 skip as one matmul, and on cuDNN (bf16, channels-last, a conv per
    layer, no activation); fails if the kernel reaches less than
    ``K5_MIN_BOUND_SHARE`` of its bound.  Returns the kernels line's K5
    figures."""
    import torch

    from upscale_video_tpu_torch.ops.common import ACT_LEAKY, ACT_NONE
    from upscale_video_tpu_torch.ops.conv3x3 import conv3x3_fused
    from upscale_video_tpu_torch.ops.rdb import (
        CINS, MACS_PER_PIXEL, rdb_block, rdb_block_plain,
    )

    for shape in K5_SM90_SHAPES:
        x = torch.from_numpy(rng.normal(0, 0.5, shape + (64,)).astype(
            np.float32)).to(dev, torch.bfloat16)
        sm90 = rdb_block.launches_sm90
        got = rdb_block(x, wts)
        torch.cuda.synchronize()
        on_sm90 = rdb_block.launches_sm90 - sm90 == 1
        want = rdb_block_plain(x, wts)
        worst, differ, ok = compare(got, want, K5_ATOL, K5_RTOL)
        finite = bool(torch.isfinite(got.float()).all())
        ok = ok and finite and on_sm90
        say("K5_sm90", shape="x".join(map(str, shape)) + "x64",
            max_abs_err=worst, frac_differ=f"{differ:.3e}", finite=finite,
            on_sm90=on_sm90, bound="atol=2**-6,rtol=2**-7", ok=ok)
        if not ok:
            raise SystemExit(f"K5's sm90 kernel disagrees with its plain "
                             f"version at {shape}")
        errs["K5"] = max(errs.get("K5", 0.0), worst)
        if shape == TILES:
            k5_x = x
        del got, want

    pix = int(np.prod(TILES))
    flop = 2 * MACS_PER_PIXEL * pix
    bound = roofline(2 * k5_x.numel() * 2 + wts.wpack.numel() * 2
                     + wts.bpack.numel() * 4, {"bf16": flop})
    # the yardsticks' weights: the same block's convs and skip
    state = veng.sr_model.state
    convs = [state[c] for c in blk["convs"]]
    skip = state[blk["skip_conv"]]
    buf = torch.zeros(TILES + (CINS[-1],), dtype=torch.bfloat16, device=dev)
    buf[..., :64] = k5_x
    c5 = torch.empty(TILES + (64,), dtype=torch.bfloat16, device=dev)
    skw = skip.wmat.reshape(64, 32).to(torch.bfloat16)

    def k4_block():
        for t in range(4):
            conv3x3_fused(buf[..., :CINS[t]], convs[t].wmat, convs[t].bias,
                          blk["slope"], ACT_LEAKY, out=buf, out_off=CINS[t])
        torch.matmul(buf[..., :64], skw)
        return conv3x3_fused(buf, convs[4].wmat, convs[4].bias, None, ACT_NONE,
                             out=c5)

    xs = [torch.randn(TILES + (CINS[t],), device=dev).to(torch.bfloat16)
          for t in range(5)]
    cl = [(conv_weight_cl(c.wmat), c.bias.to(torch.bfloat16)) for c in convs]
    sk_cl = skip.wmat.reshape(64, 32).T.reshape(32, 64, 1, 1).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def cudnn_block():
        import torch.nn.functional as F

        for t in range(5):
            cudnn_conv(xs[t], *cl[t])
        return F.conv2d(xs[0].permute(0, 3, 1, 2), sk_cl)

    times = {}
    for impl, fn, reps in (("sm90", lambda: rdb_block(k5_x, wts), 10),
                           ("plain", lambda: rdb_block_plain(k5_x, wts), 2),
                           ("k4_sm90", k4_block, 5),
                           ("cudnn", cudnn_block, 5)):
        times[impl] = ms = cuda_ms(fn, reps)
        say("K5_ab", impl=impl, shape="x".join(map(str, TILES)) + "x64",
            ms=f"{ms:.4f}", tflops=f"{flop / ms / 1e9:.1f}",
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
            share_of_bound=f"{bound[0] / ms:.3f}",
            yardstick=impl in ("k4_sm90", "cudnn"))
    share = bound[0] / times["sm90"]
    say("K5_time", ms=f"{times['sm90']:.3f}", plain_ms=f"{times['plain']:.3f}",
        k4_sm90_ms=f"{times['k4_sm90']:.3f}", cudnn_ms=f"{times['cudnn']:.3f}",
        bound_ms=f"{bound[0]:.3f}", bound_by=bound[1],
        share_of_bound=f"{share:.3f}", min_share=K5_MIN_BOUND_SHARE,
        ms_per_frame=f"{times['sm90'] * VALAR_BLOCKS:.1f}",
        tflops=f"{flop / times['sm90'] / 1e9:.1f}",
        per="one dense block over 8x576x512x64 (the tiles of a 1080p frame)",
        ok=share >= K5_MIN_BOUND_SHARE)
    if share < K5_MIN_BOUND_SHARE:
        raise SystemExit(f"K5's sm90 kernel reached {share:.3f} of its bound, "
                         f"under {K5_MIN_BOUND_SHARE}")
    del k5_x, buf, c5, xs
    return {"ms": times["sm90"], "plain_ms": times["plain"],
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "k4_sm90_ms": times["k4_sm90"], "cudnn_convs_ms": times["cudnn"]}


def wmma_conv(x, y, wmat, bias, slope, act) -> None:
    """One conv on K4's WMMA kernel, called directly (the port sends every
    dense conv to the sm90 kernel): the yardstick the sm90 kernel is timed
    against."""
    import torch

    from upscale_video_tpu_torch.kernels import build
    from upscale_video_tpu_torch.ops.common import ACT_LEAKY, ACT_PRELU

    n, h, w, cin = x.shape
    code = build.library().uvt_conv3x3_fused(
        x.data_ptr(), y.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
        slope.data_ptr() if act == ACT_PRELU else None,
        float(slope) if act == ACT_LEAKY else 0.0, n, h, w, cin, wmat.shape[1],
        act, 0, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "conv3x3_fused WMMA launch")


def wmma_layer(src, dst, layer) -> None:
    """One layer on K1's WMMA kernel, called directly (the port sends every
    64->64 layer to the sm90 kernel): the yardstick the sm90 kernel is
    timed against."""
    import torch

    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, _ = src.shape
    code = build.library().uvt_conv3x3_chain_layer(
        src.data_ptr(), dst.data_ptr(), layer.wmat.data_ptr(),
        layer.bias.data_ptr(), layer.slope.data_ptr(), n, hp - 2, wp - 2,
        layer.cin, layer.cout, layer.act,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check(code, "conv3x3_chain WMMA layer launch")


def wino_wmma_layer(src, dst, layer) -> None:
    """One layer on K7's WMMA kernel, called directly (the port sends every
    64->64 layer to the sm90 kernel): the yardstick the sm90 kernel is
    timed against."""
    import torch

    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, _ = src.shape
    code = build.library().uvt_conv_winograd_layer(
        src.data_ptr(), dst.data_ptr(), layer.umat.data_ptr(),
        layer.bias.data_ptr(), layer.slope.data_ptr(), n, hp - 2, wp - 2,
        layer.cin, layer.cout, layer.act,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check(code, "conv_winograd WMMA layer launch")


def k7_sm90_phases(dev, errs) -> dict:
    """[K7_sm90] and [K7_ab]: one 64->64 layer per activation on K7's sm90
    kernel against its plain version at 4x1080p (PReLU) and four ragged
    shapes (odd H, W no multiple of the 64-wide tile, a frame smaller than
    a tile), finite, ring checked; then one PReLU layer at 4x1080p timed
    on the sm90 kernel, K7's WMMA kernel (called directly), K1's sm90
    layer and cuDNN, in two rounds (the second in reverse order).  Returns
    each one's ms."""
    import torch

    from upscale_video_tpu_torch.ops.common import (
        ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
    )
    from upscale_video_tpu_torch.ops.conv_chain import (
        embed, launch_chain_layer, make_layer,
    )
    from upscale_video_tpu_torch.ops.conv_winograd import (
        launch_wino_layer, make_wino_layer, sm90_takes, winograd_chain,
        winograd_chain_plain,
    )

    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    c = BODY_C
    if not sm90_takes(c, c):
        raise SystemExit("K7's 64->64 layer is not routed to the sm90 kernel")

    def layer(act, cin=c, cout=c):
        slope = (rng.uniform(0.1, 0.3, (cout,)).astype(np.float32)
                 if act == ACT_PRELU else 0.2 if act == ACT_LEAKY else None)
        return make_wino_layer(
            rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
            rng.normal(0, 0.05, (cout,)).astype(np.float32), slope, act,
            device=dev)

    cases = [((N, H, W), ACT_PRELU)] + [
        (shape, act) for shape in ((1, 5, 7), (2, 37, 53), (1, 61, 70),
                                   (4, 64, 128))
        for act in (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU)]
    for shape, act in cases:
        x = torch.randn((*shape, c), generator=gen, device=dev).to(torch.bfloat16)
        src = embed(x)
        lay = layer(act)
        want = winograd_chain_plain(x, [lay], crop=False)
        ring = torch.ones(src.shape[1:3], dtype=torch.bool, device=dev)
        ring[1:-1, 1:-1] = False
        dst = torch.zeros_like(src)
        sm90 = winograd_chain.launches_sm90
        launch_wino_layer(src, dst, lay)
        torch.cuda.synchronize()
        worst, differ, ok = compare(dst, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        finite = bool(torch.isfinite(dst.float()).all())
        ring_zero = int(torch.count_nonzero(dst[:, ring])) == 0
        on_sm90 = winograd_chain.launches_sm90 - sm90 == 1
        ok = ok and finite and ring_zero and on_sm90
        say("K7_sm90", shape="x".join(map(str, shape)), act=act,
            max_abs_err=worst, frac_differ=f"{differ:.3e}",
            bound=f"atol={K1_LAYER_ATOL},rtol={K1_LAYER_RTOL}",
            finite=finite, ring_zero=ring_zero, on_sm90=on_sm90, ok=ok)
        if not on_sm90:
            raise SystemExit("a 64->64 K7 layer missed the sm90 kernel")
        if not ok:
            raise SystemExit(f"K7's sm90 layer disagrees with its plain "
                             f"version at {shape}, act {act}")
        errs["K7"] = max(errs.get("K7", 0.0), worst)
        del x, src, dst, want

    # the A/B at 4x1080p.  Bound: the bordered buffers read and written
    # once with U and the bias (bytes) against 2*6*c*c operations per
    # pixel; K1's layer and cuDNN do 2*9*c*c
    x = torch.randn((N, H, W, c), generator=gen, device=dev).to(torch.bfloat16)
    src = embed(x)
    dst = torch.zeros_like(src)
    lay = layer(ACT_PRELU)
    k1 = make_layer(rng.normal(0, 0.15, (3, 3, c, c)).astype(np.float32),
                    lay.bias.cpu(), lay.slope.cpu(), ACT_PRELU, device=dev)
    w_cl = conv_weight_cl(k1.wmat)
    b16 = lay.bias.to(torch.bfloat16)
    border = N * (H + 2) * (W + 2)
    nbytes = 2 * border * c * 2 + lay.umat.numel() * 2 + 2 * c * 4
    flop = 2 * 6 * c * c * N * H * W
    bound = roofline(nbytes, {"bf16": flop})
    fns = {"sm90": lambda: launch_wino_layer(src, dst, lay),
           "wmma": lambda: wino_wmma_layer(src, dst, lay),
           "k1_sm90": lambda: launch_chain_layer(src, dst, k1),
           "cudnn": lambda: cudnn_conv(x, w_cl, b16)}
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(cuda_ms(fns[name], 3 if name == "wmma" else 10))
    out = {name: sum(t) / len(t) for name, t in times.items()}
    smi = smi_line()
    for name, ms in out.items():
        say("K7_ab", impl=name, shape=f"{N}x{H}x{W}", layer=f"{c}->{c} prelu",
            ms=f"{ms:.4f}", rounds=" ".join(f"{t:.4f}" for t in times[name]),
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
            share_of_bound=f"{bound[0] / ms:.3f}",
            vs_cudnn=f"{ms / out['cudnn']:.3f}", card=repr(smi))
    return out


def mma_q8_layer(src, dst, layer) -> None:
    """One layer on K8's mma.sync kernel, called directly (the port sends
    every 64->64 layer to the sm90 kernel): the yardstick the sm90 kernel
    is timed against."""
    import torch

    from upscale_video_tpu_torch.kernels import build

    n, hp, wp, _ = src.shape
    code = build.library().uvt_conv3x3_chain_q8_layer(
        src.data_ptr(), dst.data_ptr(), layer.wmat.data_ptr(),
        layer.scale.data_ptr(), layer.bias.data_ptr(), layer.slope.data_ptr(),
        layer.inv_out, n, hp - 2, wp - 2, layer.cin, layer.cout, layer.act,
        int(dst.dtype == torch.int8),
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check(code, "conv3x3_chain_q8 mma.sync layer launch")


def k8_sm90_phases(dev, errs) -> dict:
    """[K8_sm90] and [K8_ab]: one 64->64 layer on K8's sm90 kernel, int8
    (requantised) and bf16 out, against its plain step bit for bit, at
    4x1080p (PReLU) and at ``K8_RAGGED`` for each activation, ring and
    route checked; then one PReLU int8 -> int8 layer at 4x1080p timed on
    the sm90 kernel and the mma.sync kernel (called directly), and the
    bf16-out layer on sm90, in two rounds (the second in reverse order),
    each with its share of the per-layer bound.  Returns each one's ms and
    the int8 layer's bound."""
    import torch

    from upscale_video_tpu_torch.ops.common import (
        ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
    )
    from upscale_video_tpu_torch.ops.conv_chain import embed
    from upscale_video_tpu_torch.ops.conv_chain_q8 import (
        conv3x3_chain_q8, launch_q8_layer, make_q8_layer, q8_layer_plain,
        sm90_takes,
    )

    rng = np.random.default_rng(19)
    gen = torch.Generator(device=dev).manual_seed(19)
    c = BODY_C
    if not sm90_takes(c, c):
        raise SystemExit("K8's 64->64 layer is not routed to the sm90 kernel")

    def layer(act):
        # dequant scales that keep most requantised values inside +-127,
        # so the rounding, not the clip, decides them
        return make_q8_layer(
            rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8),
            rng.uniform(2e-6, 6e-6, (c,)).astype(np.float32),
            rng.normal(0, 0.05, (c,)).astype(np.float32),
            rng.uniform(0.1, 0.3, (c,)).astype(np.float32),
            np.float32(rng.uniform(80.0, 130.0)), act, device=dev)

    outs = (torch.int8, torch.bfloat16)
    cases = [((N, H, W), ACT_PRELU, dt) for dt in outs] + [
        (shape, act, dt) for shape in K8_RAGGED
        for act in (ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU) for dt in outs]
    for shape, act, dt in cases:
        x8 = torch.randint(-127, 128, (*shape, c), generator=gen, device=dev,
                           dtype=torch.int8)
        src = embed(x8, torch.int8)
        lay = layer(act)
        dst = torch.zeros(src.shape, dtype=dt, device=dev)
        sm90 = conv3x3_chain_q8.launches_sm90
        launch_q8_layer(src, dst, lay)
        torch.cuda.synchronize()
        want = q8_layer_plain(src, lay, dt)
        worst, differ, _ = compare(dst, want, 0.0, 0.0)
        ring = torch.ones(src.shape[1:3], dtype=torch.bool, device=dev)
        ring[1:-1, 1:-1] = False
        ring_zero = int(torch.count_nonzero(dst[:, ring])) == 0
        on_sm90 = conv3x3_chain_q8.launches_sm90 - sm90 == 1
        clipped = (want.abs() == 127).float().mean().item() if dt == torch.int8 else 0.0
        ok = differ == 0 and ring_zero and on_sm90
        say("K8_sm90", shape="x".join(map(str, shape)), act=act,
            out=str(dt).replace("torch.", ""), max_abs_err=worst,
            differ=int(round(differ * dst.numel())), bound="bit-equal",
            frac_clipped=f"{clipped:.3f}", ring_zero=ring_zero,
            on_sm90=on_sm90, ok=ok)
        if not on_sm90:
            raise SystemExit("a 64->64 K8 layer missed the sm90 kernel")
        if not ok:
            raise SystemExit(f"K8's sm90 layer disagrees with its plain "
                             f"version at {shape}, act {act}, {dt}")
        errs["K8"] = max(errs.get("K8", 0.0), worst)
        del x8, src, dst, want

    # the A/B at 4x1080p.  Bound: the bordered buffers read and written
    # once with the weights and the per-channel fields (bytes) against
    # 2*9*c*c int8 operations per pixel
    x8 = torch.randint(-127, 128, (N, H, W, c), generator=gen, device=dev,
                       dtype=torch.int8)
    src = embed(x8, torch.int8)
    d8 = torch.zeros_like(src)
    db = torch.zeros(src.shape, dtype=torch.bfloat16, device=dev)
    lay = layer(ACT_PRELU)
    border = N * (H + 2) * (W + 2)
    wbytes = 9 * c * c + 3 * c * 4
    ops = {"int8": 2 * 9 * c * c * N * H * W}
    bounds = {"sm90": roofline(2 * border * c + wbytes, ops),
              "mma_sync": roofline(2 * border * c + wbytes, ops),
              "sm90_bf16_out": roofline(3 * border * c + wbytes, ops)}
    fns = {"sm90": lambda: launch_q8_layer(src, d8, lay),
           "mma_sync": lambda: mma_q8_layer(src, d8, lay),
           "sm90_bf16_out": lambda: launch_q8_layer(src, db, lay)}
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(cuda_ms(fns[name], 3 if name == "mma_sync" else 20))
    out = {name: sum(t) / len(t) for name, t in times.items()}
    smi = smi_line()
    for name, ms in out.items():
        bound = bounds[name]
        say("K8_ab", impl=name, shape=f"{N}x{H}x{W}",
            layer=f"{c}->{c} prelu int8->{'bf16' if name.endswith('bf16_out') else 'int8'}",
            ms=f"{ms:.4f}", rounds=" ".join(f"{t:.4f}" for t in times[name]),
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
            share_of_bound=f"{bound[0] / ms:.3f}",
            vs_mma_sync=f"{ms / out['mma_sync']:.3f}", card=repr(smi))
    if out["sm90"] >= out["mma_sync"]:
        raise SystemExit("K8's sm90 layer is no faster than its mma.sync layer")
    out["bound_ms"], out["bound_by"] = bounds["sm90"]
    out["bf16_out_bound_ms"] = bounds["sm90_bf16_out"][0]
    return out


def conv_body_phases(dev, errs) -> dict:
    """[K7], [K8] and [conv_body_ab]: K7 and K8 against their plain
    versions, then the conv body's A/B at 4x1080p.  Returns the ``ms``,
    ``plain_ms``, ``bound_ms`` and ``bound_by`` of K7's and K8's rows and
    cuDNN's ``ms``; records their worst errors in ``errs``."""
    import torch

    from upscale_video_tpu_torch.ops.common import ACT_PRELU
    from upscale_video_tpu_torch.ops.conv_chain import (
        conv3x3_chain, embed, make_layer, run_bordered,
    )
    from upscale_video_tpu_torch.ops.conv_chain_q8 import (
        conv3x3_chain_q8, conv3x3_chain_q8_plain, make_q8_layer,
        sm90_takes as q8_sm90_takes,
    )
    from upscale_video_tpu_torch.ops.conv_winograd import (
        make_wino_layer, sm90_takes, winograd_chain, winograd_chain_plain,
    )
    from upscale_video_tpu_torch.tools.q8_bench import make_q8_body
    from upscale_video_tpu_torch.tools.wino_bench import make_layers

    gen = torch.Generator(device=dev).manual_seed(5)
    c = BODY_C
    spec = make_layers(np.random.default_rng(0), BODY_LAYERS, c)
    k7 = [make_wino_layer(l["weight"], l["bias"], l["slope"], l["act"],
                          device=dev) for l in spec]
    k1 = [make_layer(l["weight"], l["bias"], l["slope"], l["act"], device=dev)
          for l in spec]
    rng = np.random.default_rng(5)

    def ragged(cin, cout):
        return make_wino_layer(
            rng.normal(0, 0.15, (3, 3, cin, cout)).astype(np.float32),
            rng.normal(0, 0.05, (cout,)).astype(np.float32),
            rng.uniform(0.1, 0.3, (cout,)).astype(np.float32), ACT_PRELU,
            device=dev)

    # K7 vs its plain version: the body at 4x1080p on uniform(0, 1)
    # frames, a ragged 3->64->64 stack (its head on the WMMA kernel, its
    # 64->64 layer on sm90), and the body's first layer alone on unit-scale
    # inputs; each on the bordered output, whose ring must stay zero
    x = torch.rand((N, H, W, c), generator=gen, device=dev).to(torch.bfloat16)
    small = torch.rand((2, 37, 53, 3), generator=gen, device=dev).to(torch.bfloat16)
    unit = torch.randn((N, H, W, c), generator=gen, device=dev).to(torch.bfloat16)
    rl = [ragged(ci, co) for ci, co in ((3, 64), (64, 64))]
    for what, xin, layers, atol, rtol in (
            ("body", x, k7, K1_ATOL, K1_RTOL),
            ("ragged", small, rl, K1_ATOL, K1_RTOL),
            ("layer0", unit, k7[:1], K1_LAYER_ATOL, K1_LAYER_RTOL)):
        before = (winograd_chain.launches, winograd_chain.launches_sm90)
        got = winograd_chain(xin, layers, crop=False)
        want = winograd_chain_plain(xin, layers, crop=False)
        torch.cuda.synchronize()
        worst, differ, ok = compare(got, want, atol, rtol)
        launches = winograd_chain.launches - before[0]
        launches_sm90 = winograd_chain.launches_sm90 - before[1]
        ring = torch.ones(got.shape[1:3], dtype=torch.bool, device=dev)
        ring[1:-1, 1:-1] = False
        ring_zero = int(torch.count_nonzero(got[:, ring])) == 0
        ok = (ok and ring_zero and launches == len(layers)
              and launches_sm90 == sum(sm90_takes(l.cin, l.cout) for l in layers))
        say("K7", case=what, shape="x".join(map(str, xin.shape)),
            layers=len(layers), launches=launches, launches_sm90=launches_sm90,
            ring_zero=ring_zero, max_abs_err=worst,
            mean_abs_want=want.float().abs().mean().item(),
            frac_differ=f"{differ:.3e}", bound=f"atol={atol},rtol={rtol}",
            ok=ok)
        if not ok:
            raise SystemExit(f"K7 disagrees with its plain version ({what})")
        errs["K7"] = max(errs.get("K7", 0.0), worst)
        del got, want
    del unit

    # K8 vs its plain version, bit for bit: q8_bench's body on one 1080p
    # frame (the f64 plain conv is slow) and a ragged 3->64->64 stack
    q8, _, x8_1 = make_q8_body(np.random.default_rng(0), BODY_LAYERS, c, H, W)
    k8 = [make_q8_layer(l["wq"], l["scale"], l["bias"], l["slope"],
                        l["inv_out"], l["act"], device=dev) for l in q8]
    x8_1 = torch.from_numpy(x8_1)[None].to(dev)
    r8 = [make_q8_layer(rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8),
                        rng.uniform(1e-4, 3e-4, (co,)).astype(np.float32),
                        rng.normal(0, 0.05, (co,)).astype(np.float32),
                        rng.uniform(0.1, 0.3, (co,)).astype(np.float32),
                        np.float32(rng.uniform(80.0, 130.0)), ACT_PRELU,
                        device=dev) for ci, co in ((3, 64), (64, 64))]
    s8 = torch.randint(-127, 128, (2, 37, 53, 3), generator=gen, device=dev,
                       dtype=torch.int8)
    for what, xin, layers in (("body", x8_1, k8), ("ragged", s8, r8)):
        before = (conv3x3_chain_q8.launches, conv3x3_chain_q8.launches_sm90)
        got = conv3x3_chain_q8(xin, layers)
        want = conv3x3_chain_q8_plain(xin, layers)
        torch.cuda.synchronize()
        worst, differ, _ = compare(got, want, 0.0, 0.0)
        launches = conv3x3_chain_q8.launches - before[0]
        launches_sm90 = conv3x3_chain_q8.launches_sm90 - before[1]
        ok = (differ == 0 and bool(torch.isfinite(got.float()).all())
              and launches == len(layers)
              and launches_sm90 == sum(q8_sm90_takes(l.cin, l.cout) for l in layers))
        say("K8", case=what, shape="x".join(map(str, xin.shape)),
            layers=len(layers), launches=launches, launches_sm90=launches_sm90,
            max_abs_err=worst, mean_abs_want=want.float().abs().mean().item(),
            differ=int(round(differ * got.numel())), bound="bit-equal", ok=ok)
        if not ok:
            raise SystemExit(f"K8 disagrees with its plain version ({what})")
        errs["K8"] = max(errs.get("K8", 0.0), worst)
        del got, want
    del x8_1

    # the body's A/B at 4x1080p.  Bounds: K1 and cuDNN do 2*9*c*c
    # operations per pixel and layer at the bf16 peak, K7 2*6*c*c, K8
    # 2*9*c*c at the int8 peak; bytes are the body's input read and output
    # written once with the weights.  The per-layer HBM floor instead
    # counts every layer's bordered buffers, read and written once.
    x8 = torch.randint(-127, 128, (N, H, W, c), generator=gen, device=dev,
                       dtype=torch.int8)
    pix = N * H * W
    border = N * (H + 2) * (W + 2)
    macs = BODY_LAYERS * 9 * c * c
    wbytes_bf16 = BODY_LAYERS * (9 * c * c * 2 + 2 * c * 4)
    wbytes_q8 = BODY_LAYERS * (9 * c * c + 3 * c * 4 + 4)
    io_bf16 = pix * c * 2 * 2
    io_q8 = pix * c * (1 + 2)
    floor_bf16 = 1e3 * BODY_LAYERS * border * 2 * c * 2 / PEAK_HBM
    floor_q8 = 1e3 * border * c * ((BODY_LAYERS - 1) * 2 + 1 + 2) / PEAK_HBM
    impls = {
        "K1": (lambda: conv3x3_chain(x, k1), None,
               roofline(io_bf16 + wbytes_bf16, {"bf16": 2 * macs * pix}),
               floor_bf16),
        "K7": (lambda: winograd_chain(x, k7),
               lambda: winograd_chain_plain(x, k7),
               roofline(io_bf16 + wbytes_bf16,
                        {"bf16": 2 * BODY_LAYERS * 6 * c * c * pix}),
               floor_bf16),
        # the same body with every layer on K7's WMMA kernel, embed and
        # crop included as winograd_chain does them
        "K7_wmma": (lambda: run_bordered(embed(x), k7, wino_wmma_layer)
                    [:, 1:H + 1, 1:W + 1, :].contiguous(), None,
                    roofline(io_bf16 + wbytes_bf16,
                             {"bf16": 2 * BODY_LAYERS * 6 * c * c * pix}),
                    floor_bf16),
        "K8": (lambda: conv3x3_chain_q8(x8, k8),
               lambda: conv3x3_chain_q8_plain(x8, k8),
               roofline(io_q8 + wbytes_q8, {"int8": 2 * macs * pix}),
               floor_q8),
        "cudnn": (lambda: cudnn_stack(x, k1), None,
                  roofline(io_bf16 + wbytes_bf16, {"bf16": 2 * macs * pix}),
                  floor_bf16),
    }
    out = {}
    for name, (fn, plain, bound, floor) in impls.items():
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 2) if plain else None
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "hbm_floor_ms": floor}
        say("conv_body_ab", impl=name, shape=f"{N}x{H}x{W}x{c}",
            layers=BODY_LAYERS, ms=f"{ms:.3f}",
            plain_ms="-" if plain_ms is None else f"{plain_ms:.3f}",
            bound_ms=f"{bound[0]:.3f}", bound_by=bound[1],
            hbm_floor_ms=f"{floor:.3f}",
            tflops_direct_equiv=f"{2 * macs * pix / ms / 1e9:.1f}",
            vs_k1=f"{ms / out['K1']['ms']:.3f}")
    return out


def run_bench(tool: str, kernel: str):
    """``python -m upscale_video_tpu_torch.tools.<tool>`` at its defaults in
    a subprocess: its lines passed on, its parity line held; returns the
    launches of ``kernel`` its ``[launches]`` line counted (from 0 in that
    process, before the parity check's own launch) and those its
    ``[launches_sm90]`` line gives to the sm90 kernel (None if it has
    none)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        f"upscale_video_tpu_torch.tools.{tool}"],
                       capture_output=True, text=True, cwd=root, env=env,
                       timeout=600)
    lines = r.stdout.splitlines()
    for line in lines:
        print(f"[{tool}] {line}", flush=True)
    def counts(tag):
        return dict(kv.split("=") for line in lines
                    if line.startswith(f"[{tag}] ") for kv in line.split()[1:])

    parity = [line for line in lines if line.startswith("[parity] ")]
    launched = int(counts("launches").get(kernel, 0))
    sm90 = counts("launches_sm90").get(kernel)
    sm90 = None if sm90 is None else int(sm90)
    ok = (r.returncode == 0 and launched > 0 and len(parity) == 1
          and parity[0].endswith("ok=True"))
    say(tool, rc=r.returncode, launches=launched, launches_sm90=sm90,
        seconds=f"{time.perf_counter() - t0:.1f}", ok=ok)
    if not ok:
        raise SystemExit(f"{tool} failed:\n{r.stderr[-4000:]}")
    return launched, sm90


def cudnn_stack(x, layers):
    """The library yardstick for K1: each layer one cuDNN bf16 conv
    (``F.conv2d`` with bias, channels-last), no activation."""
    import torch
    import torch.nn.functional as F

    from upscale_video_tpu_torch.ops.conv_chain import oihw

    y = x.permute(0, 3, 1, 2)
    for l in layers:
        w = oihw(l.wmat).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        y = F.conv2d(y, w, l.bias.to(torch.bfloat16), padding=1)
    return y


def conv_weight_cl(wmat):
    """A ``(9*cin, cout)`` weight matrix as cuDNN's bf16 OIHW weight,
    channels-last."""
    import torch

    from upscale_video_tpu_torch.ops.conv_chain import oihw

    return oihw(wmat).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)


def cudnn_conv(x, w_cl, bias):
    """The library yardstick for K4: one cuDNN bf16 SAME conv with bias
    (``F.conv2d``, channels-last), no activation, over NHWC ``x``."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w_cl, bias, padding=1)


def conv_work(n, h, w, cin, cout):
    """``(bytes, flop)`` of one SAME 3x3 conv in bf16: the input read and
    the output written once, the weights and bias read once."""
    return (n * h * w * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 4,
            2 * 9 * cin * cout * n * h * w)


def esrgan_k4(rrdbs: int) -> int:
    """K4 launches per frame of a basicsr RRDBNet: conv_first, five per
    dense block (three per RRDB), conv_body, conv_up1."""
    return 1 + 15 * rrdbs + 2


def _conv_param(rng, cout, cin):
    w = rng.normal(0, 0.6 / np.sqrt(9 * cin), (cout, cin, 3, 3))
    return w.astype(np.float32), (rng.normal(0, 0.06, cout)).astype(np.float32)


def esrgan_state_dict(seed: int, num_rrdb: int, nf: int = 64, gc: int = 32):
    """A basicsr RRDBNet state dict with RealESRGAN_x4plus's keys and
    shapes (nf 64, gc 32, 4x), weights N(0, 0.6/sqrt(fan_in)) and biases
    N(0, 0.06) from ``seed``, conv_last's bias centred on 0.5: image-like
    output (at 23 RRDBs about a fifth of the u8 values clip)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, cout, cin):
        sd[name + ".weight"], sd[name + ".bias"] = _conv_param(rng, cout, cin)

    put("conv_first", nf, 3)
    for i in range(num_rrdb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                put(f"body.{i}.rdb{j}.conv{k}", nf if k == 5 else gc,
                    nf + (k - 1) * gc)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        put(name, nf, nf)
    put("conv_last", 3, nf)
    sd["conv_last.bias"] += 0.5
    return sd


def srvgg_state_dict(seed: int, num_conv: int, nf: int, scale: int):
    """An SRVGGNetCompact state dict (``body.{2i}`` conv, ``body.{2i+1}``
    PReLU, num_conv + 1 pairs, then the tail conv) from ``seed``."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for i in range(num_conv + 1):
        sd[f"body.{2 * i}.weight"], sd[f"body.{2 * i}.bias"] = \
            _conv_param(rng, nf, cin)
        sd[f"body.{2 * i + 1}.weight"] = rng.uniform(0.05, 0.3, nf).astype(np.float32)
        cin = nf
    w, b = _conv_param(rng, 3 * scale * scale, nf)
    sd[f"body.{2 * num_conv + 2}.weight"] = w * 0.3
    sd[f"body.{2 * num_conv + 2}.bias"] = b
    return sd


K_GROUPS = {"k5": "rdb_block", "k4": "conv3x3_fused", "k1": "chain_layer",
            "cat": "CatArray"}


def profile_shares(fn, groups=K_GROUPS) -> dict:
    """One call of ``fn`` under torch.profiler: its device kernel time
    summed per group (a kernel joins the first group whose pattern its
    name holds; by default K5, K4, K1 and torch.cat) and for the rest
    (with the three largest of the rest), or ``device_ms="not measured"``
    where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    sums, rest, cats = dict.fromkeys(groups, 0.0), {}, set()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        group = next((g for g, pat in groups.items() if pat in e.key), None)
        if group:
            sums[group] += us
            if group == "cat":
                cats.add(e.key[:48])
        else:
            rest[e.key] = rest.get(e.key, 0.0) + us
    total = sum(sums.values()) + sum(rest.values())
    if total <= 0:
        return {"device_ms": "not measured"}
    out = {"device_ms": f"{total / 1e3:.2f}"}
    for g, us in list(sums.items()) + [("other", sum(rest.values()))]:
        out[f"{g}_ms"] = f"{us / 1e3:.2f}"
        out[f"{g}_share"] = f"{us / total:.3f}"
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:3]
    out["top_other"] = repr([(k[:48], round(us / 1e3, 2)) for k, us in top])
    out["cat_kernels"] = repr(sorted(cats))
    return out


def image_like(n, h, w, seed, device):
    """Model-domain f32 frames of a smooth gradient plus noise, on the
    card: NL-means finds similar patches, so its weights are far from 0."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    base = (0.5 + 0.3 * torch.sin(xx / 37.0 + yy / 53.0))[None, ..., None]
    noise = torch.randn((n, h, w, 3), generator=g, device=device) * 0.03
    return torch.clamp(base + noise, 0.0, 1.0).contiguous()


def write_frame(h, w, t, rng):
    """One small uint8 RGB frame like write_clip's: gradients plus noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 60 * np.sin(xx / (9 + t) + yy / 13)
    rgb = np.stack([base, base[::-1], 255 - base], -1)
    return np.clip(rgb + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


if __name__ == "__main__":
    raise SystemExit(main())
