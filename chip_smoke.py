"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``upscale_video_tpu_torch/csrc/`` with
nvcc, holds each against its plain PyTorch version on the card at its main
path's shapes, and drives the ported paths end to end through
``upscale-video-torch`` on hermetic 1080p Y4M clips under both device
contracts, counting kernel launches:

- the default path: 2x Compact (K1 + K2), 4 frames per step, 1080p -> 4K;
- ``-m r``: the 4x Valar RRDBNet at full width and depth (23 RRDBs, K5
  per dense block on its Hopper kernel ``csrc/rdb_block_sm90.cu``, K4 for
  conv_first, conv_trunk and conv_up1, one K1 chain for the last three
  convs), mixed precision, 544-budget tiles with halo 16, 1 frame per
  step, 1080p -> 4K;
- ``-m a,n=3``: NL-means at strength 3 (K6, one launch per step), the 1x
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
  launch per step.

- the conv-body research path: ``upscale_video_tpu_torch.tools.wino_bench``
  (cuDNN, K1, K7 row-Winograd) and ``tools.q8_bench`` (K8 int8, K1,
  cuDNN), each run at its defaults (16 x 64->64 PReLU convs on a 1080p
  frame) as a subprocess through ``python -m``; their ``[launches]`` lines
  give K7's and K8's launch counts, each counted from 0 in that process,
  and every 64->64 K7 launch of ``wino_bench`` must be on the sm90 kernel.

Weights are synthetic (seed 0).  K1 runs its 64->64 layers on the
persistent TMA + wgmma kernel (``csrc/conv3x3_chain_sm90.cu``) and every
other shape on the WMMA kernel: ``[K1_sm90]`` holds one sm90 layer per
activation against the plain version at 4x1080p and two ragged shapes
(ring checked), ``[K1_ab]`` times one 64->64 PReLU layer at 4x1080p on
the WMMA kernel (called directly), the sm90 kernel and cuDNN, and every CLI run
counts the sm90 launches (the default step's 16 body layers, two of the
last RRDBNet chain's three).  K4 runs every bf16 conv with cin a multiple
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
4x1080p, K6 at 4x1080p, and the whole 1080p ``-m r``, ESRGAN and ``--tta``
steps against the same steps on the plain versions; K7 over the benches'
16-layer body at 4x1080p, a ragged 3->64->64 stack (split 1 WMMA + 1
sm90 launch, ring checked) and one layer alone (K7 runs its 64->64 layers on the persistent TMA + wgmma kernel
``csrc/conv_winograd_sm90.cu`` and every other shape on the WMMA kernel:
``[K7_sm90]`` holds one sm90 layer per activation at 4x1080p and four
ragged shapes against the plain version (finite, ring checked),
``[K7_ab]`` times one 64->64 PReLU layer at 4x1080p on the sm90 kernel,
K7's WMMA kernel, K1's sm90 layer and cuDNN), K8
over the body at 1x1080p and the ragged stack (bit for bit), then the
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
LAST_CHAIN_SM90 = 2            # its 64->64 up2 and hr run on the sm90 kernel
COMPACT_BODY = 16              # the Compact stack's 64->64 layers: sm90
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
# version, and reciprocal scales; weights exp(-d/h^2) amplify d's ulps by
# d/h^2 (<= ~20 where a weight still counts), so a few f32 ulps of v
K6_ATOL, K6_RTOL = 1e-5, 1e-5
PRELUDE = "a,n=3"              # the pre-SR path: denoise at 3, anime deblur
ANIME_LAYERS = 10              # 3->24, 8 x 24->24 (PReLU), 24->3: one chain
TTA_MIN_PSNR = 45.0            # --tta step vs the same step on the plain versions
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense, at
# 700 W): HBM bytes/s and
# operations/s per type.  The SFU's exp rate is 16 per clock per SM
# against FP32's 256 flops, so a sixteenth of the FP32 peak.
PEAK_HBM = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "exp": 67e12 / 16}
# the conv-body benches' default body: 16 x 64->64 3x3 convs with PReLU
BODY_LAYERS, BODY_C = 16, 64
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
    from upscale_video_tpu_torch.ops.tail import (
        LAYOUTS, sr_tail_chain, sr_tail_chain_plain, sr_tail_fused,
        sr_tail_fused_plain,
    )

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
        per="17-layer stack, 4x1080p (16 layers on sm90, 1 on WMMA)")
    k1_layer_ms = k1_sm90_phases(dev, errs)

    # K2 against its plain version on the same bordered K1 output
    for layout in ("planar", "frames"):
        got = sr_tail_chain(main_buf, main_x, tail.wmat, tail.bias, 2, layout)
        want = sr_tail_chain_plain(main_buf, main_x, tail.wmat, tail.bias, 2,
                                   layout)
        torch.cuda.synchronize()
        d = (got.int() - want.int()).abs()
        worst = d.max().item()
        say("K2", layout=layout, shape=tuple(got.shape), max_abs_err=worst,
            frac_differ=f"{(d > 0).float().mean().item():.3e}",
            bound=K2_MAX_LSB, ok=worst <= K2_MAX_LSB)
        if worst > K2_MAX_LSB:
            raise SystemExit(f"K2 ({layout}) disagrees with its plain version")
        errs["K2"] = max(errs.get("K2", 0.0), float(worst))
        del got, want, d
    k2_ms = cuda_ms(lambda: sr_tail_chain(main_buf, main_x, tail.wmat,
                                          tail.bias, 2, "planar"), 10)
    k2_plain_ms = cuda_ms(lambda: sr_tail_chain_plain(
        main_buf, main_x, tail.wmat, tail.bias, 2, "planar"), 3)
    k2_bound = roofline(main_buf.numel() * 2 + main_x.numel() * 2
                        + tail.wmat.numel() * 2 + tail.bias.numel() * 4
                        + N * H * W * 12,
                        {"bf16": 2 * 9 * main_buf.shape[-1] * 12 * N * H * W})
    say("K2_time", ms=f"{k2_ms:.3f}", plain_ms=f"{k2_plain_ms:.3f}",
        bound_ms=f"{k2_bound[0]:.3f}", bound_by=k2_bound[1],
        per="one launch, 4x1080p -> planar u8")
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

    # K6 against its plain version: the main-path batch (4x1080p) and a
    # ragged one, at the path's strength 3 and at the strongest, 30
    from upscale_video_tpu_torch.ops.nlmeans import (
        FLOPS_PER_PAIR, nl_means_denoise, nl_means_denoise_plain,
    )

    for (n, h, w) in ((N, H, W), (2, 37, 53)):
        x = image_like(n, h, w, seed=n * h, device=dev)
        for strength in (3.0, 30.0):
            got = nl_means_denoise(x, strength)
            want = nl_means_denoise_plain(x, strength)
            torch.cuda.synchronize()
            worst, differ, ok = compare(got, want, K6_ATOL, K6_RTOL)
            ok = ok and bool(torch.isfinite(got).all())
            say("K6", shape=f"{n}x{h}x{w}x3", h=strength, max_abs_err=worst,
                frac_differ=f"{differ:.3e}",
                bound=f"atol={K6_ATOL},rtol={K6_RTOL}", ok=ok)
            if not ok:
                raise SystemExit(f"K6 disagrees with its plain version at "
                                 f"{n}x{h}x{w}, h={strength}")
            errs["K6"] = max(errs.get("K6", 0.0), worst)
            del got, want
        if (n, h, w) == (N, H, W):
            k6_x = x
    k6_ms = cuda_ms(lambda: nl_means_denoise(k6_x, 3.0), 10)
    k6_plain_ms = cuda_ms(lambda: nl_means_denoise_plain(k6_x, 3.0), 2)
    pairs = 81 * N * H * W
    k6_bound = roofline(2 * k6_x.numel() * 4,
                        {"f32": FLOPS_PER_PAIR * pairs, "exp": pairs})
    say("K6_time", ms=f"{k6_ms:.3f}", plain_ms=f"{k6_plain_ms:.3f}",
        bound_ms=f"{k6_bound[0]:.3f}", bound_by=k6_bound[1],
        gpairs_per_s=f"{pairs / k6_ms / 1e6:.1f}",
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
    got = conv3x3_chain(ax, alayers)
    want = conv3x3_chain_plain(ax, alayers)
    torch.cuda.synchronize()
    worst, differ, ok = compare(got, want, K1_ANIME_ATOL, K1_ANIME_RTOL)
    say("K1_anime", shape=f"{N}x{H}x{W}", layers=len(alayers),
        widths="3->24,8x24->24,24->3", max_abs_err=worst,
        mean_abs_want=want.float().abs().mean().item(),
        frac_differ=f"{differ:.3e}", bound="atol=2**-10,rtol=2**-7", ok=ok)
    if not ok:
        raise SystemExit("K1 disagrees with its plain version on the anime chain")
    errs["K1"] = max(errs["K1"], worst)
    del got, want
    # each anime layer alone at the same shape, unit-scale inputs
    for i, layer in enumerate(alayers):
        x = torch.randn((N, H, W, layer.cin), generator=torch.Generator(
            device=dev).manual_seed(i), device=dev).to(torch.bfloat16)
        got = conv3x3_chain(x, [layer])
        want = conv3x3_chain_plain(x, [layer])
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        say("K1_anime_layer", layer=i, cin=layer.cin, cout=layer.cout,
            act=layer.act, max_abs_err=worst,
            mean_abs_want=want.float().abs().mean().item(),
            frac_differ=f"{differ:.3e}", bound="atol=2**-10,rtol=2**-7", ok=ok)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at anime "
                             f"layer {i}")
        errs["K1"] = max(errs["K1"], worst)
        del x, got, want
    a_ms = cuda_ms(lambda: conv3x3_chain(ax, alayers), 5)
    a_plain_ms = cuda_ms(lambda: conv3x3_chain_plain(ax, alayers), 2)
    a_lib_ms = cuda_ms(lambda: cudnn_stack(ax, alayers), 5)
    a_flop = 2 * 9 * N * H * W * sum(l.cin * l.cout for l in alayers)
    say("K1_anime_time", ms=f"{a_ms:.3f}", plain_ms=f"{a_plain_ms:.3f}",
        cudnn_ms=f"{a_lib_ms:.3f}", tflops=f"{a_flop / a_ms / 1e9:.1f}",
        per="10-layer nf-24 chain, 4x1080p")
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
    # 64->64 leaky twice and 64->3 none (cout % 8 != 0), each layer alone
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

    # K3 against its plain version at 4x1080p in all three layouts: the
    # wide SRVGG's tail (Cf 160) and a 64-wide one, at 2x and 4x
    for cf, s in K3_CASES:
        g = torch.Generator(device=dev).manual_seed(cf + s)
        u = (torch.randn((N, H, W, cf), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16)
        skip = torch.rand((N, H, W, 3), generator=g, device=dev).to(torch.bfloat16)
        wmat = (torch.randn((9 * cf, 3 * s * s), generator=g, device=dev)
                * 0.3 / (9 * cf) ** 0.5).to(torch.bfloat16)
        bias = torch.randn((3 * s * s,), generator=g, device=dev) * 0.05
        for layout in LAYOUTS:
            got = sr_tail_fused(u, skip, wmat, bias, s, layout)
            want = sr_tail_fused_plain(u, skip, wmat, bias, s, layout)
            torch.cuda.synchronize()
            worst = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, want))
            bound = K3_MODEL_ATOL if layout == "model" else K2_MAX_LSB
            say("K3", shape=f"{N}x{H}x{W}x{cf}", scale=s, layout=layout,
                max_abs_err=worst, bound=bound, ok=worst <= bound)
            if worst > bound:
                raise SystemExit(f"K3 ({layout}, Cf {cf}, s {s}) disagrees "
                                 "with its plain version")
            if layout != "model":
                errs["K3"] = max(errs.get("K3", 0.0), worst)
            del got, want
        if (cf, s) == K3_CASES[-1]:
            k3_args = (u, skip, wmat, bias, s, "planar")
        else:
            del u, skip
        torch.cuda.empty_cache()
    k3_ms = cuda_ms(lambda: sr_tail_fused(*k3_args), 10)
    k3_plain_ms = cuda_ms(lambda: sr_tail_fused_plain(*k3_args), 2)
    cf, s = K3_CASES[-1]
    k3_bound = roofline(N * H * W * (2 * cf + 2 * 3 + 3 * s * s)
                        + 9 * cf * 3 * s * s * 2 + 3 * s * s * 4,
                        {"bf16": 2 * 9 * cf * 3 * s * s * N * H * W})
    say("K3_time", ms=f"{k3_ms:.3f}", plain_ms=f"{k3_plain_ms:.3f}",
        bound_ms=f"{k3_bound[0]:.3f}", bound_by=k3_bound[1],
        per=f"one launch, {N}x1080p, Cf {cf}, 4x -> planar u8")
    del k3_args, u, skip
    torch.cuda.empty_cache()

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
    k4, k4_sm90, k3 = (conv3x3_fused.launches, conv3x3_fused.launches_sm90,
                       sr_tail_fused.launches)
    out = weng.planar_step(small)
    torch.cuda.synchronize()
    launched = (conv3x3_fused.launches - k4, conv3x3_fused.launches_sm90 - k4_sm90,
                sr_tail_fused.launches - k3)
    out = out.cpu().numpy()
    ref = plain_call(weng.planar_step, small).cpu().numpy()
    quality = psnr(out, ref)
    ok = (quality >= WIDE_MIN_PSNR
          and launched == (WIDE_CONVS + 1, WIDE_CONVS, 1))
    say("wide_srvgg_step_vs_plain", shape=out.shape, nf=WIDE_NF,
        k4_launches=launched[0], k4_sm90_launches=launched[1],
        k3_launches=launched[2],
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
    launches = dict.fromkeys([*counters, "K1_sm90", "K4_sm90", "K5_sm90"], 0)
    e2e = {}

    def drive(tmp, name, c420, frames, rate, extra, synthetic=True):
        """One CLI run; its kernel launch counts from zero."""
        src = os.path.join(tmp, f"{name}.y4m")
        out_path = os.path.join(tmp, f"{name}.out.y4m")
        work = os.path.join(tmp, f"work_{name}")
        write_clip(src, c420, seed=1, frames=frames, rate=rate)
        for fn in counters.values():
            fn.launches = 0
        conv3x3_chain.launches_sm90 = conv3x3_fused.launches_sm90 = 0
        rdb_block.launches_sm90 = 0
        t0 = time.perf_counter()
        rc = cli_main(["-i", src, "-o", out_path, "-t", work, "-b", "1", "-r",
                       *(["--synthetic_models"] if synthetic else []), *extra])
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        counts["K1_sm90"] = conv3x3_chain.launches_sm90
        counts["K4_sm90"] = conv3x3_fused.launches_sm90
        counts["K5_sm90"] = rdb_block.launches_sm90
        for k, v in counts.items():
            launches[k] += v
        with Y4MSource(out_path) as o:
            geom, cs = (o.width, o.height), o.colorspace
            count = 0
            while o.skip(1):
                count += 1
        left = sorted(os.listdir(os.path.join(work, "upscale_video")))
        frags = seen_fragments[-1]
        os.remove(out_path)
        ok = (rc == 0 and count == frames
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
                tmp, name, c420, CLIP_FRAMES, CLIP_RATE, [])
            ok = (ok and geom == (2 * W, 2 * H) and k["K1"] == 17 * steps
                  and k["K2"] == steps
                  and k["K3"] == k["K4"] == k["K5"] == k["K6"] == 0)
            say("e2e", path="default", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=steps, k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"],
                k2_launches=k["K2"], k5_launches=k["K5"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.2f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end run on the {name} clip failed")
            if k["K1_sm90"] != COMPACT_BODY * steps:
                raise SystemExit(
                    f"the default step's 64->64 body ran {k['K1_sm90']} layers "
                    f"on the sm90 kernel, not {COMPACT_BODY * steps}")
        # -m r: one frame per step, every dense block one K5 launch over
        # the frame's 8 tiles, the three solo 3x3 convs one K4 launch each,
        # the last three one K1 chain
        vsteps = steps_of(VALAR_CLIP_FRAMES, VALAR_CLIP_RATE, 1)
        for name, c420 in (("valar_c420jpeg", True), ("valar_c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, VALAR_CLIP_FRAMES, VALAR_CLIP_RATE,
                ["-m", "r"])
            ok = (ok and geom == (4 * W, 4 * H)
                  and k["K5"] == VALAR_BLOCKS * vsteps
                  and k["K5_sm90"] == VALAR_BLOCKS * vsteps
                  and k["K4"] == VALAR_SOLOS * vsteps
                  and k["K4_sm90"] == VALAR_SOLOS_SM90 * vsteps
                  and k["K1"] == VALAR_CHAIN * vsteps
                  and k["K1_sm90"] == LAST_CHAIN_SM90 * vsteps
                  and k["K2"] == k["K3"] == k["K6"] == 0)
            say("e2e", path="-m r", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=vsteps,
                k5_launches=k["K5"], k5_launches_sm90=k["K5_sm90"],
                k4_launches=k["K4"],
                k4_sm90_launches=k["K4_sm90"], k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"],
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
                  and k["K1_sm90"] == COMPACT_BODY * steps
                  and k["K2"] == steps and k["K3"] == k["K4"] == k["K5"] == 0)
            say("e2e", path=f"-m {PRELUDE}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=steps, k6_launches=k["K6"], k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"],
                k2_launches=k["K2"], k5_launches=k["K5"],
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
                  and k["K2"] == k["K3"] == k["K5"] == k["K6"] == 0)
            say("e2e", path=f"-m sr={ESRGAN_STEM}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=esteps, k4_launches=k["K4"],
                k4_sm90_launches=k["K4_sm90"], k1_launches=k["K1"],
                k1_sm90_launches=k["K1_sm90"],
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
                  and k["K1"] == k["K1_sm90"] == k["K2"] == k["K5"]
                  == k["K6"] == 0)
            say("e2e", path=f"-m sr={WIDE_STEM}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=wsteps, k4_launches=k["K4"],
                k4_sm90_launches=k["K4_sm90"], k3_launches=k["K3"],
                k1_launches=k["K1"], k2_launches=k["K2"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end sr= wide SRVGG run on the {name} "
                                 "clip failed")
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

    # --tta: one 1080p frame of the default step, 8 dihedral passes (K1
    # and K2's f32 layout at 1080x1920 and 1920x1080), against the same
    # step on the plain versions
    teng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True, tta=True)
    for fn in counters.values():
        fn.launches = 0
    conv3x3_chain.launches_sm90 = 0
    out = teng.step(frames[:1])
    torch.cuda.synchronize()
    k = {name: fn.launches for name, fn in counters.items()}
    k["K1_sm90"] = conv3x3_chain.launches_sm90
    out = out.cpu().numpy()
    ref = plain_call(teng.step, frames[:1]).cpu().numpy()
    quality = psnr(out, ref)
    ok = (quality >= TTA_MIN_PSNR and out.shape == (1, 2 * H, 2 * W, 3)
          and k["K1"] == 8 * 17 and k["K1_sm90"] == 8 * COMPACT_BODY
          and k["K2"] == 8)
    say("tta", shape=out.shape, k1_launches=k["K1"],
        k1_sm90_launches=k["K1_sm90"], k2_launches=k["K2"],
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
    ):
        ms = cuda_ms(fn, reps)
        rates[name] = per * 1000.0 / ms
        say("throughput", step=name, ms_per_step=f"{ms:.2f}",
            frames_per_step=per, frames_per_s=f"{rates[name]:.3f}",
            card=repr(smi))

    del eng, peng, teng, veng, eeng, weng, frames, flat, yuv, pyuv
    torch.cuda.empty_cache()
    k7_layer = k7_sm90_phases(dev, errs)
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

    # library_ms: K1's is cuDNN's bf16 conv (F.conv2d with bias, one call
    # per layer, channels-last) over the same 17 layers, without the
    # PReLUs; K4's the same over one ESRGAN dense block's five convs,
    # without the leaky ReLUs; K2, K3, K5 and K6 have no PyTorch call
    # computing their function; K7's is the same cuDNN call over the 16-layer
    # conv body; PyTorch has no int8 convolution on CUDA for K8
    model_dir.cleanup()
    kernels = [
        {"name": "conv3x3_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv3x3_chain_sm90.cu",
         "source_wmma": "upscale_video_tpu_torch/csrc/conv3x3_chain.cu",
         "replaces": "upscale_video_tpu/ops/conv_chain.py:61",
         "launches": launches["K1"], "launches_sm90": launches["K1_sm90"],
         "max_abs_err": errs["K1"],
         "ms": k1_ms, "ms_wmma": k1_wmma_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": k1_lib_ms, "layer_ms": k1_layer_ms,
         "anime_ms": a_ms, "anime_plain_ms": a_plain_ms,
         "anime_library_ms": a_lib_ms},
        {"name": "sr_tail_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/sr_tail.cu",
         "replaces": "upscale_video_tpu/ops/tail_pallas.py:155",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "sr_tail_fused", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/sr_tail.cu",
         "replaces": "upscale_video_tpu/ops/tail_pallas.py:31",
         "launches": launches["K3"], "max_abs_err": errs["K3"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
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
         "source": "upscale_video_tpu_torch/csrc/nlmeans.cu",
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
         "source": "upscale_video_tpu_torch/csrc/conv_chain_q8.cu",
         "replaces": "upscale_video_tpu/ops/conv_chain_q8.py:68",
         "launches": bench_launches["conv3x3_chain_q8"][0],
         "max_abs_err": errs["K8"], **body["K8"], "library_ms": None},
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the path was never launched")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise SystemExit("jax was imported on the port's path")
    if any(m == "upscale_video_tpu" or m.startswith("upscale_video_tpu.")
           for m in sys.modules):
        raise SystemExit("the JAX package was imported on the port's path")
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels, "frames_per_s": rates,
                      "e2e_wall_fps": e2e}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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

    swaps = [(executor, "conv3x3_chain", conv_chain.conv3x3_chain_plain),
             (executor, "sr_tail_chain", tail.sr_tail_chain_plain),
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
        got = conv3x3_chain_q8(xin, layers)
        want = conv3x3_chain_q8_plain(xin, layers)
        torch.cuda.synchronize()
        worst, differ, _ = compare(got, want, 0.0, 0.0)
        ok = differ == 0 and bool(torch.isfinite(got.float()).all())
        say("K8", case=what, shape="x".join(map(str, xin.shape)),
            layers=len(layers), max_abs_err=worst,
            mean_abs_want=want.float().abs().mean().item(),
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
                     "bound_by": bound[1]}
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


def profile_shares(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its device kernel time
    summed for K5, K4, K1, torch.cat and the rest (with the three largest
    of the rest), or ``device_ms="not measured"`` where the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"k5": "rdb_block", "k4": "conv3x3_fused", "k1": "chain_layer",
              "cat": "CatArray"}
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
