"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``upscale_video_tpu_torch/csrc/`` with
nvcc, holds each against its plain PyTorch version on the card at its main
path's shapes, and drives the ported paths end to end through
``upscale-video-torch`` on hermetic 1080p Y4M clips under both device
contracts, counting kernel launches:

- the default path: 2x Compact (K1 + K2), 4 frames per step, 1080p -> 4K;
- ``-m r``: the 4x Valar RRDBNet at full width and depth (23 RRDBs, K5
  per dense block, K1 per other 3x3 conv), mixed precision, 544-budget
  tiles with halo 16, 1 frame per step, 1080p -> 4K;
- ``-m a,n=3``: NL-means at strength 3 (K6, one launch per step), the 1x
  SubCompact anime deblur model (nf 24, one 10-layer K1 chain), then the
  default 2x Compact (K1 + K2), 4 frames per step;
- ``--tta`` on the default path: one 1080p frame through the 8 dihedral
  transforms (K2's f32 layout).

Weights are synthetic (seed 0).  K1 is held against its plain version at
every path's shapes (the Compact stack and the anime chain at 4x1080p;
each of ``-m r``'s six convs on a 1080p frame's tiles at 1x, 2x or 4x),
K6 at 4x1080p, and the whole 1080p ``-m r`` and ``--tta`` steps against
the same steps on the plain versions.  It then times each step against its
plain version.  Every phase prints one line; any failure raises and the
script exits non-zero without printing a result.  The last three lines are
a JSON object with each kernel's figures (its bound computed from the
card's published peaks), the card's
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
VALAR_CONVS = 6                # first, trunk, up1, up2, hr, last: K1 launches
# each K1 conv of -m r with the factor its 1080p tiles are upscaled by there
VALAR_K1_LAYERS = (("conv_first", 1), ("conv_trunk", 1), ("conv_up1", 2),
                   ("conv_up2", 4), ("conv_hr", 4), ("conv_last", 4))
TILES = (8, 576, 512)          # one 1080p frame: 2x4 tiles of 544x480 + halo
# K1 after 17 layers: each layer rounds once to bf16 after an f32 sum whose
# order differs from cuDNN's, so a value may land one bf16 ulp apart and
# the ulp propagates through later layers (tests/test_conv_chain.py:70).
K1_ATOL, K1_RTOL = 5e-2, 2e-2
# K1 as one layer: the one rounding may land one bf16 ulp (<= 2**-7 * |v|)
# away after an f32 sum in another order; atol for sums that cancel near 0
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
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "exp": 67e12 / 16}


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
    from upscale_video_tpu_torch.ops.conv_chain import (
        conv3x3_chain, conv3x3_chain_plain,
    )
    from upscale_video_tpu_torch.ops.pixel import frames_to_model
    from upscale_video_tpu_torch.ops.tail import (
        sr_tail_chain, sr_tail_chain_plain,
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
    k1_plain_ms = cuda_ms(
        lambda: conv3x3_chain_plain(main_x, layers, crop=False), 2)
    k1_lib_ms = cuda_ms(lambda: cudnn_stack(main_x, layers), 5)
    flop = 2 * 9 * N * H * W * sum(l.cin * l.cout for l in layers)
    wbytes = sum(l.wmat.numel() * 2 + l.bias.numel() * 4 + l.slope.numel() * 4
                 for l in layers)
    k1_bound = roofline(main_x.numel() * 2 + wbytes
                        + N * (H + 2) * (W + 2) * layers[-1].cout * 2,
                        {"bf16": flop})
    say("K1_time", ms=f"{k1_ms:.3f}", plain_ms=f"{k1_plain_ms:.3f}",
        cudnn_ms=f"{k1_lib_ms:.3f}", bound_ms=f"{k1_bound[0]:.3f}",
        bound_by=k1_bound[1], tflops=f"{flop / k1_ms / 1e9:.1f}",
        per="17-layer stack, 4x1080p")

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
    a_flop = 2 * 9 * N * H * W * sum(l.cin * l.cout for l in alayers)
    say("K1_anime_time", ms=f"{a_ms:.3f}", plain_ms=f"{a_plain_ms:.3f}",
        tflops=f"{a_flop / a_ms / 1e9:.1f}", per="10-layer nf-24 chain, 4x1080p")
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

    # K5 against its plain version: the main-path shape (the 8 tiles of one
    # 1080p frame) and a ragged one, with the first dense block's weights
    from upscale_video_tpu_torch.ops.rdb import (
        MACS_PER_PIXEL, RDBWeights, rdb_block, rdb_block_plain,
    )

    veng = ChainEngine.build(ChainSpec(real_life=True), 4, dev, synthetic=True,
                             residual_dtype=torch.float32)
    vfwd = veng.sr_model.frames_forward("model")
    if len(vfwd.rdb_triggers) != VALAR_BLOCKS:
        raise SystemExit(f"{len(vfwd.rdb_triggers)} dense blocks planned, "
                         f"expected {VALAR_BLOCKS}")
    trig, blk = next(iter(vfwd.rdb_triggers.items()))
    pw = veng.sr_model.state[trig]
    wts = RDBWeights(pw.wpack, pw.bpack, blk["slope"])
    for shape in (TILES, (2, 37, 53)):
        x = torch.from_numpy(rng.normal(0, 0.5, shape + (64,)).astype(
            np.float32)).to(dev, torch.bfloat16)
        got = rdb_block(x, wts)
        want = rdb_block_plain(x, wts)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        ok = bool((d <= K5_ATOL + K5_RTOL * want.float().abs()).all()) \
            and bool(torch.isfinite(got.float()).all())
        say("K5", shape="x".join(map(str, shape)) + "x64",
            max_abs_err=d.max().item(),
            frac_differ=f"{(d > 0).float().mean().item():.3e}",
            bound=f"atol=2**-6,rtol=2**-7", ok=ok)
        if not ok:
            raise SystemExit(f"K5 disagrees with its plain version at {shape}")
        errs["K5"] = max(errs.get("K5", 0.0), d.max().item())
        if shape == TILES:
            k5_x = x
        del got, want, d
    k5_ms = cuda_ms(lambda: rdb_block(k5_x, wts), 5)
    k5_plain_ms = cuda_ms(lambda: rdb_block_plain(k5_x, wts), 2)
    flop = 2 * MACS_PER_PIXEL * int(np.prod(TILES))
    k5_bound = roofline(2 * k5_x.numel() * 2 + wts.wpack.numel() * 2
                        + wts.bpack.numel() * 4, {"bf16": flop})
    say("K5_time", ms=f"{k5_ms:.3f}", plain_ms=f"{k5_plain_ms:.3f}",
        bound_ms=f"{k5_bound[0]:.3f}", bound_by=k5_bound[1],
        ms_per_frame=f"{k5_ms * VALAR_BLOCKS:.1f}",
        plain_ms_per_frame=f"{k5_plain_ms * VALAR_BLOCKS:.1f}",
        tflops=f"{flop / k5_ms / 1e9:.1f}",
        per="one dense block over 8x576x512x64 (the tiles of a 1080p frame)")
    del k5_x
    torch.cuda.empty_cache()

    # K1 at the -m r path's six 3x3 convs, each with its activation at the
    # shape the 1080p step gives it (the frame's 8 tiles at 1x, 2x, 4x):
    # 3->64 and 64->64 none, 64->64 leaky, and 64->3 none (cout % 8 != 0)
    from upscale_video_tpu_torch.models.ops import k1_layer

    gen = torch.Generator(device=dev).manual_seed(0)
    by_name = {l.name: l for l in veng.sr_model.graph.layers}
    for name, f in VALAR_K1_LAYERS:
        layer = k1_layer(by_name[name], veng.sr_model.state[name])
        shape = (TILES[0], TILES[1] * f, TILES[2] * f, layer.cin)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        got = conv3x3_chain(x, [layer])
        want = conv3x3_chain_plain(x, [layer])
        worst, differ, ok = compare(got, want, K1_LAYER_ATOL, K1_LAYER_RTOL)
        say("K1", path="-m r", conv=name, shape="x".join(map(str, shape)),
            cout=layer.cout, act=layer.act, max_abs_err=worst,
            frac_differ=f"{differ:.3e}", bound="atol=2**-10,rtol=2**-7", ok=ok)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at {name}")
        errs["K1"] = max(errs["K1"], worst)
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
    counters = {"K1": conv3x3_chain, "K2": sr_tail_chain, "K5": rdb_block,
                "K6": nl_means_denoise}
    launches = dict.fromkeys(counters, 0)
    e2e = {}

    def drive(tmp, name, c420, frames, rate, extra):
        """One CLI run; its kernel launch counts from zero."""
        src = os.path.join(tmp, f"{name}.y4m")
        out_path = os.path.join(tmp, f"{name}.out.y4m")
        work = os.path.join(tmp, f"work_{name}")
        write_clip(src, c420, seed=1, frames=frames, rate=rate)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc = cli_main(["-i", src, "-o", out_path, "-t", work,
                       "--synthetic_models", "-b", "1", "-r", *extra])
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
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
                  and k["K2"] == steps and k["K5"] == 0 and k["K6"] == 0)
            say("e2e", path="default", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=steps, k1_launches=k["K1"],
                k2_launches=k["K2"], k5_launches=k["K5"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.2f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end run on the {name} clip failed")
        # -m r: one frame per step, every dense block one K5 launch over
        # the frame's 8 tiles, the six other 3x3 convs one K1 launch each
        vsteps = steps_of(VALAR_CLIP_FRAMES, VALAR_CLIP_RATE, 1)
        for name, c420 in (("valar_c420jpeg", True), ("valar_c444", False)):
            ok, geom, cs, count, k, frags, left, wall = drive(
                tmp, name, c420, VALAR_CLIP_FRAMES, VALAR_CLIP_RATE,
                ["-m", "r"])
            ok = (ok and geom == (4 * W, 4 * H)
                  and k["K5"] == VALAR_BLOCKS * vsteps
                  and k["K1"] == VALAR_CONVS * vsteps and k["K2"] == 0
                  and k["K6"] == 0)
            say("e2e", path="-m r", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=vsteps,
                k5_launches=k["K5"], k1_launches=k["K1"], k2_launches=k["K2"],
                fragments_before_concat=frags, workdir_after=left,
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
                  and k["K2"] == steps and k["K5"] == 0)
            say("e2e", path=f"-m {PRELUDE}", clip=name,
                out=f"{geom[0]}x{geom[1]}", colorspace=cs, frames=count,
                steps=steps, k6_launches=k["K6"], k1_launches=k["K1"],
                k2_launches=k["K2"], k5_launches=k["K5"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.2f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end -m {PRELUDE} run on the {name} "
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
    out = teng.step(frames[:1])
    torch.cuda.synchronize()
    k = {name: fn.launches for name, fn in counters.items()}
    out = out.cpu().numpy()
    ref = plain_call(teng.step, frames[:1]).cpu().numpy()
    quality = psnr(out, ref)
    ok = (quality >= TTA_MIN_PSNR and out.shape == (1, 2 * H, 2 * W, 3)
          and k["K1"] == 8 * 17 and k["K2"] == 8)
    say("tta", shape=out.shape, k1_launches=k["K1"], k2_launches=k["K2"],
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
    ):
        ms = cuda_ms(fn, reps)
        rates[name] = per * 1000.0 / ms
        say("throughput", step=name, ms_per_step=f"{ms:.2f}",
            frames_per_step=per, frames_per_s=f"{rates[name]:.3f}",
            card=repr(smi))

    # library_ms: K1's is cuDNN's bf16 conv (F.conv2d with bias, one call
    # per layer, channels-last) over the same 17 layers, without the
    # PReLUs; K2, K5 and K6 have no PyTorch call computing their function
    kernels = [
        {"name": "conv3x3_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv3x3_chain.cu",
         "replaces": "upscale_video_tpu/ops/conv_chain.py:61",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": k1_lib_ms},
        {"name": "sr_tail_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/sr_tail.cu",
         "replaces": "upscale_video_tpu/ops/tail_pallas.py:155",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "rdb_block", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/rdb_block.cu",
         "replaces": "upscale_video_tpu/ops/rdb_pallas.py:253",
         "launches": launches["K5"], "max_abs_err": errs["K5"],
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound[0],
         "bound_by": k5_bound[1], "library_ms": None},
        {"name": "nl_means", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/nlmeans.cu",
         "replaces": "upscale_video_tpu/ops/nlmeans_pallas.py:54",
         "launches": launches["K6"], "max_abs_err": errs["K6"],
         "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound[0],
         "bound_by": k6_bound[1], "library_ms": None},
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the path was never launched")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise SystemExit("jax was imported on the port's path")
    if any(m == "upscale_video_tpu" or m.startswith("upscale_video_tpu.")
           for m in sys.modules):
        raise SystemExit("the JAX package was imported on the port's path")
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
    (K1 -> conv3x3_chain_plain, K2 -> sr_tail_chain_plain, K5 ->
    rdb_block_plain, K6 -> nl_means_denoise_plain); fails if a kernel
    launched inside."""
    from upscale_video_tpu_torch.models import executor, ops
    from upscale_video_tpu_torch.ops import conv_chain, nlmeans, rdb, tail
    from upscale_video_tpu_torch.pipeline import chain

    swaps = [(executor, "conv3x3_chain", conv_chain.conv3x3_chain_plain),
             (ops, "conv3x3_chain", conv_chain.conv3x3_chain_plain),
             (executor, "sr_tail_chain", tail.sr_tail_chain_plain),
             (executor, "rdb_block", rdb.rdb_block_plain),
             (chain, "nl_means_denoise", nlmeans.nl_means_denoise_plain)]
    wrappers = (conv_chain.conv3x3_chain, tail.sr_tail_chain, rdb.rdb_block,
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
