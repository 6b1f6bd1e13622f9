"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``upscale_video_tpu_torch/csrc/`` with
nvcc, holds each against its plain PyTorch version on the card at its main
path's shapes, and drives both ported paths end to end through
``upscale-video-torch`` on hermetic 1080p Y4M clips under both device
contracts, counting kernel launches:

- the default path: 2x Compact (K1 + K2), 4 frames per step, 1080p -> 4K;
- ``-m r``: the 4x Valar RRDBNet at full width and depth (23 RRDBs, K5
  per dense block, K1 per other 3x3 conv), mixed precision, 544-budget
  tiles with halo 16, 1 frame per step, 1080p -> 4K.

Weights are synthetic (seed 0).  K1 is held against its plain version at
both paths' shapes (the Compact stack at 4x1080p; each of ``-m r``'s six
convs on a 1080p frame's tiles at 1x, 2x or 4x), and the whole 1080p
``-m r`` step against the same step on the plain versions.  It then times
each step against its plain version.  Every phase prints one line; any failure raises and the script
exits non-zero without printing a result.  The last three lines are a JSON
object with each kernel's figures, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
K2_MAX_LSB = 1                 # u8: an ulp-level difference at a boundary
E2E_MIN_PSNR = 40.0            # bf16 CUDA step vs the f32 plain path, dB
# K5: a per-source piece may round one bf16 ulp away from the plain
# version's (tensor-core vs cuDNN f32 summation order); through 0.2 * c5 it
# moves the output by up to 2**-6 + 2**-7 * |out| (tests/test_torch_rdb.py)
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
    layers = fwd.chain_layers(model.state)
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
    flop = 2 * 9 * N * H * W * sum(l.cin * l.cout for l in layers)
    say("K1_time", ms=f"{k1_ms:.3f}", plain_ms=f"{k1_plain_ms:.3f}",
        tflops=f"{flop / k1_ms / 1e9:.1f}", per="17-layer stack, 4x1080p")

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
    say("K2_time", ms=f"{k2_ms:.3f}", plain_ms=f"{k2_plain_ms:.3f}",
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
    say("K5_time", ms=f"{k5_ms:.3f}", plain_ms=f"{k5_plain_ms:.3f}",
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
    counters = {"K1": conv3x3_chain, "K2": sr_tail_chain, "K5": rdb_block}
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
                  and k["K2"] == steps and k["K5"] == 0)
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
                  and k["K1"] == VALAR_CONVS * vsteps and k["K2"] == 0)
            say("e2e", path="-m r", clip=name, out=f"{geom[0]}x{geom[1]}",
                colorspace=cs, frames=count, steps=vsteps,
                k5_launches=k["K5"], k1_launches=k["K1"], k2_launches=k["K2"],
                fragments_before_concat=frags, workdir_after=left,
                wall_s=f"{wall:.2f}", wall_fps=f"{e2e[name]:.3f}", ok=ok)
            if not ok:
                raise SystemExit(f"end-to-end -m r run on the {name} clip failed")
    HermeticBackend.concat = concat

    # device throughput at 1080p -> 4K: the default step (4 frames) and
    # the -m r step (1 frame), each beside its plain version
    from upscale_video_tpu_torch.ops.yuv import yuv420_from_planar

    eng = ChainEngine.build(ChainSpec(), 2, dev, synthetic=True)
    frames = torch.from_numpy(
        rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(dev)
    flat = torch.from_numpy(
        rng.integers(0, 256, (N, H * W * 3 // 2), dtype=np.uint8)).to(dev)
    yuv = eng.yuv_step(True, planar=True, i420_in=(H, W, True))

    def plain_planar(f):
        x = frames_to_model(f).to(torch.bfloat16)
        buf = conv3x3_chain_plain(x, layers, crop=False)
        return sr_tail_chain_plain(buf, x, tail.wmat, tail.bias, 2, "planar")

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
        ref = plain_step(engine, frames[:1]).cpu().numpy()
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
        ("plain_planar_step", lambda: plain_planar(frames), 2, N),
        ("plain_yuv420_step", lambda: yuv420_from_planar(
            plain_planar(frames), 2, True), 2, N),
        ("valar_step", lambda: veng.step(frames[:1]), 2, 1),
        ("plain_valar_step", lambda: plain_step(veng, frames[:1]), 1, 1),
    ):
        ms = cuda_ms(fn, reps)
        rates[name] = per * 1000.0 / ms
        say("throughput", step=name, ms_per_step=f"{ms:.2f}",
            frames_per_step=per, frames_per_s=f"{rates[name]:.3f}",
            card=repr(smi))

    kernels = [
        {"name": "conv3x3_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/conv3x3_chain.cu",
         "replaces": "upscale_video_tpu/ops/conv_chain.py:61",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "sr_tail_chain", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/sr_tail.cu",
         "replaces": "upscale_video_tpu/ops/tail_pallas.py:155",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "rdb_block", "route": "cuda",
         "source": "upscale_video_tpu_torch/csrc/rdb_block.cu",
         "replaces": "upscale_video_tpu/ops/rdb_pallas.py:253",
         "launches": launches["K5"], "max_abs_err": errs["K5"],
         "ms": k5_ms, "plain_ms": k5_plain_ms},
    ]
    if not all(k["launches"] > 0 for k in kernels):
        raise SystemExit("a kernel of the path was never launched")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise SystemExit("jax was imported on the port's path")
    print(json.dumps({"kernels": kernels, "frames_per_s": rates,
                      "e2e_wall_fps": e2e}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def plain_step(engine, frames):
    """``engine.step`` with every kernel of the graph walk swapped for its
    plain version (K5 -> rdb_block_plain, K1 -> conv3x3_chain_plain); the
    launch counts must not move."""
    from upscale_video_tpu_torch.models import executor, ops
    from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain_plain
    from upscale_video_tpu_torch.ops.rdb import rdb_block, rdb_block_plain

    saved = executor.rdb_block, ops.conv3x3_chain
    before = rdb_block.launches
    executor.rdb_block, ops.conv3x3_chain = rdb_block_plain, conv3x3_chain_plain
    try:
        out = engine.step(frames)
    finally:
        executor.rdb_block, ops.conv3x3_chain = saved
    if rdb_block.launches != before:
        raise SystemExit("the plain step launched K5")
    return out


if __name__ == "__main__":
    raise SystemExit(main())
