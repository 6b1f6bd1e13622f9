"""``vsr-warmup-torch``: pay a planned run's first-use costs up front.

Port of ``upscale_video_tpu/cli/warmup.py``.  On the card the one first-run
cost that persists across processes is the kernel library's build (nvcc
over ``csrc/``, minutes for the templated sources), kept in the
hash-keyed ``_build/`` directory beside the package
(:func:`~upscale_video_tpu_torch.kernels.build.library`).  This tool
builds it, then builds the engine of the planned ``upscale-video-torch``
run (model chain, precision, tile and halo, ``--conv_impl``, ``-g`` and
``--parallel``), resolves the stream contract with the same policy
(:func:`_resolve_contract`) and runs each step the run dispatches once on
a zero batch of the planned geometry (as the JAX tool does for a mesh
step), printing progress and the seconds each took.

Same flags as ``vsr-warmup`` plus ``--device``; with ``--device cpu``
there is no library to build and the step runs the plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

from upscale_video_tpu_torch.cli.common import (
    add_compute_args,
    add_model_chain_args,
)
from upscale_video_tpu_torch.cli.upscale_video import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vsr-warmup-torch",
        description="Build the CUDA kernel library and run once each step "
                    "a planned upscale-video-torch run will use, with "
                    "progress.",
    )
    p.add_argument(
        "--size", default="1920x1080",
        help="Planned input geometry WxH AFTER cropping (default "
             "1920x1080).",
    )
    add_model_chain_args(p)
    p.add_argument(
        "-p", "--pix_fmt", default="yuv420p",
        help="The planned run's encode pixel format (its -p flag): "
             "decides what --pipe_pix auto resolves to.",
    )
    p.add_argument(
        "--pipe_pix", choices=["auto", "rgb24", "yuv420p"], default="auto",
        help="Stream contract of the planned run (same default/policy as "
             "upscale-video-torch).",
    )
    p.add_argument(
        "--source_pix_fmt", default="yuv420p",
        help="The planned input's probed pixel format (ffprobe "
             "vocabulary): gates the flat-I420 decode contract exactly "
             "like the pipeline (4:4:4/10-bit sources decode as rgb24).",
    )
    p.add_argument(
        "--range", choices=["limited", "full"], default="limited",
        dest="yuv_range",
        help="YCbCr level range of the planned backend: ffmpeg rawvideo "
             "pipes are limited/studio (default); the hermetic y4m "
             "backend is full (C420jpeg).",
    )
    add_compute_args(p)
    add_device_arg(p)
    return p


def _resolve_contract(args, engine, width: int, height: int):
    """The stream-plane contract the planned run will pick: the JAX tool's
    policy over the port's ``_auto_pipe_pix`` (process.py) and the i420
    decode gate, against a planning-only ffmpeg backend (its gate
    functions never invoke the binary)."""
    from upscale_video_tpu_torch.pipeline.process import _auto_pipe_pix
    from upscale_video_tpu_torch.video.backend import FfmpegBackend

    backend = FfmpegBackend("ffmpeg", pix_fmt=args.pix_fmt)
    info = {"height": height, "width": width,
            "pix_fmt": args.source_pix_fmt}
    pipe_pix = args.pipe_pix
    if pipe_pix == "auto":
        pipe_pix = _auto_pipe_pix(backend, engine, info, "", "stream")
    planar = engine.planar_scale
    yuv420 = (pipe_pix == "yuv420p"
              and not (height * engine.scale % 2 or width * engine.scale % 2))
    if yuv420 and engine.row_sharded and not (planar and planar % 2 == 0):
        yuv420 = False
    i420_in = None
    if (yuv420 and height % 2 == 0 and width % 2 == 0
            and engine.input_rank_flexible
            and args.source_pix_fmt in ("yuv420p", "yuvj420p")):
        i420_in = (height, width, args.yuv_range == "full")
    return pipe_pix, yuv420, bool(planar), i420_in


def _run_once(fn, x) -> float:
    """``fn`` on the host batch ``x`` once, its output brought to the host
    (which waits for the device); returns seconds."""
    t0 = time.perf_counter()
    fn(x).cpu()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        width, height = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        print(f"--size must be WxH (e.g. 1920x1080), got {args.size!r}",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from upscale_video_tpu_torch.cli.upscale_video import check_slice
    from upscale_video_tpu_torch.device import resolve_device
    from upscale_video_tpu_torch.pipeline.chain import (
        ChainEngine, ChainSpec, default_frames_per_step, precision_dtypes,
    )

    check_slice(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from upscale_video_tpu_torch.kernels import build

        print(f"building the kernel library ({build.library_path().name})...",
              flush=True)
        t0 = time.perf_counter()
        build.library()
        print(f"kernel library ready in {time.perf_counter() - t0:.1f}s "
              f"({build.library_path()})", flush=True)
    spec = ChainSpec.parse(args.models)
    dtype, residual_dtype = precision_dtypes(args.precision, spec)
    print(f"building engine ({' -> '.join(spec.stage_names())} "
          f"scale={spec.effective_scale(args.scale)} {args.precision})...",
          flush=True)
    t0 = time.perf_counter()
    engine = ChainEngine.build(
        spec, args.scale, device, model_path=args.model_path,
        compute_dtype=dtype, synthetic=args.synthetic_models,
        residual_dtype=residual_dtype, tile=args.tile_size, halo=args.halo,
        tta=args.tta, conv_impl=args.conv_impl,
    )
    if args.frames_per_step is None:
        args.frames_per_step = default_frames_per_step(spec)
    frames_per_step = engine.configure_chips(
        args.chips, args.frames_per_step, args.parallel
    )
    print(f"engine built in {time.perf_counter() - t0:.1f}s", flush=True)

    pipe_pix, yuv420, planar, i420_in = _resolve_contract(
        args, engine, width, height
    )
    if yuv420:
        use_planar = planar and engine.planar_scale % 2 == 0
        step_fn = engine.yuv_step(args.yuv_range == "full",
                                  planar=use_planar, i420_in=i420_in)
        contract = ("yuv420p" + (", planar" if use_planar else "")
                    + (", i420 input" if i420_in else ""))
    elif planar:
        step_fn = engine.planar_step
        contract = f"rgb24, planar s={engine.planar_scale}"
    else:
        step_fn = engine.step
        contract = "rgb24, full-frame"
    if i420_in:
        x = np.zeros((frames_per_step, height * width * 3 // 2), np.uint8)
    else:
        x = np.zeros((frames_per_step, height, width, 3), np.uint8)
    print(f"contract: {contract} @ {width}x{height} batch {frames_per_step}"
          f" (pipe_pix {args.pipe_pix} -> {pipe_pix})", flush=True)
    dt = _run_once(step_fn, torch.from_numpy(x))
    print(f"ran step program in {dt:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
