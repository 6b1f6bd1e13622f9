"""``upscale-video-torch``: the full-pipeline CLI on the PyTorch/CUDA port.

Same flags as ``upscale-video`` (the argparse option groups are
:mod:`upscale_video_tpu_torch.cli.common`, a copy of the JAX package's),
plus ``--device``.  ``--trace_dir`` writes a ``torch.profiler`` trace of
the run (:mod:`upscale_video_tpu_torch.utils.trace`).  ``-g`` over
several GPUs runs under ``--parallel dp`` (frames split over the GPUs),
``sp`` (each frame's rows split) or ``tp`` (each conv's output channels
split).
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.common import (
    add_compute_args,
    add_io_args,
    add_logging_args,
    add_model_chain_args,
)
from upscale_video_tpu_torch.pipeline.chain import ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file
from upscale_video_tpu_torch.utils.trace import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="upscale-video-torch",
        description="Upscale Video 2x or 4x on an NVIDIA GPU (PyTorch + CUDA)",
    )
    p.add_argument("-i", "--input_file", required=True, help="Input video file.")
    p.add_argument(
        "-o", "--output_file",
        help="Output file (default: input_file + '.2x.' or '.4x.').",
    )
    add_io_args(p)
    p.add_argument("-e", "--ffmpeg_encoder", default="libx264",
                   help="ffmpeg encoder for fragments.")
    p.add_argument("-p", "--pix_fmt", default="yuv420p",
                   help="Pixel format for encoding (e.g. p010le for 10-bit).")
    add_model_chain_args(p)
    p.add_argument(
        "-b", "--batch_size", type=int, default=10,
        help="Minutes per fragment batch (negative = split into |b| parts).",
    )
    add_compute_args(p)
    p.add_argument("-r", "--resume_processing", action="store_true",
                   help="Keep temp_dir state and fast-forward completed work.")
    p.add_argument("-x", "--extract_only", action="store_true",
                   help="Exit after frame extraction (sampling checkpoint; "
                        "rerun with -r).")
    add_logging_args(p)
    p.add_argument("--global_quality", type=int, default=20,
                   help="Encoder -global_quality.")
    p.add_argument("--data_plane", choices=["stream", "png"], default="stream",
                   help="stream = zero-spill pipes (default); png = "
                        "reference-layout per-frame files (needed before "
                        "test-images-torch/fix-frames-torch).")
    p.add_argument(
        "--pipe_pix", choices=["auto", "rgb24", "yuv420p"], default="auto",
        help="Stream-plane device contract: yuv420p (4:2:0 in and out on "
             "the GPU) or rgb24 (shuffle-planar u8 out); auto picks yuv420p "
             "exactly when it is lossless for this run.",
    )
    p.add_argument("--copy_audio", action="store_true",
                   help="Mux the source's audio/subtitle streams into the "
                        "output. Needs -f.")
    p.add_argument("--trace_dir",
                   help="Write a torch.profiler trace (Chrome format) here.")
    add_device_arg(p)
    return p


def add_device_arg(p: argparse.ArgumentParser) -> None:
    """``--device``, the one flag the port's model-running CLIs add to the
    JAX package's."""
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default; the hand-written kernels) or cpu "
             "(their plain PyTorch versions). cuda without a GPU fails.",
    )


def check_slice(args) -> None:
    """Raise ``NotImplementedError`` for an ``-m`` chain that does not
    parse, before any work.  Every CLI of the port that runs a model checks
    its arguments here."""
    try:
        ChainSpec.parse(args.models)
    except ValueError:
        raise NotImplementedError(
            f"not ported to the PyTorch/CUDA package yet: -m {args.models}"
        ) from None


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.copy_audio and not args.ffmpeg:
        parser.error("--copy_audio requires -f/--ffmpeg")
    check_slice(args)
    with trace(args.trace_dir, args.device):
        _run(args)
    return 0


def _run(args) -> None:
    process_file(
        input_file=args.input_file,
        output_file=args.output_file,
        ffmpeg=args.ffmpeg,
        ffmpeg_encoder=args.ffmpeg_encoder,
        pix_fmt=args.pix_fmt,
        scale=args.scale,
        temp_dir=args.temp_dir,
        batch_size=args.batch_size,
        chips=args.chips,
        resume_processing=args.resume_processing,
        extract_only=args.extract_only,
        models=args.models,
        model_path=args.model_path,
        log_level=args.log_level,
        log_dir=args.log_dir,
        precision=args.precision,
        tile_size=args.tile_size,
        halo=args.halo,
        frames_per_step=args.frames_per_step,
        global_quality=args.global_quality,
        data_plane=args.data_plane,
        synthetic_models=args.synthetic_models,
        copy_audio=args.copy_audio,
        pipe_pix=args.pipe_pix,
        device=args.device,
        tta=args.tta,
        conv_impl=args.conv_impl,
        parallel_mode=args.parallel,
    )


if __name__ == "__main__":
    raise SystemExit(main())
