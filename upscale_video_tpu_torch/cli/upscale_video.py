"""``upscale-video-torch``: the full-pipeline CLI on the PyTorch/CUDA port.

Same flags as ``upscale-video`` (the argparse option groups are
:mod:`upscale_video_tpu_torch.cli.common`, a copy of the JAX package's),
plus ``--device``.  Flags outside the ported slice raise
``NotImplementedError`` instead of silently doing something else.
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.common import (
    add_compute_args,
    add_io_args,
    add_logging_args,
    add_model_chain_args,
)
from upscale_video_tpu_torch.pipeline.chain import ChainSpec, parse_chips
from upscale_video_tpu_torch.pipeline.process import process_file


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
                   help="Exit after frame extraction (not ported yet).")
    add_logging_args(p)
    p.add_argument("--global_quality", type=int, default=20,
                   help="Encoder -global_quality.")
    p.add_argument("--data_plane", choices=["stream", "png"], default="stream",
                   help="stream (ported) or png (not ported yet).")
    p.add_argument(
        "--pipe_pix", choices=["auto", "rgb24", "yuv420p"], default="auto",
        help="Stream-plane device contract: yuv420p (4:2:0 in and out on "
             "the GPU) or rgb24 (shuffle-planar u8 out); auto picks yuv420p "
             "exactly when it is lossless for this run.",
    )
    p.add_argument("--copy_audio", action="store_true",
                   help="Mux the source's audio/subtitle streams into the "
                        "output. Needs -f.")
    p.add_argument("--trace_dir", help="Profiler trace (not ported yet).")
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default; the hand-written kernels) or cpu "
             "(their plain PyTorch versions). cuda without a GPU fails.",
    )
    return p


def check_slice(args) -> None:
    """Raise ``NotImplementedError`` for every flag outside the port: the
    ``-m`` chains of ``a``, ``n=K``, ``r`` and ``sr=<stem>`` at scales 1, 2
    and 4, with or without ``--tta``; ``--tile_size`` and ``--precision
    mixed`` for ``-m r`` and ``sr=`` only (an ``sr=`` SRVGG on K1 + K2
    refuses mixed when its model is planned); f32 on the CPU only;
    ``--conv_impl auto`` (or ``rdb``, what auto is for ``-m r``)."""
    bad = []
    real_life = tiled = False
    try:
        spec = ChainSpec.parse(args.models)
        real_life = spec.real_life
        tiled = spec.real_life or bool(spec.sr_file)
    except ValueError:
        bad.append(f"-m {args.models}")
    if args.tile_size not in (None, 0) and not tiled:
        bad.append(f"--tile_size {args.tile_size} without -m r or sr=")
    on_cpu = str(args.device).startswith("cpu")
    allowed = {"auto", "bf16"} | ({"mixed"} if tiled else set()) \
        | ({"f32"} if on_cpu else set())
    if args.precision not in allowed:
        bad.append(f"--precision {args.precision} on {args.device}"
                   + ("" if tiled else " without -m r or sr="))
    if args.conv_impl not in ("auto", "rdb") or (
            args.conv_impl == "rdb" and not real_life):
        bad.append(f"--conv_impl {args.conv_impl}")
    if len(parse_chips(args.chips)[0]) > 1:
        bad.append(f"-g {args.chips} (more than one GPU)")
    if args.parallel != "dp":
        bad.append(f"--parallel {args.parallel}")
    if args.trace_dir:
        bad.append("--trace_dir")
    if args.data_plane != "stream":
        bad.append(f"--data_plane {args.data_plane}")
    if args.extract_only:
        bad.append("--extract_only")
    if bad:
        raise NotImplementedError(
            "not ported to the PyTorch/CUDA package yet: " + ", ".join(bad))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.copy_audio and not args.ffmpeg:
        parser.error("--copy_audio requires -f/--ffmpeg")
    check_slice(args)
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
        models=args.models,
        model_path=args.model_path,
        log_level=args.log_level,
        log_dir=args.log_dir,
        precision=args.precision,
        tile_size=args.tile_size,
        halo=args.halo,
        frames_per_step=args.frames_per_step,
        global_quality=args.global_quality,
        synthetic_models=args.synthetic_models,
        copy_audio=args.copy_audio,
        pipe_pix=args.pipe_pix,
        device=args.device,
        tta=args.tta,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
