"""``upscale-only-torch``: split-machine stage 1 on the port.

Same flags as ``upscale-only`` plus ``--device``; flags outside the port
raise ``NotImplementedError`` (:func:`~upscale_video_tpu_torch.cli.
upscale_video.check_slice`).
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.common import (
    add_compute_args,
    add_io_args,
    add_logging_args,
    add_model_chain_args,
)
from upscale_video_tpu_torch.cli.upscale_video import add_device_arg, check_slice
from upscale_video_tpu_torch.pipeline.workflows import upscale_only


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="upscale-only-torch",
        description="Upscale frames only (zip hand-off, no video encode) on "
                    "an NVIDIA GPU",
    )
    p.add_argument("-i", "--input_file", required=True, help="Input file.")
    add_io_args(p)
    add_model_chain_args(p)
    p.add_argument(
        "-b", "--batch_size", type=int, default=10,
        help="Minutes per zip batch (negative = split into |b| parts).",
    )
    add_compute_args(p)
    p.add_argument(
        "-u", "--upscale_dir",
        help="Shared directory for {batch}.zip hand-off (default temp_dir).",
    )
    p.add_argument(
        "-x", "--extract_only", action="store_true",
        help="Exit after frame extraction.",
    )
    add_logging_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_slice(args)
    upscale_only(
        input_file=args.input_file,
        ffmpeg=args.ffmpeg,
        scale=args.scale,
        temp_dir=args.temp_dir,
        batch_size=args.batch_size,
        chips=args.chips,
        upscale_dir=args.upscale_dir,
        extract_only=args.extract_only,
        models=args.models,
        log_level=args.log_level,
        log_dir=args.log_dir,
        model_path=args.model_path,
        precision=args.precision,
        tile_size=args.tile_size,
        halo=args.halo,
        frames_per_step=args.frames_per_step,
        synthetic_models=args.synthetic_models,
        tta=args.tta,
        device=args.device,
        conv_impl=args.conv_impl,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
