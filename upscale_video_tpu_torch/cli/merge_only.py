"""``merge-only``: split-machine stage 2 CLI (reference merge_only.py:150-185).

Fixes the reference's CLI bug of passing ``args.pix_fmt`` without defining
``-p`` (merge_only.py:181): the flag exists here.
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.common import add_io_args, add_logging_args
from upscale_video_tpu_torch.pipeline.workflows import merge_only


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="merge-only", description="Merge upscaled frames into a video",
    )
    p.add_argument("-o", "--output_dir", required=True, help="Output directory.")
    add_io_args(p)
    p.add_argument(
        "-e", "--ffmpeg_encoder", default="libx264",
        help="ffmpeg encoder for fragments.",
    )
    p.add_argument(
        "-p", "--pix_fmt", default="yuv420p",
        help="Pixel format for encoding.",
    )
    p.add_argument(
        "--global_quality", type=int, default=20,
        help="Encoder -global_quality (reference hardcoded 20).",
    )
    add_logging_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    merge_only(
        output_dir=args.output_dir,
        ffmpeg=args.ffmpeg,
        ffmpeg_encoder=args.ffmpeg_encoder,
        pix_fmt=args.pix_fmt,
        temp_dir=args.temp_dir,
        log_level=args.log_level,
        log_dir=args.log_dir,
        global_quality=args.global_quality,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
