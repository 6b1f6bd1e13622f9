"""``fix-frames-torch``: corrupted-frame repair on the port.

Same flags as ``fix-frames`` plus ``--device``; flags outside the port
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
from upscale_video_tpu_torch.pipeline.workflows import fix_frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fix-frames-torch",
        description="Repair corrupted frames in the temp store on an NVIDIA GPU",
    )
    p.add_argument("-i", "--input_file", required=True, help="Input file.")
    p.add_argument(
        "-b", "--bad_frames", required=True,
        help="Bad frame list like 1,3,5-7,10-12,15.",
    )
    add_io_args(p)
    add_model_chain_args(p)
    add_compute_args(p)
    add_logging_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_slice(args)
    fix_frames(
        input_file=args.input_file,
        bad_frames=args.bad_frames,
        ffmpeg=args.ffmpeg,
        scale=args.scale,
        temp_dir=args.temp_dir,
        chips=args.chips,
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
