"""``test-images-torch``: parameter sampling on the port.

Same flags as ``test-images`` plus ``--device``; flags outside the port
raise ``NotImplementedError`` (:func:`~upscale_video_tpu_torch.cli.
upscale_video.check_slice`).  Workflow: run ``upscale-video-torch -x -r``
to extract frames, sample candidate chains here, eyeball the outputs,
then resume the full run with the chosen ``-m`` options.
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.common import add_compute_args, add_model_chain_args
from upscale_video_tpu_torch.cli.upscale_video import add_device_arg, check_slice
from upscale_video_tpu_torch.pipeline.workflows import process_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="test-images-torch",
        description="Sample denoise levels / model chains on an NVIDIA GPU",
    )
    p.add_argument(
        "-i", "--input_frames", required=True,
        help="Frame list like 1,3,5-7,10-12,15 (must be extracted already).",
    )
    p.add_argument(
        "-t", "--temp_dir",
        help="Temp directory holding extracted frames.",
    )
    p.add_argument(
        "-o", "--output_dir", required=True,
        help="Directory for the sampled outputs.",
    )
    add_model_chain_args(p)
    add_compute_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_slice(args)
    process_image(
        input_frames=args.input_frames,
        temp_dir=args.temp_dir,
        output_dir=args.output_dir,
        scale=args.scale,
        models=args.models,
        chips=args.chips,
        model_path=args.model_path,
        precision=args.precision,
        tile_size=args.tile_size,
        halo=args.halo,
        frames_per_step=args.frames_per_step,
        synthetic_models=args.synthetic_models,
        tta=args.tta,
        device=args.device,
        conv_impl=args.conv_impl,
        parallel_mode=args.parallel,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
