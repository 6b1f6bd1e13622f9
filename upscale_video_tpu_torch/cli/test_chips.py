"""``test-chips-torch``: calibration on one GPU (the port's ``test-chips``).

Same flags as ``test-chips`` plus ``--device``; ``-g`` over more than one
GPU raises ``NotImplementedError`` (:func:`~upscale_video_tpu_torch.cli.
upscale_video.check_slice`).
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.upscale_video import add_device_arg, check_slice
from upscale_video_tpu_torch.pipeline.calibrate import run_calibration
from upscale_video_tpu_torch.pipeline.chain import ChainSpec
from upscale_video_tpu_torch.utils.logsetup import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="test-chips-torch",
        description="Describe the GPU and calibrate batch depth and tiles",
    )
    p.add_argument(
        "-g", "--chips",
        help="Chips to test, e.g. 0,0,1 (repetition deepens the batch).",
    )
    p.add_argument("-s", "--scale", type=int, default=2, help="Scale 2 or 4.")
    p.add_argument("-r", "--runs", type=int, default=10, help="Timed runs per point.")
    p.add_argument(
        "-m", "--models", default=None,
        help="Chain DSL to calibrate (e.g. 'r'; default 2x Compact). "
             "'-m r' also sweeps tile geometry.",
    )
    p.add_argument(
        "--batch_depths", default=None,
        help="Comma-separated frames-per-step candidates "
             "(default 1,2,4,8; 1,2 for '-m r').",
    )
    p.add_argument(
        "--tiles", default=None,
        help="Comma-separated --tile_size specs to sweep (auto / budget "
             "int / HxW).  Default: product tile only; for '-m r' "
             "auto,480,544x480.",
    )
    p.add_argument("--height", type=int, default=None,
                   help="Calibration frame height (default 540; 1080 for "
                        "'-m r').")
    p.add_argument("--width", type=int, default=None,
                   help="Calibration frame width (default 960; 1920 for "
                        "'-m r').")
    p.add_argument("--model_path")
    p.add_argument("--synthetic_models", action="store_true")
    p.add_argument("--precision",
                   choices=["auto", "bf16", "mixed", "f32"],
                   default="auto",
                   help="auto = the product per-family policy (mixed for "
                        "-m r, bf16 otherwise)")
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_slice(args)
    setup_logging(None, None, None)
    valar = ChainSpec.parse(args.models).real_life
    depths = args.batch_depths or ("1,2" if valar else "1,2,4,8")
    run_calibration(
        chips=args.chips,
        scale=args.scale,
        runs=args.runs,
        batch_depths=[int(x) for x in depths.split(",")],
        height=args.height or (1080 if valar else 540),
        width=args.width or (1920 if valar else 960),
        model_path=args.model_path,
        synthetic_models=args.synthetic_models,
        precision=args.precision,
        models=args.models,
        tiles=(None if args.tiles is None
               else [t.strip() for t in args.tiles.split(",")]),
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
