"""``vsr-finetune-torch``: fine-tune an SR model on a source video and
export ncnn ``.param``/``.bin`` files (the training plane lives in
train/finetune.py).

Same flags as ``vsr-finetune`` plus ``--device``.  Training runs the aten
route by design (autograd through ``F.conv2d``; no hand-written kernel has
a backward); the exported files serve through ``upscale-video-torch -m
sr=<stem>`` on the kernels.
"""

from __future__ import annotations

import argparse

from upscale_video_tpu_torch.cli.common import add_logging_args
from upscale_video_tpu_torch.cli.upscale_video import add_device_arg
from upscale_video_tpu_torch.train.finetune import finetune
from upscale_video_tpu_torch.utils.logsetup import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vsr-finetune-torch",
        description="Fine-tune an SR model on a video (self-supervised "
                    "HR->LR pairs) on an NVIDIA GPU and export ncnn files.  "
                    "Any loadable ncnn SR model trains — the Compact "
                    "family, the 'r'-family RRDBNets (pass -m valar -s 4), "
                    "and vsr-import-torch conversions (-m <their stem "
                    "suffix>): the trainer differentiates through the "
                    "generic graph walk.",
    )
    p.add_argument(
        "-i", "--input", required=True,
        help="Training source: video file (.y4m), PNG directory, or "
             "'synthetic' for generated pairs.",
    )
    p.add_argument(
        "-o", "--output_dir", required=True,
        help="Directory for the exported .param/.bin files.",
    )
    p.add_argument("-m", "--model", default="compact",
                   help="Model role or ncnn stem suffix (default compact).")
    p.add_argument("-s", "--scale", type=int, default=2, choices=[1, 2, 4])
    p.add_argument("--model_path", help="Directory holding the base model.")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--patch", type=int, default=64,
                   help="LR patch size (HR crop is patch*scale).")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument(
        "--mesh", dest="mesh_spec",
        help="Device mesh for the sharded train step, e.g. 'dp=2,sp=4' "
             "(default: single device; with --device cpu the entries are "
             "logical shards).",
    )
    p.add_argument("--ckpt_dir", help="Checkpoint directory (torch.save).")
    p.add_argument("--ckpt_every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="Restore the latest checkpoint in --ckpt_dir.")
    p.add_argument("--max_frames", type=int, default=64,
                   help="HR frames decoded from the source.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_models", action="store_true",
                   help="Train a synthesized model (tests/smoke).")
    p.add_argument("--export_stem",
                   help="File stem for the export (default "
                        "{scale}x_{model}_finetuned).")
    add_logging_args(p)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.resume and not args.ckpt_dir:
        build_parser().error("--resume requires --ckpt_dir")
    setup_logging(args.log_level, args.log_dir, args.input)
    finetune(
        data=args.input,
        output_dir=args.output_dir,
        model=args.model,
        scale=args.scale,
        model_path=args.model_path,
        steps=args.steps,
        batch=args.batch,
        patch=args.patch,
        learning_rate=args.learning_rate,
        mesh_spec=args.mesh_spec,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        max_frames=args.max_frames,
        seed=args.seed,
        synthetic_model=args.synthetic_models,
        export_stem=args.export_stem,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
