"""``vsr-import-torch``: convert a torch ``.pth`` checkpoint to ncnn files.

Port of ``upscale_video_tpu/cli/import_model.py`` (``vsr-import``): the
same flags and output naming, through the port's importer, and the printed
command runs ``upscale-video-torch``; it imports SwinIR too, whose files
hold the port's ``WindowAttention`` layer, which only the port loads.  The
notes below are the original's.

The reference's upstream ecosystem distributes most checkpoints as torch
state_dicts; reference users need external converter tools to produce the
``.param``/``.bin`` pair the engine consumes (the files under the
reference's models/ dir are such conversions).  This tool imports
SRVGGNetCompact / RRDBNet checkpoints directly (models/torch_import.py)
and writes ncnn files loadable by BOTH this framework and the reference's
ncnn engine.  The emitted stem is ``{scale}{suffix}``, matching the
reference's ``str(scale) + model_file`` naming (upscale_processing.py:70),
so the printed ``-m`` suffix plugs straight into the upscale CLIs.
"""

from __future__ import annotations

import argparse
import os

from upscale_video_tpu_torch.utils.logsetup import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vsr-import-torch",
        description="Convert a torch .pth SR checkpoint to ncnn "
                    ".param/.bin files usable with -m",
    )
    p.add_argument("-i", "--input", required=True,
                   help="torch checkpoint (.pth): SRVGGNetCompact, basicsr "
                        "RRDBNet (incl. the pixel-unshuffle x2/x1 "
                        "variants), old-architecture ESRGAN "
                        "(model.1.sub.N.RDBx keys), or SwinIR "
                        "(3conv, nearest+conv: the real-world SR models).")
    p.add_argument("-o", "--output_dir", required=True,
                   help="Directory for the .param/.bin files.")
    p.add_argument("--stem", help="Output stem suffix (default: the input "
                                  "file name); files are written as "
                                  "{scale}{stem}.param/.bin.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(None, None, None)
    from upscale_video_tpu_torch.models.torch_import import import_torch_checkpoint

    model = import_torch_checkpoint(args.input)
    suffix = args.stem or "x_" + os.path.splitext(
        os.path.basename(args.input))[0]
    if not suffix.startswith("x_"):
        suffix = "x_" + suffix
    stem = f"{model.scale}{suffix}"
    path = model.save(args.output_dir, stem=stem)
    print(f"wrote {path}.param / {path}.bin")
    print(f"use with: upscale-video-torch --model_path {args.output_dir} "
          f"-m sr={suffix} -s {model.scale}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
