"""``vsr-compare``: frame-wise PSNR between two videos / frame stores.

The measurable quality gate for the BASELINE.md <=1e-2 PSNR budget; the
reference had no comparison tooling (verification was eyeballing
test_images.py outputs, README:65-78).
"""

from __future__ import annotations

import argparse
import math
import json

from upscale_video_tpu_torch.pipeline.quality import compare_sources
from upscale_video_tpu_torch.utils.logsetup import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vsr-compare", description="Frame-wise PSNR between two videos",
    )
    p.add_argument("-a", "--reference", required=True,
                   help="Reference video (.y4m) or PNG directory.")
    p.add_argument("-b", "--candidate", required=True,
                   help="Candidate video (.y4m) or PNG directory.")
    p.add_argument("-n", "--max_frames", type=int,
                   help="Compare at most N frames.")
    p.add_argument("--json", action="store_true",
                   help="Print one JSON line instead of prose.")
    p.add_argument("--min_psnr", type=float,
                   help="Exit nonzero if any frame falls below this dB.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import sys

    # --json: keep stdout machine-parseable (logs go to stderr)
    setup_logging(None, None, None,
                  stream=sys.stderr if args.json else None)
    stats = compare_sources(args.reference, args.candidate,
                            max_frames=args.max_frames)
    if args.json:
        # identical frames have PSNR inf; bare Infinity is not valid
        # RFC 8259 JSON (jq and most non-Python parsers reject it)
        _num = lambda v: round(v, 4) if math.isfinite(v) else None  # noqa: E731
        print(json.dumps({
            "frames": stats.frames,
            "mean_psnr_db": _num(stats.mean_psnr),
            "min_psnr_db": _num(stats.min_psnr),
            "identical": not math.isfinite(stats.min_psnr),
            "min_frame": stats.min_frame,
        }))
    else:
        print(stats)
    if args.min_psnr is not None and stats.min_psnr < args.min_psnr:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
