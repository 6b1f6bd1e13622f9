"""Shared argparse option groups for the CLI tools."""

from __future__ import annotations

import argparse


def tile_spec(s: str):
    """Parse a ``--tile_size`` value: a bare int is a geometry-fit BUDGET
    (ops/tiling.fit_tile_grid, 0 = whole frame); ``HxW`` forces an exact
    interior tile pair (ChainEngine honors tuples verbatim); ``auto``
    (the default) applies the per-family measured policy
    (pipeline/chain.default_tile)."""
    if s.strip().lower() == "auto":
        return None
    if "x" in s:
        try:
            h, w = (int(v) for v in s.split("x"))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{s!r} is not BUDGET or HxW (e.g. 480 or 544x480)"
            ) from None
        if h < 8 or w < 8:
            raise argparse.ArgumentTypeError(
                f"tile pair {s!r} must be at least 8x8")
        return (h, w)
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{s!r} is not BUDGET or HxW (e.g. 480 or 544x480)"
        ) from None


def add_model_chain_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "-m", "--models",
        help="Additional processing: 'a' for anime deblur, 'n={level}' for "
             "denoise (1-30), 'r' for real-life 4x model. Example: -m a,n=3,r. "
             "Also 'sr={stem}' to use a custom SR model file "
             "{scale}{stem}.param/.bin (e.g. from vsr-import).",
    )
    p.add_argument(
        "-s", "--scale", type=int, default=2,
        help="Scale 1, 2 or 4 (default 2; 'r' forces 4).",
    )
    p.add_argument(
        "--model_path",
        help="Directory with ncnn .param/.bin model files "
             "(default: $UPSCALE_TPU_MODEL_PATH or ./models).",
    )
    p.add_argument(
        "--synthetic_models", action="store_true",
        help="Use random-weight stand-in models (benchmarks/tests).",
    )


def add_compute_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "-g", "--chips",
        help="TPU chips to use, e.g. 0,1 (repetition deepens the per-chip "
             "frame batch, like the reference's workers-per-GPU).",
    )
    p.add_argument(
        "--precision", choices=["auto", "bf16", "mixed", "f32"],
        default="auto",
        help="auto (default) = per-family policy: mixed for -m r, bf16 "
             "otherwise; bf16 = fast MXU path; mixed = bf16 convs with "
             "the residual spine in f32 (+3.3..4.6 dB on the deep "
             "RRDBNet for a measured 1.8%% fps cost); f32 = max quality "
             "(5.3x on Valar).",
    )
    p.add_argument(
        "--tile_size", type=tile_spec, default=None,
        help="Spatial tile budget for HBM-bounded frames.  Default "
             "'auto': whole frame for the Compact family, the measured "
             "tile for -m r (whole-frame Valar overflows HBM at 1080p; "
             "the reference hardcoded 960 for everything).  0 forces "
             "whole-frame.  Tiles are geometry-fit: the budget sets the "
             "grid, each tile shrinks to just cover the frame "
             "(ops/tiling.fit_tile_grid).  An explicit HxW pair (e.g. "
             "544x480) forces that interior tile shape instead — "
             "kernel-geometry winners from tools/valar_tile_ab.py ship "
             "as pairs.",
    )
    p.add_argument(
        "--halo", type=int, default=16,
        help="Tile context border in pixels (the reference hardcoded 10).",
    )
    p.add_argument(
        "--frames_per_step", type=int, default=None,
        help="Frames per device step (on-chip batch).  Default: per-"
             "family policy — 4 for the Compact family (measured-best "
             "depth), 1 for -m r (program size scales with depth on the "
             "fused-RDB path; depth adds no throughput there).",
    )
    p.add_argument(
        "--parallel", choices=["dp", "sp", "tp"], default="dp",
        help="Multi-chip mode for -g: dp = frames across chips "
             "(throughput), sp = each frame's rows across chips (latency), "
             "tp = conv channels across chips (latency; per-layer ICI "
             "collectives — only wins on channel-heavy models like Valar).",
    )
    p.add_argument(
        "--tta", action="store_true",
        help="x8 self-ensemble: average the SR stage over the 8 dihedral "
             "transforms of each frame (quality knob, ~8x the SR compute; "
             "beyond the reference and its upstream runner).",
    )
    p.add_argument(
        "--conv_impl", choices=["auto", "xla", "pallas", "rdb"], default="auto",
        help="Convolution backend. auto (default) = XLA conv fusions for "
             "the Compact family + the fused residual-dense-block kernel "
             "for -m r (1.36x over the XLA dense-scatter rewrite, "
             "hardware-bit-exact); xla = pure-XLA everywhere; "
             "pallas/rdb = explicit kernel choices.",
    )


def add_io_args(p: argparse.ArgumentParser, ffmpeg_required: bool = False) -> None:
    p.add_argument(
        "-f", "--ffmpeg", required=ffmpeg_required,
        help="Location of ffmpeg (optional: without it, .y4m files and PNG "
             "directories are handled natively).",
    )
    p.add_argument(
        "-t", "--temp_dir",
        help="Temp directory (default tempfile.gettempdir()).",
    )


def add_logging_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-l", "--log_level", type=int,
                   help="Logging level (default logging.INFO).")
    p.add_argument("-d", "--log_dir", help="Directory for per-video log files.")
