"""Logging configuration matching the reference's observability surface.

Reference: timestamped stdout logging plus an optional per-video DEBUG file
handler named after the input (upscale/upscale_processing.py:794-807).
The worker->parent log-relay bus (:40-51) is unnecessary here — there are
no worker processes; stages log directly.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

FORMAT = "[%(asctime)s] [%(levelname)s] %(message)s"
DATEFMT = "%Y-%m-%d %H:%M:%S"


def setup_logging(
    log_level: Optional[int] = None,
    log_dir: Optional[str] = None,
    input_name: Optional[str] = None,
    stream=None,
) -> None:
    """``stream``: console destination (default stdout, reference parity);
    machine-output CLIs (vsr-compare --json) pass sys.stderr so stdout
    stays parseable."""
    logging.basicConfig(
        level=log_level or logging.INFO,
        format=FORMAT,
        datefmt=DATEFMT,
        stream=stream or sys.stdout,
        force=True,
    )
    if log_dir and input_name:
        os.makedirs(log_dir, exist_ok=True)  # reference crashes on a
        # missing -d dir (FileHandler at upscale_processing.py:801-807)
        base = os.path.basename(input_name)
        stem = base.rsplit(".", 1)[0] if "." in base else base
        fh = logging.FileHandler(os.path.join(log_dir, stem + ".log"))
        fh.setFormatter(logging.Formatter(FORMAT))
        fh.setLevel(logging.DEBUG)
        root = logging.getLogger()
        root.addHandler(fh)
        # the per-video file really captures DEBUG (the reference's
        # identical setLevel was dead code: its root logger filtered at
        # INFO before any handler saw the record, upscale_processing.py:
        # 790-807) — console handlers keep the requested console level
        console_level = log_level or logging.INFO
        for h in root.handlers:
            if h is not fh and h.level < console_level:
                h.setLevel(console_level)
        root.setLevel(min(logging.DEBUG, root.level))
        # a DEBUG root would also unmute third-party debug firehoses
        # (jax logs through its own handlers, bypassing ours)
        if (log_level or logging.INFO) > logging.DEBUG:
            logging.getLogger("jax").setLevel(logging.INFO)
