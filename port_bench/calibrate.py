"""Readings the output check's limits are set from, in one process.

    python -m port_bench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds a,b,c] [--path-control bf16 --path-seeds d,e,f] \\
        [--faults stale,half_batch,altered] [--seconds 2] \\
        [--out chiprun_out/calibrate_<name>.json]

For each of ``--seeds`` it runs the cell as ``run`` does (set-up, warm-up,
a window of ``--seconds`` at the cell's own sizes and load, the check) and
reads the program's ``rmse`` and ``block_rmse``; for each of
``--control-seeds`` also the control's, the reference in float8 put in the
program's place, on the same sampled frames; for each of ``--path-seeds``
the program itself with its configuration's precision replaced by
``--path-control`` (its own lower-precision path); for each of
``--faults`` the program with that fault planted (``faults.py``), on the
first seed.  Every reading's ``correct`` is the judgement ``Run.check``
makes, by the cell's limits.  The benchmark's own runs never run this.
Each reading is a line of JSON on standard output and all of them are
written to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

from port_bench import faults, spec


def with_precision(cell, precision: str):
    """``cell`` with its configuration's precision replaced."""
    return dataclasses.replace(cell, config=dict(cell.config,
                                                 precision=precision))


def reading(cell, seed: int, seconds: float, device: str, control: bool,
            fault: str = "") -> dict:
    from port_bench.harness import Run

    run = Run(cell, seed, seconds, False, device)
    ctx = faults.planted(fault, cell.traffic["gpus"]) if fault \
        else contextlib.nullcontext()
    try:
        run.setup()
        with ctx:
            run.warmup()
            run.window()
        run.release()
        run.check()
        out = {"workload": cell.name, "seed": seed, "fault": fault or None,
               "precision": cell.config["precision"],
               "frames": run.frames, "n_frames": run.n_frames,
               "sampled": len(run.sampled), "program": run.worst,
               "correct": run.correct, "setup_phases_s": run.phases}
        if control:
            failed, worst, _ = run.judge(
                run.numbers(run.reference_frames("fp8"), run.ref),
                run.n_frames)
            out["control"] = worst
            out["control_correct"] = failed == 0
        return out
    finally:
        run.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--path-control", default="bf16")
    ap.add_argument("--path-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    path = with_precision(cell, args.path_control)
    plan = [(cell, s, s in controls, "") for s in seeds]
    plan += [(cell, s, True, "") for s in sorted(controls - set(seeds))]
    plan += [(path, int(s), False, "") for s in args.path_seeds.split(",")
             if s]
    plan += [(cell, seeds[0], False, f) for f in args.faults.split(",") if f]
    rows = []
    for c, seed, control, fault in plan:
        row = reading(c, seed, args.seconds, args.device, control, fault)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
