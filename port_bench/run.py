"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's GPUs.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (the window under ``torch.profiler``).
The last line of standard output is one JSON object; the numbers the
output check compared, each beside its limit, are the last lines of
standard error and the result's last key, ``checks``.  Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits with 2; if JAX or the JAX package is loaded once the window has
closed, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from port_bench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "upscale_video_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (the port's own name starts with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def fixed_caches() -> None:
    """Keep build and kernel caches at fixed paths inside the checkout."""
    base = spec.ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def power_limit() -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def metrics(run, entries) -> dict:
    out = {}
    for m in entries:
        v = run.cell.readers[m["name"]].read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(run, smi: list) -> dict:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.gpus, "memory_peak_bytes": run.peak_bytes,
              "power": smi}
    res = {"correct": run.correct, "attempted": run.n_frames,
           "failed": run.failed}
    if run.traced:
        tr = run.trace
        devs = list(range(run.gpus))
        device["busy_s"] = sum(tr.busy_s(d) for d in devs) / len(devs)
        device["window_s"] = tr.window_s
        res["metrics"] = metrics(run, run.cell.per_layer)
        res["breakdown"] = tr.breakdown(devs)
    else:
        res["metrics"] = metrics(run, run.cell.end_to_end)
    res["loop"] = {"frames_per_step": run.frames_per_step,
                   "pipe_pix": run.pipe_pix, "warm_rate": run.warm_rate,
                   "stage_s": run.stage}
    res["setup_phases_s"] = run.phases
    res["written_bytes"] = {"model_files": run.model_bytes,
                            "trace": run.trace.nbytes if run.traced else 0}
    res["device"] = device
    res["checks"] = run.checks
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches()
    cell = spec.cell(spec.load_benchmark(), args.workload)
    marks = {}
    import torch

    marks["torch_import"] = time.perf_counter() - T_START
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs on GPUs only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    marks["cuda_query"] = time.perf_counter() - T_START
    from port_bench.harness import Run

    marks["harness_import"] = time.perf_counter() - T_START
    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    run.phases.update(marks)
    try:
        run.setup()
        run.warmup()
        run.window()
        found = forbidden_modules()
        if found:
            print(f"port_bench: loaded after the window: {', '.join(found)}",
                  file=sys.stderr)
            return 3
        run.release()
        run.check()
        res = result(run, power_limit())
    finally:
        run.close()
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded by the end of the run: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
