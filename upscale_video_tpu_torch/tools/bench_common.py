"""What the conv-body benches share: the arguments, timing, and the lines
they print."""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, Sequence

import torch

from upscale_video_tpu_torch.device import resolve_device


def parser(doc: str, impls: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--impls", default=impls)
    p.add_argument("--skip_parity", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; default) or cpu (their plain "
                        "versions: a smoke run, timings meaningless)")
    return p


def device_of(args) -> torch.device:
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[device] {name}", flush=True)
    return dev


def time_impls(fns: Dict[str, Callable[[], object]], reps: int,
               dev: torch.device) -> Dict[str, float]:
    """Median milliseconds per call of each function: two warm-up calls
    each, then ``reps`` rounds that run every impl once in turn (CUDA
    events on the card, the host clock on the CPU)."""
    for fn in fns.values():
        for _ in range(2):
            fn()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize(dev)
                times[k].append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                fn()
                times[k].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in times.items()}


def report(ms: Dict[str, float], frames: int, layers: int, flop: float,
           unit: str) -> None:
    """One line per impl, as the JAX tools print them: ms per body (one
    frame), ms per layer, and the direct-conv-equivalent rate."""
    for impl, t in ms.items():
        per = t / frames
        print(f"[{impl}] body {per:.3f} ms/frame, {per / layers:.3f} ms/layer, "
              f"{flop / t / 1e9:.1f} {unit}", flush=True)


def launches_line(counters: Sequence) -> None:
    """``[launches]``: each wrapper's launch count; then, for the wrappers
    that route some shapes to an sm90 kernel, ``[launches_sm90]``: how
    many of those launches went there."""
    print("[launches] " + " ".join(f"{fn.__name__}={fn.launches}"
                                   for fn in counters), flush=True)
    sm90 = [fn for fn in counters if hasattr(fn, "launches_sm90")]
    if sm90:
        print("[launches_sm90] " + " ".join(
            f"{fn.__name__}={fn.launches_sm90}" for fn in sm90), flush=True)


def parity_line(what: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float, dev: torch.device) -> bool:
    """Print the kernel-vs-plain line; True when every value is within
    ``atol + rtol * |want|``."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= atol + rtol * w.abs()).all())
    print(f"[parity] {what} on {dev.type}: maxabs={d.max().item():.6f} "
          f"mean={d.mean().item():.8f} bit-equal={(d == 0).float().mean().item():.4%} "
          f"differ={int((d > 0).sum().item())} bound=atol={atol},rtol={rtol} "
          f"ok={ok}", flush=True)
    return ok
