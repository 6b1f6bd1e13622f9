"""``BENCHMARK.json`` and the files its names point at.

A cell (one entry of ``workloads``) is resolved by name alone: its
configuration's ``file``, ``traffic/<traffic>.json``, ``limits/<workload>
.json``, ``models/<family>.py`` and ``metrics/<metric>.py`` for each metric
that applies to it.  Nothing here knows any one cell.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str) -> ModuleType:
    """The Python file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    family: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]


def cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` with every file it names loaded
    from ``root``."""
    root = Path(root)
    bench_dir = root / bench["paths"][0]
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / conf["file"])
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    if traffic["gpus"] != entry["chips"]:
        raise ValueError(f"{workload}: traffic {entry['traffic']} runs on "
                         f"{traffic['gpus']} GPUs, the cell asks for "
                         f"{entry['chips']}")
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                      "metric")
               for m in e2e + per_layer}
    return Cell(
        name=workload, chips=entry["chips"], config=config, traffic=traffic,
        limits=_json(bench_dir / "limits" / f"{workload}.json"),
        family=load_module(bench_dir / "models" / f"{config['family']}.py",
                           "family"),
        end_to_end=e2e, per_layer=per_layer, readers=readers)
