"""BENCHMARK.json against the contract, and cells found by name alone."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from port_bench import spec

BENCH = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_and_units_use_allowed_characters(group, entry):
    assert spec.NAME_RE.fullmatch(entry["name"])
    if "unit" in entry:
        assert spec.UNIT_RE.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert spec.NAME_RE.fullmatch(entry[key])
    for k in entry.get("reduced", []):
        assert spec.NAME_RE.fullmatch(k)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_four_chip_cells():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(workload):
    cell = spec.cell(BENCH, workload)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    from port_bench.check import NUMBERS

    assert "rmse" in cell.limits
    assert all(cell.limits[k]["limit"] > 0 for k in NUMBERS if k in cell.limits)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        reader = cell.readers[m["name"]]
        assert callable(reader.read)
    for m in cell.per_layer:
        assert cell.readers[m["name"]].LAYER == m["layer"]
        assert cell.readers[m["name"]].MOVES == m["moves"]
        assert m["moves"] in e2e


def test_configs_files_lie_under_paths_and_list_reductions():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def _tree_hash(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_are_only_new_files(tmp_path):
    """A later change adds a cell as new files and new entries: nothing
    already there is edited, and the harness finds them by name."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    before = _tree_hash(tmp_path / "port_bench")
    b = tmp_path / "port_bench"

    cfg = json.loads((b / "configs" / "compact2x.json").read_text())
    cfg.update(name="compact4x", upscale=4, model_file="x_Compact_Pretrain")
    (b / "configs" / "compact4x.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "1080p-i420.json").read_text())
    tr.update(name="576p-i420", height=576, width=720)
    (b / "traffic" / "576p-i420.json").write_text(json.dumps(tr))
    (b / "limits" / "compact4x-576p-i420.json").write_text(
        (b / "limits" / "compact2x-1080p-i420-tta.json").read_text())
    (b / "metrics" / "frames_done.py").write_text(
        'LAYER = "stream loop"\nMOVES = "fps"\n\n\n'
        'def read(run):\n    return float(run.frames)\n')

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "compact4x", "source": "https://x.org",
                             "file": "port_bench/configs/compact4x.json",
                             "reduced": []})
    bench["workloads"].append({"name": "compact4x-576p-i420",
                               "config": "compact4x", "traffic": "576p-i420",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "frames_done", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "stream loop", "moves": "fps",
                               "workloads": ["compact4x-576p-i420"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell(spec.load_benchmark(tmp_path), "compact4x-576p-i420",
                     root=tmp_path)
    assert cell.config["upscale"] == 4 and cell.traffic["height"] == 576
    assert "frames_done" in cell.readers

    class _Run:
        frames = 7

    assert cell.readers["frames_done"].read(_Run()) == 7.0
    after = _tree_hash(tmp_path / "port_bench")
    assert all(after[k] == v for k, v in before.items())
