"""The harness end to end on the CPU at tiny sizes: the work counts, the
reference against the port's stream loop, the control and planted faults
failing the check, the imports, and the refusal to run without a GPU."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import check, spec
from port_bench.flops import conv_launch_bound_s, graph_conv_flops
from port_bench.tests.tiny import run_cell, tiny_cell, threads

ROOT = str(spec.ROOT)


def _cfg(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_frozen_flop_counts_match_the_published_figures():
    from port_bench.models import rrdb, srvgg

    compact = 4 * graph_conv_flops(srvgg.layers(_cfg("compact2x")), 1080, 1920)
    valar = graph_conv_flops(rrdb.layers(_cfg("valar4x")), 1080, 1920)
    assert round(compact / 1e12, 2) == 9.93
    assert round(valar / 1e12, 2) == 74.93


def test_kernel_work_counts_match_a_hand_count():
    from port_bench.models import rrdb, srvgg

    cfg = _cfg("compact2x")
    layers = {layer.name: layer for layer in srvgg.layers(cfg)}
    assert srvgg.k1_layers(cfg) == [f"conv_{i}" for i in range(17)]
    assert layers["conv_0"].attr(6) == 64 * 3 * 9
    # one 64->64 layer over 2 frames of 4x6: 2*9*64*64*48 FLOPs, and
    # 2*(48*128 + 9*64*64) bytes; FLOPs bound it
    flops, nbytes = 2 * 9 * 64 * 64 * 48, 2 * (48 * 128 + 9 * 64 * 64)
    assert conv_launch_bound_s(2, 4, 6, 64, 64, 3) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    vcfg = _cfg("valar4x")
    per_px = sum(2 * k * k * cin * cout
                 for cin, cout, k in rrdb.dense_block_convs(vcfg))
    assert per_px == 2 * 9 * 32 * (64 + 96 + 128 + 160) + 2 * 64 * 32 \
        + 2 * 9 * 192 * 64
    assert rrdb.dense_blocks(vcfg) == 69
    # a block over 8 tiles of 576x512 is operations-bound at 1.153 ms
    assert per_px * 8 * 576 * 512 / 989e12 == pytest.approx(1.153e-3, rel=1e-3)


def test_seeded_weights_follow_each_configurations_rules():
    from port_bench import ncnn
    from port_bench.models import rrdb, srvgg

    cfg = _cfg("compact2x")
    w = ncnn.seeded_weights(srvgg.layers(cfg), 11, "cpu", cfg["init"])
    assert float(w["conv_8"]["weight"].std()) == pytest.approx(0.05, rel=0.05)
    assert float(w["conv_8"]["bias"].abs().max()) > 0
    cfg = _cfg("valar4x")
    w = ncnn.seeded_weights(rrdb.layers(cfg), 11, "cpu", cfg["init"])
    dense = w["r3d1_c9"]["weight"]  # 3x3 over 64 + 2*32 channels
    assert float(dense.std()) == pytest.approx(0.141421 / math.sqrt(128 * 9),
                                               rel=0.05)
    assert float(w["r3d1_c9"]["bias"].abs().max()) == 0.0
    trunk = w["conv_trunk"]["weight"]
    assert float(trunk.std()) == pytest.approx(0.57735 / math.sqrt(64 * 9),
                                               rel=0.05)
    assert float(trunk.mean(dim=(1, 2, 3)).abs().max()) < 1e-5
    assert torch.equal(w["conv_last"]["bias"], torch.full((3,), 0.5))
    assert ncnn.seeded_weights(rrdb.layers(cfg), 11, "cpu", cfg["init"])[
        "conv_hr"]["weight"].equal(w["conv_hr"]["weight"])


def test_sample_covers_every_batch_position_and_the_last_frame():
    idx = check.sample(400, 4, 16, 2 ** 40 + 1)
    assert len(idx) == 17 and idx[-1] == 399
    assert {i % 4 for i in idx} == {0, 1, 2, 3}
    assert idx == check.sample(400, 4, 16, 2 ** 40 + 1)
    # however few frames the reference has time for, every batch slot
    count = check.n_check(8 * 2.48e12, 4)
    assert count == 4
    assert {i % 4 for i in check.sample(220, 4, count, 7)[:-1]} == \
        {0, 1, 2, 3}


VALAR = {"height": 24, "width": 40}
# the Valar cell under -g 0,1,2,3 --parallel dp (no cell of the benchmark
# yet; the harness runs it all the same)
VALAR_DP4 = dict(VALAR, gpus=4)


@pytest.mark.parametrize("workload,traffic", [
    ("compact2x-1080p-i420-tta", {}),
    ("compact2x-1080p-i420-tta", {"tta": False}),
    ("compact2x-1080p-i420-tta", {"contract": "rgb24", "tta": False,
                                  "source_pix_fmt": "rgb24",
                                  "encode_pix_fmt": "rgb24"}),
    ("valar4x-1080p-i420", VALAR),
    ("valar4x-1080p-i420", VALAR_DP4),
])
def test_reference_agrees_with_the_ports_stream_loop(workload, traffic):
    cell = tiny_cell(workload, **traffic)
    run = run_cell(cell, 2 ** 35 + 17)
    assert run.frames == run.n_frames > 0
    assert run.backend.yuv420_out == (cell.traffic["contract"] == "i420")
    assert run.correct, run.checks
    assert run.stage["infer"] > 0


@pytest.mark.parametrize("workload,traffic", [
    ("compact2x-1080p-i420-tta", {}),
    ("valar4x-1080p-i420", VALAR),
])
def test_control_in_float8_fails_the_limits(workload, traffic):
    cell = tiny_cell(workload, **traffic)
    run = run_cell(cell, 5)
    with threads():
        failed, ctl, _ = run.judge(
            run.numbers(run.reference_frames("fp8"), run.ref), run.n_frames)
    assert failed > 0, ctl


@pytest.mark.parametrize("workload,fault", [
    ("compact2x-1080p-i420-tta", "stale"),
    ("compact2x-1080p-i420-tta", "half_batch"),
    ("compact2x-1080p-i420-tta", "altered"),
    ("valar4x-1080p-i420", "stale"),
    ("valar4x-1080p-i420", "altered"),
    ("valar4x-1080p-i420", "exchange"),
])
def test_planted_fault_makes_correct_false(workload, fault):
    from port_bench import calibrate

    traffic = {} if workload.startswith("compact") else \
        VALAR_DP4 if fault == "exchange" else VALAR
    cell = tiny_cell(workload, **traffic)
    with threads():
        row = calibrate.reading(cell, 9, 0.3, "cpu", False, fault)
    assert row["correct"] is False, row


def test_traced_window_reads_the_trace():
    run = run_cell(tiny_cell("compact2x-1080p-i420-tta"), 3, trace=True)
    assert run.trace is not None and run.trace.window_s > 0
    cell = run.cell
    assert cell.readers["loop_infer_share"].read(run) > 0
    assert cell.readers["mfu"].read(run) > 0
    # no kernel ran on the CPU: the kernel metrics find nothing to read
    assert cell.readers["k1_roofline"].read(run) is None
    assert cell.readers["glue_share"].read(run) is None


def _py(code: str, cwd: str = ROOT, **env):
    e = dict(os.environ, **env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port():
    code = """
import sys, torch
torch.set_num_threads(2)
from port_bench import reference, run
from port_bench.models import rrdb, srvgg
assert not [m for m in sys.modules if m.split(".")[0] == "upscale_video_tpu_torch"]
from port_bench.tests.tiny import run_cell, tiny_cell
r = run_cell(tiny_cell("compact2x-1080p-i420-tta"), 1)
assert r.correct
tops = {m.split(".")[0] for m in sys.modules}
assert "upscale_video_tpu_torch" in tops
print(sorted(tops & {"jax", "jaxlib", "flax", "upscale_video_tpu"}))
"""
    out = _py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_nonzero_without_a_gpu():
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "compact2x-1080p-i420-tta", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "valar4x-1080p-i420", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_short_run_on_the_gpu_is_correct(gpu):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "compact2x-1080p-i420-tta", "--seed", str(2 ** 33 + 5), "--seconds",
         "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert math.isfinite(res["metrics"]["fps"]["value"])
