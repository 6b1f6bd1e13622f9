"""Multi-host start-up of the port (the counterpart of tests/test_multihost.py
and tests/test_parallel.py ``TestMultihostInit``).

``initialize_multihost`` does nothing without a multi-host environment,
joins ``torch.distributed`` through the JAX package's explicit contract
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID`` ->
``tcp://``) or torchrun's (``env://``, for the pod branch), and two real
CPU processes then run an all-reduce that crosses them (gloo) and each
lists its devices with its process index.  Every subprocess call has its
own timeout, so a hung rendezvous fails the test instead of the suite.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from upscale_video_tpu_torch.parallel import mesh
from tests.torch_fixtures import one_torch_thread  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
            "MEGASCALE_COORDINATOR_ADDRESS")


@pytest.fixture
def no_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(calls))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    return calls


def test_noop_without_env(no_env):
    assert mesh.initialize_multihost() == 1  # a single process
    assert no_env == []


def test_initializes_with_coordinator(no_env, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert mesh.initialize_multihost("gloo") == 4
    assert no_env == [(("gloo",), dict(init_method="tcp://10.0.0.1:8476",
                                       world_size=4, rank=2))]
    # a second call finds the group and joins nothing more
    assert mesh.initialize_multihost("gloo") == 4 and len(no_env) == 1


def test_pod_branch_takes_torchrun_s_contract(no_env, monkeypatch):
    monkeypatch.setenv("MEGASCALE_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    assert mesh.initialize_multihost("nccl") == 4
    assert no_env == [(("nccl",), dict(init_method="env://"))]


WORKER = """
import sys

import torch
import torch.distributed as dist

from upscale_video_tpu_torch.parallel.mesh import (
    describe_devices, initialize_multihost,
)

n = initialize_multihost("gloo")
assert n == 2, f"expected 2 processes, got {n}"
rank = dist.get_rank()
# each process contributes its own value: process_id + 1
t = torch.full((4,), float(rank + 1))
dist.all_reduce(t)
assert t.tolist() == [3.0] * 4, t  # the reduction crossed the processes
inv = describe_devices("cpu")
assert len(inv) == 1 and ((f"(process {rank})" in inv[0]) == (rank > 0)), inv
assert not any(m == "jax" or m.startswith(("jax.", "upscale_video_tpu."))
               for m in sys.modules)
dist.destroy_process_group()
print(f"MHOK {rank} {inv[0]}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_group(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               NUM_PROCESSES="2", OMP_NUM_THREADS="1")
    env.pop("MEGASCALE_COORDINATOR_ADDRESS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [
        subprocess.Popen([sys.executable, str(worker)],
                         env=dict(env, PROCESS_ID=str(i)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=str(tmp_path))
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
    assert "MHOK 0 chip 0: cpu" in outs[0], outs[0]
    assert "MHOK 1 chip 0: cpu (the plain PyTorch versions) (process 1)" \
        in outs[1], outs[1]
