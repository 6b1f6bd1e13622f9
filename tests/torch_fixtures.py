"""Fixtures the port's CPU test modules share.

``one_torch_thread`` (autouse; every module imports it): torch on one
thread.  The suite runs in several worker processes on one host's cores; with
torch's default of one thread per core in each, every parallel region of a
tiny test tensor waits on threads the other workers have preempted, and
a test that takes seconds alone takes minutes beside them.  The CPU tests'
tensors are small, so one thread each loses nothing.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def two_rrdbs(monkeypatch):
    """``--synthetic_models``' ``-m r`` stand-in at 2 RRDBs: the 23-RRDB
    one is too slow for the CPU suite."""
    from upscale_video_tpu_torch.pipeline import chain

    make = chain.make_synthetic_rrdb_model
    monkeypatch.setattr(chain, "make_synthetic_rrdb_model",
                        lambda **kw: make(**{**kw, "num_rrdb": 2}))
