"""Data parallelism: frame batches split across the GPUs of a mesh.

Port of ``upscale_video_tpu/parallel/data.py``.  The reference's primary
axis (SURVEY.md §2.4): one worker per GPU slot.  Here one replica of the
step runs on each distinct device of the ``dp`` axis, with its own weights
(the caller's ``step_of_device`` builds it there), and the host batch is
split into equal shards, one per mesh entry.

Dispatch is single-threaded and asynchronous: each shard is uploaded with
a non-blocking copy and its step launched on its device's current stream,
under that device, and only then does any shard's result come back, each
into its slice of one pinned host tensor.  Python queues every device's
work before it waits on any of them (:meth:`ShardedStep.launch` returns
the events to wait on; calling the step waits on them itself).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

import numpy as np
import torch

from upscale_video_tpu_torch.parallel.mesh import Mesh


def on_device(device: torch.device):
    """The context a launch for ``device`` runs in: that CUDA device is
    current (the kernels read the current device for their set-up); a no-op
    on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def as_batch(batch) -> torch.Tensor:
    """A host (or device) batch as a tensor: numpy arrays are wrapped."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch))
    return batch


def host_tensor(shape, dtype, pinned: bool) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=pinned)


def record_done(device: torch.device) -> "torch.cuda.Event | None":
    """An event on ``device``'s current stream after the work queued so
    far (None on the CPU, whose work is done when queued)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def run_to_host(step: Callable, x: torch.Tensor, device: torch.device):
    """``step`` on ``device`` over the host batch ``x`` (a non-blocking
    upload): its output in a host tensor (pinned for a GPU) and the events
    after which it has landed."""
    with on_device(device):
        y = step(x.to(device, non_blocking=True))
        host = host_tensor(y.shape, y.dtype, device.type == "cuda")
        host.copy_(y, non_blocking=True)
        ev = record_done(device)
    return host, [ev] if ev is not None else []


class ShardedStep:
    """A step spread over a mesh: a host batch in, one host tensor out.

    :meth:`launch` queues the work and returns ``(host, events)``: the
    output tensor (pinned where a GPU writes it) and the events after which
    its bytes have landed.  Calling the step waits on those events."""

    def launch(self, batch) -> Tuple[torch.Tensor, List[torch.cuda.Event]]:
        raise NotImplementedError

    def __call__(self, batch) -> torch.Tensor:
        host, events = self.launch(batch)
        for ev in events:
            ev.synchronize()
        return host


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "dp"
                ) -> List[torch.Tensor]:
    """Split ``(N, ...)`` into one shard per entry of ``axis`` (N % axis
    size == 0), each uploaded with a non-blocking copy to its device."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {axis}={n}")
    k = x.shape[0] // n
    out = []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        with on_device(dev):
            out.append(x[i * k:(i + 1) * k].to(dev, non_blocking=True))
    return out


class DataParallelStep(ShardedStep):
    """:func:`data_parallel_fn`'s step."""

    def __init__(self, step_of_device: Callable, mesh: Mesh, axis: str):
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        # one replica per distinct device, made here (weights, packed images)
        self.steps = {d: step_of_device(d) for d in dict.fromkeys(self.devices)}

    def launch(self, batch):
        x = as_batch(batch)
        k = x.shape[0] // len(self.devices)
        outs = []
        for dev, xs in zip(self.devices, shard_batch(x, self.mesh, self.axis)):
            with on_device(dev):
                outs.append(self.steps[dev](xs))
        pinned = any(d.type == "cuda" for d in self.devices)
        host = host_tensor((x.shape[0], *outs[0].shape[1:]), outs[0].dtype,
                           pinned)
        events = []
        for i, (dev, y) in enumerate(zip(self.devices, outs)):
            with on_device(dev):
                host[i * k:(i + 1) * k].copy_(y, non_blocking=True)
                ev = record_done(dev)
            if ev is not None:
                events.append(ev)
        return host, events


def data_parallel_fn(step_of_device: Callable[[torch.device], Callable],
                     mesh: Mesh, axis: str = "dp") -> ShardedStep:
    """Wrap a batched step so its batch is split over ``axis``:
    ``step_of_device(device)`` returns the step on that device (its
    replica), called once per distinct device here.  The step must treat
    batch items apart (every chain step does)."""
    return DataParallelStep(step_of_device, mesh, axis)

