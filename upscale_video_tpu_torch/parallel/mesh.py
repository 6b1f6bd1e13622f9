"""Device meshes, chip selection and multi-host start-up.

Port of ``upscale_video_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
named array of ``torch.device`` (axes ``dp``, ``sp``); the wrappers of
:mod:`~upscale_video_tpu_torch.parallel.data` and
:mod:`~upscale_video_tpu_torch.parallel.spatial` give each entry its shard.

Chip id ``i`` of a ``-g`` multiset is ``cuda:i``.  Only when the caller
asks for the CPU (``--device cpu``) are chip ids logical shards, all on
``torch.device("cpu")``.  A mesh may list one device more than once: each
entry is a shard, and the shards of one device run on it one after the
other.  ``-g`` never builds such a mesh (:func:`parse_chips` folds repeated
ids into the batch multiplier).

The repetition of a chip id deepens the per-chip batch instead of adding
workers, as in the JAX package (k repeats => k x frames per step).
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def parse_chips(chips: Optional[str]) -> Tuple[List[int], int]:
    """``"0,0,1"`` -> (unique chip ids [0, 1], batch multiplier 2).

    The multiplier is the max repetition count — the reference ran k
    workers on a GPU listed k times; here that becomes k x batch depth.
    """
    if not chips:
        return [0], 1
    try:
        ids = [int(g) for g in chips.split(",")]
    except ValueError as e:
        raise ValueError(f"invalid chips spec {chips!r}") from e
    counts = Counter(ids)
    return sorted(counts), max(counts.values())


def select_devices(chip_ids: Sequence[int],
                   device_type: str = "cuda") -> List[torch.device]:
    """Chip ids -> devices: ``cuda:i`` on CUDA (an id at or above
    ``torch.cuda.device_count()`` raises); on the CPU every id is a logical
    shard on ``torch.device("cpu")``."""
    if device_type == "cpu":
        return [torch.device("cpu")] * len(chip_ids)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r} (cuda or cpu)")
    count = torch.cuda.device_count()
    bad = [i for i in chip_ids if i >= count]
    if bad:
        raise ValueError(f"chip ids {bad} out of range (have {count} devices)")
    return [torch.device("cuda", i) for i in chip_ids]


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp=2,sp=4"`` -> {"dp": 2, "sp": 4}."""
    out: Dict[str, int] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, _, v = item.partition("=")
        out[k.strip()] = int(v)
    return out


class Mesh:
    """Named axes over an array of ``torch.device`` (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names`` and ``shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis)."""
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if k == i else 0
                    for k in range(len(self.axis_names)))
        return list(self.devices[idx])

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(spec: "str | Dict[str, int]",
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh("dp=2,sp=4")``.

    Sizes must multiply to at most the device count (a trailing axis of
    size -1 is inferred); a smaller mesh takes the first devices.
    ``devices`` defaults to every CUDA device, or the CPU once when there
    is none.  A list that repeats a device is taken as it is."""
    axes = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    if devices is None:
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(count)]
                   or [torch.device("cpu")])
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one inferred (-1) axis")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    need = int(np.prod(sizes))
    if need > n:
        raise ValueError(f"mesh {axes} needs {need} devices, have {n}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(sizes), tuple(axes.keys()))


def initialize_multihost(backend: Optional[str] = None) -> int:
    """Join the process group when a multi-host environment is set; returns
    the process count (1, doing nothing, when none is).

    ``COORDINATOR_ADDRESS`` (``host:port``), ``NUM_PROCESSES`` and
    ``PROCESS_ID`` are the JAX package's explicit contract, here
    ``init_process_group(init_method="tcp://...")``; with
    ``MEGASCALE_COORDINATOR_ADDRESS`` set instead (the pod branch) the group
    comes from torchrun's ``env://`` contract (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``backend`` defaults to
    ``nccl`` when a GPU is present and ``gloo`` otherwise."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        num = os.environ.get("NUM_PROCESSES")
        pid = os.environ.get("PROCESS_ID")
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}",
            world_size=int(num) if num is not None else -1,
            rank=int(pid) if pid is not None else -1,
        )
    elif os.environ.get("MEGASCALE_COORDINATOR_ADDRESS"):
        dist.init_process_group(backend, init_method="env://")
    else:
        return 1
    return dist.get_world_size()


def describe_devices(device_type: str = "cuda") -> List[str]:
    """Human-readable chip inventory, one line per GPU (or one line for
    the CPU's plain versions), with ``(process k)`` in process k > 0."""
    import torch.distributed as dist

    rank = (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)
    tag = f" (process {rank})" if rank else ""
    if device_type != "cuda" or not torch.cuda.is_available():
        return [f"chip 0: cpu (the plain PyTorch versions){tag}"]
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        out.append(f"chip {i}: cuda/{p.name}, {p.total_memory / 2**30:.1f} "
                   f"GiB, {p.multi_processor_count} SMs, "
                   f"sm_{p.major}{p.minor}{tag}")
    return out
