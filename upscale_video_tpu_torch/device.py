"""Device selection for the port: explicit, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(name: "str | torch.device") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> :class:`torch.device`.

    A CUDA name on a host without a usable GPU raises ``RuntimeError``: the
    port's kernels are CUDA-only, and running their plain versions on the
    CPU instead would be a different (far slower) program under the same
    flag.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but no CUDA device is "
                "available (pass --device cpu to run the plain PyTorch path)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(name)!r} out of range "
                f"({torch.cuda.device_count()} CUDA device(s))"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev
