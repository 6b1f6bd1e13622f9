"""Training checkpoint/restore with ``torch.save``.

Port of ``upscale_video_tpu/train/checkpoint.py`` (orbax there).  The
directory contract is the same: ``ckpt_dir/step_{N}``, the latest being the
largest N among ``step_<digits>``.  Inside is one file, ``state.pt``: the
params, the Adam moments and counts (the optimizer's ``state_dict()``
state), the step and, when the caller gives one, its data sampler's
random-generator state, so a resumed run draws the batches the
uninterrupted run would have drawn.

A checkpoint is written whole in ``<ckpt_dir>/partial/step_{N}`` and then
renamed into place, so a kill mid-write leaves no ``step_{N}`` that resume
would trust (the fragments' rule, ``pipeline/process.py:open_fragment``).
A ``step_{N}`` holding an orbax checkpoint (the JAX package's) raises: the
port does not read them.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from typing import Optional

import numpy as np
import torch

from upscale_video_tpu_torch.train.trainer import (
    TrainState, _check_bound, leaf_names,
)

STATE_FILE = "state.pt"
FORMAT = "upscale_video_tpu_torch.train/1"
PARTIAL_DIR = "partial"
# names orbax's StandardCheckpointer writes in a checkpoint directory
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                 "_sharding", "checkpoint")


def save_checkpoint(ckpt_dir: str, state: TrainState, optimizer,
                    rng: Optional[np.random.Generator] = None) -> str:
    """Write params/optimizer state/step (and ``rng``'s state) under
    ``ckpt_dir/step_{N}``, replacing one of that name."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    name = f"step_{state.step}"
    part = os.path.join(ckpt_dir, PARTIAL_DIR, name)
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    blob = {
        "format": FORMAT,
        "step": int(state.step),
        "leaves": leaf_names(state.params),
        "params": {n: {k: t.detach().cpu() for k, t in p.items()}
                   for n, p in state.params.items()},
        "optimizer": {i: {k: (v.cpu() if torch.is_tensor(v) else v)
                          for k, v in s.items()}
                      for i, s in optimizer.state_dict()["state"].items()},
        "rng": None if rng is None else rng.bit_generator.state,
    }
    with open(os.path.join(part, STATE_FILE), "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    path = os.path.join(ckpt_dir, name)
    stale = os.path.join(ckpt_dir, PARTIAL_DIR, f"stale_{name}")
    if os.path.exists(path):
        shutil.rmtree(stale, ignore_errors=True)
        os.replace(path, stale)
    os.replace(part, path)
    shutil.rmtree(stale, ignore_errors=True)
    with contextlib.suppress(OSError):  # the emptied partial dir
        os.rmdir(os.path.join(ckpt_dir, PARTIAL_DIR))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append(int(name[5:]))
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{max(steps)}")


def restore_checkpoint(path: str, template: TrainState, optimizer,
                       rng: Optional[np.random.Generator] = None) -> TrainState:
    """Restore into ``template``'s params (same model) and ``optimizer``
    (bound to them; its hyper-parameters are kept), and ``rng`` to the
    sampler state saved with it, if any."""
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        names = os.listdir(path) if os.path.isdir(path) else []
        if any(n in ORBAX_MARKERS for n in names):
            raise ValueError(
                f"{path} holds an orbax checkpoint (the JAX package's "
                "vsr-finetune format); the port reads only its own "
                f"torch.save checkpoints ({STATE_FILE})")
        raise FileNotFoundError(f"no {STATE_FILE} in {path}")
    blob = torch.load(file, map_location="cpu", weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{file}: format {blob.get('format')!r}, not {FORMAT!r}")
    if blob["leaves"] != leaf_names(template.params):
        raise ValueError(f"{file} holds another model's params")
    _check_bound(optimizer, template.params)
    with torch.no_grad():
        for n, p in template.params.items():
            for k, t in p.items():
                t.copy_(blob["params"][n][k])
    sd = optimizer.state_dict()
    sd["state"] = blob["optimizer"]
    optimizer.load_state_dict(sd)
    if rng is not None and blob.get("rng") is not None:
        rng.bit_generator.state = blob["rng"]
    return TrainState(template.params, optimizer.state, int(blob["step"]))
