"""The ``vsr-finetune-torch`` workflow: fine-tune an SR model on a video
(or PNG dir), checkpoint/resume, export back to ncnn files.

Port of ``upscale_video_tpu/train/finetune.py``.  Any loadable ncnn SR
model trains (Compact, the 'r'-family RRDBNets, vsr-import conversions):
the trainer differentiates through the generic graph walk on the aten
route (train/trainer.py), so family support is whatever it runs.

Data: HR patches are random crops of the source frames; LR inputs are
their box-downsampled halves (the standard self-supervised VSR recipe).
``data="synthetic"`` trains on generated pairs (tests, smoke runs).  One
seed draws the same batches as the JAX package's workflow.  The sampler's
random state goes into each checkpoint, so a resumed run continues the
uninterrupted run's batches (the JAX workflow restarts its generator and
draws the first batches again).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


def _load_hr_frames(data: str, max_frames: int, rng) -> np.ndarray:
    """Decode up to ``max_frames`` HR frames (uint8 NHWC) from a video
    file / PNG dir via the hermetic readers (video/io.py)."""
    from upscale_video_tpu_torch.video.io import open_source

    frames = []
    with open_source(data) as src:
        while len(frames) < max_frames:
            f = src.read()
            if f is None:
                break
            frames.append(f)
    if not frames:
        raise ValueError(f"no frames decoded from {data!r}")
    return np.stack(frames)


def _sample_batch(hr_frames: np.ndarray, batch: int, patch: int, scale: int,
                  rng) -> tuple:
    """Random HR crops -> (LR, HR) f32 pairs in [0, 1] (model domain)."""
    n, h, w, _ = hr_frames.shape
    hp = patch * scale
    if h < hp or w < hp:
        raise ValueError(
            f"frames {h}x{w} smaller than HR patch {hp}x{hp} "
            f"(patch {patch} * scale {scale})"
        )
    lr = np.empty((batch, patch, patch, 3), np.float32)
    hr = np.empty((batch, hp, hp, 3), np.float32)
    for i in range(batch):
        fi = rng.integers(0, n)
        y = rng.integers(0, h - hp + 1)
        x = rng.integers(0, w - hp + 1)
        crop = hr_frames[fi, y : y + hp, x : x + hp].astype(np.float32) / 255.0
        hr[i] = crop
        lr[i] = crop.reshape(patch, scale, patch, scale, 3).mean(axis=(1, 3))
    return lr, hr


def _mesh(spec: str, device: torch.device):
    """``--mesh`` over every CUDA device, or on the CPU over logical shards
    (as many CPU entries as the spec's sizes multiply to; an inferred -1
    axis is then 1)."""
    from upscale_video_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec

    if device.type == "cuda":
        return make_mesh(spec)
    sizes = [s for s in parse_mesh_spec(spec).values() if s != -1]
    return make_mesh(spec, devices=[device] * int(np.prod(sizes)))


def finetune(
    data: str,
    output_dir: str,
    model: str = "compact",
    scale: int = 2,
    model_path: Optional[str] = None,
    steps: int = 200,
    batch: int = 4,
    patch: int = 64,
    learning_rate: float = 1e-4,
    mesh_spec: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 100,
    resume: bool = False,
    max_frames: int = 64,
    seed: int = 0,
    synthetic_model: bool = False,
    log_every: int = 20,
    export_stem: Optional[str] = None,
    device: "str | torch.device" = "cuda",
) -> Dict:
    """Run the fine-tune loop; returns a summary dict (losses, export path).

    ``mesh_spec`` (e.g. ``"dp=2,sp=4"``) shards the train step over a
    device mesh (trainer.make_sharded_train_step; the params live on its
    first device); default is the single-device step on ``device`` (CUDA
    unless the caller asks for the CPU; no GPU raises).  ``resume``
    restores the latest checkpoint under ``ckpt_dir``.
    """
    from upscale_video_tpu_torch.device import resolve_device
    from upscale_video_tpu_torch.models.zoo import load_model, make_synthetic_model
    from upscale_video_tpu_torch.train.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint,
    )
    from upscale_video_tpu_torch.train.trainer import (
        make_sharded_train_step, make_state_apply, make_train_state,
        make_train_step, synthesize_pairs,
    )

    dev = resolve_device(device)
    mesh = _mesh(mesh_spec, dev) if mesh_spec else None
    if mesh is not None:
        dev = mesh.devices.flat[0]  # the master params' device
    rng = np.random.default_rng(seed)
    # params stay f32 for training; export casts per the zoo's fp16 tag
    m = (
        make_synthetic_model(scale=scale, device=dev,
                             compute_dtype=torch.float32)
        if synthetic_model
        else load_model(model, scale, dev, model_path, torch.float32)
    )
    state, opt = make_train_state(m, learning_rate)

    if mesh is not None:
        apply = make_state_apply(make_sharded_train_step(m, opt, mesh))
        log.info("sharded train step over mesh %s", mesh.shape)
    else:
        apply = make_train_step(m, opt)

    if resume and ckpt_dir:
        path = latest_checkpoint(ckpt_dir)
        if path:
            state = restore_checkpoint(path, state, opt, rng)
            log.info("resumed from %s (step %d)", path, state.step)

    if data == "synthetic":
        hr_frames = None
    else:
        hr_frames = _load_hr_frames(data, max_frames, rng)
        log.info("loaded %d HR frames %s from %s",
                 len(hr_frames), hr_frames.shape[1:3], data)

    losses = []
    t0 = time.time()
    pending = None  # log/append one step behind: the loss is a device
    # scalar and fetching it synchronously would stall dispatch
    while state.step < steps:
        if hr_frames is None:
            lr_b, hr_b = synthesize_pairs(rng, batch, patch, patch, scale)
        else:
            lr_b, hr_b = _sample_batch(hr_frames, batch, patch, scale, rng)
        state, loss = apply(state, lr_b, hr_b)
        if pending is not None:
            losses.append(float(pending))
        pending = loss
        if state.step % log_every == 0 and losses:
            log.info("step %d: loss %.5f", state.step, losses[-1])
        if ckpt_dir and ckpt_every and state.step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state, opt, rng)
    if pending is not None:
        losses.append(float(pending))
    if ckpt_dir:
        save_checkpoint(ckpt_dir, state, opt, rng)
    elapsed = time.time() - t0

    for n, p in state.params.items():
        for k, t in p.items():
            m.params[n][k] = t.detach().cpu().numpy()
    stem = export_stem or f"{scale}x_{model}_finetuned"
    export_path = m.save(output_dir, stem=stem)
    log.info(
        "finetune done: %d steps in %.1fs, loss %.5f -> %.5f, exported %s",
        state.step, elapsed, losses[0] if losses else float("nan"),
        losses[-1] if losses else float("nan"), export_path,
    )
    return {
        "steps": state.step,
        "elapsed_seconds": elapsed,
        "losses": losses,
        "export_path": export_path,
    }
