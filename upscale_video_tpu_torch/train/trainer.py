"""Fine-tuning the SR model zoo: the Charbonnier loss, the Adam state and
the train steps, on one device and over a ``dp`` x ``sp`` mesh.

Port of ``upscale_video_tpu/train/trainer.py``.  Params stay f32: a nested
``{layer: {"weight" (HWIO), "bias", "slope"}}`` dict of leaf tensors with
``requires_grad``, as the JAX package's pytree.  The optimizer is
``torch.optim.Adam`` with optax ``adam``'s defaults (``eps_root=0``).

No hand-written kernel is differentiated.  The JAX package rebuilds a
kernel-carrying model on the XLA path because ``pallas_call`` has no
differentiation rule; here a ctypes launch records no autograd graph, so
every train step runs the graph walk on the aten route
(:func:`_differentiable_forward`: ``conv_impl="xla"``, each conv an
``F.conv2d`` with TF32 off and cuDNN's deterministic algorithms, forward
and backward: :func:`train_numerics`).

Torch's optimizers step in place: a step updates its state's params and
Adam moments and returns a :class:`TrainState` over the same tensors.  The
optimizer is bound to one state's params (:func:`make_train_state`,
:func:`train_state_from_jax`); a step given another state's raises.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from upscale_video_tpu_torch.models.executor import build_forward
from upscale_video_tpu_torch.ops.conv_chain import no_tf32
from upscale_video_tpu_torch.parallel.data import as_batch, on_device
from upscale_video_tpu_torch.parallel.mesh import Mesh
from upscale_video_tpu_torch.parallel.spatial import (
    _upload_rows, graph_radius, plan_bands,
)

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    params: dict
    opt_state: object  # the optimizer's per-param state (``optimizer.state``)
    step: int = 0


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def charbonnier_sum(pred: torch.Tensor, target: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """:func:`charbonnier` before its division by the element count."""
    return torch.sum(torch.sqrt((pred - target) ** 2 + eps * eps))


@contextlib.contextmanager
def train_numerics():
    """A train step's convolutions, forward and backward: true f32 (TF32
    off: the forward's own ``no_tf32`` would leave the backward, run after
    it, on cuDNN's TF32 default) and cuDNN's deterministic algorithms, so a
    step's arithmetic repeats and a resumed run equals the uninterrupted
    one."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with no_tf32():
            yield
    finally:
        torch.backends.cudnn.deterministic = old


def param_leaves(params: dict) -> List[torch.Tensor]:
    """The leaves in the JAX pytree's order (dict keys sorted)."""
    return [params[name][k] for name in sorted(params)
            for k in sorted(params[name])]


def leaf_names(params: dict) -> List[str]:
    return [f"{name}/{k}" for name in sorted(params) for k in sorted(params[name])]


def _leaf_params(host: dict, device) -> dict:
    return {name: {k: torch.tensor(np.asarray(v, np.float32), device=device)
                   .requires_grad_()
                   for k, v in p.items()}
            for name, p in host.items()}


def _adam(params: dict, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(param_leaves(params), lr=learning_rate,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def make_train_state(model, learning_rate: float = 1e-4):
    """Adam state over the model's params (f32 copies on its device):
    ``(state, optimizer)``."""
    params = _leaf_params(model.params, model.device)
    opt = _adam(params, learning_rate)
    return TrainState(params=params, opt_state=opt.state), opt


def train_state_from_jax(params: dict, opt_state, step: int,
                         device: "torch.device | str",
                         learning_rate: float = 1e-4):
    """A JAX ``TrainState``'s leaves (numpy or array-likes) as the port's
    ``(state, optimizer)`` on ``device``.  optax's ``ScaleByAdamState(count,
    mu, nu)`` (alone or first of ``adam``'s chain state) becomes each
    param's ``{"step": count, "exp_avg": mu, "exp_avg_sq": nu}``: the
    count carries the bias correction of the next step."""
    chain = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = next((s for s in chain if hasattr(s, "mu") and hasattr(s, "nu")),
                None)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (count, mu, nu)")
    state_params = _leaf_params(params, device)
    opt = _adam(state_params, learning_rate)
    count = float(np.asarray(adam.count))
    for name in sorted(state_params):
        for k in sorted(state_params[name]):
            p = state_params[name][k]
            opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.tensor(
                    np.asarray(adam.mu[name][k], np.float32), device=p.device),
                "exp_avg_sq": torch.tensor(
                    np.asarray(adam.nu[name][k], np.float32), device=p.device),
            }
    return TrainState(state_params, opt.state, int(step)), opt


def state_from_params(params: dict) -> Dict[str, SimpleNamespace]:
    """The forward's per-layer weights made from the train params by torch
    ops, so they stay in the autograd graph (the twin of
    :func:`~upscale_video_tpu_torch.models.zoo.params_from_jax`, which
    copies through numpy into buffers): HWIO ``weight`` -> ``wmat``
    ``(kh*kw*cin, cout)`` by a reshape, ``bias`` (zeros where the conv has
    none), ``slope``; a ConvolutionDepthWise's flat weight -> ``wflat``."""
    state = {}
    for name, p in params.items():
        t = {}
        if "weight" in p:
            w = p["weight"]
            if w.ndim == 1:
                t["wflat"] = w
                if "bias" in p:
                    t["bias"] = p["bias"]
            elif w.ndim == 4:
                kh, kw, cin, cout = w.shape
                t["wmat"] = w.reshape(kh * kw * cin, cout)
                t["bias"] = (p["bias"] if "bias" in p
                             else torch.zeros(cout, device=w.device))
            else:
                raise NotImplementedError(f"{name}: weight {tuple(w.shape)} "
                                          "is not HWIO")
        if "slope" in p:
            t["slope"] = p["slope"]
        state[name] = SimpleNamespace(**t)
    return state


def _differentiable_forward(model, device: Optional[torch.device] = None):
    """The model's graph on the aten route (``conv_impl="xla"``) in its own
    compute dtype, on ``device`` (default the model's): ``fwd(state, x)``
    with ``state`` from :func:`state_from_params`.  A model from a kernel
    engine (bf16, ``conv_impl="auto"``) must not be differentiated through
    its kernel forward: the ctypes launches record no graph, so its loss
    would come back without gradients."""
    return build_forward(model.graph, device or model.device,
                         model.compute_dtype, "model", model.residual_dtype,
                         conv_impl="xla")


def _check_bound(optimizer, params: dict) -> None:
    held = optimizer.param_groups[0]["params"]
    leaves = param_leaves(params)
    if len(held) != len(leaves) or any(a is not b for a, b in zip(held, leaves)):
        raise ValueError("the optimizer is not over this state's params "
                         "(make_train_state, train_state_from_jax and "
                         "restore_checkpoint bind them)")


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host batch (numpy or tensor) on ``device``: on CUDA from pinned
    memory with a non-blocking copy (a copy from pageable memory waits for
    the device's queued work)."""
    t = as_batch(a)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_train_step(model, optimizer) -> Callable:
    """Single-device train step: ``apply(state, lr_imgs, hr_imgs) ->
    (state, loss)``.

    The loss is a DEVICE scalar: nothing in the step reads it back (no
    host sync per step); callers ``float()`` it when they log."""
    fwds = {}  # device -> the forward built there

    def apply(state: TrainState, lr_imgs, hr_imgs) -> Tuple[TrainState, torch.Tensor]:
        _check_bound(optimizer, state.params)
        dev = param_leaves(state.params)[0].device
        if dev not in fwds:
            fwds[dev] = _differentiable_forward(model, dev)
        x, y = to_device(lr_imgs, dev), to_device(hr_imgs, dev)
        optimizer.zero_grad(set_to_none=True)
        with train_numerics():
            pred = fwds[dev](state_from_params(state.params), x)
            loss = charbonnier(pred.float(), y.float())
            loss.backward()
        optimizer.step()
        return TrainState(state.params, optimizer.state, state.step + 1), loss.detach()

    return apply


def make_sharded_train_step(
    model,
    optimizer,
    mesh: Mesh,
    batch_axis: Optional[str] = "dp",
    h_axis: Optional[str] = "sp",
) -> Callable:
    """dp x sp sharded train step over ``mesh``: ``step(params, opt_state,
    lr_imgs, hr_imgs) -> (params, opt_state, loss)`` (wrap with
    :func:`make_state_apply` for :class:`TrainState` bookkeeping).

    N is split over ``batch_axis`` (N must divide evenly, as under the JAX
    package's sharding); each LR batch shard is cut into row bands over
    ``h_axis`` by :func:`~upscale_video_tpu_torch.parallel.spatial.plan_bands`,
    each widened by the graph's receptive radius and clipped to the frame
    (a band may be thinner than the radius: its rows come from as many
    neighbours as they need).  Each band runs forward on its device's
    replica of the params; its loss term is the Charbonnier sum over its
    core HR rows divided by the whole batch's element count, so the terms
    add up to the single-device mean.  A core output row depends only on
    input rows within the radius and the frame's true edges keep their
    zero padding, so the gradient is the single-device gradient up to
    summation order.

    The params live on the mesh's first device (the master).  A replica on
    another device is the master's copy made in the autograd graph at each
    step (the refresh), so backward sums every band's gradient onto the
    master, where Adam steps.  Every shard is queued from this thread
    before the one backward call; nothing waits on the device."""
    b = batch_axis if batch_axis in mesh.shape else None
    h = h_axis if h_axis in mesh.shape else None
    nb = mesh.shape[b] if b else 1
    nh = mesh.shape[h] if h else 1
    names = mesh.axis_names

    def device_at(i: int, j: int) -> torch.device:
        idx = [0] * len(names)
        if b:
            idx[names.index(b)] = i
        if h:
            idx[names.index(h)] = j
        return mesh.devices[tuple(idx)]

    grid = [[device_at(i, j) for j in range(nh)] for i in range(nb)]
    master = grid[0][0]
    fwds = {d: _differentiable_forward(model, d)
            for d in dict.fromkeys(d for row in grid for d in row)}
    radius = graph_radius(model.graph)

    def step(params, opt_state, lr_imgs, hr_imgs):
        _check_bound(optimizer, params)
        if param_leaves(params)[0].device != master:
            raise ValueError(f"the params are not on the mesh's first device "
                             f"{master}")
        lr, hr = as_batch(lr_imgs), as_batch(hr_imgs)
        if any(d.type == "cuda" for d in fwds):
            lr, hr = lr.pin_memory(), hr.pin_memory()
        n, h_lr = lr.shape[0], lr.shape[1]
        if n % nb:
            raise ValueError(f"batch {n} not divisible by {b}={nb}")
        kb, ratio = n // nb, hr.shape[1] // h_lr
        total = hr.numel()
        optimizer.zero_grad(set_to_none=True)
        replicas = {}
        for dev in fwds:
            with on_device(dev):
                replicas[dev] = state_from_params(
                    params if dev == master else
                    {name: {k: t.to(dev, non_blocking=True)
                            for k, t in p.items()}
                     for name, p in params.items()})
        terms = []
        with train_numerics():
            for i in range(nb):
                rows = slice(i * kb, (i + 1) * kb)
                for j, band in enumerate(plan_bands(h_lr, nh, radius)):
                    if band is None:
                        continue
                    dev = grid[i][j]
                    with on_device(dev):
                        x = _upload_rows(lr[rows], band.top, band.bottom, dev)
                        y = _upload_rows(hr[rows], band.lo * ratio,
                                         band.hi * ratio, dev)
                        pred = band.crop(fwds[dev](replicas[dev], x))
                        term = charbonnier_sum(pred.float(), y.float()) / total
                    terms.append(term.to(master, non_blocking=True))
            loss = torch.stack(terms).sum()
            loss.backward()
        optimizer.step()
        return params, optimizer.state, loss.detach()

    return step


def make_state_apply(step_fn: Callable) -> Callable:
    """Wrap a raw ``(params, opt_state, lr, hr) -> (params, opt_state,
    loss)`` step (e.g. from :func:`make_sharded_train_step`) into the same
    ``(TrainState, lr, hr) -> (TrainState, loss)`` contract as
    :func:`make_train_step`, advancing ``state.step`` so checkpoint
    directories (checkpoint.py ``step_{n}``) don't collapse onto step_0."""
    def apply(state: TrainState, lr_imgs, hr_imgs):
        params, opt_state, loss = step_fn(
            state.params, state.opt_state, lr_imgs, hr_imgs
        )
        return TrainState(params, opt_state, state.step + 1), loss

    return apply


def synthesize_pairs(
    rng: np.random.Generator, n: int, h: int, w: int, scale: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(LR, HR) pairs: smooth random HR fields box-downsampled to LR —
    enough structure for loss-decreases tests and throughput benchmarks."""
    hr = rng.uniform(0, 1, (n, h * scale, w * scale, 3)).astype(np.float32)
    # cheap smoothing so SR has learnable structure
    hr = (hr + np.roll(hr, 1, 1) + np.roll(hr, 1, 2) + np.roll(hr, -1, 1)) / 4.0
    lr = hr.reshape(n, h, scale, w, scale, 3).mean(axis=(2, 4))
    return lr.astype(np.float32), hr.astype(np.float32)
