"""Tensor parallelism: conv output channels split across the GPUs of a mesh.

Port of ``upscale_video_tpu/parallel/tensor.py``.  The JAX package annotates
each conv weight's output-channel axis onto a ``tp`` mesh axis and lets
GSPMD partition every conv and place the all-gathers.  The port does by
hand what that program does: :func:`shard_params_channelwise` gives each
entry of the axis its slice of every conv whose cout divides the axis
size (the same rule, leaf by leaf), and the model's
:class:`~upscale_video_tpu_torch.models.executor.TensorParallelForward`
runs each such conv on every entry over its slice and exchanges the
slices after it (the protocol is in
:func:`~upscale_video_tpu_torch.models.executor.exchange_channels`).
Activations are replicated; the steps' work outside the models (the
model domain, NL-means, tiles, ``--tta``'s transforms, quantization) runs
once, on the axis's first device, whose inputs every model call
broadcasts.

This complements dp (frames across GPUs) and sp (rows across GPUs); tp
exchanges every split conv's output, so it only pays where channel counts
are large against the activation each GPU must receive.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from upscale_video_tpu_torch.models.executor import (
    GraphForward, TensorParallelForward, conv_routes,
)
from upscale_video_tpu_torch.models.zoo import LayerWeights, Model
from upscale_video_tpu_torch.parallel.data import (
    ShardedStep, as_batch, run_to_host,
)
from upscale_video_tpu_torch.parallel.mesh import Mesh

# the leaves the JAX rule reads: a conv's weight matrix (its last axis the
# output channels, as HWIO's), and the per-channel bias and PReLU slope
SPLIT_LEAVES = ("wmat", "bias", "slope")


def _split(leaf: str, t: torch.Tensor, n: int) -> bool:
    """The JAX rule for one leaf: a weight whose output-channel count
    divides ``n``, or a bias or slope whose length does."""
    if leaf == "wmat":
        return t.ndim == 2 and t.shape[-1] % n == 0
    return leaf in SPLIT_LEAVES and t.ndim == 1 and t.shape[0] % n == 0


def shard_params_channelwise(state: nn.ModuleDict, mesh: Mesh,
                             axis: str = "tp") -> List[nn.ModuleDict]:
    """One model state per entry of ``mesh[axis]``, on its device: conv
    weights with their output-channel columns split, biases and slopes
    split on the same axis, every leaf whose channel count does not divide
    the axis size whole.  A ConvolutionDepthWise keeps its leaves whole,
    and so do the packed kernel images (K5's), which the JAX params lack.
    Made once: a column slice is a contiguous copy, a whole leaf on the
    entry's device is shared, not copied."""
    n = mesh.shape[axis]
    shards = []
    for r, dev in enumerate(mesh.axis_devices(axis)):
        layers: Dict[str, LayerWeights] = {}
        for name, mod in state.items():
            depthwise = hasattr(mod, "wflat")
            leaves = {}
            for leaf, t in mod.named_buffers(recurse=False):
                if not depthwise and _split(leaf, t, n):
                    c = t.shape[-1] // n
                    t = t[..., r * c:(r + 1) * c]
                leaves[leaf] = t.to(dev).contiguous()
            layers[name] = LayerWeights(**leaves)
        shards.append(nn.ModuleDict(layers))
    return shards


class TensorParallelModel:
    """A :class:`~upscale_video_tpu_torch.models.zoo.Model` over a ``tp``
    axis, as the chain engine's steps use a model: ``frames_forward(emit)``
    returns the :class:`~upscale_video_tpu_torch.models.executor.
    TensorParallelForward` for that layout (cached), called with
    ``state``, the model's own state on the axis's first device.  The
    route is the model's ``conv_impl`` read as under tp
    (:func:`tp_routes`); the K5 images are packed, then the shards made,
    once."""

    def __init__(self, model: Model, mesh: Mesh, axis: str = "tp"):
        self.model = model
        self.graph, self.scale, self.state = model.graph, model.scale, model.state
        self.devices = mesh.axis_devices(axis)
        if model.device != self.devices[0]:
            raise ValueError(f"model on {model.device}, the {axis} axis "
                             f"starts at {self.devices[0]}")
        self.kernels, self.rdb = tp_routes(model.conv_impl, model.compute_dtype)
        if self.rdb:  # K5's packed weights, shared by every layout
            GraphForward(self.graph, model.device, model.compute_dtype,
                         model.residual_dtype, "model", self.kernels,
                         self.rdb, chains=False).prepare(model.state)
        self.shards = shard_params_channelwise(model.state, mesh, axis)
        self._forwards: Dict[str, TensorParallelForward] = {}

    @property
    def planar_scale(self):
        return self.model.planar_scale

    def frames_forward(self, emit: str = "frames") -> TensorParallelForward:
        if emit not in self._forwards:
            self._forwards[emit] = TensorParallelForward(
                self.graph, self.devices, self.shards,
                self.model.compute_dtype, self.model.residual_dtype, emit,
                self.kernels, self.rdb)
        return self._forwards[emit]


def tp_routes(conv_impl: str, compute_dtype: torch.dtype):
    """``--conv_impl`` under tp -> ``(kernels, rdb)``: ``auto`` takes the
    ``pallas`` plan (no K5: a dense block is one launch and tp splits its
    convs), ``rdb`` keeps K5 whole on every GPU, ``xla`` and f32 split
    ``F.conv2d`` (JAX chain.py:621-653 reads the flag on a mesh the same
    way: ``auto`` falls back to the partitionable plan)."""
    kernels, rdb = conv_routes(conv_impl, compute_dtype)
    return kernels, rdb and not kernels


class TensorParallelStep(ShardedStep):
    """:func:`tensor_parallel_fn`'s step."""

    def __init__(self, step: Callable, mesh: Mesh, axis: str):
        self.step = step
        self.device = mesh.axis_devices(axis)[0]

    def launch(self, batch):
        return run_to_host(self.step, as_batch(batch), self.device)


def tensor_parallel_fn(step: Callable, mesh: Mesh,
                       axis: str = "tp") -> ShardedStep:
    """A step whose models run over ``mesh[axis]``
    (:class:`TensorParallelModel`) as a mesh step: the host batch goes to
    the axis's first device, the step runs there (its model calls
    broadcast to the other entries and exchange each split conv's
    output), and the output comes back from there to the host."""
    return TensorParallelStep(step, mesh, axis)
