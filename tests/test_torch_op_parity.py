"""The generic ops' parity with the JAX executor where they once parted:
ncnn's SAME_UPPER conv padding (``4=-233``), bf16 bilinear and bicubic
Interp, and Dropout with a scale in bf16.

Tolerances, each with its reason:

- SAME_UPPER convs: 1e-6 in f32 (the sum's order differs between XLA's
  conv and ``F.conv2d``); in bf16 at most one bf16 ulp of the value (both
  sum in f32 and round once; a sum on a rounding boundary may round to
  either side).
- bf16 Interp and Dropout: exact.  The port takes JAX's rounding points
  (bf16 weights, the cheaper contraction order, a bf16 intermediate; a
  bf16 scale), so every element is equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models import executor as jax_executor
from upscale_video_tpu_torch.models import ops as port_ops
from upscale_video_tpu_torch.models.param_parser import NcnnLayer
from upscale_video_tpu_torch.models.zoo import params_from_jax

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _run_both(layer, x, params, dtype):
    jd, td = DTYPES[dtype]
    jp = {k: jnp.asarray(v) for k, v in (params or {}).items()}
    want = np.asarray(jax_executor.OP_REGISTRY[layer.type](
        layer, [jnp.asarray(x, jd)], jp, jd)).astype(np.float32)
    state = params_from_jax({layer.name: params}, "cpu", td)[layer.name] \
        if params else None
    got = port_ops.OP_REGISTRY[layer.type](
        layer, [torch.from_numpy(x).to(td)], state, td)
    assert got.dtype == td and tuple(got.shape) == want.shape
    return got.float().numpy(), want


def _bf16_ulp(v):
    """One bf16 ulp at each value's magnitude (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 7, 9, 4), (1, 8, 10, 4)],
                         ids=["odd", "even"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["Convolution", "ConvolutionDepthWise"])
def test_same_upper_conv_equals_jax(kind, stride, shape, dtype):
    """``4=-233`` pads as XLA's SAME: ceil(n/s) outputs, the odd pixel of
    the total pad at the bottom/right (it shows at stride 2 on even sizes
    and at stride 1 on the even 4x4 kernel)."""
    rng = np.random.default_rng(stride * 10 + shape[1])
    cin = shape[-1]
    x = rng.uniform(-1, 2, shape).astype(np.float32)
    for k in (3, 4):
        if kind == "Convolution":
            cout, group = 6, 1
            params = {"weight": rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)}
        else:
            cout, group = cin, cin
            params = {"weight": rng.normal(0, 0.3, cout * k * k).astype(np.float32),
                      "group": np.array(group)}
        params["bias"] = rng.normal(0, 0.1, (cout,)).astype(np.float32)
        attrs = {0: cout, 1: k, 3: stride, 4: -233, 5: 1,
                 6: cout * (cin // group) * k * k, 7: group, 9: 2, 10: [0.1]}
        layer = NcnnLayer(kind, "cv", ["a"], ["b"], attrs)
        got, want = _run_both(layer, x, params, dtype)
        n_out = [-(-s // stride) for s in shape[1:3]]
        assert got.shape == (1, *n_out, cout)
        tol = 1e-6 if dtype == "f32" else _bf16_ulp(want)
        assert np.all(np.abs(got - want) <= tol), (k, np.abs(got - want).max())


@pytest.mark.parametrize("out_hw", [(26, 34), (7, 9), (26, 9), (7, 34)])
@pytest.mark.parametrize("rtype", [2, 3], ids=["bilinear", "bicubic"])
def test_bf16_interp_equals_jax(rtype, out_hw):
    """Up, down and mixed on each axis, so both contraction orders run."""
    layer = NcnnLayer("Interp", "up", ["a"], ["b"],
                      {0: rtype, 3: out_hw[0], 4: out_hw[1]})
    x = np.random.default_rng(rtype).uniform(-1, 2, (2, 13, 17, 3)).astype(np.float32)
    got, want = _run_both(layer, x, None, "bf16")
    assert got.shape == (2, *out_hw, 3)
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("dtype,scale", [("bf16", 0.8), ("f32", 0.5)])
def test_dropout_scale_equals_jax(dtype, scale):
    layer = NcnnLayer("Dropout", "d", ["a"], ["b"], {0: scale})
    x = np.random.default_rng(5).uniform(-1, 2, (2, 6, 10, 8)).astype(np.float32)
    got, want = _run_both(layer, x, None, dtype)
    assert int((got != want).sum()) == 0
