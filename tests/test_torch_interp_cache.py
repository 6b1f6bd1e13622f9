"""Bilinear and bicubic Interp take their resize weights from a cache on
the tensor's device (``models/ops.py:resize_weights_on``): made once per
``(size_in, size_out, kernel, device, dtype)``, where each resize used to
copy them host-to-device (a blocking copy, a host sync inside a CUDA
step).  The output is bit-equal to the uncached formula."""

import numpy as np
import pytest
import torch

from upscale_video_tpu_torch.models import ops
from upscale_video_tpu_torch.models.param_parser import NcnnLayer
from tests.torch_fixtures import one_torch_thread  # noqa: F401


def _uncached(x, out_h, out_w, kernel):
    """``_resize`` as it was: the weights copied to the device per call."""
    n, h, w, c = x.shape
    axes = []
    if out_h != h:
        axes.append(("nhwc,ho->nowc", ops.resize_weights(h, out_h, kernel)))
    if out_w != w:
        axes.append(("nhwc,wo->nhoc", ops.resize_weights(w, out_w, kernel)))
    if (x.dtype != torch.float32 and len(axes) == 2
            and h * out_w * (w + out_h) < w * out_h * (h + out_w)):
        axes.reverse()
    y = x
    for eq, wmat in axes:
        wt = torch.from_numpy(wmat).to(x.device, x.dtype).float()
        y = torch.einsum(eq, y.float(), wt).to(x.dtype)
    return y


@pytest.mark.parametrize("rtype,kernel", [(2, ops._triangle), (3, ops._keys_cubic)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [2.0, 0.5, 1.5])
def test_interp_reuses_one_device_tensor_and_is_bit_equal(rtype, kernel, dtype,
                                                          scale):
    ops.resize_weights_on.cache_clear()
    layer = NcnnLayer("Interp", "up", ["x"], ["y"],
                      {0: rtype, 1: scale, 2: scale})
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 10, 14, 3)).astype(np.float32)).to(dtype)
    got = ops.op_interp(layer, [x], None, dtype)
    info = ops.resize_weights_on.cache_info()
    assert info.misses == 2 and info.hits == 0  # one matrix per axis
    again = ops.op_interp(layer, [x], None, dtype)
    info = ops.resize_weights_on.cache_info()
    assert info.misses == 2 and info.hits == 2
    out_h, out_w = int(10 * scale), int(14 * scale)
    assert (ops.resize_weights_on(10, out_h, kernel, x.device, dtype)
            is ops.resize_weights_on(10, out_h, kernel, x.device, dtype))
    want = _uncached(x, out_h, out_w, kernel)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want) and torch.equal(again, want)


def test_cache_keys_on_dtype_and_kernel():
    ops.resize_weights_on.cache_clear()
    cpu = torch.device("cpu")
    a = ops.resize_weights_on(8, 16, ops._triangle, cpu, torch.float32)
    b = ops.resize_weights_on(8, 16, ops._triangle, cpu, torch.bfloat16)
    c = ops.resize_weights_on(8, 16, ops._keys_cubic, cpu, torch.float32)
    assert a is not b and a is not c and b.dtype == torch.float32
    assert torch.equal(b, torch.from_numpy(
        ops.resize_weights(8, 16, ops._triangle)).bfloat16().float())
