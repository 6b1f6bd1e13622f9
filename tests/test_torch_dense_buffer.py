"""ESRGAN's dense blocks on one shared buffer, on the CPU.

Under a bf16 compute dtype ``GraphForward`` runs each basicsr dense block
(``o_k = conv_k(cat(x, o_1, .., o_(k-1)))``, then ``conv_5`` over all) on
one NHWC buffer of ``conv_5``'s input width (``_plan_dense_buffers``): x is
copied into its first channels, each K4 conv reads a channel prefix and
writes its channels behind it, and no Concat runs.  The bytes each conv
reads are the ones its Concat would have made, so the forward equals the
Concat path bit for bit (on the CPU, K4's plain version reading a channel
view).  Its agreement with the JAX K4 route is
``tests/test_torch_sr_import.py::test_bf16_matches_the_jax_k4_k3_route``.

The model is a 2-RRDB basicsr RRDBNet state dict (RealESRGAN_x4plus's key
layout, nf 64, gc 32) drawn from a numpy seed and converted by the port's
importer.
"""

import numpy as np
import pytest
import torch

from upscale_video_tpu_torch.models import executor
from upscale_video_tpu_torch.models.bin_loader import synthesize_weights
from upscale_video_tpu_torch.models.executor import build_forward
from upscale_video_tpu_torch.models.ops import OP_REGISTRY
from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer
from upscale_video_tpu_torch.models.torch_import import import_torch_checkpoint
from upscale_video_tpu_torch.models.zoo import Model, make_rrdb_graph

NUM_RRDB = 2


def _conv(rng, cout, cin):
    w = rng.normal(0, 0.6 / np.sqrt(9 * cin), (cout, cin, 3, 3))
    return w.astype(np.float32), rng.normal(0, 0.06, cout).astype(np.float32)


def basicsr_state_dict(seed, num_rrdb=NUM_RRDB, nf=64, gc=32):
    """RealESRGAN_x4plus's keys and shapes at ``num_rrdb`` RRDBs."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, cout, cin in (
            [("conv_first", nf, 3)]
            + [(f"body.{i}.rdb{j}.conv{k}", nf if k == 5 else gc,
                nf + (k - 1) * gc)
               for i in range(num_rrdb) for j in (1, 2, 3) for k in range(1, 6)]
            + [(n, nf, nf) for n in ("conv_body", "conv_up1", "conv_up2",
                                     "conv_hr")]
            + [("conv_last", 3, nf)]):
        sd[name + ".weight"], sd[name + ".bias"] = _conv(rng, cout, cin)
    return sd


@pytest.fixture(scope="module")
def esrgan():
    return import_torch_checkpoint({"params_ema": basicsr_state_dict(3)},
                                   torch.bfloat16, "cpu")


def _frames(seed=4, h=9, w=13):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32))


def _run(monkeypatch, graph, state, residual, dense=True):
    """``(output, Concat calls)`` of the bf16 graph walk, with the
    dense-buffer planner or (``dense=False``) without it."""
    calls = []
    concat = OP_REGISTRY["Concat"]

    def counted(*args):
        calls.append(1)
        return concat(*args)

    with monkeypatch.context() as m:
        m.setitem(OP_REGISTRY, "Concat", counted)
        if not dense:
            m.setattr(executor, "_plan_dense_buffers", lambda *a: ({}, set()))
        fwd = build_forward(graph, "cpu", torch.bfloat16, "model", residual)
        out = fwd(state, _frames())
    return out, len(calls), fwd


def test_planner_claims_every_esrgan_dense_block(esrgan):
    fwd = build_forward(esrgan.graph, "cpu", torch.bfloat16)
    blocks = {d["block"] for d in fwd.dense.values()}
    assert len(blocks) == 3 * NUM_RRDB and len(fwd.dense) == 15 * NUM_RRDB
    for i in range(NUM_RRDB):
        for j in range(3):
            plans = [fwd.dense[f"r{i}d{j}_c{k}"] for k in range(1, 6)]
            assert len({p["block"] for p in plans}) == 1
            assert [p["cin"] for p in plans] == [64, 96, 128, 160, 192]
            assert [p["out_off"] for p in plans] == [64, 96, 128, 160, None]
            assert [p["first"] for p in plans] == [True] + [False] * 4
            assert {p["total"] for p in plans} == {192}
    concats = {l.name for l in esrgan.graph.layers if l.type == "Concat"}
    assert len(concats) == 12 * NUM_RRDB and concats <= fwd.absorbed
    # the dense convs stay K4 launches: 348 per frame at 23 RRDBs
    assert set(fwd.dense) <= set(fwd.solos)
    assert len(fwd.solos) == 1 + 15 * NUM_RRDB + 2


@pytest.mark.parametrize("residual", [None, torch.float32], ids=["bf16", "mixed"])
def test_dense_buffer_forward_equals_the_concat_path(esrgan, monkeypatch,
                                                     residual):
    got, got_cats, _ = _run(monkeypatch, esrgan.graph, esrgan.state, residual)
    want, want_cats, _ = _run(monkeypatch, esrgan.graph, esrgan.state,
                              residual, dense=False)
    assert got_cats == 0 and want_cats == 12 * NUM_RRDB
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == (1, 36, 52, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def _leaky_graph():
    """One basicsr RRDB whose first dense block's second Concat also feeds
    a 1x1 conv outside the block, added to the block's output."""
    g = make_rrdb_graph(num_rrdb=1, variant="esrgan")
    names = [l.name for l in g.layers]
    cat2 = g.layers[names.index("r0d0_cat2")]
    res = g.layers[names.index("r0d0_res")]
    i = names.index("r0d0_res")
    leak = [NcnnLayer("Convolution", "leak_conv", [cat2.outputs[0]], ["leak"],
                      {0: 64, 1: 1, 6: 64 * 128}),
            NcnnLayer("BinaryOp", "leak_add", [res.outputs[0], "leak"],
                      ["leak_sum"], {0: 0})]
    rest = [NcnnLayer(l.type, l.name,
                      ["leak_sum" if b == res.outputs[0] else b for b in l.inputs],
                      l.outputs, l.attrs) for l in g.layers[i + 1:]]
    return NcnnGraph(layers=g.layers[:i + 1] + leak + rest,
                     blob_count=g.blob_count + 2)


def test_leak_guard_keeps_a_block_whose_concat_escapes(monkeypatch):
    graph = _leaky_graph()
    model = Model("leaky", 4, graph, synthesize_weights(graph, seed=5), "cpu")
    got, got_cats, fwd = _run(monkeypatch, graph, model.state, None)
    want, _, _ = _run(monkeypatch, graph, model.state, None, dense=False)
    claimed = {n.split("_")[0] for n in fwd.dense}
    assert claimed == {"r0d1", "r0d2"}
    assert "r0d0_cat2" not in fwd.absorbed and "r0d1_cat2" in fwd.absorbed
    assert got_cats == 4  # the first block's Concats still run
    assert torch.equal(got, want)


def test_valar_blocks_stay_on_k5():
    fwd = build_forward(make_rrdb_graph(num_rrdb=2), "cpu", torch.bfloat16)
    assert fwd.dense == {} and len(fwd.rdb_triggers) == 6


@pytest.mark.parametrize("dtype,nf,gc", [
    (torch.float32, 64, 32), (torch.bfloat16, 12, 4)], ids=["f32", "off_grid"])
def test_no_dense_buffer_for_f32_or_widths_off_the_16_byte_grid(dtype, nf, gc):
    """The f32 parity path keeps its Concats (its convs are generic ops);
    a block whose widths are no multiple of 8 channels is not claimed (the
    sm90 kernel's pixel strides and channel offsets are 16-byte aligned)."""
    g = make_rrdb_graph(num_rrdb=1, num_feat=nf, num_grow=gc, variant="esrgan")
    fwd = build_forward(g, "cpu", dtype)
    assert fwd.dense == {}
    assert not any(l.type == "Concat" and l.name in fwd.absorbed
                   for l in g.layers)
