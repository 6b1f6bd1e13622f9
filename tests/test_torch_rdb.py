"""K5's plain version and the dense-block planner against the JAX package.

- ``rdb_block_plain`` against the JAX fused RDB kernel (``rdb_apply`` and
  ``rdb_apply_canvas`` with the Valar hooks, Pallas in interpret mode) on
  the same numpy-seeded inputs and weights.  Both round each per-source
  piece to bf16 after an f32 sum whose order differs (XLA's dot vs
  ``F.conv2d``, whose order also differs from host to host), so a piece on
  a rounding boundary may land one bf16 ulp away.  The bound follows that
  flip through the block.  Pieces reach |32| (31.6 for c4 into c5 at
  32x40), where one ulp is ``2**-3``.  A flipped piece of c5 moves c5 by
  ``2**-3``; a flipped piece of c1..c4 moves that stage's rounded value,
  which feeds c5 through weights below 1 and may tip one more c5 piece
  over a rounding boundary: at most two c5 ulps, ``2 * 2**-3``.  Through
  ``0.2 * c5`` that is ``0.05``, and the output's own rounding can add one
  of its ulps (``2**-7 * |want|``): ``0.05 + 2**-7 * |want|``.  A flip
  spreads through the later stages, so the share of differing elements
  (0.1-9% observed) is far larger than the share of flipped pieces; a
  wrong rounding point (one f32 sum over all sources) moves most of them
  (65% at 32x40), and the share cap of 20% catches it.
- ``_plan_rdb_blocks`` against the JAX planner on the synthetic graphs,
  with ncnn Split bookkeeping inserted, with an interior blob leaked to an
  outside consumer, and with convs of the wrong geometry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models.executor import _plan_rdb_blocks as jax_plan
from upscale_video_tpu.models.zoo import make_rrdb_graph as jax_rrdb_graph
from upscale_video_tpu.ops.rdb_pallas import (
    GC, NF, canvas_geometry, rdb_apply, rdb_apply_canvas, rdb_canvas_embed,
    rdb_canvas_extract,
)
from upscale_video_tpu_torch.models.executor import (
    _consumers, _plan_rdb_blocks,
)
from upscale_video_tpu_torch.models.param_parser import NcnnGraph, NcnnLayer
from upscale_video_tpu_torch.models.zoo import make_rrdb_graph
from upscale_video_tpu_torch.ops.rdb import (
    BPACK_NUMEL, CINS, MACS_PER_PIXEL, WIDTHS, WPACK_NUMEL, _source_weight,
    pack_rdb_weights, pack_rdb_weights_sm90, rdb_block, rdb_block_plain,
    sm90_blocks, sm90_swizzle,
)

# The tile plan that csrc/rdb_block_sm90.cu states (its static_asserts hold
# the same numbers at compile time): 12x16 output pixels per tile, halo 5;
# stage t (0 = the x window, 1..5 = c1..c5) covers a region that starts at
# window row/col t.  Shared memory: a ring of 8 weight slots of 4 KB, the x
# window (128 B per pixel), c1..c4 (64 B per pixel), c2's f32 value on c4's
# region, 18 mbarriers and 1 KB of alignment slack.
SM90_TH, SM90_TW, SM90_HALO = 12, 16, 5
SM90_SLOTS, SM90_SLOT_BYTES = 8, 4096
SM90_SMEM_LIMIT = 232448


def _sm90_region(t):
    return (SM90_TH + 2 * (SM90_HALO - t), SM90_TW + 2 * (SM90_HALO - t))


def _weights(seed):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for t in range(5):
        cin, cout = NF + t * GC, (NF if t == 4 else GC)
        ws.append(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32))
        bs.append(rng.normal(0, 0.05, (cout,)).astype(np.float32))
    skw = rng.normal(0, 0.1, (1, 1, NF, GC)).astype(np.float32)
    skb = rng.normal(0, 0.05, (GC,)).astype(np.float32)
    x = lambda h, w: rng.normal(0, 0.5, (h, w, NF)).astype(np.float32)  # noqa: E731
    return ws, bs, skw, skb, x


def _assert_piece_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d <= 0.2 * 2 * 2.0 ** -3 + 2.0 ** -7 * np.abs(want)).all(), d.max()
    assert (d > 0).mean() < 0.2


@pytest.mark.parametrize("hw", [(32, 40), (19, 37)])
def test_plain_matches_jax_rdb_apply(hw):
    ws, bs, skw, skb, mk = _weights(1)
    x = mk(*hw)
    want = np.asarray(rdb_apply(
        jnp.asarray(x), ws, bs, tile_h=16, tile_w=24, skip_w=skw, skip_b=skb,
        add_c2_to_c4=True, interpret=True)).astype(np.float32)
    got = rdb_block_plain(torch.from_numpy(x)[None],
                          pack_rdb_weights(ws, bs, skw, skb))
    assert got.dtype == torch.bfloat16
    _assert_piece_ulp(got[0].float().numpy(), want)


@pytest.mark.parametrize("hw", [(32, 40), (19, 37)])
def test_plain_matches_jax_canvas_path(hw):
    """The product route of the JAX package (canvas in, canvas out)."""
    ws, bs, skw, skb, mk = _weights(2)
    h, w = hw
    x = mk(h, w)
    geom = canvas_geometry(h, w, 16, 32)
    buf = rdb_apply_canvas(rdb_canvas_embed(jnp.asarray(x), geom), ws, bs,
                           geom, h, w, skip_w=skw, skip_b=skb,
                           add_c2_to_c4=True, interpret=True)
    want = np.asarray(rdb_canvas_extract(buf, h, w)).astype(np.float32)
    got = rdb_block(torch.from_numpy(x)[None], pack_rdb_weights(ws, bs, skw, skb))
    _assert_piece_ulp(got[0].float().numpy(), want)


def test_plain_batch_items_are_independent():
    """Batching tiles is bit-neutral up to the conv's own summation order
    (``F.conv2d`` may block a batch of two differently from one)."""
    ws, bs, skw, skb, mk = _weights(3)
    wts = pack_rdb_weights(ws, bs, skw, skb)
    x = torch.from_numpy(np.stack([mk(9, 11), mk(9, 11)]))
    both = rdb_block_plain(x, wts)
    for i in range(2):
        _assert_piece_ulp(both[i].float().numpy(),
                          rdb_block_plain(x[i:i + 1], wts)[0].float().numpy())


def test_pack_layout_and_formats():
    """HWIO arrays and the (9*cin, cout) matrices of the model state pack
    to the same bytes; sizes match the kernel's constants; the 1x1 skip
    and a missing skip bias land where the kernel reads them."""
    ws, bs, skw, _, _ = _weights(4)
    a = pack_rdb_weights(ws, bs, skw, None)
    b = pack_rdb_weights([torch.from_numpy(w.reshape(-1, w.shape[-1])) for w in ws],
                         [torch.from_numpy(v) for v in bs],
                         torch.from_numpy(skw.reshape(NF, GC)), None)
    assert a.wpack.shape == (WPACK_NUMEL,) == (241664,)
    assert a.bpack.shape == (BPACK_NUMEL,) == (224,)
    assert torch.equal(a.wpack, b.wpack) and torch.equal(a.bpack, b.bpack)
    skip_t = torch.from_numpy(skw.reshape(NF, GC).T.copy()).to(torch.bfloat16)
    assert torch.equal(a.wpack[-NF * GC:].reshape(GC, NF), skip_t)
    assert torch.count_nonzero(a.bpack[-GC:]) == 0
    # target 1 reads source x only: its rows are conv 1's (tap, channel) taps
    c1 = torch.from_numpy(ws[0].reshape(9 * NF, GC).T.copy()).to(torch.bfloat16)
    assert torch.equal(a.wpack[:GC * 9 * NF].reshape(GC, 9 * NF), c1)
    with pytest.raises(ValueError, match="does not fit"):
        pack_rdb_weights([ws[1]] + ws[1:], bs, skw)


def _unpack_sm90_block(stream, b):
    """One block of the Hopper kernel's stream back in logical order:
    ``(n, k)`` values, row ``r``'s chunk ``c`` read from its swizzled place."""
    rows = stream[b.offset:b.offset + b.n * b.k].reshape(b.n, b.k // 8, 8)
    return torch.stack([
        torch.cat([rows[r, sm90_swizzle(r, c, b.k)] for c in range(b.k // 8)])
        for r in range(b.n)])


def test_sm90_stream_unpacks_to_pack_rdb_weights():
    """Every (target, source, tap) value of ``pack_rdb_weights`` comes back
    exactly from its block of the Hopper stream; the blocks tile the stream
    with no gap or pad (the stream holds each weight once)."""
    ws, bs, skw, skb, _ = _weights(6)
    a = pack_rdb_weights(ws, bs, skw, skb)
    assert torch.equal(a.wpack_sm90, pack_rdb_weights_sm90(a.wpack))
    stream = a.wpack_sm90.float()
    blocks = sm90_blocks()
    assert len(blocks) == 145
    end = 0
    for b in blocks:
        assert b.offset == end and b.n * b.k * 2 <= SM90_SLOT_BYTES
        end = b.offset + b.n * b.k
        got = _unpack_sm90_block(stream, b)
        if b.s < 0:  # c2's 1x1 skip
            want = torch.from_numpy(skw.reshape(NF, GC).T.copy())
        else:
            dy, dx = divmod(b.tap, 3)
            want = _source_weight(a.wpack, b.t, b.s)[:, b.k0:b.k0 + b.k, dy, dx]
        assert torch.equal(got, want.to(torch.bfloat16).float()), b
    assert end == WPACK_NUMEL == a.wpack_sm90.numel()
    # each (target, source, tap, channel) once: 9 * cin * width per target
    for t in range(5):
        seen = sum(b.n * b.k for b in blocks if b.t == t and b.s >= 0)
        assert seen == 9 * CINS[t] * WIDTHS[t]
    # only a bf16 pack carries the stream (the kernel's dtype)
    assert pack_rdb_weights(ws, bs, skw, skb, dtype=torch.float32).wpack_sm90 is None


def test_sm90_tile_plan():
    """The Hopper kernel's plan as its source states it: shared memory
    within the 232,448 bytes, the 8x576x512 -m r tiles covered once each
    by 12x16 tiles, stage regions shrinking by 2 per conv, 8/7/5/4/3 M
    tiles of 64 pixels, and 1.406x the output's MACs computed."""
    regions = [_sm90_region(t) for t in range(6)]
    assert regions == [(22, 26), (20, 24), (18, 22), (16, 20), (14, 18), (12, 16)]
    px = [r * c for r, c in regions]
    act = px[0] * NF * 2 + sum(px[1:5]) * GC * 2 + px[4] * GC * 4
    assert act == 198144
    smem = 1024 + SM90_SLOTS * SM90_SLOT_BYTES + act + 18 * 8
    assert smem == 232080 <= SM90_SMEM_LIMIT
    assert [-(-p // 64) for p in px[1:]] == [8, 7, 5, 4, 3]
    h, w = 576, 512
    cover = np.zeros((h, w), np.int32)
    for y0 in range(0, h, SM90_TH):
        for x0 in range(0, w, SM90_TW):
            cover[y0:y0 + SM90_TH, x0:x0 + SM90_TW] += 1
    assert (cover == 1).all() and h % SM90_TH == 0 and w % SM90_TW == 0
    assert (h // SM90_TH) * (w // SM90_TW) * 8 == 12288
    # MACs per tile: each stage over its whole region, the 1x1 skip on c2's
    done = sum(px[t + 1] * 9 * CINS[t] * WIDTHS[t] for t in range(5)) + px[2] * NF * GC
    assert done == 65249280 and px[5] * MACS_PER_PIXEL == 46399488
    assert round(done / (px[5] * MACS_PER_PIXEL), 3) == 1.406


def test_cpu_wrapper_takes_the_plain_version_without_a_hopper_stream():
    """On the CPU the wrapper runs the plain version, which reads ``wpack``
    alone: a bf16 pack with its Hopper stream dropped, or an f32 pack (which
    never carries one), gives the plain version's output exactly."""
    ws, bs, skw, skb, mk = _weights(7)
    wts = pack_rdb_weights(ws, bs, skw, skb)
    x = torch.from_numpy(mk(6, 9))[None]
    assert torch.equal(rdb_block(x, wts._replace(wpack_sm90=None)),
                       rdb_block_plain(x, wts))
    f32 = pack_rdb_weights(ws, bs, skw, skb, dtype=torch.float32)
    assert f32.wpack_sm90 is None
    assert torch.equal(rdb_block(x, f32), rdb_block_plain(x, f32))


def test_wrapper_refuses_other_devices_and_shapes():
    ws, bs, skw, skb, mk = _weights(5)
    wts = pack_rdb_weights(ws, bs, skw, skb)
    with pytest.raises(ValueError, match="unsupported device"):
        rdb_block(torch.zeros(1, 4, 4, NF, device="meta"), wts)
    with pytest.raises(ValueError, match="takes"):
        rdb_block(torch.zeros(1, 4, 4, 32), wts)


def _insert_ncnn_splits(g):
    """Every multi-consumer blob gets a Split fanning out one alias per
    consumer, as the real .param files carry (tests/test_rdb_pallas.py:162)."""
    consumers = {}
    for layer in g.layers:
        for b in layer.inputs:
            consumers.setdefault(b, []).append(layer)
    layers = []
    for layer in g.layers:
        layers.append(layer)
        for b in layer.outputs:
            cs = consumers.get(b, [])
            if len(cs) <= 1:
                continue
            aliases = [f"{b}_split_{k}" for k in range(len(cs))]
            layers.append(NcnnLayer("Split", f"split_{b}", [b], aliases))
            for k, c in enumerate(cs):
                c.inputs[c.inputs.index(b)] = aliases[k]
    return NcnnGraph(layers=layers,
                     blob_count=len({b for l in layers for b in l.outputs}))


def _plans(g):
    """The port's and the JAX planner's answers on the same graph."""
    cons = _consumers(g)
    return _plan_rdb_blocks(g, cons), jax_plan(g, cons)


@pytest.mark.parametrize("num_rrdb", [1, 23])
def test_planner_matches_jax(num_rrdb):
    g = make_rrdb_graph(num_rrdb=num_rrdb)
    (blocks, absorbed), (jblocks, jabsorbed) = _plans(g)
    assert len(blocks) == 3 * num_rrdb
    assert blocks == jblocks and absorbed == jabsorbed


def test_planner_absorbs_ncnn_splits():
    g = _insert_ncnn_splits(make_rrdb_graph(num_rrdb=1))
    (blocks, absorbed), (jblocks, jabsorbed) = _plans(g)
    assert len(blocks) == 3 and blocks == jblocks and absorbed == jabsorbed
    assert any(name.startswith("split_") for name in absorbed)


def test_planner_leak_guard():
    g = make_rrdb_graph(num_rrdb=1)
    c1_out = next(l for l in g.layers if l.type == "Convolution"
                  and l.attr_i(0) == 32).outputs[0]
    g.layers.append(NcnnLayer("ReLU", "leak_probe", [c1_out], ["leaked"]))
    (blocks, absorbed), (jblocks, jabsorbed) = _plans(g)
    assert len(blocks) == 2 and blocks == jblocks and absorbed == jabsorbed
    assert "leak_probe" not in absorbed


@pytest.mark.parametrize("attr,bad", [(3, 2), (2, 2), (4, 0)])
def test_planner_rejects_non_same_geometry(attr, bad):
    g = make_rrdb_graph(num_rrdb=1)
    conv = next(l for l in g.layers
                if l.type == "Convolution" and l.attr_i(0) == 32)
    conv.attrs[attr] = bad
    (blocks, absorbed), (jblocks, _) = _plans(g)
    assert len(blocks) == 2 and blocks == jblocks
    assert conv.name not in absorbed


def test_esrgan_variant_has_no_valar_block():
    """Plain basicsr dense blocks (no 1x1 skip, no interior adds) are not
    the Valar block K5 computes: neither planner claims them."""
    g = make_rrdb_graph(num_rrdb=1, variant="esrgan")
    (blocks, _), (jblocks, _) = _plans(g)
    assert blocks == jblocks == []
    jg = jax_rrdb_graph(num_rrdb=1, variant="esrgan")
    assert [l.name for l in g.layers] == [l.name for l in jg.layers]
