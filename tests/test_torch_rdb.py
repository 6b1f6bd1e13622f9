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
import torch.nn.functional as F

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
    B_OFFS, BPACK_NUMEL, C2F_CH, CINS, MACS_PER_PIXEL, SCRATCH_CH, SKIP_B_OFF,
    STAGE_CHUNKS, WIDTHS, WPACK_NUMEL, _source_weight, pack_rdb_weights,
    pack_rdb_weights_sm90, rdb_block, rdb_block_plain, sm90_blocks,
    sm90_gather_index, sm90_slices,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401

# The stage plan that csrc/rdb_block_sm90.cu states (its static_asserts hold
# the same numbers at compile time): tiles of 2 output rows x 64 columns,
# each consumer's halo in a top and a bottom part of 2 rows x 66 columns x
# 128 B (1024-aligned), 64-channel weight slices of 9 taps x 32 lines x 128
# B resident (c2's skip one more tap block), three consumers (two in stage
# 2), 4 mbarriers a consumer, a bias and a skip bias per column, 1 KB of
# alignment slack.
SM90_KR, SM90_TW = 2, 64
SM90_WGS = (3, 2, 3, 3, 3)
SM90_PART = -(-2 * 66 * 128 // 1024) * 1024
SM90_TAP = 32 * 128
SM90_SMEM_LIMIT = 232448


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


def _sm90_block_want(a, skw, b):
    """What block ``b`` of the Hopper pack must hold, from
    ``pack_rdb_weights``' values: ``(32, k)``, row = output channel ``32 *
    chunk + row``, column = channel of the slice (c_s's 32, then
    c_{s+1}'s)."""
    rows = slice(GC * b.chunk, GC * (b.chunk + 1))
    if b.s < 0:
        return torch.from_numpy(skw.reshape(NF, GC).T.copy())[rows]
    dy, dx = divmod(b.tap, 3)
    srcs = [b.s] if b.s == 0 else range(b.s, b.s + b.k // GC)
    return torch.cat([_source_weight(a.wpack, b.t, s)[rows, :, dy, dx]
                      for s in srcs], dim=1)


@pytest.mark.parametrize("t", range(5))
def test_sm90_pack_unpacks_to_pack_rdb_weights(t):
    """Stage ``t``'s part of the Hopper pack, for every cout chunk, slice
    and tap, holds exactly ``pack_rdb_weights``' values in the order the
    stage copies them; the stages' parts tile the pack with no gap or pad,
    and the pack is a permutation of ``wpack`` (each value once)."""
    ws, bs, skw, skb, _ = _weights(6)
    a = pack_rdb_weights(ws, bs, skw, skb)
    assert torch.equal(a.wpack_sm90, pack_rdb_weights_sm90(a.wpack))
    idx = sm90_gather_index()
    assert torch.equal(torch.sort(idx).values, torch.arange(WPACK_NUMEL))
    blocks = sm90_blocks()
    assert [b.offset for b in blocks] == list(np.cumsum(
        [0] + [GC * b.k for b in blocks[:-1]]))
    stage = [b for b in blocks if b.t == t]
    assert sorted({b.chunk for b in stage}) == list(range(STAGE_CHUNKS[t]))
    pack = a.wpack_sm90.float()
    for b in stage:
        got = pack[b.offset:b.offset + GC * b.k].reshape(GC, b.k)
        assert torch.equal(got, _sm90_block_want(a, skw, b).to(
            torch.bfloat16).float()), b
    # each (output, source, tap, channel) of target t once; stage 2 also the skip
    want = 9 * CINS[t] * WIDTHS[t] + (GC * NF if t == 1 else 0)
    assert sum(GC * b.k for b in stage) == want
    assert pack_rdb_weights(ws, bs, skw, skb, dtype=torch.float32).wpack_sm90 is None


def _sm90_pack_weight(pack, t, chunk, i):
    """Slice ``i`` of stage ``t``'s chunk as the stage keeps it: OIHW
    ``(32, k, 3, 3)`` (``(32, 64, 1, 1)`` for the skip)."""
    blk = [b for b in sm90_blocks() if (b.t, b.chunk, b.slice) == (t, chunk, i)]
    taps = [pack[b.offset:b.offset + GC * b.k].reshape(GC, b.k) for b in blk]
    if blk[0].s < 0:
        return taps[0][:, :, None, None]
    return torch.stack(taps, -1).reshape(GC, blk[0].k, 3, 3)


def _sm90_walk(x, wts):
    """The Hopper stages' walk in f32 on the CPU, from the pack: each slice
    read from x or from the c1..c4 scratch at its channels, a slice of two
    c sources drained at its 32-channel boundary, each piece rounded to bf16
    and added in the walk's order, then each stage's epilogue.  Unwritten
    scratch channels are NaN, so a read of one shows in the output.
    Returns the block's output and per stage the log of what it read and
    wrote: ``("read", buffer, c0, c1)``, ``("piece", source)``, ``("write",
    buffer, c0, c1)``."""
    pack = wts.wpack_sm90.float()
    bp = wts.bpack.float()
    n, h, w, _ = x.shape
    xs = x.to(torch.bfloat16).permute(0, 3, 1, 2).float()
    scratch = torch.full((n, SCRATCH_CH, h, w), float("nan"))
    c2f = torch.full((n, C2F_CH, h, w), float("nan"))
    out = torch.full((n, NF, h, w), float("nan"))
    rnd = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    logs = []
    for t in range(5):
        log = []
        for chunk in range(STAGE_CHUNKS[t]):
            tot = skip = None
            for i, (s, k) in enumerate(sm90_slices(t)):
                wt = _sm90_pack_weight(pack, t, chunk, i)
                if s < 0:
                    skip = F.conv2d(xs, wt)
                    continue
                c0 = 0 if s == 0 else GC * (s - 1)
                log.append(("read", "x" if s == 0 else "scratch", c0, c0 + k))
                src = xs if s == 0 else scratch[:, c0:c0 + k]
                step = NF if s == 0 else GC
                for p in range(0, k, step):
                    log.append(("piece", s + p // GC))
                    piece = rnd(F.conv2d(src[:, p:p + step].contiguous(),
                                         wt[:, p:p + step].contiguous(),
                                         padding=1))
                    tot = piece if tot is None else tot + piece
            cols = slice(B_OFFS[t] + GC * chunk, B_OFFS[t] + GC * (chunk + 1))
            val = tot + bp[cols].view(1, -1, 1, 1)
            if t == 4:
                o = slice(GC * chunk, GC * (chunk + 1))
                out[:, o] = rnd(xs[:, o] + 0.2 * val)
                log.append(("write", "out", o.start, o.stop))
                continue
            val = torch.where(val >= 0, val, val * wts.slope)
            if t == 1:
                val = val + (skip + bp[SKIP_B_OFF:].view(1, -1, 1, 1))
                c2f[:] = val
                log.append(("write", "c2f", 0, C2F_CH))
            elif t == 3:
                log.append(("read", "c2f", 0, C2F_CH))
                val = val + c2f
            scratch[:, GC * t:GC * (t + 1)] = rnd(val)
            log.append(("write", "scratch", GC * t, GC * (t + 1)))
        logs.append(log)
    return out.permute(0, 2, 3, 1).to(torch.bfloat16), logs


@pytest.mark.parametrize("t", range(5))
def test_sm90_stage_plan(t):
    """Stage ``t``'s plan as csrc/rdb_block_sm90.cu states it, walked from
    the pack on the CPU: its slices read x and the scratch channels earlier
    stages wrote (c_s at 32 (s - 1)), a c slice drains at its 32-channel
    boundary, the pieces follow the plain version's source order (stage 2:
    c1 then x, a sum of two), c2's f32 value is written by stage 2 and read
    by stage 4 only, the stage writes its own 32 scratch channels (c5 the
    output, in two chunks), and its shared memory fits.  The whole walk
    agrees with ``rdb_block_plain`` to its pieces' rounding."""
    ws, bs, skw, skb, mk = _weights(8)
    wts = pack_rdb_weights(ws, bs, skw, skb)
    x = torch.from_numpy(mk(7, 10))[None]
    got, logs = _sm90_walk(x, wts)
    assert bool(torch.isfinite(got.float()).all())
    _assert_piece_ulp(got[0].float().numpy(),
                      rdb_block_plain(x, wts)[0].float().numpy())
    log = logs[t]
    pieces = [e[1] for e in log if e[0] == "piece"]
    order = [1, 0] if t == 1 else list(range(t + 1))
    assert pieces == order * STAGE_CHUNKS[t]
    written = {("x", c) for c in range(NF)}
    for e in (e for lg in logs[:t] for e in lg if e[0] == "write"):
        written |= {(e[1], c) for c in range(e[2], e[3])}
    reads = [e for e in log if e[0] == "read"]
    for _, buf, c0, c1 in reads:
        assert {(buf, c) for c in range(c0, c1)} <= written
        assert buf != "scratch" or (c0 % 64 == 0 and c1 - c0 in (GC, 2 * GC))
    assert (("read", "c2f", 0, C2F_CH) in log) == (t == 3)
    writes = [e for e in log if e[0] == "write"]
    if t == 4:
        assert writes == [("write", "out", 0, GC), ("write", "out", GC, NF)]
    else:
        assert ("write", "scratch", GC * t, GC * (t + 1)) in writes
        assert (("write", "c2f", 0, C2F_CH) in writes) == (t == 1)
    # shared memory: the weights of the stage's slices (+ the skip), two
    # consumers' two parts, barriers and the per-column constants
    nslice = len([1 for s, _ in sm90_slices(t) if s >= 0])
    smem = (1024 + (nslice * 9 + (t == 1)) * SM90_TAP
            + SM90_WGS[t] * (2 * SM90_PART + 4 * 8) + 2 * GC * 4)
    assert smem <= SM90_SMEM_LIMIT and (t < 3 or smem == 216416)
    # tiles of 2 rows x 64 columns cover the -m r batch once each
    assert (576 // SM90_KR) * (512 // SM90_TW) * 8 == 18432
    assert MACS_PER_PIXEL == sum(9 * CINS[u] * WIDTHS[u] for u in range(5)) + NF * GC


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
