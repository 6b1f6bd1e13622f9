"""Multi-GPU serving on the CPU: the port's meshes, ``dp`` and ``sp`` steps
on logical CPU shards against the JAX package's on its 8 host devices
(``tp``'s steps: tests/test_torch_tensor_parallel.py; here its CLI and
``process_file`` runs).

- Mesh helpers against JAX's: ``parse_chips``, ``parse_mesh_spec``,
  ``make_mesh`` (inferred axis, subset, too big) and the out-of-range
  error (``torch.cuda.device_count`` monkeypatched).
- Engine steps in f32 under ``use_chips(..., "dp"|"sp")`` against the JAX
  engine's with the same flags: frames and planar within 1 u8 LSB, at odd
  heights (26 rows over 3 shards, 30 over 4) as in tests/test_parallel.py
  ``TestShippedSpPath``; the ``a,n=3`` chain and a 2-RRDB ``-m r``.
- The port's sp against its own single step on the edge-padded frame
  (bf16, the kernels' plain versions): within 1 LSB.
- ``receptive_radius``: one changed input pixel changes the output only
  within the radius.
- ``configure_chips`` rounding, ``_auto_pipe_pix``'s sp reason, and
  ``process_file`` / ``upscale-only-torch`` with ``--device cpu -g 0,1,2
  --parallel sp`` (and ``-g 0,0,1 --parallel dp``) on a hermetic clip
  against the JAX package's run with the same flags.

Weights are the JAX package's synthetic ones (a numpy seed), carried into
the port by ``params_from_jax`` (``Model``'s constructor).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models.zoo import make_synthetic_model as jax_model
from upscale_video_tpu.models.zoo import make_synthetic_rrdb_model as jax_rrdb
from upscale_video_tpu.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu.parallel import mesh as jax_mesh
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu.pipeline.workflows import upscale_only as jax_upscale_only
from upscale_video_tpu.video.io import Y4MSink
from upscale_video_tpu_torch.cli.upscale_only import main as upscale_only_cli
from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
from upscale_video_tpu_torch.models.zoo import Model, make_srvgg_graph
from upscale_video_tpu_torch.ops.pixel import pad_to_multiple
from upscale_video_tpu_torch.parallel import mesh
from upscale_video_tpu_torch.parallel.data import (
    ShardedStep, data_parallel_fn, shard_batch,
)
from upscale_video_tpu_torch.parallel.spatial import (
    Band, graph_radius, plan_bands, receptive_radius, shard_frame_batch,
    sp_sharded_fn, spatial_forward, whole_frame,
)
from upscale_video_tpu_torch.pipeline import process as port_process
from upscale_video_tpu_torch.pipeline.chain import (
    BatchedStepper, ChainEngine, ChainSpec,
)
from upscale_video_tpu_torch.pipeline.process import process_file
from tests.torch_fixtures import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _frames(seed, n=1, h=26, w=16):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _port(m, dtype=torch.float32, residual=None):
    """The JAX model ``m``'s graph and weights as a port model on the CPU."""
    return Model(m.name, m.scale, m.graph, m.params, CPU, dtype, residual)


# --- mesh helpers -------------------------------------------------------

@pytest.mark.parametrize("chips", [None, "", "0", "0,0,1", "3,1,1,1,2"])
def test_parse_chips_equals_jax(chips):
    assert mesh.parse_chips(chips) == jax_mesh.parse_chips(chips)


def test_parse_chips_invalid_equals_jax():
    for fn in (mesh.parse_chips, jax_mesh.parse_chips):
        with pytest.raises(ValueError, match="invalid chips spec 'a,b'"):
            fn("a,b")


def test_parse_chips_is_chain_s():
    from upscale_video_tpu_torch.pipeline import chain

    assert chain.parse_chips is mesh.parse_chips


@pytest.mark.parametrize("spec", ["dp=2, sp=4", "sp=8", "dp=3,sp=2,"])
def test_parse_mesh_spec_equals_jax(spec):
    assert mesh.parse_mesh_spec(spec) == jax_mesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["dp=2,sp=4", "dp=2,sp=-1", "dp=3,sp=2",
                                  {"sp": 8}, {"dp": -1}])
def test_make_mesh_shape_equals_jax(spec):
    """On eight logical shards, the JAX package's eight host devices."""
    got = mesh.make_mesh(spec, devices=[CPU] * 8)
    assert got.shape == dict(jax_mesh.make_mesh(spec).shape)
    assert got.devices.size == int(np.prod(list(got.shape.values())))


@pytest.mark.parametrize("spec", ["dp=16", "dp=-1,sp=-1", "dp=3,sp=-1"])
def test_make_mesh_errors_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(spec)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(spec, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)


def test_make_mesh_takes_a_repeated_device():
    dev = torch.device("cuda", 0)
    m = mesh.make_mesh({"dp": 2}, devices=[dev, dev])
    assert m.axis_devices("dp") == [dev, dev]
    assert m.distinct_devices() == [dev]


def test_select_devices_out_of_range_equals_jax(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    with pytest.raises(ValueError) as want:
        jax_mesh.select_devices([0, 9, 8])
    with pytest.raises(ValueError) as got:
        mesh.select_devices([0, 9, 8])
    assert str(got.value) == str(want.value) \
        == "chip ids [9, 8] out of range (have 8 devices)"
    assert mesh.select_devices([0, 7]) == [torch.device("cuda", 0),
                                           torch.device("cuda", 7)]


def test_select_devices_one_gpu_refuses_a_second(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"chip ids \[1\] out of range"):
        mesh.select_devices([0, 1])


def test_cpu_chip_ids_are_logical_shards():
    assert mesh.select_devices([0, 5, 11], "cpu") == [CPU] * 3


def test_describe_devices_on_the_cpu():
    assert mesh.describe_devices("cpu") == [
        "chip 0: cpu (the plain PyTorch versions)"]


# --- dp / sp building blocks ----------------------------------------------

def test_shard_batch_divisibility():
    m = mesh.make_mesh({"dp": 4}, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="batch 6 not divisible by dp=4"):
        shard_batch(torch.zeros(6, 2, 2, 3), m)
    parts = shard_batch(torch.arange(8.0).reshape(8, 1), m)
    assert [p.flatten().tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                                     [6, 7]]


def test_data_parallel_fn_one_replica_per_device():
    made = []
    m = mesh.make_mesh({"dp": 3}, devices=[CPU] * 3)
    step = data_parallel_fn(lambda d: made.append(d) or (lambda x: x * 2), m)
    assert isinstance(step, ShardedStep) and made == [CPU]
    out, events = step.launch(np.arange(6, dtype=np.float32).reshape(6, 1))
    assert events == [] and out.flatten().tolist() == [0, 2, 4, 6, 8, 10]


@pytest.mark.parametrize("h,n,radius,period", [
    (26, 3, 4, 1), (27, 3, 0, 1), (30, 4, 7, 8), (16, 4, 3, 8), (5, 8, 2, 1),
])
def test_plan_bands_cover_the_frame(h, n, radius, period):
    bands = plan_bands(h, n, radius, period)
    assert len(bands) == n
    cores = [b for b in bands if b is not None]
    assert cores[0].lo == 0 and cores[-1].hi == h
    for a, b in zip(cores, cores[1:]):
        assert a.hi == b.lo and b.lo % period == 0
    for b in cores:
        assert b.top == max(0, b.lo - radius) and b.bottom == min(h, b.hi + radius)


def test_band_crop_keeps_the_core_at_the_row_ratio():
    b = Band(top=2, bottom=10, lo=4, hi=7, frame_h=12)
    y = torch.arange(16).reshape(1, 16, 1, 1)
    assert b.crop(y).flatten().tolist() == [4, 5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="no multiple"):
        b.crop(torch.zeros(1, 9, 1, 1))


def _small_forward(num_conv=2, feat=8, seed=0):
    g = make_srvgg_graph(scale=2, num_conv=num_conv, num_feat=feat)
    m = jax_model(scale=2, num_conv=num_conv, num_feat=feat, seed=seed,
                  compute_dtype=jnp.float32)
    pm = _port(m)
    return pm, graph_radius(g)


def test_spatial_forward_matches_single_interior_halo():
    """The fixed-halo form with halo >= the receptive field equals the
    single-device forward away from the frame border, as JAX's."""
    pm, rf = _small_forward()
    fwd = pm.frames_forward("model")
    m = mesh.make_mesh("sp=4", devices=[CPU] * 4)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, 32, 16, 3)).astype(np.float32))
    want = fwd(pm.state, x)
    got = spatial_forward(fwd, pm.state, x, m, halo=rf, scale=2)
    assert got.shape == want.shape
    k = 2 * rf
    torch.testing.assert_close(got[:, k:-k], want[:, k:-k], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        spatial_forward(fwd, pm.state, torch.zeros(1, 30, 8, 3), m, halo=2)


def test_spatial_forward_with_dp_and_the_shipped_path():
    """dp x sp fixed-halo form, and the shipped sp wrapper (widened bands)
    on the same forward: the shipped path equals the single forward
    everywhere, the fixed-halo form away from the border."""
    pm, rf = _small_forward(num_conv=1)
    fwd = pm.frames_forward("model")
    m = mesh.make_mesh("dp=2,sp=4", devices=[CPU] * 8)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 16, 8, 3)).astype(np.float32))
    pieces = shard_frame_batch(x, m)
    assert len(pieces) == 2 and all(len(p["parts"]) == 4 for p in pieces)
    torch.testing.assert_close(
        torch.cat([torch.cat(p["parts"], 1) for p in pieces]), x)
    want = fwd(pm.state, x)
    got = spatial_forward(fwd, pm.state, x, m, halo=rf, scale=2,
                          extra_axes=("dp",))
    k = 2 * rf
    torch.testing.assert_close(got[:, k:-k], want[:, k:-k], atol=1e-5, rtol=0)
    shipped = sp_sharded_fn(lambda d: whole_frame(lambda t: fwd(pm.state, t)),
                            mesh.make_mesh("sp=4", devices=[CPU] * 4), rf)
    torch.testing.assert_close(shipped(x), want, atol=1e-6, rtol=0)


# --- engine steps against JAX's -------------------------------------------

def _compact(mode, chips):
    jm = jax_model(scale=2, num_conv=2, num_feat=8, compute_dtype=jnp.float32)
    jeng = JaxEngine(spec=JaxSpec(), scale=2, sr_model=jm)
    jeng.use_chips(chips, mode=mode)
    peng = ChainEngine(spec=ChainSpec(), scale=2, sr_model=_port(jm),
                       device=CPU)
    peng.use_chips(chips, mode=mode)
    return jeng, peng


@pytest.mark.parametrize("chips,h", [("0,1,2", 26), ("0,1,2,3", 30)])
def test_sp_step_odd_height_matches_jax(chips, h):
    jeng, peng = _compact("sp", chips)
    x = _frames(3, n=2, h=h)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2 * h, 32, 3)
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("chips,h", [("0,1,2", 26), ("0,1,2,3", 30)])
def test_sp_planar_step_odd_height_matches_jax(chips, h):
    jeng, peng = _compact("sp", chips)
    assert peng.planar_scale == jeng.planar_scale == 2
    x = _frames(4, n=1, h=h)
    want = np.asarray(jeng.planar_step(jnp.asarray(x)))
    got = peng.planar_step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, h, 16, 12)
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("chips", ["0,1", "0,1,2,3"])
def test_dp_step_matches_jax(chips):
    jeng, peng = _compact("dp", chips)
    x = _frames(5, n=4, h=12)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 24, 32, 3)
    assert _lsb(got, want) <= 1


def test_dp_and_sp_yuv_steps_match_jax():
    """The packed 4:2:0 planar step (the stream plane's default) under both
    modes."""
    for mode in ("dp", "sp"):
        jeng, peng = _compact(mode, "0,1")
        x = _frames(6, n=2, h=12)
        want = np.asarray(jeng.yuv_step(True, planar=True)(jnp.asarray(x)))
        got = peng.yuv_step(True, planar=True)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape and _lsb(got, want) <= 1


@pytest.fixture(scope="module")
def prelude_engines():
    """``a,n=3`` with the JAX synthetic anime and a small SR model, f32."""
    jm = jax_model(scale=2, num_conv=2, num_feat=8, compute_dtype=jnp.float32)
    ja = jax_model(scale=1, num_conv=8, num_feat=24, compute_dtype=jnp.float32)
    spec = "a,n=3"

    def make(mode, chips):
        jeng = JaxEngine(spec=JaxSpec.parse(spec), scale=2, sr_model=jm,
                         anime_model=ja)
        peng = ChainEngine(spec=ChainSpec.parse(spec), scale=2,
                           sr_model=_port(jm), anime_model=_port(ja),
                           device=CPU)
        if chips:
            jeng.use_chips(chips, mode=mode)
            peng.use_chips(chips, mode=mode)
        return jeng, peng

    return make


@pytest.mark.parametrize("mode,chips", [("sp", "0,1,2"), ("dp", "0,1")])
def test_prelude_chain_matches_jax(prelude_engines, mode, chips):
    jeng, peng = prelude_engines(mode, chips)
    x = _frames(7, n=2, h=26, w=20)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 52, 40, 3)
    assert _lsb(got, want) <= 1


def test_prelude_stage_fns_under_sp_match_jax(prelude_engines):
    """The PNG plane's stage steps under sp."""
    jeng, peng = prelude_engines("sp", "0,1,2")
    x = _frames(8, n=1, h=26, w=20)
    for stage in ("denoise", "anime", "sr"):
        want = np.asarray(jeng.stage_fn(stage)(jnp.asarray(x)))
        got = peng.stage_fn(stage)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape and _lsb(got, want) <= 1, stage


@pytest.mark.parametrize("mode,chips", [("sp", "0,1,2"), ("dp", "0,1")])
def test_m_r_two_rrdbs_matches_jax(mode, chips):
    """A 2-RRDB ``-m r`` (f32, tile 8, halo 4): sp deals the padded frame's
    tile rows over the shards."""
    jm = jax_rrdb(scale=4, num_rrdb=2, seed=0, compute_dtype=jnp.float32)
    jm.rdb_kernel = False
    jeng = JaxEngine(spec=JaxSpec(real_life=True), scale=4, sr_model=jm,
                     tile=8, halo=4)
    peng = ChainEngine(spec=ChainSpec(real_life=True), scale=4,
                       sr_model=_port(jm), device=CPU, tile=8, halo=4)
    jeng.use_chips(chips, mode=mode)
    peng.use_chips(chips, mode=mode)
    x = _frames(9, n=2, h=14, w=12)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 56, 48, 3)
    assert _lsb(got, want) <= 1


# --- the port's sp against its own single step ------------------------------

def _bf16_engine(text, tile=0, scale=2):
    from upscale_video_tpu_torch.models.zoo import (
        make_synthetic_model, make_synthetic_rrdb_model,
    )

    spec = ChainSpec.parse(text)
    anime = (make_synthetic_model(scale=1, num_conv=8, num_feat=24)
             if spec.anime else None)
    sr = (make_synthetic_rrdb_model(scale=4, num_rrdb=2,
                                    residual_dtype=torch.float32)
          if spec.real_life else make_synthetic_model(scale=scale, num_conv=4))
    return ChainEngine(spec=spec, scale=4 if spec.real_life else scale,
                       sr_model=sr, anime_model=anime, device=CPU, tile=tile,
                       halo=4)


@pytest.mark.parametrize("text,tile,chips,h", [
    ("", 0, "0,1,2", 26), ("a,n=3", 0, "0,1,2,3", 30), ("r", 8, "0,1,2", 20),
    ("", 8, "0,1", 19), ("n=3,r", 8, "0,1,2,3", 26),
])
def test_port_sp_equals_its_single_step_on_the_padded_frame(text, tile,
                                                            chips, h):
    """bf16 (the kernels' plain versions on the CPU): the sp step is the
    single step on the edge-padded frame, cropped."""
    eng = _bf16_engine(text, tile)
    n = len(chips.split(","))
    x = torch.from_numpy(_frames(10, n=1, h=h, w=20))
    xp, (ph, _) = pad_to_multiple(x, n, 1)
    want = eng.step(xp)
    s = want.shape[1] // xp.shape[1]
    eng.use_chips(chips, mode="sp")
    got = eng.step(x)
    assert got.shape == (1, h * s, want.shape[2], 3)
    assert _lsb(got, want[:, :h * s]) <= 1


def test_sp_refuses_what_cuts_no_rows():
    """sp refuses the contracts that cut no rows; ``--tta`` over a tiled SR
    stage, which it refused before, now runs (each dihedral pass banded on
    its own tile grid: bit for bit the single step on the padded frame),
    and so does ``--parallel tp``, which takes every contract (equal to
    the single step within 1 LSB)."""
    eng = _bf16_engine("")
    single = _bf16_engine("")
    single.sr_model = eng.sr_model
    eng.use_chips("0,1", mode="sp")
    assert not eng.input_rank_flexible and eng.row_sharded
    with pytest.raises(ValueError, match="planar packed"):
        eng.yuv_step(True, planar=False)
    with pytest.raises(ValueError, match="planar packed"):
        eng.yuv_step(True, planar=True, i420_in=(12, 16, True))
    tta = _bf16_engine("r", tile=8)
    tta.tta = True
    x = torch.from_numpy(_frames(13, n=1, h=11, w=12))
    want = tta.step(pad_to_multiple(x, 2, 1)[0])[:, :44]
    tta.use_chips("0,1", mode="sp")
    assert _lsb(tta.step(x), want) == 0
    eng.use_chips("0,1", mode="tp")
    assert eng.input_rank_flexible and not eng.row_sharded
    x = torch.from_numpy(_frames(14, n=2, h=12, w=16))
    assert _lsb(eng.yuv_step(True, planar=False)(x),
                single.yuv_step(True, planar=False)(x)) <= 1


# --- receptive radius ------------------------------------------------------

def test_graph_radius_of_the_shipped_graphs():
    from upscale_video_tpu_torch.models.zoo import make_rrdb_graph

    assert graph_radius(make_srvgg_graph()) == 18  # 17 body convs + conv_up
    assert graph_radius(make_srvgg_graph(scale=1, num_conv=8,
                                         num_feat=24)) == 10
    # 23 RRDBs x 3 blocks x 5 convs + first + trunk at 1x, 2 up + hr + last
    # at 2x and 4x each read one input row
    assert graph_radius(make_rrdb_graph(num_rrdb=23)) == 351
    eng = _bf16_engine("a,n=3")
    assert receptive_radius(eng) == 6 + 10 + 6
    assert receptive_radius(eng, sr=False) == 16


@pytest.mark.parametrize("text,seed", [("", 0), ("", 1), ("a,n=3", 2),
                                       ("a", 3)])
def test_one_pixel_reaches_only_its_radius(text, seed):
    """Change one input pixel: only output rows and columns within the
    receptive radius of it (scaled) change."""
    spec = ChainSpec.parse(text)
    anime = (_port(jax_model(scale=1, num_conv=8, num_feat=24,
                             compute_dtype=jnp.float32))
             if spec.anime else None)
    eng = ChainEngine(spec=spec, scale=2, device=CPU, anime_model=anime,
                      sr_model=_port(jax_model(scale=2, num_conv=3, num_feat=8,
                                               seed=seed,
                                               compute_dtype=jnp.float32)))
    r = receptive_radius(eng)
    rng = np.random.default_rng(seed)
    h, w = 2 * r + 12, 2 * r + 10
    x = torch.from_numpy(_frames(seed, n=1, h=h, w=w))
    y = eng.step(x)
    py, px = int(rng.integers(0, h)), int(rng.integers(0, w))
    x2 = x.clone()
    x2[0, py, px] = 255 - x2[0, py, px]
    diff = (eng.step(x2).int() - y.int()).abs().sum(dim=(0, 3))
    rows, cols = torch.nonzero(diff, as_tuple=True)
    assert len(rows), "the change reached no output pixel"
    s = y.shape[1] // h
    assert rows.min() >= s * (py - r) and rows.max() < s * (py + r + 1)
    assert cols.min() >= s * (px - r) and cols.max() < s * (px + r + 1)


# --- configure_chips, the stepper, pipe_pix ---------------------------------

@pytest.mark.parametrize("chips,mode,fps", [
    ("0,0,1", "dp", 1), ("0,0,1", "dp", 3), ("0,1,2", "dp", 4),
    ("0,0,1", "sp", 3), ("0,0", "dp", 4), (None, "dp", 5),
])
def test_configure_chips_rounding_equals_jax(chips, mode, fps):
    jm = jax_model(scale=2, num_conv=1, num_feat=4, compute_dtype=jnp.float32)
    jeng = JaxEngine(spec=JaxSpec(), scale=2, sr_model=jm)
    peng = ChainEngine(spec=ChainSpec(), scale=2, sr_model=_port(jm),
                       device=CPU)
    got = peng.configure_chips(chips, fps, mode)
    assert got == jeng.configure_chips(chips, fps, mode)
    n = len(mesh.parse_chips(chips)[0])
    assert (peng._mesh is None) == (n == 1)
    if chips == "0,0,1" and mode == "dp":
        assert got % 2 == 0 and got >= 2 * fps


def test_batched_stepper_takes_a_mesh_step():
    """The stepper hands its buffer to the mesh step, one batch behind."""
    eng = _bf16_engine("")
    single = eng.step
    eng.use_chips("0,1,2", mode="dp")
    frames = _frames(11, n=7, h=8, w=10)
    st = BatchedStepper(eng.step, 3, CPU)
    out = []
    for f in frames:
        out.extend(st.feed(f))
    out.extend(st.flush())
    want = single(torch.from_numpy(frames)).numpy()
    assert len(out) == 7 and _lsb(np.stack(out), want) <= 1


class _Backend:
    def __init__(self, h, w):
        self.h, self.w = h, w

    def source_geometry(self, info, crop):
        return self.h, self.w

    def auto_yuv420(self, info):
        return True


@pytest.mark.parametrize("text,tile,want", [
    ("", 0, "yuv420p"), ("r", 8, "rgb24"), ("", 8, "rgb24"),
])
def test_auto_pipe_pix_sp_reason(caplog, text, tile, want):
    eng = _bf16_engine(text, tile)
    assert port_process._auto_pipe_pix(_Backend(12, 16), eng, {}, None,
                                       "stream") == "yuv420p"
    eng.use_chips("0,1", mode="sp")
    caplog.set_level(logging.INFO)
    caplog.clear()
    assert port_process._auto_pipe_pix(_Backend(12, 16), eng, {}, None,
                                       "stream") == want
    if want == "rgb24":
        assert any("sp row-sharding needs the even planar contract"
                   in r.getMessage() for r in caplog.records)


# --- end to end against the JAX package ------------------------------------

N_FRAMES, H, W = 5, 13, 16


def _write_clip(path, c420):
    frames = np.random.default_rng(12).integers(
        0, 256, (N_FRAMES, 2 * (H // 2) if c420 else H, W, 3), dtype=np.uint8)
    h = frames.shape[1]
    if c420:
        packed = np.asarray(yuv420_from_frames(jnp.asarray(frames), True))
        with Y4MSink(path, W, h, "24/1", colorspace="C420jpeg") as s:
            for p in packed:
                s.write(packed_to_i420(p, 2))
    else:
        with Y4MSink(path, W, h, "24/1") as s:
            for f in frames:
                s.write(f)


def _payload(path):
    with open(path, "rb") as f:
        header, _, body = f.read().partition(b"\n")
    return header, np.stack([np.frombuffer(c, np.uint8)
                             for c in body.split(b"FRAME\n")[1:]])


@pytest.mark.parametrize("chips,mode,c420", [
    ("0,1,2", "sp", False), ("0,1,2", "sp", True), ("0,0,1", "dp", False),
    ("0,1", "dp", True), ("0,1", "tp", False), ("0,1,2,3", "tp", True),
], ids=["sp_c444", "sp_c420", "dp_c444", "dp_c420", "tp_c444", "tp_c420"])
def test_process_file_matches_jax(tmp_path, chips, mode, c420):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420)
    jm = jax_model(scale=2, num_conv=2, num_feat=8, compute_dtype=jnp.float32)
    jeng = JaxEngine(spec=JaxSpec(), scale=2, sr_model=jm)
    peng = ChainEngine(spec=ChainSpec(), scale=2, sr_model=_port(jm),
                       device=CPU)
    kw = dict(temp_dir=None, batch_size=-2, chips=chips, parallel_mode=mode)
    jres = jax_process(src, str(tmp_path / "jax.y4m"), engine=jeng,
                       **{**kw, "temp_dir": str(tmp_path / "jw")})
    pres = process_file(src, str(tmp_path / "port.y4m"), engine=peng,
                        device="cpu", **{**kw, "temp_dir": str(tmp_path / "pw")})
    assert pres.pipe_pix == jres.pipe_pix
    assert pres.frames_processed == jres.frames_processed == N_FRAMES
    jh, jf = _payload(str(tmp_path / "jax.y4m"))
    ph, pf = _payload(str(tmp_path / "port.y4m"))
    assert ph == jh and pf.shape == jf.shape and _lsb(pf, jf) <= 1


@pytest.mark.parametrize("chips,mode", [("0,1,2", "sp"), ("0,0,1", "dp"),
                                        ("0,1", "tp")])
def test_cli_runs_several_shards_like_jax(tmp_path, chips, mode):
    """``upscale-video-torch --device cpu -g ... --parallel ...`` (the
    synthetic 2x Compact, f32) end to end, against the JAX package's
    ``process_file`` with the same flags."""
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    out = str(tmp_path / "port.y4m")
    assert cli_main(["-i", src, "-o", out, "-t", str(tmp_path / "pw"),
                     "--synthetic_models", "--precision", "f32", "-g", chips,
                     "--parallel", mode, "--device", "cpu"]) == 0
    jax_process(src, str(tmp_path / "jax.y4m"), temp_dir=str(tmp_path / "jw"),
                chips=chips, parallel_mode=mode, synthetic_models=True,
                precision="f32")
    jh, jf = _payload(str(tmp_path / "jax.y4m"))
    ph, pf = _payload(out)
    assert ph == jh and pf.shape == jf.shape and _lsb(pf, jf) <= 1


def test_upscale_only_sp_matches_jax(tmp_path):
    """``upscale-only-torch --device cpu -g 0,1,2 --parallel sp`` against
    the JAX ``upscale_only`` with the same flags: the zipped PNGs."""
    import zipfile

    from upscale_video_tpu_torch.video.png import read_png

    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    common = ["-i", src, "-b", "-1", "--synthetic_models", "--precision",
              "f32", "-g", "0,1,2", "--parallel", "sp"]
    assert upscale_only_cli(common + ["-t", str(tmp_path / "p"),
                                      "--device", "cpu"]) == 0
    jax_upscale_only(src, temp_dir=str(tmp_path / "j"), batch_size=-1,
                     synthetic_models=True, precision="f32", chips="0,1,2",
                     parallel_mode="sp")
    dirs = []
    for d in ("p", "j"):
        with zipfile.ZipFile(str(tmp_path / d / "upscale_video" / "1.zip")) as z:
            z.extractall(str(tmp_path / f"{d}_png"))
        dirs.append(tmp_path / f"{d}_png")
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == N_FRAMES
    for name in names:
        got, want = (read_png(str(d / name)) for d in dirs)
        assert got.shape == want.shape == (2 * H, 2 * W, 3)
        assert _lsb(got, want) <= 1


def test_process_file_initializes_multihost(tmp_path, monkeypatch):
    """``process_file`` joins the process group (a no-op without the
    environment) before it builds the engine, as the JAX one does."""
    called = []
    monkeypatch.setattr(port_process, "initialize_multihost",
                        lambda backend: called.append(backend) or 1)
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=False)
    process_file(src, temp_dir=str(tmp_path / "t"), synthetic_models=True,
                 precision="f32", device="cpu", chips="0,1",
                 parallel_mode="sp")
    assert called == ["gloo"]
    assert os.path.exists(str(tmp_path / "in.2x.y4m"))
