"""The pre-SR stages on the CPU: ``n=K`` (NL-means, K6's plain version),
``a`` (the 1x SubCompact anime deblur), ``--tta`` and scale 1, against the
JAX package on numpy-seeded inputs and byte-identical synthetic weights.

Tolerances, each with its reason:

- NL-means: ``atol=2e-6`` against both JAX versions, the JAX package's
  own tolerance between them (tests/test_nlmeans_pallas.py:26).  Only the
  f32 summation order of the box sums and the channel mean differs.
- f32 steps (the port's aten route and K6's plain version, the JAX XLA
  path): within 1 u8 LSB, PARITY.md's contract.
- bf16 ``a,n=3``: within 1 u8 LSB of the JAX Pallas path
  (``conv_impl="pallas"``), which rounds at the same points as K1/K2 (once
  per conv, after bias and activation).
- mixed ``a,r``: within 1 u8 LSB of the JAX fused-RDB path with the anime
  chain on the JAX chain kernel (K5's per-source piece ulps,
  tests/test_torch_valar.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models.executor import build_forward as jax_build_forward
from upscale_video_tpu.models.zoo import make_synthetic_model as jax_model
from upscale_video_tpu.models.zoo import make_synthetic_rrdb_model as jax_rrdb_model
from upscale_video_tpu.ops.nlmeans import nl_means_denoise as jax_nlm
from upscale_video_tpu.ops.nlmeans_pallas import nl_means_denoise_pallas
from upscale_video_tpu.ops.tta import dihedral as jax_dihedral
from upscale_video_tpu.ops.tta import inverse_dihedral as jax_inverse
from upscale_video_tpu.ops.yuv import packed_to_i420, yuv420_from_frames
from upscale_video_tpu.pipeline.chain import ChainEngine as JaxEngine
from upscale_video_tpu.pipeline.chain import ChainSpec as JaxSpec
from upscale_video_tpu.pipeline.process import process_file as jax_process
from upscale_video_tpu.video.io import Y4MSink
from upscale_video_tpu_torch.cli.upscale_video import main as cli_main
from upscale_video_tpu_torch.models.executor import GraphForward, build_forward
from upscale_video_tpu_torch.models.zoo import (
    make_srvgg_graph, make_synthetic_model, make_synthetic_rrdb_model,
    params_from_jax,
)
from upscale_video_tpu_torch.ops import nlmeans
from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain
from upscale_video_tpu_torch.ops.nlmeans import (
    MAX_GRID_YZ, OUT_COLS, ROWS, TILE_H, TILE_W, WARPS_X, WARPS_Y,
    nl_means_denoise, nl_means_denoise_plain, nlm_launch_plan, reflect_index,
)
from upscale_video_tpu_torch.ops.tta import dihedral, inverse_dihedral
from upscale_video_tpu_torch.pipeline.chain import ChainEngine, ChainSpec
from upscale_video_tpu_torch.pipeline.process import process_file
from tests.torch_fixtures import one_torch_thread  # noqa: F401


def _max_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _u8(y):
    return np.clip(np.round(np.asarray(y, np.float32) * 255.0), 0, 255).astype(np.uint8)


def _smooth(seed, h, w, noise=0.03):
    """An image-like frame (a gradient plus noise) in [0, 1]: the search
    finds similar patches, so the NL-means weights are far from 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (0.5 + 0.3 * np.sin(xx / 5.0 + yy / 7.0))[..., None]
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 1).astype(np.float32)


def _frames(seed, n=2, h=16, w=24):
    """uint8 frames of image-like content."""
    return np.stack([_u8(_smooth(seed + i, h, w)) for i in range(n)])


# --- NL-means: the plain version against both JAX versions -----------------

@pytest.mark.parametrize("sigma", [0.0, 5.0])
@pytest.mark.parametrize("h", [1.0, 3.0, 30.0])
@pytest.mark.parametrize("hw", [(16, 32), (19, 37)], ids=["tile", "ragged"])
def test_nl_means_plain_matches_jax(hw, h, sigma):
    x = _smooth(1, *hw)
    got = nl_means_denoise_plain(torch.from_numpy(x)[None], h, sigma)[0].numpy()
    want = np.asarray(jax_nlm(jnp.asarray(x), h, sigma))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    pallas = np.asarray(nl_means_denoise_pallas(jnp.asarray(x), h, sigma,
                                                interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-6, rtol=0)


def test_nl_means_plain_matches_jax_on_noise():
    """Uniform noise: no similar patches, the off-centre weights vanish."""
    x = np.random.default_rng(2).uniform(0, 1, (16, 32, 3)).astype(np.float32)
    got = nl_means_denoise_plain(torch.from_numpy(x)[None], 10.0)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jax_nlm(jnp.asarray(x), 10.0)),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("hw", [(5, 4), (1, 3), (2, 9)])
def test_nl_means_small_frames_fold_the_reflection(hw):
    """Frames under 7 pixels on a side: numpy's reflect pad of 6 folds more
    than once; the index map is numpy's and the result the JAX one."""
    for n in hw:
        want = np.pad(np.arange(n), 6, mode="reflect")
        np.testing.assert_array_equal(reflect_index(n, 6), want)
    x = _smooth(3, *hw)
    got = nl_means_denoise_plain(torch.from_numpy(x)[None], 30.0)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jax_nlm(jnp.asarray(x), 30.0)),
                               atol=2e-6, rtol=0)


def test_nl_means_constant_frame_is_a_fixed_point():
    x = torch.full((2, 16, 32, 3), 0.37)
    np.testing.assert_allclose(nl_means_denoise_plain(x, 20.0).numpy(), 0.37,
                               atol=1e-6)


def test_nl_means_batch_frames_are_independent():
    x = torch.from_numpy(np.stack([_smooth(4, 12, 16), _smooth(5, 12, 16)]))
    both = nl_means_denoise(x, 3.0)
    for i in range(2):
        torch.testing.assert_close(both[i:i + 1], nl_means_denoise(x[i:i + 1], 3.0),
                                   rtol=0, atol=0)


def test_nl_means_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        nl_means_denoise(torch.zeros(1, 4, 4, 3, device="meta"), 3.0)
    before = nl_means_denoise.launches
    nl_means_denoise(torch.zeros(1, 4, 4, 3), 3.0)
    assert nl_means_denoise.launches == before  # the CPU runs the plain version


# --- K6's launch plan (the grid csrc/nlmeans_sm90.cu launches) -------------

def _covered(grid, h, w):
    """How often the kernel stores each pixel of one frame on ``grid``:
    block (bx, by), warp wy * WARPS_X + wx, lane < 28 and strip row r store
    (by TILE_H + wy ROWS + r, bx TILE_W + wx 28 + lane) where in the frame."""
    count = np.zeros((h, w), np.int64)
    for wy in range(WARPS_Y):
        for wx in range(WARPS_X):
            ys = (np.arange(grid[1])[:, None] * TILE_H + wy * ROWS
                  + np.arange(ROWS)[None, :]).ravel()
            xs = (np.arange(grid[0])[:, None] * TILE_W + wx * OUT_COLS
                  + np.arange(OUT_COLS)[None, :]).ravel()
            ys, xs = ys[ys < h], xs[xs < w]
            np.add.at(count, (ys[:, None], xs[None, :]), 1)
    return count


@pytest.mark.parametrize("nhw", [(1, 1, 1), (1, 5, 4), (1, 7, 33), (2, 37, 53),
                                 (3, 70, 97), (1, 24, 28), (1, 25, 29),
                                 (4, 1080, 1920)])
def test_nl_means_plan_covers_every_pixel_once(nhw):
    n, h, w = nhw
    grid = nlm_launch_plan(n, h, w)
    assert grid[2] == n
    np.testing.assert_array_equal(_covered(grid, h, w), 1)
    # no block lies wholly outside the frame
    assert (grid[0] - 1) * TILE_W < w <= grid[0] * TILE_W
    assert (grid[1] - 1) * TILE_H < h <= grid[1] * TILE_H
    assert grid[1] <= MAX_GRID_YZ and n <= MAX_GRID_YZ
    assert grid[0] <= 2 ** 31 - 1
    assert 32 * WARPS_X * WARPS_Y <= 1024


def test_nl_means_plan_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError, match="grid limit"):
        nlm_launch_plan(MAX_GRID_YZ + 1, 8, 8)
    with pytest.raises(ValueError, match="grid limit"):
        nlm_launch_plan(1, MAX_GRID_YZ * TILE_H + 1, 8)
    nlm_launch_plan(MAX_GRID_YZ, MAX_GRID_YZ * TILE_H, 8)
    with pytest.raises(ValueError, match="empty"):
        nlm_launch_plan(1, 0, 8)


# --- the anime model: the graph and its forward ----------------------------

def test_anime_forward_is_one_k1_chain():
    g = make_srvgg_graph(scale=1, num_conv=8, num_feat=24)
    fwd = build_forward(g, "cpu", torch.bfloat16, "model")
    assert isinstance(fwd, GraphForward) and not fwd.rdb_triggers
    assert list(fwd.chains) == ["conv_0"]
    items = fwd.chains["conv_0"]["items"]
    assert [it["name"] for it in items] == [f"conv_{i}" for i in range(9)] + ["conv_up"]
    assert all(it["prelu"] for it in items[:-1]) and items[-1]["prelu"] is None
    assert fwd.chains["conv_0"]["out"] == "pre_shuffle"
    # the tail: PixelShuffle(1), Interp(1) and the add stay generic ops
    assert {l.name for l in g.layers if l.type != "Input"} - fwd.chain_absorbed \
        == {"split_in", "conv_0", "shuffle", "skip_up", "residual"}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_anime_forward_matches_jax(precision):
    """f32 against the JAX XLA path; bf16 against the JAX chain kernel
    (``pallas_conv=True``, interpret mode), the K1 rounding points."""
    jd, td = ((jnp.float32, torch.float32) if precision == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    m = jax_model(scale=1, num_conv=8, num_feat=24, seed=3)
    x = np.stack([_smooth(6, 14, 20), _smooth(7, 14, 20)])
    want = np.asarray(jax_build_forward(m.graph, jd, pallas_conv=precision == "bf16")(
        m.params, jnp.asarray(x)))
    fwd = build_forward(make_srvgg_graph(scale=1, num_conv=8, num_feat=24),
                        "cpu", td, "model")
    state = params_from_jax(m.params, "cpu", td)
    before = conv3x3_chain.launches
    got = fwd(state, torch.from_numpy(x))
    assert conv3x3_chain.launches == before
    assert got.dtype == torch.float32 and got.shape == (2, 14, 20, 3)
    assert _max_lsb(_u8(got.numpy()), _u8(want)) <= 1
    if precision == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_anime_mixed_add_is_f32():
    """Under ``mixed`` (``-m a,r``) the anime model's skip add runs in f32
    on bf16 operands, as the JAX executor's spine cast does: the output
    holds values bf16 cannot, and equals JAX's within one bf16 ulp of the
    chain's output (a rounding that lands an ulp apart)."""
    m = make_synthetic_model(scale=1, num_conv=8, num_feat=24,
                             residual_dtype=torch.float32)
    x = torch.from_numpy(_smooth(8, 10, 12))[None]
    y = m(x, "model")
    jm = jax_model(scale=1, num_conv=8, num_feat=24)
    jm.pallas_conv, jm.residual_dtype = True, jnp.float32
    want = np.asarray(jm.forward(jm.params, jnp.asarray(x.numpy())))
    assert y.dtype == torch.float32 and want.dtype == np.float32
    assert not torch.equal(y, y.to(torch.bfloat16).to(torch.float32))
    np.testing.assert_allclose(y.numpy(), want, atol=2 ** -7, rtol=0)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_pixelshuffle_op_equals_jax(r, mode):
    from upscale_video_tpu.models import executor as jax_executor
    from upscale_video_tpu_torch.models import ops as port_ops
    from upscale_video_tpu_torch.models.param_parser import NcnnLayer

    layer = NcnnLayer("PixelShuffle", "ps", ["a"], ["b"], {0: r, 1: mode})
    x = np.random.default_rng(9).normal(0, 1, (2, 3, 5, 2 * r * r)).astype(np.float32)
    want = np.asarray(jax_executor._op_pixelshuffle(layer, [jnp.asarray(x)], {},
                                                    jnp.float32))
    got = port_ops.op_pixelshuffle(layer, [torch.from_numpy(x)], None,
                                   torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


# --- the engine: a,n=3 + 2x Compact, against the JAX ChainEngine ----------

@pytest.fixture(scope="module")
def f32_engines():
    spec = "a,n=3"
    jax_eng = JaxEngine.build(JaxSpec.parse(spec), 2, compute_dtype=jnp.float32,
                              synthetic=True)
    port = ChainEngine.build(ChainSpec.parse(spec), 2, "cpu",
                             compute_dtype=torch.float32, synthetic=True)
    return jax_eng, port


def test_engine_build_loads_the_prelude(f32_engines):
    _, port = f32_engines
    assert port.describe() == "denoise(h=3) -> anime-deblur -> compact-sr (scale 2x)"
    assert port.anime_model is not None and port.anime_model.scale == 1
    assert port.planar_scale == 2


def test_prelude_step_matches_jax(f32_engines):
    jax_eng, port = f32_engines
    frames = _frames(10)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 32, 48, 3)
    assert _max_lsb(got, want) <= 1


def test_prelude_planar_step_matches_jax(f32_engines):
    jax_eng, port = f32_engines
    frames = _frames(11)
    assert jax_eng.planar_scale == 2
    want = np.asarray(jax_eng.planar_step(jnp.asarray(frames)))
    got = port.planar_step(torch.from_numpy(frames)).numpy()
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("i420", [False, True])
def test_prelude_yuv_step_matches_jax(f32_engines, i420):
    jax_eng, port = f32_engines
    if i420:
        packed = np.asarray(yuv420_from_frames(jnp.asarray(_frames(12)), True))
        x = np.stack([packed_to_i420(p, 2) for p in packed])
        i420_in = (16, 24, True)
    else:
        x, i420_in = _frames(12), None
    want = np.asarray(jax_eng.yuv_step(True, planar=True, i420_in=i420_in)(
        jnp.asarray(x)))
    got = port.yuv_step(True, planar=True, i420_in=i420_in)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 6)
    assert _max_lsb(got, want) <= 1


def test_prelude_bf16_step_matches_jax_pallas_path():
    spec = "a,n=3"
    jax_eng = JaxEngine.build(JaxSpec.parse(spec), 2, compute_dtype=jnp.bfloat16,
                              synthetic=True, conv_impl="pallas")
    port = ChainEngine.build(ChainSpec.parse(spec), 2, "cpu", synthetic=True)
    frames = _frames(13)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert _max_lsb(got, want) <= 1


@pytest.mark.parametrize("scale", [1, 2])
def test_denoise_alone_matches_jax(scale):
    """``n=3`` alone in f32: PARITY.md records 0 LSB for the JAX package's
    two denoise versions; the port is held to the same 0 at scale 1 (the
    denoise output quantized) and to 1 LSB through the 2x SR stage."""
    jax_eng = JaxEngine.build(JaxSpec.parse("n=3"), scale,
                              compute_dtype=jnp.float32, synthetic=True)
    port = ChainEngine.build(ChainSpec.parse("n=3"), scale, "cpu",
                             compute_dtype=torch.float32, synthetic=True)
    frames = _frames(14)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert _max_lsb(got, want) <= (0 if scale == 1 else 1)


def test_scale1_step_matches_jax():
    """``-s 1 -m a,n=3``: the pre-SR stages alone, on every step form."""
    jax_eng = JaxEngine.build(JaxSpec.parse("a,n=3"), 1,
                              compute_dtype=jnp.float32, synthetic=True)
    port = ChainEngine.build(ChainSpec.parse("a,n=3"), 1, "cpu",
                             compute_dtype=torch.float32, synthetic=True)
    assert port.sr_model is None and port.planar_scale is None
    frames = _frames(15)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert got.shape == frames.shape
    assert _max_lsb(got, want) <= 1
    want = np.asarray(jax_eng.yuv_step(False, planar=False)(jnp.asarray(frames)))
    got = port.yuv_step(False, planar=False)(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 8, 12, 6)
    assert _max_lsb(got, want) <= 1


# --- --tta ------------------------------------------------------------------

def test_dihedral_transforms_equal_jax():
    x = np.arange(2 * 3 * 5 * 3, dtype=np.float32).reshape(2, 3, 5, 3)
    for k in range(8):
        t = dihedral(torch.from_numpy(x), k)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jax_dihedral(jnp.asarray(x), k)))
        np.testing.assert_array_equal(inverse_dihedral(t, k).numpy(), x)
        np.testing.assert_array_equal(
            inverse_dihedral(t, k).numpy(),
            np.asarray(jax_inverse(jax_dihedral(jnp.asarray(x), k), k)))


def test_tta_step_matches_jax():
    """``--tta`` on the default chain, non-square frames (the forward runs
    at 12x20 and 20x12): the full-frame contract, within 1 LSB in f32."""
    jax_eng = JaxEngine.build(JaxSpec(), 2, compute_dtype=jnp.float32,
                              synthetic=True, tta=True)
    port = ChainEngine.build(ChainSpec(), 2, "cpu", compute_dtype=torch.float32,
                             synthetic=True, tta=True)
    assert port.planar_scale is None and jax_eng.planar_scale is None
    frames = _frames(16, h=12, w=20)
    want = np.asarray(jax_eng.step(jnp.asarray(frames)))
    got = port.step(torch.from_numpy(frames)).numpy()
    assert got.shape == (2, 24, 40, 3)
    assert _max_lsb(got, want) <= 1


# --- -m r with the pre-SR stages and --tta (a 2-RRDB model in both) -------

def _valar_engines(text, precision, tta=False):
    """JAX and port engines for ``text`` with a 2-RRDB SR model injected
    (the JAX 23-RRDB compile is too slow for the CPU suite) and, for
    ``a``, the synthetic anime model; ``mixed`` puts the JAX anime chain
    on its chain kernel (the port's K1 rounding points)."""
    jd, td = ((jnp.float32, torch.float32) if precision == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jr, tr = (None, None) if precision == "f32" else (jnp.float32, torch.float32)
    jm = jax_rrdb_model(scale=4, num_rrdb=2, seed=0, compute_dtype=jd)
    jm.rdb_kernel, jm.residual_dtype = precision != "f32", jr
    ja = pa = None
    if "a" in text.split(","):
        ja = jax_model(scale=1, num_conv=8, num_feat=24, compute_dtype=jd)
        ja.pallas_conv, ja.residual_dtype = precision != "f32", jr
        pa = make_synthetic_model(scale=1, num_conv=8, num_feat=24,
                                  compute_dtype=td, residual_dtype=tr)
    jeng = JaxEngine(spec=JaxSpec.parse(text), scale=4, sr_model=jm,
                     anime_model=ja, tile=16, halo=4, tta=tta)
    pm = make_synthetic_rrdb_model(scale=4, num_rrdb=2, seed=0,
                                   compute_dtype=td, residual_dtype=tr)
    peng = ChainEngine(spec=ChainSpec.parse(text), scale=4, sr_model=pm,
                       device=torch.device("cpu"), anime_model=pa, tile=16,
                       halo=4, tta=tta)
    return jeng, peng


@pytest.mark.parametrize("text,precision,tta", [
    ("n=3,r", "f32", False), ("a,r", "f32", False), ("a,r", "mixed", False),
    ("r", "f32", True),
])
def test_m_r_with_prelude_or_tta_matches_jax(text, precision, tta):
    jeng, peng = _valar_engines(text, precision, tta)
    x = _frames(17, n=1, h=12, w=20)
    want = np.asarray(jeng.step(jnp.asarray(x)))
    got = peng.step(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 48, 80, 3)
    assert _max_lsb(got, want) <= 1


def test_engine_build_m_r_with_prelude():
    eng = ChainEngine.build(ChainSpec.parse("a,n=3,r"), 2, "cpu",
                            synthetic=True, residual_dtype=torch.float32)
    assert eng.scale == 4 and eng.planar_scale is None
    assert eng.anime_model.residual_dtype == torch.float32
    assert len(eng.sr_model.frames_forward("model").rdb_triggers) == 69


# --- process_file and the CLI ----------------------------------------------

N_FRAMES, H, W = 3, 12, 16


def _write_clip(path, c420):
    frames = _frames(20, n=N_FRAMES, h=H, w=W)
    if c420:
        packed = np.asarray(yuv420_from_frames(jnp.asarray(frames), True))
        with Y4MSink(path, W, H, "24/1", colorspace="C420jpeg") as s:
            for p in packed:
                s.write(packed_to_i420(p, 2))
    else:
        with Y4MSink(path, W, H, "24/1") as s:
            for f in frames:
                s.write(f)


def _raw(path):
    with open(path, "rb") as f:
        header, _, body = f.read().partition(b"\n")
    return header, np.stack([np.frombuffer(c, np.uint8)
                             for c in body.split(b"FRAME\n")[1:]])


@pytest.mark.parametrize("c420", [False, True], ids=["c444", "c420jpeg"])
def test_process_file_prelude_matches_jax(tmp_path, f32_engines, c420):
    jeng, peng = f32_engines
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420)
    runs = {}
    for name, runner, eng, kw in (("jax", jax_process, jeng, {}),
                                  ("port", process_file, peng,
                                   {"device": "cpu"})):
        out = str(tmp_path / f"{name}.y4m")
        work = tmp_path / f"work_{name}"
        res = runner(src, out, temp_dir=str(work), batch_size=-2,
                     models="a,n=3", resume_processing=True, engine=eng, **kw)
        runs[name] = (out, res, sorted(os.listdir(work / "upscale_video")))
    (jout, jres, jfiles), (pout, pres, pfiles) = runs["jax"], runs["port"]
    assert pres.pipe_pix == jres.pipe_pix == ("yuv420p" if c420 else "rgb24")
    assert pres.frames_processed == jres.frames_processed == N_FRAMES
    assert pfiles == jfiles and "completed.txt" in pfiles
    jh, jframes = _raw(jout)
    ph, pframes = _raw(pout)
    assert ph == jh and b"W32 H24" in ph
    assert _max_lsb(pframes, jframes) <= 1


@pytest.mark.parametrize("flags,geom", [
    (["-m", "a,n=3"], b"W32 H24"), (["--tta"], b"W32 H24"),
    (["-s", "1", "-m", "a,n=3"], b"W16 H12"),
])
def test_cli_prelude_runs_on_cpu(tmp_path, flags, geom):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, c420=True)
    out = str(tmp_path / "out.y4m")
    launches = nlmeans.nl_means_denoise.launches
    assert cli_main(["-i", src, "-o", out, "-t", str(tmp_path / "t"),
                     "--synthetic_models", "--device", "cpu", *flags]) == 0
    assert nlmeans.nl_means_denoise.launches == launches
    header, frames = _raw(out)
    assert geom in header and b"C420jpeg" in header
    assert frames.shape[0] == N_FRAMES
