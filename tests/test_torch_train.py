"""Training on the CPU: the port's trainer and checkpoints against the JAX
package's, on identical numpy-seeded weights and batches.

- ``charbonnier`` and one step's loss and gradients (before Adam) against
  ``jax.value_and_grad`` of the JAX step's loss: the loss within 1e-6
  relative, each gradient leaf within 1e-5 of its largest magnitude.
- ``make_train_step`` for 4 steps, and ``train_state_from_jax`` after 2
  JAX steps stepped twice more in each package.  Adam normalises, so a
  gradient near its ``eps = 1e-8`` becomes a whole step of ``lr`` whose
  sign is the summation noise's: elements whose first gradient is at
  least 1e-5 are held to ``1e-2 * lr``, the rest to the bound an Adam
  step can move them (``2 * K * lr`` over K steps).
- ``make_sharded_train_step`` on ``dp=2``, ``sp=4`` and ``dp=2,sp=4``
  logical CPU shards against the port's single step, and at ``dp=2,sp=4``
  against the JAX sharded step on the 8 host devices; 8-row patches make
  2-row bands, thinner than the radius (4 at two body convs, 18 at the
  default depth).
- A bf16 ``conv_impl="auto"`` model trains through the aten route, every
  param with a nonzero gradient.
- Checkpoints: round trip, resume after 4 of 8 steps equal to the
  uninterrupted run, a kill between the write and the rename leaves no
  ``step_{N}``, an empty directory gives None, an orbax ``step_{N}`` (the
  JAX package's) raises.

Sizes: ``num_conv`` 2-4, ``num_feat`` 8-16, patch 8, batch 2; one case per
check at the default width and depth (16 x 64).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.models.zoo import make_synthetic_model as jax_model
from upscale_video_tpu.parallel.mesh import make_mesh as jax_make_mesh
from upscale_video_tpu.train import checkpoint as jax_ckpt
from upscale_video_tpu.train import trainer as jt
from upscale_video_tpu_torch.models.executor import GraphForward
from upscale_video_tpu_torch.models.zoo import make_synthetic_model
from upscale_video_tpu_torch.parallel.mesh import make_mesh
from upscale_video_tpu_torch.parallel.spatial import graph_radius
from upscale_video_tpu_torch.train import checkpoint as ck
from upscale_video_tpu_torch.train import trainer as tt
from tests.torch_fixtures import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
LR = 1e-3
SIZES = [(2, 8), (4, 16), (16, 64)]
LOSS_RTOL = 1e-6     # one step's loss, relative
GRAD_RTOL = 1e-5     # each gradient leaf, relative to its largest magnitude
STEP_LOSS_RTOL = 1e-4  # losses after the first step: Adam's sign noise
# has parted a few params by up to 2 * lr (the first step's loss is held
# to LOSS_RTOL or SHARD_RTOL)
ADAM_SETTLED = 1e-5  # |first gradient| above which an Adam step's sign is stable
SHARD_RTOL = 1e-5    # sharded vs single: f32 summation order only


def _models(num_conv, num_feat, **kw):
    jm = jax_model(scale=2, num_conv=num_conv, num_feat=num_feat,
                   compute_dtype=jnp.float32)
    tm = make_synthetic_model(scale=2, num_conv=num_conv, num_feat=num_feat,
                              compute_dtype=torch.float32, **kw)
    return jm, tm


def _batches(k, n=2, patch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [jt.synthesize_pairs(rng, n, patch, patch, 2) for _ in range(k)]


def _jax_grads(jm, params, lr, hr):
    fwd = jt._differentiable_forward(jm)

    def loss_fn(p):
        return jt.charbonnier(fwd(p, lr).astype(jnp.float32),
                              jnp.asarray(hr, jnp.float32))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _assert_params_close(got: dict, want: dict, grads: dict, steps: int,
                         settled_atol=lambda w: 1e-2 * LR):
    """Adam's bound: elements whose first gradient is settled within
    ``settled_atol(leaf)`` (default 1e-2 * lr), the rest within the
    2 * steps * lr two opposite Adam walks can part them by."""
    for name in want:
        for k in want[name]:
            w = np.asarray(want[name][k].detach() if torch.is_tensor(want[name][k])
                           else want[name][k])
            g = got[name][k].detach().cpu().numpy()
            settled = np.abs(np.asarray(grads[name][k])) >= ADAM_SETTLED
            d = np.abs(g - w)
            assert d[settled].max(initial=0) <= settled_atol(w), (name, k)
            assert d.max() <= 2 * steps * LR, (name, k)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 16, 12, 3)])
def test_charbonnier_equals_jax(shape):
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 1, shape).astype(np.float32)
    t = rng.uniform(0, 1, shape).astype(np.float32)
    want = float(jt.charbonnier(jnp.asarray(p), jnp.asarray(t)))
    got = float(tt.charbonnier(torch.from_numpy(p), torch.from_numpy(t)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    got_sum = float(tt.charbonnier_sum(torch.from_numpy(p), torch.from_numpy(t)))
    assert abs(got_sum / p.size - want) <= LOSS_RTOL * abs(want)


def test_synthesize_pairs_equal_jax():
    a = jt.synthesize_pairs(np.random.default_rng(5), 3, 8, 6, 2)
    b = tt.synthesize_pairs(np.random.default_rng(5), 3, 8, 6, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("num_conv,num_feat", SIZES)
def test_step_loss_and_gradients_equal_jax(num_conv, num_feat):
    jm, tm = _models(num_conv, num_feat)
    ((lr, hr),) = _batches(1)
    js, _ = jt.make_train_state(jm, LR)
    want_loss, want = _jax_grads(jm, js.params, lr, hr)
    ts, _ = tt.make_train_state(tm, LR)
    fwd = tt._differentiable_forward(tm)
    loss = tt.charbonnier(fwd(tt.state_from_params(ts.params),
                              torch.from_numpy(lr)), torch.from_numpy(hr))
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * want_loss
    for name in want:
        for k in want[name]:
            g = ts.params[name][k].grad.numpy()
            scale = np.abs(want[name][k]).max()
            np.testing.assert_allclose(g, want[name][k], rtol=0,
                                       atol=GRAD_RTOL * scale,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("num_conv,num_feat", [(2, 8), (16, 64)])
def test_train_step_four_steps_equal_jax(num_conv, num_feat):
    jm, tm = _models(num_conv, num_feat)
    batches = _batches(4)
    js, tx = jt.make_train_state(jm, LR)
    _, grads = _jax_grads(jm, js.params, *batches[0])
    ts, opt = tt.make_train_state(tm, LR)
    jstep, tstep = jt.make_train_step(jm, tx), tt.make_train_step(tm, opt)
    for i, (lr, hr) in enumerate(batches):
        js, jloss = jstep(js, lr, hr)
        ts, tloss = tstep(ts, lr, hr)
        rtol = STEP_LOSS_RTOL if i else LOSS_RTOL
        assert abs(float(tloss) - float(jloss)) <= rtol * float(jloss)
    assert ts.step == js.step == 4
    _assert_params_close(ts.params, js.params, grads, 4)


@pytest.mark.parametrize("num_conv,num_feat", [(3, 8), (16, 64)])
def test_train_state_from_jax_continues(num_conv, num_feat):
    """Two JAX steps, the state carried across (Adam's count included:
    the next step's bias correction reads it), two more in each package."""
    jm, tm = _models(num_conv, num_feat)
    batches = _batches(4, seed=2)
    js, tx = jt.make_train_state(jm, LR)
    _, grads = _jax_grads(jm, js.params, *batches[0])
    jstep = jt.make_train_step(jm, tx)
    for lr, hr in batches[:2]:
        js, _ = jstep(js, lr, hr)
    host = jax.tree_util.tree_map(np.asarray, js.params)
    ts, opt = tt.train_state_from_jax(host, js.opt_state, js.step, CPU, LR)
    assert ts.step == 2
    p0 = ts.params["conv_0"]["weight"]
    assert float(opt.state[p0]["step"]) == 2.0
    np.testing.assert_array_equal(
        opt.state[p0]["exp_avg"].numpy(),
        np.asarray(js.opt_state[0].mu["conv_0"]["weight"]))
    tstep = tt.make_train_step(tm, opt)
    for i, (lr, hr) in enumerate(batches[2:]):
        js, jloss = jstep(js, lr, hr)
        ts, tloss = tstep(ts, lr, hr)
        rtol = STEP_LOSS_RTOL if i else LOSS_RTOL
        assert abs(float(tloss) - float(jloss)) <= rtol * float(jloss)
    assert ts.step == js.step == 4
    _assert_params_close(ts.params, js.params, grads, 2)


def test_train_state_from_jax_needs_adam_state():
    jm, _ = _models(2, 8)
    js, _ = jt.make_train_state(jm, LR)
    host = jax.tree_util.tree_map(np.asarray, js.params)
    with pytest.raises(ValueError, match="no Adam state"):
        tt.train_state_from_jax(host, (), 0, CPU)


def test_step_refuses_another_states_params():
    _, tm = _models(2, 8)
    _, opt = tt.make_train_state(tm, LR)
    other, _ = tt.make_train_state(tm, LR)
    ((lr, hr),) = _batches(1)
    with pytest.raises(ValueError, match="not over this state's params"):
        tt.make_train_step(tm, opt)(other, lr, hr)


def test_state_from_params_is_the_models_state():
    """The differentiable twin of params_from_jax: the same wmat, bias and
    slope values, still in the autograd graph."""
    _, tm = _models(2, 8)
    ts, _ = tt.make_train_state(tm, LR)
    st = tt.state_from_params(ts.params)
    for name, w in tm.state.items():
        for k in ("wmat", "bias", "slope"):
            if hasattr(w, k):
                got = getattr(st[name], k)
                assert got.requires_grad, (name, k)
                torch.testing.assert_close(got.detach(), getattr(w, k),
                                           rtol=0, atol=0)


def test_state_from_params_zero_bias_and_depthwise():
    w = torch.ones(3, 3, 4, 5, requires_grad=True)
    st = tt.state_from_params({"c": {"weight": w},
                               "d": {"weight": torch.ones(36),
                                     "bias": torch.ones(4)}})
    assert st["c"].wmat.shape == (36, 5) and st["c"].wmat.grad_fn is not None
    assert torch.equal(st["c"].bias, torch.zeros(5))
    assert st["d"].wflat.shape == (36,) and st["d"].bias.shape == (4,)
    with pytest.raises(NotImplementedError, match="not HWIO"):
        tt.state_from_params({"e": {"weight": torch.ones(3, 3)}})


def test_bf16_auto_model_trains_through_the_aten_route():
    """A kernel engine's model (bf16, conv_impl auto) is differentiated on
    the aten route: the forward plans no kernel, and one step leaves every
    param a nonzero gradient."""
    tm = make_synthetic_model(scale=2, num_conv=2, num_feat=8,
                              compute_dtype=torch.bfloat16, conv_impl="auto")
    fwd = tt._differentiable_forward(tm)
    assert isinstance(fwd, GraphForward)
    assert not fwd.kernels and fwd.tail is None and not fwd.chains
    assert not fwd.solos and not fwd.rdb_triggers
    ts, opt = tt.make_train_state(tm, LR)
    ((lr, hr),) = _batches(1)
    ts, loss = tt.make_train_step(tm, opt)(ts, lr, hr)
    assert torch.isfinite(loss)
    for name, p in ts.params.items():
        for k, t in p.items():
            assert t.grad is not None and bool((t.grad != 0).any()), (name, k)


# --- dp x sp -----------------------------------------------------------------

def _sharded_vs_single(num_conv, num_feat, spec, steps=3, n=2, patch=8):
    """Loss and gradients of the first step within f32 summation noise of
    the single step's, then the params after ``steps`` under Adam's bound
    (settled elements within SHARD_RTOL of their leaf's largest value)."""
    _, tm = _models(num_conv, num_feat)
    batches = _batches(steps, n=n, patch=patch, seed=4)
    single_state, sopt = tt.make_train_state(tm, LR)
    single = tt.make_train_step(tm, sopt)
    state, opt = tt.make_train_state(tm, LR)
    mesh = make_mesh(spec, devices=[CPU] * 8)
    sharded = tt.make_state_apply(tt.make_sharded_train_step(tm, opt, mesh))
    grads = None
    for lr, hr in batches:
        single_state, want = single(single_state, lr, hr)
        state, got = sharded(state, lr, hr)
        rtol = STEP_LOSS_RTOL if grads else SHARD_RTOL
        assert abs(float(got) - float(want)) <= rtol * float(want), spec
        if grads is None:
            grads = {name: {k: t.grad.numpy().copy() for k, t in p.items()}
                     for name, p in single_state.params.items()}
            for name, p in state.params.items():
                for k, t in p.items():
                    scale = np.abs(grads[name][k]).max()
                    np.testing.assert_allclose(
                        t.grad.numpy(), grads[name][k], rtol=0,
                        atol=GRAD_RTOL * scale, err_msg=f"{spec} {name}/{k}")
    _assert_params_close(state.params, single_state.params, grads, steps,
                         lambda w: SHARD_RTOL * np.abs(w).max())
    return tm


@pytest.mark.parametrize("spec", ["dp=2", "sp=4", "dp=2,sp=4"])
def test_sharded_step_equals_single(spec):
    tm = _sharded_vs_single(2, 8, spec)
    if "sp" in spec:  # 8 LR rows over 4 bands: 2 each, against radius 4
        assert graph_radius(tm.graph) == 4 > 8 // 4


def test_sharded_step_default_depth_thin_bands():
    """The default 17-conv body: radius 18 against 2-row bands, so each
    band reaches past every neighbour to the frame's edges."""
    tm = _sharded_vs_single(16, 64, "dp=2,sp=4", steps=2)
    assert graph_radius(tm.graph) == 18


def test_sharded_step_uneven_bands_and_more_bands_than_rows():
    _sharded_vs_single(2, 8, "sp=3", steps=2, n=1, patch=7)
    _sharded_vs_single(2, 8, "sp=8", steps=2, n=1, patch=5)


def test_sharded_step_equals_jax_sharded():
    """dp=2,sp=4 against the JAX GSPMD step on the 8 host devices."""
    jm, tm = _models(2, 8)
    batches = _batches(3, seed=6)
    js, tx = jt.make_train_state(jm, LR)
    _, grads = _jax_grads(jm, js.params, *batches[0])
    jstep = jt.make_state_apply(
        jt.make_sharded_train_step(jm, tx, jax_make_mesh("dp=2,sp=4")))
    ts, opt = tt.make_train_state(tm, LR)
    tstep = tt.make_state_apply(tt.make_sharded_train_step(
        tm, opt, make_mesh("dp=2,sp=4", devices=[CPU] * 8)))
    for i, (lr, hr) in enumerate(batches):
        js, jloss = jstep(js, lr, hr)
        ts, tloss = tstep(ts, lr, hr)
        rtol = STEP_LOSS_RTOL if i else SHARD_RTOL
        assert abs(float(tloss) - float(jloss)) <= rtol * float(jloss)
    _assert_params_close(ts.params, js.params, grads, 3)


def test_sharded_step_uneven_batch_raises():
    _, tm = _models(2, 8)
    state, opt = tt.make_train_state(tm, LR)
    step = tt.make_sharded_train_step(tm, opt, make_mesh("dp=2", devices=[CPU] * 2))
    lr, hr = tt.synthesize_pairs(np.random.default_rng(0), 3, 8, 8, 2)
    with pytest.raises(ValueError, match="batch 3 not divisible by dp=2"):
        step(state.params, state.opt_state, lr, hr)


def test_sharded_step_refuses_params_off_the_first_device():
    _, tm = _models(2, 8)
    state, opt = tt.make_train_state(tm, LR)
    meta = torch.device("meta")
    step = tt.make_sharded_train_step(tm, opt, make_mesh("dp=2", devices=[meta] * 2))
    lr, hr = tt.synthesize_pairs(np.random.default_rng(0), 2, 8, 8, 2)
    with pytest.raises(ValueError, match="not on the mesh's first device meta"):
        step(state.params, state.opt_state, lr, hr)


def test_loss_decreases_single_and_sharded():
    """tests/test_parallel.py's TestTraining on the port."""
    _, tm = _models(2, 8)
    lr, hr = tt.synthesize_pairs(np.random.default_rng(1234), 4, 8, 8, 2)
    state, opt = tt.make_train_state(tm, LR)
    step = tt.make_train_step(tm, opt)
    losses = []
    for _ in range(8):
        state, loss = step(state, lr, hr)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    state, opt = tt.make_train_state(tm, LR)
    sharded = tt.make_sharded_train_step(tm, opt, make_mesh("dp=2,sp=4",
                                                            devices=[CPU] * 8))
    p, o, l1 = sharded(state.params, state.opt_state, lr, hr)
    _, _, l2 = sharded(p, o, lr, hr)
    assert float(l2) < float(l1)


# --- checkpoints -----------------------------------------------------------------

def _run(step, state, batches):
    for lr, hr in batches:
        state, _ = step(state, lr, hr)
    return state


def _params_equal(a: dict, b: dict):
    for name, p in a.items():
        for k, t in p.items():
            assert torch.equal(t.detach(), b[name][k].detach()), (name, k)


def test_checkpoint_round_trip(tmp_path):
    _, tm = _models(1, 8)
    state, opt = tt.make_train_state(tm, LR)
    step = tt.make_train_step(tm, opt)
    batches = _batches(4)
    state = _run(step, state, batches[:3])
    rng = np.random.default_rng(9)
    rng.integers(0, 10, 5)
    path = ck.save_checkpoint(str(tmp_path / "ckpt"), state, opt, rng)
    assert path.endswith("step_3") and os.path.isfile(
        os.path.join(path, ck.STATE_FILE))
    assert ck.latest_checkpoint(str(tmp_path / "ckpt")) == path
    fresh, fopt = tt.make_train_state(tm, LR)
    rng2 = np.random.default_rng(0)
    restored = ck.restore_checkpoint(path, fresh, fopt, rng2)
    assert restored.step == 3
    _params_equal(restored.params, state.params)
    assert rng2.integers(0, 1 << 30) == rng.integers(0, 1 << 30)
    # resumed training continues bit-identically
    cont_a, loss_a = step(state, *batches[3])
    cont_b, loss_b = tt.make_train_step(tm, fopt)(restored, *batches[3])
    assert float(loss_a) == float(loss_b)
    _params_equal(cont_a.params, cont_b.params)


def test_resume_after_four_of_eight_steps_equals_uninterrupted(tmp_path):
    _, tm = _models(2, 8)
    batches = _batches(8, seed=7)
    state, opt = tt.make_train_state(tm, LR)
    whole = _run(tt.make_train_step(tm, opt), state, batches)
    state, opt = tt.make_train_state(tm, LR)
    half = _run(tt.make_train_step(tm, opt), state, batches[:4])
    ck.save_checkpoint(str(tmp_path), half, opt)
    fresh, fopt = tt.make_train_state(tm, LR)
    resumed = ck.restore_checkpoint(ck.latest_checkpoint(str(tmp_path)),
                                    fresh, fopt)
    assert resumed.step == 4
    resumed = _run(tt.make_train_step(tm, fopt), resumed, batches[4:])
    assert resumed.step == whole.step == 8
    _params_equal(resumed.params, whole.params)


def test_killed_write_leaves_no_step(tmp_path, monkeypatch):
    """A kill between the write and the rename (the rename never runs)
    leaves no step_{N}: latest_checkpoint still finds the previous one."""
    _, tm = _models(1, 8)
    state, opt = tt.make_train_state(tm, LR)
    step = tt.make_train_step(tm, opt)
    state = _run(step, state, _batches(2))
    first = ck.save_checkpoint(str(tmp_path), state, opt)
    state = _run(step, state, _batches(1))

    def killed(src, dst):
        raise KeyboardInterrupt("killed")

    monkeypatch.setattr(ck.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        ck.save_checkpoint(str(tmp_path), state, opt)
    monkeypatch.undo()
    assert not os.path.exists(tmp_path / "step_3")
    assert os.path.isfile(tmp_path / ck.PARTIAL_DIR / "step_3" / ck.STATE_FILE)
    assert ck.latest_checkpoint(str(tmp_path)) == first
    # the next save of that step replaces the leftover and lands whole
    path = ck.save_checkpoint(str(tmp_path), state, opt)
    assert ck.latest_checkpoint(str(tmp_path)) == path.rstrip("/")
    again = ck.save_checkpoint(str(tmp_path), state, opt)  # over an existing one
    assert again == path and sorted(os.listdir(tmp_path)) == [
        "step_2", "step_3"]


def test_latest_checkpoint_empty(tmp_path):
    assert ck.latest_checkpoint(str(tmp_path / "nope")) is None
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "step_x").mkdir()
    assert ck.latest_checkpoint(str(tmp_path / "empty")) is None


def test_orbax_checkpoint_raises(tmp_path):
    """A step_{N} the JAX package's vsr-finetune wrote (orbax) is refused
    by name, never read as garbage."""
    jm, tm = _models(1, 8)
    js, _ = jt.make_train_state(jm, LR)
    path = jax_ckpt.save_checkpoint(str(tmp_path), js)
    assert ck.latest_checkpoint(str(tmp_path)) == path
    state, opt = tt.make_train_state(tm, LR)
    with pytest.raises(ValueError, match="orbax"):
        ck.restore_checkpoint(path, state, opt)
    os.makedirs(tmp_path / "step_9")
    with pytest.raises(FileNotFoundError, match="state.pt"):
        ck.restore_checkpoint(str(tmp_path / "step_9"), state, opt)


def test_restore_into_another_model_raises(tmp_path):
    _, tm = _models(1, 8)
    state, opt = tt.make_train_state(tm, LR)
    path = ck.save_checkpoint(str(tmp_path), state, opt)
    _, other = _models(2, 8)
    ostate, oopt = tt.make_train_state(other, LR)
    with pytest.raises(ValueError, match="another model"):
        ck.restore_checkpoint(path, ostate, oopt)
