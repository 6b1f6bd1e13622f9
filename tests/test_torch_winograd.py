"""K7 parity on the CPU: the port's row-Winograd chain (CPU tensors take
``winograd_chain_plain``) against the JAX Pallas ``winograd_chain`` run in
interpret mode, on the same numpy inputs, and the port's
``wino_bench`` entry point with the JAX packages refused.

Tolerances: both sides round V_a, then each layer's output, to bf16 after
f32 sums whose order may differ, so one layer is held to one bf16 ulp
(``2**-10 + 2**-7 * |v|``) and a stack to the JAX suite's own bound
(``tests/test_winograd.py:112``), whose ulps propagate with depth.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upscale_video_tpu.ops.conv_winograd import (
    transform_weights as jax_transform, winograd_chain as jax_wino,
)
from upscale_video_tpu_torch.ops.common import (
    ACT_LEAKY, ACT_NONE, ACT_PRELU, ACT_RELU,
)
from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain, make_layer
from upscale_video_tpu_torch.ops.conv_winograd import (
    make_wino_layer, sm90_takes, transform_weights, wino_layers_from_jax,
    winograd_chain, winograd_chain_plain,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LAYER_ATOL, LAYER_RTOL = 2.0 ** -10, 2.0 ** -7


def _layers(rng, cin, feats, act=ACT_PRELU):
    """The JAX suite's layer dicts (``tests/test_winograd.py:48-63``)."""
    out, c = [], cin
    for f in feats:
        l = {"weight": rng.normal(0, 0.2, (3, 3, c, f)).astype(np.float32),
             "bias": rng.normal(0, 0.1, (f,)).astype(np.float32), "act": act}
        if act == ACT_PRELU:
            l["slope"] = rng.uniform(0.1, 0.3, (f,)).astype(np.float32)
        elif act == ACT_LEAKY:
            l["slope"] = np.asarray([0.2], np.float32)
        out.append(l)
        c = f
    return out


def _both(x, layers):
    """``(port, jax)`` outputs as f32 numpy for one (H, W, C) frame."""
    want = np.asarray(jax_wino(jnp.asarray(x), layers, tile_h=8, tile_w=16,
                               interpret=True)).astype(np.float32)
    got = winograd_chain(torch.from_numpy(x)[None], wino_layers_from_jax(layers))
    assert got.dtype == torch.bfloat16
    return got[0].float().numpy(), want


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int32)


@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (3, 3, 3, 24), (3, 3, 128, 100)])
def test_transform_weights_matches_jax(shape):
    """U = G w in f32, rounded to bf16: bit-equal to the JAX transform on
    >= 99.9% of entries, within one bf16 ulp everywhere."""
    w = np.random.default_rng(sum(shape)).normal(0, 0.3, shape).astype(np.float32)
    want = np.asarray(jnp.asarray(jax_transform(w), jnp.bfloat16)).astype(np.float32)
    got = transform_weights(w).to(torch.bfloat16).float().numpy()
    assert got.shape == want.shape == (4, 3 * shape[2], shape[3])
    assert np.mean(got == want) >= 0.999
    assert np.abs(_bf16_bits(got) - _bf16_bits(want)).max() <= 1


def test_weight_transform_reconstructs_conv():
    """U = G w: y0/y1 from the port's transformed weights equal the direct
    conv (the algebra of ``tests/test_winograd.py:66-86``)."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (3, 3, 2, 3))
    u = transform_weights(w).double().numpy()  # (4, 6, 3)
    d = rng.normal(0, 1, (4, 5, 2))  # rows 2i-1..2i+2 for one output pair
    v = np.stack([d[0] - d[2], d[1] + d[2], d[2] - d[1], d[1] - d[3]])
    patches = np.concatenate([v[:, dx:3 + dx] for dx in range(3)], -1)
    m = np.einsum("apk,ako->apo", patches, u)
    y0 = m[0] + m[1] + m[2]
    y1 = m[1] - m[2] - m[3]
    ref = np.zeros((2, 3, 3))
    for r in range(2):
        for x_ in range(3):
            for dy in range(3):
                for dx in range(3):
                    ref[r, x_] += d[r + dy, x_ + dx] @ w[dy, dx]
    np.testing.assert_allclose(np.stack([y0, y1]), ref, atol=1e-5)


@pytest.mark.parametrize("act", [ACT_NONE, ACT_PRELU, ACT_LEAKY, ACT_RELU])
def test_single_layer_matches_jax(act):
    rng = np.random.default_rng(10 + act)
    x = rng.uniform(0, 1, (20, 40, 8)).astype(np.float32)
    got, want = _both(x, _layers(rng, 8, [8], act))
    assert np.all(np.abs(got - want) <= LAYER_ATOL + LAYER_RTOL * np.abs(want))


def test_stack_matches_jax():
    """Three layers with channel changes and ragged (odd) geometry."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (19, 37, 6)).astype(np.float32)
    got, want = _both(x, _layers(rng, 6, [8, 16, 4]))
    assert got.shape == (19, 37, 4)
    differ = np.mean(got != want)
    print(f"ragged stack: {differ:.4%} of values differ from JAX")
    np.testing.assert_allclose(got, want, atol=0.15,
                               err_msg=f"{differ:.4%} of values differ")


def test_matches_k1_plain():
    """K7 and K1 are interchangeable conv-body backends: their plain
    versions agree on the same layers."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 24, 32, 8)).astype(np.float32))
    layers = _layers(rng, 8, [8, 8])
    a = winograd_chain_plain(x, wino_layers_from_jax(layers)).float()
    b = conv3x3_chain(x, [make_layer(l["weight"], l["bias"], l["slope"],
                                     l["act"]) for l in layers]).float()
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05)


@pytest.mark.parametrize("h", [12, 13])
def test_batch_equals_single_frames(h):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (2, h, 17, 5)).astype(np.float32))
    layers = wino_layers_from_jax(_layers(rng, 5, [7, 6]))
    both = winograd_chain(x, layers)
    for i in range(2):
        assert torch.equal(both[i], winograd_chain(x[i:i + 1], layers)[0])


def test_uncropped_output_is_bordered():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 9, 11, 4)).astype(np.float32))
    layers = wino_layers_from_jax(_layers(rng, 4, [6]))
    buf = winograd_chain(x, layers, crop=False)
    assert buf.shape == (1, 11, 13, 6)
    assert torch.equal(buf[:, 1:10, 1:12], winograd_chain(x, layers))
    ring = torch.ones(11, 13, dtype=torch.bool)
    ring[1:10, 1:12] = False
    assert not buf[0][ring].any()


@pytest.mark.parametrize("shape", [(1, 3, 4, 4), (3, 3, 129, 8), (3, 3, 8, 129),
                                   (5, 5, 4, 4)])
def test_rejects_unsupported_weights(shape):
    with pytest.raises(ValueError):
        make_wino_layer(np.zeros(shape, np.float32))


def test_rejects_mismatched_chain_and_device():
    layers = [make_wino_layer(np.zeros((3, 3, 4, 4), np.float32))]
    with pytest.raises(ValueError):
        winograd_chain(torch.zeros(1, 4, 4, 5), layers)
    with pytest.raises(ValueError):
        winograd_chain(torch.zeros(1, 4, 4, 4, device="meta"), layers)


@pytest.mark.parametrize("cin,cout,takes", [
    (64, 64, True), (3, 64, False), (64, 3, False), (64, 128, False),
    (128, 64, False), (128, 128, False), (32, 32, False), (64, 48, False),
])
def test_sm90_takes_64_to_64_only(cin, cout, takes):
    """The sm90 kernel's resident U and halo ring are sized for 64 -> 64;
    every other shape stays on the WMMA kernel."""
    assert sm90_takes(cin, cout) is takes


def _swz(line, chunk):
    """``sm90_common.cuh:swz``: byte offset of 16-byte chunk ``chunk`` of
    128-byte line ``line`` under the 128-byte swizzle."""
    return line * 128 + ((chunk ^ (line & 7)) << 4)


def _u_image_sm90(umat: torch.Tensor) -> np.ndarray:
    """A mirror of ``conv_winograd_sm90.cu``'s resident-U copy: ``umat``
    (4, 192, 64) bf16 viewed as 12 (cin, cout) blocks in (a, dx) order;
    thread item ``i`` copies cin ``8*kc .. 8*kc+7`` of column ``n`` of block
    ``blk`` as one 16-byte chunk to ``u_offset(blk, n, kc)``.  Returns the
    98,304-byte image as int16 bf16 bit patterns (-1 where nothing was
    written)."""
    u = umat.contiguous().view(torch.int16).numpy().reshape(12, 64, 64)
    img = np.full(12 * 8192 // 2, -1, np.int32)
    for i in range(12 * 64 * 8):
        n, kc, blk = i % 64, (i // 64) % 8, i // (64 * 8)
        off = (blk * 8192 + _swz(n, kc)) // 2
        assert (img[off:off + 8] == -1).all(), "a chunk written twice"
        img[off:off + 8] = u[blk, 8 * kc:8 * kc + 8, n]
    return img


def test_sm90_resident_u_layout_unpacks_to_transform_weights():
    """The resident U, read back the way the kernel's wgmma reads B (the
    (a, dx) block's descriptor start ``blk * 8192 + 32 * kc``, then K-major
    B128: element (k, n) of the k16 slice at ``start + 128 n + 2 k`` with
    address bits 4-6 XORed with bits 7-9), is ``transform_weights``' U_a
    rounded to bf16, element for element; every byte is written once."""
    rng = np.random.default_rng(21)
    w = rng.normal(0, 0.3, (3, 3, 64, 64)).astype(np.float32)
    umat = make_wino_layer(w).umat
    img = _u_image_sm90(umat)
    assert (img != -1).all()
    want = transform_weights(w).to(torch.bfloat16).view(torch.int16).numpy()
    got = np.empty_like(want)
    for a in range(4):
        for dx in range(3):
            for kc in range(4):
                start = (a * 3 + dx) * 8192 + 32 * kc
                k = np.arange(16)[:, None]
                n = np.arange(64)[None, :]
                addr = start + 128 * n + 2 * k
                addr = addr ^ (((addr >> 7) & 7) << 4)
                got[a, dx * 64 + 16 * kc + k, n] = img[addr // 2]
    assert np.array_equal(got, want)


def test_cpu_wrapper_never_imports_the_build(tmp_path):
    """On CPU tensors ``winograd_chain`` runs its plain version for every
    shape, 64 -> 64 included, and never imports the kernel build."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from upscale_video_tpu_torch.ops.conv_winograd import (
            make_wino_layer, winograd_chain, winograd_chain_plain)
        rng = np.random.default_rng(0)
        layers = [make_wino_layer(rng.normal(0, 0.1, (3, 3, ci, co)).astype(
            np.float32)) for ci, co in ((3, 64), (64, 64))]
        x = torch.rand(1, 7, 9, 3)
        assert torch.equal(winograd_chain(x, layers),
                           winograd_chain_plain(x, layers))
        assert winograd_chain.launches == winograd_chain.launches_sm90 == 0
        assert "upscale_video_tpu_torch.kernels.build" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, runpy, sys

    BLOCKED = ("jax", "upscale_video_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.argv = [sys.argv[1]] + sys.argv[2:]
    try:
        runpy.run_module(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        if e.code:
            raise
    assert not [m for m in sys.modules if m in BLOCKED or m.startswith(
        tuple(b + "." for b in BLOCKED))], "a blocked package was imported"
""")


def run_bench_blocked(module: str, tmp_path) -> str:
    """Run ``python -m module`` at a tiny size on the CPU with ``jax`` and
    ``upscale_video_tpu`` refused; return its stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, module, "--device", "cpu",
         "--height", "16", "--width", "24", "--layers", "2", "--channels",
         "8", "--reps", "1"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_wino_bench_runs_on_cpu_without_jax(tmp_path):
    out = run_bench_blocked("upscale_video_tpu_torch.tools.wino_bench", tmp_path)
    lines = out.splitlines()
    assert lines[0] == "[device] cpu"
    for impl in ("cudnn", "direct", "wino"):
        assert any(l.startswith(f"[{impl}] body ") and "ms/layer" in l
                   for l in lines), out
    assert "[launches] winograd_chain=0 conv3x3_chain=0" in lines
    assert "[launches_sm90] winograd_chain=0 conv3x3_chain=0" in lines
    parity = [l for l in lines if l.startswith("[parity] wino kernel")]
    assert len(parity) == 1 and parity[0].endswith("ok=True"), out
