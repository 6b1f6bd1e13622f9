"""Conv-body A/B/C on one card: cuDNN bf16 vs K1 (direct chain) vs K7
(row-Winograd chain).

Port of ``tools/wino_bench.py``: the same body (``--layers`` SAME 3x3
convs of ``--channels`` -> ``--channels`` with PReLU, seed-0 numpy weights
N(0, 0.05)) on the same seed-0 uniform(0, 1) frame.  ``cudnn`` stands where
the JAX tool says ``xla``: per layer one cuDNN bf16 ``F.conv2d`` with bias
(channels-last) and the PReLU, timed only.  Timing is by CUDA events after
two warm-up calls, in interleaved rounds; the JAX tool's chained
differenced protocol (``--k1/--k2``), its tile flags and ``--interpret``
are gone, and ``--device cpu`` runs the plain versions as a smoke test.
The parity line holds K7 against ``winograd_chain_plain`` on the same
frame (K1's stack bounds); the tool exits 1 if it disagrees.

    python -m upscale_video_tpu_torch.tools.wino_bench [--height 1080]
        [--width 1920] [--layers 16] [--channels 64] [--reps 3]
        [--impls cudnn,direct,wino] [--skip_parity] [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from upscale_video_tpu_torch.ops.common import ACT_PRELU
from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain, make_layer
from upscale_video_tpu_torch.ops.conv_winograd import (
    make_wino_layer, winograd_chain, winograd_chain_plain,
)
from upscale_video_tpu_torch.tools import bench_common

# K1's bounds through a stack: one bf16 ulp per layer may propagate
STACK_ATOL, STACK_RTOL = 5e-2, 2e-2


def make_layers(rng, n, c):
    """The JAX tool's layer dicts (``wino_bench.py:28-37``), as numpy."""
    return [{
        "weight": rng.normal(0, 0.05, (3, 3, c, c)).astype(np.float32),
        "bias": rng.normal(0, 0.05, (c,)).astype(np.float32),
        "slope": rng.uniform(0.1, 0.3, (c,)).astype(np.float32),
        "act": ACT_PRELU,
    } for _ in range(n)]


def cudnn_weights(layers, dev):
    """Per layer (OIHW channels-last bf16 weight, bf16 bias, bf16 slope)."""
    out = []
    for l in layers:
        w = torch.from_numpy(l["weight"]).permute(3, 2, 0, 1)
        out.append((w.to(dev, torch.bfloat16).contiguous(
                        memory_format=torch.channels_last),
                    torch.from_numpy(l["bias"]).to(dev, torch.bfloat16),
                    torch.from_numpy(l["slope"]).to(dev, torch.bfloat16)
                    .view(1, -1, 1, 1)))
    return out


def cudnn_body(x, weights):
    """The library body over NHWC ``x``: conv + bias, PReLU, per layer."""
    y = x.permute(0, 3, 1, 2)
    for w, b, s in weights:
        y = F.conv2d(y, w, b, padding=1)
        y = torch.where(y >= 0, y, y * s)
    return y


def main(argv=None) -> int:
    args = bench_common.parser(__doc__, "cudnn,direct,wino").parse_args(argv)
    dev = bench_common.device_of(args)
    rng = np.random.default_rng(0)
    layers = make_layers(rng, args.layers, args.channels)
    x = torch.from_numpy(rng.uniform(
        0, 1, (1, args.height, args.width, args.channels)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    k1 = [make_layer(l["weight"], l["bias"], l["slope"], l["act"], device=dev)
          for l in layers]
    k7 = [make_wino_layer(l["weight"], l["bias"], l["slope"], l["act"],
                          device=dev) for l in layers]
    cw = cudnn_weights(layers, dev)
    bodies = {"cudnn": lambda: cudnn_body(x, cw),
              "direct": lambda: conv3x3_chain(x, k1),
              "wino": lambda: winograd_chain(x, k7)}
    impls = args.impls.split(",")
    for fn in (conv3x3_chain, winograd_chain):
        fn.launches = fn.launches_sm90 = 0
    ms = bench_common.time_impls({i: bodies[i] for i in impls}, args.reps, dev)
    flop = 2 * 9 * args.height * args.width * args.channels ** 2 * args.layers
    bench_common.report(ms, 1, args.layers, flop, "TFLOP/s-direct-equiv")
    bench_common.launches_line((winograd_chain, conv3x3_chain))
    if args.skip_parity or "wino" not in impls:
        return 0
    ok = bench_common.parity_line(
        "wino kernel vs winograd_chain_plain", winograd_chain(x, k7),
        winograd_chain_plain(x, k7), STACK_ATOL, STACK_RTOL, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
