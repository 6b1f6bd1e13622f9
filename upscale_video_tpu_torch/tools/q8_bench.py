"""Conv-body A/B on one card: K8 (int8 chain) vs K1 (bf16 direct chain)
vs cuDNN bf16.

Port of ``tools/q8_bench.py``: the same seed-0 numpy draws in the same
order (``q8_bench.py:46-68``): ``--layers`` int8 HWIO weights
``integers(-127, 128)``, per-layer biases N(0, 0.02) and PReLU slopes
U(0.1, 0.3), dequant scale ``1 / (64 * 127)``, requant ``inv_out`` 127, and
an int8 frame.  The bf16 impls run the same weights times 1/64 on the frame
over 127.  ``cudnn`` stands where the JAX tool says ``xla`` (per layer one
cuDNN bf16 ``F.conv2d`` with bias, channels-last, and the PReLU), timed
only.  Timing is by CUDA events after two warm-up calls, in interleaved
rounds; ``--k1/--k2``, the tile flags and ``--interpret`` are gone, and
``--device cpu`` runs the plain versions as a smoke test.  The parity line
holds K8 against ``conv3x3_chain_q8_plain`` on the same frame: the integer
sums are exact, so every value must be bit-equal; the tool exits 1 if one
is not.

    python -m upscale_video_tpu_torch.tools.q8_bench [--height 1080]
        [--width 1920] [--layers 16] [--channels 64] [--reps 3]
        [--impls q8,direct,cudnn] [--skip_parity] [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from upscale_video_tpu_torch.ops.common import ACT_PRELU
from upscale_video_tpu_torch.ops.conv_chain import conv3x3_chain, make_layer
from upscale_video_tpu_torch.ops.conv_chain_q8 import (
    conv3x3_chain_q8, conv3x3_chain_q8_plain, make_q8_layer,
)
from upscale_video_tpu_torch.tools import bench_common
from upscale_video_tpu_torch.tools.wino_bench import cudnn_body, cudnn_weights


def make_q8_body(rng, n, c, height, width):
    """``(int8 layer dicts, bf16-twin layer dicts, int8 frame)`` drawn as
    the JAX tool draws them."""
    wq = [rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
          for _ in range(n)]
    bias = [rng.normal(0, 0.02, (c,)).astype(np.float32) for _ in range(n)]
    slope = [rng.uniform(0.1, 0.3, (c,)).astype(np.float32) for _ in range(n)]
    x8 = rng.integers(-127, 128, (height, width, c)).astype(np.int8)
    scale = np.full((c,), 1.0 / (64.0 * 127.0), np.float32)
    q8 = [{"wq": w, "scale": scale, "bias": b, "slope": s,
           "inv_out": np.float32(127.0), "act": ACT_PRELU}
          for w, b, s in zip(wq, bias, slope)]
    # bf16 twins of the same weights (scale 1/64 keeps activations O(1))
    bf = [{"weight": w.astype(np.float32) / 64.0, "bias": b, "slope": s,
           "act": ACT_PRELU} for w, b, s in zip(wq, bias, slope)]
    return q8, bf, x8


def main(argv=None) -> int:
    args = bench_common.parser(__doc__, "q8,direct,cudnn").parse_args(argv)
    dev = bench_common.device_of(args)
    c, n = args.channels, args.layers
    q8, bf, x8 = make_q8_body(np.random.default_rng(0), n, c, args.height,
                              args.width)
    x8 = torch.from_numpy(x8)[None].to(dev)
    xb = x8.to(torch.bfloat16) / 127.0
    k8 = [make_q8_layer(l["wq"], l["scale"], l["bias"], l["slope"],
                        l["inv_out"], l["act"], device=dev) for l in q8]
    k1 = [make_layer(l["weight"], l["bias"], l["slope"], l["act"], device=dev)
          for l in bf]
    cw = cudnn_weights(bf, dev)
    bodies = {"q8": lambda: conv3x3_chain_q8(x8, k8),
              "direct": lambda: conv3x3_chain(xb, k1),
              "cudnn": lambda: cudnn_body(xb, cw)}
    impls = args.impls.split(",")
    conv3x3_chain_q8.launches = conv3x3_chain.launches = 0
    conv3x3_chain.launches_sm90 = 0
    ms = bench_common.time_impls({i: bodies[i] for i in impls}, args.reps, dev)
    flop = 2 * 9 * args.height * args.width * c * c * n
    bench_common.report(ms, 1, n, flop, "TOP/s-equiv")
    bench_common.launches_line((conv3x3_chain_q8, conv3x3_chain))
    if args.skip_parity or "q8" not in impls:
        return 0
    ok = bench_common.parity_line(
        "q8 kernel vs conv3x3_chain_q8_plain", conv3x3_chain_q8(x8, k8),
        conv3x3_chain_q8_plain(x8, k8), 0.0, 0.0, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
