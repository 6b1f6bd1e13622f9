"""k5_roofline: the bound of K5's work in the window over the device time of
K5's kernels, in %.  K5 (``csrc/rdb_block_sm90.cu``) runs one dense block
(the family's ``dense_block_convs``) over a batch of haloed tiles; per
frame, every dense block over every tile of the configuration's grid.  The
bound is the larger of the FLOPs at 989 TFLOP/s and the bytes (the block's
64-channel input and output in bf16 and its weights, each once) at 3.35
TB/s."""

import math
import re

from port_bench.flops import conv_flops, launch_bound_s
from port_bench.reference import fit_tile_grid

LAYER = "kernels"
MOVES = "fps"
KERNELS = re.compile(r"\brdb_block_sm90_kernel\b")


def read(run):
    if run.trace is None or not hasattr(run.family, "dense_block_convs"):
        return None
    seconds = run.trace.kernel_seconds(lambda n: KERNELS.search(n) is not None)
    if seconds <= 0:
        return None
    cfg, t = run.cfg, run.traffic
    budget, halo = t.get("tile_size") or cfg["tile"], cfg["halo"]
    th, tw = fit_tile_grid(t["height"], t["width"], budget)
    tiles = math.ceil(t["height"] / th) * math.ceil(t["width"] / tw)
    h, w = th + 2 * halo, tw + 2 * halo
    convs = run.family.dense_block_convs(cfg)
    flops = sum(conv_flops(tiles, h, w, cin, cout, k) for cin, cout, k in convs)
    nf = convs[0][0]
    nbytes = 2 * (tiles * h * w * 2 * nf
                  + sum(k * k * cin * cout for cin, cout, k in convs))
    per_frame = run.family.dense_blocks(cfg) * launch_bound_s(flops, nbytes)
    return 100.0 * per_frame * run.n_frames / seconds
