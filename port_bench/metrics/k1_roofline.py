"""k1_roofline: the bound of K1's work in the window over the device time of
K1's kernels, in %.  K1 is the port's conv chain (``csrc/conv3x3_chain
*.cu``): one launch per body conv of the family's ``k1_layers`` per step
(per GPU under dp), for each of the 8 passes under ``--tta``.  The bound
of a launch is the larger of its FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s, input and output activations and weights in bf16, each once."""

import re

from port_bench.flops import conv_launch_bound_s
from port_bench.ncnn import conv_shape

LAYER = "kernels"
MOVES = "fps"
KERNELS = re.compile(r"\bchain_layer_(?:sm90_|narrow_)?kernel\b")


def read(run):
    if run.trace is None or not hasattr(run.family, "k1_layers"):
        return None
    seconds = run.trace.kernel_seconds(lambda n: KERNELS.search(n) is not None)
    if seconds <= 0:
        return None
    convs = {layer.name: layer for layer in run.layers}
    n, h, w = run.frames_per_launch, run.traffic["height"], run.traffic["width"]
    per_launch = 0.0
    for name in run.family.k1_layers(run.cfg):
        cout, cin, k, _ = conv_shape(convs[name])
        per_launch += conv_launch_bound_s(n, h, w, cin, cout, k)
    passes = 8 if run.traffic.get("tta") else 1
    return 100.0 * per_launch * passes * (run.n_frames / n) / seconds
