"""mfu: the work of the frames the window completed over window seconds x
989 TFLOP/s x GPUs, in %.  A frame's work (``Run.flops_per_frame``) is
the family's own ``flops(cfg, height, width)`` where ``models/<family>.py``
defines one, else the benchmark's frozen count over the configuration's
graph (``flops.graph_conv_flops``); x8 under ``--tta``.  Counted: 2 x the
multiply-adds of convolutions, linear layers and attention's two products
(QK^T and AV) over the frame's useful pixels, with no tile halos; not
counted: norms, softmax, activations and elementwise ops.  The same work
whatever implements it."""

from port_bench.flops import PEAK_BF16_FLOPS

LAYER = "engine step"
MOVES = "fps"


def read(run):
    return (100.0 * run.flops_per_frame * run.frames
            / (run.window_s * PEAK_BF16_FLOPS * run.gpus))
