"""mfu: conv FLOPs of the frames the window completed (the benchmark's
frozen count over the configuration's graph, useful work only: no tile
halos; x8 under ``--tta``) over window seconds x 989 TFLOP/s x GPUs, in
%.  The same work whatever implements it."""

from port_bench.flops import PEAK_BF16_FLOPS

LAYER = "engine step"
MOVES = "fps"


def read(run):
    return (100.0 * run.flops_per_frame * run.frames
            / (run.window_s * PEAK_BF16_FLOPS * run.gpus))
