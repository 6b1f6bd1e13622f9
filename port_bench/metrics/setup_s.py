"""setup_s: from the start of the benchmark's process (its first statement)
to the first timed frame: imports, weights and model files, the engine's
build and planning, the kernels' build where the checkout has none yet,
and the warm-up calls of the loop.  Host clock."""

LAYER = "end to end"
MOVES = None


def read(run):
    return run.setup_s
