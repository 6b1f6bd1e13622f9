"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the run from the
engine's build on, of the fullest GPU, in GiB."""

LAYER = "end to end"
MOVES = None


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
