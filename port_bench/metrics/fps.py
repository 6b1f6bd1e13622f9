"""fps: output frames the sink received over the window's wall time (the
frames of every GPU under dp).  Host clock."""

LAYER = "end to end"
MOVES = None


def read(run):
    return run.frames / run.window_s
