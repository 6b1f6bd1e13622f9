"""device_idle_share: the share of the window in which no kernel ran on a
GPU (copies do not count as busy), in %; under dp the highest of the
GPUs."""

LAYER = "device"
MOVES = "fps"


def read(run):
    if run.trace is None:
        return None
    tr = run.trace
    return max(100.0 * (1.0 - tr.busy_s(d) / tr.window_s)
               for d in range(run.gpus))
