"""frame_latency_p95_ms: the 95th percentile over every frame of the window
of the time from the source handing the frame out to the sink receiving
it.  Host clock."""

import numpy as np

LAYER = "end to end"
MOVES = None


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(run.latencies_ms, 95))
