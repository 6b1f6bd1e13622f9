"""sink_interleave_ms: the mean time the port's ``AsyncSink`` thread spends
in its transform a frame (``sink.interleave``: under the 4:2:0 contract
``ops/yuv.py:packed_to_i420``, the host's interleave of the packed output
into I420 planes), in ms, from the program's record of the window's loop.
Inside the loop, beside the main and prefetch threads."""

from port_bench.loop_spans import mean_ms, record

LAYER = "stream loop"
MOVES = "fps"


def read(run):
    return mean_ms(record(), "sink.interleave")
