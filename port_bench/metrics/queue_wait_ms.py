"""queue_wait_ms: the mean wait of a frame in the prefetch queue
(``source.queue``: from the decode thread's put to the main thread's get)
plus its mean wait in the sink queue (``sink.queue``: from the main
thread's put to the sink thread's get), in ms, from the program's record
of the window's loop: the part of a frame's latency spent queued."""

from port_bench.loop_spans import mean_ms, record

LAYER = "stream loop"
MOVES = "fps"


def read(run):
    rec = record()
    waits = [mean_ms(rec, "source.queue"), mean_ms(rec, "sink.queue")]
    return None if None in waits else sum(waits)
