"""step_dispatch_ms: the mean host time of a step's dispatch
(``loop.dispatch`` in ``BatchedStepper``: the upload, the step's launches
and the queued download; under dp ``ShardedStep.launch``, one host thread
over every GPU), in ms, from the program's record of the window's loop."""

from port_bench.loop_spans import mean_ms, record

LAYER = "engine step"
MOVES = "fps"


def read(run):
    return mean_ms(record(), "loop.dispatch")
