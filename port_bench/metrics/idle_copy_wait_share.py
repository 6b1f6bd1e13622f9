"""idle_copy_wait_share: the share of the window in which the GPU ran no
kernel while the main thread waited on an upload or a download
(``loop.h2d_wait``, ``loop.d2h_wait``: the copies share the compute
stream), in %; under dp on the GPU ``device_idle_share`` reads.  From the
device trace and the main thread's ``loop.*`` ranges in it."""

from port_bench.loop_spans import idle_split

LAYER = "device"
MOVES = "fps"


def read(run):
    split = idle_split(run)
    return None if split is None else 100.0 * split[2]
