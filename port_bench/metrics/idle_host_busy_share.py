"""idle_host_busy_share: the share of the window in which the GPU ran no
kernel while the main thread was in none of ``loop.decode``,
``loop.h2d_wait``, ``loop.d2h_wait`` or ``loop.encode`` (the device idle
because the host was busy), in %; under dp on the GPU
``device_idle_share`` reads.  From the device trace and the main thread's
``loop.*`` ranges in it."""

from port_bench.loop_spans import idle_split

LAYER = "device"
MOVES = "fps"


def read(run):
    split = idle_split(run)
    if split is None:
        return None
    idle, waiting, _ = split
    return 100.0 * (idle - waiting)
