"""glue_share: device time in kernels that are not the port's own
(``csrc/``: the plain torch glue of ``ops/pixel.py``, ``ops/yuv.py``,
``ops/tiling.py``, casts, residual adds) over all kernel time, in %.

A kernel is the port's when its name carries one of the port's C++
namespaces, ``uvt::`` or ``uvt_<name>::``, as every ``__global__`` of
``csrc/`` does (``void uvt_rdb_sm90::rdb_block_sm90_kernel<5>(...)``), so
a kernel a later change adds in such a namespace counts without an edit
here."""

import re

LAYER = "plain torch glue"
MOVES = "fps"
PORT_KERNELS = re.compile(r"\buvt(?:_\w+)?::")


def read(run):
    if run.trace is None:
        return None
    total = run.trace.kernel_seconds()
    if total <= 0:
        return None
    port = run.trace.kernel_seconds(lambda n: PORT_KERNELS.search(n) is not None)
    return 100.0 * (total - port) / total
