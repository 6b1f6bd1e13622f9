"""glue_share: device time in kernels that are not the port's own
(``csrc/``: the plain torch glue of ``ops/pixel.py``, ``ops/yuv.py``,
``ops/tiling.py``, casts, residual adds) over all kernel time, in %."""

import re

LAYER = "plain torch glue"
MOVES = "fps"
PORT_KERNELS = re.compile(
    r"\b(?:chain_layer_(?:sm90_|narrow_)?kernel|conv3x3_fused(?:_sm90)?_kernel"
    r"|q8_layer(?:_sm90)?_kernel|wino_layer(?:_sm90)?_kernel|nl_means_sm90"
    r"|rdb_block_sm90_kernel|sr_tail(?:_plain)?(?:_sm90)?_kernel)\b")


def read(run):
    if run.trace is None:
        return None
    total = run.trace.kernel_seconds()
    if total <= 0:
        return None
    port = run.trace.kernel_seconds(lambda n: PORT_KERNELS.search(n) is not None)
    return 100.0 * (total - port) / total
