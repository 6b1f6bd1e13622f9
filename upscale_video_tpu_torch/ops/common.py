"""Activation codes shared by the conv kernels and their plain versions.

The same encoding as ``upscale_video_tpu/ops/conv_pallas.py:50-53``, which
both JAX kernel families share; the CUDA sources use the same integers.
"""

ACT_NONE = 0
ACT_PRELU = 1  # per-channel slope
ACT_LEAKY = 2  # scalar slope (broadcast over channels by the caller)
ACT_RELU = 3
