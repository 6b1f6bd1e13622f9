"""Multi-GPU parallelism (meshes, data, spatial and tensor sharding) and
host-side pipelining (decode-ahead source, writer-thread sink).

Port of ``upscale_video_tpu/parallel``: frame-level data parallelism
(``dp``: the batch split over GPUs, one replica of the step on each),
intra-frame spatial parallelism (``sp``: each frame's rows split over
GPUs) and channel tensor parallelism (``tp``: each conv's output channels
split over GPUs, the activations replicated).
"""

from upscale_video_tpu_torch.parallel.mesh import make_mesh, parse_chips
from upscale_video_tpu_torch.parallel.spatial import spatial_forward
from upscale_video_tpu_torch.parallel.data import data_parallel_fn, shard_batch
from upscale_video_tpu_torch.parallel.tensor import (
    shard_params_channelwise,
    tensor_parallel_fn,
)

__all__ = [
    "make_mesh",
    "parse_chips",
    "spatial_forward",
    "data_parallel_fn",
    "shard_batch",
    "shard_params_channelwise",
    "tensor_parallel_fn",
]
