"""Multi-GPU parallelism (meshes, data and spatial sharding) and host-side
pipelining (decode-ahead source, writer-thread sink).

Port of ``upscale_video_tpu/parallel``: frame-level data parallelism
(``dp``: the batch split over GPUs, one replica of the step on each) and
intra-frame spatial parallelism (``sp``: each frame's rows split over
GPUs).  The JAX package's channel tensor parallelism (``tp``) is not
ported.
"""

from upscale_video_tpu_torch.parallel.mesh import make_mesh, parse_chips
from upscale_video_tpu_torch.parallel.spatial import spatial_forward
from upscale_video_tpu_torch.parallel.data import data_parallel_fn, shard_batch

__all__ = [
    "make_mesh",
    "parse_chips",
    "spatial_forward",
    "data_parallel_fn",
    "shard_batch",
]
