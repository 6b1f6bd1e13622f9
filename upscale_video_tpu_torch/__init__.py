"""upscale_video_tpu_torch — the PyTorch + CUDA port of ``upscale_video_tpu``.

The JAX package beside it is the reference.  This package mirrors its
layout module for module (``models/``, ``ops/``, ``pipeline/``,
``parallel/``, ``cli/``, ``video/``, ``native/``, ``utils/``) and adds
``csrc/`` (hand-written CUDA C++ kernels for Hopper, ``sm_90a``) and
``kernels/`` (their nvcc build and ctypes binding).  It imports ``torch``,
never ``jax``, and nothing of the JAX package: the host modules it shares
with it are copies.

Layouts at public functions stay the JAX package's: NHWC frames, HWIO
weights, and the BGR model domain.  Every public entry takes an explicit
``device``; :func:`resolve_device` never substitutes the CPU for a
missing GPU.

The port covers the default ``upscale-video -i X`` path (the 2x SRVGG
Compact model, whole-frame), ``-m r`` (the 4x Valar RRDBNet, mixed
precision, tiled), the pre-SR stages ``-m n=K`` (NL-means) and ``-m a``
(the 1x anime deblur model), ``--tta`` and ``-s 1``, on the stream plane,
under the u8 (shuffle-planar or full-frame) and the 4:2:0 contracts.
"""

from upscale_video_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
