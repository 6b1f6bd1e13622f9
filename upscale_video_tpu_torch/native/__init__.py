"""Native host-side runtime components (C++ via ctypes)."""

from upscale_video_tpu_torch.native.pipeio import (
    NativePipeReader,
    NativePipeWriter,
    native_available,
)

__all__ = ["NativePipeReader", "NativePipeWriter", "native_available"]
