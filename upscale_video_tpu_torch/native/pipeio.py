"""ctypes bindings for the native pipe transport (native/pipeio.cpp).

Builds the shared library on first use with g++ (no pybind11 in this
toolchain); callers fall back to the pure-Python pipe path in
:mod:`upscale_video_tpu_torch.video.io` when no compiler is available — the
native path changes throughput, never semantics.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_LIB_NAME = "libpipeio.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build_library() -> Optional[str]:
    from upscale_video_tpu_torch.native.buildlib import build_library

    return build_library("pipeio.cpp", _LIB_NAME)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build_library()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.pipeio_reader_open.restype = ctypes.c_void_p
        lib.pipeio_reader_open.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int]
        lib.pipeio_reader_acquire.restype = ctypes.c_long
        lib.pipeio_reader_acquire.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))
        ]
        lib.pipeio_reader_release.argtypes = [ctypes.c_void_p]
        lib.pipeio_writer_open.restype = ctypes.c_void_p
        lib.pipeio_writer_open.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_int]
        lib.pipeio_writer_submit.restype = ctypes.c_int
        lib.pipeio_writer_submit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)
        ]
        lib.pipeio_writer_flush.restype = ctypes.c_int
        lib.pipeio_writer_flush.argtypes = [ctypes.c_void_p]
        lib.pipeio_writer_flush_timeout.restype = ctypes.c_int
        lib.pipeio_writer_flush_timeout.argtypes = [
            ctypes.c_void_p, ctypes.c_long
        ]
        lib.pipeio_has_error.restype = ctypes.c_int
        lib.pipeio_has_error.argtypes = [ctypes.c_void_p]
        lib.pipeio_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


class NativePipeReader:
    """Reads fixed-size frames from a file descriptor via the C++ ring."""

    def __init__(self, fd: int, frame_bytes: int, n_buffers: int = 4):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native pipeio unavailable (no compiler)")
        self._lib = lib
        self.frame_bytes = frame_bytes
        self._h = lib.pipeio_reader_open(fd, frame_bytes, n_buffers)
        if not self._h:
            raise RuntimeError("pipeio_reader_open failed")

    def read(self) -> Optional[np.ndarray]:
        """Next frame as a COPY (uint8 flat array), or None at EOF."""
        ptr = ctypes.POINTER(ctypes.c_ubyte)()
        slot = self._lib.pipeio_reader_acquire(self._h, ctypes.byref(ptr))
        if slot == -1:
            return None
        if slot == -2:
            raise IOError("native pipe reader error")
        buf = np.ctypeslib.as_array(ptr, shape=(self.frame_bytes,)).copy()
        self._lib.pipeio_reader_release(self._h)
        return buf

    def close(self) -> None:
        if self._h:
            self._lib.pipeio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativePipeWriter:
    """Writes fixed-size frames to a file descriptor via the C++ ring."""

    def __init__(self, fd: int, frame_bytes: int, n_buffers: int = 4,
                 flush_timeout_ms: Optional[int] = None):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native pipeio unavailable (no compiler)")
        self._lib = lib
        self.frame_bytes = frame_bytes
        # drain deadline before declaring the encoder wedged: scale with
        # ring depth so a legitimately slow (not stuck) software encoder —
        # e.g. AV1 at tens of seconds/frame draining n_buffers pending
        # frames — is not misclassified and its fragment deleted
        self.flush_timeout_ms = (
            flush_timeout_ms if flush_timeout_ms
            else 120_000 + 60_000 * n_buffers
        )
        self._h = lib.pipeio_writer_open(fd, frame_bytes, n_buffers)
        if not self._h:
            raise RuntimeError("pipeio_writer_open failed")

    def write(self, frame: np.ndarray) -> None:
        data = np.ascontiguousarray(frame, dtype=np.uint8)
        if data.nbytes != self.frame_bytes:
            raise ValueError(f"frame is {data.nbytes} bytes, expected {self.frame_bytes}")
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        if self._lib.pipeio_writer_submit(self._h, ptr) != 0:
            raise IOError("native pipe writer error")

    def flush(self, timeout_ms: int = 0) -> None:
        rc = self._lib.pipeio_writer_flush_timeout(
            self._h, timeout_ms or self.flush_timeout_ms
        )
        if rc == -1:
            raise IOError("native pipe writer flush timed out "
                          "(encoder not draining)")
        if rc != 0:
            raise IOError("native pipe writer error on flush")

    def close(self) -> None:
        """Flush then tear down.  Raises if submitted frames could NOT be
        delivered (writer error or wedged encoder) — silently dropping
        ring-tail frames would leave a short fragment that resume and
        concat trust as complete."""
        if self._h:
            rc = self._lib.pipeio_writer_flush_timeout(
                self._h, self.flush_timeout_ms
            )
            self._lib.pipeio_close(self._h)
            self._h = None
            if rc == -1:
                raise IOError("native pipe writer close: flush timed out "
                              "(encoder not draining)")
            if rc != 0:
                raise IOError(
                    "native pipe writer error: not all frames reached the "
                    "encoder"
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
