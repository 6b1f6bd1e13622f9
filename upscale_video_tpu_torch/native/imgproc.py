"""ctypes bindings for the native colour converter (native/imgproc.cpp).

The hermetic Y4M plane needs RGB<->YCbCr444 per frame; the numpy version
costs ~285 ms per 4K frame (host-bound pipeline), the native one ~10-20 ms.
Callers fall back to the numpy path when no compiler is available — the
native path changes throughput, never semantics (same float op order and
round-half-to-even as np.round; parity-tested in tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_LIB_NAME = "libimgproc.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_DEF_THREADS = min(8, os.cpu_count() or 1)


def _build_library() -> Optional[str]:
    # -fno-math-errno/-fno-trapping-math let nearbyintf vectorize to the
    # hardware round instruction (20x at 4K); -ffp-contract=off keeps FMA
    # from perturbing the float results, preserving bit-parity with numpy
    from upscale_video_tpu_torch.native.buildlib import build_library

    return build_library(
        "imgproc.cpp", _LIB_NAME,
        extra_flags=["-fno-math-errno", "-fno-trapping-math",
                     "-ffp-contract=off"],
    )


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
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.imgproc_rgb_to_ycbcr444.argtypes = [
            u8p, u8p, u8p, u8p, ctypes.c_int64, ctypes.c_int
        ]
        lib.imgproc_ycbcr444_to_rgb.argtypes = [
            u8p, u8p, u8p, u8p, ctypes.c_int64, ctypes.c_int
        ]
        lib.imgproc_planar_interleave.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.imgproc_planar_interleave_c.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.imgproc_planar_interleave_s.argtypes = [
            u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def rgb_to_ycbcr444(rgb: np.ndarray, threads: int = 0,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (3, H, W) uint8 planar YCbCr (full-range
    BT.601), ready to write as three y4m planes.  ``out`` reuses a caller
    buffer (hot-path sinks)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native imgproc unavailable (no compiler)")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    if out is None:
        out = np.empty((3, h, w), np.uint8)
    elif (out.shape != (3, h, w) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out buffer {out.shape}/{out.dtype} mismatch")
    lib.imgproc_rgb_to_ycbcr444(
        _u8p(rgb), _u8p(out[0]), _u8p(out[1]), _u8p(out[2]),
        h * w, threads or _DEF_THREADS,
    )
    return out


def ycbcr444_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                    threads: int = 0) -> np.ndarray:
    """Three (H, W) uint8 planes -> (H, W, 3) uint8 RGB."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native imgproc unavailable (no compiler)")
    y = np.ascontiguousarray(y, dtype=np.uint8)
    cb = np.ascontiguousarray(cb, dtype=np.uint8)
    cr = np.ascontiguousarray(cr, dtype=np.uint8)
    out = np.empty((*y.shape, 3), np.uint8)
    lib.imgproc_ycbcr444_to_rgb(
        _u8p(y), _u8p(cb), _u8p(cr), _u8p(out),
        y.size, threads or _DEF_THREADS,
    )
    return out


def planar_interleave(p: np.ndarray, s: int, threads: int = 0,
                      out: Optional[np.ndarray] = None,
                      channels: int = 3) -> np.ndarray:
    """Shuffle-planar uint8 (H, W, C*s*s) in (i, j, c) plane order ->
    interleaved (H*s, W*s, C) — the host half of the shuffle-planar
    output contract (ops/pixel.planar_to_frames routes here when the
    native library is available; pure byte moves, bit-exact by construction
    and parity-tested against the numpy path).  C=3 is the RGB contract;
    C=1 assembles the planes of the packed 4:2:0 contract (ops/yuv.py)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native imgproc unavailable (no compiler)")
    p = np.ascontiguousarray(p, dtype=np.uint8)
    h, w, c = p.shape
    if c != channels * s * s:
        # must survive `python -O`: a wrong shuffle factor would feed the C
        # loop a wrong in_px stride and read past the input buffer
        raise ValueError(
            f"planar frame has {c} channels, expected "
            f"{channels}*{s}*{s}={channels * s * s}"
        )
    if out is None:
        # callers on a hot path pass a reused ``out`` — a fresh 25 MB
        # allocation per 4K frame costs more in page faults than the
        # interleave itself on small hosts (round-3 load test)
        out = np.empty((h * s, w * s, channels), np.uint8)
    elif (out.shape != (h * s, w * s, channels) or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out buffer {out.shape}/{out.dtype} mismatch")
    lib.imgproc_planar_interleave_c(
        _u8p(p), _u8p(out), h, w, s, channels, threads or _DEF_THREADS,
    )
    return out


def planar_interleave_view(p: np.ndarray, s: int, channels: int,
                           out: np.ndarray, threads: int = 0) -> np.ndarray:
    """Zero-copy variant of :func:`planar_interleave` for a channel-slice
    VIEW of a wider packed buffer (e.g. the Y section ``packed[..., :s*s]``
    of the 4:2:0 contract, ops/yuv.py) — the view's pixel stride is passed
    through instead of forcing an ascontiguousarray copy of the plane."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native imgproc unavailable (no compiler)")
    h, w, c = p.shape
    if p.dtype != np.uint8 or c != channels * s * s:
        raise ValueError(
            f"view has {c}/{p.dtype} channels, expected uint8 "
            f"{channels}*{s}*{s}"
        )
    sh, sw, sc = p.strides
    if sc != 1 or sw < c or sh != w * sw:
        raise ValueError(f"unsupported view strides {p.strides}")
    if (out.shape != (h * s, w * s, channels) or out.dtype != np.uint8
            or not out.flags.c_contiguous):
        raise ValueError(f"out buffer {out.shape}/{out.dtype} mismatch")
    lib.imgproc_planar_interleave_s(
        _u8p(p), _u8p(out), h, w, s, channels, sw, threads or _DEF_THREADS,
    )
    return out
