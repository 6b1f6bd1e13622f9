"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

The sources expose a plain C interface (no PyTorch headers).  Each source
compiles on its own nvcc process, all started together, so the build takes
as long as its slowest source; one more nvcc call links the objects::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<source>.cu -o <source>.o  (each)
    nvcc -shared -o _build/libuvt_kernels_<hash>.so *.o

The library is built at first use into ``upscale_video_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
fresh checkout builds it on its first kernel call and a changed source
never loads a stale library.  Nothing here runs at import time: the CPU
tests import every module on a host with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("conv3x3_chain.cu", "conv3x3_chain_sm90.cu",
           "conv3x3_chain_narrow_sm90.cu", "sr_tail.cu", "sr_tail_sm90.cu",
           "rdb_block_sm90.cu", "nlmeans_sm90.cu", "conv3x3_fused.cu",
           "conv3x3_fused_sm90.cu", "conv_winograd.cu", "conv_winograd_sm90.cu",
           "conv_chain_q8.cu", "conv_chain_q8_sm90.cu",
           "window_attention_sm90.cu")
HEADERS = ("conv3x3_core.cuh", "conv3x3_plain.cuh", "sm90_common.cuh",
           "conv3x3_ring_sm90.cuh", "conv3x3_halo_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # src, dst, wmat, bias, slope, n, h, w, cin, cout, act, stream
    "uvt_conv3x3_chain_layer": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "uvt_conv3x3_chain_layer_sm90": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # src, dst, wpack, bias, slope, n, h, w, cin, cout, act, stream
    "uvt_conv3x3_chain_layer_narrow_sm90": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # src, skip, wmat, bias, out, n, h, w, cin, scale, layout, stream
    "uvt_sr_tail": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # u, skip, wmat, bias, out, n, h, w, cin, scale, layout, stream
    "uvt_sr_tail_plain": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # src, skip, wpack, bias, out, n, h, w, scale, layout, full_range, stream
    "uvt_sr_tail_sm90": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # u, skip, wmat, bias, out, n, h, w, cin, scale, layout, full_range, stream
    "uvt_sr_tail_plain_sm90": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # x, out, wmat, bias, slope, leaky, n, h, w, cin, cout, act, out_f32, stream
    "uvt_conv3x3_fused": ([_P] * 5 + [ctypes.c_float] + [_I] * 7 + [_P], _I),
    # x, out, wmat, bias, slope, leaky, n, h, w, cin, c_in_total, cout,
    # c_out_total, out_off, act, stream
    "uvt_conv3x3_fused_sm90": ([_P] * 5 + [ctypes.c_float] + [_I] * 9 + [_P], _I),
    # x, out, wstream, bpack, scratch, c2f, n, h, w, slope, stream
    "uvt_rdb_block_sm90": ([_P] * 6 + [_I] * 3 + [ctypes.c_float, _P], _I),
    # x, out, n, h, w, inv_h2, two_s2, stream
    "uvt_nl_means_sm90": ([_P] * 2 + [_I] * 3 + [ctypes.c_float] * 2 + [_P], _I),
    # src, dst, umat, bias, slope, n, h, w, cin, cout, act, stream
    "uvt_conv_winograd_layer": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "uvt_conv_winograd_layer_sm90": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # src, dst, wmat, scale, bias, slope, inv_out, n, h, w, cin, cout, act,
    # to_int8, stream
    "uvt_conv3x3_chain_q8_layer": ([_P] * 6 + [ctypes.c_float] + [_I] * 7
                                   + [_P], _I),
    # src, dst, wpack, scale, bias, slope, inv_out, n, h, w, cin, cout, act,
    # to_int8, stream
    "uvt_conv3x3_chain_q8_layer_sm90": ([_P] * 6 + [ctypes.c_float]
                                        + [_I] * 7 + [_P], _I),
    # qkv, out, table, n, h, w, heads, d, shift, scale, stream
    "uvt_window_attention_sm90": ([_P] * 3 + [_I] * 6 + [ctypes.c_float, _P],
                                  _I),
    "uvt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None  # 0.0 when the cached .so loaded


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda; raises."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libuvt_kernels_{source_hash()}.so"


def _run(cmds) -> None:
    """Run nvcc commands concurrently; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{o[-8000:]}")


def build() -> Path:
    """Compile the sources into the hashed library unless it exists."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, Path(s).stem + ".o") for s in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", o]
              for s, o in zip(SOURCES, objs)])
        tmp = os.path.join(tmpdir, out.name)
        _run([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    last_build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def launch(fn, device, what: str, *args) -> None:
    """Call the entry point ``fn`` with ``args`` and the current stream of
    ``device``, under that device, and raise if it returned a CUDA error.
    The C side reads the current device for its SM count, its grid and its
    shared-memory attribute, so every kernel launch of the port goes
    through here: a launch for ``cuda:1`` from a thread whose current
    device is 0 would otherwise run on device 1's stream with device 0's
    set-up."""
    import contextlib

    import torch

    scope = (torch.cuda.device(device) if device.type == "cuda"
             else contextlib.nullcontext())
    with scope:
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(code, what)


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = library().uvt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
