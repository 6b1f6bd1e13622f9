"""Shared on-demand builder for the first-party C++ libraries.

Both native modules (pipeio, imgproc) build their shared object from
``native/*.cpp`` with g++ on first use and fall back to pure Python when no
compiler exists.  This is the ONE copy of the cache/fallback-dir logic —
it used to live duplicated (and drifting: only imgproc had the
``-march=native`` retry) in both binding modules.
"""

from __future__ import annotations

import hashlib
import logging
import os
import platform
import shutil
import subprocess
from typing import List, Optional

log = logging.getLogger(__name__)

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def _isa_tag() -> str:
    """Short fingerprint of the host ISA for the build-cache file name.

    Builds use ``-march=native``, so a cached .so migrated to a host with
    an older ISA (shared ~/.cache or a copied tree) would SIGILL with no
    rebuild trigger.  Embedding the CPU feature fingerprint in the name
    makes an ISA mismatch a cache miss instead.
    """
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line
                    break
    except OSError:
        pass
    digest = hashlib.sha256(
        (platform.machine() + feats).encode()
    ).hexdigest()[:10]
    return digest


def build_library(src_name: str, lib_name: str,
                  extra_flags: Optional[List[str]] = None) -> Optional[str]:
    """Compile ``native/<src_name>`` into ``<lib_name>`` (cached by mtime;
    falls back to ``~/.cache/upscale_video_tpu`` when the tree is
    read-only).  Returns the library path or None (no compiler / failure).

    Tries ``-march=native`` first (vectorizes the pixel loops ~20x at 4K),
    then the portable flags.
    """
    src = os.path.join(NATIVE_DIR, src_name)
    if not os.path.exists(src):
        log.warning("native source %s missing", src)
        return None
    root, ext = os.path.splitext(lib_name)
    lib_name = f"{root}-{_isa_tag()}{ext}"
    out = os.path.join(NATIVE_DIR, lib_name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    gxx = shutil.which("g++") or shutil.which("c++")
    if not gxx:
        return None
    build_dir = NATIVE_DIR
    if not os.access(build_dir, os.W_OK):
        build_dir = os.path.join(
            os.path.expanduser("~"), ".cache", "upscale_video_tpu"
        )
        os.makedirs(build_dir, exist_ok=True)
        out = os.path.join(build_dir, lib_name)
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
            return out
    base = [gxx, "-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall"]
    base += extra_flags or []
    result = None
    for extra in (["-march=native"], []):
        cmd = base + extra + ["-shared", "-o", out, src]
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode == 0:
            return out
    log.warning("native build of %s failed: %s", src_name,
                (result.stderr if result else "")[-400:])
    return None
