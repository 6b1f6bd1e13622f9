"""Sleep inhibition during long jobs.

The reference holds ``wakepy keep.running()`` for the whole pipeline
(upscale/upscale_processing.py:847) so a desktop doesn't suspend mid-movie.
TPU hosts are servers and never sleep, so the default here is a no-op —
but when ``wakepy`` happens to be installed (a laptop driving a remote
chip), it is used for real.  Note the reference's split-machine tools
reference ``keep.running`` without importing it (upscale_only.py:125,
merge_only.py:80 — a NameError at runtime); this shim is what they meant.
"""

from __future__ import annotations

import contextlib
import logging

log = logging.getLogger(__name__)


@contextlib.contextmanager
def keep_awake():
    """Context manager: inhibit host sleep if a mechanism exists."""
    cm = None
    try:
        from wakepy import keep  # optional; not in server images

        cm = keep.running()
        cm.__enter__()
    except Exception as e:  # absent, or present but no DBus/session
        cm = None
        log.debug("sleep inhibit unavailable: %s", e)
    try:
        yield
    finally:
        if cm is not None:
            try:
                cm.__exit__(None, None, None)
            except Exception:
                pass
