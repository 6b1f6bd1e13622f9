"""PNG-compat data plane: per-stage passes over the frame store.

Port of ``upscale_video_tpu/pipeline/stages.py``.  Each pass reads
``{frame}.{in_tag}.png``, writes ``{frame}.{out_tag}.png`` and deletes its
input on success, so file existence encodes per-frame progress, laid out
as the JAX package (and the reference) lay it out.  Frames go through the
engine's device in batches (:class:`BatchedStepper`); every PNG is read and
written by the port's own codec (:mod:`upscale_video_tpu_torch.video.png`),
so the plane needs no imaging library.

This plane exists for the workflows that need on-disk artifacts:
``--extract_only`` sampling, ``fix-frames`` repair, ``test-images``
parameter sweeps, and the zip-based split-machine hand-off.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch

from upscale_video_tpu_torch.pipeline.chain import BatchedStepper
from upscale_video_tpu_torch.video.frames import format_frame_ranges, frame_name
from upscale_video_tpu_torch.video.png import read_png, verify_png, write_png

log = logging.getLogger(__name__)


def extraction_done(workdir: str, frames_count: int) -> bool:
    """Whether the last frame has an artifact at any stage, the final
    ``{n}.png`` included: extraction then ran to its end and must not run
    again on resume.  (The JAX package looks at the three stage tags only,
    so a run killed while encoding its last batch re-extracts, and then
    re-runs the pre-SR stages on, every frame.)"""
    return any(
        os.path.exists(os.path.join(workdir, frame_name(frames_count, t)))
        for t in ("extract", "denoise", "anime", "")
    )


def run_stage_pass(
    workdir: str,
    frames: Sequence[int],
    in_tag: str,
    out_tag: str,
    step_fn: Callable,
    device: "torch.device | str",
    frames_per_step: int = 4,
    remove: bool = True,
    progress_label: str = "",
) -> int:
    """Run one model stage over the frame store on ``device``; returns the
    frames processed.

    Skips frames whose input artifact is missing (the reference's
    ``os.path.exists`` guard at upscale_processing.py:339, 585: missing
    means an earlier resume already consumed it).
    """
    todo: List[int] = [
        f for f in frames
        if os.path.exists(os.path.join(workdir, frame_name(f, in_tag)))
    ]
    if not todo:
        return 0

    stepper = BatchedStepper(step_fn, frames_per_step, device)
    pending: List[int] = []
    done = 0

    def _write(outputs: List[np.ndarray]):
        nonlocal done
        for out in outputs:
            f = pending.pop(0)
            write_png(os.path.join(workdir, frame_name(f, out_tag)), out)
            if remove:
                os.remove(os.path.join(workdir, frame_name(f, in_tag)))
            done += 1
            if progress_label:
                log.info("%s %d/%d", progress_label, done, len(todo))

    for f in todo:
        img = read_png(os.path.join(workdir, frame_name(f, in_tag)))
        pending.append(f)
        _write(stepper.feed(img))
    _write(stepper.flush())
    return done


def extract_to_pngs(source, workdir: str, tag: str = "extract") -> int:
    """Hermetic extraction: stream a FrameSource into ``{n}.extract.png``
    (the ffmpeg backend uses extract_cmd instead; reference
    upscale_processing.py:203-255)."""
    n = 0
    for frame in source:
        n += 1
        write_png(os.path.join(workdir, frame_name(n, tag)), frame)
    return n


def pngs_to_sink(workdir: str, start: int, end: int, sink) -> None:
    """Feed final ``{n}.png`` frames into a fragment sink (hermetic
    replacement for the image2-sequence encode at
    upscale_processing.py:615-639).

    On any decode/encode failure, scans the batch for corrupt PNGs (CRC
    and IEND, :func:`verify_png`) and raises with the ``fix-frames -b``
    repair hint (reference behaviour at upscale_processing.py:650-672).
    """
    try:
        for f in range(start, end + 1):
            sink.write(read_png(os.path.join(workdir, frame_name(f))))
    except Exception as e:
        bad = [f for f in range(start, end + 1)
               if not verify_png(os.path.join(workdir, frame_name(f)))]
        hint = (
            f"; corrupt frames detected: run fix-frames -b "
            f"{format_frame_ranges(bad)}" if bad else ""
        )
        raise RuntimeError(f"fragment encode failed ({e}){hint}") from e


def rename_stage_to_final(workdir: str, frames: Iterable[int], in_tag: str) -> None:
    """scale==1 path: the last stage's artifact IS the final frame
    (reference upscale_processing.py:928-932).  A frame an earlier run
    already renamed (its artifact gone, its final there) is left as it is,
    so a run killed while encoding the batch resumes."""
    for f in frames:
        src = os.path.join(workdir, frame_name(f, in_tag))
        dst = os.path.join(workdir, frame_name(f))
        if os.path.exists(src) or not os.path.exists(dst):
            os.rename(src, dst)


def run_chain_stages(engine, workdir, frames, frames_per_step, remove=True):
    """Denoise -> anime pre-SR passes over the PNG store; returns the final
    input tag.  The one place the PNG plane's stage order lives, shared by
    process_file's png plane and the upscale_only/fix_frames/process_image
    workflows (reference stage sequence at upscale_processing.py:883-909).
    """
    in_tag = "extract"
    if engine.spec.denoise:
        log.info("starting denoise touchup...")
        run_stage_pass(
            workdir, frames, in_tag, "denoise", engine.stage_fn("denoise"),
            engine.device, frames_per_step, remove=remove,
            progress_label="Denoised",
        )
        in_tag = "denoise"
    if engine.spec.anime:
        log.info("starting anime touchup...")
        run_stage_pass(
            workdir, frames, in_tag, "anime", engine.stage_fn("anime"),
            engine.device, frames_per_step, remove=remove,
            progress_label="Deblurred",
        )
        in_tag = "anime"
    return in_tag
