"""Full-pipeline orchestrator: ``process_file`` on either data plane.

Port of ``upscale_video_tpu/pipeline/process.py:55-558`` over the port's :class:`~upscale_video_tpu_torch.pipeline.chain.ChainEngine`.  The
video layer (:mod:`upscale_video_tpu_torch.video`: backends, Y4M/PNG/ffmpeg
I/O, batch math, sentinels) and the logging/timing helpers
(:mod:`upscale_video_tpu_torch.utils`) are the port's copies of the JAX
package's jax-free modules, so the temp dir, ``metadata.json``, fragments
and ``completed.txt`` are laid out exactly as the JAX package lays them
out.

Fragments are written in ``<workdir>/partial`` and moved to their names
once whole (:func:`open_fragment`, :func:`commit_fragment`), so a process
killed outright mid-fragment leaves nothing under a name that resume
skips; a whole fragment a JAX run left is skipped as before.

The stream plane (the default) decodes, steps and encodes without
spilling a frame.  The PNG plane (``data_plane="png"``) lays out the
reference's ``{frame}.{tag}.png`` store through the stage passes of
:mod:`upscale_video_tpu_torch.pipeline.stages`, and ``extract_only`` stops
after spilling ``{n}.extract.png``.  Not ported yet: multi-host runs.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from upscale_video_tpu_torch.device import resolve_device
from upscale_video_tpu_torch.parallel.executor import AsyncSink, PrefetchSource
from upscale_video_tpu_torch.pipeline import stages
from upscale_video_tpu_torch.pipeline.chain import (
    BatchedStepper, ChainEngine, ChainSpec, default_frames_per_step,
    precision_dtypes,
)
from upscale_video_tpu_torch.utils.logsetup import setup_logging
from upscale_video_tpu_torch.utils.profiling import StageTimer
from upscale_video_tpu_torch.utils.wake import keep_awake
from upscale_video_tpu_torch.video import (
    SENTINEL_COMPLETED,
    calc_batches,
    ffmpeg as ff,
    frames_per_batch,
    has_sentinel,
    make_backend,
    write_sentinel,
)

log = logging.getLogger(__name__)

VALID_SCALES = (1, 2, 4)
PARTIAL_DIR = "partial"  # under the workdir: fragments being written


def default_output_name(input_file: str, scale: int) -> str:
    """``input.{N}x.{ext}``; PNG-dir inputs get a ``.y4m`` container."""
    if os.path.isdir(input_file):
        return input_file.rstrip(os.sep) + f".{scale}x.y4m"
    parts = input_file.split(".")
    return ".".join(parts[:-1] + [f"{scale}x", parts[-1]])


def prepare_workdir(temp_dir: Optional[str], resume: bool) -> str:
    """Create/purge ``<temp>/upscale_video``."""
    base = temp_dir or tempfile.gettempdir()
    workdir = os.path.abspath(os.path.join(base, "upscale_video"))
    if os.path.exists(workdir) and not resume:
        shutil.rmtree(workdir)
    os.makedirs(workdir, exist_ok=True)
    return workdir


def open_fragment(backend, batch: int, width: int, height: int, info,
                  workdir: str, **kw):
    """Open ``batch``'s fragment sink in ``<workdir>/partial``, beside the
    name resume trusts; :func:`commit_fragment` moves it there once whole."""
    part = os.path.join(workdir, PARTIAL_DIR)
    os.makedirs(part, exist_ok=True)
    return backend.open_fragment_sink(batch, width, height, info, part, **kw)


def commit_fragment(backend, batch: int, workdir: str) -> None:
    """Move ``batch``'s whole fragment from ``<workdir>/partial`` to its
    name (one rename on the same file system) and drop the emptied dir."""
    name = backend.fragment_name(batch)
    part = os.path.join(workdir, PARTIAL_DIR)
    os.replace(os.path.join(part, name), os.path.join(workdir, name))
    with contextlib.suppress(OSError):
        os.rmdir(part)


def discard_fragment(backend, batch: int, workdir: str) -> None:
    """Remove ``batch``'s fragment in ``<workdir>/partial``, if any."""
    path = os.path.join(workdir, PARTIAL_DIR, backend.fragment_name(batch))
    if os.path.exists(path):
        os.remove(path)


@dataclass
class PipelineResult:
    output_file: str
    frames_processed: int
    elapsed_seconds: float
    frames_per_second: float
    pipe_pix: str = "rgb24"  # the resolved stream-plane contract


def process_file(
    input_file: str,
    output_file: Optional[str] = None,
    ffmpeg: Optional[str] = None,
    ffmpeg_encoder: str = "libx264",
    pix_fmt: str = "yuv420p",
    scale: int = 2,
    temp_dir: Optional[str] = None,
    batch_size: int = 10,
    chips: Optional[str] = None,
    resume_processing: bool = False,
    extract_only: bool = False,
    models: Optional[str] = None,
    log_level: Optional[int] = None,
    log_dir: Optional[str] = None,
    model_path: Optional[str] = None,
    precision: str = "auto",
    tile_size: "int | tuple | None" = None,
    halo: int = 16,
    frames_per_step: Optional[int] = None,
    global_quality: Optional[int] = 20,
    data_plane: str = "stream",
    synthetic_models: bool = False,
    copy_audio: bool = False,
    pipe_pix: str = "auto",
    device: str = "cuda",
    tta: bool = False,
    engine: Optional[ChainEngine] = None,
    conv_impl: str = "auto",
) -> Optional[PipelineResult]:
    """Upscale a video file end to end on ``device``.  Returns a
    PipelineResult, or None when the resume sentinel short-circuits.

    ``tile_size``/``halo`` tile the SR stage (None = the family's default:
    whole-frame Compact, 544 for ``-m r``); ``precision`` ``auto`` is
    ``mixed`` for ``-m r`` and bf16 otherwise; ``tta`` averages the SR
    stage over the 8 dihedral transforms of each frame; ``data_plane``
    ``png`` runs the stage passes over PNG files (:func:`_run_png_plane`);
    ``extract_only`` returns None after spilling ``{n}.extract.png``;
    ``conv_impl`` picks the kernels (:class:`ChainEngine`)."""
    if scale not in VALID_SCALES:
        raise ValueError(f"scale must be one of {VALID_SCALES}")
    if not os.path.exists(input_file):
        raise FileNotFoundError(input_file)
    dev = resolve_device(device)

    spec = ChainSpec.parse(models)
    scale = spec.effective_scale(scale)
    setup_logging(log_level, log_dir, input_file)

    output_file = os.path.abspath(
        output_file or default_output_name(input_file, scale)
    )
    log.info("processing %s -> %s", input_file, output_file)

    workdir = prepare_workdir(temp_dir, resume_processing)
    if resume_processing and has_sentinel(workdir, SENTINEL_COMPLETED):
        log.info("%s already processed (completed.txt)", input_file)
        return None

    backend = make_backend(
        ffmpeg, ffmpeg_encoder, pix_fmt,
        output_format=(output_file.split(".")[-1] if ffmpeg else "y4m"),
        global_quality=global_quality,
    )

    info = backend.probe(input_file, workdir)
    frames_count = info["number_of_frames"]
    crop = backend.crop_detect(input_file, info["duration"], workdir)
    if crop:
        log.info("crop detected: %s", crop)

    per_batch = frames_per_batch(info["frame_rate"], frames_count, batch_size)
    batches = calc_batches(frames_count, per_batch)

    if extract_only:
        _extract_all(backend, input_file, info, crop, workdir, ffmpeg)
        log.info("extract only — frames extraction completed")
        return None

    if engine is None:
        compute_dtype, residual_dtype = precision_dtypes(precision, spec)
        engine = ChainEngine.build(
            spec, scale, dev, model_path=model_path,
            compute_dtype=compute_dtype, synthetic=synthetic_models,
            residual_dtype=residual_dtype, tile=tile_size, halo=halo,
            tta=tta, conv_impl=conv_impl,
        )
    if frames_per_step is None:
        frames_per_step = default_frames_per_step(spec)
    frames_per_step = engine.configure_chips(chips, frames_per_step)
    log.info("model chain: %s on %s", engine.describe(), dev)

    if pipe_pix == "auto":
        pipe_pix = _auto_pipe_pix(backend, engine, info, crop, data_plane)

    t0 = time.time()
    with keep_awake():
        if data_plane == "png":
            if pipe_pix != "rgb24":
                log.warning(
                    "--pipe_pix %s applies to the stream plane only — the "
                    "png plane encodes from RGB files; ignoring", pipe_pix,
                )
            processed = _run_png_plane(
                engine, backend, input_file, info, crop, workdir, batches,
                frames_per_step, ffmpeg,
            )
        else:
            processed = _run_stream_plane(
                engine, backend, input_file, info, crop, workdir, batches,
                frames_per_step, pipe_pix=pipe_pix,
            )
    elapsed = time.time() - t0

    backend.concat(len(batches), output_file, workdir)
    if copy_audio and ffmpeg:
        _mux_audio(ffmpeg, output_file, input_file)
    write_sentinel(workdir, SENTINEL_COMPLETED, "Completed")
    fps = processed / elapsed if elapsed > 0 else 0.0
    log.info("finished %s: %d frames in %.1fs (%.2f fps)",
             output_file, processed, elapsed, fps)

    if not resume_processing:
        shutil.rmtree(workdir)
    return PipelineResult(output_file, processed, elapsed, fps,
                          pipe_pix=pipe_pix)


def _auto_pipe_pix(backend, engine, info, crop, data_plane) -> str:
    """Resolve ``--pipe_pix auto``: the 4:2:0 contract whenever it is
    lossless versus rgb24 (the stream plane, even output geometry, a 4:2:0
    8-bit encode target), else rgb24 — the JAX package's policy
    (process.py:233)."""
    src_h, src_w = backend.source_geometry(info, crop)
    out_h, out_w = src_h * engine.scale, src_w * engine.scale
    why = None
    if data_plane != "stream":
        why = "png plane encodes from RGB files"
    elif out_h % 2 or out_w % 2:
        why = f"odd output geometry {out_w}x{out_h}"
    elif not backend.auto_yuv420(info):
        why = "encode target is not 4:2:0 8-bit"
    if why is not None:
        log.info("pipe_pix auto -> rgb24 (%s)", why)
        return "rgb24"
    log.info("pipe_pix auto -> yuv420p (4:2:0 device contract, "
             "half the transfer bytes each way)")
    return "yuv420p"


def _mux_audio(ffmpeg, output_file, input_file) -> None:
    """Stream-copy the source's audio/subs into the upscaled output."""
    tmp = output_file + ".mux.tmp" + os.path.splitext(output_file)[1]
    result = ff.run_logged(ff.mux_audio_cmd(ffmpeg, output_file, input_file, tmp))
    if result.returncode != 0 or not os.path.exists(tmp):
        if os.path.exists(tmp):
            os.remove(tmp)
        log.warning("audio mux failed (output kept video-only): %s",
                    (result.stderr or "")[-200:])
        return
    os.replace(tmp, output_file)
    log.info("muxed original audio/subtitle streams into %s", output_file)


def _extract_all(backend, input_file, info, crop, workdir, ffmpeg) -> int:
    """Spill every frame as ``{n}.extract.png`` (reference :203-255)."""
    from upscale_video_tpu_torch.video.backend import FfmpegBackend

    if isinstance(backend, FfmpegBackend):
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            result = ff.run_logged(ff.extract_cmd(
                ffmpeg, input_file if os.path.isabs(input_file)
                else os.path.join(cwd, input_file), crop))
            if result.returncode != 0:
                raise RuntimeError(f"frame extraction failed: {result.stderr[-400:]}")
        finally:
            os.chdir(cwd)
        return info["number_of_frames"]
    with backend.open_source(input_file, info, crop) as src:
        return stages.extract_to_pngs(src, workdir)


def _run_stream_plane(
    engine, backend, input_file, info, crop, workdir, batches, frames_per_step,
    pipe_pix: str = "rgb24",
) -> int:
    """Streaming loop: sequential decode -> device step -> fragment
    encoders, with skip-if-exists resume per fragment."""
    src_h, src_w = backend.source_geometry(info, crop)
    out_h, out_w = src_h * engine.scale, src_w * engine.scale
    yuv420 = pipe_pix == "yuv420p"
    if yuv420 and (out_h % 2 or out_w % 2):
        log.warning(
            "--pipe_pix yuv420p needs even output geometry, got %dx%d — "
            "falling back to rgb24", out_w, out_h,
        )
        yuv420 = False
    processed = 0
    timer = StageTimer()

    first_todo = 1
    while first_todo <= len(batches) and os.path.exists(
        os.path.join(workdir, backend.fragment_name(first_todo))
    ):
        first_todo += 1
    if first_todo > len(batches):
        log.info("all %d fragments exist, nothing to upscale", len(batches))
        return 0
    start_frame = batches[first_todo][0]
    if start_frame > 1:
        log.info("resume: %d fragments done, seeking to frame %d",
                 first_todo - 1, start_frame)

    # the tail kernel writes the shuffle-planar layout directly; the sink
    # thread interleaves on the host
    planar = engine.planar_scale
    existing = backend.fragment_yuv420(workdir, 1)
    if existing is not None and existing != yuv420:
        log.warning(
            "resume: existing fragments use the %s contract — continuing "
            "with that instead of the requested --pipe_pix",
            "yuv420" if existing else "rgb24",
        )
        yuv420 = existing
    inner_src = backend.open_source(
        input_file, info, crop, start_frame=start_frame,
        raw_i420=(yuv420 and src_h % 2 == 0 and src_w % 2 == 0
                  and engine.input_rank_flexible),
    )
    i420_in = ((src_h, src_w, inner_src.i420_full_range)
               if getattr(inner_src, "raw_i420", False) else None)

    try:
        if yuv420:
            from upscale_video_tpu_torch.ops.yuv import packed_to_i420

            use_planar = bool(planar) and planar % 2 == 0
            step_fn = engine.yuv_step(backend.yuv_full_range,
                                      planar=use_planar, i420_in=i420_in)
            pack_s = planar if use_planar else 2
            _ybuf = []
            total = out_h * out_w * 3 // 2

            def transform(p):  # noqa: E306
                if not _ybuf:
                    _ybuf[:] = [np.empty((total,), np.uint8)]
                return packed_to_i420(p, pack_s, out=_ybuf[0])

            log.info(
                "yuv420 output contract active (%s range%s%s)",
                "full" if backend.yuv_full_range else "limited",
                f", planar s={planar}" if use_planar else "",
                ", i420 input" if i420_in else "",
            )
        elif planar:
            from upscale_video_tpu_torch.ops.pixel import planar_to_frames

            step_fn = engine.planar_step
            _ibuf = []

            def transform(p):  # noqa: E306
                if not _ibuf or _ibuf[0].shape[0] != p.shape[0] * planar:
                    _ibuf[:] = [np.empty(
                        (p.shape[0] * planar, p.shape[1] * planar, 3),
                        np.uint8
                    )]
                return planar_to_frames(p, planar, out=_ibuf[0])

            log.info("planar output contract active (s=%d)", planar)
        else:
            step_fn = engine.step
            transform = None
    except BaseException:
        inner_src.close()
        raise

    source = PrefetchSource(inner_src, depth=2 * frames_per_step)
    try:
        for batch, (start, end) in batches.items():
            if batch < first_todo:
                continue
            frag = os.path.join(workdir, backend.fragment_name(batch))
            if os.path.exists(frag):
                for _ in range(start, end + 1):
                    if source.read() is None:
                        break
                log.info("batch %d exists, skipped", batch)
                continue
            sink = AsyncSink(
                open_fragment(backend, batch, out_w, out_h, info, workdir,
                              yuv420=yuv420),
                depth=2 * frames_per_step,
                transform=transform,
            )
            stepper = BatchedStepper(step_fn, frames_per_step, engine.device)
            wrote = 0
            ended_early = False
            try:
                try:
                    for f in range(start, end + 1):
                        with timer.stage("decode", 1):
                            frame = source.read()
                        if frame is None:
                            log.warning("stream ended early at frame %d", f)
                            ended_early = True
                            break
                        with timer.stage("infer"):
                            outs = stepper.feed(frame)
                        with timer.stage("encode", len(outs)):
                            for out in outs:
                                sink.write(out)
                                wrote += 1
                    with timer.stage("infer"):
                        outs = stepper.flush()
                    with timer.stage("encode", len(outs)):
                        for out in outs:
                            sink.write(out)
                            wrote += 1
                finally:
                    sink.close()
            except Exception:
                discard_fragment(backend, batch, workdir)
                raise
            if ended_early:
                discard_fragment(backend, batch, workdir)
                processed += wrote
                raise RuntimeError(
                    f"decoded stream ended at frame {start + wrote - 1} but "
                    f"the probe reported {batches[len(batches)][1]} frames; "
                    f"batch {batch}'s fragment was discarded — re-probe or "
                    "fix the source, then resume"
                )
            commit_fragment(backend, batch, workdir)
            processed += wrote
            log.info("batch %d: %d frames upscaled+encoded", batch, wrote)
    finally:
        source.close()
    timer.log_summary()
    return processed


def _run_png_plane(
    engine, backend, input_file, info, crop, workdir, batches,
    frames_per_step, ffmpeg,
) -> int:
    """Reference-layout plane: extract PNGs, stage passes with tagged
    artifacts, fragment encode from final PNGs (upscale_processing.py
    :866-959 semantics, device-batched instead of process pools).

    Resume: extraction is skipped when the last frame has an artifact at
    any stage or the last fragment exists; each stage pass skips frames
    whose input was consumed, each batch whose fragment exists."""
    frames_count = info["number_of_frames"]
    all_frames = range(1, frames_count + 1)

    last_frag = os.path.join(workdir, backend.fragment_name(len(batches)))
    need_extract = not (stages.extraction_done(workdir, frames_count)
                        or os.path.exists(last_frag))
    if need_extract:
        _extract_all(backend, input_file, info, crop, workdir, ffmpeg)

    in_tag = stages.run_chain_stages(engine, workdir, all_frames,
                                     frames_per_step)

    processed = 0
    for batch, (start, end) in batches.items():
        frag = os.path.join(workdir, backend.fragment_name(batch))
        if os.path.exists(frag):
            continue
        if engine.scale == 1:
            stages.rename_stage_to_final(workdir, range(start, end + 1), in_tag)
        else:
            stages.run_stage_pass(
                workdir, range(start, end + 1), in_tag, "",
                engine.stage_fn("sr"), engine.device, frames_per_step,
                progress_label=f"Upscaling batch {batch}:",
            )
        src_h, src_w = backend.source_geometry(info, crop)
        sink = open_fragment(
            backend, batch, src_w * engine.scale, src_h * engine.scale, info,
            workdir,
        )
        try:
            try:
                stages.pngs_to_sink(workdir, start, end, sink)
            finally:
                sink.close()
        except Exception:
            discard_fragment(backend, batch, workdir)
            raise
        commit_fragment(backend, batch, workdir)
        for f in range(start, end + 1):
            os.remove(os.path.join(workdir, f"{f}.png"))
        processed += end - start + 1
        log.info("batch %d merged (%d frames total)", batch, end)
    return processed
