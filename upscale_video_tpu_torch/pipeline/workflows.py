"""Companion workflows: split-machine stages, frame repair, sampling.

Port of ``upscale_video_tpu/pipeline/workflows.py`` over the port's engine
and PNG plane, with the same on-disk contracts (zip hand-off, sentinels,
stage tags), so a JAX box and a port box can each take one half of a job:

- :func:`upscale_only`  — upscale box half of split-machine operation
  (reference upscale/upscale_only.py): upscale batches, zip PNGs to
  ``{batch}.zip`` (optionally into a shared ``upscale_dir``), copy
  metadata/crop caches alongside, ``upscaled.txt`` sentinel.
- :func:`merge_only`    — encode box half (reference upscale/merge_only.py):
  unzip, contiguity-check, encode fragments, concat, ``merged.txt``.  It
  runs no model.
- :func:`fix_frames`    — corrupted-frame repair (reference
  upscale/fix_frames.py): re-extract only what is missing, re-run the
  chain on just the bad frames.
- :func:`process_image` — parameter sampling (reference test_images.py):
  run candidate chains on chosen extracted frames with artifacts kept.

The model-running workflows take ``device`` (``cuda`` unless the caller
asks for the CPU) and ``conv_impl`` as the JAX ones do (the JAX
``parallel_mode`` has no counterpart: one GPU); every PNG goes through the
port's codec (:mod:`upscale_video_tpu_torch.video.png`), and a fragment is
written beside its name and moved there once whole
(:func:`~upscale_video_tpu_torch.pipeline.process.open_fragment`).
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
import zipfile
from typing import List, Optional

from upscale_video_tpu_torch.device import resolve_device
from upscale_video_tpu_torch.pipeline import stages
from upscale_video_tpu_torch.pipeline.chain import (
    ChainEngine, ChainSpec, default_frames_per_step, precision_dtypes,
)
from upscale_video_tpu_torch.pipeline.process import (
    VALID_SCALES,
    _extract_all,
    commit_fragment,
    discard_fragment,
    open_fragment,
    prepare_workdir,
)
from upscale_video_tpu_torch.utils.logsetup import setup_logging
from upscale_video_tpu_torch.video.backend import make_backend
from upscale_video_tpu_torch.video.frames import (
    SENTINEL_MERGED,
    SENTINEL_UPSCALED,
    calc_batches,
    contiguous_range,
    frames_per_batch,
    has_sentinel,
    parse_frame_ranges,
    stage_progress,
    write_sentinel,
)
from upscale_video_tpu_torch.video.png import png_size, write_png

log = logging.getLogger(__name__)


def _build_engine(spec, scale, model_path, precision, tile_size, halo,
                  synthetic, device, conv_impl="auto", tta=False):
    dtype, residual_dtype = precision_dtypes(precision, spec)
    return ChainEngine.build(
        spec, scale, resolve_device(device), model_path=model_path,
        compute_dtype=dtype, synthetic=synthetic,
        residual_dtype=residual_dtype, tile=tile_size, halo=halo, tta=tta,
        conv_impl=conv_impl,
    )


def upscale_only(
    input_file: str,
    ffmpeg: Optional[str] = None,
    scale: int = 2,
    temp_dir: Optional[str] = None,
    batch_size: int = 10,
    chips: Optional[str] = None,
    upscale_dir: Optional[str] = None,
    extract_only: bool = False,
    models: Optional[str] = None,
    log_level: Optional[int] = None,
    log_dir: Optional[str] = None,
    model_path: Optional[str] = None,
    precision: str = "auto",
    tile_size: "int | tuple | None" = None,
    halo: int = 16,
    frames_per_step: Optional[int] = None,
    synthetic_models: bool = False,
    tta: bool = False,
    device: str = "cuda",
    conv_impl: str = "auto",
) -> Optional[int]:
    """Split-machine stage 1: upscale + zip, no video encode."""
    if scale not in VALID_SCALES:
        raise ValueError(f"scale must be one of {VALID_SCALES}")
    if not os.path.exists(input_file):
        raise FileNotFoundError(input_file)
    if upscale_dir and not os.path.isdir(upscale_dir):
        raise FileNotFoundError(upscale_dir)

    spec = ChainSpec.parse(models)
    scale = spec.effective_scale(scale)
    setup_logging(log_level, log_dir, input_file)

    workdir = prepare_workdir(temp_dir, resume=True)  # upscale_only never purges
    if has_sentinel(workdir, SENTINEL_UPSCALED):
        log.info("%s already processed (upscaled.txt)", input_file)
        return None

    backend = make_backend(ffmpeg)
    info = backend.probe(input_file, workdir)
    frames_count = info["number_of_frames"]
    crop = backend.crop_detect(input_file, info["duration"], workdir)
    per_batch = frames_per_batch(info["frame_rate"], frames_count, batch_size)
    batches = calc_batches(frames_count, per_batch)

    # re-extract only if the last frame has no artifact at ANY stage and no
    # batch zip exists (reference skip test, upscale_processing.py:237-242 —
    # a resume after denoise consumed the extract files must not re-extract)
    last_zip = os.path.join(upscale_dir or workdir, f"{max(batches)}.zip")
    need_extract = not (stages.extraction_done(workdir, frames_count)
                        or os.path.exists(last_zip))
    if need_extract:
        _extract_all(backend, input_file, info, crop, workdir, ffmpeg)
    if extract_only:
        log.info("extract only — frames extraction completed")
        return None

    engine = _build_engine(spec, scale, model_path, precision, tile_size, halo,
                           synthetic_models, device, conv_impl, tta=tta)
    if frames_per_step is None:
        frames_per_step = default_frames_per_step(spec)
    frames_per_step = engine.configure_chips(chips, frames_per_step)
    log.info("model chain: %s on %s", engine.describe(), engine.device)

    all_frames = range(1, frames_count + 1)
    in_tag = stages.run_chain_stages(engine, workdir, all_frames, frames_per_step)

    if upscale_dir:
        for cache in ("metadata.json", "crop_detect.txt"):
            src = os.path.join(workdir, cache)
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(upscale_dir, cache))

    processed = 0
    for batch, (start, end) in batches.items():
        zip_name = f"{batch}.zip"
        zip_path = os.path.join(upscale_dir or workdir, zip_name)
        if os.path.exists(zip_path):
            continue
        if engine.scale == 1:
            stages.rename_stage_to_final(workdir, range(start, end + 1), in_tag)
        else:
            stages.run_stage_pass(
                workdir, range(start, end + 1), in_tag, "",
                engine.stage_fn("sr"), engine.device, frames_per_step,
                progress_label=f"Upscaling batch {batch}:",
            )
        log.info("zipping png files into %s", zip_path)
        # store (no deflate work) like the reference's compresslevel=0; the
        # zip gets its name only once whole, since a resume skips any batch
        # whose zip exists
        with zipfile.ZipFile(zip_path + ".part", "w",
                             compression=zipfile.ZIP_STORED) as zf:
            for f in range(start, end + 1):
                zf.write(os.path.join(workdir, f"{f}.png"), f"{f}.png")
        os.replace(zip_path + ".part", zip_path)
        for f in range(start, end + 1):
            os.remove(os.path.join(workdir, f"{f}.png"))
        processed += end - start + 1

    write_sentinel(workdir, SENTINEL_UPSCALED, "Upscaled")
    log.info("upscale only finished for %s", input_file)
    return processed


def merge_only(
    output_dir: str,
    ffmpeg: Optional[str] = None,
    ffmpeg_encoder: str = "libx264",
    pix_fmt: str = "yuv420p",
    temp_dir: Optional[str] = None,
    log_level: Optional[int] = None,
    log_dir: Optional[str] = None,
    global_quality: Optional[int] = 20,
) -> Optional[str]:
    """Split-machine stage 2: unzip -> encode fragments -> concat."""
    setup_logging(log_level, log_dir, "merge_only")
    workdir = prepare_workdir(temp_dir, resume=True)

    backend = make_backend(ffmpeg, ffmpeg_encoder, pix_fmt,
                           output_format="mkv" if ffmpeg else "y4m",
                           global_quality=global_quality)
    info = backend.probe(None, workdir)  # cache-only read
    frames_count = info["number_of_frames"]

    src_name = os.path.basename(info["format"]["filename"])
    stem = src_name.rsplit(".", 1)[0] if "." in src_name else src_name
    ext = "mkv" if ffmpeg else "y4m"
    # abspath: FfmpegBackend.concat chdirs into the workdir
    output_file = os.path.abspath(
        os.path.join(output_dir, f"{stem}.upscaled.{ext}")
    )
    setup_logging(log_level, log_dir, output_file)

    if has_sentinel(workdir, SENTINEL_MERGED):
        log.info("%s already processed (merged.txt)", output_file)
        return None

    # fragment_frames.txt records "batch end_frame" per encoded fragment so
    # a rerun that finds every fragment already on disk (crash between the
    # last encode and concat) can see the job is complete instead of dying
    # on "no more png files found"
    state_path = os.path.join(workdir, "fragment_frames.txt")
    frag_end: dict = {}
    if os.path.exists(state_path):
        with open(state_path) as sf:
            for line in sf:
                parts = line.split()
                if len(parts) == 2 and all(p.isdigit() for p in parts):
                    frag_end[int(parts[0])] = int(parts[1])

    batch = 1
    while True:
        frag = os.path.join(workdir, backend.fragment_name(batch))
        if os.path.exists(frag):
            if frag_end.get(batch, 0) >= frames_count:
                break  # all frames already encoded; only concat remained
            batch += 1
            continue
        zip_path = os.path.join(workdir, f"{batch}.zip")
        if os.path.exists(zip_path):
            log.info("extracting png files from %s", zip_path)
            with zipfile.ZipFile(zip_path, "r") as zf:
                zf.extractall(workdir)
            os.remove(zip_path)

        png_numbers = [
            int(os.path.basename(p).split(".")[0])
            for p in glob.glob(os.path.join(workdir, "*.png"))
            if os.path.basename(p).split(".")[0].isdigit()
            and os.path.basename(p).count(".") == 1  # final frames only
        ]
        if not png_numbers:
            raise FileNotFoundError("no more png files found")
        start, end = contiguous_range(png_numbers)  # raises on gaps

        w, h = png_size(os.path.join(workdir, f"{start}.png"))
        sink = open_fragment(backend, batch, w, h, info, workdir)
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
        with open(state_path, "a") as sf:
            sf.write(f"{batch} {end}\n")
        log.info("batch %d merged (frames %d..%d)", batch, start, end)

        if end >= frames_count:
            break
        batch += 1

    backend.concat(batch, output_file, workdir)
    write_sentinel(workdir, SENTINEL_MERGED, "Merged")
    log.info("merge only finished for %s", output_file)
    return output_file


def fix_frames(
    input_file: str,
    bad_frames: str,
    ffmpeg: Optional[str] = None,
    scale: int = 2,
    temp_dir: Optional[str] = None,
    chips: Optional[str] = None,
    models: Optional[str] = None,
    log_level: Optional[int] = None,
    log_dir: Optional[str] = None,
    model_path: Optional[str] = None,
    precision: str = "auto",
    tile_size: "int | tuple | None" = None,
    halo: int = 16,
    frames_per_step: Optional[int] = None,
    synthetic_models: bool = False,
    tta: bool = False,
    device: str = "cuda",
    conv_impl: str = "auto",
) -> List[int]:
    """Repair listed frames: re-extract missing intermediates, re-run the
    chain on just those frames (reference upscale/fix_frames.py:25-277)."""
    if scale not in (1, 2, 4):
        raise ValueError("scale must be 1, 2 or 4")
    if not os.path.exists(input_file):
        raise FileNotFoundError(input_file)

    spec = ChainSpec.parse(models)
    scale = spec.effective_scale(scale)
    setup_logging(log_level, log_dir, input_file)

    workdir = prepare_workdir(temp_dir, resume=True)
    backend = make_backend(ffmpeg)
    info = backend.probe(input_file, workdir)
    crop = backend.crop_detect(input_file, info["duration"], workdir)

    frames = parse_frame_ranges(bad_frames)
    # per-stage artifact census: tells the operator what state the repair
    # starts from (which intermediates survive, how many finals exist)
    log.info("stage artifacts present: %s",
             stage_progress(workdir, info["number_of_frames"]))

    # a frame missing at EVERY stage must be re-extracted from the source
    # (reference fix_frames.py:127-152)
    tags = ["extract"]
    if spec.denoise:
        tags.append("denoise")
    if spec.anime:
        tags.append("anime")
    need_extract = [
        f for f in frames
        if all(
            not os.path.exists(os.path.join(workdir, f"{f}.{t}.png"))
            for t in tags
        )
    ]
    if need_extract:
        max_frame = max(need_extract)
        log.info("re-extracting frames 1..%d", max_frame)
        prune = info.get("prune")  # optional hand-edited filter (ref :173-179)
        _reextract(backend, input_file, info, crop, workdir, ffmpeg,
                   max_frame, prune)
        # drop re-extracted frames that were not requested (ref :198-203)
        for f in range(1, max_frame + 1):
            if f not in frames:
                p = os.path.join(workdir, f"{f}.extract.png")
                if os.path.exists(p):
                    os.remove(p)

    engine = _build_engine(spec, scale, model_path, precision, tile_size, halo,
                           synthetic_models, device, conv_impl, tta=tta)
    if frames_per_step is None:
        frames_per_step = default_frames_per_step(spec)
    frames_per_step = engine.configure_chips(chips, frames_per_step)

    for f in frames:  # clear stale final artifacts (ref :240-244)
        p = os.path.join(workdir, f"{f}.png")
        if os.path.exists(p):
            os.remove(p)

    in_tag = stages.run_chain_stages(engine, workdir, frames, frames_per_step)

    if scale == 1:
        stages.rename_stage_to_final(workdir, frames, in_tag)
    else:
        stages.run_stage_pass(
            workdir, frames, in_tag, "", engine.stage_fn("sr"), engine.device,
            frames_per_step, progress_label="Fixed",
        )
    log.info("fix frames finished (%d frames)", len(frames))
    return frames


def _reextract(backend, input_file, info, crop, workdir, ffmpeg, max_frame, prune):
    from upscale_video_tpu_torch.video import ffmpeg as ff
    from upscale_video_tpu_torch.video.backend import FfmpegBackend

    if isinstance(backend, FfmpegBackend):
        vf = ",".join(x for x in (crop, prune) if x)
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            cmd = ff.extract_cmd(
                ffmpeg,
                input_file if os.path.isabs(input_file) else os.path.join(cwd, input_file),
                vf, max_frames=max_frame,
            )
            result = ff.run_logged(cmd)
            if result.returncode != 0:
                raise RuntimeError(f"re-extraction failed: {result.stderr[-400:]}")
        finally:
            os.chdir(cwd)
        return
    with backend.open_source(input_file, info, crop) as src:
        for i in range(1, max_frame + 1):
            frame = src.read()
            if frame is None:
                break
            write_png(os.path.join(workdir, f"{i}.extract.png"), frame)


def process_image(
    input_frames: str,
    temp_dir: Optional[str],
    output_dir: str,
    scale: int = 2,
    models: Optional[str] = None,
    chips: Optional[str] = None,
    model_path: Optional[str] = None,
    precision: str = "auto",
    tile_size: "int | tuple | None" = None,
    halo: int = 16,
    frames_per_step: Optional[int] = None,
    synthetic_models: bool = False,
    tta: bool = False,
    device: str = "cuda",
    conv_impl: str = "auto",
) -> List[str]:
    """Sampling tool: run a candidate chain on selected extracted frames,
    keeping every intermediate, and name results ``{frame}.{models}.png``
    for side-by-side comparison (reference test_images.py:18-159)."""
    import tempfile

    setup_logging(None, None, None)
    if scale not in VALID_SCALES:
        raise ValueError(f"scale must be one of {VALID_SCALES}")
    spec = ChainSpec.parse(models)
    scale = spec.effective_scale(scale)

    workdir = os.path.abspath(
        os.path.join(temp_dir or tempfile.gettempdir(), "upscale_video")
    )
    frames = parse_frame_ranges(input_frames)
    # the reference crashes with FileNotFoundError when the output dir does
    # not exist yet (test_images.py:71-75 copies into it unconditionally) —
    # a latent defect deliberately not reproduced
    os.makedirs(output_dir, exist_ok=True)
    for f in frames:
        shutil.copyfile(
            os.path.join(workdir, f"{f}.extract.png"),
            os.path.join(output_dir, f"{f}.extract.png"),
        )

    engine = _build_engine(spec, scale, model_path, precision, tile_size, halo,
                           synthetic_models, device, conv_impl, tta=tta)
    if frames_per_step is None:
        frames_per_step = default_frames_per_step(spec)
    frames_per_step = engine.configure_chips(chips, frames_per_step)
    in_tag = stages.run_chain_stages(engine, output_dir, frames, frames_per_step,
                                     remove=False)

    outputs = []
    if scale > 1:
        stages.run_stage_pass(
            output_dir, frames, in_tag, "", engine.stage_fn("sr"),
            engine.device, frames_per_step, remove=False,
            progress_label="Sampled",
        )
    suffix = ".".join(models.split(",")) if models else f"{scale}x"
    for f in frames:
        src = os.path.join(
            output_dir, f"{f}.png" if scale > 1 else f"{f}.{in_tag}.png"
        )
        dst = os.path.join(output_dir, f"{f}.{suffix}.png")
        if os.path.exists(src):
            shutil.move(src, dst)
            outputs.append(dst)
    log.info("sampled %d frames -> %s", len(frames), output_dir)
    return outputs
