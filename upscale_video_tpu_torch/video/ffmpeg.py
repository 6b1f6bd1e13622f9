"""ffmpeg/ffprobe integration: metadata probe, crop detection, encode/concat.

The reference drives ffmpeg exclusively through subprocess argv lists
(upscale/upscale_processing.py:88-109 probe, :148-164 cropdetect, :214-245
extract, :615-650 fragment encode, :696-713 concat).  This module rebuilds
that surface with the latent defects fixed (SURVEY.md §5):

- frame-rate fractions parsed with ``fractions.Fraction``, not ``eval()``
  (reference defect at upscale_processing.py:121);
- ffprobe located next to ffmpeg via path handling, not string slicing
  (defect at :89);
- encode treats the process **exit code** as truth instead of "any stderr
  bytes" (defect at :652);
- every command is built by a pure function returning argv (golden-testable
  with a stubbed runner, per SURVEY.md §4).

Caching keeps the reference's on-disk conventions so resumes interoperate:
``metadata.json`` (upscale_processing.py:82-84,127-128) and
``crop_detect.txt`` (:140-142,178-179) in the working temp dir.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
from collections import Counter
from fractions import Fraction
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

Runner = Callable[[List[str]], subprocess.CompletedProcess]


def run_logged(cmds: List[str]) -> subprocess.CompletedProcess:
    """Default runner: log argv (reference logs every invocation,
    upscale_processing.py:107,163,244,649,712) and capture output."""
    log.info("%s", cmds)
    return subprocess.run(cmds, capture_output=True, text=True)


def ffprobe_path(ffmpeg: str) -> str:
    """Sibling ffprobe binary (reference sliced the string: ``ffmpeg[:-6]``)."""
    d, base = os.path.split(ffmpeg)
    probe = base.replace("ffmpeg", "ffprobe") if "ffmpeg" in base else "ffprobe"
    return os.path.join(d, probe) if d else probe


# ---------------------------------------------------------------------------
# Commands (pure builders)
# ---------------------------------------------------------------------------

def probe_cmd(ffmpeg: str, input_file: str) -> List[str]:
    return [
        ffprobe_path(ffmpeg), "-hide_banner", "-v", "quiet",
        "-show_format", "-select_streams", "v:0", "-count_packets",
        "-show_entries", "stream=nb_read_packets,r_frame_rate,width,height,pix_fmt",
        "-print_format", "json", "-loglevel", "error", "-i", input_file,
    ]


def cropdetect_cmd(ffmpeg: str, input_file: str, seek_seconds: float) -> List[str]:
    return [
        ffmpeg, "-hide_banner", "-ss", str(seek_seconds), "-i", input_file,
        "-frames:v", "2", "-vf", "cropdetect", "-f", "null", "-",
    ]


def extract_cmd(
    ffmpeg: str, input_file: str, crop_filter: str = "",
    pattern: str = "%d.extract.png", max_frames: Optional[int] = None,
) -> List[str]:
    """PNG-spill extraction (compat/repair mode; reference
    upscale_processing.py:214-232 and fix_frames.py:155-181)."""
    cmds = [ffmpeg, "-hide_banner", "-hwaccel", "auto", "-i", input_file,
            "-loglevel", "error", "-pix_fmt", "rgb24"]
    if max_frames is not None:
        cmds += ["-vframes", str(max_frames)]
    if crop_filter:
        cmds += ["-vf", crop_filter]
    cmds.append(pattern)
    return cmds


def merge_frames_cmd(
    ffmpeg: str, encoder: str, frame_batch: int, start_frame: int,
    end_frame: int, frame_rate, pix_fmt: str, output_format: str,
    global_quality: Optional[int] = 20,
) -> List[str]:
    """PNG-sequence fragment encode (compat mode; reference
    upscale_processing.py:615-639)."""
    cmds = [ffmpeg, "-hide_banner", "-hwaccel", "auto",
            "-r", str(frame_rate), "-f", "image2",
            "-start_number", str(start_frame), "-i", "%d.png",
            "-vcodec", encoder, "-frames:v", str(1 + end_frame - start_frame),
            "-pix_fmt", pix_fmt]
    if global_quality is not None:
        cmds += ["-global_quality", str(global_quality)]
    cmds += ["-loglevel", "error", f"{frame_batch}.{output_format}"]
    return cmds


def concat_cmd(ffmpeg: str, list_file: str, output_file: str) -> List[str]:
    """Concat-demuxer stream copy (reference upscale_processing.py:696-710)."""
    return [ffmpeg, "-hide_banner", "-f", "concat", "-safe", "0",
            "-i", list_file, "-loglevel", "error", "-c", "copy", output_file]


def mux_audio_cmd(ffmpeg: str, video_file: str, source_file: str,
                  output_file: str) -> List[str]:
    """Mux the ORIGINAL container's audio/subtitle streams into the
    upscaled video (stream-copy, no re-encode).

    Beyond-reference: the reference's fragment pipeline drops every
    non-video stream — its concat output (upscale_processing.py:689-730)
    carries video only, so users lose the soundtrack.
    """
    return [ffmpeg, "-hide_banner", "-loglevel", "error", "-y",
            "-i", video_file, "-i", source_file,
            "-map", "0:v:0", "-map", "1:a?", "-map", "1:s?",
            "-c", "copy", output_file]


# ---------------------------------------------------------------------------
# Probe + caches
# ---------------------------------------------------------------------------

def _derive_metadata_fields(info: Dict) -> None:
    """Fill the derived keys from raw ffprobe fields (idempotent; the
    number_of_frames/duration/frame_rate trio is kept if already present —
    a reference cache's values are authoritative for resume)."""
    stream = info["streams"][0]
    rate = Fraction(stream["r_frame_rate"])  # no eval()
    info.setdefault("number_of_frames", int(stream["nb_read_packets"]))
    info.setdefault("duration", float(info["format"]["duration"]))
    info["frame_rate"] = float(rate)
    info["frame_rate_fraction"] = f"{rate.numerator}/{rate.denominator}"
    info["width"] = int(stream.get("width", 0))
    info["height"] = int(stream.get("height", 0))
    # the 4:2:0 input contract gates on this (absent in caches written by
    # older versions / the reference: treated as unknown -> rgb24 decode)
    info["pix_fmt"] = stream.get("pix_fmt", "")


def get_metadata(
    ffmpeg: str, input_file: Optional[str], cache_dir: str = ".",
    runner: Runner = run_logged,
) -> Dict:
    """Probe stream metadata, cached in ``metadata.json``.

    ``input_file=None`` reads the cache only (merge_only's split-machine
    mode, reference merge_only.py:58).  Adds ``width``/``height`` to the
    cached fields (the reference derived geometry implicitly from PNGs).
    """
    cache = os.path.join(cache_dir, "metadata.json")
    if os.path.exists(cache):
        with open(cache) as f:
            info = json.load(f)
        # a reference-written metadata.json (upscale_processing.py:123-128)
        # lacks this pipeline's derived keys (width/height/
        # frame_rate_fraction) — backfill from the raw ffprobe fields it
        # DOES carry so resume on a reference temp dir works (the
        # reference-interop invariant).  The reference's probe never requests
        # width/height, so when geometry is missing AND we have the input,
        # re-probe (keeping the cached frame count authoritative).
        if "frame_rate_fraction" not in info or not info.get("width"):
            if input_file is not None and not info.get("width"):
                frames_count = info.get("number_of_frames")
                result = runner(probe_cmd(ffmpeg, input_file))
                if result.returncode != 0:
                    # fail HERE, not obscurely downstream where a persisted
                    # width=0 would turn into out_w/out_h = 0
                    raise RuntimeError(
                        f"geometry re-probe of {input_file!r} failed "
                        f"(reference metadata cache lacks width/height): "
                        f"{result.stderr}"
                    )
                fresh = json.loads(result.stdout)
                fresh.update(
                    {k: v for k, v in info.items()
                     if k not in ("streams", "format")}
                )
                info = fresh
                if frames_count is not None:
                    info["number_of_frames"] = frames_count
            _derive_metadata_fields(info)
            # never persist unknown geometry: a cached width=0 would mask
            # the miss and skip the re-probe on the next call
            persist = dict(info)
            if not persist.get("width"):
                persist.pop("width", None)
                persist.pop("height", None)
            with open(cache, "w") as f:
                json.dump(persist, f)
        log.info("metadata cache hit: %d frames", info["number_of_frames"])
        return info
    if input_file is None:
        raise FileNotFoundError(
            f"no metadata.json in {os.path.dirname(cache) or '.'!r} and no "
            "input file — for merge-only, -t must be the PARENT of the "
            "'upscale_video' dir holding the upscale box's zips and "
            "metadata.json"
        )

    result = runner(probe_cmd(ffmpeg, input_file))
    if result.returncode != 0:
        raise RuntimeError(f"ffprobe failed: {result.stderr}")
    info = json.loads(result.stdout)
    _derive_metadata_fields(info)
    with open(cache, "w") as f:
        json.dump(info, f)
    log.info(
        "frames=%d duration=%s rate=%s", info["number_of_frames"],
        info["duration"], info["frame_rate"],
    )
    return info


def get_crop_detect(
    ffmpeg: str, input_file: str, duration: float, cache_dir: str = ".",
    samples: Optional[int] = None, runner: Runner = run_logged,
) -> str:
    """Majority-vote crop filter over sampled timestamps, cached in
    ``crop_detect.txt`` (reference upscale_processing.py:137-181: 100
    samples at ``(i+1) * duration/120`` for i in 10..110).  Sample count
    is tunable via ``UPSCALE_TPU_CROP_SAMPLES`` (the reference's fixed 100
    probe runs are overkill for short clips)."""
    if samples is None:
        samples = int(os.environ.get("UPSCALE_TPU_CROP_SAMPLES", "100"))
    cache = os.path.join(cache_dir, "crop_detect.txt")
    if os.path.exists(cache):
        with open(cache) as f:
            return f.read()
    # spread samples across the whole runtime for ANY sample count: the
    # probed timestamps are (i+1)*interval for i in 10..10+samples, so the
    # divisor must scale with samples (the reference's fixed /120 assumed
    # its fixed 100 samples, upscale_processing.py:144-147; keeping /120
    # with a smaller count would cluster every probe in the opening
    # minutes and let credits/intros dominate the crop vote)
    span = samples + 20
    interval = int(duration / span) if duration >= span else duration / span
    votes: Counter = Counter()
    for i in range(10, 10 + samples):
        result = runner(cropdetect_cmd(ffmpeg, input_file, (i + 1) * interval))
        for line in (result.stderr or "").splitlines():
            if "crop=" in line:
                token = [t for t in line.split() if t.startswith("crop=")]
                if token:
                    votes[token[0].rstrip()] += 1
    crop = votes.most_common(1)[0][0] if votes else ""
    with open(cache, "w") as f:
        f.write(crop)
    return crop


def parse_crop_filter(crop: str) -> Optional[Dict[str, int]]:
    """``crop=W:H:X:Y`` -> dict (the streaming path needs the cropped
    geometry up front to build static-shape device programs)."""
    if not crop.startswith("crop="):
        return None
    parts = crop[len("crop="):].split(":")
    if len(parts) != 4:
        return None
    w, h, x, y = (int(p) for p in parts)
    return {"width": w, "height": h, "x": x, "y": y}


def encode_fragment_pngs(
    ffmpeg: str, encoder: str, frame_batch: int, start_frame: int,
    end_frame: int, frame_rate, pix_fmt: str, output_format: str,
    global_quality: Optional[int] = 20, runner: Runner = run_logged,
) -> List[int]:
    """Encode `{start..end}.png` into `{batch}.{ext}`.

    On failure: delete the partial fragment, scan the PNGs for corruption
    and return the bad frame list (reference upscale_processing.py:650-672
    — but failure is signalled by exit code, not stderr bytes).
    Returns [] on success; raises RuntimeError with the bad-frame list
    embedded when frames are corrupt.
    """
    out_name = f"{frame_batch}.{output_format}"
    result = runner(merge_frames_cmd(
        ffmpeg, encoder, frame_batch, start_frame, end_frame, frame_rate,
        pix_fmt, output_format, global_quality,
    ))
    if result.returncode != 0 or not os.path.exists(out_name):
        if os.path.exists(out_name):
            os.remove(out_name)
        bad = scan_corrupt_pngs(start_frame, end_frame)
        raise RuntimeError(
            "fragment encode failed"
            + (f"; corrupt frames: {','.join(map(str, bad))} "
               f"(run fix-frames with -b {','.join(map(str, bad))})" if bad else "")
            + f"; stderr: {(result.stderr or '')[-400:]}"
        )
    for frame in range(start_frame, end_frame + 1):
        os.remove(f"{frame}.png")
    log.info("batch merged into %s (%d frames)", out_name,
             end_frame - start_frame + 1)
    return []


def scan_corrupt_pngs(start_frame: int, end_frame: int) -> List[int]:
    """CRC-verify scan (``video/png.py``) used by the repair path
    (reference upscale_processing.py:658-667)."""
    from upscale_video_tpu_torch.video.png import verify_png

    return [frame for frame in range(start_frame, end_frame + 1)
            if not verify_png(f"{frame}.png")]


def concat_fragments(
    ffmpeg: str, num_batches: int, output_file: str,
    runner: Runner = run_logged, fragment_ext: Optional[str] = None,
) -> None:
    """Write merge_list.txt and concat fragments (reference
    upscale_processing.py:689-730); deletes fragments on success.

    ``fragment_ext``: the extension the fragments were encoded under
    (backend.output_format); defaults to the output file's extension."""
    output_format = fragment_ext or output_file.split(".")[-1]
    with open("merge_list.txt", "w") as f:
        for i in range(num_batches):
            f.write(f"file {i + 1}.{output_format}\n")
    result = runner(concat_cmd(ffmpeg, "merge_list.txt", output_file))
    if result.returncode != 0 or not os.path.exists(output_file):
        if os.path.exists(output_file):
            os.remove(output_file)
        raise RuntimeError(f"concat failed: {(result.stderr or '')[-400:]}")
    for i in range(num_batches):
        os.remove(f"{i + 1}.{output_format}")
