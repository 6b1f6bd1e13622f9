"""Video backends: how the pipeline decodes sources and encodes fragments.

Two interchangeable data planes:

- :class:`FfmpegBackend` — production: ffprobe metadata + cropdetect, ONE
  sequential rawvideo decode pipe feeding the device (replacing the
  reference's extract-everything-to-PNG stage at
  upscale/upscale_processing.py:203-255), and one encoder pipe per
  fragment (replacing :604-686), concat via the concat demuxer (:689-730).
- :class:`HermeticBackend` — pure-Python Y4M / PNG-directory I/O with the
  same fragment/concat/resume semantics; used when no ffmpeg binary is
  available (and by the test suite).

Both keep the reference's durable layout in the working dir: fragments are
``{batch}.{ext}`` with skip-if-exists resume (:925-926), metadata cached in
``metadata.json``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from abc import ABC, abstractmethod
from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np

from upscale_video_tpu_torch.video import ffmpeg as ff
from upscale_video_tpu_torch.video.io import (
    FfmpegPipeSink,
    FfmpegPipeSource,
    FrameSink,
    FrameSource,
    PngDirSource,
    Y4MSink,
    Y4MSource,
)

log = logging.getLogger(__name__)


class VideoBackend(ABC):
    @abstractmethod
    def probe(self, input_file: str, workdir: str) -> Dict:
        """Metadata dict with number_of_frames/duration/frame_rate/
        width/height, cached in workdir/metadata.json."""

    @abstractmethod
    def crop_detect(self, input_file: str, duration: float, workdir: str) -> str:
        ...

    @abstractmethod
    def open_source(
        self, input_file: str, info: Dict, crop: str, start_frame: int = 1,
        raw_i420: bool = False,
    ) -> FrameSource:
        """Sequential source over the video (after cropping), beginning at
        1-indexed ``start_frame`` — cheaply (time-based seek / file skip),
        so resume cost is independent of the completed-prefix length
        (reference skip-if-exists resume, upscale_processing.py:923-926).

        ``raw_i420=True`` REQUESTS the 4:2:0 input contract: when the
        underlying stream supports it, read() returns flat I420 buffers
        and the source carries ``raw_i420=True`` + ``i420_full_range``
        (the caller must check — unsupported streams fall back to RGB
        frames silently)."""

    @abstractmethod
    def open_fragment_sink(
        self, batch: int, width: int, height: int, info: Dict, workdir: str,
        yuv420: bool = False,
    ) -> FrameSink:
        """``yuv420=True`` opens the sink in the device-side 4:2:0 contract
        (ops/yuv.py): write() then takes pre-assembled flat I420 bytes at
        the backend's range (:attr:`yuv_full_range`)."""

    #: the I420 level range this backend's 4:2:0 sink expects: the hermetic
    #: y4m sink writes C420jpeg (full range), the ffmpeg rawvideo feed is
    #: interpreted as studio/limited range by default
    yuv_full_range = False

    def auto_yuv420(self, info: Dict) -> bool:
        """Whether the device-side 4:2:0 contract loses NOTHING versus
        rgb24 for this backend's encode target (the ``--pipe_pix auto``
        policy's backend gate).  True only when the final encode is
        4:2:0 8-bit anyway, so converting on-device merely moves the
        chroma subsample the encoder would perform off the host."""
        return False

    def fragment_yuv420(self, workdir: str, batch: int) -> Optional[bool]:
        """Whether an EXISTING fragment was written under the 4:2:0
        contract, or None when unknowable/irrelevant (ffmpeg fragments are
        encoder output either way, so concat doesn't care).  Lets a resume
        adopt the contract the completed fragments already use instead of
        failing at concat hours later."""
        return None

    @abstractmethod
    def fragment_name(self, batch: int) -> str:
        ...

    @abstractmethod
    def concat(self, num_batches: int, output_file: str, workdir: str) -> None:
        ...

    def source_geometry(self, info: Dict, crop: str) -> Tuple[int, int]:
        """(height, width) the model will see (crop applied)."""
        c = ff.parse_crop_filter(crop) if crop else None
        if c:
            return c["height"], c["width"]
        return info["height"], info["width"]


class FfmpegBackend(VideoBackend):
    def __init__(self, ffmpeg: str, encoder: str = "libx264",
                 pix_fmt: str = "yuv420p", output_format: str = "mkv",
                 global_quality: Optional[int] = 20):
        self.ffmpeg = ffmpeg
        self.encoder = encoder
        self.pix_fmt = pix_fmt
        self.output_format = output_format
        self.global_quality = global_quality

    def probe(self, input_file, workdir):
        return ff.get_metadata(self.ffmpeg, input_file, cache_dir=workdir)

    def auto_yuv420(self, info):
        # the encode target decides: feeding I420 to a 4:2:0 8-bit encode
        # skips the encoder-side swscale with zero information loss; a
        # 10-bit/4:4:4/4:2:2 target (p010le, yuv444p, ...) gets more out
        # of rgb24 input, so auto keeps it
        return self.pix_fmt in ("yuv420p", "yuvj420p", "nv12")

    def crop_detect(self, input_file, duration, workdir):
        return ff.get_crop_detect(self.ffmpeg, input_file, duration, cache_dir=workdir)

    def open_source(self, input_file, info, crop, start_frame=1,
                    raw_i420=False):
        h, w = self.source_geometry(info, crop)
        remaining = info["number_of_frames"] - (start_frame - 1)
        return FfmpegPipeSource(
            self.ffmpeg, input_file, width=w, height=h,
            frame_rate=Fraction(info["frame_rate_fraction"]),
            crop_filter=crop, num_frames=remaining, start_frame=start_frame,
            # gate on the PROBED source format: decoding a 4:4:4/4:2:2/
            # 10-bit source via the i420 contract would downsample chroma
            # or depth the SR model could otherwise use (unknown pix_fmt —
            # an older cache — safely keeps rgb24)
            output_pix_fmt=("yuv420p" if raw_i420 and not (h % 2 or w % 2)
                            and info.get("pix_fmt") in ("yuv420p",
                                                        "yuvj420p")
                            else "rgb24"),
        )

    def fragment_name(self, batch):
        return f"{batch}.{self.output_format}"

    def open_fragment_sink(self, batch, width, height, info, workdir,
                           yuv420=False):
        return FfmpegPipeSink(
            self.ffmpeg, os.path.join(workdir, self.fragment_name(batch)),
            width=width, height=height,
            frame_rate=Fraction(info["frame_rate_fraction"]),
            encoder=self.encoder, pix_fmt=self.pix_fmt,
            global_quality=self.global_quality,
            input_pix_fmt="yuv420p" if yuv420 else "rgb24",
        )

    def concat(self, num_batches, output_file, workdir):
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            ff.concat_fragments(self.ffmpeg, num_batches, output_file,
                                fragment_ext=self.output_format)
        finally:
            os.chdir(cwd)


class HermeticBackend(VideoBackend):
    """Y4M-in / Y4M-out (or PNG-dir in) with no external binaries."""

    output_format = "y4m"

    def probe(self, input_file, workdir):
        cache = os.path.join(workdir, "metadata.json")
        if os.path.exists(cache):
            with open(cache) as f:
                return json.load(f)
        if input_file is None:
            raise FileNotFoundError(
                f"no metadata.json in {workdir!r} and no input file — for "
                "merge-only, -t must be the PARENT of the 'upscale_video' "
                "dir holding the upscale box's zips and metadata.json"
            )
        pix_fmt = "rgb24"  # PNG-dir sources are RGB files
        if os.path.isdir(input_file):
            src = PngDirSource(input_file, tag="")
            # count only untagged frame files ({n}.png): stage artifacts
            # ({n}.extract.png) or stray PNGs in the directory are not
            # frames PngDirSource will read and must not inflate the count
            n = sum(
                1 for p in glob.glob(os.path.join(input_file, "*.png"))
                if os.path.basename(p).count(".") == 1
                and os.path.basename(p).split(".")[0].isdigit()
            )
            rate = src.frame_rate
            w, h = src.width, src.height
            src.close()
        elif input_file.endswith(".y4m"):
            with Y4MSource(input_file) as src:
                rate, w, h = src.frame_rate, src.width, src.height
                # record the source's chroma class in ffprobe vocabulary
                # so the --pipe_pix auto gate reads one field either way
                pix_fmt = {"C420jpeg": "yuvj420p"}.get(
                    src.colorspace,
                    "yuv420p" if src.colorspace.startswith("C420")
                    else "yuv444p" if src.colorspace.startswith("C444")
                    else "yuv422p",
                )
                # count via header-line reads + seeks — read() would
                # colour-convert every frame of the whole movie just to
                # learn the count
                n = 0
                while src.skip(1):
                    n += 1
        else:
            raise ValueError(
                f"hermetic backend reads .y4m or PNG dirs, got {input_file!r}; "
                f"pass --ffmpeg for compressed containers"
            )
        info = {
            "number_of_frames": n,
            "duration": float(n / rate),
            "frame_rate": float(rate),
            "frame_rate_fraction": f"{rate.numerator}/{rate.denominator}",
            "width": w,
            "height": h,
            "pix_fmt": pix_fmt,
            "format": {"filename": str(input_file)},
        }
        with open(cache, "w") as f:
            json.dump(info, f)
        return info

    def crop_detect(self, input_file, duration, workdir):
        return ""  # no detector without ffmpeg; geometry passes through

    def open_source(self, input_file, info, crop, start_frame=1,
                    raw_i420=False):
        if os.path.isdir(input_file):
            return PngDirSource(
                input_file, tag="", start=start_frame,
                frame_rate=Fraction(info["frame_rate_fraction"]),
            )
        src = Y4MSource(input_file)
        if raw_i420 and src.colorspace.startswith("C420"):
            src.raw_i420 = True  # C420-class stream: serve flat I420
        if start_frame > 1:
            src.skip(start_frame - 1)  # file seeks, no decode
        return src

    def fragment_name(self, batch):
        return f"{batch}.{self.output_format}"

    yuv_full_range = True  # C420jpeg

    def auto_yuv420(self, info):
        # the hermetic sink's 4:2:0 mode writes C420jpeg where rgb24
        # writes C444: only pick it when the SOURCE is already 4:2:0 —
        # C444/PNG sources would be genuinely chroma-downsampled (an
        # older cached metadata.json carries no pix_fmt -> keep rgb24)
        return str(info.get("pix_fmt", "")) in ("yuv420p", "yuvj420p")

    def fragment_yuv420(self, workdir, batch):
        path = os.path.join(workdir, self.fragment_name(batch))
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            header = f.readline()
        return b" C420" in header

    def open_fragment_sink(self, batch, width, height, info, workdir,
                           yuv420=False):
        return Y4MSink(
            os.path.join(workdir, self.fragment_name(batch)),
            width, height, Fraction(info["frame_rate_fraction"]),
            colorspace="C420jpeg" if yuv420 else "C444",
        )

    def concat(self, num_batches, output_file, workdir):
        """Frame-accurate concat of y4m fragments into one stream.

        Byte-level passthrough: fragment headers are identical by
        construction (same geometry/rate/colorspace), so the output is
        fragment 1 verbatim plus every later fragment minus its header
        line — lossless for any colorspace and no per-frame colour math
        (the previous decode->re-encode concat cost a full re-read of the
        movie and would have double-converted C420 fragments)."""
        if num_batches == 1:
            # single fragment IS the output (saves a full re-read/re-write
            # of the movie; y4m headers are identical by construction)
            import shutil

            shutil.move(os.path.join(workdir, self.fragment_name(1)), output_file)
            return
        first_header = None
        with open(output_file, "wb") as out:
            for b in range(1, num_batches + 1):
                with open(os.path.join(workdir, self.fragment_name(b)), "rb") as f:
                    header = f.readline()
                    if not header.startswith(b"YUV4MPEG2"):
                        raise ValueError(
                            f"fragment {b} is not a y4m stream"
                        )
                    if first_header is None:
                        first_header = header
                        out.write(header)
                    elif header != first_header:
                        raise ValueError(
                            f"fragment {b} header {header!r} != fragment 1 "
                            f"{first_header!r} — cannot concat"
                        )
                    import shutil

                    shutil.copyfileobj(f, out, 1 << 20)
        for b in range(1, num_batches + 1):
            os.remove(os.path.join(workdir, self.fragment_name(b)))


def make_backend(
    ffmpeg: Optional[str], encoder: str = "libx264", pix_fmt: str = "yuv420p",
    output_format: str = "mkv", global_quality: Optional[int] = 20,
) -> VideoBackend:
    if ffmpeg:
        return FfmpegBackend(ffmpeg, encoder, pix_fmt, output_format, global_quality)
    return HermeticBackend()
