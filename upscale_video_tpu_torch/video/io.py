"""Frame sources and sinks: the framework's streaming data plane.

The reference's data plane is a PNG file per frame per stage on disk
(~300 GB for a 2-hour movie — upscale/upscale_processing.py:232-234).
Here the primary plane is **streaming**: a source yields uint8 RGB frames
into host ring buffers feeding the device, and a sink drains upscaled
frames; nothing is spilled unless a compatibility mode asks for it.

Implementations:

- :class:`FfmpegPipeSource` / :class:`FfmpegPipeSink` — production path:
  ffmpeg decodes/encodes via rawvideo rgb24 pipes (no PNG codec work at
  all, replacing upscale_processing.py:214-245 extract + :615-650 merge).
- :class:`Y4MSource` / :class:`Y4MSink` — hermetic uncompressed YUV4MPEG2,
  pure Python; used by tests and available to users without ffmpeg.
- :class:`PngDirSource` / :class:`PngDirSink` — the reference's
  ``{frame}.{tag}.png`` layout (``video/png.py``), kept for ``--extract_only`` sampling,
  repair, and split-machine compatibility.
"""

from __future__ import annotations

import os
import subprocess
from abc import ABC, abstractmethod
from fractions import Fraction
from typing import IO, Iterator, List, Optional

import numpy as np

from upscale_video_tpu_torch.video.png import png_size, read_png, write_png


def as_fraction(frame_rate) -> Fraction:
    """Coerce any reasonable frame-rate spelling — "24/1", Fraction,
    (num, den) tuple, int, float — to an exact Fraction.  ffprobe hands out
    strings, the hermetic probe hands out Fractions, and callers naturally
    write (24, 1); all must work (Fraction() itself rejects tuples)."""
    if isinstance(frame_rate, Fraction):
        return frame_rate
    if isinstance(frame_rate, (tuple, list)):
        num, den = frame_rate
        return Fraction(int(num), int(den))
    if isinstance(frame_rate, float):
        return Fraction(frame_rate).limit_denominator(1001)
    return Fraction(frame_rate)


class FrameSource(ABC):
    """Iterates uint8 RGB (H, W, 3) frames."""

    width: int
    height: int
    frame_rate: Fraction
    num_frames: Optional[int] = None  # None when unknown (pipes)

    @abstractmethod
    def read(self) -> Optional[np.ndarray]:
        """Next frame or None at end of stream."""

    def close(self) -> None:
        pass

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameSink(ABC):
    @abstractmethod
    def write(self, frame: np.ndarray) -> None:
        """Write one uint8 RGB (H, W, 3) frame."""

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2) — hermetic uncompressed video. C444 keeps chroma lossless
# geometry; RGB<->YCbCr is full-range BT.601 (round-trip error <= 1/255).
# The per-frame conversion runs through native/imgproc.cpp when a compiler
# is available (~20x the numpy throughput at 4K; parity-tested) so the
# hermetic plane keeps up with the device program.
# ---------------------------------------------------------------------------

def _imgproc():
    global _IMGPROC
    if _IMGPROC is None:
        from upscale_video_tpu_torch.native import imgproc

        _IMGPROC = imgproc if imgproc.native_available() else False
    return _IMGPROC


_IMGPROC = None


def _rgb_to_ycbcr_full(rgb: np.ndarray) -> np.ndarray:
    r, g, b = [rgb[..., i].astype(np.float32) for i in range(3)]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 + (b - y) * (0.5 / (1.0 - 0.114))
    cr = 128.0 + (r - y) * (0.5 / (1.0 - 0.299))
    out = np.stack([y, cb, cr], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _ycbcr_to_rgb_full(ycc: np.ndarray) -> np.ndarray:
    y = ycc[..., 0].astype(np.float32)
    cb = ycc[..., 1].astype(np.float32) - 128.0
    cr = ycc[..., 2].astype(np.float32) - 128.0
    r = y + cr * (1.0 - 0.299) / 0.5
    b = y + cb * (1.0 - 0.114) / 0.5
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    out = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


class Y4MSource(FrameSource):
    """Reads YUV4MPEG2 (C444 or C420/C420jpeg/C420mpeg2) as RGB frames.

    ``raw_i420=True`` (C420-class streams only): :meth:`read` returns the
    frame's flat I420 bytes ``(H*W*3//2,)`` untouched — the 4:2:0 INPUT
    contract (ops/yuv.i420_to_model converts on device), skipping the host
    chroma upsample + YCbCr->RGB entirely.  :attr:`i420_full_range` tells
    the device conversion which levels the stream uses (C420jpeg = full)."""

    def __init__(self, path_or_file, raw_i420: bool = False):
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self._f: IO[bytes] = (
            open(path_or_file, "rb") if self._own else path_or_file
        )
        header = self._readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 stream")
        self.colorspace = "C420jpeg"
        self.frame_rate = Fraction(25, 1)
        xrange = None
        for tok in header.split()[1:]:
            c, v = tok[:1], tok[1:].decode()
            if c == b"W":
                self.width = int(v)
            elif c == b"H":
                self.height = int(v)
            elif c == b"F":
                n, d = v.split(":")
                self.frame_rate = Fraction(int(n), int(d))
            elif c == b"C":
                self.colorspace = "C" + v
            elif c == b"X" and v.upper().startswith("COLORRANGE="):
                # newer ffmpeg tags range explicitly (e.g. full-range
                # content stored as C420mpeg2 XCOLORRANGE=FULL); this
                # overrides the siting-tag heuristic below
                xrange = v.split("=", 1)[1].upper()
        if self.colorspace.startswith("C444"):
            self._planes = [(self.height, self.width)] * 3
        elif self.colorspace.startswith("C420"):
            self._planes = [
                (self.height, self.width),
                (self.height // 2, self.width // 2),
                (self.height // 2, self.width // 2),
            ]
        else:
            raise NotImplementedError(f"y4m colorspace {self.colorspace}")
        self.raw_i420 = raw_i420
        if xrange is not None:
            self.i420_full_range = xrange == "FULL"
        else:
            # siting-tag heuristic: jpeg-siting = full; bare C420/
            # C420mpeg2 = studio (what ffmpeg writes); C444 defaults FULL
            # for self-consistency with Y4MSink's own full-range writes
            self.i420_full_range = (self.colorspace == "C420jpeg"
                                    or self.colorspace.startswith("C444"))
        if raw_i420 and not self.colorspace.startswith("C420"):
            raise ValueError(
                f"raw_i420 needs a C420-class stream, got {self.colorspace}"
            )

    def _readline(self) -> bytes:
        out = bytearray()
        while True:
            ch = self._f.read(1)
            if not ch or ch == b"\n":
                return bytes(out)
            out += ch

    def skip(self, n: int) -> int:
        """Skip ``n`` frames without colour conversion (seek past the plane
        bytes); returns how many were actually skipped.  Used by the resume
        fast-forward so a long completed prefix costs file seeks, not
        decodes."""
        frame_bytes = sum(h * w for h, w in self._planes)
        done = 0
        for _ in range(n):
            marker = self._readline()
            if not marker:
                return done
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"bad frame marker {marker!r}")
            try:
                # a relative seek happily lands past EOF: verify the frame's
                # bytes exist so a truncated file raises here exactly like
                # the read path (probe counts frames via skip)
                cur = self._f.tell()
                end = self._f.seek(0, 2)
                if end - cur < frame_bytes:
                    raise ValueError("truncated y4m frame")
                self._f.seek(cur + frame_bytes)
            except OSError:  # non-seekable (pipe) fallback
                if len(self._f.read(frame_bytes)) != frame_bytes:
                    raise ValueError("truncated y4m frame")
            done += 1
        return done

    def read(self) -> Optional[np.ndarray]:
        marker = self._readline()
        if not marker:
            return None
        if not marker.startswith(b"FRAME"):
            raise ValueError(f"bad frame marker {marker!r}")
        if self.raw_i420:
            total = sum(h * w for h, w in self._planes)
            buf = self._f.read(total)
            if len(buf) != total:
                raise ValueError("truncated y4m frame")
            return np.frombuffer(buf, np.uint8)
        planes = []
        for h, w in self._planes:
            buf = self._f.read(h * w)
            if len(buf) != h * w:
                raise ValueError("truncated y4m frame")
            planes.append(np.frombuffer(buf, np.uint8).reshape(h, w))
        y, u, v = planes
        if not self.i420_full_range:
            # studio-level stream (bare C420/C420mpeg2, or any colorspace
            # tagged XCOLORRANGE=LIMITED): expand before the full-range
            # converter — the previous full-range-everywhere read washed
            # foreign files out.  (Our own sinks write full-range
            # C420jpeg/C444 only, unaffected.)  Runs on the still-
            # subsampled chroma (pointwise: order-independent, 4x fewer
            # elements than post-upsample).
            def expand(p, off, scale):
                f = (p.astype(np.float32) - off) * scale + (0 if off == 16
                                                            else 128)
                return np.clip(np.round(f), 0, 255).astype(np.uint8)

            y = expand(y, 16, 255.0 / 219.0)
            u = expand(u, 128, 255.0 / 224.0)
            v = expand(v, 128, 255.0 / 224.0)
        if u.shape != y.shape:  # upsample 420 chroma
            u = np.repeat(np.repeat(u, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
            v = np.repeat(np.repeat(v, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
        native = _imgproc()
        if native:
            return native.ycbcr444_to_rgb(y, u, v)
        return _ycbcr_to_rgb_full(np.stack([y, u, v], axis=-1))

    def close(self) -> None:
        if self._own:
            self._f.close()


class Y4MSink(FrameSink):
    """Writes YUV4MPEG2.

    ``colorspace="C444"`` (default): :meth:`write` takes RGB frames and
    converts (full-range BT.601, losslessly-sited chroma).
    ``colorspace="C420jpeg"``: :meth:`write` takes pre-assembled full-range
    I420 bytes ``(H*W*3//2,)`` — the device-side 4:2:0 output contract
    (ops/yuv.py): half the bytes and zero host colour math."""

    def __init__(self, path_or_file, width: int, height: int,
                 frame_rate: Fraction, colorspace: str = "C444"):
        if colorspace not in ("C444", "C420jpeg"):
            raise ValueError(f"unsupported y4m colorspace {colorspace!r}")
        if colorspace == "C420jpeg" and (width % 2 or height % 2):
            raise ValueError(
                f"4:2:0 needs even geometry, got {width}x{height}"
            )
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self._f: IO[bytes] = (
            open(path_or_file, "wb") if self._own else path_or_file
        )
        self.width, self.height = width, height
        self.colorspace = colorspace
        fr = as_fraction(frame_rate)
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{fr.numerator}:{fr.denominator} "
            f"Ip A1:1 {colorspace}\n".encode()
        )
        # reused conversion target + zero-copy write (tobytes() duplicated
        # every 4K frame's 24 MB on the hot path — round-3 load test)
        self._ycc = (np.empty((3, height, width), np.uint8)
                     if colorspace == "C444" else None)
        self._i420_bytes = width * height * 3 // 2

    def write(self, frame: np.ndarray) -> None:
        if self.colorspace == "C420jpeg":
            if frame.dtype != np.uint8 or frame.shape != (self._i420_bytes,):
                raise ValueError(
                    f"C420 sink takes flat I420 uint8 ({self._i420_bytes},); "
                    f"got {frame.shape}/{frame.dtype}"
                )
            self._f.write(b"FRAME\n")
            self._f.write(memoryview(np.ascontiguousarray(frame)).cast("B"))
            return
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {frame.shape} != sink geometry")
        self._f.write(b"FRAME\n")
        native = _imgproc()
        if native:
            native.rgb_to_ycbcr444(frame, out=self._ycc)
            self._f.write(memoryview(self._ycc).cast("B"))
            return
        ycc = _rgb_to_ycbcr_full(frame)
        for i in range(3):
            self._f.write(np.ascontiguousarray(ycc[..., i]).tobytes())

    def close(self) -> None:
        self._f.flush()
        if self._own:
            self._f.close()


# ---------------------------------------------------------------------------
# PNG directory — the reference's {frame}.{tag}.png layout
# (upscale_processing.py:336-337, 582-583); 1-indexed frames.
# ---------------------------------------------------------------------------

class PngDirSource(FrameSource):
    def __init__(self, directory: str, tag: str = "extract",
                 start: int = 1, end: Optional[int] = None,
                 frame_rate: Fraction = Fraction(24, 1)):
        self.dir = directory
        self.tag = tag
        self.frame_rate = as_fraction(frame_rate)
        self._next = start
        self._end = end
        first = self._path(start)
        if not os.path.exists(first):
            raise FileNotFoundError(first)
        self.width, self.height = png_size(first)
        if end is not None:
            self.num_frames = end - start + 1

    def _path(self, idx: int) -> str:
        name = f"{idx}.{self.tag}.png" if self.tag else f"{idx}.png"
        return os.path.join(self.dir, name)

    def read(self) -> Optional[np.ndarray]:
        if self._end is not None and self._next > self._end:
            return None
        p = self._path(self._next)
        if not os.path.exists(p):
            return None
        arr = read_png(p)
        self._next += 1
        return arr


class PngDirSink(FrameSink):
    def __init__(self, directory: str, tag: str = "", start: int = 1):
        self.dir = directory
        self.tag = tag
        self._next = start
        os.makedirs(directory, exist_ok=True)

    def write(self, frame: np.ndarray) -> None:
        name = f"{self._next}.{self.tag}.png" if self.tag else f"{self._next}.png"
        write_png(os.path.join(self.dir, name), frame)
        self._next += 1


# ---------------------------------------------------------------------------
# ffmpeg rawvideo pipes — the production streaming path
# ---------------------------------------------------------------------------

class _StderrDrain:
    """Continuously drains a subprocess stderr pipe on a daemon thread,
    keeping only the tail.  Without this, an ffmpeg emitting more than a
    pipe buffer of diagnostics (corrupt input, encoder warnings) blocks on
    its stderr write and the decode loop / close() deadlocks."""

    def __init__(self, stream, keep: int = 65536):
        import threading

        self._tail = b""
        self._keep = keep
        self._stream = stream
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while True:
                chunk = self._stream.read(8192)
                if not chunk:
                    return
                self._tail = (self._tail + chunk)[-self._keep:]
        except (OSError, ValueError):
            return

    def tail(self, timeout: float = 5.0) -> str:
        self._thread.join(timeout)
        return self._tail.decode(errors="replace")


class FfmpegPipeSource(FrameSource):
    """Decode any container via ``ffmpeg ... -f rawvideo -pix_fmt rgb24 -``.

    Replaces the reference's extract-to-PNG stage
    (upscale_processing.py:214-245) with a zero-spill pipe.
    """

    def __init__(self, ffmpeg: str, input_file: str, width: int, height: int,
                 frame_rate: Fraction, crop_filter: str = "",
                 num_frames: Optional[int] = None, start_frame: int = 1,
                 seek_mode: str = "ss",
                 extra_args: Optional[List[str]] = None, native: bool = True,
                 output_pix_fmt: str = "rgb24"):
        if output_pix_fmt not in ("rgb24", "yuv420p"):
            raise ValueError(f"unsupported output pix fmt {output_pix_fmt!r}")
        if output_pix_fmt == "yuv420p" and (width % 2 or height % 2):
            raise ValueError(
                f"4:2:0 needs even geometry, got {width}x{height}"
            )
        self.width, self.height = width, height
        self.output_pix_fmt = output_pix_fmt
        # 4:2:0 input contract (ops/yuv.i420_to_model): half the pipe
        # bytes and no swscale->rgb24 conversion inside the decoder;
        # read() then returns the flat I420 buffer
        self.raw_i420 = output_pix_fmt == "yuv420p"
        self.i420_full_range = False  # rawvideo yuv420p = studio levels
        self.frame_rate = as_fraction(frame_rate)
        self.num_frames = num_frames
        cmds = [ffmpeg, "-hide_banner", "-loglevel", "error",
                "-hwaccel", "auto"]
        if start_frame > 1 and seek_mode == "ss":
            # input-side accurate seek: decode starts at the nearest
            # keyframe and discards up to the timestamp, so resume cost is
            # O(GOP), not O(completed prefix).  The timestamp lands half a
            # frame period before the target frame's pts so the first
            # delivered frame is exactly ``start_frame`` (1-indexed).
            ts = Fraction(2 * (start_frame - 1) - 1, 2) / self.frame_rate
            cmds += ["-ss", f"{float(ts):.6f}"]
        cmds += ["-i", input_file]
        vf = []
        if crop_filter:
            vf.append(crop_filter)
        if start_frame > 1 and seek_mode != "ss":
            # decode-everything fallback (frame-exact regardless of
            # container timestamps)
            vf.append(f"select=gte(n\\,{start_frame - 1})")
        if vf:
            cmds += ["-vf", ",".join(vf)]
        if num_frames is not None:
            cmds += ["-frames:v", str(num_frames)]
        cmds += extra_args or []
        cmds += ["-f", "rawvideo", "-pix_fmt", output_pix_fmt, "-"]
        self.args = cmds
        self._proc = subprocess.Popen(
            cmds, stdout=subprocess.PIPE, stderr=subprocess.PIPE
        )
        self._stderr = _StderrDrain(self._proc.stderr)
        self._frame_bytes = (width * height * 3 if output_pix_fmt == "rgb24"
                             else width * height * 3 // 2)
        self._native = None
        if native:
            # C++ double-buffered ring keeps the decode pipe saturated while
            # Python is busy dispatching device work (native/pipeio.cpp)
            from upscale_video_tpu_torch.native.pipeio import (
                NativePipeReader, native_available,
            )

            if native_available():
                try:
                    self._native = NativePipeReader(
                        self._proc.stdout.fileno(), self._frame_bytes
                    )
                except Exception:
                    # never leak a live decoder writing into an unread pipe
                    self._proc.terminate()
                    self._proc.wait()
                    raise

    def read(self) -> Optional[np.ndarray]:
        if self._native is not None:
            try:
                flat = self._native.read()
            except IOError as e:
                raise IOError(
                    f"{e}: {self._stderr.tail()[-500:]}"
                ) from e
            if flat is None:
                return None
            if self.output_pix_fmt == "yuv420p":
                return flat  # flat I420: the device converts
            return flat.reshape(self.height, self.width, 3)
        buf = self._proc.stdout.read(self._frame_bytes)
        if not buf:
            return None
        if len(buf) != self._frame_bytes:
            raise IOError(
                "truncated rawvideo frame from ffmpeg: "
                + self._stderr.tail()[-500:]
            )
        flat = np.frombuffer(buf, np.uint8)
        if self.output_pix_fmt == "yuv420p":
            return flat
        return flat.reshape(self.height, self.width, 3)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._proc.stdout:
            self._proc.stdout.close()
        self._proc.terminate()
        self._proc.wait()


class FfmpegPipeSink(FrameSink):
    """Encode a fragment via rawvideo stdin -> ``ffmpeg -vcodec <enc> out``.

    Replaces the reference's PNG-sequence fragment encode
    (upscale_processing.py:615-650); quality knob promoted to a flag
    (the reference hardcodes ``-global_quality 20`` at :634-635).
    """

    def __init__(self, ffmpeg: str, output_file: str, width: int, height: int,
                 frame_rate: Fraction, encoder: str = "libx264",
                 pix_fmt: str = "yuv420p", global_quality: Optional[int] = 20,
                 extra_args: Optional[List[str]] = None, native: bool = True,
                 flush_timeout_ms: Optional[int] = None,
                 input_pix_fmt: str = "rgb24"):
        if input_pix_fmt not in ("rgb24", "yuv420p"):
            raise ValueError(f"unsupported input pix fmt {input_pix_fmt!r}")
        if input_pix_fmt == "yuv420p" and (width % 2 or height % 2):
            raise ValueError(
                f"4:2:0 needs even geometry, got {width}x{height}"
            )
        self.width, self.height = width, height
        self.input_pix_fmt = input_pix_fmt
        # device-side 4:2:0 contract (ops/yuv.py): half the pipe bytes and
        # no swscale conversion inside the encoder process
        frame_bytes = (width * height * 3 if input_pix_fmt == "rgb24"
                       else width * height * 3 // 2)
        self._frame_bytes = frame_bytes
        fr = as_fraction(frame_rate)
        cmds = [ffmpeg, "-hide_banner", "-loglevel", "error", "-y",
                "-f", "rawvideo", "-pix_fmt", input_pix_fmt,
                "-s", f"{width}x{height}",
                "-r", f"{fr.numerator}/{fr.denominator}",
                "-i", "-", "-vcodec", encoder, "-pix_fmt", pix_fmt]
        if global_quality is not None:
            cmds += ["-global_quality", str(global_quality)]
        cmds += extra_args or []
        cmds += [output_file]
        self.args = cmds
        self._proc = subprocess.Popen(
            cmds, stdin=subprocess.PIPE, stderr=subprocess.PIPE
        )
        self._stderr = _StderrDrain(self._proc.stderr)
        self._native = None
        if native:
            from upscale_video_tpu_torch.native.pipeio import (
                NativePipeWriter, native_available,
            )

            if native_available():
                try:
                    self._native = NativePipeWriter(
                        self._proc.stdin.fileno(), frame_bytes,
                        flush_timeout_ms=flush_timeout_ms,
                    )
                except Exception:
                    self._proc.terminate()
                    self._proc.wait()
                    raise

    def write(self, frame: np.ndarray) -> None:
        if self.input_pix_fmt == "yuv420p":
            expect = (self._frame_bytes,)
        else:
            expect = (self.height, self.width, 3)
        if frame.shape != expect:
            raise ValueError(
                f"frame shape {frame.shape} != sink geometry {expect} "
                f"({self.input_pix_fmt})"
            )
        if frame.dtype != np.uint8:
            # the rawvideo pipe framing is byte-exact: a float frame would
            # emit 4x the bytes and silently desynchronize ffmpeg
            raise ValueError(f"frame dtype {frame.dtype} != uint8")
        if self._native is not None:
            self._native.write(frame)
            return
        self._proc.stdin.write(np.ascontiguousarray(frame).tobytes())

    def close(self) -> None:
        native_err: Optional[BaseException] = None
        if self._native is not None:
            try:
                self._native.close()  # raises if ring-tail frames were lost
            except BaseException as e:
                native_err = e
            self._native = None
        try:
            self._proc.stdin.close()
        except BrokenPipeError:
            pass  # encoder died: wait() + stderr below carry the real error
        ret = self._proc.wait()
        if ret != 0:
            raise IOError(
                f"ffmpeg encoder failed ({ret}): {self._stderr.tail()[-500:]}"
            )
        if native_err is not None:
            # encoder exited 0 but not every submitted frame reached it —
            # the fragment on disk is short; surface it so the caller's
            # partial-fragment cleanup (process.py) deletes it
            raise IOError(
                f"{native_err}: {self._stderr.tail()[-500:]}"
            )


# ---------------------------------------------------------------------------
# Dispatch by path/extension
# ---------------------------------------------------------------------------

def open_source(path: str, **kw) -> FrameSource:
    if os.path.isdir(path):
        return PngDirSource(path, **kw)
    if path.endswith(".y4m"):
        return Y4MSource(path)
    raise ValueError(
        f"no hermetic reader for {path!r}; use FfmpegPipeSource with an "
        f"ffmpeg binary for compressed containers"
    )


def open_sink(path: str, width: int, height: int, frame_rate, **kw) -> FrameSink:
    if path.endswith(".y4m"):
        return Y4MSink(path, width, height, frame_rate)
    if path.endswith(os.sep) or os.path.isdir(path) or "." not in os.path.basename(path):
        return PngDirSink(path, **kw)
    raise ValueError(
        f"no hermetic writer for {path!r}; use FfmpegPipeSink with an "
        f"ffmpeg binary for compressed containers"
    )
