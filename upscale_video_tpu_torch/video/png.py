"""PNG files with numpy and ``zlib`` alone: the port's frame-store codec.

The PNG data plane (``{frame}.{tag}.png``), the split-machine zips, the
PNG-directory source and sink and the repair scan all read and write
through this module, so the port runs them on a host with no imaging
library.

- :func:`write_png` writes 8-bit RGB, non-interlaced, filter type 0 on
  every row (the frames go straight from the device buffer into ``zlib``,
  with no per-row filter search), a large frame deflated in row bands on
  threads.
- :func:`read_png` reads 8-bit RGB and RGBA (alpha dropped, as PIL's
  ``convert("RGB")`` drops it) with any of the five filter types per row,
  since PIL's encoder picks a filter per row and so may ffmpeg's.
- :func:`verify_png` checks the signature, every chunk's CRC and the
  closing IEND, as PIL's ``Image.verify`` does for the repair scan.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# zlib level 1: the plane is bound by the host's codec, and on noisy 4K
# frames level 1 runs well ahead of zlib's default 6 for a file of about
# the same size (filter 0 leaves the higher levels' longer match search
# little to find).
LEVEL = 1
_COLOR_BPP = {2: 3, 6: 4}  # colour type -> bytes per pixel at depth 8
# a band of at least this many scanline bytes per deflate thread (a 4K
# frame's 25 MB go out in 8 bands, a 64x48 frame in one)
BAND_BYTES = 1 << 20
MAX_BANDS = 8


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(body, zlib.crc32(kind))
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _deflate(raw: np.ndarray) -> bytes:
    """One zlib stream of the (H, 1 + 3W) scanlines.  Over two bands'
    worth, the rows are split into bands deflated on threads (``zlib``
    releases the interpreter lock), each a raw deflate stream ended by a
    sync flush (the last by the final block), so their concatenation under
    one zlib header and the whole data's Adler-32 is one valid stream, as
    pigz writes it: only matches across a band edge are lost."""
    bands = min(MAX_BANDS, os.cpu_count() or 1, raw.nbytes // BAND_BYTES)
    if bands < 2:
        return zlib.compress(raw, LEVEL)
    edges = np.linspace(0, raw.shape[0], bands + 1).astype(int)

    def band(i):
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
        last = i == bands - 1
        return (c.compress(raw[edges[i]:edges[i + 1]])
                + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))

    with ThreadPoolExecutor(bands) as pool:
        parts = list(pool.map(band, range(bands)))
    header = zlib.compress(b"", LEVEL)[:2]  # CMF and FLG for this level
    return header + b"".join(parts) + struct.pack(">I", zlib.adler32(raw))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 frame as an 8-bit RGB PNG.

    The file appears under ``path`` only once whole (written beside it,
    then renamed): the PNG plane's resume trusts every artifact it finds,
    so a process killed mid-write must leave none."""
    a = np.asarray(rgb_u8)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{a.shape} {a.dtype}")
    h, w, _ = a.shape
    if h == 0 or w == 0:
        raise ValueError(f"write_png takes a non-empty frame, got {a.shape}")
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0  # filter type 0 (None) on every row
    raw[:, 1:] = a.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", _deflate(raw)))
        f.write(_chunk(b"IEND", b""))
    os.replace(tmp, path)


def _chunks(data: bytes) -> List[Tuple[bytes, memoryview]]:
    """Every chunk up to IEND, each CRC checked; raises ``ValueError`` on a
    bad signature, a CRC mismatch or a file that ends before IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    view = memoryview(data)
    out = []
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        n, kind = struct.unpack(">I4s", view[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"truncated PNG: {kind!r} chunk runs past the end")
        body = view[pos + 8:end - 4]
        (crc,) = struct.unpack(">I", view[end - 4:end])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"PNG CRC mismatch in the {kind!r} chunk")
        out.append((kind, body))
        if kind == b"IEND":
            return out
        pos = end


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk, reading only the header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def verify_png(path: str) -> bool:
    """True when the file is a whole PNG: signature, every chunk's CRC and
    an IEND chunk (the check PIL's ``Image.verify`` makes)."""
    try:
        with open(path, "rb") as f:
            _chunks(f.read())
    except (OSError, ValueError):
        return False
    return True


def _unfilter_average(line: bytes, prior: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prior[i]) >> 1)) & 0xFF
    return bytes(cur)


def _unfilter_paeth(line: bytes, prior: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + stride) scanlines.

    None, Sub and Up run in numpy on the whole row (Sub is a cumulative
    sum mod 256 along the row, per byte of the pixel); Average and Paeth
    depend on the reconstructed byte to their left, so they run byte by
    byte (only PNGs from other writers hold them: :func:`write_png` writes
    filter 0)."""
    types = rows[:, 0]
    data = rows[:, 1:]
    if not types.any():
        return data.copy()
    if types.max() > 4:
        raise ValueError(f"unknown PNG filter type {int(types.max())}")
    out = np.empty_like(data)
    prior = np.zeros(data.shape[1], np.uint8)
    for y in range(data.shape[0]):
        line, ft = data[y], types[y]
        if ft == 0:
            out[y] = line
        elif ft == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ft == 2:
            np.add(line, prior, out=out[y])
        elif ft == 3:
            out[y] = np.frombuffer(
                _unfilter_average(line.tobytes(), prior.tobytes(), bpp),
                np.uint8)
        else:
            out[y] = np.frombuffer(
                _unfilter_paeth(line.tobytes(), prior.tobytes(), bpp),
                np.uint8)
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG as an (H, W, 3) uint8 frame (alpha
    dropped).  A corrupt or truncated file raises ``ValueError``, as does a
    PNG of another depth, colour type or interlace."""
    with open(path, "rb") as f:
        chunks = _chunks(f.read())
    if chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError(f"{path}: the first PNG chunk is not IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1])
    bpp = _COLOR_BPP.get(ctype)
    if depth != 8 or bpp is None or comp or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); 8-bit RGB or RGBA only")
    try:
        raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    stride = w * bpp
    if len(raw) != h * (1 + stride):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, "
                         f"not {h * (1 + stride)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    pixels = _unfilter(rows, bpp).reshape(h, w, bpp)
    return pixels if bpp == 3 else np.ascontiguousarray(pixels[..., :3])
