"""The port's PNG codec (``video/png.py``) against PIL, which is only a
yardstick here: the port itself never imports it.

- the port writes and PIL reads the same pixels, and PIL writes (with its
  per-row adaptive filters) and the port reads the same pixels;
- each of the five filter types, and rows of mixed types, from scanlines
  filtered by hand per the PNG specification;
- RGBA in (alpha dropped), 1x1 and odd widths;
- a flipped CRC, a truncated file or a missing IEND fails ``verify_png``
  and raises in ``read_png``.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from upscale_video_tpu_torch.video.png import (
    png_size, read_png, verify_png, write_png,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401

SHAPES = [(1, 1), (1, 5), (3, 1), (7, 13), (12, 16), (33, 40)]


def _image(h, w, seed, channels=3):
    """Gradients plus noise: PIL's filter search picks several types."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 7 + yy * 3, xx * 2 + 40, yy * 9 + 17, xx + yy][:channels], -1)
    return ((base + rng.integers(0, 24, (h, w, channels))) % 256).astype(np.uint8)


def _filter_types(data: bytes) -> set:
    """The filter type byte of every scanline of a PNG written by anyone."""
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    bpp = {2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * bpp)
    return set(raw[:, 0].tolist())


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ft, cur, prior, bpp):
    """PNG specification section 9: one scanline filtered by type ``ft``."""
    out = bytearray()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
        out.append((cur[i] - pred) & 0xFF)
    return bytes(out)


def _png_bytes(pixels, types):
    """A PNG assembled by hand: each row filtered by its own type."""
    h, w, bpp = pixels.shape
    rows = pixels.reshape(h, w * bpp)
    prior = bytes(w * bpp)
    raw = bytearray()
    for y in range(h):
        cur = rows[y].tobytes()
        raw.append(types[y % len(types)])
        raw += _filter_row(types[y % len(types)], cur, prior, bpp)
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("hw", SHAPES)
def test_port_writes_pil_reads(tmp_path, hw):
    img = _image(*hw, seed=1)
    path = str(tmp_path / "f.png")
    write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (hw[1], hw[0])
        np.testing.assert_array_equal(np.asarray(im), img)
    assert png_size(path) == (hw[1], hw[0])
    assert verify_png(path)
    with open(path, "rb") as f:
        assert _filter_types(f.read()) == {0}
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("bands", [2, 3, 8])
def test_banded_deflate_is_one_stream(tmp_path, monkeypatch, bands):
    """A frame over two bands' worth is deflated in row bands on threads:
    the file is one zlib stream that PIL, ``zlib`` and the port read back
    exactly, the bands' edges at any row."""
    from upscale_video_tpu_torch.video import png

    monkeypatch.setattr(png, "BAND_BYTES", 4096)
    monkeypatch.setattr(png, "MAX_BANDS", bands)
    monkeypatch.setattr(png.os, "cpu_count", lambda: 8)
    img = _image(61, 97, seed=8)  # 61 rows of 292 bytes: 4 x 4096 bytes
    path = str(tmp_path / "f.png")
    write_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert _filter_types(data) == {0}
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(read_png(path), img)
    raw = np.empty((61, 1 + 3 * 97), np.uint8)
    raw[:, 0], raw[:, 1:] = 0, img.reshape(61, -1)
    deflated = png._deflate(raw)
    assert zlib.decompress(deflated) == raw.tobytes()
    assert deflated != zlib.compress(raw, png.LEVEL)  # it was banded


@pytest.mark.parametrize("hw", SHAPES)
def test_pil_writes_port_reads(tmp_path, hw):
    img = _image(*hw, seed=2)
    path = str(tmp_path / "f.png")
    Image.fromarray(img).save(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, img)
    assert verify_png(path) and png_size(path) == (hw[1], hw[0])


def test_pil_adaptive_filters_read_back(tmp_path):
    """PIL's encoder picks a filter per row: a frame large enough holds
    several types, and every one reads back exactly."""
    img = _image(64, 96, seed=3)
    path = str(tmp_path / "f.png")
    Image.fromarray(img).save(path)
    with open(path, "rb") as f:
        assert len(_filter_types(f.read())) >= 3
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
@pytest.mark.parametrize("types", [[0], [1], [2], [3], [4], [4, 3, 1, 2, 0, 3]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_each_filter_type(tmp_path, types, channels):
    img = _image(9, 11, seed=4, channels=channels)
    data = _png_bytes(img, types)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(data)
    assert _filter_types(data) == set(types)
    with Image.open(io.BytesIO(data)) as im:  # the hand-built file is valid
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(read_png(path), img[..., :3])
    assert verify_png(path)


@pytest.mark.parametrize("hw", [(1, 1), (5, 7)])
def test_rgba_alpha_dropped(tmp_path, hw):
    img = _image(*hw, seed=5, channels=4)
    path = str(tmp_path / "f.png")
    Image.fromarray(img, "RGBA").save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(want, img[..., :3])


def _corrupt(data: bytes, how: str) -> bytes:
    if how == "crc":  # flip one bit of the IDAT payload: its CRC no longer holds
        i = data.index(b"IDAT") + 6
        return data[:i] + bytes([data[i] ^ 0x10]) + data[i + 1:]
    if how == "truncated":
        return data[:len(data) // 2]
    if how == "no_iend":
        return data[:-12]
    return b"GIF89a" + data[6:]  # bad signature


@pytest.mark.parametrize("how", ["crc", "truncated", "no_iend", "signature"])
@pytest.mark.parametrize("writer", ["port", "pil"])
def test_corrupt_files_fail(tmp_path, how, writer):
    img = _image(12, 16, seed=6)
    path = str(tmp_path / "f.png")
    if writer == "port":
        write_png(path, img)
    else:
        Image.fromarray(img).save(path)
    assert verify_png(path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(_corrupt(data, how))
    assert not verify_png(path)
    with pytest.raises(ValueError):
        read_png(path)


def test_missing_file_fails_verify(tmp_path):
    assert not verify_png(str(tmp_path / "absent.png"))


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
    np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8),
])
def test_write_png_refuses_other_arrays(tmp_path, bad):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "f.png"), bad)


def test_read_png_refuses_other_formats(tmp_path):
    path = str(tmp_path / "g.png")
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(path)
    assert verify_png(path)
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(path)


def test_write_png_is_atomic(tmp_path, monkeypatch):
    """A write that fails part way leaves nothing under the frame's name
    (the PNG plane's resume trusts every artifact it finds), and the next
    write of the same frame replaces the leftover part file."""
    from upscale_video_tpu_torch.video import png

    path = str(tmp_path / "3.denoise.png")
    img = _image(6, 8, seed=7)

    def fail(*a, **k):
        raise OSError("killed mid-write")

    with monkeypatch.context() as m:
        m.setattr(png.zlib, "compress", fail)
        with pytest.raises(OSError):
            write_png(path, img)
    assert not (tmp_path / "3.denoise.png").exists()
    write_png(path, img)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3.denoise.png"]
    np.testing.assert_array_equal(read_png(path), img)
