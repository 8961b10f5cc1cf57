"""The numpy PNG codec (`io/png.py`) against hand-built PNG bytes.

Each case filters its scanlines with a plain per-byte implementation of the
PNG spec's five filters (§9.2), assembles the chunks by hand and checks that
the decoder recovers the pixels exactly."""

import struct
import zlib

import numpy as np
import pytest

from orbslam_mapsave_tpu.io import dataset, png

# name -> (colour type, bit depth, channels, dtype)
FORMATS = {
    "gray8": (0, 8, 1, np.uint8),
    "gray16": (0, 16, 1, np.uint16),
    "rgb8": (2, 8, 3, np.uint8),
    "rgba8": (6, 8, 4, np.uint8),
}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype, cur, prior, bpp):
    out = bytearray(len(cur))
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[x] = (cur[x] - pred) & 0xFF
    return bytes(out)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _build_png(img, ctype, depth, filters, interlace=0):
    h, w = img.shape[:2]
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1)
    rows = rows.view(np.uint8)
    bpp = rows.shape[1] // w
    raw, prior = b"", bytes(rows.shape[1])
    for y in range(h):
        ftype = filters[y % len(filters)]
        cur = rows[y].tobytes()
        raw += bytes([ftype]) + _filter_row(ftype, cur, prior, bpp)
        prior = cur
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    idat = zlib.compress(raw)
    # split the image data over two IDAT chunks, as encoders may
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", idat[:7]) + _chunk(b"IDAT", idat[7:])
            + _chunk(b"IEND", b""))


def _image(fmt, rng, h=6, w=9):
    _, depth, ch, dtype = FORMATS[fmt]
    shape = (h, w) if ch == 1 else (h, w, ch)
    return rng.integers(0, 2 ** depth, shape).astype(dtype)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_decode_filtered(fmt, filters, rng):
    img = _image(fmt, rng)
    ctype, depth, _, dtype = FORMATS[fmt]
    out = png.decode(_build_png(img, ctype, depth, filters))
    assert out.dtype == dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_encode_roundtrip(fmt, rng, tmp_path):
    img = _image(fmt, rng, h=17, w=23)
    path = tmp_path / f"{fmt}.png"
    png.write(path, img)
    raw = path.read_bytes()
    assert raw.startswith(png.SIGNATURE)
    # the writer uses filter type 0 on every row
    ihdr_end = 8 + 8 + 13 + 4
    body = zlib.decompress(raw[ihdr_end + 8:-12 - 4])
    stride = body.__len__() // img.shape[0]
    assert all(body[y * stride] == 0 for y in range(img.shape[0]))
    np.testing.assert_array_equal(png.read(path), img)


def test_rejects_interlaced_and_corrupt(rng):
    img = _image("gray8", rng)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(_build_png(img, 0, 8, (0,), interlace=1))
    data = bytearray(_build_png(img, 0, 8, (0,)))
    data[20] ^= 0xFF  # inside IHDR: CRC no longer matches
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.float32))


def test_dataset_readers_convert(rng, tmp_path):
    """Gray readers: 16-bit keeps the high byte, RGB goes through luma."""
    g16 = _image("gray16", rng)
    png.write(tmp_path / "g16.png", g16)
    np.testing.assert_array_equal(dataset._imread_gray(tmp_path / "g16.png"),
                                  (g16 >> 8).astype(np.uint8))
    rgb = _image("rgb8", rng)
    png.write(tmp_path / "rgb.png", rgb)
    luma = rgb.astype(np.float64) @ [0.299, 0.587, 0.114]
    got = dataset._imread_gray(tmp_path / "rgb.png")
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.float64) - luma).max() <= 0.5 + 1e-3
    d = (rng.integers(0, 20000, (6, 9))).astype(np.uint16)
    png.write(tmp_path / "d.png", d)
    depth = dataset._imread_depth(tmp_path / "d.png", 5000.0)
    assert depth.dtype == np.float16
    np.testing.assert_allclose(depth, d / 5000.0, rtol=1e-3)
