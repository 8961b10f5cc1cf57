"""Minimal PNG codec on numpy, `zlib` and `struct` (no imaging library).

Covers what the dataset readers and writers need: 8- and 16-bit grayscale,
8-bit RGB and RGBA, non-interlaced, all five scanline filter types on read
(PNG spec §9). The writer emits filter type 0 for every row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (PNG spec §11.2.2); palette and gray+alpha are
# not produced by any sensor format this package reads
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, body
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; returns (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).ravel()
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) array, uint8 or uint16."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (
            depth == 16 and ctype != 0):
        raise ValueError(f"unsupported PNG: colour type {ctype}, "
                         f"bit depth {depth}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    return pix.reshape(height, width, ch) if ch > 1 else pix.reshape(
        height, width)


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint8/uint16 gray, or (H, W, 3|4) uint8 RGB/RGBA -> PNG bytes."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, img.dtype.itemsize * 8
    elif img.ndim == 3 and img.dtype == np.uint8 and img.shape[2] in (3, 4):
        ctype, depth = (2 if img.shape[2] == 3 else 6), 8
    else:
        raise ValueError(f"cannot encode {img.dtype} array of shape "
                         f"{img.shape} as PNG")
    height, width = img.shape[:2]
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(height, -1)
    rows = rows.view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def read(path: str | Path) -> np.ndarray:
    return decode(Path(path).read_bytes())


def write(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode(img))
