"""A PNG codec on the standard library (``zlib``) and numpy, for machines
without PIL.

The JAX package writes and reads every PNG of inference and evaluation
through PIL (``engine/tester.py``, ``metrics/cityscapes_official.py``,
``metrics/dataset_evaluators.py``, ``tools/evaluate.py``); the port does it
here, with the arrays PIL's ``np.asarray(Image.open(path))`` gives:

* 8-bit grey -> uint8 [H, W]; 16-bit grey -> uint16 [H, W];
* 8-bit RGB -> uint8 [H, W, 3];
* palette (1, 2, 4 or 8 bits) -> uint8 [H, W] of palette indices.

The reader undoes all five row filters (0-4), so it reads what PIL and
libpng write with adaptive filtering; interlaced files are refused.  The
writer writes grey, 16-bit grey and RGB, with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
GREY, RGB, PALETTE = 0, 2, 3
_CHANNELS = {GREY: 1, RGB: 3, PALETTE: 1}
_DEPTHS = {GREY: (8, 16), RGB: (8,), PALETTE: (1, 2, 4, 8)}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(a: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of ``a``: uint8 [H, W] (grey), uint8 [H, W, 3] (RGB) or
    uint16 [H, W] (16-bit grey), at zlib compression ``level``."""
    a = np.asarray(a)
    if a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8:
        color, depth = RGB, 8
    elif a.ndim == 2 and a.dtype == np.uint8:
        color, depth = GREY, 8
    elif a.ndim == 2 and a.dtype == np.uint16:
        color, depth = GREY, 16
        a = a.astype(">u2")
    else:
        raise ValueError(f"no PNG mode for an array of shape {a.shape} and dtype {a.dtype}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).view(np.uint8).reshape(h, -1)], axis=1)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path, a: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(a))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """[h, stride] uint8 scanlines from the decompressed stream."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, raw = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = raw
        elif ftype == 1:  # Sub: a running sum of each byte lane, mod 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = raw + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one to its left
            r, p = raw.tolist(), prev.tolist()
            c = [0] * stride
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    c[i] = (r[i] + ((left + p[i]) >> 1)) & 0xFF
                else:
                    up_left = p[i - bpp] if i >= bpp else 0
                    c[i] = (r[i] + _paeth(left, p[i], up_left)) & 0xFF
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The array of a PNG, as PIL's ``np.asarray(Image.open(...))`` gives it."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise ValueError(f"unsupported PNG: colour type {color}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    channels = _CHANNELS[color]
    stride = (w * channels * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                     max(1, channels * depth // 8))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    if depth < 8:  # palette indices packed several to a byte, high bits first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        return (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
    return rows.reshape(h, w, 3) if channels == 3 else rows


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
