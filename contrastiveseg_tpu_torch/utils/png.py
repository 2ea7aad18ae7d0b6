"""A PNG codec on the standard library (``zlib``), numpy and a native row
unfilter, for machines without PIL.

The JAX package writes and reads every PNG of inference and evaluation
through PIL (``engine/tester.py``, ``metrics/cityscapes_official.py``,
``metrics/dataset_evaluators.py``, ``tools/evaluate.py``); the port does it
here, with the arrays PIL's ``np.asarray(Image.open(path))`` gives:

* 8-bit grey -> uint8 [H, W]; 16-bit grey -> uint16 [H, W];
* 8-bit grey with alpha -> uint8 [H, W, 2];
* 8-bit RGB -> uint8 [H, W, 3]; 8-bit RGBA -> uint8 [H, W, 4];
* palette (1, 2, 4 or 8 bits) -> uint8 [H, W] of palette indices;

and, with ``rgb=True``, the uint8 [H, W, 3] of PIL's
``np.asarray(Image.open(path).convert("RGB"))`` (grey repeated, alpha
dropped, palette indices looked up; 16-bit files are refused).  The data
loader reads every PNG frame and label without a sidecar this way.

The reader undoes all five row filters (0-4), so it reads what PIL and
libpng write with adaptive filtering; interlaced files are refused.  The
unfilter is native code (``csrc/png_unfilter.cpp``, built at first use by
``data/native.py``); ``_unfilter`` is its plain Python version, taken when
the library cannot be built (counted in ``native.PNG_LIBRARY.fallbacks``)
and held against it by the tests.  The decompression is ``zlib``'s, also
native.  The writer writes grey, 16-bit grey and RGB, with filter 0 on
every row, or the filters given (``filter_rows``, vectorised numpy).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

from contrastiveseg_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
GREY, RGB, PALETTE, GREY_ALPHA, RGBA = 0, 2, 3, 4, 6
_CHANNELS = {GREY: 1, RGB: 3, PALETTE: 1, GREY_ALPHA: 2, RGBA: 4}
_DEPTHS = {GREY: (8, 16), RGB: (8,), PALETTE: (1, 2, 4, 8), GREY_ALPHA: (8,), RGBA: (8,)}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth_predictor(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(raw: np.ndarray, bpp: int, filters: Sequence[int]) -> np.ndarray:
    """[h, 1 + stride] filtered scanlines of the uint8 [h, stride] ``raw``:
    row y gets filter ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth), each filter computed at once for its rows from their
    raw neighbours."""
    h, stride = raw.shape
    ftype = np.asarray(filters, np.uint8)[np.arange(h) % len(filters)]
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = ftype
    for f in set(ftype.tolist()):
        rows = np.flatnonzero(ftype == f)
        x = raw[rows].astype(np.int16)
        if f == 0:
            out[rows, 1:] = raw[rows]
            continue
        a = np.zeros_like(x)
        a[:, bpp:] = x[:, :-bpp]
        b = np.where((rows > 0)[:, None], raw[np.maximum(rows - 1, 0)], 0).astype(np.int16)
        if f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            c = np.zeros_like(x)
            c[:, bpp:] = b[:, :-bpp]
            pred = _paeth_predictor(a, b, c)
        out[rows, 1:] = (x - pred).astype(np.uint8)
    return out


def encode_png(a: np.ndarray, level: int = 6, filters: Sequence[int] = (0,)) -> bytes:
    """PNG bytes of ``a``: uint8 [H, W] (grey), uint8 [H, W, 3] (RGB) or
    uint16 [H, W] (16-bit grey), at zlib compression ``level``, row y
    filtered with ``filters[y % len(filters)]``."""
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
    raw = np.ascontiguousarray(a).view(np.uint8).reshape(h, -1)
    rows = filter_rows(raw, _CHANNELS[color] * depth // 8, filters)
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
    """[h, stride] uint8 scanlines from the decompressed stream: the plain
    version of ``native.png_unfilter``, byte by byte for Average and Paeth."""
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


def unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """[h, stride] uint8 scanlines: the native unfilter, or ``_unfilter``
    where the library cannot be built."""
    rows = native.png_unfilter(data, h, stride, bpp)
    return _unfilter(data, h, stride, bpp) if rows is None else rows


def decode_png(data: bytes, rgb: bool = False) -> np.ndarray:
    """The array of a PNG, as PIL's ``np.asarray(Image.open(...))`` gives it,
    or with ``rgb`` as ``np.asarray(Image.open(...).convert("RGB"))``."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, palette = 8, None, [], b""
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
        elif tag == b"PLTE":
            palette = body
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise ValueError(f"unsupported PNG: colour type {color}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if rgb and depth == 16:
        raise ValueError("a 16-bit PNG has no RGB reading here")
    channels = _CHANNELS[color]
    stride = (w * channels * depth + 7) // 8
    rows = unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, channels * depth // 8))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    if depth < 8:  # palette indices packed several to a byte, high bits first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        rows = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
    a = rows.reshape(h, w, channels) if channels > 1 else rows
    if not rgb:
        return a
    if color == PALETTE:  # entries past the PLTE chunk read as black, as in PIL
        lut = np.zeros((256, 3), np.uint8)
        n = min(len(palette) // 3, 256)
        lut[:n] = np.frombuffer(palette, np.uint8, 3 * n).reshape(n, 3)
        return lut[a]
    if color in (GREY, GREY_ALPHA):
        grey = a if color == GREY else a[..., 0]
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(a[..., :3]) if color == RGBA else a


def read_png(path, rgb: bool = False) -> np.ndarray:
    return decode_png(Path(path).read_bytes(), rgb)
