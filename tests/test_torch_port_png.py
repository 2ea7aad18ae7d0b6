"""The port's PNG codec (``utils/png.py``) against PIL.

The port reads and writes PNGs without PIL (the machine with the GPU has
none); PIL is the reference here.  Every check is exact: the pixels of a
file written by one side and read by the other are equal, value and dtype,
to the array written, for 8-bit grey, RGB, 16-bit grey and palette images
(1, 2, 4 and 8 bits), for PIL's adaptively filtered files and for files
whose rows all use one of the five PNG filters.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from contrastiveseg_tpu_torch.utils.png import decode_png, encode_png, read_png, write_png


def _arrays(seed: int):
    """Noise and smooth (what segmentation labels and photos look like)
    arrays of each mode the codec has."""
    rng = np.random.default_rng(seed)
    h, w = 37, 53
    ramp = np.add.outer(np.arange(h), np.arange(w))
    return {
        "grey_noise": rng.integers(0, 256, (h, w), dtype=np.uint8),
        "grey_smooth": (ramp % 256).astype(np.uint8),
        "labels": np.repeat(rng.integers(0, 34, (h, 1), dtype=np.uint8), w, axis=1),
        "rgb_noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "rgb_smooth": np.cumsum(rng.integers(0, 4, (h, w, 3)), axis=1).astype(np.uint8),
        "grey16": rng.integers(0, 65536, (h, w)).astype(np.uint16),
        "disparity16": (256 + 97 * ramp).astype(np.uint16),
    }


CASES = sorted(_arrays(0))


def _pil_read(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_write(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("case", CASES)
def test_port_writes_what_pil_reads(case):
    a = _arrays(1)[case]
    got = _pil_read(encode_png(a))
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("case", CASES)
def test_port_reads_what_pil_writes(case):
    a = _arrays(2)[case]
    data = _pil_write(a)
    got, want = decode_png(data), _pil_read(data)
    assert got.dtype == want.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_round_trip_through_files(case, tmp_path):
    a = _arrays(3)[case]
    write_png(tmp_path / "a.png", a)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), a)


@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 200, 256])
def test_palette_images(colors, tmp_path):
    """Palette PNGs read as their indices, as PIL reads them; PIL writes 1-,
    2-, 4- and 8-bit indices for palettes of up to 2, 4, 16 and 256 colours
    (the port writes no palette PNG)."""
    rng = np.random.default_rng(colors)
    idx = rng.integers(0, colors, (29, 43), dtype=np.uint8)
    pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
    im = Image.frombytes("P", (43, 29), idx.tobytes())
    im.putpalette(pal.reshape(-1).tolist())
    im.save(tmp_path / "p.png")
    want = np.asarray(Image.open(tmp_path / "p.png"))
    np.testing.assert_array_equal(want, idx)
    np.testing.assert_array_equal(read_png(tmp_path / "p.png"), want)


def _filtered_png(a: np.ndarray, ftype: int) -> bytes:
    """``a`` (uint8 grey or RGB) with every row under filter ``ftype``: the
    PNG specification's filters, written out independently of the codec."""
    h, w = a.shape[:2]
    bpp = a.shape[2] if a.ndim == 3 else 1
    rows = a.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if a.ndim == 3 else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("case", ["grey_noise", "rgb_smooth"])
def test_every_row_filter(ftype, case):
    a = _arrays(4)[case]
    data = _filtered_png(a, ftype)
    np.testing.assert_array_equal(_pil_read(data), a)  # the file is right
    np.testing.assert_array_equal(decode_png(data), a)


def test_refusals():
    a = np.zeros((4, 5), np.uint8)
    data = bytearray(encode_png(a))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(data[6:]))
    bad = bytearray(data)
    bad[-20] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    interlaced = bytearray(data)
    interlaced[28] = 1  # IHDR's interlace byte
    crc = zlib.crc32(bytes(interlaced[12:29])) & 0xFFFFFFFF
    interlaced[29:33] = struct.pack(">I", crc)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(interlaced))
    with pytest.raises(ValueError, match="no PNG mode"):
        encode_png(np.zeros((4, 5), np.float32))
    with pytest.raises(ValueError, match="no PNG mode"):
        encode_png(np.zeros((4, 5, 4), np.uint8))
