"""The port's native PNG unfilter (``csrc/png_unfilter.cpp``) against its
plain Python version and against PIL.

Each colour type the reader takes (8- and 16-bit grey, grey with alpha,
RGB, RGBA, palette at 1, 2, 4 and 8 bits) is written twice: by this file,
with the rows cycling through the five filters (``utils/png.filter_rows``),
and, where PIL writes the mode, by PIL with its own filter choice.  Every
check is exact: the native scanlines equal the Python ones byte for byte,
and the decoded array (and its ``rgb=True`` reading) equals PIL's
``np.asarray(Image.open(...))`` (and ``.convert("RGB")``), value, dtype and
shape.  Without the library the Python path is taken and counted.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.utils import png

H, W = 23, 41  # odd, so that packed palette rows end mid-byte
GROUPS = ("grey", "rgb", "alpha", "palette")


def _png(raw: np.ndarray, w: int, depth: int, color: int, palette: bytes = b"") -> bytes:
    """A PNG of the [h, stride] scanlines ``raw``, rows cycling filters 0-4."""
    bpp = max(1, png._CHANNELS[color] * depth // 8)
    rows = png.filter_rows(raw, bpp, (0, 1, 2, 3, 4))
    assert set(rows[:, 0].tolist()) == {0, 1, 2, 3, 4}
    head = png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, raw.shape[0], depth, color, 0, 0, 0))
    plte = png._chunk(b"PLTE", palette) if palette else b""
    return (png.SIGNATURE + head + plte + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + png._chunk(b"IEND", b""))


def _arrays(group: str):
    """(array, PIL mode or None, PNG colour type, bit depth) of each case."""
    rng = np.random.default_rng(GROUPS.index(group))
    ramp = np.add.outer(np.arange(H), 3 * np.arange(W))
    smooth = np.cumsum(rng.integers(0, 5, (H, W, 4)), axis=1).astype(np.uint8)
    if group == "grey":
        return [(rng.integers(0, 256, (H, W), dtype=np.uint8), "L", png.GREY, 8),
                ((ramp % 256).astype(np.uint8), "L", png.GREY, 8),
                ((257 * ramp).astype(np.uint16), "I;16", png.GREY, 16)]
    if group == "rgb":
        return [(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), "RGB", png.RGB, 8),
                (smooth[..., :3].copy(), "RGB", png.RGB, 8)]
    if group == "alpha":
        return [(smooth, "RGBA", png.RGBA, 8), (smooth[..., :2].copy(), "LA", png.GREY_ALPHA, 8)]
    return [(rng.integers(0, 2 ** d, (H, W), dtype=np.uint8), "P", png.PALETTE, d)
            for d in (1, 2, 4, 8)]


def _raw(a: np.ndarray, depth: int) -> np.ndarray:
    """The [h, stride] scanlines of ``a``."""
    if depth < 8:  # indices packed high bits first
        bits = (a[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(a.shape[0], -1).astype(np.uint8), axis=1)
    if depth == 16:
        return a.astype(">u2").view(np.uint8).reshape(a.shape[0], -1)
    return np.ascontiguousarray(a).reshape(a.shape[0], -1)


def _pil(data: bytes, rgb: bool) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert("RGB") if rgb else im)


def _same(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("group", GROUPS)
def test_native_unfilter_matches_python_and_pil(group):
    assert native.PNG_LIBRARY.lib() is not None, native.PNG_LIBRARY.error
    rng = np.random.default_rng(7)
    for a, mode, color, depth in _arrays(group):
        palette = rng.integers(0, 256, 3 * 2 ** depth, dtype=np.uint8).tobytes() \
            if color == png.PALETTE else b""
        files = {"filters 0-4": _png(_raw(a, depth), W, depth, color, palette)}
        if mode != "P" or depth == 8:  # PIL writes these itself, filters its own choice
            im = Image.fromarray(a)
            if mode == "P":
                im.putpalette(palette)
            assert im.mode == mode
            buf = io.BytesIO()
            im.save(buf, format="PNG")
            files["PIL"] = buf.getvalue()
        for how, data in files.items():
            what = f"{group} {mode} {depth}-bit, {how}"
            n_before = native.PNG_LIBRARY.fallbacks
            _same(png.decode_png(data), _pil(data, rgb=False), what)
            if depth != 16:
                _same(png.decode_png(data, rgb=True), _pil(data, rgb=True), what + " as RGB")
            assert native.PNG_LIBRARY.fallbacks == n_before
            stream = zlib.decompress(data[data.index(b"IDAT") + 4:][:-16]) \
                if how == "filters 0-4" else None
            if stream is not None:  # one IDAT chunk: the scanlines, both ways
                stride = _raw(a, depth).shape[1]
                bpp = max(1, png._CHANNELS[color] * depth // 8)
                _same(native.png_unfilter(stream, H, stride, bpp),
                      png._unfilter(stream, H, stride, bpp), what + " scanlines")
                _same(png._unfilter(stream, H, stride, bpp), _raw(a, depth), what + " raw")


def test_without_the_library_the_python_path_is_taken_and_counted(tmp_path, monkeypatch):
    """A library that cannot be built: decoding takes ``_unfilter``, each
    call counted, and the arrays are the same; a bad filter type or a
    truncated stream raises ValueError on both routes."""
    a = np.cumsum(np.random.default_rng(3).integers(0, 4, (H, W, 3)), axis=1).astype(np.uint8)
    data = png.encode_png(a, filters=(4, 3, 1))
    lib = native.SegdataLibrary(tmp_path, tmp_path / "missing.cpp", native.PNG_SIGNATURES,
                                stem="libpngunfilter", fallback="python")
    monkeypatch.setattr(native, "PNG_LIBRARY", lib)
    _same(png.decode_png(data), a, "python route")
    _same(png.decode_png(data, rgb=True), a, "python route, rgb")
    assert lib.fallbacks == 2 and lib.route() == "python" and "missing.cpp" in lib.error
    monkeypatch.undo()
    stream = bytearray(png.filter_rows(a.reshape(H, -1), 3, (0, 1)).tobytes())
    stream[3 * (3 * W + 1)] = 5  # row 3's filter type
    for unfilter in (native.png_unfilter, png._unfilter):
        with pytest.raises(ValueError, match="row 3 has an unknown filter type 5"):
            unfilter(bytes(stream), H, 3 * W, 3)
        with pytest.raises(ValueError, match="truncated"):
            unfilter(bytes(stream[:-1]), H, 3 * W, 3)
