"""The port's native JPEG decoder (``utils/jpeg.read_jpeg``,
``csrc/jpeg_decode.cpp``) against PIL, bit for bit.

The JAX package reads a frame as ``np.asarray(Image.open(p))`` or with
``.convert("RGB")``; the port must give the same array (value, dtype and
shape) without PIL, for both readings:

* frames PIL writes here: 4:4:4, 4:2:2 and 4:2:0, grey, progressive,
  ``optimize=True``, restart markers, Adobe CMYK, RGB without the YCbCr
  transform, 16-bit quantisation tables (SOF1), every quality 1-100 (drawn
  by hypothesis under a fixed seed), odd sizes and sizes that are not a
  multiple of the MCU down to 1x1;
* frames PIL cannot write, made by a small baseline encoder here from
  random quantised coefficients: h1v2 and other sampling ratios (box
  replication, narrow chroma planes), colour spaces told by component ids
  and Adobe transforms (RGB, YCbCr, YCCK, CMYK), one scan a component with
  tables and restart intervals redefined between scans, and no DHT at all
  (libjpeg's standard tables);
* every committed fixture of ``tests/data_torch_jpeg`` (the card's machine
  reads them without PIL), against PIL and the manifest's digests;
* refused formats and truncated or corrupt data raise a RuntimeError that
  names the file (the formats it cannot read also name the sidecar tool,
  which writes PIL's array for them), and a missing library raises too:
  the loader never falls back to PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.utils import jpeg
from contrastiveseg_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

FIXTURES = Path(__file__).resolve().parent / "data_torch_jpeg"


def scene(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Smooth regions with hard edges and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 128 + 70 * np.sin(xx[..., None] / (5 + 3 * np.arange(channels))
                            + yy[..., None] / (9 + np.arange(channels)))
    for _ in range(5):
        y0, x0, r = rng.integers(0, h), rng.integers(0, w), rng.integers(2, max(3, min(h, w)))
        img[(yy - y0) ** 2 + (xx - x0) ** 2 < r * r] = rng.integers(0, 256, channels)
    img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def pil_bytes(a: np.ndarray, mode=None, fmt: str = "JPEG", **save) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, fmt, **save)
    return buf.getvalue()


def assert_same_as_pil(data: bytes, what: str) -> None:
    for rgb in (False, True):
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB")) if rgb else np.asarray(im)
        got = decode_jpeg(data, rgb)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), (what, rgb)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} rgb={rgb}")


# --- frames PIL writes --------------------------------------------------------

SIZES = ((1, 1), (1, 2), (2, 1), (3, 5), (7, 9), (8, 8), (9, 17), (16, 16), (17, 33), (37, 61))
PIL_CASES = {
    "444": (3, None, {"quality": 90, "subsampling": "4:4:4"}),
    "422": (3, None, {"quality": 90, "subsampling": "4:2:2"}),
    "420": (3, None, {"quality": 90, "subsampling": "4:2:0"}),
    "grey": (1, None, {"quality": 80}),
    "progressive_420": (3, None, {"quality": 75, "progressive": True}),
    "progressive_444_optimized": (3, None, {"quality": 85, "progressive": True,
                                            "subsampling": "4:4:4", "optimize": True}),
    "progressive_grey": (1, None, {"quality": 70, "progressive": True}),
    "optimized_422": (3, None, {"quality": 85, "subsampling": "4:2:2", "optimize": True}),
    "restart_blocks_444": (3, None, {"quality": 85, "subsampling": "4:4:4",
                                     "restart_marker_blocks": 3}),
    "restart_rows_420": (3, None, {"quality": 85, "restart_marker_rows": 1}),
    "restart_progressive": (3, None, {"quality": 85, "progressive": True,
                                      "restart_marker_blocks": 2}),
    "adobe_cmyk": (4, "CMYK", {"quality": 85}),
    "rgb_without_transform": (3, None, {"quality": 85, "keep_rgb": True}),
    "qtables_16bit_sof1": (3, None, {"qtables": [[300 + i for i in range(64)], [1000] * 64]}),
}


@pytest.mark.parametrize("case", PIL_CASES)
def test_native_decoder_equals_pil(case):
    channels, mode, save = PIL_CASES[case]
    for i, (h, w) in enumerate(SIZES + ((75, 101),)):
        data = pil_bytes(scene(h, w, channels, i), mode, **save)
        assert_same_as_pil(data, f"{case} {h}x{w}")
    if case == "qtables_16bit_sof1":
        assert b"\xff\xc1" in data and data[data.index(b"\xff\xdb") + 4] >> 4 == 1


@settings(max_examples=40, derandomize=True, deadline=None)
@given(quality=st.integers(1, 100), subsampling=st.sampled_from(["4:4:4", "4:2:2", "4:2:0"]),
       h=st.integers(1, 48), w=st.integers(1, 48), progressive=st.booleans())
def test_every_quality_equals_pil(quality, subsampling, h, w, progressive):
    data = pil_bytes(scene(h, w, 3, quality), quality=quality, subsampling=subsampling,
                     progressive=progressive)
    assert_same_as_pil(data, f"q{quality} {subsampling} {h}x{w} progressive={progressive}")


# --- frames PIL cannot write: a baseline encoder of quantised coefficients ----

def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _standard_tables() -> bytes:
    """The DHT segments of a non-optimised PIL JPEG: libjpeg's standard tables."""
    data, out, i = pil_bytes(np.zeros((8, 8, 3), np.uint8)), b"", 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out += data[i:i + 2 + n] if data[i + 1] == 0xC4 else b""
        i += 2 + n
    return out


def _codes(dht: bytes) -> dict:
    """{class/index byte: {symbol: (code, length)}} of DHT segments."""
    out, i = {}, 0
    while i < len(dht):
        end, i = i + 2 + int.from_bytes(dht[i + 2:i + 4], "big"), i + 4
        while i < end:
            bits = dht[i + 1:i + 17]
            vals = dht[i + 17:i + 17 + sum(bits)]
            code, k, table = 0, 0, {}
            for length, n in enumerate(bits, 1):
                for _ in range(n):
                    table[vals[k]] = (code, length)
                    code, k = code + 1, k + 1
                code <<= 1
            out[dht[i]] = table
            i += 17 + sum(bits)
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc, self.n = (self.acc << 1) | ((value >> i) & 1), self.n + 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes([self.acc])
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _put_block(bits: _Bits, zz, pred: int, dc: dict, ac: dict) -> int:
    diff = int(zz[0]) - pred
    s = abs(diff).bit_length()
    bits.put(*dc[s])
    bits.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
    run = 0
    for v in (int(x) for x in zz[1:]):
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        s = abs(v).bit_length()
        bits.put(*ac[(run << 4) | s])
        bits.put(v if v >= 0 else v + (1 << s) - 1, s)
        run = 0
    if run:
        bits.put(*ac[0x00])
    return int(zz[0])


def encode(width: int, height: int, comps, seed: int = 0, app: bytes = b"",
           scans=None, restart=0, dht: bool = True, qbits: int = 8,
           between: dict | None = None) -> bytes:
    """A sequential Huffman JPEG of random quantised coefficients: ``comps``
    are (id, h, v, quantisation table); ``scans`` lists the component
    indexes of each scan (default: one interleaved scan); ``restart`` is the
    restart interval, or one for each scan (a DRI before each scan that
    changes it); ``between`` maps a scan's index to the segments written
    before it (a DQT or DHT there changes a table for later scans only);
    component 0 codes with tables 0, the others with tables 1.  The
    coefficients stay inside what an encoder of 8-bit samples makes."""
    rng = np.random.default_rng(seed)
    big = 1 if qbits == 8 else 40  # the quantisation step
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    coef = []
    for _, h, v, _ in comps:
        c = np.zeros((mcuy * v, mcux * h, 64), np.int64)
        c[..., 0] = rng.integers(-60 // big, 60 // big + 1, c.shape[:2])
        c[..., 1:10] = rng.integers(-4 // big - 1, 4 // big + 2, c.shape[:2] + (9,)) * (
            rng.random(c.shape[:2] + (9,)) < .6)
        c[..., 10:] = rng.integers(-2 // big - 1, 2 // big + 2, c.shape[:2] + (54,)) * (
            rng.random(c.shape[:2] + (54,)) < .1)
        coef.append(c)
    q = (np.arange(64) % 7 + 2) * big
    std = _standard_tables()
    codes = _codes(std)
    out = b"\xff\xd8" + app
    for t in sorted({c[3] for c in comps}):
        out += _segment(0xDB, bytes([(qbits // 16) << 4 | t]) + b"".join(
            int(x + t).to_bytes(qbits // 8, "big") for x in q))
    out += _segment(0xC1 if qbits == 16 else 0xC0, bytes([8]) + height.to_bytes(2, "big")
                    + width.to_bytes(2, "big") + bytes([len(comps)]) + b"".join(
                        bytes([i, h << 4 | v, t]) for i, h, v, t in comps))
    out += std if dht else b""
    scans = scans or [list(range(len(comps)))]
    restarts, interval = restart if isinstance(restart, tuple) else (restart,) * len(scans), 0
    for n, scan in enumerate(scans):
        out += (between or {}).get(n, b"")
        if restarts[n] != interval:
            interval = restarts[n]
            out += _segment(0xDD, interval.to_bytes(2, "big"))
        restart = interval
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([comps[k][0], 0 if k == 0 else 0x11]) for k in scan) + b"\x00\x3f\x00")
        if len(scan) > 1:
            grid = [(my, mx, [(k, my * comps[k][2] + by, mx * comps[k][1] + bx)
                              for k in scan for by in range(comps[k][2])
                              for bx in range(comps[k][1])])
                    for my in range(mcuy) for mx in range(mcux)]
        else:
            k, (_, h, v, _) = scan[0], comps[scan[0]]
            bh, bw = -(-(-(-height * v // vmax)) // 8), -(-(-(-width * h // hmax)) // 8)
            grid = [(by, bx, [(k, by, bx)]) for by in range(bh) for bx in range(bw)]
        bits, pred, rst = _Bits(), dict.fromkeys(scan, 0), 0
        for i, (_, _, blocks) in enumerate(grid):
            if restart and i and i % restart == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + rst])
                bits, pred, rst = _Bits(), dict.fromkeys(scan, 0), (rst + 1) & 7
            for k, by, bx in blocks:
                t = 0 if k == 0 else 1
                pred[k] = _put_block(bits, coef[k][by, bx], pred[k], codes[t], codes[0x10 | t])
        out += bits.flush()
    return out + b"\xff\xd9"


JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def _ycc(*sampling):
    return [(i + 1, h, v, min(i, 1)) for i, (h, v) in enumerate(sampling)]


def _redefined_tables() -> bytes:
    q = bytes([1]) + bytes(range(3, 67))  # table 1, for the components of later scans
    return _segment(0xDB, q) + _standard_tables()


CRAFTED = {
    "h1v2": lambda: encode(37, 29, _ycc((1, 2), (1, 1), (1, 1)), app=JFIF),
    "h4v1_box": lambda: encode(45, 19, _ycc((4, 1), (1, 1), (1, 1)), app=JFIF),
    "h2v2_h1v2_mixed": lambda: encode(41, 23, _ycc((2, 2), (1, 1), (2, 1)), app=JFIF),
    "h2v2_narrow_box": lambda: encode(3, 21, _ycc((2, 2), (1, 1), (1, 1)), app=JFIF),
    "h2v1_narrow_box": lambda: encode(4, 9, _ycc((2, 1), (1, 1), (1, 1)), app=JFIF),
    "h2v2_grey_sampling": lambda: encode(19, 13, [(1, 2, 2, 0)]),
    "rgb_by_ids": lambda: encode(21, 14, [(82, 1, 1, 0), (71, 1, 1, 1), (66, 1, 1, 1)]),
    "rgb_by_adobe_0": lambda: encode(21, 14, _ycc((1, 1), (1, 1), (1, 1)), app=adobe(0)),
    "ycc_by_adobe_1": lambda: encode(21, 14, [(0, 1, 1, 0), (5, 1, 1, 1), (9, 1, 1, 1)],
                                     app=adobe(1)),
    "ycc_by_unknown_ids": lambda: encode(21, 14, [(0, 1, 1, 0), (1, 1, 1, 1), (2, 1, 1, 1)]),
    "ycck_adobe_2": lambda: encode(27, 18, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1),
                                            (4, 2, 2, 0)], app=adobe(2)),
    "cmyk_no_adobe": lambda: encode(27, 18, [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1),
                                             (4, 1, 1, 0)]),
    "scan_a_component_tables_between": lambda: encode(
        43, 27, _ycc((2, 2), (1, 1), (1, 1)), app=JFIF, scans=[[0], [1], [2]], restart=(7, 0, 5),
        between={1: _segment(0xDB, bytes([0]) + bytes(range(90, 154))),
                 2: _redefined_tables()}),
    "no_dht_standard_tables": lambda: encode(33, 17, _ycc((2, 1), (1, 1), (1, 1)), app=JFIF,
                                             dht=False),
    "qtables_16bit_restarts": lambda: encode(30, 22, _ycc((2, 2), (1, 1), (1, 1)), app=JFIF,
                                             qbits=16, restart=2),
}


@pytest.mark.parametrize("case", CRAFTED)
def test_crafted_frames_equal_pil(case):
    assert_same_as_pil(CRAFTED[case](), case)


# --- the committed fixtures -----------------------------------------------------

def test_fixtures_equal_pil_and_the_manifest():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    files = manifest["files"]
    assert sorted(files) == sorted(p.name for p in FIXTURES.glob("*.jpg")) and len(files) == 8
    assert sum(f["bytes"] for f in files.values()) < 1 << 20
    for name, f in files.items():
        path = FIXTURES / name
        assert path.stat().st_size == f["bytes"]
        for rgb, shape, digest in ((False, "shape", "sha256"), (True, "shape_rgb", "sha256_rgb")):
            with Image.open(path) as im:
                want = np.asarray(im.convert("RGB")) if rgb else np.asarray(im)
            got = read_jpeg(path, rgb=rgb)
            assert got.dtype == want.dtype == np.uint8 and list(got.shape) == f[shape], name
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert hashlib.sha256(want.tobytes()).hexdigest() == f[digest], name


# --- refusals -------------------------------------------------------------------

def _base() -> bytes:
    return pil_bytes(scene(24, 40, 3, 7), quality=80)


def _replace_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def _first_scans(data: bytes, n: int) -> bytes:
    """A progressive file cut after its first ``n`` scans, with an EOI."""
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:starts[n]] + b"\xff\xd9"


REFUSED = {  # name: (bytes, names the sidecar tool)
    "arithmetic_sof9": (lambda: _replace_sof(_base(), 0xC9), True),
    "lossless_sof3": (lambda: _replace_sof(_base(), 0xC3), True),
    "hierarchical_sof5": (lambda: _replace_sof(_base(), 0xC5), True),
    "precision_12": (lambda: (lambda d: d[:d.index(b"\xff\xc0") + 4] + b"\x0c"
                              + d[d.index(b"\xff\xc0") + 5:])(_base()), True),
    "two_components": (lambda: encode(16, 16, [(1, 1, 1, 0), (2, 1, 1, 1)]), True),
    "fractional_sampling": (lambda: encode(16, 16, _ycc((3, 1), (2, 1), (1, 1))), True),
    "progressive_incomplete": (lambda: _first_scans(
        pil_bytes(scene(40, 48, 3, 2), progressive=True), 2), True),
    "truncated": (lambda: _base()[:len(_base()) // 2], False),
    "no_eoi": (lambda: _base()[:-2], False),
    "corrupt_marker_in_scan": (lambda: (lambda d: d[:len(d) - 40] + b"\xff\xd5"
                                        + d[len(d) - 40:])(_base()), False),
    "not_a_jpeg": (lambda: b"\x89PNG\r\n\x1a\n" + bytes(40), False),
}


@pytest.mark.parametrize("case", REFUSED)
def test_refused_and_broken_files_raise(case, tmp_path):
    data, tool = REFUSED[case][0](), REFUSED[case][1]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(RuntimeError, match=f"{case}\\.jpg") as err:
        read_jpeg(path, rgb=True)
    assert (jpeg.SIDECAR_TOOL in str(err.value)) == tool, str(err.value)
    if case in ("truncated", "two_components", "precision_12"):
        with pytest.raises((OSError, SyntaxError)):  # PIL refuses them too
            with Image.open(path) as im:
                im.load()


def test_the_sidecar_tool_writes_what_the_decoder_refuses(tmp_path, monkeypatch):
    """A progressive frame cut after two scans (libjpeg smooths its blocks):
    the loader refuses it, ``tools/cache_dataset_torch.py`` writes PIL's
    array as its sidecar, and the loader then reads that, PIL unimportable."""
    from contrastiveseg_tpu_torch.data.datasets import DirectorySegDataset
    from tools import cache_dataset_torch

    for kind in ("image", "label"):
        (tmp_path / "train" / kind).mkdir(parents=True)
    path = tmp_path / "train" / "image" / "f0.jpg"
    path.write_bytes(_first_scans(pil_bytes(scene(40, 48, 3, 2), progressive=True), 2))
    (tmp_path / "train" / "label" / "f0.png").write_bytes(
        pil_bytes(np.ones((40, 48), np.uint8), fmt="PNG"))
    ds = DirectorySegDataset(str(tmp_path), "train")
    with pytest.raises(jpeg.UnsupportedJPEG, match=r"f0\.jpg.*incomplete scans"):
        ds[0]
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    cache_dataset_torch.main(["--root", str(tmp_path), "--splits", "train"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(ds[0]["image"], want)


def test_no_library_no_fallback(tmp_path, monkeypatch):
    broken = native.SegdataLibrary(tmp_path / "build", tmp_path / "missing.cpp",
                                   native.JPEG_SIGNATURES, stem="libjpegdecode", fallback="none")
    monkeypatch.setattr(native, "JPEG_LIBRARY", broken)
    path = tmp_path / "frame.jpg"
    path.write_bytes(_base())
    with pytest.raises(RuntimeError, match=r"frame\.jpg.*JPEG library"):
        read_jpeg(path)
    assert broken.fallbacks == 1 and broken.route() == "none"
