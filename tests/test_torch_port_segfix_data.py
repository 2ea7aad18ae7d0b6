"""SegFix's data side and offline tools in the port against the JAX package:
numpy and scipy on the host in both, so every comparison is exact.

* ``utils/offset_helper.py`` (the port's copy): every function on a sweep
  of angles, directions and offsets, at 4, 8 (and its axis-aligned 4), 16
  and 32 directions.
* ``data/loaders_extra.compute_dt_targets`` and ``DTOffsetDataset``
  through ``build_dataset`` (``data.loader=dt_offset``), from a
  Cityscapes-layout tree whose ``instance/`` maps are 16-bit PNGs with two
  touching instances of one class, written by the port's PNG writer with
  every row filter: the distance, angle, mask and direction maps bit for
  bit, with ``data.dt_boundary`` ``label`` and ``instance`` (a frame without
  an instance file falls back to its label).  The 16-bit maps read the same
  through the native unfilter, its Python version and PIL.
* ``MultiDataset`` (``data.data_dirs``): ``balanced_indices``, the samples'
  ``dataset_index`` and the pipeline's epoch order, equal to JAX's.
* ``tools/segfix_torch.py`` against ``tools/segfix.py``: each function, then
  the CLI over a directory (``.npz`` directions with a mask, ``.npz``
  offsets and a ``.mat``; both ``--interp`` modes; train ids and raw
  Cityscapes ids; the instance mode), the PNGs read back and compared.
  ``grid_sample_shift`` (``F.grid_sample`` in float64 against
  ``ndimage.map_coordinates``) agrees to 1e-12 absolute (read: 1.1e-13 on
  0-18 valued maps).  Its rounded labels and thresholded masks equal the
  JAX tool's float samples with their halves snapped (``snap_halves``),
  rounded half to even: exactly the JAX tool's output but at exact ties,
  which integer offsets make common and where the JAX tool's float sample
  falls a few ulps either side.
* ``metrics/instance_ap.py`` (the port's copy): the AP of SegFix-shifted
  instance masks and of connected components, equal to the original's.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
from PIL import Image

from contrastiveseg_tpu.data import loaders_extra as jle
from contrastiveseg_tpu.data.datasets import build_dataset as jbuild_dataset
from contrastiveseg_tpu.data.pipeline import DataPipeline as JDataPipeline
from contrastiveseg_tpu.metrics import instance_ap as jap
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import offset_helper as joh
from contrastiveseg_tpu_torch.data import loaders_extra as le
from contrastiveseg_tpu_torch.data.datasets import build_dataset
from contrastiveseg_tpu_torch.data.pipeline import DataPipeline
from contrastiveseg_tpu_torch.metrics import instance_ap as ap
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils import offset_helper as oh
from contrastiveseg_tpu_torch.utils import png

from torch_port_helpers import write_tree

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import segfix as jtool  # noqa: E402
import segfix_torch as tool  # noqa: E402

CAR = 26


def _same(a, b, what=""):
    if isinstance(a, tuple):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_offset_helper_copy_matches_jax():
    rng = np.random.default_rng(0)
    angles = np.concatenate([rng.uniform(-180, 180, 4000),
                             np.arange(-180, 180, 11.25)]).reshape(-1, 8)
    for n, axis in ((4, False), (4, True), (8, False), (16, False), (32, False)):
        cfg, jcfg = oh.DTOffsetConfig(n, c4_align_axis=axis), joh.DTOffsetConfig(
            n, c4_align_axis=axis)
        _same(oh.align_angle(angles, n, axis), joh.align_angle(angles, n, axis), f"align {n}")
        labels = rng.integers(-1, n + 2, (40, 30))
        _same(oh.label_to_vector(labels, cfg), joh.label_to_vector(labels, jcfg), f"l2v {n}")
        vec = rng.integers(-4, 5, (40, 30, 2))
        _same(oh.vector_to_label(vec, cfg), joh.vector_to_label(vec, jcfg), f"v2l {n}")
        seg = rng.integers(-1, 3, angles.shape)
        dist = rng.uniform(0, 9, angles.shape).astype(np.float32)
        extra = rng.random(angles.shape) < 0.1
        _same(oh.distance_to_mask_label(dist, seg, cfg),
              joh.distance_to_mask_label(dist, seg, jcfg), f"mask {n}")
        _same(oh.angle_to_direction_label(angles, seg, dist, extra, cfg),
              joh.angle_to_direction_label(angles, seg, dist, extra, jcfg), f"dir {n}")
    for k in (3, 11):
        _same(oh.sobel_kernel(k), joh.sobel_kernel(k), f"sobel {k}")
    packed = rng.integers(0, 256, (20, 30))
    _same(oh.encode_multi_labels(packed), joh.encode_multi_labels(packed))
    logits = rng.standard_normal((20, 30, 8)).astype(np.float32)
    no_offset = rng.random((20, 30)) < 0.3
    for topk in (8, 3):
        _same(oh.multilabel_direction_prediction(logits, no_offset, topk),
              joh.multilabel_direction_prediction(logits, no_offset, topk), f"ml {topk}")
    with pytest.raises(AssertionError):
        oh.DTOffsetConfig(num_classes=6)


def _add_instances(tree: Path, filters) -> None:
    """16-bit instance maps for the train frames but the last: each class
    region its own id (class * 1000), the left half of every car region a
    second car touching the first."""
    names = sorted(p.stem for p in (tree / "train" / "label").iterdir())
    (tree / "train" / "instance").mkdir()
    for name in names[:-1]:
        raw = np.asarray(Image.open(tree / "train" / "label" / f"{name}.png")).astype(np.uint16)
        raw[:, : raw.shape[1] // 2][raw[:, : raw.shape[1] // 2] == 7] = CAR
        inst = raw * 1000
        left = inst[:, : inst.shape[1] // 2]
        left[left == CAR * 1000] = CAR * 1000 + 1
        (tree / "train" / "instance" / f"{name}.png").write_bytes(
            png.encode_png(inst, level=1, filters=filters))


@pytest.mark.parametrize("boundary", ["label", "instance"])
def test_dt_offset_dataset_matches_jax(tmp_path, boundary):
    tree = write_tree(tmp_path / "cityscapes", n_train=3, n_val=0, hw=(48, 64), seed=2)
    _add_instances(tree, filters=(0, 1, 2, 3, 4))
    over = {"data.synthetic": False, "data.data_dir": str(tree), "data.loader": "dt_offset",
            "data.dt_boundary": boundary}
    cfg, jcfg = get_preset("cityscapes_segfix_hrnet"), jget_preset("cityscapes_segfix_hrnet")
    for k, v in over.items():
        cfg, jcfg = cfg.updated(k, v), jcfg.updated(k, v)
    ds, jds = build_dataset(cfg, "train"), jbuild_dataset(jcfg, "train")
    assert type(ds) is le.DTOffsetDataset and ds.boundary_source == boundary
    assert ds.dt_config == oh.DTOffsetConfig(8, 5.0)
    keys = ("image", "label", "distance_map", "angle_map", "mask_label", "dir_label")
    for i in range(len(ds)):
        s, js = ds[i], jds[i]
        for k in keys:
            _same(s[k], js[k], f"{i} {k}")
        assert (s["mask_label"] == 1).any() and (s["dir_label"] >= 0).any()
        assert s["meta"]["name"] == js["meta"]["name"]
    if boundary == "instance":  # the touching cars add a boundary the label has not
        plain = le.compute_dt_targets(ds[0]["label"])
        assert (ds[0]["mask_label"] == 1).sum() > (plain["mask_label"] == 1).sum()
        path = tree / "train" / "instance" / f"{ds[0]['meta']['name']}.png"
        data = path.read_bytes()
        want = np.asarray(Image.open(path))
        assert want.dtype == np.uint16 and (want == CAR * 1000 + 1).any()
        _same(png.decode_png(data), want)
        h, w = want.shape
        import zlib

        idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
        raw = zlib.decompress(idat)
        rows = png.native.png_unfilter(raw, h, 2 * w, 2)
        assert rows is not None, "the native unfilter did not build"
        _same(rows, png._unfilter(raw, h, 2 * w, 2))
    # compute_dt_targets alone, with a boundary map of its own
    rng = np.random.default_rng(3)
    label = rng.integers(-1, 3, (30, 40)).astype(np.int32)
    bmap = rng.integers(0, 4, (30, 40))
    cfg8 = oh.DTOffsetConfig(16, 3.0)
    got = le.compute_dt_targets(label, cfg8, boundary_map=bmap)
    want = jle.compute_dt_targets(label, joh.DTOffsetConfig(16, 3.0), boundary_map=bmap)
    for k in want:
        _same(got[k], want[k], k)


def test_multi_dataset_matches_jax(tmp_path):
    a = write_tree(tmp_path / "a", n_train=3, n_val=1, hw=(24, 32), seed=1)
    b = write_tree(tmp_path / "b", n_train=5, n_val=1, hw=(24, 32), seed=2)
    cfg = get_preset("segfix_cityscapes_ade20k").updated("data.data_dirs", [str(a), str(b)])
    jcfg = jget_preset("segfix_cityscapes_ade20k").updated("data.data_dirs", [str(a), str(b)])
    cfg, jcfg = (c.updated("data.data_dir", str(a)) for c in (cfg, jcfg))
    ds, jds = build_dataset(cfg, "train"), jbuild_dataset(jcfg, "train")
    assert type(ds) is le.MultiDataset and ds.sizes == jds.sizes == [3, 5] and len(ds) == 8
    assert all(type(d) is le.DTOffsetDataset for d in ds.datasets)
    for epoch in range(3):
        for seed in (0, 7):
            _same(ds.balanced_indices(epoch, seed), jds.balanced_indices(epoch, seed))
    for i in (0, 2, 3, 7):
        s, js = ds[i], jds[i]
        assert s["meta"]["dataset_index"] == js["meta"]["dataset_index"] == int(i >= 3)
        _same(s["dir_label"], js["dir_label"])
    with pytest.raises(IndexError):
        ds[8]
    pipe, jpipe = DataPipeline(ds, 2, seed=4), JDataPipeline(jds, 2, seed=4)
    assert len(pipe) == len(jpipe)
    for epoch in (0, 1):
        _same(pipe._epoch_indices(epoch), jpipe._epoch_indices(epoch))
    plain = le.MultiDataset([list(range(4)), list(range(2))])
    _same(plain.balanced_indices(0), jle.MultiDataset([list(range(4)), list(range(2))])
          .balanced_indices(0))
    assert type(build_dataset(cfg, "val")).__name__ == "DTOffsetDataset"  # data_dirs: train only


def _offset_files(tmp_path, names, hw):
    """Per name: ``.npz`` directions with a mask, ``.npz`` float offsets, or a
    ``.mat``; the last name has none."""
    rng = np.random.default_rng(8)
    d = tmp_path / "offsets"
    d.mkdir()
    for i, name in enumerate(names[:-1]):
        if i % 3 == 0:
            np.savez(d / f"{name}.npz", dir_label=rng.integers(0, 8, hw).astype(np.uint8),
                     mask=rng.integers(0, 2, hw).astype(np.uint8))
        elif i % 3 == 1:
            np.savez(d / f"{name}.npz", offset=rng.normal(0, 2, (*hw, 2)))
        else:
            sio.savemat(d / f"{name}.mat", {"mat": rng.normal(0, 2, (*hw, 2))})
    return d


def _snapped(samples: np.ndarray) -> np.ndarray:
    """The JAX tool's float samples with each value within 1e-9 of a half
    set to it, as exact arithmetic has them."""
    half = np.floor(samples) + 0.5
    return np.where(np.abs(samples - half) < 1e-9, half, samples)


def _ties(samples: np.ndarray) -> np.ndarray:
    return np.abs(samples - np.floor(samples) - 0.5) < 1e-9


def test_segfix_tool_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    label = rng.integers(0, 19, (33, 47))
    off = rng.integers(-3, 4, (33, 47, 2))
    foff = rng.normal(0, 3, (33, 47, 2))
    masks = rng.integers(0, 2, (3, 33, 47))
    n_ties = 0
    for scale in (1, 2):
        _same(tool.apply_offsets(label, off, scale), jtool.apply_offsets(label, off, scale))
        for o in (off, foff):
            want = jtool.grid_sample_shift(label[None], o, scale)
            np.testing.assert_allclose(tool.grid_sample_shift(label[None], o, scale), want,
                                       rtol=0, atol=1e-12)
            got = tool.shift_labels_bilinear(label, o, scale)
            _same(got, np.round(_snapped(want[0])).astype(np.int64))
            off_tie = ~_ties(want[0])
            _same(got[off_tie], jtool.shift_labels_bilinear(label, o, scale)[off_tie])
            n_ties += int((~off_tie).sum())
            want = jtool.grid_sample_shift(masks.astype(np.float64), o, scale)
            _same(tool.shift_instance_masks(masks, o, scale),
                  (_snapped(want) > 0.5).astype(np.uint8))
            _same(tool.shift_instance_masks(masks, o, scale)[~_ties(want)],
                  jtool.shift_instance_masks(masks, o, scale)[~_ties(want)])
    assert n_ties > 0  # integer offsets give exact halves
    raw = np.asarray(tool.RAW_ID_LISTS["cityscapes"] + [0, 1, 255], np.uint8)[
        rng.integers(0, 22, (9, 11))]
    for ds in ("cityscapes", "ade20k"):
        _same(tool.encode_raw_labels(raw, ds), jtool.encode_raw_labels(raw, ds))
        ids = rng.integers(-1, 300, (9, 11))
        _same(tool.decode_raw_labels(ids, ds), jtool.decode_raw_labels(ids, ds))
    assert tool.RAW_ID_LISTS == jtool.RAW_ID_LISTS

    names = [f"frankfurt_000000_{i:06d}_leftImg8bit" for i in range(4)]
    inputs = tmp_path / "labels"
    inputs.mkdir()
    for name in names:
        Image.fromarray(raw.repeat(4, 0).repeat(4, 1)[:33, :41]).save(inputs / f"{name}.png")
    offsets = _offset_files(tmp_path, names, (33, 41))
    for name in names[:3]:
        path = next(offsets.glob(f"{name}.*"))
        for g, w in zip(tool.load_offset(str(path)), jtool.load_offset(str(path))):
            assert (g is None) == (w is None)
            if g is not None:
                _same(g, w, path.name)
    for dataset in ("trainid", "cityscapes"):
        for interp in ("nearest", "bilinear"):
            out = tmp_path / f"{dataset}_{interp}"
            args = ["--input_dir", str(inputs), "--offset_dir", str(offsets), "--interp", interp,
                    "--dataset", dataset, "--device", "cpu"]
            assert tool.main(args + ["--out_dir", str(out / "port")]) == 4
            sys.argv = ["segfix.py"] + args[:-2] + ["--out_dir", str(out / "jax")]
            jtool.main()
            for name in names:
                got = png.read_png(out / "port" / f"{name}.png")
                want = np.asarray(Image.open(out / "jax" / f"{name}.png"))
                if interp == "bilinear":  # the JAX tool's samples, halves snapped
                    lab = np.asarray(Image.open(inputs / f"{name}.png")).astype(np.int64)
                    if dataset != "trainid":
                        lab = jtool.encode_raw_labels(lab, dataset)
                    path = next(offsets.glob(f"{name}.*"), None)
                    if path is not None:
                        o, d = jtool.load_offset(str(path))
                        o = joh.label_to_vector(d).astype(np.float64) if o is None else o
                        lab = np.round(_snapped(jtool.grid_sample_shift(
                            lab[None].astype(np.float64), o, 2.0)[0])).astype(np.int64)
                    if dataset != "trainid":
                        lab = jtool.decode_raw_labels(lab, dataset)
                    assert (got != want).mean() < 0.05, name
                    want = lab.astype(np.uint8)
                _same(got, want, name)
            moved = png.read_png(out / "port" / f"{names[0]}.png")
            assert (moved != png.read_png(inputs / f"{names[0]}.png")).any()

    sub = tmp_path / "instances"
    (sub / "masks").mkdir(parents=True)
    lines = []
    for k in range(2):
        Image.fromarray((masks[k] * 255).astype(np.uint8)).save(sub / "masks" / f"m{k}.png")
        lines.append(f"masks/m{k}.png {CAR} 0.{k + 5}")
    (sub / "f0_pred.txt").write_text("\n".join(lines) + "\n")
    np.savez(tmp_path / "offsets" / "f0.npz", offset=foff)
    (tmp_path / "pi").mkdir()
    (tmp_path / "ji").mkdir()
    assert tool.refine_instances(str(sub), str(tmp_path / "offsets"), str(tmp_path / "pi"),
                                 2.0) == 1
    jtool.refine_instances(str(sub), str(tmp_path / "offsets"), str(tmp_path / "ji"), 2.0)
    for k in range(2):
        _same(png.read_png(tmp_path / "pi" / "masks" / f"m{k}.png"),
              np.asarray(Image.open(tmp_path / "ji" / "masks" / f"m{k}.png")), f"m{k}")
    assert (tmp_path / "pi" / "f0_pred.txt").read_text() == "\n".join(lines) + "\n"
    import torch

    if not torch.cuda.is_available():  # --device defaults to cuda, with no fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--input_dir", str(inputs), "--offset_dir", str(offsets),
                       "--out_dir", str(tmp_path / "cuda")])


def test_instance_ap_copy_matches_jax():
    """Instances shifted along offsets, then scored by both copies; the
    connected components of a semantic map too."""
    rng = np.random.default_rng(12)
    gt = np.full((64, 64), 7, np.int32)
    gt[:, 50:54] = 0
    gt[2:20, 2:20] = CAR * 1000
    gt[2:20, 30:48] = CAR * 1000 + 1
    gt[30:34, 2:6] = CAR * 1000 + 2
    gt[40:60, 40:50] = CAR
    gt[40:60, 4:24] = 24 * 1000
    boxes = [(2, 20, 2, 20, CAR), (2, 20, 2, 20, CAR), (3, 19, 31, 47, CAR),
             (40, 60, 40, 50, CAR), (50, 60, 26, 36, CAR), (24, 36, 50, 54, CAR),
             (41, 60, 5, 22, 24), (0, 10, 56, 64, 24)]
    masks = np.zeros((len(boxes), 64, 64), np.uint8)
    for m, (y0, y1, x0, x1, _) in zip(masks, boxes):
        m[y0:y1, x0:x1] = 1
    shifted = tool.shift_instance_masks(masks, rng.integers(-2, 3, (64, 64, 2)), 1.0)
    preds = [(m.astype(bool), c, float(s)) for m, (*_, c), s in
             zip(shifted, boxes, np.linspace(0.9, 0.3, len(boxes)))]
    evs = [ap.InstanceAPEvaluator(), jap.InstanceAPEvaluator()]
    for ev in evs:
        ev.add_image(gt, preds)
        ev.add_image(gt, preds[::2])
    got, want = (ev.evaluate() for ev in evs)
    np.testing.assert_equal(got, want)
    assert 0 < got["all_ap"] < 1
    seg = np.where(gt >= 1000, gt // 1000, gt)
    probs = rng.random((64, 64))
    for g, w in zip(ap.instances_from_semantic(seg, probs),
                    jap.instances_from_semantic(seg, probs)):
        _same(g[0], w[0])
        assert g[1:] == w[1:]
    assert ap.CITYSCAPES_INSTANCE_IDS == jap.CITYSCAPES_INSTANCE_IDS
    assert ap.CITYSCAPES_VOID_IDS == jap.CITYSCAPES_VOID_IDS
