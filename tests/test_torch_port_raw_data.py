"""Training data without sidecars and without PIL, the sidecar tool, and the
LIP loader, against the JAX package.

* A Cityscapes-layout tree of PNGs, written with every row filter
  (``utils/png.filter_rows``), is read by the port's loader with PIL made
  unimportable: the samples equal the JAX loader's (which decodes through
  PIL), array for array.  A JPEG frame without a sidecar decodes through
  the port's native decoder (``utils/jpeg.py``), PIL unimportable too,
  into the JAX loader's sample.
* ``tools/cache_dataset_torch.py`` writes the sidecars that
  ``tools/cache_dataset.py`` writes on the same tree (PNG RGB and palette
  frames, grey and 16-bit labels, a JPEG), file for file, array for array.
* ``LipDataset`` (``data.loader=lip``) against the JAX one: samples with
  their ``maskmap`` edge target, and the collated batches of the
  ``lip_hrnet_w48`` recipe (flip with the L/R swap, resize, scale jitter,
  crop, brightness) at a small size, labels and edges bit for bit, images
  within one uint8 step (the two packages' segdata builds may round a
  bicubic tap apart, as in ``tests/test_torch_port_data.py``).
"""

from __future__ import annotations

import shutil
import sys

import numpy as np
from PIL import Image

from contrastiveseg_tpu.data.datasets import build_dataset as jbuild_dataset
from contrastiveseg_tpu.data.loaders_extra import label_to_edge as jlabel_to_edge
from contrastiveseg_tpu.data.pipeline import build_pipeline as jbuild_pipeline
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.data.datasets import LipDataset, build_dataset, label_to_edge
from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.png import encode_png
from tools import cache_dataset as jcache_tool
from tools import cache_dataset_torch as cache_tool

STD = (0.229, 0.224, 0.225)
IMAGE_ATOL = 1.0 / (255 * min(STD)) + 1e-6  # one uint8 step, normalised
FILTERS = (0, 1, 2, 3, 4)


def _scene(rng, h, w, classes):
    cy, cx = rng.uniform(0, h, 6), rng.uniform(0, w, 6)
    yy, xx = np.mgrid[0:h, 0:w]
    near = np.argmin((yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2,
                     axis=0)
    label = np.asarray(classes)[rng.integers(0, len(classes), 6)][near].astype(np.uint8)
    image = np.clip(rng.uniform(0, 255, 3) + rng.normal(0, 30, (h, w, 3)), 0, 255)
    return image.astype(np.uint8), label


def _write_tree(root, n=(4, 2), hw=(40, 56), classes=(0, 7, 8, 11, 26), seed=0):
    """{root}/{train,val}/image|label/*.png, every row filter in each file."""
    rng = np.random.default_rng(seed)
    for split, count in zip(("train", "val"), n):
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True)
        for i in range(count):
            image, label = _scene(rng, *hw, classes)
            (root / split / "image" / f"f{i}.png").write_bytes(encode_png(image, 1, FILTERS))
            (root / split / "label" / f"f{i}.png").write_bytes(encode_png(label, 1, FILTERS))
    return root


def _block_pil(monkeypatch) -> None:
    """PIL unimportable, as on a machine without it (``monkeypatch.undo()``
    brings it back)."""
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _same_samples(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in set(got) - {"meta"}:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["meta"]["ori_target"], want["meta"]["ori_target"])


def test_png_tree_decodes_without_pil(tmp_path, monkeypatch):
    root = _write_tree(tmp_path / "cs")
    jpeg = root / "train" / "image" / "f9.jpg"
    Image.fromarray(_scene(np.random.default_rng(5), 40, 56, (7,))[0]).save(jpeg, quality=90)
    shutil.copy(root / "train" / "label" / "f0.png", root / "train" / "label" / "f9.png")
    cfg, jcfg = (get("cityscapes_hrnet_w48_mem").updated("data.data_dir", str(root))
                 for get in (get_preset, jget_preset))
    jds = jbuild_dataset(jcfg, "train")
    want = [jds[i] for i in range(len(jds))]  # decoded by PIL
    _block_pil(monkeypatch)
    ds = build_dataset(cfg, "train")
    assert [p for p, _ in ds.items] == [p for p, _ in jds.items] and ds.items[-1][0] == str(jpeg)
    n_fallbacks = native.PNG_LIBRARY.fallbacks, native.JPEG_LIBRARY.fallbacks
    for i in range(len(ds)):  # the JPEG last, through the native decoder
        _same_samples(ds[i], want[i])
    assert (native.PNG_LIBRARY.fallbacks, native.JPEG_LIBRARY.fallbacks) == n_fallbacks
    assert sys.modules["PIL"] is None


def test_sidecar_tool_matches_the_jax_tool(tmp_path, monkeypatch):
    root = _write_tree(tmp_path / "a", n=(2, 1))
    rng = np.random.default_rng(1)
    lab = root / "train" / "label"
    Image.fromarray(rng.integers(0, 4, (40, 56), dtype=np.uint8), "P").save(
        root / "train" / "image" / "f9.png")  # a palette image frame
    (lab / "f9.png").write_bytes(encode_png(rng.integers(0, 60000, (40, 56)).astype(np.uint16)))
    Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(
        root / "val" / "image" / "f5.jpg")
    (root / "val" / "label" / "f5.png").write_bytes(encode_png(np.full((40, 56), 7, np.uint8)))
    other = tmp_path / "b"
    shutil.copytree(root, other)
    monkeypatch.setattr(sys, "argv", ["cache_dataset.py", "--root", str(root)])
    jcache_tool.main()
    cache_tool.main(["--root", str(other)])
    want = sorted(p.relative_to(root) for p in root.rglob("*.npy"))
    assert sorted(p.relative_to(other) for p in other.rglob("*.npy")) == want and len(want) == 10
    for rel in want:
        a, b = np.load(other / rel), np.load(root / rel)
        assert a.dtype == b.dtype and a.shape == b.shape, rel
        np.testing.assert_array_equal(a, b, err_msg=str(rel))
    assert cache_tool.cache_tree(str(other), ["train", "val"]) == (0, 10)  # all fresh now


def _lip_configs(root):
    over = {"data.data_dir": str(root), "data.workers": 0, "train.batch_size": 2,
            "train.data_transformer.input_size": [48, 48],
            "train_trans.resize.target_size": [48, 48],
            "train_trans.random_crop.crop_size": [40, 40], "val.batch_size": 2,
            "val.data_transformer.input_size": [56, 40]}
    cfg, jcfg = get_preset("lip_hrnet_w48"), jget_preset("lip_hrnet_w48")
    for k, v in over.items():
        cfg, jcfg = cfg.updated(k, v), jcfg.updated(k, v)
    return cfg, jcfg


def test_lip_dataset_and_batches_match_jax(tmp_path):
    root = _write_tree(tmp_path / "lip", classes=tuple(range(20)), seed=2)
    cfg, jcfg = _lip_configs(root)
    ds, jds = build_dataset(cfg, "train"), jbuild_dataset(jcfg, "train")
    assert isinstance(ds, LipDataset) and type(jds).__name__ == "LipDataset"
    for i in range(len(ds)):
        s = ds[i]
        _same_samples(s, jds[i])
        assert s["maskmap"].any() and (s["maskmap"] == label_to_edge(s["label"])).all()
    lab = np.random.default_rng(0).integers(-1, 3, (9, 11))
    np.testing.assert_array_equal(label_to_edge(lab), jlabel_to_edge(lab))
    for split in ("train", "val"):
        pipe, jpipe = build_pipeline(cfg, split), jbuild_pipeline(jcfg, split)
        pipe.seed = jpipe.seed = 3
        for got, want in zip(pipe.epoch_iter(0), jpipe.epoch_iter(0)):
            assert set(got) == set(want) and "maskmap" in got
            for k in ("label", "maskmap"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split} {k}")
            assert np.abs(got["image"] - want["image"]).max() <= IMAGE_ATOL
