"""JPEG dataset trees on the port with PIL unimportable, against the JAX
package, which reads the same frames through PIL.

* ADE20K-, COCO-Stuff- and Pascal-Context-layout trees of PIL-written JPEG
  frames (4:2:0 at each dataset's quality, a grey COCO frame, a progressive
  VOC frame; odd sizes) with PNG labels (0-150, 0-171, 0-59 before
  ``reduce_zero_label``): the port's ``build_dataset`` gives the JAX
  loader's samples exactly.
* ``ade20k_hrnet_w48_contrast``'s train pipeline at a 64x64 crop (its scale
  jitter, ``only_pad`` with ``pad_mode: random``) and its ``diverse_size``
  val pipeline: the JAX batches, labels bit for bit, images within the one
  uint8 step of ``tests/test_torch_port_data.py`` (the two packages'
  segdata builds may round a bicubic tap apart).
* One CPU train step of ``ade20k_hrnet_w48_contrast`` from the ADE20K tree
  on a shallow W18 at 64x64 crops: finite losses, a positive contrast term.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
from PIL import Image

from contrastiveseg_tpu.data.datasets import build_dataset as jbuild_dataset
from contrastiveseg_tpu.data.pipeline import build_pipeline as jbuild_pipeline
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.data.datasets import build_dataset
from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.models import hrnet
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.png import encode_png

from torch_port_helpers import one_torch_thread

STD = (0.229, 0.224, 0.225)
IMAGE_ATOL = 1.0 / (255 * min(STD)) + 1e-6  # one uint8 step, normalised
# dataset: its presets' prefix, label values, and each frame's (h, w), mode and save settings
TREES = {
    "ade20k": ("ade20k_hrnet_w48_contrast", 151, [
        ((52, 69), "RGB", {"quality": 90}), ((69, 52), "RGB", {"quality": 90})]),
    "coco_stuff": ("coco_stuff_hrnet_w48_contrast", 172, [
        ((48, 64), "RGB", {"quality": 85}), ((64, 48), "L", {"quality": 85})]),
    "pascal_context": ("pascal_context_hrnet_w48_contrast", 60, [
        ((47, 63), "RGB", {"quality": 75}),
        ((63, 47), "RGB", {"quality": 75, "progressive": True})]),
}


def _write_tree(root, dataset: str, n=(4, 2), seed=0):
    """{root}/{train,val}/image/*.jpg (PIL) and label/*.png, Voronoi scenes."""
    _, classes, frames = TREES[dataset]
    rng = np.random.default_rng(seed)
    for split, count in zip(("train", "val"), n):
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True)
        for i in range(count):
            (h, w), mode, save = frames[i % len(frames)]
            cy, cx = rng.uniform(0, h, 8), rng.uniform(0, w, 8)
            yy, xx = np.mgrid[0:h, 0:w]
            near = np.argmin((yy[None] - cy[:, None, None]) ** 2
                             + (xx[None] - cx[:, None, None]) ** 2, axis=0)
            ids = rng.integers(0, classes, 8)
            ids[0] = 0  # the class reduce_zero_label ignores
            label = ids[near].astype(np.uint8)
            image = np.clip(rng.uniform(0, 255, (8, 3))[near] + rng.normal(0, 12, (h, w, 3)),
                            0, 255).astype(np.uint8)
            Image.fromarray(image[..., 0] if mode == "L" else image, mode).save(
                root / split / "image" / f"f{i}.jpg", "JPEG", **save)
            (root / split / "label" / f"f{i}.png").write_bytes(encode_png(label))
    return root


def _block_pil(monkeypatch) -> None:
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def _configs(preset: str, over: dict):
    cfg, jcfg = get_preset(preset), jget_preset(preset)
    for k, v in over.items():
        cfg, jcfg = cfg.updated(k, v), jcfg.updated(k, v)
    return cfg, jcfg


@pytest.mark.parametrize("dataset", TREES)
def test_jpeg_trees_give_the_jax_samples_without_pil(dataset, tmp_path, monkeypatch):
    root = _write_tree(tmp_path / dataset, dataset)
    cfg, jcfg = _configs(TREES[dataset][0], {"data.data_dir": str(root)})
    assert cfg.get("data.reduce_zero_label") is True
    want = {split: [s for s in jbuild_dataset(jcfg, split)] for split in ("train", "val")}
    _block_pil(monkeypatch)
    fallbacks = native.JPEG_LIBRARY.fallbacks
    for split in ("train", "val"):
        ds = build_dataset(cfg, split)
        assert len(ds) == len(want[split])
        for i, w in enumerate(want[split]):
            got = ds[i]
            assert set(got) == set(w) and got["meta"]["img_path"].endswith(".jpg")
            for k in set(got) - {"meta"}:
                assert got[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(got[k], w[k], err_msg=f"{split} {i} {k}")
            np.testing.assert_array_equal(got["meta"]["ori_target"], w["meta"]["ori_target"])
        assert (np.concatenate([s["label"].ravel() for s in want[split]]) == -1).any()
    assert sys.modules["PIL"] is None and native.JPEG_LIBRARY.fallbacks == fallbacks


def test_ade20k_pipelines_give_the_jax_batches_without_pil(tmp_path, monkeypatch):
    root = _write_tree(tmp_path / "ade20k", "ade20k", n=(6, 2))
    cfg, jcfg = _configs("ade20k_hrnet_w48_contrast", {
        "data.data_dir": str(root), "data.workers": 0, "train.batch_size": 2,
        "val.batch_size": 2, "train.data_transformer.input_size": [64, 64],
        "train_trans.random_crop.crop_size": [64, 64]})
    assert (cfg.get("train.data_transformer.align_method"),
            cfg.get("train.data_transformer.pad_mode"),
            cfg.get("val.data_transformer.size_mode")) == ("only_pad", "random", "diverse_size")
    want = {}
    for split in ("train", "val"):
        jpipe = jbuild_pipeline(jcfg, split)
        jpipe.seed = 3
        want[split] = [list(jpipe.epoch_iter(e)) for e in range(2 if split == "train" else 1)]
    _block_pil(monkeypatch)
    for split in ("train", "val"):
        pipe = build_pipeline(cfg, split)
        pipe.seed = 3
        for epoch, jbatches in enumerate(want[split]):
            batches = list(pipe.epoch_iter(epoch))
            assert len(batches) == len(jbatches) > 0
            for got, w in zip(batches, jbatches):
                images, jimages = got["image"], w["image"]
                if split == "val":  # diverse_size: lists of differently sized frames
                    assert [x.shape for x in images] == [x.shape for x in jimages]
                    images, jimages = (np.concatenate([x.ravel() for x in a])
                                       for a in (images, jimages))
                    labels, jlabels = (np.concatenate([x.ravel() for x in b["label"]])
                                       for b in (got, w))
                else:
                    assert images.shape == (2, 64, 64, 3)
                    labels, jlabels = got["label"], w["label"]
                np.testing.assert_array_equal(labels, jlabels, err_msg=f"{split} {epoch}")
                assert np.abs(images - jimages).max() <= IMAGE_ATOL, (split, epoch)
    assert sys.modules["PIL"] is None


def test_ade20k_contrast_trains_a_step_from_jpeg_without_pil(tmp_path, monkeypatch):
    root = _write_tree(tmp_path / "ade20k", "ade20k")
    monkeypatch.setitem(hrnet.HRNET_SPECS, "hrnet48", hrnet.HRNetSpec(
        64, 1, 64, hrnet.StageSpec(1, 1, (18, 36)), hrnet.StageSpec(1, 1, (18, 36, 72)),
        hrnet.StageSpec(1, 1, (18, 36, 72, 144))))
    cfg, _ = _configs("ade20k_hrnet_w48_contrast", {
        "data.data_dir": str(root), "data.workers": 0, "train.batch_size": 2,
        "train.data_transformer.input_size": [64, 64],
        "train_trans.random_crop.crop_size": [64, 64], "contrast.warmup_iters": 0,
        "contrast.max_views": 10, "solver.max_iters": 1, "solver.display_iter": 1,
        "solver.test_interval": 0, "checkpoints.save_iters": 0,
        "checkpoints.checkpoints_dir": str(tmp_path / "ckpt")})
    _block_pil(monkeypatch)
    with one_torch_thread():
        trainer = Trainer(cfg, "cpu")
        (row,) = trainer.train()
    assert type(trainer.state.model).__name__ == "HRNetSeg" and cfg.get("data.num_classes") == 150
    assert all(np.isfinite(row[k]) for k in ("loss", "loss_seg", "loss_contrast"))
    assert row["loss_contrast"] > 0 and sys.modules["PIL"] is None
