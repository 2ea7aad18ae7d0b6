"""Synthetic segmentation data, ImageNet normalization and batch stacking.

Counterpart of ``SyntheticSegDataset`` (``contrastiveseg_tpu/data/datasets.py``
:221-261) and of the normalize + collate steps of the JAX data pipeline,
carried here because ``contrastiveseg_tpu.data`` imports jax.  Scenes are
Voronoi class regions with per-class colours plus noise, made from a seed
with numpy, sample for sample the same as the JAX package's.  Train-time
augmentation and the val transforms are not ported yet (ROADMAP 9, data
pipeline): the synthetic size is the model's input size, for training and
validation alike.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class SyntheticSegDataset:
    """Procedural scenes: smooth class regions + matching image statistics."""

    def __init__(self, num_classes: int = 19, size_hw=(512, 1024),
                 length: int = 64, seed: int = 0):
        self.num_classes = num_classes
        self.size_hw = tuple(size_hw)
        self.length = length
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.size_hw
        k = min(self.num_classes * 2, 40)
        cy = rng.uniform(0, h, size=k)
        cx = rng.uniform(0, w, size=k)
        cc = rng.integers(0, self.num_classes, size=k)
        yy, xx = np.mgrid[0:h, 0:w]
        d = (yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2
        label = cc[np.argmin(d, axis=0)].astype(np.int32)
        palette = rng.uniform(0, 255, size=(self.num_classes, 3))
        image = palette[label] + rng.normal(0, 20, size=(h, w, 3))
        image = np.clip(image, 0, 255).astype(np.uint8)
        return {"image": image, "label": label}


def normalize(image: np.ndarray, div_value: float = 255.0,
              mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """uint8 HWC -> float32 HWC: divide, subtract the mean, divide by std."""
    x = image.astype(np.float32) / div_value
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def collate(samples: list[dict], normalize_cfg: dict | None = None) -> dict:
    """Stack samples into {"image": [B, H, W, 3] float32, "label": [B, H, W]
    int64} CPU tensors."""
    n = normalize_cfg or {}
    images = np.stack([
        normalize(s["image"], n.get("div_value", 255.0),
                  n.get("mean_value", IMAGENET_MEAN), n.get("std", IMAGENET_STD))
        for s in samples])
    labels = np.stack([s["label"] for s in samples]).astype(np.int64)
    return {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}


def synthetic_dataset(cfg) -> SyntheticSegDataset:
    h, w = cfg.get("data.synthetic_size", default=[512, 1024])
    return SyntheticSegDataset(num_classes=cfg.get("data.num_classes"),
                               size_hw=(h, w),
                               length=cfg.get("data.synthetic_length", default=64))


def synthetic_batches(cfg, batch_size: int, start: int = 0):
    """Endless batches of ``data.synthetic_size`` scenes, in index order from
    sample ``start`` (a resumed run starts where the saved one stopped)."""
    ds = synthetic_dataset(cfg)
    norm = cfg.get("normalize", default={})
    i = start
    while True:
        yield collate([ds[(i + b) % len(ds)] for b in range(batch_size)], norm)
        i += batch_size


def synthetic_val_batches(cfg):
    """One pass over the synthetic scenes in ``val.batch_size`` batches, the
    last one short if need be (the JAX val pipeline keeps it too)."""
    ds = synthetic_dataset(cfg)
    norm = cfg.get("normalize", default={})
    bs = cfg.get("val.batch_size", default=1)
    for i in range(0, len(ds), bs):
        yield collate([ds[j] for j in range(i, min(i + bs, len(ds)))], norm)
