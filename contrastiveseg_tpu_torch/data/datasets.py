"""Datasets: directory-layout loader (reference DefaultLoader) and a
synthetic fixture for tests and benches.

The port's copy of ``contrastiveseg_tpu/data/datasets.py``.  Reference: lib/datasets/loader/default_loader.py — lists
``{root}/{split}/image`` + ``{root}/{split}/label``, optional ``label_list``
remap to train ids (default_loader.py:94-106) and ``reduce_zero_label``
(−1 shift, :83-92).  PIL is imported only to decode an image or label
that has no fresh ``.npy_cache`` sidecar.  ``data.loader=lip|dt_offset``
and ``data.data_dirs`` are not ported yet (ROADMAP 7, other models and
their loaders).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

# Cityscapes raw-id -> train-id list (configs/cityscapes/*.json "label_list").
CITYSCAPES_LABEL_LIST = [
    7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33,
]


def encode_label_map(label: np.ndarray, label_list: Sequence[int]) -> np.ndarray:
    """Raw ids -> train ids; everything else -> 255 (then ReLabel 255->-1).
    Reference `_encode_label` (default_loader.py:94-106)."""
    out = np.full_like(label, 255, dtype=np.int64)
    for train_id, raw_id in enumerate(label_list):
        out[label == raw_id] = train_id
    return out


class DirectorySegDataset:
    """`{root}/{split}/image/*` + `{root}/{split}/label/*` pairs.

    Extra-set merging mirrors the reference's coarse-data training recipes
    (default_loader.py:145-256): for the train split, ``include_val``
    appends the val set (pascal_voc: replaces with trainval),
    ``include_coarse``/``include_atr`` append those label dirs,
    ``only_coarse``/``only_mapillary`` replace the base list entirely.
    Extra sets are listed from the *label* directory like the reference
    (missing image/label partners are skipped, not errors).
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        label_list: Optional[Sequence[int]] = None,
        reduce_zero_label: bool = False,
        ignore_relabel: tuple[int, int] = (255, -1),
        use_file_list: Optional[str] = None,
        include_val: bool = False,
        include_coarse: bool = False,
        include_atr: bool = False,
        include_cihp: bool = False,
        only_coarse: bool = False,
        only_mapillary: bool = False,
        dataset_name: str = "",
        label_subdir: str = "label",
        image_dir: Optional[str] = None,
    ):
        self.root = root
        self.split = split
        self.label_list = label_list
        self.reduce_zero_label = reduce_zero_label
        self.ignore_from, self.ignore_to = ignore_relabel
        # data.label_edge2void / label_non_edge2void redirect the GT dir to
        # the edge-masked variants laid out by tools/prepare_cityscapes.py
        # --edge-void (reference default_loader.py:114-118).  Fall back to
        # "label" per-split when the variant dir doesn't exist (the
        # reference only generates them for the split under study).
        self.label_subdir = label_subdir
        if image_dir is not None:
            # Flat-directory mode (`test.test_dir`): images straight from
            # an arbitrary directory, labels (optional) from a `label/`
            # sibling.  The reference declares `--test_dir`
            # (main.py:157-158) but never consumes it; here it works.
            img_dir = image_dir
            lab_dir = os.path.join(image_dir, "label")
        else:
            img_dir = os.path.join(root, split, "image")
            lab_dir = self._label_dir(split)
        if use_file_list:
            with open(use_file_list) as f:
                names = [ln.strip() for ln in f if ln.strip()]
            self.items = [
                (os.path.join(img_dir, n), self._label_path(lab_dir, n))
                for n in names
            ]
        else:
            names = sorted(
                n for n in os.listdir(img_dir)
                if n.lower().endswith(IMG_EXTS)
            )
            self.items = [
                (os.path.join(img_dir, n), self._label_path(lab_dir, n))
                for n in names
            ]
        if split == "train":
            if include_val:  # default_loader.py:145-180
                if dataset_name == "pascal_voc":
                    self.items = self._list_split("trainval")
                else:
                    self.items += self._list_split("val")
            if include_coarse:  # :182-198
                self.items += self._list_by_label("coarse")
            if include_atr:  # :200-215
                self.items += self._list_by_label("atr")
            if include_cihp:  # lip_loader.py:172-188
                self.items += self._list_by_label(
                    os.path.join("cihp", "single_person"))
            if only_coarse:  # :217-235
                self.items = self._list_by_label("coarse")
            if only_mapillary:  # :237-254
                self.items = self._list_by_label("mapillary")

    def _label_dir(self, split: str) -> str:
        d = os.path.join(self.root, split, self.label_subdir)
        if self.label_subdir != "label" and not os.path.isdir(d):
            return os.path.join(self.root, split, "label")
        return d

    def _list_split(self, split: str) -> list:
        img_dir = os.path.join(self.root, split, "image")
        lab_dir = self._label_dir(split)
        names = sorted(
            n for n in os.listdir(img_dir) if n.lower().endswith(IMG_EXTS)
        )
        return [
            (os.path.join(img_dir, n), self._label_path(lab_dir, n))
            for n in names
            if self._label_path(lab_dir, n) is not None
        ]

    def _list_by_label(self, subset: str) -> list:
        """Reference extra-set listing: walk the label dir, pair with the
        image dir, skip missing partners (default_loader.py:187-198)."""
        img_dir = os.path.join(self.root, subset, "image")
        lab_dir = os.path.join(self.root, subset, "label")
        items = []
        if not os.path.isdir(lab_dir):
            return items
        for n in sorted(os.listdir(lab_dir)):
            if not n.lower().endswith(IMG_EXTS):
                continue
            stem = os.path.splitext(n)[0]
            img_path = None
            for ext in IMG_EXTS:
                p = os.path.join(img_dir, stem + ext)
                if os.path.exists(p):
                    img_path = p
                    break
            if img_path is None:
                continue
            items.append((img_path, os.path.join(lab_dir, n)))
        return items

    @staticmethod
    def _label_path(lab_dir: str, img_name: str) -> Optional[str]:
        stem = os.path.splitext(img_name)[0]
        for ext in IMG_EXTS:
            p = os.path.join(lab_dir, stem + ext)
            if os.path.exists(p):
                return p
        return None

    def __len__(self) -> int:
        return len(self.items)

    @staticmethod
    def _read_cached(path: str) -> Optional[np.ndarray]:
        """Raw decoded array from the .npy_cache sidecar dir, if fresh.

        PNG decode of a 1024x2048 Cityscapes frame costs 50-100 ms/img on
        one core — re-paid every epoch by the reference.  `python
        tools/cache_dataset.py` decodes once into `.npy_cache/`; mmap'd
        reads cost ~0.2 ms.  Stale caches (source newer) are ignored."""
        cache = os.path.join(os.path.dirname(path), ".npy_cache",
                             os.path.basename(path) + ".npy")
        try:
            if os.path.getmtime(cache) >= os.path.getmtime(path):
                return np.ascontiguousarray(np.load(cache, mmap_mode="r"))
        except OSError:
            pass
        return None

    def __getitem__(self, idx: int) -> dict:
        img_path, lab_path = self.items[idx]
        image = self._read_cached(img_path)
        if image is None:
            from PIL import Image

            image = np.asarray(Image.open(img_path).convert("RGB"))
        sample = {
            "image": image,
            "meta": {
                "img_path": img_path,
                "ori_size": [image.shape[1], image.shape[0]],  # (w, h)
                "name": os.path.splitext(os.path.basename(img_path))[0],
            },
        }
        if lab_path is not None:
            label = self._read_cached(lab_path)
            if label is None:
                from PIL import Image

                label = np.asarray(Image.open(lab_path))
            label = label.astype(np.int64)
            if label.ndim == 3:
                label = label[..., 0]
            sample["meta"]["ori_target"] = label.copy()
            if self.label_list is not None:
                label = encode_label_map(label, self.label_list)
            if self.reduce_zero_label:
                label = label.astype(np.int64) - 1
                label[label == -1] = 255  # 0 was background
            label = np.where(label == self.ignore_from, self.ignore_to, label)
            sample["label"] = label.astype(np.int32)
        return sample


class SyntheticSegDataset:
    """Procedural scenes: smooth class regions + matching image statistics.

    The CPU-runnable fixture of the tests, and the input of the chip smoke's
    synthetic slices; sample for sample the JAX package's scenes.
    """

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
        # Voronoi-ish label regions from random seeds.
        k = min(self.num_classes * 2, 40)
        cy = rng.uniform(0, h, size=k)
        cx = rng.uniform(0, w, size=k)
        cc = rng.integers(0, self.num_classes, size=k)
        # The nearest seed of each pixel, in blocks of rows: the same float64
        # squared distances as over the whole [k, h, w] grid at once, in a
        # quarter of the memory traffic.
        dy = (np.arange(h)[None, :] - cy[:, None]) ** 2
        dx = (np.arange(w)[None, :] - cx[:, None]) ** 2
        nearest = np.empty((h, w), np.int64)
        for r in range(0, h, 32):
            nearest[r:r + 32] = np.argmin(dy[:, r:r + 32, None] + dx[:, None, :], axis=0)
        label = cc[nearest].astype(np.int32)
        # Image: per-class base color + noise.
        palette = rng.uniform(0, 255, size=(self.num_classes, 3))
        image = palette[label] + rng.normal(0, 20, size=(h, w, 3))
        image = np.clip(image, 0, 255).astype(np.uint8)
        return {
            "image": image,
            "label": label,
            "meta": {
                "img_path": f"synthetic://{idx}",
                "name": f"synthetic_{idx:05d}",
                "ori_size": [w, h],
            },
        }


def check_loader(cfg) -> None:
    """Raise NotImplementedError for the loaders that are not ported yet."""
    if cfg.get("data.data_dirs", default=None):
        raise NotImplementedError(
            "data.data_dirs (multi-dataset training) is not ported yet: ROADMAP 7")
    loader = cfg.get("data.loader", default="default")
    if loader != "default":
        raise NotImplementedError(
            f"data.loader={loader!r} is not ported yet: ROADMAP 7 (only 'default' is)")


def build_dataset(cfg, split: str = "train"):
    """DataLoader facade dataset selection (lib/datasets/data_loader.py:97-133):
    the synthetic scenes or the directory layout; the LipLoader and
    DTOffsetLoader equivalents and multi-dataset training are refused."""
    if cfg.get("data.synthetic", default=False):
        h, w = cfg.get("data.synthetic_size", default=[512, 1024])
        return SyntheticSegDataset(
            num_classes=cfg.get("data.num_classes"),
            size_hw=(h, w),
            length=cfg.get("data.synthetic_length", default=64),
        )
    check_loader(cfg)
    if split == "test":
        test_dir = cfg.get("test.test_dir", default=None)
        if test_dir:
            # Arbitrary image-directory testing (the reference's --test_dir
            # flag, main.py:157-158 — declared there but dead; honored here).
            return DirectorySegDataset(
                root=test_dir, split="", image_dir=test_dir,
                label_list=cfg.get("data.label_list", default=None),
                reduce_zero_label=cfg.get(
                    "data.reduce_zero_label", default=False),
            )
    label_subdir = "label"
    if cfg.get("data.label_edge2void", default=False):
        label_subdir = "label_edge_void"  # default_loader.py:115-116
    elif cfg.get("data.label_non_edge2void", default=False):
        label_subdir = "label_non_edge_void"  # default_loader.py:117-118
    kwargs = dict(
        root=cfg.get("data.data_dir"),
        split=split,
        label_list=cfg.get("data.label_list", default=None),
        reduce_zero_label=cfg.get("data.reduce_zero_label", default=False),
        use_file_list=cfg.get("data.use_file_list", default=None),
        label_subdir=label_subdir,
    )
    extra_sets = dict(
        include_val=cfg.get("data.include_val", default=False),
        include_coarse=cfg.get("data.include_coarse", default=False),
        include_atr=cfg.get("data.include_atr", default=False),
        include_cihp=cfg.get("data.include_cihp", default=False),
        only_coarse=cfg.get("data.only_coarse", default=False),
        only_mapillary=cfg.get("data.only_mapillary", default=False),
        dataset_name=cfg.get("dataset", default=""),
    )
    return DirectorySegDataset(**kwargs, **extra_sets)
