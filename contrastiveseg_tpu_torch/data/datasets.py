"""Datasets: directory-layout loader (reference DefaultLoader) and a
synthetic fixture for tests and benches.

The port's copy of ``contrastiveseg_tpu/data/datasets.py``.  Reference: lib/datasets/loader/default_loader.py — lists
``{root}/{split}/image`` + ``{root}/{split}/label``, optional ``label_list``
remap to train ids (default_loader.py:94-106) and ``reduce_zero_label``
(−1 shift, :83-92).  An image or label without a fresh ``.npy_cache``
sidecar is decoded here: a PNG through the port's own reader
(``utils/png.py``, native unfilter, no PIL), a JPEG through its native
decoder (``utils/jpeg.py``, no PIL), a BMP through PIL where PIL is
importable.  ``LipDataset`` (``data.loader=lip``,
JAX ``data/loaders_extra.py:30-50``) adds the CE2P edge target;
``data.loader=dt_offset`` and ``data.data_dirs`` (train split only) build
``data/loaders_extra.DTOffsetDataset`` and ``MultiDataset``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from contrastiveseg_tpu_torch.utils.jpeg import read_jpeg
from contrastiveseg_tpu_torch.utils.png import read_png

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

# Cityscapes raw-id -> train-id list (configs/cityscapes/*.json "label_list").
CITYSCAPES_LABEL_LIST = [
    7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33,
]


def decode_frame(path: str, rgb: bool) -> np.ndarray:
    """The array of the image file at ``path``, as PIL's
    ``np.asarray(Image.open(path))`` gives it, or with ``rgb`` as
    ``np.asarray(Image.open(path).convert("RGB"))``.  PNGs are read by
    ``utils/png.read_png`` and JPEGs by ``utils/jpeg.read_jpeg`` (native
    code, no PIL, no fallback); other formats (BMP) by ``decode_with_pil``."""
    lower = path.lower()
    if lower.endswith(".png"):
        return read_png(path, rgb=rgb)
    if lower.endswith((".jpg", ".jpeg")):
        return read_jpeg(path, rgb=rgb)
    return decode_with_pil(path, rgb)


def decode_with_pil(path: str, rgb: bool) -> np.ndarray:
    """``decode_frame``'s array through PIL; without PIL a RuntimeError that
    names the file and the sidecar tool."""
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError(
            f"{path} has no fresh .npy_cache sidecar, and decoding it needs PIL, which is not "
            "importable here: write the sidecars on a machine with PIL with `python "
            "tools/cache_dataset_torch.py --root <data_dir>`, or convert the frames to "
            "PNG") from err
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")) if rgb else np.asarray(im)


def label_to_edge(label: np.ndarray, ignore_index: int = -1) -> np.ndarray:
    """The binary semantic-boundary map of a label map, the LIP edge target
    (JAX ``data/loaders_extra.py:30-40``): both pixels of every vertically
    or horizontally adjacent pair with different labels are 1, and ignored
    pixels 0."""
    edge = np.zeros_like(label, dtype=np.int32)
    d = label[1:, :] != label[:-1, :]
    edge[1:, :][d] = 1
    edge[:-1, :][d] = 1
    d = label[:, 1:] != label[:, :-1]
    edge[:, 1:][d] = 1
    edge[:, :-1][d] = 1
    edge[label == ignore_index] = 0
    return edge


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

        A decode is re-paid every epoch, as in the reference.  `python
        tools/cache_dataset_torch.py --root <data_dir>` decodes each frame
        once into `.npy_cache/<name>.npy` beside it (the format of the JAX
        package's `tools/cache_dataset.py`), and an mmap'd read replaces the
        decode.  Only a BMP tree needs the sidecars where PIL is absent.
        Stale caches (source newer) are ignored."""
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
            image = decode_frame(img_path, rgb=True)
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
                label = decode_frame(lab_path, rgb=False)
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


class LipDataset(DirectorySegDataset):
    """LIP human parsing (the reference's LipLoader, lip_loader.py:26-193):
    the directory layout with a ``maskmap`` beside each ``label``, the edge
    target of CE2P's edge branch (``label_to_edge`` of the relabelled
    label)."""

    def __getitem__(self, idx: int) -> dict:
        sample = super().__getitem__(idx)
        if "label" in sample:
            sample["maskmap"] = label_to_edge(sample["label"])
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
    loader = cfg.get("data.loader", default="default")
    if loader not in ("default", "lip", "dt_offset"):
        raise NotImplementedError(
            f"data.loader={loader!r} is not ported yet: ROADMAP 7 (the port has 'default', "
            "'lip' and 'dt_offset')")


def build_dataset(cfg, split: str = "train"):
    """DataLoader facade dataset selection (lib/datasets/data_loader.py:97-133):
    the synthetic scenes; for the train split with ``data.data_dirs``, a
    ``MultiDataset`` of one dataset per root; the directory layout, or with
    ``data.loader`` the LipLoader or DTOffsetLoader equivalent.  As in the
    JAX package, the offset dataset takes none of the extra-set flags."""
    if cfg.get("data.synthetic", default=False):
        h, w = cfg.get("data.synthetic_size", default=[512, 1024])
        return SyntheticSegDataset(
            num_classes=cfg.get("data.num_classes"),
            size_hw=(h, w),
            length=cfg.get("data.synthetic_length", default=64),
        )
    check_loader(cfg)
    data_dirs = cfg.get("data.data_dirs", default=None)
    if data_dirs and split == "train":
        # Joint multi-dataset training (run_hx_20_d_2_cityscapes_ade20k.sh):
        # each root gets the same loader and transforms; the pipeline picks
        # up MultiDataset.balanced_indices.
        from contrastiveseg_tpu_torch.data.loaders_extra import MultiDataset

        return MultiDataset([
            build_dataset(cfg.merged({"data": {"data_dirs": None, "data_dir": d}}), split)
            for d in data_dirs])
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
    loader = cfg.get("data.loader", default="default")
    if loader == "lip":
        # The reference LipLoader supports the same extra-set merging
        # (include_val/include_atr/include_cihp, lip_loader.py:135-188).
        return LipDataset(**kwargs, **extra_sets)
    if loader == "dt_offset":
        from contrastiveseg_tpu_torch.data.loaders_extra import DTOffsetDataset
        from contrastiveseg_tpu_torch.utils.offset_helper import DTOffsetConfig

        return DTOffsetDataset(
            dt_config=DTOffsetConfig(
                num_classes=cfg.get("data.dt_num_classes", default=8),
                max_distance=cfg.get("data.dt_max_distance", default=5.0),
                c4_align_axis=cfg.get("data.c4_align_axis", default=False),
            ),
            boundary_source=cfg.get("data.dt_boundary", default="label"),
            **kwargs,
        )
    return DirectorySegDataset(**kwargs, **extra_sets)
