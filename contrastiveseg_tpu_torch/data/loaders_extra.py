"""SegFix's distance-transform targets and the multi-dataset sampler.

The port's copy of ``contrastiveseg_tpu/data/loaders_extra.py`` (:53-192;
its ``LipDataset`` is in ``data/datasets.py``), numpy and scipy on the host:

  * ``compute_dt_targets`` — the SegFix ground truth of a label map: the
    exact Euclidean distance of each pixel to the nearest boundary, the
    boundary-normal angle from two 11x11 large-support Sobel filters of that
    distance field, and from them ``mask_label`` (1 within
    ``max_distance`` of a boundary) and ``dir_label`` (the angle quantised
    to ``num_classes`` directions, -1 off the mask).  The reference
    precomputes these offline (DTOffsetLoader, loader/offset_loader.py);
    both packages compute them per sample, before the transforms;
  * ``DTOffsetDataset`` (``data.loader=dt_offset``): the directory layout
    plus those targets; ``boundary_source="instance"`` takes the boundary
    geometry from ``{split}/instance/{name}.png`` (16-bit instance ids, read
    through ``utils/png.py``), so that touching instances of one class are
    separated, and the ignore regions from the semantic label;
  * ``MultiDataset`` (``data.data_dirs``) with ``balanced_indices``, the
    reference's MultiDatasetTrainingSampler (multi_dataset_loader.py):
    round-robin over the datasets, each cycling its own permutation.

The transforms and the collate treat ``mask_label`` and ``dir_label`` as
the JAX package does: they are not among the nearest-resized keys, so they
are neither cropped nor flipped, and they pad with 0 (ROADMAP §3).
"""

from __future__ import annotations

import os

import numpy as np

from contrastiveseg_tpu_torch.data.datasets import (
    DirectorySegDataset,
    decode_frame,
    label_to_edge,
)
from contrastiveseg_tpu_torch.utils.offset_helper import (
    DTOffsetConfig,
    angle_to_direction_label,
    distance_to_mask_label,
    sobel_kernel,
)


def compute_dt_targets(
    label: np.ndarray, cfg: DTOffsetConfig = DTOffsetConfig(),
    boundary_map: np.ndarray | None = None,
) -> dict:
    """``distance_map``, ``angle_map``, ``mask_label`` and ``dir_label`` of
    ``label`` (JAX :53-96): the boundary is where ``boundary_map`` (default
    ``label``) changes, the ignore regions are ``label``'s -1."""
    from scipy import ndimage

    if boundary_map is None:
        boundary_map = label
    edge = label_to_edge(boundary_map).astype(bool)
    distance = ndimage.distance_transform_edt(~edge).astype(np.float32)

    kx, ky = sobel_kernel(11)
    gx = ndimage.convolve(distance, kx, mode="nearest")
    gy = ndimage.convolve(distance, ky, mode="nearest")
    angle = np.degrees(np.arctan2(gy, gx)).astype(np.float32)

    mask_label = distance_to_mask_label(distance, label, cfg)
    dir_label = angle_to_direction_label(
        angle, seg_label_map=label, distance_map=distance, cfg=cfg)
    # Direction supervised only near boundaries; elsewhere ignore.
    dir_label = np.where(mask_label == 1, dir_label, -1)
    return {
        "distance_map": distance,
        "angle_map": angle,
        "mask_label": mask_label.astype(np.int32),
        "dir_label": dir_label.astype(np.int32),
    }


class DTOffsetDataset(DirectorySegDataset):
    """SegFix ground truth: label + mask_label + dir_label (JAX :99-150).
    Without an instance file for a frame, its boundary comes from the
    semantic label."""

    def __init__(self, *args, dt_config: DTOffsetConfig = DTOffsetConfig(),
                 boundary_source: str = "label", **kwargs):
        super().__init__(*args, **kwargs)
        self.dt_config = dt_config
        if boundary_source not in ("label", "instance"):
            raise ValueError(f"boundary_source {boundary_source!r}")
        self.boundary_source = boundary_source

    def _instance_map(self, sample: dict) -> np.ndarray | None:
        split_dir = os.path.dirname(os.path.dirname(sample["meta"]["img_path"]))
        for ext in (".png", ".bmp"):
            p = os.path.join(split_dir, "instance", sample["meta"]["name"] + ext)
            if os.path.exists(p):
                inst = decode_frame(p, rgb=False).astype(np.int64)
                return inst[..., 0] if inst.ndim == 3 else inst
        return None

    def __getitem__(self, idx: int) -> dict:
        sample = super().__getitem__(idx)
        if "label" in sample:
            boundary = None
            if self.boundary_source == "instance":
                boundary = self._instance_map(sample)
                if boundary is not None:
                    # Ignore pixels stay boundary-free (the reference maps
                    # unlisted raw ids to 255 before its per-id EDT).
                    boundary = np.where(sample["label"] < 0, -1, boundary)
            sample.update(compute_dt_targets(
                sample["label"], self.dt_config, boundary_map=boundary))
        return sample


class MultiDataset:
    """Concatenated datasets with balanced draws (JAX :152-192, less its
    ``weights``, which nothing reads); each sample's ``meta`` gets its
    ``dataset_index``."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.sizes = [len(d) for d in self.datasets]
        self.offsets = np.cumsum([0] + self.sizes[:-1])

    def __len__(self) -> int:
        return sum(self.sizes)

    def __getitem__(self, idx: int) -> dict:
        for d, off, n in zip(self.datasets, self.offsets, self.sizes):
            if idx < off + n:
                s = d[idx - off]
                s.setdefault("meta", {})["dataset_index"] = int(
                    np.searchsorted(self.offsets, off))
                return s
        raise IndexError(idx)

    def balanced_indices(self, epoch: int, seed: int = 0) -> np.ndarray:
        """An epoch of ``m * max(sizes)`` indices in which position i serves
        dataset ``i % m``, each dataset cycling its own shuffled permutation
        (short ones repeat): every batch of k*m samples is balanced."""
        rng = np.random.default_rng(seed + epoch)
        m = len(self.datasets)
        target = max(self.sizes)
        cols = []
        for off, n in zip(self.offsets, self.sizes):
            reps = -(-target // n)
            perm = np.concatenate([rng.permutation(n) for _ in range(reps)])[:target]
            cols.append(perm + off)
        # [target, m] row-major flatten = round-robin over datasets.
        return np.stack(cols, axis=1).reshape(-1)
