"""SegFix distance-transform offset math (numpy).

The port's copy of ``contrastiveseg_tpu/utils/offset_helper.py``, held
against it by ``tests/test_torch_port_segfix_data.py``.  (The original's
note follows.)

Re-implements DTOffsetConfig / DTOffsetHelper (the reference's
lib/utils/helpers/offset_helper.py:25-529): direction
quantization (4/8/16/32 classes), angle alignment, distance->boundary-mask
thresholds, and direction-label -> offset-vector mapping.  The reference's
env-var configuration (dt_num_classes, dt_scale, c4_align_axis) becomes an
explicit dataclass.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LABEL_TO_VECTOR_MAPPING = {
    4: [[-1, -1], [-1, 1], [1, 1], [1, -1]],
    "4_axis": [[0, -1], [-1, 0], [0, 1], [1, 0]],
    8: [[0, -1], [-1, -1], [-1, 0], [-1, 1],
        [0, 1], [1, 1], [1, 0], [1, -1]],
    16: [[0, -2], [-1, -2], [-2, -2], [-2, -1],
         [-2, 0], [-2, 1], [-2, 2], [-1, 2],
         [0, 2], [1, 2], [2, 2], [2, 1],
         [2, 0], [2, -1], [2, -2], [1, -2]],
    32: [[0, -4], [-1, -4], [-2, -4], [-3, -4], [-4, -4], [-4, -3], [-4, -2],
         [-4, -1], [-4, 0], [-4, 1], [-4, 2], [-4, 3], [-4, 4], [-3, 4],
         [-2, 4], [-1, 4], [0, 4], [1, 4], [2, 4], [3, 4], [4, 4], [4, 3],
         [4, 2], [4, 1], [4, 0], [4, -1], [4, -2], [4, -3], [4, -4], [3, -4],
         [2, -4], [1, -4]],
}


@dataclasses.dataclass(frozen=True)
class DTOffsetConfig:
    num_classes: int = 8  # direction classes: 4 | 8 | 16 | 32
    max_distance: float = 5.0
    min_distance: float = 0.0
    c4_align_axis: bool = False

    def __post_init__(self):
        assert self.num_classes in (4, 8, 16, 32)

    @property
    def mapping(self) -> np.ndarray:
        key = (
            "4_axis"
            if self.num_classes == 4 and self.c4_align_axis
            else self.num_classes
        )
        return np.asarray(LABEL_TO_VECTOR_MAPPING[key], dtype=np.int64)


def align_angle(
    angle_map: np.ndarray, num_classes: int = 8, c4_align_axis: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Quantize angles (degrees, (-180, 180]) to direction class indices.

    Returns (aligned_angle, class_index).  offset_helper.py:315-345.
    """
    if num_classes == 4 and not c4_align_axis:
        idx = np.clip(np.trunc((angle_map + 180) / 90).astype(np.int64), 0, 3)
        return (idx * 90 - 135).astype(np.float32), idx
    step = 360.0 / num_classes
    new_angle = np.zeros(angle_map.shape, np.float32)
    idx = np.zeros(angle_map.shape, np.int64)
    mask = (angle_map <= (-180 + step / 2)) | (angle_map > (180 - step / 2))
    new_angle[mask] = -180.0
    idx[mask] = 0
    for i in range(1, num_classes):
        middle = -180 + step * i
        mask = (angle_map > (middle - step / 2)) & (
            angle_map <= (middle + step / 2)
        )
        new_angle[mask] = middle
        idx[mask] = i
    return new_angle, idx


def distance_to_mask_label(
    distance_map: np.ndarray, seg_label_map: np.ndarray,
    cfg: DTOffsetConfig = DTOffsetConfig(),
) -> np.ndarray:
    """Boundary mask: 1 within [min, max] distance, ignore where label==-1
    (offset_helper.py:267-288)."""
    mask = np.zeros(seg_label_map.shape, np.int64)
    keep = (distance_map <= cfg.max_distance) & (
        distance_map >= cfg.min_distance
    )
    mask[keep] = 1
    mask[seg_label_map == -1] = -1
    return mask


def angle_to_direction_label(
    angle_map: np.ndarray,
    seg_label_map: np.ndarray | None = None,
    distance_map: np.ndarray | None = None,
    extra_ignore_mask: np.ndarray | None = None,
    cfg: DTOffsetConfig = DTOffsetConfig(),
) -> np.ndarray:
    """Direction class labels with ignore handling (offset_helper.py:456-488)."""
    _, label_map = align_angle(
        angle_map, cfg.num_classes, cfg.c4_align_axis
    )
    if distance_map is not None:
        label_map[distance_map > cfg.max_distance] = cfg.num_classes
    if seg_label_map is not None:
        label_map[seg_label_map == -1] = -1
    if extra_ignore_mask is not None:
        label_map[extra_ignore_mask] = -1
    return label_map


def label_to_vector(
    labelmap: np.ndarray, cfg: DTOffsetConfig = DTOffsetConfig()
) -> np.ndarray:
    """Direction labels -> integer (dy, dx) offsets, [..., 2]
    (offset_helper.py:250-265); invalid labels -> 0 vector."""
    mapping = cfg.mapping
    safe = np.clip(labelmap, 0, cfg.num_classes - 1)
    vec = mapping[safe]
    vec[labelmap < 0] = 0
    vec[labelmap >= cfg.num_classes] = 0
    return vec


def sobel_kernel(ksize: int = 11) -> tuple[np.ndarray, np.ndarray]:
    """Large-support Sobel kernels (offset_helper.py Sobel:101-135) used to
    compute boundary-normal angles from distance transforms."""

    def one(axis):
        k = np.zeros((ksize, ksize), np.float64)
        p = [
            (i, j)
            for i in range(ksize)
            for j in range(ksize)
            if not (i == ksize // 2 and j == ksize // 2)
        ]
        for i, j in p:
            di, dj = i - ksize // 2, j - ksize // 2
            d = di * di + dj * dj
            k[i, j] = (dj if axis == 0 else di) / d
        return k

    return one(0), one(1)


def encode_multi_labels(dir_labels: np.ndarray) -> np.ndarray:
    """Bit-packed multi-direction labels -> [..., 8] multi-hot
    (reference DTOffsetHelper.encode_multi_labels, offset_helper.py:140-151)."""
    out = np.zeros((*dir_labels.shape, 8), dtype=np.int32)
    for i in range(8):
        out[..., i] = ((dir_labels & (1 << i)) != 0).astype(np.int32)
    return out


def vector_to_label(
    vector_map: np.ndarray, cfg: DTOffsetConfig = DTOffsetConfig()
) -> np.ndarray:
    """(dy, dx) offset vectors -> direction class labels
    (offset_helper.py:490-506): angle from arctan2, then quantize."""
    angle_map = np.degrees(
        np.arctan2(vector_map[..., 0], vector_map[..., 1]))
    _, label_map = align_angle(angle_map, cfg.num_classes, cfg.c4_align_axis)
    return label_map


def multilabel_direction_prediction(
    dir_logits: np.ndarray,  # [H, W, 8]
    no_offset_mask: np.ndarray | None = None,
    topk: int = 8,
    cfg: DTOffsetConfig = DTOffsetConfig(),
) -> np.ndarray:
    """MLDirectionTask._get_multilabel_prediction (tasks.py:176-209):
    sum the top-k direction vectors weighted by their logits, re-quantize
    the summed offset to a single direction label; non-boundary pixels
    (mask pred 0) map to the extra class 8."""
    h, w, d = dir_logits.shape
    if topk == d:
        idx = np.broadcast_to(np.arange(d), (h, w, d))
        weights = dir_logits
    else:
        idx = np.argsort(-dir_logits, axis=-1)[..., :topk]
        weights = np.take_along_axis(dir_logits, idx, axis=-1)
    vecs = label_to_vector(idx, cfg)  # [H, W, k, 2]
    offset = (vecs * weights[..., None]).sum(axis=-2)
    pred = vector_to_label(offset, DTOffsetConfig(num_classes=8))
    if no_offset_mask is not None:
        pred = np.where(no_offset_mask, 8, pred)
    return pred
