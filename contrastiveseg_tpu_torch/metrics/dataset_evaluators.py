"""Per-dataset offline evaluator wrappers (label-convention adapters).

The port's copy of ``contrastiveseg_tpu/metrics/dataset_evaluators.py``, on
the port's ``metrics/running_score.py``, with its PNGs read through
``utils/png.py`` instead of PIL.  (The original's note follows.)

Reference counterparts: lib/metrics/{ade20k,cocostuff,pascal_context}
_evaluator.py (~210 LoC total).  Each wrapper encodes a dataset's
prediction/ground-truth label convention — the shift-by-one of
reduce_zero_label datasets, COCO-Stuff's raw-id -> train-id remap and
background-void rule — and accumulates a RunningScore over directory
pairs of PNGs.

The heavy lifting (confusion matrix) runs through RunningScore's histogram
(the port's ``ops/confusion.py``, on CPU tensors here); these classes are
deliberately thin like the reference's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from contrastiveseg_tpu_torch.metrics.running_score import RunningScore
from contrastiveseg_tpu_torch.utils.png import read_png

# COCO-Stuff raw label id -> train id (reference cocostuff_evaluator.py:
# 21-40 — dataset constant, reproduced verbatim by necessity).  Ids absent
# from COCO's 171-class subset collapse to 0 (void).
_COCOSTUFF_VOID = (12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91)


def _cocostuff_id_to_trainid() -> dict[int, int]:
    table = {}
    nxt = 1
    for raw in range(1, 183):
        if raw in _COCOSTUFF_VOID:
            table[raw] = 0
        else:
            table[raw] = nxt
            nxt += 1
    table[0] = 0
    return table


def _read_label(path: str) -> np.ndarray:
    arr = read_png(path).astype(np.int64)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


class _DirEvaluator:
    """Walk pred_dir, pair with gt_dir by filename, relabel, accumulate."""

    ignore_index: Optional[int] = 255

    def __init__(self, num_classes: int):
        self.score = RunningScore(num_classes, ignore_index=self.ignore_index)

    def relabel_pred(self, labelmap: np.ndarray) -> np.ndarray:
        return labelmap

    def relabel_gt(self, labelmap: np.ndarray) -> np.ndarray:
        return self.relabel_pred(labelmap)

    def evaluate(self, pred_dir: str, gt_dir: str) -> dict:
        count = 0
        for name in sorted(os.listdir(pred_dir)):
            if not name.lower().endswith(".png"):
                continue
            gt_path = os.path.join(gt_dir, name)
            if not os.path.exists(gt_path):
                continue
            pred = self.relabel_pred(_read_label(
                os.path.join(pred_dir, name)))
            gt = self.relabel_gt(_read_label(gt_path))
            self.score.update(pred[None], gt[None])
            count += 1
        return {
            "images": count,
            "miou": self.score.get_mean_iou(),
            "pixel_acc": self.score.get_pixel_acc(),
            "cls_iou": self.score.get_cls_iou(),
        }


class ADE20KEvaluator(_DirEvaluator):
    """ADE20K: stored labels are 1..150 with 0=void; both maps shift down
    by one so void becomes 255 under uint8 semantics
    (ade20k_evaluator.py:23-24,34-36)."""

    def __init__(self, num_classes: int = 150):
        super().__init__(num_classes)

    def relabel_pred(self, labelmap):
        return (labelmap - 1).astype(np.uint8).astype(np.int64)


class PascalContextEvaluator(ADE20KEvaluator):
    """PASCAL-Context: same shift-by-one convention
    (pascal_context_evaluator.py:22-23)."""

    def __init__(self, num_classes: int = 59):
        super().__init__(num_classes)


class COCOStuffEvaluator(_DirEvaluator):
    """COCO-Stuff: raw ids remap through id_to_trainid (no shift), then
    background 0 is voided in the ground truth only
    (cocostuff_evaluator.py:44-70)."""

    def __init__(self, num_classes: int = 171):
        super().__init__(num_classes)
        self.table = _cocostuff_id_to_trainid()

    def _remap(self, labelmap):
        out = labelmap.copy()
        for raw, train in self.table.items():
            out[labelmap == raw] = train
        return out

    def relabel_pred(self, labelmap):
        return self._remap(labelmap).astype(np.uint8).astype(np.int64)

    def relabel_gt(self, labelmap):
        remapped = self.relabel_pred(labelmap)
        remapped[remapped == 0] = 255  # unlabeled void (gt only)
        return remapped


EVALUATORS = {
    "ade20k": ADE20KEvaluator,
    "pascal_context": PascalContextEvaluator,
    "coco_stuff": COCOStuffEvaluator,
}
