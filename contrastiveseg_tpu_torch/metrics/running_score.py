"""Segmentation metrics: the host-side confusion-matrix accumulator.

A copy of ``contrastiveseg_tpu/metrics/running_score.py`` (numpy), with its
per-batch histogram from the port's ``ops/confusion.py``.  Same scores:
pixel accuracy, class accuracy, mIoU, per-class IoU, frequency-weighted
IoU, F1 (reference lib/metrics/running_score.py:121-213).
"""

from __future__ import annotations

import numpy as np
import torch

from contrastiveseg_tpu_torch.ops.confusion import confusion_matrix


class RunningScore:
    def __init__(self, num_classes: int, ignore_index: int | None = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.confusion = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, pred, label) -> None:
        """pred/label: [B, H, W] int tensors or arrays."""
        cm = confusion_matrix(torch.as_tensor(pred), torch.as_tensor(label),
                              self.num_classes)
        self.confusion += cm.cpu().numpy().astype(np.int64)

    def update_confusion(self, cm) -> None:
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        self.confusion += np.asarray(cm, dtype=np.int64)

    def reset(self) -> None:
        self.confusion[:] = 0

    # -- scores (running_score.py:170-213) --------------------------------
    def _iu(self) -> np.ndarray:
        hist = self.confusion.astype(np.float64)
        denom = hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist)
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(hist) / denom
        return iu

    def get_mean_iou(self) -> float:
        return float(np.nanmean(self._iu()))

    def get_cls_iou(self) -> np.ndarray:
        return self._iu()

    def get_pixel_acc(self) -> float:
        hist = self.confusion.astype(np.float64)
        return float(np.diag(hist).sum() / max(hist.sum(), 1))

    def get_mean_acc(self) -> float:
        hist = self.confusion.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist) / hist.sum(axis=1)
        return float(np.nanmean(acc))

    def get_fwavacc(self) -> float:
        hist = self.confusion.astype(np.float64)
        freq = hist.sum(axis=1) / max(hist.sum(), 1)
        iu = self._iu()
        return float((freq[freq > 0] * iu[freq > 0]).sum())

    def get_f1_score(self) -> float:
        hist = self.confusion.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.diag(hist) / hist.sum(axis=0)
            recall = np.diag(hist) / hist.sum(axis=1)
            f1 = 2 * precision * recall / (precision + recall)
        return float(np.nanmean(f1))

    def get_scores(self) -> dict:
        return {
            "miou": self.get_mean_iou(),
            "pixel_acc": self.get_pixel_acc(),
            "mean_acc": self.get_mean_acc(),
            "fwavacc": self.get_fwavacc(),
            "cls_iou": self.get_cls_iou(),
        }
