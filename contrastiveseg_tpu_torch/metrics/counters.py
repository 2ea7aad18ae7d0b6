"""Direction-task accuracy counters for SegFix evaluation.

The port's copy of ``contrastiveseg_tpu/metrics/counters.py``, held against
it by ``tests/test_torch_port_segfix.py``.  (The original's note follows.)

Re-implements SimpleCounterRunningScore and MultiLabelRunningScore (the
reference's lib/metrics/running_score.py:22-117): plain accuracy over
valid pixels, and multi-label (8-direction one-vs-rest) accuracy — both
reducible across hosts by summing the counters.
"""

from __future__ import annotations

import numpy as np


class SimpleCounterRunningScore:
    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, pred: np.ndarray, gt: np.ndarray,
               valid: np.ndarray | None = None) -> None:
        if valid is None:
            valid = gt >= 0
        self.correct += int(((pred == gt) & valid).sum())
        self.total += int(valid.sum())

    def get_mean_acc(self) -> float:
        return self.correct / max(self.total, 1)

    def reset(self) -> None:
        self.correct = self.total = 0


class MultiLabelRunningScore:
    """Accuracy of multi-hot direction predictions: a prediction counts as
    correct when it hits any of the ground-truth directions."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, pred_idx: np.ndarray, gt_multihot: np.ndarray,
               valid: np.ndarray | None = None) -> None:
        """pred_idx [N] int; gt_multihot [N, D] {0,1}.

        Out-of-range predictions (the 'non-boundary' extra class the ML
        direction task assigns where the predicted mask is 0,
        tasks.py:205-207) count as misses."""
        if valid is None:
            valid = gt_multihot.sum(-1) > 0
        d = gt_multihot.shape[-1]
        in_range = (pred_idx >= 0) & (pred_idx < d)
        hit = np.take_along_axis(
            gt_multihot, np.clip(pred_idx, 0, d - 1)[:, None], axis=-1
        )[:, 0] > 0
        hit = hit & in_range
        self.correct += int((hit & valid).sum())
        self.total += int(valid.sum())

    def get_mean_acc(self) -> float:
        return self.correct / max(self.total, 1)

    def reset(self) -> None:
        self.correct = self.total = 0
