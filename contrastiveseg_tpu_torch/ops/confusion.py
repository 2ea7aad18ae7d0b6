"""Confusion matrix for segmentation metrics.

Counterpart of ``contrastiveseg_tpu/ops/confusion.py``: one ``bincount``
over ``label * n + pred`` on the device, with pixels whose label is outside
[0, n) (ignore -1 / 255) routed to a trash bin that is then dropped, so the
shape stays static and no boolean indexing syncs the host.
"""

from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[num_classes, num_classes] int64 matrix; rows = ground truth, cols =
    prediction (clipped into range, as the JAX version does)."""
    n = num_classes
    pred = pred.reshape(-1).long().clamp(0, n - 1)
    label = label.reshape(-1).long()
    valid = (label >= 0) & (label < n)
    idx = torch.where(valid, label * n + pred, torch.full_like(label, n * n))
    return torch.bincount(idx, minlength=n * n + 1)[:-1].reshape(n, n)
