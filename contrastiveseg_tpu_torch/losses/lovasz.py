"""Lovasz-Softmax loss.

Counterpart of ``contrastiveseg_tpu/losses/lovasz.py`` (the reference's
lovasz_softmax_flat, lovasz_grad and flatten_probas,
lib/loss/lovasz_loss.py:216-260).  The reference compacts the valid pixels
by boolean indexing; here, as in the JAX package, every pixel keeps its
slot and an ignored pixel's error is 0 (and it is no foreground), so it
sorts into the zero-error tail where each term of the dot product is 0:
the same value as the compacted computation, with static shapes.

Inputs are NHWC: probabilities or logits [B, H, W, C], int labels [B, H, W].
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from contrastiveseg_tpu_torch.losses.ce import cross_entropy
from contrastiveseg_tpu_torch.ops.resize import scale_target_nearest


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to the sorted errors,
    [C, P] -> [C, P]."""
    gts = fg_sorted.sum(-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(-1)
    union = gts + (1.0 - fg_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1,
                   only_present: bool = True) -> torch.Tensor:
    """The Lovasz-Softmax of softmax ``probs``: each class's errors sorted
    in decreasing order (a stable sort, as JAX's ``argsort``), dotted with
    the Jaccard gradient; the mean over the classes present in the labels
    (``only_present``) or over all."""
    C = probs.shape[-1]
    p = probs.reshape(-1, C).float()
    y = labels.reshape(-1)
    valid = y != ignore_index
    classes = torch.arange(C, device=y.device)
    fg = ((y[None, :] == classes[:, None]) & valid[None, :]).float()  # [C, P]
    errors = torch.where(valid[None, :], (fg - p.T).abs(), 0.0)
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    fg_sorted = torch.gather(fg, -1, order)
    per_class = (errors_sorted * _lovasz_grad(fg_sorted).detach()).sum(-1)  # [C]
    if only_present:
        present = fg.sum(-1) > 0
        return torch.where(present, per_class, 0.0).sum() / present.sum().clamp(min=1)
    return per_class.mean()


def ce_lovasz_loss(logits: torch.Tensor, labels: torch.Tensor,
                   class_weight: Optional[Sequence[float]] = None,
                   ignore_index: int = -1) -> torch.Tensor:
    """FSCELOVASZLoss (loss_helper.py:77-130): CE plus the Lovasz-Softmax
    over the present classes, the labels resized (nearest) to the logits."""
    if logits.shape[1:3] != labels.shape[1:3]:
        labels = scale_target_nearest(labels, (logits.shape[1], logits.shape[2]))
    ce = cross_entropy(logits, labels, class_weight, ignore_index)
    probs = torch.softmax(logits.float(), dim=-1)
    return ce + lovasz_softmax(probs, labels, ignore_index, only_present=True)
