"""SegFix loss: class-balanced boundary-mask CE + masked direction CE.

Counterpart of ``contrastiveseg_tpu/losses/segfix.py`` (the reference's
SegFixLoss, lib/loss/loss_helper.py:372-431).  Both logits are upsampled
(bilinear, align corners) to the labels' size.  The mask term is a CE whose
class weights are ``1 - count_c / total`` over this batch's ``mask_label``;
the direction term is the same over ``dir_label``, counted only where the
predicted boundary probability exceeds ``mask_threshold``.

The targets are a dict of ``mask_label`` and ``dir_label`` (``data/
loaders_extra.DTOffsetDataset``).  The trainer hands every loss the label
map alone, as the JAX trainer does (``engine/trainer.py:232``,
``engine/train_step.py:75,89-91``), so a SegFix preset cannot train in
either package: here the first step raises a ``ValueError`` that says so,
where the JAX step fails indexing an array with a string (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners

TRAINER_FAULT = (
    "segfix_loss needs the targets {'mask_label', 'dir_label'}, but the trainer hands every "
    "loss the label map alone, as the JAX trainer does (contrastiveseg_tpu/engine/"
    "trainer.py:232 puts only 'image' and 'label' on the device), so a SegFix preset cannot "
    "train in either package (ROADMAP section 3); --phase val and --phase test work")


def _balanced_weights(label_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """w_c = 1 - count_c / total (SegFixLoss.calc_weights)."""
    counts = torch.stack([(label_map == i).sum() for i in range(num_classes)]).float()
    return 1.0 - counts / counts.sum().clamp(min=1.0)


def _weighted_ce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                 ignore_index: int = -1) -> torch.Tensor:
    """Mean CE of NHWC ``logits`` weighted per pixel by its class's weight
    (0 where ``labels`` is ``ignore_index``)."""
    num_classes = logits.shape[-1]
    valid = labels != ignore_index
    safe = labels.clamp(0, num_classes - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = torch.where(valid, weights[safe], torch.zeros((), device=logits.device))
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


@dataclasses.dataclass(frozen=True)
class SegFixLoss:
    num_directions: int = 8
    mask_threshold: float = 0.5
    mask_weight: float = 1.0
    direction_weight: float = 1.0

    def __call__(self, outputs: dict, targets, with_embed=True, bank=None, scores=None,
                 generator=None):
        """``outputs``: {"mask": [B, h, w, 2], "dir": [B, h, w, D]};
        ``targets``: {"mask_label", "dir_label"}, each [B, H, W] (ignore -1)."""
        if not isinstance(targets, Mapping):
            raise ValueError(TRAINER_FAULT)
        gt_mask, gt_dir = targets["mask_label"], targets["dir_label"]
        h, w = gt_mask.shape[1], gt_mask.shape[2]
        pred_mask = resize_bilinear_align_corners(outputs["mask"], (h, w))
        pred_dir = resize_bilinear_align_corners(outputs["dir"], (h, w))

        mask_loss = _weighted_ce(pred_mask, gt_mask, _balanced_weights(gt_mask, 2))

        # Direction supervised only where the predicted mask fires
        # (loss_helper.py:409-415).
        fire = torch.softmax(pred_mask.detach().float(), dim=-1)[..., 1] > self.mask_threshold
        gt_dir = torch.where(fire, gt_dir, -1)
        dir_w = _balanced_weights(torch.where(gt_dir >= 0, gt_dir, self.num_directions),
                                  self.num_directions)
        dir_loss = _weighted_ce(pred_dir, gt_dir, dir_w)

        total = self.mask_weight * mask_loss + self.direction_weight * dir_loss
        return total, {"loss_mask": mask_loss, "loss_direction": dir_loss, "loss": total}
