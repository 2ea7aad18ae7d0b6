"""Validation of the segmentation task: forward, upsampled argmax, confusion.

Counterpart of ``Evaluator`` and ``build_evaluator`` in
``contrastiveseg_tpu/engine/evaluator.py`` (:41-138, :298-320; the
reference's SegTask): the eval-mode forward, the optional flip average with
left/right class swaps, the model's ``seg`` logits (at the network's
stride for the contrast nets, at the input size for the others) resized to
the label's size (bilinear, align_corners), argmax, and the confusion
matrix accumulated on the device, read once at the end of the run.

Diverse-size (per-image) batches reach the model one image at a time,
each at its own padded size (``engine/prefetch.device_batches``).

The SegFix evaluators (:141-296; the reference's MaskTask, DirectionTask
and MLDirectionTask, segmentor/tools/evaluator/tasks.py:47-246) take the
``mask`` and ``dir`` logits of an offset net, resized (align corners) to
the labels' size, and their argmax: ``SegFixEvaluator`` scores the
boundary mask and the directions on the device, ``MLDirectionEvaluator``
(``val.evaluator=ml_dir``) the multi-label directions of ``ml_dir_label``
on the host.

Under a process group each rank scores its shard of the val split
(``data/pipeline.py`` deals every frame to one rank) with the model
unwrapped, in eval mode, so no collective runs per batch and the ranks may
take different numbers of batches; the confusion matrices (and the counts)
are summed over the ranks at the end, which is the JAX evaluator's mesh
step over padded batches (:80-99, 129-130) without the padding.
"""

from __future__ import annotations

import time
from typing import Iterable, Sequence

import torch
from torch import nn

import numpy as np

from contrastiveseg_tpu_torch.engine.prefetch import device_batches
from contrastiveseg_tpu_torch.metrics.counters import MultiLabelRunningScore
from contrastiveseg_tpu_torch.metrics.running_score import RunningScore
from contrastiveseg_tpu_torch.ops.confusion import confusion_matrix
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners
from contrastiveseg_tpu_torch.parallel import all_reduce_sum, distributed


def _swap_channels(seg: torch.Tensor, pairs: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Swap left/right class channels of flipped NHWC logits (LIP eval)."""
    perm = list(range(seg.shape[-1]))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return seg[..., perm]


class Evaluator:
    def __init__(self, model: nn.Module, num_classes: int,
                 flip_average: bool = False,
                 flip_pairs: Sequence[tuple[int, int]] = ()):
        self.model = model
        self.num_classes = num_classes
        self.flip_average = flip_average
        self.flip_pairs = list(flip_pairs)
        self.score = RunningScore(num_classes)

    @torch.no_grad()
    def confusion(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """[n, n] confusion of one batch: NHWC ``images``, [B, H, W] ``labels``."""
        seg = self.model(images)["seg"]
        if self.flip_average:
            seg_f = self.model(images.flip(2))["seg"].flip(2)
            if self.flip_pairs:
                seg_f = _swap_channels(seg_f, self.flip_pairs)
            seg = 0.5 * (seg + seg_f)
        seg = resize_bilinear_align_corners(seg, (labels.shape[1], labels.shape[2]))
        return confusion_matrix(seg.argmax(-1), labels, self.num_classes)

    def run(self, batches: Iterable[dict], device: torch.device | str) -> dict:
        """Scores over ``batches`` (numpy {"image", "label"}, as the val
        pipeline gives them; copied through ``engine/prefetch.device_batches``),
        with the model in eval mode (its mode is restored after)."""
        device = torch.device(device)
        was_training = self.model.training
        self.model.eval()
        self.score.reset()
        total = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int64,
                            device=device)
        n_images = 0
        t0 = time.perf_counter()
        try:
            for batch in device_batches(batches, device):
                total += self.confusion(batch["image"], batch["label"])
                n_images += batch["image"].shape[0]
            (total,), n_images = _summed([total], n_images)
            self.score.update_confusion(total)  # syncs the device
        finally:
            self.model.train(was_training)
        scores = self.score.get_scores()
        scores["images_per_sec"] = n_images / max(time.perf_counter() - t0, 1e-9)
        return scores


def _summed(totals: list[torch.Tensor], n_images: int) -> tuple[list[torch.Tensor], int]:
    """``totals`` and ``n_images`` summed over the ranks, in one all-reduce;
    as they are without a process group."""
    if not distributed():
        return totals, n_images
    summed = all_reduce_sum(torch.cat([t.reshape(-1) for t in totals]
                                      + [totals[0].new_tensor([n_images])]))
    parts = summed[:-1].split([t.numel() for t in totals])
    return [p.view_as(t) for p, t in zip(parts, totals)], int(summed[-1])


class _OffsetEvaluator:
    """The eval-mode forward of an offset net on NHWC images, its ``mask``
    and ``dir`` (or ``ml_dir``) logits resized to ``hw``."""

    direction_key = "dir"

    def __init__(self, model: nn.Module):
        self.model = model

    @torch.no_grad()
    def predict(self, images: torch.Tensor, hw: tuple[int, int]
                ) -> tuple[torch.Tensor, torch.Tensor]:
        out = self.model(images)
        mask = resize_bilinear_align_corners(out["mask"], hw)
        key = self.direction_key if self.direction_key in out else "dir"
        return mask.argmax(-1), resize_bilinear_align_corners(out[key], hw)

    def run(self, batches: Iterable[dict], device: torch.device | str) -> dict:
        """Scores over ``batches``, with the model in eval mode (its mode
        is restored after)."""
        device = torch.device(device)
        was_training = self.model.training
        self.model.eval()
        t0 = time.perf_counter()
        try:
            scores, n_images = self._run(batches, device)
        finally:
            self.model.train(was_training)
        scores["images_per_sec"] = n_images / max(time.perf_counter() - t0, 1e-9)
        return scores


class SegFixEvaluator(_OffsetEvaluator):
    """MaskTask + DirectionTask validation: ``mask_acc`` (boundary-mask
    pixel accuracy), ``dir_acc_mask`` (direction accuracy where the
    *predicted* mask is 1, 'dir (mask)') and ``dir_acc_gt`` (predicted
    directions with non-boundary predictions as an extra class, against the
    ground truth, 'dir (GT)', the headline, also reported as ``miou``).  The
    three confusion matrices stay on the device and are read once."""

    def __init__(self, model: nn.Module, num_directions: int = 8):
        super().__init__(model)
        self.num_directions = num_directions
        self.reset()

    def reset(self) -> None:
        self.mask_score = RunningScore(2)
        self.dir_mask_score = RunningScore(self.num_directions)
        self.dir_gt_score = RunningScore(self.num_directions + 1)

    def _run(self, batches, device):
        self.reset()
        d = self.num_directions
        totals = [torch.zeros((n, n), dtype=torch.int64, device=device) for n in (2, d, d + 1)]
        n_images = 0
        for batch in device_batches(batches, device, keys=("image", "mask_label", "dir_label")):
            gt_mask, gt_dir = batch["mask_label"], batch["dir_label"]
            mask_pred, direction = self.predict(batch["image"], tuple(gt_mask.shape[1:3]))
            dir_pred = direction.argmax(-1)
            boundary = mask_pred == 1
            totals[0] += confusion_matrix(mask_pred, gt_mask, 2)  # -1 gt is ignored
            totals[1] += confusion_matrix(dir_pred, torch.where(boundary, gt_dir, -1), d)
            totals[2] += confusion_matrix(torch.where(boundary, dir_pred, d), gt_dir, d + 1)
            n_images += batch["image"].shape[0]
        totals, n_images = _summed(totals, n_images)
        for score, total in zip((self.mask_score, self.dir_mask_score, self.dir_gt_score),
                                totals):
            score.update_confusion(total)
        scores = {"mask_acc": self.mask_score.get_pixel_acc(),
                  "dir_acc_mask": self.dir_mask_score.get_pixel_acc(),
                  "dir_acc_gt": self.dir_gt_score.get_pixel_acc()}
        # The headline, for save_by_mode, as in the seg task.
        scores["miou"] = scores["dir_acc_gt"]
        scores["pixel_acc"] = scores["mask_acc"]
        return scores, n_images


class MLDirectionEvaluator(_OffsetEvaluator):
    """MLDirectionTask: the top-``topk`` direction vectors of each pixel
    summed by their logits (``ml_dir``, else ``dir``) and re-quantised, on
    the host, against the bit-packed multi-label ``ml_dir_label``, where
    the predicted mask is 1 (``ml_dir_acc_mask``) and where the ground-truth
    mask is 1 (``ml_dir_acc_gt``, the headline)."""

    direction_key = "ml_dir"

    def __init__(self, model: nn.Module, topk: int = 8):
        super().__init__(model)
        self.topk = topk
        self.reset()

    def reset(self) -> None:
        self.score_mask = MultiLabelRunningScore()
        self.score_gt = MultiLabelRunningScore()

    def _run(self, batches, device):
        from contrastiveseg_tpu_torch.utils.offset_helper import (
            encode_multi_labels,
            multilabel_direction_prediction,
        )

        self.reset()
        n_images = 0
        for batch in batches:
            gt_mask = np.asarray(batch["mask_label"])
            gt_ml = encode_multi_labels(np.asarray(batch["ml_dir_label"]).astype(np.int64))
            images = torch.as_tensor(np.ascontiguousarray(batch["image"])).to(device)
            mask_pred, ml_logits = self.predict(images, gt_mask.shape[1:3])
            mask_pred, ml_logits = mask_pred.cpu().numpy(), ml_logits.cpu().numpy()
            for b in range(mask_pred.shape[0]):
                dir_pred = multilabel_direction_prediction(
                    ml_logits[b], no_offset_mask=mask_pred[b] == 0, topk=self.topk)
                valid_gt = gt_ml[b].sum(-1) > 0
                self.score_mask.update(dir_pred.reshape(-1), gt_ml[b].reshape(-1, 8),
                                       ((mask_pred[b] == 1) & valid_gt).reshape(-1))
                self.score_gt.update(dir_pred.reshape(-1), gt_ml[b].reshape(-1, 8),
                                     ((gt_mask[b] == 1) & valid_gt).reshape(-1))
            n_images += mask_pred.shape[0]
        counts = torch.tensor([self.score_mask.correct, self.score_mask.total,
                               self.score_gt.correct, self.score_gt.total], device=device)
        (counts,), n_images = _summed([counts], n_images)
        (self.score_mask.correct, self.score_mask.total, self.score_gt.correct,
         self.score_gt.total) = counts.tolist()
        scores = {"ml_dir_acc_mask": self.score_mask.get_mean_acc(),
                  "ml_dir_acc_gt": self.score_gt.get_mean_acc()}
        scores["miou"] = scores["ml_dir_acc_gt"]  # the headline (tasks.py:171)
        scores["pixel_acc"] = scores["ml_dir_acc_mask"]
        return scores, n_images


def build_evaluator(cfg, model: nn.Module):
    """Pick the task evaluator from the config (evaluator/__init__.py:11):
    ``val.evaluator``, or ``segfix`` for a ``segfix*`` net and ``seg``
    otherwise; ``ml_dir``/``ml_direction`` the multi-label one."""
    kind = cfg.get("val.evaluator", default=None)
    if kind is None:
        kind = ("segfix" if cfg.get("network.model_name", default="")
                .startswith("segfix") else "seg")
    if kind in ("ml_dir", "ml_direction"):
        return MLDirectionEvaluator(model)
    if kind == "segfix":
        return SegFixEvaluator(model, cfg.get("segfix.num_directions", default=8))
    return Evaluator(
        model,
        cfg.get("data.num_classes"),
        flip_average=cfg.get("val.flip_average", default=False),
        flip_pairs=[tuple(p) for p in cfg.get("data.label_pairs", default=[]) or []],
    )
