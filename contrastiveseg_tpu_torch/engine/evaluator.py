"""Validation of the segmentation task: forward, upsampled argmax, confusion.

Counterpart of ``Evaluator`` and ``build_evaluator`` in
``contrastiveseg_tpu/engine/evaluator.py`` (:41-138, :298-320; the
reference's SegTask): the eval-mode forward, the optional flip average with
left/right class swaps, the stride-4 logits resized to the label's size
(bilinear, align_corners), argmax, and the confusion matrix accumulated on
the device, read once at the end of the run.

Not ported yet (ROADMAP 12): the SegFix and multi-label direction
evaluators, the diverse-size (per-image) batches and the mesh padding of
short batches.
"""

from __future__ import annotations

import time
from typing import Iterable, Sequence

import torch
from torch import nn

from contrastiveseg_tpu_torch.engine.prefetch import device_batches
from contrastiveseg_tpu_torch.metrics.running_score import RunningScore
from contrastiveseg_tpu_torch.ops.confusion import confusion_matrix
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners


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
            self.score.update_confusion(total)  # syncs the device
        finally:
            self.model.train(was_training)
        scores = self.score.get_scores()
        scores["images_per_sec"] = n_images / max(time.perf_counter() - t0, 1e-9)
        return scores


def build_evaluator(cfg, model: nn.Module) -> Evaluator:
    """Pick the task evaluator from the config; only the seg task is ported."""
    kind = cfg.get("val.evaluator", default=None)
    if kind is None:
        kind = ("segfix" if cfg.get("network.model_name", default="")
                .startswith("segfix") else "seg")
    if kind != "seg":
        raise NotImplementedError(
            f"val.evaluator={kind!r} is not ported yet: ROADMAP 12 (only 'seg' is)")
    return Evaluator(
        model,
        cfg.get("data.num_classes"),
        flip_average=cfg.get("val.flip_average", default=False),
        flip_pairs=[tuple(p) for p in cfg.get("data.label_pairs", default=[]) or []],
    )
