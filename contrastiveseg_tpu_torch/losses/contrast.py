"""Composite training losses: contrast + CE, and the plain seg losses.

Counterpart of ``contrastiveseg_tpu/losses/contrast.py``:

* ``ContrastCELoss`` (:26) for ``contrast_ce_loss``, ``contrast_auxce_loss``
  and ``mem_contrast_ce_loss``.  The seg term is the row-blocked upsampled
  CE (:61-70) or, with ``use_aux``, the CE of the upsampled seg and aux
  logits (:95-101); with ``seg_loss_kind`` "rmi" (``contrast.use_rmi``) the
  RMI loss of the upsampled seg logits, plus the aux CE with ``use_aux``
  (:73-88), and with "lovasz" (``contrast.use_lovasz``) CE + Lovasz of the
  upsampled seg logits (:89-94).  The contrast term samples hard anchors (those
  of the global batch under a process group, ``ops/contrast.global_anchor_sample``,
  with the CE's mean the global batch's too, ``losses/ce.py``) and scores them
  against the memory bank through K1 (``ops/contrast_cuda.py``, whose
  wrappers launch the CUDA kernels for CUDA tensors and take the plain
  version for CPU tensors), or, with no bank, against each other in the
  dense InfoNCE (``_finish``, :110-158).  As in the reference, the contrast
  term is always computed and multiplied by 0 before warmup.
* ``PlainSegLoss`` (:162-226) for the ``fs_*`` losses: CE or OHEM on the
  seg head, plus the aux or deeply-supervised heads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from contrastiveseg_tpu_torch.losses.ce import (
    aux_cross_entropy,
    cross_entropy,
    ohem_cross_entropy,
    upsampled_cross_entropy,
)
from contrastiveseg_tpu_torch.losses.lovasz import ce_lovasz_loss
from contrastiveseg_tpu_torch.losses.rmi import rmi_loss
from contrastiveseg_tpu_torch.ops.contrast import (
    ContrastSpec,
    global_anchor_sample,
    pixel_contrast_loss,
)
from contrastiveseg_tpu_torch.ops.contrast_cuda import cuda_contrastive_loss
from contrastiveseg_tpu_torch.ops.queue import MemoryBank, bank_as_contrast_set
from contrastiveseg_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    scale_target_nearest,
)


class AnchorScores(NamedTuple):
    hard: torch.Tensor  # [B, C, N] uniform draws for the hard pools
    easy: torch.Tensor  # [B, C, N] uniform draws for the easy pools


@dataclasses.dataclass(frozen=True)
class ContrastCELoss:
    """CE + loss_weight * InfoNCE, against the bank when one is passed."""

    spec: ContrastSpec
    loss_weight: float = 0.1
    class_weight: Optional[tuple[float, ...]] = None
    ignore_index: int = -1
    include_class0: bool = True
    use_aux: bool = False
    aux_weight: float = 0.4
    seg_weight: float = 1.0
    seg_loss_kind: str = "ce"  # ce | rmi | lovasz (contrast.use_rmi / use_lovasz)
    rmi_params: Optional[dict] = None

    def __call__(
        self,
        outputs: dict[str, torch.Tensor],
        targets: torch.Tensor,  # [B, H, W] int labels at full res
        with_embed: bool,
        bank: Optional[MemoryBank] = None,
        scores: Optional[AnchorScores] = None,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        seg = outputs["seg"]  # [B, h, w, C] stride-level logits
        embed = outputs["embed"]  # [B, h, w, D]
        size = (targets.shape[1], targets.shape[2])
        if self.seg_loss_kind == "rmi":
            seg_loss = rmi_loss(resize_bilinear_align_corners(seg, size), targets,
                                seg.shape[-1], **(self.rmi_params or {}))
            if self.use_aux:
                seg_loss = self.seg_weight * seg_loss + self.aux_weight * cross_entropy(
                    resize_bilinear_align_corners(outputs["seg_aux"], size), targets,
                    self.class_weight, self.ignore_index)
        elif self.seg_loss_kind == "lovasz":
            seg_loss = ce_lovasz_loss(resize_bilinear_align_corners(seg, size), targets,
                                      self.class_weight, self.ignore_index)
        elif self.use_aux:
            seg_loss = aux_cross_entropy(
                resize_bilinear_align_corners(seg, size),
                resize_bilinear_align_corners(outputs["seg_aux"], size), targets,
                seg_weight=self.seg_weight, aux_weight=self.aux_weight,
                class_weight=self.class_weight, ignore_index=self.ignore_index)
        else:
            seg_loss = upsampled_cross_entropy(seg, targets, self.class_weight,
                                               self.ignore_index)

        predict = seg.argmax(-1)
        if bank is None:
            contrast = pixel_contrast_loss(embed, targets, predict, self.spec,
                                           scores=scores, generator=generator)
        else:
            q_f, q_l, q_v = bank_as_contrast_set(bank, self.include_class0)
            B, H, W, D = embed.shape
            labels_s = scale_target_nearest(targets, (H, W)).reshape(B, H * W)
            anchors = global_anchor_sample(
                embed.reshape(B, H * W, D), labels_s, predict.reshape(B, H * W),
                self.spec, scores=scores, generator=generator)
            contrast = cuda_contrastive_loss(
                anchors.feats, anchors.labels, anchors.valid, q_f, q_l, q_v,
                self.spec.temperature, self.spec.base_temperature)
        gate = 1.0 if with_embed else 0.0
        total = seg_loss + gate * self.loss_weight * contrast
        return total, {"loss_seg": seg_loss, "loss_contrast": contrast,
                       "loss": total}


@dataclasses.dataclass(frozen=True)
class PlainSegLoss:
    """``fs_ce_loss`` / ``fs_ohemce_loss`` / ``fs_auxce_loss`` /
    ``fs_auxohemce_loss`` / ``fs_auxce_dsn_loss`` on full-resolution (or
    upsampled) logits.

    ``use_aux + use_ohem`` = FSAuxOhemCELoss (OHEM on the seg head, plain CE
    on aux, loss_helper.py:264-281); ``dsn`` = FSAuxCELossDSN (seg CE plus
    the mean CE over the ``seg_aux*`` heads, loss_helper.py:284-298).
    """

    class_weight: Optional[tuple[float, ...]] = None
    ignore_index: int = -1
    use_aux: bool = False
    aux_weight: float = 0.4
    seg_weight: float = 1.0
    use_ohem: bool = False
    ohem_thresh: float = 0.9
    ohem_minkeep: int = 100000
    dsn: bool = False

    def __call__(
        self,
        outputs: dict[str, torch.Tensor],
        targets: torch.Tensor,
        with_embed: bool = True,
        bank: Optional[MemoryBank] = None,
        scores: Optional[AnchorScores] = None,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        size = (targets.shape[1], targets.shape[2])

        def ce(x):
            return cross_entropy(resize_bilinear_align_corners(x, size), targets,
                                 self.class_weight, self.ignore_index)

        seg = resize_bilinear_align_corners(outputs["seg"], size)
        if self.use_ohem:
            seg_loss = ohem_cross_entropy(seg, targets, self.ohem_thresh,
                                          self.ohem_minkeep, self.class_weight,
                                          self.ignore_index)
        else:
            seg_loss = cross_entropy(seg, targets, self.class_weight, self.ignore_index)

        if self.dsn:
            aux = [ce(outputs[k]) for k in sorted(outputs) if k.startswith("seg_aux")]
            loss = self.seg_weight * seg_loss + self.aux_weight * (sum(aux) / max(len(aux), 1))
        elif self.use_aux and "seg_aux" in outputs:
            loss = self.seg_weight * seg_loss + self.aux_weight * ce(outputs["seg_aux"])
        else:
            loss = seg_loss
        return loss, {"loss_seg": loss, "loss": loss}
