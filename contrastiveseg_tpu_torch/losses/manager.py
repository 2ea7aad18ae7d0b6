"""Loss registry of the port, keyed by the reference's ``loss_type`` strings.

Counterpart of ``contrastiveseg_tpu/losses/manager.py`` (SEG_LOSS_DICT,
lib/loss/loss_manager.py:27-42), with the JAX builders' config reads: the
CE and OHEM losses, the contrast losses (their seg term CE, RMI with
``contrast.use_rmi`` or CE + Lovasz with ``contrast.use_lovasz``), the RMI
losses (``rmi_loss``, ``fs_rmi_loss``, ``fs_aux_rmi_loss``; :94-183) and
``fs_ce_lovasz_loss`` (:186-207), MscaleOCR's ``ms_fs_aux_rmi_loss``
(:221-249) and ``segfix_loss`` (:252-259, ``losses/segfix.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from contrastiveseg_tpu_torch.losses.ce import cross_entropy
from contrastiveseg_tpu_torch.losses.contrast import ContrastCELoss, PlainSegLoss
from contrastiveseg_tpu_torch.losses.lovasz import ce_lovasz_loss
from contrastiveseg_tpu_torch.losses.rmi import rmi_loss
from contrastiveseg_tpu_torch.losses.segfix import SegFixLoss
from contrastiveseg_tpu_torch.ops.contrast import ContrastSpec
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners


def _common(cfg) -> dict:
    params = cfg.get("loss.params", default={})
    cw = params.get("ce_weight")
    return {"class_weight": tuple(cw) if cw else None,
            "ignore_index": params.get("ce_ignore_index", -1)}


def _aux_weights(cfg) -> dict:
    lw = cfg.get("network.loss_weights", default={})
    return {"aux_weight": lw.get("aux_loss", 0.4), "seg_weight": lw.get("seg_loss", 1.0)}


def _ohem(cfg) -> dict:
    params = cfg.get("loss.params", default={})
    return {"use_ohem": True, "ohem_thresh": params.get("ohem_thresh", 0.9),
            "ohem_minkeep": params.get("ohem_minkeep", 100000)}


def _contrast_spec(cfg) -> ContrastSpec:
    return ContrastSpec(
        num_classes=cfg.get("data.num_classes"),
        max_samples=cfg.get("contrast.max_samples", default=1024),
        max_views=cfg.get("contrast.max_views", default=100),
        temperature=cfg.get("contrast.temperature", default=0.1),
        base_temperature=cfg.get("contrast.base_temperature", default=0.07),
    )


def _rmi_params(cfg) -> dict:
    p = cfg.get("loss.params", default={})
    return {"radius": p.get("rmi_radius", 3), "pool_size": p.get("rmi_pool_size", 3),
            "pool_stride": p.get("rmi_pool_stride", 3), "pool_way": p.get("rmi_pool_way", 0),
            "weight_lambda": p.get("loss_weight_lambda", 0.5),
            "lambda_way": p.get("lambda_way", 1), "loss_weight": p.get("loss_weight", 1.0)}


def _contrast(cfg, use_aux: bool) -> ContrastCELoss:
    kind = "ce"
    if cfg.get("contrast.use_rmi", default=False):
        kind = "rmi"
    elif cfg.get("contrast.use_lovasz", default=False):
        kind = "lovasz"
    if cfg.exists("contrast.kernel"):
        raise ValueError(
            "contrast.kernel is not an option of the port: the InfoNCE runs "
            "on K1 for CUDA tensors and on its plain version for CPU tensors")
    return ContrastCELoss(
        spec=_contrast_spec(cfg),
        loss_weight=cfg.get("contrast.loss_weight", default=0.1),
        include_class0=cfg.get("contrast.include_class0", default=True),
        use_aux=use_aux,
        seg_loss_kind=kind,
        rmi_params=_rmi_params(cfg) if kind == "rmi" else None,
        **_aux_weights(cfg),
        **_common(cfg),
    )


def _full_res(x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_align_corners(x, (targets.shape[1], targets.shape[2]))


@dataclasses.dataclass(frozen=True)
class RMISegLoss:
    """``rmi_loss``/``fs_rmi_loss`` (RMI on ``seg``) and ``fs_aux_rmi_loss``
    (plus ``aux_weight`` times the CE of ``seg_aux``), the logits upsampled
    to the labels; ``loss_seg`` is the total, as in the JAX package."""

    num_classes: int
    rmi_params: dict
    use_aux: bool = False
    aux_weight: float = 0.4
    seg_weight: float = 1.0
    class_weight: Optional[tuple[float, ...]] = None
    ignore_index: int = -1

    def __call__(self, outputs, targets, with_embed=True, bank=None, scores=None,
                 generator=None):
        loss = rmi_loss(_full_res(outputs["seg"], targets), targets, self.num_classes,
                        **self.rmi_params)
        if self.use_aux and "seg_aux" in outputs:
            loss = self.seg_weight * loss + self.aux_weight * cross_entropy(
                _full_res(outputs["seg_aux"], targets), targets, self.class_weight,
                self.ignore_index)
        return loss, {"loss_seg": loss, "loss": loss}


@dataclasses.dataclass(frozen=True)
class LovaszSegLoss:
    """``fs_ce_lovasz_loss``: CE + Lovasz-Softmax of ``seg``, upsampled."""

    class_weight: Optional[tuple[float, ...]] = None
    ignore_index: int = -1

    def __call__(self, outputs, targets, with_embed=True, bank=None, scores=None,
                 generator=None):
        loss = ce_lovasz_loss(_full_res(outputs["seg"], targets), targets, self.class_weight,
                              self.ignore_index)
        return loss, {"loss_seg": loss, "loss": loss}


@dataclasses.dataclass(frozen=True)
class MsAuxRMILoss:
    """``ms_fs_aux_rmi_loss``: ``fs_aux_rmi_loss`` on ``seg`` and
    ``seg_aux``, plus ``scale_weight`` times the CE of each of MscaleOCR's
    ``pred_05x`` and ``pred_10x`` (the labels scaled nearest to
    ``pred_05x``'s half size); ``loss_seg`` is the RMI + aux term."""

    rmi: RMISegLoss
    scale_weight: float = 0.05
    class_weight: Optional[tuple[float, ...]] = None
    ignore_index: int = -1

    def __call__(self, outputs, targets, with_embed=True, bank=None, scores=None,
                 generator=None):
        loss, metrics = self.rmi(outputs, targets)
        for k in ("pred_05x", "pred_10x"):
            if k in outputs:
                loss = loss + self.scale_weight * cross_entropy(
                    outputs[k], targets, self.class_weight, self.ignore_index)
        return loss, {**metrics, "loss": loss}


def _rmi(cfg, use_aux: bool) -> RMISegLoss:
    return RMISegLoss(cfg.get("data.num_classes"), _rmi_params(cfg), use_aux,
                      **_aux_weights(cfg), **_common(cfg))


LOSSES = {
    "fs_ce_loss": lambda cfg: PlainSegLoss(**_common(cfg)),
    "fs_ohemce_loss": lambda cfg: PlainSegLoss(**_ohem(cfg), **_common(cfg)),
    "fs_auxce_loss": lambda cfg: PlainSegLoss(
        use_aux=True, **_aux_weights(cfg), **_common(cfg)),
    "fs_auxohemce_loss": lambda cfg: PlainSegLoss(
        use_aux=True, **_ohem(cfg), **_aux_weights(cfg), **_common(cfg)),
    "fs_auxce_dsn_loss": lambda cfg: PlainSegLoss(
        dsn=True, **_aux_weights(cfg), **_common(cfg)),
    "contrast_ce_loss": lambda cfg: _contrast(cfg, use_aux=False),
    "contrast_auxce_loss": lambda cfg: _contrast(cfg, use_aux=True),
    # The mem variants are the same callable; the train step passes the bank.
    "mem_contrast_ce_loss": lambda cfg: _contrast(cfg, use_aux=False),
    "mem_contrast_auxce_loss": lambda cfg: _contrast(cfg, use_aux=True),
    "rmi_loss": lambda cfg: _rmi(cfg, use_aux=False),
    "fs_rmi_loss": lambda cfg: _rmi(cfg, use_aux=False),
    "fs_aux_rmi_loss": lambda cfg: _rmi(cfg, use_aux=True),
    "fs_ce_lovasz_loss": lambda cfg: LovaszSegLoss(**_common(cfg)),
    "ms_fs_aux_rmi_loss": lambda cfg: MsAuxRMILoss(
        _rmi(cfg, use_aux=True),
        cfg.get("loss.params.ms_scale_weight", default=0.05), **_common(cfg)),
    "segfix_loss": lambda cfg: SegFixLoss(
        num_directions=cfg.get("data.dt_num_classes", default=8),
        mask_threshold=cfg.get("loss.params.mask_threshold", default=0.5),
        mask_weight=cfg.get("loss.params.mask_weight", default=1.0),
        direction_weight=cfg.get("loss.params.direction_weight", default=1.0)),
}



def build_loss(cfg):
    """LossManager.get_seg_loss for the losses the port has."""
    name = cfg.get("loss.loss_type")
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; the port has {sorted(LOSSES)}")
    return LOSSES[name](cfg)
