"""Loss registry of the port, keyed by the reference's ``loss_type`` strings.

Counterpart of ``contrastiveseg_tpu/losses/manager.py`` (SEG_LOSS_DICT,
lib/loss/loss_manager.py:27-42), with the JAX builders' config reads.  The
RMI, Lovasz and SegFix losses are not ported (ROADMAP 8) and are
refused by name.
"""

from __future__ import annotations

from contrastiveseg_tpu_torch.losses.contrast import ContrastCELoss, PlainSegLoss
from contrastiveseg_tpu_torch.ops.contrast import ContrastSpec

_OTHER_LOSSES = "is not ported yet: ROADMAP 8 (other losses)"


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


def _contrast(cfg, use_aux: bool) -> ContrastCELoss:
    for key in ("contrast.use_rmi", "contrast.use_lovasz"):
        if cfg.get(key, default=False):
            raise NotImplementedError(f"{key}=true {_OTHER_LOSSES}")
    if cfg.exists("contrast.kernel"):
        raise ValueError(
            "contrast.kernel is not an option of the port: the InfoNCE runs "
            "on K1 for CUDA tensors and on its plain version for CPU tensors")
    return ContrastCELoss(
        spec=_contrast_spec(cfg),
        loss_weight=cfg.get("contrast.loss_weight", default=0.1),
        include_class0=cfg.get("contrast.include_class0", default=True),
        use_aux=use_aux,
        **_aux_weights(cfg),
        **_common(cfg),
    )


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
}

NOT_PORTED = ("rmi_loss", "fs_rmi_loss", "fs_aux_rmi_loss", "fs_ce_lovasz_loss",
              "ms_fs_aux_rmi_loss", "segfix_loss")


def build_loss(cfg):
    """LossManager.get_seg_loss for the losses the port has."""
    name = cfg.get("loss.loss_type")
    if name in NOT_PORTED:
        raise NotImplementedError(f"loss.loss_type={name!r} {_OTHER_LOSSES}")
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; the port has {sorted(LOSSES)}")
    return LOSSES[name](cfg)
