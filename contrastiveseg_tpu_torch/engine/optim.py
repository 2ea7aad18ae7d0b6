"""Optimizer and LR policy: torch SGD, Adam or AdamW + ``LambdaLR``.

Counterpart of ``contrastiveseg_tpu/engine/optim.py`` (reference
OptimScheduler, optim_scheduler.py:42-159), ``build_optimizer`` :87-150:

  * ``optim.optim_method`` ``sgd`` (momentum, nesterov) and ``adam``, both
    with *coupled* weight decay (L2 added to the gradient first: optax's
    ``add_decayed_weights`` before ``sgd``/``adam`` is torch's
    ``weight_decay``), and ``adamw``, decoupled (optax's ``adamw`` is
    torch's ``AdamW``; ``optim.adamw.weight_decay`` defaults to 0.01);
  * ``optim.group_method="decay"``: weight decay on conv and linear weights
    only (the JAX ``_kernel_only_mask``: the flax leaves named ``kernel``),
    not on biases, norm scales or position tables;
  * ``network.clip_grad_norm``: the gradients scaled by ``max_norm / norm``
    when their global norm is at least ``max_norm``, before any decay, as
    ``optax.clip_by_global_norm`` (torch's ``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead), in a step pre-hook of the optimizer;
  * the LR policies of ``build_schedule`` (:45-85): ``lambda_poly`` and
    ``swa_lambda_poly`` (``base_lr * (1 - step/max_iters)^power``),
    ``lambda_cosine``, ``swa_lambda_cosine`` and ``warmup_cosine`` (the
    clipped cosine), ``step`` (``lr.step.gamma`` every ``lr.step.step_size``
    steps), ``multistep`` (``lr.multistep.gamma`` at each of
    ``lr.multistep.stepvalue``) and ``plateau`` (constant), each with the
    optional warmup (``lr.is_warm``);
  * ``plateau``'s decay: ``PlateauController`` (:157-219), the torch
    ``ReduceLROnPlateau`` state machine, reads the validation metric and
    ``set_plateau_scale`` (:222-239) rescales the LR.  JAX multiplies the
    optimizer's update by the scale (``optax.chain(tx, scale)``), which for
    SGD, Adam and AdamW is the update of every group's LR times the scale:
    here ``PlateauLambdaLR`` folds it into the LR, and keeps it in its state;
  * backbone vs head LR groups through ``lr.nbb_mult``.

The scheduler is stepped after each optimizer step, so the LR of step k is
the schedule at k, the same count optax reads.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def poly_schedule(max_iters: int, power: float = 0.9) -> Callable[[int], float]:
    """Multiplier of base_lr at ``step``."""

    def factor(step: int) -> float:
        frac = min(max(step / max_iters, 0.0), 1.0)
        return (1.0 - frac) ** power

    return factor


def with_warmup(sched: Callable[[int], float], warm_iters: int,
                warm_power: float = 1.0) -> Callable[[int], float]:
    def warmed(step: int) -> float:
        base = sched(step)
        if step < warm_iters:
            return base * min(max((step + 1) / max(warm_iters, 1), 0.0), 1.0) ** warm_power
        return base

    return warmed


def cosine_schedule(max_iters: int) -> Callable[[int], float]:
    def factor(step: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(max(step / max_iters, 0.0), 1.0)))

    return factor


def build_schedule(cfg) -> Callable[[int], float]:
    """The multiplier of ``lr.base_lr`` at each step."""
    policy = cfg.get("lr.lr_policy", default="lambda_poly")
    max_iters = cfg.get("solver.max_iters", default=40000)
    if policy in ("lambda_poly", "swa_lambda_poly"):
        sched = poly_schedule(max_iters, float(cfg.get("lr.lambda_poly.power", default=0.9)))
    elif policy in ("lambda_cosine", "swa_lambda_cosine", "warmup_cosine"):
        sched = cosine_schedule(max_iters)
    elif policy == "step":
        gamma = cfg.get("lr.step.gamma", default=0.1)
        size = cfg.get("lr.step.step_size", default=100)

        def sched(step: int) -> float:
            return gamma ** (step // size)
    elif policy == "multistep":
        gamma = cfg.get("lr.multistep.gamma", default=0.1)
        stepvalues = cfg.get("lr.multistep.stepvalue", default=[])

        def sched(step: int) -> float:
            return gamma ** sum(step >= s for s in stepvalues)
    elif policy == "plateau":
        # Constant: PlateauController rescales it from the validation metric.
        def sched(step: int) -> float:
            return 1.0
    else:
        raise NotImplementedError(f"lr policy {policy!r}")
    if cfg.get("lr.is_warm", default=False):
        sched = with_warmup(sched, cfg.get("lr.warm.warm_iters", default=1000),
                            cfg.get("lr.warm.power", default=1.0))
    return sched


def _param_groups(cfg, model: torch.nn.Module, base_lr: float, weight_decay: float
                  ) -> list[dict]:
    """A group per (backbone or head, decayed or not) that has parameters:
    the heads at ``base_lr * lr.nbb_mult`` when it is not 1, and with
    ``optim.group_method="decay"`` only the conv and linear weights at
    ``weight_decay``."""
    method = cfg.get("optim.group_method", default=None)
    if method not in (None, "decay"):
        raise NotImplementedError(f"optim.group_method {method!r}")
    nbb_mult = float(cfg.get("lr.nbb_mult", default=1.0))
    backbone = ({id(q) for q in model.backbone.parameters()} if nbb_mult != 1.0
                else {id(q) for q in model.parameters()})
    decayed = ({id(m.weight) for m in model.modules()
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
               if method == "decay" else {id(q) for q in model.parameters()})
    groups = []
    for in_backbone in (True, False):
        for decays in (True, False):
            params = [q for q in model.parameters()
                      if (id(q) in backbone) == in_backbone and (id(q) in decayed) == decays]
            if params:
                groups.append({"params": params,
                               "lr": base_lr * (1.0 if in_backbone else nbb_mult),
                               "weight_decay": weight_decay if decays else 0.0})
    return groups


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the ``.grad`` of ``params``: each
    scaled to ``g / norm * max_norm`` when the global norm is at least
    ``max_norm``, without a host sync."""
    grads = [q.grad for q in params if q.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def build_optimizer(cfg, model: torch.nn.Module):
    """-> (the optimizer, its LambdaLR)."""
    method = cfg.get("optim.optim_method", default="sgd")
    base_lr = cfg.get("lr.base_lr")
    if method == "sgd":
        p = cfg.get("optim.sgd", default={})
        opt = torch.optim.SGD(_param_groups(cfg, model, base_lr, p.get("weight_decay", 0.0)),
                              lr=base_lr, momentum=p.get("momentum", 0.9),
                              nesterov=p.get("nesterov", False))
    elif method in ("adam", "adamw"):
        p = cfg.get(f"optim.{method}", default={})
        decay = p.get("weight_decay", 0.0 if method == "adam" else 0.01)
        cls = torch.optim.Adam if method == "adam" else torch.optim.AdamW
        opt = cls(_param_groups(cfg, model, base_lr, decay), lr=base_lr,
                  betas=tuple(p.get("betas", [0.9, 0.999])), eps=p.get("eps", 1e-8))
    else:
        raise NotImplementedError(f"optim.optim_method={method!r}; the port has sgd, adam "
                                  "and adamw")
    clip = cfg.get("network.clip_grad_norm", default=None)
    if clip:
        params = list(model.parameters())
        opt.register_step_pre_hook(
            lambda *_: clip_by_global_norm(params, float(clip)))
    return opt, PlateauLambdaLR(opt, build_schedule(cfg))


class PlateauLambdaLR(torch.optim.lr_scheduler.LambdaLR):
    """``LambdaLR`` whose LRs are also multiplied by ``plateau_scale`` (1
    unless ``set_plateau_scale`` changes it); the scale is part of
    ``state_dict``, as the JAX scale is part of the optimizer state."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr_lambda: Callable[[int], float]):
        self.plateau_scale = 1.0
        super().__init__(optimizer, lr_lambda)

    def get_lr(self) -> list[float]:
        return [lr * self.plateau_scale for lr in super().get_lr()]


def set_plateau_scale(scheduler: PlateauLambdaLR, scale: float) -> None:
    """Set the plateau scale, and with it the LR of the next optimizer step
    (the JAX ``set_plateau_scale`` rewrites the scale the next update reads)."""
    scheduler.plateau_scale = float(scale)
    lrs = [base * lam(scheduler.last_epoch) * scheduler.plateau_scale
           for lam, base in zip(scheduler.lr_lambdas, scheduler.base_lrs)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


class PlateauController:
    """torch ``ReduceLROnPlateau``'s state machine on a multiplicative scale
    (a copy of the JAX ``PlateauController``): mode, factor, patience,
    threshold, threshold mode, cooldown and ``min_lr`` as the reference's
    plateau settings (optim_scheduler.py:117-125).  ``step(metric)`` returns
    the LR scale in [min_scale, 1], which the trainer hands to
    ``set_plateau_scale``."""

    def __init__(self, mode: str = "max", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_scale: float = 0.0):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"plateau mode {mode!r}, threshold mode {threshold_mode!r}")
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_scale = cooldown, min_scale
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0
        self.cooldown_left = 0
        self.scale = 1.0

    @classmethod
    def from_config(cls, cfg) -> "PlateauController":
        p = cfg.get("lr.plateau", default={})
        base_lr = float(cfg.get("lr.base_lr"))
        return cls(
            mode=p.get("mode", "max"),
            factor=p.get("factor", 0.1),
            patience=p.get("patience", 10),
            threshold=p.get("threshold", 1e-4),
            threshold_mode=p.get("thre_mode", p.get("threshold_mode", "rel")),
            cooldown=p.get("cooldown", 0),
            min_scale=p.get("min_lr", 0.0) / base_lr if base_lr else 0.0,
        )

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            thr = (self.best * (1 - self.threshold) if self.threshold_mode == "rel"
                   else self.best - self.threshold)
            return metric < thr
        thr = (self.best * (1 + self.threshold) if self.threshold_mode == "rel"
               else self.best + self.threshold)
        return metric > thr

    def step(self, metric: float) -> float:
        # torch's ReduceLROnPlateau.step order: the cooldown counts down each
        # step (and clears num_bad), then the decay check.
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.cooldown_left = self.cooldown
            self.num_bad = 0
        return self.scale
