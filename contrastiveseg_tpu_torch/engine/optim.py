"""Optimizer and LR policy: torch SGD + ``LambdaLR``.

Counterpart of ``contrastiveseg_tpu/engine/optim.py`` for the published
configs' recipe (reference OptimScheduler, optim_scheduler.py:42-159):

  * SGD with momentum and *coupled* weight decay on every parameter (L2 added
    to the gradient before the momentum buffer: torch's ``weight_decay`` and
    optax's ``add_decayed_weights`` + ``sgd`` are the same update);
  * ``lambda_poly``: ``lr = base_lr * (1 - step/max_iters)^power``, with the
    optional linear warmup (``lr.is_warm``);
  * backbone vs head LR groups through ``lr.nbb_mult``.

The scheduler is stepped after each optimizer step, so the LR of step k is
the schedule at k, the same count optax reads.
"""

from __future__ import annotations

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


def build_schedule(cfg) -> Callable[[int], float]:
    policy = cfg.get("lr.lr_policy", default="lambda_poly")
    if policy != "lambda_poly":
        raise NotImplementedError(
            f"lr.lr_policy={policy!r} is not ported yet (ROADMAP 5, training extras); "
            "the port has lambda_poly")
    sched = poly_schedule(cfg.get("solver.max_iters", default=40000),
                          float(cfg.get("lr.lambda_poly.power", default=0.9)))
    if cfg.get("lr.is_warm", default=False):
        sched = with_warmup(sched, cfg.get("lr.warm.warm_iters", default=1000),
                            cfg.get("lr.warm.power", default=1.0))
    return sched


def build_optimizer(cfg, model: torch.nn.Module):
    """-> (torch.optim.SGD, LambdaLR).  Two param groups when
    ``lr.nbb_mult != 1``: the backbone at base_lr, the heads at
    base_lr * nbb_mult."""
    method = cfg.get("optim.optim_method", default="sgd")
    if method != "sgd":
        raise NotImplementedError(f"optim.optim_method={method!r} is not ported yet: ROADMAP 5")
    if cfg.get("optim.group_method", default=None) is not None:
        raise NotImplementedError("optim.group_method is not ported yet: ROADMAP 5")
    if cfg.get("network.clip_grad_norm", default=None):
        raise NotImplementedError("network.clip_grad_norm is not ported yet: ROADMAP 5")
    base_lr = cfg.get("lr.base_lr")
    nbb_mult = float(cfg.get("lr.nbb_mult", default=1.0))
    p = cfg.get("optim.sgd", default={})
    if nbb_mult == 1.0:
        groups = [{"params": list(model.parameters()), "lr": base_lr}]
    else:
        backbone = {id(q) for q in model.backbone.parameters()}
        groups = [
            {"params": [q for q in model.parameters() if id(q) in backbone],
             "lr": base_lr},
            {"params": [q for q in model.parameters() if id(q) not in backbone],
             "lr": base_lr * nbb_mult},
        ]
    opt = torch.optim.SGD(groups, lr=base_lr, momentum=p.get("momentum", 0.9),
                          weight_decay=p.get("weight_decay", 0.0),
                          nesterov=p.get("nesterov", False))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, build_schedule(cfg))
    return opt, sched
