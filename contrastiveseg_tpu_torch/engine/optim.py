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
    sched = torch.optim.lr_scheduler.LambdaLR(opt, build_schedule(cfg))
    return opt, sched
