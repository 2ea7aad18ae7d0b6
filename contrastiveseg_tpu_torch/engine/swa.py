"""Stochastic Weight Averaging and the BN re-estimation that follows it.

Counterpart of ``contrastiveseg_tpu/engine/swa.py`` (:17-66) and of the
JAX trainer's SWA schedule and ``_reestimate_bn`` (``engine/trainer.py``
:263-273, 303-310, 335-382); the reference's ``swa_lambda_poly`` and
``swa_lambda_cosine`` policies wrap torchcontrib's SWA optimizer
(segmentor/tools/optim_scheduler.py:99-131) and swap and re-estimate at the
end (trainer_contrastive.py:291-296, 422-425).  The average is a running
mean of the parameters, kept beside the model and updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch
from torch import nn


@dataclasses.dataclass
class SWAState:
    avg_params: dict[str, torch.Tensor]  # by ``named_parameters`` name
    n_averaged: int = 0


def init_swa(model: nn.Module) -> SWAState:
    return SWAState({name: torch.zeros_like(p) for name, p in model.named_parameters()})


@torch.no_grad()
def update_swa(swa: SWAState, model: nn.Module) -> SWAState:
    """``avg = (avg * n + p) / (n + 1)`` for every parameter, ``n += 1``
    (torchcontrib ``SWA.update_swa``)."""
    n = swa.n_averaged
    for name, p in model.named_parameters():
        swa.avg_params[name].mul_(n).add_(p).div_(n + 1)
    swa.n_averaged = n + 1
    return swa


def maybe_update_swa(swa: SWAState, model: nn.Module, step: int, swa_start: int,
                     swa_freq: int) -> SWAState:
    """``update_swa`` when ``step >= swa_start`` and on the cycle."""
    if step >= swa_start and (step - swa_start) % swa_freq == 0:
        update_swa(swa, model)
    return swa


@torch.no_grad()
def swap_to_swa(model: nn.Module, swa: SWAState) -> None:
    """Load the averaged parameters into ``model``; its BN statistics are
    the last step's until ``reestimate_bn`` runs."""
    for name, p in model.named_parameters():
        p.copy_(swa.avg_params[name])


def swa_due(iteration: int, max_iters: int) -> bool:
    """Whether the trainer averages after its ``iteration``-th step (counted
    from 1): five evenly spaced points in the last quarter of training and
    the last step (JAX ``trainer.py:268-270, 303-305``)."""
    normal = int(max_iters * 0.75)
    every = (max_iters - normal) // 5 + 1
    return iteration > normal and ((iteration - normal) % every == 0
                                   or iteration == max_iters)


@torch.no_grad()
def reestimate_bn(model: nn.Module, batches: Iterator[dict], num_batches: int = 20) -> None:
    """torchcontrib's ``bn_update``: every BN's running statistics become the
    plain average of its batch statistics over ``num_batches`` train-mode
    forwards (the statistics reset, ``momentum=None``: torch's cumulative
    average); the momenta are restored after.  The JAX trainer recovers each
    batch's statistics from flax's moving average and averages them
    (``trainer.py:345-382``), which is the same average."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    try:
        for _ in range(num_batches):
            model(next(batches)["image"])
    finally:
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
