"""Train state: everything a train step needs, on one explicit device.

Counterpart of ``contrastiveseg_tpu/engine/state.py`` (``create_train_state``
:107).  The JAX state is an immutable pytree; here it is a plain object whose
model, optimizer, scheduler and bank are updated in place by the train step.
Randomness comes from one host ``torch.Generator`` (the counterpart of the
JAX ``rng`` key), from which each use draws its own seed, the way
``jax.random.split`` hands out keys.  With ``contrast.momentum_encoder`` the
state also holds the key encoder's parameters (JAX ``state.py:30``), an EMA
of the model's, by ``named_parameters`` name; they start as a copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from contrastiveseg_tpu_torch.engine.optim import build_optimizer
from contrastiveseg_tpu_torch.ops.queue import MemoryBank, bank_from_queues, init_memory_bank
from contrastiveseg_tpu_torch.utils.pretrained import QUEUE_KEYS, load_pretrained


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    bank: Optional[MemoryBank]
    generator: torch.Generator  # host rng; split per step
    device: torch.device
    step: int = 0
    key_params: Optional[dict[str, torch.Tensor]] = None  # contrast.momentum_encoder
    # The model's DistributedDataParallel wrapper under a process group
    # (``parallel.data_parallel``); the train step's query forward runs it.
    ddp: Optional[nn.Module] = None


def split(generator: torch.Generator, n: int) -> list[int]:
    """Draw ``n`` independent seeds (the counterpart of ``jax.random.split``)."""
    return torch.randint(0, 2**62, (n,), generator=generator).tolist()


def device_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: conv and linear kernels lecun-normal (flax's default,
    std 1/sqrt(fan_in), a grouped conv's fan-in that of one group), or 0
    where the conv is marked ``zero_init`` (BaseOC's ``W``,
    ``models/layers.conv``); biases 0, BN scale 1 / bias 0 / stats 0, 1,
    LayerNorm scale 1 / bias 0; a module's other tensors from its own
    ``seeded_init(generator)`` (the ViT and PVT position tables) where it
    has one.  Other parameters (CCNet's ``gamma``) keep their own init."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
            m.weight.copy_(0 * w if getattr(m, "zero_init", False) else w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)


def create_train_state(cfg, model: nn.Module, device: torch.device | str,
                       pretrained: Optional[str] = None) -> TrainState:
    """Init the weights from ``cfg.seed``, load ``pretrained`` (a reference
    ``.pth``, ``utils/pretrained.py``) over them, move the model to
    ``device``, and build the optimizer, the LR schedule and (with memory)
    the bank, which the file's queue buffers seed when it has them (JAX
    ``engine/trainer.py:58-100``), and with ``contrast.momentum_encoder``
    the key parameters, a copy of the model's (:103-105)."""
    device = torch.device(device)
    rng = torch.Generator().manual_seed(cfg.get("seed", default=304))
    s_params, s_bank, s_state = split(rng, 3)
    init_weights(model, torch.Generator().manual_seed(s_params))
    queues = load_pretrained(model, pretrained) if pretrained else None
    model.to(device)
    optimizer, scheduler = build_optimizer(cfg, model)
    bank = None
    with_memory = cfg.get("contrast.with_memory", default=False)
    if queues is not None and not with_memory:
        raise ValueError(f"{pretrained} carries memory queues, but the config has "
                         "contrast.with_memory=false")
    if with_memory:
        C = cfg.get("data.num_classes")
        M = cfg.get("contrast.memory_size", default=5000)
        D = cfg.get("contrast.proj_dim", default=256)
        if queues is None:
            bank = init_memory_bank(C, M, D, generator=device_generator(s_bank, device),
                                    device=device)
        else:
            for key in ("segment_queue", "pixel_queue"):
                if tuple(queues[key].shape) != (C, M, D):
                    raise ValueError(f"{pretrained}: {key} has shape "
                                     f"{tuple(queues[key].shape)}, the config's bank "
                                     f"{(C, M, D)}")
            bank = bank_from_queues(*(queues[k].to(device) for k in QUEUE_KEYS))
    key_params = None
    if cfg.get("contrast.momentum_encoder", default=False):
        key_params = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      bank=bank, generator=torch.Generator().manual_seed(s_state),
                      device=device, key_params=key_params)
