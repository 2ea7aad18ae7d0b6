"""The train step of the port.

Counterpart of ``make_train_step`` in ``contrastiveseg_tpu/engine/train_step.py``
(:24-138), the single-program path: split the rng, forward, loss with the
contrast term gated by ``step >= warmup_iters``, backward, enqueue the
detached embeddings with stride-subsampled labels (only when the state has
a memory bank, as at JAX :100), optimizer step.
Gradient accumulation and the momentum key encoder are not ported yet
(ROADMAP 5).

Dropout draws from torch's default generator of the device, seeded per
step from the state's rng inside ``torch.random.fork_rng``, so the global
generator is left as it was.  Anchor sampling and the enqueue draw from
their own per-step device generators.  ``draws`` replaces those two with
given uniform scores (the parity tests pass the JAX package's draws).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from contrastiveseg_tpu_torch.engine.state import TrainState, device_generator, split
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.ops.queue import enqueue
from contrastiveseg_tpu_torch.ops.resize import subsample_stride


class Draws(NamedTuple):
    anchor: AnchorScores  # hard_anchor_sample scores, each [B, C, N]
    queue: Optional[torch.Tensor] = None  # enqueue pixel scores [B, C, N_queue]


def make_train_step(
    loss_fn: Callable,
    warmup_iters: int = 0,
    network_stride: int = 4,
    pixel_update_freq: int = 10,
    queue_include_class0: bool = True,
):
    """Build ``train_step(state, batch, draws=None) -> metrics``.

    ``batch``: {"image": [B, H, W, 3] float, "label": [B, H, W] int} on the
    state's device.  The state is updated in place; metrics are detached
    0-d tensors (no host sync).
    """

    def train_step(state: TrainState, batch: dict,
                   draws: Optional[Draws] = None) -> dict[str, torch.Tensor]:
        s_drop, s_sample, s_queue = split(state.generator, 3)
        images, labels = batch["image"], batch["label"]
        with_embed = state.step >= warmup_iters
        model = state.model
        model.train()

        devices = [state.device] if state.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(s_drop)
            out = model(images)
        loss, metrics = loss_fn(
            out, labels, with_embed, state.bank,
            scores=draws.anchor if draws is not None else None,
            generator=device_generator(s_sample, state.device))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in model.parameters():
            # A parameter the loss does not reach (CE2P's edge branch under
            # fs_auxce_loss) still takes its weight decay and momentum, as
            # every parameter does in the JAX step; torch's SGD would skip it.
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)

        if state.bank is not None:
            # Reference _dequeue_and_enqueue (trainer_contrastive.py:102-138):
            # keys are the detached embeddings, labels strided (not interp'd).
            keys = out["embed"].detach()
            B, h, w, D = keys.shape
            lab_s = subsample_stride(labels, network_stride)[:, :h, :w]
            enqueue(state.bank, keys.reshape(B, h * w, D), lab_s.reshape(B, -1),
                    pixel_update_freq=pixel_update_freq,
                    include_class0=queue_include_class0,
                    scores=draws.queue if draws is not None else None,
                    generator=device_generator(s_queue, state.device))

        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
