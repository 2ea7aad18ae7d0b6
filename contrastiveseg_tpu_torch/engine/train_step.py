"""The train step of the port.

Counterpart of ``make_train_step`` in ``contrastiveseg_tpu/engine/train_step.py``
(:24-226): split the rng, forward, loss with the contrast term gated by
``step >= warmup_iters``, backward, enqueue the keys with stride-subsampled
labels (only when the state has a memory bank, as at JAX :100), optimizer
step.  The keys are the detached embeddings or, with ``momentum_encoder``,
those of the key encoder.  Three options of the JAX step:

* ``freeze_bn`` (the JAX ``train="freeze_bn"`` sentinel, ``layers.py:23-40``,
  which every flax BatchNorm of the JAX package honours): each BatchNorm
  normalises with its running statistics and writes none; dropout stays
  live and every parameter keeps its gradient.
* ``momentum_encoder`` (:100-119): once a step, before the key forward, the
  key parameters move to ``k * m + q * (1 - m)``; the key forward is
  gradient-free, runs the model with the key parameters and copies of its
  buffers, so it reads the BN statistics (in train mode, the batch's own;
  under ``freeze_bn``, the running ones) and writes none, under the query
  forward's dropout draw; the bank takes its embeddings.
* ``grad_accum_steps`` A > 1 (:140-226): the batch splits into A
  microbatches, whose gradients are summed and divided by A before one
  optimizer step (so the scheduler, the warmup gate, the EMA update, the
  step count and the weight decay fire once); metrics are the microbatches'
  mean; BN statistics chain from one microbatch to the next.  Every
  microbatch draws its contrast negatives from the step's initial bank:
  each one's keys and labels are kept, and enqueued in microbatch order
  after the last backward, which gives JAX's chained enqueues.

Dropout draws from torch's default generator of the device, seeded per
microbatch from the state's rng inside ``torch.random.fork_rng``, so the
global generator is left as it was.  Anchor sampling and the enqueue draw
from their own device generators.  ``draws`` replaces those two with given
uniform scores, one ``Draws`` a microbatch (the parity tests pass the JAX
package's draws).

Under a process group (``parallel``; ``torchrun`` and the trainer start it)
each rank holds its rows of the global batch, and the step computes what
the JAX package's global-view step computes on the whole of it:

* the query forward runs through ``state.ddp``, the model's
  ``DistributedDataParallel`` wrapper, whose mean of the ranks' gradients
  the losses are scaled for (``losses/ce.py``,
  ``ops/contrast.global_anchor_sample``); every BatchNorm normalises over
  the global batch, the key encoder's gradient-free forward too
  (``models/layers.GlobalBatchNorm``);
* with ``grad_accum_steps`` > 1 every microbatch but the last runs under
  ``no_sync()``; a rank's microbatch i is its share of the global
  microbatch i (``data/pipeline.py``);
* the anchor and enqueue draws are global ([B_global, C, N], ``draws``
  carries those) and the same on every rank, since every rank's state rng
  is seeded alike; dropout's differ by rank (its seed plus the rank);
* the keys and strided labels of the global batch are gathered in rank
  order and enqueued on every rank with the global scores, so the ranks'
  banks stay equal bit for bit;
* the metrics are the ranks' mean, the global batch's.

DDP's ``find_unused_parameters`` stays off, since it walks the autograd
graph every step.  Instead the step decides once, at its first call under
the wrapper, which parameters the loss never reaches (CE2P's edge branch
under ``fs_auxce_loss``): that step's backward runs under ``no_sync()``,
its gradients are averaged over the ranks as DDP's reducer averages them,
and a parameter left without a gradient on every rank stays out of the
wrapper's reducer from then on (``parallel.exclude_unreached``).  As in
the JAX step, such a parameter takes a zero gradient and with it its
weight decay and momentum, the same on every rank.  The set is static: the
contrast term is computed before warmup too, multiplied by 0
(``losses/contrast.py``).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from contrastiveseg_tpu_torch.engine.state import TrainState, device_generator, split
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.ops.queue import enqueue
from contrastiveseg_tpu_torch.ops.resize import subsample_stride
from contrastiveseg_tpu_torch.parallel import (
    all_gather_cat,
    all_reduce_sum,
    distributed,
    exclude_unreached,
    rank_and_world,
)


class Draws(NamedTuple):
    anchor: AnchorScores  # hard_anchor_sample scores, each [B, C, N]
    queue: Optional[torch.Tensor] = None  # enqueue pixel scores [B, C, N_queue]


def set_train_mode(model: nn.Module, freeze_bn: bool = False) -> None:
    """``model.train()``, with every BatchNorm in eval mode under ``freeze_bn``."""
    model.train()
    if freeze_bn:
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()


@torch.no_grad()
def ema_update(key_params: dict[str, torch.Tensor], model: nn.Module, m: float) -> None:
    """``k = k * m + q * (1 - m)`` for every parameter."""
    for name, q in model.named_parameters():
        key_params[name].mul_(m).add_(q * (1.0 - m))


def make_train_step(
    loss_fn: Callable,
    warmup_iters: int = 0,
    network_stride: int = 4,
    pixel_update_freq: int = 10,
    queue_include_class0: bool = True,
    freeze_bn: bool = False,
    momentum_encoder: bool = False,
    encoder_momentum: float = 0.999,
    grad_accum_steps: int = 1,
):
    """Build ``train_step(state, batch, draws=None) -> metrics``.

    ``batch``: {"image": [B, H, W, 3] float, "label": [B, H, W] int} on the
    state's device.  ``draws``: a ``Draws``, or with ``grad_accum_steps`` > 1
    a sequence of one a microbatch.  The state is updated in place; metrics
    are detached 0-d tensors (no host sync).
    """
    A = grad_accum_steps
    settled = weakref.WeakSet()  # the wrappers that a first step has settled

    def forward(model, images, seed, devices, params=None):
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            if params is None:
                return model(images)
            buffers = {name: b.clone() for name, b in model.named_buffers()}
            return torch.func.functional_call(model, {**params, **buffers}, (images,))

    def train_step(state: TrainState, batch: dict,
                   draws: Union[Draws, Sequence[Draws], None] = None
                   ) -> dict[str, torch.Tensor]:
        images, labels = batch["image"], batch["label"]
        B = images.shape[0]
        if B % A != 0:
            raise ValueError(f"batch size {B} not divisible by grad_accum_steps {A}")
        if draws is not None and A == 1:
            draws = [draws]
        seeds = split(state.generator, 3 * A)
        with_embed = state.step >= warmup_iters
        model = state.model
        net = state.ddp if state.ddp is not None else model
        set_train_mode(net, freeze_bn)
        devices = [state.device] if state.device.type == "cuda" else []
        rank, world = rank_and_world()
        # The EMA fires once a step; the single-program JAX step updates the
        # key parameters only where it has a bank (:104), the microbatched
        # one always (:161-165).
        keyed = momentum_encoder and state.key_params is not None
        if keyed and (A > 1 or state.bank is not None):
            ema_update(state.key_params, model, encoder_momentum)

        # The first step under the wrapper reduces its gradients itself
        # (``exclude_unreached``, after the backward).
        first = state.ddp is not None and state.ddp not in settled

        state.optimizer.zero_grad(set_to_none=True)
        pending, metrics = [], []
        for i, (img, lab) in enumerate(zip(images.chunk(A), labels.chunk(A))):
            s_drop, s_sample, s_queue = seeds[3 * i:3 * i + 3]
            s_drop += rank
            d = draws[i] if draws is not None else None
            sync = (state.ddp.no_sync() if state.ddp is not None and (first or i < A - 1)
                    else contextlib.nullcontext())
            with sync:
                out = forward(net, img, s_drop, devices)
                loss, m = loss_fn(out, lab, with_embed, state.bank,
                                  scores=d.anchor if d is not None else None,
                                  generator=device_generator(s_sample, state.device))
                loss.backward()
            metrics.append({k: v.detach() for k, v in m.items()})
            if state.bank is not None:
                # Reference _dequeue_and_enqueue (trainer_contrastive.py:102-138):
                # keys are the detached embeddings, labels strided (not interp'd).
                if keyed:
                    with torch.no_grad():
                        keys = forward(model, img, s_drop, devices, state.key_params)["embed"]
                else:
                    keys = out["embed"].detach()
                pending.append((keys, lab, s_queue, d))
            del out, loss, m
        for keys, lab, s_queue, d in pending:
            b, h, w, D = keys.shape
            lab_s = subsample_stride(lab, network_stride)[:, :h, :w].reshape(b, -1)
            keys = keys.reshape(b, h * w, D)
            if distributed():  # the global batch's, in rank order
                keys, lab_s = all_gather_cat(keys), all_gather_cat(lab_s.contiguous())
            enqueue(state.bank, keys, lab_s,
                    pixel_update_freq=pixel_update_freq,
                    include_class0=queue_include_class0,
                    scores=d.queue if d is not None else None,
                    generator=device_generator(s_queue, state.device))
        if first:
            state.ddp = exclude_unreached(state.ddp)
            settled.add(state.ddp)
        for p in model.parameters():
            # A parameter the loss does not reach (CE2P's edge branch under
            # fs_auxce_loss) still takes its weight decay and momentum, as
            # every parameter does in the JAX step; torch's SGD would skip it.
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
            elif A > 1 and p.grad is not None:
                p.grad.div_(A)  # the mean gradient, summed first as in JAX (:220)

        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        out = {k: torch.stack([m[k] for m in metrics]).mean() if A > 1 else metrics[0][k]
               for k in metrics[0]}
        if distributed():  # the ranks' mean: the global batch's metrics
            mean = all_reduce_sum(torch.stack(list(out.values()))) / world
            out = dict(zip(out, mean.unbind()))
        return out

    return train_step
