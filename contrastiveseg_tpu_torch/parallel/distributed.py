"""The process group and the few collectives the port uses.

``init_from_env`` starts the group from ``torchrun``'s environment: NCCL for
a CUDA device (``cuda:$LOCAL_RANK``), gloo for the CPU.  Once it exists,
``distributed()`` is true and the collectives run, at world size 1 too, so
that one card runs every collective of the distributed path.  Without a
group they return their input (or do nothing).

``global_calls()`` counts the calls of the losses' global branches
(``global_kth_smallest``, RMI's and Lovasz's) since
``reset_global_calls()``, so that a run can show that it took them.
"""

from __future__ import annotations

import collections
import math
import os

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_CALLS: collections.Counter = collections.Counter()


def count_global(name: str) -> None:
    """Count one call of the global branch ``name`` (``global_calls``)."""
    _CALLS[name] += 1


def global_calls() -> dict[str, int]:
    """The global branches' calls since ``reset_global_calls``, by name."""
    return dict(_CALLS)


def reset_global_calls() -> None:
    _CALLS.clear()


def launched() -> bool:
    """Whether ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``) is present."""
    return all(k in os.environ for k in ENV_KEYS)


def distributed() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) without one."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return rank_and_world()[1]


def is_main() -> bool:
    """Rank 0, or the one process."""
    return rank_and_world()[0] == 0


def init_from_env(device: torch.device | str = "cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes and return this
    rank's device: ``cuda:$LOCAL_RANK`` (made current) over NCCL for a CUDA
    ``device``, the CPU over gloo.  ``MASTER_ADDR`` and ``MASTER_PORT`` come
    from the environment too.  A device type with no backend here, or a
    ``LOCAL_RANK`` with no CUDA device, raises; nothing falls back to the
    CPU."""
    if not launched():
        raise RuntimeError(f"init_from_env: {', '.join(ENV_KEYS)} are not all set "
                           "(launch with torchrun)")
    rank, world, local = (int(os.environ[k]) for k in ENV_KEYS)
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"init_from_env: no backend for device {device!r} "
                         f"(known: {sorted(BACKENDS)})")
    if kind == "cuda":
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_from_env: LOCAL_RANK {local} has no CUDA device "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0} visible)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not distributed():
        dist.init_process_group(BACKENDS[kind], init_method="env://", rank=rank,
                                world_size=world,
                                device_id=dev if kind == "cuda" else None)
    return dev


def data_parallel(model: torch.nn.Module, device: torch.device,
                  ignore: tuple[str, ...] = ()) -> torch.nn.Module:
    """``model``'s ``DistributedDataParallel`` wrapper on ``device``.  It
    broadcasts no buffers: the BN statistics are the global batch's on every
    rank (``models/layers.GlobalBatchNorm``); ``find_unused_parameters`` is
    off.  The parameters named in ``ignore`` stay out of its reducer: the
    train step leaves them out once it has seen that the loss never reaches
    them (``exclude_unreached``)."""
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(model, list(ignore))
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)


def exclude_unreached(ddp: torch.nn.Module) -> torch.nn.Module:
    """After a first step whose backward ran without the reducer
    (``no_sync``): the ranks' mean of the gradients, as DDP's reducer makes
    it (each rank's times 1/world, summed), and the wrapper for the later
    steps.  A parameter that no rank's loss reached keeps no gradient and
    stays out of the new wrapper's reducer (``data_parallel``'s ``ignore``),
    whose ``find_unused_parameters`` stays off; where the loss reaches every
    parameter, ``ddp`` itself.  One host sync, for the names.

    DDP's own ways do not fit: ``static_graph`` refuses ``no_sync()`` in
    its first step, and never finishes a later step's reduction while the
    model returns an output that the loss leaves unused (CE2P's edge
    logits); ``find_unused_parameters`` walks the graph every step, from
    the model's outputs, so it takes that branch as used and reduces its
    zero gradients."""
    model = ddp.module
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    device = params[0][1].device
    reached = all_reduce_sum(torch.tensor([p.grad is not None for _, p in params],
                                          dtype=torch.int32, device=device)).tolist()
    grads = collections.defaultdict(list)
    for (_, p), hit in zip(params, reached):
        if hit:
            if p.grad is None:  # reached on another rank only
                p.grad = torch.zeros_like(p)
            grads[p.grad.dtype].append(p.grad)
    world = world_size()
    for group in grads.values():
        flat = torch.cat([g.reshape(-1) for g in group]).mul_(1.0 / world)
        dist.all_reduce(flat)
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))
    unreached = tuple(n for (n, _), hit in zip(params, reached) if not hit)
    if not unreached:
        return ddp
    return data_parallel(model, device, ignore=unreached)


def _gather_cat(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _GatherCat(torch.autograd.Function):
    """``_gather_cat`` whose backward sums the gradient of the gathered
    tensor over the ranks and hands each rank its own part: a
    reduce-scatter, made of the all-reduce that NCCL and gloo both have (the
    gathered tensors here are small: anchors, not activations)."""

    @staticmethod
    def forward(ctx, x):
        return _gather_cat(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g.chunk(dist.get_world_size())[dist.get_rank()]


def all_gather_cat(x: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (equal
    shapes on every rank).  With ``grad`` the gather carries gradients: its
    backward sums, over the ranks, the gradients that each rank's part
    receives on every rank."""
    if not distributed():
        return x
    return _GatherCat.apply(x) if grad else _gather_cat(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, as a new tensor (no gradient)."""
    if not distributed():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def global_kth_smallest(values: torch.Tensor, k: torch.Tensor, k_max: int,
                        fill: float = math.inf) -> torch.Tensor:
    """The ``k``-th smallest (from 0) of every rank's ``values`` put
    together, bit for bit ``torch.sort(cat over the ranks)[k]``, for a
    0-d device tensor ``k <= k_max``, with no host sync.

    The k-th smallest of a union lies among each part's k + 1 smallest, so
    each rank contributes its ``min(k_max + 1, numel)`` smallest, padded
    with ``fill`` (no smaller than any value that can be the k-th) to
    ``k_max + 1``: the gather's shape is static and equal on every rank.
    One all-gather, and one sort of world x (k_max + 1) values.  Without a
    process group, the k-th smallest of ``values``."""
    if distributed():
        count_global("global_kth_smallest")
    values = values.reshape(-1)
    m = min(k_max + 1, values.numel())
    local = torch.topk(values, m, largest=False, sorted=False).values
    if m < k_max + 1:
        local = torch.cat([local, local.new_full((k_max + 1 - m,), fill)])
    pooled = torch.sort(all_gather_cat(local)).values
    return pooled.gather(0, k.reshape(1).long())[0]


def barrier() -> None:
    if distributed():
        dist.barrier()


def require_one_process(what: str) -> None:
    """Raise for ``what`` (a single-device tool) under more than one rank, as
    the process group or ``torchrun``'s ``WORLD_SIZE`` gives them."""
    world = max(world_size(), int(os.environ.get("WORLD_SIZE", "1")))
    if world > 1:
        raise RuntimeError(
            f"{what} runs on one device (the JAX package's has no mesh either); "
            f"run it without torchrun, not at world size {world}")
