"""The process group and the few collectives the port uses.

``init_from_env`` starts the group from ``torchrun``'s environment: NCCL for
a CUDA device (``cuda:$LOCAL_RANK``), gloo for the CPU.  Once it exists,
``distributed()`` is true and the collectives run, at world size 1 too, so
that one card runs every collective of the distributed path.  Without a
group they return their input (or do nothing).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


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


def data_parallel(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``model``'s ``DistributedDataParallel`` wrapper on ``device``.  It
    broadcasts no buffers: the BN statistics are the global batch's on every
    rank (``models/layers.GlobalBatchNorm``); ``find_unused_parameters`` is
    off."""
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)


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


def refuse_beyond_one_rank(what: str) -> None:
    """Raise ``NotImplementedError`` for ``what`` (a loss that needs a global
    sort or threshold over the batch) under more than one rank."""
    if world_size() > 1:
        raise NotImplementedError(
            f"{what} over the global batch of {world_size()} ranks is not ported: "
            "ROADMAP §1 item 4 (OHEM, RMI and Lovász at world size > 1)")
