"""Checkpoint save and restore of the full train state.

Counterpart of ``CheckpointManager`` in ``contrastiveseg_tpu/engine/checkpoint.py``
(:41-106): the model (parameters and BN statistics), the optimizer, the LR
scheduler (with the plateau scale), the step, the memory bank's rows and
pointers, the key encoder's parameters with ``contrast.momentum_encoder``
(:36-37, 102), and the state of the host generator that the train step
splits its seeds from, so a resumed run continues exactly where the saved
one stopped.  The save modes are the
reference's (module_runner.py:186-214): ``latest`` always, plus
``performance`` / ``val_loss`` / ``iters`` / ``epoch``.

The on-disk format is the port's own: one ``torch.save`` file
``{dir}/{name}_{tag}.pt``, written to a temporary name and then renamed,
plus the config as ``{dir}/{name}_{tag}.pt.config.json``.

Under a process group every rank holds the same state (the parameters
after DDP's mean, the global BN statistics, one global bank), so rank 0
alone writes, as the JAX package's process 0 does (:50, 58), and every rank
waits at a barrier until the file is there; every rank restores.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from contrastiveseg_tpu_torch.engine.state import TrainState
from contrastiveseg_tpu_torch.parallel import barrier, is_main


def state_dict(state: TrainState) -> dict:
    tree = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "generator": state.generator.get_state(),
        "bank": None,
        "key_params": state.key_params,
    }
    if state.bank is not None:
        tree["bank"] = {"storage": state.bank.storage,
                        "segment_ptr": state.bank.segment_ptr,
                        "pixel_ptr": state.bank.pixel_ptr}
    return tree


def load_state_dict(state: TrainState, tree: dict) -> TrainState:
    """Fill ``state`` in place from ``tree``; shapes must match."""
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    state.generator.set_state(tree["generator"].cpu())
    if (state.bank is None) != (tree["bank"] is None):
        raise ValueError("the checkpoint and the state disagree on having a memory bank")
    if state.bank is not None:
        for key in ("storage", "segment_ptr", "pixel_ptr"):
            dst, src = getattr(state.bank, key), tree["bank"][key]
            if dst.shape != src.shape:
                raise ValueError(f"bank {key} has shape {tuple(src.shape)} in the "
                                 f"checkpoint, {tuple(dst.shape)} in the state")
            dst.copy_(src)
    # A checkpoint without key parameters keeps the state's (JAX :102).
    if state.key_params is not None and tree.get("key_params") is not None:
        for name, dst in state.key_params.items():
            src = tree["key_params"][name]
            if dst.shape != src.shape:
                raise ValueError(f"key parameter {name} has shape {tuple(src.shape)} in the "
                                 f"checkpoint, {tuple(dst.shape)} in the state")
            dst.copy_(src)
    state.step = int(tree["step"])
    return state


class CheckpointManager:
    def __init__(self, checkpoints_dir: str, checkpoints_name: str,
                 config_dict: Optional[dict] = None):
        self.dir = os.path.abspath(checkpoints_dir)
        self.name = checkpoints_name
        self.config_dict = config_dict or {}
        self.best_performance = -np.inf
        self.min_val_loss = np.inf
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.dir, f"{self.name}_{tag}.pt")

    def save(self, state: TrainState, tag: str = "latest") -> str:
        """Write the ``tag`` checkpoint (rank 0; the others wait for it)."""
        path = self._path(tag)
        if is_main():
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(state_dict(state), tmp)
            os.replace(tmp, path)
            with open(path + ".config.json", "w") as f:
                json.dump(self.config_dict, f, indent=2)
        barrier()
        return path

    def save_by_mode(self, state: TrainState, save_mode: str,
                     performance: float = None, val_loss: float = None,
                     iters: int = None, epoch: int = None) -> None:
        """module_runner.py:186-214 semantics."""
        self.save(state, "latest")
        if save_mode == "performance" and performance is not None:
            if performance > self.best_performance:
                self.best_performance = performance
                self.save(state, "max_performance")
        elif save_mode == "val_loss" and val_loss is not None:
            if val_loss < self.min_val_loss:
                self.min_val_loss = val_loss
                self.save(state, "min_loss")
        elif save_mode == "iters" and iters is not None:
            self.save(state, f"iters{iters}")
        elif save_mode == "epoch" and epoch is not None:
            self.save(state, f"epoch{epoch}")

    def restore(self, state: TrainState, tag: str = "latest",
                path: Optional[str] = None) -> TrainState:
        """Restore ``state`` in place from the ``tag`` checkpoint (or ``path``)."""
        tree = torch.load(path or self._path(tag), map_location=state.device,
                          weights_only=True)
        return load_state_dict(state, tree)

    def has(self, tag: str = "latest") -> bool:
        return os.path.exists(self._path(tag))
