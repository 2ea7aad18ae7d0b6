"""Trainer of the port: train steps, validation and checkpoints on one device.

Counterpart of ``Trainer`` in ``contrastiveseg_tpu/engine/trainer.py``
(``__init__`` :31-172, ``train`` :245-343, ``validate`` :384-401): build the
model, loss, optimizer, bank, evaluator and checkpoint manager from the
``Config``; resume from ``network.resume`` (a path) or, with
``network.resume_continue``, from the latest checkpoint; then loop to
``solver.max_iters``, validating every ``solver.test_interval`` steps (and
saving by performance), saving ``latest`` every ``checkpoints.save_iters``
steps and at the end.

Data is synthetic (``data.synthetic=true``): train batches in index order,
resumed at the saved step's offset, and the same scenes, in order, for
validation.  Not ported yet, and refused with ``NotImplementedError`` when a
config needs them: the data pipeline (ROADMAP 9), multi-GPU (ROADMAP 10),
pretrained-weight import, SWA, gradient accumulation, the momentum encoder
and freeze-BN (ROADMAP 12).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from contrastiveseg_tpu_torch.data.synthetic import synthetic_batches, synthetic_val_batches
from contrastiveseg_tpu_torch.engine.checkpoint import CheckpointManager
from contrastiveseg_tpu_torch.engine.evaluator import build_evaluator
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import build_model

log = logging.getLogger(__name__)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what the port cannot run yet."""
    for key, item in (
        ("network.pretrained", "ROADMAP 12 (pretrained-weight import)"),
        ("network.freeze_bn", "ROADMAP 12 (training extras)"),
        ("contrast.momentum_encoder", "ROADMAP 12 (training extras)"),
    ):
        if cfg.get(key, default=None):
            raise NotImplementedError(f"{key} is not ported yet: {item}")
    if cfg.get("solver.grad_accum_steps", default=1) > 1:
        raise NotImplementedError(
            "solver.grad_accum_steps > 1 is not ported yet: ROADMAP 12")
    if not cfg.get("data.synthetic", default=False):
        raise NotImplementedError(
            "only data.synthetic=true is ported: the data pipeline is ROADMAP 9")
    if not cfg.get("contrast.with_memory", default=False):
        raise NotImplementedError(
            "contrast without the memory bank is not ported yet: ROADMAP 5")


class Trainer:
    def __init__(self, cfg, device: torch.device | str = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_iters = cfg.get("solver.max_iters", default=40000)
        self.loss_fn = build_loss(cfg)
        self.state = create_train_state(cfg, build_model(cfg), self.device)
        self.train_step = make_train_step(
            self.loss_fn,
            warmup_iters=cfg.get("contrast.warmup_iters", default=0),
            network_stride=cfg.get("network.stride", default=4),
            pixel_update_freq=cfg.get("contrast.pixel_update_freq", default=10),
            queue_include_class0=cfg.get("contrast.include_class0", default=True),
        )
        self.evaluator = build_evaluator(cfg, self.state.model)
        self.ckpt = CheckpointManager(
            cfg.get("checkpoints.checkpoints_dir", default="./checkpoints"),
            cfg.get("checkpoints.checkpoints_name", default="seg"),
            config_dict=cfg.to_dict(),
        )
        self.last_scores: dict = {}
        resume = cfg.get("network.resume", default=None)
        if resume:
            self.ckpt.restore(self.state, path=resume)
            log.info("resumed from %s at step %d", resume, self.state.step)
        elif cfg.get("network.resume_continue", default=False) and self.ckpt.has():
            self.ckpt.restore(self.state)
            log.info("resumed latest at step %d", self.state.step)

    def train(self, max_iters: Optional[int] = None) -> list[dict[str, float]]:
        """Run the steps; returns each step's losses and its wall time."""
        cfg = self.cfg
        max_iters = max_iters or self.max_iters
        test_interval = cfg.get("solver.test_interval", default=2000)
        save_iters = cfg.get("checkpoints.save_iters", default=1000)
        batch_size = cfg.get("train.batch_size", default=8)
        batches = synthetic_batches(cfg, batch_size, start=self.state.step * batch_size)
        history = []
        for it in range(self.state.step, max_iters):
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in next(batches).items()}
            t0 = time.perf_counter()
            metrics = self.train_step(self.state, batch)
            row = {k: float(v) for k, v in metrics.items()}  # syncs the device
            row["seconds"] = time.perf_counter() - t0
            history.append(row)
            log.info(
                "iter %d/%d loss %.4f seg %.4f contrast %.4f (%.3f s)",
                it + 1, max_iters, row["loss"], row["loss_seg"],
                row["loss_contrast"], row["seconds"])
            if save_iters and (it + 1) % save_iters == 0:
                self.ckpt.save(self.state, "latest")
            if test_interval and (it + 1) % test_interval == 0:
                self.validate()
        self.ckpt.save(self.state, "latest")
        return history

    def validate(self) -> dict:
        """Scores on the synthetic validation scenes; saves by performance."""
        scores = self.evaluator.run(synthetic_val_batches(self.cfg), self.device)
        log.info("val: mIoU %.4f pixel_acc %.4f (%.2f img/s)", scores["miou"],
                 scores["pixel_acc"], scores["images_per_sec"])
        self.ckpt.save_by_mode(self.state, "performance", performance=scores["miou"])
        self.last_scores = scores
        return scores
