"""Trainer of the port: train steps, validation and checkpoints on one device.

Counterpart of ``Trainer`` in ``contrastiveseg_tpu/engine/trainer.py``
(``__init__`` :31-172, ``request_stop`` and the preemption handlers
:175-224, ``train`` :245-343, ``validate`` :384-401): build the model, loss,
optimizer, bank (with ``contrast.with_memory``), evaluator and checkpoint
manager from the ``Config``; start from ``network.pretrained`` (a reference
``.pth``, ``utils/pretrained.py``), unless the run resumes from
``network.resume`` (a path) or, with ``network.resume_continue``, from the
latest checkpoint; then loop to ``solver.max_iters``, validating
every ``solver.test_interval`` steps (and saving by performance), saving
``latest`` every ``checkpoints.save_iters`` steps and at the end.

Data comes from ``build_pipeline(cfg, "train")`` (the synthetic scenes or a
directory), through ``engine/prefetch.device_batches``: pinned on a thread,
``train.device_prefetch`` batches copied ahead on a side stream.  A resumed
run starts the pipeline at its step (``DataPipeline.iter_from``), so it sees
the batches the unbroken run would have seen; the JAX trainer restarts its
pipeline at epoch 0 instead (ROADMAP §3).  The step's metrics stay on the
device and are read in one sync every ``solver.display_iter`` steps, at the
end and on a stop.  ``train.preempt_signals`` (SIGTERM and SIGINT by
default) ask for a stop: ``latest`` is saved at the next step boundary and
``train`` returns.

The train step hands the loss the label map alone, as the JAX trainer does
(``engine/trainer.py:232``): SegFix's loss needs its offset targets, so a
SegFix preset raises ``losses/segfix.py``'s ``ValueError`` at its first
step, where the JAX step fails (ROADMAP §3); its val and test phases run.

Not ported yet, and refused with ``NotImplementedError`` when a config needs
them: multi-GPU (ROADMAP §1 item 4), SWA, gradient accumulation, the
momentum encoder and freeze-BN (item 5).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Optional

import torch

from contrastiveseg_tpu_torch.data.datasets import check_loader
from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
from contrastiveseg_tpu_torch.engine.checkpoint import CheckpointManager
from contrastiveseg_tpu_torch.engine.evaluator import build_evaluator
from contrastiveseg_tpu_torch.engine.prefetch import device_batches
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import build_model

log = logging.getLogger(__name__)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what the port cannot run yet."""
    for key in ("network.freeze_bn", "contrast.momentum_encoder"):
        if cfg.get(key, default=None):
            raise NotImplementedError(
                f"{key} is not ported yet: ROADMAP 5 (training extras)")
    if cfg.get("solver.grad_accum_steps", default=1) > 1:
        raise NotImplementedError(
            "solver.grad_accum_steps > 1 is not ported yet: ROADMAP 5 (training extras)")
    if not cfg.get("data.synthetic", default=False):
        check_loader(cfg)


def read_window(window: list[dict]) -> list[dict[str, float]]:
    """Every metric of the window's steps as floats, in one device sync."""
    keys = list(window[0])
    values = torch.stack([torch.stack([m[k].double() for k in keys])
                          for m in window]).tolist()
    return [dict(zip(keys, row)) for row in values]


class Trainer:
    def __init__(self, cfg, device: torch.device | str = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_iters = cfg.get("solver.max_iters", default=40000)
        self.loss_fn = build_loss(cfg)
        self.ckpt = CheckpointManager(
            cfg.get("checkpoints.checkpoints_dir", default="./checkpoints"),
            cfg.get("checkpoints.checkpoints_name", default="seg"),
            config_dict=cfg.to_dict(),
        )
        resume = cfg.get("network.resume", default=None)
        resume_latest = (not resume and cfg.get("network.resume_continue", default=False)
                         and self.ckpt.has())
        # A resumed run restores everything the pretrained file would fill.
        pretrained = (None if resume or resume_latest
                      else cfg.get("network.pretrained", default=None))
        self.state = create_train_state(cfg, build_model(cfg), self.device, pretrained)
        if pretrained:
            log.info("loaded pretrained weights from %s", pretrained)
        self.train_step = make_train_step(
            self.loss_fn,
            warmup_iters=cfg.get("contrast.warmup_iters", default=0),
            network_stride=cfg.get("network.stride", default=4),
            pixel_update_freq=cfg.get("contrast.pixel_update_freq", default=10),
            queue_include_class0=cfg.get("contrast.include_class0", default=True),
        )
        self.evaluator = build_evaluator(cfg, self.state.model)
        self._val_pipe = None  # built at the first validation, then reused
        self.last_scores: dict = {}
        self._stop_signal: Optional[str] = None
        if resume:
            self.ckpt.restore(self.state, path=resume)
            log.info("resumed from %s at step %d", resume, self.state.step)
        elif resume_latest:
            self.ckpt.restore(self.state)
            log.info("resumed latest at step %d", self.state.step)

    def request_stop(self, why: str = "request_stop") -> None:
        """Ask the train loop to stop at the next step boundary.  Safe to
        call from a signal handler: it only sets a flag."""
        self._stop_signal = why

    def _install_preempt_handlers(self) -> dict:
        """Handlers of ``train.preempt_signals`` that call ``request_stop``;
        returns the handlers they replaced.  Only the main thread may set
        handlers, so elsewhere none is installed."""
        names = self.cfg.get("train.preempt_signals", default=["SIGTERM", "SIGINT"])
        unknown = [n for n in names if not hasattr(signal, n)]
        if unknown:
            raise ValueError(f"train.preempt_signals: no signals named {unknown}")
        if threading.current_thread() is not threading.main_thread():
            return {}
        return {getattr(signal, name): signal.signal(
                    getattr(signal, name),
                    lambda signum, frame, name=name: self.request_stop(name))
                for name in names}

    def train(self, max_iters: Optional[int] = None) -> list[dict[str, float]]:
        """Run the steps; returns one row a step: its losses, and the wall
        time and data wait of its display window divided by the window's
        steps (``seconds``, ``data_seconds``; validation and checkpoint
        saves are not in the window)."""
        cfg = self.cfg
        max_iters = max_iters or self.max_iters
        display_iter = max(1, cfg.get("solver.display_iter", default=10))
        test_interval = cfg.get("solver.test_interval", default=2000)
        save_iters = cfg.get("checkpoints.save_iters", default=1000)
        pipeline = build_pipeline(cfg, "train")
        batches = device_batches(pipeline.iter_from(self.state.step), self.device,
                                 cfg.get("train.device_prefetch", default=1))
        history: list[dict[str, float]] = []
        window: list[dict] = []
        images = 0
        t_data = 0.0
        t0 = time.perf_counter()

        def flush() -> None:
            nonlocal images, t_data, t0
            rows = read_window(window)  # syncs the device
            seconds = time.perf_counter() - t0
            for row in rows:
                row["seconds"] = seconds / len(rows)
                row["data_seconds"] = t_data / len(rows)
            history.extend(rows)
            last = rows[-1]
            log.info(
                "iter %d/%d loss %.4f seg %.4f contrast %.4f (%.2f img/s, data %.3f s, "
                "step %.3f s)", len(history) + step0, max_iters, last["loss"],
                last.get("loss_seg", 0.0), last.get("loss_contrast", 0.0),
                images / max(seconds, 1e-9), t_data, seconds - t_data)
            window.clear()
            images, t_data, t0 = 0, 0.0, time.perf_counter()

        step0 = self.state.step
        self._stop_signal = None
        prev_handlers = self._install_preempt_handlers()
        try:
            for it in range(step0, max_iters):
                td = time.perf_counter()
                batch = next(batches)
                t_data += time.perf_counter() - td
                window.append(self.train_step(self.state, batch))
                images += batch["image"].shape[0]
                if (it + 1) % display_iter == 0 or it + 1 == max_iters or self._stop_signal:
                    flush()
                tp = time.perf_counter()
                if save_iters and (it + 1) % save_iters == 0:
                    self.ckpt.save(self.state, "latest")
                if test_interval and (it + 1) % test_interval == 0:
                    self.validate()
                t0 += time.perf_counter() - tp  # the window times steps only
                if self._stop_signal:
                    self.ckpt.save(self.state, "latest")
                    log.info("%s received: full state saved at iter %d; restart with "
                             "network.resume_continue=true to resume",
                             self._stop_signal, it + 1)
                    return history
        finally:
            batches.close()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        self.ckpt.save(self.state, "latest")
        return history

    def validate(self) -> dict:
        """Scores over one pass of the val pipeline; saves by performance."""
        if self._val_pipe is None:
            self._val_pipe = build_pipeline(self.cfg, "val")
        scores = self.evaluator.run(self._val_pipe.epoch_iter(0), self.device)
        log.info("val: mIoU %.4f pixel_acc %.4f (%.2f img/s)", scores["miou"],
                 scores["pixel_acc"], scores["images_per_sec"])
        self.ckpt.save_by_mode(self.state, "performance", performance=scores["miou"])
        self.last_scores = scores
        return scores
