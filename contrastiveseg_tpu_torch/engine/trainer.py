"""Trainer of the port: train steps, validation and checkpoints.

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
``train`` returns (under a process group at the end of the display window,
every rank together).

The train step hands the loss the label map alone, as the JAX trainer does
(``engine/trainer.py:232``): SegFix's loss needs its offset targets, so a
SegFix preset raises ``losses/segfix.py``'s ``ValueError`` at its first
step, where the JAX step fails (ROADMAP §3); its val and test phases run.

The step takes ``network.freeze_bn``, ``contrast.momentum_encoder`` (with
``contrast.encoder_momentum``) and ``solver.grad_accum_steps`` (JAX
:130-140).  Under an ``swa_*`` LR policy the parameters are averaged after
the steps that ``engine/swa.swa_due`` names (JAX :263-273, 303-310); at the
end of the run the average replaces them, the BN statistics are
re-estimated over 20 train batches (``engine/swa.reestimate_bn``, JAX
:345-382) and the model validated (:335-341).  Under ``lr.lr_policy=plateau``
each validation's mIoU steps a ``PlateauController`` whose scale
multiplies the LR (:141-146, 316-324).  A run that stops early (a preempt
signal) saves without the swap.

On more GPUs (``torchrun``; ``tools/train_torch.py`` starts the process
group, ``parallel.init_from_env``) the trainer is the JAX trainer on its
device mesh (:40): every rank builds and restores the same state, wraps the
model in ``DistributedDataParallel`` (``state.ddp``) and trains on its
slice of each global batch, the step computing the global batch's step
(``engine/train_step.py``); validation scores each rank's shard with the
unwrapped model and sums the confusions, so the mIoU that saves by
performance and steps the plateau controller is the global one; SWA's BN
re-estimation normalises over the global batch; rank 0 alone logs and
writes checkpoints, the others waiting at a barrier
(``engine/checkpoint.py``).
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
from contrastiveseg_tpu_torch.engine.optim import PlateauController, set_plateau_scale
from contrastiveseg_tpu_torch.engine.prefetch import device_batches
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.swa import (
    init_swa,
    reestimate_bn,
    swa_due,
    swap_to_swa,
    update_swa,
)
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.parallel import (
    all_reduce_sum,
    data_parallel,
    distributed,
    is_main,
)

log = logging.getLogger(__name__)


def _info(*args) -> None:
    """``log.info`` on rank 0 (or the one process)."""
    if is_main():
        log.info(*args)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what the port cannot run yet."""
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
        if distributed() and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
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
            _info("loaded pretrained weights from %s", pretrained)
        self.train_step = make_train_step(
            self.loss_fn,
            warmup_iters=cfg.get("contrast.warmup_iters", default=0),
            network_stride=cfg.get("network.stride", default=4),
            pixel_update_freq=cfg.get("contrast.pixel_update_freq", default=10),
            queue_include_class0=cfg.get("contrast.include_class0", default=True),
            freeze_bn=cfg.get("network.freeze_bn", default=False),
            momentum_encoder=cfg.get("contrast.momentum_encoder", default=False),
            encoder_momentum=cfg.get("contrast.encoder_momentum", default=0.999),
            grad_accum_steps=cfg.get("solver.grad_accum_steps", default=1),
        )
        policy = cfg.get("lr.lr_policy", default="lambda_poly")
        self.plateau = PlateauController.from_config(cfg) if policy == "plateau" else None
        self.swa_on = "swa" in policy
        self.evaluator = build_evaluator(cfg, self.state.model)
        self._val_pipe = None  # built at the first validation, then reused
        self.last_scores: dict = {}
        self._stop_signal: Optional[str] = None
        if resume:
            self.ckpt.restore(self.state, path=resume)
            _info("resumed from %s at step %d", resume, self.state.step)
        elif resume_latest:
            self.ckpt.restore(self.state)
            _info("resumed latest at step %d", self.state.step)
        if distributed():
            self.state.ddp = data_parallel(self.state.model, self.device)

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

    def _stopping(self, window_end: bool) -> bool:
        """Whether to stop after this step: at once on a stop request, or
        under a process group at the end of a display window where some rank
        had one, all ranks together (one all-reduce at the window's sync;
        a rank that stopped alone would leave the others in a collective)."""
        if not distributed():
            return self._stop_signal is not None
        if not window_end:
            return False
        flag = torch.tensor([self._stop_signal is not None], device=self.device)
        return bool(all_reduce_sum(flag.int()).item())

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
            _info(
                "iter %d/%d loss %.4f seg %.4f contrast %.4f (%.2f img/s, data %.3f s, "
                "step %.3f s)", len(history) + step0, max_iters, last["loss"],
                last.get("loss_seg", 0.0), last.get("loss_contrast", 0.0),
                images / max(seconds, 1e-9), t_data, seconds - t_data)
            window.clear()
            images, t_data, t0 = 0, 0.0, time.perf_counter()

        step0 = self.state.step
        self._stop_signal = None
        swa = init_swa(self.state.model) if self.swa_on else None
        prev_handlers = self._install_preempt_handlers()
        try:
            for it in range(step0, max_iters):
                td = time.perf_counter()
                batch = next(batches)
                t_data += time.perf_counter() - td
                window.append(self.train_step(self.state, batch))
                images += batch["image"].shape[0]
                window_end = (it + 1) % display_iter == 0 or it + 1 == max_iters
                stop = self._stopping(window_end)
                if window_end or stop:
                    flush()
                tp = time.perf_counter()
                if swa is not None and swa_due(it + 1, max_iters):
                    update_swa(swa, self.state.model)
                    _info("SWA update %d at iter %d", swa.n_averaged, it + 1)
                if save_iters and (it + 1) % save_iters == 0:
                    self.ckpt.save(self.state, "latest")
                if test_interval and (it + 1) % test_interval == 0:
                    scores = self.validate()
                    if self.plateau is not None:
                        set_plateau_scale(self.state.scheduler,
                                          self.plateau.step(scores["miou"]))
                t0 += time.perf_counter() - tp  # the window times steps only
                if stop:
                    self.ckpt.save(self.state, "latest")
                    _info("%s received: full state saved at iter %d; restart with "
                          "network.resume_continue=true to resume",
                          self._stop_signal or "a stop on another rank", it + 1)
                    return history
            if swa is not None and swa.n_averaged:
                # swap_swa_sgd + bn_update (trainer_contrastive.py:422-425).
                swap_to_swa(self.state.model, swa)
                reestimate_bn(self.state.model, batches)
                self.validate()
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
        _info("val: mIoU %.4f pixel_acc %.4f (%.2f img/s)", scores["miou"],
                 scores["pixel_acc"], scores["images_per_sec"])
        self.ckpt.save_by_mode(self.state, "performance", performance=scores["miou"])
        self.last_scores = scores
        return scores
