"""The port's trainer on a Cityscapes-layout tree, on the CPU.

hrnet18 (``smoke_hrnet_w18``, 5 classes, at the widths of
``torch_port_helpers.tiny_hrnet``: every check compares the port with
itself) at 64x64 crops of 96x192 frames written by
``torch_port_helpers.write_tree``, ``data.synthetic=false``,
4 steps and a validation at step 4.  Against the reference run
(``solver.display_iter=1``, ``train.device_prefetch=1``):

* ``display_iter=3`` gives the same losses bit for bit and reads the
  metrics twice (after steps 3 and 4), in one sync each;
* ``device_prefetch`` 0 and 2 give the same losses bit for bit;
* SIGALRM through ``train.preempt_signals`` during step 2 saves ``latest``
  after step 2 and returns; ``network.resume_continue`` then finishes steps
  3 and 4 bit-identical to the unbroken run (model, bank, losses), because
  the resumed pipeline starts at the batch the unbroken run was at.
"""

from __future__ import annotations

import signal

import numpy as np
import pytest
import torch

from contrastiveseg_tpu_torch.engine import trainer as trainer_mod
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.presets import get_preset

from torch_port_helpers import one_torch_thread, tiny_hrnet, write_tree


@pytest.fixture(scope="module", autouse=True)
def _one_thread_tiny_hrnet():
    """The port against itself: hrnet18's topology at a tiny width
    (``tiny_hrnet``), on one torch thread."""
    with one_torch_thread(), pytest.MonkeyPatch.context() as mp:
        tiny_hrnet(mp)
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("cityscapes"), n_train=6, n_val=2)


def _config(tree, ckpt_dir, **extra):
    cfg = get_preset("smoke_hrnet_w18")
    over = {
        "data.synthetic": False, "data.data_dir": str(tree),
        "data.label_list": [7, 8, 11, 12, 13],
        "train.data_transformer.input_size": [64, 64],
        "train_trans.random_crop.crop_size": [64, 64],
        "val.data_transformer.input_size": [192, 96],
        "solver.max_iters": 4, "solver.test_interval": 4, "solver.display_iter": 1,
        "checkpoints.save_iters": 0, "checkpoints.checkpoints_dir": str(ckpt_dir),
        **extra,
    }
    for k, v in over.items():
        cfg = cfg.updated(k, v)
    return cfg


def _losses(history):
    return [(r["loss"], r["loss_seg"], r["loss_contrast"]) for r in history]


@pytest.fixture(scope="module")
def reference(tree, tmp_path_factory):
    trainer = Trainer(_config(tree, tmp_path_factory.mktemp("ref")), "cpu")
    history = trainer.train()
    return {"history": history, "scores": trainer.last_scores,
            "model": {k: v.clone() for k, v in trainer.state.model.state_dict().items()},
            "bank": trainer.state.bank.storage.clone()}


def test_trains_and_validates_from_a_directory(reference):
    history = reference["history"]
    assert len(history) == 4
    for row in history:
        assert all(np.isfinite(row[k]) for k in ("loss", "loss_seg", "loss_contrast"))
        assert row["loss_contrast"] > 0 and row["seconds"] > 0 and row["data_seconds"] >= 0
    assert 0.0 <= reference["scores"]["miou"] <= 1.0


def test_display_iter_reads_metrics_once_a_window(tree, tmp_path, reference, monkeypatch):
    windows = []
    real = trainer_mod.read_window

    def counted(window):
        windows.append(len(window))
        return real(window)

    monkeypatch.setattr(trainer_mod, "read_window", counted)
    history = Trainer(_config(tree, tmp_path, **{"solver.display_iter": 3}), "cpu").train()
    assert windows == [3, 1]
    assert _losses(history) == _losses(reference["history"])
    assert history[0]["seconds"] == history[2]["seconds"]  # one window's mean


@pytest.mark.parametrize("depth", [0, 2])
def test_device_prefetch_depth_keeps_the_losses(tree, tmp_path, reference, depth):
    history = Trainer(_config(tree, tmp_path, **{"train.device_prefetch": depth}), "cpu").train()
    assert _losses(history) == _losses(reference["history"])


def test_preempted_run_resumes_bit_identical(tree, tmp_path, reference):
    cfg = _config(tree, tmp_path, **{"train.preempt_signals": ["SIGTERM", "SIGALRM"]})
    first = Trainer(cfg, "cpu")
    step = first.train_step

    def step_and_signal(state, batch):
        metrics = step(state, batch)
        if state.step == 2:
            signal.raise_signal(signal.SIGALRM)
        return metrics

    first.train_step = step_and_signal
    before = signal.getsignal(signal.SIGALRM)
    history = first.train()
    assert signal.getsignal(signal.SIGALRM) is before  # restored
    assert first.state.step == 2 and len(history) == 2 and first.ckpt.has("latest")
    assert _losses(history) == _losses(reference["history"][:2])

    resumed = Trainer(cfg.updated("network.resume_continue", True), "cpu")
    assert resumed.state.step == 2
    rest = resumed.train()
    assert _losses(rest) == _losses(reference["history"][2:])
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, reference["model"][k]), k
    assert torch.equal(resumed.state.bank.storage, reference["bank"])


def test_unknown_preempt_signal_is_refused(tree, tmp_path):
    trainer = Trainer(_config(tree, tmp_path, **{"train.preempt_signals": ["SIGNOPE"]}), "cpu")
    with pytest.raises(ValueError, match="SIGNOPE"):
        trainer.train()
