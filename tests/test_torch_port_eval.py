"""The port's evaluator and checkpoints against the JAX package.

* ``ops/confusion.confusion_matrix`` and ``metrics/running_score`` against
  the JAX ones on random labels with ignore pixels (-1 and 255): equal.
* ``engine/evaluator.Evaluator`` against JAX ``Evaluator.run`` on the same
  hrnet18 weights and scenes (JAX eager, held to exact fp32 as in the model
  test): the confusion matrices agree to a few pixels out of 16,384 (an
  argmax of two logits within fp32 rounding may go either way), mIoU within
  1e-3.
* ``engine/checkpoint``: train, save, restore in a new trainer, and the
  next step is bit-identical on the CPU to the uninterrupted run's (model,
  optimizer, scheduler, step, bank and the generator are all restored).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.engine.evaluator import Evaluator as JEvaluator
from contrastiveseg_tpu.metrics.running_score import RunningScore as JRunningScore
from contrastiveseg_tpu.models.nets import HRNetSeg as JHRNetSeg
from contrastiveseg_tpu.ops.confusion import confusion_matrix as jconfusion_matrix
from contrastiveseg_tpu_torch.data.collate import collate
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.checkpoint import CheckpointManager
from contrastiveseg_tpu_torch.engine.evaluator import Evaluator, build_evaluator
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.metrics.running_score import RunningScore
from contrastiveseg_tpu_torch.models.nets import HRNetSeg
from contrastiveseg_tpu_torch.ops.confusion import confusion_matrix
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import hrnet_seg_key, load_jax_variables

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    tiny_hrnet,
)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _shared_compiles():
    with shared_jax_compiles():
        yield


@pytest.mark.parametrize("n", [2, 5, 19])
def test_confusion_and_scores_match_jax(n):
    rng = np.random.default_rng(n)
    label = rng.integers(0, n, (3, 17, 23)).astype(np.int32)
    label[rng.random(label.shape) < 0.1] = -1
    label[rng.random(label.shape) < 0.05] = 255
    pred = rng.integers(0, n, label.shape).astype(np.int32)
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), n)
    want = np.asarray(jconfusion_matrix(jnp.asarray(pred), jnp.asarray(label), n))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((label >= 0) & (label < n)).sum())

    ours, theirs = RunningScore(n), JRunningScore(n)
    for k in range(2):  # two updates accumulate
        ours.update(torch.from_numpy(pred[k:]), torch.from_numpy(label[k:]))
        theirs.update(jnp.asarray(pred[k:]), jnp.asarray(label[k:]))
    a, b = ours.get_scores(), theirs.get_scores()
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-12, err_msg=key)
    assert ours.get_f1_score() == pytest.approx(theirs.get_f1_score(), rel=1e-12)


def test_evaluator_miou_matches_jax(monkeypatch):
    exact_fp32_reference(monkeypatch)
    C, HW = 5, (64, 64)
    jm = JHRNetSeg(num_classes=C, arch="hrnet18", with_proj=True, head_dropout=0.0)
    variables = random_variables(jm, (1, *HW, 3), seed=4)
    pm = HRNetSeg(C, "hrnet18", head_dropout=0.0)
    load_jax_variables(pm, variables)
    ds = SyntheticSegDataset(num_classes=C, size_hw=HW, length=4)
    batches = [collate([ds[i], ds[i + 1]], input_size=HW[::-1], normalizer=Normalizer())
               for i in (0, 2)]

    # Running statistics from the scenes themselves, so the eval forward is
    # as well conditioned as a trained net's (see test_torch_port_model).
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        pm.train()(torch.from_numpy(np.concatenate([b["image"] for b in batches])))
    sd = pm.state_dict()

    def fill(tree, prefix=()):
        return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                else sd[hrnet_seg_key(prefix + (k,))].numpy() for k, v in tree.items()}

    stats = fill(variables["batch_stats"])
    jev = JEvaluator(jm, C)
    with jax.disable_jit():
        want = jev.run(
            variables["params"], stats,
            [{"image": b["image"], "label": b["label"]} for b in batches])
    ev = Evaluator(pm, C)
    got = ev.run(batches, "cpu")
    assert pm.training  # the evaluator restores the model's mode
    assert ev.score.confusion.sum() == jev.score.confusion.sum() == 4 * HW[0] * HW[1]
    assert np.abs(ev.score.confusion - jev.score.confusion).sum() <= 8
    assert abs(got["miou"] - want["miou"]) < 1e-3, (got["miou"], want["miou"])
    assert abs(got["pixel_acc"] - want["pixel_acc"]) < 1e-3


def test_build_evaluator_refuses_what_is_not_ported():
    """Every task evaluator is ported now: the SegFix ones are held against
    JAX in tests/test_torch_port_segfix.py."""
    from contrastiveseg_tpu_torch.engine.evaluator import MLDirectionEvaluator, SegFixEvaluator

    cfg = get_preset("smoke_hrnet_w18")
    assert isinstance(build_evaluator(cfg, HRNetSeg(5, "hrnet18")), Evaluator)
    assert isinstance(build_evaluator(cfg.updated("val.evaluator", "segfix"),
                                      HRNetSeg(5, "hrnet18")), SegFixEvaluator)
    assert isinstance(build_evaluator(cfg.updated("val.evaluator", "ml_dir"),
                                      HRNetSeg(5, "hrnet18")), MLDirectionEvaluator)


def _trainer_config(tmp_path):
    cfg = get_preset("smoke_hrnet_w18")
    for key, value in {
        "data.synthetic_length": 4, "solver.max_iters": 3, "solver.test_interval": 2,
        "checkpoints.save_iters": 2, "checkpoints.checkpoints_dir": str(tmp_path),
        "val.batch_size": 2,
    }.items():
        cfg = cfg.updated(key, value)
    return cfg


def _snapshot(state):
    return {
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "momentum": [state.optimizer.state[p]["momentum_buffer"].clone()
                     for g in state.optimizer.param_groups for p in g["params"]],
        "lr": [g["lr"] for g in state.optimizer.param_groups],
        "bank": state.bank.storage.clone(),
        "ptrs": (state.bank.segment_ptr.clone(), state.bank.pixel_ptr.clone()),
        "generator": state.generator.get_state(),
        "step": state.step,
    }


def test_checkpoint_resume_is_bit_identical(tmp_path, monkeypatch):
    tiny_hrnet(monkeypatch)  # the port against itself: its topology at a tiny width
    cfg = _trainer_config(tmp_path / "a")
    whole = Trainer(cfg, "cpu")
    hist_a = whole.train()
    assert len(hist_a) == 3 and whole.last_scores["miou"] >= 0
    want = _snapshot(whole.state)

    cfg_b = _trainer_config(tmp_path / "b")
    first = Trainer(cfg_b, "cpu")
    hist_b = first.train(max_iters=2)  # stops at step 2: validates and saves
    assert [r["loss"] for r in hist_b] == [r["loss"] for r in hist_a[:2]]
    ckpt = first.ckpt
    assert ckpt.has("latest") and ckpt.has("max_performance")
    assert os.path.exists(ckpt._path("latest") + ".config.json")

    resumed = Trainer(cfg_b.updated("network.resume", ckpt._path("latest")), "cpu")
    assert resumed.state.step == 2
    hist_c = resumed.train()
    assert len(hist_c) == 1
    assert hist_c[0]["loss"] == hist_a[2]["loss"]
    got = _snapshot(resumed.state)
    assert got["step"] == want["step"] == 3
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert all(torch.equal(a, b) for a, b in zip(got["momentum"], want["momentum"]))
    assert got["lr"] == want["lr"]
    assert torch.equal(got["bank"], want["bank"])
    assert all(torch.equal(a, b) for a, b in zip(got["ptrs"], want["ptrs"]))
    assert torch.equal(got["generator"], want["generator"])


def test_save_by_mode(tmp_path, monkeypatch):
    tiny_hrnet(monkeypatch)
    cfg = _trainer_config(tmp_path)
    state = Trainer(cfg, "cpu").state
    ckpt = CheckpointManager(str(tmp_path), "m")
    ckpt.save_by_mode(state, "performance", performance=0.5)
    assert ckpt.has("latest") and ckpt.has("max_performance")
    first = (tmp_path / "m_max_performance.pt").stat().st_mtime_ns
    ckpt.save_by_mode(state, "performance", performance=0.4)  # worse: kept
    assert (tmp_path / "m_max_performance.pt").stat().st_mtime_ns == first
    assert ckpt.best_performance == 0.5
    ckpt.save_by_mode(state, "val_loss", val_loss=1.0)
    ckpt.save_by_mode(state, "iters", iters=7)
    assert ckpt.has("min_loss") and ckpt.has("iters7") and not ckpt.has("epoch1")
    state.step = 0
    ckpt.restore(state, "iters7")
    assert state.step == 0 and not ckpt.has("nothing")
