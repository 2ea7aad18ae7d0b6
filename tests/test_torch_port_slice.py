"""The slice end to end: one train step of the port against ``make_train_step``.

The ``smoke_hrnet_w18`` preset (5 classes, memory bank of 50 rows per class
and queue, 64 anchors, warmup 0 so the contrast term and its gradient are
live) on a shallow hrnet18 (``torch_port_helpers.shallow_hrnet18``: the W18
widths and every fuse, one module of one block a stage), batch 2 of 64x64
synthetic scenes, dropout 0, exact top-k sampling.  Both packages start
from the same numpy weights and bank and get the same random draws: the
test re-derives the JAX step's draws (``train_step.py:74``,
``contrast.py:101-103``, ``queue.py:127``) and hands them to the port.  The
JAX step runs jitted whole, with ``network.pallas_conv`` too
(``compiled_pallas_conv`` makes each kernel launch one host call), and
compiled with most of XLA's optimizations off
(``unoptimized_jax_compiles``); torch runs on one thread.

Tolerances: losses rtol 1e-4; bank pointers exactly equal and rows atol
3.5e-5 (the enqueued rows are the two forwards' unit embeddings, which
differ in summation order); post-step parameters atol 5e-4, and each
tensor's update (new - old) within 4e-2 of the JAX update in relative norm.
Read at this size with torch on 1, 3 and 8 threads, flag off and on alike,
and XLA's optimizations on and off: losses within 7.8e-7, bank rows
1.8e-6, parameters 5.6e-7, updates 2.0e-4 to 8.3e-4.  The bounds are
fp32's for a deep HRNet, not the port's: at random init the CE gradient is
mostly a per-class constant that every BN backward subtracts out, so weight
gradients lose digits to cancellation.  With the full hrnet18 the same
readings were parameters 2.0e-4 to 4.0e-4 and updates 1.86e-2 to 1.92e-2;
at 64x128, against an fp64 run of the port, the fp32 port's gradients were
off by up to 3e-3 in relative norm and the fp32 JAX step's by more.  A
wrong term in the update (sign, weight decay, momentum, a missing gradient
path) moves the relative error to order 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.data.datasets import SyntheticSegDataset as JSynthetic
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.ops.queue import MemoryBank as JBank
from contrastiveseg_tpu.presets import get_preset
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import HRNetSeg
from contrastiveseg_tpu_torch.ops.queue import bank_from_queues
from contrastiveseg_tpu_torch.utils.jax_weights import (
    flatten,
    hrnet_seg_key,
    load_jax_variables,
)

from torch_port_helpers import (
    compiled_pallas_conv,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

H, W, B = 64, 64, 2


@pytest.fixture(scope="module", autouse=True)
def _shallow_quick():
    """The shallow hrnet18 in both packages, the JAX compiles shared and
    unoptimized, torch on one thread (the checks hold on 1, 3 and 8)."""
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
        yield
    mp.undo()


def _config(pallas_conv=False):
    cfg = get_preset("smoke_hrnet_w18")
    cfg = cfg.updated("network.head_dropout", 0.0)
    cfg = cfg.updated("network.pallas_conv", pallas_conv)
    return cfg.updated("contrast.exact_sampling", True)


def _batch(cfg, h=H, w=W):
    ds = SyntheticSegDataset(num_classes=5, size_hw=(h, w), length=8)
    samples = [ds[i] for i in range(B)]
    jds = JSynthetic(num_classes=5, size_hw=(h, w), length=8)
    for i, s in enumerate(samples):  # the port's scenes are the JAX package's
        np.testing.assert_array_equal(s["image"], jds[i]["image"])
        np.testing.assert_array_equal(s["label"], jds[i]["label"])
    n = cfg.get("normalize")
    norm = Normalizer(n["div_value"], n["mean_value"], n["std"])
    return {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
            "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}


def _bank(cfg, seed=3):
    rng = np.random.default_rng(seed)
    C, M, D = 5, cfg.get("contrast.memory_size"), cfg.get("contrast.proj_dim")

    def q():
        x = rng.standard_normal((C, M, D)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return q(), rng.integers(0, M, C).astype(np.int32), q(), rng.integers(
        0, M, C).astype(np.int32)


def _step_against_jax(pallas_conv, h, w):
    cfg = _config(pallas_conv)
    batch = _batch(cfg, h, w)
    C = cfg.get("data.num_classes")
    seg_q, seg_p, pix_q, pix_p = _bank(cfg)

    # --- JAX reference step.
    jmodel = jbuild_model(cfg)
    variables = random_variables(jmodel, (1, h, w, 3), seed=2)
    tx = jbuild_optimizer(cfg, variables["params"])
    rng = jax.random.key(7)
    s0 = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        bank=JBank(jnp.asarray(seg_q), jnp.asarray(seg_p), jnp.asarray(pix_q),
                   jnp.asarray(pix_p)),
        rng=rng, tx=tx)
    jstep = jmake_train_step(
        jmodel, jbuild_loss(cfg), warmup_iters=0, network_stride=4,
        pixel_update_freq=cfg.get("contrast.pixel_update_freq"), donate=False,
        exact_sampling=True)
    jbatch = {"image": jnp.asarray(batch["image"].numpy()),
              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))}
    s1, jmetrics = jstep(s0, jbatch)

    # --- the JAX step's draws.
    _, _, r_sample, r_queue = jax.random.split(rng, 4)
    khard, keasy = jax.random.split(r_sample)
    n_embed = (h // 4) * (w // 4)
    draws = Draws(
        anchor=AnchorScores(
            torch.from_numpy(np.asarray(jax.random.uniform(khard, (B, C, n_embed)))),
            torch.from_numpy(np.asarray(jax.random.uniform(keasy, (B, C, n_embed))))),
        queue=torch.from_numpy(np.asarray(jax.random.uniform(r_queue, (B, C, n_embed)))))

    # --- the port's step on the same weights, bank, batch and draws.
    model = HRNetSeg(C, "hrnet18", head_dropout=0.0, pallas_conv=pallas_conv)
    state = create_train_state(cfg, model, "cpu")
    load_jax_variables(state.model, variables)
    state.bank = bank_from_queues(*(torch.from_numpy(a) for a in (seg_q, seg_p, pix_q, pix_p)))
    step = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4,
                           pixel_update_freq=cfg.get("contrast.pixel_update_freq"))
    metrics = step(state, batch, draws)

    assert state.step == 1
    for k in ("loss_seg", "loss_contrast", "loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(metrics["loss_contrast"]) > 0

    sd = state.model.state_dict()
    before = flatten(variables["params"])
    after = flatten(s1.params)
    assert len(after) == len(before)
    worst_update = 0.0
    for path, want in after.items():
        key = hrnet_seg_key(path)
        got = sd[key].numpy()
        if got.ndim == 4:
            got = np.transpose(got, (2, 3, 1, 0))
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=key)
        d_want, d_got = want - before[path], got - before[path]
        worst_update = max(worst_update, float(
            np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)))
    assert worst_update < 0.04, worst_update
    moved = max(np.abs(w - before[p]).max() for p, w in after.items())
    assert moved > 1e-3  # the step really changed the weights

    np.testing.assert_array_equal(state.bank.segment_ptr.numpy(), np.asarray(s1.bank.segment_ptr))
    np.testing.assert_array_equal(state.bank.pixel_ptr.numpy(), np.asarray(s1.bank.pixel_ptr))
    assert not np.array_equal(np.asarray(s1.bank.segment_ptr), seg_p)
    np.testing.assert_allclose(state.bank.segment_queue.numpy(),
                               np.asarray(s1.bank.segment_queue), atol=3.5e-5)
    np.testing.assert_allclose(state.bank.pixel_queue.numpy(),
                               np.asarray(s1.bank.pixel_queue), atol=3.5e-5)


def test_one_train_step_matches_jax(monkeypatch):
    """The JAX step jitted whole."""
    exact_fp32_reference(monkeypatch, compiled_blocks=False)
    _step_against_jax(False, H, W)


def test_one_train_step_with_pallas_conv_matches_jax(monkeypatch):
    """``network.pallas_conv`` on both sides: branches 0 and 1 (C=18, 36) run
    the JAX Pallas conv (interpret mode, each launch a host call inside the
    jitted step: ``compiled_pallas_conv``) and the port's K2 wrappers,
    forward, dX and dW; same tolerances."""
    exact_fp32_reference(monkeypatch, compiled_blocks=False)
    calls = compiled_pallas_conv(monkeypatch)
    _step_against_jax(True, H, W)
    # Forward, dX and dW of every branch-0 and branch-1 3x3 conv.
    assert {shape[1:] for shape in calls} == {(16, 16, 18), (8, 8, 36)}
    assert len(calls) == 3 * 12, len(calls)  # 12 such convs


def test_lr_schedule_matches_optax_count():
    """LambdaLR stepped after each optimizer step reads the same count as
    the optax schedule: lr_k = base * (1 - k/max_iters)^0.9."""
    from contrastiveseg_tpu.engine.optim import build_schedule as jbuild_schedule

    cfg = _config().updated("solver.max_iters", 10)
    state = create_train_state(cfg, HRNetSeg(5, "hrnet18"), "cpu")
    jsched = jbuild_schedule(cfg)
    for k in range(4):
        np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"],
                                   float(jsched(k)), rtol=1e-6)
        state.optimizer.step()
        state.scheduler.step()


def test_build_loss_refuses_a_contrast_kernel_choice():
    """The port has one InfoNCE path: K1, whose wrappers pick the kernel or
    the plain version by the tensors' device; a config cannot choose."""
    with pytest.raises(ValueError, match="contrast.kernel"):
        build_loss(_config().updated("contrast.kernel", "stream"))


def test_trainer_refuses_what_is_not_ported():
    """The training extras are ported: the trainer accepts them."""
    from contrastiveseg_tpu_torch.engine.trainer import check_supported

    cfg = _config()
    check_supported(cfg)
    check_supported(cfg.updated("solver.test_interval", 2))  # the evaluator is ported
    check_supported(cfg.updated("data.synthetic", False))  # the data pipeline is ported
    check_supported(cfg.updated("data.synthetic", False).updated("data.loader", "dt_offset"))
    check_supported(cfg.updated("contrast.momentum_encoder", True))
    check_supported(cfg.updated("network.freeze_bn", True))
    check_supported(cfg.updated("solver.grad_accum_steps", 2))
