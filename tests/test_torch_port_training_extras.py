"""The port's train-step options against the JAX package's ``make_train_step``.

One step of ``smoke_hrnet_w18`` (``hrnet_w18_mem``: 5 classes, a bank of 50
rows a class and queue, 64 anchors, contrast live from step 0) on a shallow
hrnet18 (``torch_port_helpers.shallow_hrnet18``), 64x64 synthetic scenes,
dropout 0, exact top-k sampling, both packages from the same numpy weights
and bank and the JAX step's draws, as ``tests/test_torch_port_slice.py``
runs the plain step:

* ``accum``: ``solver.grad_accum_steps=2`` on a batch of 4, against the
  JAX ``train_step_accum`` (each microbatch's draws from
  ``split(r_step, 6).reshape(2, 3)``, JAX ``train_step.py:154``);
* ``freeze_bn``: ``network.freeze_bn`` on a batch of 2, the BN running
  statistics unchanged bit for bit on both sides.

Both run ``contrast.momentum_encoder`` (momentum 0.9), the key parameters
starting from their own random weights, so the bank is fed by a key forward
that differs from the query's: under accumulation with the batch's own BN
statistics, under ``freeze_bn`` with the running ones.

Tolerances, those of the slice test: losses (the microbatches' mean) rtol
1e-4; bank pointers equal and rows atol 3.5e-5; parameters atol 5e-4 and
each tensor's update within 4e-2 of JAX's in relative norm; BN statistics
(which chain over the two microbatches) atol 1e-4; key parameters
(``k * 0.9 + q * 0.1`` of the step's initial weights) atol 1e-6.
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
from contrastiveseg_tpu_torch.engine.checkpoint import CheckpointManager
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
    to_port,
)

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

H = W = 64
M = 0.9  # contrast.encoder_momentum
CASES = {"accum": (4, {"solver.grad_accum_steps": 2}),
         "freeze_bn": (2, {"network.freeze_bn": True})}


@pytest.fixture(scope="module", autouse=True)
def _shallow_quick():
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    exact_fp32_reference(mp, compiled_blocks=False)
    with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
        yield
    mp.undo()


def _config(extra=None):
    cfg = get_preset("smoke_hrnet_w18")
    for k, v in {"network.head_dropout": 0.0, "contrast.exact_sampling": True,
                 "contrast.momentum_encoder": True, "contrast.encoder_momentum": M,
                 **(extra or {})}.items():
        cfg = cfg.updated(k, v)
    return cfg


def _batch(cfg, n):
    ds = SyntheticSegDataset(num_classes=5, size_hw=(H, W), length=8)
    samples = [ds[i] for i in range(n)]
    jds = JSynthetic(num_classes=5, size_hw=(H, W), length=8)
    for i, s in enumerate(samples):
        np.testing.assert_array_equal(s["image"], jds[i]["image"])
    p = cfg.get("normalize")
    norm = Normalizer(p["div_value"], p["mean_value"], p["std"])
    return {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
            "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}


def _bank(cfg, seed=3):
    rng = np.random.default_rng(seed)
    C, Mq, D = 5, cfg.get("contrast.memory_size"), cfg.get("contrast.proj_dim")

    def q():
        x = rng.standard_normal((C, Mq, D)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return q(), rng.integers(0, Mq, C).astype(np.int32), q(), rng.integers(
        0, Mq, C).astype(np.int32)


def _draws(r_sample, r_queue, b, C, n):
    khard, keasy = jax.random.split(r_sample)

    def u(k):
        return torch.from_numpy(np.array(jax.random.uniform(k, (b, C, n))))

    return Draws(anchor=AnchorScores(u(khard), u(keasy)), queue=u(r_queue))


def _port_layout(tree):
    return to_port(tree, hrnet_seg_key)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_extras_match_jax(case):
    B, extra = CASES[case]
    cfg = _config(extra)
    A = cfg.get("solver.grad_accum_steps", default=1)
    freeze = cfg.get("network.freeze_bn", default=False)
    batch = _batch(cfg, B)
    C = cfg.get("data.num_classes")
    seg_q, seg_p, pix_q, pix_p = _bank(cfg)

    jmodel = jbuild_model(cfg)
    variables = random_variables(jmodel, (1, H, W, 3), seed=2)
    key_tree = random_variables(jmodel, (1, H, W, 3), seed=5)["params"]
    tx = jbuild_optimizer(cfg, variables["params"])
    rng = jax.random.key(7)
    s0 = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        bank=JBank(*(jnp.asarray(a) for a in (seg_q, seg_p, pix_q, pix_p))),
        rng=rng, tx=tx, key_params=key_tree)
    jstep = jmake_train_step(
        jmodel, jbuild_loss(cfg), warmup_iters=0, network_stride=4,
        pixel_update_freq=cfg.get("contrast.pixel_update_freq"), donate=False,
        exact_sampling=True, freeze_bn=freeze, momentum_encoder=True,
        encoder_momentum=M, grad_accum_steps=A)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})

    n = (H // 4) * (W // 4)
    if A == 1:
        _, _, r_sample, r_queue = jax.random.split(rng, 4)
        draws = _draws(r_sample, r_queue, B, C, n)
    else:
        micro = jax.random.split(jax.random.split(rng)[1], 3 * A).reshape(A, 3)
        draws = [_draws(micro[i, 1], micro[i, 2], B // A, C, n) for i in range(A)]

    model = HRNetSeg(C, "hrnet18", head_dropout=0.0)
    state = create_train_state(cfg, model, "cpu")
    load_jax_variables(state.model, variables)
    keyed = HRNetSeg(C, "hrnet18", head_dropout=0.0)
    load_jax_variables(keyed, {"params": key_tree, "batch_stats": variables["batch_stats"]})
    state.key_params = {k: p.detach().clone() for k, p in keyed.named_parameters()}
    state.bank = bank_from_queues(*(torch.from_numpy(a) for a in (seg_q, seg_p, pix_q, pix_p)))
    stats0 = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
    step = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4,
                           pixel_update_freq=cfg.get("contrast.pixel_update_freq"),
                           freeze_bn=freeze, momentum_encoder=True, encoder_momentum=M,
                           grad_accum_steps=A)
    metrics = step(state, batch, draws)

    assert state.step == 1
    for k in ("loss_seg", "loss_contrast", "loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    assert float(metrics["loss_contrast"]) > 0

    sd = state.model.state_dict()
    before, after = _port_layout(variables["params"]), _port_layout(s1.params)
    worst = 0.0
    for key, want in after.items():
        got = sd[key].numpy()
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=key)
        d_want = want - before[key]
        worst = max(worst, float(np.linalg.norm(got - before[key] - d_want)
                                 / np.linalg.norm(d_want)))
    assert worst < 0.04, worst
    assert max(np.abs(w - before[k]).max() for k, w in after.items()) > 1e-3

    stats = _port_layout({"batch_stats": s1.batch_stats})
    assert len(stats) == len(stats0)
    for key, want in stats.items():
        if freeze:  # unchanged bit for bit, on both sides
            assert torch.equal(sd[key], stats0[key]), key
            np.testing.assert_array_equal(want, stats0[key].numpy(), err_msg=key)
        else:
            np.testing.assert_allclose(sd[key].numpy(), want, atol=1e-4, err_msg=key)
    if not freeze:
        assert not all(torch.equal(sd[k], v) for k, v in stats0.items())

    key_want = _port_layout(s1.key_params)
    assert key_want.keys() == state.key_params.keys()
    for key, want in key_want.items():
        np.testing.assert_allclose(state.key_params[key].numpy(), want, atol=1e-6, err_msg=key)

    np.testing.assert_array_equal(state.bank.segment_ptr.numpy(), np.asarray(s1.bank.segment_ptr))
    np.testing.assert_array_equal(state.bank.pixel_ptr.numpy(), np.asarray(s1.bank.pixel_ptr))
    assert not np.array_equal(np.asarray(s1.bank.segment_ptr), seg_p)
    np.testing.assert_allclose(state.bank.segment_queue.numpy(),
                               np.asarray(s1.bank.segment_queue), atol=3.5e-5)
    np.testing.assert_allclose(state.bank.pixel_queue.numpy(),
                               np.asarray(s1.bank.pixel_queue), atol=3.5e-5)


def test_accumulation_refuses_an_indivisible_batch():
    """A batch of 3 in 2 microbatches: the ``ValueError`` of JAX :149-152, raised
    by both packages before any forward."""
    cfg = _config({"solver.grad_accum_steps": 2})
    batch = _batch(cfg, 3)
    state = create_train_state(cfg, HRNetSeg(5, "hrnet18"), "cpu")
    step = make_train_step(build_loss(cfg), grad_accum_steps=2)
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 2"):
        step(state, batch)
    assert state.step == 0
    jmodel = jbuild_model(cfg)
    jstep = jmake_train_step(jmodel, jbuild_loss(cfg), donate=False, grad_accum_steps=2)
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 2"):
        jstep(JTrainState(step=jnp.zeros((), jnp.int32), params={}, batch_stats={},
                          opt_state=None, bank=None, rng=jax.random.key(0), tx=None),
              {"image": jnp.zeros((3, H, W, 3)), "label": jnp.zeros((3, H, W), jnp.int32)})


def test_checkpoint_keeps_the_key_encoder(tmp_path):
    """``contrast.momentum_encoder``'s key parameters start as a copy of the
    model's (JAX ``trainer.py:103-105``) and round-trip through a checkpoint
    (JAX ``checkpoint.py:36-37, 102``), with the plateau scale."""
    from contrastiveseg_tpu_torch.engine.optim import set_plateau_scale

    cfg = _config()
    state = create_train_state(cfg, HRNetSeg(5, "hrnet18"), "cpu")
    named = dict(state.model.named_parameters())
    assert state.key_params.keys() == named.keys()
    assert all(torch.equal(state.key_params[k], p) and state.key_params[k] is not p
               for k, p in named.items())
    gen = torch.Generator().manual_seed(0)
    for p in state.key_params.values():
        p.copy_(torch.randn(p.shape, generator=gen))
    set_plateau_scale(state.scheduler, 0.1)
    mgr = CheckpointManager(str(tmp_path), "seg")
    mgr.save(state, "latest")
    fresh = create_train_state(cfg, HRNetSeg(5, "hrnet18"), "cpu")
    assert not torch.equal(fresh.key_params["cls_head.3.weight"],
                           state.key_params["cls_head.3.weight"])
    mgr.restore(fresh)
    assert all(torch.equal(fresh.key_params[k], v) for k, v in state.key_params.items())
    assert fresh.scheduler.plateau_scale == 0.1
    assert fresh.optimizer.param_groups[0]["lr"] == pytest.approx(
        0.1 * state.scheduler.base_lrs[0])
    plain = create_train_state(_config({"contrast.momentum_encoder": False}),
                               HRNetSeg(5, "hrnet18"), "cpu")
    assert plain.key_params is None
    mgr.restore(plain)  # a state without a key encoder ignores the file's
