"""The port's LR policies, plateau decay, SWA and BN re-estimation against the
JAX package.

* Every ``lr.lr_policy`` of JAX ``engine/optim.py:45-85``, with and without
  ``lr.is_warm``, at steps 0, 1, warm - 1, warm, the middle and max - 1:
  the port's LR within rtol 1e-6 + atol 1e-9 of the optax schedule (1e-7
  of the base LR: optax computes in float32, whose ``1 + cos`` near the end
  of the cosine keeps fewer digits; read: 1.0e-9 at most).
* ``PlateauController``: the port's copy gives the JAX one's scale sequence
  on a fixed metric sequence, in both modes and both threshold modes, with
  a cooldown; SGD and AdamW steps across a plateau decay (the port folds
  the scale into the LR, JAX scales the update: ``optax.chain(tx, scale)``)
  within rtol 1e-5 + atol 1e-7 of optax after each of three steps (read:
  at most 2.4e-7 apart).
* ``update_swa`` over three updates and ``swap_to_swa`` within 1e-6 of the JAX
  functions; the trainer's SWA update iterations for ``max_iters`` 4, 20 and
  101 equal those of the JAX trainer's condition (``trainer.py:303-305``).
* BN re-estimation on a shallow hrnet18 (``torch_port_helpers.
  shallow_hrnet18``; dropout 0; 3 batches of 2 random 64x64 images): the
  port's running statistics (``reestimate_bn``: torch's cumulative average,
  ``momentum=None``) against the JAX ``Trainer._reestimate_bn`` itself
  (each batch's statistics recovered from flax's moving average, averaged),
  within rtol 1e-4 + atol 1e-5 (read: 6.9e-6 apart at most).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from contrastiveseg_tpu.engine import swa as jswa
from contrastiveseg_tpu.engine.optim import PlateauController as JPlateauController
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.optim import build_schedule as jbuild_schedule
from contrastiveseg_tpu.engine.optim import set_plateau_scale as jset_plateau_scale
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.trainer import Trainer as JTrainer
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.engine.optim import (
    PlateauController,
    build_optimizer,
    build_schedule,
    set_plateau_scale,
)
from contrastiveseg_tpu_torch.engine.swa import (
    init_swa,
    maybe_update_swa,
    reestimate_bn,
    swa_due,
    swap_to_swa,
    update_swa,
)
from contrastiveseg_tpu_torch.models.nets import HRNetSeg
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import hrnet_seg_key, load_jax_variables, to_port

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

POLICIES = ("lambda_poly", "swa_lambda_poly", "lambda_cosine", "swa_lambda_cosine",
            "warmup_cosine", "step", "multistep", "plateau")
SCHEDULE = {"lr.base_lr": 0.01, "solver.max_iters": 100, "lr.warm.warm_iters": 10,
            "lr.step.step_size": 30, "lr.step.gamma": 0.5,
            "lr.multistep.stepvalue": [20, 60], "lr.multistep.gamma": 0.2}


def _both(preset, overrides):
    jcfg, cfg = jget_preset(preset), get_preset(preset)
    for k, v in overrides.items():
        jcfg, cfg = jcfg.updated(k, v), cfg.updated(k, v)
    return jcfg, cfg


def test_every_lr_policy_matches_jax():
    for policy in POLICIES:
        for warm in (False, True):
            jcfg, cfg = _both("smoke_hrnet_w18", {**SCHEDULE, "lr.lr_policy": policy,
                                                  "lr.is_warm": warm})
            jsched, sched = jbuild_schedule(jcfg), build_schedule(cfg)
            got = [0.01 * sched(k) for k in (0, 1, 9, 10, 50, 99)]
            want = [float(jsched(k)) for k in (0, 1, 9, 10, 50, 99)]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9,
                                       err_msg=f"{policy} warm={warm}")
    with pytest.raises(NotImplementedError, match="lr policy"):
        build_schedule(get_preset("smoke_hrnet_w18").updated("lr.lr_policy", "cyclic"))


def test_plateau_controller_matches_jax():
    metrics = [0.10, 0.20, 0.20, 0.2001, 0.19, 0.25, 0.25, 0.24, 0.24, 0.24, 0.30, 0.29, 0.29]
    for mode in ("max", "min"):
        for threshold_mode, threshold in (("rel", 1e-2), ("abs", 5e-3)):
            kw = dict(mode=mode, factor=0.5, patience=1, threshold=threshold,
                      threshold_mode=threshold_mode, cooldown=1, min_scale=0.1)
            jpc, pc = JPlateauController(**kw), PlateauController(**kw)
            got = [pc.step(m) for m in metrics]
            assert got == [jpc.step(m) for m in metrics], (mode, threshold_mode)
            assert got[-1] < 1.0  # the sequence decays in every setting
    jcfg, cfg = _both("smoke_hrnet_w18", {"lr.plateau": {"mode": "min", "factor": 0.3,
                                                         "patience": 2, "min_lr": 1e-4}})
    assert vars(PlateauController.from_config(cfg)) == vars(JPlateauController.from_config(jcfg))


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Conv2d(3, 4, 3)
        self.head = nn.Linear(4, 5)


def _toy_key(path):
    return ".".join(path[:-1] + ({"kernel": "weight"}.get(path[-1], path[-1]),))


@pytest.mark.parametrize("method", ["sgd", "adamw"])
def test_plateau_decay_matches_optax(method):
    """Three steps, the scale set to 0.1 after the first (as a validation
    would set it), on SGD with momentum and weight decay and on AdamW."""
    jcfg, cfg = _both("ade20k_hrnet_w48", {
        "lr.base_lr": 0.01, "solver.max_iters": 10, "lr.lr_policy": "plateau",
        "optim.optim_method": method, "optim.sgd.weight_decay": 0.01,
        "optim.adamw.weight_decay": 0.05})
    rng = np.random.default_rng(0)
    params = {"backbone": {"kernel": rng.standard_normal((3, 3, 3, 4)),
                           "bias": rng.standard_normal(4)},
              "head": {"kernel": rng.standard_normal((4, 5)), "bias": rng.standard_normal(5)}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = _Toy()
    arrays, unmapped = to_port(params, _toy_key)
    assert not unmapped
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()})
    tx = jbuild_optimizer(jcfg, params)
    state = tx.init(params)
    opt, sched = build_optimizer(cfg, model)
    named = dict(model.named_parameters())
    for i in range(3):
        if i == 1:
            state = jset_plateau_scale(state, 0.1)
            set_plateau_scale(sched, 0.1)
        grads = jax.tree.map(lambda a: np.float32(4) * rng.standard_normal(a.shape, np.float32),
                             params)
        for k, g in to_port(grads, _toy_key)[0].items():
            named[k].grad = torch.from_numpy(np.ascontiguousarray(g))
        updates, state = jax.jit(tx.update)(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        opt.step()
        sched.step()
        for k, want in to_port(params, _toy_key)[0].items():
            np.testing.assert_allclose(named[k].detach().numpy(), want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    assert opt.param_groups[0]["lr"] == pytest.approx(0.1 * 0.01)


def test_swa_average_and_schedule():
    model = _Toy()
    rng = np.random.default_rng(1)
    swa = init_swa(model)
    jtree = jswa.init_swa({k: jnp.zeros(p.shape) for k, p in model.named_parameters()})
    for _ in range(3):
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        update_swa(swa, model)
        jtree = jswa.update_swa(jtree, {k: jnp.asarray(p.detach().numpy())
                                        for k, p in model.named_parameters()})
    assert swa.n_averaged == int(jtree.n_averaged) == 3
    for k, want in jtree.avg_params.items():
        np.testing.assert_allclose(swa.avg_params[k].numpy(), np.asarray(want), atol=1e-6)
    maybe_update_swa(swa, model, step=5, swa_start=4, swa_freq=2)  # off the cycle
    assert swa.n_averaged == 3
    maybe_update_swa(swa, model, step=6, swa_start=4, swa_freq=2)
    assert swa.n_averaged == 4
    swap_to_swa(model, swa)
    assert all(torch.equal(p, swa.avg_params[k]) for k, p in model.named_parameters())

    def jax_trainer_updates(max_iters):  # contrastiveseg_tpu/engine/trainer.py:268-270, 303-305
        normal = int(max_iters * 0.75)
        every = (max_iters - normal) // 5 + 1
        return [it + 1 for it in range(max_iters) if (it + 1) > normal and (
            (it + 1 - normal) % every == 0 or (it + 1) == max_iters)]

    for max_iters, want in ((4, [4]), (20, [17, 19, 20]), (101, [81, 87, 93, 99, 101])):
        got = [i for i in range(1, max_iters + 1) if swa_due(i, max_iters)]
        assert got == want == jax_trainer_updates(max_iters), max_iters


def test_bn_reestimation_matches_jax(monkeypatch):
    shallow_hrnet18(monkeypatch)
    exact_fp32_reference(monkeypatch, compiled_blocks=False)
    cfg = get_preset("smoke_hrnet_w18").updated("network.head_dropout", 0.0)
    jmodel = jbuild_model(jget_preset("smoke_hrnet_w18").updated("network.head_dropout", 0.0))
    variables = random_variables(jmodel, (1, 64, 64, 3), seed=4)
    rng = np.random.default_rng(6)
    images = [rng.standard_normal((2, 64, 64, 3)).astype(np.float32) for _ in range(3)]

    fake = types.SimpleNamespace(model=jmodel, state=JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None, bank=None,
        rng=jax.random.key(0), tx=None))
    with shared_jax_compiles(), unoptimized_jax_compiles():
        JTrainer._reestimate_bn(fake, iter({"image": jnp.asarray(x)} for x in images),
                                num_batches=3)
    want = to_port({"batch_stats": fake.state.batch_stats}, hrnet_seg_key)[0]

    model = HRNetSeg(cfg.get("data.num_classes"), "hrnet18", head_dropout=0.0)
    load_jax_variables(model, variables)
    momenta = {m: m.momentum for m in model.modules() if isinstance(m, nn.BatchNorm2d)}
    with one_torch_thread():
        reestimate_bn(model, iter({"image": torch.from_numpy(x)} for x in images), 3)
    assert all(m.momentum == mom for m, mom in momenta.items())
    sd = model.state_dict()
    assert want and all(k.endswith(("running_mean", "running_var")) for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-4, atol=1e-5, err_msg=k)
