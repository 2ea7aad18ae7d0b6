"""The port's optimizers against optax: ``adam`` (L2 added to the gradient
before Adam), ``adamw`` (decoupled), ``optim.group_method="decay"`` (conv
and linear weights only: the JAX ``kernel`` leaves), ``network.clip_grad_norm``
(optax's ``clip_by_global_norm``), and SGD with the decay groups, a clip and
``lr.nbb_mult``.

A small module with a backbone (conv, LayerNorm, position table) and heads
(BN, linear), its JAX parameter tree spelled out beside it; three steps of
the same numpy gradients (global norms 50.8-56.4, so a clip of 1.0 scales
them and one of 1e3 does not) on both sides, with the poly LR.  Parameters,
and the Adam moments, step counts and SGD momentum, within rtol 1e-5 + atol
1e-7 after each step (read: at most 4.8e-7 apart, inside the bound).
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.engine.optim import build_optimizer
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, to_port

TOL = dict(rtol=1e-5, atol=1e-7)
CASES = {
    "adam": {"optim.optim_method": "adam", "optim.adam.weight_decay": 0.01},
    "adam_decay": {"optim.optim_method": "adam", "optim.adam.weight_decay": 0.01,
                   "optim.group_method": "decay"},
    "adamw": {"optim.optim_method": "adamw", "optim.adamw.weight_decay": 0.05},
    "adamw_decay": {"optim.optim_method": "adamw", "optim.adamw.weight_decay": 0.05,
                    "optim.group_method": "decay"},
    "adamw_decay_clip": {"optim.optim_method": "adamw", "optim.adamw.weight_decay": 0.05,
                         "optim.group_method": "decay", "network.clip_grad_norm": 1.0},
    "sgd_decay_clip_nbb": {"optim.optim_method": "sgd", "optim.sgd.weight_decay": 0.01,
                           "optim.group_method": "decay", "network.clip_grad_norm": 1e3,
                           "lr.nbb_mult": 2.0},
}


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.conv = nn.Conv2d(3, 4, 3)
        self.backbone.ln = nn.LayerNorm(4)
        self.backbone.pos_embed = nn.Parameter(torch.zeros(1, 6, 4))
        self.bn = nn.BatchNorm2d(4)
        self.head = nn.Linear(4, 5)


def _key(path):
    """JAX path -> the toy's key."""
    name = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(path[:-1] + (name,)) if path[-1] != "pos_embed" else "backbone.pos_embed"


def _params(rng):
    return {"backbone": {"conv": {"kernel": rng.standard_normal((3, 3, 3, 4)),
                                  "bias": rng.standard_normal(4)},
                         "ln": {"scale": rng.standard_normal(4), "bias": rng.standard_normal(4)},
                         "pos_embed": rng.standard_normal((1, 6, 4))},
            "bn": {"scale": rng.standard_normal(4), "bias": rng.standard_normal(4)},
            "head": {"kernel": rng.standard_normal((4, 5)), "bias": rng.standard_normal(5)}}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _adam_moments(state):
    """The optax Adam state (or SGD trace) in ``state``."""
    for node in jax.tree.leaves(state, is_leaf=lambda n: hasattr(n, "mu") or hasattr(n, "trace")):
        if hasattr(node, "mu") or hasattr(node, "trace"):
            return node
    raise AssertionError("no moments")


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    jcfg, cfg = jget_preset("ade20k_hrnet_w48"), get_preset("ade20k_hrnet_w48")
    for k, v in {"lr.base_lr": 0.01, "solver.max_iters": 10, **CASES[case]}.items():
        jcfg, cfg = jcfg.updated(k, v), cfg.updated(k, v)
    rng = np.random.default_rng(0)
    params = _f32(_params(rng))
    model = _Toy()
    arrays, unmapped = to_port(params, _key)
    assert not unmapped
    model.load_state_dict({**model.state_dict(), **{k: torch.from_numpy(np.ascontiguousarray(a))
                                                   for k, a in arrays.items()}})
    tx = jbuild_optimizer(jcfg, params)
    state = tx.init(params)
    opt, sched = build_optimizer(cfg, model)
    named = dict(model.named_parameters())
    assert len(named) == len(flatten(params))
    for _ in range(3):
        grads = _f32(jax.tree.map(lambda a: 4 * rng.standard_normal(a.shape), params))
        assert 1.0 < float(optax.global_norm(grads)) < 1e3  # a clip of 1.0 cuts, 1e3 does not
        for k, g in to_port(grads, _key)[0].items():
            named[k].grad = torch.from_numpy(np.ascontiguousarray(g))
        updates, state = jax.jit(tx.update)(grads, state, params)
        params = _f32(optax.apply_updates(params, updates))
        opt.step()
        sched.step()
        for k, want in to_port(params, _key)[0].items():
            np.testing.assert_allclose(named[k].detach().numpy(), want, **TOL, err_msg=k)
        if "nbb" in case:
            continue  # optax's multi_transform keeps a masked state a group
        moments = _adam_moments(state)
        for field, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq"), ("trace", "momentum_buffer")):
            if hasattr(moments, field):
                for k, want in to_port(getattr(moments, field), _key)[0].items():
                    np.testing.assert_allclose(opt.state[named[k]][slot].numpy(), want, **TOL,
                                               err_msg=f"{field} {k}")
        if hasattr(moments, "count"):
            assert all(int(opt.state[p]["step"]) == int(moments.count) for p in named.values())
    decayed = {k for g in opt.param_groups if g["weight_decay"] > 0 for k, p in named.items()
               if any(p is q for q in g["params"])}
    assert decayed == ({"backbone.conv.weight", "head.weight"} if "decay" in case
                       else set(named))
    assert type(opt).__name__ == {"adam": "Adam", "adamw": "AdamW", "sgd": "SGD"}[
        CASES[case]["optim.optim_method"]]
