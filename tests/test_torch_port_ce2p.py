"""The CE2P nets (``models/ce2p.py``) against the JAX package.

``CE2PNet`` with each context head (``asp_ocr``, ``ocr``, ``psp``) on a
shallow deep-base ResNet dilated 16 (layers (1, 1, 2, 2) at the full
widths: c1 256, c2 512, c3 1024, c4 2048 channels), 20 classes (LIP), 2
images of 97x97 (c1 25x25, c4 7x7, above PSP's largest bin, 6):

* the four outputs (``seg``, ``edge``, ``seg_aux``, ``seg_final``, each
  upsampled to the input) in train mode, with the BN statistics after the
  forward, and in eval mode, with the gradient of every parameter of a
  fixed weighting of all four outputs (in eval mode, so that no BN
  backward cancels digits; at 49x49 the JAX side's weight gradient of
  layer2's stride-2 conv is 2e-2 (relative L2) from an fp64 run of the
  port, where the port's fp32 is 8e-7 from it);
* one step of ``lip_ce2p_ocrnet``'s recipe (``fs_auxce_loss`` on ``seg`` and
  ``seg_aux``, SGD with weight decay): the loss and every parameter after
  the step, the edge branch and the final classifier (which the loss does
  not reach) decayed as in the JAX step;
* a ``ce2p_asp_ocrnet`` ``.pth`` in the reference's CE2P_ASPOCR layout loads
  strictly and the JAX importer (mapper ``ce2p``) maps the same file onto
  the variables the port was loaded from; the two other contexts refuse a
  segmentor file (no reference layout).

Weights from a numpy seed (the heads traced on a stubbed backbone), the JAX
side jitted under ``exact_fp32_reference`` (and its CE2P resizes exact),
most of XLA's optimizations off, dropout off on both sides.  Tolerances:
outputs and BN statistics atol/rtol 1e-3; each parameter's gradient within
1e-4 of its JAX norm (relative L2), with a floor of 1e-6 of the largest
gradient norm (read: 2e-4 on the attention's query and key convs, whose
gradients are 1e-6 of the largest, 2e-6 elsewhere); after the step, the
loss rtol 1e-4 and the parameters atol 5e-4 (as
``tests/test_torch_port_context_nets.py``).
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.ce2p as jce2p
import contrastiveseg_tpu.models.resnet as jresnet
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.ops.resize import resize_bilinear_align_corners
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models import resnet
from contrastiveseg_tpu_torch.models.ce2p import CE2PNet
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, key_for, load_jax_variables
from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W, NC = 2, 97, 97, 20
SHALLOW16 = "deepbase_resnet_shallow_dilated16"
NETS = {"asp_ocr": "ce2p_asp_ocrnet", "ocr": "ce2p_ocrnet", "psp": "ce2p_ocrnet"}
OUTPUTS = ("seg", "edge", "seg_aux", "seg_final")
GRAD_REL = 1e-4


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    for mod in (jresnet, resnet):
        mp.setitem(mod.RESNET_SPECS, SHALLOW16, mod.ResNetSpec((1, 1, 2, 2), dilate_scale=16))
    exact_fp32_reference(mp, compiled_blocks=False)
    mp.setattr(jce2p, "resize_bilinear_align_corners",
               lambda x, size, fast=False: resize_bilinear_align_corners(x, size, fast=False))
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _cfg(context, get=get_preset):
    return get("lip_ce2p_ocrnet").updated("network.model_name", NETS[context]).updated(
        "network.backbone", SHALLOW16)


def _jax_model(context):
    if context == "psp":  # no registered name: the JAX module itself
        return jce2p.CE2PNet(num_classes=NC, context="psp", arch=SHALLOW16)
    return jbuild_model(_cfg(context, jget_preset))


def _port_model(context):
    with torch.device("meta"):
        pm = (CE2PNet(NC, "psp", SHALLOW16) if context == "psp"
              else build_model(_cfg(context)))
    pm.to_empty(device="cpu")
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return pm


class _Features(flax_nn.Module):
    """Stands in for the JAX ``ResNet`` while the heads' variables are
    traced: zeros of the real c1-c4 shapes."""

    spec: object
    dtype: object = jnp.float32

    @flax_nn.compact
    def __call__(self, x, train):
        return [jnp.zeros(s.shape, s.dtype) for s in _Features.shapes]


@pytest.fixture(scope="module")
def variables():
    shape = (1, H, W, 3)
    backbone = jresnet.ResNet(jresnet.RESNET_SPECS[SHALLOW16])
    _Features.shapes = jax.eval_shape(lambda: backbone.init_with_output(
        jax.random.key(0), jnp.zeros(shape), train=True)[0])[-4:]
    trunk = random_variables(backbone, shape, seed=0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jce2p, "ResNet", _Features)
        for i, context in enumerate(NETS):
            v = random_variables(_jax_model(context), shape, seed=i + 1)
            out[context] = {col: {"backbone": trunk[col], **v[col]} for col in v}
    return out


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, H, W, 3)).astype(np.float32)


def _weights():
    rng = np.random.default_rng(9)
    return {k: rng.standard_normal((B, H, W, 2 if k == "edge" else NC)).astype(np.float32)
            for k in OUTPUTS}


def _as_port(arr):
    return np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr


@pytest.mark.parametrize("context", list(NETS))
def test_forward_and_gradient_match_jax(context, variables):
    jm, v = _jax_model(context), variables[context]
    x, wts = _images(), _weights()
    jout, jnew = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"]))(v)

    def jfn(params):  # eval mode: BN on its running statistics
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                       train=False)
        return sum(jnp.sum(out[k] * wts[k]) for k in OUTPUTS), out

    jgrads, jeval = jax.jit(jax.grad(jfn, has_aux=True))(v["params"])
    pm = _port_model(context)
    load_jax_variables(pm, v)
    assert pm.reference_layout == (context == "asp_ocr")
    with torch.no_grad():
        out = pm.train()(torch.from_numpy(x))
    assert set(out) == set(jout) == set(OUTPUTS)
    for k in OUTPUTS:
        assert out[k].shape == (B, H, W, 2 if k == "edge" else NC)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=k)
    sd, key = pm.state_dict(), key_for(pm)
    for path, new in flatten(jax.tree.map(np.asarray, jnew["batch_stats"])).items():
        np.testing.assert_allclose(sd[key(path)].numpy(), new, atol=1e-3, rtol=1e-3,
                                   err_msg=str(path))
    load_jax_variables(pm, v)  # the running statistics before the train-mode forward
    out = pm.eval()(torch.from_numpy(x))
    for k in OUTPUTS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jeval[k]), atol=1e-3,
                                   rtol=1e-3, err_msg=f"eval {k}")
    sum((out[k] * torch.from_numpy(wts[k])).sum() for k in OUTPUTS).backward()
    params = dict(pm.named_parameters())
    want = {key(path): _as_port(g) for path, g in
            flatten(jax.tree.map(np.asarray, jgrads)).items()}
    assert set(want) == set(params)
    floor = 1e-6 * max(np.linalg.norm(g) for g in want.values())
    for k, g in want.items():
        err = np.linalg.norm(params[k].grad.numpy() - g)
        assert err <= GRAD_REL * np.linalg.norm(g) + floor, (k, err, np.linalg.norm(g))


def test_lip_ce2p_train_step_matches_jax(variables):
    context = "ocr"
    jcfg, cfg = _cfg(context, jget_preset), _cfg(context)
    assert cfg.get("loss.loss_type") == "fs_auxce_loss" and cfg.get("data.num_classes") == NC
    v = variables[context]
    rng = np.random.default_rng(4)
    labels = rng.integers(-1, NC, (B, H // 7 + 1, W // 7 + 1)).repeat(7, 1).repeat(7, 2)
    batch = {"image": torch.from_numpy(_images(1)),
             "label": torch.from_numpy(labels[:, :H, :W].astype(np.int64))}
    tx = jbuild_optimizer(jcfg, v["params"])
    s0 = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                     batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), bank=None,
                     rng=jax.random.key(7), tx=tx)
    jstep = jmake_train_step(_jax_model(context), jbuild_loss(jcfg), warmup_iters=0,
                             network_stride=16, donate=False)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})
    state = create_train_state(cfg, _port_model(context), "cpu")
    load_jax_variables(state.model, v)
    metrics = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=16)(state, batch)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)
    sd, key = state.model.state_dict(), key_for(state.model)
    moved = 0
    for path, want in flatten(jax.tree.map(np.asarray, s1.params)).items():
        assert np.abs(sd[key(path)].numpy() - _as_port(want)).max() <= 5e-4, path
        if path[0] in ("edge", "final_conv", "final_cls"):  # weight decay alone moves them
            before = _as_port(flatten(v["params"])[path])
            moved += not np.array_equal(sd[key(path)].numpy(), before)
    assert moved > 0


def test_asp_ocr_pth_round_trips_and_the_others_are_refused(variables, tmp_path):
    """As ``test_pth_round_trips_through_the_jax_importer`` of
    ``tests/test_torch_port_context_nets.py``, for CE2P_ASPOCR."""
    v = variables["asp_ocr"]
    pm = _port_model("asp_ocr")
    load_jax_variables(pm, v)
    sd = pm.state_dict()
    mapper = ti.mapper_for_model("ce2p_asp_ocrnet")
    assert mapper == "ce2p"
    zeros = jax.tree.map(np.zeros_like, v)
    folds = {path: tk.fold_bias_key for path in flatten(zeros["batch_stats"])
             if (tk := ti.PATH_MAPPERS[mapper](path)) is not None and tk.fold_bias_key}
    file = dict(sd)
    for i, bias in enumerate(sorted(set(folds.values()))):
        n = sd[bias.removesuffix(".bias") + ".weight"].shape[0]
        file[bias] = torch.linspace(-1, 1, n) * (i + 1) / len(folds)
    torch.save({"state_dict": {f"module.{k}": t for k, t in file.items()}}, tmp_path / "a.pth")
    fresh = _port_model("asp_ocr")
    assert load_pretrained(fresh, str(tmp_path / "a.pth")) is None
    jvars, report = ti.convert_state_dict(zeros, {k: t.numpy() for k, t in file.items()}, mapper)
    assert report["missing"] == [] and report["unused"] == []
    got, key = fresh.state_dict(), key_for(fresh)
    for col in ("params", "batch_stats"):
        want = flatten(v[col])
        for path, arr in flatten(jvars[col]).items():
            expect = want[path] - file[folds[path]].numpy() if path in folds else want[path]
            assert np.array_equal(arr, expect), path
            assert np.array_equal(_as_port(arr), got[key(path)].numpy()), path
    for context in ("ocr", "psp"):
        model = _port_model(context)
        assert not model.reference_layout
        with pytest.raises(ValueError, match="no reference layout"):
            load_pretrained(model, str(tmp_path / "a.pth"))
