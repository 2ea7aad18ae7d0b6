"""The oracle OCR nets and the ground-truth paths of ``models/ocr.py``
against the JAX package.

* ``SpatialOCR`` alone, handed a one-hot ``gt_sim``: the plain module, with
  ``use_bg`` (``[context, background, feats]``) and with ``use_bg`` and not
  ``use_oc`` (``[background, feats]``); train-mode outputs, BN statistics
  and the input gradients.
* ``IdealSpatialOCRNet``, all five variants, on the shallow deep-base
  ResNet of ``torch_port_helpers.shallow_resnet`` (c4 2048 channels; 2
  images of 49x49, c4 7x7), handed ``gt_labels`` (with ignored pixels):
  train-mode outputs and BN statistics.  Without labels, the three learned
  variants against the JAX nets without labels (the JAX trainer's path),
  and the two ``use_bg`` ones raise the port's ``ValueError`` where the JAX
  net asserts; ``build_model`` on their Cityscapes presets gives the net.

Weights from a numpy seed (heads traced on a stubbed backbone, ``_Features``
of ``test_torch_port_context_nets.py``), loaded through
``load_jax_variables``; the JAX side jitted under ``exact_fp32_reference``
with most of XLA's optimizations off, dropout off on both sides, torch on
one thread.  Tolerances: outputs and BN statistics atol/rtol 1e-3 (read:
logits at most ~1e-4 apart), the module's input gradients atol 1e-5 /
rtol 1e-4.
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.nets as jnets
import contrastiveseg_tpu.models.resnet as jresnet
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.models.ocr import SpatialOCR as JSpatialOCR
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.models.nets import IdealSpatialOCRNet, build_model
from contrastiveseg_tpu_torch.models.ocr import SpatialOCR
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import (
    _ocr_distri,
    flatten,
    key_for,
    load_jax_variables,
)

from torch_port_helpers import (
    SHALLOW_RESNET,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_resnet,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W = 2, 49, 49
VARIANTS = {"ideal_spatial_ocrnet": "spatial", "ideal_spatial_ocrnet_b": "spatial_b",
            "ideal_spatial_ocrnet_c": "spatial_c", "ideal_gather_ocrnet": "gather",
            "ideal_distribute_ocrnet": "distribute"}


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    shallow_resnet(mp)
    exact_fp32_reference(mp, compiled_blocks=False)
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _cfg(name, get=get_preset):
    return get(f"cityscapes_{name}").updated("network.backbone", SHALLOW_RESNET)


def _labels(seed, h=H, w=W, classes=19):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, classes, (B, h // 7 + 1, w // 7 + 1)).repeat(7, 1).repeat(7, 2)
    lab = lab[:, :h, :w]
    lab[rng.uniform(size=lab.shape) < 0.1] = -1
    return lab.astype(np.int32)


class _Features(flax_nn.Module):
    """Stands in for the JAX ``ResNet`` while the heads' variable trees are
    traced: no variables, zeros of the real feature shapes."""

    spec: object
    dtype: object = jnp.float32

    @flax_nn.compact
    def __call__(self, x, train):
        return [jnp.zeros(s.shape, s.dtype) for s in _Features.shapes]


class _WithLabels(flax_nn.Module):
    """Initialises a net that needs ``gt_labels`` at init (the ``use_bg``
    variants)."""

    net: flax_nn.Module

    @flax_nn.compact
    def __call__(self, x, train=True):
        return self.net(x, jnp.zeros(x.shape[:3], jnp.int32), train=train)


class _OCRInputs(flax_nn.Module):
    """Initialises ``SpatialOCR`` from the features alone."""

    m: flax_nn.Module
    k: int

    @flax_nn.compact
    def __call__(self, x, train=True):
        proxy = jnp.zeros((x.shape[0], self.k, x.shape[-1]))
        return self.m(x, proxy, train, gt_sim=jnp.ones(x.shape[:3] + (self.k,)))


@pytest.fixture(scope="module")
def variables():
    """Per net, numpy variables from a seed; one set of backbone arrays."""
    shape = (1, H, W, 3)
    backbone = jresnet.ResNet(jresnet.RESNET_SPECS[SHALLOW_RESNET])
    _Features.shapes = jax.eval_shape(lambda: backbone.init_with_output(
        jax.random.key(0), jnp.zeros(shape), train=True)[0])[-2:]
    trunk = random_variables(backbone, shape, seed=0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnets, "ResNet", _Features)
        for i, name in enumerate(VARIANTS):
            v = random_variables(_WithLabels(jbuild_model(_cfg(name, jget_preset))), shape, i + 1)
            out[name] = {col: {"backbone": trunk[col], **v[col]["net"]} for col in v}
    return out


def _port(name, v):
    with torch.device("meta"):
        pm = build_model(_cfg(name))
    pm.to_empty(device="cpu")
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    load_jax_variables(pm, v)
    return _no_dropout(pm).train()


def _close_outputs_and_stats(pm, out, jout, jnew, what):
    assert set(out) == set(jout) == {"seg", "seg_aux"}
    for k in out:
        assert out[k].shape == (B, H, W, 19)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=f"{what} {k}")
    sd, key = pm.state_dict(), key_for(pm)
    stats = flatten(jax.tree.map(np.asarray, jnew["batch_stats"]))
    for path, new in stats.items():
        np.testing.assert_allclose(sd[key(path)].numpy(), new, atol=1e-3, rtol=1e-3,
                                   err_msg=f"{what} {path}")
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())


@pytest.mark.parametrize("use_bg,use_oc", [(False, True), (True, True), (True, False)])
def test_spatial_ocr_with_ground_truth_matches_jax(use_bg, use_oc):
    C, K, KEY, OUT, h, w = 16, 5, 8, 12, 6, 7
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((B, h, w, C)).astype(np.float32)
    proxy = rng.standard_normal((B, K, C)).astype(np.float32)
    onehot = np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, h, w))]
    jm = JSpatialOCR(KEY, OUT, dropout=0.0, use_bg=use_bg, use_oc=use_oc)
    v = {col: tree["m"] for col, tree in
         random_variables(_OCRInputs(jm, K), (B, h, w, C), seed=4).items()}

    def jfn(f, p):
        out, new = jm.apply(v, f, p, True, gt_sim=jnp.asarray(onehot), mutable=["batch_stats"])
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape))), (out, new)

    (_, (jout, jnew)), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(feats), jnp.asarray(proxy))
    holder = torch.nn.Module()
    holder.ocr = SpatialOCR(C, KEY, OUT, 0.0, use_bg=use_bg, use_oc=use_oc)
    assert holder.ocr.conv_bn_dropout[0].in_channels == (3 if use_bg and use_oc else 2) * C
    load_jax_variables(holder, v, key_of=lambda p: _ocr_distri(p, base="ocr"))
    f = torch.from_numpy(feats).permute(0, 3, 1, 2).requires_grad_()
    p = torch.from_numpy(proxy).requires_grad_()
    out = holder.ocr.train()(f, p, torch.from_numpy(onehot).reshape(B, h * w, K)).permute(
        0, 2, 3, 1)
    (out * torch.cos(torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape))).sum(
    ).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgrads[0]),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[1]), atol=1e-5, rtol=1e-4)
    sd = holder.state_dict()
    for path, new in flatten(jax.tree.map(np.asarray, jnew["batch_stats"])).items():
        np.testing.assert_allclose(sd[_ocr_distri(path, base="ocr")].numpy(), new, atol=1e-3,
                                   rtol=1e-3, err_msg=str(path))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ideal_net_matches_jax_with_and_without_labels(name, variables):
    jm, v = jbuild_model(_cfg(name, jget_preset)), variables[name]
    x = np.random.default_rng(0).standard_normal((B, H, W, 3)).astype(np.float32)
    labels = _labels(1)
    use_bg = VARIANTS[name] in ("spatial_b", "spatial_c")
    runs = [labels] + ([None] if not use_bg else [])
    for lab in runs:
        jlab = None if lab is None else jnp.asarray(lab)
        jout, jnew = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), jlab, train=True,
                                                mutable=["batch_stats"]))(v)
        pm = _port(name, v)
        assert isinstance(pm, IdealSpatialOCRNet) and pm.variant == VARIANTS[name]
        with torch.no_grad():
            out = pm(torch.from_numpy(x), None if lab is None else torch.from_numpy(lab).long())
        _close_outputs_and_stats(pm, out, jout, jnew, f"{name} labels={lab is not None}")
    if use_bg:  # the JAX trainer's path: no labels reach the net
        with pytest.raises(AssertionError, match="use_bg requires"):
            jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        with pytest.raises(ValueError, match="needs gt_labels"):
            _port(name, v)(torch.from_numpy(x))
        assert pm.spatial_ocr_head.conv_bn_dropout[0].in_channels == (
            3 if VARIANTS[name] == "spatial_b" else 2) * 512
