"""The port's sibling-preset losses against the JAX package's, on fixed inputs.

Fixed random logits, embeddings and labels from a numpy seed, no model:
``ohem_cross_entropy``, ``aux_cross_entropy``, every ``PlainSegLoss`` route
and the self-contrast InfoNCE (``contrastive_loss`` without a queue,
``pixel_contrast_loss``, ``ContrastCELoss`` without a bank, its seg term CE,
RMI or CE + Lovasz), the RMI and Lovasz loss types, each loss type built by
both packages' ``build_loss`` from one config.  The samplers get
the JAX package's own uniform draws, so both sides pick the same anchors.
The JAX side's value and gradients are compiled as one program.

Tolerances: losses rtol 1e-5; gradients with respect to the logits and
embeddings rtol 1e-4, atol 1e-6 (fp32 sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.losses import ce as jce
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.ops import contrast as jcontrast
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.losses import ce as tce
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores, ContrastCELoss, PlainSegLoss
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.ops import contrast as tcontrast
from contrastiveseg_tpu_torch.presets import get_preset

from torch_port_helpers import shared_jax_compiles

B, C, H, W = 2, 5, 16, 24  # labels; the stride-level outputs are H/2 x W/2
D = 8
RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
CW = (0.8, 1.2, 1.0, 0.9, 1.1)


@pytest.fixture(autouse=True)
def _shared_compiles():
    with shared_jax_compiles():
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _labels(seed=0, ignore=0.1):
    """[B, H, W] blocky labels (so classes fill their pools unevenly) with a
    share ``ignore`` of -1."""
    r = _rng(seed)
    coarse = r.choice(C, (B, H // 4, W // 4), p=[0.5, 0.25, 0.15, 0.07, 0.03])
    lab = np.repeat(np.repeat(coarse, 4, 1), 4, 2)
    lab[r.uniform(size=lab.shape) < ignore] = -1
    return lab.astype(np.int32)


def _logits(shape, seed, scale=2.0):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _embed(seed=5, shape=(B, H // 2, W // 2, D)):
    e = _rng(seed).standard_normal(shape).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def _jax_value_and_grads(fn, *arrays, has_aux=False):
    """fn(*jnp arrays) -> (value, grads w.r.t. every array), compiled as one
    program (eagerly, each of the samplers' many small ops would compile on
    its own); with ``has_aux``, fn returns (value, aux) and so does this
    (value, grads, aux)."""
    value, grads = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(arrays))),
                                              has_aux=has_aux))(*(jnp.asarray(a) for a in arrays))
    grads = [np.asarray(g) for g in grads]
    if has_aux:
        value, aux = value
        return float(value), grads, aux
    return float(value), grads


def _torch_value_and_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return float(value.detach()), [t.grad.numpy() for t in ts]


def _check(got, want):
    (gv, gg), (wv, wg) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _ohem_threshold_source(logits, labels, thresh, min_kept):
    """'thresh' or 'min_kept': which term of max(thresh, sorted_p[k]) wins."""
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    valid = labels != -1
    p_true = np.take_along_axis(p, np.clip(labels, 0, C - 1)[..., None], -1)[..., 0]
    sorted_p = np.sort(np.where(valid, p_true, 2.0).reshape(-1))
    k = min(min_kept, max(int(valid.sum()) - 1, 0))
    return "min_kept" if sorted_p[k] > thresh else "thresh"


@pytest.mark.parametrize("case", ["thresh", "min_kept", "all_ignored"])
def test_ohem_cross_entropy(case):
    logits = _logits((B, H, W, C), seed=1)
    labels = _labels(seed=2)
    thresh, min_kept = {"thresh": (0.7, 20), "min_kept": (0.05, 400),
                        "all_ignored": (0.7, 20)}[case]
    if case == "all_ignored":
        labels = np.full_like(labels, -1)
    else:
        assert _ohem_threshold_source(logits, labels, thresh, min_kept) == case
    args = dict(thresh=thresh, min_kept=min_kept, class_weight=CW, ignore_index=-1)
    want = _jax_value_and_grads(
        lambda x: jce.ohem_cross_entropy(x, jnp.asarray(labels), **args), logits)
    got = _torch_value_and_grads(
        lambda x: tce.ohem_cross_entropy(x, torch.from_numpy(labels), **args), logits)
    _check(got, want)
    if case == "all_ignored":
        assert got[0] == 0.0 and not got[1][0].any()


def test_ohem_keeps_every_tie_at_the_threshold_out():
    """Pixels whose probability equals sorted_p[k] exactly are not kept
    (strict <), whichever order a sort puts the ties in: with all logits
    equal every probability ties, and the loss keeps no pixel."""
    logits = np.zeros((B, H, W, C), np.float32)
    labels = _labels(seed=3)
    got = tce.ohem_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 thresh=0.1, min_kept=10)
    want = jce.ohem_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  thresh=0.1, min_kept=10)
    assert float(got) == float(want) == 0.0


def test_aux_cross_entropy():
    seg, aux = _logits((B, H, W, C), seed=1), _logits((B, H, W, C), seed=4)
    labels = _labels(seed=2)
    args = dict(seg_weight=1.0, aux_weight=0.4, class_weight=CW, ignore_index=-1)
    want = _jax_value_and_grads(
        lambda s, a: jce.aux_cross_entropy(s, a, jnp.asarray(labels), **args), seg, aux)
    got = _torch_value_and_grads(
        lambda s, a: tce.aux_cross_entropy(s, a, torch.from_numpy(labels), **args),
        seg, aux)
    _check(got, want)


def _config(preset, loss_type, **extra):
    """The same config for both packages' build_loss."""
    over = {"loss.loss_type": loss_type, "data.num_classes": C,
            "loss.params.ce_weight": list(CW), "loss.params.ohem_minkeep": 300,
            "loss.params.ohem_thresh": 0.7, "contrast.max_samples": 64,
            "contrast.max_views": 6, "contrast.exact_sampling": True, **extra}
    cfgs = [jget_preset(preset), get_preset(preset)]
    for k, v in over.items():
        cfgs = [c.updated(k, v) for c in cfgs]
    return cfgs


_PLAIN = {  # loss_type -> the extra outputs it reads
    "fs_ce_loss": (),
    "fs_ohemce_loss": (),
    "fs_auxce_loss": ("seg_aux",),
    "fs_auxohemce_loss": ("seg_aux",),
    "fs_auxce_dsn_loss": ("seg_aux1", "seg_aux2", "seg_aux3"),
}


@pytest.mark.parametrize("loss_type", list(_PLAIN))
def test_plain_seg_loss_routes_and_builders(loss_type):
    """Every PlainSegLoss route, built by both packages from one config: the
    seg logits at the label size, the aux heads at stride 2 (upsampled by
    the loss)."""
    jcfg, cfg = _config("cityscapes_hrnet_w48", loss_type,
                        **{"network.loss_weights": {"aux_loss": 0.3, "seg_loss": 0.9}})
    port = build_loss(cfg)
    assert isinstance(port, PlainSegLoss)
    jloss = jbuild_loss(jcfg)
    assert {f: getattr(port, f) for f in port.__dataclass_fields__} == {
        f: getattr(jloss, f) for f in port.__dataclass_fields__}
    labels = _labels(seed=2)
    keys = ("seg",) + _PLAIN[loss_type]
    arrays = [_logits((B, H, W, C), seed=1)] + [
        _logits((B, H // 2, W // 2, C), seed=10 + i) for i in range(len(keys) - 1)]

    def jfn(*xs):
        return jloss(jax.random.key(0), dict(zip(keys, xs)), jnp.asarray(labels))[0]

    def tfn(*xs):
        return port(dict(zip(keys, xs)), torch.from_numpy(labels))[0]

    _check(_torch_value_and_grads(tfn, *arrays), _jax_value_and_grads(jfn, *arrays))


def _draws(key, n):
    """The uniform scores hard_anchor_sample draws from ``key`` in the JAX
    package (ops/contrast.py:101-103)."""
    khard, keasy = jax.random.split(key)
    return AnchorScores(*(torch.from_numpy(np.array(jax.random.uniform(k, (B, C, n))))
                          for k in (khard, keasy)))


_SPEC = dict(num_classes=C, max_samples=64, max_views=6, temperature=0.1,
             base_temperature=0.07)


@pytest.mark.parametrize("ignore", [0.0, 0.2])
def test_self_contrast_contrastive_loss(ignore):
    """The anchors against each other, diagonal masked out; value and
    gradient with respect to the embeddings."""
    embed = _embed().reshape(B, -1, D)
    lab = _labels(seed=6, ignore=ignore)[:, ::2, ::2].reshape(B, -1)
    pred = _rng(7).integers(0, C, lab.shape).astype(np.int32)
    key = jax.random.key(3)
    jspec = jcontrast.ContrastSpec(**_SPEC, exact_sampling=True)
    spec = tcontrast.ContrastSpec(**_SPEC)

    def jfn(e):
        a = jcontrast.hard_anchor_sample(key, e, jnp.asarray(lab), jnp.asarray(pred), jspec)
        return jcontrast.contrastive_loss(a, jspec)

    def tfn(e):
        a = tcontrast.hard_anchor_sample(e, torch.from_numpy(lab), torch.from_numpy(pred),
                                         spec, scores=_draws(key, lab.shape[1]))
        assert int(a.valid.sum()) > 0
        return tcontrast.contrastive_loss(a, spec)

    _check(_torch_value_and_grads(tfn, embed), _jax_value_and_grads(jfn, embed))


def test_pixel_contrast_loss_with_pools_filled_and_not():
    """Labels at full size, embeddings at stride 2; max_views 6 with some
    (image, class) pools larger than 6 and some smaller, so some classes
    qualify and some do not, and the hard/easy split takes both keep rules."""
    embed, labels = _embed(), _labels(seed=8)
    lab_s = labels[:, ::2, ::2].reshape(B, -1)
    counts = np.stack([(lab_s == c).sum(-1) for c in range(C)], -1)
    assert (counts > 6).any() and ((counts > 0) & (counts <= 6)).any()
    pred = _rng(9).integers(0, C, (B, H // 2, W // 2)).astype(np.int32)
    key = jax.random.key(4)
    jspec = jcontrast.ContrastSpec(**_SPEC, exact_sampling=True)
    spec = tcontrast.ContrastSpec(**_SPEC)
    want = _jax_value_and_grads(
        lambda e: jcontrast.pixel_contrast_loss(key, e, jnp.asarray(labels),
                                                jnp.asarray(pred), jspec), embed)
    got = _torch_value_and_grads(
        lambda e: tcontrast.pixel_contrast_loss(
            e, torch.from_numpy(labels), torch.from_numpy(pred), spec,
            scores=_draws(key, lab_s.shape[1])), embed)
    assert got[0] > 0
    _check(got, want)


@pytest.mark.parametrize("loss_type", ["contrast_ce_loss", "contrast_auxce_loss"])
def test_contrast_ce_loss_without_a_bank(loss_type):
    """``ContrastCELoss`` with no bank, both seg routes (the streamed
    upsampled CE; with aux, CE of the upsampled seg and aux logits), built
    by both packages; value and gradients with respect to seg, embed (and
    seg_aux)."""
    jcfg, cfg = _config("cityscapes_hrnet_w48_contrast", loss_type,
                        **{"contrast.loss_weight": 0.5})
    port, jloss = build_loss(cfg), jbuild_loss(jcfg)
    assert isinstance(port, ContrastCELoss) and port.use_aux == jloss.use_aux
    assert port.spec._asdict() == {f: getattr(jloss.spec, f) for f in port.spec._fields}
    labels = _labels(seed=8)
    keys = ("seg", "embed") + (("seg_aux",) if port.use_aux else ())
    arrays = [_logits((B, H // 2, W // 2, C), seed=1), _embed()] + (
        [_logits((B, H // 2, W // 2, C), seed=12)] if port.use_aux else [])
    key = jax.random.key(5)
    scores = _draws(key, (H // 2) * (W // 2))
    metrics = {}

    def tfn(*xs):
        total, metrics["port"] = port(dict(zip(keys, xs)), torch.from_numpy(labels),
                                      True, None, scores=scores)
        return total

    *want, jmetrics = _jax_value_and_grads(
        lambda *xs: jloss(key, dict(zip(keys, xs)), jnp.asarray(labels), True, None),
        *arrays, has_aux=True)
    _check(_torch_value_and_grads(tfn, *arrays), want)
    for k in ("loss_seg", "loss_contrast"):
        np.testing.assert_allclose(float(metrics["port"][k].detach()), float(jmetrics[k]),
                                   rtol=RTOL, err_msg=k)
    assert float(metrics["port"]["loss_contrast"].detach()) > 0


@pytest.mark.parametrize("loss_type", ["ms_fs_aux_rmi_loss"])
def test_build_loss_refuses_the_losses_not_ported(loss_type):
    """No loss of the JAX registry is refused any more: the last one,
    ``ms_fs_aux_rmi_loss``, builds (its values are held against JAX in
    ``tests/test_torch_port_ms_ocr.py``); an unknown name still raises."""
    _, cfg = _config("cityscapes_hrnet_w48", loss_type)
    assert type(build_loss(cfg)).__name__ == "MsAuxRMILoss"
    with pytest.raises(KeyError, match=loss_type):
        build_loss(cfg.updated("loss.loss_type", "no_such_loss"))


_RMI_LOVASZ = {  # loss_type -> the extra outputs it reads
    "rmi_loss": (), "fs_rmi_loss": (), "fs_aux_rmi_loss": ("seg_aux",), "fs_ce_lovasz_loss": (),
}


@pytest.mark.parametrize("loss_type", list(_RMI_LOVASZ))
def test_rmi_and_lovasz_losses_match_jax(loss_type):
    """The RMI losses (``_rmi_params`` off their defaults: max pool, lambda
    way 0) and CE + Lovasz, built by both packages from one config; the seg
    logits at stride 2 (upsampled by the loss), the aux head too; value and
    gradients."""
    jcfg, cfg = _config("pascal_context_hrnet_w48_ocr_rmi", loss_type, **{
        "network.loss_weights": {"aux_loss": 0.3, "seg_loss": 0.9},
        "loss.params.loss_weight_lambda": 0.7, "loss.params.lambda_way": 0,
        "loss.params.loss_weight": 1.5})
    port, jloss = build_loss(cfg), jbuild_loss(jcfg)
    if loss_type != "fs_ce_lovasz_loss":
        assert port.rmi_params == jloss.params
        assert port.rmi_params["weight_lambda"] == 0.7 and port.use_aux == jloss.use_aux
    labels = _labels(seed=3)
    keys = ("seg",) + _RMI_LOVASZ[loss_type]
    arrays = [_logits((B, H // 2, W // 2, C), seed=14 + i) for i in range(len(keys))]
    want = _jax_value_and_grads(
        lambda *xs: jloss(jax.random.key(0), dict(zip(keys, xs)), jnp.asarray(labels))[0],
        *arrays)
    got = _torch_value_and_grads(
        lambda *xs: port(dict(zip(keys, xs)), torch.from_numpy(labels))[0], *arrays)
    assert got[0] > 0
    _check(got, want)


@pytest.mark.parametrize("key", ["contrast.use_rmi", "contrast.use_lovasz"])
def test_contrast_seg_kinds_match_jax(key):
    """``ContrastCELoss`` whose seg term is RMI (``contrast_auxce_loss``:
    with the aux CE) or CE + Lovasz (``contrast_ce_loss``), no bank, built by
    both packages; value and gradients with respect to seg, embed (and
    seg_aux), and the two terms."""
    loss_type = "contrast_auxce_loss" if key == "contrast.use_rmi" else "contrast_ce_loss"
    jcfg, cfg = _config("cityscapes_hrnet_w48_contrast", loss_type,
                        **{"contrast.loss_weight": 0.5, key: True})
    port, jloss = build_loss(cfg), jbuild_loss(jcfg)
    assert port.seg_loss_kind == jloss.seg_loss_kind == key.split("_")[-1]
    assert port.rmi_params == jloss.rmi_params
    labels = _labels(seed=8)
    keys = ("seg", "embed") + (("seg_aux",) if port.use_aux else ())
    arrays = [_logits((B, H // 2, W // 2, C), seed=1), _embed()] + (
        [_logits((B, H // 2, W // 2, C), seed=12)] if port.use_aux else [])
    jkey = jax.random.key(5)
    scores = _draws(jkey, (H // 2) * (W // 2))
    metrics = {}

    def tfn(*xs):
        total, metrics["port"] = port(dict(zip(keys, xs)), torch.from_numpy(labels),
                                      True, None, scores=scores)
        return total

    *want, jmetrics = _jax_value_and_grads(
        lambda *xs: jloss(jkey, dict(zip(keys, xs)), jnp.asarray(labels), True, None),
        *arrays, has_aux=True)
    _check(_torch_value_and_grads(tfn, *arrays), want)
    for k in ("loss_seg", "loss_contrast"):
        np.testing.assert_allclose(float(metrics["port"][k].detach()), float(jmetrics[k]),
                                   rtol=RTOL, err_msg=k)


def test_mem_losses_share_the_contrast_callables():
    for mem, plain in (("mem_contrast_ce_loss", "contrast_ce_loss"),
                       ("mem_contrast_auxce_loss", "contrast_auxce_loss")):
        _, a = _config("cityscapes_hrnet_w48_mem", mem)
        _, b = _config("cityscapes_hrnet_w48_mem", plain)
        assert build_loss(a) == build_loss(b)
