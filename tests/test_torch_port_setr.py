"""SETR (ViT encoder with the Naive, PUP and MLA decoders) of the port
against the JAX package.

A small ``ViTSpec`` (patch 4, depth 4, width 64, 4 heads, hidden 128, taps
after every layer) on 2 images of 16x24, a 4x6 patch grid, 5 classes;
weights from a numpy seed (``random_variables``), carried by
``load_jax_variables``; dropout off on both sides (flax's ``Dropout``
patched to the identity, the port's ``p = 0``).  The JAX side runs jitted
with most of XLA's optimizations off.

Tolerances (fp32 both sides): outputs, the input gradient, the parameter
gradients and the BN statistics within atol 1e-4 + rtol 1e-4 (read: at
most 4.0e-4 apart, on MLA's parameter gradients, each element inside its
bound; the ViT adapter's taps 2.3e-6).  The full-width nets
(``vit_large`` at the published 768x768 crop) are built on the meta device
and counted against ``jax.eval_shape`` of the JAX init: equal.
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.vit as jvit
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.models import vit
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import (
    backbone_key,
    key_for,
    load_jax_variables,
    to_port,
)
from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained

from torch_port_helpers import (
    no_dropout,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W, C = 2, 16, 24, 5
SPEC = dict(patch_size=4, embed_dim=64, depth=4, num_heads=4, hidden_dim=128,
            aux_layers=(1, 2, 3, 4))
DECODERS = ("naive", "pup", "mla")
TOL = dict(atol=1e-4, rtol=1e-4)


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _jax(decoder):
    return jvit.SETR(num_classes=C, decoder=decoder, spec=jvit.ViTSpec(**SPEC))


def _port(decoder, v):
    pm = vit.SETR(C, decoder=decoder, spec=vit.ViTSpec(**SPEC), grid=(H // 4, W // 4))
    load_jax_variables(pm, v)
    return no_dropout(pm)


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("decoder", DECODERS)
def test_setr_matches_jax(decoder):
    """Eval outputs; then in train mode the outputs, the gradient of
    ``sum(seg * g)`` for the input and every parameter, and the BN
    statistics after the forward (Naive's ``bn1``)."""
    jm = _jax(decoder)
    v = random_variables(jm, (1, H, W, 3), seed=3)
    x = _images()
    g = np.random.default_rng(1).standard_normal((B, 16 * H // 4 if decoder != "naive" else H,
                                                  16 * W // 4 if decoder != "naive" else W, C))
    g = g.astype(np.float32)

    @jax.jit
    def jrun(v, x):
        ev = jm.apply(v, x, train=False)["seg"]

        def loss(params, x):
            out, new = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out["seg"] * g), (out["seg"], new["batch_stats"])

        (_, (seg, stats)), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            v["params"], x)
        return ev, seg, stats, grads

    jev, jseg, jstats, (jgp, jgx) = jax.tree.map(np.asarray, jrun(v, jnp.asarray(x)))
    pm = _port(decoder, v)
    with torch.no_grad():
        ev = pm.eval()(torch.from_numpy(x))["seg"]
    np.testing.assert_allclose(ev.numpy(), jev, **TOL)
    xt = torch.from_numpy(x).requires_grad_()
    seg = pm.train()(xt)["seg"]
    assert seg.shape == jseg.shape
    np.testing.assert_allclose(seg.detach().numpy(), jseg, **TOL)
    (seg * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jgx, **TOL)
    key = key_for(pm)
    want, unmapped = to_port(jgp, key)
    assert not unmapped
    # MLA never reads pre_head_ln: no gradient in the port, zeros in JAX.
    got = {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
           for k, p in pm.named_parameters()}
    assert got.keys() == want.keys()
    assert sum(p.grad is None for p in pm.parameters()) == (2 if decoder == "mla" else 0)
    for k, arr in want.items():
        np.testing.assert_allclose(got[k], arr, **TOL, err_msg=k)
    stats, _ = to_port({"batch_stats": jstats}, key)
    sd = pm.state_dict()
    assert len(stats) == (2 if decoder == "naive" else 0)
    for k, arr in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), arr, **TOL, err_msg=k)


def test_vit_features_and_the_fixed_grid():
    """``ViTFeatures`` (the backbone adapter) gives the JAX taps with the
    deepest replaced by the final output; an input off the train crop's
    grid, or not a multiple of the patch, raises in the port, as the JAX
    init or apply fails on it (a reshape of the patch grid)."""
    spec = jvit.ViTSpec(**SPEC)
    jm = jvit.ViTFeatures(spec)
    v = random_variables(jm, (1, H, W, 3), seed=4)
    x = _images(2)
    jout = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    pm = vit.ViTFeatures(vit.ViTSpec(**SPEC), (H // 4, W // 4))
    load_jax_variables(pm, v, key_of=backbone_key(pm))
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(out) == len(jout) == 4
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), **TOL)
    for hw in ((H + 4, W), (H + 2, W)):
        with pytest.raises(ValueError, match="train crop"):
            pm(torch.zeros(1, 3, *hw))
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda: _jax("pup").init(jax.random.key(0), jnp.zeros((1, H + 2, W, 3)),
                                                train=False))


def test_setr_pth_round_trips_through_the_jax_importer(tmp_path):
    """Each decoder's port ``state_dict`` is the reference's SETR ``.pth``
    (no ``backbone.`` prefix: the encoder is the net): it loads strictly
    through ``network.pretrained`` (MLA's dead ``net1_intmd`` keys in the
    file dropped), and the JAX importer's ``setr`` mapper turns it back
    into the numpy variables the port was loaded from, array for array,
    with nothing missing or left over but ``net1_intmd``."""
    for decoder in DECODERS:
        v = random_variables(_jax(decoder), (1, H, W, 3), seed=6)
        file = _port(decoder, v).state_dict()
        if decoder == "mla":
            file["net1_intmd.layer_intmd.weight"] = torch.ones(32, 32, 3, 3)
            file["net1_intmd.layer_intmd.bias"] = torch.ones(32)
        torch.save({"state_dict": {f"module.{k}": t for k, t in file.items()}},
                   tmp_path / f"{decoder}.pth")
        fresh = vit.SETR(C, decoder=decoder, spec=vit.ViTSpec(**SPEC), grid=(H // 4, W // 4))
        assert load_pretrained(fresh, str(tmp_path / f"{decoder}.pth")) is None
        got = fresh.state_dict()
        assert all(torch.equal(got[k], file[k]) for k in got)
        zeros = jax.tree.map(np.zeros_like, v)
        jvars, report = ti.convert_state_dict(zeros, {k: t.numpy() for k, t in file.items()},
                                              ti.mapper_for_model(f"setr_{decoder}"))
        assert report["missing"] == []
        assert report["unused"] == (["net1_intmd.layer_intmd.weight",
                                     "net1_intmd.layer_intmd.bias"] if decoder == "mla" else [])
        for col in v:
            for (path, a), (_, b) in zip(_leaves(jvars[col]), _leaves(v[col])):
                assert np.array_equal(a, b), path


def _leaves(tree):
    return sorted(jax.tree_util.tree_leaves_with_path(tree), key=lambda t: str(t[0]))


def test_full_width_setr_builds_with_the_jax_parameter_count():
    """``setr_naive``, ``setr_pup`` and ``setr_mla`` on ``vit_large`` (24
    layers, width 1024, 16 heads, patch 16) at the published Cityscapes crop
    of 768x768 (a 48x48 grid): the port's parameters, built on the meta
    device, number what ``jax.eval_shape`` of the JAX init gives (304-329
    M); the position table is sized by ``input_size`` [W, H]."""
    for name in ("setr_naive", "setr_pup", "setr_mla"):
        over = {"network.model_name": name, "network.backbone": "vit_large",
                "train.data_transformer.input_size": [768, 768]}
        jcfg, cfg = jget_preset("cityscapes_hrnet_w48"), get_preset("cityscapes_hrnet_w48")
        for k, val in over.items():
            jcfg, cfg = jcfg.updated(k, val), cfg.updated(k, val)
        shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 768, 768, 3)), train=False))
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
        with torch.device("meta"):
            pm = build_model(cfg)
        assert sum(p.numel() for p in pm.parameters()) == want, name
        assert pm.position_encoding.pe.weight.shape == (48 * 48, 1024)
    with torch.device("meta"):
        wide = build_model(cfg.updated("train.data_transformer.input_size", [1024, 512]))
    assert wide.grid == (32, 64)
