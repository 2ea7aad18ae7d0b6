"""HRNetSeg of the port against the JAX package's, on the same weights.

hrnet18, 5 classes, batch 2 of 64x64 images, weights from a numpy seed
loaded through ``load_jax_variables``.  The JAX side runs eagerly
(``jax.disable_jit``) so no HRNet compile enters the test.

Tolerance: atol 1e-3, rtol 1e-3 on ``seg``, ``embed`` and BN statistics:
fp32 sums in another order through ~100 convs.  The BN running variance is
compared as it is: the port updates it with the biased batch variance, as
flax does (``tests/test_torch_port_layers.py`` holds one BN at atol 1e-6).

These checks hold the JAX model to exact fp32 (``exact_fp32_reference``).
One more check runs the JAX model as its presets do, with the bf16 fuse
upsamples, and bounds how far the port's fp32 fuse is from it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.models.nets import HRNetSeg as JHRNetSeg
from contrastiveseg_tpu.utils.torch_import import convert_state_dict
from contrastiveseg_tpu_torch.models.nets import MODELS, HRNetSeg, build_model
from contrastiveseg_tpu_torch.utils.jax_weights import (
    flatten,
    hrnet_seg_key,
    load_jax_variables,
)

from torch_port_helpers import (
    bn_counts,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
)

SHAPE = (2, 64, 64, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    """Tolerances here (1e-3) are far above any summation-order effect."""
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _shared_compiles():
    with shared_jax_compiles():
        yield


@pytest.fixture(scope="module")
def weights():
    jm = JHRNetSeg(num_classes=5, arch="hrnet18", with_proj=True, head_dropout=0.0)
    return jm, random_variables(jm, (1,) + SHAPE[1:], seed=1)


def _port(variables):
    pm = HRNetSeg(5, "hrnet18", head_dropout=0.0)
    load_jax_variables(pm, variables)
    return pm


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def _calibrated(variables, x):
    """``variables`` with BN running statistics set to the batch statistics
    of ``x``, so the eval forward is as well conditioned as a trained net's
    (random running statistics blow the logits up to ~1e3, where fp32
    cancellation alone exceeds the tolerance)."""
    pm = _port(variables)
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        pm.train()(torch.from_numpy(x))
    sd = pm.state_dict()

    def fill(tree, prefix=()):
        return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                else sd[hrnet_seg_key(prefix + (k,))].numpy() for k, v in tree.items()}

    return {"params": variables["params"],
            "batch_stats": fill(variables["batch_stats"])}


@pytest.fixture(scope="module")
def calibrated(weights):
    """The eval tests' images and calibrated weights, made once."""
    x = _images()
    with one_torch_thread():
        return x, _calibrated(weights[1], x)


def test_eval_forward_matches_jax(weights, calibrated, monkeypatch):
    exact_fp32_reference(monkeypatch)
    jm, _ = weights
    x, variables = calibrated
    with jax.disable_jit():
        want = jm.apply(variables, jnp.asarray(x), train=False)
    pm = _port(variables).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got["seg"].shape == (2, 16, 16, 5) and got["embed"].shape == (2, 16, 16, 256)
    for k in ("seg", "embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)


def test_eval_forward_against_the_bf16_fuse_of_jax(weights, calibrated):
    """The JAX model as it runs, unpatched: its fuse upsamples round the
    interpolation matrix and the intermediate to bf16 (ops/resize.py:77),
    the port's stay fp32.  Measured on these inputs: relative norm error
    8.6e-3 (seg) and 9.5e-3 (embed), max abs error 1.0% (seg) and 1.3%
    (embed) of the output's largest magnitude.  Bounds: about twice that."""
    jm, _ = weights
    x, variables = calibrated
    with jax.disable_jit():
        want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(variables).eval()(torch.from_numpy(x))
    for k in ("seg", "embed"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2, k
        assert np.abs(g - w).max() < 2.5e-2 * np.abs(w).max(), k


def test_train_forward_and_bn_stats_match_jax(weights, monkeypatch):
    exact_fp32_reference(monkeypatch)
    jm, variables = weights
    x = _images(1)
    with jax.disable_jit():
        want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(0)})
    pm = _port(variables)
    counts = bn_counts(pm.eval(), torch.from_numpy(x))
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for k in ("seg", "embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)

    sd = pm.state_dict()
    checked = 0
    for path, new in flatten(mut["batch_stats"]).items():
        key = hrnet_seg_key(path)
        np.testing.assert_allclose(sd[key].numpy(), new, atol=1e-3, rtol=1e-3,
                                   err_msg=key)
        checked += 1
    assert checked == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())
    assert min(counts.values()) == 8  # the deepest branch: 2 images x 2 x 2


def test_state_dict_names_match_the_torch_import_mapper(weights):
    """The port is named after the upstream torch state_dict: the JAX
    package's own importer (hrnet_mem mapper = encoder_q. + hrnet_seg) maps
    every port tensor onto every JAX leaf, and round-trips the weights."""
    _, variables = weights
    pm = _port(variables)
    torch_sd = {f"encoder_q.{k}": v.numpy() for k, v in pm.state_dict().items()}
    back, report = convert_state_dict(variables, torch_sd, "hrnet_mem")
    assert report["missing"] == [] and report["unused"] == []
    want, got = flatten(variables), flatten(back)
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))


def test_load_jax_variables_rejects_missing_and_unused(weights):
    _, variables = weights
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros(1)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="stray"):
        _port(extra)
    params = dict(variables["params"])
    params.pop("proj_head")
    with pytest.raises(ValueError, match="proj_head"):
        _port({"params": params, "batch_stats": variables["batch_stats"]})


def test_build_model_knows_only_the_ported_names(monkeypatch):
    from contrastiveseg_tpu_torch.models import hrnet, resnet, vit
    from contrastiveseg_tpu_torch.models.layers import PallasConv3x3
    from contrastiveseg_tpu_torch.presets import get_preset

    cfg = get_preset("cityscapes_hrnet_w48_mem")
    model = build_model(cfg)
    assert sum(model.backbone.stage4[0].branches[i][0].conv1.out_channels
               for i in range(4)) == 720
    with pytest.raises(NotImplementedError, match="ROADMAP 7"):
        build_model(cfg.updated("network.model_name", "hrnet_w48_ocr_b_ha"))
    with pytest.raises(KeyError, match="hrnet_w48_mem"):
        build_model(cfg.updated("network.model_name", "no_such_net"))
    # network.bf16 is ported on every net of the registry (built on the meta
    # device, with one-block trunks: no weights, little time), and with K2
    # (its bf16 kernels) on the HRNetSeg nets; the unported
    # deeplab_v3_mobilenet still refuses any build.
    bf16 = cfg.updated("network.bf16", True)
    assert build_model(bf16).bf16
    with monkeypatch.context() as mp, torch.device("meta"):
        for w in (18, 32, 48, 64):
            mp.setitem(hrnet.HRNET_SPECS, f"hrnet{w}", hrnet.HRNetSpec(
                64, 1, 64, hrnet.StageSpec(1, 1, (w, 2 * w)),
                hrnet.StageSpec(1, 1, (w, 2 * w, 4 * w)),
                hrnet.StageSpec(1, 1, (w, 2 * w, 4 * w, 8 * w))))
        mp.setitem(resnet.RESNET_SPECS, "deepbase_resnet101_dilated8",
                   resnet.ResNetSpec((1, 1, 1, 1), dilate_scale=8))
        mp.setitem(vit.VIT_SPECS, "vit_base", vit.ViTSpec(depth=4))
        for name in MODELS:
            c = bf16.updated("network.model_name", name)
            if not name.startswith(("hrnet", "segfix", "setr", "semantic", "ms_ocr")):
                c = c.updated("network.backbone", "deepbase_resnet101_dilated8")
            assert build_model(c).bf16, name
    with torch.device("meta"):
        both = build_model(bf16.updated("network.pallas_conv", True))
    assert both.bf16 and sum(isinstance(m, PallasConv3x3) for m in both.modules()) == 208
    with pytest.raises(NotImplementedError, match="ROADMAP 7"):
        build_model(bf16.updated("network.model_name", "deeplab_v3_mobilenet"))
    # network.pallas_conv is ported: the branch BasicBlocks' 3x3 convs become
    # PallasConv3x3 (2 per block: 16 + 96 + 96 over the three stages), under
    # the same state_dict names, so weights carry over unchanged.
    flagged = build_model(cfg.updated("network.pallas_conv", True))
    assert sum(isinstance(m, PallasConv3x3) for m in flagged.modules()) == 208
    assert not any(isinstance(m, PallasConv3x3) for m in model.modules())
    assert {k: v.shape for k, v in flagged.state_dict().items()} == {
        k: v.shape for k, v in model.state_dict().items()}
