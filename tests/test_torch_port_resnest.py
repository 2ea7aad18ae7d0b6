"""ResNeSt (``radix``) in the port against the JAX package.

* ``SplitAttentionConv`` alone (radix 2, 16 features from 8 channels, at
  strides 1 and 2, dilation 2): train-mode output, both BatchNorms'
  statistics (the conv's, and the attention MLP's ``fc_bn`` over the batch)
  and the gradients of every parameter and of the input; the eval-mode
  output.
* ``cityscapes_resnest_fcn`` on a shallow ResNeSt put into both packages'
  ``RESNET_SPECS`` for this file (the deep-base stem, layers (1, 1, 2, 2),
  dilated 8, radix 2, at the full widths: c4 has 2048 channels): the
  ``seg`` and ``seg_aux`` logits, the BN statistics and every parameter's
  gradient of the preset's ``fs_auxce_loss``, then the eval forward.  The
  FCN heads' dropout is off on both sides (flax's ``Dropout`` patched to
  the identity, the port's ``p = 0``).  2 images of 64x64.
* Full width without compute: every leaf of the JAX init of the preset's
  net (``deepbase_resnest101_dilated8``) maps one to one, shape for shape,
  onto the port's ``state_dict`` built on the meta device.

The JAX side runs jitted under ``exact_fp32_reference`` (exact BN
variance), with most of XLA's optimizations off; torch runs on one thread.
Weights from a numpy seed, loaded through ``load_jax_variables``.
Tolerances: the split-attention outputs, BN statistics and input gradient
atol/rtol 1e-4, each parameter gradient within 1e-3 in relative norm plus
1e-5 of the whole gradient's norm (``fc1``'s bias feeds a train-mode BN, so
its gradient is 0 up to rounding) (read: 6.4e-5 in the input gradient,
4.5e-5 in relative norm, ``fc1``'s bias 1.0e-3 against a whole-gradient
norm of 2.5e2); the FCN's outputs and BN statistics 1e-3
and the loss 1e-5 relative, each gradient within 5e-2 of the JAX gradient
in relative norm (plus 1e-6 of the whole gradient's norm) and all together
within 2e-2, as in ``tests/test_torch_port_deeplab.py`` (read: 4.4e-4 in
the outputs, 3.3e-6 in the loss, 2.0e-2 a tensor, 9.1e-3 overall: the BN
backward of a random-init deep ResNet cancels digits, ``PERF.md`` §6).
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.models.resnet import SplitAttentionConv as JSplitAttentionConv
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import FcnNet, build_model
from contrastiveseg_tpu_torch.models.resnet import SplitAttentionConv, VariantBottleneck
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, key_for, load_jax_variables

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W, C = 2, 64, 64, 19
SHALLOW = "deepbase_resnest_shallow_dilated8"


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _shallow_exact():
    import contrastiveseg_tpu.models.resnet as jresnet

    from contrastiveseg_tpu_torch.models import resnet

    mp = pytest.MonkeyPatch()
    for mod in (jresnet, resnet):
        mp.setitem(mod.RESNET_SPECS, SHALLOW,
                   mod.ResNetSpec((1, 1, 2, 2), dilate_scale=8, radix=2))
    exact_fp32_reference(mp, compiled_blocks=False)
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _as_port(arr):
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    return arr.T if arr.ndim == 2 else arr


def _split_attention_key(path: tuple) -> str:
    leaf = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}
    if path[0] == "conv":
        return "conv.weight"
    if path[0] == "norm":
        return f"bn.{leaf[path[2]]}"
    return f"{path[0]}.{leaf[path[1]]}"


@pytest.mark.parametrize("stride", [1, 2])
def test_split_attention_conv_matches_jax(stride):
    jm = JSplitAttentionConv(16, radix=2, strides=stride, dilation=2)
    v = random_variables(jm, (B, 9, 9, 8), seed=stride)
    x = np.random.default_rng(stride).standard_normal((B, 9, 9, 8)).astype(np.float32)
    weight = np.random.default_rng(9).standard_normal((B, (9 - 1) // stride + 1,
                                                       (9 - 1) // stride + 1, 16))

    @jax.jit
    def run(params, x):
        def f(p, x):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True,
                                mutable=["batch_stats"])
            return jnp.sum(out * weight), (out, new["batch_stats"])

        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)

    (_, (jout, jstats)), (jgp, jgx) = run(v["params"], jnp.asarray(x))
    pm = SplitAttentionConv(8, 16, 2, stride=stride, dilation=2)
    load_jax_variables(pm, v, key_of=_split_attention_key)
    xt = torch.tensor(x, requires_grad=True)
    out = pm.train()(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    (out * torch.from_numpy(weight).float()).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    sd = pm.state_dict()
    for path, new in flatten(jax.tree.map(np.asarray, jstats)).items():
        np.testing.assert_allclose(sd[_split_attention_key(path)].numpy(), new, atol=1e-4,
                                   rtol=1e-4, err_msg=str(path))
    grads = dict(pm.named_parameters())
    want = {path: _as_port(g) for path, g in flatten(jax.tree.map(np.asarray, jgp)).items()}
    total = np.sqrt(sum(np.sum(g ** 2) for g in want.values()))
    for path, g in want.items():
        got = grads[_split_attention_key(path)].grad.numpy()
        assert np.linalg.norm(got - g) <= 1e-3 * np.linalg.norm(g) + 1e-5 * total, path
    want = jm.apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        got = SplitAttentionConv(8, 16, 2, stride=stride, dilation=2)
        load_jax_variables(got, v, key_of=_split_attention_key)
        got = got.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _cfg(get=get_preset, backbone=SHALLOW):
    return get("cityscapes_resnest_fcn").updated("network.backbone", backbone)


def test_resnest_fcn_forward_bn_stats_and_grads_match_jax():
    jm = jbuild_model(_cfg(jget_preset))
    v = random_variables(jm, (1, H, W, 3), seed=3)
    x = np.random.default_rng(0).standard_normal((B, H, W, 3)).astype(np.float32)
    lab = np.random.default_rng(1).integers(-1, C, (B, H, W))
    jloss = jbuild_loss(_cfg(jget_preset))

    @jax.jit
    def run(params):
        def f(p):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.key(0)})
            loss, _ = jloss(jax.random.key(0), out, jnp.asarray(lab, jnp.int32))
            return loss, (out, new["batch_stats"])

        return jax.value_and_grad(f, has_aux=True)(params)

    (jl, (jout, jstats)), jgrads = run(v["params"])
    pm = build_model(_cfg())
    for m in pm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    load_jax_variables(pm, v)
    assert isinstance(pm, FcnNet) and pm.backbone.radix == 2
    assert isinstance(pm.backbone.layer4[1], VariantBottleneck)
    out = pm.train()(torch.from_numpy(x))
    assert set(out) == set(jout) == {"seg", "seg_aux"}
    for k in out:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), atol=1e-3,
                                   rtol=1e-3, err_msg=k)
    loss, _ = build_loss(_cfg())(out, torch.from_numpy(lab))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    loss.backward()

    key = key_for(pm)
    sd = pm.state_dict()
    stats = flatten(jax.tree.map(np.asarray, jstats))
    for path, new in stats.items():
        np.testing.assert_allclose(sd[key(path)].numpy(), new, atol=1e-3, rtol=1e-3,
                                   err_msg=key(path))
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    want = {key(p): _as_port(g) for p, g in flatten(jax.tree.map(np.asarray, jgrads)).items()}
    assert got.keys() == want.keys()
    total = np.sqrt(sum(np.sum(g ** 2) for g in want.values()))
    for k, g in want.items():
        assert np.linalg.norm(got[k] - g) <= 5e-2 * np.linalg.norm(g) + 1e-6 * total, k
    assert np.sqrt(sum(np.sum((got[k] - g) ** 2) for k, g in want.items())) <= 2e-2 * total

    want = jax.jit(lambda p, s: jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                                         train=False))(v["params"], v["batch_stats"])
    with torch.no_grad():
        pm = build_model(_cfg())
        load_jax_variables(pm, v)
        got = pm.eval()(torch.from_numpy(x))
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=f"eval {k}")


def test_full_width_resnest_fcn_leaves_match_jax():
    cfg = get_preset("cityscapes_resnest_fcn")
    assert cfg.get("network.backbone") == "deepbase_resnest101_dilated8"
    shapes = jax.eval_shape(lambda: jbuild_model(jget_preset("cityscapes_resnest_fcn")).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), train=True))
    with torch.device("meta"):
        pm = build_model(cfg)
    key = key_for(pm)
    sd = {k: tuple(t.shape) for k, t in pm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    mapped = {}
    for col in ("params", "batch_stats"):
        for path, leaf in flatten(jax.tree.map(lambda s: np.empty(s.shape, np.float32),
                                               dict(shapes[col]))).items():
            k = key(path)
            assert k in sd and k not in mapped, (col, path, k)
            mapped[k] = tuple(_as_port(leaf).shape)
    assert mapped == sd
    assert sd["backbone.layer4.2.conv2.conv.weight"] == (1024, 256, 3, 3)
    assert sd["backbone.layer4.2.conv2.fc1.weight"] == (256, 512)
    for arch in ("resnext101_dilated8", "wide_resnet101_dilated8", "resnet101_dilated8_dcn"):
        with pytest.raises(NotImplementedError, match="ROADMAP 7"):
            build_model(cfg.updated("network.backbone", arch))
