"""MscaleOCR (``ms_ocr``) and its ``ms_fs_aux_rmi_loss`` of the port against
the JAX package.

On ``torch_port_helpers.shallow_hrnet18`` (W18 widths, one block a stage),
``cityscapes_hrnet_w48_ocr`` with ``network.model_name=ms_ocr``,
``loss.loss_type=ms_fs_aux_rmi_loss`` and ``loss.params.ms_scale_weight``
0.1, 19 classes with the preset's class weights, 2 images of 96x96 (the
trunk runs at 48x48 and 96x96); weights from a numpy seed carried by
``load_jax_variables``; the OCR dropout off on both sides.  The JAX side
runs jitted under ``exact_fp32_reference`` (exact fuse upsamples and BN
variance), most of XLA's optimizations off.

Tolerances: the train outputs (all seven keys) and the BN statistics after
one port train step within atol 1e-4 + rtol 1e-4 (read: at most 6.8e-5
apart, inside the bound); ``loss`` and ``loss_seg`` within rtol 1e-5 (read:
7.6e-6 on 3.9); each parameter gradient within 3e-2 of its tensor's largest
value, or of a thousandth of the largest gradient of the net for the
biases that feed a BN, whose exact gradient is 0 (read: 8.0e-3;
``GRAD_RTOL``).
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.nets as jnets
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import MscaleOCR, build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, key_for, load_jax_variables, to_port
from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained

from torch_port_helpers import (
    assert_scaled_close,
    exact_fp32_reference,
    no_dropout,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W = 2, 96, 96
TOL = dict(atol=1e-4, rtol=1e-4)
# A train-mode gradient of a random-init HRNet-OCR: the JAX package's fp32
# gradient itself is up to 6.1e-3 of a tensor's largest value from the port
# run in float64 (the OCR head's and scale_attn's BN backward).
GRAD_RTOL = 3e-2
KEYS = {"seg", "pred", "aux", "seg_aux", "pred_05x", "pred_10x", "attn_05x"}


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    exact_fp32_reference(mp, compiled_blocks=False)
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _cfg(get=get_preset):
    cfg = get("cityscapes_hrnet_w48_ocr")
    for k, v in {"network.model_name": "ms_ocr", "network.backbone": "hrnet18",
                 "loss.loss_type": "ms_fs_aux_rmi_loss",
                 "loss.params.ms_scale_weight": 0.1}.items():
        cfg = cfg.updated(k, v)
    return cfg


@pytest.fixture(scope="module")
def variables():
    return random_variables(jbuild_model(_cfg(jget_preset)), (1, H, W, 3), seed=9)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    labels = rng.integers(-1, 19, (B, H, W)).astype(np.int32)
    return x, labels


def test_ms_ocr_matches_jax(variables):
    """Eval outputs; one port train step (``make_train_step``) against the
    JAX forward, loss and gradient: the train outputs, ``loss`` and
    ``loss_seg``, every parameter's gradient, and the BN statistics, which
    the shared trunk moves twice a step (each BN runs at 0.5x, then 1.0x)."""
    jcfg, cfg = _cfg(jget_preset), _cfg()
    jm, jloss, v = jbuild_model(jcfg), jbuild_loss(jcfg), variables
    x, labels = _batch()

    @jax.jit
    def jrun(v, x, labels):
        def loss(params):
            out, new = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            total, metrics = jloss(jax.random.key(0), out, labels)
            return total, (out, new["batch_stats"], metrics)

        (_, (out, stats, metrics)), grads = jax.value_and_grad(loss, has_aux=True)(
            v["params"])
        return out, stats, metrics, grads

    jout, jstats, jmetrics, jgrads = jax.tree.map(
        np.asarray, jrun(v, jnp.asarray(x), jnp.asarray(labels)))
    assert set(jout) == KEYS
    state = create_train_state(cfg, no_dropout(build_model(cfg)), "cpu")
    pm = state.model
    assert isinstance(pm, MscaleOCR)
    load_jax_variables(pm, v)
    outs, calls = {}, {}
    hooks = [pm.register_forward_hook(lambda m, i, o: outs.update(o))] + [
        m.register_forward_hook(lambda m, i, o, n=n: calls.__setitem__(n, calls.get(n, 0) + 1))
        for n, m in pm.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    metrics = make_train_step(build_loss(cfg))(
        state, {"image": torch.from_numpy(x), "label": torch.from_numpy(labels).long()})
    for h in hooks:
        h.remove()
    assert set(calls.values()) == {2} and len(calls) == len(flatten(jstats)) // 2
    for k in KEYS:
        np.testing.assert_allclose(outs[k].detach().numpy(), jout[k], **TOL, err_msg=k)
    assert outs["pred_05x"].shape == (B, H // 2, W // 2, 19)
    for k in ("loss", "loss_seg"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert float(metrics["loss"]) > float(metrics["loss_seg"])
    key = key_for(pm)
    want, unmapped = to_port(jgrads, key)
    assert not unmapped
    got = dict(pm.named_parameters())
    assert got.keys() == want.keys()
    floor = 1e-3 * max(np.abs(a).max() for a in want.values())
    for k, arr in want.items():
        assert_scaled_close(got[k].grad.numpy(), arr, GRAD_RTOL, k, floor)
    stats, _ = to_port({"batch_stats": jstats}, key)
    sd = pm.state_dict()
    for k, arr in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), arr, **TOL, err_msg=k)


def test_ms_ocr_pth_round_trips_through_the_jax_importer(variables, tmp_path):
    """The port's ``state_dict`` is the reference MscaleOCR ``.pth``
    (``backbone``, ``ocr.*``, ``scale_attn.*``; a bias on every conv that
    feeds a BN, folded on load): it loads strictly through
    ``network.pretrained``; the JAX importer's ``ms_ocr`` mapper maps it
    back onto the numpy variables, each folded mean less its bias, nothing
    missing or left over."""
    v = variables
    pm = build_model(_cfg())
    load_jax_variables(pm, v)
    file = dict(pm.state_dict())
    mapper = ti.PATH_MAPPERS[ti.mapper_for_model("ms_ocr")]
    zeros = jax.tree.map(np.zeros_like, v)
    folds = {path: tk.fold_bias_key for path in flatten(zeros["batch_stats"])
             if (tk := mapper(path)) is not None and tk.fold_bias_key}
    assert {"scale_attn.conv0.bias", "ocr.conv3x3_ocr.0.bias"} <= set(folds.values())
    for i, bias in enumerate(sorted(set(folds.values()))):
        n = file[bias.removesuffix(".bias") + ".weight"].shape[0]
        file[bias] = torch.linspace(-1, 1, n) * (i + 1) / len(folds)
    torch.save({"state_dict": {f"module.{k}": t for k, t in file.items()}}, tmp_path / "m.pth")
    fresh = build_model(_cfg())
    assert load_pretrained(fresh, str(tmp_path / "m.pth")) is None
    jvars, report = ti.convert_state_dict(zeros, {k: t.numpy() for k, t in file.items()},
                                          mapper)
    assert report["missing"] == [] and report["unused"] == []
    got, key = fresh.state_dict(), key_for(fresh)
    for col in ("params", "batch_stats"):
        out, want = flatten(jvars[col]), flatten(v[col])
        assert out.keys() == want.keys()
        for path, arr in out.items():
            expect = want[path] - file[folds[path]].numpy() if path in folds else want[path]
            assert np.array_equal(arr, expect), path
            port = arr if arr.ndim != 4 else np.transpose(arr, (3, 2, 0, 1))
            assert np.array_equal(got[key(path)].numpy(), port), path


def test_full_width_ms_ocr_builds_with_the_jax_parameter_count():
    """``ms_ocr`` on the full HRNet-W48 (``network.backbone=hrnet48``): the
    port's parameters (meta device) and BN statistics number the JAX
    init's (``jax.eval_shape``)."""
    jcfg, cfg = (c.updated("network.backbone", "hrnet48") for c in (_cfg(jget_preset), _cfg()))
    jm = jbuild_model(jcfg)
    assert isinstance(jm, jnets.MscaleOCR) and jm.arch == "hrnet48"
    # MscaleOCR's variables are its one trunk's, under "ocr": trace the trunk once.
    shapes = jax.eval_shape(lambda: jnets._MsOCRTrunk(19, "hrnet48").init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), train=False))
    count = {c: sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes[c])) for c in shapes}
    with torch.device("meta"):
        pm = build_model(cfg)
    assert sum(p.numel() for p in pm.parameters()) == count["params"]
    assert sum(b.numel() for n, b in pm.named_buffers()
               if not n.endswith("num_batches_tracked")) == count["batch_stats"]
