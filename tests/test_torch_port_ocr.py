"""HRNet + OCR of the port against the JAX package.

``hrnet_w18_ocr``, ``hrnet_w18_ocr_contrast`` and ``hrnet_w18_ocr_b`` on a
shallow hrnet18: the W18 widths (18, 36, 72, 144; the OCR heads on their
270 fused channels), one module of one block a stage, put into both
packages' ``HRNET_SPECS["hrnet18"]`` for this file, since a whole hrnet18
takes the JAX package ~90 s to compile on the CPU.  19 classes, 2 images of
64x64, weights from a numpy seed loaded through ``load_jax_variables``.
The train step uses the same weights.  The JAX side runs jitted under
``exact_fp32_reference`` (exact BN variance and fuse upsamples), compiled
with most of XLA's optimizations off (``unoptimized_jax_compiles``); torch
runs on one thread.  The OCR dropout (0.05, fixed in both packages) is off
on both sides: flax's ``Dropout`` is patched to the identity for this file,
and the port's ``nn.Dropout`` gets ``p = 0``.

Tolerances, as in ``tests/test_torch_port_deeplab.py``: outputs and BN
statistics atol/rtol 1e-3; gradients each within 5e-2 of the JAX gradient in
relative norm (plus 1e-6 of the whole gradient's norm) and all together
within 2e-2.  Read against an fp64 run of the port: the port's fp32
gradients are off by up to 4.4e-3 (a stage-4 fuse conv) and 2.6e-3 overall,
the JAX package's by up to 2.1e-3; the two fp32 runs differ by up to 3.6e-3
a tensor and 2.1e-3 overall (OCR-B: 2.1e-3 and 1.0e-3); the train step
of ``cityscapes_hrnet_w48_ocr_contrast`` (cut to this hrnet18, 19 classes,
``max_views`` 12, contrast live from step 0, the same anchor draws) holds
the losses at rtol 1e-4 and the post-step parameters at atol 5e-4.  Full
width without compute: the leaves of the JAX init of ``hrnet_w48_ocr`` and
``hrnet_w48_ocr_contrast`` map one to one, shape for shape, onto the port's
``state_dict`` (``hrnet_w18_ocr_b`` above already runs the OCR-B heads at
their full widths, 256, 128 and 256).
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.models.ocr import SpatialGather as JSpatialGather
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.state import create_train_state, init_weights
from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import HRNetOCRSeg, build_model
from contrastiveseg_tpu_torch.models.ocr import SpatialGather
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, hrnet_ocr_key, load_jax_variables

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W, C = 2, 64, 64, 19
NETS = ("hrnet_w18_ocr", "hrnet_w18_ocr_contrast", "hrnet_w18_ocr_b")


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _shallow_exact():
    """The shallow hrnet18 in both packages, exact fp32 on the JAX side, no
    dropout, and torch on one thread (the tolerances are far above any
    summation-order effect)."""
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    exact_fp32_reference(mp, compiled_blocks=False)
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _cfg(name, get=get_preset):
    """The preset with net ``name``: 19 classes, ``fs_auxce_loss`` with its
    class weights."""
    return get("cityscapes_hrnet_w48_ocr").updated("network.model_name", name)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def nets():
    """Per net: the JAX module and numpy variables (one ``eval_shape`` of the
    contrast net covers the plain one, less its projection head)."""
    out = {}
    full = None
    for name in NETS:
        jm = jbuild_model(_cfg(name, jget_preset))
        if name == "hrnet_w18_ocr_b":
            out[name] = (jm, random_variables(jm, (1, H, W, 3), seed=2))
            continue
        if full is None:
            full = random_variables(jbuild_model(_cfg("hrnet_w18_ocr_contrast", jget_preset)),
                                    (1, H, W, 3), seed=1)
        out[name] = (jm, full if jm.with_proj else {
            col: {k: v for k, v in t.items() if k != "proj_head"} for col, t in full.items()})
    return out


def _port(name, variables):
    pm = _no_dropout(build_model(_cfg(name)))
    load_jax_variables(pm, variables)
    return pm


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, H, W, 3)).astype(np.float32)


def _as_port(arr):
    return np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr


@pytest.mark.parametrize("name", NETS)
def test_forward_bn_stats_and_grads_match_jax(name, nets):
    """Train mode: ``seg``, ``seg_aux`` (and ``embed``), the BN statistics
    after the forward, and every parameter's gradient of ``fs_auxce_loss``;
    then the eval-mode forward."""
    jm, v = nets[name]
    x = _images()
    lab = np.random.default_rng(1).integers(-1, C, (B, H, W))
    jloss = jbuild_loss(_cfg(name, jget_preset))

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
    pm = _port(name, v).train()
    assert isinstance(pm, HRNetOCRSeg)
    out = pm(torch.from_numpy(x))
    with_proj = name.endswith("_contrast")
    assert set(out) == set(jout) == {"seg", "seg_aux"} | ({"embed"} if with_proj else set())
    hw = (16, 16) if with_proj else (H, W)  # stride 4 for the contrast net
    assert out["seg"].shape == out["seg_aux"].shape == (B, *hw, C)
    for k in out:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)
    loss, _ = build_loss(_cfg(name))(out, torch.from_numpy(lab))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    loss.backward()

    sd = pm.state_dict()
    stats = flatten(jax.tree.map(np.asarray, jstats))
    for path, new in stats.items():
        key = hrnet_ocr_key(path)
        np.testing.assert_allclose(sd[key].numpy(), new, atol=1e-3, rtol=1e-3, err_msg=key)
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())

    got = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
           for k, p in pm.named_parameters()}
    want = {hrnet_ocr_key(p): _as_port(g)
            for p, g in flatten(jax.tree.map(np.asarray, jgrads)).items()}
    assert got.keys() == want.keys()
    total = np.sqrt(sum(np.sum(g ** 2) for g in want.values()))
    for k, g in want.items():
        # The floor covers conv biases right before a train-mode BN, whose
        # gradient is 0 up to rounding (~1e-8 here).
        assert np.linalg.norm(got[k] - g) <= 5e-2 * np.linalg.norm(g) + 1e-6 * total, k
    assert np.sqrt(sum(np.sum((got[k] - g) ** 2) for k, g in want.items())) <= 2e-2 * total
    _check_eval_forward(name, nets)


def _check_eval_forward(name, nets):
    """Eval mode on running statistics calibrated to the images' batch
    statistics (random ones blow the logits up)."""
    jm, v = nets[name]
    x = _images(1)
    pm = _port(name, v)
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        pm.train()(torch.from_numpy(x))
    sd = pm.state_dict()
    stats = {}
    for path in flatten(v["batch_stats"]):
        tree = stats
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = sd[hrnet_ocr_key(path)].numpy()
    want = jax.jit(lambda p, s: jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                                         train=False))(v["params"], stats)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=f"eval {k}")


def _check_spatial_gather():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 6, 7, 8)).astype(np.float32)
    probs = 3 * rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    want = JSpatialGather().apply({}, jnp.asarray(feats), jnp.asarray(probs))
    got = SpatialGather()(torch.from_numpy(feats).permute(0, 3, 1, 2),
                          torch.from_numpy(probs).permute(0, 3, 1, 2))
    assert got.shape == (2, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def _batch(cfg):
    ds = SyntheticSegDataset(num_classes=C, size_hw=(H, W), length=8)
    samples = [ds[i] for i in range(B)]
    n = cfg.get("normalize")
    norm = Normalizer(n["div_value"], n["mean_value"], n["std"])
    return {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
            "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}


def test_one_contrast_train_step_matches_jax(nets):
    """One step of ``cityscapes_hrnet_w48_ocr_contrast`` cut to the shallow
    hrnet18 and 64x64 crops: CE of seg and seg_aux plus the anchors' InfoNCE
    on the stride-4 embeddings (``max_views`` 12: a class needs more than
    that many pixels of an image on the 16x16 grid), backward, SGD, against
    the JAX step with the same anchor draws."""
    def config(get):
        cfg = get("cityscapes_hrnet_w48_ocr_contrast").updated(
            "network.model_name", "hrnet_w18_ocr_contrast")
        for k, val in {"contrast.warmup_iters": 0, "contrast.max_views": 12,
                       "contrast.exact_sampling": True}.items():
            cfg = cfg.updated(k, val)
        return cfg

    jcfg, cfg = config(jget_preset), config(get_preset)
    jmodel = jbuild_model(jcfg)
    variables = nets["hrnet_w18_ocr_contrast"][1]
    batch = _batch(cfg)
    tx = jbuild_optimizer(jcfg, variables["params"])
    rng = jax.random.key(7)
    s0 = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"],
                     opt_state=tx.init(variables["params"]), bank=None, rng=rng, tx=tx)
    jstep = jmake_train_step(jmodel, jbuild_loss(jcfg), warmup_iters=0, network_stride=4,
                             donate=False, exact_sampling=True)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})
    _, _, r_sample, _ = jax.random.split(rng, 4)
    draws = Draws(anchor=AnchorScores(*(
        torch.from_numpy(np.array(jax.random.uniform(k, (B, 19, 16 * 16))))
        for k in jax.random.split(r_sample))))

    state = create_train_state(cfg, _no_dropout(build_model(cfg)), "cpu")
    assert state.bank is None
    load_jax_variables(state.model, variables)
    metrics = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4)(
        state, batch, draws)
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)
    assert float(jmetrics["loss_contrast"]) > 0
    sd = state.model.state_dict()
    for path, want in flatten(jax.tree.map(np.asarray, s1.params)).items():
        key = hrnet_ocr_key(path)
        np.testing.assert_allclose(sd[key].numpy(), _as_port(want), atol=5e-4, err_msg=key)


@pytest.fixture(scope="module")
def w48_shapes():
    """``jax.eval_shape`` of the W48 OCR contrast net's init at 19 classes."""
    cfg = jget_preset("cityscapes_hrnet_w48_ocr_contrast")
    shapes = jax.eval_shape(lambda: jbuild_model(cfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3)), train=True))
    return {col: flatten(jax.tree.map(lambda s: np.empty(s.shape, np.float32), dict(shapes[col])))
            for col in ("params", "batch_stats")}


def test_full_width_leaves_and_spatial_gather_match_jax(w48_shapes):
    """The W48 nets' variables, and ``SpatialGather`` alone."""
    for name in ("hrnet_w48_ocr", "hrnet_w48_ocr_contrast"):
        _check_full_width(name, w48_shapes)
    _check_spatial_gather()


def _check_full_width(name, w48_shapes):
    """W48 at 19 classes: every leaf of the JAX init (``jax.eval_shape``, no
    compute) is one port tensor of its shape, none left over.  The plain
    net's leaves are the contrast net's less the projection head."""
    with torch.device("meta"):
        pm = build_model(get_preset("cityscapes_hrnet_w48_ocr").updated(
            "network.model_name", name))
    sd = {k: tuple(v.shape) for k, v in pm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    mapped = {}
    for col, leaves in w48_shapes.items():
        for path, leaf in leaves.items():
            if path[0] == "proj_head" and not name.endswith("_contrast"):
                continue
            key = hrnet_ocr_key(path)
            assert key in sd and key not in mapped, (col, path, key)
            mapped[key] = tuple(_as_port(leaf).shape)
    assert mapped == sd
    assert sd["cls_head.weight"] == (19, 512, 1, 1) and sd["aux_head.0.weight"][:2] == (720, 720)
    assert sd["ocr_distri_head.object_context_block.f_pixel.0.weight"] == (256, 512, 1, 1)


def test_pth_loads_strictly_and_refusals(tmp_path, nets):
    """A segmentor ``.pth``, then what ``build_model`` refuses."""
    _check_segmentor_pth(tmp_path, nets)
    for name in ("hrnet_w48_ocr_b_ha", "hrnet_w18_ocr_b_ha"):
        with pytest.raises(NotImplementedError, match=r"ROADMAP 7.*HANet"):
            build_model(get_preset("cityscapes_hrnet_w48_ocr").updated(
                "network.model_name", name))
    for name in ("ideal_spatial_ocrnet", "ideal_spatial_ocrnet_b"):  # ported now
        with torch.device("meta"):
            assert type(build_model(get_preset(f"cityscapes_{name}"))).__name__ == (
                "IdealSpatialOCRNet")
    for name in ("hrnet_w48_ocr", "hrnet_w48_ocr_contrast"):
        cfg = get_preset("cityscapes_hrnet_w48_ocr").updated("network.model_name", name)
        with pytest.raises(NotImplementedError, match="pallas_conv"):
            build_model(cfg.updated("network.pallas_conv", True))


def _check_segmentor_pth(tmp_path, nets):
    """An HRNet_W48_OCR_CONTRAST-layout ``.pth`` (here at the shallow
    hrnet18) whose ``conv3x3`` and ``aux_head`` 3x3 convs and OCR projection
    carry biases: each folds into the BN after it, as the JAX importer
    folds it; the rest loads bit for bit."""
    name = "hrnet_w18_ocr_contrast"
    source = build_model(_cfg(name))
    g = torch.Generator().manual_seed(4)
    init_weights(source, g)
    with torch.no_grad():
        for m in source.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
    sd = dict(source.state_dict())
    folds = {"conv3x3.0": "conv3x3.1.0", "aux_head.0": "aux_head.1.0",
             "ocr_distri_head.conv_bn_dropout.0": "ocr_distri_head.conv_bn_dropout.1.0"}
    for i, conv in enumerate(folds):
        sd[f"{conv}.bias"] = torch.linspace(-1, 1, sd[f"{folds[conv]}.running_mean"].numel()) * (i + 1)
    path = tmp_path / "ocr.pth"
    torch.save({"model": sd}, path)
    state = create_train_state(_cfg(name), build_model(_cfg(name)), "cpu", pretrained=str(path))
    got = state.model.state_dict()
    for k, v in source.state_dict().items():
        bias = next((sd[f"{c}.bias"] for c, bn in folds.items() if k == f"{bn}.running_mean"),
                    None)
        assert torch.equal(got[k], v if bias is None else v - bias), k
    jvars, report = ti.convert_state_dict(nets[name][1], {k: v.numpy() for k, v in sd.items()},
                                          ti.mapper_for_model(name))
    assert report["unused"] == [] and report["missing"] == []
    for p, arr in flatten(jvars["batch_stats"]).items():
        np.testing.assert_array_equal(arr, got[hrnet_ocr_key(p)].numpy())
