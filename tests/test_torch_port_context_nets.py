"""The context-head nets of the port against the JAX package.

The eleven nets: ``fcnet``, ``fcnet_wo_dsn``, ``spatial_ocrnet``,
``spatial_asp_ocrnet``, ``base_ocnet``, ``asp_ocnet``, ``isanet`` (with two
``network.factors``, so that ``up_conv`` runs), ``pspnet``, ``ccnet`` and
``pyramid_ocnet`` on the shallow deep-base ResNet of
``torch_port_helpers.shallow_resnet`` (layers (1, 1, 2, 2) at the full
widths: c3 1024, c4 2048 channels, and the heads at theirs), and
``hrnet_w48_isa`` on ``shallow_hrnet18`` (59 classes, as its Pascal-Context
preset).  2 images of 49x49: c4 is 7x7, which is no multiple of ISA's 8x8
blocks, of the pyramid levels 2, 3 and 6, or of the PSP bins 2, 3 and 6.
Weights come from a numpy seed (``random_variables``: BaseOC's ``W`` and
CCNet's ``gamma`` off their zero init) and load through
``load_jax_variables``.  The JAX side runs jitted under
``exact_fp32_reference`` (exact BN variance and fuse upsamples), with most
of XLA's optimizations off; torch runs on one thread.  The dropouts are off
on both sides (flax's ``Dropout`` patched to the identity, the port's
``p = 0``).

Tolerances, as in ``tests/test_torch_port_deeplab.py``: outputs and BN
statistics after a train-mode forward atol/rtol 1e-3 (read: logits at most
1.8e-4 apart, ISANet's); one train step of ``cityscapes_spatial_ocrnet``
(``fs_auxce_loss``) and of ``cityscapes_fcnet_wo_dsn`` (``fs_ce_loss``, no
aux head) holds the losses at rtol 1e-4 (read: 1.9e-6 and 3.3e-6) and the
post-step parameters at atol 5e-4 (read: 9.8e-5 and 3.5e-5).  The
reference layouts are held against the JAX package's own importer
(``utils/torch_import.convert_state_dict`` with ``mapper_for_model``'s
mapper), without a JAX compile: a ``.pth`` of the port's ``state_dict``,
with a bias on every conv the importer folds into a BN, loads strictly
through ``network.pretrained``, and the importer turns it back into the
numpy variables the port was loaded from, array for array (each folded
mean less its bias), as the port's own load does.
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.attention as jatt
import contrastiveseg_tpu.models.nets as jnets
import contrastiveseg_tpu.models.resnet as jresnet
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.ops.confusion import confusion_matrix
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, key_for, load_jax_variables
from contrastiveseg_tpu_torch.utils.png import encode_png
from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained

from torch_port_helpers import (
    SHALLOW_RESNET,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shallow_resnet,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W = 2, 49, 49
NETS = ("fcnet", "fcnet_wo_dsn", "spatial_ocrnet", "spatial_asp_ocrnet", "base_ocnet",
        "asp_ocnet", "isanet", "pspnet", "ccnet", "pyramid_ocnet", "hrnet_w48_isa")
# The nets with a reference module, by their importer mapper (fcnet_wo_dsn's
# layout is fcnet's less the dsn head).
REFERENCE = ("fcnet", "spatial_ocrnet", "spatial_asp_ocrnet", "base_ocnet", "asp_ocnet",
             "isanet")


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    shallow_resnet(mp)
    shallow_hrnet18(mp)
    exact_fp32_reference(mp, compiled_blocks=False)
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _cfg(name, get=get_preset):
    """The net's preset (``cityscapes_fcnet`` for the two without one) on
    the shallow backbone."""
    if name == "hrnet_w48_isa":
        return get("pascal_context_hrnet_w48_isa").updated("network.backbone", "hrnet18")
    preset = "cityscapes_fcnet" if name in ("pspnet", "ccnet") else f"cityscapes_{name}"
    cfg = get(preset).updated("network.model_name", name).updated(
        "network.backbone", SHALLOW_RESNET)
    return cfg.updated("network.factors", [[4, 4], [2, 3]]) if name == "isanet" else cfg


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


class _Features(flax_nn.Module):
    """Stands in for the JAX ``ResNet`` while the heads' variable trees are
    traced: no variables, and zeros of the real c3 and c4 shapes."""

    spec: object
    dtype: object = jnp.float32

    @flax_nn.compact
    def __call__(self, x, train):
        return [jnp.zeros(s.shape, s.dtype) for s in _Features.shapes]


@pytest.fixture(scope="module")
def variables():
    """Per net, numpy variables from a seed (``jax.eval_shape``, no
    compile).  The ResNet nets share one set of backbone arrays, and their
    heads are traced on ``_Features`` (tracing the backbone's init again
    would take about a second a net)."""
    cfgs = {name: _cfg(name, jget_preset) for name in NETS}
    shape = (1, H, W, 3)
    out = {"hrnet_w48_isa": random_variables(jbuild_model(cfgs["hrnet_w48_isa"]), shape, 11)}
    backbone = jresnet.ResNet(jresnet.RESNET_SPECS[SHALLOW_RESNET])
    _Features.shapes = jax.eval_shape(lambda: backbone.init_with_output(
        jax.random.key(0), jnp.zeros(shape), train=True)[0])[-2:]
    trunk = random_variables(backbone, shape, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnets, "ResNet", _Features)
        for i, name in enumerate(NETS[:-1]):
            v = random_variables(jbuild_model(cfgs[name]), shape, seed=i + 1)
            out[name] = {col: {"backbone": trunk[col], **v[col]} for col in v}
    return out


def _empty(name):
    """The port's net with storage but no init (every tensor but the BN
    counters is loaded next)."""
    with torch.device("meta"):
        pm = build_model(_cfg(name))
    pm.to_empty(device="cpu")
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    return _no_dropout(pm)


def _port(name, v):
    pm = _empty(name)
    load_jax_variables(pm, v)
    return pm


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, H, W, 3)).astype(np.float32)


def _as_port(arr):
    return np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr


@pytest.mark.parametrize("name", NETS)
def test_forward_matches_jax(name, variables):
    """Train mode: the outputs (``seg``, and ``seg_aux`` where the net has
    an aux head) upsampled to the input, and the BN statistics after the
    forward."""
    jm, v = jbuild_model(_cfg(name, jget_preset)), variables[name]
    x = _images()
    jout, jnew = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"]))(v)
    pm = _port(name, v).train()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert set(out) == set(jout) == ({"seg"} if name == "fcnet_wo_dsn" else {"seg", "seg_aux"})
    n_classes = 59 if name == "hrnet_w48_isa" else 19
    for k in out:
        assert out[k].shape == (B, H, W, n_classes)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=k)
    sd, key = pm.state_dict(), key_for(pm)
    stats = flatten(jax.tree.map(np.asarray, jnew["batch_stats"]))
    for path, new in stats.items():
        np.testing.assert_allclose(sd[key(path)].numpy(), new, atol=1e-3, rtol=1e-3,
                                   err_msg=str(path))
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())


def _batch(cfg):
    ds = SyntheticSegDataset(num_classes=19, size_hw=(H, W), length=8)
    samples = [ds[i] for i in range(B)]
    n = cfg.get("normalize")
    norm = Normalizer(n["div_value"], n["mean_value"], n["std"])
    return {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
            "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}


@pytest.mark.parametrize("name", ["spatial_ocrnet", "fcnet_wo_dsn"])
def test_one_train_step_matches_jax(name, variables):
    """One step of the net's preset (``fs_auxce_loss`` with its class
    weights, or ``fs_ce_loss`` on ``seg`` alone): the loss, backward and
    SGD, against the JAX step."""
    jcfg, cfg = _cfg(name, jget_preset), _cfg(name)
    assert cfg.get("loss.loss_type") == ("fs_ce_loss" if name == "fcnet_wo_dsn"
                                         else "fs_auxce_loss")
    v = variables[name]
    batch = _batch(cfg)
    tx = jbuild_optimizer(jcfg, v["params"])
    s0 = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                     batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), bank=None,
                     rng=jax.random.key(7), tx=tx)
    jstep = jmake_train_step(jbuild_model(jcfg), jbuild_loss(jcfg), warmup_iters=0,
                             network_stride=8, donate=False)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})
    state = create_train_state(cfg, _no_dropout(build_model(cfg)), "cpu")
    load_jax_variables(state.model, v)
    metrics = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=8)(state, batch)
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)
    sd, key = state.model.state_dict(), key_for(state.model)
    for path, want in flatten(jax.tree.map(np.asarray, s1.params)).items():
        assert np.abs(sd[key(path)].numpy() - _as_port(want)).max() <= 5e-4, path


@pytest.mark.parametrize("name", REFERENCE)
def test_pth_round_trips_through_the_jax_importer(name, variables, tmp_path):
    """The port's ``state_dict`` is a reference ``.pth`` (DDP ``module.``
    prefix and all) once every conv whose bias the JAX importer folds into
    a BN carries one (the reference's biased convs, BaseOC's
    ``f_query``/``f_key`` among them): it loads strictly through
    ``load_pretrained``, which folds each bias; the importer maps the same
    file onto the numpy variables the port was loaded from, array for
    array, each folded running mean less its bias, with nothing missing or
    left over; and the port holds the importer's arrays bit for bit."""
    v = variables[name]
    sd = _port(name, v).state_dict()
    mapper = ti.mapper_for_model(name)
    assert mapper == {"spatial_asp_ocrnet": "asp_ocrnet"}.get(name, name)
    zeros = jax.tree.map(np.zeros_like, v)  # the JAX tree, as the importer fills it
    folds = {path: tk.fold_bias_key for path in flatten(zeros["batch_stats"])
             if (tk := ti.PATH_MAPPERS[mapper](path)) is not None and tk.fold_bias_key}
    if name == "base_ocnet":
        assert "oc_module.stages.0.f_query.0.bias" in folds.values()
    file = dict(sd)
    for i, bias in enumerate(sorted(set(folds.values()))):
        n = sd[bias.removesuffix(".bias") + ".weight"].shape[0]
        file[bias] = torch.linspace(-1, 1, n) * (i + 1) / len(folds)
    torch.save({"state_dict": {f"module.{k}": t for k, t in file.items()}}, tmp_path / "a.pth")
    fresh = _empty(name)
    assert load_pretrained(fresh, str(tmp_path / "a.pth")) is None
    jvars, report = ti.convert_state_dict(zeros, {k: t.numpy() for k, t in file.items()}, mapper)
    assert report["missing"] == [] and report["unused"] == []
    got, key = fresh.state_dict(), key_for(fresh)
    for col in ("params", "batch_stats"):
        want = flatten(v[col])
        out = flatten(jvars[col])
        assert out.keys() == want.keys()
        for path, arr in out.items():
            expect = want[path] - file[folds[path]].numpy() if path in folds else want[path]
            assert np.array_equal(arr, expect), path
            assert np.array_equal(_as_port(arr), got[key(path)].numpy()), path


def test_zero_inits_refusals_and_imagenet_files(tmp_path):
    """BaseOC's ``W`` and CCNet's ``gamma`` start at zero, in the port's
    train state as in the JAX init; ``network.factors`` sets ISANet's
    blocks; a segmentor ``.pth`` is refused for the four nets the
    reference never registers, and an ImageNet backbone loads into them
    (a ResNet file into ``pyramid_ocnet``, an HRNet one into
    ``hrnet_w48_isa``)."""
    x = jnp.zeros((1, 5, 6, 8))
    jw = jax.jit(lambda k: jatt.BaseOCModule(4, 4, 8).init(k, x, False))(jax.random.key(0))
    assert not np.asarray(jw["params"]["attention"]["W"]["kernel"]).any()
    jg = jax.jit(lambda k: jatt.CCModule(16).init(k, x, False))(jax.random.key(0))
    assert float(jg["params"]["gamma"]) == 0.0
    for name, zero in (("base_ocnet", ("oc_module.stages.0.W.weight",
                                       "oc_module.stages.0.W.bias")),
                       ("ccnet", ("context.gamma",))):
        state = create_train_state(_cfg(name), build_model(_cfg(name)), "cpu")
        sd = state.model.state_dict()
        for k in zero:
            assert not sd[k].any(), (name, k)
        assert sd["cls.weight"].any()
    isa = build_model(_cfg("isanet"))
    assert [s.down_factor for s in isa.isa_head[2].stages] == [(4, 4), (2, 3)]
    assert isa.isa_head[2].up_conv is not None
    assert [s.down_factor for s in build_model(get_preset("cityscapes_isanet").updated(
        "network.backbone", SHALLOW_RESNET)).isa_head[2].stages] == [(8, 8)]

    resnet_file = {k.removeprefix("backbone."): t for k, t in
                   build_model(_cfg("pspnet")).state_dict().items() if k.startswith("backbone.")}
    torch.save({**resnet_file, "fc.weight": torch.ones(3, 2048)}, tmp_path / "r.pth")
    # A segmentor file (backbone. keys), refused before any key is matched.
    torch.save({"backbone.resinit.conv1.weight": torch.zeros(1), "cls.weight": torch.zeros(1)},
               tmp_path / "seg.pth")
    for name in ("pspnet", "ccnet", "pyramid_ocnet", "hrnet_w48_isa"):
        with torch.device("meta"):
            model = build_model(_cfg(name))
        assert not type(model).reference_layout
        with pytest.raises(ValueError, match="no reference layout"):
            load_pretrained(model, str(tmp_path / "seg.pth"))
    model = build_model(_cfg("pyramid_ocnet"))
    load_pretrained(model, str(tmp_path / "r.pth"))
    got = model.state_dict()
    assert all(torch.equal(got[f"backbone.{k}"], t) for k, t in resnet_file.items())
    hr = build_model(_cfg("hrnet_w48_isa"))
    hr_file = {k.removeprefix("backbone."): t.clone() + 1 for k, t in hr.state_dict().items()
               if k.startswith("backbone.")}
    torch.save({**hr_file, "classifier.weight": torch.ones(3, 4)}, tmp_path / "h.pth")
    load_pretrained(hr, str(tmp_path / "h.pth"))
    assert all(torch.equal(hr.state_dict()[f"backbone.{k}"], t) for k, t in hr_file.items())


def _write_pascal_tree(root, sizes):
    """A Pascal-Context-layout tree: VOC-like frame sizes, labels 0-59 with
    0 the background that ``reduce_zero_label`` turns into -1."""
    rng = np.random.default_rng(0)
    for split, hws in sizes.items():
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True)
        for i, (h, w) in enumerate(hws):
            label = rng.integers(0, 60, (h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)
            label = label[:h, :w].astype(np.uint8)
            image = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            (root / split / "image" / f"{i:04d}.png").write_bytes(encode_png(image))
            (root / split / "label" / f"{i:04d}.png").write_bytes(encode_png(label))
    return root


def test_diverse_size_validation(tmp_path):
    """``pascal_context_hrnet_w48_isa``'s validation is ``diverse_size``:
    each frame at its own size, padded to a multiple of 8 (label -1).  The
    trainer's ``validate()`` gives the confusion of the per-image forwards."""
    root = _write_pascal_tree(tmp_path / "pc", {"train": [(37, 50)] * 2,
                                                "val": [(37, 50), (50, 37), (41, 41)]})
    cfg = _cfg("hrnet_w48_isa")
    for k, val in {"data.data_dir": str(root), "checkpoints.checkpoints_dir": str(tmp_path / "c"),
                   "val.batch_size": 2}.items():
        cfg = cfg.updated(k, val)
    assert cfg.get("val.data_transformer.size_mode") == "diverse_size"
    trainer = Trainer(cfg, "cpu")
    model = trainer.state.model.eval()
    want = torch.zeros(59, 59, dtype=torch.int64)
    for batch in build_pipeline(cfg, "val").epoch_iter(0):
        assert isinstance(batch["image"], list)
        for image, label in zip(batch["image"], batch["label"]):
            assert image.shape[0] % 8 == 0 and image.shape[1] % 8 == 0
            with torch.no_grad():
                seg = model(torch.from_numpy(image)[None])["seg"]
            want += confusion_matrix(seg.argmax(-1), torch.from_numpy(label)[None].long(), 59)
    scores = trainer.validate()
    assert 0.0 <= scores["miou"] <= 1.0
    np.testing.assert_array_equal(trainer.evaluator.score.confusion, want.numpy())
    assert want.sum() > 0
