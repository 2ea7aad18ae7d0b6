"""DeepLab-V3 (dilated ResNet) of the port against the JAX package.

Parity runs a shallow deep-base bottleneck ResNet, layers (1, 1, 2, 2) at
dilate-8, put into both packages' ``RESNET_SPECS`` under the name
``SHALLOW`` (``torch_port_helpers.shallow_resnet``): layer3 gets dilations
[1, 2] and layer4 [2, 4], so both first-block rules of ``_nostride_dilate``
show, at the full widths (c4 has 2048 channels) and the full heads.  19 classes, 2 images of 33x33: an odd
size, through the stem (33 -> 17), the max-pool (17 -> 9) and the
align-corners upsamples.  Weights come from a numpy seed and load through
``load_jax_variables``; the train step uses the same weights.  The JAX side
runs jitted under ``exact_fp32_reference`` (exact BN variance and resizes),
compiled with most of XLA's optimizations off
(``unoptimized_jax_compiles``); torch runs on one thread.

Tolerances: outputs and BN statistics atol/rtol 1e-3, as in
``tests/test_torch_port_model.py``.  Gradients: each tensor within 5e-2 of
the JAX gradient in relative norm (plus 1e-6 of the whole gradient's norm),
all of them together within 2e-2.  The BN backward of a randomly
initialised net cancels digits.  Read at this size against an fp64 run of
the port (both nets give the same gradients: the plain net's upsample is
the one the loss applies to the contrast net's stride-8 outputs): the
port's fp32 gradients are off by up to 5.7e-3 in relative norm (the
``layer_dsn`` 3x3 conv) and 2.5e-4 overall, the JAX package's by up to
2.2e-4; the two fp32 runs differ by up to 5.7e-3 a tensor and 2.9e-4
overall.  At 65x65 and 5 classes they differed by up to 8.8e-3 and 6.5e-3.
A wrong term in a gradient moves it to order 1.  The train step of
``cityscapes_deeplab_v3_contrast`` (19 classes, ``max_views`` 6, contrast
live from step 0, the same anchor draws) holds the losses at rtol 1e-4 and
the post-step parameters at atol 5e-4, as ``tests/test_torch_port_siblings.py``
does.  Full width is checked without compute: the leaves of the JAX init of
``deeplab_v3_contrast`` on ``deepbase_resnet101_dilated8`` map one to one,
shape for shape, onto the port's ``state_dict``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.resnet as jresnet
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.layers import ConvBN as JConvBN
from contrastiveseg_tpu.models.nets import DeepLabV3 as JDeepLabV3
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.state import create_train_state, init_weights
from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models import resnet
from contrastiveseg_tpu_torch.models.layers import ConvBN
from contrastiveseg_tpu_torch.models.nets import DeepLabV3, build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import deeplab_key, flatten, load_jax_variables
from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained

from torch_port_helpers import (
    SHALLOW_RESNET,
    SHALLOW_RESNET_PLAIN_STEM,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_resnet,
    shared_jax_compiles,
    unoptimized_jax_compiles,
    write_tree,
)

SHALLOW = SHALLOW_RESNET
PLAIN_STEM = SHALLOW_RESNET_PLAIN_STEM
B, H, W, C = 2, 33, 33, 19
STEP_HW = 65  # the train step's crops


@pytest.fixture(scope="module", autouse=True)
def _shallow_specs():
    """The shallow specs in both packages, and torch on one thread (the
    tolerances are far above any summation-order effect)."""
    mp = pytest.MonkeyPatch()
    shallow_resnet(mp)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


@pytest.fixture(scope="module")
def exact():
    mp = pytest.MonkeyPatch()
    exact_fp32_reference(mp, compiled_blocks=False)
    yield
    mp.undo()


def _images(seed=0):
    return np.random.default_rng(seed).standard_normal((B, H, W, 3)).astype(np.float32)


def _labels(seed=0):
    lab = np.random.default_rng(seed).integers(0, C, (B, H, W))
    lab[:, :5] = -1  # some ignored pixels
    return lab


def _jax_net(with_proj):
    return JDeepLabV3(C, arch=SHALLOW, with_proj=with_proj)


@pytest.fixture(scope="module")
def variables():
    return random_variables(_jax_net(True), (1, H, W, 3), seed=1)


def _without_proj(variables):
    return {col: {k: v for k, v in t.items() if k != "proj_head"} for col, t in variables.items()}


def _port(variables, with_proj):
    """The port's net with the JAX variables: built on the meta device and
    given storage, since every tensor but the BN counters is loaded."""
    with torch.device("meta"):
        pm = DeepLabV3(C, SHALLOW, with_proj=with_proj)
    pm.to_empty(device="cpu")
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    load_jax_variables(pm, variables if with_proj else _without_proj(variables))
    return pm


def _fs_auxce(get=get_preset):
    """The preset's ``fs_auxce_loss``, with its 19 class weights."""
    return get("cityscapes_deeplab_v3")


def _grads(model) -> dict[str, np.ndarray]:
    """Every parameter's gradient; zeros where the loss does not reach it
    (the projection head under a CE-only loss), as JAX gives them."""
    return {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
            for k, p in model.named_parameters()}


def _as_port(arr):
    return np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr


@pytest.mark.parametrize("with_proj", [False, True], ids=["deeplab_v3", "deeplab_v3_contrast"])
def test_forward_bn_stats_and_grads_match_jax(with_proj, variables, exact):
    """Train mode: ``seg``, ``seg_aux`` (and ``embed``), the BN statistics
    after the forward, ``fs_auxce_loss`` and ``fs_auxohemce_loss`` on those
    outputs and every parameter's gradient of the first; then the eval-mode
    forward."""
    jm = _jax_net(with_proj)
    v = variables if with_proj else _without_proj(variables)
    x, lab = _images(), _labels()
    jloss = jbuild_loss(_fs_auxce(jget_preset))

    @jax.jit
    def run(params):
        def f(p):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
            loss, _ = jloss(jax.random.key(0), out, jnp.asarray(lab, jnp.int32))
            return loss, (out, new["batch_stats"])

        return jax.value_and_grad(f, has_aux=True)(params)

    (jl, (jout, jstats)), jgrads = run(v["params"])

    pm = _port(variables, with_proj).train()
    out = pm(torch.from_numpy(x))
    want_keys = {"seg", "seg_aux"} | ({"embed"} if with_proj else set())
    assert set(out) == want_keys == set(jout)
    hw = (5, 5) if with_proj else (H, W)  # stride 8 for the contrast net
    assert out["seg"].shape == out["seg_aux"].shape == (B, *hw, C)
    for k in want_keys:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)
    loss, _ = build_loss(_fs_auxce())(out, torch.from_numpy(lab))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    loss.backward()
    if with_proj:  # fs_auxohemce_loss on the stride-8 outputs, which it upsamples:
        # OHEM on seg (a min-kept of 500 of the 2178 pixels, so the
        # threshold bites), plain CE on seg_aux.
        ohem = {"loss.loss_type": "fs_auxohemce_loss", "loss.params.ohem_minkeep": 500,
                "loss.params.ohem_thresh": 0.7}
        jcfg, pcfg = _fs_auxce(jget_preset), _fs_auxce()
        for k, val in ohem.items():
            jcfg, pcfg = jcfg.updated(k, val), pcfg.updated(k, val)
        want_ohem, _ = jax.jit(lambda o: jbuild_loss(jcfg)(
            jax.random.key(0), o, jnp.asarray(lab, jnp.int32)))(jout)
        got_ohem, _ = build_loss(pcfg)({k: v.detach() for k, v in out.items()},
                                       torch.from_numpy(lab))
        np.testing.assert_allclose(got_ohem.item(), float(want_ohem), rtol=1e-5)
        assert abs(float(want_ohem) - float(jl)) > 1e-3  # OHEM changed the loss

    sd = pm.state_dict()
    stats = flatten(jax.tree.map(np.asarray, jstats))
    for path, new in stats.items():
        key = deeplab_key(path)
        np.testing.assert_allclose(sd[key].numpy(), new, atol=1e-3, rtol=1e-3, err_msg=key)
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())

    got = _grads(pm)
    want = {deeplab_key(p): _as_port(np.asarray(g))
            for p, g in flatten(jax.tree.map(np.asarray, jgrads)).items()}
    assert got.keys() == want.keys()
    total = np.sqrt(sum(np.sum(g ** 2) for g in want.values()))
    for k, g in want.items():
        # The floor covers conv biases right before a train-mode BN, whose
        # gradient is 0 up to rounding (~1e-8 here).
        assert np.linalg.norm(got[k] - g) <= 5e-2 * np.linalg.norm(g) + 1e-6 * total, k
    assert np.sqrt(sum(np.sum((got[k] - g) ** 2) for k, g in want.items())) <= 2e-2 * total
    _check_eval_forward(pm, v, with_proj)


def _check_eval_forward(pm, v, with_proj):
    """Eval mode on running statistics calibrated to the images' batch
    statistics (random ones blow the logits up); ``pm`` holds the weights
    of ``v`` (a backward changes none)."""
    x = _images(1)
    for m in pm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        pm.train()(torch.from_numpy(x))
    sd = pm.state_dict()
    calibrated = {"params": v["params"], "batch_stats": {}}
    for path in flatten(v["batch_stats"]):
        tree = calibrated["batch_stats"]
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = sd[deeplab_key(path)].numpy()
    want = jax.jit(lambda c: _jax_net(with_proj).apply(c, jnp.asarray(x), train=False))(
        calibrated)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=f"eval {k}")


def test_resnet_layout_matches_jax():
    """The backbone's feature sizes, stage plans and dilated convs, and the
    full-width net's variables, against the JAX package's."""
    _check_feature_sizes()
    for arch in ("deepbase_resnet101_dilated8", "resnet101_dilated16", "resnet50",
                 "deepbase_resnet18_dilated8"):
        _check_stage_plan(arch)
    for dilation, stride in ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2)):
        _check_dilated_convbn(dilation, stride)
    _check_full_width()


def _check_feature_sizes():
    """[stem, pool, c1, c2, c3, c4] of an odd 33x33 input, and the JAX
    package's floor max-pool, not the reference's ceil: the same 17 -> 9
    here, but 512x1024 gives 128x256 where ceil_mode gives 129x257."""
    spec = resnet.RESNET_SPECS[SHALLOW]
    pm = resnet.ResNet(spec)
    with torch.no_grad():
        feats = pm(torch.zeros(1, 3, H, W))
    jfeats = jax.eval_shape(lambda: jresnet.ResNet(jresnet.RESNET_SPECS[SHALLOW]).init_with_output(
        jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)[0])
    assert [tuple(f.shape[2:]) for f in feats] == [tuple(f.shape[1:3]) for f in jfeats] == [
        (17, 17), (9, 9), (9, 9), (5, 5), (5, 5), (5, 5)]
    assert [f.shape[1] for f in feats] == [f.shape[3] for f in jfeats] == [
        128, 128, 256, 512, 1024, 2048]
    with torch.device("meta"):
        big = resnet.ResNet(spec)(torch.empty(1, 3, 512, 1024))
    assert tuple(big[-1].shape[2:]) == (64, 128) and tuple(big[1].shape[2:]) == (128, 256)


def _check_stage_plan(arch):
    """``_stage_plan`` is the JAX package's, and each block's 3x3 convs
    carry its dilation, stride and padding dilation*(k-1)//2."""
    spec = resnet.RESNET_SPECS[resnet.resolve_arch(arch)]
    plan = resnet._stage_plan(spec)
    assert plan == jresnet._stage_plan(jresnet.RESNET_SPECS[jresnet.resolve_arch(arch)])
    if arch == "deepbase_resnet101_dilated8":
        assert plan[2][3] == [1] + [2] * 22 and plan[3][3] == [2, 4, 4]
    with torch.device("meta"):
        net = resnet.ResNet(spec)
    for si, (_, n, stride, dil) in enumerate(plan, 1):
        for b in range(n):
            block = getattr(net, f"layer{si}")[b]
            c = block.conv2 if spec.block == "bottleneck" else block.conv1
            assert c.dilation == (dil[b],) * 2 and c.padding == (dil[b],) * 2
            assert c.stride == ((stride,) * 2 if b == 0 else (1, 1))


def _check_dilated_convbn(dilation, stride):
    """One ConvBN (3x3, train mode) on an odd 11x13 input: padding
    dilation*(k-1)//2 on both sides, as the JAX ConvBN pads."""
    x = np.random.default_rng(dilation + 10 * stride).standard_normal((2, 11, 13, 4)).astype(
        np.float32)
    jm = JConvBN(6, 3, stride, dilation, use_relu=True)
    v = random_variables(jm, x.shape, seed=3)
    want, _ = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    pm = ConvBN(4, 6, 3, stride, dilation=dilation)
    with torch.no_grad():
        pm[0].weight.copy_(torch.from_numpy(_as_port(v["params"]["conv"]["kernel"])))
        for leaf, name in (("scale", "weight"), ("bias", "bias")):
            getattr(pm[1], name).copy_(torch.from_numpy(v["params"]["norm"]["bn"][leaf]))
        got = pm.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5,
                               err_msg=f"dilation {dilation}, stride {stride}")


@pytest.fixture(scope="module")
def step_config():
    """``cityscapes_deeplab_v3_contrast`` cut to the shallow backbone and
    65x65 crops: ``max_views`` 6, since a class needs more than
    ``max_views`` pixels of an image on the 9x9 stride-8 grid (the 19
    classes of these scenes have 1-13 each, so some qualify and some do
    not); contrast live from step 0."""
    def config(get):
        cfg = get("cityscapes_deeplab_v3_contrast")
        for k, v in {"network.backbone": SHALLOW, "contrast.warmup_iters": 0,
                     "contrast.max_views": 6, "contrast.exact_sampling": True}.items():
            cfg = cfg.updated(k, v)
        return cfg

    return config


def _batch(cfg, n_classes=19):
    ds = SyntheticSegDataset(num_classes=n_classes, size_hw=(STEP_HW, STEP_HW), length=8)
    samples = [ds[i] for i in range(B)]
    n = cfg.get("normalize")
    norm = Normalizer(n["div_value"], n["mean_value"], n["std"])
    return {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
            "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}


def test_one_contrast_train_step_matches_jax(step_config, variables, exact):
    """One step of the scaled-down ``cityscapes_deeplab_v3_contrast``: CE of
    seg and seg_aux (``contrast_auxce_loss``) plus the anchors' InfoNCE,
    backward, SGD, against the JAX step with the same anchor draws."""
    jcfg, cfg = step_config(jget_preset), step_config(get_preset)
    jmodel = jbuild_model(jcfg)
    batch = _batch(cfg)
    tx = jbuild_optimizer(jcfg, variables["params"])
    rng = jax.random.key(7)
    s0 = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"],
                     opt_state=tx.init(variables["params"]), bank=None, rng=rng, tx=tx)
    jstep = jmake_train_step(jmodel, jbuild_loss(jcfg), warmup_iters=0, network_stride=8,
                             donate=False, exact_sampling=True)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})
    _, _, r_sample, _ = jax.random.split(rng, 4)
    n = 9 * 9
    draws = Draws(anchor=AnchorScores(*(
        torch.from_numpy(np.array(jax.random.uniform(k, (B, 19, n))))
        for k in jax.random.split(r_sample))))

    state = create_train_state(cfg, build_model(cfg), "cpu")
    assert state.bank is None and isinstance(state.model, DeepLabV3)
    load_jax_variables(state.model, variables)
    step = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=8)
    metrics = step(state, batch, draws)
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)
    assert float(jmetrics["loss_contrast"]) > 0

    sd = state.model.state_dict()
    for path, want in flatten(jax.tree.map(np.asarray, s1.params)).items():
        key = deeplab_key(path)  # atol 5e-4 (assert_allclose takes seconds on 65M values)
        assert np.abs(sd[key].numpy() - _as_port(want)).max() <= 5e-4, key


def _check_full_width():
    """deeplab_v3_contrast on deepbase_resnet101_dilated8, 19 classes: every
    leaf of the JAX init (``jax.eval_shape``, no compute) is one port tensor
    of its shape, and no port tensor is left over."""
    cfg = jget_preset("cityscapes_deeplab_v3_contrast")
    assert cfg.get("network.backbone") == "deepbase_resnet101_dilated8"
    shapes = jax.eval_shape(lambda: jbuild_model(cfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, 65, 65, 3)), train=True))
    with torch.device("meta"):
        pm = build_model(get_preset("cityscapes_deeplab_v3_contrast"))
    sd = {k: tuple(v.shape) for k, v in pm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    mapped = {}
    for col in ("params", "batch_stats"):
        for path, leaf in flatten(jax.tree.map(lambda s: np.empty(s.shape, np.float32),
                                               dict(shapes[col]))).items():
            key = deeplab_key(path)
            assert key in sd and key not in mapped, (col, path, key)
            mapped[key] = tuple(_as_port(leaf).shape)
    assert mapped == sd
    assert sd["backbone.layer4.2.conv3.weight"] == (2048, 512, 1, 1)
    assert sum(np.prod(s) for k, s in sd.items()) > 9e7


def _zero_variables(jmodel) -> dict:
    """Zeros in the shape of ``jmodel``'s variables (``jax.eval_shape``)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, H, W, 3)), train=True))
    return {col: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes[col]))
            for col in ("params", "batch_stats")}


def _source(model, seed):
    """``model`` at a seeded init, BN running statistics off their init."""
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return model


def test_pth_files_load_strictly(tmp_path, variables):
    """ResNet ImageNet files in both layouts and a DeepLabV3Contrast file
    (the JAX side's variables those of ``variables``)."""
    for layout in ("deep_base", "torchvision"):
        _check_imagenet_pth(layout, tmp_path / layout, variables)
    _check_segmentor_pth(tmp_path, variables)


def _check_imagenet_pth(layout, tmp_path, variables):
    """A ResNet ImageNet ``.pth``: deep-base ``resinit.*`` keys, or a
    torchvision 7x7 stem whose ``conv1.``/``bn1.`` become ``resinit.conv1.``
    and ``resinit.bn1.`` (``tools/import_torch_ckpt.py:97-106``); ``fc.`` is
    dropped, the heads keep their init; the JAX import route fills the same
    backbone leaves with the same values."""
    tmp_path.mkdir()
    arch = SHALLOW if layout == "deep_base" else PLAIN_STEM
    cfg = get_preset("cityscapes_deeplab_v3").updated("network.backbone", arch)
    source = _source(resnet.ResNet(resnet.RESNET_SPECS[arch]), seed=3)
    sd = dict(source.state_dict())
    if layout == "torchvision":
        sd = {k.replace("resinit.", "", 1): v for k, v in sd.items()}
        assert "conv1.weight" in sd and sd["conv1.weight"].shape == (64, 3, 7, 7)
    sd.update({"fc.weight": torch.ones(1000, 2048), "fc.bias": torch.zeros(1000)})
    path = tmp_path / "resnet_imagenet.pth"
    torch.save(sd, path)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(5))
    heads = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("decoder.")}
    assert load_pretrained(model, str(path)) is None
    got = model.state_dict()
    for k, v in source.state_dict().items():
        assert torch.equal(got[f"backbone.{k}"], v), k
    assert all(torch.equal(got[k], v) for k, v in heads.items())  # kept at their init

    jsd = {f"backbone.{k}": v.numpy() for k, v in sd.items() if not k.startswith("fc.")}
    if layout == "torchvision":
        jsd = {k.replace("backbone.conv1.", "backbone.resinit.conv1.")
               .replace("backbone.bn1.", "backbone.resinit.bn1."): v for k, v in jsd.items()}
    jvars, report = ti.convert_state_dict(
        variables if layout == "deep_base" else _zero_variables(jbuild_model(cfg)), jsd, "deeplab")
    assert report["unused"] == []
    for path, arr in flatten(jvars["params"]).items():
        if path[0] == "backbone":
            np.testing.assert_array_equal(_as_port(arr), got[deeplab_key(path)].numpy())


def _check_segmentor_pth(tmp_path, variables):
    """A DeepLabV3Contrast ``.pth`` with biases on convs that feed a BN (the
    ``layer_dsn`` 3x3, an ASPP branch, a stem conv): each folds into its BN's
    running mean, as ``utils/torch_import._convbn`` folds it; everything else
    loads bit for bit; a stray key is refused."""
    cfg = get_preset("cityscapes_deeplab_v3_contrast").updated("network.backbone", SHALLOW)
    source = _source(build_model(cfg), seed=4)
    sd = dict(source.state_dict())
    folds = {"decoder.layer_dsn.0": "decoder.layer_dsn.1.0",
             "decoder.layer_aspp.b4.1": "decoder.layer_aspp.b4.2.0",
             "decoder.refine.0": "decoder.refine.1",
             "backbone.resinit.conv2": "backbone.resinit.bn2",
             "backbone.layer1.0.downsample.0": "backbone.layer1.0.downsample.1"}
    for i, conv in enumerate(folds):
        n = sd[f"{folds[conv]}.running_mean"].numel()
        sd[f"{conv}.bias"] = torch.linspace(-1, 1, n) * (i + 1)
    path = tmp_path / "deeplab.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=str(path))
    got = state.model.state_dict()
    for k, v in source.state_dict().items():
        bias = next((sd[f"{c}.bias"] for c, bn in folds.items() if k == f"{bn}.running_mean"),
                    None)
        assert torch.equal(got[k], v if bias is None else v - bias), k
    jvars, report = ti.convert_state_dict(
        variables, {k: v.numpy() for k, v in sd.items()}, "deeplab")
    assert report["unused"] == [] and report["missing"] == []
    for path, arr in flatten(jvars["batch_stats"]).items():
        np.testing.assert_array_equal(arr, got[deeplab_key(path)].numpy())
    torch.save({**sd, "decoder.stray.weight": torch.zeros(1)}, tmp_path / "stray.pth")
    with pytest.raises(ValueError, match=r"left over \['decoder.stray.weight'\]"):
        load_pretrained(state.model, str(tmp_path / "stray.pth"))


def test_refusals_and_multi_grid(tmp_path):
    """``build_model`` refuses the ResNet variant families and
    ``network.pallas_conv``, reads no ``network.multi_grid``, and a trainer
    at batch 1 refuses with a clear message."""
    for backbone, what in (
            ("resnext101_dilated8", "groups"), ("wide_resnet101_dilated8", "width_mult"),
            ("deepbase_dcn_resnet101_dilated8", "dcn_layer4"),
            ("wide_resnet38_dilated8", "WiderResNetA2")):
        cfg = get_preset("cityscapes_deeplab_v3").updated("network.backbone", backbone)
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP 7"):
            build_model(cfg)
    # ResNeSt (radix) is ported now (tests/test_torch_port_resnest.py).
    with torch.device("meta"):
        assert build_model(get_preset("cityscapes_deeplab_v3").updated(
            "network.backbone", "resnest101_dilated8")).backbone.radix == 2
    cfg = get_preset("cityscapes_deeplab_v3_contrast")
    with pytest.raises(NotImplementedError, match="pallas_conv"):
        build_model(cfg.updated("network.pallas_conv", True))
    # network.multi_grid is read by neither package: layer4 keeps (2, 4, 4).
    with torch.device("meta"):
        net = build_model(cfg.updated("network.multi_grid", [1, 2, 4]))
    assert [b.conv2.dilation[0] for b in net.backbone.layer4] == [2, 4, 4]
    # The ASPP image-pool BN has one value a channel at batch 1: torch
    # refuses to train it (flax returns zeros), and the port says why.
    tree = write_tree(tmp_path / "cityscapes", n_train=2, n_val=1, hw=(64, 64))
    cfg = get_preset("cityscapes_deeplab_v3").updated("network.backbone", SHALLOW)
    for k, v in {"data.synthetic": False, "data.data_dir": str(tree), "train.batch_size": 1,
                 "train.data_transformer.input_size": [64, 64],
                 "train_trans.random_crop.crop_size": [64, 64], "solver.max_iters": 1,
                 "checkpoints.save_iters": 0,
                 "checkpoints.checkpoints_dir": str(tmp_path / "ckpt")}.items():
        cfg = cfg.updated(k, v)
    with pytest.raises(ValueError, match="train.batch_size >= 2"):
        Trainer(cfg, "cpu").train()
