"""SegFix of the port against the JAX package: the offset nets, the loss,
the evaluators, ``test_offset`` and the reference ``.pth`` load.

``segfix_hrnet`` on two shallow backbones put into both packages' spec
tables for this file: ``hrnet18`` as ``torch_port_helpers.shallow_hrnet18``
makes it (W18 widths, one module of one block a stage) and
``hrnet2x20_shallow``, the hrnet2x20 HighResolutionNext at its widths (a
stage 1 of two Bottleneck branches, 128 and 256; then 20, 40, 80, 160,
320) at one module of one block a stage.  2 images of 64x64, weights from a
numpy seed loaded through ``load_jax_variables``.  The JAX side runs jitted
under ``exact_fp32_reference`` (exact BN variance and fuse upsamples), with
most of XLA's optimizations off; torch runs on one thread.

Tolerances: outputs and BN statistics atol/rtol 1e-3, the loss rtol 1e-5
(as in ``tests/test_torch_port_ocr.py``); each parameter's gradient within
1e-2 of the JAX gradient in relative norm (plus 1e-6 of the whole
gradient's norm), all together within 5e-3.  Read: the two fp32 runs
differ by at most 1.9e-5 in the outputs, 1.9e-6 in the loss, 1.8e-5 a
gradient tensor and 1.0e-5 overall, on either backbone.  The loss alone on
random logits (no mask probability near the thresholds 0.5 and 0.6): value
and terms rtol 1e-5, logit gradients rtol 1e-4 and atol 1e-8 (read: 7.4e-7
relative and 2.1e-9 absolute).  The evaluators and ``test_offset`` compare
integers: the evaluators' scores exactly (a constant model), the offset
``.npz`` files exactly (no pixel's two top logits tie).  Full width
without compute: every leaf of the JAX init of ``segfix_hrnet`` on the full
``hrnet2x20`` maps one to one, shape for shape, onto the port's
``state_dict`` built on the meta device, and so does ``HRNetSeg`` on the
shallow ``HRNetNext`` (the registry's ``hrnet2x20`` seg net).
"""

from __future__ import annotations

import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.engine.evaluator import MLDirectionEvaluator as JMLDirectionEvaluator
from contrastiveseg_tpu.engine.evaluator import SegFixEvaluator as JSegFixEvaluator
from contrastiveseg_tpu.engine.tester import Tester as JTester
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.metrics import counters as jcounters
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.engine.evaluator import (
    MLDirectionEvaluator,
    SegFixEvaluator,
    build_evaluator,
)
from contrastiveseg_tpu_torch.engine.state import create_train_state, init_weights
from contrastiveseg_tpu_torch.engine.tester import Tester
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.losses.segfix import SegFixLoss
from contrastiveseg_tpu_torch.metrics import counters
from contrastiveseg_tpu_torch.models.hrnet import HRNetNext
from contrastiveseg_tpu_torch.models.nets import SegFixHRNet, build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import (
    flatten,
    hrnet_seg_key,
    key_for,
    load_jax_variables,
    segfix_key,
    segfix_next_key,
)

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W, D = 2, 64, 64, 8
ARCHS = ("hrnet18", "hrnet2x20_shallow")


@pytest.fixture(scope="module", autouse=True)
def _shallow_exact():
    """The two shallow backbones in both packages, exact fp32 on the JAX
    side, torch on one thread."""
    import contrastiveseg_tpu.models.hrnet as jhrnet

    from contrastiveseg_tpu_torch.models import hrnet

    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    for mod in (jhrnet, hrnet):
        mp.setitem(mod.HRNEXT_SPECS, "hrnet2x20_shallow", (
            mod.HRNextStage(1, 1, (128, 256), block="bottleneck"),
            mod.HRNextStage(1, 1, (20, 40, 80)),
            mod.HRNextStage(1, 1, (20, 40, 80, 160)),
            mod.HRNextStage(1, 1, (20, 40, 80, 160, 320))))
    exact_fp32_reference(mp, compiled_blocks=False)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _cfg(arch, get=get_preset):
    return get("cityscapes_segfix_hrnet").updated("network.backbone", arch)


@pytest.fixture(scope="module")
def nets():
    out = {}
    for seed, arch in enumerate(ARCHS, 1):
        jm = jbuild_model(_cfg(arch, jget_preset))
        out[arch] = (jm, random_variables(jm, (1, H, W, 3), seed=seed))
    return out


def _port(arch, variables):
    pm = build_model(_cfg(arch))
    load_jax_variables(pm, variables)
    return pm


def _as_port(arr):
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    return arr.T if arr.ndim == 2 else arr


def _targets(seed=1, hw=(H, W)):
    """Random SegFix labels: mask in {-1, 0, 1}, directions 0-7 on the mask."""
    rng = np.random.default_rng(seed)
    mask = rng.integers(-1, 2, (B, *hw)).astype(np.int32)
    direction = np.where(mask == 1, rng.integers(0, D, (B, *hw)), -1).astype(np.int32)
    return {"mask_label": mask, "dir_label": direction}


def _grads_close(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    total = np.sqrt(sum(np.sum(g ** 2) for g in want.values()))
    for k, g in want.items():
        assert np.linalg.norm(got[k] - g) <= 1e-2 * np.linalg.norm(g) + 1e-6 * total, k
    err = np.sqrt(sum(np.sum((got[k] - g) ** 2) for k, g in want.items()))
    assert err <= 5e-3 * total
    return err / total


@pytest.mark.parametrize("arch", ARCHS)
def test_offset_net_forward_bn_stats_and_grads_match_jax(arch, nets):
    """Train mode: ``mask`` and ``dir``, the BN statistics after the forward,
    and every parameter's gradient of ``segfix_loss`` on dict targets; then
    the eval-mode forward.  The loss gates the direction term at a mask
    probability of 0 (every pixel), so that no pixel's gate turns on the
    two packages' last bits; the gate itself is held on random logits in
    the loss test."""
    jm, v = nets[arch]
    x = np.random.default_rng(0).standard_normal((B, H, W, 3)).astype(np.float32)
    targets = _targets()
    jloss = jbuild_loss(_cfg(arch, jget_preset).updated("loss.params.mask_threshold", 0.0))

    @jax.jit
    def run(params):
        def f(p):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
            loss, _ = jloss(jax.random.key(0), out,
                            {k: jnp.asarray(t) for k, t in targets.items()})
            return loss, (out, new["batch_stats"])

        return jax.value_and_grad(f, has_aux=True)(params)

    (jl, (jout, jstats)), jgrads = run(v["params"])
    pm = _port(arch, v).train()
    assert isinstance(pm, SegFixHRNet)
    assert isinstance(pm.backbone, HRNetNext) == (arch != "hrnet18")
    out = pm(torch.from_numpy(x))
    stride = 2 if arch != "hrnet18" else 4
    assert out["mask"].shape == (B, H // stride, W // stride, 2)
    assert out["dir"].shape == (B, H // stride, W // stride, D)
    for k in ("mask", "dir"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)
    loss, _ = build_loss(_cfg(arch).updated("loss.params.mask_threshold", 0.0))(
        out, {k: torch.from_numpy(t).long() for k, t in targets.items()})
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
    _grads_close(got, {key(p): _as_port(g)
                       for p, g in flatten(jax.tree.map(np.asarray, jgrads)).items()})

    want = jax.jit(lambda p, s: jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                                         train=False))(v["params"], v["batch_stats"])
    pm = _port(arch, v).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for k in ("mask", "dir"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, rtol=1e-3,
                                   err_msg=f"eval {k}")


def test_segfix_loss_matches_jax_and_the_train_phase_refuses(tmp_path):
    """``SegFixLoss`` on random logits at stride 4 (each term and the logit
    gradients), with a threshold that gates the direction term; then the
    train phase of the preset on a tree, which raises the port's
    ``ValueError`` at its first step: the trainer hands the loss the label
    map, as the JAX trainer does."""
    rng = np.random.default_rng(3)
    logits = {"mask": rng.standard_normal((B, 16, 16, 2)).astype(np.float32),
              "dir": rng.standard_normal((B, 16, 16, D)).astype(np.float32)}
    targets = _targets(4)
    for threshold in (0.5, 0.6):
        cfg = _cfg("hrnet18").updated("loss.params.mask_threshold", threshold)
        jloss = jbuild_loss(_cfg("hrnet18", jget_preset).updated(
            "loss.params.mask_threshold", threshold))
        (jl, jm), jg = jax.value_and_grad(
            lambda o: jloss(jax.random.key(0), o, {k: jnp.asarray(t) for k, t in targets.items()}),
            has_aux=True)({k: jnp.asarray(a) for k, a in logits.items()})
        port = build_loss(cfg)
        assert port == SegFixLoss(mask_threshold=threshold)
        ts = {k: torch.tensor(a, requires_grad=True) for k, a in logits.items()}
        loss, metrics = port(ts, {k: torch.from_numpy(t).long() for k, t in targets.items()})
        loss.backward()
        assert set(metrics) == set(jm)
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        assert float(jm["loss_direction"]) > 0
        for k in ts:
            np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                       atol=1e-8, err_msg=k)
    with pytest.raises(ValueError, match="label map alone"):
        port(ts, torch.zeros((B, H, W), dtype=torch.long))

    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from tools.train_torch import build_config
    from torch_port_helpers import write_tree

    tree = write_tree(tmp_path / "cityscapes", n_train=2, n_val=0, hw=(64, 128))
    cfg = build_config("cityscapes_segfix_hrnet", None, [
        "network.backbone=hrnet18", "data.synthetic=False", f"data.data_dir={tree}",
        "train.batch_size=2", "train.data_transformer.input_size=[32,32]",
        "train_trans.random_crop.crop_size=[32,32]", "solver.max_iters=1",
        f"checkpoints.checkpoints_dir={tmp_path / 'ckpt'}"])
    trainer = Trainer(cfg, "cpu")
    with pytest.raises(ValueError, match="label map alone"):
        trainer.train()
    assert trainer.state.step == 0


class _JConstant(flax_nn.Module):
    """Fixed logits at the input's size: ``mask``, and ``dir`` or ``ml_dir``."""
    mask: np.ndarray
    direction: np.ndarray
    key: str = "dir"

    @flax_nn.compact
    def __call__(self, x, train=False):
        scale = self.param("scale", flax_nn.initializers.ones, ())
        return {"mask": scale * jnp.asarray(self.mask),
                self.key: scale * jnp.asarray(self.direction)}


class _Constant(torch.nn.Module):
    def __init__(self, mask, direction, key="dir"):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))
        self.out = {"mask": torch.from_numpy(mask), key: torch.from_numpy(direction)}

    def forward(self, x):
        return {k: self.scale * v for k, v in self.out.items()}


def test_evaluators_and_counters_match_jax():
    """``SegFixEvaluator`` and ``MLDirectionEvaluator`` on a model of fixed
    logits, at the labels' size (so both packages score the same
    predictions), the same scores as the JAX evaluators; the counters'
    copies; ``build_evaluator``'s choice."""
    rng = np.random.default_rng(5)
    mask = rng.standard_normal((B, 32, 48, 2)).astype(np.float32)
    direction = rng.standard_normal((B, 32, 48, D)).astype(np.float32)
    targets = _targets(6, (32, 48))
    targets["mask_label"][0, :2] = -1
    batch = {"image": np.zeros((B, 32, 48, 3), np.float32), **targets,
             "ml_dir_label": rng.integers(0, 256, (B, 32, 48)).astype(np.int32)}
    jev = JSegFixEvaluator(_JConstant(mask, direction), num_directions=D)
    want = jev.run({"scale": jnp.ones(())}, {}, [batch])
    ev = SegFixEvaluator(_Constant(mask, direction), D)
    got = ev.run([batch], "cpu")
    for k in ("mask_acc", "dir_acc_mask", "dir_acc_gt", "miou", "pixel_acc"):
        assert got[k] == want[k], k
    for a, b in ((ev.mask_score, jev.mask_score), (ev.dir_mask_score, jev.dir_mask_score),
                 (ev.dir_gt_score, jev.dir_gt_score)):
        np.testing.assert_array_equal(a.confusion, b.confusion)
    assert 0 < got["dir_acc_gt"] < 1

    jml = JMLDirectionEvaluator(_JConstant(mask, direction, "ml_dir"))
    want = jml.run({"scale": jnp.ones(())}, {}, [batch])
    got = MLDirectionEvaluator(_Constant(mask, direction, "ml_dir")).run([batch], "cpu")
    for k in ("ml_dir_acc_mask", "ml_dir_acc_gt", "miou", "pixel_acc"):
        assert got[k] == want[k], k
    assert 0 < got["ml_dir_acc_gt"] < 1

    pred = rng.integers(-1, 10, 500)
    gt = rng.integers(-1, 9, 500)
    multihot = rng.integers(0, 2, (500, 8))
    for cls in ("SimpleCounterRunningScore", "MultiLabelRunningScore"):
        a, b = getattr(counters, cls)(), getattr(jcounters, cls)()
        for valid in (None, rng.random(500) < 0.7):
            args = (pred, gt) if cls.startswith("Simple") else (pred, multihot)
            a.update(*args, valid)
            b.update(*args, valid)
        assert (a.correct, a.total, a.get_mean_acc()) == (b.correct, b.total, b.get_mean_acc())
        a.reset()
        assert (a.correct, a.total) == (0, 0)

    cfg = get_preset("cityscapes_segfix_hrnet")
    model = _Constant(mask, direction)
    assert type(build_evaluator(cfg, model)) is SegFixEvaluator
    assert type(build_evaluator(cfg.updated("val.evaluator", "ml_dir"), model)) is (
        MLDirectionEvaluator)
    assert build_evaluator(cfg.updated("segfix.num_directions", 4), model).num_directions == 4
    assert type(build_evaluator(get_preset("cityscapes_hrnet_w48"), model)).__name__ == (
        "Evaluator")


def test_test_offset_writes_what_jax_writes(nets, tmp_path):
    """``Tester.test_offset`` of the hrnet18 offset net: images of two
    original sizes in one padded batch, each ``.npz`` (``mask``,
    ``dir_label``, uint8 at its original size) against the JAX Tester's."""
    jm, v = nets["hrnet18"]
    x = np.random.default_rng(7).standard_normal((B, H, W, 3)).astype(np.float32)
    metas = [{"name": "a", "ori_size": [W, H]}, {"name": "b", "ori_size": [W - 16, H - 8]}]
    batch = {"image": x, "meta": metas}
    cfg = _cfg("hrnet18", jget_preset)
    JTester(cfg, jm, types.SimpleNamespace(**v)).test_offset([batch], str(tmp_path / "jax"))
    pm = _port("hrnet18", v)
    tester = Tester(_cfg("hrnet18"), pm, "cpu")
    assert tester.test_offset([batch], str(tmp_path / "port")) == 2
    assert tester.timing["images"] == 2 and pm.training

    with torch.no_grad():
        logits = pm.eval()(torch.from_numpy(x))
    for i, meta in enumerate(metas):
        want = np.load(tmp_path / "jax" / "offset" / f"{meta['name']}.npz")
        got = np.load(tmp_path / "port" / "offset" / f"{meta['name']}.npz")
        assert set(got.files) == set(want.files) == {"mask", "dir_label"}
        for k, out_key in (("mask", "mask"), ("dir_label", "dir")):
            assert got[k].dtype == np.uint8 and got[k].shape == (meta["ori_size"][1],
                                                                 meta["ori_size"][0])
            top2 = torch.topk(logits[out_key][i], 2, dim=-1).values
            assert float((top2[..., 0] - top2[..., 1]).min()) > 0  # no tie at stride 4
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{meta['name']} {k}")
        assert len(np.unique(got["dir_label"])) > 1


def _reference_pth(model, path):
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, path)


def test_reference_pth_loads_strictly_and_full_width_leaves(nets, tmp_path):
    """A SegFix_HRNet-layout ``.pth`` of each shallow backbone (the
    ``module.`` prefix, ``{"state_dict"}``) through ``network.pretrained``,
    bit for bit, and through the JAX importer (``segfix`` and
    ``segfix_next`` mappers), every leaf used; then the full-width leaves."""
    for arch, mapper in zip(ARCHS, ("segfix", "segfix_next")):
        source = build_model(_cfg(arch))
        g = torch.Generator().manual_seed(11)
        init_weights(source, g)
        with torch.no_grad():
            for m in source.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
        path = tmp_path / f"{arch}.pth"
        _reference_pth(source, path)
        cfg = _cfg(arch)
        state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=str(path))
        got = state.model.state_dict()
        for k, val in source.state_dict().items():
            assert torch.equal(got[k], val), k
        jvars, report = ti.convert_state_dict(
            nets[arch][1], {k: val.numpy() for k, val in source.state_dict().items()}, mapper)
        assert report["unused"] == [] and report["missing"] == []
        key = segfix_next_key if mapper == "segfix_next" else segfix_key
        for col in ("params", "batch_stats"):
            for p, arr in flatten(jvars[col]).items():
                np.testing.assert_array_equal(_as_port(arr), got[key(p)].numpy())
    assert ti.mapper_for_model("segfix_hrnet") == "segfix"

    from contrastiveseg_tpu.models.nets import HRNetSeg as JHRNetSeg

    from contrastiveseg_tpu_torch.models.nets import HRNetSeg

    # segfix_hrnet on the full hrnet2x20, and HRNetSeg on the shallow one
    # (the registry's hrnet2x20 net is HRNetSeg on the full backbone).
    cfg = get_preset("cityscapes_segfix_hrnet2x")
    for jmodel, make, key in (
            (jbuild_model(jget_preset("cityscapes_segfix_hrnet2x")),
             lambda: build_model(cfg), segfix_next_key),
            (JHRNetSeg(19, "hrnet2x20_shallow"),
             lambda: HRNetSeg(19, "hrnet2x20_shallow", with_proj=False),
             lambda p: hrnet_seg_key(p, next_arch=True))):
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            jnp.zeros((1, 64, 64, 3)), train=True))
        with torch.device("meta"):
            pm = make()
        probe = ("backbone", "stage4_module0", "branch4_block0", "conv1", "conv", "kernel")
        assert key_for(pm)(probe) == key(probe)
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
    with torch.device("meta"):
        pm = build_model(get_preset("cityscapes_hrnet_w48").updated(
            "network.model_name", "hrnet2x20"))
    assert isinstance(pm, HRNetSeg) and isinstance(pm.backbone, HRNetNext)
