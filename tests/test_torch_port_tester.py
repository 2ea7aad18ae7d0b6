"""The port's ``Tester`` (``engine/tester.py``) and ``--phase val|test``
against the JAX package.

* Every mode on a one-conv model on both sides (the JAX ``TinySeg`` of
  ``tests/test_tester.py``; its weights carried across): ``ss_test`` at
  scales 1.0 and 0.75, ``ms_test`` with and without ``test.scale_weights``,
  ``sscrop_test`` and ``mscrop_test``, ``ms_test_depth`` without a stereo
  PNG, with one at the image's size and with one at another size (PIL's
  nearest resize, emulated by the port); ``_decide_intersection`` over a
  sweep of sizes.  Tolerance: 1e-5 abs, fp32.
* ``Tester.test``: the same ``label/``, ``vis/`` and ``gt_vis/`` pixels (each
  file read through PIL) and ``_prob.npy`` values (1e-5 abs).
* The slice: ``ss_test`` of hrnet18 with weights converted from the JAX
  model's, at ``tests/test_torch_port_eval.py``'s input shape (no new JAX
  HRNet program), flag off and on (K2's plain version on the CPU), against
  JAX's; tolerance 1e-3 abs and rel, as the model test's (fp32 through ~100
  convolutions).
* ``tools/train_torch.py --phase val`` and ``--phase test --device cpu``
  from a checkpoint on ``torch_port_helpers.write_tree``'s tree (the tiny
  HRNet of ``torch_port_helpers.tiny_hrnet``): the scores, confusion and
  PNGs of the checkpoint's model.
* Refusals: ``crf_ss_test`` and an unknown mode; ``--phase test`` of a
  SegFix net writes its offsets.
"""

from __future__ import annotations

import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from contrastiveseg_tpu.engine.tester import Tester as JTester
from contrastiveseg_tpu.engine.tester import _decide_intersection as j_decide
from contrastiveseg_tpu.models.nets import HRNetSeg as JHRNetSeg
from contrastiveseg_tpu.utils.config import Config as JConfig
from contrastiveseg_tpu_torch.engine import tester as ptester
from contrastiveseg_tpu_torch.models.nets import HRNetSeg
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.config import Config
from contrastiveseg_tpu_torch.utils.jax_weights import hrnet_seg_key, load_jax_variables
from contrastiveseg_tpu_torch.utils.png import encode_png

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    tiny_hrnet,
    write_tree,
)

C = 4
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


class JTinySeg(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x, train=False):
        return {"seg": flax_nn.Conv(C, (3, 3), padding=1, name="cls")(x)}


class TinySeg(torch.nn.Module):
    """The same one-conv model, NHWC in and out."""

    def __init__(self):
        super().__init__()
        self.cls = torch.nn.Conv2d(3, C, 3, padding=1)

    def forward(self, x):
        return {"seg": self.cls(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)}


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    kernel = (rng.standard_normal((3, 3, 3, C)) / np.sqrt(27)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return kernel, bias


@pytest.fixture(scope="module")
def jax_tester(weights):
    """One JAX Tester for the module: its jitted forward compiles once a
    shape; each test gives it its own config (the Tester reads it per call)."""
    kernel, bias = weights
    return JTester(JConfig.from_args(overrides=[f"data.num_classes={C}"]), JTinySeg(),
                   types.SimpleNamespace(params={"cls": {"kernel": jnp.asarray(kernel),
                                                         "bias": jnp.asarray(bias)}},
                                         batch_stats={}))


@pytest.fixture
def testers(weights, jax_tester):
    """``make(**overrides)`` -> (the JAX Tester, a port Tester) on the same
    weights and config."""
    kernel, bias = weights

    def make(**over):
        cfg = [f"data.num_classes={C}"] + [f"{k}={v!r}" for k, v in over.items()]
        jax_tester.cfg = JConfig.from_args(overrides=cfg)
        model = TinySeg()
        with torch.no_grad():
            model.cls.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
            model.cls.bias.copy_(torch.from_numpy(bias))
        return jax_tester, ptester.Tester(Config.from_args(overrides=cfg), model)

    return make


def _images(b=1, h=16, w=32, seed=0):
    return np.random.default_rng(seed).standard_normal((b, h, w, 3), dtype=np.float32)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_ss_test_matches_jax(testers, scale):
    jt, pt = testers()
    x = _images(2)
    got = pt.ss_test(torch.from_numpy(x), scale)
    assert got.shape == (2, 16, 32, C)
    _close(got, jt.ss_test(jnp.asarray(x), scale))


@pytest.mark.parametrize("scale_weights", [None, [0.5, 1.0, 2.0]])
def test_ms_test_matches_jax(testers, scale_weights):
    over = {"test.scale_weights": scale_weights} if scale_weights else {}
    jt, pt = testers(**over)
    x = _images()
    _close(pt.ms_test(torch.from_numpy(x)), jt.ms_test(jnp.asarray(x)))


@pytest.mark.parametrize("mode", ["sscrop_test", "mscrop_test"])
def test_crop_modes_match_jax(testers, mode):
    """Crop (h, w) = (10, 12) over 16x32: a last window flush with each edge
    and overlapping counts; through ``infer`` and ``test.crop_size`` [w, h]."""
    jt, pt = testers(**{"test.mode": mode, "test.crop_size": [12, 10]})
    x = _images(seed=1)
    got = pt.infer(torch.from_numpy(x))
    assert got.shape == (1, 16, 32, C)
    _close(got, jt.infer(jnp.asarray(x)))


@pytest.mark.parametrize("stereo", ["none", "same_size", "other_size"])
def test_ms_test_depth_matches_jax(testers, tmp_path, stereo):
    jt, pt = testers(**{"test.mode": "ms_test_depth", "test.stereo_path": str(tmp_path)})
    if stereo != "none":
        hw = (16, 32) if stereo == "same_size" else (11, 21)
        raw = np.random.default_rng(1).integers(256, 60000, hw).astype(np.uint16)
        Image.fromarray(raw).save(tmp_path / "frame.png")
    x = _images(seed=2)
    metas = [{"name": "frame"}]
    got = pt.infer(torch.from_numpy(x), metas)
    _close(got, jt.infer(jnp.asarray(x), metas))
    if stereo != "none":  # the depth weights did something
        assert not np.allclose(got.numpy(), pt.ms_test(torch.from_numpy(x)).numpy(), atol=1e-4)


def test_pil_nearest_matches_pil():
    rng = np.random.default_rng(3)
    for h_in, w_in, h, w in ((11, 21, 16, 32), (16, 32, 11, 21), (7, 4, 5, 7), (3, 2, 23, 7)):
        a = rng.integers(0, 6, (h_in, w_in)).astype(np.float64)
        want = np.asarray(Image.fromarray(a).resize((w, h), Image.NEAREST))
        got = ptester._pil_nearest(a, (h, w))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_decide_intersection_matches_jax():
    for total in range(1, 70):
        for crop in range(1, total + 1):
            assert ptester._decide_intersection(total, crop) == j_decide(total, crop)


def test_test_writes_what_jax_writes(testers, tmp_path):
    """label/ (raw ids through data.label_list), vis/, gt_vis/ and _prob.npy;
    the second image's ori_size differs from its input, so its logits are
    resized first."""
    over = {"test.save_gt_label": True, "dataset": "cityscapes",
            "data.label_list": [7, 8, 11, 12]}
    jt, pt = testers(**over)
    rng = np.random.default_rng(4)
    batch = {"image": _images(2, seed=3),
             "label": rng.integers(-1, C, (2, 16, 32)).astype(np.int32),
             "meta": [{"ori_size": (32, 16), "name": "a"}, {"ori_size": (20, 10), "name": "b"}]}
    assert pt.test([batch], str(tmp_path / "port"), save_prob=True) == 2
    assert jt.test([batch], str(tmp_path / "jax"), save_prob=True) == 2
    assert pt.timing["images"] == 2 and pt.timing["seconds"] >= pt.timing["infer_seconds"] > 0
    for name in ("a", "b"):
        for sub in ("label", "vis", "gt_vis"):
            got = Image.open(tmp_path / "port" / sub / f"{name}.png")
            want = Image.open(tmp_path / "jax" / sub / f"{name}.png")
            assert got.mode == want.mode
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=sub)
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"{name}_prob.npy"),
                                   np.load(tmp_path / "jax" / f"{name}_prob.npy"), atol=ATOL)
    labels = np.asarray(Image.open(tmp_path / "port" / "label" / "b.png"))
    assert labels.shape == (10, 20) and set(np.unique(labels)) <= {7, 8, 11, 12}


# -- the slice: hrnet18 at the evaluator test's shape ----------------------
SHAPE = (2, 64, 64, 3)


@pytest.fixture(scope="module")
def hrnet():
    """JAX hrnet18 variables (numpy seed) with BN running statistics set to
    the images' batch statistics, so the eval forward is well conditioned
    (as in ``tests/test_torch_port_model.py``), and the images."""
    jm = JHRNetSeg(num_classes=5, arch="hrnet18", with_proj=True, head_dropout=0.0)
    variables = random_variables(jm, (1,) + SHAPE[1:], seed=1)
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    with one_torch_thread():
        pm = HRNetSeg(5, "hrnet18", head_dropout=0.0)
        load_jax_variables(pm, variables)
        for m in pm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = 1.0
        with torch.no_grad():
            pm.train()(torch.from_numpy(x))
    sd = pm.state_dict()

    def fill(tree, prefix=()):
        return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                else sd[hrnet_seg_key(prefix + (k,))].numpy() for k, v in tree.items()}

    return jm, {"params": variables["params"], "batch_stats": fill(variables["batch_stats"])}, x


@pytest.fixture(scope="module")
def jax_ss(hrnet):
    jm, variables, x = hrnet
    with pytest.MonkeyPatch.context() as mp:
        exact_fp32_reference(mp)
        state = types.SimpleNamespace(params=variables["params"],
                                      batch_stats=variables["batch_stats"])
        jt = JTester(JConfig.from_args(overrides=["data.num_classes=5"]), jm, state)
        with jax.disable_jit(), shared_jax_compiles():
            return np.asarray(jt.ss_test(jnp.asarray(x)))


@pytest.mark.parametrize("pallas_conv", [False, True])
def test_hrnet_ss_test_matches_jax(hrnet, jax_ss, pallas_conv):
    _, variables, x = hrnet
    pm = HRNetSeg(5, "hrnet18", head_dropout=0.0, pallas_conv=pallas_conv)
    load_jax_variables(pm, variables)
    pm.train()  # the tester runs it in eval mode and restores the mode
    got = ptester.Tester(Config.from_args(overrides=["data.num_classes=5"]), pm).ss_test(
        torch.from_numpy(x))
    assert pm.training and got.shape == (2, 64, 64, 5)
    np.testing.assert_allclose(got.numpy(), jax_ss, atol=1e-3, rtol=1e-3)


# -- the CLI: --phase val and --phase test ---------------------------------
def _cli_overrides(tree, tmp_path):
    return [
        "data.synthetic=False", f"data.data_dir={tree}", "data.label_list=[7,8,11,12,13]",
        "train.data_transformer.input_size=[64,64]", "train_trans.random_crop.crop_size=[64,64]",
        "val.data_transformer.input_size=[192,96]", "test.data_transformer.input_size=[192,96]",
        f"test.test_dir={tree / 'val' / 'image'}", f"checkpoints.checkpoints_dir={tmp_path}",
    ]


def test_phase_val_and_test_through_the_cli(tmp_path, capsys, monkeypatch):
    from tools import train_torch
    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    tiny_hrnet(monkeypatch)
    tree = write_tree(tmp_path / "cityscapes", n_train=2, n_val=2)
    over = _cli_overrides(tree, tmp_path / "ckpt")
    cfg = train_torch.build_config("smoke_hrnet_w18", None, over)
    trained = Trainer(cfg, "cpu")
    with torch.no_grad():  # weights off their init, so that resume shows
        for p in trained.state.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    path = trained.ckpt.save(trained.state, "latest")
    want_val = trained.validate()
    want_out = tmp_path / "want"
    ptester.Tester(cfg, trained.state.model).test(out_dir=str(want_out))

    base = ["--preset", "smoke_hrnet_w18", "--device", "cpu"] + over + [
        f"network.resume={path}"]
    out = train_torch.main(["--phase", "val"] + base)
    assert f"val mIoU: {want_val['miou']:.4f}" in capsys.readouterr().out
    assert out["scores"]["miou"] == want_val["miou"]
    np.testing.assert_array_equal(out["trainer"].evaluator.score.confusion,
                                  trained.evaluator.score.confusion)

    out = train_torch.main(["--phase", "test"] + base + [f"test.out_dir={tmp_path / 'got'}"])
    assert out["tester"].timing["images"] == 2
    for sub in ("label", "vis"):
        names = sorted(p.name for p in (want_out / sub).iterdir())
        assert names == ["f0.png", "f1.png"]
        for name in names:
            assert (tmp_path / "got" / sub / name).read_bytes() == (want_out / sub / name).read_bytes()


# -- refusals --------------------------------------------------------------
def test_refusals(tmp_path, monkeypatch):
    model = TinySeg()
    with pytest.raises(NotImplementedError, match="ROADMAP 8"):
        ptester.Tester(Config.from_args(overrides=["test.mode=crf_ss_test"]), model)
    with pytest.raises(NotImplementedError, match="nonsense"):
        ptester.Tester(Config.from_args(overrides=["test.mode=nonsense"]), model)
    from tools import train_torch

    # A SegFix net is no longer refused: --phase test runs test_offset and
    # writes the offsets (tests/test_torch_port_segfix.py holds them against JAX).
    tiny_hrnet(monkeypatch)
    tree = write_tree(tmp_path / "cityscapes", n_train=0, n_val=2)
    cfg = train_torch.build_config("smoke_hrnet_w18", None, _cli_overrides(tree, tmp_path) + [
        "network.model_name=segfix_hrnet", "network.backbone=hrnet18",
        f"test.out_dir={tmp_path / 'out'}"])
    out = train_torch.run(cfg, "test", "cpu")
    assert out["tester"].timing["images"] == 2
    for name in ("f0", "f1"):
        offsets = np.load(tmp_path / "out" / "offset" / f"{name}.npz")
        assert offsets["mask"].shape == offsets["dir_label"].shape == (96, 192)
        assert offsets["mask"].max() <= 1 and offsets["dir_label"].max() < 8
    # the writer refuses what is not a PNG mode, before any file is written
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2), np.int32))
