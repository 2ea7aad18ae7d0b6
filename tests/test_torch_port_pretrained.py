"""``network.pretrained`` on the port against the JAX package's import route.

The ``.pth`` files are written here from a port hrnet18 (shallow:
``torch_port_helpers.shallow_hrnet18``) with seeded random weights (nothing
is downloaded), in the reference's layouts:

* an ImageNet backbone (``hrnetv2_w48_imagenet_pretrained.pth``): backbone
  keys without ``backbone.``, plus classification-head tensors that the
  load drops;
* an ``HRNet_W48_MEM`` segmentor: ``encoder_q.``-prefixed keys plus the four
  queue buffers, which seed the bank;
* a raw state_dict, ``{"state_dict": ...}``, ``{"model": ...}``, and keys
  under the DDP ``module.`` prefix.

The JAX route is ``tools/import_torch_ckpt.load_torch_state`` (imported by
path), its ImageNet filter, then ``utils/torch_import.convert_state_dict``
with ``mapper_for_model``, and ``extract_memory_queues`` for the queues.
Loaded tensors are compared bit for bit; the ImageNet-initialised forward
(same heads on both sides, JAX jitted under ``exact_fp32_reference``) at
atol 1e-3 / rtol 1e-3, as in the model test.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.engine.state import create_train_state, init_weights
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils import pretrained as tp
from contrastiveseg_tpu_torch.utils.jax_weights import flatten, hrnet_seg_key

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
)

H, W, B, C = 64, 64, 2, 19
MEM = {"network.model_name": "hrnet_w18_mem", "contrast.memory_size": 6,
       "contrast.proj_dim": 16}
_TOOL = Path(__file__).resolve().parent.parent / "tools" / "import_torch_ckpt.py"


@pytest.fixture(scope="module", autouse=True)
def _shallow_one_thread():
    """The shallow hrnet18 in both packages (the files' layouts do not
    depend on the depth), and torch on one thread."""
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    with one_torch_thread():
        yield
    mp.undo()


@pytest.fixture(scope="module")
def jax_models():
    """The JAX mem and plain hrnet18 and numpy variables in their shape: one
    ``jax.eval_shape`` of the mem net's init; the plain net's variables are
    the same less the projection head."""
    mem = jbuild_model(_config("cityscapes_hrnet_w48_mem", jget_preset, **MEM))
    variables = random_variables(mem, (1, H, W, 3), seed=4)
    plain = {col: {k: v for k, v in tree.items() if k != "proj_head"}
             for col, tree in variables.items()}
    return {"mem": (mem, variables),
            "plain": (jbuild_model(_config("cityscapes_hrnet_w48", jget_preset)), plain)}


def _import_tool():
    spec = importlib.util.spec_from_file_location("import_torch_ckpt", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(preset, get=get_preset, **extra):
    cfg = get(preset).updated("network.model_name", "hrnet_w18").updated(
        "network.head_dropout", 0.0)
    for k, v in extra.items():
        cfg = cfg.updated(k, v)
    return cfg


def _source_model(cfg, seed):
    """A port model with seeded random weights and BN statistics."""
    model = build_model(cfg)
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.weight, m.bias, m.running_mean):
                    t.copy_(0.1 * torch.randn(t.shape, generator=g) + (t is m.weight))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.num_batches_tracked.fill_(7)
    return model


def _imagenet_sd(model) -> dict:
    sd = {k.removeprefix("backbone."): v.clone() for k, v in model.state_dict().items()
          if k.startswith("backbone.")}
    sd.update({"incre_modules.0.0.conv1.weight": torch.ones(4, 3, 1, 1),
               "downsamp_modules.0.0.weight": torch.ones(2),
               "final_layer.0.weight": torch.ones(3),
               "classifier.weight": torch.ones(1000, 2048),
               "fc.bias": torch.ones(5)})
    return sd


def _queues(seed=1, C=C, M=6, D=16) -> dict:
    g = torch.Generator().manual_seed(seed)

    def q():
        x = torch.randn((C, M, D), generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    return {"segment_queue": q(), "segment_queue_ptr": torch.randint(0, M, (C,), generator=g),
            "pixel_queue": q(), "pixel_queue_ptr": torch.randint(0, M, (C,), generator=g)}


def _save(path, sd, layout="raw"):
    blob = {"raw": sd, "state_dict": {"state_dict": sd, "config_dict": {"epoch": 3}},
            "model": {"model": sd, "iters": 10},
            "module": {f"module.{k}": v for k, v in sd.items()}}[layout]
    torch.save(blob, path)
    return str(path)


def _assert_loaded(model, sd):
    got = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    cfg = _config("cityscapes_hrnet_w48")
    source = _source_model(cfg, seed=3)
    path = _save(tmp_path_factory.mktemp("pth") / "imagenet.pth", _imagenet_sd(source))
    return cfg, source, path


def test_imagenet_load_matches_the_jax_import_route(imagenet, jax_models):
    """Backbone tensors bit for bit, heads at their init, BN counters from
    the file; the JAX route fills the same leaves with the same values, and
    the two models give the same forward once their heads agree."""
    cfg, source, path = imagenet
    state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=path)
    model = state.model
    _assert_loaded(model, {k: v for k, v in source.state_dict().items()
                           if k.startswith("backbone.")})
    fresh = create_train_state(cfg, build_model(cfg), "cpu").model.state_dict()
    for k, v in model.state_dict().items():
        if k.startswith("cls_head."):
            assert torch.equal(v, fresh[k]), k  # kept at the seeded init

    tool = _import_tool()
    sd = tool.load_torch_state(path)
    sd = {f"backbone.{k}": v for k, v in sd.items()
          if not k.startswith(tool._IMAGENET_HEAD_PREFIXES)}
    jmodel, variables = jax_models["plain"]
    mp = pytest.MonkeyPatch()
    exact_fp32_reference(mp, compiled_blocks=False)
    try:
        variables, report = ti.convert_state_dict(
            variables, sd, ti.mapper_for_model("hrnet_w18"), strict=True)
        assert report["unused"] == []
        assert report["missing"] and all(m.startswith(("params/cls_head", "cls_head"))
                                         for m in report["missing"])
        port_sd = model.state_dict()
        for col in ("params", "batch_stats"):
            tree = flatten(variables[col])
            for p, arr in tree.items():
                key = hrnet_seg_key(p)
                t = port_sd[key].numpy()
                if t.ndim == 4:
                    t = np.transpose(t, (2, 3, 1, 0))
                if key.startswith("backbone."):
                    np.testing.assert_array_equal(arr, t, err_msg=key)
                else:
                    _set(variables[col], p, t)  # same heads on both sides
        x = np.random.default_rng(0).standard_normal((B, H, W, 3)).astype(np.float32)
        with shared_jax_compiles():
            out, _ = jax.jit(lambda v, x: jmodel.apply(
                v, x, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(0)}))(variables, jnp.asarray(x))
            want = np.asarray(out["seg"])
    finally:
        mp.undo()
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))["seg"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def test_imagenet_file_starts_every_cityscapes_hrnet_preset(imagenet):
    """The backbone keys are shared, so the plain, contrast and mem presets
    all load an ImageNet file; only the backbone comes from it."""
    _, source, path = imagenet
    want = {k: v for k, v in source.state_dict().items() if k.startswith("backbone.")}
    for preset, name in (("cityscapes_hrnet_w48_contrast", "hrnet_w18_contrast"),
                         ("cityscapes_hrnet_w48_mem", "hrnet_w18_mem")):
        cfg = _config(preset, **{"network.model_name": name, "contrast.memory_size": 6,
                                 "contrast.proj_dim": 16})
        state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=path)
        _assert_loaded(state.model, want)
        assert (state.bank is not None) == (preset == "cityscapes_hrnet_w48_mem")


def test_mem_checkpoint_seeds_the_bank_like_extract_memory_queues(tmp_path, jax_models):
    cfg = _config("cityscapes_hrnet_w48_mem", **MEM)
    source = _source_model(cfg, seed=5)
    queues = _queues()
    sd = {f"encoder_q.{k}": v for k, v in source.state_dict().items()}
    path = _save(tmp_path / "mem.pth", {**sd, **queues}, "state_dict")
    state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=path)
    _assert_loaded(state.model, source.state_dict())

    jsd = _import_tool().load_torch_state(path)
    jq = ti.extract_memory_queues(jsd)
    bank = state.bank
    np.testing.assert_array_equal(bank.segment_queue.numpy(), jq["segment_queue"])
    np.testing.assert_array_equal(bank.pixel_queue.numpy(), jq["pixel_queue"])
    np.testing.assert_array_equal(bank.segment_ptr.numpy(), jq["segment_ptr"])
    np.testing.assert_array_equal(bank.pixel_ptr.numpy(), jq["pixel_ptr"])
    assert bank.segment_ptr.dtype == torch.int32
    # What is left of the file after the queues maps onto the JAX model, none unused.
    _, report = ti.convert_state_dict(jax_models["mem"][1], jsd, ti.mapper_for_model("hrnet_w18_mem"))
    assert report["unused"] == [] and report["missing"] == []


@pytest.mark.parametrize("layout", ["raw", "state_dict", "model", "module"])
def test_checkpoint_layouts(layout, tmp_path):
    cfg = _config("cityscapes_hrnet_w48_contrast",
                  **{"network.model_name": "hrnet_w18_contrast", "contrast.proj_dim": 16})
    source = _source_model(cfg, seed=6)
    path = _save(tmp_path / f"{layout}.pth", source.state_dict(), layout)
    got = tp.load_torch_state(path)
    want = _import_tool().load_torch_state(path)
    assert got.keys() == want.keys() == source.state_dict().keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=path)
    _assert_loaded(state.model, source.state_dict())


def test_reference_cls_head_bias_folds_into_the_bn_mean(tmp_path, jax_models):
    """The reference cls head's 3x3 conv has a bias (the port's has not);
    the load folds it into the BN running mean, as the JAX importer does."""
    cfg = _config("cityscapes_hrnet_w48")
    source = _source_model(cfg, seed=7)
    sd = dict(source.state_dict())
    bias = torch.linspace(-1, 1, sd["cls_head.1.0.running_mean"].numel())
    sd["cls_head.0.bias"] = bias
    path = _save(tmp_path / "seg.pth", sd)
    state = create_train_state(cfg, build_model(cfg), "cpu", pretrained=path)
    got = state.model.state_dict()["cls_head.1.0.running_mean"]
    torch.testing.assert_close(got, source.state_dict()["cls_head.1.0.running_mean"] - bias,
                               rtol=0, atol=0)
    jvars, _ = ti.convert_state_dict(jax_models["plain"][1],
                                     {k: v.numpy() for k, v in sd.items()}, "hrnet_seg")
    np.testing.assert_array_equal(jvars["batch_stats"]["cls_head"]["conv"]["norm"]["bn"]["mean"],
                                  got.numpy())


def _refused(cfg, path, match):
    with pytest.raises(ValueError, match=match):
        create_train_state(cfg, build_model(cfg), "cpu", pretrained=path)


def test_refuses_a_missing_backbone_key(imagenet, tmp_path):
    cfg, source, _ = imagenet
    sd = _imagenet_sd(source)
    del sd["stage2.0.branches.0.0.conv1.weight"]
    _refused(cfg, _save(tmp_path / "m.pth", sd),
             r"missing \['backbone.stage2.0.branches.0.0.conv1.weight'\]")


def test_refuses_a_leftover_key(tmp_path):
    cfg = _config("cityscapes_hrnet_w48")
    sd = dict(_source_model(cfg, seed=8).state_dict())
    sd["aux_head.weight"] = torch.zeros(3)
    _refused(cfg, _save(tmp_path / "l.pth", sd), r"left over \['aux_head.weight'\]")
    # A contrast segmentor's projection head has no place in the plain net.
    ccfg = _config("cityscapes_hrnet_w48_contrast",
                   **{"network.model_name": "hrnet_w18_contrast", "contrast.proj_dim": 16})
    _refused(cfg, _save(tmp_path / "c.pth", _source_model(ccfg, seed=8).state_dict()),
             r"left over \['proj_head")


def test_refuses_queues_without_memory_and_half_a_queue_set(tmp_path):
    cfg = _config("cityscapes_hrnet_w48_mem", **MEM)
    sd = {f"encoder_q.{k}": v for k, v in _source_model(cfg, seed=9).state_dict().items()}
    queues = _queues()
    no_memory = cfg.updated("contrast.with_memory", False).updated(
        "network.model_name", "hrnet_w18_contrast")
    _refused(no_memory, _save(tmp_path / "q.pth", {**sd, **queues}), "with_memory=false")
    half = {k: queues[k] for k in ("segment_queue", "segment_queue_ptr")}
    _refused(cfg, _save(tmp_path / "h.pth", {**sd, **half}), "all four or none")
    small = {**queues, "pixel_queue": queues["pixel_queue"][:, :3]}
    _refused(cfg, _save(tmp_path / "s.pth", {**sd, **small}), "pixel_queue has shape")


def test_trainer_reads_pretrained_and_resume_wins(imagenet, tmp_path):
    cfg, source, path = imagenet
    cfg = cfg.updated("network.pretrained", path).updated(
        "checkpoints.checkpoints_dir", str(tmp_path))
    want = {k: v for k, v in source.state_dict().items() if k.startswith("backbone.")}
    trainer = Trainer(cfg, "cpu")
    _assert_loaded(trainer.state.model, want)
    # A checkpoint of other weights: resuming restores it, not the .pth.
    other = create_train_state(cfg.updated("seed", 11), build_model(cfg), "cpu")
    other.step = 4
    trainer.ckpt.save(other, "latest")
    resumed = Trainer(cfg.updated("network.resume_continue", True), "cpu")
    assert resumed.state.step == 4
    _assert_loaded(resumed.state.model, other.model.state_dict())
