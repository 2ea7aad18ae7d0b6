"""The headline's sibling presets on the port against the JAX package.

``cityscapes_hrnet_w48`` (the plain net, CE only) and
``cityscapes_hrnet_w48_contrast`` (CE plus the InfoNCE of the anchors
against each other, no bank), cut to a shallow hrnet18
(``torch_port_helpers.shallow_hrnet18``: the W18 widths and every fuse, one
block a stage) with the presets' 19 classes, on batch 2 of 64x64 synthetic scenes, the size of
``tests/test_torch_port_slice.py``.  Dropout is 0 and sampling exact.  The
contrast term is live from step 0 (``contrast.warmup_iters=0``), and
``contrast.max_views`` is 12 instead of 100: a class qualifies for anchors
with more than ``max_views`` pixels of an image on the stride-4 grid, and
the 16x16 grid of a 64x64 crop gives no class 100 (the classes here have
0-33 each, so some qualify and some do not).  The JAX step and forward are
jitted whole and compiled unoptimized (``unoptimized_jax_compiles``) under
``exact_fp32_reference``; both packages start from the same numpy weights
and get the same anchor draws.

Tolerances: the plain model's forward atol 1e-3 / rtol 1e-3; losses rtol
1e-4 and post-step parameters atol 5e-4, as in the slice test; each
tensor's update (new - old) within 0.1 of the JAX update in relative norm.
The slice test bounds that last one by 4e-2 at 5 classes.  At 19 classes
the BN backward of a randomly initialised HRNet cancels more of each weight
gradient: against an fp64 run of the port, the contrast step's fp32 updates
are off by up to 3.3e-2 to 3.5e-2 (the port, on 1 and 8 torch threads) and
3.1e-2 (the JAX step) in relative norm on the worst tensors (BN biases),
and the two fp32 steps differ by up to 4.1e-2 (readings on the whole
hrnet18).  On the shallow net the updates differ by up to 2.7e-4 and the
forward by 1.2e-5 of its largest value 3.1.  A wrong term in the update
moves it to order 1.

Also: a save/resume round trip of the plain preset's state, and the
trainer training the plain preset for 2 steps from a Cityscapes-layout
tree (``torch_port_helpers.write_tree``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.data.datasets import SyntheticSegDataset as JSynthetic
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.checkpoint import CheckpointManager
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import HRNetSeg, build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import (
    flatten,
    hrnet_seg_key,
    load_jax_variables,
)

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    tiny_hrnet,
    unoptimized_jax_compiles,
    write_tree,
)

H, W, B, C = 64, 64, 2, 19
PRESETS = {"cityscapes_hrnet_w48": "hrnet_w18",
           "cityscapes_hrnet_w48_contrast": "hrnet_w18_contrast"}
OVERRIDES = {"network.head_dropout": 0.0, "contrast.exact_sampling": True,
             "contrast.warmup_iters": 0, "contrast.max_views": 12}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The checks hold on 1 and 8 torch threads; one thread keeps the
    workers of a parallel run from oversubscribing the cores."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module", autouse=True)
def _shallow():
    """Both packages build hrnet18 as ``shallow_hrnet18`` for the module."""
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    yield
    mp.undo()


def _config(preset, get=get_preset):
    cfg = get(preset).updated("network.model_name", PRESETS[preset])
    for k, v in OVERRIDES.items():
        cfg = cfg.updated(k, v)
    return cfg


def _batch(cfg):
    ds = SyntheticSegDataset(num_classes=C, size_hw=(H, W), length=8)
    samples = [ds[i] for i in range(B)]
    jds = JSynthetic(num_classes=C, size_hw=(H, W), length=8)
    for i, s in enumerate(samples):  # the port's scenes are the JAX package's
        np.testing.assert_array_equal(s["label"], jds[i]["label"])
    n = cfg.get("normalize")
    norm = Normalizer(n["div_value"], n["mean_value"], n["std"])
    return {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
            "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}


@pytest.fixture(scope="module")
def jax_runs():
    """Per preset: the numpy weights, the batch, the JAX step's new state,
    metrics and anchor draws; and the JAX plain model's train-mode forward.
    Each JAX program is jitted whole and compiled unoptimized."""
    mp = pytest.MonkeyPatch()
    exact_fp32_reference(mp, compiled_blocks=False)
    runs = {}
    try:
        # One eval_shape: the plain net's variables are the contrast net's
        # less the projection head.
        full = random_variables(jbuild_model(_config("cityscapes_hrnet_w48_contrast",
                                                     jget_preset)), (1, H, W, 3), seed=2)
        with shared_jax_compiles(), unoptimized_jax_compiles():
            for preset in PRESETS:
                cfg = _config(preset, jget_preset)
                batch = _batch(cfg)
                jmodel = jbuild_model(cfg)
                variables = full if jmodel.with_proj else {
                    col: {k: v for k, v in tree.items() if k != "proj_head"}
                    for col, tree in full.items()}
                jbatch = {"image": jnp.asarray(batch["image"].numpy()),
                          "label": jnp.asarray(batch["label"].numpy().astype(np.int32))}
                tx = jbuild_optimizer(cfg, variables["params"])
                rng = jax.random.key(7)
                s0 = JTrainState(
                    step=jnp.zeros((), jnp.int32), params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), bank=None, rng=rng, tx=tx)
                jstep = jmake_train_step(jmodel, jbuild_loss(cfg), warmup_iters=0,
                                         network_stride=4, donate=False,
                                         exact_sampling=True)
                s1, metrics = jstep(s0, jbatch)
                if preset == "cityscapes_hrnet_w48":
                    seg = jax.jit(lambda v, x: jmodel.apply(
                        v, x, train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.key(0)})[0]["seg"])(
                            variables, jbatch["image"])
                    runs["forward"] = (variables, batch, np.asarray(seg))
                _, _, r_sample, _ = jax.random.split(rng, 4)
                khard, keasy = jax.random.split(r_sample)
                n = (H // 4) * (W // 4)
                draws = Draws(anchor=AnchorScores(*(
                    torch.from_numpy(np.array(jax.random.uniform(k, (B, C, n))))
                    for k in (khard, keasy))))
                runs[preset] = (variables, batch, flatten(s1.params),
                                {k: float(v) for k, v in metrics.items()}, draws)
    finally:
        mp.undo()
    return runs


def test_plain_model_forward_matches_jax(jax_runs):
    variables, batch, want = jax_runs["forward"]
    model = HRNetSeg(C, "hrnet18", head_dropout=0.0, with_proj=False)
    load_jax_variables(model, variables)
    assert not any(k.startswith("proj_head") for k in model.state_dict())
    with torch.no_grad():
        out = model.train()(batch["image"])
    assert set(out) == {"seg"} and out["seg"].shape == (B, H, W, C)  # upsampled inside
    np.testing.assert_allclose(out["seg"].numpy(), want, atol=1e-3, rtol=1e-3)


def test_build_model_has_the_plain_nets():
    cfg = get_preset("cityscapes_hrnet_w48")
    for w in (18, 32, 48, 64):
        model = build_model(cfg.updated("network.model_name", f"hrnet_w{w}"))
        assert model.proj_head is None
    contrast = build_model(cfg.updated("network.model_name", "hrnet_w18_contrast"))
    plain = build_model(cfg.updated("network.model_name", "hrnet_w18"))
    assert {k: v.shape for k, v in plain.state_dict().items()} == {
        k: v.shape for k, v in contrast.state_dict().items()
        if not k.startswith("proj_head.")}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_one_train_step_matches_jax(preset, jax_runs):
    variables, batch, after, jmetrics, draws = jax_runs[preset]
    cfg = _config(preset)
    model = build_model(cfg)
    state = create_train_state(cfg, model, "cpu")
    assert state.bank is None
    load_jax_variables(state.model, variables)
    step = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4)
    metrics = step(state, batch, draws)

    assert state.step == 1 and state.bank is None
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-4, err_msg=k)
    if preset == "cityscapes_hrnet_w48_contrast":
        assert jmetrics["loss_contrast"] > 0

    sd = state.model.state_dict()
    before = flatten(variables["params"])
    assert after.keys() == before.keys()
    update_err = {}
    for path, want in after.items():
        key = hrnet_seg_key(path)
        got = sd[key].numpy()
        if got.ndim == 4:
            got = np.transpose(got, (2, 3, 1, 0))
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=key)
        d_want, d_got = want - before[path], got - before[path]
        update_err[key] = float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))
    worst = max(update_err, key=update_err.get)
    assert update_err[worst] < 0.1, (worst, sorted(update_err.values())[-5:])
    if preset == "cityscapes_hrnet_w48_contrast":
        # Only the contrast term reaches the projection head: its update is
        # more than weight decay.
        w0 = before[("proj_head", "fc2", "kernel")]
        d = after[("proj_head", "fc2", "kernel")] - w0
        decay = -cfg.get("lr.base_lr") * cfg.get("optim.sgd.weight_decay") * w0
        assert np.linalg.norm(d - decay) > 0.5 * np.linalg.norm(d)


def test_plain_state_round_trips_a_checkpoint(tmp_path):
    cfg = _config("cityscapes_hrnet_w48")
    state = create_train_state(cfg, build_model(cfg), "cpu")
    step = make_train_step(build_loss(cfg))
    step(state, _batch(cfg))
    ckpt = CheckpointManager(str(tmp_path), "plain")
    ckpt.save(state, "latest")
    fresh = create_train_state(cfg.updated("seed", 5), build_model(cfg), "cpu")
    ckpt.restore(fresh)
    assert fresh.step == 1 and fresh.bank is None
    for (ka, a), (kb, b) in zip(state.model.state_dict().items(),
                                fresh.model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())
    for pa, pb in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(state.optimizer.state[pa]["momentum_buffer"],
                           fresh.optimizer.state[pb]["momentum_buffer"])
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]


def test_trainer_trains_the_plain_preset_from_a_directory(tmp_path, monkeypatch):
    tiny_hrnet(monkeypatch)  # the port against itself: hrnet18's topology, tiny widths
    tree = write_tree(tmp_path / "cityscapes", n_train=4, n_val=2)
    cfg = _config("cityscapes_hrnet_w48")
    for k, v in {"data.synthetic": False, "data.data_dir": str(tree),
                 "train.batch_size": 2, "val.batch_size": 2,
                 "train.data_transformer.input_size": [64, 64],
                 "train_trans.random_crop.crop_size": [64, 64],
                 "val.data_transformer.input_size": [192, 96],
                 "solver.max_iters": 2, "solver.test_interval": 2, "solver.display_iter": 1,
                 "checkpoints.save_iters": 0,
                 "checkpoints.checkpoints_dir": str(tmp_path / "ckpt")}.items():
        cfg = cfg.updated(k, v)
    trainer = Trainer(cfg, "cpu")
    history = trainer.train()
    assert len(history) == 2 and trainer.state.step == 2 and trainer.state.bank is None
    for row in history:
        assert set(row) >= {"loss", "loss_seg"} and "loss_contrast" not in row
        assert np.isfinite(row["loss"]) and row["loss"] > 0
    assert 0.0 <= trainer.last_scores["miou"] <= 1.0
    resumed = Trainer(cfg.updated("network.resume_continue", True), "cpu")
    assert resumed.state.step == 2
    for a, b in zip(trainer.state.model.state_dict().values(),
                    resumed.state.model.state_dict().values()):
        assert torch.equal(a, b)
