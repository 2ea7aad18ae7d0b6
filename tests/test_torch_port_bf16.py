"""``network.bf16`` of the port against the JAX package's ``dtype=bf16`` nets.

The JAX nets compute in bf16 with fp32 parameters and keep the class
logits, the embedding's normalisation, the products taken with
``preferred_element_type=jnp.float32`` (OCR, self-attention, criss-cross,
PVT attention, the oracle gather) and the SETR decoders in fp32; the port
runs the same nets under ``torch.autocast`` with those sites pinned to fp32
(``models/layers.bf16_compute``, ``full_precision``, ``fp32``).  Eval-mode
forwards of ``hrnet_w18_mem`` and ``hrnet_w18_ocr`` on a shallow hrnet18
(``torch_port_helpers.shallow_hrnet18``), ``deeplab_v3_contrast`` on a
shallow dilated ResNet (``torch_port_helpers.shallow_resnet``), and one net
of each other family: ``ccnet`` (the dilated-ResNet context nets),
``ideal_spatial_ocrnet`` with ground-truth labels (the oracle nets),
``hrnet_w48_isa`` and ``segfix_hrnet`` on the shallow hrnet18 (the HRNet
side nets), ``ce2p_asp_ocrnet``, ``setr_pup`` and ``semantic_fpn`` on small
ViT and PVT specs put into both packages' tables (patch 4, width 64, depth
2; PVT widths 16-64, one block a stage), and ``ms_ocr``; built through both
packages' ``build_model`` with ``network.bf16=true``, from the same numpy
weights, on 2 random 64x64 images; the JAX side jitted whole.

Tolerance: each output within 3e-2 of JAX's in relative L2 norm (bf16
keeps 8 bits, 3.9e-3 a rounding; the two runs round the convolutions'
outputs, the fuse upsamples and the BN inputs in different places; read:
1.1e-3 (MS-OCR's attention) to 9.7e-3 (SegFix's ``dir``), about what two
independent bf16 runs give).  Each port output is fp32 and at least 1e-4
(relative L2) from the same net's fp32 forward, so bf16 did run (read:
8.8e-4 to 1.1e-2).  A bf16 train step of
``hrnet_w18_mem`` gives a finite loss and keeps the parameters, their
gradients and the bank in fp32.

One bf16 train step of ``cityscapes_deeplab_v3_contrast`` (19 classes, 2
images of 65x65, ``max_views`` 6, contrast live from step 0) against the JAX
package's bf16 step from the same weights, batch and anchor draws, the JAX
gradients read off a plain ``optax.sgd(1.0)`` update.  The losses within
rtol 5e-3 (a bf16 rounding is 3.9e-3; read: 1.0e-3 to 1.3e-3).  The
gradients: a random-init net's bf16 gradients are far from its fp32 ones
in both packages (JAX's, each tensor against the port's fp32 gradient:
2.1e-3 for ``layer_dsn``'s bias to 1.2 in the backbone), because the BN
backward, which cancels about three digits of every gradient in fp32
(``tests/test_torch_port_deeplab.py``), runs through the bf16 activations
of flax's ``BatchNorm(dtype=bf16)`` (and of the port's autocast) and
cancels every digit that bf16 keeps.  So each tensor is held to JAX's own
bf16 error: the port's gradient within twice JAX's distance from the fp32
gradient, plus 2e-2 (relative norms; two independent roundings of one size
put the two bf16 runs sqrt(2) times that distance apart; read: at most 1.9
times on ``refine``'s biases, whose JAX error is 1.5e-2, and 0.66-1.2
times elsewhere); where JAX's error is under 5e-2 (the five tensors next to
the DSN and final logits) that is a bound of 2.4e-2 to 0.12 on a wrong
gradient's order-1 error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import key_for, load_jax_variables, to_port

from torch_port_helpers import (
    SHALLOW_RESNET,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shallow_resnet,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

B, H, W = 2, 64, 64
_CS, _HR18, _SMALL = "cityscapes_hrnet_w48", {"network.backbone": "hrnet18"}, {
    "train.data_transformer.input_size": [W, H]}
NETS = {"hrnet_w18_mem": ("smoke_hrnet_w18", {}),
        "hrnet_w18_ocr": ("cityscapes_hrnet_w48_ocr", {"network.model_name": "hrnet_w18_ocr"}),
        "deeplab_v3_contrast": ("cityscapes_deeplab_v3_contrast",
                                {"network.backbone": SHALLOW_RESNET}),
        "ccnet": (_CS, {"network.backbone": SHALLOW_RESNET}),
        "ideal_spatial_ocrnet": (_CS, {"network.backbone": SHALLOW_RESNET}),
        "hrnet_w48_isa": (_CS, _HR18),
        "segfix_hrnet": ("cityscapes_segfix_hrnet", _HR18),
        "ce2p_asp_ocrnet": ("lip_ce2p_ocrnet", {"network.backbone": SHALLOW_RESNET}),
        "setr_pup": (_CS, {"network.backbone": "vit_bf16test", **_SMALL}),
        "semantic_fpn": (_CS, {"network.backbone": "pvt_bf16test", **_SMALL}),
        "ms_ocr": (_CS, _HR18)}
LABELED = {"ideal_spatial_ocrnet"}  # forward(x, gt_labels): the ground-truth gather


@pytest.fixture(scope="module", autouse=True)
def _shallow_quick():
    import contrastiveseg_tpu.models.pvt as jpvt
    import contrastiveseg_tpu.models.vit as jvit

    from contrastiveseg_tpu_torch.models import pvt, vit

    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    shallow_resnet(mp)
    for mod in (jvit, vit):
        mp.setitem(mod.VIT_SPECS, "vit_bf16test", mod.ViTSpec(
            patch_size=4, embed_dim=64, depth=2, num_heads=4, hidden_dim=128,
            aux_layers=(1, 2)))
    for mod in (jpvt, pvt):
        mp.setitem(mod.PVT_SPECS, "pvt_bf16test", mod.PVTSpec(
            dims=(16, 32, 40, 64), depths=(1, 1, 1, 1), heads=(1, 2, 2, 4),
            mlp_ratios=(2.0, 2.0, 2.0, 2.0), abs_pos_embed=True))
    with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
        yield
    mp.undo()


def _cfg(get, name, bf16=True):
    preset, extra = NETS[name]
    cfg = get(preset)
    for k, v in {"network.model_name": name, **extra, "network.bf16": bf16}.items():
        cfg = cfg.updated(k, v)
    return cfg


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", list(NETS))
def test_bf16_forward_matches_jax(name):
    jmodel = jbuild_model(_cfg(jget_preset, name))
    assert jmodel.dtype == jax.numpy.bfloat16
    variables = random_variables(jmodel, (1, H, W, 3), seed=1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    kw = {"gt_labels": rng.integers(-1, 19, (B, H, W)).astype(np.int32)} if name in LABELED \
        else {}
    want = jax.jit(lambda v, x, kw: jmodel.apply(v, x, train=False, **kw))(variables, x, kw)

    outs = {}
    for bf16 in (True, False):
        model = build_model(_cfg(get_preset, name, bf16))
        assert model.bf16 == bf16
        load_jax_variables(model, variables)
        model.eval()
        with torch.no_grad():
            outs[bf16] = model(torch.from_numpy(x),
                               **{k: torch.from_numpy(v).long() for k, v in kw.items()})
    assert outs[True].keys() == want.keys()
    for k, w in want.items():
        got = outs[True][k]
        assert got.dtype == torch.float32 and w.dtype == np.float32, k
        assert _rel(got, w) <= 3e-2, (k, _rel(got, w))
        assert _rel(got, outs[False][k]) >= 1e-4, (k, _rel(got, outs[False][k]))


def test_bf16_train_step_keeps_fp32_state():
    cfg = _cfg(get_preset, "hrnet_w18_mem").updated("contrast.warmup_iters", 0)
    state = create_train_state(cfg, build_model(cfg), "cpu")
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(rng.standard_normal((B, H, W, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 5, (B, H, W)))}
    step = make_train_step(build_loss(cfg), pixel_update_freq=cfg.get("contrast.pixel_update_freq"))
    metrics = step(state, batch)
    assert all(torch.isfinite(v) for v in metrics.values()) and float(metrics["loss_contrast"]) > 0
    params = dict(state.model.named_parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in params.values())
    assert all(torch.isfinite(p).all() for p in params.values())
    assert sum(not torch.equal(p, before[k]) for k, p in params.items()) > len(params) // 2
    assert state.bank.storage.dtype == torch.float32
    assert not torch.equal(state.bank.segment_ptr, torch.zeros_like(state.bank.segment_ptr))


def test_bf16_train_step_matches_jax():
    """One bf16 step of ``cityscapes_deeplab_v3_contrast`` against the JAX
    package's bf16 step (module docstring: tolerances and readings)."""
    hw, n = 65, 9 * 9  # the stride-8 grid of 65x65

    def config(get, bf16=True):
        cfg = get("cityscapes_deeplab_v3_contrast")
        for k, v in {"network.backbone": SHALLOW_RESNET, "contrast.warmup_iters": 0,
                     "contrast.max_views": 6, "contrast.exact_sampling": True,
                     "network.bf16": bf16}.items():
            cfg = cfg.updated(k, v)
        return cfg

    jcfg = config(jget_preset)
    jmodel = jbuild_model(jcfg)
    variables = random_variables(jmodel, (1, hw, hw, 3), seed=1)
    ds = SyntheticSegDataset(num_classes=19, size_hw=(hw, hw), length=8)
    samples = [ds[i] for i in range(B)]
    p = jcfg.get("normalize")
    norm = Normalizer(p["div_value"], p["mean_value"], p["std"])
    batch = {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
             "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}
    tx, rng = optax.sgd(1.0), jax.random.key(7)  # p1 = p0 - g
    s0 = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"],
                     opt_state=tx.init(variables["params"]), bank=None, rng=rng, tx=tx)
    jstep = jmake_train_step(jmodel, jbuild_loss(jcfg), warmup_iters=0, network_stride=8,
                             donate=False, exact_sampling=True)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})
    _, _, r_sample, _ = jax.random.split(rng, 4)
    draws = Draws(anchor=AnchorScores(*(
        torch.from_numpy(np.array(jax.random.uniform(k, (B, 19, n))))
        for k in jax.random.split(r_sample))))

    grads = {}
    for bf16 in (True, False):
        cfg = config(get_preset, bf16)
        state = create_train_state(cfg, build_model(cfg), "cpu")
        load_jax_variables(state.model, variables)
        metrics = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=8)(
            state, batch, draws)
        grads[bf16] = {k: q.grad for k, q in state.model.named_parameters()}
        if bf16:
            for k, want in jmetrics.items():
                np.testing.assert_allclose(float(metrics[k]), float(want), rtol=5e-3, err_msg=k)
    want = to_port(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), s0.params,
                                s1.params), key_for(state.model))[0]
    assert want.keys() == grads[True].keys()
    held = 0
    for k, w in want.items():
        w, got, f32 = torch.from_numpy(w), grads[True][k], grads[False][k]
        assert got.dtype == torch.float32
        jax_err = _rel(w, f32)
        assert _rel(got, w) <= 2 * jax_err + 2e-2, (k, _rel(got, w), jax_err)
        held += jax_err < 5e-2
    assert held >= 5
