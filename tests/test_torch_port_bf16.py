"""``network.bf16`` of the port against the JAX package's ``dtype=bf16`` nets.

The JAX nets compute in bf16 with fp32 parameters and keep the class
logits, the embedding's normalisation and the OCR products in fp32; the
port runs the same nets under ``torch.autocast`` with those sites pinned to
fp32 (``models/layers.bf16_compute``, ``full_precision``).  Eval-mode
forwards of ``hrnet_w18_mem`` and ``hrnet_w18_ocr`` on a shallow hrnet18
(``torch_port_helpers.shallow_hrnet18``) and of ``deeplab_v3_contrast`` on
a shallow dilated ResNet (``torch_port_helpers.shallow_resnet``), built
through both packages' ``build_model`` with ``network.bf16=true``, from the
same numpy weights, on 2 random 64x64 images; the JAX side jitted whole.

Tolerance: each output within 3e-2 of JAX's in relative L2 norm (bf16
keeps 8 bits, 3.9e-3 a rounding; the two runs round the convolutions'
outputs, the fuse upsamples and the BN inputs in different places; read:
4.5e-3 to 8.8e-3, about what two independent bf16 runs give).  Each port
output is fp32 and at least 1e-4 (relative L2) from the same net's fp32
forward, so bf16 did run (read: 4.8e-3 to 9.2e-3).  A bf16 train step of
``hrnet_w18_mem`` gives a finite loss and keeps the parameters, their
gradients and the bank in fp32.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import make_train_step
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import load_jax_variables

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
NETS = {"hrnet_w18_mem": ("smoke_hrnet_w18", {}),
        "hrnet_w18_ocr": ("cityscapes_hrnet_w48_ocr", {"network.model_name": "hrnet_w18_ocr"}),
        "deeplab_v3_contrast": ("cityscapes_deeplab_v3_contrast",
                                {"network.backbone": SHALLOW_RESNET})}


@pytest.fixture(scope="module", autouse=True)
def _shallow_quick():
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    shallow_resnet(mp)
    with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
        yield
    mp.undo()


def _cfg(get, name, bf16=True):
    preset, extra = NETS[name]
    cfg = get(preset)
    for k, v in {**extra, "network.bf16": bf16}.items():
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
    x = np.random.default_rng(0).standard_normal((B, H, W, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)

    outs = {}
    for bf16 in (True, False):
        model = build_model(_cfg(get_preset, name, bf16))
        assert model.bf16 == bf16
        load_jax_variables(model, variables)
        model.eval()
        with torch.no_grad():
            outs[bf16] = model(torch.from_numpy(x))
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
