"""K2 in bf16 (``network.bf16`` with ``network.pallas_conv``) against the JAX
package's Pallas conv on bf16 operands, and K2's custom op.

* K2 through the port's custom op (``ops/conv_cuda.conv3x3``: on the CPU its
  plain versions, ``F.conv2d`` and ``conv2d_weight`` on the fp32 upcasts,
  rounded once to bf16) against JAX ``conv3x3`` (``ops/conv_pallas.py``, the
  kernels in interpret mode, one host call a launch:
  ``torch_port_helpers.compiled_pallas_conv``) on the same bf16 operands, at
  C = 18, and at C = 48 on a ragged width (20, which the JAX kernel pads to
  24):
  the forward, dX, and dW rounded to the weights' bf16 by both VJPs
  (``conv_pallas.py:253``), each within 1 bf16 ulp (``chip_smoke.bf16_ulps``:
  fp32 sums of exact products in another order, rounded once).
* ``hrnet_w18_mem`` (``smoke_hrnet_w18``: 5 classes, a bank of 50 rows a
  class and queue, contrast live from step 0, dropout 0, exact top-k
  sampling) with ``network.bf16`` and ``network.pallas_conv`` on a shallow
  hrnet18 (``torch_port_helpers.shallow_hrnet18``: branches 0 and 1, C = 18
  and 36, go through K2), 2 images of 64x64, both packages from the same
  numpy weights and bank: the eval forward within 3e-2 of JAX's in relative
  L2 (the bf16 nets' tolerance, ``tests/test_torch_port_bf16.py``; read:
  5.1e-3 and 7.5e-3); one train step with the JAX step's draws: the losses
  within rtol 5e-3 (a bf16 rounding is 3.9e-3; read: 6.5e-5 to 1.3e-3), the
  bank pointers equal and its rows within 2e-2 (the enqueued keys are unit
  embeddings of bf16 features; read: 1.3e-2), and each parameter's gradient
  (the JAX one read off an ``optax.sgd(1.0)`` update) within twice the JAX
  gradient's own distance from the port's fp32 gradient, plus 2e-2, in
  relative norm.  The BN backward through bf16 activations leaves a
  random-init net's bf16 gradients far from the fp32 ones in both packages
  (``tests/test_torch_port_bf16.py``); two independent roundings of one size
  put the two bf16 runs sqrt(2) times that distance apart.  Read: JAX's
  distance 1.7e-2 (``cls_head``) to 0.37 (branch 0's convs, K2's dW), and
  7.8e5 on a conv bias that feeds a BN (its true gradient is 0); the port's
  within 1.62 times it, and within 0.97-1.11 times it on the K2 convs.
* The custom ops pass ``torch.library.opcheck`` on the CPU in fp32 and bf16
  (schema, fake implementation, autograd registration); a bf16
  ``pallas_conv`` net exported by ``tools/export_torch.py`` (a tiny HRNet,
  ``torch_port_helpers.tiny_hrnet``), loaded and run in a fresh process,
  gives the ``Tester``'s ``ss_test`` logits within 1e-5.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import contrastiveseg_tpu.ops.conv_pallas as jconv
from chip_smoke import bf16_ulps
from contrastiveseg_tpu.data.datasets import SyntheticSegDataset as JSynthetic
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.ops.queue import MemoryBank as JBank
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine import tester as ptester
from contrastiveseg_tpu_torch.engine.state import create_train_state
from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
from contrastiveseg_tpu_torch.losses.manager import build_loss
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.ops import conv_cuda
from contrastiveseg_tpu_torch.ops.queue import bank_from_queues
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import hrnet_seg_key, load_jax_variables, to_port
from tools import export_torch
from tools.train_torch import build_config

from torch_port_helpers import (
    compiled_pallas_conv,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shared_jax_compiles,
    tiny_hrnet,
    unoptimized_jax_compiles,
)

B, H, W = 2, 64, 64
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    compiled_pallas_conv(mp)
    with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
        yield
    mp.undo()


def _bf16(a: np.ndarray) -> tuple:
    """The bf16 rounding of ``a`` for each package, NHWC/HWIO for JAX and
    NCHW/OIHW for the port."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    perm = (0, 3, 1, 2) if a.shape[0] != 3 else (3, 2, 0, 1)
    return jnp.asarray(a, jnp.bfloat16), t.permute(*perm).contiguous()


@pytest.mark.parametrize("b,h,w,c", [(1, 8, 24, 18), (2, 8, 20, 48)])
def test_bf16_k2_matches_jax_pallas(b, h, w, c):
    rng = np.random.default_rng(c + w)
    jx, x = _bf16(rng.standard_normal((b, h, w, c)).astype(np.float32))
    jw, wt = _bf16((rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32))
    jg, g = _bf16(rng.standard_normal((b, h, w, c)).astype(np.float32))
    jy, vjp = jax.vjp(lambda x_, w_: jconv.conv3x3(x_, w_, True), jx, jw)
    jdx, jdw = vjp(jg)
    assert jy.dtype == jdx.dtype == jdw.dtype == jnp.bfloat16

    x.requires_grad_(True)
    wt.requires_grad_(True)
    y = conv_cuda.conv3x3(x, wt)
    y.backward(g)
    assert y.dtype == x.grad.dtype == wt.grad.dtype == torch.bfloat16

    def port(a):  # a JAX array in the port's layout
        a = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
        return a.permute(3, 2, 0, 1) if a.shape[0] == 3 else a.permute(0, 3, 1, 2)

    for what, got, want in (("y", y, jy), ("dx", x.grad, jdx), ("dw", wt.grad, jdw)):
        assert bf16_ulps(got.detach(), port(want)) <= 1, what


def _config(bf16=True):
    cfg = get_preset("smoke_hrnet_w18")
    for k, v in {"network.head_dropout": 0.0, "contrast.exact_sampling": True,
                 "network.pallas_conv": True, "network.bf16": bf16}.items():
        cfg = cfg.updated(k, v)
    return cfg


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_hrnet_w18_mem_bf16_pallas_matches_jax():
    cfg = _config()
    jcfg = jget_preset("smoke_hrnet_w18")
    for k in ("network.head_dropout", "contrast.exact_sampling", "network.pallas_conv",
              "network.bf16"):
        jcfg = jcfg.updated(k, cfg.get(k))
    jmodel = jbuild_model(jcfg)
    assert jmodel.dtype == jnp.bfloat16 and jmodel.pallas_conv
    variables = random_variables(jmodel, (1, H, W, 3), seed=2)

    # The eval forward.
    x = np.random.default_rng(0).standard_normal((B, H, W, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    model = build_model(cfg)
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and _rel(got[k], w) <= 3e-2, (k, _rel(got[k], w))

    # One train step with the JAX step's draws.
    ds, jds = SyntheticSegDataset(num_classes=5, size_hw=(H, W), length=8), JSynthetic(
        num_classes=5, size_hw=(H, W), length=8)
    samples = [ds[i] for i in range(B)]
    for i, s in enumerate(samples):
        np.testing.assert_array_equal(s["image"], jds[i]["image"])
    p = cfg.get("normalize")
    norm = Normalizer(p["div_value"], p["mean_value"], p["std"])
    batch = {"image": torch.from_numpy(np.stack([norm(s["image"]) for s in samples])),
             "label": torch.from_numpy(np.stack([s["label"] for s in samples]).astype(np.int64))}
    C, Mq, D = 5, cfg.get("contrast.memory_size"), cfg.get("contrast.proj_dim")
    rng = np.random.default_rng(3)
    queues = []
    for _ in range(2):
        q = rng.standard_normal((C, Mq, D)).astype(np.float32)
        queues += [q / np.linalg.norm(q, axis=-1, keepdims=True),
                   rng.integers(0, Mq, C).astype(np.int32)]
    tx, key = optax.sgd(1.0), jax.random.key(7)  # p1 = p0 - g
    s0 = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                     batch_stats=variables["batch_stats"],
                     opt_state=tx.init(variables["params"]),
                     bank=JBank(*(jnp.asarray(a) for a in queues)), rng=key, tx=tx)
    jstep = jmake_train_step(jmodel, jbuild_loss(jcfg), warmup_iters=0, network_stride=4,
                             pixel_update_freq=cfg.get("contrast.pixel_update_freq"),
                             donate=False, exact_sampling=True)
    s1, jmetrics = jstep(s0, {"image": jnp.asarray(batch["image"].numpy()),
                              "label": jnp.asarray(batch["label"].numpy().astype(np.int32))})
    _, _, r_sample, r_queue = jax.random.split(key, 4)
    n = (H // 4) * (W // 4)

    def u(k):
        return torch.from_numpy(np.array(jax.random.uniform(k, (B, C, n))))

    draws = Draws(anchor=AnchorScores(*(u(k) for k in jax.random.split(r_sample))),
                  queue=u(r_queue))
    grads = {}
    for bf16 in (True, False):
        c = _config(bf16)
        state = create_train_state(c, build_model(c), "cpu")
        load_jax_variables(state.model, variables)
        state.bank = bank_from_queues(*(torch.from_numpy(a) for a in queues))
        metrics = make_train_step(build_loss(c), warmup_iters=0, network_stride=4,
                                  pixel_update_freq=c.get("contrast.pixel_update_freq"))(
            state, batch, draws)
        grads[bf16] = {k: q.grad for k, q in state.model.named_parameters()}
        if bf16:
            bank = state.bank
            for k, w in jmetrics.items():
                np.testing.assert_allclose(float(metrics[k]), float(w), rtol=5e-3, err_msg=k)
    assert float(jmetrics["loss_contrast"]) > 0
    np.testing.assert_array_equal(bank.segment_ptr.numpy(), np.asarray(s1.bank.segment_ptr))
    np.testing.assert_array_equal(bank.pixel_ptr.numpy(), np.asarray(s1.bank.pixel_ptr))
    assert not np.array_equal(np.asarray(s1.bank.segment_ptr), queues[1])
    for got, w in ((bank.segment_queue, s1.bank.segment_queue),
                   (bank.pixel_queue, s1.bank.pixel_queue)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-2)

    want = to_port(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), s0.params,
                                s1.params), hrnet_seg_key)[0]
    assert want.keys() == grads[True].keys()
    k2 = [k for k in want if ".branches.0." in k and k.endswith(("conv1.weight",
                                                                  "conv2.weight"))]
    assert k2  # K2's bf16 dW, rounded to bf16 and returned in fp32
    for k, w in want.items():
        w, got, f32 = torch.from_numpy(w), grads[True][k], grads[False][k]
        assert got.dtype == torch.float32
        jax_err = _rel(w, f32)
        assert _rel(got, w) <= 2 * jax_err + 2e-2, (k, _rel(got, w), jax_err)


def test_custom_ops_pass_opcheck():
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 6, 8, 12, generator=g).to(dtype).requires_grad_(True)
        w = torch.randn(5, 6, 3, 3, generator=g).to(dtype).requires_grad_(True)
        gy = torch.randn(2, 5, 8, 12, generator=g).to(dtype)
        torch.library.opcheck(conv_cuda.conv3x3_op, (x, w, False))
        torch.library.opcheck(conv_cuda.conv3x3_dw_op, (x.detach(), gy))
        assert conv_cuda.conv3x3_dw_op(x.detach(), gy).dtype == torch.float32


def test_bf16_pallas_export_round_trip(tmp_path, monkeypatch):
    """Exported on the CPU, loaded and run in a fresh Python process
    (``tools/export_torch.load_artifact``, which registers K2's ops), against
    the live ``Tester``'s ``ss_test`` (module docstring); the loaded program
    calls ``contrastiveseg::conv3x3``.  The fresh process runs while this one
    computes the live logits."""
    tiny_hrnet(monkeypatch)
    hw = (32, 48)
    cfg = build_config("smoke_hrnet_w18", None, ["network.pallas_conv=True",
                                                 "network.bf16=True"])
    export_torch.export_artifact(cfg, str(tmp_path / "k2"), "ss", hw, 1, device="cpu")
    x = np.random.default_rng(0).standard_normal((1, *hw, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np, torch; sys.path.insert(0, sys.argv[1]); "
        "from tools.export_torch import load_artifact; "
        "m, _ = load_artifact(sys.argv[2]); "
        "np.save(sys.argv[3], m(torch.from_numpy(np.load(sys.argv[4]))).detach().numpy()); "
        "print(any(n.target is torch.ops.contrastiveseg.conv3x3.default "  # inside the autocast region
        "for g in m.modules() if isinstance(g, torch.fx.GraphModule) for n in g.graph.nodes))")
    proc = subprocess.Popen([sys.executable, "-c", script, str(ROOT), str(tmp_path / "k2"),
                             str(tmp_path / "y.npy"), str(tmp_path / "x.npy")],
                            stdout=subprocess.PIPE, text=True)
    live = ptester.Tester(cfg, export_torch.load_model(cfg, None, "cpu"))
    with torch.no_grad():
        want = live.ss_test(torch.from_numpy(x)).numpy()
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0
    assert out.strip().splitlines()[-1] == "True"
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), want, atol=1e-5)
