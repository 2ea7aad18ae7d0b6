"""K2 of the port (``ops/conv.py``, ``ops/conv_cuda.py``) against the JAX
package's Pallas conv, and the ``network.pallas_conv`` path of the model.

On the CPU the K2 wrappers take their plain versions (``F.conv2d`` and
``conv2d_weight``); the JAX side runs the Pallas kernels in interpret mode,
as ``tests/test_conv_pallas.py`` does, compiled with most of XLA's
optimizations off (``unoptimized_jax_compiles``).  Inputs come from one
numpy seed, NHWC/HWIO for JAX and transposed to NCHW/OIHW for the port.

Tolerances: atol/rtol 1e-4 on the forward, dX and dW (fp32 sums in another
order; dW sums B·H·W products); the model at the model test's atol/rtol
1e-3 (fp32 through ~100 convs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.models.nets import HRNetSeg as JHRNetSeg
from contrastiveseg_tpu.ops import conv_pallas as jconv
from contrastiveseg_tpu_torch.models import layers
from contrastiveseg_tpu_torch.models.nets import HRNetSeg, build_model
from contrastiveseg_tpu_torch.ops import conv_cuda
from contrastiveseg_tpu_torch.ops.conv import pick_block_h, supported
from contrastiveseg_tpu_torch.utils.jax_weights import load_jax_variables

from torch_port_helpers import (
    compiled_pallas_conv,
    exact_fp32_reference,
    mm_tf32,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

SHAPES = [  # tests/test_conv_pallas.py:27-31 (B, H, W, C, Co)
    (2, 16, 24, 12, 12),
    (1, 8, 16, 18, 18),
    (1, 32, 16, 48, 48),
    (1, 8, 16, 3, 18),
]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def _inputs(shape, seed):
    b, h, w_, c, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w_, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    tgt = rng.standard_normal((b, h, w_, co)).astype(np.float32)
    return x, w, tgt


@pytest.fixture(scope="module", autouse=True)
def _shared_quick_compiles():
    """Every JAX compile shared and unoptimized (the interpret-mode kernels
    are compiled once per shape and run once)."""
    with shared_jax_compiles(), unoptimized_jax_compiles():
        yield


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_forward_dx_dw_match_jax(shape):
    x, w, tgt = _inputs(shape, seed=sum(shape))

    def loss(x, w):
        return ((jconv.conv3x3(x, w, True) - tgt) ** 2).sum()

    want_y = jconv.conv3x3(jnp.asarray(x), jnp.asarray(w), True)
    want_dx, want_dw = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(w))

    xt = _nchw(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    y = conv_cuda.conv3x3(xt, wt)
    ((y - _nchw(tgt)) ** 2).sum().backward()

    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_y),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(want_dw),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("flip", [False, True])
def test_plain_versions_are_the_vjp_of_the_conv(flip):
    """dX is the forward with flipped, transposed weights; dW is conv2d_weight:
    both against torch autograd of F.conv2d, in fp64 (ragged width 40)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 8, 40, generator=g, dtype=torch.float64)
    w = torch.randn(5, 6, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
    xr = x.clone().requires_grad_(True)
    y = torch.nn.functional.conv2d(xr, w, padding=1)
    go = torch.randn(y.shape, generator=g, dtype=torch.float64)
    y.backward(go)
    if flip:
        torch.testing.assert_close(conv_cuda.conv3x3_fwd(go, w.detach(), True), xr.grad)
    else:  # dW is fp32 by contract: fp32 tolerance
        torch.testing.assert_close(conv_cuda.conv3x3_dw(x, go).double(), w.grad,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["dw", "fwd", "dx"])
def test_3xtf32_keeps_k2s_tolerance(kernel):
    """K2's numerics, emulated on the CPU at [1, 48, 64, 128] with the 3xTF32
    products of ``csrc/conv3x3.cu`` and ``csrc/conv_tile.cuh``, against fp64
    at the card test's tolerances.

    * dw (K2b): one GEMM of g [Co, P] and the im2col of x [9C, P] over P =
      8,192 pixels; rtol 1e-4, atol 1e-6 max|dW| + 1e-4;
    * fwd and dx (K2a): the weights [Co, 9C] times the im2col of x [9C, P]
      (w flipped and transposed for dX), a reduction 432 long; rtol 1e-4,
      atol 1e-4, with w at the scale 1 / (3 sqrt(C)) of ``chip_smoke.py``.

    A single TF32 product is not within them: its truncated operands move
    dW by ~1e-3 relative and the forward and dX by ~4e-3 absolute, so both
    kernels keep three."""
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rng.standard_normal((1, 48, 64, 128), dtype=np.float32))
    cols = torch.nn.functional.unfold(x, 3, padding=1)[0]  # [9C, P], (ci, ky, kx) order
    if kernel == "dw":
        g = torch.from_numpy(rng.standard_normal((1, 48, 64, 128), dtype=np.float32))
        want = torch.nn.grad.conv2d_weight(x.double(), (48, 48, 3, 3), g.double(), padding=1)
        a, b, shape = g[0].reshape(48, -1), cols, (48, 48, 3, 3)
        atol = 1e-6 * float(want.abs().max()) + 1e-4
    else:
        w = torch.from_numpy(rng.standard_normal((48, 48, 3, 3), dtype=np.float32)
                             / (3 * 48 ** 0.5))
        if kernel == "dx":
            w = w.flip((2, 3)).transpose(0, 1)
        want = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
        a, b, shape = w.reshape(48, -1).contiguous(), cols.T.contiguous(), want.shape
        atol = 1e-4
    with one_torch_thread():
        got = mm_tf32(a, b, split=True).reshape(shape)
        one = mm_tf32(a, b, split=False).reshape(shape)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=atol)
    assert not torch.allclose(one.double(), want, rtol=1e-4, atol=atol)


def test_k2_variant_switches_exist_in_the_source():
    """``tools/bench_k2_variants.py`` builds ``csrc/conv3x3.cu`` (K2a, K2b) and
    ``csrc/fused_block.cu`` (K3) with -D switches; each must be one the
    source reads, and the port's own build sets none."""
    import importlib.util
    from pathlib import Path

    from contrastiveseg_tpu_torch.ops import block_cuda

    path = Path(__file__).resolve().parents[1] / "tools" / "bench_k2_variants.py"
    spec = importlib.util.spec_from_file_location("bench_k2_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for lib, variants in ((conv_cuda.LIBRARY, tool.VARIANTS),
                          (block_cuda.LIBRARY, tool.K3_VARIANTS)):
        source = lib.source.read_text()
        assert lib.defines == ()
        for defines in variants.values():
            for d in defines:
                assert f"#ifndef {d.split('=')[0]}" in source or \
                    f"#ifdef {d.split('=')[0]}" in source, d


@pytest.mark.parametrize("case,want", [
    ((1, 48, 32, 256), True),
    ((1, 48, 32, 256, "1x1"), False),
    ((1, 48, 32, 256, "strided"), False),
    ((1, 48, 32, 256, "dilated"), False),
    ((1, 720, 32, 256), False),   # wide channels
    ((1, 48, 6, 256), False),     # H not 8-aligned
    ((2, 64, 8, 40), True),
    ((2, 65, 8, 40), False),
])
def test_supported_matches_jax(case, want):
    kind = case[4] if len(case) == 5 else ""
    b, c, h, w = case[:4]
    k, s, d = 1 if kind == "1x1" else 3, 2 if kind == "strided" else 1, 2 if kind == "dilated" else 1
    assert supported((b, c, h, w), k, s, d) is want
    assert jconv.supported((b, h, w, c), k, s, d) is want


def test_pick_block_h_matches_jax():
    for h in (8, 12, 16, 24, 32, 40, 64, 96, 128, 130, 256):
        assert pick_block_h(h) == jconv.pick_block_h(h), h
    assert pick_block_h(128) == 32 and pick_block_h(8) == 8 and pick_block_h(12) == 0


def test_pallas_conv_routes_branch0_of_w48(monkeypatch):
    """At W48 only branch 0 (C=48) passes ``supported``: 64 convs a forward
    (stage 2: 8, stage 3: 32, stage 4: 24), as in the JAX model."""
    from contrastiveseg_tpu_torch.presets import get_preset

    calls = []

    def counting(x, w):
        calls.append(tuple(x.shape))
        return conv_cuda.conv3x3(x, w)

    monkeypatch.setattr(layers, "conv3x3", counting)
    cfg = get_preset("cityscapes_hrnet_w48_mem").updated("network.pallas_conv", True)
    model = build_model(cfg)
    with torch.no_grad(), one_torch_thread():
        model.eval()(torch.zeros(1, 64, 128, 3))
    assert len(calls) == 64
    assert set(calls) == {(1, 48, 16, 32)}


@pytest.fixture(scope="module")
def weights():
    jm = JHRNetSeg(num_classes=5, arch="hrnet18", with_proj=True, head_dropout=0.0,
                   pallas_conv=True)
    return jm, random_variables(jm, (1, 64, 64, 3), seed=1)


def test_train_forward_with_pallas_conv_matches_jax(weights, monkeypatch):
    """hrnet18 at 64x64 with ``pallas_conv`` on both sides: branches 0 and 1
    (C=18, 36) go through the JAX Pallas conv (interpret mode, each launch a
    host call from the compiled blocks: ``compiled_pallas_conv``) and the
    port's K2 wrappers; train-mode outputs and BN statistics agree.  torch
    runs on one thread (the 1e-3 tolerance is far above summation order)."""
    from contrastiveseg_tpu_torch.utils.jax_weights import flatten, hrnet_seg_key

    exact_fp32_reference(monkeypatch)
    calls = compiled_pallas_conv(monkeypatch)
    jm, variables = weights
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with jax.disable_jit():
        want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
    # Every 3x3 conv of the blocks of branches 0 and 1: 2 a block, 4 blocks
    # a branch, 8 modules.
    assert len(calls) == 128 and set(calls) == {(2, 16, 16, 18), (2, 8, 8, 36)}
    pm = HRNetSeg(5, "hrnet18", head_dropout=0.0, pallas_conv=True)
    load_jax_variables(pm, variables)
    with torch.no_grad(), one_torch_thread():
        got = pm.train()(torch.from_numpy(x))
    for k in ("seg", "embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)
    sd = pm.state_dict()
    for path, new in flatten(mut["batch_stats"]).items():
        key = hrnet_seg_key(path)
        np.testing.assert_allclose(sd[key].numpy(), new, atol=1e-3, rtol=1e-3, err_msg=key)
