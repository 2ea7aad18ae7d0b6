"""K1, the anchor x bank InfoNCE: the port's wrappers against the JAX package.

On the CPU the wrappers of ``ops/contrast_cuda.py`` take the plain torch
passes of ``ops/contrast_stream.py``; these are held against the Pallas
kernels (``pallas_contrastive_loss``, interpret mode on the CPU) and the
dense ``contrastive_loss``.  Value and gradient at atol 1e-5, rtol 1e-4,
the tolerance of tests/test_contrast_pallas.py:55 (fp32 sums in another
order).  The CUDA kernels themselves run only on the card:
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.ops.contrast import AnchorSet as JAnchorSet
from contrastiveseg_tpu.ops.contrast import ContrastSpec as JSpec
from contrastiveseg_tpu.ops.contrast import contrastive_loss as jdense
from contrastiveseg_tpu.ops.contrast_pallas import pallas_contrastive_loss
from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
from contrastiveseg_tpu_torch.ops import contrast_stream
from contrastiveseg_tpu_torch.ops.contrast import AnchorSet, ContrastSpec, contrastive_loss
from contrastiveseg_tpu_torch.ops.contrast_stream import (
    InfoNCE,
    Passes,
    stream_bwd,
    stream_pass1,
    stream_pass2,
    streaming_contrastive_loss,
)

from torch_port_helpers import mm_tf32


def _setup(M=16, K=48, D=8, C=5, seed=0, no_pos_row=True):
    rng = np.random.default_rng(seed)
    a_f = rng.standard_normal((M, D)).astype(np.float32)
    a_f /= np.linalg.norm(a_f, axis=-1, keepdims=True)
    a_l = rng.integers(0, C - 1, size=M).astype(np.int32)
    if no_pos_row:
        a_l[3] = C - 1  # class C-1 is absent from the contrast set
    a_v = rng.random(M) < 0.9
    c_f = rng.standard_normal((K, D)).astype(np.float32)
    c_f /= np.linalg.norm(c_f, axis=-1, keepdims=True)
    c_l = rng.integers(0, C - 1, size=K).astype(np.int32)
    c_v = rng.random(K) < 0.9
    return a_f, a_l, a_v, c_f, c_l, c_v


@pytest.mark.parametrize("tau,base,K", [(0.07, 0.07, 48), (0.1, 0.07, 37), (0.07, 0.07, 1)])
def test_k1_wrapper_matches_pallas_and_dense(tau, base, K):
    arrs = _setup(K=K, seed=K)
    ja = [jnp.asarray(x) for x in arrs]
    ta = [torch.from_numpy(x) for x in arrs]

    def f_pallas(x):
        return pallas_contrastive_loss(x, *ja[1:], tau, base, 16)

    want, want_g = jax.value_and_grad(f_pallas)(ja[0])
    spec = JSpec(num_classes=5, max_samples=16, temperature=tau,
                 base_temperature=base)
    dense = float(jdense(JAnchorSet(*ja[:3]), spec, *ja[3:]))

    x = ta[0].clone().requires_grad_(True)
    got = k1.cuda_contrastive_loss(x, *ta[1:], tau, base)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(got.detach()), dense, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-5, rtol=1e-4)


def test_port_dense_and_streamed_agree_in_value_and_grad():
    """The port's own dense oracle (autograd through the [M, K] logits)
    against the streamed passes with their analytic backward."""
    arrs = _setup(M=12, K=40, D=6, seed=5)
    ta = [torch.from_numpy(x) for x in arrs]
    x1 = ta[0].clone().requires_grad_(True)
    x2 = ta[0].clone().requires_grad_(True)
    spec = ContrastSpec(num_classes=5, temperature=0.1, base_temperature=0.07)
    dense = contrastive_loss(AnchorSet(x1, ta[1], ta[2]), spec, ta[3], ta[4], ta[5])
    stream = streaming_contrastive_loss(x2, *ta[1:], 0.1, 0.07)
    dense.backward()
    stream.backward()
    np.testing.assert_allclose(float(stream.detach()), float(dense.detach()),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(x2.grad.numpy(), x1.grad.numpy(), atol=1e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_counting():
    k1.reset_launch_counts()
    arrs = [torch.from_numpy(x) for x in _setup()]
    m, ns, p = k1.infonce_pass1(arrs[0], arrs[1], arrs[3], arrs[4], arrs[5], 0.07)
    k1.infonce_pass2(arrs[0], arrs[1], arrs[3], arrs[4], arrs[5], m, ns, 0.07)
    assert p[3] == 0  # the row with no positive
    assert k1.launch_counts() == {"infonce_pass1": 0, "infonce_pass2": 0,
                                  "infonce_bwd": 0}


def _emulated_passes(split):
    """K1's three kernels with their products emulated in TF32."""

    def tf32_logits(plain_pass):
        def run(*args):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(contrast_stream, "_logits",
                           lambda a, cf, tau: mm_tf32(a, cf, split) * (1.0 / tau))
                return plain_pass(*args)
        return run

    def bwd(a_f, a_l, c_f, c_l, c_v, m, ns, t, w, temperature):
        dA = torch.zeros_like(a_f)
        for k0 in range(0, c_f.shape[0], 8192):
            cf, cl, cv = c_f[k0:k0 + 8192], c_l[k0:k0 + 8192], c_v[k0:k0 + 8192]
            e = torch.exp(mm_tf32(a_f, cf, split) * (1.0 / temperature) - m[:, None])
            same = a_l[:, None] == cl[None, :]
            ok = cv[None, :]
            denom = e + ns[:, None] + 1e-30
            dl = torch.where(same & ok, w[:, None] * (1.0 - e / denom), 0.0)
            dl = dl + torch.where(~same & ok, -w[:, None] * t[:, None] * e, 0.0)
            dA = dA + mm_tf32(dl / temperature, cf.T, split)
        return dA

    return Passes(tf32_logits(stream_pass1), tf32_logits(stream_pass2), bwd)


def test_3xtf32_products_keep_k1s_tolerance():
    """The numerics of the Hopper K1, emulated on the CPU at the main
    path's shape (M=38 anchors, D=256, tau 0.07) against a 4,000-row bank:
    pass 1's (m, ns, p), dA and the loss's value and gradient stay within
    K1's rtol 1e-4 / atol 1e-5 of the fp32 plain passes.  A single TF32
    product does not: its logit error, scaled by 1/tau = 14.3, moves ns
    by more than 1e-4 relative."""
    tau = 0.07
    a, a_l, a_v, c, c_l, c_v = [torch.from_numpy(x) for x in _setup(
        M=38, K=4000, D=256, C=19, seed=38)]
    want = stream_pass1(a, a_l, c, c_l, c_v, tau)
    got = _emulated_passes(True).pass1(a, a_l, c, c_l, c_v, tau)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    one = _emulated_passes(False).pass1(a, a_l, c, c_l, c_v, tau)
    assert not torch.allclose(one[1], want[1], rtol=1e-4, atol=1e-5)

    m, ns, p = want
    t = stream_pass2(a, a_l, c, c_l, c_v, m, ns, tau)[1]
    w = torch.where(a_v & (p > 0), -1.0 / (38 * p.clamp(min=1)), 0.0)
    torch.testing.assert_close(_emulated_passes(True).bwd(a, a_l, c, c_l, c_v, m, ns, t, w, tau),
                               stream_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, tau),
                               rtol=1e-4, atol=1e-5)

    x1 = a.clone().requires_grad_(True)
    x2 = a.clone().requires_grad_(True)
    emulated = InfoNCE.apply(x1, a_l, a_v, c, c_l, c_v, tau, tau, _emulated_passes(True))
    plain = streaming_contrastive_loss(x2, a_l, a_v, c, c_l, c_v, tau, tau)
    emulated.backward()
    plain.backward()
    torch.testing.assert_close(emulated.detach(), plain.detach(), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-4, atol=1e-5)


def test_3xtf32_pass2_keeps_k1bs_tolerance():
    """K1b's numerics, emulated as above: s1 and t stay within K1's rtol 1e-4
    / atol 1e-5 of the fp32 plain pass 2.  So does a single TF32 product,
    unlike in pass 1: s1 and t sum only over positives, with no max or
    exp-sum of negatives to amplify the logit error; its s1 error is still
    more than 10x that of the 3xTF32 products, which K1b shares with K1a."""
    tau = 0.07
    a, a_l, a_v, c, c_l, c_v = [torch.from_numpy(x) for x in _setup(
        M=38, K=4000, D=256, C=19, seed=38)]
    m, ns, _ = stream_pass1(a, a_l, c, c_l, c_v, tau)
    want = stream_pass2(a, a_l, c, c_l, c_v, m, ns, tau)
    err = {}
    for split in (True, False):
        got = _emulated_passes(split).pass2(a, a_l, c, c_l, c_v, m, ns, tau)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        err[split] = float((got[0] - want[0]).abs().max())
    assert err[False] > 10 * err[True]


def test_k1_build_variants_get_their_own_library(monkeypatch, tmp_path):
    """``tools/bench_k1_variants.py`` builds K1's source with ``-DK1_PRODUCTS``
    into a library of its own; the port's library, built with no macro, keeps
    its name and its nvcc command."""
    from contrastiveseg_tpu_torch.ops import cuda_lib

    lib = k1.LIBRARY
    assert lib.defines == ()
    variant = cuda_lib.CudaLibrary(lib.source.name, lib.signatures, lib.error_string,
                                   lib.init, defines=("K1_PRODUCTS=1",))
    assert variant.library_path() != lib.library_path()
    assert variant.library_path().parent == lib.library_path().parent
    assert "K1_PRODUCTS" in lib.source.read_text()

    argv = []

    class Popen:
        def __init__(self, cmd, **kwargs):
            argv.append(cmd)

    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_lib.subprocess, "Popen", Popen)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    for x in (lib, variant):
        x._start(force=True)
    assert not any(a.startswith("-D") for a in argv[0])
    assert "-DK1_PRODUCTS=1" in argv[1]
    assert argv[0][-1] == argv[1][-1] == str(lib.source)
