"""The context modules of the port against the JAX package, one at a time.

Each case runs one module of ``contrastiveseg_tpu_torch/models/attention.py``
(and ``models/ocr.SpatialOCRASP``, ``ops/cc_attention``) and its JAX
counterpart on a tiny map, in train mode, from the same numpy weights
(``random_variables``, which also makes BaseOC's zero-init ``W`` and CCNet's
``gamma`` non-zero, so that their paths count) and inputs: the output, the
BN statistics after the forward and the gradient of a scalar loss (the
output against a fixed cosine pattern) with respect to every parameter.
The sizes are where the traps show: odd maps that are not multiples of the
ISA down factors or the pyramid levels (asymmetric pads and crops), a PSP
input whose height is not a multiple of 3 (truncated bins), a scale-2
BaseOC context on an odd map (floor max-pool, align-corners resize back).
The dropouts are off on both sides (flax's ``Dropout`` patched to the
identity, the port's ``p = 0``).  The JAX side is jitted with most of XLA's
optimizations off; torch runs on one thread.

Tolerances: outputs and BN statistics atol/rtol 1e-4; each gradient within
1e-3 of the JAX one in relative norm, plus 1e-5 of the whole gradient's
norm (the floor covers conv biases right before a train-mode BN, whose
gradient is 0 up to rounding).  The readings, the worst over the cases:
outputs 3.3e-5 apart (the BaseOC context, whose BN divides by a small
variance), gradients 9.6e-5 in relative norm (ASP-OC); BaseOC's ``W`` bias
before that BN, 3.8e-6 of the whole norm.  A transposed block order, a pad
on the wrong side or a missing mask moves them to order 1.
"""

from __future__ import annotations

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.attention as jatt
from contrastiveseg_tpu.models.ocr import SpatialOCRASP as JSpatialOCRASP
from contrastiveseg_tpu.ops.cc_attention import criss_cross_attention as jcca
from contrastiveseg_tpu_torch.models import attention
from contrastiveseg_tpu_torch.models.ocr import SpatialOCRASP
from contrastiveseg_tpu_torch.ops.cc_attention import criss_cross_attention
from contrastiveseg_tpu_torch.utils import jax_weights as jw

from torch_port_helpers import (
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)


class _NoDropout(flax_nn.Dropout):
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn, "Dropout", _NoDropout)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


def _isa_block_key(path):
    return jw._sub(f"{path[0]}_sa", jw.self_attention_key(path[1:]))


# name: (JAX module, port module, key map, input [B, H, W, C], extra input's channels)
CASES = {
    "self_attention_isa": (
        lambda: jatt.SelfAttention2D(4, 6, 5),
        lambda: attention.SelfAttention2D(8, 4, 6, 5),
        jw.self_attention_key, (2, 7, 9, 8), None),
    "self_attention_base_oc_scale2": (
        lambda: jatt.SelfAttention2D(4, 6, 5, w_bn=False, scale=2),
        lambda: attention.SelfAttention2D(8, 4, 6, 5, w_bn=False, scale=2),
        lambda p: jw.self_attention_key(p, w_bn=False), (2, 7, 9, 8), None),
    "isa_block": (
        lambda: jatt.ISABlock(4, 6, 5, down_factor=(4, 3)),
        lambda: attention.ISABlock(8, 4, 6, 5, (4, 3)),
        _isa_block_key, (2, 11, 13, 8), None),
    "isa_module_two_factors": (
        lambda: jatt.ISAModule(4, 6, 5, down_factors=((4, 3), (2, 5))),
        lambda: attention.ISAModule(8, 4, 6, 5, ((4, 3), (2, 5))),
        jw.isa_module_key, (2, 11, 13, 8), None),
    "base_oc": (
        lambda: jatt.BaseOCModule(4, 4, 8),
        lambda: attention.BaseOCModule(8, 4, 4, 8),
        jw.base_oc_key, (2, 7, 9, 8), None),
    "base_oc_context": (
        lambda: jatt.BaseOCContextModule(4, 4, 6, scale=2),
        lambda: attention.BaseOCContextModule(8, 4, 4, 6, scale=2),
        jw.base_oc_context_key, (2, 7, 9, 8), None),
    "asp_oc": (
        lambda: jatt.ASPOCModule(4, rates=(1, 2, 3)),
        lambda: attention.ASPOCModule(8, 4, (1, 2, 3)),
        jw.asp_oc_key, (2, 7, 9, 8), None),
    "pyramid_oc": (
        lambda: jatt.PyramidOCModule(4, 6, 8),
        lambda: attention.PyramidOCModule(8, 4, 6, 8),
        jw.pyramid_oc_key, (2, 7, 11, 8), None),
    "psp": (
        lambda: jatt.PSPModule(8),
        lambda: attention.PSPModule(8, 8),
        jw.jax_named_key, (2, 7, 11, 8), None),
    "cc": (
        lambda: jatt.CCModule(16),
        lambda: attention.CCModule(8, 16),
        jw.jax_named_key, (2, 6, 7, 8), None),
    "spatial_ocr_asp": (
        lambda: JSpatialOCRASP(hidden=6, out_channels=8, dilations=(1, 2, 3)),
        lambda: SpatialOCRASP(8, 6, 8, (1, 2, 3)),
        jw.asp_ocr_key, (2, 7, 9, 8), 5),
}


def _pattern(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)


def _as_port(arr):
    return np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr


@pytest.mark.parametrize("name", list(CASES))
def test_module_matches_jax(name):
    """Forward, BN statistics and parameter gradients of one module."""
    jctor, pctor, key_of, shape, extra = CASES[name]
    jm = jctor()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    args = [x] + ([3 * rng.standard_normal(shape[:3] + (extra,)).astype(np.float32)]
                  if extra else [])
    v = random_variables(_Wrapped(jm, shape[-1]), shape[:3] + (sum(a.shape[-1] for a in args),))
    v = {col: t.get("inner", {}) for col, t in v.items()}
    flat = jw.flatten(v["params"])
    if name == "cc":
        assert abs(float(flat[("gamma",)])) > 1e-3  # gamma off its zero init
    if "base_oc" in name:
        w = next(a for p, a in flat.items() if p[-2:] == ("W", "kernel"))
        assert np.abs(w).min() > 0  # BaseOC's W off its zero init

    @jax.jit
    def run(params):
        def f(p):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                *map(jnp.asarray, args), True, mutable=["batch_stats"])
            return jnp.sum(out * _pattern(out.shape)), (out, new.get("batch_stats", {}))

        return jax.value_and_grad(f, has_aux=True)(params)

    (_, (jout, jstats)), jgrads = run(v["params"])
    pm = pctor()
    for m in pm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    jw.load_jax_variables(pm, v, key_of)
    out = pm.train()(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in args))
    out = out.permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    torch.sum(out * torch.from_numpy(_pattern(tuple(out.shape)))).backward()

    sd = pm.state_dict()
    stats = jw.flatten(jax.tree.map(np.asarray, jstats))
    for path, new in stats.items():
        np.testing.assert_allclose(sd[key_of(path)].numpy(), new, atol=1e-4, rtol=1e-4,
                                   err_msg=str(path))
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in pm.modules())
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    want = {key_of(p): _as_port(g) for p, g in jw.flatten(jax.tree.map(np.asarray, jgrads)).items()}
    assert got.keys() == want.keys()
    total = np.sqrt(sum(np.sum(g ** 2) for g in want.values()))
    for k, g in want.items():
        assert np.linalg.norm(got[k] - g) <= 1e-3 * np.linalg.norm(g) + 1e-5 * total, k


class _Wrapped(flax_nn.Module):
    """``random_variables`` inits a model on one input: this one takes the
    module's inputs concatenated on the channels (the first ``channels`` of
    them the features), and holds the module as ``inner``."""

    inner: flax_nn.Module
    channels: int

    @flax_nn.compact
    def __call__(self, xs, train=True):
        parts = [xs] if xs.shape[-1] == self.channels else [
            xs[..., :self.channels], xs[..., self.channels:]]
        return self.inner(*parts, train)


def test_criss_cross_attention_matches_jax():
    """``criss_cross_attention`` alone, forward and input gradients, on an
    odd 5x6 map: one softmax over the column and the row, the self
    position counted once.  The column pass masks it: without the mask the
    self logit enters twice, which moves the output by ~1e-1 here."""
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((2, 5, 6, 3)).astype(np.float32) for _ in range(2))
    val = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    pattern = _pattern((2, 5, 6, 4))

    def f(q, k, val):
        return jnp.sum(jcca(q, k, val) * pattern)

    jout = jax.jit(jcca)(q, k, val)
    jgrads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, val)
    ts = [torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (q, k, val)]
    out = criss_cross_attention(*ts).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    torch.sum(out * torch.from_numpy(pattern)).backward()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g),
                                   atol=1e-5, rtol=1e-4)
    # The unmasked version (self counted in both passes) is far off.
    H = q.shape[1]
    tq, tk, tv = (t.detach() for t in ts)
    col = torch.einsum("bdhw,bdkw->bhwk", tq, tk)
    row = torch.einsum("bdhw,bdhk->bhwk", tq, tk)
    a = torch.softmax(torch.cat([col, row], -1), -1)
    twice = (torch.einsum("bhwk,bdkw->bdhw", a[..., :H], tv)
             + torch.einsum("bhwk,bdhk->bdhw", a[..., H:], tv)).permute(0, 2, 3, 1)
    assert np.abs(twice.numpy() - np.asarray(jout)).max() > 1e-2
