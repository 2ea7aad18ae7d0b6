"""K3 of the port (``ops/block.py``, ``ops/block_cuda.py``) against the JAX
package's fused BasicBlock kernel in interpret mode.

B, H, W, C = 2, 32, 40, 48, as ``tests/test_conv_pallas.py:119-159``: two
row blocks of 16 (so the first and last row tiles, where conv2's SAME
padding must read zeros and not conv1 evaluated on the padding) and a
ragged width of 40.  On the CPU the wrapper takes its plain version.

Tolerances: fp32 atol 5e-5 (the JAX test's); bf16 against the fp32 result
below 0.35 (the JAX test's bound: ~21 activation scale x bf16 eps x
depth), and against the JAX kernel in bf16 within 2 bf16 steps of the
output's magnitude (the two round y1 and the output at the same places, but
sum in another order, so a value near a rounding boundary may land one step
apart, and one step of y1 moves the output by about another).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.ops import block_pallas as jblock
from contrastiveseg_tpu_torch.ops import block_cuda
from contrastiveseg_tpu_torch.ops.block import fold_bn, reference_block_eval

from torch_port_helpers import unoptimized_jax_compiles

B, H, W, C = 2, 32, 40, 48


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w1 = rng.standard_normal((3, 3, C, C)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((3, 3, C, C)).astype(np.float32) * 0.1

    def bn():
        return (rng.uniform(0.5, 1.5, C).astype(np.float32),
                rng.standard_normal(C).astype(np.float32) * 0.1,
                rng.standard_normal(C).astype(np.float32) * 0.2,
                rng.uniform(0.5, 2.0, C).astype(np.float32))

    bn1, bn2 = bn(), bn()
    j1 = jblock.fold_bn(*map(jnp.asarray, bn1))
    j2 = jblock.fold_bn(*map(jnp.asarray, bn2))
    jargs = (jnp.asarray(w1), *j1, jnp.asarray(w2), *j2)
    want = np.asarray(jblock.reference_block_eval(jnp.asarray(x), *jargs))
    with unoptimized_jax_compiles():  # the interpret-mode kernel runs once a dtype
        fused = {
            dt: np.asarray(jblock.fused_basic_block_eval(
                jnp.asarray(x).astype(dt), *jargs, block_h=16, sub_h=8, interpret=True
            ).astype(jnp.float32))
            for dt in (jnp.float32, jnp.bfloat16)
        }
    t1 = fold_bn(*(torch.from_numpy(a) for a in bn1))
    t2 = fold_bn(*(torch.from_numpy(a) for a in bn2))
    for (js, jb), (ts, tb) in ((j1, t1), (j2, t2)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    targs = (torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))), *t1,
             torch.from_numpy(np.ascontiguousarray(w2.transpose(3, 2, 0, 1))), *t2)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return xt, targs, want, fused


def _nhwc(y):
    return y.float().permute(0, 2, 3, 1).numpy()


def test_fp32_matches_the_jax_kernel_and_reference(case):
    xt, targs, want, fused = case
    got = _nhwc(block_cuda.fused_basic_block_eval(xt, *targs))
    np.testing.assert_allclose(got, fused[jnp.float32], atol=5e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    assert block_cuda.launch_counts() == {"fused_block": 0}  # CPU: the plain version


def test_bf16_matches_the_jax_kernel(case):
    xt, targs, want, fused = case
    y = block_cuda.fused_basic_block_eval(xt.to(torch.bfloat16), *targs)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    got = _nhwc(y)
    assert np.abs(got - want).max() < 0.35
    step = 2.0 ** -7 * np.maximum(np.abs(fused[jnp.bfloat16]), 1.0)  # bf16 spacing
    assert np.all(np.abs(got - fused[jnp.bfloat16]) <= 2 * step)


def test_boundary_tiles_read_zero_padding(case):
    """conv2's SAME padding is zero: a block whose conv1 bias alone is large
    (relu(b1) > 0 everywhere) differs at the border from a version that lets
    conv2 read conv1 evaluated on the padding."""
    xt, (w1, s1, b1, w2, s2, b2), _, _ = case
    b1 = b1 + 3.0
    got = reference_block_eval(xt, w1, s1, b1, w2, s2, b2)
    y1 = torch.relu(torch.nn.functional.conv2d(
        torch.nn.functional.pad(xt, (2, 2, 2, 2)), w1 * s1[:, None, None, None]) + b1[:, None, None])
    leaky = torch.relu(torch.nn.functional.conv2d(y1, w2 * s2[:, None, None, None])
                       + b2[:, None, None] + xt)
    inner = (slice(None), slice(None), slice(1, -1), slice(1, -1))
    torch.testing.assert_close(got[inner], leaky[inner], atol=1e-4, rtol=1e-4)
    assert float((got[:, :, 0] - leaky[:, :, 0]).abs().max()) > 1e-2


def _block_3xtf32(x, w1, s1, b1, w2, s2, b2, split: bool):
    """K3's fp32 arithmetic on the CPU: both convs as [C, 9C] x im2col products
    in 3xTF32 (``split``) or one TF32 product, fp32 sums, y1 zero outside the
    image (conv2's SAME padding)."""
    from torch_port_helpers import mm_tf32

    from contrastiveseg_tpu_torch.ops.block import fold_weights

    def conv(v, w):
        cols = torch.nn.functional.unfold(v, 3, padding=1)  # [B, 9C, P]
        w2d = w.reshape(w.shape[0], -1).contiguous()
        out = torch.stack([mm_tf32(w2d, c.T.contiguous(), split=split) for c in cols])
        return out.reshape(v.shape[0], w.shape[0], *v.shape[2:])

    y1 = torch.relu(conv(x, fold_weights(w1, s1, torch.float32)) + b1[:, None, None])
    return torch.relu(conv(y1, fold_weights(w2, s2, torch.float32)) + b2[:, None, None] + x)


def test_3xtf32_stages_keep_k3s_tolerance(case):
    """K3's fp32 stages, emulated on the CPU with the 3xTF32 products of
    ``csrc/conv_tile.cuh``, are within the card test's tolerance (rtol 1e-4,
    atol 1e-4) of the block in fp64 (2.4e-5 off here); a single TF32 product
    is not (3.2e-2 off, at outputs up to 22)."""
    from torch_port_helpers import one_torch_thread

    xt, (w1, s1, b1, w2, s2, b2), _, _ = case
    d = [a.double() for a in (xt, w1, s1, b1, w2, s2, b2)]
    y1 = torch.relu(torch.nn.functional.conv2d(d[0], d[1] * d[2][:, None, None, None],
                                               padding=1) + d[3][:, None, None])
    want = torch.relu(torch.nn.functional.conv2d(y1, d[4] * d[5][:, None, None, None],
                                                 padding=1) + d[6][:, None, None] + d[0])
    with one_torch_thread():
        got = _block_3xtf32(xt, w1, s1, b1, w2, s2, b2, split=True)
        one = _block_3xtf32(xt, w1, s1, b1, w2, s2, b2, split=False)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    assert not torch.allclose(one.double(), want, rtol=1e-4, atol=1e-4)
