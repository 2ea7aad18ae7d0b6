"""The RMI and Lovasz-Softmax losses (``losses/{rmi,lovasz}.py``) against
the JAX package's, on fixed inputs from a numpy seed.

* ``rmi_loss`` with both pool ways (max, padded with -inf; mean over the
  pixels inside the image) and both lambda ways, on 2 x 23 x 29 logits of
  5 classes with ignored labels (-1 and out of range), the pooled maps not
  a multiple of the stride: value and gradient.  A matrix that is not
  positive definite gives a NaN log-determinant on both sides.
* ``lovasz_softmax`` over the present classes and over all, and
  ``ce_lovasz_loss`` (class weights, labels resized to smaller logits):
  value and gradient.

Tolerances: values rtol 1e-5 (read: RMI 1e-6 apart, in fp32 on both
sides), gradients rtol 1e-4 / atol 1e-6 (read: 1e-8).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.losses import lovasz as jlovasz
from contrastiveseg_tpu.losses import rmi as jrmi
from contrastiveseg_tpu_torch.losses import lovasz, rmi

N, H, W, C = 2, 23, 29, 5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((N, H, W, C))).astype(np.float32)
    labels = rng.integers(0, C, (N, H // 4 + 1, W // 4 + 1)).repeat(4, 1).repeat(4, 2)
    labels = labels[:, :H, :W].astype(np.int32)
    labels[rng.uniform(size=labels.shape) < 0.1] = -1
    labels[0, 0, :3] = C + 2  # out of range: ignored by RMI
    return logits, labels


def _check(tfn, jfn, logits):
    jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    v = tfn(t)
    v.backward()
    v = float(v.detach())
    np.testing.assert_allclose(v, float(jv), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    return v


@pytest.mark.parametrize("pool_way,lambda_way", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_rmi_loss_matches_jax(pool_way, lambda_way):
    logits, labels = _inputs(pool_way * 2 + lambda_way)
    args = dict(pool_way=pool_way, lambda_way=lambda_way, weight_lambda=0.6, loss_weight=1.3)
    value = _check(lambda x: rmi.rmi_loss(x, torch.from_numpy(labels).long(), C, **args),
                   lambda x: jrmi.rmi_loss(x, jnp.asarray(labels), C, **args), logits)
    assert np.isfinite(value)
    if pool_way == 0 and lambda_way == 0:
        bad = np.diag([1.0, -1.0, 2.0]).astype(np.float32)[None]
        assert np.isnan(rmi._log_det_cholesky(torch.from_numpy(bad))[0].item())
        assert np.isnan(float(jrmi._log_det_cholesky(jnp.asarray(bad))[0]))


@pytest.mark.parametrize("only_present", [True, False])
def test_lovasz_matches_jax(only_present):
    logits, labels = _inputs(7)
    labels[labels >= C] = -1
    lab_t, lab_j = torch.from_numpy(labels).long(), jnp.asarray(labels)
    _check(lambda x: lovasz.lovasz_softmax(torch.softmax(x, -1), lab_t,
                                           only_present=only_present),
           lambda x: jlovasz.lovasz_softmax(jax.nn.softmax(x, -1), lab_j,
                                            only_present=only_present), logits)
    if only_present:  # CE + Lovasz on logits at half the label size
        small = np.ascontiguousarray(logits[:, ::2, ::2])
        cw = (0.8, 1.2, 1.0, 0.9, 1.1)
        _check(lambda x: lovasz.ce_lovasz_loss(x, lab_t, cw),
               lambda x: jlovasz.ce_lovasz_loss(x, lab_j, cw), small)
