"""The port's BatchNorm and cls-head dropout against the JAX package's.

* BatchNorm: in train mode flax updates the running variance with the
  biased batch variance; so does the port (``models/layers.BatchNorm2d``),
  where torch's own BatchNorm would take the unbiased one, n/(n-1) times
  larger (8e-4 off here).  Held at atol 1e-6: the two batch variances
  differ only by fp32 rounding.
* Dropout: the JAX ``ClsHead`` drops elements (``nn.Dropout``), not whole
  channels; in train mode some channel must be partly zeroed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.models.layers import TorchBatchNorm as JBatchNorm
from contrastiveseg_tpu_torch.models.heads import ClsHead
from contrastiveseg_tpu_torch.models.layers import BatchNorm2d, TorchBatchNorm


@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (4, 5, 3, 16)])
def test_bn_running_stats_match_flax(shape):
    rng = np.random.default_rng(0)
    x = (0.3 + 1.5 * rng.standard_normal(shape)).astype(np.float32)  # NHWC
    C = shape[-1]
    mean0 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, C).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)

    jbn = JBatchNorm()
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    want, mut = jbn.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])

    bn = TorchBatchNorm(C)
    assert isinstance(bn, BatchNorm2d) and isinstance(bn, torch.nn.BatchNorm2d)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    got = bn.train()(xt)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]), atol=1e-6)
    got.square().sum().backward()  # the in-place buffer update leaves autograd intact
    assert torch.isfinite(xt.grad).all()

    # Eval mode normalises with the running statistics and updates nothing.
    before = bn.running_var.clone()
    with torch.no_grad():
        out = bn.eval()(xt)
    want_eval = jbn.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                          jnp.asarray(x), False)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(want_eval),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(bn.running_var, before)


def test_cls_head_dropout_is_elementwise():
    head = ClsHead(16, 5, 16, dropout=0.5)
    drop = head[2]
    x = torch.ones(2, 16, 8, 8)
    torch.manual_seed(0)
    y = drop.train()(x)
    zero_share = (y == 0).float().mean(dim=(2, 3))  # per (image, channel)
    partly = (zero_share > 0) & (zero_share < 1)
    assert bool(partly.any()), "no channel is partly zeroed: channel-wise dropout"
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}  # kept values scale by 1/(1-p)
    assert torch.equal(drop.eval()(x), x)


def test_cls_head_eval_is_deterministic():
    torch.manual_seed(1)
    head = ClsHead(8, 3, 8, dropout=0.5).eval()
    x = torch.randn(1, 8, 4, 4)
    with torch.no_grad():
        assert torch.equal(head(x), head(x))
