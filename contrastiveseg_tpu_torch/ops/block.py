"""K3's plain version: the inference HRNet BasicBlock with BN folded in.

Counterpart of ``contrastiveseg_tpu/ops/block_pallas.py`` on the port's own
layout (x NCHW, weights OIHW):

    y = relu(conv2(relu(conv1(x)·s1 + b1))·s2 + b2 + x)

with 3x3 SAME convs and the eval BN of each conv folded into a per-channel
scale and bias (``fold_bn``, :195).  ``reference_block_eval`` computes it in
the fused kernel's arithmetic: the folded weights w·s and the intermediate
relu(conv1(x)·s1 + b1) are rounded to x's dtype, as the JAX kernel stores
them (``block_pallas.py:158-159``, its ``y1`` scratch); the products and
sums are fp32; the result is x's dtype.  conv2's SAME padding reads zeros
outside the image, never conv1 evaluated on the padding (:93-101).  In fp32
it is the JAX package's ``reference_block_eval``; in bf16 it rounds where
the kernel rounds, not where XLA's bf16 convolutions do.

``ops/block_cuda.fused_basic_block_eval`` is the wrapper: K3 on CUDA
tensors, this function on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BN eval affine: y = x·s + b with s = gamma/sqrt(var + eps),
    b = beta - mean·s (ModuleHelper BNReLU eval semantics)."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def fold_weights(w: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW ``w`` with ``s`` folded into its output channels, rounded to
    ``dtype`` and returned as contiguous fp32."""
    return (w.float() * s.float()[:, None, None, None]).to(dtype).float().contiguous()


def reference_block_eval(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """relu(conv2(relu(conv1(x)·s1+b1))·s2+b2 + x), NCHW, in x's dtype."""
    dt = x.dtype
    xf = x.float()
    y = F.conv2d(xf, fold_weights(w1, s1, dt), padding=1) + b1.float()[:, None, None]
    y = torch.relu(y).to(dt).float()
    y = F.conv2d(y, fold_weights(w2, s2, dt), padding=1) + b2.float()[:, None, None]
    return torch.relu(y + xf).to(dt)
