"""Segmentation heads (NCHW).

Counterpart of ``contrastiveseg_tpu/models/heads.py``; slot numbers follow
the upstream torch heads so the ``state_dict`` keys match
``utils/torch_import.py`` (``cls_head.0``, ``cls_head.1.0``, ``cls_head.3``,
``proj_head.proj.{0,1.0,2}``).
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.layers import TorchBatchNorm, conv


class ClsHead(nn.Sequential):
    """3x3 conv -> BNReLU -> Dropout -> 1x1 conv (no bias) -> logits
    (reference HRNet_W48 cls_head, lib/models/nets/hrnet.py:37-42).  The 3x3
    conv has no bias, like the JAX ConvBN (the upstream bias folds into BN).
    The dropout is element-wise, as in the JAX ``ClsHead``
    (``contrastiveseg_tpu/models/heads.py:29``), not the upstream's
    channel-wise ``Dropout2d``."""

    def __init__(self, in_channels: int, num_classes: int, mid_channels: int,
                 dropout: float = 0.10):
        super().__init__(
            conv(in_channels, mid_channels, 3),
            nn.Sequential(TorchBatchNorm(mid_channels), nn.ReLU()),
            nn.Dropout(dropout),
            conv(mid_channels, num_classes, 1),
        )


class ProjectionHead(nn.Module):
    """convmlp projection (1x1 -> BNReLU -> 1x1) + L2 normalize over channels
    (lib/models/modules/projection.py:8-24)."""

    def __init__(self, dim_in: int, proj_dim: int = 256):
        super().__init__()
        self.proj = nn.Sequential(
            conv(dim_in, dim_in, 1, bias=True),
            nn.Sequential(TorchBatchNorm(dim_in), nn.ReLU()),
            conv(dim_in, proj_dim, 1, bias=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x).float()
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
