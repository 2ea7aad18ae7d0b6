"""OCR (object-contextual representations) modules (NCHW).

Counterpart of ``contrastiveseg_tpu/models/ocr.py`` (:26-150; the
reference's spatial_ocr_block.py):

  * ``SpatialGather``: the context of each class, softmax over the pixels
    of its probability map times the features, ``[B, K, C]``;
  * ``ObjectAttention``: pixel queries against object keys, scaled by
    1/sqrt(key_channels), softmax over the objects, and the weighted object
    values projected back to C channels.  The oracle nets' ``gt_sim``
    (spatial_ocr_block.py:186-192), a one-hot ground-truth map, replaces
    the softmax once L1-normalised over the objects; with ``use_bg``
    (:207-214) the module also returns the background context, the values
    weighted by the L1-normalised complement ``1 - gt_sim``, through the
    same ``f_up``;
  * ``SpatialOCR``: that context concatenated with the features, then a
    1x1 ConvBNReLU and element-wise dropout (``nn.Dropout``, as in the JAX
    package, not the reference's ``Dropout2d``); with ``use_bg`` the
    concatenation is ``[context, background, feats]``, or ``[background,
    feats]`` without ``use_oc`` (:117-148);
  * ``SpatialOCRASP`` (:151-191; SpatialOCR_ASP_Module): ASPP whose context
    branch is that attention, gathered over the DSN logits: a 3x3
    ConvBNReLU, ``SpatialGather``, then ``ObjectAttention`` at half the
    hidden width; beside it a 1x1 and three dilated 3x3 ConvBNReLU
    branches; the five concatenated, 1x1 ConvBNReLU, dropout.

The two products are batched matmuls (``torch.bmm``), as they are XLA
einsums in the JAX package.  As there, the query and key convs run on the
ground-truth path too (their BN statistics move), though the similarity
does not read them.

Module names are the reference's torch keys (``utils/torch_import.
_ocr_distri``, ``_object_attention``): ``object_context_block.f_pixel``,
``.f_object`` (``[conv, BNReLU, conv, BNReLU]``), ``.f_down``, ``.f_up``
(``[conv, BNReLU]``) and ``conv_bn_dropout``; ``SpatialOCRASP``'s are
``utils/torch_import._asp_ocr``'s: ``context`` (``[conv, BNReLU,
{object_context_block}]``), ``conv2``-``conv5`` and ``conv_bn_dropout``.  The attention's 1x1 convs
carry a bias, as the JAX package's do.
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.heads import conv_bn_relu


class SpatialGather(nn.Module):
    """``context[b, k] = softmax_hw(scale * probs[b, k]) @ feats[b]``."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def forward(self, feats: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """``feats`` [B, C, H, W], ``probs`` [B, K, H, W] -> [B, K, C]."""
        p = torch.softmax(self.scale * probs.flatten(2), dim=2)
        return torch.bmm(p, feats.flatten(2).transpose(1, 2))


class ObjectAttention(nn.Module):
    """Pixel-to-object attention (ObjectAttentionBlock2D)."""

    def __init__(self, in_channels: int, key_channels: int, use_bg: bool = False):
        super().__init__()
        self.key_channels = key_channels
        self.use_bg = use_bg

        def double(cin):
            return nn.Sequential(*conv_bn_relu(cin, key_channels, 1, bias=True),
                                 *conv_bn_relu(key_channels, key_channels, 1, bias=True))

        self.f_pixel = double(in_channels)
        self.f_object = double(in_channels)
        self.f_down = conv_bn_relu(in_channels, key_channels, 1, bias=True)
        self.f_up = conv_bn_relu(key_channels, in_channels, 1, bias=True)

    def forward(self, x: torch.Tensor, proxy: torch.Tensor,
                gt_sim: torch.Tensor | None = None):
        """``x`` [B, C, H, W] pixels, ``proxy`` [B, K, C] objects, ``gt_sim``
        None or a [B, H*W, K] one-hot (unnormalised) -> [B, C, H, W], or with
        ``use_bg`` (context, background context)."""
        B, _, H, W = x.shape
        objects = proxy.transpose(1, 2).unsqueeze(-1)  # [B, C, K, 1]
        query = self.f_pixel(x).flatten(2).transpose(1, 2)  # [B, HW, key]
        key = self.f_object(objects).flatten(2)  # [B, key, K]
        value = self.f_down(objects).flatten(2).transpose(1, 2)  # [B, K, key]

        def distribute(sim):
            ctx = torch.bmm(sim, value).transpose(1, 2).reshape(B, self.key_channels, H, W)
            return self.f_up(ctx)

        if gt_sim is not None:
            sim = gt_sim / gt_sim.sum(-1, keepdim=True).clamp(min=1e-12)
        else:
            sim = torch.softmax(torch.bmm(query, key) * self.key_channels ** -0.5, dim=-1)
        ctx = distribute(sim)
        if not self.use_bg:
            return ctx
        if gt_sim is None:
            raise ValueError("ObjectAttention(use_bg=True) needs the ground-truth gt_sim")
        bg = 1.0 - gt_sim
        return ctx, distribute(bg / bg.sum(-1, keepdim=True).clamp(min=1e-12))


class SpatialOCR(nn.Module):
    """ObjectAttention, concat ``[context, feats]``, 1x1 ConvBNReLU, dropout
    (SpatialOCR_Module, spatial_ocr_block.py:237-310); with ``use_bg``,
    ``[context, background, feats]``, or ``[background, feats]`` without
    ``use_oc``."""

    def __init__(self, in_channels: int, key_channels: int, out_channels: int,
                 dropout: float = 0.05, use_bg: bool = False, use_oc: bool = True):
        super().__init__()
        self.use_bg, self.use_oc = use_bg, use_oc
        parts = 3 if use_bg and use_oc else 2
        self.object_context_block = ObjectAttention(in_channels, key_channels, use_bg)
        self.conv_bn_dropout = nn.Sequential(
            *conv_bn_relu(parts * in_channels, out_channels, 1), nn.Dropout(dropout))

    def forward(self, feats: torch.Tensor, proxy: torch.Tensor,
                gt_sim: torch.Tensor | None = None) -> torch.Tensor:
        ctx = self.object_context_block(feats, proxy, gt_sim)
        if self.use_bg:
            ctx, bg = ctx
            parts = [ctx, bg, feats] if self.use_oc else [bg, feats]
        else:
            parts = [ctx, feats]
        return self.conv_bn_dropout(torch.cat(parts, dim=1))


class _OCRContext(nn.Module):
    """The attention slot of ``SpatialOCRASP.context`` (the reference's
    SpatialOCR_Context): ``object_context_block`` on (feats, proxy)."""

    def __init__(self, in_channels: int, key_channels: int):
        super().__init__()
        self.object_context_block = ObjectAttention(in_channels, key_channels)

    def forward(self, feats: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
        return self.object_context_block(feats, proxy)


class SpatialOCRASP(nn.Module):
    """ASPP with a probability-conditioned OCR context branch."""

    def __init__(self, in_channels: int, hidden: int = 256, out_channels: int = 512,
                 dilations: tuple[int, ...] = (12, 24, 36), dropout: float = 0.1):
        super().__init__()
        self.context = nn.Sequential(*conv_bn_relu(in_channels, hidden, 3),
                                     _OCRContext(hidden, hidden // 2))
        self.gather = SpatialGather()
        self.conv2 = conv_bn_relu(in_channels, hidden, 1)
        for i, d in enumerate(dilations, 3):
            self.add_module(f"conv{i}", conv_bn_relu(in_channels, hidden, 3, dilation=d))
        self.n_branches = len(dilations) + 2
        self.conv_bn_dropout = nn.Sequential(
            *conv_bn_relu(self.n_branches * hidden, out_channels, 1), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """``x`` [B, C, H, W], ``probs`` [B, K, H, W] (the DSN logits)."""
        feats = self.context[1](self.context[0](x))
        branches = [self.context[2](feats, self.gather(feats, probs))]
        branches += [getattr(self, f"conv{i}")(x) for i in range(2, self.n_branches + 1)]
        return self.conv_bn_dropout(torch.cat(branches, dim=1))
