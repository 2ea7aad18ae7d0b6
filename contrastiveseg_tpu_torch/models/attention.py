"""Self-attention context modules: non-local, ISA, OC, pyramid OC, PSP,
ASP-OC and criss-cross (NCHW).

Counterpart of ``contrastiveseg_tpu/models/attention.py`` (:28-367):

  * ``SelfAttention2D``: scaled-dot self-attention over every pixel of the
    map, in two flavours.  ISA's (``w_bn``): bias-free ``f_value``, ``W`` a
    1x1 conv then BNReLU.  BaseOC's: biased ``f_value``, ``W`` one biased
    1x1 conv that starts at zero.  With ``scale`` > 1 the map is max-pooled
    first (floor sizes, window = stride) and the context resized back
    (align corners) after.  Similarity and softmax are fp32, scaled by
    ``key_channels ** -0.5``;
  * ``ISABlock`` / ``ISAModule``: interlaced sparse attention, the map
    zero-padded symmetrically to a multiple of the down factor (the odd
    row or column at the bottom or right), attention across blocks, then
    within them, then the crop; several factors concatenate, with the input
    lifted by ``up_conv``; then the residual concat and ``conv_bn``;
  * ``BaseOCModule`` (attention, concat with the input, 1x1 ConvBNReLU,
    dropout), ``BaseOCContextModule`` (scale-2 attention, BNReLU, dropout)
    and ``ASPOCModule`` (that context beside a 1x1 and three dilated 3x3
    branches, concatenated and projected);
  * ``PyramidOCModule``: ISA-flavoured attention inside the s x s cells of
    levels 1, 2, 3 and 6, padded and cropped as ISA's blocks;
  * ``PSPModule``: pyramid pooling whose bins truncate the map to
    ``(H // s) * s`` rows and ``(W // s) * s`` columns and average equal
    bins, as the JAX package does.  That is not
    ``F.adaptive_avg_pool2d``, whose bins are ragged and overlap;
  * ``CCModule``: recurrent criss-cross attention
    (``ops/cc_attention.py``), its query, key and value convs shared by the
    recurrences, ``gamma`` starting at zero.

The products are ``torch.bmm`` (XLA einsums in the JAX package; no Pallas
kernel lies on this path).  The dropouts are element-wise ``nn.Dropout``,
as in the JAX package.  Module names are the reference's torch keys where
the reference has the module (``utils/torch_import._self_attention``,
``base_ocnet_path``, ``asp_ocnet_path``, ``isanet_path``): ``f_query``,
``f_key`` (``[conv, BNReLU, conv, BNReLU]``), ``f_value``, ``W``;
``stages``, ``conv_bn``, ``up_conv``, ``conv_bn_dropout``;
``context``, ``conv2``-``conv5``.  The reference never registers the
pyramid OC, PSP and criss-cross nets, so those modules keep the JAX
package's names (``attn_s{s}``, ``project``; ``stage{i}``,
``bottleneck``; ``conva``, ``query``, ``key``, ``value``, ``gamma``,
``convb``).  ``HANetConv`` is not ported (ROADMAP 7).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from contrastiveseg_tpu_torch.models.heads import bn_relu, conv_bn_relu
from contrastiveseg_tpu_torch.models.layers import ConvBN, conv, fp32, full_precision
from contrastiveseg_tpu_torch.ops.cc_attention import criss_cross_attention
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


class SelfAttention2D(nn.Module):
    """Non-local attention over the whole map (SelfAttentionBlock2D /
    _SelfAttentionBlock)."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 out_channels: int, w_bn: bool = True, scale: int = 1):
        super().__init__()
        self.key_channels, self.value_channels, self.scale = key_channels, value_channels, scale

        def double():
            return nn.Sequential(conv(in_channels, key_channels, 1), bn_relu(key_channels),
                                 conv(key_channels, key_channels, 1), bn_relu(key_channels))

        self.f_query = double()
        self.f_key = double()
        self.f_value = conv(in_channels, value_channels, 1, bias=not w_bn)
        self.W = (conv_bn_relu(value_channels, out_channels, 1) if w_bn
                  else conv(value_channels, out_channels, 1, bias=True, zero_init=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[2:]
        if self.scale > 1:
            x = F.max_pool2d(x, self.scale, self.scale)
        B, _, H, W = x.shape
        q = self.f_query(x).flatten(2).transpose(1, 2)  # [B, N, key]
        k = self.f_key(x).flatten(2)  # [B, key, N]
        v = self.f_value(x).flatten(2).transpose(1, 2)  # [B, N, value]
        with full_precision(x):  # JAX attention.py:69,74
            sim = torch.softmax(torch.bmm(fp32(q), fp32(k)) * self.key_channels ** -0.5, dim=-1)
            ctx = torch.bmm(fp32(sim.to(v.dtype)), fp32(v)).to(x.dtype)
        ctx = ctx.transpose(1, 2).reshape(B, self.value_channels, H, W)
        ctx = self.W(ctx)
        if self.scale > 1:
            ctx = resize_bilinear_align_corners_nchw(ctx, tuple(size))
        return ctx


def _pad_to(x: torch.Tensor, fh: int, fw: int) -> tuple[torch.Tensor, int, int]:
    """``x`` zero-padded to multiples of (fh, fw), ``ph // 2`` rows on top and
    ``pw // 2`` columns on the left; returns it and (top, left)."""
    h, w = x.shape[2:]
    ph, pw = math.ceil(h / fh) * fh - h, math.ceil(w / fw) * fw - w
    if ph or pw:
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x, ph // 2, pw // 2


class ISABlock(nn.Module):
    """Interlaced sparse self-attention: long range across the
    ``down_factor`` blocks, short range within each."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 out_channels: int, down_factor: tuple[int, int] = (8, 8)):
        super().__init__()
        self.down_factor = tuple(down_factor)
        self.long_range_sa = SelfAttention2D(in_channels, key_channels, value_channels,
                                             out_channels)
        self.short_range_sa = SelfAttention2D(out_channels, key_channels, value_channels,
                                              out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        dh, dw = self.down_factor
        x, top, left = _pad_to(x, dh, dw)
        oh, ow = x.shape[2] // dh, x.shape[3] // dw
        # long range: the pixels of one intra-block position, across blocks.
        f = x.reshape(n, c, oh, dh, ow, dw).permute(0, 3, 5, 1, 2, 4)
        f = self.long_range_sa(f.reshape(n * dh * dw, c, oh, ow))
        co = f.shape[1]
        # short range: within each block.
        f = f.reshape(n, dh, dw, co, oh, ow).permute(0, 4, 5, 3, 1, 2)
        f = self.short_range_sa(f.reshape(n * oh * ow, co, dh, dw))
        f = f.reshape(n, oh, ow, co, dh, dw).permute(0, 3, 1, 4, 2, 5)
        f = f.reshape(n, co, oh * dh, ow * dw)
        return f[:, :, top:top + h, left:left + w]


class ISAModule(nn.Module):
    """ISA blocks (one per down factor), concatenated with the input (lifted
    by ``up_conv`` when there are several), then ``conv_bn`` and dropout."""

    def __init__(self, in_channels: int, key_channels: int = 256, value_channels: int = 512,
                 out_channels: int = 512, down_factors=((8, 8),), dropout: float = 0.05):
        super().__init__()
        n = len(down_factors)
        self.stages = nn.ModuleList(
            ISABlock(in_channels, key_channels, value_channels, out_channels, tuple(f))
            for f in down_factors)
        self.up_conv = conv_bn_relu(in_channels, n * out_channels, 1) if n > 1 else None
        lifted = n * out_channels if n > 1 else in_channels
        self.conv_bn = conv_bn_relu(lifted + n * out_channels, out_channels, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = torch.cat([stage(x) for stage in self.stages], dim=1)
        if self.up_conv is not None:
            x = self.up_conv(x)
        return self.dropout(self.conv_bn(torch.cat([x, context], dim=1)))


class BaseOCModule(nn.Module):
    """BaseOC_Module: BaseOC attention, concat ``[context, x]``, 1x1
    ConvBNReLU, dropout."""

    def __init__(self, in_channels: int, key_channels: int = 256, value_channels: int = 256,
                 out_channels: int = 512, dropout: float = 0.05):
        super().__init__()
        self.stages = nn.ModuleList([SelfAttention2D(
            in_channels, key_channels, value_channels, out_channels, w_bn=False)])
        self.conv_bn_dropout = nn.Sequential(
            *conv_bn_relu(out_channels + in_channels, out_channels, 1), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_bn_dropout(torch.cat([self.stages[0](x), x], dim=1))


class BaseOCContextModule(nn.Module):
    """BaseOC_Context_Module: scale-pooled BaseOC attention, BNReLU and
    dropout; no concat with the input."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 out_channels: int, scale: int = 2, dropout: float = 0.0):
        super().__init__()
        self.stages = nn.ModuleList([SelfAttention2D(
            in_channels, key_channels, value_channels, out_channels, w_bn=False, scale=scale)])
        self.conv_bn_dropout = nn.Sequential(bn_relu(out_channels), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_bn_dropout(self.stages[0](x))


class ASPOCModule(nn.Module):
    """ASP_OC_Module: five branches of ``out_features`` channels (a 3x3
    ConvBNReLU then the scale-2 BaseOC context; a 1x1; three dilated
    3x3), concatenated, 1x1 ConvBNReLU to ``2 * out_features``, dropout 0.1."""

    def __init__(self, in_channels: int, out_features: int = 256,
                 rates: tuple[int, ...] = (12, 24, 36)):
        super().__init__()
        of = out_features
        self.context = nn.Sequential(
            *conv_bn_relu(in_channels, of, 3),
            BaseOCContextModule(of, of // 2, of // 2, of, scale=2))
        self.conv2 = conv_bn_relu(in_channels, of, 1)
        for i, r in enumerate(rates, 3):
            self.add_module(f"conv{i}", conv_bn_relu(in_channels, of, 3, dilation=r))
        self.n_branches = len(rates) + 2
        self.conv_bn_dropout = nn.Sequential(
            *conv_bn_relu(self.n_branches * of, 2 * of, 1), nn.Dropout(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.context(x)] + [getattr(self, f"conv{i}")(x)
                                        for i in range(2, self.n_branches + 1)]
        return self.conv_bn_dropout(torch.cat(branches, dim=1))


class PyramidOCModule(nn.Module):
    """Pyramid object context: at each level s, ISA-flavoured attention
    inside each of the s x s cells (padded to a multiple of s as ISA pads),
    the levels concatenated with the input, 1x1 ``project``, dropout."""

    def __init__(self, in_channels: int, key_channels: int = 256, value_channels: int = 256,
                 out_channels: int = 512, levels: tuple[int, ...] = (1, 2, 3, 6),
                 dropout: float = 0.05):
        super().__init__()
        self.levels = tuple(levels)
        for s in self.levels:
            self.add_module(f"attn_s{s}", SelfAttention2D(
                in_channels, key_channels, value_channels, value_channels))
        self.project = ConvBN(in_channels + len(self.levels) * value_channels, out_channels, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        ctxs = [x]
        for s in self.levels:
            f, top, left = _pad_to(x, s, s)
            oh, ow = f.shape[2] // s, f.shape[3] // s
            f = f.reshape(n, c, s, oh, s, ow).permute(0, 2, 4, 1, 3, 5)
            f = getattr(self, f"attn_s{s}")(f.reshape(n * s * s, c, oh, ow))
            v = f.shape[1]
            f = f.reshape(n, s, s, v, oh, ow).permute(0, 3, 1, 4, 2, 5).reshape(n, v, s * oh, s * ow)
            ctxs.append(f[:, :, top:top + h, left:left + w])
        return self.dropout(self.project(torch.cat(ctxs, dim=1)))


class PSPModule(nn.Module):
    """Pyramid pooling at sizes 1, 2, 3, 6: each a truncated equal-bin mean,
    1x1 ConvBNReLU (``stage{i}``), resized back (align corners);
    concatenated with the input, 3x3 ConvBNReLU ``bottleneck``, dropout 0.1."""

    def __init__(self, in_channels: int, out_channels: int = 512,
                 sizes: tuple[int, ...] = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        branch = out_channels // len(self.sizes)
        for i in range(len(self.sizes)):
            self.add_module(f"stage{i}", ConvBN(in_channels, branch, 1))
        self.bottleneck = ConvBN(in_channels + len(self.sizes) * branch, out_channels, 3)
        self.dropout = nn.Dropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        feats = [x]
        for i, s in enumerate(self.sizes):
            ph, pw = H // s, W // s
            p = x[:, :, :ph * s, :pw * s].reshape(B, C, s, ph, s, pw).mean(dim=(3, 5))
            feats.append(resize_bilinear_align_corners_nchw(getattr(self, f"stage{i}")(p), (H, W)))
        return self.dropout(self.bottleneck(torch.cat(feats, dim=1)))


class CCModule(nn.Module):
    """Recurrent criss-cross attention (RCCA): 3x3 ``conva``, then
    ``recurrence`` times ``y + gamma * CCA(y)`` with shared ``query``,
    ``key`` and ``value`` convs, 3x3 ``convb``, concat with the input, 3x3
    ``bottleneck``, dropout."""

    def __init__(self, in_channels: int, out_channels: int = 512, recurrence: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        self.recurrence = recurrence
        self.conva = ConvBN(in_channels, out_channels, 3)
        self.query = conv(out_channels, out_channels // 8, 1)
        self.key = conv(out_channels, out_channels // 8, 1)
        self.value = conv(out_channels, out_channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.convb = ConvBN(out_channels, out_channels, 3)
        self.bottleneck = ConvBN(in_channels + out_channels, out_channels, 3)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conva(x)
        for _ in range(self.recurrence):
            y = y + self.gamma * criss_cross_attention(self.query(y), self.key(y), self.value(y))
        y = self.convb(y)
        return self.dropout(self.bottleneck(torch.cat([x, y], dim=1)))
