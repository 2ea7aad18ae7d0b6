"""Pyramid Vision Transformer backbones (PVT v1, PCPVT, Twins-SVT), NCHW.

Counterpart of ``contrastiveseg_tpu/models/pvt.py`` (the reference's
lib/models/backbones/pvt/{pvt,pcpvt,svt}_backbone.py): four stages of patch
merge (a strided conv and a LayerNorm) and transformer blocks with
spatial-reduction attention (``SRAttention``: keys and values from an sr x
sr strided conv of the map); PCPVT adds a 3x3 depthwise position conv after
each stage's first block; SVT alternates locally-grouped attention in w x w
windows (``LocalAttention``) with the global one; PVT v1 adds a learned
position table a stage.  ``PVT`` returns the maps at strides 4, 8, 16, 32.

It follows the JAX package's flax defaults where they differ from the
reference's torch (ROADMAP section 3):

* every LayerNorm has epsilon 1e-6 (flax's default; the reference's 1e-5 and
  1e-6 vary by file);
* the MLP's GELU is the tanh approximation (flax's ``nn.gelu``);
* the strided convs (patch merges and ``sr``) pad "SAME": a side that is no
  multiple of the stride gives ``ceil(n / s)`` outputs, padded low by half
  the shortfall (rounded down), high by the rest.  At a 520 crop the stage
  grids are 130, 65, 33 and 17, where the reference's 32 and 16;
* PVT v1's tables are sized ``img_size // (4 * 2**stage)`` and resized
  (half-pixel bilinear, no antialiasing: ``jax.image.resize(method=
  "linear")``) to any other running grid, so at a 520 crop the last two
  are resized in training too.

SVT's window mask is -1000 wherever a query's and a key's padded-ness
differ; when only one of the two pads is 0, the reference's ``-0:`` slice
fills the whole mask, which turns the masking off, and both packages keep
that.

Module names are the reference's keys (``utils/torch_import.
_pvt_family_path``, ``_pvt_block``): v1 ``patch_embed{1..4}.{proj,norm}``,
``pos_embed{1..4}`` ([1, N, C], the reference's layout), ``block{1..4}.{b}``;
PCPVT and SVT ``patch_embeds.{i}``, ``blocks.{i}.{b}``, ``pos_block.{i}.proj.0``.
A block is ``norm1``, ``attn`` (``q``, ``kv`` (keys then values, one
``Linear``), ``sr``, ``norm``, ``proj``; SVT's local ``qkv``, ``proj``),
``norm2``, ``mlp.fc1``, ``mlp.fc2``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from contrastiveseg_tpu_torch.models.layers import fp32, full_precision
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_half_pixel_nchw

LN_EPS = 1e-6  # flax nn.LayerNorm's default (JAX pvt.py:85,168,176,206)


@dataclasses.dataclass(frozen=True)
class PVTSpec:
    dims: tuple[int, ...] = (64, 128, 320, 512)
    depths: tuple[int, ...] = (3, 4, 6, 3)
    heads: tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratios: tuple[float, ...] = (8.0, 8.0, 4.0, 4.0)
    pos_cnn: bool = False  # PCPVT conditional position encoding
    local_windows: tuple[int, ...] | None = None  # SVT locally-grouped attention
    abs_pos_embed: bool = False  # PVT v1's learned position tables


_SVT = dict(pos_cnn=True, local_windows=(7, 7, 7, 7), mlp_ratios=(4.0, 4.0, 4.0, 4.0))
PVT_SPECS = {
    "pvt_tiny": PVTSpec(depths=(2, 2, 2, 2), abs_pos_embed=True),
    "pvt_small": PVTSpec(abs_pos_embed=True),
    "pvt_medium": PVTSpec(depths=(3, 4, 18, 3), abs_pos_embed=True),
    "pvt_large": PVTSpec(depths=(3, 8, 27, 3), abs_pos_embed=True),
    "pcpvt_tiny": PVTSpec(depths=(2, 2, 2, 2), pos_cnn=True),
    "pcpvt_small": PVTSpec(pos_cnn=True),
    "pcpvt_medium": PVTSpec(depths=(3, 4, 18, 3), pos_cnn=True),
    "pcpvt_base": PVTSpec(depths=(3, 4, 18, 3), pos_cnn=True),
    "pcpvt_large": PVTSpec(depths=(3, 8, 27, 3), pos_cnn=True),
    "svt_small": PVTSpec(dims=(64, 128, 256, 512), heads=(2, 4, 8, 16),
                         depths=(2, 2, 10, 4), **_SVT),
    "svt_base": PVTSpec(dims=(96, 192, 384, 768), heads=(3, 6, 12, 24),
                        depths=(2, 2, 18, 2), **_SVT),
    "svt_large": PVTSpec(dims=(128, 256, 512, 1024), heads=(4, 8, 16, 32),
                         depths=(2, 2, 18, 2), **_SVT),
}


def same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (no padding of its own) on ``x`` padded as XLA's "SAME":
    ``ceil(n / s)`` outputs a side."""
    pads = []
    for n, k, s in zip(x.shape[:1:-1], conv.kernel_size[::-1], conv.stride[::-1]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads) if any(pads) else x)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """[B, h, n, d] queries, [B, h, m, d] keys and values -> [B, h, n, d];
    ``bias`` [G, n, m] is added to each of G consecutive groups of the
    batch (the windows of an image).  The products and the softmax in fp32,
    the weights rounded to v's dtype (JAX ``pvt.py:95-98``: bf16 in a bf16
    net)."""
    with full_precision(q):
        att = (fp32(q) @ fp32(k).transpose(-2, -1)) * q.shape[-1] ** -0.5
        if bias is not None:
            G = bias.shape[0]
            att = (att.unflatten(0, (-1, G)) + bias[None, :, None]).flatten(0, 1)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        return (fp32(att) @ fp32(v)).to(v.dtype)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, n, C] -> [B, heads, n, C / heads]."""
    B, n, C = x.shape
    return x.reshape(B, n, num_heads, C // num_heads).transpose(1, 2)


class SRAttention(nn.Module):
    """Spatial-reduction attention; ``kv`` is the reference's fused key and
    value ``Linear`` (keys in its first ``dim`` rows)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] (channels last, as the blocks run) -> same."""
        B, H, W, C = x.shape
        q = _heads(self.q(x).reshape(B, H * W, C), self.num_heads)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(same_conv(self.sr, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        k, v = self.kv(kv_in.flatten(1, 2)).chunk(2, dim=-1)
        out = _attention(q, _heads(k, self.num_heads), _heads(v, self.num_heads))
        return self.proj(out.transpose(1, 2).reshape(B, H, W, C))


def _window_bias(H: int, W: int, w: int) -> np.ndarray:
    """[windows, w*w, w*w] additive mask of the padded grid (JAX
    pvt.py:128-146, with the reference's ``-0:`` quirk)."""
    ph, pw = (-H) % w, (-W) % w
    Hp, Wp = H + ph, W + pw
    m = np.zeros((Hp, Wp), np.float32)
    m[Hp - ph if ph > 0 else 0:, :] = 1
    m[:, Wp - pw if pw > 0 else 0:] = 1
    m = m.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(m[:, None, :] - m[:, :, None] != 0.0, -1000.0, 0.0).astype(np.float32)


class LocalAttention(nn.Module):
    """Locally-grouped attention in ``window`` x ``window`` windows of the
    map zero-padded at the bottom and right (SVT's GroupAttention)."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        w = self.window
        ph, pw = (-H) % w, (-W) % w
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        nh, nw = Hp // w, Wp // w
        xw = x.reshape(B, nh, w, nw, w, C).transpose(2, 3).reshape(B * nh * nw, w * w, C)
        q, k, v = (_heads(t, self.num_heads) for t in self.qkv(xw).chunk(3, dim=-1))
        bias = None
        if ph or pw:
            bias = torch.from_numpy(_window_bias(H, W, w)).to(x.device, q.dtype)
        out = _attention(q, k, v, bias).transpose(1, 2).reshape(B, nh, nw, w, w, C)
        out = out.transpose(2, 3).reshape(B, Hp, Wp, C)[:, :H, :W]
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PVTBlock(nn.Module):
    """Pre-norm block: ``x + attn(norm1(x))``, ``x + mlp(norm2(x))``, on a
    channels-last [B, H, W, C] map."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: float,
                 local_window: int | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = (LocalAttention(dim, num_heads, local_window) if local_window
                     else SRAttention(dim, num_heads, sr_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> channels-last [B, H', W', C]."""
        return self.norm(same_conv(self.proj, x).permute(0, 2, 3, 1))


class _PosCNN(nn.Module):
    """``proj.0``: the 3x3 depthwise conv whose output is added back."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1, groups=dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PVT(nn.Module):
    """NCHW images -> 4 NCHW maps at strides 4, 8, 16, 32.  ``img_size``
    sizes PVT v1's position tables (the reference reads the train
    ``input_size[0]``)."""

    def __init__(self, spec: PVTSpec, img_size: int = 224):
        super().__init__()
        self.spec = spec
        self.out_channels = list(spec.dims)
        self.v1 = not spec.pos_cnn  # the PVT v1 layout; PCPVT and SVT share theirs
        cin = 3
        for i in range(4):
            patch = _PatchEmbed(cin, spec.dims[i], 4 if i == 0 else 2)
            blocks = nn.ModuleList(
                PVTBlock(spec.dims[i], spec.heads[i], spec.sr_ratios[i], spec.mlp_ratios[i],
                         spec.local_windows[i] if spec.local_windows and b % 2 == 0 else None)
                for b in range(spec.depths[i]))
            if self.v1:
                setattr(self, f"patch_embed{i + 1}", patch)
                setattr(self, f"block{i + 1}", blocks)
                if spec.abs_pos_embed:
                    g = img_size // (4 << i)
                    setattr(self, f"pos_embed{i + 1}",
                            nn.Parameter(torch.zeros(1, g * g, spec.dims[i])))
            else:
                if i == 0:
                    self.patch_embeds, self.blocks = nn.ModuleList(), nn.ModuleList()
                    self.pos_block = nn.ModuleList()
                self.patch_embeds.append(patch)
                self.blocks.append(blocks)
                self.pos_block.append(_PosCNN(spec.dims[i]))
            cin = spec.dims[i]

    def _stage(self, i: int):
        if self.v1:
            return (getattr(self, f"patch_embed{i + 1}"), getattr(self, f"block{i + 1}"),
                    getattr(self, f"pos_embed{i + 1}", None), None)
        return self.patch_embeds[i], self.blocks[i], None, self.pos_block[i]

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """v1's position tables from ``generator``, as flax's
        ``truncated_normal(0.02)``: a standard normal truncated to [-2, 2],
        scaled to a standard deviation of 0.02."""
        for i in range(4):
            pe = self._stage(i)[2]
            if pe is not None:
                nn.init.trunc_normal_(pe, generator=generator).mul_(0.02 / 0.87962566103423978)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i in range(4):
            patch, blocks, pe, pos_cnn = self._stage(i)
            x = patch(x)
            if pe is not None:
                B, h, w, C = x.shape
                g = math.isqrt(pe.shape[1])
                table = pe.reshape(1, g, g, C)
                if (g, g) != (h, w):
                    with full_precision(x):
                        table = resize_bilinear_half_pixel_nchw(
                            table.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
                x = x + table.to(x.dtype)
            for b, block in enumerate(blocks):
                x = block(x)
                if b == 0 and pos_cnn is not None:
                    x = pos_cnn(x)
            x = x.permute(0, 3, 1, 2)
            feats.append(x)
        return feats
