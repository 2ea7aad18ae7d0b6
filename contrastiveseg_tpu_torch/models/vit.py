"""ViT encoder and the SETR decoders (NCHW inside, NHWC at the net's edge).

Counterpart of ``contrastiveseg_tpu/models/vit.py`` (the reference's SETR,
lib/models/backbones/vit/setr.py, transformer.py, position_encoding.py):

* ``ViT``: a linear patch embed, a learned position table, a pre-norm
  transformer (``qkv`` without a bias, LayerNorm epsilon 1e-5, exact-erf
  GELU), ``pre_head_ln``; it returns the normalised last layer on the patch
  grid and the raw outputs of the 1-indexed ``spec.aux_layers``.
* ``ViTFeatures``: the backbone-selector adapter, the taps with the deepest
  replaced by the final output (JAX :173, kept).
* ``SETR``: the encoder and the ``naive``, ``pup`` or ``mla`` decoder; all
  upsamples are half-pixel bilinear (``ops/resize.py``).

Attention is one matmul-softmax-dropout-matmul chain a block, as in the JAX
package.  Module names are the reference's torch keys
(``utils/torch_import._setr_encoder_path``, ``_setr_path``): SETR subclasses
the encoder, as the reference's SETR subclasses SegmentationTransformer, so
its keys are ``linear_encoding``, ``position_encoding.pe``,
``transformer.net.{2i}.fn.{norm,fn.qkv,fn.proj}`` and
``transformer.net.{2i+1}.fn.{norm,fn.net.0,fn.net.3}`` (one block is two
entries of ``transformer.net``), ``pre_head_ln`` and the decoder's.
``linear_encoding`` is the reference's ``Linear`` over patches flattened
pixels row-major, channels fastest; the forward runs it as the strided
convolution it equals (the JAX package's conv kernel is that weight
reshaped, ``_patch_linear_to_conv``).

The position table has ``gh * gw`` rows for the grid of the input the JAX
``model.init`` sees, the train crop: the port takes the grid at
construction.  An input on another grid, or whose sides are not multiples
of the patch (the JAX reshape fails on it), raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from contrastiveseg_tpu_torch.models.layers import (
    TorchBatchNorm,
    Upsample,
    bf16_compute,
    conv,
    fp32,
)

LN_EPS = 1e-5  # SETR's LayerNorms (JAX vit.py:90,107,157)


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    """Encoder hyperparameters (setr.py's S/L/H factories)."""

    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    hidden_dim: int = 3072
    dropout_rate: float = 0.1
    attn_dropout_rate: float = 0.1
    aux_layers: tuple[int, ...] = (3, 6, 9, 12)


VIT_SPECS = {
    "vit_small": ViTSpec(embed_dim=768, depth=12, num_heads=12, hidden_dim=3072,
                         aux_layers=(3, 6, 9, 12)),
    "vit_base": ViTSpec(embed_dim=768, depth=12, num_heads=12, hidden_dim=3072,
                        aux_layers=(3, 6, 9, 12)),
    "vit_large": ViTSpec(embed_dim=1024, depth=24, num_heads=16, hidden_dim=4096,
                         aux_layers=(6, 12, 18, 24)),
    "vit_huge": ViTSpec(embed_dim=1280, depth=32, num_heads=16, hidden_dim=5120,
                        aux_layers=(8, 16, 24, 32)),
}


class _SelfAttention(nn.Module):
    """Bias-free ``qkv``; softmax, ``attn_drop``, ``proj``, ``proj_drop``."""

    def __init__(self, dim: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.attn_drop = nn.Dropout(dropout)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        h = (self.attn_drop(attn) @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj_drop(self.proj(h))


class _PreNorm(nn.Module):
    """``fn(norm(x))`` (the reference's PreNorm; keys ``norm``, ``fn``)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class _Residual(nn.Module):
    """``x + drop(fn(x))`` (Residual; ``drop`` is PreNormDrop's outer dropout,
    the identity for the feed-forward half)."""

    def __init__(self, fn: nn.Module, dropout: float | None = None):
        super().__init__()
        self.fn = fn
        self.dropout = nn.Dropout(dropout) if dropout is not None else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dropout(self.fn(x))


class _FeedForward(nn.Module):
    """fc1 (``net.0``), erf GELU, dropout, fc2 (``net.3``), dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
                                 nn.Linear(hidden_dim, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def SETRBlock(dim: int, num_heads: int, hidden_dim: int, dropout: float,  # noqa: N802
              attn_dropout: float) -> list[nn.Module]:
    """One encoder block (the JAX ``SETRBlock``): ``x + drop(attn(LN(x)))``,
    then ``x + FF(LN(x))``, as the reference's two ``transformer.net``
    entries."""
    return [_Residual(_PreNorm(dim, _SelfAttention(dim, num_heads, attn_dropout)), dropout),
            _Residual(_PreNorm(dim, _FeedForward(dim, hidden_dim, dropout)))]


class ViT(nn.Module):
    """SegmentationTransformer's encoder on a fixed ``grid`` (gh, gw)."""

    def __init__(self, spec: ViTSpec, grid: tuple[int, int]):
        super().__init__()
        self.spec, self.grid = spec, tuple(grid)
        p, d = spec.patch_size, spec.embed_dim
        self.linear_encoding = nn.Linear(p * p * 3, d)
        self.position_encoding = nn.Module()
        self.position_encoding.pe = nn.Embedding(self.grid[0] * self.grid[1], d)
        self.pe_dropout = nn.Dropout(spec.dropout_rate)
        self.transformer = nn.Module()
        self.transformer.net = nn.Sequential(*[
            m for _ in range(spec.depth)
            for m in SETRBlock(d, spec.num_heads, spec.hidden_dim, spec.dropout_rate,
                               spec.attn_dropout_rate)])
        self.pre_head_ln = nn.LayerNorm(d, eps=LN_EPS)

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """The position table from ``generator``, N(0, 0.02) as in JAX."""
        pe = self.position_encoding.pe.weight
        pe.copy_(0.02 * torch.randn(pe.shape, generator=generator))

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """NCHW images -> (pre_head_ln'd last layer [B, D, gh, gw], the raw
        outputs of the aux layers on the same grid)."""
        s, (B, _, H, W) = self.spec, x.shape
        p, d = s.patch_size, s.embed_dim
        if H % p or W % p or (H // p, W // p) != self.grid:
            raise ValueError(
                f"ViT patch grid: a {H}x{W} input is not a {self.grid[0]}x{self.grid[1]} grid "
                f"of {p}x{p} patches; the position table is sized by the train crop "
                "(train.data_transformer.input_size), as the JAX model.init sizes it.  Run "
                "the net at that size: test.mode=sscrop_test with test.crop_size the train "
                "crop")
        gh, gw = self.grid
        w = self.linear_encoding.weight.view(d, p, p, 3).permute(0, 3, 1, 2)
        h = F.conv2d(x, w, self.linear_encoding.bias, stride=p)
        pe = self.position_encoding.pe.weight.to(h.dtype)  # JAX pos.astype(x.dtype)
        h = self.pe_dropout(h.flatten(2).transpose(1, 2) + pe)
        taps = []
        for i in range(s.depth):
            h = self.transformer.net[2 * i + 1](self.transformer.net[2 * i](h))
            if i + 1 in s.aux_layers:
                taps.append(h.transpose(1, 2).reshape(B, d, gh, gw))
        final = self.pre_head_ln(h).transpose(1, 2).reshape(B, d, gh, gw)
        return final, taps


class ViTFeatures(nn.Module):
    """Backbone adapter: NCHW -> the aux taps with the deepest replaced by
    the final output, all on the patch grid."""

    def __init__(self, spec: ViTSpec, grid: tuple[int, int]):
        super().__init__()
        self.vit = ViT(spec, grid)
        self.out_channels = [spec.embed_dim] * max(len(spec.aux_layers), 1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        final, taps = self.vit.encode(x)
        return taps[:-1] + [final] if taps else [final]


class SETR(ViT):
    """SETR Naive / PUP / MLA: NHWC images -> ``{"seg": NHWC logits at the
    input size}``."""

    reference_layout = True
    # The reference builds net1_intmd and never calls it (setr.py:364-367;
    # torch_import._setr_path): a reference MLA .pth carries its keys.
    reference_unused = ("net1_intmd.",)

    def __init__(self, num_classes: int, arch: str = "vit_base", decoder: str = "pup",
                 spec: ViTSpec | None = None, grid: tuple[int, int] = (14, 14),
                 bf16: bool = False):
        super().__init__(spec if spec is not None else VIT_SPECS[arch], grid)
        self.bf16 = bf16
        if decoder not in ("naive", "pup", "mla"):
            raise ValueError(f"unknown SETR decoder {decoder!r}; naive, pup or mla")
        self.decoder = decoder
        emb, p = self.spec.embed_dim, self.spec.patch_size
        if decoder == "naive":
            self.conv1 = conv(emb, emb, 1, bias=True)
            self.bn1 = TorchBatchNorm(emb)
            self.conv2 = conv(emb, num_classes, 1, bias=True)
            self.up = Upsample(p)
        elif decoder == "pup":
            chans = [emb] + [emb // 4] * 4 + [num_classes]
            layers = []
            for i in range(5):
                layers.append(conv(chans[i], chans[i + 1], 1, bias=True))
                if i != 4:
                    layers.append(Upsample(2))
            self.decode_net = nn.Sequential(*layers)
        else:
            if len(self.spec.aux_layers) != 4:
                raise ValueError("SETR-MLA needs 4 aux layers")
            for k in range(4):
                setattr(self, f"net{k + 1}_in",
                        nn.ModuleDict({"layer_1": conv(emb, emb // 2, 1, bias=True)}))
                if k:
                    setattr(self, f"net{k + 1}_intmd", nn.ModuleDict(
                        {"layer_intmd": conv(emb // 2, emb // 2, 3, bias=True)}))
                setattr(self, f"net{k + 1}_out", nn.ModuleDict({
                    "layer_2": conv(emb // 2, emb // 2, 3, bias=True),
                    "layer_3": conv(emb // 2, emb // 4, 3, bias=True)}))
            self.output_net = nn.ModuleDict({"conv_1": conv(emb, num_classes, 1, bias=True)})
            self.up = Upsample(4)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """In a bf16 net the encoder computes in bf16 and the decoder in fp32
        on the upcast features (JAX ``vit.py:198,206,219``)."""
        with bf16_compute(self.bf16, x):
            f, taps = self.encode(x.permute(0, 3, 1, 2))
        f, taps = fp32(f), [fp32(t) for t in taps]
        if self.decoder == "naive":
            seg = self.up(self.conv2(torch.relu(self.bn1(self.conv1(f)))))
        elif self.decoder == "pup":
            seg = self.decode_net(f)
        else:  # the taps deepest first (the reference's all_keys.reverse())
            outs, run = [], None
            for k, t in enumerate(taps[::-1]):
                cin = getattr(self, f"net{k + 1}_in")["layer_1"](t)
                run = cin if run is None else cin + run
                h = run if k == 0 else getattr(self, f"net{k + 1}_intmd")["layer_intmd"](run)
                out = getattr(self, f"net{k + 1}_out")
                outs.append(self.up(out["layer_3"](out["layer_2"](h))))
            seg = self.up(self.output_net["conv_1"](torch.cat(outs, dim=1)))
        return {"seg": seg.permute(0, 2, 3, 1)}
