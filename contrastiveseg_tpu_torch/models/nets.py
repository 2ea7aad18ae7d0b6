"""The HRNet contrast segmentor and the port's model registry.

Counterpart of ``HRNetSeg`` in ``contrastiveseg_tpu/models/nets.py``
(:34-115; reference HRNet_W48_CONTRAST, lib/models/nets/hrnet.py:60-95).
The contrast nets return ``{"seg": stride-4 logits, "embed": L2-normalized
stride-4 projections}`` in NHWC, like the JAX package; inside, the model
runs NCHW and permutes once, here.  ``hrnet_w48_mem`` is the same module as
``hrnet_w48_contrast``: the memory bank lives in the train state.  The
registry mirrors the JAX package's HRNet contrast names at every width
(``hrnet_w{18,32,48,64}_{contrast,mem}``).
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.heads import ClsHead, ProjectionHead
from contrastiveseg_tpu_torch.models.hrnet import HRNET_SPECS, HRNet
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


class HRNetSeg(nn.Module):
    """HRNet-W* contrast segmentor: backbone, 4-branch fuse, cls + proj heads."""

    def __init__(self, num_classes: int, arch: str = "hrnet48",
                 proj_dim: int = 256, head_dropout: float = 0.10,
                 pallas_conv: bool = False):
        super().__init__()
        spec = HRNET_SPECS[arch]
        width = sum(spec.out_channels)  # 720 for hrnet48
        self.backbone = HRNet(spec, pallas_conv=pallas_conv)
        self.cls_head = ClsHead(width, num_classes, width, head_dropout)
        self.proj_head = ProjectionHead(width, proj_dim)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """``x``: NHWC images -> NHWC ``seg`` and ``embed`` at stride 4."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        h, w = feats[0].shape[2], feats[0].shape[3]
        cat = torch.cat(
            [feats[0]] + [resize_bilinear_align_corners_nchw(f, (h, w))
                          for f in feats[1:]], dim=1)
        seg = self.cls_head(cat)
        embed = self.proj_head(cat)
        return {"seg": seg.permute(0, 2, 3, 1),
                "embed": embed.permute(0, 2, 3, 1)}


def _hrnet_contrast(arch: str):
    def build(cfg) -> HRNetSeg:
        return HRNetSeg(
            num_classes=cfg.get("data.num_classes"),
            arch=arch,
            proj_dim=cfg.get("contrast.proj_dim", default=256),
            head_dropout=cfg.get("network.head_dropout", default=0.10),
            pallas_conv=cfg.get("network.pallas_conv", default=False),
        )

    return build


MODELS = {f"hrnet_w{w}_{kind}": _hrnet_contrast(f"hrnet{w}")
          for w in (18, 32, 48, 64) for kind in ("contrast", "mem")}

# Config switches of the JAX HRNetSeg that the port does not have yet; a
# config that turns one on is refused rather than silently ignored.
_NOT_PORTED = {
    "network.bf16": "bf16 compute",
    "network.lane_pad": "a TPU layout variant",
    "network.full_res_stem": "ROADMAP 13 (other models)",
    "network.drop_stage4": "ROADMAP 13 (other models)",
    "network.keep_imagenet_head": "ROADMAP 13 (other models)",
}


def build_model(cfg) -> HRNetSeg:
    """ModelManager.semantic_segmentor for the models the port has."""
    name = cfg.get("network.model_name")
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; the port has {sorted(MODELS)}")
    for key, what in _NOT_PORTED.items():
        if cfg.get(key, default=False):
            raise NotImplementedError(f"{key}=true is not ported yet: {what}")
    return MODELS[name](cfg)
