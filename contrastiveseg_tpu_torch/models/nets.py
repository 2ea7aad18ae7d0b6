"""The HRNet segmentors and the port's model registry.

Counterpart of ``HRNetSeg`` in ``contrastiveseg_tpu/models/nets.py``
(:34-115; reference HRNet_W48 and HRNet_W48_CONTRAST,
lib/models/nets/hrnet.py:24-95), NHWC in and out like the JAX package;
inside, the model runs NCHW and permutes once, here.

* The contrast nets (``hrnet_w{18,32,48,64}_contrast``) return
  ``{"seg": stride-4 logits, "embed": L2-normalized stride-4
  projections}``; the loss upsamples ``seg``.  ``hrnet_w*_mem`` is the same
  module: the memory bank lives in the train state.
* The plain nets (``hrnet_w{18,32,48,64}``) have no projection head and
  return ``{"seg": logits upsampled to the input size}`` (``upsample_out``).

Module names follow the reference's torch keys, so the cls head has the
same keys in both.
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.heads import ClsHead, ProjectionHead
from contrastiveseg_tpu_torch.models.hrnet import HRNET_SPECS, HRNet
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


class HRNetSeg(nn.Module):
    """HRNet-W* segmentor: backbone, 4-branch fuse, cls head and, with
    ``with_proj``, the projection head."""

    def __init__(self, num_classes: int, arch: str = "hrnet48",
                 proj_dim: int = 256, head_dropout: float = 0.10,
                 pallas_conv: bool = False, with_proj: bool = True):
        super().__init__()
        spec = HRNET_SPECS[arch]
        width = sum(spec.out_channels)  # 720 for hrnet48
        self.backbone = HRNet(spec, pallas_conv=pallas_conv)
        self.cls_head = ClsHead(width, num_classes, width, head_dropout)
        self.proj_head = ProjectionHead(width, proj_dim) if with_proj else None

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """``x``: NHWC images -> NHWC ``seg`` (and ``embed``) at stride 4, or
        ``seg`` at the input size without the projection head."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        h, w = feats[0].shape[2], feats[0].shape[3]
        cat = torch.cat(
            [feats[0]] + [resize_bilinear_align_corners_nchw(f, (h, w))
                          for f in feats[1:]], dim=1)
        seg = self.cls_head(cat)
        if self.proj_head is None:
            seg = resize_bilinear_align_corners_nchw(seg, (x.shape[1], x.shape[2]))
            return {"seg": seg.permute(0, 2, 3, 1)}
        embed = self.proj_head(cat)
        return {"seg": seg.permute(0, 2, 3, 1),
                "embed": embed.permute(0, 2, 3, 1)}


def _hrnet(arch: str, with_proj: bool):
    def build(cfg) -> HRNetSeg:
        return HRNetSeg(
            num_classes=cfg.get("data.num_classes"),
            arch=arch,
            proj_dim=cfg.get("contrast.proj_dim", default=256),
            head_dropout=cfg.get("network.head_dropout", default=0.10),
            pallas_conv=cfg.get("network.pallas_conv", default=False),
            with_proj=with_proj,
        )

    return build


MODELS = {f"hrnet_w{w}{kind}": _hrnet(f"hrnet{w}", with_proj=bool(kind))
          for w in (18, 32, 48, 64) for kind in ("", "_contrast", "_mem")}

# Config switches of the JAX HRNetSeg that the port does not have yet; a
# config that turns one on is refused rather than silently ignored.
_NOT_PORTED = {
    "network.bf16": "ROADMAP 5 (training extras: bf16 compute)",
    "network.lane_pad": "a TPU layout variant",
    "network.full_res_stem": "ROADMAP 7 (other models)",
    "network.drop_stage4": "ROADMAP 7 (other models)",
    "network.keep_imagenet_head": "ROADMAP 7 (other models)",
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
