"""The segmentors of the port and its model registry.

Counterpart of ``contrastiveseg_tpu/models/nets.py``, NHWC in and out like
the JAX package; inside, the models run NCHW and permute once, here.

* ``HRNetSeg`` (:34-115; reference HRNet_W48 and HRNet_W48_CONTRAST,
  lib/models/nets/hrnet.py:24-95).  The contrast nets
  (``hrnet_w{18,32,48,64}_contrast``) return ``{"seg": stride-4 logits,
  "embed": L2-normalized stride-4 projections}``; the loss upsamples
  ``seg``.  ``hrnet_w*_mem`` is the same module: the memory bank lives in
  the train state.  The plain nets (``hrnet_w{18,32,48,64}``) have no
  projection head and return ``{"seg": logits upsampled to the input
  size}``.  ``hrnet2x20`` is the plain net on ``HRNetNext`` (:80-84, :324),
  its five branches fused at stride 2.
* ``HRNetOCRSeg`` (:118-187; reference HRNet_W48_OCR[_B][_CONTRAST]):
  ``hrnet_w*_ocr``, ``_ocr_contrast`` and ``_ocr_b``, with an aux head
  (``seg_aux``).
* ``DeepLabV3`` (:226-272; reference DeepLabV3[Contrast]) on a dilated
  ResNet (``network.backbone``): ``deeplab_v3`` and ``deeplab_v3_contrast``,
  with the ``layer_dsn`` aux head on c3.
* The context-head nets on a dilated ResNet, each with a DSN aux head on
  c3 (``seg_aux``) and its context head on c4, in the module layout of the
  reference net it ports: ``FcnNet`` (``fcnet``, and ``fcnet_wo_dsn``
  without the aux head; JAX ``ResNetContextNet`` :361-486, reference
  nets/fcnet.py), ``SpatialOCRNet`` (``spatial_ocrnet``, :190-223;
  nets/ocrnet.py:19-69), ``ASPOCRNet`` (``spatial_asp_ocrnet``,
  :615-660), ``BaseOCNet`` and ``AspOCNet`` (``base_ocnet``,
  ``asp_ocnet``; nets/ocnet.py), ``ISANet`` (``isanet``, reading
  ``network.factors``; nets/isanet.py).  ``pspnet``, ``ccnet`` and
  ``pyramid_ocnet``, which the reference never registers, are one
  ``ResNetContextNet`` under the JAX package's module names.
* ``HRNetISASeg`` (:489-548; ``hrnet_w48_isa`` and ``hrnet48_isa``, also
  unregistered upstream): HRNet's fused branches, an aux head, a 3x3
  ConvBNReLU and ``ISAModule``, under the JAX names.
* ``IdealSpatialOCRNet`` (:662-750; reference nets/ideal_ocrnet.py), the
  oracle OCR nets ``ideal_spatial_ocrnet``, ``_b``, ``_c``,
  ``ideal_gather_ocrnet`` and ``ideal_distribute_ocrnet``, in
  ``SpatialOCRNet``'s layout: with ``gt_labels`` the ground truth replaces
  the learned gather, the learned distribute, or both, and ``_b``/``_c``
  add the background context.  Without labels the learned branches run, as
  in the JAX trainer, which never passes ``gt_labels``.
* ``models/ce2p.CE2PNet`` (``ce2p_asp_ocrnet``, ``ce2p_ocrnet``,
  ``ce2p_ideal_ocrnet``; :855-875), the LIP human-parsing nets.
* ``SegFixHRNet`` (``segfix_hrnet``, :551-601; reference SegFix_HRNet,
  nets/segfix.py:25-89), the SegFix offset net: HRNet (``network.backbone``
  ``hrnet{18,32,48,64}``) or ``HRNetNext`` (``hrnet2x20``; any other name
  falls back to ``hrnet48``, as in JAX), its branches concatenated at the
  finest one's stride, and twin heads ``mask_head`` and ``dir_head`` (1x1
  conv, BNReLU, 1x1 conv without bias) giving ``{"mask": 2 logits,
  "dir": data.dt_num_classes logits}`` at that stride.  Like the JAX net it
  takes no ``pallas_conv``.

* ``MscaleOCR`` (``ms_ocr``, :756-852; reference ms_ocrnet.py): the
  hierarchical multi-scale attention OCR on HRNet.  One trunk (the backbone,
  ``ocr``: the OCR block with its aux head, and ``scale_attn``) runs at 0.5x
  and at 1.0x, so each BN's running statistics move twice a train step, the
  0.5x ones first, as flax's shared submodule moves them; the 0.5x attention
  fuses ``up(attn * p_05x) + (1 - up(attn)) * p_10x``, and likewise the aux
  logits, all half-pixel bilinear.  Outputs ``seg``/``pred`` and
  ``aux``/``seg_aux`` at the input size, ``pred_05x``/``attn_05x`` at half of
  it, ``pred_10x``.
* ``models/vit.SETR`` (``setr_naive``, ``setr_pup``, ``setr_mla``,
  :900-918) on ``network.backbone`` (a ``vit_*`` name, else ``vit_base``),
  its position table sized by the train crop.
* ``PyramidSegNet`` (``semantic_fpn``, :921-1020; reference
  nets/semantic_fpn.py): a ``backbone_selector`` backbone (PVT, PCPVT, SVT,
  HRNet, ...), the FPN ``neck`` (biased 1x1 laterals, nearest top-down sum,
  biased 3x3 convs) and the ``decoder`` (a scale head a level: 3x3
  ConvBNReLU then x2 half-pixel upsamples down to stride 4, summed, 1x1
  ``cls_seg``), the logits upsampled to the input (align corners).  The JAX
  ``FPNSemanticDecoder`` is ``FPNNeck`` and ``FPNSemanticDecoder`` here,
  under the reference's keys.

With a projection head, ``seg`` and ``seg_aux`` stay at the network's
stride (4 for HRNet, 8 for DeepLab) and the loss upsamples them; without,
both are upsampled to the input here.  Module names follow the reference's
torch keys.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.attention import (
    ASPOCModule,
    BaseOCModule,
    CCModule,
    ISAModule,
    PSPModule,
    PyramidOCModule,
)
from contrastiveseg_tpu_torch.models.heads import (
    ASPP,
    ClsHead,
    ProjectionHead,
    bn_relu,
    conv_bn_relu,
)
from contrastiveseg_tpu_torch.models.hrnet import HRNET_SPECS, HRNEXT_SPECS, HRNet, HRNetNext
from contrastiveseg_tpu_torch.models.layers import ConvBN, TorchBatchNorm, Upsample, conv
from contrastiveseg_tpu_torch.models.ocr import SpatialGather, SpatialOCR, SpatialOCRASP
from contrastiveseg_tpu_torch.models.backbone_selector import build_backbone
from contrastiveseg_tpu_torch.models.resnet import ResNet, backbone_spec
from contrastiveseg_tpu_torch.models.vit import SETR, VIT_SPECS, ViTFeatures
from contrastiveseg_tpu_torch.ops.resize import (
    resize_bilinear_align_corners_nchw,
    resize_bilinear_half_pixel_nchw,
    resize_nearest_nchw,
    scale_target_nearest,
)


def _outputs(out: dict[str, torch.Tensor], proj_head: nn.Module | None,
             feats: torch.Tensor, size: tuple[int, int]) -> dict[str, torch.Tensor]:
    """NHWC outputs: with a projection head, the logits stay at the
    network's stride and ``embed`` projects ``feats``; without one, the
    logits are upsampled to the input ``size``."""
    if proj_head is not None:
        out = {**out, "embed": proj_head(feats)}
    else:
        out = {k: resize_bilinear_align_corners_nchw(v, size) for k, v in out.items()}
    return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


def _fuse(feats: list[torch.Tensor]) -> torch.Tensor:
    """HRNet's branches concatenated at the finest one's stride (4, or 2 for
    ``HRNetNext``), the others upsampled (align corners)."""
    h, w = feats[0].shape[2], feats[0].shape[3]
    return torch.cat([feats[0]] + [resize_bilinear_align_corners_nchw(f, (h, w))
                                   for f in feats[1:]], dim=1)


class HRNetSeg(nn.Module):
    """HRNet-W* segmentor: backbone, 4-branch fuse, cls head and, with
    ``with_proj``, the projection head."""

    def __init__(self, num_classes: int, arch: str = "hrnet48",
                 proj_dim: int = 256, head_dropout: float = 0.10,
                 pallas_conv: bool = False, with_proj: bool = True):
        super().__init__()
        self.backbone = _hrnet_backbone(arch, pallas_conv)
        width = sum(self.backbone.out_channels)  # 720 for hrnet48
        self.cls_head = ClsHead(width, num_classes, width, head_dropout)
        self.proj_head = ProjectionHead(width, proj_dim) if with_proj else None

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """``x``: NHWC images -> NHWC ``seg`` (and ``embed``) at stride 4, or
        ``seg`` at the input size without the projection head."""
        cat = _fuse(self.backbone(x.permute(0, 3, 1, 2)))
        return _outputs({"seg": self.cls_head(cat)}, self.proj_head, cat, x.shape[1:3])


def _hrnet_backbone(arch: str, pallas_conv: bool = False) -> nn.Module:
    """HRNet for an ``HRNET_SPECS`` arch, else the ``HRNetNext`` of ``arch``
    (as the JAX ``HRNetSeg`` and ``SegFixHRNet`` pick)."""
    if arch in HRNET_SPECS:
        return HRNet(HRNET_SPECS[arch], pallas_conv=pallas_conv)
    return HRNetNext(arch)


class SegFixHRNet(nn.Module):
    """SegFix offset net: backbone, branch concat, and the ``mask`` (2) and
    ``dir`` (``num_directions``) heads, each 1x1 conv -> BNReLU -> 1x1 conv,
    NHWC logits at the concat's stride."""

    def __init__(self, num_directions: int = 8, arch: str = "hrnet48"):
        super().__init__()
        self.backbone = _hrnet_backbone(arch)
        width = sum(self.backbone.out_channels)
        for name, out in (("mask", 2), ("dir", num_directions)):
            setattr(self, f"{name}_head", nn.Sequential(
                conv(width, 256, 1), bn_relu(256), conv(256, out, 1)))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        cat = _fuse(self.backbone(x.permute(0, 3, 1, 2)))
        return {"mask": self.mask_head(cat).permute(0, 2, 3, 1),
                "dir": self.dir_head(cat).permute(0, 2, 3, 1)}


class HRNetOCRSeg(nn.Module):
    """HRNet + OCR: the aux head on the fused 720 channels gives the class
    maps that ``SpatialGather`` pools the ``conv3x3`` features with;
    ``SpatialOCR`` distributes the contexts back; ``cls_head``.  The contrast
    net projects the fused features.  Without ``height_attention`` (the
    ``_ocr_b_ha`` nets, refused)."""

    def __init__(self, num_classes: int, arch: str = "hrnet48", with_proj: bool = False,
                 proj_dim: int = 256, mid_channels: int = 512, key_channels: int = 256,
                 aux_channels: int | None = None):
        super().__init__()
        spec = HRNET_SPECS[arch]
        width = sum(spec.out_channels)
        aux_channels = aux_channels or width
        self.backbone = HRNet(spec)
        self.aux_head = nn.Sequential(*conv_bn_relu(width, aux_channels, 3),
                                      conv(aux_channels, num_classes, 1, bias=True))
        self.conv3x3 = conv_bn_relu(width, mid_channels, 3)
        self.ocr_gather_head = SpatialGather()
        self.ocr_distri_head = SpatialOCR(mid_channels, key_channels, mid_channels, 0.05)
        self.cls_head = conv(mid_channels, num_classes, 1, bias=True)
        self.proj_head = ProjectionHead(width, proj_dim) if with_proj else None

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        cat = _fuse(self.backbone(x.permute(0, 3, 1, 2)))
        aux = self.aux_head(cat)
        feats = self.conv3x3(cat)
        feats = self.ocr_distri_head(feats, self.ocr_gather_head(feats, aux))
        return _outputs({"seg": self.cls_head(feats), "seg_aux": aux}, self.proj_head, cat,
                        x.shape[1:3])


class DeepLabHead(nn.Module):
    """The reference's DeepLabHead (decoder_block.py:151-179): ``layer_dsn``
    (3x3 ConvBNReLU of 256, 1x1 with bias) on c3; ``layer_aspp`` on c4,
    then ``refine`` (3x3 ConvBN of 512 with no ReLU, 1x1 ``cls`` with bias)."""

    def __init__(self, c3: int, c4: int, num_classes: int):
        super().__init__()
        self.layer_dsn = nn.Sequential(*conv_bn_relu(c3, 256, 3),
                                       conv(256, num_classes, 1, bias=True))
        self.layer_aspp = ASPP(c4, 512)
        self.refine = nn.Sequential(conv(512, 512, 3), TorchBatchNorm(512),
                                    conv(512, num_classes, 1, bias=True))

    def forward(self, c3: torch.Tensor, c4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.refine(self.layer_aspp(c4)), self.layer_dsn(c3)


class DeepLabV3(nn.Module):
    """DeepLab-V3 on a dilated ResNet: the decoder on (c3, c4) and, with
    ``with_proj``, the projection head on c4."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8",
                 with_proj: bool = False, proj_dim: int = 256):
        super().__init__()
        self.backbone = ResNet(backbone_spec(arch))
        c3, c4 = self.backbone.channels[2:]
        self.decoder = DeepLabHead(c3, c4, num_classes)
        self.proj_head = ProjectionHead(c4, proj_dim) if with_proj else None

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c3, c4 = self.backbone(x.permute(0, 3, 1, 2))[-2:]
        seg, aux = self.decoder(c3, c4)
        return _outputs({"seg": seg, "seg_aux": aux}, self.proj_head, c4, x.shape[1:3])


def _dsn_head(c3: int, num_classes: int, dropout: float | None, bias: bool = True
              ) -> nn.Sequential:
    """The DSN aux head on c3: 3x3 ConvBNReLU to 512, dropout, 1x1 to the
    classes (slots ``0``, ``1.0``, ``3``: the reference's ``dsn_head``).
    ``dropout`` None leaves the dropout slot out (slots ``0``, ``1.0``,
    ``2``: the OCNets' ``dsn``, whose dropout is 0)."""
    drop = [] if dropout is None else [nn.Dropout(dropout)]
    return nn.Sequential(*conv_bn_relu(c3, 512, 3), *drop, conv(512, num_classes, 1, bias=bias))


class _DilatedResNetNet(nn.Module):
    """A dilated ResNet whose (c3, c4) feed the subclass's ``heads``; the
    logits come out NHWC, upsampled to the input."""

    reference_layout = True  # a reference .pth of the net loads into it

    def __init__(self, arch: str):
        super().__init__()
        self.backbone = ResNet(backbone_spec(arch))

    def heads(self, c3: torch.Tensor, c4: torch.Tensor) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c3, c4 = self.backbone(x.permute(0, 3, 1, 2))[-2:]
        return _outputs(self.heads(c3, c4), None, None, x.shape[1:3])


class FcnNet(_DilatedResNetNet):
    """FcnNet: ``cls_head`` (3x3 ConvBNReLU 512, dropout 0.1, 1x1) on c4 and
    ``dsn_head`` (dropout 0.10) on c3, both 1x1 convs without a bias
    (fcnet.py:36-47).  ``with_dsn=False`` is FcnNet_wo_dsn: no aux head,
    and its cls conv has a bias (fcnet.py:93)."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8",
                 with_dsn: bool = True):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.cls_head = nn.Sequential(*conv_bn_relu(c4, 512, 3), nn.Dropout(0.1),
                                      conv(512, num_classes, 1, bias=not with_dsn))
        self.dsn_head = _dsn_head(c3, num_classes, 0.10, bias=False) if with_dsn else None

    def heads(self, c3, c4):
        out = {"seg": self.cls_head(c4)}
        if self.dsn_head is not None:
            out["seg_aux"] = self.dsn_head(c3)
        return out


class SpatialOCRNet(_DilatedResNetNet):
    """ResNet + OCR: ``dsn_head`` (dropout 0.05) logits on c3 are the class
    maps that ``spatial_context_head`` pools the ``conv_3x3`` features of
    c4 with; ``spatial_ocr_head`` distributes the contexts; 1x1 ``head``."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8"):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.conv_3x3 = conv_bn_relu(c4, 512, 3)
        self.spatial_context_head = SpatialGather()
        self.spatial_ocr_head = SpatialOCR(512, 256, 512, 0.05)
        self.head = conv(512, num_classes, 1, bias=True)
        self.dsn_head = _dsn_head(c3, num_classes, 0.05)

    def heads(self, c3, c4):
        aux = self.dsn_head(c3)
        f = self.conv_3x3(c4)
        f = self.spatial_ocr_head(f, self.spatial_context_head(f, aux))
        return {"seg": self.head(f), "seg_aux": aux}


def _label_onehot(labels: torch.Tensor, num_channels: int) -> torch.Tensor:
    """label_to_onehot (spatial_ocr_block.py:22-34): [B, h, w] labels ->
    [B, h*w, num_channels] float one-hot; ignored pixels (< 0) go to the
    last channel."""
    lab = torch.where(labels < 0, num_channels - 1, labels.clamp(0, num_channels - 1))
    return torch.nn.functional.one_hot(lab.flatten(1).long(), num_channels).float()


class IdealSpatialOCRNet(SpatialOCRNet):
    """The oracle OCR nets: ``SpatialOCRNet`` whose gather (``spatial``,
    ``spatial_b``, ``spatial_c``, ``gather``) and distribute (``spatial``,
    ``spatial_b``, ``spatial_c``, ``distribute``) read the ground truth when
    ``forward`` is given ``gt_labels``.  The ground-truth gather pools the
    features over each class's pixels, L1-normalised, into ``num_classes +
    1`` proxies (the last one the ignored pixels); the ground-truth
    distribute is the labels' one-hot over the proxies.  ``spatial_b`` adds
    the background context, ``spatial_c`` keeps only it (``use_oc``
    False)."""

    VARIANTS = ("spatial", "spatial_b", "spatial_c", "gather", "distribute")

    def __init__(self, num_classes: int, variant: str = "spatial",
                 arch: str = "resnet101_dilated8"):
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown oracle OCR variant {variant!r}; one of {self.VARIANTS}")
        super().__init__(num_classes, arch)
        self.variant = variant
        self.num_classes = num_classes
        self.gather_gt = variant != "distribute"
        self.distribute_gt = variant != "gather"
        self.use_bg = variant in ("spatial_b", "spatial_c")
        self.spatial_ocr_head = SpatialOCR(512, 256, 512, 0.05, use_bg=self.use_bg,
                                           use_oc=variant != "spatial_c")

    def forward(self, x: torch.Tensor,
                gt_labels: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """``x`` NHWC images; ``gt_labels`` None or [B, H, W] int labels at
        the input size (-1 ignored)."""
        if self.use_bg and gt_labels is None:
            raise ValueError(
                f"ideal OCR variant {self.variant!r} (use_bg) needs gt_labels: its background "
                "context is the ground truth's complement.  The JAX trainer never passes "
                "labels to a model, and its init fails on this net the same way")
        c3, c4 = self.backbone(x.permute(0, 3, 1, 2))[-2:]
        aux = self.dsn_head(c3)
        f = self.conv_3x3(c4)
        lab = None if gt_labels is None else scale_target_nearest(gt_labels, f.shape[2:])
        if self.gather_gt and lab is not None:
            weights = _label_onehot(lab, self.num_classes + 1)  # [B, hw, K + 1]
            weights = weights / weights.sum(1, keepdim=True).clamp(min=1e-12)
            context = torch.bmm(weights.transpose(1, 2), f.flatten(2).transpose(1, 2))
        else:
            context = self.spatial_context_head(f, aux)
        gt_sim = None
        if self.distribute_gt and lab is not None:
            gt_sim = _label_onehot(lab, context.shape[1])
        f = self.spatial_ocr_head(f, context, gt_sim)
        return _outputs({"seg": self.head(f), "seg_aux": aux}, None, None, x.shape[1:3])


class ASPOCRNet(_DilatedResNetNet):
    """ResNet + ASP-OCR: ``asp_ocr_head`` (``SpatialOCRASP``, 256 channels,
    dilations 12, 24, 36) on c4, gathering over the ``dsn_head`` logits
    (dropout 0.1); 1x1 ``head``."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8"):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.asp_ocr_head = SpatialOCRASP(c4, 256, 256, (12, 24, 36), 0.1)
        self.head = conv(256, num_classes, 1, bias=True)
        self.dsn_head = _dsn_head(c3, num_classes, 0.1)

    def heads(self, c3, c4):
        aux = self.dsn_head(c3)
        return {"seg": self.head(self.asp_ocr_head(c4, aux)), "seg_aux": aux}


class BaseOCNet(_DilatedResNetNet):
    """BaseOCNet: ``oc_module_pre`` (3x3 ConvBNReLU 512), ``oc_module``
    (``BaseOCModule``), 1x1 ``cls``; the aux ``dsn`` has no dropout."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8"):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.oc_module_pre = conv_bn_relu(c4, 512, 3)
        self.oc_module = BaseOCModule(512, 256, 256, 512, 0.05)
        self.cls = conv(512, num_classes, 1, bias=True)
        self.dsn = _dsn_head(c3, num_classes, None)

    def heads(self, c3, c4):
        return {"seg": self.cls(self.oc_module(self.oc_module_pre(c4))),
                "seg_aux": self.dsn(c3)}


class AspOCNet(_DilatedResNetNet):
    """AspOCNet: ``context`` (3x3 ConvBNReLU 512, ``ASPOCModule(512, 256)``),
    1x1 ``cls``; the aux ``dsn`` has no dropout."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8"):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.context = nn.Sequential(*conv_bn_relu(c4, 512, 3), ASPOCModule(512, 256))
        self.cls = conv(512, num_classes, 1, bias=True)
        self.dsn = _dsn_head(c3, num_classes, None)

    def heads(self, c3, c4):
        return {"seg": self.cls(self.context(c4)), "seg_aux": self.dsn(c3)}


class ISANet(_DilatedResNetNet):
    """ISANet: ``isa_head`` (3x3 ConvBNReLU 512, ``ISAModule`` at
    ``down_factors``), 1x1 ``cls_head``, ``dsn_head`` (dropout 0.05)."""

    def __init__(self, num_classes: int, arch: str = "resnet101_dilated8",
                 down_factors=((8, 8),)):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.isa_head = nn.Sequential(*conv_bn_relu(c4, 512, 3),
                                      ISAModule(512, 256, 512, 512, down_factors, 0.05))
        self.cls_head = conv(512, num_classes, 1, bias=True)
        self.dsn_head = _dsn_head(c3, num_classes, 0.05)

    def heads(self, c3, c4):
        return {"seg": self.cls_head(self.isa_head(c4)), "seg_aux": self.dsn_head(c3)}


class ResNetContextNet(_DilatedResNetNet):
    """The JAX ``ResNetContextNet`` for the nets with no reference module:
    ``context`` "psp" (``PSPModule`` on c4), "cc" (``CCModule`` on c4) or
    "pyramid_oc" (3x3 ``conv3x3`` then ``PyramidOCModule``); ``dsn_conv``,
    ``dsn_drop`` (0.05) and ``dsn_cls`` on c3; 1x1 ``cls``."""

    reference_layout = False

    def __init__(self, num_classes: int, context: str, arch: str = "resnet101_dilated8"):
        super().__init__(arch)
        c3, c4 = self.backbone.channels[2:]
        self.dsn_conv = ConvBN(c3, 512, 3)
        self.dsn_drop = nn.Dropout(0.05)
        self.dsn_cls = conv(512, num_classes, 1, bias=True)
        if context == "pyramid_oc":
            self.conv3x3 = ConvBN(c4, 512, 3)
            self.context = PyramidOCModule(512, out_channels=512)
        elif context in ("psp", "cc"):
            self.conv3x3 = None
            self.context = (PSPModule if context == "psp" else CCModule)(c4, 512)
        else:
            raise ValueError(f"unknown context head {context!r}")
        self.cls = conv(512, num_classes, 1, bias=True)

    def heads(self, c3, c4):
        aux = self.dsn_cls(self.dsn_drop(self.dsn_conv(c3)))
        f = c4 if self.conv3x3 is None else self.conv3x3(c4)
        return {"seg": self.cls(self.context(f)), "seg_aux": aux}


class HRNetISASeg(nn.Module):
    """HRNet + ISA: on the fused branches, ``aux_conv`` (3x3 ConvBNReLU 512)
    and ``aux_cls``; ``conv3x3`` (3x3 ConvBNReLU 512), ``isa``
    (``ISAModule``) and 1x1 ``cls``."""

    reference_layout = False

    def __init__(self, num_classes: int, arch: str = "hrnet48"):
        super().__init__()
        width = sum(HRNET_SPECS[arch].out_channels)
        self.backbone = HRNet(HRNET_SPECS[arch])
        self.aux_conv = ConvBN(width, 512, 3)
        self.aux_cls = conv(512, num_classes, 1, bias=True)
        self.conv3x3 = ConvBN(width, 512, 3)
        self.isa = ISAModule(512, 256, 512, 512, ((8, 8),), 0.05)
        self.cls = conv(512, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        cat = _fuse(self.backbone(x.permute(0, 3, 1, 2)))
        out = {"seg": self.cls(self.isa(self.conv3x3(cat))),
               "seg_aux": self.aux_cls(self.aux_conv(cat))}
        return _outputs(out, None, None, x.shape[1:3])


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


def _hrnet_ocr(arch: str, with_proj: bool = False, **heads):
    def build(cfg) -> HRNetOCRSeg:
        return HRNetOCRSeg(cfg.get("data.num_classes"), arch, with_proj=with_proj,
                           proj_dim=cfg.get("contrast.proj_dim", default=256), **heads)

    return build


def _deeplab(with_proj: bool):
    # JAX `_deeplab_variant` passes no multi_grid (nets.py:301-312): the spec's (1, 1, 1).
    def build(cfg) -> DeepLabV3:
        return DeepLabV3(cfg.get("data.num_classes"),
                         cfg.get("network.backbone", default="resnet101_dilated8"),
                         with_proj=with_proj,
                         proj_dim=cfg.get("contrast.proj_dim", default=256))

    return build


MODELS = {f"hrnet_w{w}{kind}": _hrnet(f"hrnet{w}", with_proj=bool(kind))
          for w in (18, 32, 48, 64) for kind in ("", "_contrast", "_mem")}
_HRNET_SEG = frozenset(MODELS)  # the nets that take network.pallas_conv
for _w in (18, 32, 48, 64):
    MODELS[f"hrnet_w{_w}_ocr"] = _hrnet_ocr(f"hrnet{_w}")
    MODELS[f"hrnet_w{_w}_ocr_contrast"] = _hrnet_ocr(f"hrnet{_w}", with_proj=True)
    # OCR "B": the cheaper 256-channel head (nets/hrnet.py:249-299).
    MODELS[f"hrnet_w{_w}_ocr_b"] = _hrnet_ocr(f"hrnet{_w}", mid_channels=256,
                                              key_channels=128, aux_channels=256)
# HighResolutionNext backbone (hrnet_backbone.py:791-798); K2 runs in HRNet's
# BasicBlocks only, so not in _HRNET_SEG.
MODELS["hrnet2x20"] = _hrnet("hrnet2x20", with_proj=False)
MODELS["deeplab_v3"] = _deeplab(with_proj=False)
MODELS["deeplab_v3_contrast"] = _deeplab(with_proj=True)


def _resnet_net(cls, **kw):
    def build(cfg) -> nn.Module:
        return cls(cfg.get("data.num_classes"),
                   arch=cfg.get("network.backbone", default="resnet101_dilated8"), **kw)

    return build


def _isanet(cfg) -> ISANet:
    # ISANet reads network.factors (JAX nets.py:457-460; isanet.py:22-28).
    factors = cfg.get("network.factors", default=None) or [[8, 8]]
    return ISANet(cfg.get("data.num_classes"),
                  cfg.get("network.backbone", default="resnet101_dilated8"),
                  tuple(tuple(f) for f in factors))


def _hrnet_isa(cfg) -> HRNetISASeg:
    backbone = cfg.get("network.backbone", default="hrnet48")
    return HRNetISASeg(cfg.get("data.num_classes"),
                       backbone if backbone in HRNET_SPECS else "hrnet48")


def _segfix_hrnet(cfg) -> SegFixHRNet:
    # data.dt_num_classes; an unknown backbone falls back to hrnet48 (JAX nets.py:590-601).
    backbone = cfg.get("network.backbone", default="hrnet48")
    if backbone not in HRNET_SPECS and backbone not in HRNEXT_SPECS:
        backbone = "hrnet48"
    return SegFixHRNet(cfg.get("data.dt_num_classes", default=8), backbone)


MODELS.update({
    "segfix_hrnet": _segfix_hrnet,
    "fcnet": _resnet_net(FcnNet),
    "fcnet_wo_dsn": _resnet_net(FcnNet, with_dsn=False),
    "spatial_ocrnet": _resnet_net(SpatialOCRNet),
    "spatial_asp_ocrnet": _resnet_net(ASPOCRNet),
    "base_ocnet": _resnet_net(BaseOCNet),
    "asp_ocnet": _resnet_net(AspOCNet),
    "isanet": _isanet,
    "pspnet": _resnet_net(ResNetContextNet, context="psp"),
    "ccnet": _resnet_net(ResNetContextNet, context="cc"),
    "pyramid_ocnet": _resnet_net(ResNetContextNet, context="pyramid_oc"),
    # Both spellings appear across the reference's ISA run scripts.
    "hrnet_w48_isa": _hrnet_isa,
    "hrnet48_isa": _hrnet_isa,
    **{name: _resnet_net(IdealSpatialOCRNet, variant=variant) for name, variant in (
        ("ideal_spatial_ocrnet", "spatial"), ("ideal_spatial_ocrnet_b", "spatial_b"),
        ("ideal_spatial_ocrnet_c", "spatial_c"), ("ideal_gather_ocrnet", "gather"),
        ("ideal_distribute_ocrnet", "distribute"))},
})


def _ce2p(context: str):
    def build(cfg) -> nn.Module:
        from contrastiveseg_tpu_torch.models.ce2p import CE2PNet

        return CE2PNet(cfg.get("data.num_classes"), context,
                       cfg.get("network.backbone", default="resnet101_dilated8"))

    return build


# ce2p_ideal_ocrnet is the "ocr" context, as in the JAX registry (nets.py:872).
MODELS.update({"ce2p_asp_ocrnet": _ce2p("asp_ocr"), "ce2p_ocrnet": _ce2p("ocr"),
               "ce2p_ideal_ocrnet": _ce2p("ocr")})

class _MsOCRTrunk(nn.Module):
    """The trunk of ``MscaleOCR`` (JAX ``_MsOCRTrunk``; the reference's
    OCR_block and make_attn_head): ``backbone`` (HRNet), ``ocr``
    (``conv3x3_ocr`` 3x3 ConvBNReLU to 256, ``aux_head`` 3x3 ConvBNReLU to
    256 and a biased 1x1 to the classes, ``ocr_gather_head``,
    ``ocr_distri_head`` (``SpatialOCR`` key 128, out 256), biased 1x1
    ``cls_head``) and ``scale_attn`` (two 3x3 ConvBNReLU of 256, a bias-free
    1x1 to one channel, sigmoid)."""

    def __init__(self, num_classes: int, arch: str = "hrnet48"):
        super().__init__()
        self.backbone = HRNet(HRNET_SPECS[arch])
        width = sum(self.backbone.out_channels)
        self.ocr = nn.Module()
        self.ocr.conv3x3_ocr = conv_bn_relu(width, 256, 3)
        self.ocr.aux_head = nn.Sequential(*conv_bn_relu(width, 256, 3),
                                          conv(256, num_classes, 1, bias=True))
        self.ocr.ocr_gather_head = SpatialGather()
        self.ocr.ocr_distri_head = SpatialOCR(256, 128, 256, 0.05)
        self.ocr.cls_head = conv(256, num_classes, 1, bias=True)
        self.scale_attn = nn.Sequential(OrderedDict([
            ("conv0", conv(256, 256, 3)), ("bn0", TorchBatchNorm(256)), ("re0", nn.ReLU()),
            ("conv1", conv(256, 256, 3)), ("bn1", TorchBatchNorm(256)), ("re1", nn.ReLU()),
            ("conv2", conv(256, 1, 1)), ("sig", nn.Sigmoid())]))

    def trunk(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """NCHW images -> the class logits, aux logits and attention, each
        upsampled (half-pixel) to the images' size."""
        cat = _fuse(self.backbone(x))
        aux = self.ocr.aux_head(cat)
        f = self.ocr.conv3x3_ocr(cat)
        f = self.ocr.ocr_distri_head(f, self.ocr.ocr_gather_head(f, aux))
        size = x.shape[2:]
        return {k: resize_bilinear_half_pixel_nchw(v, size) for k, v in (
            ("cls_out", self.ocr.cls_head(f)), ("aux_out", aux),
            ("logit_attn", self.scale_attn(f)))}


class MscaleOCR(_MsOCRTrunk):
    """Hierarchical multi-scale attention OCR (two scales, 0.5x and 1.0x)."""

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        size = x.shape[2:]
        lo = self.trunk(resize_bilinear_half_pixel_nchw(x, (size[0] // 2, size[1] // 2)))
        hi = self.trunk(x)
        attn = lo["logit_attn"]
        attn_up = resize_bilinear_half_pixel_nchw(attn, size)
        pred = (resize_bilinear_half_pixel_nchw(attn * lo["cls_out"], size)
                + (1.0 - attn_up) * hi["cls_out"])
        aux = (resize_bilinear_half_pixel_nchw(attn * lo["aux_out"], size)
               + (1.0 - attn_up) * hi["aux_out"])
        out = {"seg": pred, "pred": pred, "aux": aux, "seg_aux": aux,
               "pred_05x": lo["cls_out"], "pred_10x": hi["cls_out"], "attn_05x": attn}
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


class FPNNeck(nn.Module):
    """mmseg's FPN: biased 1x1 ``lateral_convs``, each coarser lateral added
    to the next finer one by a nearest resize (coarsest first), biased 3x3
    ``fpn_convs``."""

    def __init__(self, in_channels, fpn_dim: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(conv(c, fpn_dim, 1, bias=True) for c in in_channels)
        self.fpn_convs = nn.ModuleList(conv(fpn_dim, fpn_dim, 3, bias=True)
                                       for _ in in_channels)

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        laterals = [lat(f) for lat, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest_nchw(
                laterals[i], laterals[i - 1].shape[2:])
        return [c(f) for c, f in zip(self.fpn_convs, laterals)]


class FPNSemanticDecoder(nn.Module):
    """SemanticFPN's decoder: ``scale_heads`` (a level of stride s:
    max(1, log2(s / 4)) 3x3 ConvBNReLU of ``channels``, each followed on
    the coarser levels by a x2 half-pixel upsample: slots conv ``3k``,
    BNReLU ``3k+1``, upsample ``3k+2``; ``2k``, ``2k+1`` on the finest), summed
    (half-pixel resized to the finest), and the 1x1 ``cls_seg``."""

    def __init__(self, num_classes: int, fpn_dim: int = 256, channels: int = 128,
                 feature_strides: tuple[int, ...] = (4, 8, 16, 32)):
        super().__init__()
        s0 = feature_strides[0]
        heads = []
        for i, s in enumerate(feature_strides):
            layers = []
            for k in range(max(1, int(math.log2(s) - math.log2(s0)))):
                layers += conv_bn_relu(fpn_dim if k == 0 else channels, channels, 3)
                if s != s0:
                    layers.append(Upsample(2))
            heads.append(nn.Sequential(*layers))
        self.scale_heads = nn.ModuleList(heads)
        self.cls_seg = conv(channels, num_classes, 1, bias=True)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        merged = None
        for head, f in zip(self.scale_heads, feats):
            f = head(f)
            merged = f if merged is None else merged + resize_bilinear_half_pixel_nchw(
                f, merged.shape[2:])
        return self.cls_seg(merged)


class PyramidSegNet(nn.Module):
    """Semantic-FPN on a 4-scale backbone: ``backbone``, ``neck``,
    ``decoder``; ``{"seg": NHWC logits upsampled to the input}``."""

    def __init__(self, num_classes: int, backbone: str = "pvt_small", fpn_dim: int = 256,
                 img_size: int = 224, input_hw: tuple[int, int] | None = None):
        super().__init__()
        self.backbone = build_backbone(backbone, img_size, input_hw)
        # The reference builds SemanticFPN on PVT-family (and HRNet) trunks;
        # the ViT adapter's names are the JAX package's.
        self.reference_layout = not isinstance(self.backbone, ViTFeatures)
        self.neck = FPNNeck(self.backbone.out_channels, fpn_dim)
        self.decoder = FPNSemanticDecoder(num_classes, fpn_dim)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        seg = self.decoder(self.neck(self.backbone(x.permute(0, 3, 1, 2))))
        seg = resize_bilinear_align_corners_nchw(seg, x.shape[1:3])
        return {"seg": seg.permute(0, 2, 3, 1)}


def _train_hw(cfg) -> tuple[int, int]:
    """The train crop (H, W): ``train.data_transformer.input_size`` is [W, H]."""
    w, h = cfg.get("train.data_transformer.input_size", default=[224, 224])
    return int(h), int(w)


def _setr(decoder: str):
    def build(cfg) -> SETR:
        backbone = cfg.get("network.backbone", default="vit_base")
        arch = backbone if backbone.startswith("vit") else "vit_base"
        p = VIT_SPECS[arch].patch_size
        h, w = _train_hw(cfg)
        return SETR(cfg.get("data.num_classes"), arch, decoder, grid=(h // p, w // p))

    return build


def _semantic_fpn(cfg) -> PyramidSegNet:
    # img_size = input_size[0] (JAX nets.py:1012-1019), the train width.
    h, w = _train_hw(cfg)
    return PyramidSegNet(cfg.get("data.num_classes"),
                         cfg.get("network.backbone", default="pvt_small"),
                         img_size=w, input_hw=(h, w))


def _ms_ocr(cfg) -> MscaleOCR:
    backbone = cfg.get("network.backbone", default="hrnet48")
    return MscaleOCR(cfg.get("data.num_classes"),
                     backbone if backbone in HRNET_SPECS else "hrnet48")


MODELS.update({"setr_naive": _setr("naive"), "setr_pup": _setr("pup"),
               "setr_mla": _setr("mla"), "semantic_fpn": _semantic_fpn, "ms_ocr": _ms_ocr})

# Models of the JAX registry that the port refuses by name until they are ported.
_LATER_MODELS = {
    **{f"hrnet_w{w}_ocr_b_ha": "ROADMAP 7 (HANet height attention)" for w in (18, 32, 48, 64)},
    "deeplab_v3_mobilenet": "ROADMAP 7 (other models: mobilenet)"}

# Config switches of the JAX models that the port does not have yet; a
# config that turns one on is refused rather than silently ignored.
_NOT_PORTED = {
    "network.bf16": "ROADMAP 5 (training extras: bf16 compute)",
    "network.lane_pad": "a TPU layout variant",
    "network.full_res_stem": "ROADMAP 7 (other models)",
    "network.drop_stage4": "ROADMAP 7 (other models)",
    "network.keep_imagenet_head": "ROADMAP 7 (other models)",
}


def build_model(cfg) -> nn.Module:
    """ModelManager.semantic_segmentor for the models the port has."""
    name = cfg.get("network.model_name")
    if name in _LATER_MODELS:
        raise NotImplementedError(f"model {name!r} is not ported yet: {_LATER_MODELS[name]}")
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; the port has {sorted(MODELS)}")
    for key, what in _NOT_PORTED.items():
        if cfg.get(key, default=False):
            raise NotImplementedError(f"{key}=true is not ported yet: {what}")
    if cfg.get("network.pallas_conv", default=False) and name not in _HRNET_SEG:
        raise NotImplementedError(
            f"network.pallas_conv=true on {name!r}: K2 runs in the HRNetSeg nets only; the "
            "JAX package's other nets take no pallas_conv")
    return MODELS[name](cfg)
