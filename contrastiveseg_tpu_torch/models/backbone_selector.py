"""Backbone selector: a ``network.backbone`` string -> a backbone module.

Counterpart of ``contrastiveseg_tpu/models/backbone_selector.py`` (the
reference's BackboneSelector): the exact ResNet zoo names first, then the
name without ``deepbase_``: HRNet, ResNet, PVT / PCPVT / SVT, ViT and
HRNet-Next.  Every backbone maps NCHW images to a list of NCHW maps and
names their widths in ``out_channels``.  The MobileNet and WiderResNet
backbones are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from torch import nn

from contrastiveseg_tpu_torch.models.hrnet import HRNET_SPECS, HRNEXT_SPECS, HRNet, HRNetNext
from contrastiveseg_tpu_torch.models.pvt import PVT, PVT_SPECS
from contrastiveseg_tpu_torch.models.resnet import RESNET_SPECS, WIDE_RESNET_ARCHS, ResNet
from contrastiveseg_tpu_torch.models.vit import VIT_SPECS, ViTFeatures


def _resnet(name: str) -> ResNet:
    net = ResNet(RESNET_SPECS[name])
    stem = 128 if RESNET_SPECS[name].deep_base else 64
    net.out_channels = [stem, stem, *net.channels]  # stem, pool, c1..c4
    return net


def build_backbone(name: str, img_size: int = 224,
                   input_hw: tuple[int, int] | None = None) -> nn.Module:
    """``img_size`` sizes PVT v1's position tables (the train
    ``input_size[0]``); ``input_hw`` (default ``img_size`` square), the
    train crop, sizes a ViT's position table."""
    if name in RESNET_SPECS:
        return _resnet(name)
    if name in WIDE_RESNET_ARCHS:
        raise NotImplementedError(
            f"backbone {name!r} (WiderResNetA2) is not ported yet: ROADMAP 7 (the ResNet "
            "variant families)")
    name = name.replace("deepbase_", "")
    if name in HRNET_SPECS:
        return HRNet(HRNET_SPECS[name])
    if name in RESNET_SPECS:
        return _resnet(name)
    if name in PVT_SPECS:
        return PVT(PVT_SPECS[name], img_size)
    if name in VIT_SPECS:
        p = VIT_SPECS[name].patch_size
        h, w = input_hw or (img_size, img_size)
        return ViTFeatures(VIT_SPECS[name], (h // p, w // p))
    if name in HRNEXT_SPECS:
        return HRNetNext(name)
    if name.startswith("mobilenet"):
        raise NotImplementedError(
            f"backbone {name!r} (MobileNet) is not ported yet: ROADMAP 7 (other models: "
            "mobilenet)")
    raise KeyError(
        f"unknown backbone {name!r}; known: "
        f"{sorted([*HRNET_SPECS, *HRNEXT_SPECS, *RESNET_SPECS, *PVT_SPECS, *VIT_SPECS])}")
