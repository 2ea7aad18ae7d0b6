"""CE2P human-parsing nets: edge branch, decoder and a context head (NCHW).

Counterpart of ``contrastiveseg_tpu/models/ce2p.py`` (:25-148; the
reference's nets/ce2pnet.py:19-262, modules/edge_block.py:17-56 and
modules/decoder_block.py:210-239), NHWC in and out like the port's other
nets:

  * ``EdgeModule``: a 1x1 ConvBNReLU of 256 on each of c1, c2 and c3, one
    shared 3x3 conv to 2 edge logits on each, the three resized to c1's
    size (align corners) and fused by a 1x1 conv; returns the edge logits
    and the three features concatenated (768 channels);
  * ``CE2PDecoder``: the context features (1x1 ConvBNReLU 256, resized to
    c1) beside c1 (1x1 ConvBNReLU 48), two 1x1 ConvBNReLU of 256, dropout
    0.1 and a 1x1 classifier; returns the logits and the 256 features;
  * ``CE2PNet``: a dilated ResNet, the DSN aux head on c3 (dropout 0.1),
    the edge module, a context head on c4 (``context``): ``asp_ocr``
    (``SpatialOCRASP``, 256 hidden, out 512, dilations 6, 12, 18, gathered
    over the DSN logits), ``ocr`` (3x3 ConvBNReLU 512, ``SpatialGather``
    over the DSN logits, ``SpatialOCR``) or ``psp`` (``PSPModule``, 512);
    the decoder on (context, c1); and the final 1x1 ConvBNReLU 256 and
    classifier on the decoder's features beside the edge features.
    Outputs, all upsampled to the input: ``seg`` (the decoder's), ``edge``,
    ``seg_aux`` (the DSN's) and ``seg_final``.

``ce2p_asp_ocrnet`` is the reference's CE2P_ASPOCR, in its module layout
(``dsn``, ``edgelayer``, ``asp_ocr_head``, ``decoder``, ``cls``;
``utils/torch_import.ce2p_path``), so its ``.pth`` loads.  The reference's
CE2P_OCRNet and CE2P_IdealOCRNet cannot be built (JAX ``models/ce2p.py:
112-118``: they call ``Decoder_Module`` with arguments it does not take),
so no checkpoint of them exists: the ``ocr`` and ``psp`` contexts carry the
JAX module names (``conv3x3``, ``ocr_gather``, ``ocr_distri``; ``context``)
and ``reference_layout`` False.
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.attention import PSPModule
from contrastiveseg_tpu_torch.models.heads import bn_relu, conv_bn_relu
from contrastiveseg_tpu_torch.models.layers import ConvBN, conv
from contrastiveseg_tpu_torch.models.ocr import SpatialGather, SpatialOCR, SpatialOCRASP
from contrastiveseg_tpu_torch.models.resnet import ResNet, backbone_spec
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw as _resize


class EdgeModule(nn.Module):
    """Multi-level edge prediction (edge_block.py:17-56)."""

    def __init__(self, in_channels: tuple[int, int, int], mid_fea: int = 256,
                 out_fea: int = 2):
        super().__init__()
        for i, cin in enumerate(in_channels, 1):
            self.add_module(f"conv{i}", conv_bn_relu(cin, mid_fea, 1))
        self.conv4 = conv(mid_fea, out_fea, 3, bias=True)
        self.conv5 = conv(3 * out_fea, out_fea, 1, bias=True)

    def forward(self, x1, x2, x3) -> tuple[torch.Tensor, torch.Tensor]:
        size = tuple(x1.shape[2:])
        feas, edges = [], []
        for i, x in enumerate((x1, x2, x3), 1):
            fea = getattr(self, f"conv{i}")(x)
            edges.append(_resize(self.conv4(fea), size))
            feas.append(_resize(fea, size))
        return self.conv5(torch.cat(edges, dim=1)), torch.cat(feas, dim=1)


class CE2PDecoder(nn.Module):
    """High-level and low-level fusion decoder (decoder_block.py:210-239):
    ``conv1`` on the context, ``conv2`` on c1, ``conv3`` (two 1x1
    ConvBNReLU, then the dropout), ``conv4`` the classifier."""

    def __init__(self, in_channels: int, low_channels: int, num_classes: int,
                 dropout: float = 0.1):
        super().__init__()
        self.conv1 = conv_bn_relu(in_channels, 256, 1)
        self.conv2 = conv_bn_relu(low_channels, 48, 1)
        self.conv3 = nn.Sequential(conv(304, 256, 1), bn_relu(256), conv(256, 256, 1),
                                   bn_relu(256), nn.Dropout(dropout))
        self.conv4 = conv(256, num_classes, 1, bias=True)

    def forward(self, xt, xl) -> tuple[torch.Tensor, torch.Tensor]:
        xt = _resize(self.conv1(xt), tuple(xl.shape[2:]))
        x = self.conv3(torch.cat([xt, self.conv2(xl)], dim=1))
        return self.conv4(x), x


class CE2PNet(nn.Module):
    """CE2P with the ``asp_ocr``, ``ocr`` or ``psp`` context head."""

    CONTEXTS = ("asp_ocr", "ocr", "psp")

    def __init__(self, num_classes: int, context: str = "asp_ocr",
                 arch: str = "resnet101_dilated8"):
        super().__init__()
        if context not in self.CONTEXTS:
            raise ValueError(f"unknown CE2P context {context!r}; one of {self.CONTEXTS}")
        self.context_kind = context
        self.reference_layout = context == "asp_ocr"
        self.backbone = ResNet(backbone_spec(arch))
        c1, c2, c3, c4 = self.backbone.channels
        self.dsn = nn.Sequential(*conv_bn_relu(c3, 512, 3), nn.Dropout(0.1),
                                 conv(512, num_classes, 1, bias=True))
        self.edgelayer = EdgeModule((c1, c2, c3))
        if context == "asp_ocr":
            self.asp_ocr_head = SpatialOCRASP(c4, 256, 512, (6, 12, 18), 0.1)
        elif context == "ocr":
            self.conv3x3 = ConvBN(c4, 512, 3)
            self.ocr_gather = SpatialGather()
            self.ocr_distri = SpatialOCR(512, 256, 512, 0.05)
        else:
            self.context = PSPModule(c4, 512)
        self.decoder = CE2PDecoder(512, c1, num_classes)
        self.cls = nn.Sequential(*conv_bn_relu(256 + 3 * 256, 256, 1),
                                 conv(256, num_classes, 1, bias=True))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c1, c2, c3, c4 = self.backbone(x.permute(0, 3, 1, 2))[-4:]
        dsn = self.dsn(c3)
        edge, edge_fea = self.edgelayer(c1, c2, c3)
        if self.context_kind == "asp_ocr":
            f = self.asp_ocr_head(c4, dsn)
        elif self.context_kind == "ocr":
            f = self.conv3x3(c4)
            f = self.ocr_distri(f, self.ocr_gather(f, _resize(dsn, tuple(f.shape[2:]))))
        else:
            f = self.context(c4)
        seg, dec_fea = self.decoder(f, c1)
        seg_final = self.cls(torch.cat([dec_fea, _resize(edge_fea, tuple(dec_fea.shape[2:]))],
                                       dim=1))
        size = tuple(x.shape[1:3])
        out = {"seg": seg, "edge": edge, "seg_aux": dsn, "seg_final": seg_final}
        return {k: _resize(v, size).permute(0, 2, 3, 1) for k, v in out.items()}
