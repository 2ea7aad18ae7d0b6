"""Weights bridge: the JAX package's variables -> the port's ``state_dict``.

``load_jax_variables(model, variables)`` takes ``{"params", "batch_stats"}``
as nested dicts of numpy arrays (the flax trees of ``HRNetSeg``,
``HRNetOCRSeg``, ``DeepLabV3``, the context-head nets, ``HRNetISASeg``,
the oracle ``IdealSpatialOCRNet``, ``CE2PNet`` or ``SegFixHRNet``)
and fills the port's model of the same class (or, with ``key_of``, any
module, such as one context module alone):

  * conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in];
  * BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * any leaf with no counterpart, any port tensor left unfilled, or any
    shape mismatch raises.

The key mappings are the ones ``contrastiveseg_tpu/utils/torch_import.py``
applies in the other direction (``hrnet_seg_path``, ``hrnet_ocr_path`` with
``_ocr_distri``, ``_object_attention`` and ``_bnact``, ``deeplab_path`` with
``resnet_backbone_path``; ``fcnet_path``, ``spatial_ocrnet_path``,
``asp_ocrnet_path`` with ``_asp_ocr``, ``base_ocnet_path``,
``asp_ocnet_path`` and ``isanet_path`` with ``_self_attention``,
``ce2p_path``; ``segfix_path`` and ``segfix_next_path`` with
``hrnetnext_backbone_path`` for ``SegFixHRNet``, ``segfix_key`` and
``segfix_next_key`` here), carried here as copies because that module
imports flax.  ``HRNetSeg`` on ``HRNetNext`` (``hrnet2x20``) maps its
backbone as SegFix's does.  A ResNeSt backbone (``radix``) maps each
block's ``SplitAttentionConv`` (``conv2``: ``conv``, ``norm``, ``fc1``,
``fc_bn``, ``fc2``) onto the port's names; the JAX package has no
reference ``.pth`` map for it.
``MscaleOCR`` (``ms_ocr_key``), ``SETR`` (``setr_key``: the encoder's
``_setr_encoder_path``) and ``PyramidSegNet`` (``pyramid_key``:
``semantic_fpn_decoder_path`` and the backbone's map, ``pvt_key`` for PVT
(``pvt_backbone_path``) and PCPVT/SVT (``pcpvt_backbone_path``)) map onto
the reference layouts too.  Where a port tensor is not the JAX leaf
transposed, the map returns a ``Leaf`` with its conversion: SETR's patch
embed (a conv kernel here, the reference's ``Linear`` in the port) and
position table, PVT v1's tables ([1, g, g, C] -> [1, g*g, C]), and PVT's
separate ``k``/``v`` dense layers, which fill the halves of the fused
``kv`` (``part`` 0 and 1, stacked along the output rows).
The oracle nets share ``SpatialOCRNet``'s map (``mapper_for_model``,
torch_import.py:958-962).  ``CE2PNet``'s map depends on its context:
``asp_ocr`` in the reference's layout, ``ocr`` and ``psp`` under the JAX
names (``ce2p_key``).  The nets the reference
never registers (``pspnet``, ``ccnet``, ``pyramid_ocnet``,
``hrnet_w48_isa``) carry the JAX module names: a ``ConvBN`` ``name`` is
``name.0``/``name.1``, a plain conv ``name``.  The module keys
(``self_attention_key``, ``isa_module_key``, ...) are relative to the
module; ``key_for(model)`` picks the map of the model's class.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from contrastiveseg_tpu_torch.models.ce2p import CE2PNet
from contrastiveseg_tpu_torch.models.nets import (
    ASPOCRNet,
    AspOCNet,
    BaseOCNet,
    DeepLabV3,
    FcnNet,
    HRNetISASeg,
    HRNetOCRSeg,
    HRNetSeg,
    ISANet,
    MscaleOCR,
    PyramidSegNet,
    ResNetContextNet,
    SegFixHRNet,
    SpatialOCRNet,
)
from contrastiveseg_tpu_torch.models.hrnet import HRNet, HRNetNext
from contrastiveseg_tpu_torch.models.pvt import PVT
from contrastiveseg_tpu_torch.models.resnet import ResNet
from contrastiveseg_tpu_torch.models.vit import SETR, ViTFeatures

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


class Leaf(NamedTuple):
    """A port tensor that is not just the JAX leaf (transposed): ``convert``
    takes the JAX array to the port's layout; ``part`` k places it as the
    k-th block of rows of a tensor that several leaves fill."""

    key: str
    convert: Optional[Callable[[np.ndarray], np.ndarray]] = None
    part: Optional[int] = None


Target = Optional[Union[str, Leaf]]


def flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    """Nested dict of arrays -> {path tuple: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convbn(base_conv: str, base_bn: str, sub: tuple) -> Optional[str]:
    if sub == ("conv", "kernel"):
        return f"{base_conv}.weight"
    if len(sub) == 3 and sub[:2] == ("norm", "bn"):
        return f"{base_bn}.{_BN_LEAF[sub[2]]}"
    return None


def _block(base: str, sub: tuple) -> Optional[str]:
    m = re.fullmatch(r"conv(\d)", sub[0])
    if m:
        n = m.group(1)
        return _convbn(f"{base}.conv{n}", f"{base}.bn{n}", sub[1:])
    if sub[0] == "downsample":
        return _convbn(f"{base}.downsample.0", f"{base}.downsample.1", sub[1:])
    return None


def _backbone_key(path: tuple, next_arch: bool = False) -> Optional[str]:
    """An HRNet leaf; with ``next_arch`` an ``HRNetNext`` one (its stem
    ``conv1``/``bn1``; stage s's new branch is i == s, not s - 1)."""
    name = path[0]
    if name in ("stem1", "stem2") or (next_arch and name == "stem"):
        n = "1" if next_arch else name[-1]
        return _convbn(f"conv{n}", f"bn{n}", path[1:])
    m = re.fullmatch(r"layer1_block(\d+)", name)
    if m:
        return _block(f"layer1.{m.group(1)}", path[1:])
    m = re.fullmatch(r"transition(\d)_b(\d)", name)
    if m:
        s, i = int(m.group(1)), int(m.group(2))
        base = f"transition{s - 1}.{i}" + (".0" if i == s - int(not next_arch) else "")
        return _convbn(f"{base}.0", f"{base}.1", path[1:])
    m = re.fullmatch(r"stage(\d)_module(\d+)", name)
    if m:
        stage = f"stage{m.group(1)}.{m.group(2)}"
        inner = path[1]
        b = re.fullmatch(r"branch(\d+)_block(\d+)", inner)
        if b:
            return _block(f"{stage}.branches.{b.group(1)}.{b.group(2)}", path[2:])
        f = re.fullmatch(r"fuse(\d+)_(\d+)_ds(\d+)", inner)
        if f:
            base = f"{stage}.fuse_layers.{f.group(1)}.{f.group(2)}.{f.group(3)}"
            return _convbn(f"{base}.0", f"{base}.1", path[2:])
        f = re.fullmatch(r"fuse(\d+)_(\d+)", inner)
        if f:
            base = f"{stage}.fuse_layers.{f.group(1)}.{f.group(2)}"
            return _convbn(f"{base}.0", f"{base}.1", path[2:])
    return None


def _plain_conv(base: str, sub: tuple) -> Optional[str]:
    if sub == ("kernel",):
        return f"{base}.weight"
    if sub == ("bias",):
        return f"{base}.bias"
    return None


def _proj_head(sub: tuple) -> Optional[str]:
    if sub[0] == "fc1":
        return _plain_conv("proj_head.proj.0", sub[1:])
    if sub[0] == "fc2":
        return _plain_conv("proj_head.proj.2", sub[1:])
    if len(sub) == 3 and sub[:2] == ("norm", "bn"):
        return f"proj_head.proj.1.0.{_BN_LEAF[sub[2]]}"
    return None


def _prefixed(prefix: str, key: Target) -> Target:
    if isinstance(key, Leaf):
        return key._replace(key=f"{prefix}.{key.key}")
    return None if key is None else f"{prefix}.{key}"


def next_backbone_key(path: tuple) -> Optional[str]:
    """flax ``HRNetNext`` leaf path -> the port's key."""
    return _backbone_key(path, next_arch=True)


def hrnet_seg_key(path: tuple, next_arch: bool = False) -> Optional[str]:
    """flax leaf path of ``HRNetSeg`` (on ``HRNetNext`` with ``next_arch``)
    -> the port's ``state_dict`` key."""
    if path[0] == "backbone":
        return _prefixed("backbone", _backbone_key(path[1:], next_arch))
    if path[0] == "cls_head":
        if path[1] == "conv":
            return _convbn("cls_head.0", "cls_head.1.0", path[2:])
        if path[1] == "cls":
            return _plain_conv("cls_head.3", path[2:])
    if path[0] == "proj_head":
        return _proj_head(path[1:])
    return None


def _bnact(base_bn: str, sub: tuple) -> Optional[str]:
    """A ``ConvBNAct`` leaf ('bn', 'bn', leaf) -> the torch BN."""
    if len(sub) == 3 and sub[:2] == ("bn", "bn"):
        return f"{base_bn}.{_BN_LEAF[sub[2]]}"
    return None


def _object_attention(ob: str, s: tuple) -> Optional[str]:
    m = re.fullmatch(r"f_(pixel|object)_(\d)", s[0])
    if m:
        return _plain_conv(f"{ob}.f_{m.group(1)}.{0 if m.group(2) == '1' else 2}", s[1:])
    m = re.fullmatch(r"f_(pixel|object)_bn(\d)", s[0])
    if m:
        return _bnact(f"{ob}.f_{m.group(1)}.{1 if m.group(2) == '1' else 3}.0", s[1:])
    m = re.fullmatch(r"f_(down|up)(_bn)?", s[0])
    if m:
        base = f"{ob}.f_{m.group(1)}"
        return _bnact(f"{base}.1.0", s[1:]) if m.group(2) else _plain_conv(f"{base}.0", s[1:])
    return None


def _ocr_distri(sub: tuple, base: str = "ocr_distri_head") -> Optional[str]:
    if sub[0] == "project":
        return _convbn(f"{base}.conv_bn_dropout.0", f"{base}.conv_bn_dropout.1.0", sub[1:])
    if sub[0] == "object_attention":
        return _object_attention(f"{base}.object_context_block", sub[1:])
    return None


def hrnet_ocr_key(path: tuple) -> Optional[str]:
    """flax leaf path of ``HRNetOCRSeg`` -> the port's ``state_dict`` key."""
    if path[0] == "backbone":
        return _prefixed("backbone", _backbone_key(path[1:]))
    if path[0] == "aux_conv":
        return _convbn("aux_head.0", "aux_head.1.0", path[1:])
    if path[0] == "aux_cls":
        return _plain_conv("aux_head.2", path[1:])
    if path[0] == "conv3x3":
        return _convbn("conv3x3.0", "conv3x3.1.0", path[1:])
    if path[0] == "ocr_distri":
        return _ocr_distri(path[1:])
    if path[0] == "cls":
        return _plain_conv("cls_head", path[1:])
    if path[0] == "proj_head":
        return _proj_head(path[1:])
    return None


def segfix_key(path: tuple, next_arch: bool = False) -> Optional[str]:
    """flax leaf path of ``SegFixHRNet`` -> the port's key: the backbone,
    ``{mask,dir}_conv`` -> ``{mask,dir}_head.0`` and ``.1.0``,
    ``{mask,dir}_cls`` -> ``{mask,dir}_head.2``."""
    if path[0] == "backbone":
        return _prefixed("backbone", _backbone_key(path[1:], next_arch))
    m = re.fullmatch(r"(mask|dir)_(conv|cls)", path[0])
    if m and m.group(2) == "conv":
        return _cbr(f"{m.group(1)}_head", path[1:])
    if m:
        return _plain_conv(f"{m.group(1)}_head.2", path[1:])
    return None


def segfix_next_key(path: tuple) -> Optional[str]:
    """``SegFixHRNet`` on ``HRNetNext`` (``hrnet2x20``)."""
    return segfix_key(path, next_arch=True)


def _split_attention(base: str, sub: tuple) -> Optional[str]:
    """A ``SplitAttentionConv``: ``conv``, ``norm`` -> ``bn``, the dense
    ``fc1``/``fc2`` and the BatchNorm ``fc_bn``."""
    if sub == ("conv", "kernel"):
        return f"{base}.conv.weight"
    if len(sub) == 3 and sub[:2] == ("norm", "bn"):
        return f"{base}.bn.{_BN_LEAF[sub[2]]}"
    if len(sub) == 2 and sub[0] in ("fc1", "fc2"):
        return f"{base}.{sub[0]}.{'weight' if sub[1] == 'kernel' else sub[1]}"
    if len(sub) == 2 and sub[0] == "fc_bn":
        return f"{base}.fc_bn.{_BN_LEAF[sub[1]]}"
    return None


def resnet_backbone_key(path: tuple, radix: bool = False) -> Optional[str]:
    """flax ``ResNet`` leaf path -> the port's key: the stem
    ``resinit.conv{n}``/``resinit.bn{n}``, the blocks ``layer{i}.{k}``
    (with ``radix``, ResNeSt's, whose ``conv2`` is a ``SplitAttentionConv``)."""
    m = re.fullmatch(r"stem(\d)?", path[0])
    if m:
        n = m.group(1) or "1"
        return _convbn(f"resinit.conv{n}", f"resinit.bn{n}", path[1:])
    m = re.fullmatch(r"layer(\d)_block(\d+)", path[0])
    if m:
        base = f"layer{m.group(1)}.{m.group(2)}"
        if radix and path[1] == "conv2":
            return _split_attention(f"{base}.conv2", path[2:])
        return _block(base, path[1:])
    return None


def deeplab_key(path: tuple) -> Optional[str]:
    """flax leaf path of ``DeepLabV3`` -> the port's ``state_dict`` key."""
    if path[0] == "backbone":
        return _prefixed("backbone", resnet_backbone_key(path[1:]))
    if path[0] == "dsn_conv":
        return _convbn("decoder.layer_dsn.0", "decoder.layer_dsn.1.0", path[1:])
    if path[0] == "dsn_cls":
        return _plain_conv("decoder.layer_dsn.2", path[1:])
    if path[0] == "aspp":
        m = re.fullmatch(r"b(\d)", path[1])
        if m:
            base = f"decoder.layer_aspp.b{m.group(1)}"
            return _convbn(f"{base}.0", f"{base}.1.0", path[2:])
        if path[1] == "img_pool":
            return _convbn("decoder.layer_aspp.b4.1", "decoder.layer_aspp.b4.2.0", path[2:])
        if path[1] == "project":
            return _convbn("decoder.layer_aspp.project.0",
                           "decoder.layer_aspp.project.1.0", path[2:])
    if path[0] == "refine":
        return _convbn("decoder.refine.0", "decoder.refine.1", path[1:])
    if path[0] == "cls":
        return _plain_conv("decoder.refine.2", path[1:])
    if path[0] == "proj_head":
        return _proj_head(path[1:])
    return None


def _at(base: str, name: str) -> str:
    return f"{base}.{name}" if base else name


def _sub(base: str, key: Optional[str]) -> Optional[str]:
    return None if key is None else _at(base, key)


def _cbr(base: str, sub: tuple) -> Optional[str]:
    """A ConvBN ``sub`` onto the port's ``conv_bn_relu`` at ``base``
    (slots ``0``, ``1.0``)."""
    return _convbn(_at(base, "0"), _at(base, "1.0"), sub)


def _jax_named(base: str, sub: tuple) -> Optional[str]:
    """A JAX ``ConvBN`` (port ``layers.ConvBN``: ``0``, ``1``) or plain conv
    at ``base``."""
    return _convbn(_at(base, "0"), _at(base, "1"), sub) or _plain_conv(base, sub)


def self_attention_key(path: tuple, w_bn: bool = True) -> Optional[str]:
    """``SelfAttention2D``: ``f_query``/``f_key`` [conv, BNReLU, conv,
    BNReLU], ``f_value``, ``W`` ([conv, BNReLU] with ``w_bn``, else one conv)."""
    m = re.fullmatch(r"f_(query|key)_(\d)", path[0])
    if m:
        return _plain_conv(f"f_{m.group(1)}.{0 if m.group(2) == '1' else 2}", path[1:])
    m = re.fullmatch(r"f_(query|key)_bn(\d)", path[0])
    if m:
        return _bnact(f"f_{m.group(1)}.{1 if m.group(2) == '1' else 3}.0", path[1:])
    if path[0] == "f_value":
        return _plain_conv("f_value", path[1:])
    if path[0] == "W":
        return _plain_conv("W.0" if w_bn else "W", path[1:])
    if path[0] == "W_bn" and w_bn:
        return _bnact("W.1.0", path[1:])
    return None


def isa_module_key(path: tuple) -> Optional[str]:
    """``ISAModule``: ``isa{i}`` -> ``stages.{i}`` (``long_range_sa``,
    ``short_range_sa``), ``up_conv``, ``project`` -> ``conv_bn``."""
    m = re.fullmatch(r"isa(\d+)", path[0])
    if m and path[1] in ("long_range", "short_range"):
        return _sub(f"stages.{m.group(1)}.{path[1]}_sa", self_attention_key(path[2:]))
    if path[0] == "up_conv":
        return _cbr("up_conv", path[1:])
    if path[0] == "project":
        return _cbr("conv_bn", path[1:])
    return None


def base_oc_key(path: tuple) -> Optional[str]:
    """``BaseOCModule``: ``attention`` -> ``stages.0``, ``project`` ->
    ``conv_bn_dropout``."""
    if path[0] == "attention":
        return _sub("stages.0", self_attention_key(path[1:], w_bn=False))
    if path[0] == "project":
        return _cbr("conv_bn_dropout", path[1:])
    return None


def base_oc_context_key(path: tuple) -> Optional[str]:
    """``BaseOCContextModule``: ``attention`` -> ``stages.0``, ``ctx_bn`` ->
    ``conv_bn_dropout.0``."""
    if path[0] == "attention":
        return _sub("stages.0", self_attention_key(path[1:], w_bn=False))
    if path[0] == "ctx_bn":
        return _bnact("conv_bn_dropout.0.0", path[1:])
    return None


def _branch(path: tuple) -> Optional[str]:
    """``b{i}`` of an ASPP-like module -> ``conv{i + 2}``."""
    m = re.fullmatch(r"b(\d)", path[0])
    return _cbr(f"conv{int(m.group(1)) + 2}", path[1:]) if m else None


def asp_oc_key(path: tuple) -> Optional[str]:
    """``ASPOCModule``: ``context_conv`` and ``oc`` -> ``context.0``-``.2``,
    ``b{i}`` -> ``conv{i + 2}``, ``project`` -> ``conv_bn_dropout``."""
    if path[0] == "context_conv":
        return _cbr("context", path[1:])
    if path[0] == "oc":
        return _sub("context.2", base_oc_context_key(path[1:]))
    if path[0] == "project":
        return _cbr("conv_bn_dropout", path[1:])
    return _branch(path)


def asp_ocr_key(path: tuple) -> Optional[str]:
    """``SpatialOCRASP``: ``context_conv`` and ``object_attention`` ->
    ``context.0``-``.2``, ``b{i}`` -> ``conv{i + 2}``, ``project`` ->
    ``conv_bn_dropout``."""
    if path[0] == "context_conv":
        return _cbr("context", path[1:])
    if path[0] == "object_attention":
        return _object_attention("context.2.object_context_block", path[1:])
    if path[0] == "project":
        return _cbr("conv_bn_dropout", path[1:])
    return _branch(path)


def pyramid_oc_key(path: tuple) -> Optional[str]:
    """``PyramidOCModule``: ``attn_s{s}`` (ISA-flavoured attention),
    ``project``."""
    if path[0].startswith("attn_s"):
        return _sub(path[0], self_attention_key(path[1:]))
    return _jax_named(path[0], path[1:])


def jax_named_key(path: tuple) -> Optional[str]:
    """``PSPModule`` and ``CCModule`` (JAX names; CC's scalar ``gamma``)."""
    if path == ("gamma",):
        return "gamma"
    return _jax_named(path[0], path[1:])


def _resnet_net_key(path: tuple, dsn: tuple[str, str, str], heads: dict) -> Optional[str]:
    """A dilated-ResNet net: the backbone; ``dsn_conv``/``dsn_cls`` onto
    ``dsn`` = (conv, BN, cls) keys; each other flax module ``name`` onto
    ``heads[name](sub)``."""
    if path[0] == "backbone":
        return _prefixed("backbone", resnet_backbone_key(path[1:]))
    if path[0] == "dsn_conv":
        return _convbn(dsn[0], dsn[1], path[1:])
    if path[0] == "dsn_cls":
        return _plain_conv(dsn[2], path[1:])
    fn = heads.get(path[0])
    return None if fn is None else fn(path[1:])


_DSN_HEAD = ("dsn_head.0", "dsn_head.1.0", "dsn_head.3")
_DSN = ("dsn.0", "dsn.1.0", "dsn.2")


def fcnet_key(path: tuple) -> Optional[str]:
    """``FcnNet`` (fcnet, fcnet_wo_dsn)."""
    return _resnet_net_key(path, _DSN_HEAD, {
        "conv3x3": lambda s: _cbr("cls_head", s),
        "cls": lambda s: _plain_conv("cls_head.3", s)})


def spatial_ocrnet_key(path: tuple) -> Optional[str]:
    """``SpatialOCRNet``."""
    return _resnet_net_key(path, _DSN_HEAD, {
        "conv3x3": lambda s: _cbr("conv_3x3", s),
        "ocr_distri": lambda s: _ocr_distri(s, base="spatial_ocr_head"),
        "cls": lambda s: _plain_conv("head", s)})


def asp_ocrnet_key(path: tuple) -> Optional[str]:
    """``ASPOCRNet``."""
    return _resnet_net_key(path, _DSN_HEAD, {
        "asp_ocr": lambda s: _sub("asp_ocr_head", asp_ocr_key(s)),
        "cls": lambda s: _plain_conv("head", s)})


def base_ocnet_key(path: tuple) -> Optional[str]:
    """``BaseOCNet``."""
    return _resnet_net_key(path, _DSN, {
        "conv3x3": lambda s: _cbr("oc_module_pre", s),
        "context": lambda s: _sub("oc_module", base_oc_key(s)),
        "cls": lambda s: _plain_conv("cls", s)})


def asp_ocnet_key(path: tuple) -> Optional[str]:
    """``AspOCNet``."""
    return _resnet_net_key(path, _DSN, {
        "conv3x3": lambda s: _cbr("context", s),
        "context": lambda s: _sub("context.2", asp_oc_key(s)),
        "cls": lambda s: _plain_conv("cls", s)})


def isanet_key(path: tuple) -> Optional[str]:
    """``ISANet``."""
    return _resnet_net_key(path, _DSN_HEAD, {
        "conv3x3": lambda s: _cbr("isa_head", s),
        "context": lambda s: _sub("isa_head.2", isa_module_key(s)),
        "cls": lambda s: _plain_conv("cls_head", s)})


def resnet_context_key(path: tuple) -> Optional[str]:
    """``ResNetContextNet`` (pspnet, ccnet, pyramid_ocnet; JAX names)."""
    def context(s):
        return pyramid_oc_key(s) if s[0].startswith("attn_s") else jax_named_key(s)

    return _resnet_net_key(path, ("dsn_conv.0", "dsn_conv.1", "dsn_cls"), {
        "conv3x3": lambda s: _jax_named("conv3x3", s),
        "context": lambda s: _sub("context", context(s)),
        "cls": lambda s: _plain_conv("cls", s)})


def hrnet_isa_key(path: tuple) -> Optional[str]:
    """``HRNetISASeg`` (JAX names; ``isa`` an ``ISAModule``)."""
    if path[0] == "backbone":
        return _prefixed("backbone", _backbone_key(path[1:]))
    if path[0] == "isa":
        return _sub("isa", isa_module_key(path[1:]))
    if path[0] in ("aux_conv", "aux_cls", "conv3x3", "cls"):
        return _jax_named(path[0], path[1:])
    return None


def ce2p_key(context: str):
    """The map of a ``CE2PNet`` with ``context``: the reference's
    CE2P_ASPOCR layout (``dsn``, ``edgelayer``, ``asp_ocr_head``,
    ``decoder``, ``cls``), with ``conv3x3``/``ocr_distri`` (``ocr``) or
    ``context`` (``psp``) under the JAX names."""
    if context == "asp_ocr":
        def head(s):
            return _sub("asp_ocr_head", asp_ocr_key(s))
    else:
        def head(s):
            return _sub("context", jax_named_key(s))

    def edge(s):
        if s[0] in ("conv1", "conv2", "conv3"):
            return _cbr(f"edgelayer.{s[0]}", s[1:])
        return _plain_conv(f"edgelayer.{s[0]}", s[1:]) if s[0] in ("conv4", "conv5") else None

    def decoder(s):
        slots = {"conv1": ("conv1.0", "conv1.1.0"), "conv2": ("conv2.0", "conv2.1.0"),
                 "conv3a": ("conv3.0", "conv3.1.0"), "conv3b": ("conv3.2", "conv3.3.0")}
        if s[0] in slots:
            return _convbn(*(f"decoder.{k}" for k in slots[s[0]]), s[1:])
        return _plain_conv("decoder.conv4", s[1:]) if s[0] == "conv4" else None

    def key(path: tuple) -> Optional[str]:
        return _resnet_net_key(path, ("dsn.0", "dsn.1.0", "dsn.3"), {
            "edge": edge, "context": head, "decoder": decoder,
            "conv3x3": lambda s: _jax_named("conv3x3", s),
            "ocr_distri": lambda s: _ocr_distri(s, base="ocr_distri"),
            "final_conv": lambda s: _cbr("cls", s),
            "final_cls": lambda s: _plain_conv("cls.2", s)})

    return key


def ms_ocr_key(path: tuple) -> Optional[str]:
    """flax leaf path of ``MscaleOCR`` (everything under its shared trunk
    ``ocr``) -> the port's key (torch_import.ms_ocr_path)."""
    if path[0] != "ocr":
        return None
    sub = path[1:]
    if sub[0] == "backbone":
        return _prefixed("backbone", _backbone_key(sub[1:]))
    if sub[0] in ("conv3x3_ocr", "aux_conv"):
        return _cbr("ocr." + {"conv3x3_ocr": "conv3x3_ocr", "aux_conv": "aux_head"}[sub[0]],
                    sub[1:])
    if sub[0] == "aux_cls":
        return _plain_conv("ocr.aux_head.2", sub[1:])
    if sub[0] == "ocr_distri":
        return _ocr_distri(sub[1:], base="ocr.ocr_distri_head")
    if sub[0] == "cls":
        return _plain_conv("ocr.cls_head", sub[1:])
    m = re.fullmatch(r"attn(\d)", sub[0])
    if m and m.group(1) == "2":
        return _plain_conv("scale_attn.conv2", sub[1:])
    if m:
        return _convbn(f"scale_attn.conv{m.group(1)}", f"scale_attn.bn{m.group(1)}", sub[1:])
    return None


def _layernorm(base: str, sub: tuple) -> Optional[str]:
    return {("scale",): f"{base}.weight", ("bias",): f"{base}.bias"}.get(sub)


def _dense(base: str, sub: tuple) -> Optional[str]:
    return {("kernel",): f"{base}.weight", ("bias",): f"{base}.bias"}.get(sub)


def _patch_conv_to_linear(kernel: np.ndarray) -> np.ndarray:
    """The JAX strided-conv kernel [p, p, 3, D] -> the reference's patch
    ``Linear`` weight [D, p*p*3] (torch_import._patch_linear_to_conv
    inverted)."""
    return np.ascontiguousarray(kernel.reshape(-1, kernel.shape[-1]).T)


def vit_encoder_key(path: tuple) -> Target:
    """flax ``ViT`` leaf path -> the port's key (torch_import.
    _setr_encoder_path): block i is ``transformer.net.{2i}`` (attention)
    and ``.{2i+1}`` (feed-forward)."""
    name, sub = path[0], path[1:]
    if name == "linear_encoding":
        return Leaf("linear_encoding.weight", _patch_conv_to_linear) if sub == (
            "kernel",) else _dense("linear_encoding", sub)
    if path == ("pos_embed",):
        return Leaf("position_encoding.pe.weight", np.asarray)
    if name == "pre_head_ln":
        return _layernorm("pre_head_ln", sub)
    m = re.fullmatch(r"block(\d+)", name)
    if not m:
        return None
    attn, ff = (f"transformer.net.{2 * int(m.group(1)) + j}.fn" for j in (0, 1))
    if sub[0] in ("norm1", "norm2"):
        return _layernorm(f"{attn if sub[0] == 'norm1' else ff}.norm", sub[1:])
    if sub[0] in ("qkv", "proj"):
        return _dense(f"{attn}.fn.{sub[0]}", sub[1:])
    if sub[0] in ("fc1", "fc2"):
        return _dense(f"{ff}.fn.net.{0 if sub[0] == 'fc1' else 3}", sub[1:])
    return None


def setr_key(path: tuple) -> Target:
    """flax ``SETR`` leaf path -> the port's key (torch_import._setr_path):
    the encoder at the top level, Naive ``conv1``/``bn1``/``conv2``, PUP
    ``pup{i}`` -> ``decode_net.{2i}``, MLA ``mla{k}_{in,intmd,out1,out2}``
    -> ``net{k+1}_{in.layer_1, intmd.layer_intmd, out.layer_2,
    out.layer_3}``, ``cls`` -> ``output_net.conv_1``."""
    if path[0] == "backbone":
        return vit_encoder_key(path[1:])
    if path[0] in ("conv1", "conv2"):
        return _plain_conv(path[0], path[1:])
    if path[0] == "bn1" and len(path) == 3 and path[1] == "bn":
        return f"bn1.{_BN_LEAF[path[2]]}"
    m = re.fullmatch(r"pup(\d)", path[0])
    if m:
        return _plain_conv(f"decode_net.{2 * int(m.group(1))}", path[1:])
    m = re.fullmatch(r"mla(\d)_(in|intmd|out1|out2)", path[0])
    if m:
        layer = {"in": "in.layer_1", "intmd": "intmd.layer_intmd", "out1": "out.layer_2",
                 "out2": "out.layer_3"}[m.group(2)]
        return _plain_conv(f"net{int(m.group(1)) + 1}_{layer}", path[1:])
    if path[0] == "cls":
        return _plain_conv("output_net.conv_1", path[1:])
    return None


def _pvt_block(base: str, sub: tuple) -> Target:
    """``PVTBlock`` (torch_import._pvt_block): the JAX ``k`` and ``v`` fill
    the fused ``attn.kv``."""
    if sub[0] in ("norm1", "norm2"):
        return _layernorm(f"{base}.{sub[0]}", sub[1:])
    if sub[0] in ("fc1", "fc2"):
        return _dense(f"{base}.mlp.{sub[0]}", sub[1:])
    if sub[0] != "attn":
        return None
    name, leaf = sub[1], sub[2:]
    if name in ("q", "proj", "qkv"):
        return _dense(f"{base}.attn.{name}", leaf)
    if name in ("k", "v") and leaf in (("kernel",), ("bias",)):
        return Leaf(f"{base}.attn.kv.{'weight' if leaf == ('kernel',) else 'bias'}",
                    part=0 if name == "k" else 1)
    if name == "sr":
        return _plain_conv(f"{base}.attn.sr", leaf)
    if name == "sr_norm":
        return _layernorm(f"{base}.attn.norm", leaf)
    return None


def _flat_table(table: np.ndarray) -> np.ndarray:
    """A v1 position table [1, g, g, C] -> the reference's [1, g*g, C]."""
    return np.ascontiguousarray(table.reshape(1, -1, table.shape[-1]))


def pvt_key(path: tuple, v1: bool) -> Target:
    """flax ``PVT`` leaf path -> the port's key (torch_import.
    _pvt_family_path; ``v1``: PVT v1's names, else PCPVT/SVT's)."""
    name, sub = path[0], path[1:]
    m = re.fullmatch(r"(patch|patch_norm|pos_embed|pos_cnn)(\d)", name)
    if m:
        kind, i = m.group(1), int(m.group(2))
        embed = f"patch_embed{i + 1}" if v1 else f"patch_embeds.{i}"
        if kind == "patch":
            return _plain_conv(f"{embed}.proj", sub)
        if kind == "patch_norm":
            return _layernorm(f"{embed}.norm", sub)
        if kind == "pos_embed":
            return Leaf(f"pos_embed{i + 1}", _flat_table) if not sub else None
        return _plain_conv(f"pos_block.{i}.proj.0", sub)
    m = re.fullmatch(r"stage(\d)_block(\d+)", name)
    if m:
        i, b = int(m.group(1)), m.group(2)
        return _pvt_block(f"block{i + 1}.{b}" if v1 else f"blocks.{i}.{b}", sub)
    return None


def fpn_decoder_key(path: tuple) -> Optional[str]:
    """The JAX ``FPNSemanticDecoder`` (relative to it) -> the port's
    ``neck`` and ``decoder`` (torch_import.semantic_fpn_decoder_path)."""
    m = re.fullmatch(r"(lateral|fpn_conv)(\d)", path[0])
    if m:
        kind = "lateral_convs" if m.group(1) == "lateral" else "fpn_convs"
        return _plain_conv(f"neck.{kind}.{m.group(2)}", path[1:])
    m = re.fullmatch(r"scale_head(\d)_(\d)", path[0])
    if m:
        i, k = int(m.group(1)), int(m.group(2))
        idx = 3 * k if i > 0 else 2 * k
        return _convbn(f"decoder.scale_heads.{i}.{idx}",
                       f"decoder.scale_heads.{i}.{idx + 1}.0", path[1:])
    if path[0] == "cls":
        return _plain_conv("decoder.cls_seg", path[1:])
    return None


def backbone_key(backbone: nn.Module):
    """The map of a ``backbone_selector`` backbone (paths relative to it)."""
    if isinstance(backbone, PVT):
        return lambda path: pvt_key(path, backbone.v1)
    if isinstance(backbone, ViTFeatures):
        return lambda path: _prefixed("vit", vit_encoder_key(path[1:])) if path[
            0] == "vit" else None
    if isinstance(backbone, HRNetNext):
        return next_backbone_key
    if isinstance(backbone, HRNet):
        return _backbone_key
    if isinstance(backbone, ResNet):
        return lambda path: resnet_backbone_key(path, bool(backbone.radix))
    raise TypeError(f"no JAX key map for a {type(backbone).__name__} backbone")


def pyramid_key(model: PyramidSegNet):
    """The map of a ``PyramidSegNet``: its backbone's and the decoder's."""
    trunk = backbone_key(model.backbone)

    def key(path: tuple) -> Target:
        if path[0] == "backbone":
            return _prefixed("backbone", trunk(path[1:]))
        return fpn_decoder_key(path[1:]) if path[0] == "decoder" else None

    return key


_KEY_MAPS = ((HRNetSeg, hrnet_seg_key), (HRNetOCRSeg, hrnet_ocr_key), (DeepLabV3, deeplab_key),
             (FcnNet, fcnet_key), (SpatialOCRNet, spatial_ocrnet_key),
             (ASPOCRNet, asp_ocrnet_key), (BaseOCNet, base_ocnet_key),
             (AspOCNet, asp_ocnet_key), (ISANet, isanet_key),
             (ResNetContextNet, resnet_context_key), (HRNetISASeg, hrnet_isa_key))


def key_for(model: nn.Module):
    """The flax-path -> port-key map of ``model``'s class (the oracle OCR
    nets are ``SpatialOCRNet``s; a ``CE2PNet``'s map is its context's; an
    ``HRNetNext`` backbone and a ResNeSt one map as such)."""
    if isinstance(model, CE2PNet):
        return ce2p_key(model.context_kind)
    if isinstance(model, MscaleOCR):
        return ms_ocr_key
    if isinstance(model, SETR):
        return setr_key
    if isinstance(model, PyramidSegNet):
        return pyramid_key(model)
    next_arch = isinstance(getattr(model, "backbone", None), HRNetNext)
    if isinstance(model, SegFixHRNet):
        return segfix_next_key if next_arch else segfix_key
    if isinstance(model, HRNetSeg) and next_arch:
        return lambda path: hrnet_seg_key(path, next_arch=True)
    for cls, fn in _KEY_MAPS:
        if isinstance(model, cls):
            if getattr(model.backbone, "radix", 0):
                return lambda path: (_prefixed("backbone", resnet_backbone_key(path[1:], True))
                                     if path[0] == "backbone" else fn(path))
            return fn
    raise TypeError(f"no JAX key map for {type(model).__name__}")


def _port_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # a conv kernel, HWIO -> OIHW
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:  # a dense kernel, [in, out] -> [out, in]
        return arr.T
    return arr


def to_port(tree: dict, key_of) -> tuple[dict[str, np.ndarray], list[str]]:
    """A flax tree of arrays (``{"params", "batch_stats"}``, or any tree of
    the params' structure, such as an optimizer moment) -> ({port key:
    array in the port's layout}, the leaves ``key_of`` does not map)."""
    out: dict[str, np.ndarray] = {}
    parts: dict[str, dict[int, np.ndarray]] = {}
    unmapped = []
    for path, arr in flatten(tree).items():
        target = key_of(path[1:] if path[0] in ("params", "batch_stats") else path)
        if target is None:
            unmapped.append("/".join(path))
            continue
        leaf = target if isinstance(target, Leaf) else Leaf(target)
        arr = leaf.convert(arr) if leaf.convert else _port_layout(arr)
        if leaf.part is None:
            out[leaf.key] = arr
        else:
            parts.setdefault(leaf.key, {})[leaf.part] = arr
    for key, blocks in parts.items():
        out[key] = np.concatenate([blocks[i] for i in sorted(blocks)], axis=0)
    return out, unmapped


def load_jax_variables(model: nn.Module, variables: dict, key_of=None) -> None:
    """Fill ``model`` from the JAX package's variables of the same net (or
    module, with its ``key_of`` map)."""
    key_of = key_of or key_for(model)
    sd = model.state_dict()
    arrays, unused = to_port({col: variables.get(col, {}) for col in ("params", "batch_stats")},
                             key_of)
    unused += [k for k in arrays if k not in sd]
    new_sd: dict[str, torch.Tensor] = {}
    for key, arr in arrays.items():
        if key not in sd:
            continue
        if tuple(arr.shape) != tuple(sd[key].shape):
            raise ValueError(
                f"shape mismatch at {key}: jax {arr.shape} vs "
                f"port {tuple(sd[key].shape)}")
        new_sd[key] = torch.as_tensor(np.ascontiguousarray(arr), dtype=sd[key].dtype)
    missing = [k for k in sd
               if k not in new_sd and not k.endswith("num_batches_tracked")]
    if unused or missing:
        raise ValueError(f"JAX leaves with no port tensor: {unused}; "
                         f"port tensors with no JAX leaf: {missing}")
    for k in sd:
        new_sd.setdefault(k, sd[k])
    model.load_state_dict(new_sd, strict=True)
