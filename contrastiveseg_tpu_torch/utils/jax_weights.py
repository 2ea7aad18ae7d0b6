"""Weights bridge: the JAX package's variables -> the port's ``state_dict``.

``load_jax_variables(model, variables)`` takes ``{"params", "batch_stats"}``
as nested dicts of numpy arrays (the flax trees of ``HRNetSeg``,
``HRNetOCRSeg`` or ``DeepLabV3``) and fills the port's model of the same
class:

  * conv kernels HWIO -> OIHW;
  * BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * any leaf with no counterpart, any port tensor left unfilled, or any
    shape mismatch raises.

The key mappings are the ones ``contrastiveseg_tpu/utils/torch_import.py``
applies in the other direction (``hrnet_seg_path``, ``hrnet_ocr_path`` with
``_ocr_distri``, ``_object_attention`` and ``_bnact``, ``deeplab_path`` with
``resnet_backbone_path``), carried here as copies because that module
imports flax.  ``key_for(model)`` picks the one of the model's class.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn

from contrastiveseg_tpu_torch.models.nets import DeepLabV3, HRNetOCRSeg, HRNetSeg

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


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


def _backbone_key(path: tuple) -> Optional[str]:
    name = path[0]
    if name in ("stem1", "stem2"):
        n = name[-1]
        return _convbn(f"conv{n}", f"bn{n}", path[1:])
    m = re.fullmatch(r"layer1_block(\d+)", name)
    if m:
        return _block(f"layer1.{m.group(1)}", path[1:])
    m = re.fullmatch(r"transition(\d)_b(\d)", name)
    if m:
        s, i = int(m.group(1)), int(m.group(2))
        base = f"transition{s - 1}.{i}" + (".0" if i == s - 1 else "")
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


def _prefixed(prefix: str, key: Optional[str]) -> Optional[str]:
    return None if key is None else f"{prefix}.{key}"


def hrnet_seg_key(path: tuple) -> Optional[str]:
    """flax leaf path of ``HRNetSeg`` -> the port's ``state_dict`` key."""
    if path[0] == "backbone":
        return _prefixed("backbone", _backbone_key(path[1:]))
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


def resnet_backbone_key(path: tuple) -> Optional[str]:
    """flax ``ResNet`` leaf path -> the port's key: the stem
    ``resinit.conv{n}``/``resinit.bn{n}``, the blocks ``layer{i}.{k}``."""
    m = re.fullmatch(r"stem(\d)?", path[0])
    if m:
        n = m.group(1) or "1"
        return _convbn(f"resinit.conv{n}", f"resinit.bn{n}", path[1:])
    m = re.fullmatch(r"layer(\d)_block(\d+)", path[0])
    if m:
        return _block(f"layer{m.group(1)}.{m.group(2)}", path[1:])
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


def key_for(model: nn.Module):
    """The flax-path -> port-key map of ``model``'s class."""
    for cls, fn in ((HRNetSeg, hrnet_seg_key), (HRNetOCRSeg, hrnet_ocr_key),
                    (DeepLabV3, deeplab_key)):
        if isinstance(model, cls):
            return fn
    raise TypeError(f"no JAX key map for {type(model).__name__}")


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model`` (``HRNetSeg``, ``HRNetOCRSeg`` or ``DeepLabV3``) from
    the JAX package's variables of the same net."""
    key_of = key_for(model)
    sd = model.state_dict()
    new_sd: dict[str, torch.Tensor] = {}
    unused = []
    for col in ("params", "batch_stats"):
        for path, arr in flatten(variables.get(col, {})).items():
            key = key_of(path)
            if key is None or key not in sd:
                unused.append("/".join((col,) + path))
                continue
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = np.transpose(arr, (3, 2, 0, 1))
            if tuple(arr.shape) != tuple(sd[key].shape):
                raise ValueError(
                    f"shape mismatch at {key}: jax {arr.shape} vs "
                    f"port {tuple(sd[key].shape)}")
            new_sd[key] = torch.as_tensor(np.ascontiguousarray(arr),
                                          dtype=sd[key].dtype)
    missing = [k for k in sd
               if k not in new_sd and not k.endswith("num_batches_tracked")]
    if unused or missing:
        raise ValueError(f"JAX leaves with no port tensor: {unused}; "
                         f"port tensors with no JAX leaf: {missing}")
    for k in sd:
        new_sd.setdefault(k, sd[k])
    model.load_state_dict(new_sd, strict=True)
