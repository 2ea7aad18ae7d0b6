"""``network.pretrained``: start a model, and the memory bank, from a reference ``.pth``.

Counterpart of the JAX trainer's pretrained load
(``contrastiveseg_tpu/engine/trainer.py:58-100``) together with the import
tool that feeds it (``tools/import_torch_ckpt.py:31-53,97-140``) and
``utils/torch_import.extract_memory_queues`` (:903-920).  In the JAX package
the config value is a flax msgpack that the import tool writes from the
``.pth``.  The port's modules carry the reference's torch ``state_dict``
keys, so here the value is the reference ``.pth`` itself, as the
reference's own ``--pretrained`` takes it, and no import tool is needed.

Which source a file is, from its keys alone:

* keys under ``backbone.`` or ``encoder_q.backbone.``: a full segmentor
  (HRNet_W48[_CONTRAST], HRNet_W48_OCR[_B][_CONTRAST], DeepLabV3[Contrast],
  or HRNet_W48_MEM with its ``encoder_q.`` prefix and its four queue
  buffers, which seed the bank);
* otherwise an ImageNet backbone (``hrnetv2_w48_imagenet_pretrained.pth``,
  a deep-base ResNet's ``resinit.*`` file, or a torchvision-style ResNet
  whose ``conv1.``/``bn1.`` stem becomes ``resinit.conv1.``/``resinit.bn1.``
  as in ``tools/import_torch_ckpt.py:97-106``): the classification head's
  keys (``IMAGENET_HEAD_PREFIXES``) are dropped and the rest prefixed with
  ``backbone.``.  The heads keep their init.

The context-head nets load their reference segmentors too (FcnNet,
SpatialOCRNet, ASPOCRNet, BaseOCNet, AspOCNet, ISANet), and so do the
oracle OCR nets (``ideal_*``, in SpatialOCRNet's layout),
``ce2p_asp_ocrnet`` (CE2P_ASPOCR) and ``segfix_hrnet`` (SegFix_HRNet, on
HRNet-W48 or the HRNet-2x20 HighResolutionNext: the published SegFix
checkpoints), ``ms_ocr`` (MscaleOCR), ``semantic_fpn`` (SemanticFPN on a
PVT, PCPVT or SVT trunk) and the SETR nets.  SETR's encoder is the net
itself (the reference's SETR subclasses SegmentationTransformer), so its
keys have no ``backbone.``: for a net without a ``backbone`` module every
file is a segmentor; the MLA decoder's ``net1_intmd``, which the
reference builds and never calls, is dropped from the file
(``reference_unused``).  The nets the reference never registers
(``pspnet``, ``ccnet``, ``pyramid_ocnet``, ``hrnet_w48_isa``) and the two
CE2P nets it cannot build (``ce2p_ocrnet``, ``ce2p_ideal_ocrnet``; JAX
``models/ce2p.py:112-118``) have ``reference_layout`` False: no reference
segmentor of them exists, so a segmentor file is refused for them; an
ImageNet backbone loads as for any other net.

The load is strict: every tensor of the model that the source covers (the
backbone for ImageNet files, everything for a segmentor) must be in the
file with its shape, and no key may be left over.  BN
``num_batches_tracked`` counters are loaded where the file has them and
kept otherwise.  A reference conv may have a bias where the port's conv has
none because a BN follows it (the HRNet cls head's 3x3 conv, for one): as
in ``utils/torch_import._convbn``, the bias folds into that BN's running
mean (``conv_bn_pairs`` finds the BN).  Half a set of queue buffers, or
queues for a preset without memory, raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# ImageNet classification-head modules with no segmentation counterpart
# (tools/import_torch_ckpt.py:31-33).
IMAGENET_HEAD_PREFIXES = (
    "incre_modules", "downsamp_modules", "final_layer", "classifier", "fc.")
QUEUE_KEYS = ("segment_queue", "segment_queue_ptr", "pixel_queue", "pixel_queue_ptr")
# A torchvision-style ResNet's 7x7 stem, and its names in the port.
TORCHVISION_STEM = {"backbone.conv1.": "backbone.resinit.conv1.",
                    "backbone.bn1.": "backbone.resinit.bn1."}


def load_torch_state(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` in any of the reference's three layouts
    (a raw state_dict, ``{"state_dict": ...}``, ``{"model": ...}``), on the
    CPU, with the DDP ``module.`` prefix stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    elif isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    return {k.removeprefix("module."): v for k, v in blob.items()
            if isinstance(v, torch.Tensor)}


def split_source(sd: dict[str, torch.Tensor]
                 ) -> tuple[dict[str, torch.Tensor], Optional[dict[str, torch.Tensor]], bool]:
    """-> (weights keyed like the port's segmentors, the queue buffers or
    None, whether the file is an ImageNet backbone)."""
    if not any(k.startswith(("backbone.", "encoder_q.backbone.")) for k in sd):
        return ({f"backbone.{k}": v for k, v in sd.items()
                 if not k.startswith(IMAGENET_HEAD_PREFIXES)}, None, True)
    present = [k for k in QUEUE_KEYS if k in sd]
    if present and len(present) != len(QUEUE_KEYS):
        raise ValueError(f"the checkpoint carries {present} of the four memory "
                         f"queue buffers {list(QUEUE_KEYS)}: all four or none")
    queues = {k: sd[k] for k in QUEUE_KEYS} if present else None
    weights = {k.removeprefix("encoder_q."): v for k, v in sd.items()
               if k not in QUEUE_KEYS}
    return weights, queues, False


def conv_bn_pairs(model: nn.Module) -> dict[str, str]:
    """{bias-free conv: the BN right after it} over ``model``: a conv
    followed, among its parent's children, by a ``BatchNorm2d`` or by a
    ``Sequential`` that starts with one (a BNReLU)."""
    pairs = {}
    for prefix, parent in model.named_modules():
        children = list(parent.named_children())
        for (name, mod), (next_name, nxt) in zip(children, children[1:]):
            if not isinstance(mod, nn.Conv2d) or mod.bias is not None:
                continue
            if isinstance(nxt, nn.Sequential) and len(nxt) and isinstance(nxt[0], nn.BatchNorm2d):
                next_name += ".0"
            elif not isinstance(nxt, nn.BatchNorm2d):
                continue
            base = f"{prefix}." if prefix else ""
            pairs[base + name] = base + next_name
    return pairs


def _fold_biases(weights: dict[str, torch.Tensor], model: nn.Module) -> dict[str, torch.Tensor]:
    weights = dict(weights)
    for conv, bn in conv_bn_pairs(model).items():
        bias, mean = f"{conv}.bias", f"{bn}.running_mean"
        if bias in weights and mean in weights:
            weights[mean] = weights[mean] - weights.pop(bias)
    return weights


def _first(keys: list[str]) -> str:
    return f"{keys[:5]}{' ...' if len(keys) > 5 else ''} ({len(keys)})"


def load_pretrained(model: nn.Module, path: str) -> Optional[dict[str, torch.Tensor]]:
    """Fill ``model`` (any of the port's segmentors) from the ``.pth`` at
    ``path``; returns the file's queue buffers (CPU tensors keyed by
    ``QUEUE_KEYS``), or None when it has none."""
    target = model.state_dict()
    sd = load_torch_state(path)
    if any(k.startswith("backbone.") for k in target):
        weights, queues, imagenet = split_source(sd)
    else:
        weights, queues, imagenet = sd, None, False
    unused = getattr(model, "reference_unused", ())
    weights = {k: v for k, v in weights.items() if not k.startswith(unused)}
    if not imagenet and not getattr(model, "reference_layout", True):
        raise ValueError(
            f"{path} is a segmentor checkpoint, but {type(model).__name__} has no reference "
            "layout to load it in: the reference never registers pspnet, ccnet, pyramid_ocnet "
            "or hrnet_w48_isa (lib/models/model_manager.py:48-82) and cannot build CE2P_OCRNet "
            "or CE2P_IdealOCRNet, so no reference checkpoint of them exists; start the net "
            "from an ImageNet backbone .pth")
    if (imagenet and any(k.startswith("backbone.resinit.") for k in target)
            and not any(k.startswith("backbone.resinit.") for k in weights)):
        weights = {next((k.replace(a, b, 1) for a, b in TORCHVISION_STEM.items()
                         if k.startswith(a)), k): v for k, v in weights.items()}
    weights = _fold_biases(weights, model)
    covered = [k for k in target if not imagenet or k.startswith("backbone.")]
    missing = [k for k in covered
               if k not in weights and not k.endswith("num_batches_tracked")]
    leftover = [k for k in weights if k not in target]
    if missing or leftover:
        raise ValueError(
            f"{path} ({'ImageNet backbone' if imagenet else 'segmentor'}) does not fit "
            f"the model: missing {_first(missing)}; left over {_first(leftover)}")
    for k, v in weights.items():
        if v.shape != target[k].shape:
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)} in the file, "
                             f"{tuple(target[k].shape)} in the model")
    model.load_state_dict({**target, **weights}, strict=True)
    return queues
