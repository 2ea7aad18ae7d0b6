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
  (HRNet_W48, HRNet_W48_CONTRAST, or HRNet_W48_MEM with its ``encoder_q.``
  prefix and its four queue buffers, which seed the bank);
* otherwise an ImageNet backbone (``hrnetv2_w48_imagenet_pretrained.pth``):
  the classification head's keys (``IMAGENET_HEAD_PREFIXES``) are dropped
  and the rest prefixed with ``backbone.``.  The heads keep their init.

The load is strict: every tensor of the model that the source covers (the
backbone for ImageNet files, everything for a segmentor) must be in the
file with its shape, and no key may be left over.  BN
``num_batches_tracked`` counters are loaded where the file has them and
kept otherwise.  The reference cls head's 3x3 conv has a bias that the
port's has not (it feeds a BN); as in ``utils/torch_import``, it is folded
into that BN's running mean.  Half a set of queue buffers, or queues for a
preset without memory, raise.
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
# Reference conv biases that the port folds into the BN after the conv.
FOLDED_BIASES = {"cls_head.0.bias": "cls_head.1.0.running_mean"}


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
    """-> (weights keyed like ``HRNetSeg``, the queue buffers or None,
    whether the file is an ImageNet backbone)."""
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


def _fold_biases(weights: dict[str, torch.Tensor], model_keys) -> dict[str, torch.Tensor]:
    weights = dict(weights)
    for bias, mean in FOLDED_BIASES.items():
        if bias in weights and bias not in model_keys and mean in weights:
            weights[mean] = weights[mean] - weights.pop(bias)
    return weights


def _first(keys: list[str]) -> str:
    return f"{keys[:5]}{' ...' if len(keys) > 5 else ''} ({len(keys)})"


def load_pretrained(model: nn.Module, path: str) -> Optional[dict[str, torch.Tensor]]:
    """Fill ``model`` (an ``HRNetSeg``) from the ``.pth`` at ``path``;
    returns the file's queue buffers (CPU tensors keyed by ``QUEUE_KEYS``),
    or None when it has none."""
    weights, queues, imagenet = split_source(load_torch_state(path))
    target = model.state_dict()
    weights = _fold_biases(weights, target)
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
