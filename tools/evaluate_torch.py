#!/usr/bin/env python
"""Offline evaluator of the PyTorch port: prediction PNGs against
ground-truth PNGs.

Counterpart of ``tools/evaluate.py``.  PNGs are read through the port's
``utils/png.py`` (no PIL) and the histogram is the port's
``ops/confusion.py`` on CPU tensors.  Predictions and ground truth may be
raw label ids (remapped with the Cityscapes ``label_list`` by default) or
train ids (``--train_ids``); ``--dataset ade20k|pascal_context|coco_stuff``
applies that dataset's conventions (``metrics/dataset_evaluators.py``).

    python tools/evaluate_torch.py --pred_dir out/label --gt_dir data/val/label \
        [--dataset cityscapes] [--num_classes 19] [--train_ids]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from contrastiveseg_tpu_torch.data.datasets import (  # noqa: E402
    CITYSCAPES_LABEL_LIST,
    encode_label_map,
)
from contrastiveseg_tpu_torch.metrics.running_score import RunningScore  # noqa: E402
from contrastiveseg_tpu_torch.ops.confusion import confusion_matrix  # noqa: E402
from contrastiveseg_tpu_torch.utils.png import read_png  # noqa: E402

CITYSCAPES_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]


def _read_ids(path: str) -> np.ndarray:
    a = read_png(path).astype(np.int64)
    return a[..., 0] if a.ndim == 3 else a


def evaluate_dirs(pred_dir: str, gt_dir: str, num_classes: int,
                  label_list=None, train_ids=False) -> dict:
    score = RunningScore(num_classes)
    n = 0
    for name in sorted(os.listdir(pred_dir)):
        if not name.endswith(".png"):
            continue
        gt_path = os.path.join(gt_dir, name)
        if not os.path.exists(gt_path):
            continue
        pred = _read_ids(os.path.join(pred_dir, name))
        gt = _read_ids(gt_path)
        if not train_ids and label_list is not None:
            pred = encode_label_map(pred, label_list)
            gt = encode_label_map(gt, label_list)
            pred = np.where(pred == 255, -1, pred)
            gt = np.where(gt == 255, -1, gt)
        score.update_confusion(confusion_matrix(
            torch.from_numpy(pred.astype(np.int32)), torch.from_numpy(gt.astype(np.int32)),
            num_classes))
        n += 1
    scores = score.get_scores()
    scores["num_images"] = n
    return scores


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--dataset", default="cityscapes")
    ap.add_argument("--num_classes", type=int, default=19)
    ap.add_argument("--train_ids", action="store_true",
                    help="inputs already use train ids")
    args = ap.parse_args()

    from contrastiveseg_tpu_torch.metrics.dataset_evaluators import EVALUATORS

    if args.dataset in EVALUATORS:
        ev = EVALUATORS[args.dataset](args.num_classes)
        r = ev.evaluate(args.pred_dir, args.gt_dir)
        print(f"evaluated {r['images']} images")
        for i, iou in enumerate(r["cls_iou"]):
            print(f"  class{i:<11} IoU {iou:.4f}")
        print(f"mIoU: {r['miou']:.4f}  pixelAcc: {r['pixel_acc']:.4f}")
        return

    label_list = CITYSCAPES_LABEL_LIST if args.dataset == "cityscapes" else None
    scores = evaluate_dirs(args.pred_dir, args.gt_dir, args.num_classes, label_list,
                           args.train_ids)
    names = (CITYSCAPES_CLASSES if args.dataset == "cityscapes" and args.num_classes == 19
             else [f"class{i}" for i in range(args.num_classes)])
    print(f"evaluated {scores['num_images']} images")
    for name, iou in zip(names, scores["cls_iou"]):
        print(f"  {name:<16} IoU {iou:.4f}")
    print(f"mIoU: {scores['miou']:.4f}  pixelAcc: {scores['pixel_acc']:.4f}")


if __name__ == "__main__":
    main()
