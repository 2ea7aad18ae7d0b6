#!/usr/bin/env python
"""Official Cityscapes evaluation CLI of the PyTorch port (pixel + instance
level): ``tools/evaluate_cityscapes.py`` on the port's
``metrics/cityscapes_official.py``, which reads PNGs without PIL.

Like the original, the counterpart of `python -m
lib.metrics.cityscapes_evaluator --pred_dir ... --gt_dir ...` (reference
run scripts, e.g. scripts/cityscapes/hrnet/run_h_48_d_4_contrast.sh:81-82).
Ground truth is searched recursively for
*_gtFine_labelIds.png (+ instanceIds for iIoU); predictions are matched by
the city_sequence_frame stem.

    python tools/evaluate_cityscapes_torch.py --pred_dir out/label \
        --gt_dir /data/cityscapes/gtFine/val [--no-instances] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--no-instances", action="store_true",
                    help="skip instance-level iIoU")
    ap.add_argument("--json", default=None, help="write full results JSON")
    args = ap.parse_args()

    from contrastiveseg_tpu_torch.metrics.cityscapes_official import evaluate_dirs

    res = evaluate_dirs(args.pred_dir, args.gt_dir,
                        eval_instances=not args.no_instances)

    print(f"{'classes':<16}{'IoU':>10}{'nIoU':>10}")
    print("-" * 36)
    for name, iou in res["classScores"].items():
        if math.isnan(iou):
            continue
        niou = res["classInstScores"].get(name, float("nan"))
        nstr = f"{niou:10.6f}" if not math.isnan(niou) else f"{'-':>10}"
        print(f"{name:<16}{iou:10.6f}{nstr}")
    print("-" * 36)
    print(f"{'Score Average':<16}{res['averageScoreClasses']:10.6f}"
          f"{res['averageScoreInstClasses']:10.6f}")
    print()
    print(f"{'categories':<16}{'IoU':>10}{'nIoU':>10}")
    print("-" * 36)
    for name, iou in res["categoryScores"].items():
        if math.isnan(iou):
            continue
        niou = res["categoryInstScores"].get(name, float("nan"))
        nstr = f"{niou:10.6f}" if not math.isnan(niou) else f"{'-':>10}"
        print(f"{name:<16}{iou:10.6f}{nstr}")
    print("-" * 36)
    print(f"{'Score Average':<16}{res['averageScoreCategories']:10.6f}"
          f"{res['averageScoreInstCategories']:10.6f}")
    print(f"\npixel accuracy: {res['pixelAccuracy']:.6f}")

    if args.json:
        out = {k: v for k, v in res.items() if k != "confMatrix"}
        out["confMatrix"] = res["confMatrix"].tolist()
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
