"""Cityscapes instance-level AP evaluator (in-memory, array-based).

The port's copy of ``contrastiveseg_tpu/metrics/instance_ap.py`` (numpy
only), the score of ``tools/segfix_torch.py --mode instance``'s output,
held against the original by ``tests/test_torch_port_segfix_data.py``.
(The original's note follows.)

Re-implements the matching + average-precision algorithm of the official
cityscapes-scripts port in the reference,
lib/metrics/cityscapes/evaluation/
evalInstanceLevelSemanticLabeling.py:255-547 (assignGt2Preds /
evaluateMatches / computeAverages), without its txt+PNG-file plumbing:
predictions are (mask, class_id, confidence) triples and ground truth is
the standard *_instanceIds.png array (pixel value = class_id*1000 +
instance index; bare class ids < 1000 mark group regions).

Semantics kept exactly:
  * group regions and ground-truth instances below ``min_region_size``
    never count as targets, but predictions mostly covered by them (or
    by void) are ignored rather than penalized
    (proportionIgnore <= overlap -> false positive, else dropped);
  * duplicate matches to one gt: best confidence wins, the rest become
    false positives;
  * unmatched gt instances count as hard false negatives at every
    threshold;
  * AP integrates the step-wise precision-recall curve over unique score
    thresholds with the artificial (r=0, p=1) point, averaged over
    overlaps 0.50:0.05:0.95; ap50 is the 0.5 slice; classes with gt but
    no predictions score 0, classes with no gt at all are NaN and are
    excluded from the mean (np.nanmean, computeAverages:558).

The distance-conditioned variants (50m/100m) require stereo disparity
inputs the pipeline does not carry — like the reference with
``distanceAvailable=False``, only the unconditioned AP is produced.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Cityscapes raw ids of classes with instances (helpers/labels.py:181:
# person, rider, car, truck, bus, train, motorcycle, bicycle).
CITYSCAPES_INSTANCE_IDS = (24, 25, 26, 27, 28, 31, 32, 33)
# Raw ids ignored in eval (void + the non-instance stuff is handled by
# class filtering; this set is only used for the void-overlap rule).
CITYSCAPES_VOID_IDS = (0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30)

DEFAULT_OVERLAPS = np.arange(0.5, 1.0, 0.05)


def _gt_regions(gt: np.ndarray, class_id: int):
    """(instID, pixelCount) regions of one class: real instances carry
    id = class_id*1000 + k; a bare class_id region is the group."""
    out = []
    for v in np.unique(gt):
        if v == class_id or v // 1000 == class_id:
            out.append((int(v), int(np.count_nonzero(gt == v))))
    return out


class InstanceAPEvaluator:
    """Accumulate per-image matches, then compute AP / AP50 per class."""

    def __init__(self,
                 instance_class_ids: Sequence[int] = CITYSCAPES_INSTANCE_IDS,
                 void_ids: Sequence[int] = CITYSCAPES_VOID_IDS,
                 overlaps: np.ndarray = DEFAULT_OVERLAPS,
                 min_region_size: int = 100):
        self.class_ids = list(instance_class_ids)
        self.void_ids = set(void_ids)
        self.overlaps = np.asarray(overlaps)
        self.min_region_size = min_region_size
        self.images: list[dict] = []

    def add_image(
        self,
        gt_instance_map: np.ndarray,  # [H, W] int (class*1000+k / class)
        predictions: Sequence[tuple[np.ndarray, int, float]],
        # each: (bool mask [H, W], class_id, confidence)
    ) -> None:
        """assignGt2Preds (reference :255-351) for one image."""
        gt = np.asarray(gt_instance_map)
        void = np.isin(gt, list(self.void_ids))
        record = {c: {"gt": _gt_regions(gt, c), "preds": []}
                  for c in self.class_ids}
        for mask, class_id, conf in predictions:
            if class_id not in record:
                continue
            mask = np.asarray(mask, bool)
            pix = int(np.count_nonzero(mask))
            if pix == 0:
                continue
            inter = []
            for inst_id, gt_pix in record[class_id]["gt"]:
                i = int(np.count_nonzero((gt == inst_id) & mask))
                if i > 0:
                    inter.append((inst_id, gt_pix, i))
            record[class_id]["preds"].append({
                "pixelCount": pix,
                "confidence": float(conf),
                "voidIntersection": int(np.count_nonzero(void & mask)),
                "matchedGt": inter,
            })
        self.images.append(record)

    # -- evaluateMatches (reference :352-547) --------------------------------
    def _class_overlap_ap(self, class_id: int, overlap_th: float) -> float:
        y_true: list[float] = []
        y_score: list[float] = []
        hard_fns = 0
        have_gt = have_pred = False
        for record in self.images:
            entry = record[class_id]
            gts = [(iid, pix) for iid, pix in entry["gt"]
                   if iid >= 1000 and pix >= self.min_region_size]
            if gts:
                have_gt = True
            if entry["preds"]:
                have_pred = True

            cur_true, cur_score = [], []
            matched_score = {iid: None for iid, _ in gts}
            for iid, gt_pix in gts:
                found = False
                for pred in entry["preds"]:
                    inter = next((i for pid, _, i in pred["matchedGt"]
                                  if pid == iid), 0)
                    if inter <= 0:
                        continue
                    ov = inter / (gt_pix + pred["pixelCount"] - inter)
                    if ov > overlap_th:
                        conf = pred["confidence"]
                        if matched_score[iid] is not None:
                            hi = max(matched_score[iid], conf)
                            lo = min(matched_score[iid], conf)
                            matched_score[iid] = hi
                            cur_true.append(0.0)  # duplicate -> FP
                            cur_score.append(lo)
                        else:
                            found = True
                            matched_score[iid] = conf
                if not found and matched_score[iid] is None:
                    hard_fns += 1
            for iid, _ in gts:
                if matched_score[iid] is not None:
                    cur_true.append(1.0)
                    cur_score.append(matched_score[iid])

            # unmatched predictions -> FP unless mostly covering ignores.
            gt_pix_of = dict(entry["gt"])
            for pred in entry["preds"]:
                found_gt = False
                for pid, gt_pix, inter in pred["matchedGt"]:
                    ov = inter / (gt_pix + pred["pixelCount"] - inter)
                    if pid >= 1000 and gt_pix >= self.min_region_size \
                            and ov > overlap_th:
                        found_gt = True
                        break
                if found_gt:
                    continue
                ignore = pred["voidIntersection"]
                for pid, gt_pix, inter in pred["matchedGt"]:
                    if pid < 1000:  # group region
                        ignore += inter
                    elif gt_pix_of[pid] < self.min_region_size:
                        ignore += inter
                if ignore / pred["pixelCount"] <= overlap_th:
                    cur_true.append(0.0)
                    cur_score.append(pred["confidence"])
            y_true.extend(cur_true)
            y_score.extend(cur_score)

        if not have_gt:
            return float("nan")
        if not have_pred:
            return 0.0
        return _average_precision(np.asarray(y_true), np.asarray(y_score),
                                  hard_fns)

    def evaluate(self) -> dict:
        """computeAverages (reference :549-577): allAp = nanmean over
        classes x overlaps; ap50 the 0.5 slice; per-class means."""
        aps = np.zeros((len(self.class_ids), len(self.overlaps)))
        for li, c in enumerate(self.class_ids):
            for oi, th in enumerate(self.overlaps):
                aps[li, oi] = self._class_overlap_ap(c, float(th))
        o50 = int(np.argmin(np.abs(self.overlaps - 0.5)))
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows
            return {
                "all_ap": float(np.nanmean(aps)),
                "all_ap_50": float(np.nanmean(aps[:, o50])),
                "classes": {
                    c: {"ap": float(np.mean(aps[li])),
                        "ap50": float(aps[li, o50])}
                    for li, c in enumerate(self.class_ids)
                },
                "raw": aps,
            }


def _average_precision(y_true: np.ndarray, y_score: np.ndarray,
                       hard_fns: int) -> float:
    """The reference's exact PR construction + step integration
    (evaluateMatches :486-541)."""
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cumsum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n = len(y_score)
    n_true = cumsum[-1] if n else 0.0
    precision = np.zeros(len(unique_idx) + 1)
    recall = np.zeros(len(unique_idx) + 1)
    cumsum = np.append(cumsum, 0)  # index -1 -> 0
    for res_i, score_i in enumerate(unique_idx):
        below = cumsum[score_i - 1]
        tp = n_true - below
        fp = n - score_i - tp
        fn = below + hard_fns
        precision[res_i] = tp / (tp + fp) if tp + fp else 0.0
        recall[res_i] = tp / (tp + fn) if tp + fn else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0
    r = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(r, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def instances_from_semantic(
    seg: np.ndarray,  # [H, W] predicted raw-id label map
    probs: Optional[np.ndarray] = None,  # [H, W] max-prob map (confidence)
    instance_class_ids: Sequence[int] = CITYSCAPES_INSTANCE_IDS,
) -> list[tuple[np.ndarray, int, float]]:
    """Connected components of a semantic prediction as pseudo-instances
    (the common way to feed a semantic model into the instance AP
    benchmark); confidence = mean max-prob over the component."""
    from scipy import ndimage

    out = []
    for c in instance_class_ids:
        binary = seg == c
        if not binary.any():
            continue
        comps, n = ndimage.label(binary)
        for k in range(1, n + 1):
            mask = comps == k
            conf = float(probs[mask].mean()) if probs is not None else 1.0
            out.append((mask, int(c), conf))
    return out
