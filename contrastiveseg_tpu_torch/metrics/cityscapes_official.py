"""Official Cityscapes evaluation semantics (pixel + instance level).

The port's copy of ``contrastiveseg_tpu/metrics/cityscapes_official.py``,
with its PNGs read through ``utils/png.py`` instead of PIL.  (The
original's note follows.)

Re-design of the reference's port of the cityscapes-scripts evaluator
(upstream lib/metrics/cityscapes_evaluator.py:1-710, itself wrapping
evalPixelLevelSemanticLabeling.py semantics): confusion matrix over RAW
label ids, the official IoU rule (false positives exclude ignored ground
truth rows), category IoU, and the instance-weighted iIoU built from the
*_instanceIds.png maps with the published average class sizes.

The reference needs a Cython extension (addToConfusionMatrix.pyx) for
speed; here the inner loop is one vectorized ``np.bincount`` per image —
no native code, same counts, and golden-tested against the reference
script in tests/test_cityscapes_official.py.
"""

from __future__ import annotations

import fnmatch
import math
import os
from dataclasses import dataclass

import numpy as np

from contrastiveseg_tpu_torch.utils.png import read_png


@dataclass(frozen=True)
class CsLabel:
    name: str
    id: int
    train_id: int
    category: str
    has_instances: bool
    ignore_in_eval: bool


# Official label table (dataset constants; cityscapes-scripts labels.py,
# mirrored at upstream lib/metrics/cityscapes/helpers/labels.py:63-97).
CS_LABELS = [
    CsLabel("unlabeled", 0, 255, "void", False, True),
    CsLabel("ego vehicle", 1, 255, "void", False, True),
    CsLabel("rectification border", 2, 255, "void", False, True),
    CsLabel("out of roi", 3, 255, "void", False, True),
    CsLabel("static", 4, 255, "void", False, True),
    CsLabel("dynamic", 5, 255, "void", False, True),
    CsLabel("ground", 6, 255, "void", False, True),
    CsLabel("road", 7, 0, "flat", False, False),
    CsLabel("sidewalk", 8, 1, "flat", False, False),
    CsLabel("parking", 9, 255, "flat", False, True),
    CsLabel("rail track", 10, 255, "flat", False, True),
    CsLabel("building", 11, 2, "construction", False, False),
    CsLabel("wall", 12, 3, "construction", False, False),
    CsLabel("fence", 13, 4, "construction", False, False),
    CsLabel("guard rail", 14, 255, "construction", False, True),
    CsLabel("bridge", 15, 255, "construction", False, True),
    CsLabel("tunnel", 16, 255, "construction", False, True),
    CsLabel("pole", 17, 5, "object", False, False),
    CsLabel("polegroup", 18, 255, "object", False, True),
    CsLabel("traffic light", 19, 6, "object", False, False),
    CsLabel("traffic sign", 20, 7, "object", False, False),
    CsLabel("vegetation", 21, 8, "nature", False, False),
    CsLabel("terrain", 22, 9, "nature", False, False),
    CsLabel("sky", 23, 10, "sky", False, False),
    CsLabel("person", 24, 11, "human", True, False),
    CsLabel("rider", 25, 12, "human", True, False),
    CsLabel("car", 26, 13, "vehicle", True, False),
    CsLabel("truck", 27, 14, "vehicle", True, False),
    CsLabel("bus", 28, 15, "vehicle", True, False),
    CsLabel("caravan", 29, 255, "vehicle", True, True),
    CsLabel("trailer", 30, 255, "vehicle", True, True),
    CsLabel("train", 31, 16, "vehicle", True, False),
    CsLabel("motorcycle", 32, 17, "vehicle", True, False),
    CsLabel("bicycle", 33, 18, "vehicle", True, False),
]

ID2LABEL = {l.id: l for l in CS_LABELS}
EVAL_LABELS = [l.id for l in CS_LABELS]
N_IDS = max(EVAL_LABELS) + 1
TRAINID2ID = {l.train_id: l.id for l in CS_LABELS if l.train_id != 255}

# Published average instance sizes for iIoU weighting
# (cityscapes_evaluator.py:70-81).
AVG_CLASS_SIZE = {
    "bicycle": 4672.3249222261, "caravan": 36771.8241758242,
    "motorcycle": 6298.7200839748, "rider": 3930.4788056518,
    "bus": 35732.1511111111, "train": 67583.7075812274,
    "car": 12794.0202738185, "person": 3462.4756337644,
    "truck": 27855.1264367816, "trailer": 16926.9763313609,
}


def _category2labels():
    cats: dict[str, list[CsLabel]] = {}
    for l in CS_LABELS:
        cats.setdefault(l.category, []).append(l)
    return cats


CATEGORY2LABELS = _category2labels()

# Categories where every label has instances (generateInstanceStats,
# cityscapes_evaluator.py:152-171).
INSTANCE_CATEGORIES = {
    cat: [l.id for l in ls]
    for cat, ls in CATEGORY2LABELS.items()
    if all(l.has_instances for l in ls if l.id >= 0)
}


class CityscapesOfficialEvaluator:
    """Accumulates official pixel + instance statistics over image pairs."""

    def __init__(self, eval_instances: bool = True):
        self.eval_instances = eval_instances
        self.conf = np.zeros((N_IDS, N_IDS), dtype=np.uint64)
        self.inst_classes = {
            l.name: dict(tp=0.0, fn=0.0, tpWeighted=0.0, fnWeighted=0.0)
            for l in CS_LABELS if l.has_instances and not l.ignore_in_eval
        }
        self.inst_categories = {
            cat: dict(tp=0.0, fn=0.0, tpWeighted=0.0, fnWeighted=0.0)
            for cat in INSTANCE_CATEGORIES
        }
        self.per_image: dict[str, dict] = {}

    # -- accumulation ------------------------------------------------------
    def update(self, pred: np.ndarray, gt: np.ndarray,
               inst: np.ndarray | None = None, name: str = "") -> None:
        """pred/gt: [H, W] RAW label ids; inst: *_instanceIds.png array."""
        pred = np.asarray(pred, np.int64)
        gt = np.asarray(gt, np.int64)
        if pred.shape != gt.shape:
            raise ValueError(f"shape mismatch {pred.shape} vs {gt.shape}")
        # One bincount replaces the reference's Cython inner loop
        # (addToConfusionMatrix_impl.c) — same counts.
        idx = gt.reshape(-1) * N_IDS + np.clip(pred.reshape(-1), 0, N_IDS - 1)
        self.conf += np.bincount(idx, minlength=N_IDS * N_IDS).reshape(
            N_IDS, N_IDS).astype(np.uint64)

        if self.eval_instances and inst is not None:
            self._update_instances(pred, np.asarray(inst, np.int64))

        # Per-image pixel accuracy over non-ignored ground truth.  (The
        # reference stores the *erroneous* count under "nbCorrectPixels",
        # cityscapes_evaluator.py:652-658 — we record the correct counts.)
        not_ignored = np.isin(
            gt, [l.id for l in CS_LABELS if not l.ignore_in_eval])
        if name:
            self.per_image[name] = {
                "nbNotIgnoredPixels": int(not_ignored.sum()),
                "nbCorrectPixels": int((not_ignored & (pred == gt)).sum()),
            }

    def _update_instances(self, pred: np.ndarray, inst: np.ndarray) -> None:
        sel = inst > 1000
        if not sel.any():
            return
        flat_inst = inst[sel]
        flat_pred = pred[sel]
        ids, inv = np.unique(flat_inst, return_inverse=True)
        sizes = np.bincount(inv).astype(np.float64)
        tp = np.bincount(inv, weights=(flat_pred == flat_inst // 1000))
        cat_tp = {
            cat: np.bincount(inv, weights=np.isin(flat_pred, lab_ids))
            for cat, lab_ids in INSTANCE_CATEGORIES.items()
        }
        for k, inst_id in enumerate(ids):
            label = ID2LABEL.get(int(inst_id) // 1000)
            if label is None or label.ignore_in_eval:
                continue
            weight = AVG_CLASS_SIZE[label.name] / sizes[k]
            st = self.inst_classes[label.name]
            st["tp"] += tp[k]
            st["fn"] += sizes[k] - tp[k]
            st["tpWeighted"] += tp[k] * weight
            st["fnWeighted"] += (sizes[k] - tp[k]) * weight
            if label.category in self.inst_categories:
                ct = self.inst_categories[label.category]
                ct["tp"] += cat_tp[label.category][k]
                ct["fn"] += sizes[k] - cat_tp[label.category][k]
                ct["tpWeighted"] += cat_tp[label.category][k] * weight
                ct["fnWeighted"] += (sizes[k] - cat_tp[label.category][k]) * weight

    # -- scores (official rules) -------------------------------------------
    def _iou_for_label(self, label_id: int) -> float:
        label = ID2LABEL[label_id]
        if label.ignore_in_eval:
            return float("nan")
        tp = int(self.conf[label_id, label_id])
        fn = int(self.conf[label_id, :].sum()) - tp
        not_ignored = [l for l in EVAL_LABELS
                       if not ID2LABEL[l].ignore_in_eval and l != label_id]
        fp = int(self.conf[not_ignored, label_id].sum())
        denom = tp + fp + fn
        return tp / denom if denom else float("nan")

    def _inst_iou_for_label(self, label_id: int) -> float:
        label = ID2LABEL[label_id]
        if label.ignore_in_eval or label.name not in self.inst_classes:
            return float("nan")
        st = self.inst_classes[label.name]
        not_ignored = [l for l in EVAL_LABELS
                       if not ID2LABEL[l].ignore_in_eval and l != label_id]
        fp = int(self.conf[not_ignored, label_id].sum())
        denom = st["tpWeighted"] + fp + st["fnWeighted"]
        return st["tpWeighted"] / denom if denom else float("nan")

    def _iou_for_category(self, category: str) -> float:
        lab_ids = [l.id for l in CATEGORY2LABELS[category]
                   if not l.ignore_in_eval and l.id in EVAL_LABELS]
        if not lab_ids:
            return float("nan")
        tp = int(self.conf[np.ix_(lab_ids, lab_ids)].sum())
        fn = int(self.conf[lab_ids, :].sum()) - tp
        other = [l for l in EVAL_LABELS if not ID2LABEL[l].ignore_in_eval
                 and ID2LABEL[l].category != category]
        fp = int(self.conf[np.ix_(other, lab_ids)].sum())
        denom = tp + fp + fn
        return tp / denom if denom else float("nan")

    def _inst_iou_for_category(self, category: str) -> float:
        if category not in self.inst_categories:
            return float("nan")
        lab_ids = INSTANCE_CATEGORIES[category]
        ct = self.inst_categories[category]
        other = [l for l in EVAL_LABELS if not ID2LABEL[l].ignore_in_eval
                 and ID2LABEL[l].category != category]
        fp = int(self.conf[np.ix_(other, lab_ids)].sum())
        denom = ct["tpWeighted"] + fp + ct["fnWeighted"]
        return ct["tpWeighted"] / denom if denom else float("nan")

    @staticmethod
    def _avg(scores: dict[str, float]) -> float:
        vals = [v for v in scores.values() if not math.isnan(v)]
        return sum(vals) / len(vals) if vals else float("nan")

    def results(self) -> dict:
        class_scores = {ID2LABEL[l].name: self._iou_for_label(l)
                        for l in EVAL_LABELS}
        class_inst = {ID2LABEL[l].name: self._inst_iou_for_label(l)
                      for l in EVAL_LABELS}
        cat_scores = {c: self._iou_for_category(c) for c in CATEGORY2LABELS}
        cat_inst = {c: self._inst_iou_for_category(c) for c in CATEGORY2LABELS}
        total = self.conf.sum()
        return {
            "confMatrix": self.conf,
            "classScores": class_scores,
            "classInstScores": class_inst,
            "categoryScores": cat_scores,
            "categoryInstScores": cat_inst,
            "averageScoreClasses": self._avg(class_scores),
            "averageScoreInstClasses": self._avg(class_inst),
            "averageScoreCategories": self._avg(cat_scores),
            "averageScoreInstCategories": self._avg(cat_inst),
            "pixelAccuracy": (
                float(np.diag(self.conf).sum()) / total if total else
                float("nan")),
            "perImageScores": self.per_image,
        }


def _load_png(path: str) -> np.ndarray:
    return read_png(path)


def find_pairs(pred_dir: str, gt_dir: str) -> list[tuple[str, str, str | None]]:
    """Match *_gtFine_labelIds.png (recursively) to predictions whose name
    starts with the same city_sequence_frame stem (getPrediction,
    cityscapes_evaluator.py:91-127)."""
    gt_files = []
    for root, _, files in os.walk(gt_dir):
        gt_files += [os.path.join(root, f) for f in files
                     if f.endswith("labelIds.png")]
    gt_files.sort()
    pred_walk = []
    for root, _, files in os.walk(pred_dir):
        pred_walk.append((root, files))

    pairs = []
    for gt in gt_files:
        stem = "_".join(os.path.basename(gt).split("_")[:3])
        pred = None
        for root, files in pred_walk:
            for f in fnmatch.filter(files, f"{stem}*.png"):
                pred = os.path.join(root, f)
                break
            if pred:
                break
        if pred is None:
            raise FileNotFoundError(f"no prediction for {gt}")
        inst = gt.replace("labelIds", "instanceIds")
        pairs.append((pred, gt, inst if os.path.exists(inst) else None))
    return pairs


def evaluate_dirs(pred_dir: str, gt_dir: str,
                  eval_instances: bool = True) -> dict:
    """Directory-level evaluation (CityscapesEvaluator.evaluate)."""
    ev = CityscapesOfficialEvaluator(eval_instances=eval_instances)
    for pred, gt, inst in find_pairs(pred_dir, gt_dir):
        ev.update(
            _load_png(pred), _load_png(gt),
            _load_png(inst) if (eval_instances and inst) else None,
            name=pred,
        )
    return ev.results()


def train_ids_to_raw(pred_train: np.ndarray) -> np.ndarray:
    """Map 0..18 train ids to raw submission ids (labels.py trainId->id)."""
    out = np.zeros_like(pred_train)
    for tid, rid in TRAINID2ID.items():
        out[pred_train == tid] = rid
    return out
