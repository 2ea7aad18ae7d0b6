"""The port's offline metrics and palettes against the JAX package's.

* ``metrics/cityscapes_official.py``: ``evaluate_dirs`` on random
  prediction, ``labelIds`` and ``instanceIds`` directories (written by PIL,
  as Cityscapes files come from elsewhere), with and without instances:
  the same confusion matrix, scores (NaN where the JAX package has NaN),
  per-image counts and pairs; ``train_ids_to_raw`` equal.
* ``metrics/dataset_evaluators.py``: each of ``EVALUATORS`` on random PNG
  directories: equal results.
* ``tools/evaluate_torch.evaluate_dirs`` against ``tools/evaluate.py``'s,
  on raw ids and on train ids: equal scores.
* ``utils/palette.py``: equal colormaps and colourised maps.

All comparisons are exact (integer counts; scores computed from them in
float64 the same way on both sides).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from PIL import Image

import tools.evaluate as jevaluate
import tools.evaluate_torch as pevaluate
from contrastiveseg_tpu.metrics import cityscapes_official as jco
from contrastiveseg_tpu.metrics import dataset_evaluators as jde
from contrastiveseg_tpu.utils import palette as jpalette
from contrastiveseg_tpu_torch.metrics import cityscapes_official as pco
from contrastiveseg_tpu_torch.metrics import dataset_evaluators as pde
from contrastiveseg_tpu_torch.utils import palette as ppalette

from torch_port_helpers import one_torch_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _same(a, b, path="") -> None:
    """Equal results: arrays exactly, floats exactly or both NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _cityscapes_dirs(root, seed: int, n: int = 3, hw=(48, 80)):
    rng = np.random.default_rng(seed)
    gt_dir, pred_dir = root / "gtFine" / "val" / "lindau", root / "pred"
    gt_dir.mkdir(parents=True)
    pred_dir.mkdir()
    ids = np.array([0, 1, 4, 7, 8, 11, 17, 21, 23, 24, 25, 26, 28, 29, 31, 33])
    for i in range(n):
        h, w = hw
        gt = np.kron(ids[rng.integers(0, len(ids), (h // 8, w // 8))], np.ones((8, 8), int))
        inst = gt.copy()
        for cls in (24, 25, 26, 28, 29, 31, 33):
            mask = gt == cls
            k = rng.integers(0, 3, (h, w))  # up to three instances a class
            inst[mask] = cls * 1000 + k[mask]
        pred = gt.copy()
        flip = rng.random((h, w)) < 0.3
        pred[flip] = ids[rng.integers(0, len(ids), int(flip.sum()))]
        stem = f"lindau_{i:06d}_000019"
        Image.fromarray(gt.astype(np.uint8)).save(gt_dir / f"{stem}_gtFine_labelIds.png")
        Image.fromarray(inst.astype(np.uint16)).save(
            gt_dir / f"{stem}_gtFine_instanceIds.png")
        Image.fromarray(pred.astype(np.uint8)).save(pred_dir / f"{stem}_leftImg8bit.png")
    return str(pred_dir), str(root / "gtFine" / "val")


@pytest.mark.parametrize("eval_instances", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_cityscapes_official_matches_jax(tmp_path, seed, eval_instances):
    pred_dir, gt_dir = _cityscapes_dirs(tmp_path, seed)
    assert pco.find_pairs(pred_dir, gt_dir) == jco.find_pairs(pred_dir, gt_dir)
    got = pco.evaluate_dirs(pred_dir, gt_dir, eval_instances=eval_instances)
    want = jco.evaluate_dirs(pred_dir, gt_dir, eval_instances=eval_instances)
    _same(got, want)
    assert got["confMatrix"].sum() == 3 * 48 * 80
    if eval_instances:  # the instance path ran
        assert not math.isnan(got["averageScoreInstClasses"])


def test_cityscapes_tables_and_train_ids_to_raw():
    assert pco.CS_LABELS == [pco.CsLabel(*vars(lab).values()) for lab in jco.CS_LABELS]
    assert pco.TRAINID2ID == jco.TRAINID2ID and pco.AVG_CLASS_SIZE == jco.AVG_CLASS_SIZE
    assert pco.INSTANCE_CATEGORIES == jco.INSTANCE_CATEGORIES
    pred = np.random.default_rng(3).integers(0, 19, (31, 45))
    np.testing.assert_array_equal(pco.train_ids_to_raw(pred), jco.train_ids_to_raw(pred))


def _label_dirs(root, seed: int, high: int, n: int = 3, hw=(24, 40)):
    rng = np.random.default_rng(seed)
    dirs = []
    for kind in ("pred", "gt"):
        d = root / kind
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, high, hw).astype(np.uint8)).save(d / f"im{i}.png")
        dirs.append(str(d))
    (root / "pred" / "unpaired.png").write_bytes((root / "pred" / "im0.png").read_bytes())
    return dirs


@pytest.mark.parametrize("name,high", [("ade20k", 151), ("pascal_context", 60),
                                       ("coco_stuff", 183)])
def test_dataset_evaluators_match_jax(tmp_path, name, high):
    pred_dir, gt_dir = _label_dirs(tmp_path, seed=len(name), high=high)
    got = pde.EVALUATORS[name]().evaluate(pred_dir, gt_dir)
    want = jde.EVALUATORS[name]().evaluate(pred_dir, gt_dir)
    assert got["images"] == want["images"] == 3
    _same(got, want)
    assert pde._cocostuff_id_to_trainid() == jde._cocostuff_id_to_trainid()


@pytest.mark.parametrize("train_ids", [False, True])
def test_evaluate_dirs_matches_jax(tmp_path, train_ids):
    rng = np.random.default_rng(7)
    ids = np.array(pevaluate.CITYSCAPES_LABEL_LIST + [0, 1, 4])
    for kind in ("pred", "gt"):
        (tmp_path / kind).mkdir()
        for i in range(3):
            lab = (rng.integers(0, 21, (32, 48)) if train_ids
                   else ids[rng.integers(0, len(ids), (32, 48))])
            Image.fromarray(lab.astype(np.uint8)).save(tmp_path / kind / f"f{i}.png")
    args = (str(tmp_path / "pred"), str(tmp_path / "gt"), 19,
            None if train_ids else pevaluate.CITYSCAPES_LABEL_LIST, train_ids)
    got, want = pevaluate.evaluate_dirs(*args), jevaluate.evaluate_dirs(*args)
    assert got["num_images"] == want["num_images"] == 3
    _same(got, want)


def test_palette_matches_jax():
    np.testing.assert_array_equal(ppalette.voc_colormap(), jpalette.voc_colormap())
    for dataset, n in (("cityscapes", 19), ("ade20k", 150), ("", 5)):
        np.testing.assert_array_equal(ppalette.get_palette(dataset, n),
                                      jpalette.get_palette(dataset, n))
    label = np.random.default_rng(5).integers(-1, 21, (17, 23))
    pal = ppalette.get_palette("cityscapes", 19)
    np.testing.assert_array_equal(ppalette.colorize(label, pal), jpalette.colorize(label, pal))


def test_running_score_histogram_runs_on_cpu_tensors():
    """``evaluate_torch`` counts through ``ops/confusion.py`` on CPU tensors."""
    pred = torch.tensor([[0, 1, 2, 2]])
    gt = torch.tensor([[0, 1, -1, 1]])
    cm = pevaluate.confusion_matrix(pred, gt, 3)
    assert cm.device.type == "cpu" and cm.tolist() == [[1, 0, 0], [0, 1, 1], [0, 0, 0]]
