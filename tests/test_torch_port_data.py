"""The port's data path against the JAX package's.

* ``data/pipeline.py``: the JAX ``build_pipeline`` and the port's give the
  same batches for two epochs, at seeds 0 and 1, with 0 and 2 workers, from
  a Cityscapes-layout tree (6 frames of 96x192 with raw ids, crop 64x128)
  that the test writes with PIL, with ``data.fuse_resize_crop`` on and off,
  for the val split, and for the synthetic scenes.  Labels (so crops, flips
  and pad offsets) and the frame order are bit-identical.  Images are held
  within one uint8 step before normalisation, 1 / (255 * min std) + 1e-6
  after it: the JAX side loads the committed ``native/libsegdata.so`` and
  the port its own build of the same source (``-ffast-math`` may round a
  bicubic tap the other way); the test prints how many pixels differ.
* Each transform builder, ``build_train_transforms`` with shuffled groups,
  each collate mode, ``encode_label_map``, the ``.npy_cache`` read and the
  two-shard index slices, against the JAX functions.
* ``data/native.py``: the library is built into ``build/segdata/``, never
  loaded from ``native/libsegdata.so``, and agrees with the plain versions.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from contrastiveseg_tpu.data.collate import collate as jcollate
from contrastiveseg_tpu.data.datasets import DirectorySegDataset as JDirectorySegDataset
from contrastiveseg_tpu.data.datasets import encode_label_map as jencode_label_map
from contrastiveseg_tpu.data.pipeline import DataPipeline as JDataPipeline
from contrastiveseg_tpu.data.pipeline import build_pipeline as jbuild_pipeline
from contrastiveseg_tpu.data.transforms import _TRANSFORM_BUILDERS as J_BUILDERS
from contrastiveseg_tpu.data.transforms import Normalizer as JNormalizer
from contrastiveseg_tpu.data.transforms import build_train_transforms as jbuild_train_transforms
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.data.collate import collate
from contrastiveseg_tpu_torch.data.datasets import (
    CITYSCAPES_LABEL_LIST,
    DirectorySegDataset,
    build_dataset,
    encode_label_map,
)
from contrastiveseg_tpu_torch.data.pipeline import DataPipeline, build_pipeline
from contrastiveseg_tpu_torch.data.transforms import _TRANSFORM_BUILDERS, Normalizer
from contrastiveseg_tpu_torch.data.transforms import build_train_transforms
from contrastiveseg_tpu_torch.presets import get_preset

from torch_port_helpers import write_tree

ROOT = Path(__file__).resolve().parents[1]
STD = (0.229, 0.224, 0.225)
IMAGE_ATOL = 1.0 / (255 * min(STD)) + 1e-6  # one uint8 step, normalised


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("cityscapes"))


def _overrides(root, seed, workers, fuse=True, synthetic=False):
    over = {
        "data.data_dir": str(root), "data.workers": workers, "data.synthetic": synthetic,
        "data.fuse_resize_crop": fuse, "train.batch_size": 2, "val.batch_size": 2,
        "train.data_transformer.input_size": [128, 64],
        "val.data_transformer.input_size": [192, 96],
        "train_trans.random_crop.crop_size": [128, 64],
    }
    if synthetic:
        over.update({"data.synthetic_size": [96, 192], "data.synthetic_length": 6,
                     "data.num_classes": 19})
    return over, seed


def _configs(over, seed):
    cfg, jcfg = get_preset("cityscapes_hrnet_w48_mem"), jget_preset("cityscapes_hrnet_w48_mem")
    for k, v in over.items():
        cfg, jcfg = cfg.updated(k, v), jcfg.updated(k, v)
    return cfg, jcfg


def _compare_batches(got: dict, want: dict, what: str) -> int:
    """Asserts the tolerances; returns the count of image values that differ."""
    np.testing.assert_array_equal(got["label"], want["label"], err_msg=what)
    assert got["label"].dtype == want["label"].dtype == np.int32
    assert [m["name"] for m in got["meta"]] == [m["name"] for m in want["meta"]], what
    assert got["image"].dtype == np.float32 and got["image"].shape == want["image"].shape
    diff = np.abs(got["image"] - want["image"])
    assert float(diff.max()) <= IMAGE_ATOL, (what, float(diff.max()))
    return int((diff > 0).sum())


@pytest.mark.parametrize("seed,workers,fuse", [
    (0, 0, True), (0, 2, True), (1, 0, True), (1, 2, True), (0, 0, False), (1, 2, False)])
def test_train_pipeline_matches_jax(tree, seed, workers, fuse):
    cfg, jcfg = _configs(*_overrides(tree, seed, workers, fuse))
    pipe, jpipe = build_pipeline(cfg, "train"), jbuild_pipeline(jcfg, "train")
    pipe.seed = jpipe.seed = seed
    assert len(pipe) == len(jpipe) == 3
    differing = total = 0
    for epoch in range(2):
        batches = list(pipe.epoch_iter(epoch))
        jbatches = list(jpipe.epoch_iter(epoch))
        assert len(batches) == len(jbatches) == 3
        for b, (got, want) in enumerate(zip(batches, jbatches)):
            assert got["image"].shape == (2, 64, 128, 3)
            differing += _compare_batches(got, want, f"epoch {epoch} batch {b}")
            total += got["image"].size
        assert (np.concatenate([b["label"] for b in batches]) == -1).any()  # raw id 0
    print(f"seed {seed} workers {workers} fuse {fuse}: {differing} of {total} image "
          f"values differ between the port's segdata build and the committed one")


def test_pipeline_resumes_at_a_batch(tree):
    """``iter_from(s)`` yields the stream's batches from global batch s on."""
    cfg, _ = _configs(*_overrides(tree, 0, 0))
    pipe = build_pipeline(cfg, "train")
    it = pipe.iter_from(0)
    stream = [next(it) for _ in range(5)]
    it.close()
    it = pipe.iter_from(2)
    for want in stream[2:]:
        np.testing.assert_array_equal(next(it)["image"], want["image"])
    it.close()


def test_val_and_synthetic_pipelines_match_jax(tree):
    cfg, jcfg = _configs(*_overrides(tree, 0, 0))
    for got, want in zip(build_pipeline(cfg, "val").epoch_iter(0),
                         jbuild_pipeline(jcfg, "val").epoch_iter(0)):
        assert got["image"].shape == (2, 96, 192, 3)
        _compare_batches(got, want, "val")
    cfg, jcfg = _configs(*_overrides(tree, 1, 2, synthetic=True))
    pipe, jpipe = build_pipeline(cfg, "train"), jbuild_pipeline(jcfg, "train")
    for epoch in range(2):
        for got, want in zip(pipe.epoch_iter(epoch), jpipe.epoch_iter(epoch)):
            _compare_batches(got, want, f"synthetic epoch {epoch}")


def _sample(seed=5, hw=(40, 56)):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (*hw, 3)).astype(np.uint8),
            "label": rng.integers(-1, 5, hw).astype(np.int32)}


BUILDER_PARAMS = {
    "random_resize": {"ratio": 1.0, "scale_range": [0.5, 2.0]},
    "random_crop": {"crop_size": [32, 24]},
    "random_hflip": {"ratio": 1.0, "swap_pair": [[1, 2]]},
    "random_brightness": {"ratio": 1.0},
    "random_contrast": {"ratio": 1.0},
    "random_saturation": {"ratio": 1.0},
    "random_perm": {"ratio": 1.0},
    "random_hue": {"ratio": 1.0},
    "padding": {"ratio": 1.0, "pad": [2, 3, 4, 5]},
    "random_rotate": {"ratio": 1.0},
    "resize": {"target_size": [30, 20]},
}


def test_transform_builders_are_the_jax_ones():
    assert _TRANSFORM_BUILDERS.keys() == J_BUILDERS.keys() == BUILDER_PARAMS.keys()


@pytest.mark.parametrize("name", sorted(BUILDER_PARAMS))
def test_transform_matches_jax(name):
    params = BUILDER_PARAMS[name]
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    got = _TRANSFORM_BUILDERS[name](params)(_sample(), rng)
    want = J_BUILDERS[name](params)(_sample(), jrng)
    assert rng.bit_generator.state == jrng.bit_generator.state  # same draws
    np.testing.assert_array_equal(got["label"], want["label"])
    diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
    assert got["image"].dtype == want["image"].dtype and diff.max() <= 1, diff.max()
    if name not in ("random_resize", "resize"):  # no bicubic tap: exact
        assert diff.max() == 0


@pytest.mark.parametrize("shuffle", [None, ["random_brightness", "random_contrast", "random_hue"],
                                     [["random_brightness"], ["random_perm", "random_hue"]]],
                         ids=["fixed", "shuffled", "groups"])
def test_build_train_transforms_matches_jax(shuffle):
    over = {"train_trans.trans_seq": ["random_resize", "random_crop", "random_hflip"],
            "train_trans.random_crop.crop_size": [32, 24],
            "train_trans.shuffle_trans_seq": shuffle}
    cfg, jcfg = _configs(over, 0)
    for seed in range(3):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = build_train_transforms(cfg)(_sample(seed), rng)
        want = jbuild_train_transforms(jcfg)(_sample(seed), jrng)
        np.testing.assert_array_equal(got["label"], want["label"])
        assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1
        assert rng.bit_generator.state == jrng.bit_generator.state


COLLATE_CASES = {
    **{f"only_pad-{m}": dict(input_size=(64, 48), pad_mode=m) for m in (
        "random", "pad_left_up", "pad_right_down", "pad_center", "pad_border")},
    "only_pad-fused": dict(input_size=(64, 48), fused=True),
    "fit_stride": dict(input_size=(60, 45), fit_stride=8),
    "multi_size": dict(size_mode="multi_size", ms_input_size=[(64, 48), (72, 56)]),
    "max_size": dict(size_mode="max_size"),
    "diverse_size": dict(size_mode="diverse_size", fit_stride=16),
    "only_scale": dict(input_size=(64, 48), align_method="only_scale"),
    "scale_and_pad": dict(input_size=(64, 48), align_method="scale_and_pad"),
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_collate_matches_jax(case):
    kw = dict(COLLATE_CASES[case])
    fused = kw.pop("fused", False)
    samples = [_sample(s, hw) for s, hw in ((0, (40, 56)), (1, (33, 64)), (2, (48, 37)))]
    if not fused:
        for s in samples:
            s["image"] = Normalizer()(s["image"])
    got = collate(samples, rng=np.random.default_rng(7),
                  normalizer=Normalizer() if fused else None, **kw)
    want = jcollate(samples, rng=np.random.default_rng(7),
                    normalizer=JNormalizer() if fused else None, **kw)
    assert got.keys() == want.keys()
    for key in ("image", "label"):
        for a, b in zip(*(x[key] if isinstance(x[key], list) else [x[key]] for x in (got, want))):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 if key == "image" else 0)
    assert [m["input_size"] for m in got["meta"]] == [m["input_size"] for m in want["meta"]]


def test_collate_refuses_a_sample_larger_than_the_target():
    with pytest.raises(ValueError, match="larger than target"):
        collate([_sample()], input_size=(32, 32))


def test_encode_label_map_matches_jax():
    raw = np.random.default_rng(0).integers(0, 40, (31, 45))
    got = encode_label_map(raw, CITYSCAPES_LABEL_LIST)
    np.testing.assert_array_equal(got, jencode_label_map(raw, CITYSCAPES_LABEL_LIST))
    assert got.dtype == np.int64 and set(np.unique(got)) <= set(range(19)) | {255}


def test_npy_cache_is_read_when_fresh(tree):
    """The ``.npy_cache`` sidecar stands in for its PNG when it is not older;
    a stale one is ignored, on both sides alike."""
    root = tree.parent / "cached"
    write_tree(root, n_train=1, n_val=0, hw=(8, 12), seed=3)
    img = root / "train" / "image" / "f0.png"
    lab = root / "train" / "label" / "f0.png"
    for path, value in ((img, np.full((8, 12, 3), 7, np.uint8)),
                        (lab, np.full((8, 12), 8, np.uint8))):
        (path.parent / ".npy_cache").mkdir()
        np.save(path.parent / ".npy_cache" / (path.name + ".npy"), value)
    ds = DirectorySegDataset(str(root), label_list=CITYSCAPES_LABEL_LIST)
    jds = JDirectorySegDataset(str(root), label_list=CITYSCAPES_LABEL_LIST)
    s, js = ds[0], jds[0]
    assert (s["image"] == 7).all() and (s["label"] == 1).all()  # raw 8 is train id 1
    np.testing.assert_array_equal(s["label"], js["label"])
    os.utime(img, (1e10, 1e10))  # the PNG is newer: its cache is stale
    s, js = ds[0], jds[0]
    assert not (s["image"] == 7).all()
    np.testing.assert_array_equal(s["image"], js["image"])


def test_build_dataset_refuses_what_is_not_ported(tree):
    cfg, _ = _configs(*_overrides(tree, 0, 0))
    assert len(build_dataset(cfg, "train")) == 6
    assert type(build_dataset(cfg.updated("data.loader", "lip"))).__name__ == "LipDataset"
    # SegFix's offset loader and multi-dataset training are ported now
    # (tests/test_torch_port_segfix_data.py holds them against JAX).
    assert type(build_dataset(cfg.updated("data.loader", "dt_offset"))).__name__ == (
        "DTOffsetDataset")
    multi = build_dataset(cfg.updated("data.data_dirs", [str(tree), str(tree)]))
    assert type(multi).__name__ == "MultiDataset" and multi.sizes == [6, 6]
    with pytest.raises(NotImplementedError, match="ROADMAP 7"):
        build_dataset(cfg.updated("data.loader", "nonsense"))


@pytest.mark.parametrize("drop_last", [True, False])
def test_two_shards_take_the_jax_slices(drop_last):
    """The JAX slices of every full global batch; past the last one, with
    ``drop_last`` (training) nothing, so that both ranks take the same number
    of batches (the JAX pipeline's strided rest gave rank 0 one batch more
    than rank 1 here), and without it (evaluation) the JAX strided rest."""
    data = list(range(23))
    taken = []
    for shard in (0, 1):
        pipe = DataPipeline(data, 4, num_shards=2, shard_index=shard, drop_last=drop_last)
        jpipe = JDataPipeline(data, 4, num_shards=2, shard_index=shard, drop_last=drop_last)
        assert len(pipe) == len(jpipe)
        for epoch in (0, 1):
            want = jpipe._epoch_indices(epoch)
            got = pipe._epoch_indices(epoch)
            np.testing.assert_array_equal(got, want[:len(pipe) * 4] if drop_last else want)
            # epoch_iter's count of batches
            assert (len(got) // 4 if drop_last else -(-len(got) // 4)) == len(pipe)
        taken += list(pipe._epoch_indices(0))
    assert len(set(taken)) == len(taken) == (16 if drop_last else len(data))


@pytest.fixture(scope="module")
def segdata():
    if native.LIBRARY.lib() is None:
        pytest.skip(f"segdata could not be built here: {native.LIBRARY.error}")
    return native


def test_native_builds_into_build_never_loads_the_committed_library(segdata, monkeypatch):
    opened = []
    real = ctypes.CDLL

    def spy(name, *args, **kwargs):
        opened.append(Path(name))
        return real(name, *args, **kwargs)

    monkeypatch.setattr(ctypes, "CDLL", spy)
    lib = native.SegdataLibrary()
    assert lib.lib() is not None and lib.error is None
    assert opened == [lib.library_path()]
    assert opened[0].parent == ROOT / "build" / "segdata"
    assert opened[0].exists() and opened[0] != ROOT / "native" / "libsegdata.so"
    assert lib.route() == str(opened[0])


def test_native_without_a_compiler_falls_back(tmp_path):
    lib = native.SegdataLibrary(build_dir=tmp_path, source=tmp_path / "missing.cpp")
    assert lib.get() is None and lib.get() is None
    assert lib.route() == "numpy" and lib.fallbacks == 2 and "missing.cpp" in lib.error


def test_native_agrees_with_the_plain_versions(segdata):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    for size_wh in ((100, 80), (20, 15), (53, 37)):
        got = segdata.resize_bicubic_u8(img, size_wh)
        ref = F.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None].float(),
                            size=size_wh[::-1], mode="bicubic", align_corners=False)
        ref = ref[0].permute(1, 2, 0).round().clamp(0, 255).byte().numpy()
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, size_wh
        window = segdata.resize_bicubic_window_u8(img, size_wh, (3, 2, 9, 7))
        np.testing.assert_array_equal(window, got[2:9, 3:12])
    lab = rng.integers(-1, 19, (33, 47)).astype(np.int32)
    rows = np.floor(np.arange(9) * 33 / 9).astype(int)
    cols = np.floor(np.arange(13) * 47 / 13).astype(int)
    np.testing.assert_array_equal(segdata.resize_nearest_i32(lab, (13, 9)), lab[rows][:, cols])
    mean, std = np.asarray((0.485, 0.456, 0.406), np.float32), np.asarray(STD, np.float32)
    plain = (img.astype(np.float32) / 255.0 - mean) / std
    np.testing.assert_array_equal(segdata.normalize_f32(img, 255.0, mean, std), plain)
    padded = segdata.normalize_pad_f32(img, (40, 60), (2, 5), 255.0, mean, std)
    np.testing.assert_array_equal(padded, np.pad(plain, [(2, 1), (5, 2), (0, 0)]))


def test_chip_smoke_writes_a_tree_the_loader_reads(tmp_path):
    """``chip_smoke.write_dataset``: its stdlib PNGs decode (PIL) to the
    arrays of their ``.npy_cache`` sidecars, which the loader reads without
    PIL; raw id 0 relabels to -1 and the rest to train ids."""
    import chip_smoke

    chip_smoke.write_dataset(tmp_path, n_train=2, n_val=1, hw=(32, 48), seed=1)
    ds = DirectorySegDataset(str(tmp_path), label_list=CITYSCAPES_LABEL_LIST)
    assert len(ds) == 2 and len(DirectorySegDataset(str(tmp_path), split="val")) == 1
    for (img_path, lab_path), s in zip(ds.items, (ds[0], ds[1])):
        for path, kind in ((img_path, "RGB"), (lab_path, None)):
            png = Image.open(path)
            decoded = np.asarray(png.convert(kind) if kind else png)
            cached = np.load(Path(path).parent / ".npy_cache" / (Path(path).name + ".npy"))
            np.testing.assert_array_equal(decoded, cached)
        np.testing.assert_array_equal(s["image"], np.asarray(Image.open(img_path).convert("RGB")))
        assert (s["label"][-2:] == -1).all() and set(np.unique(s["label"][:-2])) <= set(range(19))
