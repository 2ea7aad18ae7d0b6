"""Batch collation: size alignment + padding + stacking (numpy, NHWC).

The port's copy of ``contrastiveseg_tpu/data/collate.py``.  That module
re-implements the reference collate (lib/datasets/tools/collate.py:37-175):
size modes fix_size / multi_size / max_size / diverse_size, ``fit_stride``
padding, align methods only_pad / only_scale / scale_and_pad, pad modes
random / pad_left_up / pad_right_down / pad_center / pad_border.
Image pads with 0 (post-normalization zeros), label with -1.

``fix_size`` keeps every batch the same shape; ``diverse_size`` keeps each
image at its own size (eval only).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from contrastiveseg_tpu_torch.data import native
from contrastiveseg_tpu_torch.data.transforms import _nearest_resize
from contrastiveseg_tpu_torch.ops.resize import _align_corners_matrix

_PAD_VALUES = {
    "image": 0.0,
    "label": -1,
    "maskmap": 0,
    "distance_map": 255,
    "angle_map": 0,
    "boundary_map": -1,  # direction/mask label maps pad with -1
}


def _pad_offsets(pad_w: int, pad_h: int, pad_mode: str,
                 rng: np.random.Generator) -> tuple[int, int]:
    if pad_mode == "random":
        return int(rng.integers(0, pad_w + 1)), int(rng.integers(0, pad_h + 1))
    if pad_mode == "pad_left_up":
        return pad_w, pad_h
    if pad_mode == "pad_right_down":
        return 0, 0
    if pad_mode == "pad_center":
        return pad_w // 2, pad_h // 2
    if pad_mode == "pad_border":
        return (pad_w, pad_h) if rng.integers(0, 2) == 0 else (0, 0)
    raise ValueError(f"invalid pad mode {pad_mode!r}")


def collate(
    samples: Sequence[dict],
    size_mode: str = "fix_size",
    input_size: tuple[int, int] | None = None,  # (w, h)
    ms_input_size: Sequence[tuple[int, int]] | None = None,
    align_method: str = "only_pad",
    pad_mode: str = "random",
    fit_stride: int | None = None,
    rng: np.random.Generator | None = None,
    normalizer=None,
) -> dict:
    """``normalizer`` (a transforms.Normalizer) enables the fused fast
    path: uint8 images are normalized+padded straight into a preallocated
    [N, th, tw, C] float32 batch by the native kernel — bit-identical to
    np.stack([np.pad(normalizer(img))]) but with zero intermediate
    copies.  Only taken under align_method='only_pad'; float images pass
    through the regular path unchanged."""
    rng = rng or np.random.default_rng()
    n = len(samples)

    if size_mode == "fix_size":
        tw, th = input_size
    elif size_mode == "multi_size":
        tw, th = ms_input_size[rng.integers(0, len(ms_input_size))]
    elif size_mode == "max_size":
        tw = max(s["image"].shape[1] for s in samples)
        th = max(s["image"].shape[0] for s in samples)
    elif size_mode == "diverse_size":
        # ADE20K-style per-image eval (collate.py:37-60 diverse branch +
        # DataHelper scatter, data_helper.py:93-117): keep every image at
        # its own size; fit_stride pads each individually (label -1, img 0).
        out_lists: dict[str, list] = {}
        metas = []
        for s in samples:
            item = {k: v for k, v in s.items() if k != "meta"}
            meta = dict(s.get("meta", {}))
            h, w = item["image"].shape[:2]
            meta["input_size"] = [w, h]
            if fit_stride:
                ph = -h % fit_stride
                pw = -w % fit_stride
                if ph or pw:
                    for k, v in item.items():
                        widths = [(0, ph), (0, pw)]
                        if v.ndim == 3:
                            widths.append((0, 0))
                        item[k] = np.pad(v, widths,
                                         constant_values=_PAD_VALUES.get(k, 0))
            for k, v in item.items():
                out_lists.setdefault(k, []).append(v)
            metas.append(meta)
        batch = dict(out_lists)
        batch["meta"] = metas
        return batch
    else:
        raise NotImplementedError(f"size mode {size_mode!r}")

    if fit_stride:
        tw += 0 if tw % fit_stride == 0 else fit_stride - tw % fit_stride
        th += 0 if th % fit_stride == 0 else fit_stride - th % fit_stride

    out: dict[str, list] = {}
    metas = []
    img_batch = None  # fused fast-path canvas
    fuse_all = (
        normalizer is not None
        and align_method == "only_pad"
        and all(
            s["image"].dtype == np.uint8 and s["image"].ndim == 3
            and s["image"].shape[-1] == len(normalizer.mean)
            for s in samples
        )
    )
    for bi, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        meta = dict(s.get("meta", {}))
        meta["input_size"] = [tw, th]
        item = {k: v for k, v in s.items() if k != "meta"}

        if (h, w) != (th, tw) and align_method in ("only_scale", "scale_and_pad"):
            w_ratio, h_ratio = tw / w, th / h
            if align_method == "scale_and_pad":
                w_ratio = h_ratio = min(w_ratio, h_ratio)
            sw, sh = int(round(w * w_ratio)), int(round(h * h_ratio))
            # Image here is already float-normalized; scale via PIL on a
            # rescaled uint8 proxy would lose precision, so use bilinear
            # via np (align_corners semantics matched on device at eval).
            item["image"] = _np_bilinear_align_corners(item["image"], (sh, sw))
            for k in ("label", "maskmap"):
                if k in item:
                    item[k] = _nearest_resize(item[k], (sw, sh))
            meta["border_size"] = [sw, sh]
            h, w = sh, sw

        pad_w, pad_h = tw - w, th - h
        if pad_w < 0 or pad_h < 0:
            raise ValueError(
                f"sample ({h}x{w}) larger than target ({th}x{tw}) with "
                f"align_method={align_method}")
        left = up = 0
        if pad_w > 0 or pad_h > 0:
            left, up = _pad_offsets(pad_w, pad_h, pad_mode, rng)

        if fuse_all:
            img = item["image"]
            if img_batch is None:
                img_batch = np.empty((n, th, tw, img.shape[-1]), np.float32)
            done = native.normalize_pad_f32(
                img, (th, tw), (up, left), normalizer.div_value,
                normalizer.mean, normalizer.std, out=img_batch[bi])
            if done is None:  # no native lib: fall back in place
                canvas = np.zeros((th, tw, img.shape[-1]), np.float32)
                canvas[up:up + h, left:left + w] = normalizer(img)
                img_batch[bi] = canvas
            item.pop("image")

        if pad_w > 0 or pad_h > 0:
            for k, v in item.items():
                pv = _PAD_VALUES.get(k, 0)
                widths = [(up, pad_h - up), (left, pad_w - left)]
                if v.ndim == 3:
                    widths.append((0, 0))
                item[k] = np.pad(v, widths, constant_values=pv)
        for k, v in item.items():
            out.setdefault(k, []).append(v)
        metas.append(meta)

    batch = {k: np.stack(v) for k, v in out.items()}
    if img_batch is not None:
        batch["image"] = img_batch
    batch["meta"] = metas
    return batch


def _np_bilinear_align_corners(x: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """Host-side align-corners bilinear (matches ops/resize.py)."""
    h_out, w_out = size_hw
    a_h = _align_corners_matrix(h_out, x.shape[0])
    a_w = _align_corners_matrix(w_out, x.shape[1])
    y = np.einsum("op,pqc->oqc", a_h, x.astype(np.float32))
    return np.einsum("oq,pqc->poc", a_w, y)
