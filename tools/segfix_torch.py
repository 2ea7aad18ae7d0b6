#!/usr/bin/env python
"""SegFix offline refinement on the port: shift the labels of boundary
pixels along predicted offsets.

Counterpart of ``tools/segfix.py`` (the reference's apply scripts,
scripts/cityscapes/{segfix,segfix_ade20k,segfix_instance}.py), in PyTorch
on an explicit device, with no PIL: PNGs are read and written through
``contrastiveseg_tpu_torch/utils/png.py`` (grey and palette label maps;
palette indices are the labels, as PIL's ``convert("P")`` leaves them).
For each label PNG of ``--input_dir`` it loads ``{stem}.npz``
(``Tester.test_offset``'s ``dir_label`` and ``mask``, or an ``offset``
[H, W, 2]) or ``{stem}.mat`` (the reference's released (dy, dx) offsets)
from ``--offset_dir`` and replaces each pixel's label with the label at
``(y + dy * scale, x + dx * scale)``:

  * ``--interp nearest``: an integer gather, clamped at the border;
  * ``--interp bilinear``: the reference scripts' ``shift``,
    ``F.grid_sample(..., align_corners=False, padding_mode="border")`` in
    float64 on a grid normalised by ``(len - 1) / 2``, then rounded: the
    JAX tool's ``ndimage.map_coordinates`` samples, which land on
    ``(p + dp) * len / (len - 1) - 0.5``, to 1e-12.  With integer offsets
    many samples are exact halves (a tie between two ids, or a mask at
    0.5), which both float64 routes miss by a few ulps either way, each its
    own way and the card's unlike the CPU's.  A sample within 1e-9 of a
    half is set to it (``snap_halves``) before it is rounded (half to even)
    or thresholded, as exact arithmetic would do it, so that the card and
    the CPU write the same bytes; the JAX tool rounds its float sample, so
    it may differ from this tool at those ties, and only there.

``--dataset cityscapes|ade20k`` reads raw submission ids (encode, shift,
decode); ``--mode instance`` shifts the binary masks of Cityscapes instance
submissions (``*_pred.txt``), re-thresholded at 0.5.

    python tools/segfix_torch.py --input_dir pred/label --offset_dir out/offset \\
        --out_dir refined [--scale 2] [--interp nearest|bilinear] \\
        [--dataset trainid|cityscapes|ade20k] [--mode semantic|instance] \\
        [--device cuda]

``--device`` defaults to ``cuda`` and then fails without CUDA; it never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from contrastiveseg_tpu_torch.utils.offset_helper import (  # noqa: E402
    DTOffsetConfig,
    label_to_vector,
)
from contrastiveseg_tpu_torch.utils.png import read_png, write_png  # noqa: E402

# Raw-submission label encodings of the reference apply scripts: Cityscapes
# labelIds and ADE20K's 1-based ids ("trainid": contiguous train ids, the
# Tester's output).
RAW_ID_LISTS = {
    "cityscapes": [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26,
                   27, 28, 31, 32, 33],
    "ade20k": list(range(1, 151)),
}


def apply_offsets(label: np.ndarray, offset: np.ndarray, scale: int = 1,
                  device: torch.device | str = "cpu") -> np.ndarray:
    """label [H, W]; offset [H, W, 2] int (dy, dx); the label at
    ``(y + dy * scale, x + dx * scale)``, clamped into the image."""
    lab = torch.as_tensor(label, device=device)
    off = torch.as_tensor(np.asarray(offset) * scale, device=device).long()
    h, w = lab.shape
    ys = (torch.arange(h, device=device)[:, None] + off[..., 0]).clamp(0, h - 1)
    xs = (torch.arange(w, device=device)[None, :] + off[..., 1]).clamp(0, w - 1)
    return lab[ys, xs].cpu().numpy()


def snap_halves(x: torch.Tensor, tol: float = 1e-9) -> torch.Tensor:
    """``x`` with each value within ``tol`` of a half (k + 0.5) set to it."""
    half = torch.floor(x) + 0.5
    return torch.where((x - half).abs() < tol, half, x)


def grid_sample_shift(stack: np.ndarray, offset: np.ndarray, scale: float = 1.0,
                      device: torch.device | str = "cpu") -> np.ndarray:
    """[N, H, W] maps resampled bilinearly along (dy, dx) ``offset``
    [H, W, 2], in float64: the reference scripts' ``shift``, halves
    snapped (``snap_halves``)."""
    x = torch.as_tensor(np.asarray(stack, np.float64), device=device)[:, None]
    n, _, h, w = x.shape
    off = torch.as_tensor(np.asarray(offset, np.float64), device=device) * scale
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device),
                            indexing="ij")
    grid = torch.stack([(xx + off[..., 1]) / (w - 1) * 2 - 1,
                        (yy + off[..., 0]) / (h - 1) * 2 - 1], dim=-1)
    out = F.grid_sample(x, grid[None].expand(n, h, w, 2), mode="bilinear",
                        padding_mode="border", align_corners=False)
    return snap_halves(out[:, 0]).cpu().numpy()


def shift_instance_masks(masks: np.ndarray, offset: np.ndarray, scale: float = 1.0,
                         device: torch.device | str = "cpu") -> np.ndarray:
    """Binary instance masks [N, H, W] shifted along ``offset``,
    re-thresholded at 0.5 (segfix_instance.py ``shift``)."""
    out = grid_sample_shift(masks.astype(np.float64), offset, scale, device)
    return (out > 0.5).astype(np.uint8)


def encode_raw_labels(label: np.ndarray, dataset: str) -> np.ndarray:
    """Raw submission ids -> contiguous train ids (255 = unlabeled)."""
    lut = np.full(256, 255, np.int64)
    for i, raw in enumerate(RAW_ID_LISTS[dataset]):
        lut[raw] = i
    return lut[label.astype(np.int64)]


def decode_raw_labels(label: np.ndarray, dataset: str) -> np.ndarray:
    """Contiguous train ids -> raw submission ids (255 = unlabeled)."""
    lut = np.full(256, 255, np.uint8)
    for i, raw in enumerate(RAW_ID_LISTS[dataset]):
        lut[i] = raw
    return lut[np.clip(label, 0, 255).astype(np.int64)]


def shift_labels_bilinear(label: np.ndarray, offset: np.ndarray, scale: float = 1.0,
                          device: torch.device | str = "cpu") -> np.ndarray:
    """The reference's semantic apply path (``shift`` + ``np.round``): the
    id map resampled bilinearly and rounded to the nearest id, across
    numeric id values at boundaries as the reference does."""
    out = grid_sample_shift(label[None].astype(np.float64), offset, scale, device)
    return np.round(out[0]).astype(np.int64)


def load_offset(path: str) -> tuple[np.ndarray | None, np.ndarray | None]:
    """(offset [H, W, 2] float64 or None, dir_label or None) of an offset
    file: ``.npz`` (``offset``, or ``dir_label`` with an optional ``mask``
    whose 0 pixels get no offset) or ``.mat`` (key ``mat``, (dy, dx))."""
    if path.endswith(".mat"):
        import scipy.io as sio

        return sio.loadmat(path)["mat"].astype(np.float64), None
    data = np.load(path)
    if "offset" in data:
        return data["offset"].astype(np.float64), None
    dir_label = data["dir_label"].astype(np.int64)
    if "mask" in data:
        dir_label = np.where(data["mask"] > 0, dir_label, -1)
    return None, dir_label


def read_label_png(path: str) -> np.ndarray:
    """A grey or palette label PNG as its [H, W] values."""
    label = read_png(path)
    if label.ndim != 2:
        raise ValueError(f"{path}: a label PNG must be grey or palette, not {label.shape}")
    return label


def refine_instances(input_dir: str, offset_dir: str, out_dir: str, scale: float = 1.0,
                     device: torch.device | str = "cpu") -> int:
    """Instance-submission refinement (segfix_instance.py:66-94): each
    ``*_pred.txt`` (lines ``mask.png class score``) is copied, and its
    masks are shifted along the image's ``offset`` and saved as 0/255
    PNGs; returns the number of submissions."""
    n_imgs = 0
    for fn in sorted(os.listdir(input_dir)):
        if not fn.endswith("_pred.txt"):
            continue
        names, masks = [], []
        with open(os.path.join(input_dir, fn)) as f:
            for line in f:
                if not line.strip():
                    continue
                name = line.strip().split()[0]
                names.append(name)
                masks.append(read_label_png(os.path.join(input_dir, name)))
        shutil.copy(os.path.join(input_dir, fn), out_dir)
        if masks:
            off_path = os.path.join(offset_dir, fn[: -len("_pred.txt")] + ".npz")
            stack = (np.stack(masks, 0) > 0).astype(np.uint8)
            if os.path.exists(off_path):
                offset = np.load(off_path)["offset"].astype(np.float32)
                stack = shift_instance_masks(stack, offset, scale, device)
            for name, mask in zip(names, stack):
                out_path = os.path.join(out_dir, name)
                os.makedirs(os.path.dirname(out_path) or out_dir, exist_ok=True)
                write_png(out_path, mask * 255)
        n_imgs += 1
    return n_imgs


def refine_labels(input_dir: str, offset_dir: str, out_dir: str, scale: float = 2,
                  cfg: DTOffsetConfig = DTOffsetConfig(), dataset: str = "trainid",
                  interp: str = "nearest", device: torch.device | str = "cpu") -> int:
    """Refine every label PNG of ``input_dir`` into ``out_dir`` (a PNG
    without an offset file is copied as read); returns their number."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(input_dir)):
        if not name.endswith(".png"):
            continue
        stem = os.path.splitext(name)[0]
        off_path = next((p for p in (os.path.join(offset_dir, stem + ext)
                                     for ext in (".npz", ".mat")) if os.path.exists(p)), None)
        label = read_label_png(os.path.join(input_dir, name)).astype(np.int64)
        if dataset != "trainid":
            label = encode_raw_labels(label, dataset)
        if off_path is None:
            out = label
        else:
            offset, dir_label = load_offset(off_path)
            if offset is None:
                offset = label_to_vector(dir_label, cfg).astype(np.float64)
            if interp == "bilinear":
                out = shift_labels_bilinear(label, offset, scale, device)
            else:
                out = apply_offsets(label, offset.astype(np.int64), int(scale), device)
        if dataset != "trainid":
            out = decode_raw_labels(out, dataset)
        write_png(os.path.join(out_dir, name), out.astype(np.uint8))
        n += 1
    return n


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--offset_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--scale", type=float, default=2)
    ap.add_argument("--num_classes", type=int, default=8)
    ap.add_argument("--c4_align_axis", action="store_true",
                    help="axis-aligned 4-direction mapping (the reference's c4_align_axis)")
    ap.add_argument("--mode", choices=["semantic", "instance"], default="semantic",
                    help="instance: refine Cityscapes instance submissions (*_pred.txt + "
                         "binary mask PNGs)")
    ap.add_argument("--dataset", choices=["trainid", "cityscapes", "ade20k"],
                    default="trainid",
                    help="the input PNGs' ids: contiguous train ids, or raw submission ids "
                         "(Cityscapes labelIds, ADE20K 1-based), encoded, shifted, decoded")
    ap.add_argument("--interp", choices=["nearest", "bilinear"], default="nearest",
                    help="bilinear: the reference scripts' grid_sample + round; nearest: "
                         "an integer gather (the same for integer offsets)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.mode == "instance":
        n = refine_instances(args.input_dir, args.offset_dir, args.out_dir, args.scale, device)
        print(f"refined {n} instance submissions -> {args.out_dir}")
        return n
    cfg = DTOffsetConfig(num_classes=args.num_classes, c4_align_axis=args.c4_align_axis)
    n = refine_labels(args.input_dir, args.offset_dir, args.out_dir, args.scale, cfg,
                      args.dataset, args.interp, device)
    print(f"refined {n} label maps -> {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
