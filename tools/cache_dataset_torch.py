#!/usr/bin/env python
"""Decode a dataset's frames once into mmap-able .npy sidecars, for the
port's loader.

The counterpart of ``tools/cache_dataset.py`` for machines without JAX:
the same walk (``{root}/{split}/image`` and every label directory beside
it), the same ``.npy_cache/<name>.npy`` files (images as the RGB uint8
array, labels as their raw decoded form), read by the port's
``DirectorySegDataset`` whenever a sidecar is at least as new as its
source.  Frames are decoded by ``data/datasets.decode_frame``, as the
loader decodes them: PNGs by the port's reader (``utils/png.py``, native
unfilter) and JPEGs by its native decoder (``utils/jpeg.py``), neither
through PIL; BMP frames through PIL, so only a BMP tree needs this tool run
on a machine with PIL before it trains where PIL is absent.  A PNG or JPEG
tree needs no sidecars: the loader decodes its frames itself, and the
sidecars only save that decode (tens of ms a 1024x2048 frame), or carry a
JPEG the native decoder refuses (arithmetic-coded, 12-bit, lossless), which
this tool decodes through PIL.

    python tools/cache_dataset_torch.py --root /data/cityscapes --splits train,val

Re-run after changing source files (stale caches are ignored, not
auto-rebuilt).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from contrastiveseg_tpu_torch.data.datasets import (  # noqa: E402
    IMG_EXTS,
    decode_frame,
    decode_with_pil,
)
from contrastiveseg_tpu_torch.utils.jpeg import UnsupportedJPEG  # noqa: E402


def decode(path: str, rgb: bool) -> np.ndarray:
    """``decode_frame``'s array; a JPEG of a format the native decoder
    refuses through PIL, which this tool runs beside and the loader never
    takes."""
    try:
        return decode_frame(path, rgb=rgb)
    except UnsupportedJPEG:
        return decode_with_pil(path, rgb)


def cache_dir_files(d: str, as_rgb: bool) -> tuple[int, int]:
    """Cache every image file directly inside `d`; returns (new, kept)."""
    if not os.path.isdir(d):
        return (0, 0)
    out_dir = os.path.join(d, ".npy_cache")
    os.makedirs(out_dir, exist_ok=True)
    new = kept = 0
    for name in sorted(os.listdir(d)):
        if not name.lower().endswith(IMG_EXTS):
            continue
        src = os.path.join(d, name)
        dst = os.path.join(out_dir, name + ".npy")
        if os.path.exists(dst) and os.path.getmtime(dst) >= os.path.getmtime(src):
            kept += 1
            continue
        np.save(dst, decode(src, as_rgb))
        new += 1
    return (new, kept)


def cache_tree(root: str, splits: list[str]) -> tuple[int, int]:
    """Every split's image and label directories; returns (decoded, kept)."""
    total_new = total_kept = 0
    for split in splits:
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            print(f"skip {base}: not a directory")
            continue
        for sub in sorted(os.listdir(base)):
            d = os.path.join(base, sub)
            if not os.path.isdir(d) or sub.startswith("."):
                continue
            new, kept = cache_dir_files(d, as_rgb=sub == "image")
            if new or kept:
                print(f"{d}: {new} cached, {kept} fresh")
            total_new += new
            total_kept += kept
    return total_new, total_kept


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="dataset root "
                    "({root}/{split}/image + label layout)")
    ap.add_argument("--splits", default="train,val")
    args = ap.parse_args(argv)
    new, kept = cache_tree(args.root, args.splits.split(","))
    print(f"done: {new} decoded, {kept} already fresh")


if __name__ == "__main__":
    main()
