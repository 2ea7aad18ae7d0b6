#!/usr/bin/env python
"""Write the JPEG fixtures of ``tests/data_torch_jpeg/`` and their manifest.

The machine with the GPU has no PIL and no JPEG encoder, so the JPEG frames
that the port's native decoder (``utils/jpeg.py``) is held to there are
made here, with PIL, from seeded numpy scenes (smooth regions with hard
edges and some noise, so that the Huffman tables see many codes), at the
sizes and settings of the datasets that ship JPEG frames: ADE20K, COCO and
VOC / Pascal-Context, plus a 4:4:4 frame with restart markers and a 4:2:2
frame with optimised Huffman tables.

``manifest.json`` holds, for each file, its settings, its size in bytes,
and the shape and SHA-256 of PIL's ``np.asarray(Image.open(f))`` and of
``np.asarray(Image.open(f).convert("RGB"))``, with the PIL and
libjpeg-turbo versions that made them.

    python tools/make_jpeg_fixtures_torch.py [--out tests/data_torch_jpeg]
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "tests" / "data_torch_jpeg"
# name: (width, height), PIL mode, save settings, the dataset whose frames it stands for
FIXTURES = {
    "ade20k_683x512.jpg": ((683, 512), "RGB", {"quality": 90, "subsampling": "4:2:0"},
                           "ade20k"),
    "ade20k_512x683.jpg": ((512, 683), "RGB", {"quality": 90, "subsampling": "4:2:0"},
                           "ade20k"),
    "coco_640x480.jpg": ((640, 480), "RGB", {"quality": 85, "subsampling": "4:2:0"},
                         "coco_stuff"),
    "coco_grey_480x640.jpg": ((480, 640), "L", {"quality": 85}, "coco_stuff"),
    "voc_500x375.jpg": ((500, 375), "RGB", {"quality": 75, "subsampling": "4:2:0"},
                        "pascal_context"),
    "voc_375x500_progressive.jpg": ((375, 500), "RGB", {"quality": 75, "subsampling": "4:2:0",
                                                        "progressive": True},
                                    "pascal_context"),
    "restart_444_320x240.jpg": ((320, 240), "RGB", {"quality": 90, "subsampling": "4:4:4",
                                                    "restart_marker_blocks": 5}, None),
    "optimized_422_321x241.jpg": ((321, 241), "RGB", {"quality": 80, "subsampling": "4:2:2",
                                                      "optimize": True}, None),
}


def scene(width: int, height: int, channels: int, seed: int) -> np.ndarray:
    """uint8 [H, W, C] (or [H, W]): 12 regions of the nearest of 12 random
    centres, each a colour with a gentle gradient, plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cy, cx = rng.uniform(0, height, 12), rng.uniform(0, width, 12)
    near = np.argmin((yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2,
                     axis=0)
    base = rng.uniform(20, 235, (12, channels))[near]
    slope = rng.uniform(-0.15, 0.15, (12, 2, channels))[near]
    img = base + slope[..., 0, :] * (yy - height / 2)[..., None] / 4 \
        + slope[..., 1, :] * (xx - width / 2)[..., None] / 4
    img += rng.normal(0, 5, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main(argv=None) -> None:
    from PIL import Image, features

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    files = {}
    for seed, (name, ((w, h), mode, save, dataset)) in enumerate(FIXTURES.items()):
        path = args.out / name
        Image.fromarray(scene(w, h, 1 if mode == "L" else 3, seed), mode).save(
            path, "JPEG", **save)
        with Image.open(path) as im:
            raw, rgb = np.asarray(im), np.asarray(im.convert("RGB"))
        files[name] = {"size": [w, h], "mode": mode, "save": save, "dataset": dataset,
                       "bytes": path.stat().st_size, "shape": list(raw.shape),
                       "sha256": digest(raw), "shape_rgb": list(rgb.shape),
                       "sha256_rgb": digest(rgb)}
    manifest = {"generator": "tools/make_jpeg_fixtures_torch.py",
                "pil": Image.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
                "dtype": "uint8", "files": files}
    (args.out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(f["bytes"] for f in files.values())
    print(f"wrote {len(files)} JPEG fixtures ({total} bytes) and manifest.json to {args.out}")


if __name__ == "__main__":
    main()
