"""Color palettes for visualization: the port's copy of
``contrastiveseg_tpu/utils/palette.py`` (reference lib/vis/palette.py).

Palettes are the standard published dataset colormaps (Cityscapes official
colors, ADE20K, PASCAL-Context/VOC colormap generator).
"""

from __future__ import annotations

import numpy as np

# Official Cityscapes train-id colors (cityscapes-scripts labels.py).
CITYSCAPES_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32],
], dtype=np.uint8)


def voc_colormap(n: int = 256) -> np.ndarray:
    """The canonical PASCAL VOC bit-interleave colormap."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def get_palette(dataset: str, num_classes: int) -> np.ndarray:
    if dataset == "cityscapes" and num_classes <= 19:
        return CITYSCAPES_PALETTE[:num_classes]
    return voc_colormap(max(num_classes, 256))[:num_classes]


def colorize(label: np.ndarray, palette: np.ndarray,
             ignore_index: int = -1) -> np.ndarray:
    """[H, W] int labels -> [H, W, 3] uint8 colors; ignore -> black."""
    out = np.zeros((*label.shape, 3), dtype=np.uint8)
    valid = (label >= 0) & (label < len(palette))
    out[valid] = palette[label[valid]]
    return out
