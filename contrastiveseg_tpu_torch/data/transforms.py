"""Host-side augmentation transforms (numpy; PIL only where noted).

The port's copy of ``contrastiveseg_tpu/data/transforms.py``, with the same
names, sampling order and outputs.  That module re-implements the
reference's cv2 aug pipeline (``lib/datasets/tools/cv2_aug_transforms.py``)
with the same sampling distributions, but:

  * explicit ``np.random.Generator`` instead of global ``random`` state
    (reproducible per-sample seeds across workers/hosts);
  * the native bicubic resize of ``native/segdata.cpp`` (cv2 INTER_CUBIC's
    kernel), PIL bicubic where that library is missing, and exact
    floor-indexed nearest for label maps;
  * RGB channel order + ImageNet normalization (the reference feeds BGR
    yet normalizes with RGB-ordered means — a quirk that only matters for
    its own pretrained weights).

Samples are dicts: ``image`` float32/uint8 HWC, ``label`` int HW, optional
``maskmap``/``offsetmap``/... following the reference's multi-map dispatch.
PIL is imported only by the bicubic fallback and ``RandomRotate``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from contrastiveseg_tpu_torch.data import native

IMAGE_KEYS = ("image",)
NEAREST_KEYS = ("label", "maskmap", "distance_map", "angle_map", "boundary_map")


def _pil_resize_img(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """Bicubic uint8 image resize (reference uses cv2 INTER_CUBIC).

    Prefers the native C kernel (exact cv2 kernel: Keys a=-0.75,
    half-pixel, clamp) and falls back to PIL bicubic."""
    if img.dtype != np.uint8:
        img = img.astype(np.uint8)
    out = native.resize_bicubic_u8(img, size_wh)
    if out is not None:
        return out
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size_wh, Image.BICUBIC))


def _nearest_resize(x: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    if x.ndim == 2 and x.dtype in (np.int32, np.int64):
        out = native.resize_nearest_i32(x.astype(np.int32), size_wh)
        if out is not None:
            return out.astype(x.dtype)
    w, h = size_wh
    src_h, src_w = x.shape[:2]
    rows = np.clip(np.floor(np.arange(h) * src_h / h).astype(np.int64), 0, src_h - 1)
    cols = np.clip(np.floor(np.arange(w) * src_w / w).astype(np.int64), 0, src_w - 1)
    return x[rows][:, cols]


class RandomResize:
    """Uniform scale in scale_range x sqrt-aspect jitter
    (cv2_aug_transforms.py:327-442)."""

    def __init__(self, scale_range=(0.75, 1.25), aspect_range=(0.9, 1.1),
                 ratio=1.0, scale_list=None, max_side_bound=None):
        self.scale_range = scale_range
        self.aspect_range = aspect_range
        self.ratio = ratio
        self.scale_list = scale_list
        self.max_side_bound = max_side_bound

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        h, w = sample["image"].shape[:2]
        if self.scale_list is not None:
            scale = self.scale_list[rng.integers(0, len(self.scale_list))]
        else:
            scale = rng.uniform(*self.scale_range)
        aspect = rng.uniform(*self.aspect_range)
        w_ratio = math.sqrt(aspect) * scale
        h_ratio = math.sqrt(1.0 / aspect) * scale
        if self.max_side_bound is not None and max(
            h * h_ratio, w * w_ratio
        ) > self.max_side_bound:
            d = self.max_side_bound / max(h * h_ratio, w * w_ratio)
            w_ratio *= d
            h_ratio *= d
        size = (int(w * w_ratio), int(h * h_ratio))
        out = dict(sample)
        out["image"] = _pil_resize_img(sample["image"], size)
        for k in NEAREST_KEYS:
            if k in sample:
                out[k] = _nearest_resize(sample[k], size)
        return out


class RandomCrop:
    """Random/center/grid crop (cv2_aug_transforms.py:504-602).  Like the
    reference, crops to min(crop, img) per axis — padding happens in
    collate."""

    def __init__(self, crop_size=(1024, 512), ratio=1.0, method="random",
                 grid=None, allow_outside_center=False):
        self.size = tuple(crop_size)  # (w, h)
        self.ratio = ratio
        self.method = method
        self.grid = grid

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        h, w = sample["image"].shape[:2]
        tw, th = min(self.size[0], w), min(self.size[1], h)
        if self.method == "center":
            x0, y0 = (w - tw) // 2, (h - th) // 2
        elif self.method == "grid":
            gx = rng.integers(0, self.grid[0])
            gy = rng.integers(0, self.grid[1])
            x0 = gx * ((w - tw) // max(self.grid[0] - 1, 1))
            y0 = gy * ((h - th) // max(self.grid[1] - 1, 1))
        else:
            x0 = int(rng.integers(0, w - tw + 1))
            y0 = int(rng.integers(0, h - th + 1))
        out = dict(sample)
        for k in ("image", *NEAREST_KEYS):
            if k in sample:
                out[k] = sample[k][y0:y0 + th, x0:x0 + tw]
        return out


class FusedResizeCrop:
    """RandomResize immediately followed by RandomCrop, evaluated lazily:
    only the cropped window of the virtual resized image is ever computed
    (native ``resize_bicubic_window_u8``).  Draws from ``rng`` in exactly
    the order the two constituent transforms would, and produces
    bit-identical samples + rng state — the full resize at scale 2
    materializes 8.4 Mpx of a 1024x2048 Cityscapes frame to keep a
    0.5 Mpx crop, which dominated host aug cost (~400 ms/img)."""

    def __init__(self, resize: RandomResize, crop: RandomCrop):
        self.resize = resize
        self.crop = crop

    def _draw_virtual_size(self, sample, rng):
        """Replicates RandomResize's rng draws; returns (vw, vh) or None
        when the ratio gate skips the resize."""
        r = self.resize
        if rng.random() > r.ratio:
            return None
        h, w = sample["image"].shape[:2]
        if r.scale_list is not None:
            scale = r.scale_list[rng.integers(0, len(r.scale_list))]
        else:
            scale = rng.uniform(*r.scale_range)
        aspect = rng.uniform(*r.aspect_range)
        w_ratio = math.sqrt(aspect) * scale
        h_ratio = math.sqrt(1.0 / aspect) * scale
        if r.max_side_bound is not None and max(
            h * h_ratio, w * w_ratio
        ) > r.max_side_bound:
            d = r.max_side_bound / max(h * h_ratio, w * w_ratio)
            w_ratio *= d
            h_ratio *= d
        return (int(w * w_ratio), int(h * h_ratio))

    def _draw_crop(self, vw, vh, rng):
        """Replicates RandomCrop's rng draws; returns (x0, y0, tw, th) or
        None when the ratio gate skips the crop."""
        c = self.crop
        if rng.random() > c.ratio:
            return None
        tw, th = min(c.size[0], vw), min(c.size[1], vh)
        if c.method == "center":
            x0, y0 = (vw - tw) // 2, (vh - th) // 2
        elif c.method == "grid":
            gx = rng.integers(0, c.grid[0])
            gy = rng.integers(0, c.grid[1])
            x0 = gx * ((vw - tw) // max(c.grid[0] - 1, 1))
            y0 = gy * ((vh - th) // max(c.grid[1] - 1, 1))
        else:
            x0 = int(rng.integers(0, vw - tw + 1))
            y0 = int(rng.integers(0, vh - th + 1))
        return (x0, y0, tw, th)

    @staticmethod
    def _nearest_window(x, vw, vh, win):
        """window of _nearest_resize(x, (vw, vh)) without materializing it."""
        x0, y0, tw, th = win
        sh, sw = x.shape[:2]
        rows = np.clip(
            np.floor((y0 + np.arange(th)) * sh / vh).astype(np.int64),
            0, sh - 1)
        cols = np.clip(
            np.floor((x0 + np.arange(tw)) * sw / vw).astype(np.int64),
            0, sw - 1)
        return x[rows][:, cols]

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        virtual = self._draw_virtual_size(sample, rng)
        if virtual is None:  # resize skipped: plain crop
            return self.crop(sample, rng)
        vw, vh = virtual
        win = self._draw_crop(vw, vh, rng)
        if win is None:  # crop skipped: plain full resize
            out = dict(sample)
            out["image"] = _pil_resize_img(sample["image"], (vw, vh))
            for k in NEAREST_KEYS:
                if k in sample:
                    out[k] = _nearest_resize(sample[k], (vw, vh))
            return out
        out = dict(sample)
        src = sample["image"]
        if src.dtype != np.uint8:
            src = src.astype(np.uint8)
        img = native.resize_bicubic_window_u8(src, (vw, vh), win)
        if img is None:  # no native lib: full resize then crop
            x0, y0, tw, th = win
            img = _pil_resize_img(sample["image"], (vw, vh))[
                y0:y0 + th, x0:x0 + tw]
        out["image"] = img
        for k in NEAREST_KEYS:
            if k in sample:
                out[k] = self._nearest_window(sample[k], vw, vh, win)
        return out


class RandomHFlip:
    """Horizontal flip + optional label-id swap pairs
    (cv2_aug_transforms.py:143-201)."""

    def __init__(self, ratio=0.5, swap_pair: Sequence[Sequence[int]] = ()):
        self.ratio = ratio
        self.swap_pair = swap_pair

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        out = dict(sample)
        for k in ("image", *NEAREST_KEYS):
            if k in sample:
                out[k] = sample[k][:, ::-1].copy()
        if self.swap_pair and "label" in out:
            lab = out["label"].copy()
            for a, b in self.swap_pair:
                lab[out["label"] == a] = b
                lab[out["label"] == b] = a
            out["label"] = lab
        return out


class RandomBrightness:
    """Integer shift in [-shift, shift] (cv2_aug_transforms.py:305-325)."""

    def __init__(self, shift_value=30, ratio=0.5):
        self.shift_value = shift_value
        self.ratio = ratio

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        shift = int(rng.integers(-self.shift_value, self.shift_value + 1))
        out = dict(sample)
        img = sample["image"]
        if img.dtype == np.uint8:
            # 256-entry LUT == clip(around(v + shift)) for every uint8 v.
            lut = np.clip(
                np.around(np.arange(256, dtype=np.float32) + shift),
                0, 255).astype(np.uint8)
            out["image"] = lut[img]
        else:
            out["image"] = np.clip(
                np.around(img.astype(np.float32) + shift), 0, 255
            ).astype(np.uint8)
        return out


class RandomContrast:
    def __init__(self, lower=0.5, upper=1.5, ratio=0.5):
        self.lower, self.upper, self.ratio = lower, upper, ratio

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        f = rng.uniform(self.lower, self.upper)
        out = dict(sample)
        img = sample["image"]
        if img.dtype == np.uint8:
            # LUT == clip(v * f).astype(uint8) for every uint8 v.
            lut = np.clip(
                np.arange(256, dtype=np.float32) * f, 0, 255
            ).astype(np.uint8)
            out["image"] = lut[img]
        else:
            out["image"] = np.clip(
                img.astype(np.float32) * f, 0, 255).astype(np.uint8)
        return out


class RandomSaturation:
    """Scale HSV saturation (cv2_aug_transforms.py:227-250)."""

    def __init__(self, lower=0.5, upper=1.5, ratio=0.5):
        self.lower, self.upper, self.ratio = lower, upper, ratio

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        f = rng.uniform(self.lower, self.upper)
        img = sample["image"].astype(np.float32) / 255.0
        mx = img.max(axis=-1, keepdims=True)
        out_img = np.clip(mx - (mx - img) * f, 0, 1)
        out = dict(sample)
        out["image"] = np.clip(np.around(out_img * 255), 0, 255).astype(np.uint8)
        return out


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Vectorized RGB [0,1] -> HSV with hue in degrees [0, 360)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    c = mx - mn
    with np.errstate(divide="ignore", invalid="ignore"):
        hue = np.where(
            c == 0, 0.0,
            np.where(mx == r, ((g - b) / c) % 6,
                     np.where(mx == g, (b - r) / c + 2, (r - g) / c + 4)),
        ) * 60.0
        sat = np.where(mx == 0, 0.0, c / mx)
    return np.stack([hue, sat, mx], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    c = v * s
    x = c * (1 - np.abs(h % 2 - 1))
    m = v - c
    z = np.zeros_like(c)
    i = (np.floor(h).astype(int) % 6)[..., None]
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([c, x, z], -1), np.stack([x, c, z], -1),
         np.stack([z, c, x], -1), np.stack([z, x, c], -1),
         np.stack([x, z, c], -1), np.stack([c, z, x], -1)],
    )
    return rgb + m[..., None]


class RandomHue:
    """Rotate HSV hue by a uniform delta in degrees
    (cv2_aug_transforms.py:236-258; numpy HSV instead of cv2)."""

    def __init__(self, delta=18, ratio=0.5):
        assert 0 <= delta <= 360
        self.delta = delta
        self.ratio = ratio

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        hsv = _rgb_to_hsv(sample["image"].astype(np.float32) / 255.0)
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.delta, self.delta)) % 360
        out = dict(sample)
        out["image"] = np.clip(
            np.around(_hsv_to_rgb(hsv) * 255.0), 0, 255
        ).astype(np.uint8)
        return out


class Padding:
    """Pad (left, up, right, down) with image mean / label ignore
    (cv2_aug_transforms.py:60-140).  Divergence: labels pad with -1 (our
    native ignore id) instead of 255-then-ReLabel."""

    def __init__(self, pad=(0, 0, 0, 0), ratio=0.5, mean=(104, 117, 123)):
        self.pad = pad
        self.ratio = ratio
        self.mean = np.asarray(mean, np.float32)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        left, up, right, down = self.pad
        out = dict(sample)
        img = sample["image"]
        padded = np.empty(
            (img.shape[0] + up + down, img.shape[1] + left + right, 3),
            img.dtype)
        padded[:] = self.mean.astype(img.dtype)
        padded[up:up + img.shape[0], left:left + img.shape[1]] = img
        out["image"] = padded
        for k in NEAREST_KEYS:
            if k in sample:
                fill = -1 if k == "label" else 0
                out[k] = np.pad(
                    sample[k], [(up, down), (left, right)]
                    + [(0, 0)] * (sample[k].ndim - 2),
                    constant_values=fill)
        return out


class RandomPerm:
    """Random channel permutation (cv2_aug_transforms.py RandomPerm)."""

    def __init__(self, ratio=0.5):
        self.ratio = ratio

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        out = dict(sample)
        out["image"] = sample["image"][..., rng.permutation(3)]
        return out


class RandomRotate:
    """Rotate by uniform angle; label filled with border value
    (cv2_aug_transforms.py RandomRotate)."""

    def __init__(self, max_degree=10, ratio=0.5, mean=(104, 117, 123),
                 label_fill=255):
        self.max_degree = max_degree
        self.ratio = ratio
        self.mean = tuple(int(m) for m in mean)
        self.label_fill = label_fill

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if rng.random() > self.ratio:
            return sample
        deg = float(rng.uniform(-self.max_degree, self.max_degree))
        from PIL import Image

        out = dict(sample)
        img = Image.fromarray(sample["image"].astype(np.uint8))
        out["image"] = np.asarray(
            img.rotate(deg, resample=Image.BICUBIC, fillcolor=self.mean)
        )
        if "label" in sample:
            lab = Image.fromarray(sample["label"].astype(np.int32), mode="I")
            out["label"] = np.asarray(
                lab.rotate(deg, resample=Image.NEAREST,
                           fillcolor=self.label_fill)
            ).astype(sample["label"].dtype)
        return out


class Resize:
    """Deterministic resize to target (w, h) (cv2_aug_transforms.py:605-651)."""

    def __init__(self, target_size=None, min_side_length=None,
                 max_side_length=None, max_side_bound=None):
        self.target_size = target_size
        self.min_side_length = min_side_length
        self.max_side_length = max_side_length
        self.max_side_bound = max_side_bound

    def __call__(self, sample: dict, rng: np.random.Generator = None) -> dict:
        h, w = sample["image"].shape[:2]
        if self.target_size is not None:
            tw, th = self.target_size
            w_ratio, h_ratio = tw / w, th / h
        elif self.min_side_length is not None:
            s = self.min_side_length / min(w, h)
            w_ratio = h_ratio = s
        elif self.max_side_length is not None:
            s = self.max_side_length / max(w, h)
            w_ratio = h_ratio = s
        else:
            return sample
        if self.max_side_bound is not None and max(
            h * h_ratio, w * w_ratio
        ) > self.max_side_bound:
            d = self.max_side_bound / max(h * h_ratio, w * w_ratio)
            w_ratio *= d
            h_ratio *= d
        size = (int(w * w_ratio), int(h * h_ratio))
        out = dict(sample)
        out["image"] = _pil_resize_img(sample["image"], size)
        for k in NEAREST_KEYS:
            if k in sample:
                out[k] = _nearest_resize(sample[k], size)
        return out


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class ShuffledCompose:
    """`shuffle_trans_seq` semantics (cv2_aug_transforms.py:725-731):
    per sample, apply the shuffle group in random order (or pick one of a
    list of groups) BEFORE the fixed sequence."""

    def __init__(self, shuffle_groups, fixed: Sequence[Callable]):
        # shuffle_groups: list[Callable] (shuffled) or list[list[Callable]]
        # (one group sampled per call, applied in order).
        self.shuffle_groups = shuffle_groups
        self.fixed = list(fixed)
        self.nested = bool(shuffle_groups) and isinstance(
            shuffle_groups[0], (list, tuple))

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        if self.nested:
            group = self.shuffle_groups[rng.integers(0, len(self.shuffle_groups))]
        else:
            group = [self.shuffle_groups[i]
                     for i in rng.permutation(len(self.shuffle_groups))]
        for t in list(group) + self.fixed:
            sample = t(sample, rng)
        return sample


class Normalizer:
    """ToTensor + Normalize (lib/datasets/tools/transforms.py:15-110):
    div 255, subtract ImageNet mean, divide std.  Stays NHWC uint8->f32."""

    def __init__(self, div_value=255.0, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225)):
        self.div_value = div_value
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == len(
                self.mean):
            out = native.normalize_f32(img, self.div_value, self.mean,
                                       self.std)
            if out is not None:
                return out
        x = img.astype(np.float32) / self.div_value
        return (x - self.mean) / self.std

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return np.clip((x * self.std + self.mean) * self.div_value, 0, 255)


_TRANSFORM_BUILDERS = {
    "random_resize": lambda p: RandomResize(
        scale_range=p.get("scale_range", (0.75, 1.25)),
        aspect_range=p.get("aspect_range", (0.9, 1.1)),
        ratio=p.get("ratio", 1.0),
        scale_list=p.get("scale_list"),
        max_side_bound=p.get("max_side_bound"),
    ),
    "random_crop": lambda p: RandomCrop(
        crop_size=p.get("crop_size", (1024, 512)),
        ratio=p.get("ratio", 1.0),
        method=p.get("method", "random"),
        grid=p.get("grid"),
    ),
    "random_hflip": lambda p: RandomHFlip(
        ratio=p.get("ratio", 0.5), swap_pair=p.get("swap_pair", ())
    ),
    "random_brightness": lambda p: RandomBrightness(
        shift_value=p.get("shift_value", 30), ratio=p.get("ratio", 0.5)
    ),
    "random_contrast": lambda p: RandomContrast(
        lower=p.get("lower", 0.5), upper=p.get("upper", 1.5),
        ratio=p.get("ratio", 0.5),
    ),
    "random_saturation": lambda p: RandomSaturation(
        lower=p.get("lower", 0.5), upper=p.get("upper", 1.5),
        ratio=p.get("ratio", 0.5),
    ),
    "random_perm": lambda p: RandomPerm(ratio=p.get("ratio", 0.5)),
    "random_hue": lambda p: RandomHue(
        delta=p.get("delta", 18), ratio=p.get("ratio", 0.5)
    ),
    "padding": lambda p: Padding(
        pad=p.get("pad", (0, 0, 0, 0)), ratio=p.get("ratio", 0.5),
        mean=p.get("mean", (104, 117, 123)),
    ),
    "random_rotate": lambda p: RandomRotate(
        max_degree=p.get("rotate_degree", 10), ratio=p.get("ratio", 0.5)
    ),
    "resize": lambda p: Resize(
        target_size=p.get("target_size"),
        min_side_length=p.get("min_side_length"),
        max_side_length=p.get("max_side_length"),
        max_side_bound=p.get("max_side_bound"),
    ),
}


def _fuse_resize_crop(transforms: list) -> list:
    """Replace adjacent RandomResize -> RandomCrop with the lazily
    evaluated FusedResizeCrop (bit-identical output and rng state)."""
    out, i = [], 0
    while i < len(transforms):
        t = transforms[i]
        if (isinstance(t, RandomResize) and i + 1 < len(transforms)
                and isinstance(transforms[i + 1], RandomCrop)):
            out.append(FusedResizeCrop(t, transforms[i + 1]))
            i += 2
        else:
            out.append(t)
            i += 1
    return out


def build_train_transforms(cfg, section: str = "train_trans") -> Compose:
    """CV2AugCompose equivalent: builds from `trans_seq` config, honoring
    `shuffle_trans_seq` (cv2_aug_transforms.py:654-903)."""

    def build_one(name: str):
        params = cfg.get(f"{section}.{name}", default={})
        if name not in _TRANSFORM_BUILDERS:
            raise KeyError(f"unknown transform {name!r}")
        return _TRANSFORM_BUILDERS[name](params)

    fixed = [build_one(n) for n in cfg.get(f"{section}.trans_seq", default=[])]
    shuffle = cfg.get(f"{section}.shuffle_trans_seq", default=None)
    if cfg.get("data.fuse_resize_crop", default=True):
        fixed = _fuse_resize_crop(fixed)
    if not shuffle:
        return Compose(fixed)
    if shuffle and isinstance(shuffle[0], (list, tuple)):
        groups = [[build_one(n) for n in grp] for grp in shuffle]
    else:
        groups = [build_one(n) for n in shuffle]
    return ShuffledCompose(groups, fixed)
