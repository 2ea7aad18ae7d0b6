"""Offline inference and the submission writer.

Counterpart of ``Tester`` in ``contrastiveseg_tpu/engine/tester.py``
(reference segmentor/tester.py): the modes ``ss_test`` (single scale),
``ms_test`` (multi-scale plus horizontal flip, with ``test.scale_weights``),
``sscrop_test`` and ``mscrop_test`` (sliding-window crops; the grid is
stride = crop with a last window flush with the edge) and ``ms_test_depth``
(per-pixel scale weights from a 16-bit stereo disparity PNG); ``test``
writes the label PNGs of a submission (raw ids), their palette colours,
optionally the colourised ground truth and the softmax ``_prob.npy``.

The model is the port's ``nn.Module`` in eval mode under ``torch.no_grad``;
images are NHWC at this interface, as in the JAX package and the port's
``Evaluator``.  Scale resizes and logit fusion run on the model's device,
through ``ops/resize.resize_bilinear_align_corners``, and every mode returns
logits at the input's resolution.  PNGs go through ``utils/png.py``, never
PIL.

Not ported: ``crf_ss_test`` (needs ``ops/crf.py``, ROADMAP 8) and the SegFix
``test_offset`` (needs the SegFix nets, ROADMAP 7); both are refused.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners
from contrastiveseg_tpu_torch.utils.palette import colorize, get_palette
from contrastiveseg_tpu_torch.utils.png import read_png, write_png

log = logging.getLogger(__name__)

MODES = ("ss_test", "ms_test", "sscrop_test", "mscrop_test", "ms_test_depth")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for the test paths the port does not have."""
    if cfg.get("network.model_name", default="").startswith("segfix"):
        raise NotImplementedError(
            "the SegFix test_offset phase is not ported yet: ROADMAP 7 (the SegFix nets)")
    mode = cfg.get("test.mode", default="ss_test")
    if mode == "crf_ss_test":
        raise NotImplementedError(
            "test.mode=crf_ss_test is not ported yet: ROADMAP 8 (ops/crf.py)")
    if mode not in MODES:
        raise NotImplementedError(f"test mode {mode!r}")


def _decide_intersection(total: int, crop: int) -> list[int]:
    stride = crop
    starts = [stride * i for i in range((total - crop) // stride + 1)] or [0]
    if total - starts[-1] > crop:
        starts.append(total - crop)
    return starts


def _pil_nearest(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(a).resize((w, h), Image.NEAREST)`` of a 2-D float
    array without PIL: Pillow's scale-only affine samples source index
    ``int(x0)``, where ``x0`` starts at half a step and adds one step (in/out,
    in double precision) a pixel; mode F keeps float32."""

    def index(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        pos = np.cumsum(np.r_[0.5 * step, np.full(n_out - 1, step)])
        return np.minimum(pos.astype(np.int64), n_in - 1)

    h, w = size
    return a.astype(np.float32)[index(a.shape[0], h)][:, index(a.shape[1], w)]


class Tester:
    def __init__(self, cfg, model: nn.Module, device: torch.device | str | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.num_classes = cfg.get("data.num_classes")
        self.timing: dict = {}

    @torch.no_grad()
    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        was_training = self.model.training
        self.model.eval()
        try:
            out = self.model(images)
        finally:
            self.model.train(was_training)
        return out["seg"] if isinstance(out, dict) else out

    # -- inference modes (logits at input resolution) ---------------------
    def ss_test(self, images: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        """tester.py:310-327: scale -> forward -> upsample back."""
        n, h, w, _ = images.shape
        if scale != 1.0:
            images = resize_bilinear_align_corners(images, (int(h * scale), int(w * scale)))
        seg = self._forward(images)
        return resize_bilinear_align_corners(seg, (h, w))

    def ms_test(self, images: torch.Tensor) -> torch.Tensor:
        """tester.py:380-398: sum over scales of logits + flipped logits."""
        scales = self.cfg.get("test.scale_search", default=[0.75, 1.0, 1.25])
        weights = self.cfg.get("test.scale_weights", default=None)
        total = torch.zeros((*images.shape[:3], self.num_classes), dtype=torch.float32,
                            device=images.device)
        flipped = images.flip(2)
        for i, s in enumerate(scales):
            probs = self.ss_test(images, s)
            flip_probs = self.ss_test(flipped, s).flip(2)
            contrib = probs + flip_probs
            total = total + (weights[i] * contrib if weights else contrib)
        return total

    def sscrop_test(self, images: torch.Tensor, crop_size: tuple[int, int],
                    scale: float = 1.0) -> torch.Tensor:
        """tester.py:351-378: sliding-window accumulate logits / counts.
        crop_size is (h, w)."""
        n, ori_h, ori_w, _ = images.shape
        scaled = (resize_bilinear_align_corners(
            images, (int(ori_h * scale), int(ori_w * scale))) if scale != 1.0 else images)
        h, w = scaled.shape[1], scaled.shape[2]
        ch, cw = min(crop_size[0], h), min(crop_size[1], w)
        full = torch.zeros((n, h, w, self.num_classes), dtype=torch.float32,
                           device=images.device)
        count = torch.zeros((n, h, w, 1), dtype=torch.float32, device=images.device)
        for y0 in _decide_intersection(h, ch):
            for x0 in _decide_intersection(w, cw):
                pred = self.ss_test(scaled[:, y0:y0 + ch, x0:x0 + cw, :])
                full[:, y0:y0 + ch, x0:x0 + cw, :] += pred
                count[:, y0:y0 + ch, x0:x0 + cw, :] += 1.0
        return resize_bilinear_align_corners(full / count, (ori_h, ori_w))

    def mscrop_test(self, images: torch.Tensor,
                    crop_size: tuple[int, int]) -> torch.Tensor:
        scales = self.cfg.get("test.scale_search", default=[0.75, 1.0, 1.25])
        total = torch.zeros((*images.shape[:3], self.num_classes), dtype=torch.float32,
                            device=images.device)
        flipped = images.flip(2)
        for s in scales:
            total = total + self.sscrop_test(images, crop_size, s)
            total = total + self.sscrop_test(flipped, crop_size, s).flip(2)
        return total

    def ms_test_depth(self, images: torch.Tensor,
                      metas: Optional[list] = None) -> torch.Tensor:
        """tester.py:425-475: depth-weighted multi-scale fusion.

        Per-scale fused (orig+flip) probs are weighted per pixel by
        POWER_BASE ** |depth_bin - scale_index| where depth bins come from
        a stereo disparity PNG (`test.stereo_path/<name>.png`, 16-bit,
        depth = 500 * 0.5/(raw/256), clipped to MAX_DEPTH=63).  Images with
        no depth map fall back to uniform weights (= ms_test).  The fusion
        runs on the host, as in the JAX package; the result is a CPU tensor.
        """
        MAX_DEPTH, POWER_BASE = 63, 0.8
        scales = self.cfg.get("test.scale_search", default=[0.75, 1.0, 1.25])
        stereo_path = self.cfg.get("test.stereo_path", default=None)
        n, h, w, _ = images.shape
        flipped = images.flip(2)
        prob_list = [
            (self.ss_test(images, s) + self.ss_test(flipped, s).flip(2)).cpu().numpy()
            for s in scales
        ]

        full = np.zeros((n, h, w, self.num_classes), np.float32)
        for i in range(n):
            depth_bins = None
            name = (metas[i] or {}).get("name") if metas else None
            if stereo_path and name:
                p = os.path.join(stereo_path, f"{name}.png")
                if os.path.exists(p):
                    raw = read_png(p).astype(np.float64)
                    depth = 500.0 * (0.5 / np.maximum(raw / 256.0, 1e-6))
                    depth = np.clip(depth, 0, MAX_DEPTH)
                    depth_bins = depth // (MAX_DEPTH // len(scales))
                    if depth_bins.shape != (h, w):
                        depth_bins = _pil_nearest(depth_bins, (h, w))
            for si, prob in enumerate(prob_list):
                if depth_bins is None:
                    weight = 1.0
                else:
                    weight = (POWER_BASE ** np.abs(depth_bins - si)).astype(
                        np.float32)[..., None]
                full[i] += weight * prob[i]
        return torch.from_numpy(full)

    def infer(self, images: torch.Tensor, metas: Optional[list] = None) -> torch.Tensor:
        mode = self.cfg.get("test.mode", default="ss_test")
        if mode == "ss_test":
            return self.ss_test(images)
        if mode == "ms_test":
            return self.ms_test(images)
        if mode == "ms_test_depth":
            return self.ms_test_depth(images, metas)
        if mode in ("sscrop_test", "mscrop_test"):
            cw, ch = self.cfg.get("test.crop_size", default=[1024, 512])
            fn = self.sscrop_test if mode == "sscrop_test" else self.mscrop_test
            return fn(images, (ch, cw))
        raise NotImplementedError(f"test mode {mode!r}")

    # -- output writing ----------------------------------------------------
    def _to_raw_ids(self, pred: np.ndarray) -> np.ndarray:
        """Train ids -> submission ids (tester.py:176-207 inverse relabel)."""
        if self.cfg.get("data.reduce_zero_label", default=False):
            pred = pred + 1
        label_list = self.cfg.get("data.label_list", default=None)
        if label_list:
            out = pred.copy()
            for train_id, raw_id in enumerate(label_list):
                out[pred == train_id] = raw_id
            pred = out
        return pred

    def test(self, batches: Optional[Iterable[dict]] = None,
             out_dir: Optional[str] = None, save_prob: bool = False) -> int:
        """Write ``label/``, ``vis/`` (and ``gt_vis/``, ``<name>_prob.npy``)
        for every image of ``batches`` (default: the ``test`` split's
        pipeline); returns the number of images.  ``self.timing`` keeps the
        call's wall seconds and the part spent in ``infer`` and the copy of
        its logits to the host."""
        from contrastiveseg_tpu_torch.data.pipeline import build_pipeline

        out_dir = out_dir or self.cfg.get("test.out_dir", default="./out")
        label_dir = os.path.join(out_dir, "label")
        vis_dir = os.path.join(out_dir, "vis")
        os.makedirs(label_dir, exist_ok=True)
        os.makedirs(vis_dir, exist_ok=True)
        palette = get_palette(self.cfg.get("dataset", default=""), self.num_classes)
        if batches is None:
            batches = build_pipeline(self.cfg, "test").epoch_iter(0)

        n = 0
        t_infer = 0.0
        t0 = time.perf_counter()
        for batch in batches:
            ti = time.perf_counter()
            images = torch.as_tensor(batch["image"]).to(self.device)
            logits = self.infer(images, batch.get("meta")).float().cpu().numpy()
            t_infer += time.perf_counter() - ti
            for i, meta in enumerate(batch["meta"]):
                ow, oh = meta["ori_size"]
                img_logits = logits[i]
                if img_logits.shape[:2] != (oh, ow):
                    img_logits = resize_bilinear_align_corners(
                        torch.from_numpy(img_logits[None]), (oh, ow))[0].numpy()
                pred = np.argmax(img_logits, axis=-1).astype(np.int32)
                name = meta.get("name", f"img_{n:06d}")
                write_png(os.path.join(label_dir, f"{name}.png"),
                          self._to_raw_ids(pred).astype(np.uint8))
                write_png(os.path.join(vis_dir, f"{name}.png"), colorize(pred, palette))
                # save_gt_label (reference tester.py:209-217): also colorize
                # the ground truth into gt_vis/ when labels ride along.
                if self.cfg.get("test.save_gt_label", default=False) and "label" in batch:
                    gt = np.asarray(batch["label"][i]).astype(np.int32)
                    gt_dir = os.path.join(out_dir, "gt_vis")
                    os.makedirs(gt_dir, exist_ok=True)
                    write_png(os.path.join(gt_dir, f"{name}.png"),
                              colorize(np.maximum(gt, 0), palette))
                if save_prob:
                    np.save(os.path.join(out_dir, f"{name}_prob.npy"),
                            torch.softmax(torch.from_numpy(img_logits), dim=-1).numpy())
                n += 1
        self.timing = {"images": n, "seconds": time.perf_counter() - t0,
                       "infer_seconds": t_infer}
        log.info("wrote %d predictions to %s", n, out_dir)
        return n
