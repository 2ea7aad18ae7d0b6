#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero):
  1. device: require CUDA; print the card's name and power limit; turn TF32
     off for matmuls and cuDNN;
  2. build K1 (csrc/contrast_infonce.cu), K2 (csrc/conv3x3.cu) and K3
     (csrc/fused_block.cu) from the checkout, one nvcc each, all at once;
  3. K1 against its plain version at M=1024 anchors, D=256, K=190,000 bank
     rows (tau 0.07), at a ragged K=190,037, at the recipe's M=152 (batch 8)
     and at the main path's M=38 (batch 2); the loss through K1 against the
     plain loss, value and gradient; times at M=38, 152 and 1024, each
     kernel's share of its bound;
  4. K2 (forward, dX, dW) against its plain version at the main path's
     branch-0 shape [2, 48, 128, 256] and at a ragged width of 40; at the
     recipe's batch 8, [8, 48, 128, 256], the forward and dW against fp64 and
     timed beside cuDNN's ``conv2d`` and ``conv2d_weight``; K3 against its
     plain version at [8, 48, 128, 256] in fp32 and bf16 (the bench shape);
  5. the flag-off slice: 3 train steps of ``cityscapes_hrnet_w48_mem`` at full
     HRNet-W48 width, 19 classes, the full 190k-row bank, batch 2 of 512x1024
     synthetic scenes, contrast live from step 0, through the same code as
     ``tools/train_torch.py``; finite losses, a positive contrast term,
     >= 3 launches of each K1 kernel, advanced bank pointers, changed
     parameters; then the trained model's contrast loss and gradient through
     K1 against the plain version;
  6. the same slice with ``network.pallas_conv=true``: 3 steps, validation
     after step 3 and checkpoints; K2a >= 2*64*3 and K2b >= 64*3 launches;
     the checkpoint restored into a new trainer equals the trained state;
  7. flag on equals flag off: step 1 of both from the same seed, batch and
     anchor scores; losses within rtol 1e-4, each branch-0 conv weight
     gradient within 2e-2 in relative norm (``GRAD_REL_NORM``);
  8. K3's path, ``tools/bench_block_torch.py``, in bf16 and fp32;
  9. the directory slice: a Cityscapes-layout tree written under
     ``build/chip_smoke_data/`` (8 train and 4 val frames of 1024x2048, raw
     Cityscapes ids, each PNG beside its ``.npy_cache`` sidecar, so that no
     PNG is decoded and PIL is not needed; the val labels also as
     ``gtFine/val/<city>/*_gtFine_labelIds.png``), then 3 steps of the
     headline at the recipe's batch 8 from it through the data pipeline (the preset's
     transforms, ``data.workers`` and pinned prefetch), validation over the
     4 val frames at 2048x1024; >= 3 launches of each K1 kernel, the first
     device batch bit-identical to the pipeline's host batch, segdata loaded
     from ``build/segdata/`` with no fallback; each step's time and data
     wait, the pipeline's host seconds a batch alone at 1 and 4 workers,
     val images/s and the peak memory;
 10. the plain phase: ``cityscapes_hrnet_w48`` (no projection head, CE on
     logits upsampled inside the model) for 3 steps at batch 8 from the same
     tree; validation over the 4 val frames at 2048x1024 with
     ``val.batch_size=2`` (the preset's 4 meets cuDNN's slow FFT choice);
     ``latest`` saved and resumed into a new trainer, step, weights, BN
     statistics and momentum bit for bit; 0 K1 launches;
 11. the contrast phase: ``cityscapes_hrnet_w48_contrast`` (the anchors'
     InfoNCE against each other, no bank) for 3 steps at batch 8 from the
     tree, ``contrast.warmup_iters=0``; each step's anchor count M and a
     positive contrast term; 0 K1 launches;
 12. the pretrained phase: an ImageNet-layout and an HRNet_W48_MEM-layout
     ``.pth`` written under ``build/`` from a freshly initialised port W48
     (the latter with 19 x 5000 x 256 queues); the headline started from
     each and the plain preset from the ImageNet one through
     ``network.pretrained``, every loaded tensor equal to the file's on the
     device and the bank equal to the queues; 2 steps at batch 2 from the
     MEM file with >= 1 launch of each K1 kernel;
 13. the test phase: the directory slice's W48 (its ``latest`` checkpoint)
     restored through ``network.resume`` by ``tools/train_torch.run``:
     ``--phase val`` and ``--phase test`` in ``ss_test``, ``ms_test``,
     ``sscrop_test`` and ``mscrop_test`` (crop 1024x512) over the 4 val
     frames (``test.test_dir``) at batch 1 (``TEST_BATCH``), each mode's
     seconds an image, peak memory and PNGs written; the official
     Cityscapes evaluator on the ``ss_test`` label PNGs (read back through
     ``utils/png.py``) gives ``validate()``'s 19x19 confusion and its mIoU
     to 1e-6; ``ss_test`` with ``network.pallas_conv=true`` launches K2a
     and its logits are within 1e-3 (relative L2) of flag off; one timed
     ``ss_test`` call per scale and batch below cuDNN's FFT picks (batches
     1-2 at scales 1.0 and 0.75, batch 1 at 1.25); the model
     exported (``tools/export_torch.py``, ``--scope ss``, batch 1,
     1024x2048) and served (``tools/serve_torch.py``) on 127.0.0.1 answers
     4 ``/segment`` requests with the ``ss_test`` labels on >= 99.99% of
     the pixels; no PNG goes through PIL;
 14. the models phase: the paper's DeepLab-V3 and HRNet-W48 + OCR rows,
     ``cityscapes_deeplab_v3``, ``cityscapes_deeplab_v3_contrast``,
     ``cityscapes_hrnet_w48_ocr`` and ``cityscapes_hrnet_w48_ocr_contrast``,
     each at full width (ResNet-101 with its 2048-channel layer4, HRNet-W48,
     19 classes) for 2 steps at the preset's batch 8 from the same tree
     (contrast live from step 0): step times, data wait, peak memory, the
     losses, the anchor count M of the contrast presets, and 0 launches of
     K1, K2 and K3; each trained model's eval forward on a 1x128x256 input
     within 1e-4 (relative L2) of the same weights on the CPU; the two
     contrast trainers' ``latest`` restored bit for
     bit, then ``--phase val`` and ``ss_test`` at batch 1 from it over the 4
     val frames; a deep-base ResNet-101 ImageNet ``.pth`` in the reference's
     layout (``resinit.*``, ``layer*``, ``fc.*``) written from a seeded model
     and loaded through ``network.pretrained`` bit for bit, then one step;
 15. the context phase: the dilated-ResNet-101 context-head nets, the
     Cityscapes presets ``cityscapes_{fcnet,fcnet_wo_dsn,spatial_ocrnet,
     spatial_asp_ocrnet,base_ocnet,asp_ocnet,isanet,pyramid_ocnet}``,
     ``pspnet`` and ``ccnet`` (no preset: ``cityscapes_fcnet``'s recipe with
     ``network.model_name`` overridden), from a Cityscapes-layout tree of 16
     + 4 frames of 1024x2048, and ``pascal_context_hrnet_w48_isa`` from a
     Pascal-Context-layout tree (``write_pascal_context``: 500x375 and
     375x500 frames, 59 classes, ``reduce_zero_label``), each at full width
     for 2 steps at the preset's batch 16, or at 8 with the batch-16
     allocator failure printed where 16 does not fit: step times, data wait,
     peak memory, each head's CE (finite, positive), 0 launches of K1-K3,
     the eval forward within 1e-4 of the CPU's; ``spatial_ocrnet`` and
     ``base_ocnet`` round-trip ``latest`` into ``--phase val`` and
     ``ss_test`` at batch 1 on the 1024x2048 frames; the ISA net's
     ``--phase val`` in ``diverse_size``; each of the six reference layouts
     from a reference segmentor ``.pth`` (a bias on every conv that feeds a
     BN, folded on load; ``fcnet_wo_dsn`` in fcnet's) bit for bit through
     ``network.pretrained``, then one step at batch 2; for the four nets
     without a reference layout, a
     segmentor ``.pth`` refused with its reason and an ImageNet backbone
     ``.pth`` loaded bit for bit; its lines carry ``[context phase +N s]``;
 16. the raw phase, from trees of raw PNGs (no ``.npy_cache`` sidecars, the
     rows of every PNG cycling through the five filters) under
     ``build/chip_smoke_raw/``: the headline from a Cityscapes tree of 8 + 4
     frames of 1024x2048 at batch 8 (2 steps, >= 2 launches of each K1
     kernel) and its validation (``val.batch_size=2``), with PIL made
     unimportable and 0 fallbacks of the native PNG unfilter
     (``csrc/png_unfilter.cpp``, built with ``g++`` into
     ``build/pngunfilter/``); the native decode ms of each frame, the
     pipeline's seconds a batch at 1 and 4 workers, the data wait of steps
     after the first; ``tools/cache_dataset_torch.py`` on the tree, every sidecar equal
     to its decoded frame; then, each at full width for 2 steps at its
     preset's batch (or the largest that fits, after the allocator's
     message), from raw trees of its layout and classes: the oracle OCR
     nets ``cityscapes_ideal_{spatial,gather,distribute}_ocrnet`` (batch
     16), with ``_spatial_ocrnet_b`` and ``_c`` built and raising their
     ``ValueError`` at the first forward (of a batch of 2), as the JAX
     trainer fails at their init; ``pascal_context_hrnet_w48_ocr_rmi`` and
     ``coco_stuff_hrnet_w48_ocr_rmi`` (``fs_aux_rmi_loss``, batch 16 of
     520x520, 59 and 171 classes); the six LIP presets (batch 32 of
     473x473, 20 classes; two on CE2P), ``lip_hrnet_w48_ocr`` also through
     ``--phase val`` with the flip average and the L/R swap; step times,
     data wait, peak memory, finite losses, 0 launches of K1-K3 by the new
     nets; its lines carry ``[raw phase +N s]``;
 17. the SegFix phase, from a Cityscapes tree of 16 + 4 frames of
     1024x2048 under ``build/chip_smoke_segfix/`` whose 16-bit
     ``instance/`` maps have touching instances of one class: the host
     seconds of ``compute_dt_targets`` a frame; for ``cityscapes_segfix_hrnet``
     (HRNet-W48) and ``cityscapes_segfix_hrnet2x`` (HRNet-2x20) each, a
     seeded random-init net written as a reference SegFix ``.pth`` and
     loaded strictly (bit for bit) through ``network.pretrained``, then
     ``--phase val`` at batch 2 (``SEGFIX_VAL_BATCH``; the presets' 4 meets
     cuDNN's FFT pick, 18-25 s a batch) over the 4 val frames (the
     dt-offset loader, the SegFix evaluator: ``mask_acc``, ``dir_acc_mask``,
     ``dir_acc_gt``, seconds a val batch, the model's share of it, peak
     memory) and ``--phase test`` (``test_offset``, batch ``TEST_BATCH``:
     4 offset ``.npz`` files, seconds an image); ``--phase val`` of
     ``cityscapes_segfix_hrnet2x_inst`` from the instance maps;
     ``tools/segfix_torch.py`` refining the val label PNGs with W48's
     offsets on the card and on the CPU, in both ``--interp`` modes, the
     card's PNGs byte-identical to the CPU's and some pixels moved; one
     forward and backward of each net with ``SegFixLoss`` (dict targets)
     at the preset's batch 16 of 512x512, time and memory; ``--phase
     train`` of ``cityscapes_segfix_hrnet`` raising the port's
     ``ValueError`` at its first step (the trainer hands the loss the
     label map alone, as the JAX trainer does); ``cityscapes_resnest_fcn``
     (ResNeSt-101) for 2 steps at batch 16 (or 8 where 16 does not fit)
     and one validation batch; 0 launches of K1-K3; its lines carry
     ``[segfix phase +N s]``;
 18. the JPEG phase, with PIL unimportable: every JPEG fixture of
     ``tests/data_torch_jpeg/`` (ADE20K's 683x512 and 512x683, COCO's
     640x480 and a 480x640 grey frame, VOC's 500x375 and a progressive
     375x500, a 4:4:4 frame with restart markers, a 4:2:2 one with
     optimised tables) decoded by the native decoder
     (``csrc/jpeg_decode.cpp``, built with ``g++`` into
     ``build/jpegdecode/``, 0 fallbacks) equal to the SHA-256 of PIL's
     arrays in the manifest, both readings, with its decode ms; raw trees
     under ``build/chip_smoke_jpeg/`` of 16 + 4 frames each: ADE20K,
     COCO-Stuff and Pascal-Context of those JPEGs with PNG labels (0-150,
     0-171, 0-59, ``reduce_zero_label``) and CamVid of 960x720 PNGs (labels
     0-11); then ``ade20k_hrnet_w48_contrast``, ``ade20k_hrnet_w48``,
     ``coco_stuff_hrnet_w48_contrast``, ``coco_stuff_hrnet_w48``,
     ``pascal_context_hrnet_w48_contrast``, ``pascal_context_hrnet_w48`` and
     ``camvid_hrnet_w48_contrast`` at full width (HRNet-W48) and the
     preset's batch 16 (8 where 16 does not fit, after the allocator's
     message), crop, classes and transforms: 3 steps for a contrast preset
     (``contrast.warmup_iters=0``; a positive contrast term and each step's
     anchor count M), 2 for a plain one; finite losses, step times, data
     wait, peak memory, 0 launches of K1-K3; ``--phase val`` of the ADE20K
     and Pascal-Context contrast presets in ``diverse_size`` over the 4 JPEG
     val frames (images/s, a finite mIoU); the pipeline's host seconds for
     an ADE20K batch of 16 at 1 and 4 workers; its lines carry ``[jpeg
     phase +N s]``;
 19. the transformer phase, each net at full width trained 2 steps, with
     finite losses, most parameters changed and 0 launches of K1-K3, one
     net of each family (``ms_ocr``, ``setr_pup``, ``semantic_fpn`` on
     PVT-Small) from a reference ``.pth`` of a seeded net (a bias on every
     conv that feeds a BN, folded on load; every tensor bit for bit):
     ``ms_ocr`` (MscaleOCR on HRNet-W48, ``ms_fs_aux_rmi_loss``) through
     ``cityscapes_hrnet_w48_ocr``'s recipe at batch 8 of 1024x512 (4 where 8
     does not fit) from phase 9's Cityscapes tree, its stem BN run twice a
     step (the trunk at 0.5x and 1.0x) with its running statistics moved,
     ``pred_05x`` at half the batch's size, then ``--phase val`` at
     ``TEST_BATCH``; ``setr_pup``, ``setr_mla`` and ``setr_naive`` on ViT-L
     (24 layers, width 1024, 16 heads) through ``cityscapes_hrnet_w48``'s
     recipe at SETR's published 768x768 crop (``SETR_CROP``), batch 2 (1
     where 2 does not fit), then ``setr_pup``'s ``sscrop_test`` at 768x768
     on a 1024x2048 frame (the position table is the crop's grid);
     ``semantic_fpn`` on PVT-Small and on Twins-SVT-Small through
     ``ade20k_hrnet_w48``'s recipe with the PVT recipe's AdamW (lr 1e-4,
     weight decay 1e-4; SVT with ``network.clip_grad_norm=1.0``, the clipped
     global norm printed each step) at batch 16 of 520x520 (8 where 16 does
     not fit) from phase 18's ADE20K JPEG tree with PIL unimportable, then
     PVT-Small's ``--phase val`` in ``diverse_size`` (its position tables
     resized to each frame's grids); step times, data wait, peak memory and
     parameter counts; its lines carry ``[transformer phase +N s]``;
 20. a JSON line of the six kernels, the card line, and the result line.

Phases 10-19 print their step times (or seconds an image), peak memory and
wall time.  Phases 14-17 train each preset 2 steps (``CUT_STEPS``; 3 before
phase 18 was added), which makes room for phase 18 in the time limit; every check they
make stays (the raw headline's K1 launches are held to 2, one a step).  Phase
17 validates at batch 2, not 4, which makes room for phase 19.

The slices read their batches through the port's data pipeline
(``data/pipeline.py``): the synthetic ones get the preset's train
transforms (scale 0.5-2.0, crop 1024x512) and validate at
``val.data_transformer`` (2048x1024).  ``solver.display_iter=1`` gives each
step its own time.  Segdata (``native/segdata.cpp``) and the PNG unfilter
(``csrc/png_unfilter.cpp``) are built with ``g++`` beside the CUDA
libraries; a failed build fails the run.

Each path's launch counts are set to 0 just before it and read just after;
the kernel-vs-plain launches of phases 3-4 are not counted.  Kernel times
are CUDA-event medians of 5 runs of 10 back-to-back calls; ``bound_ms`` is
max(FLOPs / peak, bytes / 3.35 TB/s) from this run's shapes, with the H100
SXM peaks (``PEAK_FLOPS``).  An fp32 product's peak is that of its fastest
route at fp32 accuracy on the card: three TF32 tensor-core products per
product (3xTF32, 495 / 3 TFLOP/s), the route of K1 and K2b.  The fp32 rows
add ``bound_ms_fp32_simt``: the same at the 67 TFLOP/s of the SIMT cores,
the bound that PRs 1-2 reported.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
# Flag on against flag off, branch-0 conv weight gradients: each tensor's
# relative norm error.  An elementwise atol 1e-4 / rtol 1e-3 cannot hold:
# the two paths round dX and dW differently in their last bits, and the BN
# backward of a randomly initialised HRNet cancels about three digits of
# every weight gradient (tests/test_torch_port_slice.py); measured on the
# CPU at 64x128 the two paths differ by 2.3e-3 to 7.4e-3 in relative norm.
# A wrong dX or dW (unflipped, untransposed, missing) is off by order 1.
GRAD_REL_NORM = 2e-2
# 3xTF32 keeps ~2^-20 relative error per product, inside the rtol 1e-4 that
# every fp32 kernel here is held to (tests/test_torch_port_k1.py emulates it).
PEAK_FLOPS = {"fp32": 495e12 / 3, "fp32_simt": 67e12, "bf16": 989e12}
# Batch of the test phase's validation and tests.  cuDNN's heuristics pick FFT
# convolutions, ~20 s a forward, at the preset's batch 4 of 1024x2048 and at
# batch 2 of ms_test's 1280x2560 scale; at batch 1 at none of the three
# scales (PERF.md section 5; the phase's sweep reads the batches below those,
# and phase 17's validation of the SegFix W48 at batch 4 meets the first).
TEST_BATCH = 1
SLICE = ["data.synthetic=true", "data.synthetic_size=[512,1024]", "train.batch_size=2",
         "contrast.warmup_iters=0", "solver.max_iters=3", "solver.display_iter=1"]
ROOT = Path(__file__).resolve().parent
# Train steps of each preset in phases 14-17 (3 before phase 18 was added; 2
# make room for it inside the time limit).  Phase 18 takes 3 for a contrast preset
# and 2 for its plain twin.
CUT_STEPS = 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str = "fp32") -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def close(name: str, got, want, rtol: float, atol: float) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with the plain version "
            f"(max abs err {float(err.max()):.3e}, rtol {rtol}, atol {atol})")
    return float(err.max())


def k1_inputs(M: int, K: int, D: int, seed: int, device):
    """L2-normalised features; labels 0..18 with class 18 absent from the
    contrast set (so its one anchor row has no positive); ~10% invalid
    anchors; ~5% invalid contrast rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, D), dtype=np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    c = rng.standard_normal((K, D), dtype=np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    a_l = rng.integers(0, 18, size=M).astype(np.int32)
    a_l[M // 2] = 18
    a_v = rng.random(M) >= 0.1
    c_l = rng.integers(0, 18, size=K).astype(np.int32)
    c_v = rng.random(K) >= 0.05
    return [torch.from_numpy(x).to(device)
            for x in (a, a_l, a_v, c, c_l, c_v)]


def check_k1(device, tau: float = 0.07) -> dict:
    """Errors over four shapes; rows (times, the bound and the fp32-SIMT
    bound) at M=38 (the main path), M=152 (the recipe's batch 8) and M=1024."""
    import torch

    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
    from contrastiveseg_tpu_torch.ops.contrast_stream import (
        row_ok_and_count,
        streaming_contrastive_loss,
    )

    errs = {name: 0.0 for name in k1.KERNELS}
    rows = {}
    cases = [("headline", 1024, 190_000), ("ragged", 1024, 190_037),
             ("recipe_b8", 152, 190_000), ("main_path", 38, 190_000)]
    for case, M, K in cases:
        a, a_l, a_v, c, c_l, c_v = k1_inputs(M, K, 256, seed=M + K, device=device)
        plain1 = k1.stream_pass1(a, a_l, c, c_l, c_v, tau)
        got1 = k1.infonce_pass1(a, a_l, c, c_l, c_v, tau)
        torch.cuda.synchronize()
        e = [close(f"{case} pass1 {n}", g, w, 1e-4, 1e-5)
             for n, g, w in zip(("m", "ns", "p"), got1, plain1)]
        errs["infonce_pass1"] = max(errs["infonce_pass1"], *e)
        m, ns, p = plain1
        plain2 = k1.stream_pass2(a, a_l, c, c_l, c_v, m, ns, tau)
        got2 = k1.infonce_pass2(a, a_l, c, c_l, c_v, m, ns, tau)
        torch.cuda.synchronize()
        e = [close(f"{case} pass2 {n}", g, w, 1e-4, 1e-5)
             for n, g, w in zip(("s1", "t"), got2, plain2)]
        errs["infonce_pass2"] = max(errs["infonce_pass2"], *e)
        t = plain2[1]
        row_ok, R = row_ok_and_count(a_v, p)
        w = torch.where(row_ok, -1.0 / (R * p.clamp(min=1)), 0.0)
        plain_da = k1.stream_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, tau)
        got_da = k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, tau)
        torch.cuda.synchronize()
        errs["infonce_bwd"] = max(errs["infonce_bwd"], close(
            f"{case} bwd dA", got_da, plain_da, 1e-4, 1e-5))

        # The whole loss through K1 against the plain loss.
        xa = a.clone().requires_grad_(True)
        xb = a.clone().requires_grad_(True)
        lk = k1.cuda_contrastive_loss(xa, a_l, a_v, c, c_l, c_v, tau, tau)
        lp = streaming_contrastive_loss(xb, a_l, a_v, c, c_l, c_v, tau, tau)
        lk.backward()
        lp.backward()
        close(f"{case} loss", lk.detach(), lp.detach(), 1e-5, 0.0)
        close(f"{case} loss grad", xa.grad, xb.grad, 1e-4, 1e-5)
        print(f"K1 {case} M={M} K={K}: loss kernel {float(lk.detach()):.6f} "
              f"plain {float(lp.detach()):.6f}")

        if case == "ragged":
            continue
        flops = 2 * M * K * 256
        ins = nbytes(a, a_l, c, c_l, c_v)
        work = {"infonce_pass1": (flops, ins + 3 * 4 * M),
                "infonce_pass2": (flops, ins + 4 * 4 * M),
                "infonce_bwd": (2 * flops, ins + 4 * 4 * M + 4 * M * 256)}
        calls = {
            "infonce_pass1": (lambda: k1.infonce_pass1(a, a_l, c, c_l, c_v, tau),
                              lambda: k1.stream_pass1(a, a_l, c, c_l, c_v, tau)),
            "infonce_pass2": (lambda: k1.infonce_pass2(a, a_l, c, c_l, c_v, m, ns, tau),
                              lambda: k1.stream_pass2(a, a_l, c, c_l, c_v, m, ns, tau)),
            "infonce_bwd": (lambda: k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, tau),
                            lambda: k1.stream_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, tau)),
        }
        t_case = {}
        for name, (kernel, plain) in calls.items():
            f, b = work[name]
            t_case[name] = (time_ms(kernel), time_ms(plain), bound(f, b),
                            bound(f, b, "fp32_simt"))
            ms, plain_ms, (b_ms, by), (bs, bys) = t_case[name]
            print(f"K1 time {case} M={M} K={K} {name}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                  f"share of the bound {b_ms / ms:.3f}, "
                  f"fp32-SIMT bound {bs:.4f} ms ({bys})")
        rows[case] = t_case
    return {"errs": errs, "rows": rows}


def check_k2(device) -> dict:
    import torch

    from contrastiveseg_tpu_torch.ops import conv_cuda as k2
    from contrastiveseg_tpu_torch.ops.conv import conv3x3_dw_plain, conv3x3_plain

    errs = {name: 0.0 for name in k2.KERNELS}
    rows = {}
    g = torch.Generator().manual_seed(2)
    for case, (B, C, H, W) in (("main_path", (2, 48, 128, 256)), ("ragged", (2, 48, 128, 40))):
        x = torch.randn(B, C, H, W, generator=g).to(device)
        w = (torch.randn(C, C, 3, 3, generator=g) / (3 * C ** 0.5)).to(device)
        gy = torch.randn(B, C, H, W, generator=g).to(device)
        y = k2.conv3x3_fwd(x, w)
        dx = k2.conv3x3_fwd(gy, w, True)
        dw = k2.conv3x3_dw(x, gy)
        torch.cuda.synchronize()
        errs["conv3x3_fwd"] = max(
            errs["conv3x3_fwd"], close(f"K2 {case} forward", y, conv3x3_plain(x, w), 1e-4, 1e-4),
            close(f"K2 {case} dX", dx, conv3x3_plain(gy, w, True), 1e-4, 1e-4))
        want_dw = conv3x3_dw_plain(x, gy)
        errs["conv3x3_dw"] = max(errs["conv3x3_dw"], close(
            f"K2 {case} dW", dw, want_dw, 1e-4, 4e-6 * float(want_dw.abs().max())))
        print(f"K2 {case} {[B, C, H, W]}: forward, dX and dW match the plain versions")
        if case != "main_path":
            continue
        flops = 2 * 9 * C * C * B * H * W
        rows = {
            "conv3x3_fwd": (
                time_ms(lambda: k2.conv3x3_fwd(x, w)),
                time_ms(lambda: conv3x3_plain(x, w)),
                time_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1)),
                bound(flops, nbytes(x, w, y)), bound(flops, nbytes(x, w, y), "fp32_simt")),
            "conv3x3_dw": (
                time_ms(lambda: k2.conv3x3_dw(x, gy)),
                time_ms(lambda: conv3x3_dw_plain(x, gy)),
                time_ms(lambda: torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1)),
                bound(flops, nbytes(x, gy, dw)), bound(flops, nbytes(x, gy, dw), "fp32_simt")),
        }
        for name, (ms, plain_ms, lib_ms, (b_ms, by), (bs, _)) in rows.items():
            print(f"K2 time {[B, C, H, W]} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                  f"share of the bound {b_ms / ms:.3f}, fp32-SIMT bound {bs:.4f} ms")

    # The forward and dW at the recipe's batch 8 (dW sums 262,144 pixels),
    # against the formulas in fp64 at the card test's tolerances: cuDNN's fp32
    # dW, printed beside it, strays from fp64 itself at this depth.
    B, C, H, W = 8, 48, 128, 256
    x = torch.randn(B, C, H, W, generator=g).to(device)
    w = (torch.randn(C, C, 3, 3, generator=g) / (3 * C ** 0.5)).to(device)
    gy = torch.randn(B, C, H, W, generator=g).to(device)
    y = k2.conv3x3_fwd(x, w)
    dw = k2.conv3x3_dw(x, gy)
    torch.cuda.synchronize()
    err = close("K2 batch 8 forward against fp64", y.double(),
                torch.nn.functional.conv2d(x.double(), w.double(), padding=1), 1e-4, 1e-4)
    errs["conv3x3_fwd"] = max(errs["conv3x3_fwd"], err)
    print(f"K2 batch 8 forward: max abs err against fp64 {err:.3e} (rtol 1e-4, atol 1e-4)")
    want_dw = torch.nn.grad.conv2d_weight(x.double(), (C, C, 3, 3), gy.double(), padding=1)
    atol = 1e-6 * float(want_dw.abs().max()) + 1e-4
    err = close("K2 batch 8 dW against fp64", dw.double(), want_dw, 1e-4, atol)
    lib_err = float((conv3x3_dw_plain(x, gy).double() - want_dw).abs().max())
    print(f"K2 batch 8 dW: max abs err against fp64 {err:.3e} (cuDNN fp32 "
          f"conv2d_weight {lib_err:.3e}; atol {atol:.3e}, rtol 1e-4)")
    flops = 2 * 9 * C * C * B * H * W
    b8 = {
        "conv3x3_fwd": (time_ms(lambda: k2.conv3x3_fwd(x, w)),
                        time_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1)),
                        bound(flops, nbytes(x, w, y)), "conv2d"),
        "conv3x3_dw": (time_ms(lambda: k2.conv3x3_dw(x, gy)),
                       time_ms(lambda: torch.nn.grad.conv2d_weight(x, (C, C, 3, 3), gy,
                                                                   padding=1)),
                       bound(flops, nbytes(x, gy, dw)), "conv2d_weight"),
    }
    for name, (ms, lib_ms, (b_ms, by), lib) in b8.items():
        print(f"K2 time {[B, C, H, W]} {name}: kernel {ms:.4f} ms, library {lib_ms:.4f} ms "
              f"({lib}), bound {b_ms:.4f} ms ({by}), share of the bound {b_ms / ms:.3f}")
    return {"errs": errs, "rows": rows, "b8": b8}


def check_k3(device) -> dict:
    import torch

    from contrastiveseg_tpu_torch.ops.block import reference_block_eval
    from contrastiveseg_tpu_torch.ops.block_cuda import fused_basic_block_eval
    from tools.bench_block_torch import make_inputs

    errs = {}
    for fp32 in (True, False):
        args = make_inputs(8, 128, 256, 48, fp32, device)
        got = fused_basic_block_eval(*args)
        want = reference_block_eval(*args)
        torch.cuda.synchronize()
        if fp32:
            e = close("K3 fp32", got, want, 1e-4, 1e-4)
        else:  # within 2 bf16 steps of the output's magnitude
            step = 2.0 ** -7 * want.float().abs().clamp(min=1.0)
            diff = (got.float() - want.float()).abs()
            if not torch.isfinite(got.float()).all() or bool((diff > 2 * step).any()):
                raise AssertionError(f"K3 bf16 disagrees: max abs err {float(diff.max()):.3e}")
            e = float(diff.max())
        errs["fp32" if fp32 else "bf16"] = e
        print(f"K3 {'fp32' if fp32 else 'bf16'} [8, 48, 128, 256]: max abs err {e:.3e}")
    return {"errs": errs}


def slice_config(extra: list[str]):
    from tools.train_torch import build_config

    return build_config("cityscapes_hrnet_w48_mem", None, SLICE + extra)


def pipeline_batch(cfg, device) -> dict:
    """The train pipeline's first batch, on ``device``."""
    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
    from contrastiveseg_tpu_torch.engine.prefetch import device_batches

    batches = device_batches(build_pipeline(cfg, "train").iter_from(0), device)
    try:
        return next(batches)
    finally:
        batches.close()


def check_history(history, launches: dict, want: dict, what: str) -> None:
    import torch

    for i, row in enumerate(history):
        print(f"{what} step {i + 1}: loss {row['loss']:.6f} seg "
              f"{row['loss_seg']:.6f} contrast {row['loss_contrast']:.6f} "
              f"time {row['seconds'] * 1e3:.1f} ms, data wait "
              f"{row['data_seconds'] * 1e3:.1f} ms")
    for row in history:
        for key in ("loss", "loss_seg", "loss_contrast"):
            if not torch.isfinite(torch.tensor(row[key])):
                raise AssertionError(f"{what}: non-finite {key}: {row}")
        if not row["loss_contrast"] > 0:
            raise AssertionError(f"{what}: contrast term is not positive: {row}")
    for name, n in want.items():
        if launches.get(name, 0) < n:
            raise AssertionError(f"{what}: {name} launched {launches.get(name, 0)} times, "
                                 f"expected >= {n}: {launches}")
    print(f"{what} launches {json.dumps(launches)}")


def reset_counts() -> None:
    from contrastiveseg_tpu_torch.ops import block_cuda, contrast_cuda, conv_cuda

    for mod in (contrast_cuda, conv_cuda, block_cuda):
        mod.reset_launch_counts()


def read_counts() -> dict:
    from contrastiveseg_tpu_torch.ops import block_cuda, contrast_cuda, conv_cuda

    counts = {}
    for mod in (contrast_cuda, conv_cuda, block_cuda):
        counts.update(mod.launch_counts())
    return counts


def run_slice(device) -> dict:
    """The slice with network.pallas_conv off; returns its launches and step
    times."""
    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1

    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    cfg = slice_config(["solver.test_interval=0", "checkpoints.save_iters=0",
                        f"checkpoints.checkpoints_dir={ckpt_dir / 'off'}"])
    trainer = Trainer(cfg, device)
    state = trainer.state
    C, M = state.bank.num_classes, state.bank.memory_size
    if C * 2 * M != 190_000:
        raise AssertionError(f"bank has {C * 2 * M} rows, expected 190,000")
    params0 = [q.detach().clone() for q in state.model.parameters()]
    seg_ptr0 = state.bank.segment_ptr.clone()
    pix_ptr0 = state.bank.pixel_ptr.clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    history = trainer.train()
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    check_history(history, launches, {n: 3 for n in k1.KERNELS}, "slice")
    if any(launches[n] for n in ("conv3x3_fwd", "conv3x3_dw", "fused_block")):
        raise AssertionError(f"the flag-off slice launched K2 or K3: {launches}")
    if bool((state.bank.segment_ptr == seg_ptr0).all()) or bool(
            (state.bank.pixel_ptr == pix_ptr0).all()):
        raise AssertionError("the bank pointers did not advance")
    if all(torch.equal(a, b) for a, b in zip(params0, state.model.parameters())):
        raise AssertionError("the parameters did not change")
    print(f"slice step time steps 2-3: "
          f"{[round(r['seconds'] * 1e3, 1) for r in history[1:]]} ms; "
          f"peak memory {peak / 2**30:.3f} GiB (max_memory_allocated)")

    # The trained model's contrast loss through K1 against the plain
    # version, on the same outputs, anchor draws and bank.
    from contrastiveseg_tpu_torch.losses.manager import build_loss
    from contrastiveseg_tpu_torch.ops.contrast import hard_anchor_sample
    from contrastiveseg_tpu_torch.ops.contrast_stream import streaming_contrastive_loss
    from contrastiveseg_tpu_torch.ops.queue import bank_as_contrast_set
    from contrastiveseg_tpu_torch.ops.resize import scale_target_nearest

    batch = pipeline_batch(cfg, device)
    images, labels = batch["image"], batch["label"]
    with torch.no_grad():
        out = state.model.eval()(images)
    B, h, w, D = out["embed"].shape
    if tuple(out["seg"].shape) != (2, 128, 256, 19) or (B, h, w, D) != (2, 128, 256, 256):
        raise AssertionError(f"unexpected output shapes "
                             f"{out['seg'].shape} {out['embed'].shape}")
    loss = build_loss(cfg)
    spec = loss.spec
    gen = torch.Generator(device=device).manual_seed(0)
    anchors = hard_anchor_sample(
        out["embed"].reshape(B, h * w, D),
        scale_target_nearest(labels, (h, w)).reshape(B, h * w),
        out["seg"].argmax(-1).reshape(B, h * w), spec, generator=gen)
    contrast_set = bank_as_contrast_set(state.bank, loss.include_class0)
    xk = anchors.feats.clone().requires_grad_(True)
    xp = anchors.feats.clone().requires_grad_(True)
    lk = k1.cuda_contrastive_loss(xk, anchors.labels, anchors.valid, *contrast_set,
                                  spec.temperature, spec.base_temperature)
    lp = streaming_contrastive_loss(xp, anchors.labels, anchors.valid, *contrast_set,
                                    spec.temperature, spec.base_temperature)
    lk.backward()
    lp.backward()
    close("trained-model contrast loss", lk.detach(), lp.detach(), 1e-5, 0.0)
    close("trained-model contrast grad", xk.grad, xp.grad, 1e-4, 1e-5)
    print(f"trained model ({anchors.feats.shape[0]} anchors): contrast loss K1 "
          f"{float(lk.detach()):.6f} plain {float(lp.detach()):.6f}")
    return {"launches": launches, "history": history, "peak": peak}


def run_flagged_slice(device) -> dict:
    """The slice with network.pallas_conv=true, validation and checkpoints."""
    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1

    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt" / "on"
    cfg = slice_config(["network.pallas_conv=true", "solver.test_interval=3",
                        "checkpoints.save_iters=0", "data.synthetic_length=4",
                        "val.batch_size=2", f"checkpoints.checkpoints_dir={ckpt_dir}"])
    trainer = Trainer(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    history = trainer.train()
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    want = {n: 3 for n in k1.KERNELS}
    want.update(conv3x3_fwd=2 * 64 * 3, conv3x3_dw=64 * 3)
    check_history(history, launches, want, "flag-on slice")
    scores = trainer.last_scores
    if not (0.0 <= scores.get("miou", -1.0) <= 1.0):
        raise AssertionError(f"validation gave no mIoU in [0, 1]: {scores}")
    print(f"flag-on slice validation (4 synthetic scenes of 512x1024, padded to "
          f"1024x2048): mIoU {scores['miou']:.4f} "
          f"pixel_acc {scores['pixel_acc']:.4f}, {scores['images_per_sec']:.2f} img/s")
    print(f"flag-on slice step time steps 2-3: "
          f"{[round(r['seconds'] * 1e3, 1) for r in history[1:]]} ms; "
          f"peak memory {peak / 2**30:.3f} GiB (max_memory_allocated)")

    # Checkpoint round trip: a new trainer resumed from the latest checkpoint
    # holds the trained state exactly.
    if not (trainer.ckpt.has("latest") and trainer.ckpt.has("max_performance")):
        raise AssertionError("the flag-on slice wrote no latest/max_performance checkpoint")
    path = trainer.ckpt._path("latest")
    resumed = Trainer(cfg.updated("network.resume", path), device)
    a, b = trainer.state, resumed.state
    same = (a.step == b.step == 3
            and all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                      b.model.state_dict().values()))
            and torch.equal(a.bank.storage, b.bank.storage)
            and torch.equal(a.bank.segment_ptr, b.bank.segment_ptr)
            and torch.equal(a.bank.pixel_ptr, b.bank.pixel_ptr)
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"])
    if not same:
        raise AssertionError("the restored checkpoint differs from the trained state")
    print(f"checkpoint round trip: {Path(path).name} "
          f"({Path(path).stat().st_size / 2**20:.1f} MiB) restored at step {b.step}, equal")
    del resumed
    return {"launches": launches, "history": history, "peak": peak, "scores": scores}


def flag_on_equals_off(device) -> None:
    """Step 1 with network.pallas_conv on and off, from the same seed, batch
    and anchor and enqueue scores."""
    import torch

    from contrastiveseg_tpu_torch.engine.state import create_train_state
    from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
    from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
    from contrastiveseg_tpu_torch.losses.manager import build_loss
    from contrastiveseg_tpu_torch.models.nets import build_model

    results = {}
    for flag in (False, True):
        cfg = slice_config([f"network.pallas_conv={flag}"])
        batch = pipeline_batch(cfg, device)
        _, h, w, _ = batch["image"].shape
        C, n = cfg.get("data.num_classes"), (h // 4) * (w // 4)
        g = torch.Generator(device=device).manual_seed(11)
        draws = Draws(AnchorScores(torch.rand((2, C, n), generator=g, device=device),
                                   torch.rand((2, C, n), generator=g, device=device)),
                      torch.rand((2, C, n), generator=g, device=device))
        state = create_train_state(cfg, build_model(cfg), device)
        step = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4,
                               pixel_update_freq=cfg.get("contrast.pixel_update_freq"))
        metrics = step(state, batch, draws)
        grads = {name: p.grad.detach().clone()
                 for name, p in state.model.backbone.named_parameters()
                 if ".branches.0." in name and name.endswith(("conv1.weight", "conv2.weight"))}
        results[flag] = ({k: float(v) for k, v in metrics.items()}, grads)
        del state
        torch.cuda.empty_cache()
    (m_off, g_off), (m_on, g_on) = results[False], results[True]
    for key in ("loss", "loss_seg", "loss_contrast"):
        if abs(m_on[key] - m_off[key]) > 1e-4 * abs(m_off[key]):
            raise AssertionError(f"flag on/off {key}: {m_on[key]} vs {m_off[key]}")
    if len(g_on) != 64 or g_on.keys() != g_off.keys():
        raise AssertionError(f"expected 64 branch-0 conv weights, got {len(g_on)}")
    rel = {k: float((g_on[k] - g_off[k]).norm() / g_off[k].norm()) for k in g_on}
    worst = max(rel, key=rel.get)
    err = max(float((g_on[k] - g_off[k]).abs().max()) for k in g_on)
    if rel[worst] > GRAD_REL_NORM:
        raise AssertionError(f"flag on/off gradient of {worst}: relative norm error "
                             f"{rel[worst]:.3e} > {GRAD_REL_NORM}")
    print(f"flag on equals flag off at step 1: loss {m_on['loss']:.6f} vs "
          f"{m_off['loss']:.6f}; 64 branch-0 conv weight gradients: relative norm "
          f"error at most {rel[worst]:.3e} ({worst}), max abs err {err:.3e}")


def run_block_bench() -> dict:
    """K3's path: tools/bench_block_torch.py, bf16 (its default) and fp32."""
    from tools.bench_block_torch import bench

    out = {}
    for fp32 in (False, True):
        reset_counts()
        res = bench(8, 128, 256, 48, fp32=fp32, reps=5, chain=10)
        res["launches"] = read_counts()["fused_block"]
        if res["launches"] < 1:
            raise AssertionError("the bench did not launch K3")
        print(f"bench_block_torch {json.dumps(res)}")
        out["fp32" if fp32 else "bf16"] = res
    return out


def write_dataset(root: Path, n_train: int = 8, n_val: int = 4, hw=(1024, 2048),
                  seed: int = 0, sidecars: bool = True, filters=(0,),
                  instances: bool = False) -> None:
    """A Cityscapes-layout tree, {root}/{split}/image|label/*.png, each PNG
    beside its ``.npy_cache/<name>.png.npy`` sidecar (the decoded array, as
    ``tools/cache_dataset.py`` writes it; written after the PNG, so fresh;
    none with ``sidecars`` False), the PNG rows cycling through ``filters``,
    and the val labels again as the official evaluator's ground truth,
    ``{root}/gtFine/val/frankfurt/<stem>_gtFine_labelIds.png`` and
    ``_instanceIds.png`` (one instance per class and frame).  The frames are
    the synthetic scenes with raw Cityscapes ids; the bottom sixteenth of each
    is raw id 0 (unlabeled), which relabels to -1.  Val frames are named as
    Cityscapes names them (``frankfurt_000000_<i>_leftImg8bit``), so that the
    evaluator pairs the tester's outputs with them.  With ``instances``, each
    frame also gets ``{split}/instance/<name>.png``, a 16-bit map in the
    instanceIds convention (a stuff pixel its raw id, an instance pixel its
    raw id * 1000 + k), where every instance class's region is two
    instances that touch at the frame's middle column (SegFix's
    ``data.dt_boundary=instance`` ground truth).  PNGs are written by the
    port's ``utils/png.py``."""
    import numpy as np

    from contrastiveseg_tpu_torch.data.datasets import (
        CITYSCAPES_LABEL_LIST,
        SyntheticSegDataset,
    )
    from contrastiveseg_tpu_torch.metrics.cityscapes_official import CS_LABELS
    from contrastiveseg_tpu_torch.utils.png import encode_png

    raw_ids = np.asarray(CITYSCAPES_LABEL_LIST, np.uint8)
    has_instances = np.zeros(256, bool)
    has_instances[[lab.id for lab in CS_LABELS if lab.has_instances]] = True
    scenes = SyntheticSegDataset(19, hw, n_train + n_val, seed=seed)
    gt_dir = root / "gtFine" / "val" / "frankfurt"
    gt_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_train + n_val):
        split, name = (("train", f"f{i}") if i < n_train
                       else ("val", f"frankfurt_000000_{i - n_train:06d}_leftImg8bit"))
        scene = scenes[i]
        label = raw_ids[scene["label"]]
        label[-(hw[0] // 16):] = 0
        for kind, array in (("image", scene["image"]), ("label", label)):
            d = root / split / kind
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{name}.png").write_bytes(encode_png(array, level=1, filters=filters))
            if sidecars:
                (d / ".npy_cache").mkdir(exist_ok=True)
                np.save(d / ".npy_cache" / f"{name}.png.npy", array)
        if instances:
            right = np.arange(hw[1]) >= hw[1] // 2
            inst = np.where(has_instances[label], label.astype(np.uint16) * 1000 + right, label)
            d = root / split / "instance"
            d.mkdir(exist_ok=True)
            (d / f"{name}.png").write_bytes(encode_png(inst.astype(np.uint16), level=1,
                                                       filters=filters))
        if split == "val":
            stem = name.removesuffix("_leftImg8bit")
            inst = np.where(has_instances[label], label.astype(np.uint16) * 1000, label)
            (gt_dir / f"{stem}_gtFine_labelIds.png").write_bytes(encode_png(label, level=1))
            (gt_dir / f"{stem}_gtFine_instanceIds.png").write_bytes(
                encode_png(inst.astype(np.uint16), level=1))


def pipeline_seconds(cfg, workers: int, repeat: int = 4) -> float:
    """Host seconds a batch of the train pipeline alone, over one epoch of
    the train frames listed ``repeat`` times (so that workers >= 2 have
    batches to overlap)."""
    from contrastiveseg_tpu_torch.data.datasets import build_dataset
    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline

    cfg = cfg.updated("data.workers", workers)
    dataset = build_dataset(cfg, "train")
    dataset.items = dataset.items * repeat
    pipe = build_pipeline(cfg, "train", dataset=dataset)
    t0 = time.perf_counter()
    n = sum(1 for _ in pipe.epoch_iter(0))
    return (time.perf_counter() - t0) / n


def run_directory_slice(device) -> dict:
    """The headline at batch 8 from a Cityscapes-layout directory."""
    import importlib.util
    import sys

    import torch

    from contrastiveseg_tpu_torch.data import native
    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
    from tools.train_torch import build_config

    pil_loaded = "PIL.Image" in sys.modules
    data_dir = ROOT / "build" / "chip_smoke_data"
    shutil.rmtree(data_dir, ignore_errors=True)
    t0 = time.perf_counter()
    write_dataset(data_dir)
    print(f"directory slice: wrote 8 train and 4 val frames of 1024x2048 (PNG and "
          f".npy_cache) in {time.perf_counter() - t0:.1f} s")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt" / "dir"
    cfg = build_config("cityscapes_hrnet_w48_mem", None, [
        "data.synthetic=False", f"data.data_dir={data_dir}", "contrast.warmup_iters=0",
        "solver.max_iters=3", "solver.display_iter=1", "solver.test_interval=0",
        "checkpoints.save_iters=0", f"checkpoints.checkpoints_dir={ckpt_dir}"])
    if (cfg.get("train.batch_size"), cfg.get("train_trans.random_crop.crop_size"),
            cfg.get("train_trans.random_resize.scale_range")) != (8, [1024, 512], [0.5, 2.0]):
        raise AssertionError("the directory slice must run the recipe's batch 8, crop and scales")
    trainer = Trainer(cfg, device)
    first = []
    step = trainer.train_step

    def keep_first(state, batch):
        if not first:
            first.append({k: v.clone() for k, v in batch.items()})
        return step(state, batch)

    trainer.train_step = keep_first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    history = trainer.train()
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    check_history(history, launches, {n: 3 for n in k1.KERNELS}, "directory slice")
    if any(launches[n] for n in ("conv3x3_fwd", "conv3x3_dw", "fused_block")):
        raise AssertionError(f"the directory slice launched K2 or K3: {launches}")

    host = next(build_pipeline(cfg, "train").iter_from(0))
    got = first[0]
    if tuple(got["image"].shape) != (8, 512, 1024, 3) or not (
            torch.equal(got["image"].cpu(), torch.from_numpy(host["image"]))
            and torch.equal(got["label"].cpu(), torch.from_numpy(host["label"]).long())):
        raise AssertionError("the first device batch differs from the pipeline's host batch")
    ignored = float((got["label"] == -1).float().mean())
    print(f"directory slice: first device batch {list(got['image'].shape)} equals the "
          f"pipeline's host batch bit for bit ({ignored:.3f} of its labels are -1)")

    scores = trainer.validate()
    if not (0.0 <= scores["miou"] <= 1.0):
        raise AssertionError(f"directory validation gave no mIoU in [0, 1]: {scores}")
    print(f"directory slice validation (4 frames of 1024x2048, batch 4): mIoU "
          f"{scores['miou']:.4f} pixel_acc {scores['pixel_acc']:.4f}, "
          f"{scores['images_per_sec']:.3f} val images/s")

    route = native.LIBRARY.route()
    if Path(route).parent != ROOT / "build" / "segdata" or native.LIBRARY.fallbacks:
        raise AssertionError(f"segdata came from {route} with {native.LIBRARY.fallbacks} "
                             "numpy fallbacks; expected the build in build/segdata/ and none")
    if not pil_loaded and "PIL.Image" in sys.modules:
        raise AssertionError("the directory slice decoded a PNG through PIL")
    print(f"segdata: {Path(route).relative_to(ROOT)}, 0 numpy fallbacks; PIL importable: "
          f"{importlib.util.find_spec('PIL') is not None}, not imported by the phase")
    host_s = {w: pipeline_seconds(cfg, w) for w in (1, 4)}
    steps = history[1:]
    print(f"directory slice at batch 8: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in steps]} ms, data wait "
          f"{[round(r['data_seconds'] * 1e3, 1) for r in steps]} ms a step (step 1: "
          f"{history[0]['seconds'] * 1e3:.1f} ms, data wait "
          f"{history[0]['data_seconds'] * 1e3:.1f} ms); pipeline alone "
          f"{host_s[1]:.3f} s a batch at 1 worker, {host_s[4]:.3f} s at 4; peak memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated)")
    latest = trainer.ckpt._path("latest")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "history": history, "peak": peak, "scores": scores,
            "host_seconds": host_s, "data_dir": data_dir, "latest": latest}


def directory_config(preset: str, data_dir: Path, ckpt_dir: Path, extra: list[str]):
    from tools.train_torch import build_config

    return build_config(preset, None, [
        "data.synthetic=False", f"data.data_dir={data_dir}", "solver.display_iter=1",
        "solver.test_interval=0", "checkpoints.save_iters=0",
        f"checkpoints.checkpoints_dir={ckpt_dir}"] + extra)


def train_phase(trainer, device, what: str) -> tuple[list, dict, int]:
    """Train ``trainer`` with the launch counts and the peak memory reset
    just before; returns its history, the launches and the peak."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    history = trainer.train()
    torch.cuda.synchronize()
    launches, peak = read_counts(), torch.cuda.max_memory_allocated(device)
    for i, row in enumerate(history):
        for key in ("loss", "loss_seg") + (("loss_contrast",) if "loss_contrast" in row else ()):
            if not torch.isfinite(torch.tensor(row[key])):
                raise AssertionError(f"{what}: non-finite {key}: {row}")
        print(f"{what} step {i + 1}: " + " ".join(
            f"{k} {v:.6f}" for k, v in row.items() if k.startswith("loss"))
            + f" time {row['seconds'] * 1e3:.1f} ms, data wait {row['data_seconds'] * 1e3:.1f} ms")
    print(f"{what}: peak memory {peak / 2**30:.3f} GiB (max_memory_allocated); "
          f"launches {json.dumps(launches)}")
    return history, launches, peak


def no_launch(launches: dict, what: str, total: collections.Counter) -> None:
    """Fail if a path launched any of K1-K3; add its counts to ``total``
    (the kernels line sums them over a phase)."""
    total.update(launches)
    if any(launches.values()):
        raise AssertionError(f"{what} launched a kernel of K1-K3: {launches}")


def no_k1(launches: dict, what: str) -> None:
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1

    if any(launches[n] for n in k1.KERNELS):
        raise AssertionError(f"{what} has no bank but launched K1: {launches}")


def same_state(a, b) -> bool:
    """Step, every model tensor and every momentum buffer, bit for bit."""
    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.step == b.step and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(a.optimizer.state[p]["momentum_buffer"],
                                b.optimizer.state[q]["momentum_buffer"])
                    for p, q in zip(a.model.parameters(), b.model.parameters())))


def run_plain_phase(device, data_dir: Path) -> dict:
    """cityscapes_hrnet_w48 (no projection head, CE only) at batch 8 from the
    directory; validation at 2048x1024; a checkpoint round trip."""
    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    cfg = directory_config("cityscapes_hrnet_w48", data_dir,
                           ROOT / "build" / "chip_smoke_ckpt" / "plain",
                           ["solver.max_iters=3", "val.batch_size=2"])
    if cfg.get("train.batch_size") != 8 or cfg.get("loss.loss_type") != "fs_ce_loss":
        raise AssertionError("the plain phase must run the preset's batch 8 and fs_ce_loss")
    trainer = Trainer(cfg, device)
    if trainer.state.bank is not None or trainer.state.model.proj_head is not None:
        raise AssertionError("cityscapes_hrnet_w48 built a bank or a projection head")
    history, launches, peak = train_phase(trainer, device, "plain phase")
    no_k1(launches, "the plain phase")
    print("plain phase validation: val.batch_size overridden from the preset's "
          f"{directory_config('cityscapes_hrnet_w48', data_dir, ROOT, []).get('val.batch_size')}"
          " to 2 (cuDNN's algorithm choice at batch 4 takes ~20 s a batch, PERF.md section 5)")
    scores = trainer.validate()
    if not (0.0 <= scores["miou"] <= 1.0):
        raise AssertionError(f"plain validation gave no mIoU in [0, 1]: {scores}")
    print(f"plain phase validation (4 frames of 1024x2048, batch 2): mIoU "
          f"{scores['miou']:.4f} pixel_acc {scores['pixel_acc']:.4f}, "
          f"{scores['images_per_sec']:.3f} val images/s")
    path = trainer.ckpt._path("latest")
    resumed = Trainer(cfg.updated("network.resume", path), device)
    if resumed.state.step != 3 or not same_state(trainer.state, resumed.state):
        raise AssertionError("the plain checkpoint did not restore the trained state bit for bit")
    print(f"plain phase checkpoint round trip: {Path(path).name} "
          f"({Path(path).stat().st_size / 2**20:.1f} MiB) restored at step 3, every weight, "
          "BN statistic and momentum buffer equal")
    del trainer, resumed
    torch.cuda.empty_cache()
    return {"history": history, "peak": peak, "scores": scores}


def run_contrast_phase(device, data_dir: Path) -> dict:
    """cityscapes_hrnet_w48_contrast (InfoNCE of the anchors against each
    other, no bank) at batch 8 from the directory, contrast live from step 0."""
    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.ops import contrast

    cfg = directory_config("cityscapes_hrnet_w48_contrast", data_dir,
                           ROOT / "build" / "chip_smoke_ckpt" / "contrast",
                           ["solver.max_iters=3", "contrast.warmup_iters=0"])
    if (cfg.get("train.batch_size"), cfg.get("contrast.max_views"),
            cfg.get("contrast.with_memory")) != (8, 100, False):
        raise AssertionError("the contrast phase must run the preset's batch 8, "
                             "max_views 100 and no bank")
    trainer = Trainer(cfg, device)
    sample, anchors = contrast.hard_anchor_sample, []

    def counted(*args, **kwargs):  # records each step's anchor rows, no sync
        out = sample(*args, **kwargs)
        anchors.append((out.valid.shape[0], out.valid.sum()))
        return out

    contrast.hard_anchor_sample = counted
    try:
        history, launches, peak = train_phase(trainer, device, "contrast phase")
    finally:
        contrast.hard_anchor_sample = sample
    no_k1(launches, "the contrast phase")
    m = [(rows, int(valid)) for rows, valid in anchors]
    print(f"contrast phase anchors (rows, valid rows M) per step: {m}")
    if len(m) != len(history):
        raise AssertionError(f"contrast phase: {len(m)} anchor draws seen for "
                             f"{len(history)} steps")
    for row, (_, valid) in zip(history, m):
        if not (row["loss_contrast"] > 0 and valid > 0):
            raise AssertionError(f"contrast phase: no anchors or no contrast term: {row}, M={valid}")
    del trainer
    torch.cuda.empty_cache()
    return {"history": history, "peak": peak, "anchors": m}


def run_pretrained_phase(device, data_dir: Path) -> dict:
    """network.pretrained from the reference's ImageNet and HRNet_W48_MEM
    layouts, written from a freshly initialised port W48."""
    import torch

    from contrastiveseg_tpu_torch.engine.state import init_weights
    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.models.nets import build_model
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
    from contrastiveseg_tpu_torch.utils.pretrained import QUEUE_KEYS

    out_dir = ROOT / "build" / "chip_smoke_pretrained"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg = directory_config("cityscapes_hrnet_w48_mem", data_dir, out_dir / "ckpt",
                           ["solver.max_iters=2", "train.batch_size=2",
                            "contrast.warmup_iters=0"])
    source = build_model(cfg)
    g = torch.Generator().manual_seed(2024)
    init_weights(source, g)
    with torch.no_grad():  # BN tensors off their init too, so the check means something
        for mod in source.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                for t in (mod.weight, mod.bias, mod.running_mean, mod.running_var):
                    t.add_(0.1 * torch.rand(t.shape, generator=g))
    sd = source.state_dict()
    imagenet = {k.removeprefix("backbone."): v for k, v in sd.items() if k.startswith("backbone.")}
    imagenet.update({"incre_modules.0.0.conv1.weight": torch.ones(32, 48, 1, 1),
                     "classifier.weight": torch.ones(1000, 2048),
                     "classifier.bias": torch.zeros(1000)})
    C, M, D = 19, cfg.get("contrast.memory_size"), cfg.get("contrast.proj_dim")
    q = torch.nn.functional.normalize(torch.randn((2, C, M, D), generator=g), dim=-1)
    queues = dict(zip(QUEUE_KEYS, (q[0], torch.randint(0, M, (C,), generator=g),
                                   q[1], torch.randint(0, M, (C,), generator=g))))
    mem = {**{f"encoder_q.{k}": v for k, v in sd.items()}, **queues}
    paths = {"imagenet": out_dir / "hrnetv2_w48_imagenet.pth", "mem": out_dir / "hrnet_w48_mem.pth"}
    torch.save(imagenet, paths["imagenet"])
    torch.save({"state_dict": mem}, paths["mem"])
    print(f"pretrained phase: wrote {paths['imagenet'].name} "
          f"({paths['imagenet'].stat().st_size / 2**20:.1f} MiB, {len(imagenet)} tensors) and "
          f"{paths['mem'].name} ({paths['mem'].stat().st_size / 2**20:.1f} MiB, queues "
          f"{tuple(queues['segment_queue'].shape)} x2) in {time.perf_counter() - t0:.1f} s")

    def loaded(trainer, want: dict, what: str) -> None:
        got = trainer.state.model.state_dict()
        bad = [k for k, v in want.items() if not torch.equal(got[k], v.to(device))]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} tensors differ from the file: {bad[:5]}")
        print(f"{what}: {len(want)} tensors equal the file's bit for bit, on the device")

    backbone = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    for preset in ("cityscapes_hrnet_w48_mem", "cityscapes_hrnet_w48"):
        trainer = Trainer(directory_config(preset, data_dir, out_dir / "ckpt", [
            f"network.pretrained={paths['imagenet']}"]), device)
        loaded(trainer, backbone, f"{preset} from the ImageNet file")
        del trainer
    trainer = Trainer(cfg.updated("network.pretrained", str(paths["mem"])), device)
    loaded(trainer, sd, "cityscapes_hrnet_w48_mem from the HRNet_W48_MEM file")
    bank = trainer.state.bank
    if not (torch.equal(bank.segment_queue, queues["segment_queue"].to(device))
            and torch.equal(bank.pixel_queue, queues["pixel_queue"].to(device))
            and torch.equal(bank.segment_ptr.long(), queues["segment_queue_ptr"].to(device))
            and torch.equal(bank.pixel_ptr.long(), queues["pixel_queue_ptr"].to(device))):
        raise AssertionError("the bank does not equal the file's queues and pointers")
    print(f"the bank equals the file's queues ({C} x {M} x {D}, twice) and pointers")
    history, launches, peak = train_phase(trainer, device, "pretrained phase (MEM file, batch 2)")
    for name in k1.KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the pretrained phase launched {name} {launches[name]} times")
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"history": history, "peak": peak, "launches": launches}


MODEL_PRESETS = ("cityscapes_deeplab_v3", "cityscapes_deeplab_v3_contrast",
                 "cityscapes_hrnet_w48_ocr", "cityscapes_hrnet_w48_ocr_contrast")


def run_models_phase(device, data_dir: Path) -> dict:
    """The paper's DeepLab-V3 and HRNet-W48 + OCR rows, with and without
    contrast: each preset at full width and its batch 8 for 2 steps from the
    directory (no K1, K2 or K3 on this path); the two contrast trainers
    round-trip ``latest`` and run ``--phase val`` and ``ss_test`` at batch 1
    from it; a deep-base ResNet-101 ImageNet ``.pth`` in the reference's
    layout starts ``cityscapes_deeplab_v3`` bit for bit and takes a step."""
    import torch

    from contrastiveseg_tpu_torch.engine.state import init_weights
    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.models.nets import DeepLabV3, HRNetOCRSeg, build_model
    from contrastiveseg_tpu_torch.ops import contrast
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[models phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    root = ROOT / "build" / "chip_smoke_models"
    shutil.rmtree(root, ignore_errors=True)
    sample, anchors = contrast.hard_anchor_sample, []

    def counted(*args, **kwargs):  # each step's anchor rows, no sync
        out = sample(*args, **kwargs)
        anchors.append((out.valid.shape[0], out.valid.sum()))
        return out

    results, total = {}, collections.Counter()

    for preset in MODEL_PRESETS:
        contrastive = preset.endswith("_contrast")
        cfg = directory_config(preset, data_dir, root / preset, [
            f"solver.max_iters={CUT_STEPS}"] + (["contrast.warmup_iters=0"] if contrastive else []))
        want = (8, 19, "deepbase_resnet101_dilated8" if "deeplab" in preset else "hrnet48")
        got = (cfg.get("train.batch_size"), cfg.get("data.num_classes"),
               cfg.get("network.backbone"))
        if got != want:
            raise AssertionError(f"{preset}: batch, classes, backbone {got}; want {want}")
        trainer = Trainer(cfg, device)
        model = trainer.state.model
        if not isinstance(model, DeepLabV3 if "deeplab" in preset else HRNetOCRSeg) or (
                (model.proj_head is not None) != contrastive) or trainer.state.bank is not None:
            raise AssertionError(f"{preset} built {type(model).__name__} with the wrong heads")
        n_params = sum(p.numel() for p in model.parameters())
        say(f"{preset}: {type(model).__name__}, {n_params / 1e6:.2f} M parameters, "
            f"{cfg.get('loss.loss_type')}, batch {cfg.get('train.batch_size')} of "
            f"{cfg.get('train_trans.random_crop.crop_size')} crops")
        anchors.clear()
        contrast.hard_anchor_sample = counted
        try:
            history, launches, peak = train_phase(trainer, device, preset)
        finally:
            contrast.hard_anchor_sample = sample
        no_launch(launches, preset, total)
        m = [(rows, int(valid)) for rows, valid in anchors]
        if contrastive:
            say(f"{preset} anchors (rows, valid rows M) per step: {m}")
            if len(m) != len(history):
                raise AssertionError(f"{preset}: {len(m)} anchor draws seen for "
                                     f"{len(history)} steps")
            for row, (_, valid) in zip(history, m):
                if not (row["loss_contrast"] > 0 and valid > 0):
                    raise AssertionError(f"{preset}: no anchors or no contrast term: {row}")
        if not all(r["loss_seg"] > 0 for r in history):
            raise AssertionError(f"{preset}: a seg loss is not positive: {history}")
        same_on_the_cpu(model, preset, say)
        results[preset] = {"history": history, "peak": peak, "anchors": m,
                           "params": n_params}
        if contrastive:
            results[preset].update(infer_from_latest(trainer, cfg, device, run, say))
            for phase in ("val", "ss_test"):
                no_launch(results[preset][phase]["launches"], f"{preset} {phase}", total)
        del trainer, model
        torch.cuda.empty_cache()

    # A deep-base ResNet-101 ImageNet .pth in the reference's layout.
    cfg = directory_config("cityscapes_deeplab_v3", data_dir, root / "pretrained",
                           ["solver.max_iters=1", "train.batch_size=2"])
    source = build_model(cfg)
    g = torch.Generator().manual_seed(2025)
    init_weights(source, g)
    with torch.no_grad():
        for mod in source.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                for t in (mod.weight, mod.bias, mod.running_mean, mod.running_var):
                    t.add_(0.1 * torch.rand(t.shape, generator=g))
    sd = {k.removeprefix("backbone."): v for k, v in source.state_dict().items()
          if k.startswith("backbone.")}
    sd.update({"fc.weight": torch.ones(1000, 2048), "fc.bias": torch.zeros(1000)})
    path = root / "deepbase_resnet101_imagenet.pth"
    torch.save(sd, path)
    trainer = Trainer(cfg.updated("network.pretrained", str(path)), device)
    loaded = trainer.state.model.state_dict()
    bad = [k for k, v in source.state_dict().items()
           if k.startswith("backbone.") and not torch.equal(loaded[k], v.to(device))]
    if bad or not any(k.startswith("backbone.resinit.conv3") for k in loaded):
        raise AssertionError(f"the ResNet-101 .pth did not load bit for bit: {bad[:5]}")
    n = sum(k.startswith("backbone.") for k in loaded)
    history, launches, _ = train_phase(trainer, device, "cityscapes_deeplab_v3 from the .pth")
    no_launch(launches, "cityscapes_deeplab_v3 from the .pth", total)
    say(f"deep-base ResNet-101 ImageNet .pth ({path.stat().st_size / 2**20:.1f} MiB, "
        f"{len(sd)} tensors with fc.*): {n} backbone tensors equal the file's bit for bit "
        f"on the device; one step at batch 2, loss {history[0]['loss']:.6f}")
    results["pretrained"] = {"history": history, "tensors": n}
    del trainer, source
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    results["launches"] = dict(total)
    return results


def same_on_the_cpu(model, what: str, say) -> None:
    """The trained model's eval forward on the card against the same weights
    on the CPU, on a seeded 1x128x256 input: every output of the expected
    shape, finite, and within 1e-4 of the CPU's in relative L2 (fp32 on
    both, TF32 off; cuDNN and the CPU sum in other orders)."""
    import copy

    import torch

    x = torch.randn((1, 128, 256, 3), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = model.eval()(x.to(next(model.parameters()).device))
        want = copy.deepcopy(model).cpu()(x)
    model.train()
    errs = {}
    for k, w in want.items():
        g = got[k].cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what} {k}: shape {tuple(g.shape)} vs {tuple(w.shape)}, "
                                 f"finite {bool(torch.isfinite(g).all())}")
        errs[k] = float((g - w).norm() / w.norm())
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"{what}: the card's eval forward is off the CPU's: {errs}")
    say(f"{what}: eval forward on the card vs the CPU (1x128x256): shapes "
        f"{ {k: tuple(v.shape) for k, v in want.items()} }, relative L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (bound 1e-4)")


def infer_from_latest(trainer, cfg, device, run, say) -> dict:
    """``latest`` of ``trainer`` restored bit for bit into a new trainer,
    then ``--phase val`` and ``ss_test`` at batch 1 from it, over the 4 val
    frames of 1024x2048."""
    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    preset = cfg.get("network.model_name")
    path = trainer.ckpt._path("latest")  # saved at the end of train()
    resumed = Trainer(cfg.updated("network.resume", path), device)
    if resumed.state.step != cfg.get("solver.max_iters") or not same_state(
            trainer.state, resumed.state):
        raise AssertionError(f"{preset}: the checkpoint did not restore the trained state")
    say(f"{preset}: {Path(path).name} ({Path(path).stat().st_size / 2**20:.1f} MiB) restored "
        f"at step {resumed.state.step}, every weight, BN statistic and momentum buffer equal")
    del resumed
    out = {}
    data_dir = Path(cfg.get("data.data_dir"))
    c = (cfg.updated("network.resume", path).updated("val.batch_size", 1)
         .updated("test.batch_size", 1).updated("test.mode", "ss_test")
         .updated("test.test_dir", str(data_dir / "val" / "image"))
         .updated("test.out_dir", str(Path(path).parent / "ss_test")))
    for phase in ("val", "test"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        res = run(c, phase, device)
        torch.cuda.synchronize()
        wall, peak, launches = (time.perf_counter() - t0,
                                torch.cuda.max_memory_allocated(device), read_counts())
        if phase == "val":
            scores = res["scores"]
            if not 0.0 <= scores["miou"] <= 1.0:
                raise AssertionError(f"{preset} --phase val gave no mIoU: {scores}")
            out["val"] = {"images_per_sec": scores["images_per_sec"], "miou": scores["miou"],
                          "peak": peak, "wall": wall, "launches": launches}
            say(f"{preset} --phase val (4 frames of 1024x2048, batch 1): mIoU "
                f"{scores['miou']:.6f}, {scores['images_per_sec']:.3f} images/s "
                f"({1 / scores['images_per_sec']:.3f} s an image), peak {peak / 2**30:.3f} GiB, "
                f"wall {wall:.1f} s")
        else:
            timing = res["tester"].timing
            labels = list((Path(path).parent / "ss_test" / "label").glob("*.png"))
            if timing["images"] != 4 or len(labels) != 4:
                raise AssertionError(f"{preset} ss_test wrote {len(labels)} label PNGs")
            out["ss_test"] = {"seconds_an_image": timing["seconds"] / 4,
                              "infer_seconds_an_image": timing["infer_seconds"] / 4,
                              "peak": peak, "wall": wall, "launches": launches}
            say(f"{preset} --phase test ss_test (batch 1): {timing['seconds'] / 4:.3f} s an "
                f"image ({timing['infer_seconds'] / 4:.3f} s in the model), peak "
                f"{peak / 2**30:.3f} GiB, 4 label PNGs, wall {wall:.1f} s")
        del res
        torch.cuda.empty_cache()
    return out


# Phase 15: (preset, network.model_name override) of each context-head net;
# pspnet and ccnet have no preset and run through cityscapes_fcnet's recipe.
CONTEXT_NETS = (
    ("cityscapes_fcnet", None), ("cityscapes_fcnet_wo_dsn", None),
    ("cityscapes_spatial_ocrnet", None), ("cityscapes_spatial_asp_ocrnet", None),
    ("cityscapes_base_ocnet", None), ("cityscapes_asp_ocnet", None),
    ("cityscapes_isanet", None), ("cityscapes_pyramid_ocnet", None),
    ("cityscapes_fcnet", "pspnet"), ("cityscapes_fcnet", "ccnet"),
    ("pascal_context_hrnet_w48_isa", None))
def write_pascal_context(root: Path, n_train: int = 16, n_val: int = 4, seed: int = 0,
                         sizes=((375, 500), (500, 375)), classes: int = 60,
                         sidecars: bool = True, filters=(0,)) -> None:
    """A Pascal-Context-layout tree, {root}/{split}/image|label/*.png, each
    PNG beside its ``.npy_cache`` sidecar (none with ``sidecars`` False),
    its rows cycling through ``filters``: frames of VOC's sizes, 500x375
    and 375x500 in turn, labels 0-59 (0 the background, which the presets'
    ``reduce_zero_label`` turns into -1).  ``sizes`` and ``classes`` make
    the other datasets' trees (COCO-Stuff's 640x480 frames and labels
    0-171, LIP's person crops and its 20 parts)."""
    import numpy as np

    from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
    from contrastiveseg_tpu_torch.utils.png import encode_png

    scenes = [SyntheticSegDataset(classes, hw, n_train + n_val, seed=seed) for hw in sizes]
    for i in range(n_train + n_val):
        scene = scenes[i % len(sizes)][i]
        split = "train" if i < n_train else "val"
        for kind, array in (("image", scene["image"]), ("label", scene["label"].astype(np.uint8))):
            d = root / split / kind
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{i:04d}.png").write_bytes(encode_png(array, level=1, filters=filters))
            if sidecars:
                (d / ".npy_cache").mkdir(exist_ok=True)
                np.save(d / ".npy_cache" / f"{i:04d}.png.npy", array)


def head_losses(model, batch: dict, cfg) -> dict:
    """The preset's class-weighted CE of each head's logits (``seg``, and
    ``seg_aux`` where the net has one) on ``batch``, in eval mode (a
    train-mode forward would move the BN statistics of a saved state)."""
    import torch

    from contrastiveseg_tpu_torch.losses.ce import cross_entropy
    from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners

    params = cfg.get("loss.params", default={})
    with torch.no_grad():
        out = model.eval()(batch["image"])
        size = tuple(batch["label"].shape[1:3])
        losses = {k: float(cross_entropy(resize_bilinear_align_corners(v, size), batch["label"],
                                         params.get("ce_weight"),
                                         params.get("ce_ignore_index", -1)))
                  for k, v in out.items()}
    model.train()
    return losses


def reference_pth(model, path: Path) -> tuple[dict, int]:
    """Write ``model``'s ``state_dict`` as a reference segmentor ``.pth``
    (``{"state_dict"}`` with the DDP ``module.`` prefix) whose every conv
    that feeds a BN (``utils/pretrained.conv_bn_pairs``) carries a bias;
    returns the tensors a load must give (each such BN's running mean less
    its conv's bias) and the number of biases."""
    import torch

    from contrastiveseg_tpu_torch.utils.pretrained import conv_bn_pairs

    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    pairs = sorted(conv_bn_pairs(model).items())
    file, want = dict(sd), dict(sd)
    for i, (conv, bn) in enumerate(pairs):
        mean = sd[f"{bn}.running_mean"]
        bias = torch.linspace(-1, 1, mean.numel()) * (i + 1) / len(pairs)
        file[f"{conv}.bias"] = bias
        want[f"{bn}.running_mean"] = mean - bias
    torch.save({"state_dict": {f"module.{k}": v for k, v in file.items()}}, path)
    return want, len(pairs)


def train_fitting(cfg, device, name: str, say, batches=(16, 8), before=None) -> dict:
    """Train ``cfg`` (its ``solver.max_iters`` steps) at the first of
    ``batches`` (the preset's) that fits the card, calling ``before(trainer)``
    on each trainer before it trains; returns the trainer, the config run,
    the first batch (a copy), the history, launches and peak of
    ``train_phase``, and the failure at the preset's batch (the allocator's
    message) or None."""
    import gc

    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    failure = None
    for batch in batches:
        c = cfg.updated("train.batch_size", batch)
        trainer = Trainer(c, device)
        if before is not None:
            before(trainer)
        first, step = [], trainer.train_step

        def keep_first(state, b, step=step, first=first):
            if not first:
                first.append({k: v.clone() for k, v in b.items()})
            return step(state, b)

        trainer.train_step = keep_first
        try:
            history, launches, peak = train_phase(trainer, device, f"{name} at batch {batch}")
            return {"trainer": trainer, "cfg": c, "first": first[0], "history": history,
                    "launches": launches, "peak": peak, "failure": failure}
        except torch.cuda.OutOfMemoryError as err:
            if batch == batches[-1]:
                raise
            failure = failure or (f"{str(err).splitlines()[0]} (max_memory_allocated "
                                  f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB)")
            say(f"{name} at batch {batch} does not fit the card: {str(err).splitlines()[0]}; "
                f"trying batch {batches[batches.index(batch) + 1]}")
        del trainer, first, step, keep_first  # and the failed step's tensors with them
        gc.collect()
        torch.cuda.empty_cache()
    raise AssertionError("unreachable")


def run_context_phase(device) -> dict:
    """The context-head nets at full width: the eight Cityscapes presets
    on a deep-base ResNet-101 (dilated 8, 1024x512 crops), ``pspnet`` and
    ``ccnet`` through ``cityscapes_fcnet``'s recipe, and
    ``pascal_context_hrnet_w48_isa`` (520x520 crops, 59 classes) from a
    Pascal-Context-layout tree: 2 steps each at the preset's batch 16, or at
    8 where 16 does not fit the card (the allocator's message printed);
    each head's loss, the eval forward against the CPU's, 0 launches of
    K1-K3; ``latest`` of ``spatial_ocrnet`` and ``base_ocnet`` through
    ``--phase val`` and ``ss_test`` at batch 1 (1024x2048 frames), and of
    the ISA net through ``--phase val`` in ``diverse_size``; a reference
    ``.pth`` of each of the six reference layouts loaded bit for bit through
    ``network.pretrained`` (every conv bias before a BN folded), one step; a
    segmentor ``.pth`` refused for the four nets without a reference layout,
    and an ImageNet backbone loaded into each."""
    import gc

    import torch

    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[context phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    root = ROOT / "build" / "chip_smoke_context"
    shutil.rmtree(root, ignore_errors=True)
    cs_dir, pc_dir = root / "cityscapes", root / "pascal_context"
    write_dataset(cs_dir, 16, 4)
    write_pascal_context(pc_dir)
    say("wrote 16 train and 4 val frames of 1024x2048 (Cityscapes layout) and 16 + 4 frames "
        "of 500x375 and 375x500 (Pascal-Context layout), each PNG with its sidecar")
    results, total = {}, collections.Counter()

    def on_device(trainer, want: dict, what: str) -> None:
        got = trainer.state.model.state_dict()
        bad = [k for k, v in want.items() if not torch.equal(got[k], v.to(device))]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} tensors differ from the file's: {bad[:5]}")

    for preset, override in CONTEXT_NETS:
        pascal = preset.startswith("pascal_context")
        cfg = directory_config(preset, pc_dir if pascal else cs_dir,
                               root / "ckpt" / (override or preset),
                               [f"solver.max_iters={CUT_STEPS}"] + (
                                   [f"network.model_name={override}"] if override else []))
        name = cfg.get("network.model_name")
        want = (16, 59, "hrnet48") if pascal else (16, 19, "deepbase_resnet101_dilated8")
        got = (cfg.get("train.batch_size"), cfg.get("data.num_classes"),
               cfg.get("network.backbone"))
        if got != want:
            raise AssertionError(f"{name}: batch, classes, backbone {got}; want {want}")
        if pascal and (cfg.get("data.reduce_zero_label") is not True
                       or cfg.get("train_trans.random_crop.crop_size") != [520, 520]
                       or cfg.get("val.data_transformer.size_mode") != "diverse_size"):
            raise AssertionError(f"{preset}: not the preset's Pascal-Context recipe")
        if override:
            say(f"{name} has no preset: trained through {preset}'s recipe with "
                f"network.model_name={name}")
        run16 = train_fitting(cfg, device, name, say)
        trainer, c, first = run16["trainer"], run16["cfg"], run16["first"]
        history, launches, peak = run16["history"], run16["launches"], run16["peak"]
        batch, failure = c.get("train.batch_size"), run16["failure"]
        model = trainer.state.model
        n_params = sum(p.numel() for p in model.parameters())
        say(f"{name}: {type(model).__name__}, {n_params / 1e6:.2f} M parameters, "
            f"{c.get('loss.loss_type')}, batch {batch} of "
            f"{c.get('train_trans.random_crop.crop_size')} crops")
        no_launch(launches, name, total)
        heads = head_losses(model, first, c)
        if set(heads) != ({"seg"} if name == "fcnet_wo_dsn" else {"seg", "seg_aux"}) or not all(
                math.isfinite(v) and v > 0 for v in heads.values()):
            raise AssertionError(f"{name}: head losses {heads}")
        if not all(r["loss_seg"] > 0 for r in history):
            raise AssertionError(f"{name}: a seg loss is not positive: {history}")
        say(f"{name}: each head's CE on the first batch, eval mode: "
            + ", ".join(f"{k} {v:.6f}" for k, v in heads.items()))
        same_on_the_cpu(model, name, say)
        res = {"preset": preset, "batch": batch, "failure_at_16": failure, "history": history,
               "peak": peak, "params": n_params, "heads": heads}
        if name in ("spatial_ocrnet", "base_ocnet"):
            res.update(infer_from_latest(trainer, c, device, run, say))
            for phase in ("val", "ss_test"):
                no_launch(res[phase]["launches"], f"{name} {phase}", total)
        if pascal:
            val_cfg = c.updated("network.resume", trainer.ckpt._path("latest"))
            first_val = next(build_pipeline(val_cfg, "val").epoch_iter(0))
            if not isinstance(first_val["image"], list):
                raise AssertionError("the Pascal-Context val batches are not diverse_size")
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            t0 = time.perf_counter()
            scores = run(val_cfg, "val", device)["scores"]
            no_launch(read_counts(), f"{name} --phase val", total)
            if not 0.0 <= scores["miou"] <= 1.0:
                raise AssertionError(f"{name} --phase val gave no mIoU: {scores}")
            res["val"] = {"images_per_sec": scores["images_per_sec"], "miou": scores["miou"],
                          "peak": torch.cuda.max_memory_allocated(device),
                          "wall": time.perf_counter() - t0}
            say(f"{name} --phase val, diverse_size (4 frames, "
                f"{[tuple(x.shape[:2]) for x in first_val['image']]} after fit_stride 8, one "
                f"forward each): mIoU {scores['miou']:.6f}, {scores['images_per_sec']:.3f} "
                f"images/s, peak {res['val']['peak'] / 2**30:.3f} GiB")
        pth = root / f"{name}.pth"
        reference = type(model).reference_layout  # a reference segmentor loads into it
        if reference:
            want_sd, n_bias = reference_pth(model, pth)
        else:  # no reference layout: a segmentor file is refused, an ImageNet file loads
            torch.save({"backbone.resinit.conv1.weight": torch.zeros(1),
                        "cls.weight": torch.zeros(1)}, root / "segmentor.pth")
            try:
                load_pretrained(model, str(root / "segmentor.pth"))
                raise AssertionError(f"{name}: a segmentor .pth was not refused")
            except ValueError as err:
                if "no reference layout" not in str(err):
                    raise
                say(f"{name}: a segmentor .pth is refused: {err}")
            head = ({"fc.weight": torch.ones(1000, 2048), "fc.bias": torch.zeros(1000)}
                    if "hrnet" not in name else {"classifier.weight": torch.ones(1000, 2048)})
            want_sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                       if k.startswith("backbone.")}
            torch.save({**{k.removeprefix("backbone."): v for k, v in want_sd.items()}, **head},
                       pth)
        del trainer, model, first, run16
        gc.collect()
        torch.cuda.empty_cache()
        c1 = c.updated("network.pretrained", str(pth)).updated(
            "checkpoints.checkpoints_dir", str(root / "ckpt" / f"{name}_pth"))
        if reference:
            trainer = Trainer(c1.updated("train.batch_size", 2).updated("solver.max_iters", 1),
                              device)
            on_device(trainer, want_sd, f"{name} from its reference .pth")
            h, launches, _ = train_phase(trainer, device, f"{name} from its reference .pth")
            no_launch(launches, f"{name} from its .pth", total)
            say(f"{name}: a reference .pth ({pth.stat().st_size / 2**20:.1f} MiB, {n_bias} "
                f"conv biases folded into their BN) loads through network.pretrained, "
                f"{len(want_sd)} tensors equal bit for bit on the device; one step at batch 2, "
                f"loss {h[0]['loss']:.6f}")
            res["pth"] = {"tensors": len(want_sd), "biases": n_bias, "loss": h[0]["loss"]}
        else:
            trainer = Trainer(c1, device)
            on_device(trainer, want_sd, f"{name} from an ImageNet .pth")
            say(f"{name}: an ImageNet backbone .pth ({pth.stat().st_size / 2**20:.1f} MiB, "
                f"{len(want_sd)} backbone tensors and the classifier's) loads through "
                "network.pretrained bit for bit on the device")
            res["pth"] = {"tensors": len(want_sd)}
        results[name] = res
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        pth.unlink()
    shutil.rmtree(root, ignore_errors=True)
    results["launches"] = dict(total)
    return results


# Phase 16: the presets this slice ports, and what runs them.
FILTERS = (0, 1, 2, 3, 4)  # every PNG row filter, in turn, in the raw trees
IDEAL_NETS = ("cityscapes_ideal_spatial_ocrnet", "cityscapes_ideal_gather_ocrnet",
              "cityscapes_ideal_distribute_ocrnet")
IDEAL_BG_NETS = ("cityscapes_ideal_spatial_ocrnet_b", "cityscapes_ideal_spatial_ocrnet_c")
RMI_NETS = ("pascal_context_hrnet_w48_ocr_rmi", "coco_stuff_hrnet_w48_ocr_rmi")
LIP_NETS = ("lip_hrnet_w48", "lip_hrnet_w48_isa", "lip_hrnet_w48_ocr", "lip_hrnet_w48_ocr_b",
            "lip_ce2p_ocrnet", "lip_ce2p_ideal_ocrnet")


def decode_ms(paths, rgb: bool) -> list[float]:
    """Milliseconds of ``data/datasets.decode_frame`` on each file."""
    from contrastiveseg_tpu_torch.data.datasets import decode_frame

    out = []
    for path in paths:
        t0 = time.perf_counter()
        decode_frame(str(path), rgb=rgb)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_raw_headline(device, root: Path, say) -> dict:
    """The headline at batch 8 from a Cityscapes tree of raw PNGs (no
    sidecars, every row filter), with PIL unimportable; then the sidecar
    tool on the tree."""
    import numpy as np
    import torch

    from contrastiveseg_tpu_torch.data import native
    from contrastiveseg_tpu_torch.data.datasets import decode_frame
    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
    from tools import cache_dataset_torch

    t0 = time.perf_counter()
    write_dataset(root, 8, 4, sidecars=False, filters=FILTERS)
    if list(root.rglob(".npy_cache")):
        raise AssertionError("the raw tree has sidecars")
    say(f"wrote 8 train and 4 val frames of 1024x2048 as raw PNGs, rows cycling through filters "
        f"{FILTERS}, no sidecars, in {time.perf_counter() - t0:.1f} s")
    # PIL unimportable while the phase reads the tree: an import of it raises.
    with pil_unimportable() as (installed, loaded):
        fallbacks = native.PNG_LIBRARY.fallbacks
        images = sorted(root.glob("*/image/*.png"))
        labels = sorted(root.glob("*/label/*.png"))
        ms_image, ms_label = decode_ms(images, True), decode_ms(labels, False)
        cfg = directory_config("cityscapes_hrnet_w48_mem", root, root / "ckpt", [
            "contrast.warmup_iters=0", f"solver.max_iters={CUT_STEPS}", "val.batch_size=2"])
        if (cfg.get("train.batch_size"), cfg.get("train_trans.random_crop.crop_size"),
                cfg.get("data.workers")) != (8, [1024, 512], 1):
            raise AssertionError("the raw headline must run the recipe's batch 8, crop and "
                                 "worker")
        trainer = Trainer(cfg, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        history = trainer.train()
        torch.cuda.synchronize()
        launches, peak = read_counts(), torch.cuda.max_memory_allocated(device)
        check_history(history, launches, {n: CUT_STEPS for n in k1.KERNELS},
                      "headline from raw PNGs")
        if any(launches[n] for n in ("conv3x3_fwd", "conv3x3_dw", "fused_block")):
            raise AssertionError(f"the raw headline launched K2 or K3: {launches}")
        scores = trainer.validate()
        if not 0.0 <= scores["miou"] <= 1.0:
            raise AssertionError(f"raw headline validation gave no mIoU: {scores}")
        host_s = {w: pipeline_seconds(cfg, w) for w in (1, 4)}
        route = native.PNG_LIBRARY.route()
        if native.PNG_LIBRARY.fallbacks != fallbacks or Path(route).parent != (
                ROOT / "build" / "pngunfilter"):
            raise AssertionError(f"the PNG unfilter came from {route} with "
                                 f"{native.PNG_LIBRARY.fallbacks - fallbacks} Python fallbacks")
    steps = history[1:]
    say(f"PNG unfilter: {Path(route).relative_to(ROOT)}, 0 Python fallbacks; PIL (installed: "
        f"{installed}, loaded before the phase: {loaded}) unimportable while the tree was "
        "read, trained on and validated")
    say(f"native decode (zlib + unfilter) of a 1024x2048 frame: RGB image median "
        f"{statistics.median(ms_image):.1f} ms (min {min(ms_image):.1f}, max {max(ms_image):.1f}), "
        f"label median {statistics.median(ms_label):.1f} ms, on the host")
    say(f"headline from raw PNGs at batch 8: steps after the first "
        f"{[round(r['seconds'] * 1e3, 1) for r in steps]} ms, data wait "
        f"{[round(r['data_seconds'] * 1e3, 1) for r in steps]} ms (step 1: "
        f"{history[0]['seconds'] * 1e3:.1f} ms, data wait {history[0]['data_seconds'] * 1e3:.1f}"
        f" ms); pipeline alone {host_s[1]:.3f} s a batch at 1 worker, {host_s[4]:.3f} s at 4; "
        f"peak {peak / 2**30:.3f} GiB; validation (4 frames, val.batch_size=2 for the preset's 4, "
        f"whose cuDNN pick is FFT) mIoU {scores['miou']:.4f}, "
        f"{scores['images_per_sec']:.3f} images/s")
    del trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cache_dataset_torch.main(["--root", str(root), "--splits", "train,val"])
    n = 0
    for path in images + labels:
        sidecar = path.parent / ".npy_cache" / f"{path.name}.npy"
        got, want = np.load(sidecar), decode_frame(str(path), rgb=path.parent.name == "image")
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{sidecar} differs from the decoded frame")
        n += 1
    say(f"tools/cache_dataset_torch.py wrote {n} sidecars in {time.perf_counter() - t0:.1f} s, "
        "each equal to its decoded frame (value, dtype, shape)")
    return {"history": history, "launches": launches, "peak": peak, "scores": scores,
            "host_seconds": host_s, "decode_ms_image": statistics.median(ms_image),
            "decode_ms_label": statistics.median(ms_label)}


def run_raw_phase(device) -> dict:
    """Phase 16: the headline from raw PNGs (``run_raw_headline``), then the
    nets and losses this slice ports, each from a raw PNG tree of its
    preset's layout and classes, 2 steps at the preset's batch (or the
    largest that fits, after the allocator's message): the oracle OCR nets
    (and the two ``use_bg`` ones failing at their first forward, as in the
    JAX trainer), HRNet-W48 + OCR with ``fs_aux_rmi_loss`` on Pascal-Context
    and COCO-Stuff, and the six LIP presets (``lip_hrnet_w48_ocr`` also
    through ``--phase val`` with its flip average and L/R swap)."""
    import gc

    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[raw phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    root = ROOT / "build" / "chip_smoke_raw"
    shutil.rmtree(root, ignore_errors=True)
    total = collections.Counter()
    headline = run_raw_headline(device, root / "headline", say)
    total.update(headline["launches"])
    trees = {"cityscapes": root / "cityscapes", "pascal_context": root / "pascal_context",
             "coco_stuff": root / "coco_stuff", "lip": root / "lip"}
    t0 = time.perf_counter()
    write_dataset(trees["cityscapes"], 16, 4, sidecars=False, filters=FILTERS)
    write_pascal_context(trees["pascal_context"], 16, 4, sidecars=False, filters=FILTERS)
    write_pascal_context(trees["coco_stuff"], 16, 4, sizes=((480, 640), (640, 480)),
                         classes=172, sidecars=False, filters=FILTERS)
    write_pascal_context(trees["lip"], 32, 4, sizes=((320, 240), (240, 320)), classes=20,
                         sidecars=False, filters=FILTERS)
    say(f"wrote raw PNG trees (no sidecars) in {time.perf_counter() - t0:.1f} s: Cityscapes "
        "16 + 4 frames of 1024x2048; Pascal-Context 16 + 4 of 500x375 and 375x500, labels "
        "0-59; COCO-Stuff 16 + 4 of 640x480 and 480x640, labels 0-171; LIP 32 + 4 of 240x320 "
        "and 320x240, labels 0-19")
    results = {}
    want = {"cityscapes": (16, 19, [1024, 512]), "pascal_context": (16, 59, [520, 520]),
            "coco_stuff": (16, 171, [520, 520]), "lip": (32, 20, [473, 473])}
    for preset in IDEAL_NETS + IDEAL_BG_NETS + RMI_NETS + LIP_NETS:
        dataset = preset.split("_")[0] if not preset.startswith(("pascal", "coco")) else (
            "pascal_context" if preset.startswith("pascal") else "coco_stuff")
        cfg = directory_config(preset, trees[dataset], root / "ckpt" / preset,
                               [f"solver.max_iters={CUT_STEPS}"])
        name = cfg.get("network.model_name")
        got = (cfg.get("train.batch_size"), cfg.get("data.num_classes"),
               cfg.get("train_trans.random_crop.crop_size"))
        if got != want[dataset]:
            raise AssertionError(f"{preset}: batch, classes, crop {got}; want {want[dataset]}")
        if preset in IDEAL_BG_NETS:  # its first forward raises: batch 2 reads less of the tree
            trainer = Trainer(cfg.updated("train.batch_size", 2), device)
            try:
                trainer.train()
                raise AssertionError(f"{preset} trained without ground-truth labels")
            except ValueError as err:
                if "needs gt_labels" not in str(err):
                    raise
                say(f"{preset}: {type(trainer.state.model).__name__} "
                    f"({trainer.state.model.variant}) built; its first forward raises, as the "
                    f"JAX trainer's init fails: {err}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            results[preset] = {"raises": True}
            continue
        batches = (32, 16, 8) if dataset == "lip" else (16, 8)
        fit = train_fitting(cfg, device, preset, say, batches=batches)
        trainer, c, history = fit["trainer"], fit["cfg"], fit["history"]
        no_launch(fit["launches"], preset, total)
        # A CE is positive; the RMI bound is a sum of log-determinants, often negative.
        if "rmi" not in c.get("loss.loss_type") and not all(r["loss_seg"] > 0 for r in history):
            raise AssertionError(f"{preset}: a seg loss is not positive: {history}")
        model = trainer.state.model
        n_params = sum(p.numel() for p in model.parameters())
        steps = history[1:]
        res = {"batch": c.get("train.batch_size"), "failure": fit["failure"],
               "history": history, "peak": fit["peak"], "params": n_params,
               "loss_type": c.get("loss.loss_type"), "model": type(model).__name__}
        say(f"{preset} ({name}, {res['model']}, {n_params / 1e6:.2f} M, {res['loss_type']}) at "
            f"batch {res['batch']} of {c.get('train_trans.random_crop.crop_size')} crops: steps "
            f"after the first {[round(r['seconds'] * 1e3, 1) for r in steps]} ms, data wait "
            f"{[round(r['data_seconds'] * 1e3, 1) for r in steps]} ms, peak "
            f"{fit['peak'] / 2**30:.3f} GiB, 0 launches of K1-K3"
            + (f" (at its batch {want[dataset][0]}: {fit['failure']})" if fit["failure"] else ""))
        if preset == "lip_hrnet_w48_ocr":
            vc = c.updated("network.resume", trainer.ckpt._path("latest")).updated(
                "val.batch_size", 1)
            torch.cuda.reset_peak_memory_stats(device)
            reset_counts()
            t0 = time.perf_counter()
            out = run(vc, "val", device)
            no_launch(read_counts(), f"{preset} --phase val", total)
            ev, scores = out["trainer"].evaluator, out["scores"]
            if not (ev.flip_average and ev.flip_pairs == [(14, 15), (16, 17), (18, 19)]
                    and 0.0 <= scores["miou"] <= 1.0):
                raise AssertionError(f"{preset} --phase val: flip {ev.flip_average}, pairs "
                                     f"{ev.flip_pairs}, scores {scores}")
            res["val"] = {"images_per_sec": scores["images_per_sec"], "miou": scores["miou"],
                          "peak": torch.cuda.max_memory_allocated(device),
                          "wall": time.perf_counter() - t0}
            say(f"{preset} --phase val (4 frames padded to the preset's 2048x1024, "
                f"val.batch_size=1 for the preset's 4, flip average with the L/R swap of "
                f"{ev.flip_pairs}): mIoU {scores['miou']:.6f}, {scores['images_per_sec']:.3f} "
                f"images/s, peak {res['val']['peak'] / 2**30:.3f} GiB")
            del out, ev
        results[preset] = res
        del trainer, model, fit
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return {"headline": headline, "nets": results, "launches": dict(total)}


SEGFIX_PRESETS = ("cityscapes_segfix_hrnet", "cityscapes_segfix_hrnet2x")
SEGFIX_HW = (1024, 2048)  # the phase's frames, Cityscapes' size
# Phase 17 validates at batch 2, not the presets' 4: at 4 cuDNN picks FFT
# convolutions for the W48 trunk, 18.4-25.0 s a batch of 1024x2048 frames
# (PERF.md section 5), which phase 19 needs the time of.
SEGFIX_VAL_BATCH = 2


def segfix_pth(cfg, path: Path) -> dict:
    """A seeded, randomly initialised offset net of ``cfg`` written as a
    reference SegFix_HRNet ``.pth`` (``{"state_dict"}``, ``module.``
    prefix); returns its tensors."""
    import torch

    from contrastiveseg_tpu_torch.engine.state import init_weights
    from contrastiveseg_tpu_torch.models.nets import build_model

    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(17))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return sd


def loaded_exactly(model, want: dict) -> bool:
    """Every tensor of ``model`` equal to ``want``'s (CPU tensors)."""
    import torch

    got = model.state_dict()
    return got.keys() == want.keys() and all(torch.equal(got[k].cpu(), want[k]) for k in want)


def run_segfix_phase(device) -> dict:
    """Phase 17: SegFix and ResNeSt.  For both offset nets, from a reference
    ``.pth`` of a seeded random-init net loaded strictly: ``--phase val``
    at the preset's batch 4 over 4 frames of 1024x2048 (the dt-offset
    loader computing each frame's targets on the host), ``--phase test``
    (``test_offset``) at batch ``TEST_BATCH``; ``--phase val`` of
    ``cityscapes_segfix_hrnet2x_inst`` from the 16-bit instance maps;
    ``tools/segfix_torch.py`` on the card and on the CPU; one forward and
    backward of each net with ``SegFixLoss`` at the preset's batch 16 of
    512x512; the train phase's ``ValueError``; 2 steps of
    ``cityscapes_resnest_fcn`` and one validation batch."""
    import gc

    import numpy as np
    import torch

    from contrastiveseg_tpu_torch.data.loaders_extra import compute_dt_targets
    from contrastiveseg_tpu_torch.engine.evaluator import SegFixEvaluator
    from contrastiveseg_tpu_torch.losses.segfix import SegFixLoss
    from contrastiveseg_tpu_torch.models.nets import build_model
    from contrastiveseg_tpu_torch.utils.png import read_png
    from tools import segfix_torch
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[segfix phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    root = ROOT / "build" / "chip_smoke_segfix"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    hw = SEGFIX_HW
    write_dataset(root, 16, 4, hw=hw, instances=True)
    say(f"wrote 16 train and 4 val frames of {hw[0]}x{hw[1]} (PNG and .npy_cache) with 16-bit "
        f"instance maps, touching instances of one class, in {time.perf_counter() - t0:.1f} s")
    val_dir = root / "val" / "image"
    total = collections.Counter()
    res: dict = {"nets": {}}

    from contrastiveseg_tpu_torch.data.datasets import build_dataset

    plain = build_dataset(directory_config(SEGFIX_PRESETS[0], root, root, [
        "data.loader=default"]), "val")
    compute_dt_targets(plain[0]["label"][:64, :64])  # imports scipy.ndimage
    dt_s = []
    for i in range(len(plain)):
        label = plain[i]["label"]
        t0 = time.perf_counter()
        compute_dt_targets(label)
        dt_s.append(time.perf_counter() - t0)
    res["dt_seconds"] = dt_s
    say(f"compute_dt_targets on the host: {[round(t, 3) for t in dt_s]} s a {hw[0]}x{hw[1]} frame "
        f"(mean {statistics.mean(dt_s):.3f} s)")

    for preset in SEGFIX_PRESETS:
        name = preset.removeprefix("cityscapes_")
        cfg = directory_config(preset, root, root / "ckpt" / name, [
            f"test.test_dir={val_dir}", f"test.out_dir={root / 'out' / name}",
            f"test.batch_size={TEST_BATCH}"])
        got = (cfg.get("val.batch_size"), cfg.get("data.loader"), cfg.get("network.model_name"))
        if got != (4, "dt_offset", "segfix_hrnet"):
            raise AssertionError(f"{preset}: val batch, loader, net {got}")
        pth = root / f"{name}.pth"
        want = segfix_pth(cfg, pth)
        cfg = cfg.updated("val.batch_size", SEGFIX_VAL_BATCH)
        vc = cfg.updated("network.pretrained", str(pth))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        out = run(vc, "val", device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        no_launch(read_counts(), f"{preset} --phase val", total)
        trainer, scores = out["trainer"], out["scores"]
        model = trainer.state.model
        if not loaded_exactly(model, want):
            raise AssertionError(f"{preset}: the .pth did not load bit for bit")
        ev = trainer.evaluator
        keys = ("mask_acc", "dir_acc_mask", "dir_acc_gt")
        if not (isinstance(ev, SegFixEvaluator) and all(0.0 <= scores[k] <= 1.0 for k in keys)
                and scores["miou"] == scores["dir_acc_gt"]):
            raise AssertionError(f"{preset} --phase val: {type(ev).__name__}, {scores}")
        peak_val = torch.cuda.max_memory_allocated(device)
        b = SEGFIX_VAL_BATCH
        images = torch.zeros((b, *hw, 3), device=device)
        model.eval()
        ev.predict(images, hw)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.predict(images, hw)
        torch.cuda.synchronize()
        model_s = time.perf_counter() - t0
        model.train()
        del images
        n_params = sum(p.numel() for p in model.parameters())
        r = {"params": n_params, "scores": {k: scores[k] for k in keys},
             "images_per_sec": scores["images_per_sec"], "val_batch_seconds": b / scores[
                 "images_per_sec"], "val_wall": wall, "model_seconds_batch": model_s,
             "peak_val": peak_val, "backbone": type(model.backbone).__name__}
        say(f"{preset} ({r['backbone']}, {n_params / 1e6:.2f} M) from a reference .pth, loaded "
            f"bit for bit: --phase val at batch {b} (the preset's 4; 4 frames of "
            f"{hw[0]}x{hw[1]}): mask_acc "
            f"{scores['mask_acc']:.6f}, dir_acc_mask {scores['dir_acc_mask']:.6f}, "
            f"dir_acc_gt {scores['dir_acc_gt']:.6f} (= miou), {scores['images_per_sec']:.3f} "
            f"images/s, {r['val_batch_seconds']:.3f} s a val batch; the model's forward, "
            f"resize and argmax on a batch of {b} alone {model_s:.3f} s "
            f"({100 * model_s / r['val_batch_seconds']:.1f}% of the batch); peak "
            f"{peak_val / 2**30:.3f} GiB; phase wall {wall:.1f} s")
        del out, trainer, model, ev
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        out = run(vc, "test", device)
        torch.cuda.synchronize()
        no_launch(read_counts(), f"{preset} --phase test", total)
        timing = out["tester"].timing
        files = sorted((root / "out" / name / "offset").glob("*.npz"))
        if timing["images"] != 4 or len(files) != 4:
            raise AssertionError(f"{preset} --phase test wrote {len(files)} offset files")
        for f in files:
            z = np.load(f)
            if not (z["mask"].shape == z["dir_label"].shape == hw
                    and z["mask"].dtype == np.uint8 and z["mask"].max() <= 1
                    and z["dir_label"].max() < 8):
                raise AssertionError(f"{f.name}: {z['mask'].shape} {z['dir_label'].max()}")
        r["test"] = {"seconds_image": timing["seconds"] / 4,
                     "infer_seconds_image": timing["infer_seconds"] / 4,
                     "peak": torch.cuda.max_memory_allocated(device),
                     "wall": time.perf_counter() - t0}
        say(f"{preset} --phase test (test_offset, batch {TEST_BATCH}): "
            f"{r['test']['seconds_image']:.3f} s an image ({r['test']['infer_seconds_image']:.3f}"
            f" s in the model, the resize to the frame's size and the copy), peak "
            f"{r['test']['peak'] / 2**30:.3f} GiB, 4 offset .npz files of {hw[0]}x{hw[1]}")
        res["nets"][preset] = r
        del out
        gc.collect()
        torch.cuda.empty_cache()

    # The instance-boundary ground truth of the _inst presets.
    cfg = directory_config("cityscapes_segfix_hrnet2x_inst", root, root / "ckpt" / "inst", [
        f"network.pretrained={root / 'segfix_hrnet2x.pth'}"])
    ds = build_dataset(cfg, "val")
    sample = ds[0]
    plain = compute_dt_targets(sample["label"])
    n_inst, n_plain = int((sample["mask_label"] == 1).sum()), int((plain["mask_label"] == 1).sum())
    if not (ds.boundary_source == "instance" and n_inst > n_plain):
        raise AssertionError(f"_inst: {ds.boundary_source}, {n_inst} vs {n_plain} boundary pixels")
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    out = run(cfg, "val", device)
    torch.cuda.synchronize()
    no_launch(read_counts(), "_inst --phase val", total)
    scores = out["scores"]
    res["inst"] = {"scores": {k: scores[k] for k in ("mask_acc", "dir_acc_mask", "dir_acc_gt")},
                   "images_per_sec": scores["images_per_sec"], "wall": time.perf_counter() - t0}
    say(f"cityscapes_segfix_hrnet2x_inst --phase val from the 16-bit instance maps ({n_inst} "
        f"boundary pixels in frame 0 against {n_plain} from its label): mask_acc "
        f"{scores['mask_acc']:.6f}, dir_acc_mask {scores['dir_acc_mask']:.6f}, dir_acc_gt "
        f"{scores['dir_acc_gt']:.6f}, {scores['images_per_sec']:.3f} images/s")
    del out, ds
    gc.collect()
    torch.cuda.empty_cache()

    # Refinement of the tree's val labels (raw ids) with hrnet48's offsets.
    offsets = root / "out" / "segfix_hrnet" / "offset"
    res["refine"] = {}
    for interp in ("nearest", "bilinear"):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = root / "refined" / f"{interp}_{dev}"
            t0 = time.perf_counter()
            n = segfix_torch.main([
                "--input_dir", str(root / "val" / "label"), "--offset_dir", str(offsets),
                "--out_dir", str(outs[dev]), "--dataset", "cityscapes", "--interp", interp,
                "--device", dev])
            res["refine"][f"{interp}_{dev}_seconds_image"] = (time.perf_counter() - t0) / n
        moved = 0
        for f in sorted(outs["cuda"].glob("*.png")):
            if f.read_bytes() != (outs["cpu"] / f.name).read_bytes():
                raise AssertionError(f"segfix_torch --interp {interp}: {f.name} differs "
                                     "between the card and the CPU")
            moved += int((read_png(f) != read_png(root / "val" / "label" / f.name)).sum())
        if not moved:
            raise AssertionError(f"segfix_torch --interp {interp} moved no pixel")
        res["refine"][f"{interp}_moved"] = moved
        say(f"tools/segfix_torch.py --interp {interp} --dataset cityscapes on 4 label PNGs of "
            f"{hw[0]}x{hw[1]}: the card's PNGs byte-identical to the CPU's; {moved} pixels "
            "relabelled; "
            f"{res['refine'][f'{interp}_cuda_seconds_image']:.3f} s an image on the card, "
            f"{res['refine'][f'{interp}_cpu_seconds_image']:.3f} on the CPU")

    # The loss at the preset's batch 16 of 512x512, with dict targets.
    rng = np.random.default_rng(0)
    res["loss"] = {}
    for preset in SEGFIX_PRESETS:
        cfg = directory_config(preset, root, root / "ckpt" / "loss", [])
        b, (cw, ch) = cfg.get("train.batch_size"), cfg.get("train_trans.random_crop.crop_size")
        if b != 16:
            raise AssertionError(f"{preset}: batch {b}, not the preset's 16")
        model = build_model(cfg).to(device).train()
        loss_fn = SegFixLoss()
        images = torch.randn((b, ch, cw, 3), device=device)
        mask = torch.from_numpy(rng.integers(-1, 2, (b, ch, cw))).to(device)
        targets = {"mask_label": mask, "dir_label": torch.where(
            mask == 1, torch.from_numpy(rng.integers(0, 8, (b, ch, cw))).to(device), -1)}
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            loss, metrics = loss_fn(model(images), targets)
            loss.backward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            model.zero_grad(set_to_none=True)
        no_launch(read_counts(), f"{preset} loss", total)
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{preset}: SegFixLoss {metrics}")
        peak = torch.cuda.max_memory_allocated(device)
        res["loss"][preset] = {"seconds": times, "peak": peak,
                               "loss": {k: float(v.detach()) for k, v in metrics.items()}}
        say(f"{preset}: forward + SegFixLoss + backward at batch 16 of {ch}x{cw} (dict "
            "targets): "
            f"{times[0] * 1e3:.1f} ms cold, {times[1] * 1e3:.1f} ms warm, peak "
            f"{peak / 2**30:.3f} GiB, loss_mask {res['loss'][preset]['loss']['loss_mask']:.4f} "
            f"loss_direction {res['loss'][preset]['loss']['loss_direction']:.4f}")
        del model, images, targets, loss, metrics
        gc.collect()
        torch.cuda.empty_cache()

    # The train phase fails as the JAX trainer does, with the port's ValueError.
    cfg = directory_config("cityscapes_segfix_hrnet", root, root / "ckpt" / "train", [
        "train.batch_size=2", "solver.max_iters=1"])
    t0 = time.perf_counter()
    try:
        run(cfg, "train", device)
        raise AssertionError("cityscapes_segfix_hrnet trained")
    except ValueError as err:
        if "label map alone" not in str(err):
            raise
        say(f"--phase train of cityscapes_segfix_hrnet (train.batch_size=2 for the preset's 16: "
            f"each frame's targets take the host {statistics.mean(dt_s):.1f} s) raised the "
            f"port's ValueError at its first step after {time.perf_counter() - t0:.1f} s: {err}")
    gc.collect()
    torch.cuda.empty_cache()

    # ResNeSt-101 FCN from the tree.
    cfg = directory_config("cityscapes_resnest_fcn", root, root / "ckpt" / "resnest",
                           [f"solver.max_iters={CUT_STEPS}"])
    if (cfg.get("network.backbone"), cfg.get("train.batch_size")) != (
            "deepbase_resnest101_dilated8", 16):
        raise AssertionError("cityscapes_resnest_fcn: not ResNeSt-101 at batch 16")
    fit = train_fitting(cfg, device, "cityscapes_resnest_fcn", say)
    no_launch(fit["launches"], "cityscapes_resnest_fcn", total)
    trainer, history = fit["trainer"], fit["history"]
    if not all(r["loss_seg"] > 0 for r in history):
        raise AssertionError(f"cityscapes_resnest_fcn: {history}")
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    scores = trainer.validate()
    no_launch(read_counts(), "cityscapes_resnest_fcn validation", total)
    if not 0.0 <= scores["miou"] <= 1.0:
        raise AssertionError(f"cityscapes_resnest_fcn validation: {scores}")
    model = trainer.state.model
    res["resnest"] = {"batch": fit["cfg"].get("train.batch_size"), "failure": fit["failure"],
                      "history": history, "peak": fit["peak"],
                      "params": sum(p.numel() for p in model.parameters()),
                      "val": {"miou": scores["miou"], "images_per_sec": scores["images_per_sec"],
                              "peak": torch.cuda.max_memory_allocated(device)}}
    steps = history[1:]
    say(f"cityscapes_resnest_fcn (FcnNet on ResNeSt-101, {res['resnest']['params'] / 1e6:.2f} M) "
        f"at batch {res['resnest']['batch']} of "
        f"{fit['cfg'].get('train_trans.random_crop.crop_size')} crops: steps after the first "
        f"{[round(r['seconds'] * 1e3, 1) for r in steps]} ms, data wait "
        f"{[round(r['data_seconds'] * 1e3, 1) for r in steps]} ms, peak "
        f"{fit['peak'] / 2**30:.3f} GiB"
        + (f" (at its batch 16: {fit['failure']})" if fit["failure"] else "")
        + f"; validation (4 frames of {hw[0]}x{hw[1]}, batch 4): mIoU {scores['miou']:.6f}, "
        f"{scores['images_per_sec']:.3f} images/s, peak "
        f"{res['resnest']['val']['peak'] / 2**30:.3f} GiB; 0 launches of K1-K3")
    del trainer, model, fit
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    res["launches"] = dict(total)
    return res


JPEG_FIXTURES = ROOT / "tests" / "data_torch_jpeg"
# The paper's four other datasets: (preset, tree, steps).
JPEG_PRESETS = (
    ("ade20k_hrnet_w48_contrast", "ade20k", 3), ("ade20k_hrnet_w48", "ade20k", 2),
    ("coco_stuff_hrnet_w48_contrast", "coco_stuff", 3), ("coco_stuff_hrnet_w48", "coco_stuff", 2),
    ("pascal_context_hrnet_w48_contrast", "pascal_context", 3),
    ("pascal_context_hrnet_w48", "pascal_context", 2),
    ("camvid_hrnet_w48_contrast", "camvid", 3))
# tree: label values 0..n-1 (0 the ignored class of reduce_zero_label), and
# the preset's classes.
JPEG_TREES = {"ade20k": (151, 150), "coco_stuff": (172, 171), "pascal_context": (60, 59),
              "camvid": (12, 12)}


@contextlib.contextmanager
def pil_unimportable():
    """A block in which an import of PIL raises (phases 16, 18 and 19 read
    their trees so); yields whether PIL is installed and whether it was
    loaded before, and fails if the block imported it."""
    import importlib.util
    import sys

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == "PIL"}
    installed = importlib.util.find_spec("PIL") is not None if not saved else True
    sys.modules["PIL"] = None
    try:
        yield installed, bool(saved)
        if sys.modules.get("PIL") is not None:
            raise AssertionError("the phase imported PIL")
    finally:
        sys.modules.pop("PIL", None)
        sys.modules.update(saved)


def write_jpeg_tree(root: Path, dataset: str, n_train: int = 16, n_val: int = 4,
                    seed: int = 0) -> list[str]:
    """A tree of ``dataset``'s layout, {root}/{split}/image/*.jpg and
    label/*.png, no sidecars: the frames are copies of the committed JPEG
    fixtures made for that dataset (``tests/data_torch_jpeg``, in turn), each
    label a synthetic scene of the frame's size written by ``utils/png.py``.
    Returns the fixtures used."""
    import numpy as np

    from contrastiveseg_tpu_torch.data.datasets import SyntheticSegDataset
    from contrastiveseg_tpu_torch.utils.png import encode_png

    files = json.loads((JPEG_FIXTURES / "manifest.json").read_text())["files"]
    frames = [n for n, f in files.items() if f["dataset"] == dataset]
    classes = JPEG_TREES[dataset][0]
    for i in range(n_train + n_val):
        name = frames[i % len(frames)]
        w, h = files[name]["size"]
        split = "train" if i < n_train else "val"
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        shutil.copyfile(JPEG_FIXTURES / name, root / split / "image" / f"{i:04d}.jpg")
        label = SyntheticSegDataset(classes, (h, w), 1, seed=seed + i)[0]["label"]
        (root / split / "label" / f"{i:04d}.png").write_bytes(
            encode_png(label.astype(np.uint8), level=1))
    return frames


def check_jpeg_fixtures(say) -> dict:
    """Every committed fixture through ``utils/jpeg.read_jpeg``, both
    readings equal to the manifest's digests of PIL's arrays; the decode ms
    of each (median of 5, RGB reading)."""
    import hashlib

    from contrastiveseg_tpu_torch.utils.jpeg import read_jpeg

    files = json.loads((JPEG_FIXTURES / "manifest.json").read_text())["files"]
    ms = {}
    for name, f in files.items():
        path = JPEG_FIXTURES / name
        for rgb, shape, digest in ((False, f["shape"], f["sha256"]),
                                   (True, f["shape_rgb"], f["sha256_rgb"])):
            a = read_jpeg(path, rgb=rgb)
            if (list(a.shape), str(a.dtype)) != (shape, "uint8") or hashlib.sha256(
                    a.tobytes()).hexdigest() != digest:
                raise AssertionError(f"{name} (rgb={rgb}): {a.shape} {a.dtype} differs from "
                                     "PIL's array in the manifest")
        ms[name] = statistics.median(decode_ms([path] * 5, True))
    say("native JPEG decode, every fixture equal to PIL's arrays (manifest SHA-256, both "
        "readings): " + "; ".join(
            f"{n} {files[n]['size'][0]}x{files[n]['size'][1]} {files[n]['mode']} "
            f"{ms[n]:.2f} ms ({ms[n] / (files[n]['size'][0] * files[n]['size'][1] / 1e6):.2f} ms "
            "a megapixel)" for n in files) + " on the host (median of 5)")
    return ms


def run_jpeg_phase(device) -> dict:
    """Phase 18: the paper's ADE20K, COCO-Stuff, Pascal-Context and CamVid
    rows from raw trees, with PIL unimportable: the JPEG fixtures through
    the native decoder against the manifest, then the seven presets (3 steps
    for a contrast preset, 2 for its plain twin, at the preset's batch 16 or
    8 where 16 does not fit), ``--phase val`` of the ADE20K and
    Pascal-Context contrast presets in ``diverse_size``, and the pipeline's
    host seconds for an ADE20K batch of 16 at 1 and 4 workers."""
    import gc

    import torch

    from contrastiveseg_tpu_torch.data import native
    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
    from contrastiveseg_tpu_torch.ops import contrast
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[jpeg phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    root = ROOT / "build" / "chip_smoke_jpeg"
    shutil.rmtree(root, ignore_errors=True)
    total, results = collections.Counter(), {}
    sample, anchors = contrast.hard_anchor_sample, []

    def counted(*args, **kwargs):  # each step's anchor rows, no sync
        out = sample(*args, **kwargs)
        anchors.append((out.valid.shape[0], out.valid.sum()))
        return out

    with pil_unimportable() as (installed, loaded):  # an import of PIL raises in the phase
        fallbacks = native.JPEG_LIBRARY.fallbacks
        decode = check_jpeg_fixtures(say)
        t0 = time.perf_counter()
        used = {d: write_jpeg_tree(root / d, d) for d in ("ade20k", "coco_stuff",
                                                          "pascal_context")}
        write_pascal_context(root / "camvid", 16, 4, sizes=((720, 960),),
                             classes=JPEG_TREES["camvid"][0], sidecars=False)
        say(f"wrote raw trees (no sidecars) in {time.perf_counter() - t0:.1f} s, 16 + 4 frames "
            f"each: ADE20K, COCO-Stuff and Pascal-Context JPEGs ({used}), labels 0-150, 0-171 "
            "and 0-59 as PNG; CamVid 960x720 PNG frames, labels 0-11")
        for preset, tree, steps in JPEG_PRESETS:
            contrastive = preset.endswith("_contrast")
            cfg = directory_config(preset, root / tree, root / "ckpt" / preset, [
                f"solver.max_iters={steps}"] + (["contrast.warmup_iters=0"] if contrastive else []))
            got = (cfg.get("data.num_classes"), cfg.get("train.batch_size"),
                   cfg.get("network.backbone"), cfg.get("loss.loss_type"))
            want = (JPEG_TREES[tree][1], 16, "hrnet48",
                    "contrast_ce_loss" if contrastive else "fs_ce_loss")
            if got != want:
                raise AssertionError(f"{preset}: classes, batch, backbone, loss {got}; "
                                     f"want {want}")
            anchors.clear()
            contrast.hard_anchor_sample = counted
            try:
                fit = train_fitting(cfg, device, preset, say)
            finally:
                contrast.hard_anchor_sample = sample
            trainer, c, history = fit["trainer"], fit["cfg"], fit["history"]
            no_launch(fit["launches"], preset, total)
            m = [(rows, int(valid)) for rows, valid in anchors[-len(history):]]
            if not all(r["loss_seg"] > 0 for r in history):
                raise AssertionError(f"{preset}: a seg loss is not positive: {history}")
            if contrastive and (len(anchors) < len(history) or not all(
                    r["loss_contrast"] > 0 and valid > 0 for r, (_, valid) in zip(history, m))):
                raise AssertionError(f"{preset}: no anchors or no contrast term: {history}, "
                                     f"M={m}")
            model = trainer.state.model
            res = {"batch": c.get("train.batch_size"), "failure": fit["failure"],
                   "history": history, "peak": fit["peak"], "anchors": m if contrastive else None,
                   "params": sum(p.numel() for p in model.parameters())}
            say(f"{preset} ({type(model).__name__}, {res['params'] / 1e6:.2f} M, "
                f"{c.get('loss.loss_type')}, {c.get('data.num_classes')} classes) at batch "
                f"{res['batch']} of {c.get('train_trans.random_crop.crop_size')} crops: steps "
                f"{[round(r['seconds'] * 1e3, 1) for r in history]} ms, data wait "
                f"{[round(r['data_seconds'] * 1e3, 1) for r in history]} ms, peak "
                f"{fit['peak'] / 2**30:.3f} GiB, 0 launches of K1-K3"
                + (f", contrast {[round(r['loss_contrast'], 4) for r in history]}, anchors "
                   f"(rows, M) {m}" if contrastive else "")
                + (f" (at its batch 16: {fit['failure']})" if fit["failure"] else ""))
            latest = trainer.ckpt._path("latest")
            del trainer, model, fit
            gc.collect()
            torch.cuda.empty_cache()
            if preset in ("ade20k_hrnet_w48_contrast", "pascal_context_hrnet_w48_contrast"):
                vc = c.updated("network.resume", latest)
                first_val = next(build_pipeline(vc, "val").epoch_iter(0))
                if not isinstance(first_val["image"], list):
                    raise AssertionError(f"{preset}: the val batches are not diverse_size")
                torch.cuda.reset_peak_memory_stats(device)
                reset_counts()
                t0 = time.perf_counter()
                scores = run(vc, "val", device)["scores"]
                no_launch(read_counts(), f"{preset} --phase val", total)
                if not math.isfinite(scores["miou"]):
                    raise AssertionError(f"{preset} --phase val gave no mIoU: {scores}")
                res["val"] = {"images_per_sec": scores["images_per_sec"], "miou": scores["miou"],
                              "peak": torch.cuda.max_memory_allocated(device),
                              "wall": time.perf_counter() - t0}
                say(f"{preset} --phase val, diverse_size (4 JPEG frames, "
                    f"{[tuple(x.shape[:2]) for x in first_val['image']]} after fit_stride 8, "
                    f"val.batch_size {vc.get('val.batch_size')}): mIoU {scores['miou']:.6f}, "
                    f"{scores['images_per_sec']:.3f} images/s, peak "
                    f"{res['val']['peak'] / 2**30:.3f} GiB, {res['val']['wall']:.1f} s")
            if preset == "ade20k_hrnet_w48_contrast":
                res["host_seconds"] = {w: pipeline_seconds(c, w) for w in (1, 4)}
                say(f"{preset}: the train pipeline alone, a batch of {c.get('train.batch_size')} "
                    f"from JPEG frames: {res['host_seconds'][1]:.3f} s at 1 worker, "
                    f"{res['host_seconds'][4]:.3f} s at 4")
            results[preset] = res
        route = native.JPEG_LIBRARY.route()
        if native.JPEG_LIBRARY.fallbacks != fallbacks or Path(route).parent != (
                ROOT / "build" / "jpegdecode"):
            raise AssertionError(f"the JPEG decoder came from {route} with "
                                 f"{native.JPEG_LIBRARY.fallbacks - fallbacks} fallbacks")
    say(f"JPEG decoder: {Path(route).relative_to(ROOT)}, 0 fallbacks; PIL (installed: "
        f"{installed}, loaded before the phase: {loaded}) unimportable while the fixtures "
        "were checked and the trees were read, trained on and validated")
    return {"decode_ms": decode, "nets": results, "launches": dict(total), "root": root}


# Phase 19: SETR's published Cityscapes crop, and the nets on each family.
SETR_CROP = 768
SETR_NETS = ("setr_pup", "setr_mla", "setr_naive")
FPN_BACKBONES = ("pvt_small", "svt_small")


def seeded_reference_pth(cfg, path: Path) -> tuple[dict, int]:
    """A seeded random-init net of ``cfg`` written by ``reference_pth`` (a
    bias on every conv that feeds a BN); returns the tensors a load must give
    and the number of biases."""
    import torch

    from contrastiveseg_tpu_torch.engine.state import init_weights
    from contrastiveseg_tpu_torch.models.nets import build_model

    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(17))
    return reference_pth(model, path)


def run_transformer_phase(device, data_dir: Path, jpeg_root: Path) -> dict:
    """Phase 19: the transformer and multi-scale families at full width,
    trained 2 steps, one net of each family started from a reference
    ``.pth`` of a seeded net (loaded bit for bit): ``ms_ocr`` on HRNet-W48 (``ms_fs_aux_rmi_loss``,
    batch 8 of 1024x512, else 4) from the Cityscapes tree, then ``--phase
    val`` at ``TEST_BATCH``; ``setr_pup``, ``setr_mla`` and ``setr_naive`` on
    ViT-L at 768x768 (batch 2, else 1), then ``setr_pup``'s ``sscrop_test``
    at 768x768 on a 1024x2048 frame; ``semantic_fpn`` on PVT-Small and
    SVT-Small with AdamW (SVT with a gradient clip) from the ADE20K JPEG
    tree, PIL unimportable (batch 16, else 8), then PVT-Small's ``--phase
    val`` in ``diverse_size``, which resizes its position tables."""
    import gc

    import torch

    from contrastiveseg_tpu_torch.models.vit import VIT_SPECS
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[transformer phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    root = ROOT / "build" / "chip_smoke_transformer"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total, results = collections.Counter(), {}

    def train(name, cfg, batches, extra_check=None, keep_latest=True, from_pth=False):
        """Train ``cfg`` at the first of ``batches`` that fits (with
        ``from_pth``, from the net's reference ``.pth``, held to load bit for
        bit), and hold the losses and the parameters; returns the fit and
        the result row."""
        src = "a seeded init"
        if from_pth:
            t0 = time.perf_counter()
            pth = root / f"{name}.pth"
            want, n_bias = seeded_reference_pth(cfg, pth)
            cfg = cfg.updated("network.pretrained", str(pth))
            src = (f"a reference .pth ({pth.stat().st_size / 2**20:.1f} MiB, {n_bias} conv biases "
                   f"folded, written in {time.perf_counter() - t0:.1f} s), every tensor loaded "
                   "bit for bit")
        loads, start = [], {}

        def before(trainer):
            model = trainer.state.model
            if from_pth:
                loads.append(loaded_exactly(model, want))
            start.update({k: p.detach().cpu().clone() for k, p in model.named_parameters()})
            if not keep_latest:  # the phase reads no checkpoint of it: skip the write
                trainer.ckpt.save = lambda *args, **kwargs: None
            if extra_check is not None:
                extra_check(trainer)

        fit = train_fitting(cfg, device, name, say, batches, before)
        no_launch(fit["launches"], name, total)
        if not all(loads):
            raise AssertionError(f"{name}: the reference .pth did not load bit for bit")
        model = fit["trainer"].state.model
        n_tensors = len(start)
        changed = sum(not torch.equal(p.detach().cpu(), start[k])
                      for k, p in model.named_parameters())
        n_params = sum(p.numel() for p in model.parameters())
        if changed < n_tensors // 2:  # (biases before a BN start at 0 and keep no gradient)
            raise AssertionError(f"{name}: {changed} of {n_tensors} parameters changed")
        res = {"batch": fit["cfg"].get("train.batch_size"), "failure": fit["failure"],
               "history": fit["history"], "peak": fit["peak"], "params": n_params}
        say(f"{name} ({type(model).__name__}, {n_params / 1e6:.2f} M, "
            f"{fit['cfg'].get('optim.optim_method')}, {fit['cfg'].get('loss.loss_type')}) from "
            f"{src}; at batch {res['batch']} of "
            f"{fit['cfg'].get('train_trans.random_crop.crop_size')} crops: steps "
            f"{[round(r['seconds'] * 1e3, 1) for r in fit['history']]} ms, data wait "
            f"{[round(r['data_seconds'] * 1e3, 1) for r in fit['history']]} ms, peak "
            f"{fit['peak'] / 2**30:.3f} GiB, {changed} of {n_tensors} parameters changed, 0 "
            "launches of K1-K3" + (f" (at its batch {batches[0]}: {fit['failure']})"
                                   if fit["failure"] else ""))
        return fit, res

    # (a) MscaleOCR on HRNet-W48: the trunk at 0.5x and 1.0x.
    cfg = directory_config("cityscapes_hrnet_w48_ocr", data_dir, root / "ckpt" / "ms_ocr", [
        "network.model_name=ms_ocr", "loss.loss_type=ms_fs_aux_rmi_loss",
        f"solver.max_iters={CUT_STEPS}"])
    if (cfg.get("train.batch_size"), cfg.get("network.backbone"),
            cfg.get("train_trans.random_crop.crop_size")) != (8, "hrnet48", [1024, 512]):
        raise AssertionError("ms_ocr: not HRNet-W48 at batch 8 of 1024x512")
    seen = {"bn_calls": 0, "shapes": None}

    def watch(trainer):
        model = trainer.state.model
        bn = next(m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
        seen["bn"], seen["bn_calls"] = bn, 0
        seen["mean0"] = bn.running_mean.clone()
        bn.register_forward_hook(lambda *a: seen.__setitem__("bn_calls", seen["bn_calls"] + 1))
        model.register_forward_hook(lambda m, i, o: seen.__setitem__("shapes", (
            tuple(i[0].shape), {k: tuple(v.shape) for k, v in o.items()})))

    fit, res = train("ms_ocr", cfg, (8, 4), watch, from_pth=True)
    (x_shape, shapes), steps = seen["shapes"], len(fit["history"])
    moved = not torch.equal(seen["bn"].running_mean, seen["mean0"])
    if (seen["bn_calls"] != 2 * steps or not moved
            or shapes["pred_05x"][1:3] != (x_shape[1] // 2, x_shape[2] // 2)
            or shapes["seg"][1:3] != x_shape[1:3]):
        raise AssertionError(f"ms_ocr: BN calls {seen['bn_calls']} in {steps} steps, moved "
                             f"{moved}, shapes {x_shape} -> {shapes}")
    say(f"ms_ocr: the stem BN ran {seen['bn_calls']} times in {steps} steps (the trunk at 0.5x "
        f"and 1.0x) and its running statistics moved; a {x_shape[1]}x{x_shape[2]} batch gives "
        f"pred_05x {shapes['pred_05x'][1:3]}, seg {shapes['seg'][1:3]}; loss_seg (RMI + aux) "
        f"{[round(r['loss_seg'], 4) for r in fit['history']]}, loss (+ 0.05 x the two scales' "
        f"CE) {[round(r['loss'], 4) for r in fit['history']]}")
    latest = fit["trainer"].ckpt._path("latest")
    c = fit["cfg"]
    del fit
    gc.collect()
    torch.cuda.empty_cache()
    vc = c.updated("network.resume", latest).updated("val.batch_size", TEST_BATCH)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    scores = run(vc, "val", device)["scores"]
    no_launch(read_counts(), "ms_ocr --phase val", total)
    if not 0.0 <= scores["miou"] <= 1.0:
        raise AssertionError(f"ms_ocr --phase val gave no mIoU: {scores}")
    res["val"] = {"miou": scores["miou"], "images_per_sec": scores["images_per_sec"],
                  "peak": torch.cuda.max_memory_allocated(device),
                  "wall": time.perf_counter() - t0}
    say(f"ms_ocr --phase val (4 frames of 1024x2048, batch {TEST_BATCH}): mIoU "
        f"{scores['miou']:.6f}, {scores['images_per_sec']:.3f} images/s, peak "
        f"{res['val']['peak'] / 2**30:.3f} GiB, wall {res['val']['wall']:.1f} s")
    results["ms_ocr"] = res
    shutil.rmtree(root / "ckpt", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) SETR on ViT-L at the published 768x768 Cityscapes crop.
    crop = f"[{SETR_CROP},{SETR_CROP}]"
    for name in SETR_NETS:
        cfg = directory_config("cityscapes_hrnet_w48", data_dir, root / "ckpt" / name, [
            f"network.model_name={name}", "network.backbone=vit_large",
            f"train.data_transformer.input_size={crop}",
            f"train_trans.random_crop.crop_size={crop}", f"solver.max_iters={CUT_STEPS}"])
        # setr_pup from its reference .pth, which its test below starts from too
        fit, res = train(name, cfg, (2, 1), keep_latest=False, from_pth=name == "setr_pup")
        model, vit_l = fit["trainer"].state.model, VIT_SPECS["vit_large"]
        if (model.spec, model.grid) != (vit_l, (SETR_CROP // vit_l.patch_size,) * 2):
            raise AssertionError(f"{name}: not ViT-L on the crop's grid")
        del fit, model
        gc.collect()
        torch.cuda.empty_cache()
        results[name] = res
    frame = root / "frame"
    frame.mkdir()
    src = sorted((data_dir / "val" / "image").glob("*.png"))[0]
    shutil.copyfile(src, frame / src.name)
    c = (cfg.updated("network.model_name", "setr_pup")
         .updated("network.pretrained", str(root / "setr_pup.pth"))
         .updated("test.mode", "sscrop_test").updated("test.crop_size", [SETR_CROP, SETR_CROP])
         .updated("test.batch_size", 1).updated("test.test_dir", str(frame))
         .updated("test.out_dir", str(root / "setr_test")))
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    tester = run(c, "test", device)["tester"]
    no_launch(read_counts(), "setr_pup sscrop_test", total)
    labels = list((root / "setr_test" / "label").glob("*.png"))
    if tester.timing["images"] != 1 or len(labels) != 1:
        raise AssertionError(f"setr_pup sscrop_test wrote {len(labels)} label PNGs")
    results["setr_pup"]["test"] = {"seconds": tester.timing["seconds"],
                                   "infer_seconds": tester.timing["infer_seconds"],
                                   "peak": torch.cuda.max_memory_allocated(device)}
    say(f"setr_pup --phase test sscrop_test (crops of {SETR_CROP}x{SETR_CROP}, the net's grid) "
        f"on one 1024x2048 frame: {tester.timing['seconds']:.3f} s ({tester.timing['infer_seconds']:.3f} s "
        f"in the model), peak {results['setr_pup']['test']['peak'] / 2**30:.3f} GiB, wall "
        f"{time.perf_counter() - t0:.1f} s; a 1024x2048 ss_test would raise: the position "
        "table is the crop's grid")
    del tester
    (root / "setr_pup.pth").unlink()
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Semantic-FPN on PVT-Small and Twins-SVT-Small, the PVT recipe's AdamW.
    with pil_unimportable() as (installed, loaded):
        for backbone in FPN_BACKBONES:
            extra = ["network.model_name=semantic_fpn", f"network.backbone={backbone}",
                     "optim.optim_method=adamw", "lr.base_lr=0.0001",
                     "optim.adamw.weight_decay=0.0001", f"solver.max_iters={CUT_STEPS}"]
            if backbone.startswith("svt"):
                extra.append("network.clip_grad_norm=1.0")
            cfg = directory_config("ade20k_hrnet_w48", jpeg_root / "ade20k",
                                   root / "ckpt" / backbone, extra)
            clips = []

            def count_clips(trainer, clip=cfg.get("network.clip_grad_norm", default=None)):
                if clip:  # the optimizer's pre-hook clips; count the steps whose norm it cut
                    params = list(trainer.state.model.parameters())
                    trainer.state.optimizer.register_step_pre_hook(lambda *a: clips.append(float(
                        torch.linalg.vector_norm(torch.stack([
                            torch.linalg.vector_norm(p.grad) for p in params])))))

            name = f"semantic_fpn/{backbone}"
            pvt = backbone == "pvt_small"
            fit, res = train(name.replace("/", "_"), cfg, (16, 8), count_clips,
                             keep_latest=pvt, from_pth=pvt)
            opt = fit["trainer"].state.optimizer
            if type(opt).__name__ != "AdamW" or (backbone.startswith("svt") and not (
                    len(clips) == len(fit["history"]) and all(n <= 1.0 + 1e-4 for n in clips))):
                raise AssertionError(f"{name}: {type(opt).__name__}, gradient norms after the "
                                     f"clip {clips}")
            if clips:
                say(f"{name}: network.clip_grad_norm=1.0 ran on the card each step, global norms "
                    f"after it {[round(n, 4) for n in clips]}")
            res["clip_norms"] = clips
            latest = fit["trainer"].ckpt._path("latest")
            c = fit["cfg"]
            del fit, opt
            gc.collect()
            torch.cuda.empty_cache()
            if pvt:
                vc = c.updated("network.resume", latest)
                torch.cuda.reset_peak_memory_stats(device)
                reset_counts()
                t0 = time.perf_counter()
                scores = run(vc, "val", device)["scores"]
                no_launch(read_counts(), f"{name} --phase val", total)
                if not 0.0 <= scores["miou"] <= 1.0:
                    raise AssertionError(f"{name} --phase val gave no mIoU: {scores}")
                res["val"] = {"miou": scores["miou"], "images_per_sec": scores["images_per_sec"],
                              "peak": torch.cuda.max_memory_allocated(device),
                              "wall": time.perf_counter() - t0}
                say(f"{name} --phase val, diverse_size (4 ADE20K JPEG frames, each at its own "
                    f"size: the position tables resized to its grids): mIoU {scores['miou']:.6f}, "
                    f"{scores['images_per_sec']:.3f} images/s, peak "
                    f"{res['val']['peak'] / 2**30:.3f} GiB, wall {res['val']['wall']:.1f} s")
            results[name] = res
    say(f"PIL (installed: {installed}, loaded before the phase: {loaded}) unimportable while the "
        "JPEG tree was read, trained on and validated")
    shutil.rmtree(root, ignore_errors=True)
    return {"nets": results, "launches": dict(total)}


def cudnn_sweep(tester, images, say=print) -> list[dict]:
    """Seconds an image of one ``ss_test`` call for each (scale, batch), on
    the host clock around a device sync.  Where cuDNN's heuristics pick FFT
    convolutions, a call is tens of times slower an image than at batch 1
    (``tools/profile_torch_step.py --eval --scale`` shows their kernels; the
    profiler takes minutes to parse one such call, so not here): at batch 4
    of 1.0 and batch 2 of 1.25 (5.2 and 9.1 s an image, PERF.md section 5),
    which the sweep no longer runs, to keep the script inside its time
    limit."""
    import torch

    rows = []
    for scale, batches in ((1.0, (1, 2)), (0.75, (1, 2)), (1.25, (1,))):
        base = None
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tester.ss_test(images[:b], scale)
            torch.cuda.synchronize()
            per_image = (time.perf_counter() - t0) / b
            base = base or per_image
            row = {"scale": scale, "batch": b, "seconds_an_image": per_image,
                   "vs_batch_1": per_image / base}
            rows.append(row)
            say(f"cuDNN sweep: ss_test at scale {scale}, batch {b} "
                f"({int(images.shape[1] * scale)}x{int(images.shape[2] * scale)}): "
                f"{per_image:.3f} s an image, {row['vs_batch_1']:.1f}x batch 1's")
    return rows


def run_test_phase(device, data_dir: Path, checkpoint: str) -> dict:
    """Inference with the directory slice's headline W48, restored through
    ``network.resume``: ``--phase val``, ``--phase test`` in four modes and
    with ``network.pallas_conv=true``, the official Cityscapes evaluator on
    the ``ss_test`` labels, the cuDNN sweep, then export and serving."""
    import importlib.util
    import io
    import sys
    import threading
    import urllib.request

    import numpy as np
    import torch

    from contrastiveseg_tpu_torch.data.datasets import CITYSCAPES_LABEL_LIST
    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
    from contrastiveseg_tpu_torch.metrics.cityscapes_official import evaluate_dirs, find_pairs
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
    from contrastiveseg_tpu_torch.utils.png import read_png
    from tools.export_torch import export_artifact
    from tools.serve_torch import make_server
    from tools.train_torch import run

    t_phase = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[test phase +{time.perf_counter() - t_phase:.1f} s] {msg}", flush=True)

    pil_loaded = "PIL.Image" in sys.modules
    out_root = ROOT / "build" / "chip_smoke_test"
    shutil.rmtree(out_root, ignore_errors=True)
    cfg = directory_config("cityscapes_hrnet_w48_mem", data_dir,
                           ROOT / "build" / "chip_smoke_ckpt" / "test", [
                               f"network.resume={checkpoint}",
                               f"val.batch_size={TEST_BATCH}", f"test.batch_size={TEST_BATCH}",
                               f"test.test_dir={data_dir / 'val' / 'image'}",
                               "test.crop_size=[1024,512]"])
    say(f"val.batch_size and test.batch_size {TEST_BATCH} (at the preset's 4, and at 2 for "
        "ms_test's 1.25 scale, cuDNN picks FFT convolutions, PERF.md section 5)")

    def measured(c, phase):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        out = run(c, phase, device)
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
        out["peak"] = torch.cuda.max_memory_allocated(device)
        out["launches"] = read_counts()
        if any(out["launches"][n] for n in k1.KERNELS):
            raise AssertionError(f"--phase {phase} launched K1: {out['launches']}")
        return out

    val = measured(cfg, "val")
    scores = val["scores"]
    conf_val = val["trainer"].evaluator.score.confusion.copy()
    if not 0.0 <= scores["miou"] <= 1.0 or conf_val.sum() == 0:
        raise AssertionError(f"--phase val gave no scores: {scores}")
    say(f"--phase val (4 frames of 1024x2048, batch {TEST_BATCH}, restored at step "
          f"{val['trainer'].state.step}): mIoU {scores['miou']:.6f}, pixel_acc "
          f"{scores['pixel_acc']:.6f}, {scores['images_per_sec']:.3f} images/s, peak "
          f"{val['peak'] / 2**30:.3f} GiB, phase wall {val['wall']:.1f} s")
    del val

    modes, keep = {}, {}
    for mode in ("ss_test", "ms_test", "sscrop_test", "mscrop_test"):
        c = cfg.updated("test.mode", mode).updated("test.out_dir", str(out_root / mode))
        out = measured(c, "test")
        timing, n = out["tester"].timing, out["tester"].timing["images"]
        pngs = {d: len(list((out_root / mode / d).glob("*.png"))) for d in ("label", "vis")}
        if n != 4 or pngs != {"label": 4, "vis": 4}:
            raise AssertionError(f"{mode}: {n} images, PNGs {pngs}; expected 4 of each")
        modes[mode] = {"seconds_an_image": timing["seconds"] / n,
                       "infer_seconds_an_image": timing["infer_seconds"] / n,
                       "peak": out["peak"], "pngs": sum(pngs.values()), "wall": out["wall"]}
        say(f"--phase test {mode}: {timing['seconds'] / n:.3f} s an image "
              f"({timing['infer_seconds'] / n:.3f} s in the model and fusion, the rest writing "
              f"PNGs), peak {out['peak'] / 2**30:.3f} GiB, {sum(pngs.values())} PNGs written "
              f"(label/ and vis/), phase wall {out['wall']:.1f} s")
        if mode == "ss_test":
            keep = out
        else:
            del out
        torch.cuda.empty_cache()

    # The official evaluator on the ss_test labels against validate().
    label_dir, gt_dir = out_root / "ss_test" / "label", data_dir / "gtFine" / "val"
    if len(find_pairs(str(label_dir), str(gt_dir))) != 4:
        raise AssertionError("the official evaluator did not pair 4 predictions")
    res = evaluate_dirs(str(label_dir), str(gt_dir))
    ids = np.asarray(CITYSCAPES_LABEL_LIST)
    conf_official = res["confMatrix"][np.ix_(ids, ids)].astype(np.int64)
    miou_official = res["averageScoreClasses"]
    if not np.array_equal(conf_official, conf_val) or abs(miou_official - scores["miou"]) > 1e-6:
        raise AssertionError(
            f"the official evaluator disagrees with validate(): mIoU {miou_official} vs "
            f"{scores['miou']}, confusion entries off by {np.abs(conf_official - conf_val).sum()}")
    say(f"official Cityscapes evaluator on the ss_test label PNGs: the 19x19 confusion equals "
          f"validate()'s ({int(conf_val.sum())} pixels); mIoU {miou_official:.6f} vs "
          f"{scores['miou']:.6f}; iIoU {res['averageScoreInstClasses']:.6f}, categories "
          f"{res['averageScoreCategories']:.6f}, pixel accuracy {res['pixelAccuracy']:.6f}")

    # ss_test with K2a on branch 0, against the flag-off logits.
    c = (cfg.updated("network.pallas_conv", True).updated("test.mode", "ss_test")
         .updated("test.out_dir", str(out_root / "ss_test_pallas_conv")))
    on = measured(c, "test")
    launches = on["launches"]
    if launches["conv3x3_fwd"] < 1 or launches["conv3x3_dw"] or launches["fused_block"]:
        raise AssertionError(f"the flag-on ss_test launched {launches}; expected K2a only")
    batch = next(build_pipeline(cfg, "test").epoch_iter(0))
    images = torch.from_numpy(batch["image"]).to(device)
    off_logits = keep["tester"].infer(images)
    on_logits = on["tester"].infer(images)
    rel = float((on_logits - off_logits).norm() / off_logits.norm())
    same = float((on_logits.argmax(-1) == off_logits.argmax(-1)).float().mean())
    if not rel <= 1e-3:
        raise AssertionError(f"flag-on ss_test logits are {rel:.3e} from flag-off in relative L2")
    timing = on["tester"].timing
    modes["ss_test_pallas_conv"] = {"seconds_an_image": timing["seconds"] / 4,
                                    "infer_seconds_an_image": timing["infer_seconds"] / 4,
                                    "peak": on["peak"], "pngs": 8, "wall": on["wall"]}
    say(f"ss_test with network.pallas_conv=true: K2a launched "
          f"{launches['conv3x3_fwd']} times; {timing['seconds'] / 4:.3f} s an image "
          f"({timing['infer_seconds'] / 4:.3f} s in the model), peak {on['peak'] / 2**30:.3f} GiB; "
          f"logits {rel:.3e} from flag-off in relative L2 (bound 1e-3), argmax equal on "
          f"{same:.6f} of the pixels")
    del on
    torch.cuda.empty_cache()

    full = torch.from_numpy(next(build_pipeline(cfg.updated("test.batch_size", 2), "test")
                                 .epoch_iter(0))["image"]).to(device)
    sweep = cudnn_sweep(keep["tester"], full, say)
    hw = tuple(full.shape[1:3])
    del full, images, off_logits, on_logits

    # Export the same model and serve it.
    art = out_root / "w48_ss"
    t0 = time.perf_counter()
    export_artifact(cfg, str(art), "ss", hw, 1, False, checkpoint, str(device))
    export_s = time.perf_counter() - t0
    size = (art.parent / "w48_ss.pt2").stat().st_size
    say(f"export: --scope ss, batch 1, {hw[0]}x{hw[1]}: {size / 2**20:.1f} MiB in "
          f"{export_s:.1f} s")
    t0 = time.perf_counter()
    httpd = make_server(str(art), 0)
    load_s = time.perf_counter() - t0
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    latencies, shares = [], []
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.load(r)
        if health.get("status") != "ok" or health["input"]["shape"] != [1, *hw, 3]:
            raise AssertionError(f"/healthz: {health}")
        for path in sorted((data_dir / "val" / "image").glob("*.png")):
            frame = np.load(path.parent / ".npy_cache" / (path.name + ".npy"))
            buf = io.BytesIO()
            np.save(buf, frame)
            req = urllib.request.Request(url + "/segment", data=buf.getvalue(),
                                         headers={"Content-Type": "application/x-npy"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                labels = np.load(io.BytesIO(r.read()))
            latencies.append(time.perf_counter() - t0)
            want = read_png(label_dir / path.name)
            shares.append(float((ids[labels] == want).mean()))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    say(f"serve: artifact loaded in {load_s:.1f} s; 4 /segment requests of {hw[0]}x{hw[1]} frames: "
          f"latency {[round(t, 3) for t in latencies]} s; labels equal to ss_test's on "
          f"{[round(x, 6) for x in shares]} of the pixels (bound 0.9999)")
    if len(shares) != 4 or min(shares) < 0.9999:
        raise AssertionError(f"served labels differ from ss_test's: {shares}")

    if not pil_loaded and "PIL.Image" in sys.modules:
        raise AssertionError("the test phase wrote or read a PNG through PIL")
    say(f"no PNG through PIL (importable: "
          f"{importlib.util.find_spec('PIL') is not None}, not imported)")
    del keep
    torch.cuda.empty_cache()
    shutil.rmtree(out_root, ignore_errors=True)
    return {"scores": scores, "modes": modes, "launches_k2a": launches["conv3x3_fwd"],
            "official_miou": miou_official, "sweep": sweep, "artifact_bytes": size,
            "export_s": export_s, "latencies": latencies, "shares": shares}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()

    from concurrent.futures import ThreadPoolExecutor

    from contrastiveseg_tpu_torch.data import native
    from contrastiveseg_tpu_torch.ops import block_cuda, contrast_cuda, conv_cuda, cuda_lib

    libraries = [contrast_cuda.LIBRARY, conv_cuda.LIBRARY, block_cuda.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        host_libs = [pool.submit(lib.build) for lib in (native.LIBRARY, native.PNG_LIBRARY,
                                                        native.JPEG_LIBRARY)]
        built = cuda_lib.build_all(libraries, force=True)
        host_paths = [f.result() for f in host_libs]
    print(f"built {[(p.name, round(s, 2)) for p, s in built]} and "
          f"{[str(p.relative_to(ROOT)) for p in host_paths]} (g++) in "
          f"{time.perf_counter() - t0:.2f} s (one compiler each, in parallel)")
    spills = []
    for lib in libraries:
        entry = None
        for line in lib.ptxas_report().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(line.strip())
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "bytes spill stores" in line and any(
                    int(n) for n in re.findall(r"(\d+) bytes", line)):
                spills.append(entry)
    print(f"ptxas: kernels with a stack frame or spills: {spills or 'none'}")

    t0 = time.perf_counter()
    k1 = check_k1(device)
    k2 = check_k2(device)
    k3 = check_k3(device)
    print(f"kernel checks passed in {time.perf_counter() - t0:.1f} s")
    sl = run_slice(device)
    on = run_flagged_slice(device)
    flag_on_equals_off(device)
    blk = run_block_bench()
    dr = run_directory_slice(device)
    phases = {}
    for name, run in (("plain", run_plain_phase), ("contrast", run_contrast_phase),
                      ("pretrained", run_pretrained_phase)):
        t0 = time.perf_counter()
        phases[name] = run(device, dr["data_dir"])
        print(f"{name} phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp = run_test_phase(device, dr["data_dir"], dr["latest"])
    print(f"test phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mp = run_models_phase(device, dr["data_dir"])
    print(f"models phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cp = run_context_phase(device)
    print(f"context phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rp = run_raw_phase(device)
    print(f"raw phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp = run_segfix_phase(device)
    print(f"segfix phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jp = run_jpeg_phase(device)
    print(f"jpeg phase wall time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tf = run_transformer_phase(device, dr["data_dir"], jp["root"])
    print(f"transformer phase wall time {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(jp["root"], ignore_errors=True)
    shutil.rmtree(dr["data_dir"], ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "chip_smoke_ckpt", ignore_errors=True)
    print(f"flag-off slice: steps 2-3 {[round(r['seconds'] * 1e3, 1) for r in sl['history'][1:]]}"
          f" ms, peak {sl['peak'] / 2**30:.3f} GiB; flag-on slice: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in on['history'][1:]]} ms, peak "
          f"{on['peak'] / 2**30:.3f} GiB; directory slice at batch 8: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in dr['history'][1:]]} ms, peak "
          f"{dr['peak'] / 2**30:.3f} GiB; at batch 8 from the directory, "
          f"cityscapes_hrnet_w48: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in phases['plain']['history'][1:]]} ms, peak "
          f"{phases['plain']['peak'] / 2**30:.3f} GiB; cityscapes_hrnet_w48_contrast: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in phases['contrast']['history'][1:]]} ms, "
          f"peak {phases['contrast']['peak'] / 2**30:.3f} GiB (same call, same card)")
    print("models phase at batch 8 from the directory: " + "; ".join(
        f"{p}: steps after the first "
        f"{[round(r['seconds'] * 1e3, 1) for r in mp[p]['history'][1:]]} ms, "
        f"data wait {[round(r['data_seconds'] * 1e3, 1) for r in mp[p]['history'][1:]]} ms, "
        f"peak {mp[p]['peak'] / 2**30:.3f} GiB" for p in MODEL_PRESETS) + " (same call)")
    print("context phase from the directories: " + "; ".join(
        f"{n} ({r['params'] / 1e6:.2f} M) at batch {r['batch']}: steps after the first "
        f"{[round(x['seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, data wait "
        f"{[round(x['data_seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, peak "
        f"{r['peak'] / 2**30:.3f} GiB" + (f", val {r['val']['images_per_sec']:.3f} images/s"
                                          if "val" in r else "")
        for n, r in cp.items() if n != "launches") + " (same call)")
    hl = rp["headline"]
    print(f"raw phase: headline from raw PNGs at batch 8: steps after the first "
          f"{[round(r['seconds'] * 1e3, 1) for r in hl['history'][1:]]} ms, data wait "
          f"{[round(r['data_seconds'] * 1e3, 1) for r in hl['history'][1:]]} ms, decode "
          f"{hl['decode_ms_image']:.1f} ms a frame, pipeline {hl['host_seconds'][1]:.3f} s a "
          f"batch at 1 worker, {hl['host_seconds'][4]:.3f} s at 4; " + "; ".join(
              f"{n} at batch {r['batch']}: steps after the first "
              f"{[round(x['seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, data wait "
              f"{[round(x['data_seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, peak "
              f"{r['peak'] / 2**30:.3f} GiB" for n, r in rp["nets"].items() if "history" in r)
          + " (same call)")

    print("segfix phase: " + "; ".join(
        f"{n}: val {r['val_batch_seconds']:.3f} s a batch of {SEGFIX_VAL_BATCH} (model "
        f"{r['model_seconds_batch']:.3f} s), test_offset {r['test']['seconds_image']:.3f} s an "
        f"image, loss step at batch 16 {sp['loss'][n]['seconds'][1] * 1e3:.1f} ms, "
        f"{sp['loss'][n]['peak'] / 2**30:.3f} GiB" for n, r in sp["nets"].items())
        + f"; dt targets {statistics.mean(sp['dt_seconds']):.3f} s a frame on the host; "
        f"cityscapes_resnest_fcn at batch {sp['resnest']['batch']}: steps after the first "
        f"{[round(r['seconds'] * 1e3, 1) for r in sp['resnest']['history'][1:]]} ms, data wait "
        f"{[round(r['data_seconds'] * 1e3, 1) for r in sp['resnest']['history'][1:]]} ms, peak "
        f"{sp['resnest']['peak'] / 2**30:.3f} GiB (same call)")
    ade_host = jp["nets"]["ade20k_hrnet_w48_contrast"]["host_seconds"]
    print("jpeg phase from raw JPEG (and CamVid PNG) trees: " + "; ".join(
        f"{n} at batch {r['batch']}: steps after the first "
        f"{[round(x['seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, data wait "
        f"{[round(x['data_seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, peak "
        f"{r['peak'] / 2**30:.3f} GiB" + (f", val {r['val']['images_per_sec']:.3f} images/s"
                                          if "val" in r else "")
        for n, r in jp["nets"].items())
        + f"; decode {statistics.median(jp['decode_ms'].values()):.2f} ms a fixture (median); "
        f"pipeline {ade_host[1]:.3f} s an ADE20K batch of 16 at 1 worker, {ade_host[4]:.3f} s "
        "at 4 (same call)")
    print("transformer phase: " + "; ".join(
        f"{n} ({r['params'] / 1e6:.2f} M) at batch {r['batch']}: steps after the first "
        f"{[round(x['seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, data wait "
        f"{[round(x['data_seconds'] * 1e3, 1) for x in r['history'][1:]]} ms, peak "
        f"{r['peak'] / 2**30:.3f} GiB" + (f", val {r['val']['images_per_sec']:.3f} images/s"
                                          if "val" in r else "")
        for n, r in tf["nets"].items()) + " (same call)")

    rows = []
    for name, (_, _, replaces) in contrast_cuda.KERNELS.items():
        row = {"name": name, "route": "cuda",
               "source": "contrastiveseg_tpu_torch/csrc/contrast_infonce.cu",
               "replaces": replaces, "launches": sl["launches"][name],
               "launches_directory_slice": dr["launches"][name],
               "max_abs_err": k1["errs"][name], "library_ms": None,
               "shape": "M=38 K=190000 D=256"}
        for case, sfx in (("main_path", ""), ("recipe_b8", "_m152"), ("headline", "_m1024")):
            ms, plain_ms, (b_ms, by), (bs, _) = k1["rows"][case][name]
            row.update({f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms, f"bound_ms{sfx}": b_ms,
                        f"bound_by{sfx}": by, f"bound_ms_fp32_simt{sfx}": bs})
        rows.append(row)
    for name, (_, _, replaces) in conv_cuda.KERNELS.items():
        ms, plain_ms, lib_ms, (b_ms, by), (bs, _) = k2["rows"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "contrastiveseg_tpu_torch/csrc/conv3x3.cu",
            "replaces": replaces, "launches": on["launches"][name],
            "max_abs_err": k2["errs"][name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "bound_ms_fp32_simt": bs, "library_ms": lib_ms,
            "shape": "x [2,48,128,256] fp32, w [48,48,3,3]",
        })
    rows[-2]["launches_test_path"] = tp["launches_k2a"]
    rows[-1]["launches_test_path"] = 0
    for row in rows[-2:]:
        ms, lib_ms, (b_ms, by), _ = k2["b8"][row["name"]]
        row.update({"ms_b8": ms, "library_ms_b8": lib_ms, "bound_ms_b8": b_ms,
                    "bound_by_b8": by})
    _, _, replaces = block_cuda.KERNELS["fused_block"]
    b16, f32 = blk["bf16"], blk["fp32"]
    B, H, W, C = b16["shape"]
    flops = 2 * (2 * 9 * C * C) * B * H * W
    x_elems = B * C * H * W
    b_ms, by = bound(flops, 2 * 2 * x_elems + 2 * 4 * 9 * C * C + 4 * 4 * C, "bf16")
    f32_bytes = 2 * 4 * x_elems + 2 * 4 * 9 * C * C + 4 * 4 * C
    b32, by32 = bound(flops, f32_bytes)
    b32s, _ = bound(flops, f32_bytes, "fp32_simt")
    rows.append({
        "name": "fused_block", "route": "cuda",
        "source": "contrastiveseg_tpu_torch/csrc/fused_block.cu",
        "replaces": replaces, "launches": b16["launches"],
        "max_abs_err": k3["errs"]["bf16"], "ms": b16["block_us_fused"] / 1e3,
        "plain_ms": b16["block_us_plain"] / 1e3, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "shape": "x [8,48,128,256] bf16 (the bench default)",
        "ms_fp32": f32["block_us_fused"] / 1e3, "plain_ms_fp32": f32["block_us_plain"] / 1e3,
        "bound_ms_fp32": b32, "bound_by_fp32": by32, "bound_ms_fp32_simt": b32s,
        "max_abs_err_fp32": k3["errs"]["fp32"],
    })
    for row in rows:  # summed over every run of phases 14-19; 14, 15, 17-19 fail on one
        row["launches_models_phase"] = mp["launches"][row["name"]]
        row["launches_context_phase"] = cp["launches"][row["name"]]
        row["launches_raw_phase"] = rp["launches"].get(row["name"], 0)
        row["launches_segfix_phase"] = sp["launches"].get(row["name"], 0)
        row["launches_jpeg_phase"] = jp["launches"].get(row["name"], 0)
        row["launches_transformer_phase"] = tf["launches"].get(row["name"], 0)
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s after the device check")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
