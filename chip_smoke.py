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
     ``ss_test`` call per scale and batch shows where cuDNN's FFT
     convolutions make it tens of times slower an image; the model
     exported (``tools/export_torch.py``, ``--scope ss``, batch 1,
     1024x2048) and served (``tools/serve_torch.py``) on 127.0.0.1 answers
     4 ``/segment`` requests with the ``ss_test`` labels on >= 99.99% of
     the pixels; no PNG goes through PIL;
 14. a JSON line of the six kernels, the card line, and the result line.

Phases 10-13 print their step times (or seconds an image), peak memory and
wall time.

The slices read their batches through the port's data pipeline
(``data/pipeline.py``): the synthetic ones get the preset's train
transforms (scale 0.5-2.0, crop 1024x512) and validate at
``val.data_transformer`` (2048x1024).  ``solver.display_iter=1`` gives each
step its own time.  Segdata (``native/segdata.cpp``) is built with ``g++``
beside the CUDA libraries; a failed build fails the run.

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

import json
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
# scales (PERF.md section 5; the phase's sweep reads it again).
TEST_BATCH = 1
SLICE = ["data.synthetic=true", "data.synthetic_size=[512,1024]", "train.batch_size=2",
         "contrast.warmup_iters=0", "solver.max_iters=3", "solver.display_iter=1"]
ROOT = Path(__file__).resolve().parent


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
                  seed: int = 0) -> None:
    """A Cityscapes-layout tree, {root}/{split}/image|label/*.png, each PNG
    beside its ``.npy_cache/<name>.png.npy`` sidecar (the decoded array, as
    ``tools/cache_dataset.py`` writes it; written after the PNG, so fresh),
    and the val labels again as the official evaluator's ground truth,
    ``{root}/gtFine/val/frankfurt/<stem>_gtFine_labelIds.png`` and
    ``_instanceIds.png`` (one instance per class and frame).  The frames are
    the synthetic scenes with raw Cityscapes ids; the bottom sixteenth of each
    is raw id 0 (unlabeled), which relabels to -1.  Val frames are named as
    Cityscapes names them (``frankfurt_000000_<i>_leftImg8bit``), so that the
    evaluator pairs the tester's outputs with them.  PNGs are written by the
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
            (d / ".npy_cache").mkdir(parents=True, exist_ok=True)
            (d / f"{name}.png").write_bytes(encode_png(array, level=1))
            np.save(d / ".npy_cache" / f"{name}.png.npy", array)
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


def cudnn_sweep(tester, images, say=print) -> list[dict]:
    """Seconds an image of one ``ss_test`` call for each (scale, batch), on
    the host clock around a device sync.  Where cuDNN's heuristics pick FFT
    convolutions, a call is tens of times slower an image than at batch 1
    (``tools/profile_torch_step.py --eval --scale`` shows their kernels; the
    profiler takes minutes to parse one such call, so not here)."""
    import torch

    rows = []
    for scale, batches in ((1.0, (1, 2, 4)), (0.75, (1, 2)), (1.25, (1, 2))):
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
        "ms_test's 1.25 scale, cuDNN picks FFT convolutions; the sweep below reads it again)")

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

    full = torch.from_numpy(next(build_pipeline(cfg.updated("test.batch_size", 4), "test")
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
    with ThreadPoolExecutor(1) as pool:
        segdata = pool.submit(native.LIBRARY.build)
        built = cuda_lib.build_all(libraries, force=True)
        segdata_path = segdata.result()
    print(f"built {[(p.name, round(s, 2)) for p, s in built]} and "
          f"{segdata_path.relative_to(ROOT)} (g++) in {time.perf_counter() - t0:.2f} s "
          f"(one compiler each, in parallel)")
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
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s after the device check")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
