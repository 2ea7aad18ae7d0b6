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
     PNG is decoded and PIL is not needed), then 3 steps of the headline at
     the recipe's batch 8 from it through the data pipeline (the preset's
     transforms, ``data.workers`` and pinned prefetch), validation over the
     4 val frames at 2048x1024; >= 3 launches of each K1 kernel, the first
     device batch bit-identical to the pipeline's host batch, segdata loaded
     from ``build/segdata/`` with no fallback; each step's time and data
     wait, the pipeline's host seconds a batch alone at 1 and 4 workers,
     val images/s and the peak memory;
 10. a JSON line of the six kernels, the card line, and the result line.

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


def png_bytes(a) -> bytes:
    """An 8-bit grey (HxW) or RGB (HxWx3) PNG of ``a``, every row filter 0."""
    import struct
    import zlib

    import numpy as np

    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if a.ndim == 3 else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_dataset(root: Path, n_train: int = 8, n_val: int = 4, hw=(1024, 2048),
                  seed: int = 0) -> None:
    """A Cityscapes-layout tree, {root}/{split}/image|label/*.png, each PNG
    beside its ``.npy_cache/<name>.png.npy`` sidecar (the decoded array, as
    ``tools/cache_dataset.py`` writes it; written after the PNG, so fresh).
    The frames are the synthetic scenes with raw Cityscapes ids; the bottom
    sixteenth of each is raw id 0 (unlabeled), which relabels to -1."""
    import numpy as np

    from contrastiveseg_tpu_torch.data.datasets import (
        CITYSCAPES_LABEL_LIST,
        SyntheticSegDataset,
    )

    raw_ids = np.asarray(CITYSCAPES_LABEL_LIST, np.uint8)
    scenes = SyntheticSegDataset(19, hw, n_train + n_val, seed=seed)
    for i in range(n_train + n_val):
        split, name = ("train", f"f{i}") if i < n_train else ("val", f"f{i - n_train}")
        scene = scenes[i]
        label = raw_ids[scene["label"]]
        label[-(hw[0] // 16):] = 0
        for kind, array in (("image", scene["image"]), ("label", label)):
            d = root / split / kind
            (d / ".npy_cache").mkdir(parents=True, exist_ok=True)
            (d / f"{name}.png").write_bytes(png_bytes(array))
            np.save(d / ".npy_cache" / f"{name}.png.npy", array)


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
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(data_dir, ignore_errors=True)
    return {"launches": launches, "history": history, "peak": peak, "scores": scores,
            "host_seconds": host_s}


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
    shutil.rmtree(ROOT / "build" / "chip_smoke_ckpt", ignore_errors=True)
    print(f"flag-off slice: steps 2-3 {[round(r['seconds'] * 1e3, 1) for r in sl['history'][1:]]}"
          f" ms, peak {sl['peak'] / 2**30:.3f} GiB; flag-on slice: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in on['history'][1:]]} ms, peak "
          f"{on['peak'] / 2**30:.3f} GiB; directory slice at batch 8: steps 2-3 "
          f"{[round(r['seconds'] * 1e3, 1) for r in dr['history'][1:]]} ms, peak "
          f"{dr['peak'] / 2**30:.3f} GiB (same call, same card)")

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
