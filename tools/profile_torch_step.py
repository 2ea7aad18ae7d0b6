#!/usr/bin/env python
"""Where the time of the port's train step goes, on one CUDA device.

    python tools/profile_torch_step.py [--preset cityscapes_hrnet_w48_mem]
        [--steps 6] [--warmup 3] [--eval [--scale S]] [--cudnn-benchmark]
        [key.path=value ...]

Defaults: the headline preset at full HRNet-W48 width, batch 2 of 512x1024
synthetic scenes, contrast live from step 0 (the ``chip_smoke.py`` slice).
Batches are put on the device before any timing.  After ``--warmup`` steps:

  1. ``--steps`` unprofiled steps, each timed on the host clock between two
     ``torch.cuda.synchronize()`` calls;
  2. the same number of steps under ``torch.profiler`` with CUDA activity
     only (CPU op tracing would add host work to every launch, and so to
     the idle share), timed the same way as one window.

From the profiled window it reports the device busy time (the union of
kernel, memcpy and memset intervals), the idle share of that window
(1 - busy / wall), and the kernel time per step by category, with each
category's three longest kernels and K1's kernels by name.  The last line of stdout is one JSON object of these
numbers.  TF32 is off for matmuls and cuDNN, as in ``tools/train_torch.py``.

With ``--eval`` a "step" is the evaluator's work on one val batch instead
(``Evaluator.confusion``: the eval-mode forward, the upsample of the logits
to the label's size, argmax and confusion), at ``val.batch_size`` from the
val pipeline (the headline pads the scenes to 2048x1024); ``--scale S``
resizes the images by S first (align-corners bilinear), as the ``Tester``'s
``ss_test`` does at that scale (``ms_test`` runs 0.75, 1.0 and 1.25).  With
``--cudnn-benchmark``, cuDNN times its algorithms for each new shape and
keeps the fastest (``torch.backends.cudnn.benchmark``) instead of taking
its heuristics' pick; the warm-up steps absorb that search.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLICE = ["data.synthetic=true", "data.synthetic_size=[512,1024]",
         "train.batch_size=2", "contrast.warmup_iters=0", "solver.max_iters=100"]

# Kernel-name substrings per category, tested in this order.  The trace has
# K1's kernels by their names (K1_KERNELS, also the breakdown's keys); a
# mangled name holds the source's, csrc/contrast_infonce.cu.
K1_KERNELS = ("pass1_tc", "pass1_merge", "pass2_tc", "bwd_tc", "sum_splits")
K2_KERNELS = ("conv3x3_fwd", "conv3x3_dw", "dw_sum_splits")
CATEGORIES = (  # K2 before K1 and the convolutions: its names hold theirs
    ("K2", K2_KERNELS),
    ("K3", ("fused_block",)),
    ("K1", ("contrast_infonce",) + K1_KERNELS),
    # cuDNN's FFT convolutions: their transforms and complex-valued GEMMs.
    ("FFT convolution (transforms, complex GEMMs)", ("fft", "cgemm", "cf32")),
    ("convolution (cuDNN, with its layout transforms)",
     ("conv", "dgrad", "wgrad", "fprop", "nhwctonchw", "nchwtonhwc")),
    ("batchnorm", ("batchnorm", "batch_norm", "bn_fw", "bn_bw")),
    ("gemm (resize einsums, bmm, matmul)", ("gemm", "cutlass", "sm90_xmma")),
)
OTHER = "elementwise / reductions / copies / other"


def category(name: str) -> str:
    n = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return OTHER


def device_intervals(prof):
    """(name, start_us, end_us) of every device-side event: kernels,
    memcpys and memsets, and nothing from the host."""
    import torch

    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s, t = e.time_range.start, e.time_range.end
            if t > s:
                out.append((e.name, s, t))
    return out


def busy_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, cur = 0.0, None
    for _, s, t in sorted(intervals, key=lambda x: x[1]):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="cityscapes_hrnet_w48_mem")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--eval", action="store_true",
                    help="profile the evaluator on val batches, not the train step")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="with --eval: resize the val images by this factor first")
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its algorithms per shape (torch.backends.cudnn.benchmark)")
    ap.add_argument("overrides", nargs="*", help="key.path=value, after the slice's")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from contrastiveseg_tpu_torch.data.pipeline import build_pipeline
    from contrastiveseg_tpu_torch.engine.prefetch import device_batches
    from contrastiveseg_tpu_torch.engine.trainer import Trainer
    from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners
    from tools.train_torch import build_config, require_device

    device = require_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    cfg = build_config(args.preset, None, SLICE + args.overrides)
    trainer = Trainer(cfg, device)
    host = (build_pipeline(cfg, "val").epoch_iter(0) if args.eval
            else build_pipeline(cfg, "train").iter_from(0))
    batches = device_batches(host, device)
    bs = [next(batches) for _ in range(2)]
    batches.close()
    if args.eval:
        trainer.state.model.eval()

    if args.eval and args.scale != 1.0:
        for b in bs:
            h, w = b["image"].shape[1:3]
            b["image"] = resize_bilinear_align_corners(
                b["image"], (int(h * args.scale), int(w * args.scale)))

    def step(i):
        if args.eval:
            return trainer.evaluator.confusion(bs[i % 2]["image"], bs[i % 2]["label"])
        return trainer.train_step(trainer.state, bs[i % 2])

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()

    step_ms = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    ivs = device_intervals(prof)
    busy_ms = busy_us(ivs) / 1e3
    cats, k1 = collections.Counter(), collections.Counter()
    by_name = collections.defaultdict(collections.Counter)
    for name, s, t in ivs:
        cat = category(name)
        cats[cat] += (t - s) / 1e3
        by_name[cat][name] += (t - s) / 1e3
        if cat == "K1":
            k1[next((k for k in K1_KERNELS if k in name), name)] += (t - s) / 1e3
    total = sum(cats.values())
    n = args.steps

    print(f"{'evaluator' if args.eval else 'train step'} on batches of "
          f"{list(bs[0]['image'].shape)}")
    print(f"unprofiled step ms: {[round(t, 3) for t in step_ms]} "
          f"(median {statistics.median(step_ms):.3f})")
    print(f"profiled window: {n} steps, wall {wall_ms:.3f} ms "
          f"({wall_ms / n:.3f} ms/step), device busy {busy_ms:.3f} ms "
          f"({busy_ms / n:.3f} ms/step), idle share {1 - busy_ms / wall_ms:.4f}")
    for cat, ms in cats.most_common():
        print(f"  {cat}: {ms / n:.3f} ms/step ({ms / total:.4f} of device time)")
        for name, kms in by_name[cat].most_common(3):
            print(f"      {kms / n:.3f} ms/step {name[:110]}")
    for name, ms in k1.most_common():
        print(f"    K1 {name}: {ms / n:.3f} ms/step")
    print(f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "eval": args.eval, "scale": args.scale, "cudnn_benchmark": args.cudnn_benchmark,
        "batch_shape": list(bs[0]["image"].shape), "steps": n, "step_ms": step_ms, "profiled_wall_ms": wall_ms,
        "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "device_ms_per_step": {c: ms / n for c, ms in cats.items()},
        "k1_ms_per_step": {c: ms / n for c, ms in k1.items()},
    }))


if __name__ == "__main__":
    main()
