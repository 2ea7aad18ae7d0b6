#!/usr/bin/env python
"""Micro-benchmark: the fused inference BasicBlock kernel (K3) against its
plain PyTorch version, on one CUDA device.

Counterpart of ``tools/bench_block_pallas.py``: the same arguments, the
same inputs (numpy seed 0, made NHWC/HWIO as there and transposed to the
port's NCHW/OIHW), the HRNet stride-4 branch shape [8, 128, 256, 48] in
bf16 by default.  Times come from CUDA events around ``--chain`` block
applications (default 1; each reads the same x), median of ``--reps``,
after a warm-up.  The plain version is ``ops/block.reference_block_eval``
(two cuDNN convolutions and the elementwise ops between them, TF32 off).
Before timing, the kernel's output is held against the plain version.

    python tools/bench_block_torch.py [--fp32] [--reps 10] [--chain 1]

Prints one JSON line: ``block_us_fused``, ``block_us_plain``, their
TFLOP/s, the speedup, the max abs error, the card's name and power limit.
Without CUDA it fails: it never times the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_inputs(batch: int, height: int, width: int, channels: int, fp32: bool,
                device):
    """The JAX bench's inputs, in the port's layouts, on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    B, H, W, C = batch, height, width, channels
    x = rng.standard_normal((B, H, W, C))
    w1 = rng.standard_normal((3, 3, C, C)) * 0.05
    w2 = rng.standard_normal((3, 3, C, C)) * 0.05
    s1 = rng.uniform(0.9, 1.1, C)
    s2 = rng.uniform(0.9, 1.1, C)
    b1 = rng.standard_normal(C) * 0.01
    b2 = rng.standard_normal(C) * 0.01

    def t(a, perm=None):
        a = torch.from_numpy(np.ascontiguousarray(
            a.transpose(perm) if perm else a).astype(np.float32))
        return a.to(device)

    dtype = torch.float32 if fp32 else torch.bfloat16
    return (t(x, (0, 3, 1, 2)).to(dtype), t(w1, (3, 2, 0, 1)), t(s1), t(b1),
            t(w2, (3, 2, 0, 1)), t(s2), t(b2))


def time_us(fn, reps: int, chain: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / chain)
    return statistics.median(times)


def bench(batch: int = 8, height: int = 128, width: int = 256, channels: int = 48,
          fp32: bool = False, reps: int = 10, chain: int = 1) -> dict:
    import torch

    from contrastiveseg_tpu_torch.ops.block import reference_block_eval
    from contrastiveseg_tpu_torch.ops.block_cuda import fused_basic_block_eval

    if not torch.cuda.is_available():
        raise RuntimeError("bench_block_torch.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = make_inputs(batch, height, width, channels, fp32, torch.device("cuda", 0))
    got = fused_basic_block_eval(*args)
    want = reference_block_eval(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    us_fused = time_us(lambda: fused_basic_block_eval(*args), reps, chain)
    us_plain = time_us(lambda: reference_block_eval(*args), reps, chain)
    B, C, H, W = args[0].shape
    flops = 2 * (2 * 9 * C * C) * B * H * W
    return {
        "shape": [B, H, W, C],
        "dtype": str(args[0].dtype).replace("torch.", ""),
        "block_us_fused": us_fused,
        "block_us_plain": us_plain,
        "tflops_fused": flops / us_fused / 1e6,
        "tflops_plain": flops / us_plain / 1e6,
        "speedup": us_plain / us_fused,
        "max_abs_err": err,
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--channels", type=int, default=48)
    ap.add_argument("--chain", type=int, default=1,
                    help="block applications between two CUDA events")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args()
    print(json.dumps(bench(args.batch, args.height, args.width, args.channels,
                           args.fp32, args.reps, args.chain)))


if __name__ == "__main__":
    main()
