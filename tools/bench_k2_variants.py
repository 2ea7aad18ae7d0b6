#!/usr/bin/env python
"""What bounds K2b (``conv3x3_dw``): time it built as diagnostic variants.

    python3 tools/bench_k2_variants.py [--batches 2,8]

Builds ``csrc/conv3x3.cu`` as the port ships it and with its diagnostic
switches, one nvcc each, all at once: ``K2_PRODUCTS=1`` (the hi.hi TF32
product alone) and ``=0`` (no products), ``K2_NO_LOADS`` (the products on
whatever shared memory holds, no segment loads) and ``K2_FLUSH=0`` (the
hi.hi accumulator runs over a whole split instead of one segment).  Each variant runs
through the port's wrapper on HRNet-W48 branch 0's dW, x and g of
[B, 48, 128, 256] fp32 (seeded), and is timed two ways: CUDA events around
back-to-back calls (``chip_smoke.time_ms``) and each kernel's device time
under ``torch.profiler`` (``conv3x3_dw_tc`` and ``dw_sum_splits``, per
call, over 20 calls).  cuDNN's ``conv2d_weight`` is timed beside them.
Every variant's and cuDNN's max abs error against the same dW in fp64 is
printed; only the shipped variant is held to the card test's tolerance
(rtol 1e-4, atol 1e-6 max|dW| + 1e-4), the others are wrong by design or
are the question.

Prints one line per (B, variant), then one JSON line of them all, then the
card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C = 48
VARIANTS = {
    "shipped": (),
    "products_1": ("K2_PRODUCTS=1",),
    "products_0": ("K2_PRODUCTS=0",),
    "no_loads": ("K2_NO_LOADS",),
    "no_flush": ("K2_FLUSH=0",),
}


def device_us(fn, calls: int = 20) -> dict[str, float]:
    """Device time per call of each kernel that ``fn`` launches, in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tools.profile_torch_step import device_intervals

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for name, s, t in device_intervals(prof):
        key = next((k for k in ("conv3x3_dw_tc", "dw_sum_splits") if k in name), name[:40])
        out[key] += (t - s) / calls
    return dict(out)


def main() -> None:
    import torch

    from chip_smoke import card_line, close, time_ms
    from contrastiveseg_tpu_torch.ops import conv_cuda as k2
    from contrastiveseg_tpu_torch.ops import cuda_lib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="2,8", help="batch sizes B, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_k2_variants.py needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False

    shipped = k2.LIBRARY
    libs = {name: shipped if not d else cuda_lib.CudaLibrary(
        shipped.source.name, shipped.signatures, shipped.error_string, shipped.init,
        defines=d) for name, d in VARIANTS.items()}
    built = cuda_lib.build_all(list(libs.values()), force=True)
    print(f"built {[(p.name, round(s, 2)) for p, s in built]}")

    results = []
    g = torch.Generator().manual_seed(2)
    for B in (int(b) for b in args.batches.split(",")):
        x = torch.randn(B, C, 128, 256, generator=g).to(device)
        gy = torch.randn(B, C, 128, 256, generator=g).to(device)
        want = torch.nn.grad.conv2d_weight(x.double(), (C, C, 3, 3), gy.double(), padding=1)
        atol = 1e-6 * float(want.abs().max()) + 1e-4

        def cudnn():
            return torch.nn.grad.conv2d_weight(x, (C, C, 3, 3), gy, padding=1)

        row = {"B": B, "variant": "cudnn_conv2d_weight", "events_ms": time_ms(cudnn),
               "max_abs_err_vs_fp64": float((cudnn().double() - want).abs().max())}
        results.append(row)
        print(json.dumps(row))
        for name, lib in libs.items():
            k2.LIBRARY = lib
            try:
                dw = k2.conv3x3_dw(x, gy)
                torch.cuda.synchronize()
                if name == "shipped":
                    close(f"B={B} dW against fp64", dw.double(), want, 1e-4, atol)
                row = {"B": B, "variant": name,
                       "events_ms": time_ms(lambda: k2.conv3x3_dw(x, gy)),
                       "device_us": device_us(lambda: k2.conv3x3_dw(x, gy)),
                       "max_abs_err_vs_fp64": float((dw.double() - want).abs().max())}
            finally:
                k2.LIBRARY = shipped
            results.append(row)
            print(json.dumps(row))
    print(json.dumps({"k2b_variants": results}))
    print(card_line())


if __name__ == "__main__":
    main()
