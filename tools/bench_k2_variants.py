#!/usr/bin/env python
"""What bounds K2 (``conv3x3_fwd``, ``conv3x3_dw`` and their bf16 kernels) and
K3 (``fused_block``): time them built as diagnostic variants.

    python3 tools/bench_k2_variants.py [--batches 2,8]

Builds ``csrc/conv3x3.cu`` and ``csrc/fused_block.cu`` as the port ships
them and with their diagnostic switches, one nvcc each, all at once.  K2:
``K2_PRODUCTS=1`` (the hi.hi TF32 product alone) and ``=0`` (no products),
``K2_NO_LOADS`` (the products on whatever shared memory holds: no chunk
loads in K2a, no segment loads in K2b) and ``K2_FLUSH=0`` (K2b's hi.hi
accumulator runs over a whole split instead of one segment); for the bf16
TMA and wgmma kernels (``conv3x3_fwd_bf16_wgmma``, ``conv3x3_dw_bf16_wgmma``
and its split sum ``dw_sum_taps``) ``K2_PRODUCTS=0`` (no wgmma),
``K2_NO_LOADS`` (no TMA copies: the producer arrives on the barriers) and
``K2_NO_SHIFT`` (the shifter warps build no shifted tiles).  K3:
``K3_PRODUCTS=1`` (fp32: one TF32 product) and ``=0`` (no products) and
``K3_NO_LOADS`` (no x or weight loads).

K2 variants run through the port's wrappers on HRNet-W48 branch 0's x, w and
g of [B, 48, 128, 256] fp32 (seeded): K2a's forward and dX, K2b's dW; the
bf16 rows the same in bf16, and at [1, 48, 256, 512] (ss_test's branch 0).  K3
variants run on ``tools/bench_block_torch.py``'s inputs, [8, 48, 128, 256]
in bf16 and fp32.  Each is timed two ways: CUDA events around back-to-back
calls of the wrapper (``chip_smoke.time_ms``; K3's wrapper also folds the
BN scales into the weights) and each kernel's device time under
``torch.profiler`` (``conv3x3_fwd_tc``, ``conv3x3_dw_tc``, ``dw_sum_splits``,
``fused_block_f32``, ``fused_block_bf16``, the bf16 kernels; per call, over
20 calls).
cuDNN's ``conv2d`` and ``conv2d_weight`` and K3's plain version are timed
beside them.  Max abs
errors: K2 against fp64, K3 against its plain version; only the shipped
variants are held to the card test's tolerances (K2 rtol 1e-4, atol 1e-4
on the forward, atol 1e-6 max|dW| + 1e-4 on dW; K3 fp32 rtol 1e-4, atol
1e-4, bf16 within 2 bf16 steps), the others are wrong by design or are the
question.

Prints one line per row, then one JSON line of them all, then the card's
name and power limit.  Needs one CUDA device.
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
    "no_shift": ("K2_NO_SHIFT",),
}
FP32_VARIANTS = ("shipped", "products_1", "products_0", "no_loads", "no_flush")
BF16_VARIANTS = ("shipped", "products_0", "no_loads", "no_shift")
K3_VARIANTS = {
    "shipped": (),
    "products_1": ("K3_PRODUCTS=1",),
    "products_0": ("K3_PRODUCTS=0",),
    "no_loads": ("K3_NO_LOADS",),
}
KERNEL_NAMES = ("conv3x3_fwd_tc", "conv3x3_dw_tc", "dw_sum_splits", "fused_block_f32",
                "fused_block_bf16", "conv3x3_fwd_bf16_wgmma", "conv3x3_dw_bf16_wgmma",
                "dw_sum_taps")


def device_us(fn, calls: int = 20) -> dict[str, float]:
    """Device time per call of each kernel that ``fn`` launches, in us, under
    the names of ``KERNEL_NAMES`` (``chip_smoke.device_us``)."""
    from chip_smoke import device_us as kernels_us

    out = collections.Counter()
    for name, us in kernels_us(fn, calls).items():
        out[next((k for k in KERNEL_NAMES if k in name), name[:40])] += us
    return dict(out)


def variant_libraries(shipped, variants: dict) -> dict:
    from contrastiveseg_tpu_torch.ops import cuda_lib

    return {name: shipped if not d else cuda_lib.CudaLibrary(
        shipped.source.name, shipped.signatures, shipped.error_string, shipped.init,
        defines=d) for name, d in variants.items()}


def k2_rows(libs: dict, batches, device) -> list[dict]:
    import torch

    from chip_smoke import close, time_ms
    from contrastiveseg_tpu_torch.ops import conv_cuda as k2

    rows = []
    g = torch.Generator().manual_seed(2)
    for B in batches:
        x = torch.randn(B, C, 128, 256, generator=g).to(device)
        w = (torch.randn(C, C, 3, 3, generator=g) / (3 * C ** 0.5)).to(device)
        gy = torch.randn(B, C, 128, 256, generator=g).to(device)
        want_y = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
        want_dw = torch.nn.grad.conv2d_weight(x.double(), (C, C, 3, 3), gy.double(), padding=1)
        atol = 1e-6 * float(want_dw.abs().max()) + 1e-4

        def cudnn():
            torch.nn.functional.conv2d(x, w, padding=1)
            torch.nn.grad.conv2d_weight(x, (C, C, 3, 3), gy, padding=1)

        row = {"B": B, "variant": "cudnn",
               "conv2d_ms": time_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1)),
               "conv2d_weight_ms": time_ms(
                   lambda: torch.nn.grad.conv2d_weight(x, (C, C, 3, 3), gy, padding=1)),
               "device_us": device_us(cudnn),
               "max_abs_err_fwd_vs_fp64": float(
                   (torch.nn.functional.conv2d(x, w, padding=1).double() - want_y).abs().max())}
        rows.append(row)
        print(json.dumps(row), flush=True)
        shipped = k2.LIBRARY
        for name in FP32_VARIANTS:
            k2.LIBRARY = libs[name]
            try:
                y = k2.conv3x3_fwd(x, w)
                dw = k2.conv3x3_dw(x, gy)
                torch.cuda.synchronize()
                if name == "shipped":
                    close(f"B={B} forward against fp64", y.double(), want_y, 1e-4, 1e-4)
                    close(f"B={B} dW against fp64", dw.double(), want_dw, 1e-4, atol)

                def all_three():
                    k2.conv3x3_fwd(x, w)
                    k2.conv3x3_fwd(gy, w, True)
                    k2.conv3x3_dw(x, gy)

                row = {"B": B, "variant": name,
                       "fwd_ms": time_ms(lambda: k2.conv3x3_fwd(x, w)),
                       "dx_ms": time_ms(lambda: k2.conv3x3_fwd(gy, w, True)),
                       "dw_ms": time_ms(lambda: k2.conv3x3_dw(x, gy)),
                       "device_us_fwd_dx_dw": device_us(all_three),
                       "max_abs_err_fwd_vs_fp64": float((y.double() - want_y).abs().max()),
                       "max_abs_err_dw_vs_fp64": float((dw.double() - want_dw).abs().max())}
            finally:
                k2.LIBRARY = shipped
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def k2_bf16_rows(libs: dict, batches, device) -> list[dict]:
    """The bf16 kernels' variants at [B, 48, 128, 256] for each B, and at
    [1, 48, 256, 512]; cuDNN's bf16 calls beside them.  The shipped build is
    held to the card test's tolerances (1 bf16 ulp, dW rtol 1e-5 and atol
    1e-6 of its largest entry)."""
    import torch

    from chip_smoke import bf16_ulps, close, time_ms
    from contrastiveseg_tpu_torch.ops import conv_cuda as k2
    from contrastiveseg_tpu_torch.ops.conv import conv3x3_dw_plain, conv3x3_plain

    rows = []
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    for B, H, W in [(b, 128, 256) for b in batches] + [(1, 256, 512)]:
        x = torch.randn(B, C, H, W, generator=g).to(device, bf)
        w = (torch.randn(C, C, 3, 3, generator=g) / (3 * C ** 0.5)).to(device, bf)
        gy = torch.randn(B, C, H, W, generator=g).to(device, bf)
        want_y, want_dw = conv3x3_plain(x, w), conv3x3_dw_plain(x, gy)
        shape = [B, C, H, W]
        row = {"shape": shape, "dtype": "bf16", "variant": "cudnn",
               "conv2d_ms": time_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1)),
               "conv2d_weight_ms": time_ms(
                   lambda: torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1)),
               "device_us_conv2d": device_us(lambda: torch.nn.functional.conv2d(x, w, padding=1)),
               "device_us_conv2d_weight": device_us(
                   lambda: torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1))}
        rows.append(row)
        print(json.dumps(row), flush=True)
        shipped = k2.LIBRARY
        for name in BF16_VARIANTS:
            k2.LIBRARY = libs[name]
            try:
                y, dw = k2.conv3x3_fwd(x, w), k2.conv3x3_dw(x, gy)
                torch.cuda.synchronize()
                if name == "shipped":
                    if bf16_ulps(y, want_y) > 1:
                        raise AssertionError(f"bf16 {shape}: forward over 1 bf16 ulp")
                    close(f"bf16 {shape} dW", dw, want_dw, 1e-5, 1e-6 * float(want_dw.abs().max()))
                row = {"shape": shape, "dtype": "bf16", "variant": name,
                       "fwd_ms": time_ms(lambda: k2.conv3x3_fwd(x, w)),
                       "dx_ms": time_ms(lambda: k2.conv3x3_fwd(gy, w, True)),
                       "dw_ms": time_ms(lambda: k2.conv3x3_dw(x, gy)),
                       "device_us_fwd": device_us(lambda: k2.conv3x3_fwd(x, w)),
                       "device_us_dx": device_us(lambda: k2.conv3x3_fwd(gy, w, True)),
                       "device_us_dw": device_us(lambda: k2.conv3x3_dw(x, gy)),
                       "max_bf16_ulps_fwd": bf16_ulps(y, want_y),
                       "max_abs_err_dw": float((dw - want_dw).abs().max())}
            finally:
                k2.LIBRARY = shipped
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def k3_rows(libs: dict, device) -> list[dict]:
    import torch

    from chip_smoke import time_ms
    from contrastiveseg_tpu_torch.ops import block_cuda as k3
    from contrastiveseg_tpu_torch.ops.block import reference_block_eval
    from tools.bench_block_torch import make_inputs

    rows = []
    for fp32 in (False, True):
        args = make_inputs(8, 128, 256, C, fp32, device)
        want = reference_block_eval(*args).float()
        rows.append({"dtype": "fp32" if fp32 else "bf16", "variant": "plain",
                     "ms": time_ms(lambda: reference_block_eval(*args))})
        print(json.dumps(rows[-1]), flush=True)
        shipped = k3.LIBRARY
        for name, lib in libs.items():
            k3.LIBRARY = lib
            try:
                got = k3.fused_basic_block_eval(*args).float()
                torch.cuda.synchronize()
                diff = (got - want).abs()
                if name == "shipped":
                    bound = (1e-4 + 1e-4 * want.abs() if fp32
                             else 2 * 2.0 ** -7 * want.abs().clamp(min=1.0))
                    if bool((diff > bound).any()):
                        raise AssertionError(f"K3 {'fp32' if fp32 else 'bf16'} disagrees: "
                                             f"max abs err {float(diff.max()):.3e}")
                row = {"dtype": "fp32" if fp32 else "bf16", "variant": name,
                       "ms": time_ms(lambda: k3.fused_basic_block_eval(*args)),
                       "device_us": device_us(lambda: k3.fused_basic_block_eval(*args)),
                       "max_abs_err_vs_plain": float(diff.max())}
            finally:
                k3.LIBRARY = shipped
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> None:
    import torch

    from chip_smoke import card_line
    from contrastiveseg_tpu_torch.ops import block_cuda, conv_cuda, cuda_lib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="2,8", help="K2's batch sizes B, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_k2_variants.py needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    k2_libs = variant_libraries(conv_cuda.LIBRARY, VARIANTS)
    k3_libs = variant_libraries(block_cuda.LIBRARY, K3_VARIANTS)
    built = cuda_lib.build_all([*k2_libs.values(), *k3_libs.values()], force=True)
    print(f"built {[(p.name, round(s, 2)) for p, s in built]}")
    batches = [int(b) for b in args.batches.split(",")]
    rows = k2_rows(k2_libs, batches, device)
    rows += k2_bf16_rows(k2_libs, batches, device)
    rows += k3_rows(k3_libs, device)
    print(json.dumps({"k2_k3_variants": rows}))
    print(card_line())


if __name__ == "__main__":
    main()
