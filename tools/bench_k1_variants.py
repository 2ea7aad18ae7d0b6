#!/usr/bin/env python
"""What bounds K1's three kernels: time them built as diagnostic variants.

    python3 tools/bench_k1_variants.py [--cases 38,152,1024]

Builds ``csrc/contrast_infonce.cu`` three ways, one nvcc each, all at once:
``K1_PRODUCTS`` = 3 (the port's kernels: three TF32 tensor-core products
for each fp32 one), 1 (the hi.hi product alone: TF32 accuracy) and 0 (no
products: the bank stream, the labels and the epilogue on zero logits).
Each variant runs through the port's wrappers on ``chip_smoke.py``'s K1
inputs (D=256, K=190,000 bank rows, tau 0.07) at each M of ``--cases``
and is timed with ``chip_smoke.time_ms`` (CUDA events, median of 5 runs of
10 back-to-back calls), variants in turn within each M: K1a, K1b and K1c.
The variants with fewer products are wrong by design; the tool prints each
variant's relative error of ns and s1 and max abs error of dA against the
plain version, and holds only the shipped variant to K1's tolerance (rtol
1e-4, atol 1e-5).  If a kernel with no products takes far less than the
shipped one, the products, not the bank's bytes, set its time.

Prints one line per (M, variant), then one JSON line of them all, then
the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 190_000
D = 256
TAU = 0.07
VARIANTS = (3, 1, 0)


def main() -> None:
    import torch

    from chip_smoke import card_line, close, k1_inputs, time_ms
    from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
    from contrastiveseg_tpu_torch.ops import cuda_lib
    from contrastiveseg_tpu_torch.ops.contrast_stream import row_ok_and_count

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="38,152,1024", help="anchor counts M, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1_variants.py needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    shipped = k1.LIBRARY
    libs = {3: shipped}
    for n in VARIANTS[1:]:
        libs[n] = cuda_lib.CudaLibrary(
            shipped.source.name, shipped.signatures, shipped.error_string, shipped.init,
            defines=(f"K1_PRODUCTS={n}",))
    built = cuda_lib.build_all(list(libs.values()), force=True)
    print(f"built {[(p.name, round(s, 2)) for p, s in built]}")

    results = []
    for M in (int(x) for x in args.cases.split(",")):
        a, a_l, a_v, c, c_l, c_v = k1_inputs(M, K, D, seed=M + K, device=device)
        m, ns, p = k1.stream_pass1(a, a_l, c, c_l, c_v, TAU)
        s1, t = k1.stream_pass2(a, a_l, c, c_l, c_v, m, ns, TAU)
        row_ok, R = row_ok_and_count(a_v, p)
        w = torch.where(row_ok, -1.0 / (R * p.clamp(min=1)), 0.0)
        da = k1.stream_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, TAU)
        for n, lib in libs.items():
            k1.LIBRARY = lib
            try:
                got_ns = k1.infonce_pass1(a, a_l, c, c_l, c_v, TAU)[1]
                got_s1 = k1.infonce_pass2(a, a_l, c, c_l, c_v, m, ns, TAU)[0]
                got_da = k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, TAU)
                torch.cuda.synchronize()
                if n == 3:
                    close(f"M={M} pass1 ns", got_ns, ns, 1e-4, 1e-5)
                    close(f"M={M} pass2 s1", got_s1, s1, 1e-4, 1e-5)
                    close(f"M={M} bwd dA", got_da, da, 1e-4, 1e-5)
                ns_rel = float(((got_ns - ns).abs() / ns.abs().clamp(min=1e-30)).max())
                s1_rel = float(((got_s1 - s1).abs() / s1.abs().clamp(min=1e-30)).max())
                da_err = float((got_da - da).abs().max())
                pass1_ms = time_ms(lambda: k1.infonce_pass1(a, a_l, c, c_l, c_v, TAU))
                pass2_ms = time_ms(lambda: k1.infonce_pass2(a, a_l, c, c_l, c_v, m, ns, TAU))
                bwd_ms = time_ms(lambda: k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, TAU))
            finally:
                k1.LIBRARY = shipped
            results.append({"M": M, "products": n, "pass1_ms": pass1_ms, "pass2_ms": pass2_ms,
                            "bwd_ms": bwd_ms, "ns_max_rel_err": ns_rel,
                            "s1_max_rel_err": s1_rel, "da_max_abs_err": da_err})
            print(f"M={M} K1_PRODUCTS={n}: K1a {pass1_ms:.4f} ms, K1b {pass2_ms:.4f} ms, "
                  f"K1c {bwd_ms:.4f} ms (ns max rel err {ns_rel:.3e}, s1 max rel err "
                  f"{s1_rel:.3e}, dA max abs err {da_err:.3e})")
    print(json.dumps({"k1_variants": results}))
    print(card_line())


if __name__ == "__main__":
    main()
