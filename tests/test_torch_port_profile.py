"""The step profiler's bookkeeping (``tools/profile_torch_step.py``), on the CPU.

The profiler itself needs a CUDA device; what it computes from the trace is
plain Python: each device event goes to exactly one category, and the busy
time is the union of the intervals, so overlapping events count once.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "tools" / "profile_torch_step.py"
_spec = importlib.util.spec_from_file_location("profile_torch_step", _PATH)
prof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(prof)


@pytest.mark.parametrize("name,want", [
    ("_ZN52_GLOBAL__N__contrast_infonce_cu9bwd_tilesEPKf", "K1"),
    ("_ZN52_GLOBAL__N__contrast_infonce_cu10sum_splitsEPKfPfii", "K1"),
    ("_ZN52_GLOBAL__N__54bb903d_19_contrast_infonce_cu_e9da0ee08pass1_tcILi5EEEvPKf", "K1"),
    ("_ZN52_GLOBAL__N__54bb903d_19_contrast_infonce_cu_e9da0ee06bwd_tcILi5EEEvPKf", "K1"),
    ("void (anonymous namespace)::pass2_tc<5>(float const*, int const*)", "K1"),
    ("_ZN43_GLOBAL__N__conv3x3_cu17conv3x3_fwd_tilesILi12EEEvPKfS2_Pfiiiiii", "K2"),
    ("_ZN43_GLOBAL__N__conv3x3_cu16conv3x3_dw_tilesILi12EEEvPKfS2_Pfiiiiii", "K2"),
    ("void (anonymous namespace)::conv3x3_dw_tc<6>(float const*, float const*)", "K2"),
    ("_ZN43_GLOBAL__N__conv3x3_cu13dw_sum_splitsEPKfPfii", "K2"),
    ("_ZN47_GLOBAL__N__fused_block_cu17fused_block_tilesIfLi12EEEvPKT_", "K3"),
    ("void (anonymous namespace)::conv3x3_fwd_tc<3, true>(float const*, float const*)", "K2"),
    ("void (anonymous namespace)::fused_block_bf16<3>(__nv_bfloat16 const*, float const*)", "K3"),
    ("void (anonymous namespace)::fused_block_f32<3>(float const*, float const*)", "K3"),
    ("sm90_xmma_dgrad_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "convolution"),
    ("void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float>", "batchnorm"),
    ("ampere_sgemm_128x64_nn", "gemm"),
    ("void fft2d_r2c_32x32<float, false, 1u, false>(float2*, float const*)", "FFT"),
    ("sm80_xmma_gemm_cf32cf32_cf32f32_f32_nn_n_tilesize64x64x8", "FFT"),
    ("void cgemm_strided_batched_sm80_kernel<float2>", "FFT"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Binary>", "elementwise"),
])
def test_each_kernel_name_gets_one_category(name, want):
    assert prof.category(name).startswith(want)


def test_busy_time_counts_overlaps_once():
    ivs = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0), ("d", 21.0, 22.0)]
    assert prof.busy_us(ivs) == 17.0
    assert prof.busy_us([]) == 0.0
