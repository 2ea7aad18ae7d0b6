"""The port's CUDA kernels (K1, K2, K3) against their plain versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU.  This file imports no
JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

Tolerances: K1 rtol 1e-4, atol 1e-5 (fp32 sums in another order; K1's
products are 3xTF32 on the tensor cores, at worst ~2^-19 relative per
product, the plain version's cuBLAS SGEMM).
K2 and K3 in fp32 with cuDNN's TF32 off: rtol 1e-4, atol 1e-4 (sums of up
to 9·64 products; dW sums B·H·W of them in 3xTF32, so atol scales with its
size, and K2's dW is held against the plain formula evaluated in fp64:
cuDNN's fp32 ``conv2d_weight`` itself rounds past that tolerance at some
shapes); K3 in bf16 within 2 bf16 steps of the output (both round y1 and
the output at the same places; a value near a rounding boundary may land
one step apart).  K2 in bf16: the forward and dX within 1 bf16 ulp of the
plain version, dW (fp32 sums of exact products) within rtol 1e-5, on each
of its two routes (the TMA and wgmma kernels, PR 16's for other shapes).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from contrastiveseg_tpu_torch.ops import block_cuda, conv_cuda
from contrastiveseg_tpu_torch.ops import contrast_cuda as k1
from contrastiveseg_tpu_torch.ops.block import reference_block_eval
from contrastiveseg_tpu_torch.ops.conv import conv3x3_plain


def _setup(M, K, D, C=19, seed=0):
    """L2-normalised features, class C-1 absent from the contrast set (the
    anchor row M // 2 has it, and no positive, unless M = 1), ~10% invalid
    anchors and contrast rows."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    a_l = rng.integers(0, C - 1, size=M).astype(np.int32)
    if M > 1:
        a_l[M // 2] = C - 1
    c = rng.standard_normal((K, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    c_l = rng.integers(0, C - 1, size=K).astype(np.int32)
    return a, a_l, rng.random(M) < 0.9, c, c_l, rng.random(K) < 0.9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,D", [
    (16, 48, 8), (70, 1000, 256), (38, 19037, 256),
    # the recipe's batch 8; anchor chunks of 64 (300 = 5 x 60); K not a
    # multiple of the 64-row bank tile; D=8; D=6 (4-byte bank copies); one
    # anchor in a chunk of 8 columns (7 of padding)
    (152, 19037, 256), (300, 5003, 256), (300, 777, 8), (20, 1001, 6), (1, 1001, 256)])
def test_k1_kernels_match_plain_on_card(cuda_device, M, K, D):
    torch.backends.cuda.matmul.allow_tf32 = False
    arrs = [torch.from_numpy(x).to(cuda_device) for x in _setup(M, K, D, seed=M)]
    a, a_l, a_v, c, c_l, c_v = arrs
    k1.reset_launch_counts()
    got = k1.infonce_pass1(a, a_l, c, c_l, c_v, 0.07)
    want = k1.stream_pass1(a, a_l, c, c_l, c_v, 0.07)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    m, ns, p = want
    got2 = k1.infonce_pass2(a, a_l, c, c_l, c_v, m, ns, 0.07)
    want2 = k1.stream_pass2(a, a_l, c, c_l, c_v, m, ns, 0.07)
    for g, w in zip(got2, want2):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    w_row = torch.where(a_v & (p > 0), -1.0 / p.clamp(min=1), 0.0)
    torch.testing.assert_close(
        k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, want2[1], w_row, 0.07),
        k1.stream_bwd(a, a_l, c, c_l, c_v, m, ns, want2[1], w_row, 0.07),
        rtol=1e-4, atol=1e-5)
    assert k1.launch_counts() == {"infonce_pass1": 1, "infonce_pass2": 1,
                                  "infonce_bwd": 1}


@pytest.mark.cuda
def test_k1_kernels_are_deterministic_on_card(cuda_device):
    """Partials merge in a fixed split order, with no float atomics."""
    a, a_l, a_v, c, c_l, c_v = [torch.from_numpy(x).to(cuda_device)
                                for x in _setup(152, 19037, 256, seed=3)]
    runs = [k1.infonce_pass1(a, a_l, c, c_l, c_v, 0.07) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    m, ns, p = runs[0]
    runs = [k1.infonce_pass2(a, a_l, c, c_l, c_v, m, ns, 0.07) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    t = runs[0][1]
    w = torch.where(a_v & (p > 0), -1.0 / p.clamp(min=1), 0.0)
    assert torch.equal(k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, 0.07),
                       k1.infonce_bwd(a, a_l, c, c_l, c_v, m, ns, t, w, 0.07))


@pytest.mark.cuda
def test_k1_wrapper_rejects_bad_inputs_on_card(cuda_device):
    a, a_l, _, c, c_l, c_v = [torch.from_numpy(x).to(cuda_device) for x in _setup(16, 48, 8)]
    with pytest.raises(ValueError, match="dtype"):
        k1.infonce_pass1(a, a_l.long(), c, c_l, c_v, 0.07)
    with pytest.raises(ValueError, match="contiguous"):
        k1.infonce_pass1(a, a_l, c.t().contiguous().t(), c_l, c_v, 0.07)
    with pytest.raises(ValueError, match="on"):
        k1.infonce_pass1(a, a_l, c.cpu(), c_l, c_v, 0.07)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Co,H,W", [(2, 48, 48, 32, 256), (2, 48, 48, 16, 40),
                                        (1, 3, 18, 8, 16), (2, 12, 70, 16, 24),
                                        # C = 64; W % 4 != 0: dW's 4-byte copies
                                        (2, 64, 40, 24, 70),
                                        # K2a's tile edges: H not a multiple of its 4
                                        # rows, W ragged by 1-3 past 32 columns, dX
                                        # with 70 input channels, C = Co = 64
                                        (1, 48, 48, 18, 33), (2, 16, 70, 10, 34),
                                        (1, 64, 64, 13, 35)])
def test_k2_kernels_match_plain_on_card(cuda_device, B, C, Co, H, W):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(B + C + W)
    x = torch.randn(B, C, H, W, generator=g).to(cuda_device)
    w = (torch.randn(Co, C, 3, 3, generator=g) * 0.1).to(cuda_device)
    gy = torch.randn(B, Co, H, W, generator=g).to(cuda_device)
    conv_cuda.reset_launch_counts()
    torch.testing.assert_close(conv_cuda.conv3x3_fwd(x, w), conv3x3_plain(x, w),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(conv_cuda.conv3x3_fwd(gy, w, True), conv3x3_plain(gy, w, True),
                               rtol=1e-4, atol=1e-4)
    dw = torch.nn.grad.conv2d_weight(x.double(), w.shape, gy.double(), padding=1)
    torch.testing.assert_close(conv_cuda.conv3x3_dw(x, gy).double(), dw, rtol=1e-4,
                               atol=1e-6 * float(dw.abs().max()) + 1e-4)
    assert conv_cuda.launch_counts() == {**dict.fromkeys(conv_cuda.KERNELS, 0),
                                         "conv3x3_fwd": 2, "conv3x3_dw": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Co,H,W", [(2, 48, 48, 32, 256), (2, 48, 48, 16, 40),
                                        (1, 3, 18, 8, 16), (2, 12, 70, 16, 24),
                                        # C = 64; W % 8 != 0: PR 16's kernels, dW's
                                        # 2-byte loads
                                        (2, 64, 40, 24, 70),
                                        # odd W: K2a-bf16's 2-byte pixel loads; ragged
                                        # tiles; dX with 70 input channels; C = Co = 64
                                        (1, 48, 48, 18, 33), (2, 16, 70, 10, 34),
                                        (1, 64, 64, 13, 35), (1, 20, 36, 8, 300),
                                        # the TMA kernels: HRNet-W18's branch 0 (C = 18:
                                        # the channel tail past C, wgmma's N = 24 and a
                                        # padded K), C = Co = 64, ss_test's branch 0 of
                                        # HRNet-W48 at 1024x2048; a width they cannot take
                                        (2, 18, 18, 16, 64), (2, 64, 64, 16, 128),
                                        (1, 48, 48, 256, 512), (2, 48, 48, 16, 36)])
def test_k2_bf16_kernels_match_plain_on_card(cuda_device, B, C, Co, H, W):
    """K2's bf16 kernels: the forward and dX within 1 bf16 ulp of the plain
    version (``chip_smoke.bf16_ulps``: the fp32 sums differ only in order, and
    each output is rounded once); dW in fp32 within rtol 1e-5 and atol 1e-6
    of its largest entry of the plain formula in fp64 (products of bf16
    values are exact; the kernel and cuDNN's fp32 ``conv2d_weight``, the
    plain version on the card, differ by up to 4.3e-6 of the largest entry
    at [2, 48, 16, 40] on an H100, so the yardstick is fp64).  Each shape
    goes the route ``conv_cuda.tma_route`` gives it (the TMA and wgmma
    kernels where W % 8 == 0 and C, Co <= 64, else PR 16's), which the
    launch counts show; an fp32 weight gives the bf16 weight's outputs."""
    from chip_smoke import bf16_ulps

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(B + C + W)
    x = torch.randn(B, C, H, W, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(Co, C, 3, 3, generator=g) * 0.1).to(cuda_device, torch.bfloat16)
    gy = torch.randn(B, Co, H, W, generator=g).to(cuda_device, torch.bfloat16)
    conv_cuda.reset_launch_counts()
    y, dx = conv_cuda.conv3x3_fwd(x, w), conv_cuda.conv3x3_fwd(gy, w, True)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert bf16_ulps(y, conv3x3_plain(x, w)) <= 1
    assert bf16_ulps(dx, conv3x3_plain(gy, w, True)) <= 1
    dw = conv_cuda.conv3x3_dw(x, gy)
    want = torch.nn.grad.conv2d_weight(x.double(), w.shape, gy.double(), padding=1)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    sfx = "" if W % 8 == 0 and C <= 64 and Co <= 64 else "_ragged"
    assert conv_cuda.tma_route(x, C, Co, gy) == (sfx == "")
    assert conv_cuda.launch_counts() == {**dict.fromkeys(conv_cuda.KERNELS, 0),
                                         f"conv3x3_fwd_bf16{sfx}": 2,
                                         f"conv3x3_dw_bf16{sfx}": 1}
    assert torch.equal(conv_cuda.conv3x3_fwd(x, w.float()), y)
    assert torch.equal(conv_cuda.conv3x3_fwd(gy, w.float(), True), dx)
    assert torch.equal(conv_cuda.conv3x3_dw(x, gy, round_bf16=True), dw.to(torch.bfloat16).float())


@pytest.mark.cuda
def test_k2_bf16_layer_routes_on_card(cuda_device):
    """A bf16 ``PallasConv3x3``'s eager route (``conv_cuda.Conv3x3`` on the
    fp32 weight) and its custom-op route (the weight cast to bf16, as an
    exported net runs it) launch the same kernels and give the same output
    and gradients, bit for bit."""
    from contrastiveseg_tpu_torch.models.layers import PallasConv3x3, bf16_compute

    torch.manual_seed(4)
    layer = PallasConv3x3(48, 48, 3, padding=1, bias=False).to(cuda_device)
    x0 = torch.randn(2, 48, 32, 64, device=cuda_device).to(torch.bfloat16)
    gy = torch.randn(2, 48, 32, 64, device=cuda_device).to(torch.bfloat16)
    out = {}
    for route in ("eager", "op"):
        layer.weight.grad = None
        x = x0.clone().requires_grad_(True)
        conv_cuda.reset_launch_counts()
        with bf16_compute(True, x):
            y = layer(x) if route == "eager" else conv_cuda.conv3x3_op(
                x, layer.weight.to(torch.bfloat16), False)
        y.backward(gy)
        torch.cuda.synchronize()
        out[route] = (y, x.grad, layer.weight.grad, conv_cuda.launch_counts())
    for a, b in zip(out["eager"], out["op"]):
        assert a == b if isinstance(a, dict) else torch.equal(a, b)
    assert out["eager"][3]["conv3x3_fwd_bf16"] == 2 and out["eager"][3]["conv3x3_dw_bf16"] == 1


@pytest.mark.cuda
def test_k2_bf16_autograd_and_export_on_card(cuda_device, tmp_path):
    """The custom op in bf16 on the card: dW comes back bf16 (the JAX VJP's
    rounding) and equals the rounded K2b-bf16; an exported program that calls
    it runs K2 and gives the eager output."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 16, 16, 40, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(16, 16, 3, 3, generator=g) * 0.1).to(cuda_device, torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = conv_cuda.conv3x3(x, w)
    gy = torch.randn(y.shape, generator=g).to(cuda_device, torch.bfloat16)
    y.backward(gy)
    assert w.grad.dtype == torch.bfloat16
    assert torch.equal(w.grad, conv_cuda.conv3x3_dw(x.detach(), gy).to(torch.bfloat16))
    assert torch.equal(x.grad, conv_cuda.conv3x3_fwd(gy, w.detach(), True))

    class Net(torch.nn.Module):
        def forward(self, a):
            return conv_cuda.conv3x3(a, w.detach())

    with torch.no_grad():
        program = torch.export.export(Net(), (x.detach(),))
        torch.export.save(program, tmp_path / "k2.pt2")
        conv_cuda.reset_launch_counts()
        out = torch.export.load(tmp_path / "k2.pt2").module()(x.detach())
    assert conv_cuda.launch_counts()["conv3x3_fwd_bf16"] == 1
    assert torch.equal(out, y.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_dw_is_deterministic_on_card(cuda_device, dtype):
    """dW's split partials are added in a fixed order, with no float atomics."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 48, 128, 256, generator=g).to(cuda_device, dtype)
    gy = torch.randn(2, 48, 128, 256, generator=g).to(cuda_device, dtype)
    assert torch.equal(conv_cuda.conv3x3_dw(x, gy), conv_cuda.conv3x3_dw(x, gy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_fwd_is_deterministic_on_card(cuda_device, dtype):
    """Each output of K2a (forward and dX) is one block's (one warpgroup's)
    sum in one order: no split-K, no atomics."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 48, 128, 256, generator=g).to(cuda_device, dtype)
    w = (torch.randn(48, 48, 3, 3, generator=g) * 0.1).to(cuda_device, dtype)
    for flip in (False, True):
        assert torch.equal(conv_cuda.conv3x3_fwd(x, w, flip), conv_cuda.conv3x3_fwd(x, w, flip))


@pytest.mark.cuda
def test_k2_autograd_and_checks_on_card(cuda_device):
    x = torch.randn(2, 8, 16, 20, device=cuda_device, requires_grad=True)
    w = torch.randn(8, 8, 3, 3, device=cuda_device, requires_grad=True)
    conv_cuda.conv3x3(x, w).square().sum().backward()
    xr, wr = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    torch.nn.functional.conv2d(xr, wr, padding=1).square().sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(w.grad, wr.grad, rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError, match="dtype"):
        conv_cuda.conv3x3_fwd(x.detach().double(), w.detach())
    with pytest.raises(ValueError, match="dtype"):
        conv_cuda.conv3x3_fwd(x.detach().bfloat16(), w.detach().double())
    with pytest.raises(ValueError, match="dtype"):
        conv_cuda.conv3x3_fwd(x.detach(), w.detach().bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        conv_cuda.conv3x3_fwd(x.detach().transpose(2, 3), w.detach())
    with pytest.raises(ValueError, match="C <= 64"):
        conv_cuda.conv3x3_dw(torch.zeros(1, 65, 8, 8, device=cuda_device),
                             torch.zeros(1, 4, 8, 8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W", [(2, 48, 32, 40), (1, 5, 8, 9), (1, 64, 24, 70),
                                     # K3's tile edges: H not a multiple of its 8 rows,
                                     # W ragged by 1-3 past 32 columns
                                     (2, 48, 20, 33), (1, 5, 11, 34), (1, 64, 13, 35)])
def test_k3_kernel_matches_plain_on_card(cuda_device, dtype, B, C, H, W):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(C + H)
    x = torch.randn(B, C, H, W, generator=g).to(cuda_device, dtype)
    args = [(torch.randn(C, C, 3, 3, generator=g) * 0.1), torch.rand(C, generator=g) + 0.5,
            torch.randn(C, generator=g) * 0.1, (torch.randn(C, C, 3, 3, generator=g) * 0.1),
            torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g) * 0.1]
    args = [a.to(cuda_device) for a in args]
    block_cuda.reset_launch_counts()
    got = block_cuda.fused_basic_block_eval(x, *args).float()
    want = reference_block_eval(x, *args).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        step = 2.0 ** -7 * want.abs().clamp(min=1.0)
        assert bool(((got - want).abs() <= 2 * step).all())
    assert block_cuda.launch_counts() == {"fused_block": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_is_deterministic_on_card(cuda_device, dtype):
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 48, 64, 96, generator=g).to(cuda_device, dtype)
    args = [(torch.randn(48, 48, 3, 3, generator=g) * 0.1), torch.rand(48, generator=g) + 0.5,
            torch.randn(48, generator=g) * 0.1, (torch.randn(48, 48, 3, 3, generator=g) * 0.1),
            torch.rand(48, generator=g) + 0.5, torch.randn(48, generator=g) * 0.1]
    args = [a.to(cuda_device) for a in args]
    assert torch.equal(block_cuda.fused_basic_block_eval(x, *args),
                       block_cuda.fused_basic_block_eval(x, *args))
