"""K2's two routes on the CPU, through the plain versions.

A ``PallasConv3x3`` called eagerly runs ``conv_cuda.Conv3x3``, an autograd
function that calls the wrappers directly and, in a bf16 net, hands them
the fp32 weight to round as they load it; traced (``torch.export``) it runs
the custom op ``contrastiveseg::conv3x3`` on the weight cast to bf16.  The
two must give the same output and gradients bit for bit: the rounding of
the weight, of dX and of dW (to bf16, returned in fp32 to the parameter)
is the same.  No JAX here: the JAX parity of K2 in bf16 is
``tests/test_torch_port_bf16_k2.py``.
"""

from __future__ import annotations

import pytest
import torch

from contrastiveseg_tpu_torch.models.layers import PallasConv3x3, bf16_compute
from contrastiveseg_tpu_torch.ops import conv_cuda
from contrastiveseg_tpu_torch.ops.conv import conv3x3_dw_plain, conv3x3_plain


def _layer_and_input(seed: int, c: int = 6, co: int = 5):
    torch.manual_seed(seed)
    layer = PallasConv3x3(c, co, 3, padding=1, bias=False)
    return layer, torch.randn(2, c, 8, 12)


@pytest.mark.parametrize("bf16", [True, False])
def test_eager_route_equals_custom_op_route(bf16):
    layer, x0 = _layer_and_input(1)
    got = {}
    for route in ("eager", "op"):
        layer.weight.grad = None
        x = x0.clone().requires_grad_(True)
        with bf16_compute(bf16, x):
            if route == "eager":
                y = layer(x)
            else:  # what the traced layer calls: the weight cast, then the op
                xin, w = (x.to(torch.bfloat16), layer.weight.to(torch.bfloat16)) if bf16 else (
                    x, layer.weight)
                y = conv_cuda.conv3x3_op(xin, w, False)
        y.float().square().sum().backward()
        got[route] = (y.detach(), x.grad, layer.weight.grad)
    for a, b in zip(got["eager"], got["op"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["eager"][0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got["eager"][2].dtype == torch.float32  # the parameter's gradient


def test_fp32_weights_round_as_bf16_weights():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 4, 8, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(3, 4, 3, 3, generator=g)
    gy = torch.randn(1, 3, 8, 8, generator=g).to(torch.bfloat16)
    w16 = w.to(torch.bfloat16)
    assert torch.equal(conv_cuda.conv3x3_fwd(x, w), conv3x3_plain(x, w16))
    assert torch.equal(conv_cuda.conv3x3_fwd(gy, w, True), conv3x3_plain(gy, w16, True))
    dw = conv3x3_dw_plain(x, gy)
    assert torch.equal(conv_cuda.conv3x3_dw(x, gy, round_bf16=True), dw.to(torch.bfloat16).float())
    assert torch.equal(conv_cuda.conv3x3_dw(x, gy), dw)


def test_exported_layer_calls_the_custom_op():
    """Traced by ``torch.export`` in a bf16 net, the layer records
    ``contrastiveseg::conv3x3``, and the program gives the eager output."""
    layer, x = _layer_and_input(3)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = layer

        def forward(self, a):
            with bf16_compute(True, a):
                return self.conv(a).float()

    net = Net().eval()
    assert not conv_cuda.traced(x)
    with torch.no_grad():
        program = torch.export.export(net, (x,))
        want = net(x)
    assert any(n.target is torch.ops.contrastiveseg.conv3x3.default
               for m in program.graph_module.modules() if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes)
    with torch.no_grad():
        assert torch.equal(program.module()(x), want)
