"""Shared pieces of the ``test_torch_port_*`` parity tests.

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and its PyTorch port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np


def exact_fp32_reference(monkeypatch, compiled_blocks: bool = True) -> None:
    """Hold the JAX models to exact fp32 in two places where they trade
    precision for TPU speed; the JAX package itself is unchanged.

    * Fuse upsamples: the JAX fuse path calls
      ``resize_bilinear_align_corners(..., fast=True)`` (models/hrnet.py:151,
      models/nets.py:90), which rounds the interpolation matrix and the
      intermediate to bf16 (ops/resize.py:77): ~5e-3 relative on the logits.
      The port computes the upstream fp32 ``F.interpolate``.  Routed through
      ``fast=False`` here.
    * BatchNorm variance: flax's ``nn.BatchNorm`` defaults to
      ``use_fast_variance=True``, E[x^2] - E[x]^2, whose cancellation in the
      low-resolution branches of a randomly initialized HRNet moves some
      weight gradients by tens of percent against an fp64 reference.  torch
      (and the port) use the two-pass variance.  Patched to
      ``use_fast_variance=False`` here.

    The resize patch covers every net of ``models/nets.py`` (``HRNetSeg``,
    ``HRNetOCRSeg`` and ``DeepLabV3`` call it there), the BN patch every
    flax BatchNorm.  With ``compiled_blocks`` it also runs the JAX HRNet's
    blocks compiled (``compiled_hrnet_blocks``), which changes the time of an
    eager forward, not its values; a test that jits the whole model needs
    no such patch.
    """
    import contrastiveseg_tpu.models.hrnet as jhrnet
    import contrastiveseg_tpu.models.nets as jnets
    import flax.linen as flax_nn
    from contrastiveseg_tpu.ops.resize import resize_bilinear_align_corners

    def exact(x, size, fast=False):
        return resize_bilinear_align_corners(x, size, fast=False)

    monkeypatch.setattr(jhrnet, "resize_bilinear_align_corners", exact)
    monkeypatch.setattr(jnets, "resize_bilinear_align_corners", exact)
    monkeypatch.setattr(flax_nn, "BatchNorm", functools.partial(
        flax_nn.BatchNorm, use_fast_variance=False))
    if compiled_blocks:
        compiled_hrnet_blocks(monkeypatch)


_BLOCK_FNS: dict = {}


def _block_fn(block, fields: tuple, train):
    """The pure function (params, batch_stats, x) -> (y, new batch_stats)
    of one configuration of ``block``, compiled: its primal, and a custom
    VJP whose forward (with its residuals) and backward are compiled too.
    Eager differentiation of a jitted function runs the backward one
    primitive at a time; this runs it as one compiled call."""
    key = (block, fields, train)
    if key not in _BLOCK_FNS:
        module = block(**dict(fields), parent=None)  # unbound, whoever builds it

        def apply(params, stats, x):
            if train is True:
                y, new = module.apply({"params": params, "batch_stats": stats}, x, train,
                                      mutable=["batch_stats"])
                return y, new["batch_stats"]
            return module.apply({"params": params, "batch_stats": stats}, x, train), stats

        primal = jax.jit(apply)

        @jax.jit
        def fwd(params, stats, x):
            out, vjp_fn = jax.vjp(lambda p, x: apply(p, stats, x), params, x)
            return out, (vjp_fn, stats)

        @jax.jit
        def bwd(res, g):
            vjp_fn, stats = res
            d_params, d_x = vjp_fn((g[0], jax.tree.map(jnp.zeros_like, g[1])))
            return d_params, jax.tree.map(jnp.zeros_like, stats), d_x

        @jax.custom_vjp
        def fn(params, stats, x):
            with jax.disable_jit(False):
                return primal(params, stats, x)

        def fn_fwd(params, stats, x):
            with jax.disable_jit(False):
                return fwd(params, stats, x)

        def fn_bwd(res, g):
            with jax.disable_jit(False):
                return bwd(res, g)

        fn.defvjp(fn_fwd, fn_bwd)
        _BLOCK_FNS[key] = fn
    return _BLOCK_FNS[key]


def _put(scope, col: str, tree) -> None:
    for k, v in tree.items():
        if hasattr(v, "items"):
            _put(scope.push(k, reuse=True), col, v)
        else:
            scope.put_variable(col, k, v)


@functools.cache
def _compiled(block):
    """A subclass of ``block`` (a flax Module called as ``block(...)(x,
    train)``) with the same name, fields and variables, whose application
    (once its variables exist) is ``_block_fn``'s compiled function, and
    whose new batch statistics are written back to its scope."""
    fields = [f.name for f in dataclasses.fields(block) if f.name not in ("parent", "name")]

    class Compiled(block):
        def __call__(self, x, train):
            if self.is_initializing():
                return super().__call__(x, train)
            variables = self.variables
            stats = variables.get("batch_stats", {})
            fn = _block_fn(block, tuple((f, getattr(self, f)) for f in fields), train)
            y, new = fn(variables["params"], stats, x)
            if train is True and self.is_mutable_collection("batch_stats"):
                _put(self.scope, "batch_stats", new)
            return y

    Compiled.__name__ = Compiled.__qualname__ = block.__name__
    return Compiled


def compiled_hrnet_blocks(monkeypatch) -> None:
    """Run the JAX HRNet's ``HighResolutionModule`` (``models/hrnet.py``)
    and blocks (``BasicBlock``, ``Bottleneck``, ``ConvBN``;
    ``models/layers.py``) compiled per configuration and shape, forward and
    backward, even inside ``jax.disable_jit()``.

    The parity tests run the JAX model eagerly so that no whole-model
    compile enters them; an eager HRNet then dispatches the ops of its ~300
    conv + BN blocks one at a time, forward and backward, each op shape
    compiled on first use (~900 compiles, ~70 s, for an hrnet18 train step
    at 64x64).  Compiled, a block is one call each way, and the compiles go
    to the persistent cache that ``shared_jax_compiles`` opens to the other
    workers.  The blocks' code, names and variables are the JAX package's
    own, which is unchanged; compiled and eager evaluation agree to fp32
    rounding.  A model on the Pallas conv needs ``compiled_pallas_conv``
    too: the interpret-mode kernel body, traced into a block, takes minutes
    to compile.
    """
    import contrastiveseg_tpu.models.heads as jheads
    import contrastiveseg_tpu.models.hrnet as jhrnet
    import contrastiveseg_tpu.models.layers as jlayers

    for mod, source, names in (
            (jhrnet, jhrnet, ("HighResolutionModule",)),
            (jhrnet, jlayers, ("BasicBlock", "Bottleneck", "ConvBN")),
            (jheads, jlayers, ("ConvBN",))):
        for name in names:
            monkeypatch.setattr(mod, name, _compiled(getattr(source, name)))


def random_variables(jax_model, input_shape, seed: int = 1) -> dict:
    """numpy {"params", "batch_stats"} in the shape of ``jax_model``'s
    variables: lecun-normal kernels, small biases, BN scale near 1 and
    running variances in [0.5, 1.5].  ``jax.eval_shape`` gives the tree
    without compiling anything."""
    shapes = jax.eval_shape(
        lambda: jax_model.init({"params": jax.random.key(0),
                                "dropout": jax.random.key(1)},
                               jnp.zeros(input_shape, jnp.float32), train=True))
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(dict(v))
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            else:  # bias, BN bias, running mean
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return out

    return {col: fill(dict(shapes.get(col, {}))) for col in ("params", "batch_stats")}


def assert_scaled_close(got, want, rtol: float = 1e-4, err_msg: str = "",
                        floor: float = 1e-30) -> float:
    """``max|got - want| <= rtol * max(max|want|, floor)``: a tensor held to
    a share of its own largest value (a weight gradient sums many terms, and
    its small entries carry the rounding of the large ones); ``floor`` for a
    tensor whose exact value is ~0 (the gradient of a conv bias that feeds a
    BN).  Returns the share."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    share = float(np.abs(got - want).max() / max(np.abs(want).max(), floor))
    assert share <= rtol, f"{err_msg}: max error {share:.3g} of the tensor's largest value"
    return share


def no_dropout(torch_model):
    """``torch_model`` with every ``nn.Dropout``'s rate set to 0 (the JAX
    side patches flax's ``Dropout`` to the identity)."""
    import torch

    for m in torch_model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return torch_model


def bn_counts(torch_model, x):
    """Run ``torch_model`` on ``x`` and return {bn module name: number of
    values each channel's batch statistics average over}."""
    import torch

    counts, hooks = {}, []
    for name, mod in torch_model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            hooks.append(mod.register_forward_hook(
                lambda m, inp, out, name=name:
                counts.__setitem__(name, inp[0].numel() // inp[0].shape[1])))
    try:
        with torch.no_grad():
            torch_model(x)
    finally:
        for h in hooks:
            h.remove()
    return counts


def compiled_pallas_conv(monkeypatch) -> list:
    """Run the JAX package's Pallas conv (``ops/conv_pallas.py``), in
    interpret mode, as one opaque call per kernel launch, compiled once per
    conv shape; returns the list that each launch appends its input shape
    to.

    Traced into a model, the interpret-mode kernel body unrolls into a
    graph that takes minutes to compile, and run eagerly it evaluates op by
    op.  Here the two kernel calls (the forward, which the custom VJP also
    runs for dX, and dW) are ``jax.pure_callback``s to their own compiled
    functions, so a jitted model or train step holds them as host calls
    (a test-time patch; the JAX package is unchanged).  The values are the
    kernels' own.
    """
    import contrastiveseg_tpu.ops.conv_pallas as jconv

    statics = ("block_h", "sub_h", "interpret")
    fwd = jax.jit(jconv.conv3x3_small_c, static_argnames=statics)
    dw = jax.jit(jconv._conv3x3_dw, static_argnames=statics)
    calls = []

    def opaque(fn, shape, *args, **static):
        def host(*arrays):
            calls.append(tuple(arrays[0].shape))
            with jax.disable_jit(False):
                return np.asarray(fn(*arrays, **static))

        return jax.pure_callback(host, shape, *args)

    def conv3x3_small_c(x, w, block_h=32, sub_h=8, interpret=False):
        shape = jax.ShapeDtypeStruct((*x.shape[:3], w.shape[-1]), x.dtype)
        return opaque(fwd, shape, x, w, block_h=block_h, sub_h=sub_h, interpret=interpret)

    def conv3x3_dw(x, g, block_h, sub_h, interpret=False):
        shape = jax.ShapeDtypeStruct((3, 3, x.shape[-1], g.shape[-1]), jnp.float32)
        return opaque(dw, shape, x, g, block_h=block_h, sub_h=sub_h, interpret=interpret)

    monkeypatch.setattr(jconv, "conv3x3_small_c", conv3x3_small_c)
    monkeypatch.setattr(jconv, "_conv3x3_dw", conv3x3_dw)
    return calls


@contextlib.contextmanager
def shared_jax_compiles():
    """Send every JAX compile inside the block to the persistent compilation
    cache that ``tests/conftest.py`` sets up, down to the single primitives
    that an eager (``jax.disable_jit``) HRNet compiles one by one.

    The eager JAX sides of the port's parity tests spend most of their time
    on those compiles, and several test files compile the same hrnet18
    primitives at the same shapes in different worker processes; from the
    cache the later ones load them instead.  The JAX computations and what
    the tests compare are unchanged.
    """
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    try:
        yield
    finally:
        jax.config.update(key, old)


@contextlib.contextmanager
def unoptimized_jax_compiles():
    """Compile the JAX side inside the block with most of XLA's
    optimizations off (``jax_disable_most_optimizations``).

    A parity test runs each JAX program once, on inputs of a few hundred
    kilobytes, so its compile is most of its cost: for the jitted gradient
    of a shallow HRNet-OCR, 6.7 s optimized and 3.4 s not, against 0.3 s to
    run.  The program computes the same fp32 values up to the order of its
    sums: for tests whose tolerances stand far above that order, as their
    readings show."""
    key = "jax_disable_most_optimizations"
    old = jax.config.values[key]
    jax.config.update(key, True)
    try:
        yield
    finally:
        jax.config.update(key, old)


@contextlib.contextmanager
def one_torch_thread():
    """Run torch on one intra-op thread inside the block.

    The suite runs in several worker processes on a few cores, and torch's
    thread pool in each of them oversubscribes the cores and stalls at its
    barriers: the checkpoint test, 7 s alone, took 238 s beside five busy
    workers.  Only for tests whose checks hold at any summation order that
    the thread count sets, as their readings on 1 and 8 threads show.
    """
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tf32(x):
    """The tensor cores' view of an fp32 operand: its 13 low mantissa bits
    dropped (truncated, as the kernels' split leaves them)."""
    import torch

    return (x.view(torch.int32) & -8192).view(torch.float32)


def mm_tf32(x, y, split: bool):
    """x @ y.T as the port's tensor-core kernels compute it (K1, K2b): with
    ``split``, 3xTF32 (x = hi + lo with hi = tf32(x), lo = x - hi read as
    tf32; hi.hi + hi.lo + lo.hi in fp32); without, one TF32 product."""
    xh, yh = tf32(x), tf32(y)
    if not split:
        return xh @ yh.T
    xl, yl = tf32(x - xh), tf32(y - yh)
    return xh @ yh.T + (xh @ yl.T + xl @ yh.T)


def write_tree(root: Path, n_train: int = 6, n_val: int = 2, hw=(96, 192), seed: int = 0):
    """A Cityscapes-layout tree, {root}/{split}/image|label/*.png: Voronoi-ish
    scenes of raw Cityscapes ids (0 among them, which relabels to -1)."""
    from PIL import Image

    from contrastiveseg_tpu_torch.data.datasets import CITYSCAPES_LABEL_LIST

    rng = np.random.default_rng(seed)
    h, w = hw
    raw_ids = np.asarray([0] + CITYSCAPES_LABEL_LIST[:4])
    for split, n in (("train", n_train), ("val", n_val)):
        (root / split / "image").mkdir(parents=True)
        (root / split / "label").mkdir(parents=True)
        for i in range(n):
            cy, cx = rng.uniform(0, h, 8), rng.uniform(0, w, 8)
            yy, xx = np.mgrid[0:h, 0:w]
            near = np.argmin((yy[None] - cy[:, None, None]) ** 2
                             + (xx[None] - cx[:, None, None]) ** 2, axis=0)
            label = raw_ids[rng.integers(0, len(raw_ids), 8)][near].astype(np.uint8)
            image = rng.uniform(0, 255, (len(raw_ids), 3))[np.searchsorted(raw_ids, label)]
            image = np.clip(image + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(image).save(root / split / "image" / f"f{i}.png")
            Image.fromarray(label).save(root / split / "label" / f"f{i}.png")
    return root


def shallow_hrnet18(monkeypatch) -> None:
    """Put a shallow hrnet18 into both packages' ``HRNET_SPECS["hrnet18"]``:
    the W18 widths (stem 64; branches 18, 36, 72, 144) and every fuse, at
    one module of one block a stage.  A whole hrnet18 takes the JAX package
    ~90 s to compile on the CPU, this one a few seconds."""
    import contrastiveseg_tpu.models.hrnet as jhrnet

    from contrastiveseg_tpu_torch.models import hrnet

    for mod in (jhrnet, hrnet):
        monkeypatch.setitem(mod.HRNET_SPECS, "hrnet18", mod.HRNetSpec(
            64, 1, 64, mod.StageSpec(1, 1, (18, 36)), mod.StageSpec(1, 1, (18, 36, 72)),
            mod.StageSpec(1, 1, (18, 36, 72, 144))))


SHALLOW_RESNET = "deepbase_resnet_shallow_dilated8"
SHALLOW_RESNET_PLAIN_STEM = "resnet_shallow_dilated8"


def shallow_resnet(monkeypatch) -> None:
    """Put a shallow dilated-8 bottleneck ResNet, layers (1, 1, 2, 2), into
    both packages' ``RESNET_SPECS``: ``SHALLOW_RESNET`` with the deep-base
    stem and ``SHALLOW_RESNET_PLAIN_STEM`` with the 7x7 one.  Layer3 gets
    dilations [1, 2] and layer4 [2, 4], so both first-block rules of
    ``_nostride_dilate`` show, at the full widths (c4 has 2048 channels)."""
    import contrastiveseg_tpu.models.resnet as jresnet

    from contrastiveseg_tpu_torch.models import resnet

    for mod in (jresnet, resnet):
        monkeypatch.setitem(mod.RESNET_SPECS, SHALLOW_RESNET,
                            mod.ResNetSpec((1, 1, 2, 2), dilate_scale=8))
        monkeypatch.setitem(mod.RESNET_SPECS, SHALLOW_RESNET_PLAIN_STEM,
                            mod.ResNetSpec((1, 1, 2, 2), deep_base=False, dilate_scale=8))


def tiny_hrnet_spec():
    """The port's ``HRNetSpec`` of ``tiny_hrnet``."""
    from contrastiveseg_tpu_torch.models.hrnet import HRNetSpec, StageSpec

    return HRNetSpec(16, 1, 16, StageSpec(1, 1, (8, 16)), StageSpec(1, 1, (8, 16, 32)),
                     StageSpec(1, 1, (8, 16, 32, 64)))


def tiny_hrnet(monkeypatch) -> None:
    """Build the port's hrnet18 as a tiny HRNet: the same topology (four
    stages, every fuse) at one block a stage and widths 8-64, for tests
    whose cost grows with the number of ops (``torch.export`` traces it in
    seconds) and that compare the port with itself."""
    from contrastiveseg_tpu_torch.models import hrnet

    monkeypatch.setitem(hrnet.HRNET_SPECS, "hrnet18", tiny_hrnet_spec())
