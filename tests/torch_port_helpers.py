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


def exact_fp32_reference(monkeypatch) -> None:
    """Hold the JAX HRNet to exact fp32 in two places where it trades
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

    It also runs the JAX HRNet's blocks compiled (``compiled_hrnet_blocks``),
    which changes the time of an eager forward, not its values.
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
    compiled_hrnet_blocks(monkeypatch)


def compiled(fn):
    """``fn`` under ``jax.jit``, with jit on even inside ``jax.disable_jit()``:
    an eager JAX step can call its loss through it, so that the forward of
    the loss's many small ops (anchor sampling, top-k, the InfoNCE) is one
    compiled call instead of one dispatch (and, the first time, one
    compile) each; its backward still runs op by op.  The values are the
    same to fp32 rounding."""
    jitted = jax.jit(fn)

    def call(*args, **kwargs):
        with jax.disable_jit(False):
            return jitted(*args, **kwargs)

    return call


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
    rounding.  Blocks on the Pallas conv stay eager: its interpret-mode
    kernel, traced into a block, takes minutes to compile
    (``compiled_pallas_conv`` compiles it per conv shape instead).
    """
    import contrastiveseg_tpu.models.heads as jheads
    import contrastiveseg_tpu.models.hrnet as jhrnet
    import contrastiveseg_tpu.models.layers as jlayers

    def unless_pallas(block):
        def make(*args, **kwargs):
            pallas = kwargs.get("pallas") or kwargs.get("pallas_conv")
            return (block if pallas else _compiled(block))(*args, **kwargs)

        return make

    for mod, source, names in (
            (jhrnet, jhrnet, ("HighResolutionModule",)),
            (jhrnet, jlayers, ("BasicBlock", "Bottleneck", "ConvBN")),
            (jheads, jlayers, ("ConvBN",))):
        for name in names:
            monkeypatch.setattr(mod, name, unless_pallas(getattr(source, name)))


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

    return {col: fill(dict(shapes[col])) for col in ("params", "batch_stats")}


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


def compiled_pallas_conv(monkeypatch) -> None:
    """Run the JAX package's Pallas conv (``ops/conv_pallas.py``) compiled,
    in interpret mode, even inside ``jax.disable_jit()``.

    The parity tests run the JAX model eagerly under ``jax.disable_jit`` so
    that no HRNet compile enters them; the Pallas conv's interpret mode then
    evaluates its kernel body op by op, minutes for an hrnet18 forward.
    This re-enables jit for the two kernel calls only (a test-time patch; the
    JAX package is unchanged), so each conv shape compiles once.
    """
    import contrastiveseg_tpu.ops.conv_pallas as jconv

    fwd = jconv.conv3x3_small_c
    dw = jax.jit(jconv._conv3x3_dw, static_argnames=("block_h", "sub_h", "interpret"))

    def conv3x3_small_c(x, w, block_h=32, sub_h=8, interpret=False):
        with jax.disable_jit(False):
            return fwd(x, w, block_h=block_h, sub_h=sub_h, interpret=interpret)

    def conv3x3_dw(x, g, block_h, sub_h, interpret=False):
        with jax.disable_jit(False):
            return dw(x, g, block_h=block_h, sub_h=sub_h, interpret=interpret)

    monkeypatch.setattr(jconv, "conv3x3_small_c", conv3x3_small_c)
    monkeypatch.setattr(jconv, "_conv3x3_dw", conv3x3_dw)


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
def one_torch_thread():
    """Run torch on one intra-op thread inside the block.

    The suite runs in several worker processes on a few cores, and torch's
    thread pool in each of them oversubscribes the cores and stalls at its
    barriers: the checkpoint test, 7 s alone, took 238 s beside five busy
    workers.  Only for tests whose checks do not depend on the summation
    order that the thread count sets (the slice test's tolerances do).
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


def tiny_hrnet(monkeypatch) -> None:
    """Build the port's hrnet18 as a tiny HRNet: the same topology (four
    stages, every fuse) at one block a stage and widths 8-64, for tests
    whose cost grows with the number of ops (``torch.export`` traces it in
    seconds) and that compare the port with itself."""
    from contrastiveseg_tpu_torch.models import hrnet
    from contrastiveseg_tpu_torch.models.hrnet import HRNetSpec, StageSpec

    monkeypatch.setitem(hrnet.HRNET_SPECS, "hrnet18", HRNetSpec(
        16, 1, 16, StageSpec(1, 1, (8, 16)), StageSpec(1, 1, (8, 16, 32)),
        StageSpec(1, 1, (8, 16, 32, 64))))
