"""Semantic-FPN on PVT v1, PCPVT and Twins-SVT, and the two resizes it
needs, of the port against the JAX package.

* The resizes: ``resize_nearest`` (float64 indices) exactly, and
  ``resize_bilinear_half_pixel`` within 1e-6, against the JAX package's, at
  integer and non-integer ratios up and down, 32 -> 65 and 65 -> 130 (the
  FPN's top-down path at ADE20K's 520 crop) among them.
* ``PyramidSegNet`` on a small spec of each family (widths 16-64, one or
  two blocks a stage, sr ratios 8, 4, 2, 1, 5 classes), 2 images a side,
  weights from a numpy seed carried by ``load_jax_variables``:
  - PVT v1 at 64x40 with ``img_size`` 48: its position tables (12, 6, 3, 1)
    are resized up in height and down in width to the running grids (16x10,
    8x5, 4x3, 2x2: flax's SAME padding makes 5 -> 3 and 3 -> 2), as in
    ``diverse_size`` validation;
  - PCPVT at 64x40;
  - SVT (7x7 windows; a local and a global block in stage 0, a local one
    after) at 56x40: stages 0 and 1 (14x10, 7x5) pad only their width, which
    the reference's ``-0:`` slice turns into no mask at all; stages 2 and 3
    (4x3, 2x2) pad both sides and mask.
  Train outputs and the decoder's BN statistics within atol 1e-4
  + rtol 1e-4 (read: at most 1.9e-5 apart); the input gradient and every
  parameter gradient of ``sum(seg * g)``, the port's in float64, within
  1e-4 of each tensor's largest value (read: 4.6e-6), and the port's fp32
  ones within 1e-2 of their float64 in relative norm (read: 6.1e-3, PVT
  v1's ReLU tie below; 4.2e-6 for PCPVT and SVT).  The LayerNorm epsilon
  (1e-6) and the tanh GELU are checked by this parity.  The resizes: read
  4.8e-7 at most.
* The reference layouts through the JAX importer (``pvt_backbone_path``,
  ``pcpvt_backbone_path``, ``semantic_fpn_decoder_path``) and
  ``network.pretrained``.
* The full-width nets (``semantic_fpn`` on ``pvt_small`` and ``svt_small``,
  the two the card trains, at ADE20K's 520 crop) on the meta device against
  ``jax.eval_shape``'s parameter count, and ``optim.group_method="decay"``
  against the JAX kernel mask on them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contrastiveseg_tpu.models.nets as jnets
import contrastiveseg_tpu.models.pvt as jpvt
import contrastiveseg_tpu.ops.resize as jresize
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.presets import get_preset as jget_preset
from contrastiveseg_tpu.utils import torch_import as ti
from contrastiveseg_tpu_torch.engine.optim import build_optimizer
from contrastiveseg_tpu_torch.models import nets, pvt
from contrastiveseg_tpu_torch.models.nets import build_model
from contrastiveseg_tpu_torch.ops import resize
from contrastiveseg_tpu_torch.presets import get_preset
from contrastiveseg_tpu_torch.utils.jax_weights import (
    flatten,
    key_for,
    load_jax_variables,
    to_port,
)
from contrastiveseg_tpu_torch.utils.pretrained import load_pretrained

from torch_port_helpers import (
    assert_scaled_close,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shared_jax_compiles,
    unoptimized_jax_compiles,
)

C = 5
TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(depths=(1, 1, 1, 1), heads=(1, 2, 2, 4), mlp_ratios=(2.0, 2.0, 2.0, 2.0))
# family -> (spec fields, input H x W, img_size)
FAMILIES = {
    "pvt": (dict(dims=(16, 32, 40, 64), abs_pos_embed=True), (64, 40), 48),
    "pcpvt": (dict(dims=(16, 32, 40, 64), pos_cnn=True), (64, 40), 64),
    "svt": (dict(dims=(16, 32, 48, 64), pos_cnn=True, local_windows=(7, 7, 7, 7),
                 depths=(2, 1, 1, 1)), (56, 40), 56),
}


@pytest.fixture(scope="module", autouse=True)
def _setup():
    mp = pytest.MonkeyPatch()
    for name, (fields, _, _) in FAMILIES.items():
        for mod in (jpvt, pvt):
            mp.setitem(mod.PVT_SPECS, f"{name}_test", mod.PVTSpec(**{**SMALL, **fields}))
    exact_fp32_reference(mp, compiled_blocks=False)
    with one_torch_thread(), shared_jax_compiles(), unoptimized_jax_compiles():
        yield
    mp.undo()


@pytest.mark.parametrize("n_in,n_out", [(32, 65), (65, 130), (16, 32), (65, 33), (130, 65),
                                        (7, 3), (5, 12), (12, 5)])
def test_resizes_match_jax(n_in, n_out):
    """Nearest bit for bit, half-pixel bilinear within 1e-6, on a [2, h, w,
    3] map resized to (n_out, w') in both orientations."""
    x = np.random.default_rng(n_in * n_out).standard_normal((2, n_in, n_in + 3, 3))
    x = x.astype(np.float32)
    for size in ((n_out, n_in + 3), (n_in, n_out), (n_out, n_out + 1)):
        got = resize.resize_nearest(torch.from_numpy(x), size).numpy()
        assert np.array_equal(got, np.asarray(jresize.resize_nearest(jnp.asarray(x), size)))
        got = resize.resize_bilinear_half_pixel(torch.from_numpy(x), size).numpy()
        want = np.asarray(jresize.resize_bilinear_half_pixel(jnp.asarray(x), size))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _nets(family):
    fields, (h, w), img = FAMILIES[family]
    jm = jnets.PyramidSegNet(num_classes=C, backbone=f"{family}_test", img_size=img)
    pm = nets.PyramidSegNet(C, f"{family}_test", img_size=img, input_hw=(h, w))
    return jm, pm, (h, w)


def _grads(pm, x, g, dtype):
    """Train mode: ``seg``, the input gradient and {key: parameter gradient}
    of ``sum(seg * g)`` with ``pm`` in ``dtype``."""
    pm = pm.to(dtype).train()
    pm.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    seg = pm(xt)["seg"]
    (seg * torch.from_numpy(g).to(dtype)).sum().backward()
    return (seg.detach().double().numpy(), xt.grad.double().numpy(),
            {k: p.grad.double().numpy() for k, p in pm.named_parameters()})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pyramid_net_matches_jax(family):
    """Train mode: the outputs, the BN statistics after the forward, and the
    input and parameter gradients of ``sum(seg * g)``.  (Eval mode differs
    in the decoder's BNs only, which the SETR and MS-OCR files hold; its JAX
    compile would add a third to this test's cost.)

    The gradients are those of the port in float64 (the same module,
    ``.double()``): a ReLU input within fp32 rounding of 0 takes either
    branch in an fp32 run, and the scale heads' BN over a few dozen values
    spreads the flip over its channel (PVT v1's level-2 head at this seed:
    one input at 2e-7, 0.036 on an input gradient of 12; JAX's fp32 run
    takes the float64 branch there).  The port's fp32 gradients are held to
    its float64 ones in relative norm (1e-2; read: 6.1e-3, that flip)."""
    jm, pm, (h, w) = _nets(family)
    v = random_variables(jm, (1, h, w, 3), seed=7)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    g = rng.standard_normal((2, h, w, C)).astype(np.float32)

    @jax.jit
    def jrun(v, x):
        def loss(params, x):
            out, new = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out["seg"] * g), (out["seg"], new["batch_stats"])

        (_, (seg, stats)), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(
            v["params"], x)
        return seg, stats, grads

    jseg, jstats, (jgp, jgx) = jax.tree.map(np.asarray, jrun(v, jnp.asarray(x)))
    load_jax_variables(pm, v)
    seg, gx32, gp32 = _grads(pm, x, g, torch.float32)
    np.testing.assert_allclose(seg, jseg, **TOL)
    key = key_for(pm)
    stats, _ = to_port({"batch_stats": jstats}, key)
    sd = pm.state_dict()
    assert len(stats) == 2 * 7  # the scale heads' seven BNs
    for k, arr in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), arr, **TOL, err_msg=k)
    load_jax_variables(pm, v)
    _, gx, gp = _grads(pm, x, g, torch.float64)
    assert_scaled_close(gx, jgx, err_msg="input")
    want, unmapped = to_port(jgp, key)
    assert not unmapped and gp.keys() == want.keys()
    for k, arr in want.items():
        assert_scaled_close(gp[k], arr, err_msg=k)
    for k, a in {"input": (gx32, gx), **{k: (gp32[k], gp[k]) for k in gp}}.items():
        assert np.linalg.norm(a[0] - a[1]) <= 1e-2 * np.linalg.norm(a[1]) + 1e-6, k


def test_pth_round_trips_through_the_jax_importer(tmp_path):
    """Each family's port ``state_dict`` (a bias on every conv that feeds a
    BN, as a reference file may carry) loads strictly through
    ``network.pretrained``; the JAX importer's backbone mapper (v1's or
    PCPVT/SVT's) and ``semantic_fpn_decoder_path`` map the same file onto
    the numpy variables the port was loaded from, array for array, each
    folded mean less its bias, nothing missing or left over."""
    for family in FAMILIES:
        jm, pm, (h, w) = _nets(family)
        v = random_variables(jm, (1, h, w, 3), seed=8)
        load_jax_variables(pm, v)
        file = dict(pm.state_dict())
        mapper = ti.PATH_MAPPERS["pvt_backbone" if family == "pvt" else "pcpvt_backbone"]

        def jmap(path, mapper=mapper):
            if path[0] == "backbone":
                tk = mapper(path[1:])
                if tk is not None:
                    tk.key = f"backbone.{tk.key}"
                return tk
            return ti.semantic_fpn_decoder_path(path)

        zeros = jax.tree.map(np.zeros_like, v)
        folds = {path: tk.fold_bias_key for path in flatten(zeros["batch_stats"])
                 if (tk := jmap(path)) is not None and tk.fold_bias_key}
        assert len(folds) == 7
        for i, bias in enumerate(sorted(set(folds.values()))):
            file[bias] = torch.linspace(-1, 1, 128) * (i + 1) / 7
        torch.save({"state_dict": {f"module.{k}": t for k, t in file.items()}},
                   tmp_path / f"{family}.pth")
        fresh = nets.PyramidSegNet(C, f"{family}_test", img_size=FAMILIES[family][2],
                                   input_hw=(h, w))
        assert load_pretrained(fresh, str(tmp_path / f"{family}.pth")) is None
        jvars, report = ti.convert_state_dict(zeros, {k: t.numpy() for k, t in file.items()},
                                              jmap)
        assert report["missing"] == [] and report["unused"] == []
        want_port, _ = to_port(v, key_for(fresh))
        got = fresh.state_dict()
        for col in ("params", "batch_stats"):
            out, want = flatten(jvars[col]), flatten(v[col])
            assert out.keys() == want.keys()
            for path, arr in out.items():
                expect = want[path] - file[folds[path]].numpy() if path in folds else want[path]
                assert np.array_equal(arr, expect), path
        for k, arr in want_port.items():
            fold = next((b for p, b in folds.items() if key_for(fresh)(p) == k), None)
            expect = arr - file[fold].numpy() if fold else arr
            assert np.array_equal(got[k].numpy(), expect), k


def test_full_width_nets_and_decay_groups():
    """``semantic_fpn`` on ``pvt_small`` and ``svt_small`` at ADE20K's
    520x520 crop: the port's parameters (meta device) number the JAX
    init's (``jax.eval_shape``), and ``optim.group_method="decay"`` decays
    exactly the port tensors of the JAX ``kernel`` leaves.  The backbones
    and the net the port lacks are refused by name, with their ROADMAP
    item."""
    from contrastiveseg_tpu_torch.models.backbone_selector import build_backbone

    for name in ("mobilenetv2_dilated8", "mobilenet_v1", "wide_resnet38_dilated8"):
        with pytest.raises(NotImplementedError, match="ROADMAP 7"):
            build_backbone(name)
    with pytest.raises(KeyError, match="pvt_small"):
        build_backbone("no_such_backbone")
    with pytest.raises(NotImplementedError, match="ROADMAP 7"):
        build_model(get_preset("ade20k_hrnet_w48").updated("network.model_name",
                                                           "deeplab_v3_mobilenet"))
    for backbone in ("pvt_small", "svt_small"):
        over = {"network.model_name": "semantic_fpn", "network.backbone": backbone,
                "optim.group_method": "decay", "optim.optim_method": "adamw",
                "optim.adamw.weight_decay": 0.0001}
        jcfg, cfg = jget_preset("ade20k_hrnet_w48"), get_preset("ade20k_hrnet_w48")
        for k, val in over.items():
            jcfg, cfg = jcfg.updated(k, val), cfg.updated(k, val)
        shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 520, 520, 3)), train=False))
        params = flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"]))
        with torch.device("meta"):
            pm = build_model(cfg)
        assert sum(p.numel() for p in pm.parameters()) == sum(a.size for a in params.values())
        key = key_for(pm)
        kernels = set()
        for path in params:
            target = key(path)
            if path[-1] == "kernel":
                kernels.add(getattr(target, "key", target))
        opt, _ = build_optimizer(cfg, pm)
        names = {id(p): k for k, p in pm.named_parameters()}
        decayed = {names[id(p)] for g in opt.param_groups if g["weight_decay"] > 0
                   for p in g["params"]}
        assert decayed == kernels, backbone
        assert {g["weight_decay"] for g in opt.param_groups} == {0.0001, 0.0}
