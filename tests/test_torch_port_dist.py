"""Multi-GPU training of the port, on the CPU: 2 gloo ranks against one process.

The JAX package trains one global-view program on a device mesh, so its BN
statistics, CE mean, anchor set and enqueue are the global batch's; its
own ``test_spmd_equivalence.py`` holds the mesh step to its solo step.
Here 2 processes of ``tests/torch_port_dist_worker.py``, spawned once for
the file on free ports (``parallel.init_from_env("cpu")``: gloo), each take
half of every global input and run every scenario; the parent holds them to
the JAX solo step on the global batch (with the JAX step's draws, which
every rank gets whole) and to the port's single-process functions:

1. ``models/layers.BatchNorm2d`` in train mode on 2 x 2 images against the
   port's BN on all 4: output and dX atol 2e-6 (values of order 1), the
   ranks' summed dweight and dbias within 1e-6 of their largest value,
   running statistics (momentum 0.1, and momentum None after a reset, as
   SWA's re-estimation runs) atol 1e-6 and equal on both ranks;
2. ``ops/contrast.global_anchor_sample`` on 2 x 2 images against
   ``hard_anchor_sample`` on all 4 with the same scores (an ``[:M]`` cut and
   a ``total_classes`` that differ from each rank's own): the anchors bit
   for bit; the InfoNCE against a queue (K1's wrapper) and against itself,
   the loss within 1e-6 and d embed (each rank's gradient over the world
   size, DDP's mean) within 1e-6;
3. the upsampled CE and the CE of full-size logits with 60% ignored pixels
   on one rank and 5% on the other: the ranks' mean within 1e-6 of the
   global CE, each rank's gradient over the world size within 1e-7;
4. two headline steps (``smoke_hrnet_w18`` on a shallow hrnet18, bank,
   contrast live) on 2 ranks of 1 image under DDP against two JAX solo
   steps on both (``tests/test_torch_port_slice.py``'s), each held after
   it: losses rtol 1e-4, parameters atol 5e-3 (the JAX mesh test's) and
   each update within 4e-2 of JAX's in relative norm (the slice test's),
   BN statistics atol 1e-4, bank pointers equal, bank rows atol 1e-5; both
   ranks' parameters and banks equal bit for bit.  Step 1 runs without
   DDP's reducer (``parallel.exclude_unreached``), step 2 through it, as
   every later step.  Step 2's update and enqueued bank rows are held to
   those of one process's step 2 from the DDP state after step 1 (the
   workers run it once their group is gone): from states 5e-7 apart the
   step-2 updates of JAX and of the port on one process, or of the port
   on one process and on 2 ranks, part by up to 5.7e-2 in relative norm
   (read here);
5. the same with ``solver.grad_accum_steps=2`` and the key encoder on 2
   ranks of 2 images against the JAX accumulation step on 4
   (``tests/test_torch_port_training_extras.py``'s): each rank holds its
   share of each JAX microbatch; key parameters atol 1e-6;
6. the trainer's validation of 5 frames on 2 ranks (3 and 2 frames, one a
   batch) gives the single-process trainer's confusion matrix at batch 1,
   entry for entry;
7. a stop asked for on rank 1 in step 1 of 2 stops both ranks after it;
   ``latest``, written by rank 0, restores into a single-process trainer bit
   for bit, and equals both ranks' states;
8. ``--phase test`` and ``tools/export_torch.py`` raise at world size 2;
   OHEM, RMI and CE + Lovasz return there;
9. ``parallel.global_kth_smallest`` of 300 values on rank 0 and 40 on rank
   1 (ties, negatives, values above 2) at k 0, mid and last, with k_max
   below rank 0's count and above rank 1's: ``torch.sort`` of the
   concatenation at k, bit for bit;
10. OHEM (``ohem_cross_entropy``) on 2 x 2 images of 33x65 with 7 classes,
    60% ignored pixels on rank 0 and 5% on rank 1, in three cases: the
    global k-th smallest true-class probability on rank 0, a ``min_kept``
    above the global valid count, and ``thresh`` dominating; each against
    JAX ``ohem_cross_entropy`` on all 4 images: the ranks' mean rtol 1e-6,
    each rank's gradient over the world size atol 1e-7; the ranks' own OHEM
    (no process group) more than 1e-3 from it; the kept pixels and the
    threshold the port's single-process selection's;
11. ``rmi_loss`` on the same images against JAX ``rmi_loss``: rtol 1e-5,
    gradients over the world size atol 1e-6;
12. ``ce_lovasz_loss`` of logits drawn from 4 rows, so that the errors tie
    across the ranks, against JAX ``ce_lovasz_loss``: rtol 1e-6, gradients
    over the world size atol 1e-7 (the tie order is JAX's);
13. one step on 2 ranks of 1 image under DDP against the port's
    single-process step on both (which the port's other tests hold to JAX;
    the workers run it once their process group is gone), each held after
    it: ``cityscapes_hrnet_w48_ocr_ohem`` on a shallow hrnet18 at 48x48
    (``thresh`` 0 and ``min_kept`` a third of the pixels, so that the global
    selection bites), ``lip_ce2p_ocrnet`` on a shallow dilated-16 ResNet at
    49x49 for two steps (its edge branch, which ``fs_auxce_loss`` never
    reaches: zero gradients on both ranks, the same parameters as one
    process's, moved by weight decay and momentum alone, in the first step
    and under the reducer that it settled) and ``cityscapes_deeplab_v3`` on
    a shallow ResNet at 32x32, one image a rank (its image-pool BN over the
    global batch), whose parameters all take a gradient: losses rtol 1e-5,
    parameters and BN statistics atol 1e-6, both ranks bit for bit (the
    workers compare each tensor themselves and write the differences and
    each rank's digests: the float64 states take gigabytes).  The nets run
    in float64 (the losses in fp32, as always): in fp32 the BN backward of a
    randomly initialised net cancels digits, and the two BN routes (one
    process's ``nn.BatchNorm2d``, ``GlobalBatchNorm`` over 2 ranks) give
    weight gradients 0.7-6.9% apart, as far as each is from float64 (read
    on these nets at 64x64), which after a step at the presets' LR is
    1e-4 to 7e-3 in a weight.

``DataPipeline.__len__`` with 2 shards needs no process group: each val
frame counts once.  Nor do ``parallel.init_from_env``'s refusals: without
torchrun's variables, for a device type with no backend, and for CUDA on a
machine without a GPU, it raises and makes no group.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastiveseg_tpu.data.datasets import SyntheticSegDataset as JSynthetic
from contrastiveseg_tpu.engine.optim import build_optimizer as jbuild_optimizer
from contrastiveseg_tpu.engine.state import TrainState as JTrainState
from contrastiveseg_tpu.engine.train_step import make_train_step as jmake_train_step
from contrastiveseg_tpu.losses.ce import ohem_cross_entropy as johem
from contrastiveseg_tpu.losses.lovasz import ce_lovasz_loss as jlovasz
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.losses.rmi import rmi_loss as jrmi
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.ops.queue import MemoryBank as JBank
from contrastiveseg_tpu.presets import get_preset
from contrastiveseg_tpu_torch.data.pipeline import DataPipeline
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.checkpoint import state_dict
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.losses.ce import (
    cross_entropy,
    ohem_cross_entropy,
    ohem_selection,
    upsampled_cross_entropy,
)
from contrastiveseg_tpu_torch.models import hrnet, resnet
from contrastiveseg_tpu_torch.models.layers import TorchBatchNorm
from contrastiveseg_tpu_torch.ops.contrast import (
    ContrastSpec,
    contrastive_loss,
    hard_anchor_sample,
)
from contrastiveseg_tpu_torch.ops.contrast_cuda import cuda_contrastive_loss
from contrastiveseg_tpu_torch.parallel import global_kth_smallest
from contrastiveseg_tpu_torch.presets import get_preset as port_preset
from contrastiveseg_tpu_torch.utils.jax_weights import hrnet_seg_key, to_port

from torch_port_helpers import (
    SHALLOW_RESNET,
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
    shallow_resnet,
    shared_jax_compiles,
    tiny_hrnet,
    tiny_hrnet_spec,
    unoptimized_jax_compiles,
)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_port_dist_worker.py")
WORLD = 2
H = W = 64
M_KEY = 0.9  # contrast.encoder_momentum
STEP = {"network.head_dropout": 0.0, "contrast.exact_sampling": True}
ACCUM = {**STEP, "contrast.momentum_encoder": True, "contrast.encoder_momentum": M_KEY,
         "solver.grad_accum_steps": 2}
OHEM_CASES = ("kth_on_sparse_rank", "min_kept_above_valid", "thresh_dominates")
SHALLOW16 = "deepbase_resnet_shallow_dilated16"
PRESETS = ("ohem", "ce2p", "deeplab")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_config(extra: dict):
    cfg = get_preset("smoke_hrnet_w18")
    for k, v in extra.items():
        cfg = cfg.updated(k, v)
    return cfg


def _batch(cfg, n: int, start: int = 0) -> dict:
    ds = JSynthetic(num_classes=5, size_hw=(H, W), length=8)
    p = cfg.get("normalize")
    norm = Normalizer(p["div_value"], p["mean_value"], p["std"])
    samples = [ds[i] for i in range(start, start + n)]
    return {"image": np.stack([norm(s["image"]) for s in samples]).astype(np.float32),
            "label": np.stack([s["label"] for s in samples]).astype(np.int64)}


def _bank(cfg, seed=3):
    rng = np.random.default_rng(seed)
    C, Mq, D = 5, cfg.get("contrast.memory_size"), cfg.get("contrast.proj_dim")

    def q():
        x = rng.standard_normal((C, Mq, D)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return q(), rng.integers(0, Mq, C).astype(np.int32), q(), rng.integers(
        0, Mq, C).astype(np.int32)


def _draws(r_sample, r_queue, b, C, n) -> dict:
    khard, keasy = jax.random.split(r_sample)
    return {k: np.asarray(jax.random.uniform(key, (b, C, n)))
            for k, key in (("hard", khard), ("easy", keasy), ("queue", r_queue))}


def _step_draws(rng, A: int, B: int, C: int, n: int) -> tuple[list[dict], jax.Array]:
    """The draws of a JAX step from the state's ``rng``, a list of one a
    microbatch, and the state's next rng (``engine/train_step.py``: :74
    without accumulation, :143 with it)."""
    if A == 1:
        nxt, _, r_sample, r_queue = jax.random.split(rng, 4)
        return [_draws(r_sample, r_queue, B, C, n)], nxt
    nxt, r_step = jax.random.split(rng)
    micro = jax.random.split(r_step, 3 * A).reshape(A, 3)
    return [_draws(micro[i, 1], micro[i, 2], B // A, C, n) for i in range(A)], nxt


def _step_case(extra: dict, B: int, variables: dict) -> dict:
    """The inputs of a step case: ``variables`` (and key weights near them
    with the key encoder), bank, the global batches of two steps, the JAX
    steps' draws, each rank's rows."""
    cfg = _jax_config(extra)
    A = extra.get("solver.grad_accum_steps", 1)
    C, n = cfg.get("data.num_classes"), (H // 4) * (W // 4)
    rng, draws = jax.random.key(7), []
    for _ in range(2):
        d, rng = _step_draws(rng, A, B, C, n)
        draws.append(d)
    # Rank r's share of global microbatch i is its rows [i*B/A + r*B/(A*S), ...).
    share = B // (A * WORLD)
    rows = [[i * B // A + r * share + j for i in range(A) for j in range(share)]
            for r in range(WORLD)]
    key_rng = np.random.default_rng(5)
    key_params = (jax.tree.map(lambda a: (a + 0.1 * key_rng.standard_normal(a.shape))
                               .astype(np.float32), variables["params"])
                  if extra.get("contrast.momentum_encoder") else None)
    return {"overrides": extra, "variables": variables, "key_params": key_params,
            "bank": _bank(cfg), "batches": [_batch(cfg, B, i * B) for i in range(2)],
            "draws": draws, "rows": rows}


def _jax_step(case: dict) -> list:
    """Two JAX solo steps on the whole global batches (the programs of
    ``test_torch_port_slice.py`` and ``test_torch_port_training_extras.py``):
    after each, (state, metrics)."""
    extra = case["overrides"]
    cfg = _jax_config(extra)
    A = extra.get("solver.grad_accum_steps", 1)
    keyed = case["key_params"] is not None
    jmodel = jbuild_model(cfg)
    variables = case["variables"]
    tx = jbuild_optimizer(cfg, variables["params"])
    s0 = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        bank=JBank(*(jnp.asarray(a) for a in case["bank"])), rng=jax.random.key(7), tx=tx,
        **({"key_params": case["key_params"]} if keyed else {}))
    step = jmake_train_step(
        jmodel, jbuild_loss(cfg), warmup_iters=0, network_stride=4,
        pixel_update_freq=cfg.get("contrast.pixel_update_freq"), donate=False,
        exact_sampling=True,
        **({"momentum_encoder": True, "encoder_momentum": M_KEY, "grad_accum_steps": A}
           if keyed else {}))
    out = []
    for batch in case["batches"]:
        s0, metrics = step(s0, {"image": jnp.asarray(batch["image"]),
                                "label": jnp.asarray(batch["label"].astype(np.int32))})
        out.append((s0, metrics))
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    C = 6
    bn = {"x": (2.0 + 3.0 * rng.standard_normal((4, C, 5, 7))).astype(np.float32),
          "g": rng.standard_normal((4, C, 5, 7)).astype(np.float32),
          "weight": rng.uniform(0.5, 1.5, C).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
          "running_mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
          "running_var": rng.uniform(0.5, 1.5, C).astype(np.float32)}

    B, N, D, K, Ca = 4, 64, 16, 30, 3
    embed = rng.standard_normal((B, N, D)).astype(np.float32)
    labels = rng.integers(0, Ca, (B, N))
    labels[3] = rng.integers(0, 2, N)
    labels[3, :3] = 2  # 3 pixels: an invalid slot (count <= max_views)
    predict = np.where(rng.uniform(size=(B, N)) < 0.6, labels, rng.integers(0, Ca, (B, N)))
    q = rng.standard_normal((K, D)).astype(np.float32)
    anchors = {"embed": embed / np.linalg.norm(embed, axis=-1, keepdims=True),
               "labels": labels, "predict": predict,
               "hard": rng.uniform(size=(B, Ca, N)).astype(np.float32),
               "easy": rng.uniform(size=(B, Ca, N)).astype(np.float32),
               "q_feats": q / np.linalg.norm(q, axis=-1, keepdims=True),
               "q_labels": rng.integers(0, Ca, K).astype(np.int32),
               "q_valid": rng.uniform(size=K) > 0.1,
               "spec": {"num_classes": Ca, "max_samples": 40, "max_views": 4,
                        "temperature": 0.1, "base_temperature": 0.07}}

    lab = rng.integers(0, 5, (4, 32, 32))
    for rows, share in ((slice(0, 2), 0.6), (slice(2, 4), 0.05)):
        lab[rows][rng.uniform(size=lab[rows].shape) < share] = -1
    ce = {"seg": rng.standard_normal((4, 8, 8, 5)).astype(np.float32),
          "full": rng.standard_normal((4, 32, 32, 5)).astype(np.float32),
          "labels": lab, "class_weight": (1.0, 2.0, 0.5, 1.0, 1.5)}
    variables = random_variables(jbuild_model(_jax_config(STEP)), (1, H, W, 3), seed=2)
    return {"bn": bn, "anchors": anchors, "ce": ce, "step": _step_case(STEP, 2, variables),
            "accum": _step_case(ACCUM, 4, variables), "kth": _kth_inputs(rng),
            "global_losses": _global_loss_inputs(rng), "presets": _preset_cases(rng)}


def _kth_inputs(rng) -> dict:
    """300 values on rank 0, 40 on rank 1, on a grid (ties), some negative
    and some above 2; (k, k_max) at k 0, mid and last."""
    values = [(rng.integers(-40, 400, n) / 16.0).astype(np.float32) for n in (300, 40)]
    return {"values": values, "cases": [(0, 100), (170, 170), (339, 339)]}


def _true_class_p(logits, labels) -> np.ndarray:
    p = torch.softmax(torch.from_numpy(logits), -1)
    safe = torch.from_numpy(labels).clamp(min=0)
    return torch.gather(p, -1, safe[..., None])[..., 0].numpy()


def _global_loss_inputs(rng) -> dict:
    """2 x 2 images of 33x65, 7 classes, 60% ignored on rank 0 and 5% on
    rank 1; OHEM's (thresh, min_kept) cases; logits of 4 rows for Lovasz."""
    B, h, w, C = 4, 33, 65, 7
    labels = rng.integers(0, C, (B, h, w))
    for rows, share in ((slice(0, 2), 0.6), (slice(2, 4), 0.05)):
        labels[rows][rng.uniform(size=labels[rows].shape) < share] = -1
    logits = (2.0 * rng.standard_normal((B, h, w, C))).astype(np.float32)
    # Case 1: thresh 0 and min_kept = k, where the global k-th smallest
    # true-class probability is on rank 0 and 1e-4 from its neighbours (so
    # that no rounding of the two packages' softmax moves a pixel across it).
    p = _true_class_p(logits, labels)
    valid = labels >= 0
    order = np.argsort(np.where(valid, p, 2.0), axis=None, kind="stable")
    sorted_p = p.reshape(-1)[order]
    n_valid = int(valid.sum())
    on_rank0 = order < 2 * h * w
    gaps = np.minimum(np.diff(sorted_p, prepend=-1.0), np.diff(sorted_p, append=3.0))
    k = next(i for i in range(n_valid // 3, n_valid - 1) if on_rank0[i] and gaps[i] > 1e-4)
    pool = (2.0 * rng.standard_normal((4, C))).astype(np.float32)
    return {"labels": labels, "logits": logits, "tied": pool[rng.integers(0, 4, (B, h, w))],
            "class_weight": tuple(float(x) for x in rng.uniform(0.5, 1.5, C)),
            "ohem_cases": [(0.0, k), (0.9, 2 * n_valid), (0.6, 50)], "n_valid": n_valid}


def _preset_cases(rng) -> dict:
    """Each preset step's config, shallow trunk and global batch of 2."""
    def labels(n_classes, hw, cell=8):
        lab = rng.integers(-1, n_classes, (2, hw // cell + 1, hw // cell + 1))
        return lab.repeat(cell, 1).repeat(cell, 2)[:, :hw, :hw].astype(np.int64)

    def images(hw):
        return rng.standard_normal((2, hw, hw, 3)).astype(np.float32)

    specs = {SHALLOW16: resnet.ResNetSpec((1, 1, 2, 2), dilate_scale=16),
             SHALLOW_RESNET: resnet.ResNetSpec((1, 1, 2, 2), dilate_scale=8)}
    # 48x48: HRNet's stride-32 branch is 2x2 (at 32x32 its BN of 1x1 maps
    # normalises 2 values a channel, which amplifies rounding block by block).
    ohem_label = labels(19, 48)
    ohem_label[0, :, :24] = -1  # unequal valid counts
    cases = {
        "ohem": {"preset": "cityscapes_hrnet_w48_ocr_ohem", "overrides": {
            "network.backbone": "hrnet18", "loss.params.ohem_thresh": 0.0,
            "loss.params.ohem_minkeep": int((ohem_label >= 0).sum()) // 3},
            "batches": [{"image": images(48), "label": ohem_label}]},
        "ce2p": {"preset": "lip_ce2p_ocrnet", "overrides": {"network.backbone": SHALLOW16},
                 "batches": [{"image": images(49), "label": labels(20, 49, 7)}]},
        "deeplab": {"preset": "cityscapes_deeplab_v3",
                    "overrides": {"network.backbone": SHALLOW_RESNET},
                    "batches": [{"image": images(32), "label": labels(19, 32)}]},
    }
    # CE2P takes a second step, under the reducer that its first one settled.
    cases["ce2p"]["batches"].append({"image": images(49), "label": labels(20, 49, 7)})
    return cases, specs


def _jax_global_losses(inp: dict) -> dict:
    """JAX's OHEM cases, RMI and CE + Lovasz on all 4 images: (value,
    gradient of the logits)."""
    labels = jnp.asarray(inp["labels"].astype(np.int32))
    cw, C = inp["class_weight"], inp["logits"].shape[-1]

    def run(fn, key="logits", *args):
        value, grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(inp[key]), *args)
        return float(value), np.asarray(grad)

    ohem = jax.jit(jax.value_and_grad(lambda x, t, m: johem(x, labels, t, m, cw)))
    return {"ohem": [tuple(map(np.asarray, ohem(jnp.asarray(inp["logits"]), jnp.float32(t),
                                                jnp.int32(m))))
                     for t, m in inp["ohem_cases"]],
            "rmi": run(lambda x: jrmi(x, labels, C)),
            "lovasz": run(lambda x: jlovasz(x, labels, cw), "tied")}


def _trainer_overrides(ckpt_dir: Path, val_batch: int) -> dict:
    return {"data.synthetic_length": 5, "solver.max_iters": 2, "solver.test_interval": 1,
            "checkpoints.save_iters": 1, "checkpoints.checkpoints_dir": str(ckpt_dir),
            "val.batch_size": val_batch, "contrast.max_views": 4}


def _trainer_config(overrides: dict):
    cfg = port_preset("smoke_hrnet_w18")
    for k, v in overrides.items():
        cfg = cfg.updated(k, v)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' outputs, the inputs, and the JAX solo steps, computed
    while the workers run."""
    tmp = tmp_path_factory.mktemp("dist")
    mp = pytest.MonkeyPatch()
    shallow_hrnet18(mp)
    shallow_resnet(mp)
    exact_fp32_reference(mp, compiled_blocks=False)
    try:
        with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
            inputs = _inputs()
            inputs["presets"], specs = inputs["presets"]
            for name, spec in specs.items():
                mp.setitem(resnet.RESNET_SPECS, name, spec)
            for case in inputs["presets"].values():
                case["resnet_specs"] = specs
            inputs["shallow_spec"] = hrnet.HRNET_SPECS["hrnet18"]
            inputs["tiny_spec"] = tiny_hrnet_spec()
            inputs["trainer"] = {"overrides": _trainer_overrides(tmp / "ckpt", WORLD)}
            torch.save(inputs, tmp / "inputs.pt")
            port = str(_free_port())
            env = {**os.environ, "PYTHONPATH": os.pathsep.join(
                [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]),
                "WORLD_SIZE": str(WORLD), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                "OMP_NUM_THREADS": "1"}
            logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
            procs = [subprocess.Popen(
                [sys.executable, str(WORKER), str(tmp / "inputs.pt"), str(tmp / f"out{r}.pt")],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
                stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
            try:
                jax_steps = {name: _jax_step(inputs[name]) for name in ("step", "accum")}
                jax_losses = _jax_global_losses(inputs["global_losses"])
                for p in procs:
                    p.wait(timeout=300)
            finally:
                for p in procs:
                    p.kill()
                for f in logs:
                    f.close()
    finally:
        mp.undo()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()[-6000:]
    outs = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    assert [o["rank"] for o in outs] == list(range(WORLD))
    return {"inputs": inputs, "outs": outs, "jax": jax_steps, "tmp": tmp,
            "jax_losses": jax_losses, "solo": {k: v for o in outs for k, v in o["solo"].items()},
            "solo_steps": {k: v for o in outs for k, v in o["solo_steps"].items()}}


def _cat(outs, *path):
    def get(o):
        for p in path:
            o = o[p]
        return o
    return torch.cat([get(o) for o in outs]).numpy()


def _share(got, want, floor=1e-30) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def test_bn_over_two_ranks_is_the_global_batch_norm(runs):
    inp, outs = runs["inputs"]["bn"], runs["outs"]
    m = TorchBatchNorm(inp["x"].shape[1])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, k).copy_(torch.from_numpy(inp[k]))
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = m(x)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    np.testing.assert_allclose(_cat(outs, "bn", "y"), y.detach().numpy(), atol=2e-6)
    np.testing.assert_allclose(_cat(outs, "bn", "dx"), x.grad.numpy(), atol=2e-6)
    for k, want in (("dweight", m.weight.grad), ("dbias", m.bias.grad)):
        got = sum(o["bn"][k] for o in outs)  # DDP's sum (its mean times the world)
        assert _share(got, want) < 1e-6, k
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(outs[0]["bn"][k].numpy(), getattr(m, k).numpy(), atol=1e-6)
        assert torch.equal(outs[0]["bn"][k], outs[1]["bn"][k]), k
    m.reset_running_stats()
    m.momentum = None
    with torch.no_grad():
        m(x)
    for got, want in zip(outs[0]["bn"]["cumulative"], (m.running_mean, m.running_var)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_global_anchor_set_is_the_global_batch_sample(runs):
    inp, outs = runs["inputs"]["anchors"], runs["outs"]
    spec = ContrastSpec(**inp["spec"])
    for name in ("bank", "self"):
        embed = torch.from_numpy(inp["embed"]).requires_grad_(True)
        a = hard_anchor_sample(embed, torch.from_numpy(inp["labels"]),
                               torch.from_numpy(inp["predict"]), spec,
                               scores=(torch.from_numpy(inp["hard"]),
                                       torch.from_numpy(inp["easy"])))
        if name == "bank":
            loss = cuda_contrastive_loss(
                a.feats, a.labels, a.valid, torch.from_numpy(inp["q_feats"]),
                torch.from_numpy(inp["q_labels"]), torch.from_numpy(inp["q_valid"]),
                spec.temperature, spec.base_temperature)
        else:
            loss = contrastive_loss(a, spec)
        loss.backward()
        assert int(a.valid.sum()) == 33 and a.valid.shape[0] == spec.max_samples
        for o in outs:
            got = o["anchors"][name]
            for k in ("feats", "labels", "valid"):
                assert torch.equal(got[k], getattr(a, k)), (name, k)
            np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=1e-6)
        d_embed = _cat(outs, "anchors", name, "d_embed") / WORLD
        np.testing.assert_allclose(d_embed, embed.grad.numpy(), atol=1e-6, err_msg=name)
        assert float(loss.detach()) > 0 and np.abs(embed.grad.numpy()).max() > 1e-3


def test_ce_mean_is_the_global_batch_mean(runs):
    inp, outs = runs["inputs"]["ce"], runs["outs"]
    labels = torch.from_numpy(inp["labels"])
    ignored = [float((labels[r * 2:(r + 1) * 2] < 0).float().mean()) for r in range(WORLD)]
    assert ignored[0] > 0.5 > 0.1 > ignored[1]
    for name, fn, key in (("upsampled", upsampled_cross_entropy, "seg"),
                          ("full", cross_entropy, "full")):
        logits = torch.from_numpy(inp[key]).requires_grad_(True)
        loss = fn(logits, labels, inp["class_weight"])
        loss.backward()
        got = np.mean([float(o["ce"][name]["loss"]) for o in outs])
        np.testing.assert_allclose(got, float(loss.detach()), rtol=1e-6, err_msg=name)
        assert abs(float(outs[0]["ce"][name]["loss"]) - float(loss.detach())) > 1e-3  # a rank's own
        np.testing.assert_allclose(_cat(outs, "ce", name, "grad") / WORLD, logits.grad.numpy(),
                                   atol=1e-7, err_msg=name)


def _hold_step(runs, case: str, i: int) -> None:
    """Step ``i`` (from 0) of ``case`` on 2 ranks against the JAX solo step:
    the tolerances of the module docstring's item 4."""
    inp, outs = runs["inputs"][case], runs["outs"]
    s1, jmetrics = runs["jax"][case][i]
    got = [o[case][i] for o in outs]
    for g in got:
        assert g["step"] == i + 1
        for k in ("loss_seg", "loss_contrast", "loss"):
            np.testing.assert_allclose(g["metrics"][k], float(jmetrics[k]), rtol=1e-4,
                                       err_msg=k)
    assert got[0]["metrics"]["loss_contrast"] > 0
    sd0, sd1 = got[0]["state_dict"], got[1]["state_dict"]
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    for a, b in zip(got[0]["bank"], got[1]["bank"]):
        assert torch.equal(a, b)

    def port(tree):
        return to_port(tree, hrnet_seg_key)[0]

    # The update, and the bank rows that the step enqueues, are held to
    # those of a step from the same state: step 1's to JAX's, step 2's to
    # one process's from the DDP state after step 1 (module docstring).
    if i:
        prev = runs["jax"][case][i - 1][0]
        want_before = port(prev.params)
        got_before = {k: v.numpy() for k, v in outs[0][case][i - 1]["state_dict"].items()}
        before_ptr = np.asarray(prev.bank.segment_ptr)
        solo = runs["solo_steps"][case][0]["state_dict"]
        ref = {k: solo[k].numpy() - got_before[k] for k in got_before}
    else:
        want_before = got_before = port(inp["variables"]["params"])
        before_ptr = inp["bank"][1]
    after = port(s1.params)
    worst = 0.0
    for key, want in after.items():
        g = sd0[key].numpy()
        np.testing.assert_allclose(g, want, atol=5e-3, err_msg=key)
        d_want = ref[key] if i else want - want_before[key]
        worst = max(worst, float(np.linalg.norm(g - got_before[key] - d_want)
                                 / np.linalg.norm(d_want)))
    assert worst < 0.04, worst
    assert max(np.abs(w - want_before[k]).max() for k, w in after.items()) > 1e-3
    for key, want in port({"batch_stats": s1.batch_stats}).items():
        np.testing.assert_allclose(sd0[key].numpy(), want, atol=1e-4, err_msg=key)
    if inp["key_params"] is not None:
        for key, want in port(s1.key_params).items():
            np.testing.assert_allclose(got[0]["key_params"][key].numpy(), want,
                                       atol=1e-6, err_msg=key)

    storage, seg_ptr, pix_ptr = got[0]["bank"]
    np.testing.assert_array_equal(seg_ptr.numpy(), np.asarray(s1.bank.segment_ptr))
    np.testing.assert_array_equal(pix_ptr.numpy(), np.asarray(s1.bank.pixel_ptr))
    assert not np.array_equal(np.asarray(s1.bank.segment_ptr), before_ptr)
    C, Mq = np.asarray(s1.bank.segment_queue).shape[:2]
    queues = storage[:C * 2 * Mq].view(C, 2, Mq, -1).numpy()
    if i:  # the rows the step enqueues are the keys of its state: as the update
        want = runs["solo_steps"][case][0]["bank"][0][:C * 2 * Mq].view(C, 2, Mq, -1).numpy()
    else:
        want = np.stack([np.asarray(s1.bank.segment_queue), np.asarray(s1.bank.pixel_queue)], 1)
    np.testing.assert_allclose(queues[:, 0], want[:, 0], atol=1e-5)
    np.testing.assert_allclose(queues[:, 1], want[:, 1], atol=1e-5)


@pytest.mark.parametrize("case", ["step", "accum"])
def test_two_rank_step_is_the_jax_solo_step(runs, case):
    _hold_step(runs, case, 0)


@pytest.mark.parametrize("case", ["step", "accum"])
def test_two_rank_second_step_is_the_jax_second_step(runs, case):
    """Step 2 runs DDP's reducer past its first iteration (its static graph
    settled by step 1)."""
    _hold_step(runs, case, 1)


def _restored_trainer(runs, monkeypatch) -> Trainer:
    tiny_hrnet(monkeypatch)
    overrides = {**_trainer_overrides(runs["tmp"] / "ckpt", 1),
                 "network.resume_continue": True}
    return Trainer(_trainer_config(overrides), "cpu")


def test_two_rank_validation_is_the_global_confusion(runs, monkeypatch):
    outs = runs["outs"]
    t = _restored_trainer(runs, monkeypatch)
    with one_torch_thread():
        scores = t.validate()
    want = t.evaluator.score.confusion
    assert len(t._val_pipe) == 5 and want.sum() > 0
    for o in outs:
        np.testing.assert_array_equal(o["trainer"]["confusion"], want)
        assert o["trainer"]["miou"] == scores["miou"]


def test_latest_from_two_ranks_restores_bit_for_bit(runs, monkeypatch):
    outs = runs["outs"]
    assert [len(o["trainer"]["history"]) for o in outs] == [1, 1]  # rank 1's stop, on both
    t = _restored_trainer(runs, monkeypatch)
    assert t.state.step == 1 and outs[0]["trainer"]["latest"] == t.ckpt._path("latest")
    got = state_dict(t.state)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    for o in outs:
        for k in ("step", "model", "optimizer", "scheduler", "bank", "generator"):
            assert same(got[k], o["trainer"]["state"][k]), k


def test_what_two_ranks_refuse(runs):
    for o in runs["outs"]:
        got = o["refusals"]
        for name in ("ohem", "rmi", "lovasz"):  # computed over the global batch (10-12)
            assert got[name] is None, got[name]
        for name in ("phase_test", "export"):
            kind, msg = got[name]
            assert kind == "RuntimeError" and "world size 2" in msg, got[name]


@pytest.mark.parametrize("case", [0, 1, 2], ids=["k0", "mid", "last"])
def test_global_kth_smallest_is_the_sorted_concatenation(runs, case):
    inp = runs["inputs"]["kth"]
    k, k_max = inp["cases"][case]
    values = torch.from_numpy(np.concatenate(inp["values"]))
    want = torch.sort(values).values[k]
    assert len(inp["values"][1]) < k_max + 1  # rank 1 pads
    assert k == 0 or len(values) - 1 in (k, k_max) or len(inp["values"][0]) > k_max + 1
    for o in runs["outs"]:
        assert torch.equal(o["kth"][case], want)
    assert torch.equal(global_kth_smallest(values, torch.tensor(k), k_max), want)  # no group


def _rank_rows(r):
    return slice(2 * r, 2 * r + 2)


@pytest.mark.parametrize("case", range(3), ids=OHEM_CASES)
def test_ohem_over_two_ranks_is_the_jax_global_ohem(runs, case):
    inp, outs = runs["inputs"]["global_losses"], runs["outs"]
    thresh, min_kept = inp["ohem_cases"][case]
    want, want_grad = runs["jax_losses"]["ohem"][case]
    got = [o["global_losses"]["ohem"][case] for o in outs]
    np.testing.assert_allclose(np.mean([float(g["loss"]) for g in got]), want, rtol=1e-6)
    np.testing.assert_allclose(_cat(outs, "global_losses", "ohem", case, "grad") / WORLD,
                               want_grad, atol=1e-7)
    assert np.abs(want_grad).max() > 1e-5
    logits, labels = torch.from_numpy(inp["logits"]), torch.from_numpy(inp["labels"])
    per_rank = np.mean([float(ohem_cross_entropy(logits[_rank_rows(r)], labels[_rank_rows(r)],
                                                 thresh, min_kept, inp["class_weight"]))
                        for r in range(WORLD)])
    assert abs(per_rank - want) > 1e-3, (per_rank, want)
    keep, threshold, kept = ohem_selection(logits, labels, thresh, min_kept)
    for g in got:
        assert torch.equal(g["threshold"], threshold) and torch.equal(g["kept"], kept)
    assert torch.equal(torch.cat([g["keep"] for g in got]), keep)
    p = torch.from_numpy(np.where(inp["labels"] >= 0, _true_class_p(inp["logits"],
                                                                      inp["labels"]), 2.0))
    if case == 0:  # the k-th smallest is a pixel of rank 0, above thresh
        assert threshold > thresh and (p[_rank_rows(0)] == threshold).any()
        assert not (p[_rank_rows(1)] == threshold).any()
    elif case == 1:
        assert min_kept >= inp["n_valid"] and int(kept) >= inp["n_valid"] - 1
    else:
        assert float(threshold) == np.float32(thresh) and 0 < int(kept) < inp["n_valid"]
    assert all(o["global_losses"]["calls"]["global_kth_smallest"] == 3 for o in outs)


@pytest.mark.parametrize("loss, rtol, atol", [("rmi", 1e-5, 1e-6), ("lovasz", 1e-6, 1e-7)])
def test_rmi_and_lovasz_over_two_ranks_are_the_jax_global_losses(runs, loss, rtol, atol):
    inp, outs = runs["inputs"]["global_losses"], runs["outs"]
    want, want_grad = runs["jax_losses"][loss]
    got = np.mean([float(o["global_losses"][loss]["loss"]) for o in outs])
    np.testing.assert_allclose(got, want, rtol=rtol)
    np.testing.assert_allclose(_cat(outs, "global_losses", loss, "grad") / WORLD, want_grad,
                               atol=atol)
    assert np.abs(want_grad).max() > 1e-4
    assert all(o["global_losses"]["calls"][loss] == 1 for o in outs)
    if loss == "lovasz":  # every logit row on both ranks: ties across them
        rows = [np.unique(inp["tied"][_rank_rows(r)].reshape(-1, 7), axis=0) for r in (0, 1)]
        assert len(rows[0]) == len(rows[1]) == 4 and np.array_equal(rows[0], rows[1])


@pytest.mark.parametrize("name", PRESETS)
def test_two_rank_preset_step_is_the_single_process_step(runs, name):
    solo, outs = runs["solo"][name], runs["outs"]
    got = [o["presets"][name] for o in outs]
    steps = len(runs["inputs"]["presets"][name]["batches"])
    assert len(solo["metrics"]) == len(got[0]["metrics"]) == steps
    for i in range(steps):
        for g in got:
            for k, v in solo["metrics"][i].items():
                np.testing.assert_allclose(g["metrics"][i][k], v, rtol=1e-5,
                                           err_msg=f"step {i + 1}: {k}")
        assert got[0]["digest"][i] == got[1]["digest"][i]  # both ranks' states bit for bit
        err = solo["err"][i]
        assert max(err.values()) <= 1e-6, (i, sorted(err.items(), key=lambda kv: -kv[1])[:5])
        assert solo["moved"][i] > 1e-3
        zero = got[0]["zero_grad"][i]
        assert got[1]["zero_grad"][i] == zero == solo["zero_grad"][i]
        ignored = got[0]["ignored"][i]  # what the later steps' wrapper leaves out
        assert got[1]["ignored"][i] == ignored and set(ignored) <= set(zero)
        if name == "ce2p":  # the edge branch: zero gradients, moved by weight decay alone
            assert any(n.startswith("edge") for n in ignored), ignored
            for n in zero:  # decayed towards 0 by a zero gradient's momentum step
                assert solo["shrunk"][i][n], (i, n)
            assert sum(solo["changed"][i].values()) > len(zero) / 3
        else:
            assert zero == ignored == []


@pytest.mark.parametrize("n, batch", [(5, 1), (23, 4)])
def test_every_val_frame_counts_once_over_two_shards(n, batch):
    """No process group: pipelines with 2 shards; the old count,
    ``len(dataset) // 2`` a shard, lost the odd frame."""
    frames = list(range(n))
    pipes = [DataPipeline(frames, batch, num_shards=2, shard_index=s, shuffle=False,
                          drop_last=False) for s in (0, 1)]
    taken = [list(p._epoch_indices(0)) for p in pipes]
    assert sorted(taken[0] + taken[1]) == frames
    for p, t in zip(pipes, taken):
        assert len(p) == -(-len(t) // batch)
    assert sum(len(t) for t in taken) == n


@pytest.mark.parametrize("env, device, error", [
    ({}, "cpu", RuntimeError),  # no torchrun environment
    ({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}, "meta", ValueError),  # no backend
    ({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}, "cuda", RuntimeError),  # no GPU here
])
def test_init_from_env_refuses_without_falling_back(monkeypatch, env, device, error):
    """No process group: ``init_from_env`` raises before it makes one."""
    from contrastiveseg_tpu_torch import parallel

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA refusal needs a machine without one")
    with pytest.raises(error):
        parallel.init_from_env(device)
    assert not parallel.distributed()
