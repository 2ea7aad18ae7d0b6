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
4. one headline step (``smoke_hrnet_w18`` on a shallow hrnet18, bank,
   contrast live) on 2 ranks of 1 image under DDP against the JAX solo
   step on both (``tests/test_torch_port_slice.py``'s): losses rtol 1e-4,
   parameters atol 5e-3 (the JAX mesh test's) and each update within 4e-2
   of JAX's in relative norm (the slice test's), BN statistics atol 1e-4,
   bank pointers equal, bank rows atol 1e-5; both ranks' parameters and
   banks equal bit for bit;
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
8. OHEM, RMI, Lovasz, ``--phase test`` and ``tools/export_torch.py`` raise
   at world size 2.

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
from contrastiveseg_tpu.losses.manager import build_loss as jbuild_loss
from contrastiveseg_tpu.models.nets import build_model as jbuild_model
from contrastiveseg_tpu.ops.queue import MemoryBank as JBank
from contrastiveseg_tpu.presets import get_preset
from contrastiveseg_tpu_torch.data.pipeline import DataPipeline
from contrastiveseg_tpu_torch.data.transforms import Normalizer
from contrastiveseg_tpu_torch.engine.checkpoint import state_dict
from contrastiveseg_tpu_torch.engine.trainer import Trainer
from contrastiveseg_tpu_torch.losses.ce import cross_entropy, upsampled_cross_entropy
from contrastiveseg_tpu_torch.models import hrnet
from contrastiveseg_tpu_torch.models.layers import TorchBatchNorm
from contrastiveseg_tpu_torch.ops.contrast import (
    ContrastSpec,
    contrastive_loss,
    hard_anchor_sample,
)
from contrastiveseg_tpu_torch.ops.contrast_cuda import cuda_contrastive_loss
from contrastiveseg_tpu_torch.presets import get_preset as port_preset
from contrastiveseg_tpu_torch.utils.jax_weights import hrnet_seg_key, to_port

from torch_port_helpers import (
    exact_fp32_reference,
    one_torch_thread,
    random_variables,
    shallow_hrnet18,
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_config(extra: dict):
    cfg = get_preset("smoke_hrnet_w18")
    for k, v in extra.items():
        cfg = cfg.updated(k, v)
    return cfg


def _batch(cfg, n: int) -> dict:
    ds = JSynthetic(num_classes=5, size_hw=(H, W), length=8)
    p = cfg.get("normalize")
    norm = Normalizer(p["div_value"], p["mean_value"], p["std"])
    samples = [ds[i] for i in range(n)]
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


def _step_case(extra: dict, B: int, variables: dict) -> dict:
    """The inputs of a step case: ``variables`` (and key weights near them
    with the key encoder), bank, global batch, the JAX step's draws, each
    rank's rows."""
    cfg = _jax_config(extra)
    A = extra.get("solver.grad_accum_steps", 1)
    C, n = cfg.get("data.num_classes"), (H // 4) * (W // 4)
    rng = jax.random.key(7)
    if A == 1:
        draws = [_draws(*jax.random.split(rng, 4)[2:], B, C, n)]
    else:
        micro = jax.random.split(jax.random.split(rng)[1], 3 * A).reshape(A, 3)
        draws = [_draws(micro[i, 1], micro[i, 2], B // A, C, n) for i in range(A)]
    # Rank r's share of global microbatch i is its rows [i*B/A + r*B/(A*S), ...).
    share = B // (A * WORLD)
    rows = [[i * B // A + r * share + j for i in range(A) for j in range(share)]
            for r in range(WORLD)]
    key_rng = np.random.default_rng(5)
    key_params = (jax.tree.map(lambda a: (a + 0.1 * key_rng.standard_normal(a.shape))
                               .astype(np.float32), variables["params"])
                  if extra.get("contrast.momentum_encoder") else None)
    return {"overrides": extra, "variables": variables, "key_params": key_params,
            "bank": _bank(cfg), **_batch(cfg, B), "draws": draws, "rows": rows}


def _jax_step(case: dict):
    """The JAX solo step on the whole global batch (the programs of
    ``test_torch_port_slice.py`` and ``test_torch_port_training_extras.py``)."""
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
    return step(s0, {"image": jnp.asarray(case["image"]),
                     "label": jnp.asarray(case["label"].astype(np.int32))})


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
            "accum": _step_case(ACCUM, 4, variables)}


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
    exact_fp32_reference(mp, compiled_blocks=False)
    try:
        with shared_jax_compiles(), unoptimized_jax_compiles(), one_torch_thread():
            inputs = _inputs()
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
    return {"inputs": inputs, "outs": outs, "jax": jax_steps, "tmp": tmp}


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


@pytest.mark.parametrize("case", ["step", "accum"])
def test_two_rank_step_is_the_jax_solo_step(runs, case):
    inp, outs = runs["inputs"][case], runs["outs"]
    s1, jmetrics = runs["jax"][case]
    for o in outs:
        assert o[case]["step"] == 1
        for k in ("loss_seg", "loss_contrast", "loss"):
            np.testing.assert_allclose(o[case]["metrics"][k], float(jmetrics[k]), rtol=1e-4,
                                       err_msg=k)
    assert outs[0][case]["metrics"]["loss_contrast"] > 0
    sd0, sd1 = outs[0][case]["state_dict"], outs[1][case]["state_dict"]
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    for a, b in zip(outs[0][case]["bank"], outs[1][case]["bank"]):
        assert torch.equal(a, b)

    def port(tree):
        return to_port(tree, hrnet_seg_key)[0]

    before, after = port(inp["variables"]["params"]), port(s1.params)
    worst = 0.0
    for key, want in after.items():
        got = sd0[key].numpy()
        np.testing.assert_allclose(got, want, atol=5e-3, err_msg=key)
        d_want = want - before[key]
        worst = max(worst, float(np.linalg.norm(got - before[key] - d_want)
                                 / np.linalg.norm(d_want)))
    assert worst < 0.04, worst
    assert max(np.abs(w - before[k]).max() for k, w in after.items()) > 1e-3
    for key, want in port({"batch_stats": s1.batch_stats}).items():
        np.testing.assert_allclose(sd0[key].numpy(), want, atol=1e-4, err_msg=key)
    if inp["key_params"] is not None:
        for key, want in port(s1.key_params).items():
            np.testing.assert_allclose(outs[0][case]["key_params"][key].numpy(), want,
                                       atol=1e-6, err_msg=key)

    storage, seg_ptr, pix_ptr = outs[0][case]["bank"]
    np.testing.assert_array_equal(seg_ptr.numpy(), np.asarray(s1.bank.segment_ptr))
    np.testing.assert_array_equal(pix_ptr.numpy(), np.asarray(s1.bank.pixel_ptr))
    assert not np.array_equal(np.asarray(s1.bank.segment_ptr), inp["bank"][1])
    C, Mq = np.asarray(s1.bank.segment_queue).shape[:2]
    queues = storage[:C * 2 * Mq].view(C, 2, Mq, -1).numpy()
    np.testing.assert_allclose(queues[:, 0], np.asarray(s1.bank.segment_queue), atol=1e-5)
    np.testing.assert_allclose(queues[:, 1], np.asarray(s1.bank.pixel_queue), atol=1e-5)


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
        for name in ("ohem", "rmi", "lovasz"):
            kind, msg = got[name]
            assert kind == "NotImplementedError" and "ROADMAP §1 item 4" in msg, got[name]
        for name in ("phase_test", "export"):
            kind, msg = got[name]
            assert kind == "RuntimeError" and "world size 2" in msg, got[name]


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
