"""One rank of ``tests/test_torch_port_dist.py``: the port on 2 gloo processes.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_dist_worker.py <inputs.pt> <out.pt>

Joins the process group through ``parallel.init_from_env("cpu")`` (gloo),
takes its rows of each global input that the parent wrote, runs every
scenario of the parent's cases in turn (the same collectives in the same
order on both ranks) and writes what it got.  It imports torch and the
port only: the parent holds the results to the JAX package and to the
port's single-process runs.  Not named ``test_*``: pytest never collects it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from contrastiveseg_tpu_torch import parallel  # noqa: E402
from contrastiveseg_tpu_torch.models import hrnet  # noqa: E402


def _t(a, grad=False):
    return torch.from_numpy(a).clone().requires_grad_(grad)


def bn(inp, rows):
    """(1): a train-mode BatchNorm on the rank's rows; then with momentum
    None after a reset (SWA's re-estimation), the running statistics."""
    from contrastiveseg_tpu_torch.models.layers import TorchBatchNorm

    m = TorchBatchNorm(inp["x"].shape[1])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, k).copy_(_t(inp[k]))
    x = _t(inp["x"][rows], grad=True)
    y = m(x)
    (y * _t(inp["g"][rows])).sum().backward()
    out = {"y": y.detach(), "dx": x.grad, "dweight": m.weight.grad, "dbias": m.bias.grad,
           "running_mean": m.running_mean.clone(), "running_var": m.running_var.clone()}
    m.reset_running_stats()
    m.momentum = None
    with torch.no_grad():
        m(x)
    out["cumulative"] = (m.running_mean.clone(), m.running_var.clone())
    return out


def anchors(inp, rows):
    """(2): the global anchor set, its InfoNCE against a queue through K1's
    wrapper (the plain version on the CPU) and against itself, each loss's
    gradient of the rank's embeddings."""
    from contrastiveseg_tpu_torch.ops.contrast import (
        ContrastSpec,
        contrastive_loss,
        global_anchor_sample,
    )
    from contrastiveseg_tpu_torch.ops.contrast_cuda import cuda_contrastive_loss

    spec = ContrastSpec(**inp["spec"])
    out = {}
    for name in ("bank", "self"):
        embed = _t(inp["embed"][rows], grad=True)
        a = global_anchor_sample(embed, _t(inp["labels"][rows]), _t(inp["predict"][rows]),
                                 spec, scores=(_t(inp["hard"]), _t(inp["easy"])))
        if name == "bank":
            loss = cuda_contrastive_loss(a.feats, a.labels, a.valid, _t(inp["q_feats"]),
                                         _t(inp["q_labels"]), _t(inp["q_valid"]),
                                         spec.temperature, spec.base_temperature)
        else:
            loss = contrastive_loss(a, spec)
        loss.backward()
        out[name] = {"feats": a.feats.detach(), "labels": a.labels, "valid": a.valid,
                     "loss": loss.detach(), "d_embed": embed.grad}
    return out


def ce(inp, rows):
    """(3): the upsampled CE and the CE of full-size logits, value and
    gradient, on rows whose ignored counts differ by rank."""
    from contrastiveseg_tpu_torch.losses.ce import cross_entropy, upsampled_cross_entropy

    out = {}
    for name, fn, key in (("upsampled", upsampled_cross_entropy, "seg"),
                          ("full", cross_entropy, "full")):
        logits = _t(inp[key][rows], grad=True)
        loss = fn(logits, _t(inp["labels"][rows]), inp["class_weight"])
        loss.backward()
        out[name] = {"loss": loss.detach(), "grad": logits.grad}
    return out


def step(inp, rank):
    """(4)-(5): one train step of the headline under DDP on the rank's rows
    of the global batch, with the global draws."""
    from contrastiveseg_tpu_torch.engine.state import create_train_state
    from contrastiveseg_tpu_torch.engine.train_step import Draws, make_train_step
    from contrastiveseg_tpu_torch.losses.contrast import AnchorScores
    from contrastiveseg_tpu_torch.losses.manager import build_loss
    from contrastiveseg_tpu_torch.models.nets import HRNetSeg
    from contrastiveseg_tpu_torch.ops.queue import bank_from_queues
    from contrastiveseg_tpu_torch.utils.jax_weights import load_jax_variables

    cfg = _config(inp["overrides"])
    C = cfg.get("data.num_classes")
    state = create_train_state(cfg, HRNetSeg(C, "hrnet18", head_dropout=0.0), "cpu")
    load_jax_variables(state.model, inp["variables"])
    if inp["key_params"] is not None:
        keyed = HRNetSeg(C, "hrnet18", head_dropout=0.0)
        load_jax_variables(keyed, {"params": inp["key_params"],
                                   "batch_stats": inp["variables"]["batch_stats"]})
        state.key_params = {k: p.detach().clone() for k, p in keyed.named_parameters()}
    state.bank = bank_from_queues(*(_t(a) for a in inp["bank"]))
    state.ddp = parallel.data_parallel(state.model, state.device)
    rows = inp["rows"][rank]
    batch = {"image": _t(inp["image"][rows]), "label": _t(inp["label"][rows])}
    draws = [Draws(AnchorScores(_t(d["hard"]), _t(d["easy"])), _t(d["queue"]))
             for d in inp["draws"]]
    A = cfg.get("solver.grad_accum_steps", default=1)
    run = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4,
                          pixel_update_freq=cfg.get("contrast.pixel_update_freq"),
                          momentum_encoder=cfg.get("contrast.momentum_encoder", default=False),
                          encoder_momentum=cfg.get("contrast.encoder_momentum", default=0.999),
                          grad_accum_steps=A)
    metrics = run(state, batch, draws if A > 1 else draws[0])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state_dict": state.model.state_dict(), "step": state.step,
            "key_params": state.key_params,
            "bank": (state.bank.storage, state.bank.segment_ptr, state.bank.pixel_ptr)}


def _config(overrides: dict):
    from contrastiveseg_tpu_torch.presets import get_preset

    cfg = get_preset("smoke_hrnet_w18")
    for k, v in overrides.items():
        cfg = cfg.updated(k, v)
    return cfg


def trainer(inp, rank):
    """(6)-(7): the trainer on 2 ranks: rank 1 asks for a stop in step 1 of
    2, so both stop after it; validation of the 5 val frames, ``latest``
    written by rank 0; the rank's history, state and scores."""
    from contrastiveseg_tpu_torch.engine.checkpoint import state_dict
    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    t = Trainer(_config(inp["overrides"]), "cpu")
    if rank == 1:
        step = t.train_step

        def stopping(state, batch):
            t.request_stop("a stop on rank 1")
            return step(state, batch)

        t.train_step = stopping
    history = t.train()
    return {"history": history, "state": state_dict(t.state),
            "confusion": t.evaluator.score.confusion.copy(),
            "miou": t.last_scores["miou"], "latest": t.ckpt._path("latest")}


def refusals(inp, trainer_inp, rows):
    """(8): what the port refuses at world size 2."""
    import tools.export_torch as export_torch
    import tools.train_torch as train_torch
    from contrastiveseg_tpu_torch.losses.ce import ohem_cross_entropy
    from contrastiveseg_tpu_torch.losses.lovasz import ce_lovasz_loss
    from contrastiveseg_tpu_torch.losses.rmi import rmi_loss

    logits, labels = _t(inp["full"][rows]), _t(inp["labels"][rows])
    calls = {"ohem": lambda: ohem_cross_entropy(logits, labels),
             "rmi": lambda: rmi_loss(logits, labels, logits.shape[-1]),
             "lovasz": lambda: ce_lovasz_loss(logits, labels),
             "phase_test": lambda: train_torch.run(_config(trainer_inp["overrides"]), "test",
                                                   "cpu"),
             "export": export_torch.main}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as e:  # noqa: BLE001 -- the parent checks type and message
            out[name] = (type(e).__name__, str(e))
    return out


def main() -> None:
    inputs, out_path = torch.load(sys.argv[1], weights_only=False), sys.argv[2]
    torch.set_num_threads(1)
    device = parallel.init_from_env("cpu")
    rank, world = parallel.rank_and_world()
    assert device == torch.device("cpu") and world == 2, (device, world)
    half = inputs["bn"]["x"].shape[0] // world
    rows = slice(rank * half, (rank + 1) * half)
    out = {"rank": rank, "bn": bn(inputs["bn"], rows),
           "anchors": anchors(inputs["anchors"], rows), "ce": ce(inputs["ce"], rows)}
    hrnet.HRNET_SPECS["hrnet18"] = inputs["shallow_spec"]
    for name in ("step", "accum"):
        out[name] = step(inputs[name], rank)
    hrnet.HRNET_SPECS["hrnet18"] = inputs["tiny_spec"]
    out["trainer"] = trainer(inputs["trainer"], rank)
    out["refusals"] = refusals(inputs["ce"], inputs["trainer"], rows)
    torch.save(out, out_path)
    parallel.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
