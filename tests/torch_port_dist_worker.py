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

import copy
import hashlib
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


def kth(inp, rank):
    """(9): ``parallel.global_kth_smallest`` of each rank's values (rank 1
    holds fewer than k_max + 1) at each (k, k_max)."""
    values = _t(inp["values"][rank])
    return [parallel.global_kth_smallest(values, torch.tensor(k), k_max)
            for k, k_max in inp["cases"]]


def global_losses(inp, rows):
    """(10)-(12): OHEM in each case, RMI and CE + Lovasz on the rank's rows,
    value and gradient of the logits, and the global branches' calls."""
    from contrastiveseg_tpu_torch.losses.ce import ohem_cross_entropy, ohem_selection
    from contrastiveseg_tpu_torch.losses.lovasz import ce_lovasz_loss
    from contrastiveseg_tpu_torch.losses.rmi import rmi_loss

    labels, C = _t(inp["labels"][rows]), inp["logits"].shape[-1]

    def run(fn, key="logits"):
        logits = _t(inp[key][rows], grad=True)
        loss = fn(logits)
        loss.backward()
        return {"loss": loss.detach(), "grad": logits.grad}

    parallel.reset_global_calls()
    out = {"ohem": [run(lambda x: ohem_cross_entropy(x, labels, t, m, inp["class_weight"]))
                    for t, m in inp["ohem_cases"]],
           "rmi": run(lambda x: rmi_loss(x, labels, C)),
           "lovasz": run(lambda x: ce_lovasz_loss(x, labels, inp["class_weight"]), "tied"),
           "calls": parallel.global_calls()}
    for r, (thresh, min_kept) in zip(out["ohem"], inp["ohem_cases"]):
        r.update(zip(("keep", "threshold", "kept"), ohem_selection(
            _t(inp["logits"][rows]), labels, thresh, min_kept)))
    return out


def _preset_state(inp):
    """A preset's train state from its seed, dropout off, in float64 (see
    the parent's case 13), and its step."""
    from contrastiveseg_tpu_torch.engine.state import create_train_state
    from contrastiveseg_tpu_torch.engine.train_step import make_train_step
    from contrastiveseg_tpu_torch.losses.manager import build_loss
    from contrastiveseg_tpu_torch.models import resnet
    from contrastiveseg_tpu_torch.models.nets import build_model

    resnet.RESNET_SPECS.update(inp["resnet_specs"])
    cfg = _config(inp["overrides"], inp["preset"])
    with torch.device("meta"):  # create_train_state inits every tensor of these nets
        model = build_model(cfg)
    state = create_train_state(cfg, model.to_empty(device="cpu"), "cpu")
    for m in state.model.modules():
        if isinstance(m, torch.nn.modules.dropout._DropoutNd):
            m.p = 0.0
    state.model.double()
    return state, make_train_step(build_loss(cfg), warmup_iters=0)


def _batches(inp, rows) -> list[dict]:
    return [{"image": _t(b["image"][rows]).double(), "label": _t(b["label"][rows])}
            for b in inp["batches"]]


def _digest(state_dict) -> dict:
    """Each tensor's bytes, hashed: equal digests on two ranks are equal
    tensors bit for bit, without writing either rank's state."""
    return {k: hashlib.sha256(v.detach().contiguous().reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, v in state_dict.items()}


def _zero_grad(model) -> list[str]:
    return sorted(n for n, p in model.named_parameters() if not p.grad.any())


def _clone(state_dict) -> dict:
    return {k: v.clone() for k, v in state_dict.items()}


def preset_step(inp, rank):
    """(13): the steps of a preset under DDP on the rank's image of each
    global batch; after each, the metrics, the parameters whose gradient is
    0, those that the wrapper of the next step leaves out of its reducer
    and the digest of the state; and the states themselves (kept in memory for ``solo_step``,
    never written: in float64 the three nets' states take gigabytes)."""
    state, run = _preset_state(inp)
    state.ddp = parallel.data_parallel(state.model, state.device)
    out = {k: [] for k in ("metrics", "zero_grad", "ignored", "digest")}
    states = []
    for batch in _batches(inp, slice(rank, rank + 1)):
        metrics = run(state, batch)
        states.append(_clone(state.model.state_dict()))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["zero_grad"].append(_zero_grad(state.model))
        out["ignored"].append(sorted(state.ddp.parameters_to_ignore))
        out["digest"].append(_digest(states[-1]))
    return out, states


def solo_step(inp, ranked, unreached):
    """(13)'s reference, run once the process group is gone: the steps of
    one process on the whole global batches, held here after each to this
    rank's state after the DDP step (``ranked``, one a step; the parent
    checks that both ranks' digests agree): for each floating tensor the
    largest difference; the largest move of the step; the parameters whose
    gradient is 0; and for each of the parameters whose DDP gradient was 0
    (``unreached``, one list a step), whether the DDP step shrank it
    elementwise and whether it changed it."""
    state, run = _preset_state(inp)
    out = {k: [] for k in ("metrics", "err", "moved", "zero_grad", "shrunk", "changed")}
    before = _clone(state.model.state_dict())
    for i, batch in enumerate(_batches(inp, slice(None))):
        metrics = run(state, batch)
        after = state.model.state_dict()
        floats = [k for k, v in after.items() if v.is_floating_point()]
        got, prev = ranked[i], ranked[i - 1] if i else before
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["err"].append({k: float((got[k] - after[k]).abs().max()) for k in floats})
        out["moved"].append(max(float((after[k] - before[k]).abs().max()) for k in floats))
        out["zero_grad"].append(_zero_grad(state.model))
        out["shrunk"].append({n: bool((got[n].abs() <= prev[n].abs()).all())
                              for n in unreached[i]})
        out["changed"].append({n: not torch.equal(got[n], prev[n]) for n in unreached[i]})
        before = _clone(after)
    return out


def step(inp, rank, start=None):
    """(4)-(5): two train steps of the headline under DDP on the rank's rows
    of each global batch, with the global draws; after each, the metrics,
    the state and the bank, and after step 1 the whole train state
    (``"start"``).  With ``start``, such a state (no process group): step 2
    of one process on the whole global batch, from it."""
    from contrastiveseg_tpu_torch.engine.checkpoint import load_state_dict, state_dict
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
    if start is None:
        state.ddp = parallel.data_parallel(state.model, state.device)
        rows, steps = inp["rows"][rank], zip(inp["batches"], inp["draws"])
    else:
        load_state_dict(state, start)
        rows, steps = slice(None), [(inp["batches"][1], inp["draws"][1])]
    A = cfg.get("solver.grad_accum_steps", default=1)
    run = make_train_step(build_loss(cfg), warmup_iters=0, network_stride=4,
                          pixel_update_freq=cfg.get("contrast.pixel_update_freq"),
                          momentum_encoder=cfg.get("contrast.momentum_encoder", default=False),
                          encoder_momentum=cfg.get("contrast.encoder_momentum", default=0.999),
                          grad_accum_steps=A)
    out = []
    for batch, draws in steps:
        batch = {"image": _t(batch["image"][rows]), "label": _t(batch["label"][rows])}
        draws = [Draws(AnchorScores(_t(d["hard"]), _t(d["easy"])), _t(d["queue"]))
                 for d in draws]
        metrics = run(state, batch, draws if A > 1 else draws[0])
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "state_dict": {k: v.clone() for k, v in state.model.state_dict().items()},
                    "step": state.step,
                    "key_params": ({k: v.clone() for k, v in state.key_params.items()}
                                   if state.key_params is not None else None),
                    "bank": tuple(t.clone() for t in (state.bank.storage, state.bank.segment_ptr,
                                                      state.bank.pixel_ptr))})
        if len(out) == 1 and start is None:
            out[0]["start"] = copy.deepcopy(state_dict(state))
    return out


def _config(overrides: dict, preset: str = "smoke_hrnet_w18"):
    from contrastiveseg_tpu_torch.presets import get_preset

    cfg = get_preset(preset)
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
    """(8): what the port refuses at world size 2, and the losses that it
    computes there now (``None`` where a call returns)."""
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
    out["kth"] = kth(inputs["kth"], rank)
    out["global_losses"] = global_losses(inputs["global_losses"], rows)
    hrnet.HRNET_SPECS["hrnet18"] = inputs["shallow_spec"]
    for name in ("step", "accum"):
        out[name] = step(inputs[name], rank)
    names = list(inputs["presets"])  # rank 0 the first (the heaviest), rank 1 the rest
    mine = names[:1] if rank == 0 else names[1:]
    out["presets"], kept = {}, {}
    for name in names:
        out["presets"][name], states = preset_step(inputs["presets"][name], rank)
        if name in mine:
            kept[name] = states
        del states
    hrnet.HRNET_SPECS["hrnet18"] = inputs["tiny_spec"]
    out["trainer"] = trainer(inputs["trainer"], rank)
    out["refusals"] = refusals(inputs["ce"], inputs["trainer"], rows)
    parallel.barrier()
    torch.distributed.destroy_process_group()
    hrnet.HRNET_SPECS["hrnet18"] = inputs["shallow_spec"]
    case = ("step", "accum")[rank]  # (4)-(5)'s one-process step 2, one case a rank
    out["solo_steps"] = {case: step(inputs[case], rank, out[case][0]["start"])}
    for name in ("step", "accum"):
        del out[name][0]["start"]
    out["solo"] = {name: solo_step(inputs["presets"][name], kept.pop(name),
                                   out["presets"][name]["zero_grad"])
                   for name in mine}
    torch.save(out, out_path)


if __name__ == "__main__":
    main()
