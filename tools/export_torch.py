#!/usr/bin/env python
"""Export a model of the PyTorch port as a ``torch.export`` artifact.

Counterpart of ``tools/export_model.py``: ``torch.export.export`` of the
eval forward, the model in eval mode (BN running statistics) plus the
align-corners upsample of its logits to the input, i.e. the ``Tester``'s
``ss_test`` (``--scope ss``), or its ``ms_test`` with ``test.scale_search``
unrolled into the graph, flips included (``--scope ms``).

    # export (random init from the config's seed, or --checkpoint <.pt>)
    python tools/export_torch.py --preset cityscapes_hrnet_w48_mem \\
        --checkpoint ckpts/seg_cityscapes_latest.pt --input-size 1024x2048 \\
        --batch 1 --out model_artifacts/w48

    # load and run the artifact in a fresh process
    python tools/export_torch.py --load model_artifacts/w48

Artifacts: ``<out>.pt2`` (``torch.export.save``: the graph and its weights)
and ``<out>.json`` (the input spec, the normalize constants, the class count
and the device; what a server needs to preprocess).  ``--dynamic-batch``
exports with a symbolic batch dimension, so one artifact serves any batch.
The export runs on ``--device`` (``cuda`` by default; it fails without CUDA)
and the artifact runs there.

A net built with ``network.pallas_conv`` exports with K2 in its graph: K2 is
the custom op ``contrastiveseg::conv3x3`` (``ops/conv_cuda.py``, with a fake
implementation for tracing), in fp32 or, with ``network.bf16``, in bf16.
Loading such an artifact needs the op registered: ``load_artifact`` imports
``ops/conv_cuda.py`` (not the model code) before ``torch.export.load``.

Refused (ROADMAP 6): ``--weights sidecar`` (a weight-free program; the
artifact always carries its weights).  It runs on one device, as the JAX
package's exporter does: under ``torchrun`` at world size > 1 it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_exportable(cfg, weights: str = "baked") -> None:
    if weights != "baked":
        raise NotImplementedError(
            f"--weights {weights} is not ported: ROADMAP 6 (a torch.export artifact "
            "always carries its weights)")


def scope_module(cfg, model, scope: str):
    """An ``nn.Module`` whose forward is the Tester's ``ss_test`` or
    ``ms_test`` (``test.scale_search``, with flips) on ``model``."""
    import torch

    from contrastiveseg_tpu_torch.engine.tester import Tester

    tester = Tester(cfg.updated("test.mode", "ss_test"), model)
    infer = {"ss": tester.ss_test, "ms": tester.ms_test}[scope]

    class Forward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, images):
            return infer(images)

    return Forward()


def export_program(cfg, model, scope: str, input_hw: tuple[int, int], batch: int = 1,
                   dynamic_batch: bool = False):
    """``torch.export`` of ``model``'s eval forward in ``scope`` on NHWC
    float32 images of ``input_hw``, on the device of ``model``'s weights."""
    import torch

    model.eval()
    device = next(model.parameters()).device
    # A batch of 1 would specialise the batch dimension to 1.
    example = torch.zeros((max(batch, 2) if dynamic_batch else batch, *input_hw, 3),
                          dtype=torch.float32, device=device)
    shapes = {"images": {0: torch.export.Dim("b", min=1)}} if dynamic_batch else None
    with torch.no_grad():
        return torch.export.export(scope_module(cfg, model, scope), (example,),
                                   dynamic_shapes=shapes)


def load_model(cfg, checkpoint: str | None, device):
    """The config's model with the weights of a port checkpoint (a
    ``CheckpointManager`` file), or initialised from ``seed``."""
    import torch

    from contrastiveseg_tpu_torch.engine.state import init_weights
    from contrastiveseg_tpu_torch.models.nets import build_model

    model = build_model(cfg)
    if checkpoint:
        tree = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model.load_state_dict(tree["model"])
    else:
        init_weights(model, torch.Generator().manual_seed(cfg.get("seed", default=304)))
    return model.to(device).eval()


def export_artifact(cfg, out: str, scope: str = "ss", input_hw=(512, 1024), batch: int = 1,
                    dynamic_batch: bool = False, checkpoint: str | None = None,
                    device: str = "cuda", weights: str = "baked") -> dict:
    """Write ``<out>.pt2`` and ``<out>.json``; returns the metadata."""
    import torch

    from tools.train_torch import require_device

    check_exportable(cfg, weights)
    dev = require_device(device)
    model = load_model(cfg, checkpoint, dev)
    program = export_program(cfg, model, scope, tuple(input_hw), batch, dynamic_batch)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.export.save(program, out + ".pt2")
    nz = cfg.get("normalize", default={})
    h, w = input_hw
    meta = {
        "model_name": cfg.get("network.model_name"),
        "backbone": cfg.get("network.backbone", default=None),
        "num_classes": cfg.get("data.num_classes"),
        "scope": scope,
        "scale_search": (cfg.get("test.scale_search", default=[0.75, 1.0, 1.25])
                         if scope == "ms" else [1.0]),
        "input": {"shape": ["b" if dynamic_batch else batch, h, w, 3],
                  "dtype": "float32", "layout": "NHWC RGB"},
        "normalize": {
            "div_value": nz.get("div_value", 255.0),
            "mean": list(nz.get("mean_value", (0.485, 0.456, 0.406))),
            "std": list(nz.get("std", (0.229, 0.224, 0.225))),
        },
        "output": "logits at input resolution (argmax -> train ids)",
        "weights": weights,
        "device": str(dev),
        "torch_version": torch.__version__,
    }
    with open(out + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_artifact(path: str):
    """(the artifact's module, its metadata), on the device it was exported
    for; fails when that device is CUDA and there is none.  K2's custom ops
    are registered first, so an artifact of a ``pallas_conv`` net loads."""
    import torch

    import contrastiveseg_tpu_torch.ops.conv_cuda  # noqa: F401 (registers contrastiveseg::*)
    from tools.train_torch import require_device

    with open(path + ".json") as f:
        meta = json.load(f)
    require_device(meta["device"])
    return torch.export.load(path + ".pt2").module(), meta


def run_artifact(path: str, batch: int = 1) -> tuple:
    """Load the artifact and run it once on uniform noise in [-2, 2] (seed
    0) of its input shape (a symbolic batch becomes ``batch``); returns
    (input, logits) as numpy arrays and fails on a non-finite logit."""
    import torch

    module, meta = load_artifact(path)
    shape = [d if isinstance(d, int) else batch for d in meta["input"]["shape"]]
    x = np.random.default_rng(0).uniform(-2, 2, shape).astype(np.float32)
    with torch.no_grad():
        out = module(torch.from_numpy(x).to(meta["device"])).cpu().numpy()
    if not np.isfinite(out).all():
        raise RuntimeError("the artifact produced non-finite logits")
    return x, out


def main() -> None:
    from contrastiveseg_tpu_torch.parallel import require_one_process

    require_one_process("tools/export_torch.py")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint (.pt) whose weights to export (omit: "
                         "initialised from the config's seed)")
    ap.add_argument("--out", default="model_artifacts/model")
    ap.add_argument("--load", default=None,
                    help="load and run an exported artifact instead")
    ap.add_argument("--input-size", default="512x1024", help="HxW")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dynamic-batch", action="store_true")
    ap.add_argument("--scope", choices=["ss", "ms"], default="ss")
    ap.add_argument("--weights", choices=["baked", "sidecar"], default="baked",
                    help="baked (the artifact carries its weights); sidecar is refused")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    if args.load:
        x, out = run_artifact(args.load, args.batch)
        print(f"loaded {args.load}: input {x.shape} -> logits {out.shape}, "
              f"argmax classes {np.unique(out.argmax(-1))[:8].tolist()}...")
        return

    from tools.train_torch import build_config

    cfg = build_config(args.preset, args.config, args.overrides)
    h, w = (int(v) for v in args.input_size.split("x"))
    meta = export_artifact(cfg, args.out, args.scope, (h, w), args.batch, args.dynamic_batch,
                           args.checkpoint, args.device, args.weights)
    print(f"exported {os.path.getsize(args.out + '.pt2') / 2**20:.1f} MiB -> {args.out}.pt2")
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
