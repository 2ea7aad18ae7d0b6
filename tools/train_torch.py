#!/usr/bin/env python
"""Train, val and test CLI of the PyTorch/CUDA port (``contrastiveseg_tpu_torch``).

Mirrors ``tools/train.py``:

    python tools/train_torch.py --preset cityscapes_hrnet_w48_mem \
        [--config extra.json] [--phase train|val|test] [--device cuda] \
        [key.path=value ...]

``--phase val`` prints the val mIoU of ``Trainer.validate()``; ``--phase
test`` runs ``engine/tester.Tester`` over the ``test`` split (or
``test.test_dir``) in ``test.mode`` (``ss_test``, ``ms_test``,
``sscrop_test``, ``mscrop_test``, ``ms_test_depth``) and writes the label
PNGs of a submission under ``test.out_dir``; for a SegFix net
(``network.model_name=segfix_*``) it runs ``Tester.test_offset`` and writes
``offset/{name}.npz``, which ``tools/segfix_torch.py`` applies to label
PNGs.  Both start from
``network.resume=<checkpoint>``.  With ``--device cuda`` (the default) the
run fails when CUDA is absent; it never falls back to the CPU.  Data comes
from a Cityscapes-layout directory (``data.data_dir=...``, holding
``{split}/image`` and ``{split}/label``; PNGs decode through PIL unless
their ``.npy_cache`` sidecars are fresh) or, with ``data.synthetic=true``,
from synthetic scenes.

On N GPUs of one machine, launch it through ``torchrun``:

    torchrun --standalone --nproc_per_node N tools/train_torch.py \
        --preset cityscapes_hrnet_w48_mem [key.path=value ...]

Each rank joins the process group (``parallel.init_from_env``: NCCL on
``cuda:$LOCAL_RANK``; gloo with ``--device cpu``) and trains its slice of
every global batch (``train.batch_size`` is the global batch), as the JAX
trainer trains its device mesh; ``--phase val`` scores each rank's shard of
the val split and sums the confusions.  ``--phase test`` runs on one device,
as the JAX tester does: at world size > 1 it raises.  Without torchrun's
environment no process group is made.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_config(preset: str | None, config: str | None, overrides: list[str]):
    from contrastiveseg_tpu_torch.presets import get_preset
    from contrastiveseg_tpu_torch.utils.config import Config

    if preset:
        cfg = get_preset(preset)
        if config:
            with open(config) as f:
                cfg = cfg.merged(json.load(f))
        return Config.from_args(overrides=overrides, base=cfg.to_dict())
    return Config.from_args(config_file=config, overrides=overrides)


def require_device(device: str):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")
    return dev


def run(cfg, phase: str, device) -> dict:
    """One phase on ``device``; returns the trainer and what the phase made:
    the train ``history``, the val ``scores`` or the ``tester`` (whose
    ``timing`` holds its run's seconds)."""
    from contrastiveseg_tpu_torch.engine.tester import Tester, check_supported
    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    from contrastiveseg_tpu_torch.parallel import require_one_process

    if phase not in ("train", "val", "test"):
        raise ValueError(f"unknown phase {phase!r}")
    if phase == "test":
        require_one_process("--phase test")
        check_supported(cfg)  # before the trainer restores a checkpoint
    trainer = Trainer(cfg, device)
    if phase == "train":
        return {"trainer": trainer, "history": trainer.train()}
    if phase == "val":
        return {"trainer": trainer, "scores": trainer.validate()}
    tester = Tester(cfg, trainer.state.model, device)
    # SegFix nets give a boundary mask and directions (the reference's
    # phase=test_offset, tester_offset.py); the others write labels.
    if cfg.get("network.model_name", default="").startswith("segfix"):
        tester.test_offset()
    else:
        tester.test()
    return {"trainer": trainer, "tester": tester}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default=None, help="preset name (presets.py)")
    ap.add_argument("--config", default=None, help="JSON config file")
    ap.add_argument("--phase", default="train", choices=["train", "val", "test"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = ap.parse_args(argv)

    from contrastiveseg_tpu_torch import parallel

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = build_config(args.preset, args.config, args.overrides)
    device = (parallel.init_from_env(args.device) if parallel.launched()
              else require_device(args.device))

    import torch

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    main_rank = parallel.is_main()
    try:
        out = run(cfg, args.phase, device)
    finally:
        if parallel.distributed():
            torch.distributed.destroy_process_group()
    if not main_rank:
        return out
    if args.phase == "val":
        print(f"val mIoU: {out['scores']['miou']:.4f}")
    elif args.phase == "test":
        timing = out["tester"].timing
        print(f"wrote {timing['images']} predictions to "
              f"{cfg.get('test.out_dir', default='./out')} in {timing['seconds']:.1f} s")
    return out


if __name__ == "__main__":
    main()
