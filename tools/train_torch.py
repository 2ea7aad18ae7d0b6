#!/usr/bin/env python
"""Train CLI of the PyTorch/CUDA port (``contrastiveseg_tpu_torch``).

Mirrors ``tools/train.py``:

    python tools/train_torch.py --preset cityscapes_hrnet_w48_mem \
        [--config extra.json] [--device cuda] [key.path=value ...]

Only ``--phase train`` is ported.  With ``--device cuda`` (the default) the
run fails when CUDA is absent; it never falls back to the CPU.  Data comes
from a Cityscapes-layout directory (``data.data_dir=...``, holding
``{split}/image`` and ``{split}/label``; PNGs decode through PIL unless
their ``.npy_cache`` sidecars are fresh) or, with ``data.synthetic=true``,
from synthetic scenes.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default=None, help="preset name (presets.py)")
    ap.add_argument("--config", default=None, help="JSON config file")
    ap.add_argument("--phase", default="train", choices=["train"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("overrides", nargs="*", help="key.path=value overrides")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = build_config(args.preset, args.config, args.overrides)
    device = require_device(args.device)

    import torch

    from contrastiveseg_tpu_torch.engine.trainer import Trainer

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    Trainer(cfg, device).train()


if __name__ == "__main__":
    main()
