"""The port's copies of ``presets.py`` and ``utils/config.py`` against the
JAX package's originals.

The port imports nothing of the JAX package, so it carries both modules as
copies; these tests keep the copies equal to the originals: every preset
gives the same tree, and the same overrides build the same config.
"""

from __future__ import annotations

import pytest

from contrastiveseg_tpu import presets as jpresets
from contrastiveseg_tpu.utils.config import Config as JConfig
from contrastiveseg_tpu_torch import presets
from contrastiveseg_tpu_torch.utils.config import Config

OVERRIDES = [
    [],
    ["data.synthetic=true", "data.synthetic_size=[64,128]", "train.batch_size=2"],
    ["network.pallas_conv=True", "solver.test_interval=5", "lr.base_lr=0.02",
     "checkpoints.checkpoints_dir=./ckpt", "contrast.warmup_iters=0"],
    ["loss.params.ce_weight=None", "data.label_pairs+=(14, 15)",
     "network.model_name=hrnet_w48_mem"],
]


def test_same_preset_names():
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_preset_equals_the_jax_package(name):
    assert presets.get_preset(name).to_dict() == jpresets.get_preset(name).to_dict()


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o) or "none")
def test_config_from_args_equals_the_jax_package(overrides):
    base = jpresets.get_preset("cityscapes_hrnet_w48_mem").to_dict()
    got = Config.from_args(overrides=overrides, base=base)
    want = JConfig.from_args(overrides=overrides, base=base)
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()


def test_config_errors_match_the_jax_package():
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match="key.path=value"):
            cls.from_args(overrides=["no_equals_sign"])
        with pytest.raises(TypeError, match="non-list"):
            cls.from_args(overrides=["solver.max_iters+=3"], base={"solver": {"max_iters": 1}})
