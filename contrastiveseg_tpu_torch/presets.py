"""Config presets of the port: a copy of ``contrastiveseg_tpu/presets.py``.

The port carries its own copy because it imports nothing of the JAX
package; ``tests/test_torch_port_presets.py`` holds every preset equal to
the original.  (The original's note follows.)

Config presets (programmatic; replaces the reference's JSON config zoo).
Hyperparameters mirror the published configs
(upstream configs/cityscapes/H_48_D_4.json, H_48_D_4_CONTRAST.json,
H_48_D_4_MEM.json, R_101_D_8.json and scripts/cityscapes/hrnet/
run_h_48_d_4_contrast.sh: BATCH_SIZE=8, MAX_ITERS=40000, BASE_LR=0.01).
Presets are plain dicts; compose with Config.merged / CLI overrides.
"""

from __future__ import annotations

import copy

from contrastiveseg_tpu_torch.utils.config import Config

CITYSCAPES_CE_WEIGHT = [
    0.8373, 0.9180, 0.8660, 1.0345, 1.0166, 0.9969, 0.9754, 1.0489, 0.8786,
    1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955, 1.0865, 1.1529,
    1.0507,
]

_CITYSCAPES_BASE = {
    "dataset": "cityscapes",
    "method": "fcn_segmentor",
    "data": {
        "num_classes": 19,
        "label_list": [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26,
                       27, 28, 31, 32, 33],
        "data_dir": "/data/cityscapes",
        "workers": 1,
    },
    "train": {
        "batch_size": 8,
        "data_transformer": {
            "size_mode": "fix_size",
            "input_size": [1024, 512],
            "align_method": "only_pad",
            "pad_mode": "random",
        },
    },
    "val": {
        "batch_size": 4,
        "mode": "ss_test",
        "data_transformer": {
            "size_mode": "fix_size",
            "input_size": [2048, 1024],
            "align_method": "only_pad",
        },
    },
    "test": {
        "batch_size": 4,
        "mode": "ss_test",
        "out_dir": "./out/cityscapes",
        "data_transformer": {
            "size_mode": "fix_size",
            "input_size": [2048, 1024],
            "align_method": "only_pad",
        },
    },
    "train_trans": {
        "trans_seq": ["random_resize", "random_crop", "random_hflip",
                      "random_brightness"],
        "random_brightness": {"ratio": 1.0, "shift_value": 10},
        "random_hflip": {"ratio": 0.5, "swap_pair": []},
        "random_resize": {
            "ratio": 1.0, "method": "random",
            "scale_range": [0.5, 2.0], "aspect_range": [0.9, 1.1],
        },
        "random_crop": {
            "ratio": 1.0, "crop_size": [1024, 512], "method": "random",
            "allow_outside_center": False,
        },
    },
    "val_trans": {"trans_seq": []},
    "normalize": {
        "div_value": 255.0,
        "mean_value": [0.485, 0.456, 0.406],
        "std": [0.229, 0.224, 0.225],
    },
    "checkpoints": {
        "checkpoints_name": "seg_cityscapes",
        "checkpoints_dir": "./checkpoints/cityscapes",
        "save_iters": 1000,
    },
    "logging": {"logfile_level": "info", "stdout_level": "info",
                "log_file": None},
    "lr": {"base_lr": 0.01, "metric": "iters", "lr_policy": "lambda_poly",
           "nbb_mult": 1.0},
    "solver": {"display_iter": 10, "test_interval": 2000, "max_iters": 40000},
    "optim": {
        "optim_method": "sgd",
        "sgd": {"weight_decay": 0.0005, "momentum": 0.9, "nesterov": False},
    },
    "loss": {
        "loss_type": "fs_ce_loss",
        "params": {
            "ce_weight": CITYSCAPES_CE_WEIGHT,
            "ce_reduction": "elementwise_mean",
            "ce_ignore_index": -1,
            "ohem_minkeep": 100000,
            "ohem_thresh": 0.9,
        },
    },
    "seed": 304,
}


def _merge(*dicts) -> dict:
    cfg = Config({})
    for d in dicts:
        cfg = cfg.merged(d)
    return cfg.to_dict()


_CONTRAST_BLOCK = {
    "contrast": {
        "proj_dim": 256,
        "temperature": 0.1,
        "base_temperature": 0.07,
        "max_samples": 1024,
        "max_views": 100,
        "stride": 8,
        "warmup_iters": 5000,
        "loss_weight": 0.1,
        "use_rmi": False,
        "use_lovasz": False,
        "with_memory": False,
        "memory_size": 5000,
        "pixel_update_freq": 10,
        "include_class0": True,
    }
}

PRESETS: dict[str, dict] = {}

PRESETS["cityscapes_hrnet_w48"] = _merge(_CITYSCAPES_BASE, {
    "network": {"model_name": "hrnet_w48", "backbone": "hrnet48",
                "stride": 4, "bn_type": "sync", "bf16": False,
                # Checkpoint stem+layer1: stops XLA replaying the 2.4-TFLOP
                # cls_head conv under HBM pressure (25.5 -> 28.1 img/s).
                "remat_stem": True},
})

PRESETS["cityscapes_hrnet_w48_contrast"] = _merge(_CITYSCAPES_BASE, _CONTRAST_BLOCK, {
    "network": {"model_name": "hrnet_w48_contrast", "backbone": "hrnet48",
                "stride": 4, "bn_type": "sync", "bf16": False,
                "remat_stem": True},
    "loss": {"loss_type": "contrast_ce_loss"},
    "contrast": {"stride": 4},
    "solver": {"test_interval": 1000},  # H_48_D_4.json (MEM uses 2000)
})

# H_48_D_4_MEM.json: tau=0.07, max_views=1, memory on, loss_weight 1.
PRESETS["cityscapes_hrnet_w48_mem"] = _merge(_CITYSCAPES_BASE, _CONTRAST_BLOCK, {
    "network": {"model_name": "hrnet_w48_mem", "backbone": "hrnet48",
                "stride": 4, "bn_type": "sync", "bf16": False,
                "remat_stem": True},
    "loss": {"loss_type": "mem_contrast_ce_loss"},
    "contrast": {"temperature": 0.07, "max_views": 1, "loss_weight": 1.0,
                 "with_memory": True, "stride": 4},
})

PRESETS["cityscapes_deeplab_v3"] = _merge(_CITYSCAPES_BASE, {
    "network": {"model_name": "deeplab_v3",
                "backbone": "deepbase_resnet101_dilated8",
                "multi_grid": [1, 1, 1], "stride": 8, "bn_type": "sync",
                "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
})

PRESETS["cityscapes_deeplab_v3_contrast"] = _merge(_CITYSCAPES_BASE, _CONTRAST_BLOCK, {
    "network": {"model_name": "deeplab_v3_contrast",
                "backbone": "deepbase_resnet101_dilated8",
                "multi_grid": [1, 1, 1], "stride": 8, "bn_type": "sync",
                "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "contrast_auxce_loss"},
})

# --- other datasets (reference configs/{ade20k,coco_stuff,pascal_context,lip}).
_ADE20K_BASE = _merge(_CITYSCAPES_BASE, {
    "dataset": "ade20k",
    "data": {"num_classes": 150, "label_list": None,
             "reduce_zero_label": True, "data_dir": "/data/ade20k"},
    "train": {"batch_size": 16,
              "data_transformer": {"size_mode": "fix_size",
                                   "input_size": [520, 520],
                                   "align_method": "only_pad",
                                   "pad_mode": "random"}},
    "val": {"data_transformer": {"size_mode": "diverse_size",
                                 "align_method": "only_pad",
                                 "fit_stride": 8}},
    "train_trans": {"random_crop": {"crop_size": [520, 520]},
                    "random_resize": {"scale_range": [0.5, 2.0]}},
    "loss": {"params": {"ce_weight": None}},
    # configs/ade20k/H_48_D_4.json solver/lr/optim blocks (non-cityscapes
    # datasets use weight_decay 1e-4).
    "lr": {"base_lr": 0.02},
    "solver": {"max_iters": 150000},
    "optim": {"sgd": {"weight_decay": 0.0001}},
})

PRESETS["ade20k_hrnet_w48"] = _merge(_ADE20K_BASE, {
    "network": {"model_name": "hrnet_w48", "backbone": "hrnet48",
                "stride": 4, "bf16": False},
})
PRESETS["ade20k_hrnet_w48_contrast"] = _merge(_ADE20K_BASE, _CONTRAST_BLOCK, {
    "network": {"model_name": "hrnet_w48_contrast", "backbone": "hrnet48",
                "stride": 4, "bf16": False},
    "loss": {"loss_type": "contrast_ce_loss"},
    "contrast": {"stride": 4},
})

_COCO_STUFF_BASE = _merge(_ADE20K_BASE, {
    "dataset": "coco_stuff",
    "data": {"num_classes": 171, "data_dir": "/data/coco_stuff"},
    # configs/coco_stuff/H_48_D_4.json lr/solver.
    "lr": {"base_lr": 0.001},
    "solver": {"max_iters": 30000},
})
PRESETS["coco_stuff_hrnet_w48_contrast"] = _merge(
    _COCO_STUFF_BASE, _CONTRAST_BLOCK, {
        "network": {"model_name": "hrnet_w48_contrast",
                    "backbone": "hrnet48", "stride": 4, "bf16": False},
        "loss": {"loss_type": "contrast_ce_loss"},
        # H_48_D_4.json contrast block: tau=0.07 here (cityscapes uses 0.1).
        "contrast": {"stride": 4, "temperature": 0.07},
    })

_PCONTEXT_BASE = _merge(_ADE20K_BASE, {
    "dataset": "pascal_context",
    "data": {"num_classes": 59, "data_dir": "/data/pascal_context"},
    # configs/pascal_context/H_48_D_4.json lr/solver.
    "lr": {"base_lr": 0.001},
    "solver": {"max_iters": 30000},
})
PRESETS["pascal_context_hrnet_w48_contrast"] = _merge(
    _PCONTEXT_BASE, _CONTRAST_BLOCK, {
        "network": {"model_name": "hrnet_w48_contrast",
                    "backbone": "hrnet48", "stride": 4, "bf16": False},
        "loss": {"loss_type": "contrast_ce_loss"},
        "contrast": {"stride": 4, "temperature": 0.07},
    })

# LIP human parsing (CE2P): label + edge targets, hflip swaps L/R parts.
PRESETS["lip_ce2p_ocrnet"] = _merge(_CITYSCAPES_BASE, {
    "dataset": "lip",
    # LIP validates with flip-averaged logits and L/R channel swaps
    # (trainer_contrastive.py:320-346) — label_pairs drives the swap.
    "data": {"num_classes": 20, "label_list": None,
             "reduce_zero_label": False, "data_dir": "/data/lip",
             "loader": "lip",
             "label_pairs": [[14, 15], [16, 17], [18, 19]]},
    "train": {"batch_size": 32,
              "data_transformer": {"size_mode": "fix_size",
                                   "input_size": [473, 473],
                                   "align_method": "only_pad"}},
    # configs/lip/R_101_D_16.json train_trans (hflip-with-swap first, then
    # resize-to-target + scale jitter [0.5, 1.5] + crop + brightness).
    "train_trans": {
        "trans_seq": ["random_hflip", "resize", "random_resize",
                      "random_crop", "random_brightness"],
        "resize": {"target_size": [473, 473]},
        "random_hflip": {"ratio": 0.5,
                         "swap_pair": [[14, 15], [16, 17], [18, 19]]},
        "random_crop": {"ratio": 1.0, "crop_size": [473, 473],
                        "method": "random", "allow_outside_center": False},
        "random_resize": {"ratio": 1.0, "method": "random",
                          "scale_range": [0.5, 1.5],
                          "aspect_range": [0.9, 1.1]},
        "random_brightness": {"ratio": 1.0, "shift_value": 10},
    },
    # run_r_101_d_16_ce2p_ocr_train.sh: dilated16 backbone, 100k iters.
    # The script's LOSS_TYPE=ce2p_auxce_loss is absent from the
    # reference's own SEG_LOSS_DICT (loss_manager.py:27-42 — bitrot);
    # fs_auxce_loss is the nearest registered key on both sides.
    "network": {"model_name": "ce2p_ocrnet",
                "backbone": "deepbase_resnet101_dilated16", "stride": 16,
                "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss", "params": {"ce_weight": None}},
    "lr": {"base_lr": 0.007},
    "solver": {"max_iters": 100000},
    "val": {"flip_average": True},
})

# CamVid (configs/camvid/H_48_D_4.json): 12 classes, 480x360 crops.
PRESETS["camvid_hrnet_w48_contrast"] = _merge(
    _CITYSCAPES_BASE, _CONTRAST_BLOCK, {
        "dataset": "camvid",
        "data": {"num_classes": 12, "label_list": list(range(12)),
                 "data_dir": "/data/camvid"},
        "train": {"batch_size": 16,
                  "data_transformer": {"input_size": [480, 360]}},
        "val": {"data_transformer": {"input_size": [480, 360]}},
        "train_trans": {"random_crop": {"crop_size": [480, 360]}},
        "network": {"model_name": "hrnet_w48_contrast", "backbone": "hrnet48",
                    "stride": 4, "bf16": False},
        "loss": {"loss_type": "contrast_ce_loss",
                 "params": {"ce_weight": None}},
        "lr": {"base_lr": 0.001},
        "solver": {"max_iters": 30000},
        "optim": {"sgd": {"weight_decay": 0.0001}},
        "contrast": {"temperature": 0.07, "stride": 4},
    })

# Mapillary Vistas (configs/mapillary/H_48_D_4_1024x1024.json): 65 classes.
PRESETS["mapillary_hrnet_w48"] = _merge(_CITYSCAPES_BASE, {
    "dataset": "mapillary",
    "data": {"num_classes": 65, "label_list": list(range(65)),
             "data_dir": "/data/mapillary"},
    # run_h_48_d_4_ocr_b.sh: BATCH_SIZE=16, MAX_ITERS=500000, ocr_b head.
    "train": {"batch_size": 16,
              "data_transformer": {"input_size": [1024, 1024]}},
    "val": {"data_transformer": {"input_size": [1024, 1024]}},
    "train_trans": {"random_crop": {"crop_size": [1024, 1024]}},
    "network": {"model_name": "hrnet_w48_ocr_b", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss", "params": {"ce_weight": None}},
    "solver": {"max_iters": 500000},
})

# CelebAMask-HQ face parsing (configs/celeba/H_48_D_4.json): 19 classes.
PRESETS["celeba_hrnet_w48"] = _merge(_CITYSCAPES_BASE, {
    "dataset": "celeba",
    "data": {"num_classes": 19, "label_list": None,
             "reduce_zero_label": False, "data_dir": "/data/celeba"},
    "train": {"batch_size": 16,
              "data_transformer": {"input_size": [512, 512]}},
    "val": {"data_transformer": {"input_size": [512, 512]}},
    "train_trans": {"random_crop": {"crop_size": [512, 512]}},
    # run_h_48_d_4_train.sh (celeba): LOSS_TYPE=fs_ce_loss.
    "network": {"model_name": "hrnet_w48", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_ce_loss", "params": {"ce_weight": None}},
    "lr": {"base_lr": 0.001},
    "solver": {"max_iters": 150000},
    "optim": {"sgd": {"weight_decay": 0.0001}},
})

# SegFix offset training (configs/cityscapes/H_SEGFIX.json +
# run_h_48_d_4_segfix.sh: 512x512 crops, bs 16, lr 0.04, 80k iters).
PRESETS["cityscapes_segfix_hrnet"] = _merge(_CITYSCAPES_BASE, {
    "data": {"dt_num_classes": 8, "loader": "dt_offset"},
    "train": {"batch_size": 16,
              "data_transformer": {"input_size": [512, 512]}},
    "train_trans": {"random_crop": {"crop_size": [512, 512]}},
    "network": {"model_name": "segfix_hrnet", "backbone": "hrnet48",
                "stride": 4, "bf16": False},
    "loss": {"loss_type": "segfix_loss", "params": {"ce_weight": None}},
    "lr": {"base_lr": 0.04},
    "solver": {"max_iters": 80000},
})

# --- script-zoo widening (VERDICT r2 §2.1 partial row): one preset per
# reference run script, fields verified in tests/test_presets_vs_reference.

PRESETS["cityscapes_hrnet_w48_ocr"] = _merge(_CITYSCAPES_BASE, {
    # run_h_48_d_4_ocr.sh: bs 8, lr 0.01, 40k.
    "network": {"model_name": "hrnet_w48_ocr", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
})

PRESETS["cityscapes_hrnet_w48_ocr_contrast"] = _merge(
    _CITYSCAPES_BASE, _CONTRAST_BLOCK, {
        # run_h_48_d_4_ocr_contrast.sh.
        "network": {"model_name": "hrnet_w48_ocr_contrast",
                    "backbone": "hrnet48", "stride": 4, "bf16": False,
                    "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
        "loss": {"loss_type": "contrast_auxce_loss"},
        "contrast": {"stride": 4},
    })

PRESETS["cityscapes_hrnet_w48_ocr_b"] = _merge(_CITYSCAPES_BASE, {
    # run_h_48_d_4_ocr_b.sh: 80k iters; bs 16 from H_48_D_4.json (the
    # script sets no BATCH_SIZE override).
    "train": {"batch_size": 16},
    "network": {"model_name": "hrnet_w48_ocr_b", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "solver": {"max_iters": 80000},
})

PRESETS["cityscapes_hrnet_w48_ocr_ohem"] = _merge(_CITYSCAPES_BASE, {
    # run_h_48_d_4_ocr_ohem.sh: OHEM on the seg head, 80k iters.
    "network": {"model_name": "hrnet_w48_ocr", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxohemce_loss"},
    "solver": {"max_iters": 80000},
})


def _r101_cityscapes(model_name):
    # cityscapes R_101_D_8.json + the ocnet/isa run scripts: bs 16 (JSON,
    # scripts set no override), lr 0.01, 40k.
    return _merge(_CITYSCAPES_BASE, {
        "train": {"batch_size": 16},
        "network": {"model_name": model_name,
                    "backbone": "deepbase_resnet101_dilated8",
                    "multi_grid": [1, 1, 1], "stride": 8, "bf16": False,
                    "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
        "loss": {"loss_type": "fs_auxce_loss"},
    })


PRESETS["cityscapes_base_ocnet"] = _r101_cityscapes("base_ocnet")
PRESETS["cityscapes_asp_ocnet"] = _r101_cityscapes("asp_ocnet")
PRESETS["cityscapes_isanet"] = _r101_cityscapes("isanet")

PRESETS["coco_stuff_hrnet_w48"] = _merge(_COCO_STUFF_BASE, {
    # run_h_48_d_4_train.sh (coco_stuff): fs_ce, 60k.
    "network": {"model_name": "hrnet_w48", "backbone": "hrnet48",
                "stride": 4, "bf16": False},
    "loss": {"loss_type": "fs_ce_loss"},
    "solver": {"max_iters": 60000},
})

PRESETS["coco_stuff_hrnet_w48_ocr"] = _merge(_COCO_STUFF_BASE, {
    "network": {"model_name": "hrnet_w48_ocr", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "solver": {"max_iters": 60000},
})

PRESETS["coco_stuff_spatial_ocrnet"] = _merge(_COCO_STUFF_BASE, {
    # run_r_101_d_8_ocr_train.sh + coco_stuff/R_101_D_8.json.
    "network": {"model_name": "spatial_ocrnet",
                "backbone": "deepbase_resnet101_dilated8",
                "multi_grid": [1, 1, 1], "stride": 8, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "solver": {"max_iters": 60000},
})

PRESETS["pascal_context_hrnet_w48_ocr"] = _merge(_PCONTEXT_BASE, {
    "network": {"model_name": "hrnet_w48_ocr", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "solver": {"max_iters": 60000},
})

PRESETS["pascal_context_deeplab_v3"] = _merge(_PCONTEXT_BASE, {
    # run_r_101_d_8_deeplabv3_train.sh oddly points CONFIGS at the
    # *cityscapes* R_101_D_8.json (bs 16, lr 0.01, wd 5e-4) while training
    # pascal-context via CLI data overrides; we keep the pascal data block
    # and take the script's effective solver/optim values.
    "train": {"batch_size": 16},
    "network": {"model_name": "deeplab_v3",
                "backbone": "deepbase_resnet101_dilated8",
                "multi_grid": [1, 1, 1], "stride": 8, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "lr": {"base_lr": 0.01},
    "solver": {"max_iters": 60000},
    "optim": {"sgd": {"weight_decay": 0.0005}},
})

PRESETS["lip_hrnet_w48_ocr"] = _merge(PRESETS["lip_ce2p_ocrnet"], {
    # run_h_48_d_4_ocr_train.sh (lip) + lip/H_48_D_4.json.
    "network": {"model_name": "hrnet_w48_ocr", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "solver": {"max_iters": 100000},
})


# --- full script-zoo closure: one preset per remaining distinct reference
# run script (scripts/** table in tests/test_presets_vs_reference.py).
# paddle variants differ only in the pretrained-weight file, and the aml lr
# sweeps only in BASE_LR — both reachable via CLI overrides, not duplicated.

# cityscapes R_101_D_8 family (scripts/cityscapes/{fcn,ocnet,ocrnet,resnest}).
PRESETS["cityscapes_fcnet"] = _r101_cityscapes("fcnet")
PRESETS["cityscapes_fcnet_wo_dsn"] = _merge(
    _r101_cityscapes("fcnet_wo_dsn"),
    {"loss": {"loss_type": "fs_ce_loss"}})  # run_r_101_d_8_fcn_wo_dsn_train.sh
PRESETS["cityscapes_pyramid_ocnet"] = _r101_cityscapes("pyramid_ocnet")
PRESETS["cityscapes_spatial_ocrnet"] = _r101_cityscapes("spatial_ocrnet")
PRESETS["cityscapes_spatial_asp_ocrnet"] = _r101_cityscapes("spatial_asp_ocrnet")
for _ideal in ("ideal_spatial_ocrnet", "ideal_spatial_ocrnet_b",
               "ideal_spatial_ocrnet_c", "ideal_gather_ocrnet",
               "ideal_distribute_ocrnet"):
    PRESETS[f"cityscapes_{_ideal}"] = _r101_cityscapes(_ideal)
# run_r_101_d_8_fcn.sh (resnest): same recipe on the ResNeSt-101 backbone.
PRESETS["cityscapes_resnest_fcn"] = _merge(
    _r101_cityscapes("fcnet"),
    {"network": {"backbone": "deepbase_resnest101_dilated8"}})

# Staged coarse/mapillary recipes (scripts/cityscapes/ocrnet/run_spatial_*
# + hrnet/run_h_48_d_4_ocr_b_mapillary_*): each stage resumes from the
# previous stage's checkpoint (the script's PRETRAINED chain) and swaps
# the train list via the extra-set flags.
PRESETS["cityscapes_spatial_ocrnet_trainval"] = _merge(
    _r101_cityscapes("spatial_ocrnet"),
    {"data": {"include_val": True},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 120000}})
PRESETS["cityscapes_spatial_ocrnet_coarse"] = _merge(
    _r101_cityscapes("spatial_ocrnet"),
    {"data": {"only_coarse": True},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 100000}})
PRESETS["cityscapes_spatial_ocrnet_coarse_trainval"] = _merge(
    _r101_cityscapes("spatial_ocrnet"),
    {"data": {"include_val": True},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 10000}})
PRESETS["cityscapes_spatial_ocrnet_mapillary"] = _merge(
    _r101_cityscapes("spatial_ocrnet"),
    {"data": {"only_mapillary": True},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 50000}})
PRESETS["cityscapes_spatial_ocrnet_mapillary_coarse"] = _merge(
    _r101_cityscapes("spatial_ocrnet"),
    {"data": {"only_coarse": True},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 50000}})
PRESETS["cityscapes_hrnet_w48_ocr_trainval"] = _merge(
    PRESETS["cityscapes_hrnet_w48_ocr"],
    {"data": {"include_val": True}, "solver": {"max_iters": 100000}})
PRESETS["cityscapes_hrnet_w48_ocr_b_trainval_ohem"] = _merge(
    PRESETS["cityscapes_hrnet_w48_ocr_b"],
    {"data": {"include_val": True}, "train": {"batch_size": 8},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 120000}})
PRESETS["cityscapes_hrnet_w48_ocr_b_coarse_ohem"] = _merge(
    PRESETS["cityscapes_hrnet_w48_ocr_b"],
    {"data": {"only_coarse": True}, "train": {"batch_size": 16},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 50000}})
PRESETS["cityscapes_hrnet_w48_ocr_b_coarse_trainval_ohem"] = _merge(
    PRESETS["cityscapes_hrnet_w48_ocr_b"],
    {"data": {"include_val": True}, "train": {"batch_size": 8},
     "loss": {"loss_type": "fs_auxohemce_loss"},
     "solver": {"max_iters": 20000}})

# SegFix variants (scripts/cityscapes/segfix/* + scripts/segfix/*).
PRESETS["cityscapes_segfix_hrnet_inst"] = _merge(
    PRESETS["cityscapes_segfix_hrnet"],
    # *_inst: offsets from the instance-id boundary map, 20k finetune.
    {"data": {"dt_boundary": "instance"}, "solver": {"max_iters": 20000}})
PRESETS["cityscapes_segfix_hrnet_trainval"] = _merge(
    PRESETS["cityscapes_segfix_hrnet"],
    {"data": {"include_val": True}, "solver": {"max_iters": 80000}})
PRESETS["cityscapes_segfix_hrnet2x"] = _merge(
    PRESETS["cityscapes_segfix_hrnet"],
    {"network": {"backbone": "hrnet2x20"}})
PRESETS["cityscapes_segfix_hrnet2x_inst"] = _merge(
    PRESETS["cityscapes_segfix_hrnet2x"],
    {"data": {"dt_boundary": "instance"}, "solver": {"max_iters": 20000}})
PRESETS["cityscapes_segfix_hrnet2x_trainval"] = _merge(
    PRESETS["cityscapes_segfix_hrnet2x"],
    {"data": {"include_val": True}, "solver": {"max_iters": 120000}})
# Joint cityscapes+ade20k SegFix (run_hx_20_d_2_cityscapes_ade20k.sh):
# two data roots, balanced round-robin sampling.
PRESETS["segfix_cityscapes_ade20k"] = _merge(
    PRESETS["cityscapes_segfix_hrnet2x"],
    {"data": {"data_dirs": ["/data/cityscapes", "/data/ade20k"]},
     "solver": {"max_iters": 100000}})

PRESETS["celeba_hrnet_w48_ocr"] = _merge(PRESETS["celeba_hrnet_w48"], {
    # run_h_48_d_4_ocr_train.sh (celeba).
    "network": {"model_name": "hrnet_w48_ocr"},
    "loss": {"loss_type": "fs_auxce_loss"},
})

# coco_stuff tail (scripts/coco_stuff/*).
PRESETS["coco_stuff_hrnet48_isa"] = _merge(_COCO_STUFF_BASE, {
    "network": {"model_name": "hrnet48_isa", "backbone": "hrnet48",
                "stride": 4, "bf16": False,
                "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
    "loss": {"loss_type": "fs_auxce_loss"},
    "solver": {"max_iters": 60000},
})
PRESETS["coco_stuff_hrnet_w48_ocr_ohem"] = _merge(
    PRESETS["coco_stuff_hrnet_w48_ocr"],
    {"train": {"batch_size": 16},
     "loss": {"loss_type": "fs_auxohemce_loss"}})
PRESETS["coco_stuff_hrnet_w48_ocr_rmi"] = _merge(
    PRESETS["coco_stuff_hrnet_w48_ocr"],
    # run_h_48_d_4_ocr_ohem_train_rmi_paddle.sh + H_48_D_4_RMI.json.
    {"train": {"batch_size": 16},
     "loss": {"loss_type": "fs_aux_rmi_loss"}})
PRESETS["coco_stuff_ideal_spatial_ocrnet"] = _merge(
    PRESETS["coco_stuff_spatial_ocrnet"],
    {"network": {"model_name": "ideal_spatial_ocrnet"}})
PRESETS["coco_stuff_fcnet"] = _merge(
    PRESETS["coco_stuff_spatial_ocrnet"],
    {"network": {"model_name": "fcnet"}})

# lip tail (scripts/lip/*) — H_48_D_4 family keeps the ce2p data/transform
# block (label pairs, 473 crops) with the HRNet models.
PRESETS["lip_hrnet_w48"] = _merge(PRESETS["lip_hrnet_w48_ocr"], {
    "network": {"model_name": "hrnet_w48"},
    "loss": {"loss_type": "fs_ce_loss"},
})
PRESETS["lip_hrnet_w48_isa"] = _merge(PRESETS["lip_hrnet_w48_ocr"], {
    "network": {"model_name": "hrnet_w48_isa"},
    "loss": {"loss_type": "fs_ce_loss"},
})
PRESETS["lip_hrnet_w48_ocr_b"] = _merge(PRESETS["lip_hrnet_w48_ocr"], {
    "network": {"model_name": "hrnet_w48_ocr_b"},
})
PRESETS["lip_ce2p_ideal_ocrnet"] = _merge(PRESETS["lip_ce2p_ocrnet"], {
    # run_r_101_d_16_ce2p_gt_ocrnet_train.sh (same ce2p_auxce_loss
    # bitrot as lip_ce2p_ocrnet — fs_auxce is the nearest key).
    "network": {"model_name": "ce2p_ideal_ocrnet"},
})

# pascal_context tail (scripts/pascal_context/*).
PRESETS["pascal_context_hrnet_w48"] = _merge(_PCONTEXT_BASE, {
    # run_h_48_d_4_train.sh names fs_auxce_loss with the single-output
    # hrnet_w48 — inexecutable in the reference (HRNet_W48 returns one
    # map, FSAuxCELoss indexes two); fs_ce is the runnable intent.
    "network": {"model_name": "hrnet_w48", "backbone": "hrnet48",
                "stride": 4, "bf16": False},
    "loss": {"loss_type": "fs_ce_loss"},
    "solver": {"max_iters": 60000},
})
PRESETS["pascal_context_hrnet_w48_isa"] = _merge(_PCONTEXT_BASE, {
    "network": {"model_name": "hrnet_w48_isa", "backbone": "hrnet48",
                "stride": 4, "bf16": False},
    "loss": {"loss_type": "fs_ce_loss"},
    "solver": {"max_iters": 60000},
})
PRESETS["pascal_context_hrnet_w48_ocr_b"] = _merge(
    PRESETS["pascal_context_hrnet_w48_ocr"],
    {"network": {"model_name": "hrnet_w48_ocr_b"}})
PRESETS["pascal_context_hrnet_w48_ocr_rmi"] = _merge(
    PRESETS["pascal_context_hrnet_w48_ocr"],
    {"loss": {"loss_type": "fs_aux_rmi_loss"}})


def _r101_pcontext(model_name):
    # pascal_context R_101_D_8 runs: 30k iters (run_r_101_d_8_*_train.sh).
    return _merge(_PCONTEXT_BASE, {
        "train": {"batch_size": 16},
        "network": {"model_name": model_name,
                    "backbone": "deepbase_resnet101_dilated8",
                    "multi_grid": [1, 1, 1], "stride": 8, "bf16": False,
                    "loss_weights": {"aux_loss": 0.4, "seg_loss": 1.0}},
        "loss": {"loss_type": "fs_auxce_loss"},
        "solver": {"max_iters": 30000},
    })


PRESETS["pascal_context_spatial_ocrnet"] = _r101_pcontext("spatial_ocrnet")
PRESETS["pascal_context_spatial_asp_ocrnet"] = _r101_pcontext(
    "spatial_asp_ocrnet")
PRESETS["pascal_context_base_ocnet"] = _r101_pcontext("base_ocnet")
PRESETS["pascal_context_ideal_spatial_ocrnet"] = _r101_pcontext(
    "ideal_spatial_ocrnet")
PRESETS["pascal_context_fcnet"] = _r101_pcontext("fcnet")


# CPU-runnable smoke fixture (BASELINE.json config 1 on synthetic data).
PRESETS["smoke_hrnet_w18"] = _merge(_CITYSCAPES_BASE, _CONTRAST_BLOCK, {
    "data": {"num_classes": 5, "synthetic": True,
             "synthetic_size": [64, 128], "synthetic_length": 8,
             "label_list": None},
    "train": {"batch_size": 2,
              "data_transformer": {"input_size": [128, 64]}},
    "val": {"batch_size": 2,
            "data_transformer": {"input_size": [128, 64]}},
    "train_trans": {
        "random_crop": {"crop_size": [128, 64]},
    },
    "network": {"model_name": "hrnet_w18_mem", "backbone": "hrnet18",
                "stride": 4, "bf16": False},
    "loss": {"loss_type": "mem_contrast_ce_loss",
             "params": {"ce_weight": None, "ce_ignore_index": -1}},
    "contrast": {"max_samples": 64, "max_views": 8, "warmup_iters": 0,
                 "with_memory": True, "memory_size": 50, "stride": 4},
    "solver": {"display_iter": 1, "test_interval": 0, "max_iters": 2},
    "checkpoints": {"checkpoints_dir": "./checkpoints/smoke",
                    "save_iters": 1000000},
})


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return Config(copy.deepcopy(PRESETS[name]))
