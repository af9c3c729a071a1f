"""Two-stage config system: user YAML merged with programmatic derivation.

Counterpart of `msml_tpu/core/config.py` (reference `config.py:13-137`): the
user YAML holds dataset / recipe / model / experiment keys; `config_init`
derives per-dataset class counts, epoch schedules, model defaults and the
output directory `out/{prefix}_{exp_id}`. `yaml` is imported only by
`load_yaml`, so a config built with `Config.from_dict` needs no PyYAML, and
`save_yaml` writes JSON, which is YAML too (PyYAML's `safe_load` and
`load_yaml` read it back unchanged).
"""

from __future__ import annotations

import json
import os
from typing import Any


class Config(dict):
    """Attribute-accessible dict (replacement for the reference's easydict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls._wrap(dict(d))


def load_yaml(file_name: str) -> Config:
    """YAML -> Config (reference `config.py:132-137`). A file that
    `save_yaml` wrote is JSON and is read without PyYAML."""
    with open(file_name) as f:
        text = f.read()
    try:
        loaded = json.loads(text)
    except ValueError:
        import yaml

        loaded = yaml.safe_load(text)
    return Config.from_dict(loaded)


def default_config() -> Config:
    """A complete training config with the reference's config.yaml defaults
    (reference `config.yaml:1-36`), used when no YAML is supplied."""
    return Config.from_dict({
        "dataset": "ms1m-retinaface-t2",
        "fp16": True,  # selects bf16 compute (see core/precision.py)
        "batch_size": 256,
        "frb_type": "iresnet18",
        "osb_type": "unet",
        "use_osb": True,
        "fm_layers": [1, 1, 1, 1],
        "fm_params": [3, 2, "sigmoid", "mul"],
        "peer_params": {
            "use_ori": True,
            "use_conv": True,
            "mask_trans": "conv",
            "use_decoder": True,
        },
        "header_type": "AMArcFace",
        "header_params": [64.0, 0.48, 0.0, 0.0],
        "exp_id": 1,
        "output_prefix": "arc18_msml",
    })


def config_init(cfg: Config, make_output_dir: bool = True) -> Config:
    """Main config derivation (reference `config.py:13-18`)."""
    _config_dataset(cfg)
    _config_recipe(cfg)
    _config_model(cfg)
    _config_exp(cfg, make_output_dir)
    return cfg


def _config_dataset(cfg: Config) -> None:
    """Per-dataset derived fields (reference `config.py:21-68`)."""
    cfg.is_gray = False
    cfg.out_size = (112, 112)
    cfg.use_norm = True

    if cfg.dataset == "ms1m-retinaface-t2":
        cfg.setdefault("rec", "/tmp/train_tmp/ms1m-retinaface")
        cfg.nw = 32
        cfg.num_classes = 93431
        cfg.num_epoch = 25
        cfg.warmup_epoch = -1
        cfg.val_targets = ["lfw", "cfp_fp", "agedb_30"]
        cfg.decay_epochs = [11, 17, 22]
        cfg.decay_scale = 0.1
    elif cfg.dataset == "webface":
        cfg.setdefault("rec", "/tmp/train_tmp/casia")
        cfg.nw = 32
        cfg.num_classes = 10572
        cfg.warmup_epoch = -1
        cfg.val_targets = []
        if cfg.frb_type == "iresnet50" and cfg.header_type == "AMCosFace":
            cfg.num_epoch = 40
            cfg.decay_epochs = [10, 25]
            cfg.decay_scale = 0.1
        elif cfg.frb_type == "lightcnn":
            cfg.num_epoch = 35
            cfg.decay_epochs = [15]
            cfg.decay_scale = 0.3162
        else:
            cfg.num_epoch = 34
            cfg.decay_epochs = [20, 28, 32]
            cfg.decay_scale = 0.1
    elif cfg.dataset == "custom":
        # user-provided RecordIO dataset: the yaml is authoritative
        if "num_classes" not in cfg:
            raise ValueError("dataset: custom requires num_classes")
        cfg.setdefault("rec", "")
        cfg.setdefault("nw", 32)
        cfg.setdefault("num_epoch", 25)
        cfg.setdefault("warmup_epoch", -1)
        cfg.setdefault("val_targets", [])
        cfg.setdefault("decay_epochs", [10, 18, 22])
        cfg.setdefault("decay_scale", 0.1)
    elif cfg.dataset == "synthetic":
        # smoke dataset: random images + labels. Unlike the JAX package it
        # keeps a user's val_targets, so that a smoke run can verify on
        # real `{rec}/{target}.bin` pairs
        cfg.setdefault("rec", "")
        cfg.nw = 0
        cfg.setdefault("num_classes", 1000)
        cfg.setdefault("num_epoch", 1)
        cfg.warmup_epoch = -1
        cfg.setdefault("val_targets", [])
        cfg.decay_epochs = [1]
        cfg.decay_scale = 0.1
    else:
        raise ValueError(f"Unknown dataset: {cfg.dataset}")


def lr_step_factor(cfg: Config, epoch: int) -> float:
    """The reference's LambdaLR closure (reference `config.py:35-39,64-68`;
    `msml_tpu/core/config.py:145-151`): quadratic warmup, then step decay
    at `decay_epochs`."""
    if epoch < cfg.warmup_epoch:
        return ((epoch + 1) / (4 + 1)) ** 2
    return cfg.decay_scale ** len([m for m in cfg.decay_epochs
                                   if m - 1 <= epoch])


def _config_recipe(cfg: Config) -> None:
    """Training recipe (reference `config.py:71-79`)."""
    cfg.momentum = 0.9
    cfg.weight_decay = 5e-4
    cfg.lr = 0.1  # 0.1 for total batch size 512
    cfg.lambda1 = 1.0  # l_total = l_cls + lambda1 * l_seg
    cfg.setdefault("grad_clip_norm", 5.0)  # reference train.py:270


def _config_model(cfg: Config) -> None:
    """Model defaults (reference `config.py:82-119`)."""
    cfg.pretrained = False
    cfg.fm_layers = tuple(cfg.fm_layers)
    cfg.header_params = tuple(cfg.header_params)
    cfg.dim_feature = 512
    cfg.setdefault("sample_rate", 1.0)  # PartialFC (reference config.py:97)
    cfg.setdefault("dropout", 0.0)

    if cfg.frb_type == "lightcnn":
        cfg.is_gray = True
        cfg.out_size = (128, 128)
        cfg.use_norm = False
        cfg.pretrained = True
        cfg.lr = 0.001 * 8
        cfg.dim_feature = 256
    elif (cfg.frb_type == "iresnet50" and cfg.header_type == "AMCosFace"
          and cfg.dataset == "webface"):
        cfg.pretrained = True
        cfg.lr = 0.01

    if cfg.get("peer_params") is None:
        cfg.peer_params = Config.from_dict({
            "use_ori": False,
            "use_conv": False,
            "mask_trans": "conv",
            "use_decoder": False,
        })


def _config_exp(cfg: Config, make_output_dir: bool) -> None:
    """Output folder (reference `config.py:122-129`)."""
    out_folder = cfg.get("out_folder", "out")
    cfg.output = os.path.join(out_folder, f"{cfg.output_prefix}_{cfg.exp_id}")
    if make_output_dir:
        os.makedirs(cfg.output, exist_ok=True)


USER_KEYS = ("dataset", "fp16", "batch_size", "frb_type", "osb_type",
             "use_osb", "fm_layers", "fm_params", "peer_params",
             "header_type", "header_params", "exp_id", "output_prefix",
             "num_classes", "num_epoch", "sample_rate", "use_partial_fc",
             "remat", "kd_metric", "kd_loss_weight", "decoder_loss_weight",
             "rec", "scan_unroll",
             "out_folder", "dropout", "pretrained_backbone", "peer_weights")
"""The user-level config surface (reference config.yaml keys + the JAX
package's extensions); what gets persisted next to weights."""


def user_config_dict(cfg: Config) -> dict:
    def plain(v):
        if isinstance(v, tuple):
            return list(v)
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v
    return {k: plain(cfg[k]) for k in USER_KEYS if k in cfg}


def save_yaml(cfg_raw: dict, path: str) -> None:
    """Persist the user-level config next to weights (reference
    train.py:71-72), as JSON text: a YAML document that needs no PyYAML to
    write."""
    with open(path, "w") as f:
        json.dump({k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in cfg_raw.items() if not callable(v)}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
