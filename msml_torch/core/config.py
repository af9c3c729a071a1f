"""Two-stage config system: user YAML merged with programmatic derivation.

Counterpart of `msml_tpu/core/config.py` (reference `config.py:13-137`): the
user YAML holds dataset / recipe / model / experiment keys; `config_init`
derives per-dataset class counts, epoch schedules, model defaults and the
output directory `out/{prefix}_{exp_id}`. `yaml` is imported only by
`load_yaml`, so a config built with `Config.from_dict` needs no PyYAML.
"""

from __future__ import annotations

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
    """YAML -> Config (reference `config.py:132-137`)."""
    import yaml

    with open(file_name) as f:
        loaded = yaml.safe_load(f)
    return Config.from_dict(loaded)


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
        # smoke dataset: random images + labels
        cfg.setdefault("rec", "")
        cfg.nw = 0
        cfg.setdefault("num_classes", 1000)
        cfg.setdefault("num_epoch", 1)
        cfg.warmup_epoch = -1
        cfg.val_targets = []
        cfg.decay_epochs = [1]
        cfg.decay_scale = 0.1
    else:
        raise ValueError(f"Unknown dataset: {cfg.dataset}")


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
