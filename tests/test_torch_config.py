"""The port's config derivation (msml_torch.core.config) against the JAX one,
and the flagship config that chip_smoke.py builds without PyYAML."""

import glob
import os

import pytest
import yaml

from msml_tpu.core import config as jconfig
from msml_torch.core import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _derive(module, path):
    try:
        return module.config_init(module.load_yaml(path),
                                  make_output_dir=False)
    except ValueError as e:  # e.g. a dataset neither package knows
        return ("ValueError", str(e))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_init_matches_jax(path):
    want = _derive(jconfig, path)
    got = _derive(tconfig, path)
    if isinstance(want, tuple):
        assert got == want
        return
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]) or isinstance(
            got[key], dict), key


def test_from_dict_matches_yaml():
    with open(os.path.join(REPO, "configs", "arc18_msml.yaml")) as f:
        raw = yaml.safe_load(f)
    cfg = tconfig.Config.from_dict(raw)
    assert cfg.peer_params.use_ori is False
    assert tconfig.config_init(cfg, make_output_dir=False) == \
        _derive(tconfig, os.path.join(REPO, "configs", "arc18_msml.yaml"))


def test_chip_smoke_config_is_arc18_msml():
    import chip_smoke

    with open(os.path.join(REPO, "configs", "arc18_msml.yaml")) as f:
        assert chip_smoke.ARC18_MSML == yaml.safe_load(f)
