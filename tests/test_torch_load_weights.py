"""`pretrained_backbone` in the port against `msml_tpu.tools.load_weights`.

The same numpy-drawn donor weights, written as JAX's `export_frb` `.npz`,
as JAX's `export_torch` `backbone.pth`, as a vanilla iResNet `.pth` (the
trunk without the `frb.` prefix) and as a port `ckpt/<step>.pt`, are
overlaid by JAX's `load_pretrained` onto a flax state and by the port's
onto a train state that start from the same weights. After
`state_dict_from_jax` the two results are equal exactly, the groups that
were not overlaid keep their weights, both log the same count, and both
raise and warn alike. Then `cli.train` overlays before its first step,
raises for a missing `peer_weights` file (tests/test_torch_peer_weights.py
holds `peer_weights` itself against JAX), and a `--resume` wins over the
pretrained weights.
arc18_msml's structure with one block per iResNet stage, float32, a
16-class head, on the CPU."""

import contextlib
import logging
import os
import re

import flax
import jax
import numpy as np
import pytest
import torch

from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
from msml_tpu.tools import export_frb as jax_export_frb
from msml_tpu.tools.export_torch import export_msml_state_dict
from msml_tpu.tools.load_weights import load_pretrained as jax_load
from msml_torch.cli import train as cli_train
from msml_torch.core.config import Config, config_init
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn.iresnet import IRESNET_LAYERS
from msml_torch.nn.msml import msml_from_config
from msml_torch.tools.convert import state_dict_from_jax
from msml_torch.tools.load_weights import load_pretrained
from msml_torch.train import train_step
from tests.test_torch_export_weights import (CLASSES, assert_state_dicts_equal,
                                             jax_trees)
from tests.test_torch_nn import arc18_configs
from tests.test_torch_weight_folder import SMALL

SOURCES = ["npz", "jax_pth", "vanilla_pth", "port_ckpt"]
COUNT = re.compile(r"loaded (\d+) pretrained backbone tensors from")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


@flax.struct.dataclass
class JaxState:
    params: dict
    batch_stats: dict


@contextlib.contextmanager
def records(name):
    """The records of logger `name` at INFO and above, whatever its
    handlers and propagation."""
    got = []
    handler = logging.Handler()
    handler.emit = got.append
    logger = logging.getLogger(name)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield got
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def messages(recs):
    return [r.getMessage() for r in recs]


def trunk_only(sd):
    """The keys of a torch state dict in the frb trunk (no FM operators)."""
    return {k for k in sd if k.startswith("frb.")
            and not k.startswith("frb.fm_ops.")}


def copied(keys):
    """Of `keys`, those a load copies: no counter, no frozen features
    scale."""
    return {k for k in keys if not k.endswith("num_batches_tracked")
            and k != "frb.features.weight"}


def write_source(kind, trees, path_dir):
    params, stats = trees
    if kind == "npz":
        path = os.path.join(path_dir, "frb.npz")
        jax_export_frb.save_npz(path, *jax_export_frb.extract_frb(params,
                                                                  stats))
        return path
    sd = {k: torch.from_numpy(np.array(
        v, np.int64 if v.dtype == np.int64 else np.float32))
        for k, v in export_msml_state_dict(params, stats).items()}
    if kind == "jax_pth":
        path = os.path.join(path_dir, "backbone.pth")
        torch.save(sd, path)
    elif kind == "vanilla_pth":
        path = os.path.join(path_dir, "iresnet.pth")
        torch.save({k[len("frb."):]: v for k, v in sd.items()
                    if k in trunk_only(sd)}, path)
    else:
        path = os.path.join(path_dir, "7.pt")
        torch.save({"model": state_dict_from_jax(params, stats),
                    "optimizer": {}, "step": 7}, path)
    return path


def jax_state(trees):
    return JaxState(params=jax.device_put(trees[0]),
                    batch_stats=jax.device_put(trees[1]))


def port_state(trees):
    _, tcfg = arc18_configs()
    tcfg.num_classes = CLASSES
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    model.load_state_dict(state_dict_from_jax(*trees), strict=True)
    return train_step.init_train_state(model, tcfg, "cpu")


def configs(**keys):
    jcfg, tcfg = arc18_configs()
    for cfg in (jcfg, tcfg):
        cfg.update(keys)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def template():
    return jax_trees(seed=0)


@pytest.fixture(scope="module")
def donor():
    return jax_trees(seed=1)


@pytest.fixture(scope="module")
def loaded(template, donor, tmp_path_factory):
    """source -> (JAX's result as a port state dict, the port's state
    dict, JAX's log lines, the port's)."""
    out, paths = {}, {}
    for kind in SOURCES:  # jax_pth comes before port_ckpt
        path = paths[kind] = write_source(kind, donor, str(
            tmp_path_factory.mktemp(kind)))
        jcfg, tcfg = configs(pretrained_backbone=path)
        # JAX reads the checkpoint's weights from the same backbone.pth
        if kind == "port_ckpt":
            jcfg.pretrained_backbone = paths["jax_pth"]
        with records("msml_tpu") as jrec:
            js = jax_load(jax_state(template), jcfg)
        with records("msml_torch") as trec:
            ts = load_pretrained(port_state(template), tcfg)
        out[kind] = (state_dict_from_jax(jax.device_get(js.params),
                                         jax.device_get(js.batch_stats)),
                     ts.model.state_dict(), messages(jrec), messages(trec))
    return out


@pytest.mark.parametrize("kind", SOURCES)
def test_overlay_equals_jax(loaded, kind):
    want, got, _, _ = loaded[kind]
    assert_state_dicts_equal(got, want)


@pytest.mark.parametrize("kind", SOURCES)
def test_overlay_takes_the_donor_and_keeps_the_rest(loaded, template, donor,
                                                    kind):
    _, got, _, _ = loaded[kind]
    before, new = state_dict_from_jax(*template), state_dict_from_jax(*donor)
    overlaid = copied(trunk_only(new) if kind in ("npz", "vanilla_pth")
                      else new)
    assert overlaid and set(got) - overlaid
    for k, v in got.items():
        assert torch.equal(v, (new if k in overlaid else before)[k]), k


@pytest.mark.parametrize("kind", SOURCES)
def test_same_count_logged(loaded, donor, kind):
    _, _, jlog, tlog = loaded[kind]
    jn = [int(m.group(1)) for m in map(COUNT.search, jlog) if m]
    tn = [int(m.group(1)) for m in map(COUNT.search, tlog) if m]
    assert len(jn) == len(tn) == 1 and jn == tn
    leaves = (jax.tree.leaves(donor[0]["frb"]) if kind in ("npz",
                                                           "vanilla_pth")
              else jax.tree.leaves(donor[0]))
    assert tn[0] == len(leaves)


@pytest.mark.parametrize("kind", ["npz", "jax_pth"])
def test_shape_mismatch_raises_in_both(template, donor, tmp_path, kind):
    params = jax.tree.map(np.asarray, donor[0])
    params["frb"]["bn2"]["bias"] = np.zeros((511,), np.float32)
    path = write_source(kind, (params, donor[1]), str(tmp_path))
    jcfg, tcfg = configs(pretrained_backbone=path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_load(jax_state(template), jcfg)
    with pytest.raises(ValueError, match="shape mismatch at frb.bn2.bias"):
        load_pretrained(port_state(template), tcfg)


@pytest.mark.parametrize("name, error", [
    ("missing.pth", FileNotFoundError), ("weights.bin", ValueError)])
def test_missing_or_unknown_file_raises_in_both(template, tmp_path, name,
                                                error):
    if error is ValueError:
        (tmp_path / name).write_bytes(b"\0")
    jcfg, tcfg = configs(pretrained_backbone=str(tmp_path / name))
    with pytest.raises(error):
        jax_load(jax_state(template), jcfg)
    with pytest.raises(error):
        load_pretrained(port_state(template), tcfg)


def test_pretrained_without_weights_warns_in_both(template):
    jcfg, tcfg = configs(pretrained=True)
    with records("msml_tpu") as jrec:
        jax_load(jax_state(template), jcfg)
    with records("msml_torch") as trec:
        state = load_pretrained(port_state(template), tcfg)
    assert messages(jrec) == messages(trec)
    assert len(trec) == 1 and trec[0].levelno == logging.WARNING
    assert "cfg.pretrained is set" in trec[0].getMessage()
    assert_state_dicts_equal(state.model.state_dict(),
                             state_dict_from_jax(*template))


def test_features_scale_warning_in_both(template, donor, tmp_path):
    path = write_source("jax_pth", donor, str(tmp_path))
    sd = torch.load(path)
    sd["frb.features.weight"] = torch.full((512,), 2.0)
    torch.save(sd, path)
    jcfg, tcfg = configs(pretrained_backbone=path)
    with pytest.warns(UserWarning, match="features BN scale != 1.0"):
        jax_load(jax_state(template), jcfg)
    with pytest.warns(UserWarning, match="features BN scale != 1.0"):
        state = load_pretrained(port_state(template), tcfg)
    assert state.model.frb.features.weight.eq(1).all()  # stays frozen at 1


def test_peer_weights_is_refused(template, tmp_path):
    """`peer_weights` was refused until the teacher was ported; now a
    missing file is refused, by the CLI and by `load_pretrained`, with
    JAX's FileNotFoundError."""
    missing = str(tmp_path / "peer.pth")
    cfg = Config.from_dict(dict(SMALL, out_folder=str(tmp_path),
                                peer_weights=missing))
    with pytest.raises(FileNotFoundError, match="peer.pth"):
        cli_train.main(cli_train.parse_args(["--device", "cpu",
                                             "--steps", "1"]), cfg)
    jcfg, tcfg = configs(peer_weights=missing)
    with pytest.raises(FileNotFoundError, match="peer.pth"):
        jax_load(jax_state(template), jcfg)
    with pytest.raises(FileNotFoundError, match="peer.pth"):
        load_pretrained(port_state(template), tcfg)


def first_step_weights(monkeypatch):
    """Patch the CLI's step so that its first call records the model's
    state dict before the step runs."""
    seen = {}
    make = train_step.make_train_step

    def recording(cfg):
        step = make(cfg)

        def wrapped(state, *args, **kwargs):
            if not seen:
                seen.update({k: v.clone() for k, v in
                             state.model.state_dict().items()})
            return step(state, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(train_step, "make_train_step", recording)
    return seen


def run_cli(out, steps, *flags, **keys):
    cfg = Config.from_dict(dict(SMALL, out_folder=str(out), **keys))
    return cli_train.main(cli_train.parse_args(
        ["--device", "cpu", "--seed", "0", "--steps", str(steps), *flags]),
        cfg)


def test_cli_overlays_before_step_one(donor, tmp_path, monkeypatch):
    path = write_source("jax_pth", donor, str(tmp_path))
    seen = first_step_weights(monkeypatch)
    state = run_cli(tmp_path, 1, pretrained_backbone=path)
    assert state.step == 1
    fresh = msml_from_config(config_init(Config.from_dict(
        dict(SMALL, out_folder=str(tmp_path))), make_output_dir=False),
        device="cpu", seed=0, head=True).state_dict()
    new = state_dict_from_jax(*donor)
    for k, v in seen.items():
        assert torch.equal(v, (new if k in copied(new) else fresh)[k]), k
    with open(tmp_path / "arc18_msml_1" / "training.log") as f:
        counts = COUNT.findall(f.read())
    assert counts == [str(len(jax.tree.leaves(donor[0])))]


def test_resume_wins_over_pretrained(donor, tmp_path, monkeypatch):
    run_cli(tmp_path, 1)
    saved = torch.load(tmp_path / "arc18_msml_1" / "ckpt" / "1.pt",
                       weights_only=True)["model"]
    path = write_source("jax_pth", donor, str(tmp_path))
    seen = first_step_weights(monkeypatch)
    state = run_cli(tmp_path, 2, "--resume", pretrained_backbone=path)
    assert state.step == 2
    assert_state_dicts_equal(seen, saved)
