"""The modules under the port's training CLI against their JAX
counterparts, on the CPU: the synthetic dataset, the loss meter and the
throughput logger, the user config, verification's `test()` and its
callback; and, with no JAX counterpart to hold them to, the port's own
prefetcher, checkpoints and eval step.

Everything compared here is host numpy or host logic, so the comparisons
are exact unless a test says otherwise.
"""

import glob
import logging
import os
import re

import numpy as np
import pytest
import torch
import yaml

from msml_tpu.core import callbacks as jcallbacks
from msml_tpu.core import config as jconfig
from msml_tpu.core import logging as jlogging
from msml_tpu.data import synthetic as jsynthetic
from msml_tpu.eval import verification as jver
from msml_torch.core import callbacks, checkpoint
from msml_torch.core import config as tconfig
from msml_torch.core import logging as tlogging
from msml_torch.data import synthetic
from msml_torch.data.pipeline import device_prefetch
from msml_torch.eval import verification as ver
from msml_torch.train.train_step import TrainState, make_eval_step
from test_torch_sweep import subsample, write_bin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("shard_id", [0, 1])
def test_synthetic_dataset_matches_jax(shard_id, uint8):
    kw = dict(batch_size=3, steps_per_epoch=2, size=16, num_classes=50,
              seed=4, shard_id=shard_id, num_shards=2, uint8=uint8)
    ours, theirs = synthetic.SyntheticDataset(**kw), \
        jsynthetic.SyntheticDataset(**kw)
    assert len(ours) == len(theirs) == 12
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes(), k


def test_average_meter_matches_jax():
    ours, theirs = tlogging.AverageMeter(), jlogging.AverageMeter()
    for val, n in ((3.0, 1), (1.5, 4), (-2.0, 2), (0.25, 1)):
        ours.update(val, n)
        theirs.update(val, n)
        assert vars(ours) == vars(theirs)
    ours.reset()
    theirs.reset()
    assert vars(ours) == vars(theirs)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("frequency", [1, 3, 5])
def test_throughput_logger_logs_where_jax_does(frequency):
    """The same steps logged, with the same loss, epoch and extra text
    (the speed and ETA are clock readings)."""
    out = []
    for mod in (tlogging, jlogging):
        logger = logging.getLogger(f"cli_parts_{mod.__name__}_{frequency}")
        logger.propagate = False
        rec = _Records()
        logger.handlers[:] = [rec]
        logger.setLevel(logging.INFO)
        tlog = mod.ThroughputLogger(frequency, 17, 8, 1, logger)
        meter = mod.AverageMeter()
        for step in range(1, 18):
            meter.update(float(step) / 3)
            tlog(step, meter, step // 6, extra="lr_factor 0.1000")
        out.append([re.sub(r"Speed \S+ samples/sec \(\S+ img/s/chip\)|"
                           r"Required: \S+ hours", "", line)
                    for line in rec.lines])
    assert out[0] == out[1]
    assert len(out[0]) == 17 // frequency - 1


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_user_config_dict_matches_jax(path, tmp_path):
    """user_config_dict of the derived config, and what save_yaml writes:
    PyYAML and the port's load_yaml read it back unchanged."""
    def derive(mod):
        try:
            return mod.user_config_dict(mod.config_init(
                mod.load_yaml(path), make_output_dir=False))
        except ValueError as e:  # e.g. a dataset neither package knows
            return ("ValueError", str(e))

    want, got = derive(jconfig), derive(tconfig)
    assert got == want
    if isinstance(want, tuple):
        return
    assert tconfig.USER_KEYS == jconfig.USER_KEYS
    tconfig.save_yaml(got, str(tmp_path / "config.yaml"))
    with open(tmp_path / "config.yaml") as f:
        assert yaml.safe_load(f) == want
    assert tconfig.load_yaml(str(tmp_path / "config.yaml")) == want


def test_default_config_matches_jax():
    assert tconfig.default_config() == jconfig.default_config()
    assert tconfig.default_config().peer_params.use_ori is True


def _pairs(n_pairs, size, seed):
    rng = np.random.RandomState(seed)
    first = rng.randint(0, 256, (n_pairs, size, size, 3)).astype(np.float32)
    second = np.where(np.arange(n_pairs)[:, None, None, None] % 2 == 0,
                      np.clip(first + 9, 0, 255),
                      rng.randint(0, 256, first.shape).astype(np.float32))
    data = np.stack([first, second], 1).reshape(-1, size, size, 3)
    return [data, data[:, :, ::-1].copy()], [p % 2 == 0
                                             for p in range(n_pairs)]


@pytest.mark.parametrize("is_gray,use_norm,batch_size", [
    (False, True, 7), (False, False, 40), (True, True, 9)])
def test_verification_test_matches_jax(is_gray, use_norm, batch_size):
    """Accuracy, its spread and XNorm equal for the same embedding
    function; batch 7 and 9 exercise the overlapping tail window."""
    data_list, issame = _pairs(60, 8, seed=3)
    proj = np.random.RandomState(5).randn(8 * 8 * (1 if is_gray else 3),
                                          16)

    def extract_fn(img):
        return img.reshape(img.shape[0], -1) @ proj

    got = ver.test(data_list, issame, extract_fn, batch_size,
                   is_gray=is_gray, use_norm=use_norm)
    want = jver.test(data_list, issame, extract_fn, batch_size,
                     is_gray=is_gray, use_norm=use_norm)
    assert got[:3] == want[:3]
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)


def _embeddings(case):
    """(embeddings, issame) of a metric case: random unit features, or
    squared distances on the thresholds' own 0.001 grid (ties)."""
    n, dtype, issame = {"f64": (40, np.float64, "alternate"),
                        "f32": (37, np.float32, "alternate"),
                        "one_kind_fold": (40, np.float64, "halves"),
                        "lfw_like": (600, np.float64, "alternate"),
                        "ties": (120, np.float64, "alternate"),
                        "ties_f32": (120, np.float32, "alternate"),
                        "empty_fold": (9, np.float64, "alternate")}[case]
    rng = np.random.RandomState(len(case))
    if case.startswith("ties"):
        emb = np.zeros((2 * n, 2))
        emb[1::2, 0] = np.sqrt(rng.randint(0, 4000, n) / 1000.0)
    else:
        emb = ver.l2_normalize_np(rng.randn(2 * n, 16))
    same = {"alternate": [p % 2 == 0 for p in range(n)],
            "halves": [p < n // 2 for p in range(n)]}[issame]
    return emb.astype(dtype), same


@pytest.mark.parametrize("case", ["f64", "f32", "lfw_like", "ties",
                                  "ties_f32", "empty_fold", "one_kind_fold"])
def test_evaluate_matches_jax(case):
    """The 10-fold ROC and VAL@FAR, every threshold of a fold at once,
    return JAX's loop's values bit for bit, and raise where it divides by
    zero (a fold without a pair, or without a same or a different one)."""
    emb, issame = _embeddings(case)
    results = []
    for impl in (ver, jver):
        try:
            results.append(impl.evaluate(emb, issame))
        except ZeroDivisionError:
            results.append(None)
    got, want = results
    assert (got is None) == (want is None) == case.endswith("_fold")
    for a, b in zip(got or (), want or ()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_callback_logs_what_jax_logs(tmp_path):
    """Both callbacks on the same .bin and embedding function log the same
    XNorm, Accuracy-Flip and Accuracy-Highest lines, at the same steps."""
    write_bin(str(tmp_path / "lfw.bin"))
    lines = []
    for mod in (callbacks, jcallbacks):
        logger = logging.getLogger(f"cli_parts_cb_{mod.__name__}")
        logger.propagate = False
        rec = _Records()
        logger.handlers[:] = [rec]
        logger.setLevel(logging.INFO)
        cb = mod.CallBackVerification(2, ["lfw", "agedb_30"], str(tmp_path),
                                      subsample, logger=logger)
        assert cb(1) is None
        cb(2)
        cb(4)
        lines.append(rec.lines)
    assert lines[0] == lines[1]
    assert any("[lfw][4]Accuracy-Highest" in line for line in lines[0])
    assert any("agedb_30.bin not found" in line for line in lines[0])


def test_device_prefetch_yields_the_batches_in_order():
    data = synthetic.SyntheticDataset(2, steps_per_epoch=5, size=8,
                                      uint8=True)
    got = list(device_prefetch(data.epoch(0), "cpu"))
    assert len(got) == 5
    for a, b in zip(got, data.epoch(0)):
        for k in b:
            assert torch.equal(a[k], torch.from_numpy(b[k]))


def test_device_prefetch_closes_and_raises():
    closed = []

    def source(fail_at=None):
        try:
            for i in range(100):
                if i == fail_at:
                    raise OSError("reader failed")
                yield {"x": np.full((2,), i)}
        finally:
            closed.append(True)

    it = device_prefetch(source(), "cpu")
    assert int(next(it)["x"][0]) == 0
    it.close()
    assert closed == [True]
    with pytest.raises(OSError, match="reader failed"):
        list(device_prefetch(source(fail_at=3), "cpu"))


def _tiny_state(seed):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return TrainState(model.train(), opt, torch.Generator().manual_seed(seed))


def test_checkpoints_keep_three_and_restore_exactly(tmp_path):
    state = _tiny_state(0)
    x = torch.randn((6, 4), generator=torch.Generator().manual_seed(1))
    saved = {}
    writer = checkpoint.CheckpointWriter(str(tmp_path))
    for step in range(1, 6):
        state.optimizer.zero_grad()
        state.model(x).square().sum().backward()
        state.optimizer.step()
        state.step = step
        torch.rand((3,), generator=state.generator)
        assert writer.save(state, step)
        assert not writer.save(state, step)  # same step: no-op
        saved[step] = ({k: v.clone() for k, v in
                        state.model.state_dict().items()},
                       [state.optimizer.state[p]["momentum_buffer"].clone()
                        for p in state.model.parameters()],
                       state.generator.get_state())
    writer.close()
    assert checkpoint.all_steps(str(tmp_path)) == [3, 4, 5]
    assert checkpoint.latest_step(str(tmp_path)) == 5
    for step in (4, None):
        fresh = _tiny_state(9)
        assert checkpoint.restore_checkpoint(str(tmp_path), fresh,
                                             step) is fresh
        params, momentum, gen = saved[step or 5]
        assert fresh.step == (step or 5)
        for k, v in fresh.model.state_dict().items():
            assert torch.equal(v, params[k]), k
        for p, m in zip(fresh.model.parameters(), momentum):
            assert torch.equal(fresh.optimizer.state[p]["momentum_buffer"],
                               m)
        assert torch.equal(fresh.generator.get_state(), gen)
    assert checkpoint.restore_checkpoint(str(tmp_path / "none"),
                                         _tiny_state(0)) is None


class _Features(torch.nn.Module):
    """(feature, seg) like MSML's eval forward, with a BatchNorm so that
    eval mode shows."""

    def __init__(self):
        super().__init__()
        self.bn = torch.nn.BatchNorm2d(3)
        self.fc = torch.nn.Linear(3 * 4 * 5, 6)

    def forward(self, x):
        return self.fc(self.bn(x).flatten(1)), None


def test_eval_step_runs_eval_mode_and_restores_train():
    torch.manual_seed(2)
    model = _Features()
    with torch.no_grad():
        model.bn.running_mean.uniform_()
        model.bn.running_var.uniform_(0.5, 2.0)
    model.train()
    img = np.random.RandomState(0).randn(2, 4, 5, 3).astype(np.float32)
    feats = make_eval_step(model)(img)
    assert model.training and isinstance(feats, np.ndarray)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(img).permute(0, 3, 1, 2))[0]
    np.testing.assert_array_equal(feats, want.numpy())
