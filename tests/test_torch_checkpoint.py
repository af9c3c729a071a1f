"""Asynchronous checkpoint saves (`msml_torch/core/checkpoint.py::
CheckpointWriter`) on the CPU, on a small train state (a linear layer with
SGD momentum and a relight generator, seeded).

The background write is held at a gate (`_write` patched to wait on an
event), so the tests see `save` return while the write has not started,
change the parameters in place, and then read what was written.
"""

import os
import re
import threading

import pytest
import torch

from msml_torch.cli import train as cli
from msml_torch.core import checkpoint
from msml_torch.train.train_step import TrainState


def small_state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                torch.nn.BatchNorm1d(5))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(4, 6)).square().sum().backward()
    opt.step()
    return TrainState(model, opt, torch.Generator().manual_seed(seed), 1)


@pytest.fixture
def gate(monkeypatch):
    """Hold every background write until `gate.set()`; records the thread
    each write ran on."""
    release = threading.Event()
    release.threads = []
    real = checkpoint._write

    def gated(output_dir, payload, step):
        release.threads.append(threading.current_thread().name)
        assert release.wait(timeout=60)
        real(output_dir, payload, step)

    monkeypatch.setattr(checkpoint, "_write", gated)
    return release


def test_save_returns_before_the_write(tmp_path, gate):
    state = small_state()
    w = checkpoint.CheckpointWriter(str(tmp_path))
    assert w.save(state, 1) is True
    assert checkpoint.all_steps(str(tmp_path)) == []
    assert w._thread.is_alive()
    gate.set()
    w.wait()
    assert checkpoint.all_steps(str(tmp_path)) == [1]
    assert gate.threads == ["checkpoint-1"]
    assert w._thread is None
    w.close()


def test_in_place_update_after_save_does_not_reach_the_file(tmp_path, gate):
    """SGD updates in place after `save` returns: the file still holds the
    state of the step it names."""
    state = small_state()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = [state.optimizer.state[p]["momentum_buffer"].clone()
                for p in state.model.parameters()]
    gen = state.generator.get_state()
    w = checkpoint.CheckpointWriter(str(tmp_path))
    w.save(state, 1)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for p in state.model.parameters():
            state.optimizer.state[p]["momentum_buffer"].mul_(-3.0)
        state.model[1].running_mean.add_(5.0)
    state.generator.manual_seed(99)
    state.step = 2
    gate.set()
    w.close()
    fresh = small_state(seed=4)
    checkpoint.restore_checkpoint(str(tmp_path), fresh, 1)
    assert fresh.step == 1
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for p, m in zip(fresh.model.parameters(), momentum):
        assert torch.equal(fresh.optimizer.state[p]["momentum_buffer"], m)
    assert torch.equal(fresh.generator.get_state(), gen)


def test_keep_three_and_same_step_is_a_no_op(tmp_path):
    state = small_state()
    w = checkpoint.CheckpointWriter(str(tmp_path))
    for step in (2, 4, 6, 8, 10):
        state.step = step
        assert w.save(state, step) is True
    assert w.save(state, 10) is False  # waits for 10, then finds it
    w.close()
    assert checkpoint.all_steps(str(tmp_path)) == [6, 8, 10]
    assert not [n for n in os.listdir(tmp_path / "ckpt")
                if n.endswith(".tmp")]
    assert checkpoint.CheckpointWriter(str(tmp_path)).save(state, 8) is False


def test_sync_save_blocks(tmp_path, gate):
    """async_save=False (the CLI's --sync-ckpt) writes on the caller's
    thread before `save` returns."""
    gate.set()
    state = small_state()
    w = checkpoint.CheckpointWriter(str(tmp_path), async_save=False)
    assert w.save(state, 3) is True
    assert w._thread is None
    assert checkpoint.all_steps(str(tmp_path)) == [3]
    assert gate.threads == [threading.current_thread().name]
    assert cli.parse_args(["--sync-ckpt"]).sync_ckpt
    assert not cli.parse_args([]).sync_ckpt


def test_writer_error_is_raised_again(tmp_path, monkeypatch):
    """An exception in the background write is raised at the next `wait`,
    `save` or `close`, once each."""
    calls = []

    def failing(output_dir, payload, step):
        calls.append(step)
        raise OSError(f"disk full at {step}")

    monkeypatch.setattr(checkpoint, "_write", failing)
    state = small_state()
    w = checkpoint.CheckpointWriter(str(tmp_path))
    assert w.save(state, 1) is True
    with pytest.raises(OSError, match="disk full at 1"):
        w.wait()
    w.wait()  # reported once
    w.save(state, 2)
    with pytest.raises(OSError, match="disk full at 2"):
        w.save(state, 3)
    assert calls == [1, 2]
    w.save(state, 4)
    with pytest.raises(OSError, match="disk full at 4"):
        w.close()
    assert checkpoint.all_steps(str(tmp_path)) == []


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_cli_save_mode(tmp_path, sync):
    """The CLI saves in the background unless --sync-ckpt; either way the
    checkpoint of the last step is on disk when main returns."""
    import chip_smoke
    from msml_torch.core.config import Config

    cfg = Config.from_dict(dict(chip_smoke.ARC18_MSML, dataset="synthetic",
                                batch_size=2, num_classes=16, fp16=False,
                                out_folder=str(tmp_path)))
    argv = ["--device", "cpu", "--steps", "2", "--ckpt-every", "1"]
    state = cli.main(cli.parse_args(argv + (["--sync-ckpt"] if sync
                                            else [])), cfg)
    folder = os.path.join(str(tmp_path), "arc18_msml_1")
    with open(os.path.join(folder, "training.log")) as f:
        log = f.read()
    assert state.step == 2 and checkpoint.all_steps(folder) == [1, 2]
    background = re.findall(r"checkpoint (\d+) written in the background",
                            log)
    assert background == ([] if sync else ["1", "2"])
    assert re.search(r"periodic checkpoint at step 1 \(\S+ s on the loop\)",
                     log)
