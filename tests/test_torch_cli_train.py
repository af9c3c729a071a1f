"""The port's training CLI (`python -m msml_torch.cli.train`) on the CPU.

arc18_msml's structure at full width and depth (iResNet-18 FRB, U-Net OSB,
four FMCnn [3, 2, sigmoid, mul], AMArcFace s = 64, m = 0.48, device_light)
in float32 with 16 classes, batch 2, synthetic data, `--device cpu`: the
routed convs and the PReLU sites run their plain versions. The run
writes config.yaml, logs, checkpoints, resumes, verifies and stops cleanly
on SIGTERM; what it refuses, it refuses loudly.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from msml_torch.cli import train as cli
from msml_torch.core import checkpoint
from msml_torch.core.config import Config, config_init, user_config_dict
from msml_torch.eval.verification import test as ver_test
from msml_torch.nn.msml import msml_from_config
from msml_torch.train.train_step import init_train_state, make_eval_step
from test_torch_sweep import write_bin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(chip_smoke.ARC18_MSML, dataset="synthetic", batch_size=2,
             num_classes=16, fp16=False)


def config(out, **over):
    return Config.from_dict(dict(SMALL, out_folder=str(out), **over))


def run(out, *argv, **over):
    """main() on a fresh Config; -> (state, output folder, training.log)."""
    args = cli.parse_args(["--device", "cpu", "--seed", "0", *argv])
    state = cli.main(args, config(out, **over))
    folder = os.path.join(str(out), "arc18_msml_1")
    with open(os.path.join(folder, "training.log")) as f:
        return state, folder, f.read()


@pytest.fixture(scope="module")
def three_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    return run(out, "--steps", "3", "--log-every", "1")


def test_writes_the_user_config(three_steps):
    _, folder, _ = three_steps
    want = user_config_dict(config_init(config(os.path.dirname(folder)),
                                        make_output_dir=False))
    with open(os.path.join(folder, "config.yaml")) as f:
        assert yaml.safe_load(f) == want


def test_logs_speed_and_loss(three_steps):
    state, _, log = three_steps
    assert state.step == 3
    speed = re.findall(r"Speed \S+ samples/sec .* Loss (\S+) Epoch: 0 "
                       r"Global Step: (\d+)", log)
    assert [int(s) for _, s in speed] == [2, 3]
    assert all(np.isfinite(float(v)) for v, _ in speed)
    assert "Total Step is: 3" in log
    assert "checkpoint saved at step 3 (epoch 0)" in log
    assert "training finished at step 3" in log


def test_checkpoint_round_trip_is_exact(three_steps):
    """Parameters, BN statistics, momentum, step and the relight
    generator's state, restored into a fresh state."""
    state, folder, _ = three_steps
    assert 3 in checkpoint.all_steps(folder)
    cfg = config_init(config(os.path.dirname(folder)), make_output_dir=False)
    fresh = init_train_state(msml_from_config(cfg, device="cpu", seed=5,
                                              head=True), cfg, "cpu", seed=5)
    assert checkpoint.restore_checkpoint(folder, fresh, 3) is fresh
    assert fresh.step == state.step == 3
    want = state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    mine = dict(zip([n for n, _ in state.model.named_parameters()],
                    state.model.parameters()))
    n_momentum = 0
    for name, p in fresh.model.named_parameters():
        got = fresh.optimizer.state[p].get("momentum_buffer")
        want = state.optimizer.state[mine[name]].get("momentum_buffer")
        assert (got is None) == (want is None), name
        if want is not None:
            assert torch.equal(got, want), name
            n_momentum += 1
    assert n_momentum > 100
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())


def test_resume_continues_to_steps(three_steps):
    _, folder, _ = three_steps
    state, _, log = run(os.path.dirname(folder), "--steps", "5",
                        "--log-every", "1", "--resume", "--ckpt-every", "4")
    assert "backbone resume successfully! step=3" in log
    assert state.step == 5
    assert "periodic checkpoint at step 4" in log
    assert checkpoint.all_steps(folder) == [3, 4, 5]


def test_verification_every_n_steps(tmp_path):
    """--ver-every runs the callback on {rec}/lfw.bin and logs what
    verification.test gives for the trained model."""
    rec = tmp_path / "rec"
    rec.mkdir()
    write_bin(str(rec / "lfw.bin"), pairs=20)
    state, _, log = run(tmp_path / "out", "--steps", "2", "--ver-every", "2",
                        rec=str(rec), val_targets=["lfw"])
    flip = re.findall(r"\[lfw\]\[2\]Accuracy-Flip: (\S+)\+-(\S+)", log)
    assert len(flip) == 1
    assert re.search(r"\[lfw\]\[2\]XNorm: \S+", log)
    assert "[lfw][2]Accuracy-Highest" in log
    from msml_torch.data.bin_loader import load_bin

    data_list, issame = load_bin(str(rec / "lfw.bin"))
    acc, std, _, _ = ver_test(data_list, issame, make_eval_step(state.model),
                              40)
    assert flip[0] == ("%1.5f" % acc, "%1.5f" % std)
    assert state.model.training


def test_peer_teacher_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="peer"):
        run(tmp_path, "--steps", "1",
            peer_params={"use_ori": True, "use_conv": True,
                         "mask_trans": "conv", "use_decoder": True})


def test_default_config_is_refused(tmp_path, monkeypatch):
    """No --config: the reference defaults, whose peer teacher
    (use_ori: true) is not ported."""
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--config",
                           str(tmp_path / "missing.yaml"), "--steps", "1"])
    with pytest.raises(NotImplementedError, match="peer"):
        cli.main(args)
    assert os.path.exists(tmp_path / "out" / "arc18_msml_1" / "config.yaml")


def test_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args, config(tmp_path))


@pytest.mark.parametrize("argv,over", [
    (["--strategy", "fsdp"], {}), (["--scan-steps", "2"], {}),
    (["--multihost"], {}), (["--tensorboard"], {}),
    ([], {"sample_rate": 0.5})], ids=["strategy", "scan_steps", "multihost",
                                      "tensorboard", "partial_fc"])
def test_not_ported_options_are_refused(tmp_path, argv, over):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run(tmp_path, "--steps", "1", *argv, **over)


def test_recordio_dataset_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="face_dataset"):
        run(tmp_path, "--steps", "1", dataset="webface",
            rec=str(tmp_path / "casia"))


def test_sigterm_saves_and_exits_cleanly(tmp_path):
    """The preemption contract of the JAX CLI: SIGTERM once training.log
    exists -> a checkpoint at the next step boundary, exit code 0."""
    cfg_path = tmp_path / "cfg.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(SMALL, out_folder=str(tmp_path / "out")), f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "msml_torch.cli.train", "--config",
         str(cfg_path), "--device", "cpu", "--steps", "500"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    log = tmp_path / "out" / "arc18_msml_1" / "training.log"
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None \
                and not log.exists():
            time.sleep(0.2)
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "preemption checkpoint saved at step" in out
    steps = checkpoint.all_steps(str(tmp_path / "out" / "arc18_msml_1"))
    assert len(steps) == 1 and 1 <= steps[0] < 500
    with open(tmp_path / "out" / "arc18_msml_1" / "config.yaml") as f:
        assert f.read() == open(cfg_path).read()
