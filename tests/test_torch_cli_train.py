"""The port's training CLI (`python -m msml_torch.cli.train`) on the CPU.

arc18_msml's structure at full width and depth (iResNet-18 FRB, U-Net OSB,
four FMCnn [3, 2, sigmoid, mul], AMArcFace s = 64, m = 0.48, device_light)
in float32 with 16 classes, batch 2, synthetic data, `--device cpu`: the
routed convs and the PReLU sites run their plain versions. The run
writes config.yaml, logs, checkpoints, resumes, verifies and stops cleanly
on SIGTERM; what it refuses, it refuses loudly. On a tiny RecordIO rec
(the JAX package's `write_dataset`, 4 ids x 4 views, seed 0, with its
procedural occluders) the step receives JAX's first batch byte for byte,
and worker processes change no loss.
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
    """The refusal this test guarded is lifted: the LightCNN FRB with
    `use_ori: true` builds its frozen teacher (PeerLightCNN: eval mode,
    no gradient, out of the optimizer) and the CLI takes steps on gray
    128 x 128 batches with `ori`; the teacher comes out of them bit-equal
    to the seeded one the same config builds."""
    from msml_torch.nn.lightcnn import PeerLightCNN

    peer = {"use_ori": True, "use_conv": True, "mask_trans": "conv",
            "use_decoder": False}
    state, _, log = run(tmp_path, "--steps", "2", "--log-every", "1",
                        frb_type="lightcnn", peer_params=peer)
    teacher = state.model.frb.peer
    assert isinstance(teacher, PeerLightCNN) and not teacher.training
    assert state.step == 2
    held = {id(p) for g in state.optimizer.param_groups
            for p in g["params"]}
    for p in teacher.parameters():
        assert not p.requires_grad and p.grad is None and id(p) not in held
    fresh = msml_from_config(config_init(config(tmp_path / "x", frb_type=
                                                "lightcnn",
                                                peer_params=peer),
                                         make_output_dir=False),
                             device="cpu", seed=0, head=True)
    for k, v in fresh.frb.peer.state_dict().items():
        assert torch.equal(teacher.state_dict()[k], v), k
    losses = speed_losses(log)  # logged from the second step on
    assert len(losses) == 1 and np.isfinite(float(losses[0]))


def test_default_config_is_refused(tmp_path, monkeypatch):
    """No --config: the reference defaults, the peer-KD recipe
    (use_ori, use_conv, use_decoder at B = 256), were refused until the
    teacher was ported. Now the CLI writes their config.yaml and builds
    the model with its teacher, towers and decoder and the step without
    refusing; the step itself is stopped before it runs (B = 256 at full
    width does not belong in a CPU test: tests/test_torch_peer_cli.py
    trains the recipe)."""
    from msml_torch.train import train_step

    class Built(Exception):
        pass

    real = train_step.make_train_step

    def stop(cfg):
        real(cfg)
        raise Built(cfg)

    monkeypatch.setattr(train_step, "make_train_step", stop)
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--config",
                           str(tmp_path / "missing.yaml"), "--steps", "1"])
    with pytest.raises(Built) as built:
        cli.main(args)
    cfg = built.value.args[0]
    assert dict(cfg.peer_params) == {"use_ori": True, "use_conv": True,
                                     "mask_trans": "conv",
                                     "use_decoder": True}
    assert not cfg.get("device_light") and cfg.batch_size == 256
    assert os.path.exists(tmp_path / "out" / "arc18_msml_1" / "config.yaml")


def test_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args, config(tmp_path))


@pytest.mark.parametrize("argv,over", [
    (["--strategy", "fsdp"], {}), (["--scan-steps", "2"], {}),
    (["--multihost"], {}),
    ([], {"sample_rate": 0.5})], ids=["strategy", "scan_steps", "multihost",
                                      "partial_fc"])
def test_not_ported_options_are_refused(tmp_path, argv, over):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run(tmp_path, "--steps", "1", *argv, **over)


@pytest.fixture(scope="module")
def tiny_rec(tmp_path_factory):
    """A 16-image rec (4 ids x 4 views, 8 train images) and occluders,
    written by the JAX package's tools."""
    from msml_tpu.tools.make_occluders import main as make_occluders
    from msml_tpu.tools.make_synthetic_rec import write_dataset

    base = tmp_path_factory.mktemp("rec")
    write_dataset(str(base / "rec"), ids=4, per_id=4, val_pairs=0,
                  seed=0, log_every=0)
    make_occluders(str(base / "occ"), num=2, seed=0)
    return str(base / "rec"), str(base / "occ")


def rec_config(tiny_rec, nw=0):
    rec, occ = tiny_rec
    return dict(dataset="custom", rec=rec, occluder_root=occ, nw=nw,
                num_classes=16)


def speed_losses(log):
    return re.findall(r"Speed \S+ samples/sec .* Loss (\S+) Epoch", log)


def test_rec_first_batch_equals_jax(tmp_path, tiny_rec, monkeypatch):
    """What the step receives first is JAX's `build_dataset(cfg, args, 1)`
    first batch, byte for byte (uint8 images, device_light)."""
    from msml_tpu.cli import train as jax_cli
    from msml_tpu.core.config import Config as JaxConfig
    from msml_tpu.core.config import config_init as jax_config_init
    from msml_torch.train import train_step

    seen = []
    real = train_step.make_train_step

    def spy(cfg):
        step = real(cfg)

        def wrapped(state, batch, lr_factor):
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
            return step(state, batch, lr_factor)
        return wrapped

    monkeypatch.setattr(train_step, "make_train_step", spy)
    over = rec_config(tiny_rec)
    state, _, log = run(tmp_path / "port", "--steps", "1", **over)
    assert state.step == 1 and len(seen) == 1
    assert "data: FaceByRandOccMask, 8 samples" in log

    jcfg = jax_config_init(JaxConfig.from_dict(dict(
        SMALL, out_folder=str(tmp_path / "jax"), **over)))
    jargs = jax_cli.parse_args(["--seed", "0", "--steps", "1"])
    jset = jax_cli.build_dataset(jcfg, jargs, 1)
    want = next(jset.epoch(0))
    assert sorted(seen[0]) == sorted(want) == ["img", "label", "msk"]
    for k in want:
        assert seen[0][k].dtype == want[k].dtype, k
        assert seen[0][k].tobytes() == want[k].tobytes(), k
    assert want["img"].dtype == np.uint8 and want["img"].shape == (
        2, 112, 112, 3)


def test_rec_worker_processes_log_identical_losses(tmp_path, tiny_rec):
    """nw 0 (a thread pool) and nw 2 (two spawned processes) train on the
    same batches: the logged losses are identical."""
    logs = {}
    for nw in (0, 2):
        state, _, logs[nw] = run(tmp_path / str(nw), "--steps", "2",
                                 "--log-every", "1",
                                 **rec_config(tiny_rec, nw))
        assert state.step == 2
    assert "no worker processes" in logs[0]
    assert "2 worker processes" in logs[2]
    assert len(speed_losses(logs[0])) == 1
    assert speed_losses(logs[2]) == speed_losses(logs[0])
    assert all(np.isfinite(float(v)) for v in speed_losses(logs[0]))


def test_rec_pool_starts_on_the_main_thread(tmp_path, tiny_rec,
                                            monkeypatch):
    """The CLI starts the spawn pool itself, before `device_prefetch`'s
    thread runs the epoch generator: hiding `__main__` while the workers
    start then changes the process's state on its main thread only."""
    import threading

    from msml_torch.data.face_dataset import FaceByRandOccMask

    calls = []
    real = FaceByRandOccMask._get_pool

    def spy(self):
        calls.append((threading.current_thread() is threading.main_thread(),
                      getattr(self, "_pool", None) is None))
        return real(self)

    monkeypatch.setattr(FaceByRandOccMask, "_get_pool", spy)
    state, _, log = run(tmp_path, "--steps", "1", **rec_config(tiny_rec, 1))
    assert state.step == 1
    assert calls[0] == (True, True)  # created on the main thread
    assert all(not created for _, created in calls[1:])
    assert re.search(r"1 worker processes \(started in \S+ s\)", log)


def test_rec_occ_off(tmp_path, tiny_rec):
    state, _, log = run(tmp_path, "--steps", "2", "--log-every", "1",
                        "--occ", "0", **rec_config(tiny_rec))
    assert state.step == 2 and len(speed_losses(log)) == 1
    assert "training finished at step 2" in log


def test_tensorboard_writes_events(tmp_path, tiny_rec):
    """--tensorboard writes the JAX CLI's tags to <output>/tb."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    state, folder, _ = run(tmp_path, "--steps", "2", "--log-every", "1",
                           "--tensorboard", **rec_config(tiny_rec))
    assert state.step == 2
    events = [n for n in os.listdir(os.path.join(folder, "tb"))
              if n.startswith("events.out.tfevents")]
    assert len(events) == 1
    acc = EventAccumulator(os.path.join(folder, "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == [
        "img_per_sec_per_chip", "loss", "samples_per_sec", "time_for_end"]
    assert [e.step for e in acc.Scalars("loss")] == [2]


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
