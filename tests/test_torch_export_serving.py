"""`msml_torch.tools.export_serving`: the eval forward through
`torch.export`, with the conv3x3 and PReLU kernels as custom ops.

arc18_msml at full width (the conv3x3 route needs 64 channels) and one
block per iResNet stage, random weights from a seed, on the CPU, where the
custom ops run their plain versions. The loaded program must equal the
eager forward it was exported from (`ATOL`: the same ops; 0 apart here),
in float32 with a symbolic batch and in the bf16 policy, whose autocast
the exporter folds into casts. The sidecar carries the JAX exporter's keys
(`msml_tpu/tools/export_serving.py`).
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6  # the program runs the eager forward's ops, on raw features
OPS = ("msml_torch.conv3x3_fwd.default", "msml_torch.prelu_fwd.default")


def write_weight_folder(folder, fp16: bool):
    """config.yaml (configs/arc18_msml.yaml, `fp16` set) + backbone.pth of
    the port's seeded model. -> the model, in eval mode."""
    from msml_torch.core.config import config_init, load_yaml
    from msml_torch.nn.msml import msml_from_config

    with open(os.path.join(REPO, "configs", "arc18_msml.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["fp16"] = fp16
    os.makedirs(folder)
    with open(os.path.join(folder, "config.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    cfg = config_init(load_yaml(os.path.join(folder, "config.yaml")),
                      make_output_dir=False)
    model = msml_from_config(cfg, device="cpu", seed=3)
    torch.save(model.state_dict(), os.path.join(folder, "backbone.pth"))
    return model


def export(folder, out, *extra):
    from msml_torch.tools import export_serving

    program = export_serving.main(export_serving.parse_args(
        ["--weight_folder", folder, "--out", out, "--device", "cpu",
         *extra]))
    with open(out + ".json") as f:
        return program, json.load(f)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    from msml_torch.nn.iresnet import IRESNET_LAYERS

    root = tmp_path_factory.mktemp("export")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        f32, bf16 = str(root / "f32"), str(root / "bf16")
        model = write_weight_folder(f32, fp16=False)
        model_bf16 = write_weight_folder(bf16, fp16=True)
        out = str(root / "model.pt2")
        program, meta = export(f32, out)
        fixed, fixed_meta = export(f32, str(root / "fixed.pt2"), "--batch",
                                   "2")
        program_bf16, _ = export(bf16, str(root / "bf16.pt2"))
        yield types.SimpleNamespace(
            folder=f32, out=out, model=model, program=program, meta=meta,
            fixed=fixed, fixed_meta=fixed_meta, model_bf16=model_bf16,
            program_bf16=program_bf16, loaded=torch.export.load(out))


def eager(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())[0]


def images(b, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (b, 112, 112, 3)) \
        .astype(np.float32)


def graph_nodes(program):
    """The call_function nodes of the program's graph and its submodules'
    (an autocast or other higher-order region is a submodule)."""
    return [node for module in program.graph_module.modules()
            if isinstance(module, torch.fx.GraphModule)
            for node in module.graph.nodes if node.op == "call_function"]


def test_program_calls_the_kernels_as_custom_ops(exported):
    """Every routed conv3x3 site and every PReLU is one custom-op node
    (found in any submodule of the graph), and no plain version of them
    was traced in their place."""
    from msml_torch.nn.common import PReLU, routed_conv_sites

    for program in (exported.program, exported.loaded):
        targets = [str(node.target) for node in graph_nodes(program)]
        assert not [t for t in targets if "einsum" in t]
        assert targets.count(OPS[0]) == len(
            routed_conv_sites(exported.model)) == 6
        assert targets.count(OPS[1]) == sum(
            isinstance(m, PReLU) for m in exported.model.modules())


@pytest.mark.parametrize("b", [1, 3, 5])
def test_loaded_program_equals_eager(exported, b):
    x = images(b, seed=b)
    with torch.inference_mode():
        got = exported.loaded.module()(torch.from_numpy(x))
    want = eager(exported.model, x)
    assert got.shape == (b, 512) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_bf16_policy_program_equals_eager(exported):
    """The folder's fp16: true runs the forward under bf16 autocast; the
    program holds the same casts (no autocast region is left in it)."""
    targets = [str(n.target) for n in graph_nodes(exported.program_bf16)]
    assert not [t for t in targets if "autocast" in t]
    assert OPS[0] in targets and OPS[1] in targets
    x = images(2, seed=7)
    with torch.inference_mode():
        got = exported.program_bf16.module()(torch.from_numpy(x))
    want = eager(exported.model_bf16, x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_fixed_batch_program_takes_only_its_batch(exported):
    x = images(2, seed=9)
    with torch.inference_mode():
        got = exported.fixed.module()(torch.from_numpy(x))
        torch.testing.assert_close(got, eager(exported.model, x), atol=ATOL,
                                   rtol=0)
        with pytest.raises(Exception):
            exported.fixed.module()(torch.from_numpy(images(3)))


@pytest.mark.parametrize("batch", [0, 2], ids=["symbolic", "fixed"])
def test_sidecar_equals_jax(exported, batch, tmp_path, monkeypatch):
    """The JAX exporter's `main` (its restore and StableHLO export stood in
    for) writes the same sidecar for the same folder config."""
    from msml_tpu.core import weight_folder as jax_wf
    from msml_tpu.tools import export_serving as jax_export
    from tests.test_torch_nn import arc18_configs

    jcfg, _ = arc18_configs()
    state = types.SimpleNamespace(params={}, batch_stats={})
    monkeypatch.setattr(jax_wf, "load_weight_folder",
                        lambda *a, **k: (jcfg, None, state, None, False))
    monkeypatch.setattr(jax_export, "export_eval_fn", lambda *a, **k: b"")
    out = str(tmp_path / "model.stablehlo")
    jax_export.main(jax_export.parse_args(
        ["--weight_folder", exported.folder, "--out", out, "--platform", "",
         "--batch", str(batch)]))
    with open(out + ".json") as f:
        want = json.load(f)
    got = exported.fixed_meta if batch else exported.meta
    assert got == want
    assert got["batch"] == (2 if batch else "symbolic")


@pytest.mark.parametrize("op", ["conv3x3_fwd", "prelu_fwd"])
def test_custom_op_registration(op):
    """torch.library.opcheck: schema, fake (shape) implementation and
    dispatch of each op, at f32 and bf16, on CPU tensors."""
    rs = np.random.RandomState(11)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rs.randn(2, 64, 5, 7).astype(np.float32))
        if op == "conv3x3_fwd":
            other = torch.from_numpy(rs.randn(64, 64, 3, 3).astype(
                np.float32) / 24).to(dtype)
        else:
            other = torch.from_numpy(rs.rand(64).astype(np.float32))
        torch.library.opcheck(getattr(torch.ops.msml_torch, op),
                              (x.to(dtype), other),
                              test_utils=("test_schema", "test_faketensor"))


def test_artifact_server_needs_no_model_code(exported):
    """`runner_from_artifact` in a fresh process: features equal the eager
    model's, and `msml_torch.nn` is never imported (the kernels are)."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from msml_torch.cli.serve import runner_from_artifact\n"
        f"r = runner_from_artifact({exported.out!r}, 'cpu', flip=False, "
        "l2_norm=False)\n"
        "x = np.random.RandomState(12).uniform(-1, 1, (1, 112, 112, 3))\n"
        "y = r.infer(x.astype(np.float32))\n"
        "print(json.dumps({'y': y.tolist(), 'modules': sorted("
        "m for m in sys.modules if m.startswith('msml_torch'))}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "msml_torch.kernels.conv3x3" in out["modules"]
    assert not [m for m in out["modules"] if m.startswith("msml_torch.nn")]
    x = np.random.RandomState(12).uniform(-1, 1, (1, 112, 112, 3))
    want = eager(exported.model, x.astype(np.float32))
    np.testing.assert_allclose(out["y"], want.numpy(), atol=ATOL, rtol=0)


def test_quant_is_refused():
    """Only int8 is a quantization mode, at the command line and in
    `export_eval_fn`."""
    from msml_torch.tools import export_serving

    with pytest.raises(SystemExit):
        export_serving.parse_args(["--weight_folder", "w", "--quant",
                                   "int4"])
    with pytest.raises(ValueError, match="unknown quant mode 'int4'"):
        export_serving.export_eval_fn(torch.nn.Linear(3, 2), (3,),
                                      quant="int4")
