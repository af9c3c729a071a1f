"""Rules the port keeps, checked on the CPU: what it imports, where it runs
by default, and the weight-folder / CLI path end to end."""

import ast
import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    p for p in glob.glob(os.path.join(REPO, "msml_torch", "**", "*.py"),
                         recursive=True)
    if "_build" not in p.split(os.sep)) + [os.path.join(REPO, "chip_smoke.py")]
# absent on the card's machine, or kept out of import time
LAZY = ("triton", "yaml", "cv2", "PIL")
# the RecordIO dataset's modules import Pillow with themselves: only the
# CLI's RecordIO branch imports them
TOP_LEVEL_OK = {os.path.join("msml_torch", "data", "rand_occ.py"): ("PIL",),
                os.path.join("msml_torch", "data", "face_dataset.py"):
                    ("PIL",)}


def _imports(tree):
    """-> [(module name, imported at import time?)]."""
    found = []

    def visit(node, top):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                found.extend((a.name, top) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                found.append((child.module or "", top))
            inner = top and not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            visit(child, inner)

    visit(tree, True)
    return found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    with open(path) as f:
        imports = _imports(ast.parse(f.read(), path))
    for name, top in imports:
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "msml_tpu",
                            "sklearn"), (path, name)
        allowed = TOP_LEVEL_OK.get(os.path.relpath(path, REPO), ())
        assert not (top and root in LAZY and root not in allowed), (
            path, name)


@pytest.fixture
def arc18_cfg():
    from msml_torch.core.config import config_init, load_yaml
    return config_init(load_yaml(os.path.join(REPO, "configs",
                                              "arc18_msml.yaml")),
                       make_output_dir=False)


def test_entry_points_default_to_cuda(arc18_cfg, tmp_path):
    """Without device='cpu' every entry point asks for CUDA, and on a box
    without it that raises; nothing falls back to the CPU."""
    from msml_torch import resolve_device
    from msml_torch.cli import test as cli_test
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.eval.occ_sweep_device import occlusion_sweep_device
    from msml_torch.nn.msml import msml_from_config

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device works")
    data = [np.zeros((2, 112, 112, 3), np.float32)] * 2
    calls = [
        lambda: resolve_device(),
        lambda: msml_from_config(arc18_cfg),
        lambda: occlusion_sweep_device(data, [True], lambda x: x),
        lambda: load_weight_folder(str(tmp_path)),
        lambda: cli_test.main(cli_test.parse_args(
            ["--device-sweep", "--weight_folder", str(tmp_path)])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cli_refuses_what_is_not_ported():
    from msml_torch.cli import test as cli_test

    for argv in (["--network", "iresnet18_v"], ["--vis"],
                 ["--device-sweep", "--vis"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            cli_test.main(cli_test.parse_args(argv + ["--device", "cpu"]))


def test_weight_folder_and_cli_sweep(tmp_path, monkeypatch):
    """A folder written by the JAX package's exporter (config.yaml +
    backbone.pth with a classification head) loads strict into the port and
    gives the features of the converted JAX weights; `cli.test
    --device-sweep --no-occ --device cpu` runs on it."""
    from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
    from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_tpu.tools.export_torch import export_msml_state_dict
    from msml_torch.cli import test as cli_test
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.nn.iresnet import IRESNET_LAYERS
    from tests.test_torch_nn import arc18_configs, random_variables
    from tests.test_torch_sweep import write_bin

    monkeypatch.setitem(JAX_LAYERS, "iresnet18", (1, 1, 1, 1))
    monkeypatch.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
    jcfg, _ = arc18_configs()
    x = np.random.RandomState(1).randn(2, 112, 112, 3).astype(np.float32)
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    v = random_variables(jmodel, x, train=False)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False)[0])(v, x))

    sd = export_msml_state_dict(v["params"], v["batch_stats"])
    sd["classification.weight"] = np.zeros((10572, 512), np.float32)
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
               str(tmp_path / "backbone.pth"))
    with open(os.path.join(REPO, "configs", "arc18_msml.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["fp16"] = False
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump(raw, f)

    _, model = load_weight_folder(str(tmp_path), device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))[0]
    got = got.numpy()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() > 0.9999, cos

    bin_path = write_bin(str(tmp_path / "t.bin"), pairs=20)
    rows = cli_test.main(cli_test.parse_args(
        ["--device-sweep", "--no-occ", "--device", "cpu", "--weight_folder",
         str(tmp_path), "--bin", bin_path]))
    assert len(rows) == 1 and np.isfinite(rows[0]["avg_acc"])
