"""The training CLI without Pillow or OpenCV, in a fresh interpreter with
`PIL` and `cv2` blocked in `sys.modules`: `msml_torch.cli.train` imports
and trains one synthetic step (arc18_msml, float32, B = 2, 16 classes,
seed 0, on the CPU); a RecordIO `build_dataset` raises an ImportError that
names the missing package, and never falls back."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, sys
sys.modules["PIL"] = None
sys.modules["cv2"] = None
import chip_smoke
from msml_torch.cli import train as cli
from msml_torch.core.config import Config, config_init

out = sys.argv[1]
cfg = Config.from_dict(dict(chip_smoke.ARC18_MSML, dataset="synthetic",
                            batch_size=2, num_classes=16, fp16=False,
                            out_folder=out))
state = cli.main(cli.parse_args(["--device", "cpu", "--steps", "1"]), cfg)
assert state.step == 1

rec = config_init(Config.from_dict(dict(
    chip_smoke.ARC18_MSML, dataset="custom", rec=out, num_classes=16,
    out_folder=out)), make_output_dir=False)
args = cli.parse_args(["--device", "cpu"])
for name in ("Pillow", "OpenCV"):  # both blocked, then only cv2
    try:
        cli.build_dataset(rec, args)
    except ImportError as e:
        assert name in str(e), str(e)
        print("refused:", e)
    else:
        raise AssertionError("built a RecordIO dataset without " + name)
    del sys.modules["PIL"]
"""


def test_cli_without_pillow_and_opencv(tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    refused = [line for line in out.stdout.splitlines()
               if line.startswith("refused:")]
    assert len(refused) == 2
    assert "needs Pillow" in refused[0] and "needs OpenCV" in refused[1]
    assert os.path.exists(tmp_path / "arc18_msml_1" / "ckpt" / "1.pt")
