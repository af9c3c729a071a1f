"""The port's data tools (`msml_torch/tools/make_synthetic_rec.py`,
`msml_torch/tools/make_occluders.py`) against the JAX package's on the CPU:
the same arguments and seeds write byte-identical files."""

import os
import subprocess
import sys

import pytest

from msml_tpu.tools import make_occluders as jocc
from msml_tpu.tools import make_synthetic_rec as jrec
from msml_torch.data.recordio import IndexedRecordIO, unpack
from msml_torch.tools import make_occluders as tocc
from msml_torch.tools import make_synthetic_rec as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=5, view_noise=20.0, id_alpha=0.5, geo_jitter=0.5,
         quality=95, val_holdout=2)], ids=["defaults", "harder"])
def test_write_dataset_byte_identical(tmp_path, kw):
    args = dict(ids=3, per_id=4, size=112, val_pairs=4, log_every=0, **kw)
    want = jrec.write_dataset(str(tmp_path / "jax"), **args)
    got = trec.write_dataset(str(tmp_path / "port"), **args)
    assert {k: v for k, v in got.items() if k not in ("root", "bin")} == \
        {k: v for k, v in want.items() if k not in ("root", "bin")}
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(tf) == sorted(jf) == ["synth_val.bin", "train.idx",
                                        "train.rec"]
    for name in jf:
        assert tf[name] == jf[name], name
    r = IndexedRecordIO(str(tmp_path / "port" / "train.idx"),
                        str(tmp_path / "port" / "train.rec"))
    header, _ = unpack(r.read_idx(0))
    assert list(header.label) == [3 * 2 + 1, 3] and len(r) == 7


@pytest.mark.parametrize("seed", [0, 3])
def test_make_occluders_byte_identical(tmp_path, seed):
    jocc.main(str(tmp_path / "jax"), num=2, seed=seed)
    tocc.main(str(tmp_path / "port"), num=2, seed=seed)
    jf, tf = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(jf) == 5 * 2
    assert sorted(tf) == sorted(jf)
    for name in jf:
        assert tf[name] == jf[name], name


def test_make_synthetic_rec_module_entry(tmp_path):
    """`python -m msml_torch.tools.make_synthetic_rec` writes the files
    that write_dataset does, and imports nothing of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.argv = sys.argv[1:]; "
         "runpy.run_module('msml_torch.tools.make_synthetic_rec', "
         "run_name='__main__'); "
         "bad = [m for m in sys.modules if m == 'jax' or "
         "m.startswith(('jax.', 'msml_tpu'))]; assert not bad, bad",
         "make_synthetic_rec", "--root", str(tmp_path / "cli"), "--ids",
         "3", "--per-id", "4", "--val-pairs", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    trec.write_dataset(str(tmp_path / "direct"), ids=3, per_id=4,
                       val_pairs=4)
    assert _files(tmp_path / "cli") == _files(tmp_path / "direct")
