"""The port's training dataset (`msml_torch/data/face_dataset.py`) against
the JAX package's (`msml_tpu/data/face_dataset.py`) on the CPU.

A 12-image rec of 3 identities (smooth random 112 x 112 faces drawn from
`RandomState(0)`, JPEG), with `mask_out.rec` / `mask.rec` for every key (a
lower-face mask, as `tests/test_face_dataset.py` builds them) and
procedural occluders (JAX's `make_occluders`, seed 0). Both packages read
it at B = 4 with seed 3; every batch must be equal: uint8 batches byte for
byte, float batches exactly.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from msml_tpu.data import face_dataset as jfd
from msml_tpu.data.recordio import IRHeader, IndexedRecordIO, imencode, pack
from msml_tpu.tools.make_occluders import main as make_occluders
from msml_torch.data import face_dataset as tfd

N, N_CLS, B, SEED = 12, 3, 4, 3


def _write_rec(root: str, masks: bool = True):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    rec = IndexedRecordIO(os.path.join(root, "train.idx"),
                          os.path.join(root, "train.rec"), "w")
    rec.write_idx(0, pack(IRHeader(2, [N + 1, N_CLS], 1, 0), b""))
    if masks:
        mo = IndexedRecordIO(os.path.join(root, "mask_out.idx"),
                             os.path.join(root, "mask_out.rec"), "w")
        mk = IndexedRecordIO(os.path.join(root, "mask.idx"),
                             os.path.join(root, "mask.rec"), "w")
    for i in range(1, N + 1):
        small = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(small).resize((112, 112)))
        rec.write_idx(i, pack(IRHeader(0, float(i % N_CLS), 0, 0),
                              imencode(img)))
        if masks:
            masked = img.copy()
            masked[60:, :] = 30
            mo.write_idx(i, pack(IRHeader(0, float(i % N_CLS), 0, 0),
                                 imencode(masked)))
            m = np.full((112, 112, 3), 255, np.uint8)
            m[60:, :] = 0
            mk.write_idx(i, pack(IRHeader(0, 0.0, 0, 0), imencode(m)))
    rec.close()
    if masks:
        mo.close(), mk.close()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("face_data")
    occl = str(base / "occluders")
    make_occluders(occl, num=2, seed=0)
    _write_rec(str(base / "casia"))
    _write_rec(str(base / "ms1m_rec"))
    _write_rec(str(base / "nomask"), masks=False)
    return {"base": base, "occluders": occl,
            "casia": str(base / "casia"), "ms1m": str(base / "ms1m_rec"),
            "nomask": str(base / "nomask")}


def _both(root, occluders, **kw):
    kw = dict(dict(batch_size=B, seed=SEED, use_norm=True, use_ori=False,
                   raw_uint8=True, num_workers=4), **kw)
    return (jfd.FaceByRandOccMask(root, occluder_root=occluders, **kw),
            tfd.FaceByRandOccMask(root, occluder_root=occluders, **kw))


def _assert_equal(want_batches, got_batches):
    assert len(got_batches) == len(want_batches) > 0
    for want, got in zip(want_batches, got_batches):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def _check_contract(batches, raw_uint8):
    for b in batches:
        assert b["img"].dtype == (np.uint8 if raw_uint8 else np.float32)
        assert b["img"].shape[:3] == (B, 112, 112)
        assert b["msk"].dtype == np.int32 and b["msk"].shape == (B, 112, 112)
        assert set(np.unique(b["msk"])) <= {0, 1}
        assert b["label"].dtype == np.int32
        assert ((0 <= b["label"]) & (b["label"] < N_CLS)).all()
    assert any((b["msk"] == 0).any() for b in batches)


CASES = {
    "uint8_epoch0": dict(epoch=0),
    "uint8_epoch1": dict(epoch=1),
    "float_epoch0": dict(epoch=0, raw_uint8=False),
    "float_epoch1": dict(epoch=1, raw_uint8=False),
    "shard0of2": dict(epoch=0, shard_id=0, num_shards=2),
    "shard1of2": dict(epoch=1, shard_id=1, num_shards=2),
    "occ_off": dict(epoch=0, occ=False),
    "occ_off_float": dict(epoch=1, occ=False, raw_uint8=False),
    "use_ori": dict(epoch=0, use_ori=True),
    "use_ori_float": dict(epoch=0, use_ori=True, raw_uint8=False),
    "gray_float": dict(epoch=0, is_gray=True, raw_uint8=False),
    "no_gauss_light": dict(epoch=0, raw_uint8=False, gauss_light=False),
    "ms1m": dict(epoch=0, root="ms1m"),
    "ms1m_float": dict(epoch=1, root="ms1m", raw_uint8=False),
    "no_mask_recs": dict(epoch=0, root="nomask"),
    "no_mask_recs_float": dict(epoch=0, root="nomask", raw_uint8=False),
    "missing_occluders": dict(epoch=0, occluders="absent"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_equal_jax(data, case):
    kw = dict(CASES[case])
    epoch = kw.pop("epoch")
    root = data[kw.pop("root", "casia")]
    occl = (str(data["base"] / "absent") if kw.pop("occluders", None)
            else data["occluders"])
    jds, tds = _both(root, occl, **kw)
    assert len(tds) == len(jds) == N
    if "occluders" in CASES[case]:
        assert len(tds.trans_occ) == len(jds.trans_occ) == 3
    else:
        assert len(tds.trans_occ) == len(jds.trans_occ) == 6
    assert (tds.mask_out_rec is None) == (jds.mask_out_rec is None) == (
        CASES[case].get("root") == "nomask")
    assert tds.is_ms1m == jds.is_ms1m == (CASES[case].get("root") == "ms1m")
    np.testing.assert_array_equal(tds._epoch_order(epoch),
                                  jds._epoch_order(epoch))
    want = list(jds.epoch(epoch))
    got = list(tds.epoch(epoch))
    _assert_equal(want, got)
    raw = kw.get("raw_uint8", True)
    shards = kw.get("num_shards", 1)
    assert len(got) == N // shards // B
    if kw.get("occ", True):
        _check_contract(got, raw)
    if kw.get("use_ori"):
        assert all(b["ori"].shape == b["img"].shape for b in got)


def test_shards_are_disjoint_and_padded(data):
    """Two shards of one epoch cover the order once; an order that does
    not divide wraps around as DistributedSampler pads it."""
    orders = []
    for shard in (0, 1):
        _, tds = _both(data["casia"], data["occluders"], shard_id=shard,
                       num_shards=2)
        orders.append(tds._epoch_order(2))
    assert sorted(np.concatenate(orders)) == list(range(N))
    _, tds = _both(data["casia"], data["occluders"], shard_id=4,
                   num_shards=5)
    jds, _ = _both(data["casia"], data["occluders"], shard_id=4,
                   num_shards=5)
    np.testing.assert_array_equal(tds._epoch_order(0), jds._epoch_order(0))
    assert len(tds._epoch_order(0)) == 3


def test_per_sample_seed_matches(data):
    """_fetch's RandomState((seed * 1000003 + epoch * 10007 + i) mod
    2**31 - 1): one sample, both packages, both modes."""
    for raw in (True, False):
        jds, tds = _both(data["casia"], data["occluders"], raw_uint8=raw)
        for args in ((0, 5), (7, 11)):
            want, got = jds._fetch(args), tds._fetch(args)
            for w, g in zip(want, got):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_process_pool_equals_threads(data):
    """The spawn pool of 2 workers gives the batches of the thread path
    and of the JAX package; the pool lives across epochs until close()."""
    jds, tds = _both(data["casia"], data["occluders"], num_workers=2)
    try:
        for epoch in (0, 1):
            want = list(jds.epoch(epoch))
            _assert_equal(want, list(tds.epoch(epoch, use_processes=True)))
            _assert_equal(want, list(tds.epoch(epoch)))
        pool = tds._pool
        assert pool is not None
        gen = tds.epoch(2, use_processes=True)
        next(gen)
        gen.close()  # abandoned mid-epoch, as on an early break
        assert tds._pool is pool
        _assert_equal(list(jds.epoch(2)),
                      list(tds.epoch(2, use_processes=True)))
    finally:
        tds.close()
    assert tds._pool is None
    tds.close()


def test_pool_workers_do_not_run_main(data, tmp_path):
    """A main script that imports torch at its top: the spawn workers do
    not run it again, so they hold no torch, and the main module is
    whole again once the pool has started."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "main.py"
    script.write_text(
        "import sys\n"
        "import torch\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from msml_torch.data.face_dataset import FaceByRandOccMask\n"
        "if __name__ == '__main__':\n"
        f"    ds = FaceByRandOccMask({data['casia']!r}, batch_size=4,\n"
        f"        occluder_root={data['occluders']!r}, num_workers=2)\n"
        "    pool = ds._get_pool()\n"
        "    assert sys.modules['__main__'].__file__ == __file__\n"
        "    assert sys.modules['__main__'].__spec__ is None\n"
        "    probe = \"'torch' in __import__('sys').modules\"\n"
        "    print('torch in workers:', sorted(set(pool.map(\n"
        "        eval, [probe] * 8, chunksize=1))))\n"
        "    print('batch:', next(ds.epoch(0, True))['img'].shape)\n"
        "    ds.close()\n")
    out = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "torch in workers: [False]" in out.stdout
    assert "batch: (4, 112, 112, 3)" in out.stdout


def test_dataset_pickles_without_pool(data):
    import pickle

    _, tds = _both(data["casia"], data["occluders"], num_workers=2)
    try:
        next(tds.epoch(0, use_processes=True))
        clone = pickle.loads(pickle.dumps(tds))
        assert clone._pool is None
        for w, g in zip(tds._fetch((0, 1)), clone._fetch((0, 1))):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    finally:
        tds.close()


@pytest.mark.parametrize("raw_uint8", [True, False], ids=["uint8", "float"])
def test_mx_face_dataset_python_path(data, raw_uint8):
    kw = dict(batch_size=B, seed=SEED, use_ori=True, raw_uint8=raw_uint8)
    jds = jfd.MXFaceDataset(data["casia"], native_decode=False, **kw)
    tds = tfd.MXFaceDataset(data["casia"], **kw)
    assert tds.use_occ is False and tds.use_norm is True
    want = list(jds.epoch(1))
    got = list(tds.epoch(1))
    _assert_equal(want, got)
    assert all((b["msk"] == 1).all() for b in got)
    with pytest.raises(NotImplementedError, match="msml_loader.cpp"):
        tfd.MXFaceDataset(data["casia"], native_decode=True, **kw)


def test_pil_gray_u8_and_gauss_map():
    rgb = np.random.RandomState(0).randint(0, 256, (3, 9, 7, 3)).astype(
        np.uint8)
    got = tfd.pil_gray_u8(rgb)
    np.testing.assert_array_equal(got, jfd.pil_gray_u8(rgb))
    np.testing.assert_array_equal(
        got[0], np.asarray(Image.fromarray(rgb[0]).convert("L")))
    for args, kw in (((0, 0, 112, 112), dict(radius=128)),
                     ((40, 1, 100, 111), {}),
                     ((3, 5, 20, 17), dict(center_x=(4, 9), center_y=(6, 8))),
                     ((0, 0, 16, 12), dict(metric="Manhattan"))):
        want = jfd.gauss_map(*args, np.random.RandomState(1), **kw)
        got = tfd.gauss_map(*args, np.random.RandomState(1), **kw)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="Distance Metric"):
        tfd.gauss_map(0, 0, 4, 4, np.random.RandomState(0), metric="x")


def test_default_occluder_root(monkeypatch, tmp_path):
    monkeypatch.delenv("MSML_OCCLUDER_DIR", raising=False)
    root = tfd.default_occluder_root()
    assert root == os.path.join(os.path.dirname(tfd.__file__),
                                "occluder_assets")
    assert "msml_tpu" not in root
    monkeypatch.setenv("MSML_OCCLUDER_DIR", str(tmp_path))
    assert tfd.default_occluder_root() == str(tmp_path)


def test_env_occluder_root_is_read(data, monkeypatch, tmp_path):
    """Without occluder_root, the dataset reads MSML_OCCLUDER_DIR."""
    shutil.copytree(data["occluders"], tmp_path / "occ")
    monkeypatch.setenv("MSML_OCCLUDER_DIR", str(tmp_path / "occ"))
    tds = tfd.FaceByRandOccMask(data["casia"], batch_size=B)
    assert len(tds.trans_occ) == 6
