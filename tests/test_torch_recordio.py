"""The port's RecordIO reader and writer (`msml_torch/data/recordio.py`)
against the JAX package's (`msml_tpu/data/recordio.py`) on the CPU.

Files written by one package are read by the other: keys, headers and
payloads equal. Images are random uint8 arrays drawn from
`RandomState(seed)`; the JPEG codec is compared byte for byte.
"""

import os
import pickle
import struct

import numpy as np
import pytest

from msml_tpu.data import recordio as jrec
from msml_torch.data import recordio as trec


def _records(seed=0, n=6):
    """(key, header args, image bytes): a vector-label header record, then
    scalar-label records with random payloads of uneven lengths."""
    rng = np.random.RandomState(seed)
    out = [(0, (2, [n, 3], 1, 0), b"")]
    for k in range(1, n):
        payload = rng.randint(0, 256, rng.randint(1, 40)).astype(
            np.uint8).tobytes()
        out.append((k, (0, float(k % 3), k, 7), payload))
    return out


def _write(mod, root, records):
    w = mod.IndexedRecordIO(os.path.join(root, "train.idx"),
                            os.path.join(root, "train.rec"), "w")
    for key, hdr, data in records:
        w.write_idx(key, mod.pack(mod.IRHeader(*hdr), data))
    w.close()


def _read_all(mod, root):
    r = mod.IndexedRecordIO(os.path.join(root, "train.idx"),
                            os.path.join(root, "train.rec"))
    out = []
    for key in r.keys:
        h, data = mod.unpack(r.read_idx(key))
        label = (h.label.tolist() if isinstance(h.label, np.ndarray)
                 else h.label)
        out.append((key, h.flag, label, h.id, h.id2, data))
    r.close()
    return out


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_writes", "port_writes"])
def test_cross_read(tmp_path, writer, reader):
    recs = _records()
    _write(writer, str(tmp_path), recs)
    got = _read_all(reader, str(tmp_path))
    want = _read_all(writer, str(tmp_path))
    assert got == want
    assert [g[0] for g in got] == [k for k, _, _ in recs]
    assert [g[-1] for g in got] == [d for _, _, d in recs]
    assert got[0][1:3] == (2, [6.0, 3.0])


def test_files_byte_equal(tmp_path):
    for mod, sub in ((jrec, "jax"), (trec, "port")):
        os.makedirs(tmp_path / sub)
        _write(mod, str(tmp_path / sub), _records(seed=3))
    for name in ("train.rec", "train.idx"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(5.0)],
                         ids=["scalar", "list", "array"])
def test_pack_unpack_round_trip(label):
    hdr_args = (0, label, 11, 12)
    packed = trec.pack(trec.IRHeader(*hdr_args), b"abc")
    assert packed == jrec.pack(jrec.IRHeader(*hdr_args), b"abc")
    h, data = trec.unpack(packed)
    assert data == b"abc" and (h.id, h.id2) == (11, 12)
    if np.isscalar(label):
        assert h.flag == 0 and h.label == label
    else:
        assert h.flag == len(label)
        np.testing.assert_array_equal(h.label,
                                      np.asarray(label, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("quality", [80, 95])
def test_imencode_imdecode_byte_equal(seed, quality):
    img = np.random.RandomState(seed).randint(0, 256, (17, 23, 3)).astype(
        np.uint8)
    buf = trec.imencode(img, quality)
    assert buf == jrec.imencode(img, quality)
    got = trec.imdecode(buf)
    np.testing.assert_array_equal(got, jrec.imdecode(buf))
    np.testing.assert_array_equal(trec.imdecode(buf, to_rgb=False),
                                  got[:, :, ::-1])
    with pytest.raises(ValueError, match="decode failed"):
        trec.imdecode(b"not an image")


def test_bad_magic_raises(tmp_path):
    _write(trec, str(tmp_path), _records())
    path = tmp_path / "train.rec"
    raw = bytearray(path.read_bytes())
    r = trec.IndexedRecordIO(str(tmp_path / "train.idx"), str(path))
    raw[r.idx[2]:r.idx[2] + 4] = struct.pack("<I", 0xDEADBEEF)
    path.write_bytes(bytes(raw))
    assert trec.unpack(r.read_idx(1))[0].id == 1
    with pytest.raises(IOError, match="bad record magic at key 2"):
        r.read_idx(2)


def test_reader_pickles(tmp_path):
    """A reader crosses to worker processes by pickle: the handles stay
    behind and reopen on first read."""
    _write(trec, str(tmp_path), _records())
    r = trec.IndexedRecordIO(str(tmp_path / "train.idx"),
                             str(tmp_path / "train.rec"))
    first = r.read_idx(3)
    assert r._local is not None
    clone = pickle.loads(pickle.dumps(r))
    assert clone._local is None and len(clone) == len(r) == 6
    assert clone.read_idx(3) == first
    assert clone.read_idx(5) == r.read_idx(5)
