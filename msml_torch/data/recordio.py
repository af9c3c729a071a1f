"""Pure-python MXNet IndexedRecordIO reader and writer (no mxnet).

The port's own copy of `msml_tpu/data/recordio.py`. The reference reads its
training data through `mxnet.recordio.MXIndexedRecordIO`
(`datasets/load_dataset.py:39-48,373`); this module reads and writes the
same on-disk format, so insightface's `train.rec` / `train.idx` (and the
offline `mask_out.rec` / `mask.rec`) are readable as they are:

  * .idx: text lines "<key>\\t<offset>"
  * .rec: records of [uint32 magic 0xced7230a][uint32 lrecord][payload][pad4]
      lrecord = cflag(upper 3 bits) | length(lower 29 bits)
  * payload: IRHeader (uint32 flag, float32 label, uint64 id, uint64 id2)
      + (flag > 0 ? flag * float32 extended label : nothing) + image bytes

Images decode through cv2 (libjpeg-turbo), as mx.image.imdecode's OpenCV
backend does, BGR -> RGB flip included. `cv2` is imported only inside
`imdecode` / `imencode`.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Tuple, Union

import numpy as np

_MAGIC = 0xCED7230A
_IR_FORMAT = "<IfQQ"          # flag, label, id, id2
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class IRHeader:
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id_, id2):
        self.flag = flag
        self.label = label
        self.id = id_
        self.id2 = id2


def unpack(payload: bytes) -> Tuple[IRHeader, bytes]:
    """mxnet.recordio.unpack parity: split IRHeader (+ extended label) from
    the image bytes."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, payload[:_IR_SIZE])
    rest = payload[_IR_SIZE:]
    lab: Union[float, np.ndarray] = label
    if flag > 0:
        lab = np.frombuffer(rest[:flag * 4], dtype=np.float32)
        rest = rest[flag * 4:]
    return IRHeader(flag, lab, id_, id2), rest


def pack(header: IRHeader, data: bytes) -> bytes:
    """mxnet.recordio.pack parity (used by the rec writer tools)."""
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)):
        label = np.asarray(label, np.float32)
        hdr = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
        return hdr + label.tobytes() + data
    hdr = struct.pack(_IR_FORMAT, 0, float(label), header.id, header.id2)
    return hdr + data


class IndexedRecordIO:
    """MXIndexedRecordIO parity, read and write."""

    def __init__(self, idx_path: str, rec_path: str, mode: str = "r"):
        self.idx_path, self.rec_path = idx_path, rec_path
        self.mode = mode
        if mode == "r":
            self._local = None
            self.idx = {}
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        self.idx[int(parts[0])] = int(parts[1])
            self.keys = sorted(self.idx)
        else:
            self._f = open(rec_path, "wb")
            self._idx_f = open(idx_path, "w")
            self.idx = {}
            self.keys = []

    def _handle(self):
        """A read handle per thread and per process: seek + read on one
        shared handle races across the loader's threads and its worker
        processes (reset by pid after a fork)."""
        if self._local is None or self._local["pid"] != os.getpid():
            self._local = {"pid": os.getpid(), "tl": threading.local()}
        tl = self._local["tl"]
        if not hasattr(tl, "f"):
            tl.f = open(self.rec_path, "rb")
        return tl.f

    # -- read --
    def read_idx(self, key: int) -> bytes:
        f = self._handle() if self.mode == "r" else self._f
        f.seek(self.idx[key])
        magic, lrec = struct.unpack("<II", f.read(8))
        if magic != _MAGIC:
            raise IOError(f"bad record magic at key {key}: {magic:#x}")
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        if cflag != 0:
            raise NotImplementedError("multi-part records not supported")
        return f.read(length)

    # -- write --
    def write_idx(self, key: int, payload: bytes) -> None:
        pos = self._f.tell()
        lrec = len(payload) & ((1 << 29) - 1)
        self._f.write(struct.pack("<II", _MAGIC, lrec))
        self._f.write(payload)
        pad = (-len(payload)) % 4
        if pad:
            self._f.write(b"\x00" * pad)
        self._idx_f.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)

    def close(self):
        if self.mode == "w":
            self._f.close()
            self._idx_f.close()
        else:
            self._local = None

    # picklable (worker processes): drop the handles, reopen lazily
    def __getstate__(self):
        state = self.__dict__.copy()
        if self.mode == "r":
            state["_local"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __len__(self):
        return len(self.keys)


def imdecode(buf: bytes, to_rgb: bool = True) -> np.ndarray:
    """mx.image.imdecode parity via cv2 (same OpenCV jpeg path)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("image decode failed")
    return img[:, :, ::-1] if to_rgb else img


def imencode(img_rgb: np.ndarray, quality: int = 95) -> bytes:
    """cv2 JPEG encode (tooling side)."""
    import cv2

    ok, buf = cv2.imencode(".jpg", img_rgb[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise ValueError("image encode failed")
    return buf.tobytes()
