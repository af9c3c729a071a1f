"""Training dataset: RecordIO faces + online occlusion + offline 3D masks.

The port's own copy of `msml_tpu/data/face_dataset.py`, giving the same
batches from the same seed. Parity target: `datasets/load_dataset.py:21-339`
`FaceByRandOccMask`:
  * reads train.rec/idx plus the offline-rendered mask_out.rec (masked faces)
    and mask.rec (binary masks) produced by the 3D-mask tool
    (datasets/3d_tools/cvt_casia_webface_masked.py)
  * P(3D mask) = 2/10 (load_dataset.py:113); otherwise, casia recipe:
    P(random-occ) = P(no-occ) = 4/10 each (159-163); ms1m recipe: uniform
    over the 7 transforms (155-157)
  * `ori` (the KD reference image) goes through the same non-mask branch, so
    it is itself randomly occluded half the time — faithful to
    load_dataset.py:114 (quirk kept deliberately)
  * random horizontal flip p=0.5 of img/msk/ori together (123-126)
  * Gaussian-light relighting of the face (183-201) and of the 3D-mask
    region (noise/light/rect-block jitter, 203-280)
  * returns (img, msk, ori, label) with img/ori normalized to [-1, 1] when
    use_norm, msk int {0: occluded, 1: clean}

Deviations (documented):
  * dataset branch (ms1m vs casia) chosen from the root_dir path string; the
    reference tests `'ms1m' in self.img_rec` against a RecordIO *object*
    (load_dataset.py:155) which TypeErrors on stock mxnet — we implement the
    evident intent.
  * per-sample numpy RandomState seeded from (seed, index, epoch) makes the
    pipeline deterministic and worker-count-independent.
  * if mask_out.rec/mask.rec are absent, P(mask) mass moves to the online
    branch with a warning (lets users train without the offline render step).
  * `MXFaceDataset` reads on its Python path only: the C++ batch decoder of
    the JAX package (`tools_cpp/msml_loader.cpp`) is not ported.

Pillow is imported with the module, cv2 inside the decoders
(`data/recordio.py`) and the transforms that draw with it.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from msml_torch.core.logging import LOGGER
from msml_torch.data import rand_occ as occ
from msml_torch.data.recordio import IndexedRecordIO, imdecode, unpack

logger = logging.getLogger(LOGGER)


_WORKER_DS = None  # installed in pool workers by _init_worker


def _init_worker(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_fetch(args):
    return _WORKER_DS._fetch(args)


@contextlib.contextmanager
def _main_hidden():
    """While the spawn pool starts its workers, hide the parent's main
    module from multiprocessing, so that the workers do not run it again:
    they need only this module, and a main script or `-m` module that
    imports torch at its top (the training CLI, chip_smoke.py) would make
    every worker import torch (on an H100's machine a pool of 32 workers
    then took 312 s to start, 25 s without). It changes the process's
    `__main__`, so start the pool on the main thread before other threads
    run (the training CLI does). A worker that the pool starts again after
    one died is started outside this and imports the main module again."""
    main = sys.modules["__main__"]
    spec, file = main.__spec__, main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__spec__ = spec
        if file is not None:
            main.__file__ = file


def default_occluder_root() -> str:
    """`msml_torch/data/occluder_assets`, unless MSML_OCCLUDER_DIR names
    another directory."""
    return os.environ.get("MSML_OCCLUDER_DIR",
                          os.path.join(os.path.dirname(__file__),
                                       "occluder_assets"))


class FaceByRandOccMask:
    """Indexable dataset; __getitem__(index, rng) -> (img, msk, ori, label)
    numpy arrays (HWC float32, HW int32, HWC float32, int32)."""

    def __init__(self, root_dir: str, is_train: bool = True,
                 out_size=(112, 112), is_gray: bool = False,
                 use_norm: bool = False, use_ori: bool = True,
                 occluder_root: Optional[str] = None, occ: bool = True,
                 batch_size: int = 0, seed: int = 0,
                 num_workers: int = 16, shard_id: int = 0,
                 num_shards: int = 1, gauss_light: bool = True,
                 raw_uint8: bool = False):
        self.root_dir = root_dir
        self.out_size = tuple(out_size)
        self.is_gray = is_gray
        self.use_norm = use_norm
        self.use_ori = use_ori
        self.use_occ = occ
        self.gauss_light = gauss_light
        # device_light mode: __getitem__ stops after the u8 stages (decode
        # + occlusion + resize + flip) and yields uint8; the Gaussian
        # relighting + normalize run inside the train step (the augment
        # kernel, kernels/augment.py) — 4x smaller host->device transfer
        # and no per-sample float work on the host. The 3D-mask
        # branch's extra mask-region relighting (trans_type jitter,
        # _add_gauss_to_mask) is skipped in this mode — documented
        # distribution deviation, like the on-device sweep kernel.
        self.raw_uint8 = raw_uint8
        self.batch_size = batch_size  # per-process batch
        self.seed = seed
        self.num_workers = num_workers
        # multi-host: each process reads a disjoint interleaved slice of the
        # shuffled order (the DistributedSampler analogue, train.py:94-95)
        self.shard_id, self.num_shards = shard_id, num_shards
        self.is_ms1m = "ms1m" in root_dir

        self.img_rec = IndexedRecordIO(os.path.join(root_dir, "train.idx"),
                                       os.path.join(root_dir, "train.rec"))
        self.mask_out_rec = self.mask_rec = None
        if (os.path.exists(os.path.join(root_dir, "mask_out.rec"))
                and os.path.exists(os.path.join(root_dir, "mask.rec"))):
            self.mask_out_rec = IndexedRecordIO(
                os.path.join(root_dir, "mask_out.idx"),
                os.path.join(root_dir, "mask_out.rec"))
            self.mask_rec = IndexedRecordIO(
                os.path.join(root_dir, "mask.idx"),
                os.path.join(root_dir, "mask.rec"))
        else:
            logger.warning("mask_out.rec/mask.rec not found under %s; "
                           "3D-mask branch disabled (P moves to online occ)",
                           root_dir)

        header, _ = unpack(self.img_rec.read_idx(0))
        if header.flag > 0:
            self.header0 = (int(header.label[0]), int(header.label[1]))
            self.img_idx = np.arange(1, int(header.label[0]))
        else:
            self.img_idx = np.asarray(self.img_rec.keys)

        self._build_transforms(occluder_root or default_occluder_root())

    def _build_transforms(self, occluder_root: str):
        """load_dataset.py:71-84."""
        self.no_occ = occ.NoneOcc()
        trans = [occ.RandomRect(), occ.RandomEllipse(),
                 occ.RandomConnectedPolygon()]
        for cls, sub in ((occ.RandomGlassesList,
                          ["glasses_crop", "eleglasses_crop"]),
                         (occ.RandomScarf, "scarf_crop"),
                         (occ.RandomRealObject, "object_train")):
            try:
                if isinstance(sub, list):
                    trans.append(cls([os.path.join(occluder_root, s)
                                      for s in sub]))
                else:
                    trans.append(cls(os.path.join(occluder_root, sub)))
            except FileNotFoundError:
                logger.warning("occluder assets %s/%s missing; transform %s "
                               "disabled", occluder_root, sub, cls.__name__)
        self.trans_occ = tuple(trans)
        self.all_trans = tuple(trans) + (self.no_occ,)

    def __len__(self):
        return len(self.img_idx)

    # ------------------------------------------------------------- sample
    def __getitem__(self, index: int, rng: Optional[np.random.RandomState]
                    = None):
        r = rng or np.random
        idx = int(self.img_idx[index])
        header, img_bytes = unpack(self.img_rec.read_idx(idx))
        label = header.label
        if not np.isscalar(label):
            label = label[0]

        mask_flag = (self.use_occ and self.mask_out_rec is not None
                     and r.randint(1, 11) >= 9)  # P=2/10
        # ori (the KD reference image, randomly occluded half the time —
        # faithful to load_dataset.py:114) is only materialised when a peer
        # teacher consumes it: it costs a second jpeg decode + occlusion
        # transform per sample on the host hot path, and epoch() drops it
        # from the batch when use_ori is off.
        ori = None
        if self.use_ori:
            ori, _ = self._occluded_face_and_mask(img_bytes, idx, False, r)
        img, msk = self._occluded_face_and_mask(img_bytes, idx, mask_flag, r)

        img = self._resize(img)
        msk = self._resize(msk)
        if ori is not None:
            ori = self._resize(ori)

        if r.randint(1, 11) >= 5:  # P(flip) ~ 0.5+ (load_dataset.py:123)
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            msk = msk.transpose(Image.FLIP_LEFT_RIGHT)
            if ori is not None:
                ori = ori.transpose(Image.FLIP_LEFT_RIGHT)

        if self.raw_uint8:
            img_a = np.asarray(img, np.uint8)
            if img_a.ndim == 2:
                img_a = img_a[..., None]
            m = np.asarray(msk, np.uint8)
            if mask_flag:  # 3D-mask threshold (load_dataset.py:241-242,277)
                msk_t = (m > 128).astype(np.int32)
            else:
                msk_t = (m // 255).astype(np.int32)
            if ori is not None:
                ori_a = np.asarray(ori, np.uint8)
                if ori_a.ndim == 2:
                    ori_a = ori_a[..., None]
            else:
                ori_a = img_a
            return img_a, msk_t, ori_a, np.int32(label)

        if self.gauss_light:
            img_t = self._add_gauss_to_face(img, r)    # HWC [0,1] f32
        else:  # plain-reader parity (MXFaceDataset, load_dataset.py:344-396)
            img_t = self._to_float(img)
        img_t, msk_t = self._add_gauss_to_mask(img_t, msk, mask_flag, r)

        ori_t = self._to_float(ori) if ori is not None else img_t
        if self.use_norm:
            img_t = (img_t - 0.5) / 0.5
            ori_t = (ori_t - 0.5) / 0.5 if ori is not None else img_t
        return (img_t.astype(np.float32), msk_t.astype(np.int32),
                ori_t.astype(np.float32), np.int32(label))

    def _resize(self, img: Image.Image) -> Image.Image:
        if img.size == (self.out_size[1], self.out_size[0]):
            return img
        return img.resize((self.out_size[1], self.out_size[0]),
                          Image.BILINEAR)

    def _to_float(self, img: Image.Image) -> np.ndarray:
        a = np.asarray(img, np.float32) / 255.0
        if a.ndim == 2:
            a = a[..., None]
        return a

    def _occluded_face_and_mask(self, img_bytes: bytes, idx: int,
                                mask_flag: bool, r):
        """load_dataset.py:144-181."""
        if not mask_flag:
            src = Image.fromarray(imdecode(img_bytes))
            if not self.use_occ:
                out_img, out_mask = self.no_occ(src, r)
            elif self.is_ms1m:
                t = self.all_trans[r.randint(0, len(self.all_trans))]
                out_img, out_mask = t(src, r)
            else:  # casia recipe
                if r.randint(0, 8) >= 4:
                    t = self.trans_occ[r.randint(0, len(self.trans_occ))]
                    out_img, out_mask = t(src, r)
                else:
                    out_img, out_mask = self.no_occ(src, r)
        else:
            _, mo_bytes = unpack(self.mask_out_rec.read_idx(idx))
            out_img = Image.fromarray(imdecode(mo_bytes))
            _, m_bytes = unpack(self.mask_rec.read_idx(idx))
            out_mask = Image.fromarray(imdecode(m_bytes)).convert("L")
        if self.is_gray:
            out_img = out_img.convert("L")
        return out_img, out_mask

    def _add_gauss_to_face(self, img: Image.Image, r) -> np.ndarray:
        """load_dataset.py:183-201 (HWC layout)."""
        out = self._to_float(img)
        h, w = self.out_size
        light = gauss_map(0, 0, w, h, r, radius=128)
        scale = r.uniform(0.7, 1.4)
        out = out * (light * scale)[..., None]
        return out / max(out.max(), 1e-6)

    def _add_gauss_to_mask(self, face: np.ndarray, msk: Image.Image,
                           mask_flag: bool, r):
        """load_dataset.py:203-280 (HWC layout)."""
        if not mask_flag:
            m = np.asarray(msk, np.uint8) // 255  # {0,1}, 1 = clean
            return face, m

        h, w = self.out_size
        m = np.asarray(msk, np.uint8)
        msk_tmp = np.full((h, w), 255.0)
        msk_tmp[m <= 128] = 0  # 0: occluded

        trans_type = r.randint(0, 11)
        lty, ltx = 1, 40 + r.randint(-20, 21)
        rdy, rdx = 111, 100 + r.randint(-20, 11)
        rescale = np.zeros((h, w), np.float32)
        msk_light = np.repeat(((msk_tmp // 128) * (-1) + 1)[..., None], 3,
                              axis=2).astype(np.float32)  # 1: mask px

        if trans_type >= 7:  # gaussian light on the mask region
            g = gauss_map(ltx, lty, rdx, rdy, r)
            g = (g - 0.5) * 2 * 0.4 * (r.randint(0, 2) * 2 - 1)
            rescale[lty:rdy, ltx:rdx] = g
        elif trans_type >= 5:  # gaussian noise
            rescale[lty:rdy, ltx:rdx] = r.randn(rdy - lty, rdx - ltx)
        else:  # rectangle block
            lty2 = 40 + r.randint(-20, 20)
            rdy2 = 100 + r.randint(-20, 10)
            block = np.zeros((h, w), np.float32)
            block[lty2:rdy2, ltx:rdx] = r.randint(0, 2) * 2 - 1
            msk_light = msk_light * block[..., None]

        if trans_type >= 5:  # color jitter
            for c in range(3):
                if r.randint(0, 2) >= 1:
                    msk_light[..., c] = msk_light[..., c] * rescale
                else:
                    msk_light[..., c] = 0

        if self.is_gray:
            msk_light = ((0.2989 * msk_light[..., 0]
                          + 0.5870 * msk_light[..., 1]
                          + 0.1140 * msk_light[..., 2]) / 3)[..., None]

        out_face = face - msk_light
        out_mask = (msk_tmp // 255).astype(np.int32)
        return out_face, out_mask

    def _fetch(self, args):
        epoch, i = args
        r = np.random.RandomState(
            (self.seed * 1000003 + epoch * 10007 + int(i)) % (2 ** 31 - 1))
        return self.__getitem__(int(i), r)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """Shuffled per-epoch sample order (DistributedSampler.set_epoch
        analogue): same shuffle on every process (seeded), disjoint
        interleaved slices per rank, incl. torch's wrap-around padding to a
        multiple of num_shards — without it, ranks can disagree on
        batches-per-epoch and hang the pod at the epoch boundary waiting for
        each other's SPMD launches."""
        order_rng = np.random.RandomState(self.seed + epoch)
        order = order_rng.permutation(len(self))
        if self.num_shards > 1:
            pad = (-len(order)) % self.num_shards
            if pad:
                # np.resize tiles cyclically, so this also covers
                # pad > len(order) (num_shards >> dataset size), like
                # DistributedSampler's repeated-indices padding
                order = np.resize(order, len(order) + pad)
            order = order[self.shard_id::self.num_shards]
        return order

    # -------------------------------------------------------------- batches
    def epoch(self, epoch: int, use_processes: bool = False
              ) -> Iterator[dict]:
        """Shuffled batches (the DistributedSampler.set_epoch analogue,
        train.py:94-95,234); drop_last=True like the reference loader.

        use_processes=True uses a spawned worker pool (the reference's 32
        DataLoader workers, train.py:96-99), since PIL/cv2 augmentation
        holds the GIL too often for threads alone. spawn (not fork)
        because the caller has usually already initialized CUDA and
        started the prefetch thread. The workers import numpy, Pillow and
        cv2 but not torch (`_main_hidden`); the pool still takes seconds
        to start. It is created once and reused across epochs (call
        close() when done)."""
        assert self.batch_size > 0, "set batch_size for epoch iteration"
        order = self._epoch_order(epoch)
        nb = len(order) // self.batch_size

        if use_processes:
            pool = self._get_pool()
            mapper = functools.partial(pool.imap, _worker_fetch, chunksize=4)
        else:
            ex = ThreadPoolExecutor(max_workers=self.num_workers)
            mapper = functools.partial(ex.map, self._fetch)
        try:
            for b in range(nb):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                samples = list(mapper([(epoch, int(i)) for i in idxs]))
                img = np.stack([s[0] for s in samples])
                msk = np.stack([s[1] for s in samples])
                ori = np.stack([s[2] for s in samples])
                label = np.stack([s[3] for s in samples])
                batch = {"img": img, "msk": msk, "label": label}
                if self.use_ori:
                    batch["ori"] = ori
                yield batch
        finally:
            if not use_processes:
                ex.shutdown(wait=False)

    def _get_pool(self):
        if getattr(self, "_pool", None) is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            with _main_hidden():
                self._pool = ctx.Pool(self.num_workers,
                                      initializer=_init_worker,
                                      initargs=(self,))
        return self._pool

    def close(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_pool"] = None  # pools never cross process boundaries
        return state


class MXFaceDataset(FaceByRandOccMask):
    """Plain rec reader parity (`datasets/load_dataset.py:344-396`): resize /
    flip / normalize ONLY — no occlusion and no Gaussian relighting (the
    reference's plain class applies neither). Yields the same 4-tuple
    contract with an all-clean mask; ori mirrors img (flipped together,
    like the reference flips everything it returns).

    The Python path of `msml_tpu/data/face_dataset.py::MXFaceDataset`.
    native_decode=True asks for the JAX package's C++ batch decoder
    (`tools_cpp/msml_loader.cpp`), which is not ported, and raises;
    None and False read through the Python path."""

    def __init__(self, root_dir: str, native_decode: Optional[bool] = None,
                 **kw):
        if native_decode:
            raise NotImplementedError(
                "native_decode: the C++ batch decoder "
                "tools_cpp/msml_loader.cpp (data/native_loader.py) is not "
                "ported; use native_decode=None or False")
        kw.setdefault("use_norm", True)
        kw.setdefault("gauss_light", False)
        super().__init__(root_dir, occ=False, **kw)


def pil_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """PIL Image.convert('L') exactly (integer ITU-R 601-2:
    L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16), vectorized."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    bch = rgb[..., 2].astype(np.uint32)
    return ((r * 19595 + g * 38470 + bch * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def gauss_map(left_top_x: int, left_top_y: int, right_down_x: int,
              right_down_y: int, r, center_x=(), center_y=(),
              radius: int = -1, metric: str = "Euclidean") -> np.ndarray:
    """2D Gaussian illumination map (load_dataset.py:282-339)."""
    image_height = right_down_y - left_top_y
    image_width = right_down_x - left_top_x

    if len(center_x) == 0 and len(center_y) == 0:
        cx = left_top_x + (right_down_x - left_top_x) * r.random()
        cy = left_top_y + (right_down_y - left_top_y) * r.random()
    else:
        cx = center_x[r.randint(0, len(center_x))]
        cy = center_y[r.randint(0, len(center_y))]

    if radius < 0:
        edge = max(image_width, image_height)
        radius = r.uniform(int(edge / 1.5), int(edge * 1.5))

    x = (np.arange(image_width) - cx)[None, :].astype(np.float32)
    y = (np.arange(image_height) - cy)[:, None].astype(np.float32)
    if metric == "Euclidean":
        d2 = x ** 2 + y ** 2
    elif metric == "Manhattan":
        d2 = (np.abs(x) + np.abs(y)) ** 2
    else:
        raise ValueError("Distance Metric Error!")
    return np.exp(-0.5 * d2 / radius ** 2)
