"""Host -> device input pipeline for one GPU.

Counterpart of `msml_tpu/data/pipeline.py::device_prefetch` on a single
device. A worker thread draws the numpy batches and puts each into pinned
host tensors, up to two batches ahead; the consumer starts the next batch's
`non_blocking` copy to the card before it hands out the current one, so the
copy and the host's batch making overlap the step. No sharding, and no
`scan_steps` windows (the port's step takes one batch at a time).

The generator is safe to abandon early (a `break` out of the training
loop): closing it stops the worker and closes the inner iterator.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

_END = object()
_DEPTH = 2  # host batches ready ahead of the consumer


def _host(batch: Dict[str, np.ndarray], pin: bool):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def device_prefetch(it: Iterator, device) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of `it` (dicts of numpy arrays) as tensors on
    `device`, the next batch's copy already under way."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=_DEPTH)
    stop = threading.Event()
    err: list = []

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in it:
                if not offer(_host(batch, pin)):
                    break
        except Exception as e:  # surfaced on the consumer's thread
            err.append(e)
        finally:
            if hasattr(it, "close"):
                it.close()
            offer(_END)

    def take():
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return None
        return {k: t.to(device, non_blocking=True) for k, t in item.items()}

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        ahead = take()
        while ahead is not None:
            nxt = take()
            yield ahead
            ahead = nxt
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5)
