"""Batches for the training loops (JAX counterpart: ``deepfluoro_tpu/data/
pipeline.py``).

``BatchIterator`` copies the dataset to the device once and gathers each
batch there by index, so a step moves only the index vector across the
host boundary. ``PrefetchIterator`` keeps the dataset in host memory, for
archives too large for the card: a producer thread gathers each batch's
rows into pinned buffers and copies them to the card on a side stream
while the consumer trains on the batch before (``prefetch_sequence``,
``HostToDevice``). Both give the same batch order for the same seed.

With ``part=(index, count)`` either iterator yields process ``index``'s
contiguous slice of every global batch (``parallel/multihost.py::
local_batch_slice``), the multi-process feed of data parallelism; a global
batch that does not split evenly over the ``count`` processes (a final
partial one) is skipped, as the JAX package's multi-process feed drops it.
"""

from __future__ import annotations

import queue
import threading
import warnings

import numpy as np
import torch

from deepfluoro_tpu_torch.data.hdf5 import FluoroData
from deepfluoro_tpu_torch.parallel.multihost import local_batch_slice


def _batch_rows(order: np.ndarray, batch_size: int, part):
    """Each batch's rows of ``order``, or with ``part`` this process's
    slice of each global batch that splits evenly."""
    for start in range(0, len(order), batch_size):
        rows = order[start : start + batch_size]
        if part is not None:
            index, count = part
            if len(rows) % count:
                continue
            rows = local_batch_slice(rows, index, count)
        yield rows


class BatchIterator:
    """Yields (projs, segs, lands) device tensors per batch; segs and lands
    are None when the data has none. With ``shuffle`` each epoch permutes
    the rows with ``rng`` (a numpy Generator, so the order equals the JAX
    package's for the same seed). The final partial batch is kept, like
    torch DataLoader's drop_last=False; ``part`` as the module says."""

    def __init__(self, data: FluoroData, batch_size: int, device, shuffle: bool = False, rng: np.random.Generator | None = None,
                 part: tuple[int, int] | None = None):
        if shuffle and rng is None:
            raise ValueError("shuffle needs an explicit numpy Generator")
        self.n = len(data)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.part = part
        self._rng = rng
        put = lambda a: None if a is None else torch.as_tensor(a).to(device)  # noqa: E731
        self.projs = put(data.projs)
        self.segs = put(data.segs)
        self.lands = put(data.lands)

    def epoch(self):
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        for rows in _batch_rows(order, self.batch_size, self.part):
            idx = torch.as_tensor(rows).to(self.projs.device)
            take = lambda a: None if a is None else a.index_select(0, idx)  # noqa: E731
            yield self.projs.index_select(0, idx), take(self.segs), take(self.lands)


JOIN_TIMEOUT_S = 10.0  # a wedged producer must not turn closing its generator into a hang


def prefetch_sequence(make_item, num_items: int, prefetch: int = 2):
    """Yield ``make_item(i)`` for i in range(num_items), made on a producer
    thread at most ``prefetch`` items ahead (a bounded queue). A producer
    error re-raises in the consumer; closing the generator early stops the
    producer, drains the queue so a blocked ``put`` returns, and joins the
    thread (each join bounded by ``JOIN_TIMEOUT_S``)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def produce():
        try:
            for i in range(num_items):
                if stop.is_set():
                    return
                q.put(make_item(i))
            q.put(None)
        except BaseException as e:  # handed to the consumer
            q.put(e)

    def drain():
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        drain()
        t.join(timeout=JOIN_TIMEOUT_S)
        drain()  # the one put that can land between the first drain and the stop check
        t.join(timeout=JOIN_TIMEOUT_S)
        if t.is_alive():
            warnings.warn("prefetch producer thread still alive after a bounded join; abandoning it", RuntimeWarning)


class HostToDevice:
    """Gathers rows of host arrays into device tensors, for a producer
    thread. On CUDA the rows go into one of ``slots`` pinned buffers and
    are copied with ``non_blocking=True`` on a side stream; a buffer is
    refilled only after the event recorded behind its last copy has
    passed, so no copy in flight reads rows being overwritten. The
    consumer calls ``ready`` before it uses a batch: its stream then waits
    for the batch's copy, and the batch's memory is recorded on that stream
    for the allocator. On the CPU ``put`` is a plain gather.

    ``put(rows)`` returns (tensors, event): one tensor per array (None for
    an absent array) and the copy's event (None on the CPU). With ``take``
    the rows come from ``take(rows)`` (a tuple of arrays, e.g.
    ``LazyFluoroReader.take``) and ``arrays`` only give each array's
    dtype and row shape."""

    def __init__(self, arrays, max_rows: int, device, slots: int = 4, take=None):
        self.arrays = arrays
        self._take = take
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._buffers = [
                [None if a is None else torch.empty((max_rows,) + a.shape[1:], dtype=torch.from_numpy(a[:0]).dtype).pin_memory()
                 for a in arrays]
                for _ in range(slots)
            ]
            self._events = [None] * slots
            self._slot = 0

    def put(self, rows: np.ndarray):
        n = len(rows)
        if self._take is None:
            gather = lambda a, buf: np.take(a, rows, axis=0, out=buf)  # noqa: E731
            src = self.arrays
        else:
            gather = lambda a, buf: np.copyto(buf, a)  # noqa: E731
            src = self._take(rows)
        if not self._cuda:
            return tuple(None if a is None else torch.from_numpy(a[rows] if self._take is None else a) for a in src), None
        slot = self._slot
        self._slot = (slot + 1) % len(self._buffers)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for a, buf in zip(src, self._buffers[slot]):
                if a is None:
                    out.append(None)
                    continue
                gather(a, buf[:n].numpy())
                out.append(buf[:n].to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        return tuple(out), event

    def ready(self, item):
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                if t is not None:
                    t.record_stream(stream)
        return tensors


class PrefetchIterator:
    """``BatchIterator``'s batches from a dataset kept in host memory:
    yields (projs, segs, lands) tensors on ``device``, made ``prefetch``
    batches ahead by a producer thread. With ``shuffle`` each epoch
    permutes the rows with ``np.random.default_rng(seed)``, one shuffle per
    epoch, so the order equals ``BatchIterator``'s given
    ``np.random.default_rng(seed)``, and the JAX ``PrefetchIterator``'s.
    ``data`` is a ``FluoroData``, or any object with ``projs``, ``segs``
    and ``lands`` (dtype and row shape) and ``take(rows)`` that reads the
    rows (``loop.py::ReaderRows``); ``part`` as the module says."""

    def __init__(self, data, batch_size: int, device, shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 part: tuple[int, int] | None = None):
        assert prefetch >= 1
        self.n = len(data)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.part = part
        self._rng = np.random.default_rng(seed)
        self._feed = HostToDevice((data.projs, data.segs, data.lands), batch_size, device, slots=prefetch + 2,
                                  take=getattr(data, "take", None))

    def __len__(self) -> int:
        return -(-self.n // self.batch_size)

    def epoch(self):
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        batches = list(_batch_rows(order, self.batch_size, self.part))
        items = prefetch_sequence(lambda i: self._feed.put(batches[i]), len(batches), self.prefetch)
        try:
            for item in items:
                yield self._feed.ready(item)
        finally:
            items.close()
