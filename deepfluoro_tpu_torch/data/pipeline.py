"""Shuffled batches from a dataset held on the device (JAX counterpart:
``deepfluoro_tpu/data/pipeline.py::BatchIterator``).

The arrays are copied to the device once; each batch is gathered there by
index, so a step moves only the index vector across the host boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from deepfluoro_tpu_torch.data.hdf5 import FluoroData


class BatchIterator:
    """Yields (projs, segs, lands) device tensors per batch; segs and lands
    are None when the data has none. With ``shuffle`` each epoch permutes
    the rows with ``rng`` (a numpy Generator, so the order equals the JAX
    package's for the same seed). The final partial batch is kept, like
    torch DataLoader's drop_last=False."""

    def __init__(self, data: FluoroData, batch_size: int, device, shuffle: bool = False, rng: np.random.Generator | None = None):
        if shuffle and rng is None:
            raise ValueError("shuffle needs an explicit numpy Generator")
        self.n = len(data)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = rng
        put = lambda a: None if a is None else torch.as_tensor(a).to(device)  # noqa: E731
        self.projs = put(data.projs)
        self.segs = put(data.segs)
        self.lands = put(data.lands)

    def epoch(self):
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, self.n, self.batch_size):
            idx = torch.as_tensor(order[start : start + self.batch_size]).to(self.projs.device)
            take = lambda a: None if a is None else a.index_select(0, idx)  # noqa: E731
            yield self.projs.index_select(0, idx), take(self.segs), take(self.lands)
