"""Host-side minibatch iterator with background staging.

Port of portfoliooptgp_tpu/data/iterator.py:

- each epoch is shuffled on the host by `np.random.default_rng(seed)`, so
  for a given seed the index stream is the JAX package's and both train on
  the same batches;
- every batch has `batch_size` rows: the last, partial batch is zero-padded
  and its padding rows carry weight 0;
- with `inner_steps` k > 1 batches are stacked k at a time, and the
  stream's tail group is filled with all-zero batches (weight 0), which the
  trainer skips exactly;
- a daemon thread shuffles, slices, pads and stacks up to `prefetch` host
  batches ahead through a bounded queue; the consumer copies each to the
  device;
- with a mesh every rank runs the same stream (the same permutation from
  `seed`) and yields its row shard of each global batch over the data
  axis, as JAX places a batch sharded over DATA_AXIS: rank i of D takes
  rows [i·b/D, (i+1)·b/D) of the batch (of each inner batch of a group).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device
from portfoliooptgp_tpu_torch.parallel.mesh import DATA_AXIS


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=torch.empty((), dtype=dtype).numpy().dtype)


class MinibatchIterator:
    """Iterate (X, Y, w) device minibatches of a fixed shape.

    Args:
      X, Y: (N, D) / (N, P) arrays or tensors (copied to the host once).
      batch_size: rows per step (of the global batch); with a mesh it must
        divide by the data-axis size.
      mesh: optional (parallel/mesh.py) — yield this rank's row shard of
        each batch, on the mesh's device.
      num_epochs: None cycles forever.
      shuffle/seed: per-epoch permutation, deterministic per seed.
      drop_remainder: skip the last partial batch instead of padding it.
      prefetch: host batches staged ahead by the background thread.
      inner_steps: stack this many batches into one (k, batch_size, ...)
        group; the tail group is filled with all-zero batches.
      device, dtype: where and as what the batches are delivered (with a
        mesh, on the mesh's device).
    """

    def __init__(self, X, Y, batch_size: int, *, mesh=None, num_epochs: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0, drop_remainder: bool = False,
                 prefetch: int = 2, inner_steps: int = 1, device=DEFAULT_DEVICE,
                 dtype=DEFAULT_DTYPE):
        self._device = resolve_device(device) if mesh is None else mesh.device
        self._X = _host(X, dtype)
        self._Y = _host(Y, dtype)
        if self._X.shape[0] != self._Y.shape[0]:
            raise ValueError("X and Y row counts differ")
        self._n = self._X.shape[0]
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self._bs = int(batch_size)
        self._shard = None
        if mesh is not None:
            n_shards = mesh.shape[DATA_AXIS]
            if self._bs % n_shards:
                raise ValueError(
                    f"batch_size={batch_size} must divide the data axis ({n_shards})")
            local = self._bs // n_shards
            self._shard = slice(mesh.index(DATA_AXIS) * local,
                                (mesh.index(DATA_AXIS) + 1) * local)
        if inner_steps < 1:
            raise ValueError("inner_steps must be >= 1")
        self._k = int(inner_steps)
        self._group: list = []
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._drop_remainder = drop_remainder
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    @property
    def num_data(self) -> int:
        return self._n

    def steps_per_epoch(self) -> int:
        if self._drop_remainder:
            return self._n // self._bs
        return -(-self._n // self._bs)

    def _enqueue(self, item):
        # bounded put, polling the stop flag so close() never deadlocks
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _stage(self, batch):
        if self._k == 1:
            self._enqueue(batch)
            return
        self._group.append(batch)
        if len(self._group) == self._k:
            self._enqueue(tuple(np.stack(parts) for parts in zip(*self._group)))
            self._group = []

    def _flush_group(self):
        """Fill a partial tail group with all-zero (weight-0) batches."""
        if self._k == 1 or not self._group:
            return
        dummy = (np.zeros((self._bs,) + self._X.shape[1:], self._X.dtype),
                 np.zeros((self._bs,) + self._Y.shape[1:], self._Y.dtype),
                 np.zeros((self._bs,), self._X.dtype))
        while len(self._group) < self._k:
            self._group.append(dummy)
        self._enqueue(tuple(np.stack(parts) for parts in zip(*self._group)))
        self._group = []

    def _put_batch(self, idx):
        n_real = idx.shape[0]
        Xb, Yb = self._X[idx], self._Y[idx]
        w = np.ones((self._bs,), self._X.dtype)
        if n_real < self._bs:
            pad = self._bs - n_real
            Xb = np.concatenate([Xb, np.zeros((pad,) + Xb.shape[1:], Xb.dtype)])
            Yb = np.concatenate([Yb, np.zeros((pad,) + Yb.shape[1:], Yb.dtype)])
            w[n_real:] = 0.0
        self._stage((Xb, Yb, w))

    def _producer(self):
        epoch = 0
        try:
            while not self._stop.is_set():
                if self._num_epochs is not None and epoch >= self._num_epochs:
                    break
                order = self._rng.permutation(self._n) if self._shuffle else np.arange(self._n)
                limit = (self._n // self._bs) * self._bs if self._drop_remainder else self._n
                for start in range(0, limit, self._bs):
                    if self._stop.is_set():
                        return
                    self._put_batch(order[start:start + self._bs])
                epoch += 1
        finally:
            self._flush_group()
            self._enqueue(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if self._shard is not None:
            rows = (self._shard,) if self._k == 1 else (slice(None), self._shard)
            item = tuple(np.ascontiguousarray(a[rows]) for a in item)
        return tuple(torch.from_numpy(a).to(self._device) for a in item)

    def close(self):
        """Stop the producer thread and drop staged batches."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
