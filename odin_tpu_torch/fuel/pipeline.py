"""Host-to-device input pipeline (PyTorch port of
``odin_tpu/fuel/pipeline.py``).

``DataPipeline`` shuffles, batches and maps arrays on the host and prepares
batches ahead on a background thread.  With ``to_device`` a device, that
thread also copies each batch to the card: into pinned host memory, then
``non_blocking`` on a side stream, with an event recorded after the copy;
the consumer's stream waits on that event before it is handed the batch,
so a step never reads a batch whose copy has not finished.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device

__all__ = ["DataPipeline", "device_transfer"]


def _length_of(arrays) -> int:
  if isinstance(arrays, dict):
    return len(next(iter(arrays.values())))
  if isinstance(arrays, (tuple, list)):
    return len(arrays[0])
  return len(arrays)


def _take(v, idx):
  # native threaded gather for contiguous ndarrays (bit-identical to numpy
  # fancy indexing; csrc/odin_io.cpp `odin_gather`)
  if isinstance(v, np.ndarray) and v.flags["C_CONTIGUOUS"]:
    from odin_tpu_torch.native import gather
    return gather(v, idx)
  return v[idx]


def _index(arrays, idx):
  if isinstance(arrays, dict):
    return {k: _take(v, idx) for k, v in arrays.items()}
  if isinstance(arrays, (tuple, list)):
    return tuple(_take(v, idx) for v in arrays)
  return _take(arrays, idx)


def _map(fn, batch):
  if isinstance(batch, dict):
    return {k: _map(fn, v) for k, v in batch.items()}
  if isinstance(batch, (tuple, list)):
    return type(batch)(_map(fn, v) for v in batch)
  return fn(batch)


class _InFlight:
  """A batch whose copy to the card was issued on a side stream."""

  def __init__(self, batch, event: torch.cuda.Event, device: torch.device):
    self.batch, self.event, self.device = batch, event, device

  def arrive(self):
    """Make the current stream wait for the copy, and keep the memory from
    being reused before that stream is done with it."""
    stream = torch.cuda.current_stream(self.device)
    stream.wait_event(self.event)
    _map(lambda t: t.record_stream(stream), self.batch)
    return self.batch


def _arrive(item):
  return item.arrive() if isinstance(item, _InFlight) else item


class _ToDevice:
  """Copies a batch of host arrays to `device`: on the card through pinned
  memory, ``non_blocking`` on a side stream of its own."""

  def __init__(self, device):
    self.device = resolve_device(device)
    self._stream = None

  def __call__(self, batch):
    if self.device.type != "cuda":
      return _map(lambda a: torch.as_tensor(np.asarray(a)).to(self.device),
                  batch)
    if self._stream is None:
      self._stream = torch.cuda.Stream(self.device)
    pinned = _map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                  .pin_memory(), batch)
    with torch.cuda.stream(self._stream):
      out = _map(lambda t: t.to(self.device, non_blocking=True), pinned)
      event = torch.cuda.Event()
      event.record(self._stream)
    return _InFlight(out, event, self.device)


def device_transfer(to_device) -> Optional[Callable]:
  """The per-batch function of a pipeline's `to_device`: None, a callable
  (applied as it is), or a device (``'cuda'``, a ``torch.device``), whose
  copy raises where there is no card."""
  if to_device is None or callable(to_device):
    return to_device
  return _ToDevice(to_device)


class DataPipeline:
  """Iterable of batches over in-memory or memory-mapped arrays.

  Args:
    arrays: array, tuple of arrays, or dict of arrays (first axis =
      examples).
    batch_size: examples per batch.
    shuffle: any truthy value permutes the examples anew each epoch.
    epochs: -1 repeats forever.
    map_fn: applied to each batch on the host.
    drop_remainder: drop the trailing partial batch.
    seed: the shuffle's ``numpy.random.RandomState`` seed.
    prefetch: batches prepared ahead on a background thread.
    to_device: a callable applied to each batch, or a device the batches
      are copied to (see the module's docstring); None yields numpy.
  """

  def __init__(self,
               arrays,
               batch_size: int = 32,
               shuffle: Union[bool, int] = False,
               epochs: int = 1,
               map_fn: Optional[Callable] = None,
               drop_remainder: bool = False,
               seed: int = 1,
               prefetch: int = 2,
               to_device=None):
    self.arrays = arrays
    self.batch_size = int(batch_size)
    self.shuffle = bool(shuffle)
    self.epochs = int(epochs)
    self.map_fn = map_fn
    self.drop_remainder = bool(drop_remainder)
    self.seed = int(seed)
    self.prefetch = int(prefetch)
    self.to_device = to_device
    self._transfer = device_transfer(to_device)
    self.n = _length_of(arrays)

  def __len__(self) -> int:
    return self.steps_per_epoch * max(self.epochs, 1)

  @property
  def steps_per_epoch(self) -> int:
    return self.n // self.batch_size if self.drop_remainder else \
        -(-self.n // self.batch_size)

  def _gen(self) -> Iterator:
    rng = np.random.RandomState(self.seed)
    epoch = 0
    while self.epochs < 0 or epoch < self.epochs:
      order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
      stop = self.n - (self.n % self.batch_size) if self.drop_remainder \
          else self.n
      for i in range(0, stop, self.batch_size):
        idx = order[i:i + self.batch_size]
        if self.drop_remainder and len(idx) < self.batch_size:
          break
        batch = _index(self.arrays, idx)
        if self.map_fn is not None:
          batch = self.map_fn(batch)
        if self._transfer is not None:
          batch = self._transfer(batch)
        yield batch
      epoch += 1

  def __iter__(self) -> Iterator:
    if self.prefetch <= 0:
      for b in self._gen():
        yield _arrive(b)
      return
    q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
    end = object()
    error = []
    stop = threading.Event()

    def put(item):
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          continue
      return False

    def worker():
      try:
        for b in self._gen():
          if not put(b):
            return
      except Exception as e:  # raised in the consumer
        error.append(e)
      put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
      while True:
        b = q.get()
        if b is end:
          if error:
            raise error[0]
          return
        yield _arrive(b)
    finally:  # the consumer stopped early: let the worker end
      stop.set()
      t.join()

  # -- tf.data-style combinators -----------------------------------------
  def map(self, fn: Callable) -> "DataPipeline":
    prev = self.map_fn
    new_fn = fn if prev is None else (lambda b: fn(prev(b)))
    return self._copy(map_fn=new_fn)

  def repeat(self, epochs: int = -1) -> "DataPipeline":
    return self._copy(epochs=epochs)

  def take(self, n_batches: int):
    it = iter(self)
    for _ in range(n_batches):
      yield next(it)

  def _copy(self, **overrides) -> "DataPipeline":
    kw = dict(arrays=self.arrays, batch_size=self.batch_size,
              shuffle=self.shuffle, epochs=self.epochs, map_fn=self.map_fn,
              drop_remainder=self.drop_remainder, seed=self.seed,
              prefetch=self.prefetch, to_device=self.to_device)
    kw.update(overrides)
    return DataPipeline(**kw)
