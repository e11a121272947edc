"""Host-side parallel job map: a copy of ``odin_tpu/utils/mpi.py:34-137``
(``MPI``, ``async_process``, ``async_thread``, ``SharedCounter``).

The reference's "MPI" (``odin/utils/mpi.py:386``) is a round-robin
multiprocess map used to fan feature-extraction jobs over CPU workers.  Here
it is built on ``multiprocessing`` with the ``fork`` context; with
``ncpu <= 1`` the jobs run inline in the calling process.  A forked worker
inherits the parent's CUDA context but may not use it ("Cannot
re-initialize CUDA in forked subprocess"), so the jobs it runs are host
NumPy work: ``preprocessing.processor.FeatureProcessor`` refuses to fork a
pipeline that holds a stage bound to a CUDA device.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import types
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

__all__ = ["MPI", "async_process", "async_thread", "SharedCounter"]

_WORKER_FN: Optional[Callable] = None


def _init_worker(fn):
  global _WORKER_FN
  _WORKER_FN = fn


def _run_job(batch):
  global _WORKER_FN
  out = _WORKER_FN(batch)
  if isinstance(out, types.GeneratorType):
    return list(out)
  return [out]


class MPI:
  """Map `func` over `jobs` with `ncpu` worker processes, streaming results.

  API parity with the reference (``odin/utils/mpi.py:386-465``): `func`
  receives a *batch* (list) of jobs and may return a value or a generator;
  iterate the `MPI` object to consume results as they complete.  With
  ``ncpu<=1`` everything runs inline in the calling process (no fork), which
  is also the fallback on single-core machines.
  """

  def __init__(self,
               jobs: Sequence[Any],
               func: Callable[[list], Any],
               ncpu: int = 1,
               batch: int = 1,
               ordered: bool = False,
               chunk_scheduler: bool = True):
    self.jobs = list(jobs)
    self.func = func
    self.ncpu = max(1, min(int(ncpu), os.cpu_count() or 1))
    self.batch = max(1, int(batch))
    self.ordered = bool(ordered)

  def __len__(self) -> int:
    return len(self.jobs)

  def _batches(self) -> Iterator[list]:
    for i in range(0, len(self.jobs), self.batch):
      yield self.jobs[i:i + self.batch]

  def __iter__(self) -> Iterator[Any]:
    if self.ncpu <= 1:
      for b in self._batches():
        out = self.func(b)
        if isinstance(out, types.GeneratorType):
          yield from out
        else:
          yield out
      return
    ctx = mp.get_context("fork")
    with ctx.Pool(self.ncpu, initializer=_init_worker, initargs=(self.func,)) as pool:
      mapper = pool.imap if self.ordered else pool.imap_unordered
      for results in mapper(_run_job, self._batches()):
        yield from results

  def run(self) -> List[Any]:
    return list(self)


def async_process(fn: Callable, *args, **kwargs):
  """Run `fn` in a daemon process; returns the Process handle.

  Reference: ``odin/utils/mpi.py:217`` (`async_process`).
  """
  p = mp.get_context("fork").Process(target=fn, args=args, kwargs=kwargs, daemon=True)
  p.start()
  return p


def async_thread(fn: Callable, *args, **kwargs):
  """Run `fn` in a daemon thread; returns an object with `.get()`
  (reference ``utils/mpi.py:164``)."""
  import threading

  class _Future:
    def __init__(self):
      self._result = None
      self._exc = None
      self._thread = threading.Thread(target=self._run, daemon=True)
      self._thread.start()

    def _run(self):
      try:
        self._result = fn(*args, **kwargs)
      except BaseException as e:  # surfaced on .get()
        self._exc = e

    def get(self, timeout=None):
      self._thread.join(timeout)
      if self._exc is not None:
        raise self._exc
      return self._result

    finished = property(lambda self: not self._thread.is_alive())

  return _Future()


class SharedCounter:
  """Process-safe monotonically increasing counter
  (reference ``utils/mpi.py:365-384``)."""

  def __init__(self, initial: int = 0):
    import multiprocessing
    self._value = multiprocessing.Value("i", int(initial))

  def add(self, n: int = 1) -> int:
    with self._value.get_lock():
      self._value.value += int(n)
      return self._value.value

  @property
  def value(self) -> int:
    return self._value.value
