"""Host-side training loop (PyTorch port of ``odin_tpu/training/trainer.py``).

``Trainer.fit`` pumps batches into the training step, logs, validates,
runs callbacks and checkpoints.  The step runs as ``scan_steps(step_fn,
k)`` with ``k = steps_per_call``: on the card one call replays a CUDA graph
of one step k times (k = 1 included, as ``jax.jit`` makes each step one
compiled call), with the state's buffers donated from call to call; a
capture or a copy that fails raises, and nothing falls back to eager steps
or to the CPU.  For k > 1 the k host batches are stacked and copied to the
card at once; batches already on the card are stacked there.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from odin_tpu_torch.training.core import (TrainState, _clone_state,
                                          scan_steps, state_from_host,
                                          state_to_host)

__all__ = ["Trainer", "get_current_trainer", "read_tensorboard"]

_CURRENT_TRAINER: Optional["Trainer"] = None


def get_current_trainer() -> Optional["Trainer"]:
  """The trainer whose ``fit`` is running, if any."""
  return _CURRENT_TRAINER


def _to_float(tree) -> Dict[str, float]:
  return {k: float(v) for k, v in tree.items()}


def _stack(batches, device: torch.device):
  """k batches (numpy or tensors, in tuples or dicts) as one batch with a
  leading axis of k on `device`: tensors are stacked where they are; host
  arrays are stacked on the host and copied once, pinned and
  ``non_blocking`` where `device` is the card."""
  first = batches[0]
  if isinstance(first, dict):
    return {k: _stack([b[k] for b in batches], device) for k in first}
  if isinstance(first, (tuple, list)):
    return type(first)(_stack([b[i] for b in batches], device)
                       for i in range(len(first)))
  if isinstance(first, torch.Tensor):
    return torch.stack([b.to(device) for b in batches])
  x = torch.from_numpy(np.ascontiguousarray(
      np.asarray(first)[None] if len(batches) == 1 else np.stack(batches)))
  if device.type == "cuda":
    return x.pin_memory().to(device, non_blocking=True)
  return x


def read_tensorboard(logdir: str) -> Dict[str, List]:
  """A run's logged scalars as {tag: [(step, value), ...]}, from its
  ``log.jsonl``."""
  out: Dict[str, List] = {}
  with open(os.path.join(logdir, "log.jsonl")) as f:
    for line in f:
      row = json.loads(line)
      step = row.get("step", len(out))
      for k, v in row.items():
        if k in ("step", "time") or not isinstance(v, (int, float)):
          continue
        out.setdefault(k, []).append((int(step), float(v)))
  return out


class Trainer:
  """Drive a training step over a dataset.

  Args:
    logdir: directory for the ``log.jsonl`` records and checkpoints (and
      TensorBoard events where ``torch.utils.tensorboard`` imports).
    logging_interval: seconds between logged records.
    log_tag: the tag of printed lines.
    use_tensorboard: write TensorBoard events beside ``log.jsonl``.
  """

  def __init__(self,
               logdir: Optional[str] = None,
               logging_interval: float = 5.0,
               log_tag: str = "",
               use_tensorboard: bool = True):
    self.logdir = logdir
    if logdir is not None:
      os.makedirs(logdir, exist_ok=True)
    self.logging_interval = float(logging_interval)
    self.log_tag = log_tag
    self._terminate = False
    self.history: List[Dict[str, float]] = []
    self.valid_history: List[Dict[str, float]] = []
    self._log_file = None
    self._tb_writer = None
    self.use_tensorboard = use_tensorboard and logdir is not None
    self.last_metrics: Dict[str, float] = {}
    self.step = 0
    self._trace_remaining = 0
    self._ckpt_thread: Optional[threading.Thread] = None
    self._ckpt_error: Optional[BaseException] = None
    self.total_time = 0.0  # of the last fit, and its graph capture's share
    self.capture_seconds: Optional[float] = None

  # -- logging ------------------------------------------------------------
  def _open_logs(self):
    if self.logdir is None:
      return
    if self._log_file is None:
      self._log_file = open(os.path.join(self.logdir, "log.jsonl"), "a")
    if self.use_tensorboard and self._tb_writer is None:
      try:
        from torch.utils.tensorboard import SummaryWriter
      except ImportError:  # no tensorboard package: log.jsonl alone
        self.use_tensorboard = False
      else:
        self._tb_writer = SummaryWriter(self.logdir)

  def _close_logs(self):
    for f in (self._log_file, self._tb_writer):
      if f is not None:
        f.close()
    self._log_file = self._tb_writer = None

  def _log(self, metrics: Dict[str, float], step: int, prefix: str = "train"):
    rec = {"step": step, "time": time.time(), "tag": prefix, **metrics}
    (self.history if prefix == "train" else self.valid_history).append(rec)
    if self.logdir is not None:
      self._open_logs()
      self._log_file.write(json.dumps(rec) + "\n")
      self._log_file.flush()
      if self._tb_writer is not None:
        for k, v in metrics.items():
          self._tb_writer.add_scalar(f"{prefix}/{k}", v, step)
        self._tb_writer.flush()

  def terminate(self):
    """Stop training after the current call."""
    self._terminate = True

  # -- profiling ------------------------------------------------------------
  def trace(self, n_steps: int = 5):
    """Trace the next `n_steps` steps with ``torch.profiler`` (the card's
    kernels too, where there is one), written as a Chrome trace to
    ``<logdir>/profile``."""
    if self.logdir is None:
      raise ValueError("trace requires a logdir")
    self._trace_remaining = int(n_steps)
    return self

  def _start_trace(self):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
      activities.append(torch.profiler.ProfilerActivity.CUDA)
    self._profiler = torch.profiler.profile(activities=activities)
    self._profiler.__enter__()

  def _stop_trace(self, step: int):
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    self._profiler.__exit__(None, None, None)
    out = os.path.join(self.logdir, "profile")
    os.makedirs(out, exist_ok=True)
    self._profiler.export_chrome_trace(
        os.path.join(out, f"trace_step{step}.json"))
    self._profiler = None

  # -- checkpoints --------------------------------------------------------
  def save_checkpoint(self, state: TrainState, path: Optional[str] = None,
                      blocking: bool = True) -> str:
    """One pickle of the whole state (``state_to_host``: params, optimizer
    states, step, skipped updates, mutables and the noise generator's
    state), written to ``path + '.tmp'`` and renamed into place.

    ``blocking=False``: the state is copied on the device and its
    generator's state read now; the copy to the host, the pickle and the
    rename run on a writer thread while training goes on.  One writer at a
    time; ``wait_for_checkpoint()`` joins it (``fit`` does so before it
    returns, also when the loop raises).  A save requested at step N is on
    disk only once the writer is joined."""
    path = path or os.path.join(self.logdir, "checkpoint")

    def _write(host):
      with open(path + ".tmp", "wb") as f:
        pickle.dump(host, f)
      os.replace(path + ".tmp", path)

    if blocking:
      _write(state_to_host(state))
      return path
    snap = _clone_state(state)
    rng_state = state.rng.get_state()
    self.wait_for_checkpoint()  # one writer at a time; raises its failure

    def _run():
      try:
        host = state_to_host(snap)
        host["rng_state"] = rng_state
        _write(host)
      except Exception as e:  # raised by wait_for_checkpoint()
        self._ckpt_error = e

    self._ckpt_thread = threading.Thread(target=_run, daemon=True)
    self._ckpt_thread.start()
    return path

  def wait_for_checkpoint(self):
    """Join the writer of a non-blocking checkpoint, if any, and raise what
    it failed with, so that a failed save never passes silently."""
    t = self._ckpt_thread
    if t is not None:
      t.join()
      self._ckpt_thread = None
    err = self._ckpt_error
    if err is not None:
      self._ckpt_error = None
      raise RuntimeError("async checkpoint write failed") from err

  def restore_checkpoint(self, path: Optional[str] = None
                         ) -> Optional[TrainState]:
    """The state of a checkpoint, on the device it was saved from, or None
    where there is none."""
    path = path or (os.path.join(self.logdir, "checkpoint")
                    if self.logdir else None)
    if path is None or not os.path.exists(path):
      return None
    with open(path, "rb") as f:
      host = pickle.load(f)
    return state_from_host(host, host["device"])

  def save_checkpoint_orbax(self, state: TrainState,
                            directory: Optional[str] = None,
                            step: Optional[int] = None):
    raise NotImplementedError("sharded (orbax) checkpoints are not ported "
                              "yet; they come with the parallelism work")

  def restore_checkpoint_orbax(self, template: TrainState,
                               directory: Optional[str] = None,
                               step: Optional[int] = None):
    raise NotImplementedError("sharded (orbax) checkpoints are not ported "
                              "yet; they come with the parallelism work")

  # -- main loop ------------------------------------------------------------
  def fit(self,
          train_ds,
          step_fn,
          state: TrainState,
          valid_ds=None,
          valid_interval: float = 0.0,
          valid_freq: int = 0,
          eval_fn: Optional[Callable] = None,
          max_iter: int = -1,
          callbacks: Sequence[Callable] = (),
          on_valid_end: Sequence[Callable] = (),
          checkpoint_freq: int = 0,
          mesh=None,
          steps_per_call: int = 1,
          verbose: bool = True) -> TrainState:
    """Run the loop; returns the final state (a copy of its own, on the
    state's device).

    `step_fn` is a training step (``build_train_step_fn``, a model's
    ``make_step_fn``).  `eval_fn(state, batch) -> metrics` evaluates a
    validation batch.  `callbacks(trainer, state, metrics)` run at each
    logged record, and a dict they return is logged with it.
    `on_valid_end(trainer, state, valid_metrics)` may return a state that
    replaces the live one (``BestWeights``' rollback).  Logging,
    validation and checkpoints happen at call granularity, every
    `steps_per_call` steps.  A state handed to a callback is the step's
    own buffer, good until the next call (copy it to keep it).
    """
    global _CURRENT_TRAINER
    if mesh is not None:
      raise NotImplementedError("a mesh is not ported yet: the port trains "
                                "on one device")
    if not hasattr(step_fn, "run"):
      raise TypeError("fit takes a training step made by "
                      "build_train_step_fn or a model's make_step_fn")
    _CURRENT_TRAINER = self
    self._terminate = False
    device = state.device
    k = max(int(steps_per_call), 1)
    fused = scan_steps(step_fn, k, donate=True)
    last_log = time.time()
    it = 0
    t_start = time.time()
    steps_since_log = 0
    tracing = False
    buf = []
    try:
      for _ in range(1 << 30):
        for batch in train_ds:
          buf.append(batch)
          if len(buf) < k:
            continue
          batches, buf = _stack(buf, device), []
          if self._trace_remaining > 0 and not tracing:
            self._start_trace()
            tracing = True
          state, metrics = fused(state, batches)
          if tracing:
            self._trace_remaining -= k
            if self._trace_remaining <= 0:
              self._stop_trace(it + k)
              tracing = False
          it += k
          steps_since_log += k
          now = time.time()
          if now - last_log >= self.logging_interval or it == max_iter or \
              it == 1:
            m = _to_float(metrics)
            m["steps_per_sec"] = steps_since_log / max(now - last_log, 1e-9)
            for cb in callbacks:
              out = cb(self, state, m)
              if isinstance(out, dict):
                m.update(_to_float(out))
            self.last_metrics = m
            self.step = it
            self._log(m, it)
            if verbose:
              msg = " ".join(f"{n}:{v:.4g}" for n, v in m.items())
              print(f"[{self.log_tag or 'train'}] #{it} {msg}", flush=True)
            last_log, steps_since_log = now, 0
            if m.get("nan_gradients", 0) > 0:
              print("[trainer] non-finite gradients - stopping", flush=True)
              self._terminate = True
          if valid_ds is not None and eval_fn is not None and (
              (valid_freq > 0 and it % valid_freq == 0) or
              (valid_interval > 0 and now - getattr(self, "_last_valid", 0)
               >= valid_interval)):
            self._last_valid = now
            vm = self.validate(valid_ds, eval_fn, state)
            self._log(vm, it, prefix="valid")
            if verbose:
              msg = " ".join(f"{n}:{v:.4g}" for n, v in vm.items())
              print(f"[valid] #{it} {msg}", flush=True)
            for cb in on_valid_end:
              out = cb(self, state, vm)
              if isinstance(out, TrainState):
                state = out
          if checkpoint_freq > 0 and self.logdir and \
              it % checkpoint_freq == 0:
            self.save_checkpoint(state, blocking=False)
          if self._terminate or (0 < max_iter <= it):
            break
        if self._terminate or (0 < max_iter <= it):
          break
    finally:
      # join the checkpoint writer also when the loop raises, so that it
      # is never killed mid-write at exit; its failure is raised, but never
      # in place of an exception already on its way
      if tracing:
        self._stop_trace(it)
      self.total_time = time.time() - t_start
      self.capture_seconds = fused.capture_seconds
      self._close_logs()
      _CURRENT_TRAINER = None
      if sys.exc_info()[0] is None:
        self.wait_for_checkpoint()
      else:
        try:
          self.wait_for_checkpoint()
        except Exception as ckpt_err:
          print(f"[trainer] async checkpoint write failed during teardown: "
                f"{ckpt_err!r}", flush=True)
    return _clone_state(state)

  def validate(self, valid_ds, eval_fn, state, mesh=None) -> Dict[str, float]:
    """`eval_fn`'s metrics averaged over the validation batches."""
    if mesh is not None:
      raise NotImplementedError("a mesh is not ported yet")
    totals: Dict[str, float] = {}
    n = 0
    for batch in valid_ds:
      m = eval_fn(state, batch)
      for k, v in m.items():
        totals[k] = totals.get(k, 0.0) + float(v)
      n += 1
    return {k: v / max(n, 1) for k, v in totals.items()}

  # -- introspection --------------------------------------------------------
  def read_logs(self) -> List[Dict[str, float]]:
    """The records of ``log.jsonl``."""
    path = os.path.join(self.logdir, "log.jsonl")
    with open(path) as f:
      return [json.loads(line) for line in f]

  def plot_learning_curves(self, path: Optional[str] = None,
                           smooth: float = 0.6):
    """EMA-smoothed learning curves, one panel a metric, saved as a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    logs = self.history or self.read_logs()
    keys = sorted({k for rec in logs for k in rec
                   if k not in ("step", "time", "tag")})
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3.2),
                             squeeze=False)
    for ax, key in zip(axes[0], keys):
      xs = [r["step"] for r in logs if key in r]
      ys = [r[key] for r in logs if key in r]
      if smooth > 0 and len(ys) > 2:
        ema, out = ys[0], []
        for y in ys:
          ema = smooth * ema + (1 - smooth) * y
          out.append(ema)
        ax.plot(xs, ys, alpha=0.25)
        ax.plot(xs, out)
      else:
        ax.plot(xs, ys)
      ax.set_title(key)
    fig.tight_layout()
    path = path or os.path.join(self.logdir, "learning_curves.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
