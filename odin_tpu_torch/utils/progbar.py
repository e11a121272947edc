"""Progbar — progress tracking with per-key, per-epoch reports.

Reference: ``odin/utils/progbar.py:90`` — a rich progress bar recording named
values into a per-epoch history (`history`, `get_report`, `set_summarizer`,
`summary`) with timestamped notifications (`add_notification`,
``progbar.py:58,389``).  Here a tqdm-backed equivalent: when `seen` reaches
`target`, the epoch rolls over and the tracked values are summarized (mean
for scalars, sum for arrays, or a user summarizer per key).

The port's copy of the JAX package's ``odin_tpu/utils/progbar.py``, which
imports no JAX.
"""
from __future__ import annotations

import time
from collections import defaultdict
from datetime import datetime
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["Progbar", "add_notification"]


def _write(msg: str):
  try:
    from tqdm import tqdm
    tqdm.write(msg)
  except ImportError:
    print(msg, flush=True)


def add_notification(msg: str):
  """Module-level timestamped notification (reference ``progbar.py:58``)."""
  _write(f"[{datetime.now().strftime('%d/%b-%H:%M:%S')}]Notification:{msg}")


class Progbar:

  def __init__(self, target: Optional[int] = None, name: str = "",
               print_report: bool = True, interval: float = 1.0,
               unit: str = "it"):
    self.target = target
    self.name = name
    self.print_report = print_report
    self.interval = float(interval)
    self.seen = 0
    self._start = time.time()
    self._epoch_start = time.time()
    self._last_print = 0.0
    self._epoch_idx = 0
    # epoch -> key -> [values]  (reference `history`, ``progbar.py:247``)
    self._epoch_hist: Dict[int, Dict[str, list]] = defaultdict(
        lambda: defaultdict(list))
    self._epoch_summary: Dict[int, Dict[str, Any]] = defaultdict(dict)
    self._summarizers: Dict[str, Callable] = {}
    self._labels = None
    try:
      from tqdm import tqdm
      self._bar = tqdm(total=target, desc=name, unit=unit,
                       disable=not print_report)
    except ImportError:
      self._bar = None

  # -- history --------------------------------------------------------------
  @property
  def epoch_idx(self) -> int:
    return self._epoch_idx

  @property
  def nb_epoch(self) -> int:
    return self._epoch_idx + 1

  @property
  def history(self) -> Dict[int, Dict[str, list]]:
    """{epoch: {key: [value, ...]}} (reference ``progbar.py:247``)."""
    return self._epoch_hist

  @property
  def _values(self) -> Dict[str, list]:
    # current-epoch values (kept for backward compatibility)
    return self._epoch_hist[self._epoch_idx]

  def add_value(self, key: str, value: Any) -> "Progbar":
    v = float(value) if np.isscalar(value) else value
    self._epoch_hist[self._epoch_idx][key].append(v)
    return self

  def __setitem__(self, key, value):
    self.add_value(key, value)

  def __getitem__(self, key):
    vals = self._epoch_hist[self._epoch_idx][key]
    return vals[-1] if vals else None

  def set_summarizer(self, key: str, fn: Callable) -> "Progbar":
    """Per-key epoch summarizer: values-list -> summary
    (reference ``progbar.py:272``)."""
    if not callable(fn):
      raise ValueError("`fn` must be callable")
    self._summarizers[str(key)] = fn
    return self

  def set_name(self, name: str) -> "Progbar":
    self.name = str(name)
    return self

  def set_labels(self, labels) -> "Progbar":
    self._labels = None if labels is None else tuple(map(str, labels))
    return self

  @property
  def labels(self):
    return self._labels

  # -- progress -------------------------------------------------------------
  def add(self, n: int = 1, **values) -> "Progbar":
    for k, v in values.items():
      self.add_value(k, v)
    self.seen += n
    if self._bar is not None:
      self._bar.update(n)
      now = time.time()
      if now - self._last_print >= self.interval and self._values:
        self._bar.set_postfix(
            {k: f"{v[-1]:.4g}" for k, v in self._values.items()
             if v and np.isscalar(v[-1])})
        self._last_print = now
    if self.target is not None and self.seen >= self.target:
      self._new_epoch()
    return self

  update = add

  def _new_epoch(self):
    """Summarize the finished epoch and roll over
    (reference ``progbar.py:396-443``): user summarizer per key, else mean
    for numbers, elementwise sum for arrays."""
    ep = self._epoch_idx
    for key, values in self._epoch_hist[ep].items():
      if key in self._summarizers:
        self._epoch_summary[ep][key] = self._summarizers[key](list(values))
      elif values and np.isscalar(values[0]):
        self._epoch_summary[ep][key] = float(np.mean(values))
      elif values and isinstance(values[0], np.ndarray):
        self._epoch_summary[ep][key] = sum(v for v in values)
    total = time.time() - self._epoch_start
    self._epoch_summary[ep]["__total_time__"] = total
    self._epoch_summary[ep]["__avg_time__"] = total / max(self.seen, 1)
    self._epoch_idx += 1
    self.seen = 0
    self._epoch_start = time.time()
    if self._bar is not None:
      self._bar.reset(total=self.target)

  @property
  def throughput(self) -> float:
    # per-epoch rate: `seen` resets at each rollover, and so does the
    # denominator
    return self.seen / max(time.time() - self._epoch_start, 1e-9)

  # -- reports --------------------------------------------------------------
  def get_report(self, epoch: int = -1, key: Optional[str] = None):
    """Raw recorded values of one epoch (reference ``progbar.py:266``)."""
    if epoch < 0:
      # reference semantics (``progbar.py:266``): -1 is the last FINISHED
      # epoch (the current epoch_idx is in progress); clamp at 0 so a
      # bar that never rolled over still reports its own values
      epoch = max(self.nb_epoch + epoch - 1, 0)
    hist = self._epoch_hist[epoch]
    return dict(hist) if key is None else list(hist[key])

  def report(self) -> Dict[str, float]:
    """Mean of every scalar tracked this epoch (falls back to the last
    finished epoch right after a rollover)."""
    vals = self._values
    if not vals and self._epoch_idx > 0:
      vals = self._epoch_hist[self._epoch_idx - 1]
    return {k: float(np.mean(v)) for k, v in vals.items()
            if v and np.isscalar(v[0])}

  @property
  def summary(self) -> str:
    """Formatted per-epoch summaries (reference ``progbar.py:380``)."""
    lines = [f'Report "{self.name}"    TotalEpoch: {self.nb_epoch}']
    for ep in sorted(self._epoch_summary):
      s = dict(self._epoch_summary[ep])
      total = s.pop("__total_time__", 0.0)
      avg = s.pop("__avg_time__", None)
      speed = (1.0 / avg) if avg else 0.0
      lines.append(f" Epoch {ep} {total:.4f}(s) {speed:.4f}(obj/s)")
      for k, v in s.items():
        v = f"{v:.4g}" if isinstance(v, float) else str(v)
        lines.append(f"   {k}: {v}")
    return "\n".join(lines)

  def add_notification(self, msg: str) -> "Progbar":
    """Timestamped out-of-band message that doesn't corrupt the bar
    (reference ``progbar.py:389``)."""
    stamp = datetime.now().strftime("%d/%b-%H:%M:%S")
    _write(f"[{stamp}][{self.name}]Notification:{msg}")
    return self

  def close(self):
    if self._bar is not None:
      self._bar.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
