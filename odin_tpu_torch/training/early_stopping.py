"""Early stopping with generalization-loss / progress criteria (a copy of
``odin_tpu/training/early_stopping.py``, host NumPy): tracks a smoothed
loss history and returns a signal in {-1, 0, +1}: -1 = new best (save
weights), 0 = keep going, +1 = stop (patience exhausted).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["EarlyStopping", "exponential_moving_average"]


def exponential_moving_average(x, w: float) -> np.ndarray:
  """``s[0] = x[0]``, ``s[t] = w * x[t] + (1 - w) * s[t-1]``."""
  x = np.asarray(x, np.float64)
  s = np.empty_like(x)
  if len(x) == 0:
    return s
  s[0] = x[0]
  for t in range(1, len(x)):
    s[t] = w * x[t] + (1.0 - w) * s[t - 1]
  return s


class EarlyStopping:

  def __init__(self,
               min_improvement: float = 0.0,
               warmup_epochs: int = 2,
               patience: int = 5,
               reward: float = 0.5,
               progression_length: int = 5,
               mode: str = "min",
               smooth: float = 0.4):
    self.min_improvement = float(min_improvement)
    self.warmup_epochs = int(warmup_epochs)
    self.patience = int(patience)
    self.init_patience = int(patience)
    self.reward = float(reward)
    self.progression_length = int(progression_length)
    assert mode in ("min", "max")
    self.mode = mode
    self.smooth = float(smooth)
    self.losses: List[float] = []
    self._smoothed: List[float] = []

  @property
  def best(self) -> Optional[float]:
    return min(self._smoothed) if self._smoothed else None

  def update(self, value: float) -> int:
    """Record a validation loss; return -1 (best), 0 (continue), +1 (stop)."""
    value = float(value)
    if self.mode == "max":
      value = -value
    self.losses.append(value)
    if self._smoothed:
      value = self.smooth * self._smoothed[-1] + (1 - self.smooth) * value
    self._smoothed.append(value)
    if len(self._smoothed) <= max(self.warmup_epochs, 1):
      return 0  # need at least one previous point for the comparison
    hist = np.asarray(self._smoothed)
    best = hist[:-1].min()
    current = hist[-1]
    improvement = best - current
    if improvement > self.min_improvement:
      # reward patience on improvement
      self.patience = min(self.patience + self.reward, self.init_patience)
      return -1
    # progress: are recent losses still trending down?
    k = min(self.progression_length, len(hist))
    recent = hist[-k:]
    progressing = recent[-1] < recent[0]
    if not progressing:
      self.patience -= 1
    if self.patience <= 0:
      return 1
    return 0

  def __call__(self, value: float) -> int:
    return self.update(value)
