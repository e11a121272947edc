"""Training callbacks: keeping the best weights and wiring early stopping
into ``Trainer.fit`` (PyTorch port of ``odin_tpu/training/callbacks.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from odin_tpu_torch.training.core import (TrainState, state_from_host,
                                          state_to_host)
from odin_tpu_torch.training.early_stopping import EarlyStopping

__all__ = ["BestWeights", "early_stopping_callback", "Callback"]


class BestWeights:
  """`on_valid_end` hook: keep the state of the best validation metric as a
  copy on the host; restore it on demand, or by itself when the metric
  regresses by more than `restore_margin`.  A rollback keeps the live
  ``step`` and noise generator, as in the JAX package."""

  def __init__(self, metric: str = "loss", mode: str = "min",
               restore_margin: Optional[float] = None):
    self.metric = metric
    self.sign = 1.0 if mode == "min" else -1.0
    self.restore_margin = restore_margin
    self.best_value: float = np.inf
    self.best_state: Optional[Dict[str, Any]] = None  # ``state_to_host``
    self.device = None  # the device the best state was kept from

  def __call__(self, trainer, state: TrainState,
               valid_metrics: Dict[str, float]):
    value = self.sign * float(valid_metrics.get(self.metric, np.inf))
    if value < self.best_value:
      self.best_value = value
      self.best_state = state_to_host(state)
      self.device = state.device
      return None
    if self.restore_margin is not None and self.best_state is not None and \
        value > self.best_value + self.restore_margin:
      # roll back to the best weights
      return state_from_host(self.best_state, state.device).replace(
          step=state.step, rng=state.rng)
    return None

  def restore(self) -> Optional[TrainState]:
    """The best state, on the device it was kept from."""
    if self.best_state is None:
      return None
    return state_from_host(self.best_state, self.device)


def early_stopping_callback(early_stopper: EarlyStopping,
                            metric: str = "loss",
                            best_weights: Optional[BestWeights] = None):
  """Wire an ``EarlyStopping`` criterion into ``Trainer.fit``'s
  `on_valid_end`: terminates training on signal +1; with `best_weights`,
  keeps and restores the best state."""

  def hook(trainer, state, valid_metrics):
    signal = early_stopper.update(float(valid_metrics.get(metric, np.inf)))
    if best_weights is not None:
      out = best_weights(trainer, state, valid_metrics)
      if out is not None:
        return out
    if signal > 0:
      trainer.terminate()
    return None

  return hook


class Callback:
  """Minimal callback base: subclass and override the hooks; an instance is
  also a ``Trainer.fit(callbacks=[...])`` entry through ``__call__``."""

  def on_batch_end(self, trainer, state, metrics):
    return None

  def on_valid_end(self, trainer, state, valid_metrics):
    return None

  def __call__(self, trainer, state, valid_metrics):
    return self.on_valid_end(trainer, state, valid_metrics)
