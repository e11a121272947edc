"""Extractor pipeline framework (host NumPy): a copy of
``odin_tpu/preprocessing/base.py``.

Reference: ``odin/preprocessing/base.py`` — sklearn-style `Extractor`
(:175) stages exchanging a feature dict with input_name/output_name routing,
`make_pipeline` (:96), `ExtractorSignal` error protocol (:23), and the
generic stages (`Converter`, `DeltaExtractor` :433, `EqualizeShape0`,
`RunningStatistics` :556, `AsType`, `Duplicate/Rename/Delete/StackFeatures`
:616-724).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from odin_tpu_torch.preprocessing import signal as S
from odin_tpu_torch.utils import as_tuple

__all__ = [
    "ExtractorSignal", "Extractor", "make_pipeline", "Pipeline", "Converter",
    "DeltaExtractor", "EqualizeShape0", "RunningStatistics", "AsType",
    "Duplicate", "Rename", "Delete", "StackFeatures",
]


class ExtractorSignal(Exception):
  """Control-flow signal raised by extractors (reference ``base.py:23-94``):
  `action` in {'warn', 'ignore', 'error'} decides how the pipeline/processor
  reacts."""

  def __init__(self, message: str = "", action: str = "error",
               last_input: Any = None, extractor: Optional["Extractor"] = None):
    super().__init__(message)
    self.message = message
    self.action = str(action)
    self.last_input = last_input
    self.extractor = extractor

  def set_message(self, message):
    self.message = message
    return self

  def set_action(self, action):
    self.action = str(action)
    return self


class Extractor:
  """One pipeline stage: consumes and produces a feature dict.

  Subclasses implement `_transform(feat_dict) -> dict-update or array`.
  `input_name`/`output_name` route which dict keys are read/written
  (reference ``base.py:175``).
  """

  def __init__(self,
               input_name: Union[str, Sequence[str], None] = None,
               output_name: Union[str, Sequence[str], None] = None):
    self.input_name = as_tuple(input_name) if input_name is not None else None
    self.output_name = as_tuple(output_name) if output_name is not None else None

  @property
  def name(self) -> str:
    return type(self).__name__

  def _inputs(self, feat: Dict[str, Any]):
    if self.input_name is None:
      return feat
    return tuple(feat[k] for k in self.input_name)

  def _transform(self, X):
    raise NotImplementedError

  def transform(self, X) -> Dict[str, Any]:
    if not isinstance(X, dict):
      X = {"raw": X}
    inputs = self._inputs(X)
    out = self._transform(inputs if self.input_name is not None else X)
    if isinstance(out, ExtractorSignal):
      raise out
    feat = dict(X)
    if isinstance(out, dict):
      feat.update(out)
    elif out is not None:
      names = self.output_name or (self.name.lower(),)
      if len(names) == 1:
        feat[names[0]] = out
      else:
        for k, v in zip(names, out):
          feat[k] = v
    return feat

  # sklearn API parity
  def fit(self, X, y=None):
    return self

  def __call__(self, X):
    return self.transform(X)

  def __repr__(self):
    return (f"{self.name}(input={self.input_name}, "
            f"output={self.output_name})")


class Pipeline:
  """Chain of extractors (reference `make_pipeline`, ``base.py:96``)."""

  def __init__(self, steps: Sequence[Extractor],
               debug: Optional[bool] = None):
    self.steps = list(steps)
    self.debug = _DEBUG_DEFAULT[0] if debug is None else bool(debug)

  def transform(self, X) -> Dict[str, Any]:
    feat = X if isinstance(X, dict) else {"raw": X}
    for step in self.steps:
      feat = step.transform(feat)
      if self.debug:
        shapes = {k: getattr(v, "shape", type(v).__name__)
                  for k, v in feat.items()}
        print(f"[{step.name}] {shapes}")
    return feat

  def __call__(self, X):
    return self.transform(X)


def make_pipeline(steps: Sequence[Extractor],
                  debug: Optional[bool] = None) -> Pipeline:
  flat = []
  for s in steps:
    if isinstance(s, Pipeline):
      flat.extend(s.steps)
    elif isinstance(s, Extractor):
      flat.append(s)
    elif callable(s):
      flat.append(Converter(s))
    else:
      raise ValueError(f"cannot interpret pipeline step: {s!r}")
  return Pipeline(flat, debug=debug)


# ---------------------------------------------------------------------------
# generic stages
# ---------------------------------------------------------------------------
class Converter(Extractor):
  """Apply an arbitrary function (reference ``base.py``)."""

  def __init__(self, converter: Callable, input_name=None, output_name=None):
    super().__init__(input_name, output_name)
    self.converter = converter

  def _transform(self, X):
    if self.input_name is not None and len(self.input_name) == 1:
      X = X[0]
    return self.converter(X)


class DeltaExtractor(Extractor):
  """Append order-(1..n) deltas along the feature axis
  (reference ``base.py:433``)."""

  def __init__(self, input_name=("mspec",), width: int = 9, order=(0, 1),
               axis: int = 0):
    super().__init__(input_name=input_name)
    self.width = int(width)
    self.order = as_tuple(order, t=int)
    self.axis = int(axis)

  def _transform(self, X):
    out = {}
    max_order = max(self.order)
    for name, x in zip(self.input_name, X):
      feats = [x] if 0 in self.order else []
      if max_order > 0:
        deltas = S.delta(x, width=self.width, order=max_order, axis=self.axis)
        deltas = [deltas] if max_order == 1 else deltas
        for o, d in enumerate(deltas, start=1):
          if o in self.order:
            feats.append(d)
      out[name] = np.concatenate(feats, axis=-1) if len(feats) > 1 else feats[0]
    return out


class EqualizeShape0(Extractor):
  """Trim all named features to the same length along axis 0."""

  def __init__(self, input_name):
    super().__init__(input_name=input_name)

  def _transform(self, X):
    arrays = [x for x in X if x is not None]
    n = min(len(a) for a in arrays)
    return {k: (x[:n] if x is not None else None)
            for k, x in zip(self.input_name, X)}


class RunningStatistics(Extractor):
  """Accumulate sum1/sum2 for corpus-level CMVN
  (reference ``base.py:556``)."""

  def __init__(self, input_name, axis: int = 0, prefix: str = ""):
    super().__init__(input_name=input_name)
    self.axis = int(axis)
    self.prefix = prefix

  def _transform(self, X):
    out = {}
    for name, x in zip(self.input_name, X):
      out[f"{self.prefix}{name}_sum1"] = np.sum(x, axis=self.axis)
      out[f"{self.prefix}{name}_sum2"] = np.sum(x ** 2, axis=self.axis)
    return out


class AsType(Extractor):

  def __init__(self, dtype="float32", input_name=None):
    super().__init__(input_name=input_name)
    self.dtype = dtype

  def _transform(self, X):
    if self.input_name is None:
      return {k: (v.astype(self.dtype) if isinstance(v, np.ndarray) else v)
              for k, v in X.items()}
    return {k: x.astype(self.dtype) for k, x in zip(self.input_name, X)}


class Duplicate(Extractor):

  def __init__(self, input_name, output_name):
    super().__init__(input_name=input_name, output_name=output_name)

  def _transform(self, X):
    return {o: np.array(x, copy=True)
            for o, x in zip(self.output_name, X)}


class Rename(Extractor):

  def __init__(self, mapping: Dict[str, str]):
    super().__init__()
    self.mapping = dict(mapping)

  def _transform(self, X):
    out = dict(X)
    for old, new in self.mapping.items():
      if old in out:
        out[new] = out.pop(old)
    return out

  def transform(self, X):
    if not isinstance(X, dict):
      X = {"raw": X}
    return self._transform(X)


class Delete(Extractor):

  def __init__(self, input_name):
    super().__init__(input_name=None)
    self.delete_names = as_tuple(input_name)

  def transform(self, X):
    if not isinstance(X, dict):
      X = {"raw": X}
    return {k: v for k, v in X.items() if k not in self.delete_names}


class StackFeatures(Extractor):
  """Stack context frames (reference ``base.py:724`` / `stack_frames`,
  ``signal.py:1225``)."""

  def __init__(self, input_name, context: int = 4):
    super().__init__(input_name=input_name)
    self.context = int(context)

  def _transform(self, X):
    out = {}
    c = self.context
    for name, x in zip(self.input_name, X):
      pads = [x]
      for k in range(1, c + 1):
        pads.insert(0, np.pad(x, ((k, 0), (0, 0)), mode="edge")[:len(x)])
        pads.append(np.pad(x, ((0, k), (0, 0)), mode="edge")[k:])
      out[name] = np.concatenate(pads, axis=-1)
    return out


_DEBUG_DEFAULT = [False]


def set_extractor_debug(debug: bool) -> None:
  """Global default for new pipelines' debug mode (reference
  ``odin/preprocessing`` `set_extractor_debug`); existing pipelines keep
  their own flag."""
  _DEBUG_DEFAULT[0] = bool(debug)


# reference names for the feature-dict stages (``base.py:668,682,703``)
DuplicateFeatures = Duplicate
RenameFeatures = Rename
DeleteFeatures = Delete
__all__ += ["DuplicateFeatures", "RenameFeatures", "DeleteFeatures"]
