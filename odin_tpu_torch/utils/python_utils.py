"""Generic Python containers and predicates.

Reference: ``odin/utils/python_utils.py`` — small data-structure helpers
used across the framework: attribute-dict `struct`, bidirectional `bidict`,
key-aware `defaultdictkey`, bounded `fifodict`, `multikeysdict`,
`partialclass`, `IndexedList`, datetime formatting, and `is_*` predicates.

The port's copy of the JAX package's ``odin_tpu/utils/python_utils.py``, which
imports no JAX.
"""
from __future__ import annotations

import datetime
import functools
import inspect
import numbers
import os
import pickle
from collections import defaultdict
from typing import Any, Callable, List

import numpy as np

__all__ = ["struct", "bidict", "defaultdictkey", "fifodict", "multikeysdict",
           "partialclass", "IndexedList", "get_formatted_datetime",
           "get_function_arguments", "is_lambda", "is_pickleable",
           "is_number", "is_string", "is_bool", "is_primitive", "is_path"]


class struct(dict):
  """Dict whose items are also attributes (reference
  ``python_utils.py:99``)."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    for key, value in self.items():
      if isinstance(key, str) and not hasattr(self, key):
        super().__setattr__(key, value)

  def __setattr__(self, name, value):
    super().__setattr__(name, value)
    super().__setitem__(name, value)

  def __setitem__(self, key, value):
    super().__setitem__(key, value)
    if isinstance(key, str):
      super().__setattr__(key, value)

  def __getattr__(self, name):
    try:
      return self[name]
    except KeyError as e:
      raise AttributeError(name) from e


class bidict(dict):
  """Bi-directional dict: missing forward keys fall back to the inverse
  mapping (reference ``python_utils.py:119``)."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self._inv = {v: k for k, v in self.items()}

  @property
  def inv(self) -> dict:
    return self._inv

  def __setitem__(self, key, value):
    super().__setitem__(key, value)
    self._inv[value] = key

  def __getitem__(self, key):
    if key not in self:
      return self._inv[key]
    return super().__getitem__(key)

  def update(self, *args, **kwargs):
    for k, v in dict(*args, **kwargs).items():
      self[k] = v

  def __delitem__(self, key):
    del self._inv[super().__getitem__(key)]
    super().__delitem__(key)


class defaultdictkey(defaultdict):
  """defaultdict whose factory receives the missing KEY (reference
  ``python_utils.py:158``): ``defaultdictkey(str)['ab'] == 'ab'``."""

  def __missing__(self, key):
    if self.default_factory is None:
      raise KeyError(key)
    value = self[key] = self.default_factory(key)
    return value


class fifodict(dict):
  """Dict evicting its oldest key beyond `maxlen` entries — a simple
  function-return cache (reference ``python_utils.py:201``)."""

  def __init__(self, *args, maxlen: int = 1000, **kwargs):
    super().__init__(*args, **kwargs)
    self._queue = list(self.keys())
    self.maxlen = int(maxlen)

  def copy(self) -> "fifodict":
    return fifodict(self, maxlen=self.maxlen)

  def clear(self):
    self._queue.clear()
    super().clear()

  def pop(self, key, default=None):
    if key in self._queue:
      self._queue.remove(key)
    return super().pop(key, default)

  def __delitem__(self, key):
    self._queue.remove(key)
    super().__delitem__(key)

  def __setitem__(self, key, value):
    if key not in self:
      if len(self) >= self.maxlen:
        oldest = self._queue.pop(0)
        super().__delitem__(oldest)
      self._queue.append(key)
    super().__setitem__(key, value)


def multikeysdict(d: dict) -> dict:
  """Expand tuple keys into one entry per element (reference
  ``python_utils.py:178``)."""
  out = d.__class__()
  for key, value in d.items():
    if isinstance(key, tuple):
      for k in key:
        out[k] = value
    else:
      out[key] = value
  return out


def partialclass(cls: type, *args, **kwargs) -> type:
  """functools.partial for class constructors (reference
  ``python_utils.py:190``); the returned subclass records the bound
  arguments for debugging."""
  new_cls = type(f"Partial{cls.__name__}", (cls,), {})
  new_cls.__init__ = functools.partialmethod(new_cls.__init__, *args,
                                             **kwargs)
  new_cls._partial_args = args
  new_cls._partial_kwargs = kwargs
  return new_cls


class IndexedList(list):
  """List keeping a name -> position index for O(1) named lookup
  (reference ``python_utils.py:72``): append with `name=`, then fetch by
  name or position."""

  def __init__(self, items=(), names=None):
    super().__init__(items)
    names = list(names) if names is not None else [None] * len(self)
    assert len(names) == len(self)
    self._names = names

  def append(self, value, name=None):
    self._names.append(name)
    super().append(value)

  def index_of(self, name) -> int:
    return self._names.index(name)

  def __getitem__(self, key):
    if isinstance(key, str):
      return super().__getitem__(self.index_of(key))
    return super().__getitem__(key)


def get_formatted_datetime(only_number: bool = True) -> str:
  """Timestamp string (reference ``python_utils.py:249``)."""
  now = datetime.datetime.now()
  if only_number:
    return now.strftime(r"%H%M%S%d%m%y")
  return now.strftime(r"%H:%M:%S-%d%b%y")


def get_function_arguments(func: Callable[..., Any]) -> List[str]:
  """Argument names of a callable (reference ``python_utils.py:63``)."""
  return [p.name for p in inspect.signature(func).parameters.values()
          if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]


def is_lambda(v) -> bool:
  return callable(v) and getattr(v, "__name__", "") == "<lambda>"


def is_pickleable(x) -> bool:
  try:
    pickle.dumps(x)
    return True
  except Exception:
    return False


def is_number(x, string_number: bool = False) -> bool:
  if isinstance(x, str) and string_number:
    try:
      float(x)
      return True
    except ValueError:
      return False
  return isinstance(x, numbers.Number) and not isinstance(x, bool)


def is_string(x) -> bool:
  return isinstance(x, str)


def is_bool(x) -> bool:
  return isinstance(x, (bool, np.bool_))


def is_primitive(x, inc_ndarray: bool = True) -> bool:
  if isinstance(x, (numbers.Number, str, bytes, bool, type(None))):
    return True
  if inc_ndarray and isinstance(x, np.ndarray):
    return True
  if isinstance(x, (tuple, list)):
    return all(is_primitive(i, inc_ndarray) for i in x)
  return False


def is_path(x) -> bool:
  return isinstance(x, (str, os.PathLike)) and (
      os.path.sep in str(x) or os.path.exists(str(x)))
