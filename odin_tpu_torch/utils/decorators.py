"""Function/class decorators.

Reference: ``odin/utils/decorators.py`` — `schedule` (rate-limit a callable),
`typecheck` (runtime signature enforcement), `autoattr` (auto-set attributes
after a method call), `abstractstatic`, `functionable` (serialize a function
by value so lambdas/closures survive pickling to worker processes), and
`singleton` (same-args -> same-instance classes).

The `functionable` here serializes the function's *code object* via
`marshal` plus closure cells and referenced globals — the modern equivalent
of the reference's source-extraction sandbox (``decorators.py:327-460``),
without re-parsing source files.

The port's copy of the JAX package's ``odin_tpu/utils/decorators.py``, which
imports no JAX.
"""
from __future__ import annotations

import inspect
import marshal
import math
import time
import types
from collections import defaultdict
from functools import wraps
from typing import Callable

__all__ = ["schedule", "typecheck", "autoattr", "abstractstatic",
           "functionable", "singleton"]


def schedule(interval: float, stop_after: float = math.inf,
             max_repeat: float = math.inf):
  """Rate-limit a function: calls run at most every `interval` seconds and
  are silently dropped otherwise; stop entirely `stop_after` seconds after
  the first accepted call or after `max_repeat` accepted calls (reference
  ``decorators.py:34``).  Dropped/stopped calls return None."""

  def decorate(fn: Callable) -> Callable:
    state = {"last": time.time(), "first": -1.0, "n": 0}

    @wraps(fn)
    def scheduled(*args, **kwargs):
      now = time.time()
      if now - state["last"] < interval:
        return None
      if state["first"] < 0:
        state["first"] = now
      elif now - state["first"] > stop_after:
        return None
      state["n"] += 1
      if state["n"] > max_repeat:
        return None
      state["last"] = now
      return fn(*args, **kwargs)

    return scheduled

  return decorate


def typecheck(fn: Callable) -> Callable:
  """Enforce the function's type annotations at call time (reference
  ``decorators.py:104`` took separate inputs/outputs specs; here the
  annotations ARE the spec).  Only plain-class annotations are checked;
  typing generics are ignored."""
  sig = inspect.signature(fn)

  def _check(name, value, expected):
    if isinstance(expected, type) and not isinstance(value, expected):
      raise TypeError(
          f"{fn.__name__}: argument {name!r} expected "
          f"{expected.__name__}, got {type(value).__name__}")

  @wraps(fn)
  def checked(*args, **kwargs):
    bound = sig.bind(*args, **kwargs)
    for name, value in bound.arguments.items():
      ann = sig.parameters[name].annotation
      if ann is not inspect.Parameter.empty:
        _check(name, value, ann)
    out = fn(*args, **kwargs)
    if sig.return_annotation is not inspect.Signature.empty:
      _check("return", out, sig.return_annotation)
    return out

  return checked


def autoattr(**attr_values):
  """After the decorated method runs, set the given attributes on `self`
  (reference ``decorators.py:227``): values may be constants or callables
  taking `self` — e.g. ``@autoattr(is_fitted=True)`` on ``fit``."""

  def decorate(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapper(self, *args, **kwargs):
      out = fn(self, *args, **kwargs)
      for name, value in attr_values.items():
        setattr(self, name, value(self) if callable(value) else value)
      return out

    return wrapper

  return decorate


class abstractstatic(staticmethod):
  """Abstract static method (reference ``decorators.py:277``)."""

  __slots__ = ()

  def __init__(self, function):
    super().__init__(function)
    function.__isabstractmethod__ = True

  __isabstractmethod__ = True


class functionable:
  """Wrap a function so it pickles BY VALUE: the code object, defaults,
  closure cells, and referenced module-level globals travel with it, so
  lambdas and locally-defined functions can cross process boundaries (the
  reference's `functionable`, ``decorators.py:460``, did this by shipping
  extracted source).  Modules referenced by the function are re-imported by
  name on the receiving side."""

  def __init__(self, fn: Callable, *args, **kwargs):
    assert callable(fn) and inspect.isfunction(fn), \
        "functionable wraps plain functions/lambdas"
    self._fn = fn
    self.args = args
    self.kwargs = kwargs

  def __call__(self, *args, **kwargs):
    call_kwargs = dict(self.kwargs)
    call_kwargs.update(kwargs)
    return self._fn(*self.args, *args, **call_kwargs)

  @property
  def function(self) -> Callable:
    return self._fn

  def __repr__(self):
    return f"functionable({self._fn.__name__}, args={self.args}, " \
           f"kwargs={self.kwargs})"

  def __getstate__(self):
    fn = self._fn
    code = marshal.dumps(fn.__code__)
    closure = tuple(cell.cell_contents for cell in (fn.__closure__ or ()))
    # referenced globals: values pickled directly, modules by name
    names = fn.__code__.co_names
    globs, modules = {}, {}
    for name in names:
      if name in fn.__globals__:
        value = fn.__globals__[name]
        if isinstance(value, types.ModuleType):
          modules[name] = value.__name__
        else:
          try:
            import pickle
            pickle.dumps(value)
            globs[name] = value
          except Exception:
            pass  # unpicklable global: receiver must have it importable
    return dict(code=code, name=fn.__name__, defaults=fn.__defaults__,
                closure=closure, globs=globs, modules=modules,
                args=self.args, kwargs=self.kwargs)

  def __setstate__(self, state):
    import importlib
    globs = dict(state["globs"])
    for name, modname in state["modules"].items():
      globs[name] = importlib.import_module(modname)
    globs["__builtins__"] = __builtins__
    code = marshal.loads(state["code"])
    closure = tuple(types.CellType(v) for v in state["closure"])
    self._fn = types.FunctionType(code, globs, state["name"],
                                  state["defaults"], closure or None)
    self.args = state["args"]
    self.kwargs = state["kwargs"]


def singleton(cls):
  """Class decorator: constructing with the same ``_get_id(*args)`` returns
  the same instance (reference ``decorators.py:613``).  Classes without a
  ``_get_id`` classmethod use the plain argument tuple as identity."""
  if not isinstance(cls, type):
    raise TypeError("singleton only decorates classes")
  instances = defaultdict(list)
  get_id = getattr(cls, "_get_id", None)

  @wraps(cls, updated=())
  class Wrapped(cls):
    def __new__(wcls, *args, **kwargs):
      key = (get_id(*args, **kwargs) if get_id is not None
             else (args, tuple(sorted(kwargs.items()))))
      for existing_key, obj in instances[cls]:
        if existing_key == key:
          obj.__singleton_hit__ = True
          return obj
      obj = super().__new__(wcls)
      obj.__singleton_hit__ = False
      instances[cls].append((key, obj))
      return obj

    def __init__(self, *args, **kwargs):
      if getattr(self, "__singleton_hit__", False):
        return  # already initialized
      super().__init__(*args, **kwargs)

  return Wrapped
