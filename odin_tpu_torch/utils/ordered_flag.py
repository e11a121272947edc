"""Ordered string flags.

Reference: ``odin/utils/ordered_flag.py`` — `OrderedFlag`, a string Enum
behaving like `enum.Flag` (bitwise ``| & ^ ~`` compose members) but keeping
the composition ORDER in ``.value`` while comparing order-insensitively.
The reference's attention algebra used this to spell modes like
``'scoredot_global_soft'``; it is kept here as a general utility (the
attention module uses plain dataclass fields by design).

The port's copy of the JAX package's ``odin_tpu/utils/ordered_flag.py``, which
imports no JAX.
"""
from __future__ import annotations

from enum import Enum
from numbers import Number

__all__ = ["OrderedFlag"]


class OrderedFlag(str, Enum):
  """String Enum with Flag-style composition preserving element order in
  `value` (``a | b`` -> ``'a_b'``, ``b | a`` -> ``'b_a'``) while ``==``,
  ``!=``, and ``in`` ignore order.  Override ``_sep`` to change the
  separator."""

  @classmethod
  def _sep(cls) -> str:
    return "_"

  @classmethod
  def parse(cls, value, raise_not_found: bool = True):
    """Return the member matching `value` (a member, its value, or a
    substring of a composite name)."""
    if isinstance(value, cls):
      return value
    value = str(value)
    try:
      return cls(value)
    except ValueError:
      pass
    for member in cls:
      if value in member.name:
        return member
    if raise_not_found:
      raise ValueError(f"Invalid value={value!r} for {cls.__name__}; "
                       f"supported: {list(cls)}")
    return False

  @classmethod
  def _missing_(cls, value):
    # build a composite pseudo-member iff every part is a base member
    sep = cls._sep()
    parts = [p for p in str(value).split(sep) if p]
    seen = []
    for p in parts:
      if p not in cls._value2member_map_:
        raise ValueError(f"Invalid value: {value!r} for {cls.__name__}")
      if p not in seen:
        seen.append(p)
    composite_value = sep.join(seen)
    member = cls._value2member_map_.get(composite_value)
    if member is None:
      member = str.__new__(cls)
      member._name_ = sep.join(sorted(seen))  # order-free identity
      member._value_ = composite_value
      member = cls._value2member_map_.setdefault(composite_value, member)
    return member

  def _parts(self):
    return self._value_.split(self.__class__._sep())

  def __contains__(self, other) -> bool:
    other = self.__class__.parse(other)
    return all(p in self._parts() for p in other._parts())

  def __iter__(self):
    for p in self._parts():
      yield self.__class__._value2member_map_[p]

  def __or__(self, other):
    other = self.__class__.parse(other)
    return self.__class__(
        self.__class__._sep().join([self._value_, other._value_]))

  def __and__(self, other):
    other = self.__class__.parse(other)
    keep = [p for p in self._parts() if p in other._parts()]
    return self.__class__(self.__class__._sep().join(keep))

  def __xor__(self, other):
    other = self.__class__.parse(other)
    mine, theirs = self._parts(), other._parts()
    sym = ([p for p in mine if p not in theirs] +
           [p for p in theirs if p not in mine])
    return self.__class__(self.__class__._sep().join(sym))

  def __invert__(self):
    sep = self.__class__._sep()
    base = [v for v in self.__class__._value2member_map_ if sep not in v]
    return self.__class__(
        sep.join([v for v in base if v not in self._parts()]))

  def index(self, element) -> int:
    element = self.__class__.parse(element)
    return list(self).index(element)

  def __getitem__(self, key):
    if isinstance(key, Number):
      return list(self)[int(key)]
    raise ValueError(f"OrderedFlag does not support indexing with {key!r}")

  def __eq__(self, other) -> bool:
    if not isinstance(other, self.__class__):
      return False
    return set(self._parts()) == set(other._parts())

  def __ne__(self, other) -> bool:
    return not self.__eq__(other)

  def __hash__(self):
    return hash(frozenset(self._parts()))
