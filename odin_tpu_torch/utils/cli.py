"""ArgController + stdio redirection.

Reference: ``odin/utils/__init__.py:708`` (`ArgController` — declarative CLI
arguments) and :288 (`stdio` — tee stdout to a log file).

The port's copy of the JAX package's ``odin_tpu/utils/cli.py``, which
imports no JAX.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Optional

__all__ = ["ArgController", "stdio"]


class ArgController:
  """Chainable argparse wrapper::

    args = (ArgController()
            .add('-ds', 'dataset name', 'mnist')
            .add('-bs', 'batch size', 32)
            .add('--debug', 'debug mode', False)
            .parse())
  """

  def __init__(self, description: str = ""):
    self._parser = argparse.ArgumentParser(description=description)

  def add(self, name: str, help: str = "", default: Any = None,
          choices=None) -> "ArgController":
    kwargs: dict = dict(help=help, default=default)
    if isinstance(default, bool):
      kwargs = dict(help=help, action="store_true" if not default
                    else "store_false")
    elif default is not None:
      kwargs["type"] = type(default)
    if choices is not None:
      kwargs["choices"] = choices
    self._parser.add_argument(name, **kwargs)
    return self

  def parse(self, argv=None):
    return self._parser.parse_args(argv)


class _Tee:

  def __init__(self, stream, fobj):
    self.stream = stream
    self.fobj = fobj

  def write(self, data):
    self.stream.write(data)
    self.fobj.write(data)

  def flush(self):
    self.stream.flush()
    self.fobj.flush()


class stdio:
  """Context manager tee-ing stdout/stderr to a file
  (reference ``utils/__init__.py:288``)."""

  def __init__(self, path: str, mode: str = "w", stderr: bool = True):
    self.path = path
    self.mode = mode
    self.stderr = stderr

  def __enter__(self):
    self._f = open(self.path, self.mode)
    self._out, self._err = sys.stdout, sys.stderr
    sys.stdout = _Tee(self._out, self._f)
    if self.stderr:
      sys.stderr = _Tee(self._err, self._f)
    return self

  def __exit__(self, *exc):
    sys.stdout = self._out
    sys.stderr = self._err
    self._f.close()
    return False
