"""Experiments over a grid of config overrides (a copy of
``odin_tpu/training/experimenter.py``): ``run_hydra``, a decorator taking
``key=value`` overrides from the command line, where a comma-separated
value sweeps the cartesian product, each point in an output directory
named by its overrides (``get_output_dir``; their md5 ``hash_config``
when the name is long), with ``--reset`` and ``-j N`` (N forked jobs);
``parse_config`` reads a dict, a YAML file or YAML text (a minimal parser
where pyyaml is absent).

Forked jobs cannot use a CUDA context their parent holds, so ``-j N`` with
N > 1 raises ``ValueError`` before it forks where the parent has started
CUDA; each task starting its own CUDA work after the fork is allowed.
"""
from __future__ import annotations

import copy
import itertools
import os
import shutil
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from odin_tpu_torch.utils import md5_checksum

__all__ = ["parse_config", "hash_config", "run_hydra", "get_output_dir"]


def _parse_value(v: str) -> Any:
  v = v.strip()
  for cast in (int, float):
    try:
      return cast(v)
    except ValueError:
      pass
  if v.lower() in ("true", "false"):
    return v.lower() == "true"
  if v.lower() in ("null", "none"):
    return None
  if "," in v:
    return [_parse_value(x) for x in v.split(",")]
  return v


def parse_config(config: Union[str, dict, None]) -> Dict[str, Any]:
  """A config from a dict, a YAML file's path or YAML text."""
  if config is None:
    return {}
  if isinstance(config, dict):
    return dict(config)
  text = config
  if os.path.isfile(config):
    with open(config) as f:
      text = f.read()
  try:
    import yaml
    return yaml.safe_load(text) or {}
  except ImportError:
    out: Dict[str, Any] = {}
    for line in text.splitlines():
      line = line.split("#")[0].strip()
      if not line or ":" not in line:
        continue
      k, v = line.split(":", 1)
      out[k.strip()] = _parse_value(v)
    return out


def hash_config(overrides: Dict[str, Any], exclude: Sequence[str] = ()) -> str:
  """The first 8 hex digits of the md5 of the sorted override items."""
  items = sorted((k, v) for k, v in overrides.items() if k not in exclude)
  return md5_checksum(repr(items).encode())[:8]


def get_output_dir(root: str, overrides: Dict[str, Any]) -> str:
  """``root/k1=v1_k2=v2`` (sorted keys), or ``root/<hash_config>`` where
  that name is empty or longer than 80 characters."""
  name = "_".join(f"{k}={v}" for k, v in sorted(overrides.items()))
  if len(name) > 80 or not name:
    name = hash_config(overrides)
  return os.path.join(root, name)


def _parse_cli(argv: Sequence[str]):
  overrides: Dict[str, Any] = {}
  flags = {"reset": False, "jobs": 1}
  for arg in argv:
    if arg == "--reset":
      flags["reset"] = True
    elif arg.startswith("-j"):
      flags["jobs"] = int(arg[2:] or 1)
    elif "=" in arg:
      k, v = arg.split("=", 1)
      overrides[k.lstrip("-")] = _parse_value(v)
  return overrides, flags


def _run_one(task_fn: Callable, base: Dict[str, Any], output_dir: str,
             reset: bool, ov: Dict[str, Any]):
  """One sweep point in its own output directory."""
  cfg = copy.deepcopy(base)
  cfg.update(ov)
  out_dir = get_output_dir(output_dir, ov)
  if reset and os.path.exists(out_dir):
    shutil.rmtree(out_dir)
  os.makedirs(out_dir, exist_ok=True)
  cfg["output_dir"] = out_dir
  return task_fn(_Namespace(cfg))


def run_hydra(output_dir: str = "./results",
              config: Union[str, dict, None] = None,
              exclude_keys: Sequence[str] = ()):
  """Decorator: ``@run_hydra(output_dir=...)`` wraps a ``main(cfg)``.

  ``main(argv=None, **extra)`` reads ``key=value key2=v1,v2 --reset -j2``
  from `argv` (``sys.argv[1:]`` by default): list-valued overrides sweep
  their cartesian product; each point runs ``main`` on the config updated
  with its overrides, its own output directory in ``cfg.output_dir``.  It
  returns the task's result, or the list of them for a sweep.  ``-jN``
  runs a sweep in N forked processes; it raises ``ValueError`` before
  forking where this process has started CUDA.
  """

  def decorator(task_fn: Callable):
    def wrapped(argv: Optional[Sequence[str]] = None, **extra):
      base = parse_config(config)
      overrides, flags = _parse_cli(
          argv if argv is not None else sys.argv[1:])
      overrides.update(extra)
      # multirun expansion: any list-valued override sweeps
      sweep_keys = [k for k, v in overrides.items() if isinstance(v, list)]
      combos = [dict(overrides)]
      if sweep_keys:
        values = [overrides[k] for k in sweep_keys]
        combos = []
        for combo in itertools.product(*values):
          d = dict(overrides)
          d.update(dict(zip(sweep_keys, combo)))
          combos.append(d)
      n_jobs = max(1, int(flags["jobs"]))
      if n_jobs > 1 and len(combos) > 1:
        # a forked worker inherits this process's state, not a usable CUDA
        # context: start CUDA inside task_fn, not before the sweep
        import functools
        import multiprocessing as mp

        import torch
        if torch.cuda.is_initialized():
          raise ValueError(
              f"run_hydra(-j{n_jobs}) would fork workers that cannot use the "
              "CUDA context this process has started; run the sweep with "
              "-j1, or start CUDA inside the task only")
        ctx = mp.get_context("fork")
        with ctx.Pool(min(n_jobs, len(combos))) as pool:
          results = pool.map(
              functools.partial(_run_one, task_fn, base, output_dir,
                                flags["reset"]), combos)
      else:
        results = [_run_one(task_fn, base, output_dir, flags["reset"], ov)
                   for ov in combos]
      return results[0] if len(results) == 1 else results

    wrapped.__name__ = task_fn.__name__
    return wrapped

  return decorator


class _Namespace(dict):
  """A dict whose keys read and write as attributes."""

  def __getattr__(self, k):
    try:
      return self[k]
    except KeyError as e:
      raise AttributeError(k) from e

  def __setattr__(self, k, v):
    self[k] = v
