"""Model introspection helpers of the port (PyTorch port of
``odin_tpu/backend/keras_helpers.py``): the parameter count of a module or
a tree of tensors, and a readable listing of a module's tree."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["layer2text", "count_params"]


def _named_leaves(tree: Any, prefix: str = ""):
  """(name, tensor or array) of a module's parameters, a VAE's params or
  a tree of dicts and lists."""
  if isinstance(tree, torch.nn.Module):
    yield from tree.named_parameters()
    return
  if hasattr(tree, "state") and getattr(tree, "state", None) is not None \
      and hasattr(tree.state, "params"):  # a built model
    yield from _named_leaves(tree.state.params, prefix)
    return
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
  elif hasattr(tree, "shape"):
    yield prefix, tree


def count_params(params: Any) -> int:
  """The number of parameters of a module, a built model or a tree of
  tensors or arrays: the sum of each leaf's element count, which equals
  the JAX package's count on the same weights carried across by
  ``odin_tpu_torch.weights``."""
  return int(sum(int(np.prod(tuple(leaf.shape)))
                 for _, leaf in _named_leaves(params)))


def layer2text(module_or_params: Any, sample_input=None, depth: int = 2
               ) -> str:
  """A readable summary.  A module: its tree of submodules down to
  `depth`, each line with the module's class, its own parameters' shapes,
  its parameter count and, with a `sample_input`, its output shape from
  one forward pass (under ``torch.no_grad``).  Anything else (a built
  model, a tree of tensors): one line per leaf with its name, shape and
  dtype.  The last line is the total count."""
  if not isinstance(module_or_params, torch.nn.Module):
    lines = [f"{name:<60s} {str(tuple(leaf.shape)):<18s} "
             f"{str(leaf.dtype).replace('torch.', '')}"
             for name, leaf in _named_leaves(module_or_params)]
    lines.append(f"total parameters: {count_params(module_or_params):,}")
    return "\n".join(lines)
  module = module_or_params
  outputs = {}
  if sample_input is not None:
    def record(name):
      def hook(m, args, out):  # returns None: the output stays as it is
        outputs.setdefault(name, tuple(out.shape) if isinstance(
            out, torch.Tensor) else type(out).__name__)
      return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in module.named_modules()]
    try:
      with torch.no_grad():
        module(sample_input)
    finally:
      for h in hooks:
        h.remove()
  lines = []
  for name, m in module.named_modules():
    level = 0 if not name else name.count(".") + 1
    if level > depth:
      continue
    own = [tuple(p.shape) for _, p in m.named_parameters(recurse=False)]
    line = (f"{'  ' * level}{name or '(root)'}: {type(m).__name__} "
            f"params={count_params(m):,}")
    if own:
      line += f" own={own}"
    if name in outputs:
      line += f" -> {outputs[name]}"
    lines.append(line)
  lines.append(f"total parameters: {count_params(module):,}")
  return "\n".join(lines)
