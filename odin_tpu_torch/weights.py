"""Bridge between flax parameter trees and the port's ``state_dict``s.

The trees are those of ``odin_tpu``'s models as numpy arrays, e.g.
``jax.device_get(vae.state.params)``; the state dicts are those of the
port's ``VAECore`` (or any module built from ``odin_tpu_torch.networks``).
The layout rules:

  * ``Conv`` kernels are HWIO in flax and OIHW in torch;
  * flax's ``ConvTranspose`` kernel is unflipped (kh, kw, in, out); the
    port's ``ConvTranspose`` weight is (in, out, kh, kw) with both spatial
    axes flipped (see ``networks.base.ConvTranspose``);
  * ``Dense`` kernels are (in, out) in flax and (out, in) in torch;
  * activations stay NHWC, so ``Flatten`` before a ``Dense`` needs no
    permutation of the Dense kernel.

Path rules: flax's ``layers_<i>`` is ``layers.<i>``; the primitive a
wrapper layer holds (``Conv_0``, ``ConvTranspose_0``, ``Dense_0``) has no
module of its own in the port; ``kernel`` is ``weight``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.networks.base import Conv, ConvTranspose, Dense

__all__ = ["from_jax_params", "to_jax_params"]

_PRIMITIVES = {"Conv_0": Conv, "ConvTranspose_0": ConvTranspose,
               "Dense_0": Dense}
_LAYER = re.compile(r"^layers_(\d+)$")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
  for k, v in tree.items():
    if isinstance(v, Mapping):
      yield from _leaves(v, prefix + (str(k),))
    else:
      yield prefix + (str(k),), np.asarray(v)


def _kernel_to_torch(kind, kernel: np.ndarray) -> np.ndarray:
  if kernel.ndim == 2:  # Dense (in, out) -> (out, in)
    return kernel.T
  if kind is ConvTranspose:  # (kh, kw, in, out) -> flipped (in, out, kh, kw)
    return kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
  return kernel.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _kernel_to_flax(kind, weight: np.ndarray) -> np.ndarray:
  if weight.ndim == 2:
    return weight.T
  if kind is ConvTranspose:
    return weight[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
  return weight.transpose(2, 3, 1, 0)


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """flax params (a nested dict of arrays; a VAE's ``{'vae': ...}`` tree or
  the tree of one module) -> a ``state_dict`` for the port's module."""
  if set(params) == {"vae"}:
    params = params["vae"]
  out = {}
  for path, value in _leaves(params):
    *modules, leaf = path
    kind = _PRIMITIVES.get(modules[-1]) if modules else None
    if kind is not None:
      modules = modules[:-1]
    names = []
    for m in modules:
      match = _LAYER.match(m)
      names.extend(("layers", match.group(1)) if match else (m,))
    if leaf == "kernel":
      value = _kernel_to_torch(kind, value)
      leaf = "weight"
    elif leaf != "bias":
      raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
    out[".".join(names + [leaf])] = torch.from_numpy(
        value.astype(np.float32, order="C", copy=True))
  return out


def to_jax_params(module: nn.Module) -> Dict[str, Any]:
  """The inverse of ``from_jax_params`` for a built module of the port:
  its parameters as a flax tree of numpy arrays."""
  tree: Dict[str, Any] = {}
  for name, sub in module.named_modules():
    if not isinstance(sub, (Conv, ConvTranspose, Dense)):
      continue
    parts = name.split(".") if name else []
    path = []
    i = 0
    while i < len(parts):
      if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
        path.append(f"layers_{parts[i + 1]}")
        i += 2
      else:
        path.append(parts[i])
        i += 1
    if not path or path[-1] != "projection":  # a head's Dense is flax's own
      path.append(next(k for k, v in _PRIMITIVES.items() if type(sub) is v))
    node = tree
    for p in path:
      node = node.setdefault(p, {})
    w = sub.weight.detach().cpu().numpy()
    node["kernel"] = np.ascontiguousarray(_kernel_to_flax(type(sub), w))
    if sub.bias is not None:
      node["bias"] = sub.bias.detach().cpu().numpy().copy()
  return tree
