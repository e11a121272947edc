"""Name -> object parsers of the port (PyTorch port of
``odin_tpu/backend/alias.py``).  They accept the JAX package's names and
resolve them to the port's objects: activations to torch functions,
initializers to in-place fills of a torch tensor with flax's formulas,
optimizers to the port's ``training.core.make_optimizer`` factories,
attention, normalization and layer names to the port's ``networks``
classes (torch's own ``LayerNorm``, ``GroupNorm`` and ``RMSNorm``, which
the port's networks do not redefine), and losses and metrics to torch's
functional losses and the port's ``backend.losses`` and
``backend.metrics``.  A reduction keeps the JAX package's call,
``f(x, axis=None, keepdims=False)``."""
from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F

__all__ = [
    "identity_function", "parse_activation", "parse_initializer",
    "parse_optimizer", "parse_regularizer", "parse_constraint",
    "parse_reduction", "parse_attention", "parse_normalizer", "parse_layer",
    "parse_loss", "parse_metric",
]


def identity_function(x):
  return x


def _invalid(msg: str, obj: Any):
  raise ValueError(f"{msg}: '{obj}'")


def parse_activation(activation: Union[str, Callable, None],
                     framework: Any = None) -> Callable:
  """Alias -> activation function; 'a+b' applies a then b."""
  from odin_tpu_torch.networks.base import get_activation
  if activation is None or callable(activation):
    return get_activation(activation)
  fns = [get_activation(a.strip()) for a in str(activation).split("+")]
  if len(fns) == 1:
    return fns[0]

  def seq(x):
    for f in fns:
      x = f(x)
    return x

  return seq


# -- initializers: in-place fills of a tensor in torch's layout (out, in,
# kernel...), flax's formulas with torch's fans
def _fans(w: torch.Tensor):
  if w.ndim < 2:
    n = w.numel()
    return n, n
  receptive = math.prod(w.shape[2:])
  return w.shape[1] * receptive, w.shape[0] * receptive


def _variance_scaling(scale: float, mode: str, distribution: str) -> Callable:
  """flax's ``variance_scaling``: a truncated normal (±2 std, std
  corrected for the truncation) or a uniform of variance
  ``scale / fan``."""

  def init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    fan_in, fan_out = _fans(w)
    fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
    with torch.no_grad():
      if distribution == "uniform":
        limit = math.sqrt(3.0 * scale / fan)
        return w.uniform_(-limit, limit, generator=generator)
      std = math.sqrt(scale / fan) / .87962566103423978
      return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                         generator=generator)

  return init


def _fill(fn: Callable) -> Callable:
  def init(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      return fn(w, generator)
  return init


_INITIALIZERS = {
    "zeros": _fill(lambda w, g: w.zero_()),
    "ones": _fill(lambda w, g: w.fill_(1.0)),
    "glorotuniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "glorotnormal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "heuniform": _variance_scaling(2.0, "fan_in", "uniform"),
    "henormal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "lecununiform": _variance_scaling(1.0, "fan_in", "uniform"),
    "lecunnormal": _variance_scaling(1.0, "fan_in", "truncated_normal"),
    "orthogonal": _fill(lambda w, g: torch.nn.init.orthogonal_(
        w, generator=g)),
    "normal": _fill(lambda w, g: w.normal_(0.0, 0.05, generator=g)),
    "truncatednormal": _fill(lambda w, g: torch.nn.init.trunc_normal_(
        w, 0.0, 0.05, -0.1, 0.1, generator=g)),
    "uniform": _fill(lambda w, g: w.uniform_(0.0, 0.05, generator=g)),
}
_INITIALIZERS.update(
    xavieruniform=_INITIALIZERS["glorotuniform"],
    xaviernormal=_INITIALIZERS["glorotnormal"],
    randomnormal=_INITIALIZERS["normal"],
    randomuniform=_INITIALIZERS["uniform"],
    kaiminguniform=_INITIALIZERS["heuniform"],
    kaimingnormal=_INITIALIZERS["henormal"])


def parse_initializer(initializer: Union[str, Callable],
                      framework: Any = None) -> Callable:
  """Alias -> initializer ``f(tensor, generator=None)`` that fills the
  tensor in place (torch's layout: fan in from dim 1 and the kernel dims)
  and returns it.  'normal' and 'truncated_normal' have std 0.05 (the
  latter cut at ±2 std), 'uniform' draws from [0, 0.05), as flax's."""
  if callable(initializer):
    return initializer
  key = str(initializer).lower().strip().replace("_", "")
  if key not in _INITIALIZERS:
    _invalid("No support for initializer", initializer)
  return _INITIALIZERS[key]


def parse_optimizer(optimizer: Union[str, Any],
                    framework: Any = None) -> Callable:
  """Alias -> factory ``f(learning_rate=1e-3, **kw)`` of the port's
  optimizer (``training.core.make_optimizer``); a non-string is returned
  as it is."""
  from odin_tpu_torch.training.core import make_optimizer
  if not isinstance(optimizer, str):
    return optimizer

  def factory(learning_rate=1e-3, **kwargs):
    return make_optimizer(optimizer, learning_rate=learning_rate, **kwargs)

  factory.__name__ = f"torch_{str(optimizer).lower()}"
  return factory


def _tree_leaves(tree):
  if isinstance(tree, torch.nn.Module):
    return list(tree.parameters())
  from odin_tpu_torch.training.core import _tree_leaves as leaves
  return leaves(tree)


def parse_regularizer(regularizer: Union[str, Callable, None],
                      framework: Any = None) -> Optional[Callable]:
  """Alias -> weight penalty ``f(params) -> scalar`` over a tree of
  tensors (dicts, lists) or a module's parameters."""
  if regularizer is None or callable(regularizer):
    return regularizer
  key = str(regularizer).lower().strip()

  def _sum(tree, f):
    leaves = _tree_leaves(tree)
    return sum(torch.sum(f(l)) for l in leaves) if leaves \
        else torch.zeros((), dtype=torch.float32)

  if key in ("l1",):
    return lambda tree, scale=0.01: scale * _sum(tree, torch.abs)
  if key in ("l2",):
    return lambda tree, scale=0.01: scale * _sum(tree, torch.square)
  if key in ("l1l2", "l1_l2"):
    return lambda tree, l1=0.01, l2=0.01: (l1 * _sum(tree, torch.abs) +
                                           l2 * _sum(tree, torch.square))
  _invalid("No support for regularizer", regularizer)


def parse_constraint(constraint: Union[str, Callable, None],
                     framework: Any = None) -> Optional[Callable]:
  """Alias -> projection of a parameter applied after an update."""
  if constraint is None or callable(constraint):
    return constraint
  key = str(constraint).lower().strip().replace("_", "")
  if key in ("nonneg", "nonnegative"):
    return lambda w: torch.clamp(w, min=0.0)
  if key in ("unitnorm",):
    return lambda w, axis=0: w / (
        torch.linalg.vector_norm(w, dim=axis, keepdim=True) + 1e-12)
  if key in ("maxnorm",):
    def max_norm(w, max_value=2.0, axis=0):
      n = torch.linalg.vector_norm(w, dim=axis, keepdim=True)
      return w * torch.clamp(n, 0, max_value) / (n + 1e-12)
    return max_norm
  _invalid("No support for constraint", constraint)


def _reduction(fn: Callable) -> Callable:
  def reduce(x, axis=None, keepdims=False):
    if axis is None:
      out = fn(x)
      return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)
  return reduce


def parse_reduction(reduce: Union[str, None],
                    framework: Any = None) -> Callable:
  """Alias -> reduction ``f(x, axis=None, keepdims=False)``; 'stat'
  concatenates the mean and the (population) std along the last axis."""
  if reduce is None:
    reduce = "none"
  if callable(reduce):
    return reduce
  key = str(reduce).lower()
  if "min" in key:
    return _reduction(torch.amin)
  if "max" in key:
    return _reduction(torch.amax)
  if "avg" in key or "mean" in key:
    return _reduction(torch.mean)
  if "sum" in key:
    return _reduction(torch.sum)
  if "stat" in key:
    mean = _reduction(torch.mean)
    std = _reduction(lambda x, **kw: torch.std(x, correction=0, **kw))

    def stat_reduce(x, axis=None, keepdims=False):
      return torch.cat([mean(x, axis, keepdims), std(x, axis, keepdims)],
                       dim=-1)
    return stat_reduce
  if "none" in key or key == "":
    return lambda x, *a, **kw: x
  _invalid("No support for reduce", reduce)


def parse_attention(attention: Union[str, Any], framework: Any = None):
  """Alias -> the port's attention layer class."""
  from odin_tpu_torch.networks import attention as _att
  if not isinstance(attention, str):
    return attention
  key = attention.lower().replace("_", "").replace("attention", "")
  table = {
      "": _att.Attention,
      "self": _att.SelfAttention,
      "global": _att.GlobalAttention,
      "local": _att.LocalPredictiveAttention,
      "localpredictive": _att.LocalPredictiveAttention,
      "multihead": _att.MultiHeadAttention,
  }
  if key not in table:
    _invalid("No support for attention", attention)
  return table[key]


def parse_normalizer(normalizer: Union[str, Any], framework: Any = None):
  """Alias -> normalization layer class: the port's flax-like
  ``BatchNorm``, torch's ``LayerNorm``, ``GroupNorm`` and ``RMSNorm``."""
  from odin_tpu_torch.networks.base import BatchNorm
  if not isinstance(normalizer, str):
    return normalizer
  key = normalizer.lower().replace("_", "").replace("norm", "") \
      .replace("alization", "")
  table = {"batch": BatchNorm, "layer": torch.nn.LayerNorm,
           "group": torch.nn.GroupNorm, "rms": torch.nn.RMSNorm}
  if key not in table:
    _invalid("No support for normalizer", normalizer)
  return table[key]


def parse_layer(layer: Union[str, Any], framework: Any = None):
  """Alias -> a class of ``odin_tpu_torch.networks``, by its name with
  case and underscores ignored."""
  import odin_tpu_torch.networks as _nets
  if not isinstance(layer, str):
    return layer
  for name in dir(_nets):
    if name.lower() == layer.lower().replace("_", ""):
      obj = getattr(_nets, name)
      if inspect.isclass(obj):
        return obj
  _invalid("No support for layer", layer)


def _losses() -> dict:
  from odin_tpu_torch.backend import losses
  return {
      "mse": lambda y, p: torch.square(p - y),
      "mae": lambda y, p: torch.abs(p - y),
      "huber": lambda y, p: F.huber_loss(p, y, reduction="none", delta=1.0),
      "categorical_crossentropy":
          lambda y, p: -torch.sum(y * F.log_softmax(p, dim=-1), dim=-1),
      "sparse_categorical_crossentropy":
          lambda y, p: F.cross_entropy(p, y.long(), reduction="none"),
      "binary_crossentropy":
          lambda y, p: F.binary_cross_entropy_with_logits(
              p, y.to(p.dtype), reduction="none"),
      "cosine_similarity": losses.cosine_similarity,
      "contrastive": losses.contrastive_loss,
      "triplet": losses.triplet_loss,
  }


def parse_loss(loss: Union[str, Callable], framework: Any = None) -> Callable:
  """Alias -> loss ``f(y_true, y_pred)``, per element (per row for the
  cross-entropies, which take logits), or a function of
  ``backend.losses`` by its name."""
  from odin_tpu_torch.backend import losses
  if callable(loss):
    return loss
  key = str(loss).lower().strip()
  aliases = _losses()
  if key in aliases:
    return aliases[key]
  if key in losses.__all__:
    return getattr(losses, key)
  _invalid("No support for loss", loss)


def parse_metric(metric: Union[str, Callable],
                 framework: Any = None) -> Callable:
  """Alias -> metric function: 'acc'/'accuracy' (the share of rows whose
  argmax is the label, a float) or a function of ``backend.metrics``."""
  from odin_tpu_torch.backend import metrics
  if callable(metric):
    return metric
  key = str(metric).lower().strip()
  if key in ("acc", "accuracy"):
    def accuracy(y, p):
      p = torch.as_tensor(p)
      y = torch.as_tensor(y, device=p.device)
      return float((torch.argmax(p, -1) == y.reshape(-1)).float().mean())
    return accuracy
  if key in metrics.__all__:
    return getattr(metrics, key)
  _invalid("No support for metric", metric)
