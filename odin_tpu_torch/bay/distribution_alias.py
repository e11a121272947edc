"""String alias registry of the port: alias -> (params_size, builder,
default prior), for the families the port serves and trains through
(PyTorch port of ``odin_tpu/bay/distribution_alias.py``: ``_softplus`` :30,
the normal, mvndiag, dirichlet, bernoulli, onehot, deterministic,
vdeterministic, vmf and powerspherical builders
:83,93,122,127,147,208,212,263,271, the image likelihoods' gmmdiag
:216-244, mixqlogistic :245-262 and qlogistic :376-388, and the default
priors :282-305)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from odin_tpu_torch.bay import distributions as D

__all__ = ["DistSpec", "parse_distribution", "register_distribution_alias"]


def _softplus(x, eps=1e-5):
  return F.softplus(x) + eps


def _size(event_shape) -> int:
  return int(np.prod(event_shape)) if len(event_shape) else 1


def _reshape_event(x, event_shape):
  return x.reshape(tuple(x.shape[:-1]) + tuple(event_shape))


def _indep(dist, event_shape):
  return D.Independent(dist, len(event_shape)) if len(event_shape) else dist


@dataclass(frozen=True)
class DistSpec:
  name: str
  params_size: Callable[..., int]
  builder: Callable[..., D.Distribution]
  default_prior: Callable[..., Optional[D.Distribution]]


_ALIASES: Dict[str, DistSpec] = {}


def register_distribution_alias(names, spec: DistSpec):
  for n in (names if isinstance(names, (tuple, list)) else [names]):
    _ALIASES[n.lower()] = spec


def parse_distribution(alias) -> DistSpec:
  """Resolve a string alias (or DistSpec) to its DistSpec."""
  if isinstance(alias, DistSpec):
    return alias
  key = str(alias).lower()
  if key not in _ALIASES:
    raise ValueError(f"unknown distribution alias '{alias}'; "
                     f"available: {sorted(_ALIASES)}")
  return _ALIASES[key]


def _split(params, n, event_shape):
  """Split the trailing axis into n event-shaped chunks."""
  d = _size(event_shape)
  return [_reshape_event(params[..., i * d:(i + 1) * d], event_shape)
          for i in range(n)]


def _normal_builder(params, event_shape, **kw):
  loc, raw = _split(params, 2, event_shape)
  return _indep(D.Normal(loc, _softplus(raw)), event_shape)


def _mvndiag_builder(params, event_shape, **kw):
  d = _size(event_shape)
  return D.MultivariateNormalDiag(params[..., :d], _softplus(params[..., d:]))


def _dirichlet_builder(params, event_shape, **kw):
  return D.Dirichlet(_softplus(_reshape_event(params, event_shape)))


def _bernoulli_builder(params, event_shape, **kw):
  return _indep(D.Bernoulli(logits=_reshape_event(params, event_shape)),
                event_shape)


def _onehot_builder(params, event_shape, **kw):
  return D.OneHotCategorical(logits=_reshape_event(params, event_shape))


def _deterministic_builder(params, event_shape, **kw):
  return _indep(D.Deterministic(_reshape_event(params, event_shape)),
                event_shape)


def _vdeterministic_builder(params, event_shape, **kw):
  return D.VectorDeterministic(_reshape_event(params, event_shape))


def _unit_direction(params, d):
  loc = params[..., :d]
  return loc / torch.clamp(torch.linalg.vector_norm(loc, dim=-1,
                                                   keepdim=True), min=1e-8)


def _vmf_builder(params, event_shape, **kw):
  d = _size(event_shape)
  return D.VonMisesFisher(_unit_direction(params, d),
                          _softplus(params[..., d]) + 1.0)


def _powerspherical_builder(params, event_shape, **kw):
  d = _size(event_shape)
  return D.PowerSpherical(_unit_direction(params, d),
                          _softplus(params[..., d]) + 1.0)


def _gmm_params_size(event_size, n_components=2, covariance="diag", **kw):
  if covariance in ("diag", "none"):
    return n_components * (1 + 2 * event_size)
  if covariance in ("tril", "full"):
    return n_components * (1 + event_size + event_size * (event_size + 1) // 2)
  raise ValueError(covariance)


def _gmm_builder(params, event_shape, n_components=2, covariance="diag",
                 **kw):
  """K logits, then K·d locations, then K·d raw scales."""
  d = _size(event_shape)
  K = n_components
  if covariance not in ("diag", "none"):
    return D.GaussianMixture(None, None, None, covariance=covariance)
  logits, rest = params[..., :K], params[..., K:]
  lead = tuple(rest.shape[:-1])
  locs = rest[..., :K * d].reshape(lead + (K, d))
  scales = _softplus(rest[..., K * d:].reshape(lead + (K, d)))
  return D.GaussianMixture(logits, locs, scales, covariance="diag")


def _mixqlogistic_params_size(event_size, n_components=10, **kw):
  return n_components * (1 + 2 * event_size)


def _mixqlogistic_builder(params, event_shape, n_components=10, low=0,
                          high=255, **kw):
  """K logits, then K event-shaped locations (a sigmoid onto the grid),
  then K raw scales (softplus, times the grid's width)."""
  d = _size(event_shape)
  K = n_components
  logits, rest = params[..., :K], params[..., K:]
  shape = tuple(rest.shape[:-1]) + (K,) + tuple(event_shape)
  locs = rest[..., :K * d].reshape(shape)
  scales = _softplus(rest[..., K * d:].reshape(shape))
  comp = D.QuantizedLogistic(torch.sigmoid(locs) * (high - low) + low,
                             scales * (high - low), low=low, high=high,
                             inputs_domain="sigmoid")
  return D.MixtureSameFamily(D.Categorical(logits=logits),
                             _indep(comp, event_shape))


def _qlogistic_builder(params, event_shape, low=0, high=255, **kw):
  """The PixelCNN quantized logistic: the raw location, about [-1, 1],
  mapped onto the grid as ``low + (high - low)/2 · (loc + 1)``, the scale
  ``(softplus(raw) + exp(-7)) · (high - low)/2``."""
  loc, raw = _split(params, 2, event_shape)
  support = 0.5 * (high - low)
  loc = low + support * (loc + 1.0)
  scale = (F.softplus(raw) + math.exp(-7.0)) * support
  return _indep(D.QuantizedLogistic(loc, scale, low=low, high=high,
                                    inputs_domain="sigmoid"), event_shape)


def _std_normal_prior(event_shape, **kw):
  return _indep(D.Normal(torch.zeros(event_shape), torch.ones(event_shape)),
                event_shape)


def _mvndiag_prior(event_shape, **kw):
  d = _size(event_shape)
  return D.MultivariateNormalDiag(torch.zeros(d), torch.ones(d))


def _dirichlet_prior(event_shape, **kw):
  return D.Dirichlet(torch.ones(event_shape))


def _onehot_prior(event_shape, **kw):
  return D.OneHotCategorical(logits=torch.zeros(_size(event_shape)))


def _sphere_prior(event_shape, **kw):
  return D.SphericalUniform(_size(event_shape))


def _no_prior(event_shape, **kw):
  return None


def _n_params(n):
  return lambda event_size, **kw: n * event_size


register_distribution_alias(("normal", "gaussian"), DistSpec(
    "normal", _n_params(2), _normal_builder, _std_normal_prior))
register_distribution_alias("mvndiag", DistSpec(
    "mvndiag", _n_params(2), _mvndiag_builder, _mvndiag_prior))
register_distribution_alias("dirichlet", DistSpec(
    "dirichlet", _n_params(1), _dirichlet_builder, _dirichlet_prior))
register_distribution_alias("bernoulli", DistSpec(
    "bernoulli", _n_params(1), _bernoulli_builder, _no_prior))
register_distribution_alias(("onehot",), DistSpec(
    "onehot", _n_params(1), _onehot_builder, _onehot_prior))
register_distribution_alias("deterministic", DistSpec(
    "deterministic", _n_params(1), _deterministic_builder, _no_prior))
register_distribution_alias("vdeterministic", DistSpec(
    "vdeterministic", _n_params(1), _vdeterministic_builder, _no_prior))
register_distribution_alias(("mdn", "gmm", "mdndiag", "gmmdiag"), DistSpec(
    "gmmdiag", _gmm_params_size, _gmm_builder, _mvndiag_prior))
register_distribution_alias(
    ("mdntril", "gmmtril", "mdnfull", "gmmfull"), DistSpec(
        "gmmtril",
        lambda d, n_components=2, **kw: _gmm_params_size(d, n_components,
                                                         "tril"),
        lambda p, e, n_components=2, **kw: _gmm_builder(p, e, n_components,
                                                        "tril"),
        _mvndiag_prior))
register_distribution_alias(("qlogistic", "quantizedlogistic"), DistSpec(
    "qlogistic", _n_params(2), _qlogistic_builder, _no_prior))
register_distribution_alias(("mixqlogist", "mixqlogistic"), DistSpec(
    "mixqlogistic", _mixqlogistic_params_size, _mixqlogistic_builder,
    _no_prior))
register_distribution_alias(("vonmisesfisher", "vmf"), DistSpec(
    "vmf", lambda d, **kw: d + 1, _vmf_builder, _sphere_prior))
register_distribution_alias(("powerspherical",), DistSpec(
    "powerspherical", lambda d, **kw: d + 1, _powerspherical_builder,
    _sphere_prior))
