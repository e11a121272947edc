"""String alias registry of the port: alias -> (params_size, builder,
default prior) (PyTorch port of ``odin_tpu/bay/distribution_alias.py``:
``_softplus`` :30, the builders :83-271 and :376-414, the default priors
:282-305 and the table :315-433).  The port registers every alias the JAX
package does, each with the same parameter count and the same
raw-parameter layout."""
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


def _lognormal_builder(params, event_shape, **kw):
  loc, raw = _split(params, 2, event_shape)
  return _indep(D.LogNormal(loc, _softplus(raw)), event_shape)


def _mvndiag_builder(params, event_shape, **kw):
  d = _size(event_shape)
  return D.MultivariateNormalDiag(params[..., :d], _softplus(params[..., d:]))


def _fill_tril(raw: torch.Tensor, d: int) -> torch.Tensor:
  """The d x d lower-triangular factors whose entries are `raw`'s last axis
  in ``tril_indices(d)`` order (row by row), softplus on the diagonal."""
  rows, cols = torch.tril_indices(d, d, device=raw.device)
  flat = raw.reshape(-1, raw.shape[-1])
  tril = flat.new_zeros(flat.shape[0], d * d).index_copy(
      1, rows * d + cols, flat).reshape(tuple(raw.shape[:-1]) + (d, d))
  diag = torch.diagonal(tril, dim1=-2, dim2=-1)
  return tril + torch.diag_embed(_softplus(diag) - diag)


def _mvntril_builder(params, event_shape, **kw):
  d = _size(event_shape)
  return D.MultivariateNormalTriL(params[..., :d],
                                  _fill_tril(params[..., d:], d))


def _gamma_builder(params, event_shape, **kw):
  conc, rate = _split(params, 2, event_shape)
  return _indep(D.Gamma(_softplus(conc), _softplus(rate)), event_shape)


def _beta_builder(params, event_shape, **kw):
  c1, c0 = _split(params, 2, event_shape)
  return _indep(D.Beta(_softplus(c1), _softplus(c0)), event_shape)


def _dirichlet_builder(params, event_shape, **kw):
  return D.Dirichlet(_softplus(_reshape_event(params, event_shape)))


def _bernoulli_builder(params, event_shape, **kw):
  return _indep(D.Bernoulli(logits=_reshape_event(params, event_shape)),
                event_shape)


def _cbernoulli_builder(params, event_shape, **kw):
  return _indep(D.ContinuousBernoulli(
      logits=_reshape_event(params, event_shape)), event_shape)


def _zibernoulli_builder(params, event_shape, **kw):
  logits, gate = _split(params, 2, event_shape)
  return _indep(D.ZeroInflated(D.Bernoulli(logits=logits), logits=gate),
                event_shape)


def _relaxedbernoulli_builder(params, event_shape, temperature=0.5, **kw):
  return _indep(D.RelaxedBernoulli(
      torch.as_tensor(temperature, dtype=params.dtype, device=params.device),
      logits=_reshape_event(params, event_shape)), event_shape)


def _onehot_builder(params, event_shape, **kw):
  return D.OneHotCategorical(logits=_reshape_event(params, event_shape))


def _categorical_builder(params, event_shape, **kw):
  return D.Categorical(logits=_reshape_event(params, event_shape))


def _relaxedonehot_builder(params, event_shape, temperature=0.5, **kw):
  return D.RelaxedOneHotCategorical(
      torch.as_tensor(temperature, dtype=params.dtype, device=params.device),
      logits=_reshape_event(params, event_shape))


def _poisson_builder(params, event_shape, **kw):
  return _indep(D.Poisson(log_rate=_reshape_event(params, event_shape)),
                event_shape)


def _zipoisson_builder(params, event_shape, **kw):
  log_rate, gate = _split(params, 2, event_shape)
  return _indep(D.ZeroInflated(D.Poisson(log_rate=log_rate), logits=gate),
                event_shape)


def _nb_builder(params, event_shape, **kw):
  count, logits = _split(params, 2, event_shape)
  return _indep(D.NegativeBinomial(_softplus(count), logits=logits),
                event_shape)


def _zinb_builder(params, event_shape, **kw):
  count, logits, gate = _split(params, 3, event_shape)
  return _indep(D.ZeroInflated(D.NegativeBinomial(_softplus(count),
                                                  logits=logits),
                               logits=gate), event_shape)


def _nbd_builder(params, event_shape, **kw):
  loc, disp = _split(params, 2, event_shape)
  return _indep(D.NegativeBinomialDisp(_softplus(loc), _softplus(disp)),
                event_shape)


def _zinbd_builder(params, event_shape, **kw):
  loc, disp, gate = _split(params, 3, event_shape)
  return _indep(D.ZeroInflated(D.NegativeBinomialDisp(_softplus(loc),
                                                      _softplus(disp)),
                               logits=gate), event_shape)


def _binomial_builder(params, event_shape, total_count=1.0, **kw):
  return _indep(D.Binomial(total_count,
                           logits=_reshape_event(params, event_shape)),
                event_shape)


def _multinomial_builder(params, event_shape, total_count=1.0, **kw):
  return D.Multinomial(total_count,
                       logits=_reshape_event(params, event_shape))


def _dirimultinomial_builder(params, event_shape, total_count=1.0, **kw):
  return D.DirichletMultinomial(
      total_count, _softplus(_reshape_event(params, event_shape)))


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
  """K logits, then K·d locations, then K·d raw scales ('diag') or K raw
  lower-triangular factors of d(d+1)/2 entries each ('tril')."""
  d = _size(event_shape)
  K = n_components
  logits, rest = params[..., :K], params[..., K:]
  lead = tuple(rest.shape[:-1])
  locs = rest[..., :K * d].reshape(lead + (K, d))
  if covariance in ("diag", "none"):
    scales = _softplus(rest[..., K * d:].reshape(lead + (K, d)))
    return D.GaussianMixture(logits, locs, scales, covariance="diag")
  raw = rest[..., K * d:].reshape(lead + (K, d * (d + 1) // 2))
  return D.GaussianMixture(logits, locs, _fill_tril(raw, d),
                           covariance="tril")


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


def _mixnb_params_size(event_size, n_components=2, zero_inflated=False,
                       **kw):
  per = 3 if zero_inflated else 2
  return n_components * (1 + per * event_size)


def _activation(name: str):
  """``jax.nn``'s activation `name` (softplus, relu, sigmoid, ...)."""
  fn = getattr(F, name, None) or getattr(torch, name, None)
  if fn is None:
    raise ValueError(f"unknown mean_activation {name!r}")
  return fn


def _mixnb_builder(params, event_shape, n_components=2, zero_inflated=False,
                   mean_activation="softplus", **kw):
  """A mixture of mean/dispersion negative binomials (scVI's count heads):
  K logits, then K·d means (`mean_activation`, plus 1e-8), K·d raw
  dispersions (softplus, plus 1e-8) and, `zero_inflated`, K·d gate
  logits."""
  d = _size(event_shape)
  K = n_components
  logits, rest = params[..., :K], params[..., K:]
  lead = tuple(rest.shape[:-1])
  loc = _activation(mean_activation)(rest[..., :K * d]).reshape(
      lead + (K, d)) + 1e-8
  disp = _softplus(rest[..., K * d:2 * K * d]).reshape(lead + (K, d)) + 1e-8
  comp = D.NegativeBinomialDisp(loc, disp)
  if zero_inflated:
    comp = D.ZeroInflated(comp, logits=rest[..., 2 * K * d:].reshape(
        lead + (K, d)))
  return D.MixtureSameFamily(D.Categorical(logits=logits),
                             D.Independent(comp, len(event_shape) or 1))


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


def _tril_params_size(d, **kw):
  return d + d * (d + 1) // 2


register_distribution_alias(("normal", "gaussian"), DistSpec(
    "normal", _n_params(2), _normal_builder, _std_normal_prior))
register_distribution_alias("lognormal", DistSpec(
    "lognormal", _n_params(2), _lognormal_builder, _std_normal_prior))
register_distribution_alias("mvndiag", DistSpec(
    "mvndiag", _n_params(2), _mvndiag_builder, _mvndiag_prior))
register_distribution_alias("mvntril", DistSpec(
    "mvntril", _tril_params_size, _mvntril_builder, _mvndiag_prior))
register_distribution_alias("mvnfull", DistSpec(
    "mvnfull", _tril_params_size, _mvntril_builder, _mvndiag_prior))
register_distribution_alias("gamma", DistSpec(
    "gamma", _n_params(2), _gamma_builder, _no_prior))
register_distribution_alias("beta", DistSpec(
    "beta", _n_params(2), _beta_builder, _no_prior))
register_distribution_alias("dirichlet", DistSpec(
    "dirichlet", _n_params(1), _dirichlet_builder, _dirichlet_prior))
register_distribution_alias("bernoulli", DistSpec(
    "bernoulli", _n_params(1), _bernoulli_builder, _no_prior))
register_distribution_alias("cbernoulli", DistSpec(
    "cbernoulli", _n_params(1), _cbernoulli_builder, _no_prior))
register_distribution_alias(("zibernoulli", "zeroinflatedbernoulli"), DistSpec(
    "zibernoulli", _n_params(2), _zibernoulli_builder, _no_prior))
register_distribution_alias(
    ("relaxedbern", "relaxedsigmoid", "relaxedbernoulli"), DistSpec(
        "relaxedbernoulli", _n_params(1), _relaxedbernoulli_builder,
        _no_prior))
register_distribution_alias(("onehot",), DistSpec(
    "onehot", _n_params(1), _onehot_builder, _onehot_prior))
register_distribution_alias(("cat", "categorical", "discrete"), DistSpec(
    "categorical", _n_params(1), _categorical_builder, _onehot_prior))
register_distribution_alias(
    ("relaxedsoftmax", "relaxedonehot", "gumbel_softmax"), DistSpec(
        "relaxedonehot", _n_params(1), _relaxedonehot_builder,
        _onehot_prior))
register_distribution_alias(("pois", "poisson"), DistSpec(
    "poisson", _n_params(1), _poisson_builder, _no_prior))
register_distribution_alias(
    ("zip", "zipois", "zipoisson", "zeroinflatedpoisson"), DistSpec(
        "zipoisson", _n_params(2), _zipoisson_builder, _no_prior))
register_distribution_alias(
    ("nb", "negativebinomial", "nbfull", "nbshare", "nbsingle"), DistSpec(
        "nb", _n_params(2), _nb_builder, _no_prior))
register_distribution_alias(("zinb", "zinbfull", "zinbshare", "zinbsingle"),
                            DistSpec("zinb", _n_params(3), _zinb_builder,
                                     _no_prior))
register_distribution_alias(
    ("nbd", "negativebinomialdisp", "nbdfull", "nbdshare", "nbdsingle"),
    DistSpec("nbd", _n_params(2), _nbd_builder, _no_prior))
register_distribution_alias(
    ("zinbd", "zinbdfull", "zinbdshare", "zinbdsingle"), DistSpec(
        "zinbd", _n_params(3), _zinbd_builder, _no_prior))
register_distribution_alias("binomial", DistSpec(
    "binomial", _n_params(1), _binomial_builder, _no_prior))
register_distribution_alias("multinomial", DistSpec(
    "multinomial", _n_params(1), _multinomial_builder, _no_prior))
register_distribution_alias(("dirimultinomial", "dirichletmultinomial"),
                            DistSpec("dirimultinomial", _n_params(1),
                                     _dirimultinomial_builder, _no_prior))
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
register_distribution_alias(("mixnb", "nbmixture"), DistSpec(
    "mixnb", _mixnb_params_size, _mixnb_builder, _no_prior))
register_distribution_alias(("mixzinb", "zinbmixture"), DistSpec(
    "mixzinb",
    lambda d, n_components=2, **kw: _mixnb_params_size(
        d, n_components, zero_inflated=True),
    lambda p, e, n_components=2, **kw: _mixnb_builder(
        p, e, n_components, zero_inflated=True, **kw),
    _no_prior))
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
