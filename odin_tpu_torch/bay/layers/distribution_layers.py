"""Named distribution-layer classes (PyTorch port of
``odin_tpu/bay/layers/distribution_layers.py``): one ``DistributionDense``
subclass per family, under the JAX package's class names, with its alias
fixed and ``projection=False`` by default (raw parameters in, the
distribution out); ``projection=True`` prepends the Dense projection."""
from __future__ import annotations

from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense

__all__ = [
    "GaussianLayer", "NormalLayer", "LogNormalLayer", "GammaLayer",
    "BetaLayer", "DirichletLayer", "MultivariateNormalLayer",
    "BernoulliLayer", "ContinuousBernoulliLayer", "ZIBernoulliLayer",
    "CategoricalLayer", "OneHotCategoricalLayer", "RelaxedBernoulliLayer",
    "RelaxedOneHotCategoricalLayer", "BinomialLayer", "MultinomialLayer",
    "DirichletMultinomialLayer", "PoissonLayer", "ZIPoissonLayer",
    "NegativeBinomialLayer", "NegativeBinomialDispLayer",
    "ZINegativeBinomialLayer", "ZINegativeBinomialDispLayer",
    "MixtureGaussianLayer", "MixtureNegativeBinomialLayer",
    "MixtureQLogisticLayer", "QuantizedLogisticLayer", "DeterministicLayer",
    "VectorDeterministicLayer", "VonMisesFisherLayer",
]

# class name -> alias in the distribution registry (the JAX package's
# table, ``distribution_layers.py:33-81``)
_LAYER_ALIASES = {
    "GaussianLayer": "gaussian",
    "NormalLayer": "normal",
    "LogNormalLayer": "lognormal",
    "GammaLayer": "gamma",
    "BetaLayer": "beta",
    "DirichletLayer": "dirichlet",
    "MultivariateNormalLayer": "mvntril",
    "BernoulliLayer": "bernoulli",
    "ContinuousBernoulliLayer": "cbernoulli",
    "ZIBernoulliLayer": "zibernoulli",
    "CategoricalLayer": "categorical",
    "OneHotCategoricalLayer": "onehot",
    "RelaxedBernoulliLayer": "relaxedbernoulli",
    "RelaxedOneHotCategoricalLayer": "relaxedonehot",
    "BinomialLayer": "binomial",
    "MultinomialLayer": "multinomial",
    "DirichletMultinomialLayer": "dirichletmultinomial",
    "PoissonLayer": "poisson",
    "ZIPoissonLayer": "zipoisson",
    "NegativeBinomialLayer": "negativebinomial",
    "NegativeBinomialDispLayer": "negativebinomialdisp",
    "ZINegativeBinomialLayer": "zinb",
    "ZINegativeBinomialDispLayer": "zinbd",
    "MixtureGaussianLayer": "gmm",
    "MixtureNegativeBinomialLayer": "nbmixture",
    "MixtureQLogisticLayer": "mixqlogistic",
    "QuantizedLogisticLayer": "qlogistic",
    "DeterministicLayer": "deterministic",
    "VectorDeterministicLayer": "vdeterministic",
    "VonMisesFisherLayer": "vmf",
}


def _make_layer(name: str, alias: str):

  def __init__(self, event_shape=(), posterior=None, posterior_kwargs=None,
               projection=False, **kwargs):
    DistributionDense.__init__(self, event_shape, posterior, posterior_kwargs,
                               projection, **kwargs)

  return type(name, (DistributionDense,), {
      "__doc__": f"The `{alias}` layer: raw params in, the distribution "
                 "out (a Dense projection first with projection=True).",
      "__init__": __init__,
      "default_posterior": alias,
  })


_g = globals()
for _name, _alias in _LAYER_ALIASES.items():
  _g[_name] = _make_layer(_name, _alias)
del _g, _name, _alias
