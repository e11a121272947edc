"""The port's disentanglement evaluation (``odin_tpu_torch/bay/vi``: utils,
metrics, downstream_metrics, giga, the Gym) against the JAX package's on
the CPU, on the same numpy inputs drawn from a seed.

Score functions: 1,500 rows of 4-10 latents that are noisy mixes of five
dSprites-like factors (3, 6, 40, 32 and 32 values).  Limits:
- exact: ``discretizing``, ``permute_dims`` on the same uniforms, the
  semi-supervised helpers, ``concat_distributions``, and the FactorVAE
  votes and score (both protocols);
- MIG (both protocols) to 1e-10, the mutual information and entropies to
  1e-14 (float64 rounding of logs summed in another order);
- Spearman matrices to 1e-10, Pearson to 1e-6 (scipy keeps float32 input
  in float32, the port sums in float64), ``relative_strength`` to 1e-12 on
  the same matrix;
- DCI: the importance matrix (relative to its max), disentanglement and
  completeness to 1e-6 where scikit-learn's boosted trees do not depend on
  their random_state; where they do (splits of equal gain, see
  tests/test_torch_estimators.py), to twice the spread of scikit-learn's
  own values over three other random states.  Informativeness to one
  prediction of the test split (1/n_test), plus that spread;
- SAP: each (latent, factor) accuracy to one prediction of the test split,
  SAP to two;
- the beta-VAE score (both protocols) and ``accuracy_score``: to one
  prediction of the rows scored against the JAX package's functions with
  scikit-learn's lbfgs run to the minimiser (tol 1e-12 on float64), which
  the port's Newton solver reaches; against the call as the JAX package
  makes it (lbfgs stopped at tol 1e-4 on float32 features) to 0.5 % of the
  rows scored (measured: up to 0.08 %).  ``estimate_Izy`` to rtol 1e-5 of
  the converged probe and 1e-2 of the one as made (measured 3.5e-3);
- FID and ``estimate_Izx`` to rtol 1e-6 (float64 and float32 sums).
With ``n_mcmc > 0`` the port is given the JAX package's draws: the seed it
draws from the shared ``RandomState`` keys JAX's PRNG, as JAX does.

The whole Gym: ``dSpritesSmall(n_samples=256)``, ``BetaVAE`` at zdim 4 (as
tests/test_gym.py:141-154) on the same weights (the JAX state made from the
port's params with ``to_jax_params``: flax's init takes 10 s here) and with
JAX's ELBO noise injected, 200 test images in batches of 64 (a padded
tail).  ``z_mean`` within 1e-5 of JAX's (XLA and torch round the
convolutions apart).  ``write_report``'s default suite plus FID has no
``_error`` key; TC, ``kl_unweighted``, ``active_units``, FID and the ELBO
terms within rtol 1e-4 of JAX's report; every other score at the limits
above against JAX's score functions applied to the port's own
``z_mean`` (a bin edge or a split may flip between the two ``z_mean``s).

``python tests/test_torch_gym.py`` prints the measured distances behind
the logistic probes' limits.
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jvi
from odin_tpu.backend import metrics as jmetrics
from odin_tpu.bay import distributions as jd
from odin_tpu.bay.helpers import concat_distributions as jconcat
from odin_tpu.bay.vi import downstream_metrics as jdm
from odin_tpu.bay.vi import giga as jgiga
from odin_tpu.bay.vi import metrics as jm
from odin_tpu.bay.vi import utils as jutils
from odin_tpu.fuel import dSpritesSmall as JdSpritesSmall
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu.training.core import TrainState as JaxTrainState
from sklearn.ensemble import GradientBoostingClassifier as SkGBT
from sklearn.model_selection import train_test_split as sk_split

import odin_tpu_torch.bay.vi as vi
from odin_tpu_torch.backend import metrics as pmetrics
from odin_tpu_torch.bay import distributions as pd
from odin_tpu_torch.bay.helpers import concat_distributions
from odin_tpu_torch.bay.vi import downstream_metrics as dm
from odin_tpu_torch.bay.vi import giga
from odin_tpu_torch.bay.vi import metrics as pm
from odin_tpu_torch.bay.vi import utils as putils
from odin_tpu_torch.fuel import dSpritesSmall
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.weights import to_jax_params

torch.set_num_threads(2)
warnings.filterwarnings("ignore", module="sklearn")

SIZES = (3, 6, 40, 32, 32)
N = 1500
# the share of the scored rows on which the JAX package's logistic probes
# (lbfgs stopped at tol 1e-4 on float32 features) may predict otherwise
# than the minimiser the port solves for (measured: up to 0.08 %)
LR_SHARE = 0.005
# estimate_Izy against the probe as the JAX package fits it: its log-loss
# moves with lbfgs' shortfall (measured: up to 3.5e-3 relative, where the
# information is smallest)
IZY_RTOL = 1e-2
# Pearson: scipy computes float32 inputs in float32, the port in float64
PEARSON_ATOL = 1e-6


def latents_and_factors(n=N, d=6, seed=0):
  """(z (n, d) float32, factors (n, 5) int64): each latent a noisy mix of
  factors scaled to [0, 1]."""
  rng = np.random.RandomState(seed)
  f = np.stack([rng.randint(0, k, n) for k in SIZES], 1)
  u = f / (np.array(SIZES) - 1.0)
  mix = rng.rand(len(SIZES), d) * (rng.rand(len(SIZES), d) < 0.4)
  mix[np.arange(d) % len(SIZES), np.arange(d)] += 1.0
  z = u @ mix + 0.3 * rng.randn(n, d)
  return z.astype(np.float32), f


@pytest.fixture
def converged_lbfgs(monkeypatch):
  """Within the test, scikit-learn's ``LogisticRegression`` (which the JAX
  package's scores import when called) runs lbfgs to the minimiser: tol
  1e-12 on float64 features, where the JAX package's call stops at tol
  1e-4 on float32 ones."""
  import sklearn.linear_model

  base = sklearn.linear_model.LogisticRegression

  class Converged(base):
    def __init__(self, C=1.0, max_iter=100, random_state=None):
      super().__init__(C=C, max_iter=100000, tol=1e-12,
                       random_state=random_state)

    def fit(self, X, y):
      return super().fit(np.asarray(X, np.float64), y)

  def use():
    monkeypatch.setattr(sklearn.linear_model, "LogisticRegression",
                        Converged)

  def undo():
    monkeypatch.setattr(sklearn.linear_model, "LogisticRegression", base)

  return use, undo


class JaxDraws:
  """A posterior (the port's) whose samples are the JAX package's: the
  seed the port's score draws from its RandomState keys JAX's PRNG, as
  the JAX score keys it."""

  def __init__(self, loc, scale):
    self.loc = torch.as_tensor(loc)
    self.jqz = jd.MultivariateNormalDiag(jnp.asarray(loc), jnp.asarray(scale))

  def mean(self):
    return self.loc

  def sample(self, sample_shape, generator):
    key = jax.random.PRNGKey(generator.initial_seed())
    return torch.from_numpy(np.asarray(self.jqz.sample(key, sample_shape)))


# ---------------------------------------------------------------------------
# utils and distributions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bins", [8, 20])
def test_discretizing_matches_jax(n_bins):
  z, f = latents_and_factors()
  want = jutils.discretizing(z, f.astype(np.float32), n_bins=n_bins)
  got = putils.discretizing(torch.tensor(z), torch.tensor(f),
                            n_bins=n_bins)
  for a, b in zip(want, got):
    np.testing.assert_array_equal(b.numpy(), a)
  # the quantile strategy, once a raise (tests/test_torch_gym_clustering.py
  # holds the others)
  np.testing.assert_array_equal(
      putils.discretizing(torch.tensor(z), n_bins=n_bins,
                          strategy="quantile").numpy(),
      jutils.discretizing(z, n_bins=n_bins, strategy="quantile"))


def test_permute_dims_with_jax_uniforms():
  z, _ = latents_and_factors(n=64)
  key = jax.random.PRNGKey(3)
  want = np.asarray(jutils.permute_dims(jnp.asarray(z), key))
  u = np.asarray(jax.random.uniform(key, z.shape))
  got = putils.permute_dims(torch.tensor(z), uniforms=torch.tensor(u))
  np.testing.assert_array_equal(got.numpy(), want)
  drawn = putils.permute_dims(torch.tensor(z),
                              generator=torch.Generator().manual_seed(0))
  np.testing.assert_array_equal(np.sort(drawn.numpy(), 0), np.sort(z, 0))


def test_ssl_helpers_match_jax():
  x = np.arange(24, dtype=np.float32).reshape(6, 4)
  y = np.arange(6)
  mask = np.array([1, 0, 1, 1, 0, 0], bool)
  assert putils.prepare_ssl_inputs([x, y], mask, 1)[0][0] is x
  (xl, yl), (xu,) = putils.split_ssl_inputs(torch.tensor(x), y, mask)
  (jxl, jyl), (jxu,) = jutils.split_ssl_inputs(x, y, mask)
  np.testing.assert_array_equal(xl.numpy(), jxl)
  np.testing.assert_array_equal(yl.numpy(), jyl)
  np.testing.assert_array_equal(xu.numpy(), jxu)
  got = putils.marginalize_categorical_labels(torch.tensor(x), 3)
  want = jutils.marginalize_categorical_labels(jnp.asarray(x), 3)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_concat_distributions_matches_jax():
  rng = np.random.RandomState(0)
  locs = [rng.randn(b, 4).astype(np.float32) for b in (3, 5)]
  scales = [rng.rand(b, 4).astype(np.float32) + 0.1 for b in (3, 5)]
  logits = [rng.randn(b, 2, 2, 1).astype(np.float32) for b in (3, 5)]
  got = concat_distributions([pd.MultivariateNormalDiag(
      torch.tensor(l), torch.tensor(s)) for l, s in zip(locs, scales)])
  want = jconcat([jd.MultivariateNormalDiag(jnp.asarray(l), jnp.asarray(s))
                  for l, s in zip(locs, scales)])
  np.testing.assert_array_equal(got.mean().numpy(), np.asarray(want.mean()))
  np.testing.assert_array_equal(got.stddev().numpy(),
                                np.asarray(want.stddev()))
  got = concat_distributions([pd.Independent(pd.Bernoulli(
      torch.tensor(l)), 3) for l in logits])
  want = jconcat([jd.Independent(jd.Bernoulli(logits=jnp.asarray(l)), 3)
                  for l in logits])
  x = (rng.rand(8, 2, 2, 1) < 0.5).astype(np.float32)
  np.testing.assert_allclose(got.log_prob(torch.tensor(x)).numpy(),
                             np.asarray(want.log_prob(x)), rtol=1e-6)
  assert got.reinterpreted_batch_ndims == 3
  with pytest.raises(TypeError):
    concat_distributions([pd.Bernoulli(torch.tensor(logits[0])),
                          pd.MultivariateNormalDiag(torch.tensor(locs[0]),
                                                    torch.tensor(scales[0]))])
  # a Normal (M3's joint posterior, an Independent Normal) concatenates
  got = concat_distributions([pd.Independent(pd.Normal(
      torch.tensor(l), torch.tensor(s)), 1) for l, s in zip(locs, scales)])
  want = jconcat([jd.Independent(jd.Normal(jnp.asarray(l), jnp.asarray(s)),
                                 1) for l, s in zip(locs, scales)])
  np.testing.assert_array_equal(got.stddev().numpy(),
                                np.asarray(want.stddev()))
  with pytest.raises(NotImplementedError):
    concat_distributions([pd.SphericalUniform(4)] * 2)


def test_ground_truth_matches_jax():
  """Discrete columns kept, a continuous one binned (8 uniform bins), and
  the samplers' draws."""
  z, f = latents_and_factors(n=500)
  factors = np.concatenate([f[:, :2].astype(np.float32), z[:, :1]], 1)
  got = vi.GroundTruth(factors, ["a", "b", "c"], device="cpu")
  want = jvi.GroundTruth(factors, ["a", "b", "c"])
  np.testing.assert_array_equal(got.factors, want.factors)
  assert got.factor_names == want.factor_names and got.shape == want.shape
  for a, b in zip(got.sample_factors(7, seed=3), want.sample_factors(7,
                                                                     seed=3)):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(
      got.sample_indices_from_factors(want.factors[:5], seed=2),
      want.sample_indices_from_factors(want.factors[:5], seed=2))


# ---------------------------------------------------------------------------
# metrics.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bins", [8, 20])  # the reference and dlib bins
def test_mutual_info_gap_matches_jax(n_bins):
  z, f = latents_and_factors(d=10)
  codes = jutils.discretizing(z, n_bins=n_bins)
  np.testing.assert_allclose(
      pm.discrete_mutual_info(torch.tensor(codes), torch.tensor(f)).numpy(),
      jm.discrete_mutual_info(codes, f), rtol=0, atol=1e-14)
  np.testing.assert_allclose(pm.discrete_entropy(torch.tensor(f)).numpy(),
                             jm.discrete_entropy(f), rtol=0, atol=1e-14)
  assert float(pm.discrete_entropy(torch.tensor(f[:, 0]))) == \
      pytest.approx(jm.discrete_entropy(f[:, 0]), abs=1e-14)
  assert pm.mutual_info_gap(torch.tensor(codes), torch.tensor(f)) == \
      pytest.approx(jm.mutual_info_gap(codes, f), abs=1e-10)


@pytest.mark.parametrize("method", ["spearman", "pearson"])
def test_correlation_matrix_matches_jax(method):
  z, f = latents_and_factors(d=5)
  f = f.astype(np.float32)
  f[:, 4] = 7.0  # a constant column: NaN -> 0 in both
  want = jm.correlation_matrix(z, f, method=method)
  got = pm.correlation_matrix(torch.tensor(z), torch.tensor(f),
                              method=method).numpy()
  # scipy's pearsonr keeps float32 inputs in float32; ranks are float64
  atol = PEARSON_ATOL if method == "pearson" else 1e-10
  np.testing.assert_allclose(got, want, rtol=0, atol=atol)
  assert pm.relative_strength(torch.tensor(want)) == pytest.approx(
      jm.relative_strength(want), abs=1e-12)
  assert pm.relative_strength(torch.tensor(got)) == pytest.approx(
      jm.relative_strength(want), abs=atol)


def test_unported_estimators_raise():
  """The estimators that raised until ported ('lasso' and 'mutualinfo'
  correlations, ``mutual_info_estimate``, ``unsupervised_clustering_scores``)
  against JAX's on 50 rows, where factor values seen once are dropped by the
  k-NN estimate and the 40-value factor leaves some of KMeans' clusters
  small (tests/test_torch_gym_clustering.py holds them at full size)."""
  z, f = latents_and_factors(n=50)
  for method in ("lasso", "mutualinfo"):
    want = jm.correlation_matrix(z, f, method=method)
    got = pm.correlation_matrix(torch.tensor(z), torch.tensor(f),
                                method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
  np.testing.assert_allclose(
      pm.mutual_info_estimate(torch.tensor(z), torch.tensor(f)).numpy(),
      jm.mutual_info_estimate(z, f), rtol=0, atol=1e-6)
  for j in range(f.shape[1]):
    want = jm.unsupervised_clustering_scores(f[:, j], z)
    got = pm.unsupervised_clustering_scores(torch.tensor(f[:, j]),
                                            torch.tensor(z))
    assert set(got) == set(want)
    for key in ("ari", "ami", "nmi"):
      assert got[key] == pytest.approx(want[key], abs=1e-12), (j, key)
    assert got["asw"] == pytest.approx(want["asw"], abs=1e-6), j


# ---------------------------------------------------------------------------
# downstream_metrics.py
# ---------------------------------------------------------------------------
def _sk_dci(ztr, ftr, zte, fte, random_state):
  """JAX's importance_matrix and DCI with the trees' random_state set
  apart from the split's seed."""
  mat = np.zeros((ztr.shape[1], ftr.shape[1]))
  acc = []
  for j in range(ftr.shape[1]):
    m = SkGBT(n_estimators=10, random_state=random_state).fit(ztr, ftr[:, j])
    mat[:, j] = m.feature_importances_
    acc.append(np.mean(m.predict(zte) == fte[:, j]))
  return (mat, jdm.disentanglement_score(mat), jdm.completeness_score(mat),
          float(np.mean(acc)))


def assert_dci_close(z, f, got_mat, got_dci, seed=1):
  """The port's DCI against the JAX package's at the limits of this
  module's docstring."""
  want_mat, _, test_acc = jdm.importance_matrix(z, f, seed=seed)
  want = (jdm.disentanglement_score(want_mat),
          jdm.completeness_score(want_mat), float(np.mean(test_acc)))
  ztr, zte, ftr, fte = sk_split(z, f, test_size=0.2, random_state=seed)
  others = [_sk_dci(ztr, ftr, zte, fte, r) for r in range(seed + 1,
                                                          seed + 4)]
  scale = want_mat.max()
  spread = max(np.abs(o[0] - want_mat).max() for o in others)
  np.testing.assert_allclose(got_mat / scale, want_mat / scale, rtol=0,
                             atol=max(1e-6, 2 * spread / scale))
  for i in range(2):
    s = max(abs(o[1 + i] - want[i]) for o in others)
    assert abs(got_dci[i] - want[i]) <= max(1e-6, 2 * s), (i, got_dci, want)
  s = max(abs(o[3] - want[2]) for o in others)
  assert abs(got_dci[2] - want[2]) <= 1.0 / len(zte) + 2 * s + 1e-12


def test_dci_matches_jax():
  z, f = latents_and_factors(n=800, d=6)
  mat = pm.correlation_matrix(torch.tensor(z), torch.tensor(f),
                              method="importance", seed=1).numpy()
  got = dm.dci_scores(torch.tensor(z), torch.tensor(f), seed=1)
  assert got[0] == pytest.approx(dm.disentanglement_score(torch.tensor(mat)),
                                 abs=1e-12)
  assert_dci_close(z, f, mat, got)


def _jax_sap_matrix(z, f, seed=1):
  """The score matrix of JAX's separated_attr_predictability (its loop,
  with the same scikit-learn calls)."""
  from sklearn.preprocessing import StandardScaler
  from sklearn.svm import LinearSVC
  ztr, zte, ftr, fte = sk_split(z, f, test_size=0.2, random_state=seed)
  out = np.zeros((z.shape[1], f.shape[1]))
  for i in range(z.shape[1]):
    for j in range(f.shape[1]):
      svc = LinearSVC(C=0.01, max_iter=4000, class_weight="balanced",
                      random_state=seed)
      sc = StandardScaler()
      svc.fit(sc.fit_transform(ztr[:, i][:, None]), ftr[:, j])
      out[i, j] = np.mean(svc.predict(sc.transform(zte[:, i][:, None])) ==
                          fte[:, j])
  return out, len(zte)


@pytest.mark.parametrize("d", [4, 10])
def test_sap_matches_jax(d):
  z, f = latents_and_factors(d=d)
  want, n_test = _jax_sap_matrix(z, f)
  got = dm.sap_matrix(torch.tensor(z), torch.tensor(f), seed=1).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / n_test + 1e-12)
  sap = dm.separated_attr_predictability(torch.tensor(z), torch.tensor(f),
                                         seed=1)
  assert abs(sap - jdm.separated_attr_predictability(z, f, seed=1)) <= \
      2.0 / n_test + 1e-12
  cont = dm.separated_attr_predictability(
      torch.tensor(z), torch.tensor(f.astype(np.float32)),
      continuous_factors=True, seed=1)
  assert cont == pytest.approx(jdm.separated_attr_predictability(
      z, f.astype(np.float32), continuous_factors=True, seed=1), rel=1e-5)


@pytest.mark.parametrize("protocol", ["reference", "dlib"])
def test_beta_vae_score_matches_jax(protocol, converged_lbfgs):
  z, f = latents_and_factors(d=6)
  scale = (0.05 + 0.1 * np.random.RandomState(1).rand(*z.shape)).astype(
      np.float32)
  if protocol == "dlib":
    kw = dict(n_mcmc=0, batch_size=64, n_samples=2000, n_eval_samples=1000)
    n_scored = 1000
  else:
    kw = dict(n_mcmc=10, batch_size=10, n_samples=2000)
    n_scored = 2000
  jqz = jd.MultivariateNormalDiag(jnp.asarray(z), jnp.asarray(scale))
  got = dm.beta_vae_score(JaxDraws(z, scale), torch.tensor(f), seed=1, **kw)
  as_made = jdm.beta_vae_score(jqz, f, seed=1, **kw)
  assert abs(got - as_made) <= LR_SHARE, (got, as_made)
  use, undo = converged_lbfgs
  use()
  converged = jdm.beta_vae_score(jqz, f, seed=1, **kw)
  undo()
  assert abs(got - converged) <= 1.0 / n_scored + 1e-12, (got, converged)


@pytest.mark.parametrize("protocol", ["reference", "dlib"])
def test_factor_vae_score_matches_jax(protocol):
  z, f = latents_and_factors(d=6)
  z[:, 5] = 0.5 + 1e-9 * z[:, 5]  # a collapsed latent, pruned
  scale = (0.05 + 0.1 * np.random.RandomState(1).rand(*z.shape)).astype(
      np.float32)
  if protocol == "dlib":
    kw = dict(n_mcmc=0, batch_size=64, n_samples=2000, n_eval_samples=1000,
              prune_threshold=0.05, prune_scale="std")
  else:
    kw = dict(n_mcmc=10, batch_size=256, n_samples=2000)
  jqz = jd.MultivariateNormalDiag(jnp.asarray(z), jnp.asarray(scale))
  want, want_labels = jdm.factor_vae_score(jqz, f, seed=1, return_model=True,
                                           **kw)
  got, labels = dm.factor_vae_score(JaxDraws(z, scale), torch.tensor(f),
                                    seed=1, return_model=True, **kw)
  assert got == want
  np.testing.assert_array_equal(labels.numpy(), want_labels)


def test_giga_matches_jax(converged_lbfgs):
  z, f = latents_and_factors(n=600, d=5)
  use, undo = converged_lbfgs
  for j in range(len(SIZES)):
    got = giga.estimate_Izy(torch.tensor(z), torch.tensor(f[:, j]), seed=1)
    as_made = jgiga.estimate_Izy(z, f[:, j], seed=1)
    use()
    converged = jgiga.estimate_Izy(z, f[:, j], seed=1)
    undo()
    assert got == pytest.approx(converged, rel=1e-5, abs=1e-8), j
    assert got == pytest.approx(as_made, rel=IZY_RTOL), j
  scale = (0.1 + 0.2 * np.random.RandomState(2).rand(*z.shape)).astype(
      np.float32)
  eps = np.random.RandomState(3).randn(*z.shape).astype(np.float32)
  zs = z + scale * eps
  want = jgiga.estimate_Izx(
      jd.MultivariateNormalDiag(jnp.asarray(z), jnp.asarray(scale)),
      jnp.asarray(zs))
  got = giga.estimate_Izx(pd.MultivariateNormalDiag(torch.tensor(z),
                                                    torch.tensor(scale)),
                          torch.tensor(zs))
  assert got == pytest.approx(want, rel=1e-6)


def test_frechet_matches_jax():
  rng = np.random.RandomState(0)
  a = rng.randn(500, 8).astype(np.float32)
  b = (rng.randn(500, 8) * 1.3 + 0.2).astype(np.float32)
  want = jmetrics.frechet_inception_distance(a, b)
  got = pmetrics.frechet_inception_distance(torch.tensor(a), torch.tensor(b))
  assert got == pytest.approx(want, rel=1e-6)
  assert pmetrics.frechet_distance(np.zeros(2), np.eye(2), np.ones(2),
                                   np.eye(2)) == pytest.approx(
                                       jmetrics.frechet_distance(
                                           np.zeros(2), np.eye(2),
                                           np.ones(2), np.eye(2)), abs=1e-12)


# ---------------------------------------------------------------------------
# the whole Gym
# ---------------------------------------------------------------------------
ZDIM = 4
N_GYM = 200
SCORES = ("elbo", "llk", "kl", "mig", "sap", "dci", "betavae", "factorvae",
          "tc", "active_units", "fid")


@pytest.fixture(scope="module")
def gyms():
  vae = vi.BetaVAE(**get_networks("dsprites", zdim=ZDIM)).build(
      seed=1, device="cpu")
  jvae = jvi.BetaVAE(**jax_get_networks("dsprites", zdim=ZDIM))
  jvae.input_shape = (64, 64, 1)
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(2), mutables={})
  jgym = jvi.DisentanglementGym(dataset=JdSpritesSmall(n_samples=256),
                                model=jvae, batch_size=64)
  jgym.run_model(n_samples=N_GYM, partition="test")
  jreport = jgym.write_report(scores=SCORES)
  # the noise JAX draws for every batch's ELBO (run_model's PRNGKey(seed),
  # split by elbo_components, a normal draw of (batch, zdim))
  eps = np.asarray(jax.random.normal(
      jax.random.split(jax.random.PRNGKey(jgym.seed))[1], (64, ZDIM)))
  gym = vi.DisentanglementGym(dataset=dSpritesSmall(n_samples=256),
                              model=vae, batch_size=64)
  assert gym.device == torch.device("cpu")
  gym.run_model(n_samples=N_GYM, partition="test", eps=torch.tensor(eps))
  report = gym.write_report(scores=SCORES)
  return gym, jgym, report, jreport


def test_gym_run_model_matches_jax(gyms):
  gym, jgym, _, _ = gyms
  np.testing.assert_array_equal(gym.x_true, jgym.x_true)
  np.testing.assert_array_equal(gym.groundtruth.factors,
                                jgym.groundtruth.factors)
  assert gym.groundtruth.factor_names == jgym.groundtruth.factor_names
  assert gym.z_mean.shape == (N_GYM, ZDIM)
  np.testing.assert_allclose(gym.z_mean.numpy(), jgym.z_mean, rtol=0,
                             atol=1e-5)
  np.testing.assert_allclose(gym.log_likelihood_values().numpy(),
                             jgym.log_likelihood_values(), rtol=1e-4)
  np.testing.assert_allclose(gym.kl_divergence_values().numpy(),
                             jgym.kl_divergence_values(), rtol=1e-4)
  np.testing.assert_allclose(gym.px.mean().numpy(),
                             np.asarray(jgym.px.mean()), rtol=0, atol=1e-5)


def test_gym_report_matches_jax(gyms):
  gym, jgym, report, jreport = gyms
  assert not [k for k in report if k.endswith("_error")], report
  assert not [k for k in jreport if k.endswith("_error")], jreport
  assert set(report) == set(jreport)
  for key in ("elbo", "log_likelihood", "kl_divergence", "kl_unweighted",
              "elbo_unweighted", "total_correlation", "fid"):
    assert report[key] == pytest.approx(jreport[key], rel=1e-4), key
  assert report["n_active_units"] == jreport["n_active_units"]
  np.testing.assert_array_equal(gym.active_units(), jgym.active_units())


def test_gym_scores_match_jax_on_the_ports_latents(gyms, converged_lbfgs):
  gym, _, report, _ = gyms
  use, undo = converged_lbfgs
  z = gym.z_mean.numpy()
  f = gym.groundtruth.factors
  n_test = math.ceil(0.2 * len(z))
  for protocol, bins in (("reference", 8), ("dlib", 20)):
    want = jm.mutual_info_gap(jutils.discretizing(z, n_bins=bins), f)
    assert gym.mig_score(protocol) == pytest.approx(want, abs=1e-10)
  assert report["mig"] == gym.mig_score()
  assert abs(report["sap"] - jdm.separated_attr_predictability(z, f, seed=1)
             ) <= 2.0 / n_test + 1e-12
  mat, _, _ = dm.importance_matrix(gym.z_mean, gym._factors_t, seed=1)
  assert_dci_close(z, f, mat.numpy(), (report["dci_disentanglement"],
                                       report["dci_completeness"],
                                       report["dci_informativeness"]))
  assert abs(gym.accuracy_score() - _jax_accuracy_score(z, f[:, 0])) <= \
      1.0 / n_test + 1e-12
  # the reference protocols on JAX's MCMC draws of the port's posterior
  qz = gym.qz
  gym.qz = JaxDraws(qz.mean(), qz.stddev())
  try:
    jqz = gym.qz.jqz
    dlib = dict(n_mcmc=0, batch_size=64, n_samples=10_000,
                n_eval_samples=5_000, seed=1)
    for got, kw, n_scored in ((gym.betavae_score(), dict(
        n_samples=2000, seed=1), 2000), (gym.betavae_score(
            protocol="dlib"), dlib, 5000)):
      assert abs(got - jdm.beta_vae_score(jqz, f, **kw)) <= LR_SHARE
      use()
      assert abs(got - jdm.beta_vae_score(jqz, f, **kw)) <= \
          1.0 / n_scored + 1e-12
      undo()
    assert gym.factorvae_score() == jdm.factor_vae_score(
        jqz, f, n_samples=2000, seed=1)
    assert gym.factorvae_score(protocol="dlib") == jdm.factor_vae_score(
        jqz, f, n_mcmc=0, batch_size=64, n_samples=10_000,
        n_eval_samples=5_000, prune_threshold=0.05, prune_scale="std",
        seed=1)
  finally:
    gym.qz = qz
  for method, atol in (("spearman", 1e-10), ("pearson", PEARSON_ATOL)):
    assert gym.relative_disentanglement_strength(method) == pytest.approx(
        jm.relative_strength(jm.correlation_matrix(
            z, gym.groundtruth.factors_original, method=method)), abs=atol)


def _jax_accuracy_score(z, y):
  """JAX's DisentanglementGym.accuracy_score on given latents (its probe
  run to the minimiser; at 40 test rows one prediction is 2.5 %)."""
  from sklearn.linear_model import LogisticRegression
  xtr, xte, ytr, yte = sk_split(z, y, test_size=0.2, random_state=1)
  return float(LogisticRegression(max_iter=100000, tol=1e-12).fit(
      xtr.astype(np.float64), ytr).score(xte.astype(np.float64), yte))


def test_gym_unported_parts_raise(gyms, tmp_path):
  """The parts of the Gym that raised until ported: the 'clustering' score
  of ``write_report`` against JAX's function on the port's own latents,
  and two plots and ``plot_latent_stats`` drawn (the plots' data is held
  in tests/test_torch_gym_plots.py)."""
  gym = gyms[0]
  report = gym.write_report(scores=("clustering",))
  assert not [k for k in report if k.endswith("_error")], report
  want = jm.unsupervised_clustering_scores(gym.groundtruth.factors[:, 0],
                                           gym.z_mean.numpy(), random_state=1)
  assert set(report) == {f"clustering_{k}" for k in want}
  for key, value in want.items():
    limit = 1e-6 if key == "asw" else 1e-12
    assert report[f"clustering_{key}"] == pytest.approx(value, abs=limit)
  for name in ("plot_reconstruction", "plot_latents_tsne"):
    path = str(tmp_path / f"{name}.png")
    assert getattr(gym, name)(path=path) == path
    with open(path, "rb") as fh:
      assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
  fig = vi.plot_latent_stats(gym.z_mean.mean(0), gym.qz.stddev().mean(0))
  assert len(fig.axes[0].lines) == 2
  assert vi.concat_mean([gym.qz, gym.qz]).shape == (N_GYM, 2 * ZDIM)
  np.testing.assert_array_equal(vi.first_mean([gym.qz]).numpy(),
                                gym.z_mean.numpy())


def report():
  """Print the measured distances behind the logistic probes' limits:
  the port against JAX's functions as made and with lbfgs converged."""
  import sklearn.linear_model
  base = sklearn.linear_model.LogisticRegression

  class Converged(base):
    def __init__(self, C=1.0, max_iter=100, random_state=None):
      super().__init__(C=C, max_iter=100000, tol=1e-12,
                       random_state=random_state)

    def fit(self, X, y):
      return super().fit(np.asarray(X, np.float64), y)

  def both(fn):
    made = fn()
    sklearn.linear_model.LogisticRegression = Converged
    try:
      return made, fn()
    finally:
      sklearn.linear_model.LogisticRegression = base

  z, f = latents_and_factors(d=6)
  scale = (0.05 + 0.1 * np.random.RandomState(1).rand(*z.shape)).astype(
      np.float32)
  jqz = jd.MultivariateNormalDiag(jnp.asarray(z), jnp.asarray(scale))
  for name, kw in (("reference", dict(n_mcmc=10, batch_size=10,
                                      n_samples=2000)),
                   ("dlib", dict(n_mcmc=0, batch_size=64, n_samples=10000,
                                 n_eval_samples=5000))):
    got = dm.beta_vae_score(JaxDraws(z, scale), torch.tensor(f), seed=1, **kw)
    made, conv = both(lambda: jdm.beta_vae_score(jqz, f, seed=1, **kw))
    print(f"beta-VAE {name}: port {got}, JAX as made {made}, JAX converged "
          f"{conv}")
  z, f = latents_and_factors(n=600, d=5)
  for j in range(len(SIZES)):
    got = giga.estimate_Izy(torch.tensor(z), torch.tensor(f[:, j]), seed=1)
    made, conv = both(lambda: jgiga.estimate_Izy(z, f[:, j], seed=1))
    print(f"estimate_Izy factor {j}: port {got:.8f}, relative to JAX as "
          f"made {abs(got - made) / abs(made):.3g}, to JAX converged "
          f"{abs(got - conv) / abs(conv):.3g}")


if __name__ == "__main__":
  report()
