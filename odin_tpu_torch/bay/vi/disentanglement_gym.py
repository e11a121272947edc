"""DisentanglementGym of the port (PyTorch port of
``odin_tpu/bay/vi/disentanglement_gym.py``): ``GroundTruth``,
``concat_mean``, ``first_mean`` and ``DisentanglementGym`` with
``run_model``, every score and ``write_report``.

The Gym runs where its model lives (the card, unless the model was built
with ``device='cpu'``): ``run_model`` encodes and decodes the evaluation
set in batches without gradients and keeps the posterior, the
reconstruction and the per-sample ELBO terms there, and every score runs
the port's estimators on the latents there.  The plots, ``clustering_score``
and the t-SNE plot raise until ported (ROADMAP.md queue 1, item 2).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.backend.metrics import frechet_inception_distance as _fid
from odin_tpu_torch.bay.distributions.base import kl_registry_lookup
from odin_tpu_torch.bay.helpers import (concat_distributions, kl_divergence,
                                        map_distributions)
from odin_tpu_torch.bay.vi import downstream_metrics as _dm
from odin_tpu_torch.bay.vi import metrics as _metrics
from odin_tpu_torch.bay.vi.estimators import (LogisticRegression,
                                              train_test_split)
from odin_tpu_torch.bay.vi.losses import total_correlation as _tc
from odin_tpu_torch.bay.vi.utils import discretizing
from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.training.core import Noise

__all__ = ["GroundTruth", "DisentanglementGym", "concat_mean", "first_mean",
           "plot_latent_stats"]

_CHUNK = 256  # rows a step where a score's work grows with rows squared


def _reshape2D(x) -> torch.Tensor:
  x = torch.as_tensor(x)
  return x.reshape(x.shape[0], -1)


def concat_mean(dists: Sequence[Any]) -> torch.Tensor:
  """The 2-D means of several distributions, side by side."""
  return torch.cat([_reshape2D(d.mean()) for d in dists], -1)


def first_mean(dists: Sequence[Any]) -> torch.Tensor:
  """The 2-D mean of the first distribution."""
  return _reshape2D(dists[0].mean())


def plot_latent_stats(*args, **kwargs):
  """The per-dimension latent statistics plot: not ported yet."""
  raise NotImplementedError("plot_latent_stats is not ported yet "
                            "(ROADMAP.md queue 1, item 2)")


class GroundTruth:
  """The ground-truth factor matrix (host numpy) and its sampling helpers.
  Columns that are not integers with at most 64 values are discretized
  into `n_bins` bins (``discretizing`` on `device`)."""

  def __init__(self, factors, factor_names: Optional[Sequence[str]] = None,
               categorical: Union[bool, Sequence[bool]] = False,
               n_bins: int = 8, strategy: str = "uniform", device=None):
    factors = np.asarray(factors.cpu() if isinstance(factors, torch.Tensor)
                         else factors)
    if factors.ndim == 1:
      factors = factors[:, None]
    self.factors_original = factors
    self.factor_names = list(factor_names) if factor_names is not None else \
        [f"factor{i}" for i in range(factors.shape[1])]
    is_discrete = np.array([
        np.allclose(factors[:, i], np.round(factors[:, i])) and
        len(np.unique(factors[:, i])) <= 64
        for i in range(factors.shape[1])])
    if np.all(is_discrete):
      self.factors = factors.astype(np.int64)
    else:
      cols = []
      for i in range(factors.shape[1]):
        if is_discrete[i]:
          cols.append(factors[:, i].astype(np.int64))
        else:
          cols.append(discretizing(factors[:, i:i + 1], n_bins=n_bins,
                                   strategy=strategy,
                                   device=device).cpu().numpy().ravel())
      self.factors = np.stack(cols, -1)

  @property
  def n_factors(self) -> int:
    return self.factors.shape[1]

  @property
  def shape(self):
    return self.factors.shape

  def sample_factors(self, n: int = 16, seed: int = 1
                     ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(self.factors), size=n, replace=False)
    return self.factors[idx], idx

  def sample_indices_from_factors(self, factors: np.ndarray,
                                  seed: int = 1) -> np.ndarray:
    """Rows of the dataset matching each requested factor combination
    (the nearest in L1, one drawn at random among ties)."""
    rng = np.random.RandomState(seed)
    out = []
    for f in np.atleast_2d(factors):
      dist = np.sum(np.abs(self.factors - f), axis=1)
      out.append(rng.choice(np.where(dist == dist.min())[0]))
    return np.asarray(out)


def _not_ported(name: str):
  def method(self, *args, **kwargs):
    raise NotImplementedError(
        f"DisentanglementGym.{name} is not ported yet (ROADMAP.md queue 1, "
        "item 2)")
  method.__name__ = name
  return method


class DisentanglementGym:
  """Evaluate a VAE's latent space against ground-truth factors::

    gym = DisentanglementGym(dataset=get_dataset("dsprites"), model=vae)
    gym.run_model(n_samples=10000, partition="test")
    scores = gym.write_report("report.txt")

  It runs on the model's device (`device` overrides it)."""

  def __init__(self, dataset=None, model=None, x: Optional[np.ndarray] = None,
               y: Optional[np.ndarray] = None, batch_size: int = 64,
               seed: int = 1, device=None):
    self.model = model
    self.dataset = dataset
    self.batch_size = int(batch_size)
    self.seed = int(seed)
    self._x, self._y = x, y
    if device is None:
      device = getattr(model, "device", None) or "cuda"
    self.device = resolve_device(device)
    self.x_true: Optional[np.ndarray] = None
    self.factors: Optional[np.ndarray] = None
    self.qz = None
    self.px = None
    self.groundtruth: Optional[GroundTruth] = None
    self._z_mean: Optional[torch.Tensor] = None
    self._z_discrete: Optional[torch.Tensor] = None
    self._factors_t: Optional[torch.Tensor] = None
    self._llk_total: Optional[torch.Tensor] = None
    self._kl_total: Optional[torch.Tensor] = None

  # -- data collection --------------------------------------------------------
  @torch.no_grad()
  def run_model(self, n_samples: int = 1000, partition: str = "test",
                n_bins: int = 8, verbose: bool = False, eps=None):
    """Collect x, the factors, q(z|x), p(x|z) and the per-sample ELBO
    terms over the evaluation set, in batches of `batch_size` on the
    model's device (the tail padded with the first rows, then trimmed).

    The ELBO's terms are the model's own ``elbo_components``, the noise of
    every batch the same (B, zdim) standard normals, as JAX draws every
    batch's from one key: drawn from a generator seeded `seed`, or `eps`
    (B, zdim) given, as a test gives the JAX package's draws."""
    if self._x is not None:
      x, y = self._x, self._y
    else:
      x, y = self.dataset.numpy(partition)
      if hasattr(self.dataset, "normalize255"):
        x = self.dataset.normalize255(x)
    if n_samples > 0:
      x, y = x[:n_samples], (y[:n_samples] if y is not None else None)
    self.x_true = np.asarray(x)
    self.factors = np.asarray(y) if y is not None else None
    n, bs = len(x), self.batch_size
    n_pad = (-n) % bs
    xp = np.concatenate([x, x[:n_pad]]) if n_pad else np.asarray(x)
    model, dev = self.model, self.device
    state = model.state

    def total(terms):
      out = torch.zeros(bs, dtype=torch.float32, device=dev)
      for v in terms.values():
        v = v.to(torch.float32)
        if v.ndim > 1:  # average sample dims, keep the trailing batch axis
          v = v.mean(dim=tuple(range(v.ndim - 1)))
        out = out + v
      return out

    elbo_ok = True
    qzs, pxs, llks, kls = [], [], [], []
    for i in range(0, len(xp), bs):
      batch = torch.as_tensor(xp[i:i + bs], dtype=torch.float32).to(dev)
      qz, px = model.reconstruct(batch)
      qzs.append(qz)
      pxs.append(px)
      if elbo_ok:
        noise = Noise(eps=eps) if eps is not None else Noise(
            torch.Generator(dev).manual_seed(self.seed))
        try:
          llk, kl, _ = model.elbo_components(state.params, batch, noise,
                                             state.step, False,
                                             state.mutables)
        except (TypeError, ValueError, KeyError, NotImplementedError):
          elbo_ok = False  # e.g. an objective that needs labels
        else:
          llks.append(total(llk))
          kls.append(total(kl))

    def trim(d):
      return map_distributions(lambda t: t[:n], d) if n_pad else d

    self._llk_total = torch.cat(llks)[:n] if elbo_ok and llks else None
    self._kl_total = torch.cat(kls)[:n] if elbo_ok and kls else None
    self.qz = trim(concat_distributions(qzs, axis=0))
    self.px = trim(concat_distributions(pxs, axis=0))
    self._z_mean = self.qz.mean()
    self._z_discrete = discretizing(self._z_mean, n_bins=n_bins,
                                    strategy="uniform")
    if self.factors is not None:
      self.groundtruth = GroundTruth(self.factors,
                                     getattr(self.dataset, "labels", None),
                                     device=dev)
      self._factors_t = torch.as_tensor(self.groundtruth.factors).to(dev)
    return self

  def _require_run(self):
    if self._z_mean is None:
      raise RuntimeError("call run_model() first")

  @property
  def z_mean(self) -> torch.Tensor:
    self._require_run()
    return self._z_mean

  # -- scores -------------------------------------------------------------------
  def mig_score(self, protocol: str = "reference") -> float:
    """Mutual information gap.  protocol='reference' uses ``run_model``'s
    `n_bins` equal-width bins; 'dlib' re-bins the posterior means into the
    20 that disentanglement_lib's published numbers use."""
    self._require_run()
    codes = (discretizing(self._z_mean, n_bins=20, strategy="uniform")
             if protocol == "dlib" else self._z_discrete)
    return _metrics.mutual_info_gap(codes, self._factors_t)

  def sap_score(self) -> float:
    """Separated attribute predictability."""
    self._require_run()
    return _dm.separated_attr_predictability(self._z_mean, self._factors_t,
                                             seed=self.seed)

  def dci_score(self) -> Tuple[float, float, float]:
    """(disentanglement, completeness, informativeness)."""
    self._require_run()
    return _dm.dci_scores(self._z_mean, self._factors_t, seed=self.seed)

  def betavae_score(self, n_samples: Optional[int] = None,
                    protocol: str = "reference") -> float:
    """Higgins' beta-VAE metric.  protocol='reference': 10 MCMC samples of
    z, pair batches of 10, `n_samples` votes (default 2,000).
    protocol='dlib' (disentanglement_lib's ``beta_vae_sklearn``): the
    posterior mean, pair batches of 64, `n_samples` train votes (default
    10,000) scored on 5,000 held-out votes."""
    self._require_run()
    if protocol == "dlib":
      return _dm.beta_vae_score(self.qz, self._factors_t, n_mcmc=0,
                                batch_size=64, n_samples=n_samples or 10_000,
                                n_eval_samples=5_000, seed=self.seed)
    return _dm.beta_vae_score(self.qz, self._factors_t,
                              n_samples=n_samples or 2_000, seed=self.seed)

  def factorvae_score(self, n_samples: Optional[int] = None,
                      protocol: str = "reference") -> float:
    """Kim & Mnih's FactorVAE metric.  protocol='reference': 10 MCMC
    samples of z, batches of 256, `n_samples` votes (default 2,000).
    protocol='dlib': the posterior mean, batches of 64, `n_samples` train
    votes (default 10,000) with 5,000 held-out votes, latents pruned at
    std < 0.05."""
    self._require_run()
    if protocol == "dlib":
      return _dm.factor_vae_score(self.qz, self._factors_t, n_mcmc=0,
                                  batch_size=64,
                                  n_samples=n_samples or 10_000,
                                  n_eval_samples=5_000, prune_threshold=0.05,
                                  prune_scale="std", seed=self.seed)
    return _dm.factor_vae_score(self.qz, self._factors_t,
                                n_samples=n_samples or 2_000, seed=self.seed)

  clustering_score = _not_ported("clustering_score")

  def relative_disentanglement_strength(self, method: str = "spearman"
                                        ) -> float:
    self._require_run()
    return _metrics.relative_strength(self.correlation_matrix(method))

  def correlation_matrix(self, method: str = "spearman") -> torch.Tensor:
    self._require_run()
    return _metrics.correlation_matrix(
        self._z_mean, torch.as_tensor(self.groundtruth.factors_original).to(
            self.device), method=method, seed=self.seed)

  def total_correlation(self) -> float:
    """The Gaussian minibatch TC of the aggregate posterior at the
    posterior means, over ``_CHUNK`` rows at a time (the pairwise terms of
    10,000 rows would take 4 GB at once)."""
    self._require_run()
    z = self._z_mean
    total = sum(float(_tc(z[i:i + _CHUNK], self.qz)) * len(z[i:i + _CHUNK])
                for i in range(0, z.shape[0], _CHUNK))
    return total / z.shape[0]

  def elbo(self) -> float:
    return float(torch.mean(self.log_likelihood_values() -
                            self.kl_divergence_values()))

  def log_likelihood_values(self) -> torch.Tensor:
    self._require_run()
    if self._llk_total is not None:
      return self._llk_total
    return self.px.log_prob(torch.as_tensor(self.x_true).to(self.device))

  def log_likelihood(self) -> float:
    return float(torch.mean(self.log_likelihood_values()))

  def kl_divergence_values(self) -> torch.Tensor:
    """Per-sample total KL: the model's own ``elbo_components`` terms
    collected by ``run_model``; where the objective needed labels, the
    single-point estimate log q(z̄) - log p(z̄) at the posterior means."""
    self._require_run()
    if self._kl_total is not None:
      return self._kl_total
    if self.model.latents_prior is None:
      return torch.zeros(len(self._z_mean), device=self.device)
    prior = self.model._prior_on(self.device)
    return self.qz.log_prob(self._z_mean) - prior.log_prob(self._z_mean)

  def kl_divergence(self) -> float:
    return float(torch.mean(self.kl_divergence_values()))

  def kl_unweighted_values(self) -> torch.Tensor:
    """Per-sample unweighted analytic KL(q(z|x) || p(z)) of the top
    latents: the rate published tables report (``kl_divergence`` is the
    objective's term, beta-scaled for the BetaVAE family).  Without an
    analytic KL for the pair, a 10-sample estimate from a generator seeded
    `seed` (``kl_unweighted_estimator`` says which)."""
    self._require_run()
    if self.model.latents_prior is None:
      return torch.zeros(len(self._z_mean), device=self.device)
    prior = self.model._prior_on(self.device)
    if kl_registry_lookup(type(self.qz), type(prior)) is not None:
      self.kl_unweighted_estimator = "analytic"
      return kl_divergence(self.qz, prior, analytic=True)
    warnings.warn(
        f"no analytic KL registered for ({type(self.qz).__name__}, "
        f"{type(prior).__name__}); kl_unweighted falls back to a 10-sample "
        "MC estimate", stacklevel=2)
    self.kl_unweighted_estimator = "mc10"
    return kl_divergence(self.qz, prior, q_sample=10,
                         generator=torch.Generator(self.device).manual_seed(
                             self.seed))

  def kl_unweighted(self) -> float:
    return float(torch.mean(self.kl_unweighted_values()))

  def elbo_unweighted(self) -> float:
    """llk - the unweighted KL: the beta = 1 ELBO the literature
    reports."""
    return (float(torch.mean(self.log_likelihood_values())) -
            float(torch.mean(self.kl_unweighted_values())))

  def accuracy_score(self) -> float:
    """Test accuracy of a logistic probe from the latents to the first
    factor."""
    self._require_run()
    xtr, xte, ytr, yte = train_test_split(
        self._z_mean, self._factors_t[:, 0], test_size=0.2,
        random_state=self.seed)
    return LogisticRegression().fit(xtr, ytr).score(xte, yte)

  def active_units(self, threshold: float = 1e-2) -> np.ndarray:
    """Latents whose posterior means vary more than `threshold` (Burda et
    al.), as host indices."""
    self._require_run()
    var = torch.var(self._z_mean.to(torch.float64), dim=0, correction=0)
    return torch.nonzero(var > threshold).reshape(-1).cpu().numpy()

  def frechet_inception_distance(self, features_fn=None) -> float:
    """FID between the reconstructions and the data.  Without inception
    weights, `features_fn` defaults to the model's encoder mean latents
    (the reconstructions encoded ``4 * _CHUNK`` at a time)."""
    self._require_run()
    recon = self.px.mean()
    if features_fn is None:
      f_real = self._z_mean
      step = 4 * _CHUNK
      with torch.no_grad():
        f_fake = torch.cat([self.model.encode(recon[i:i + step]).mean()
                            for i in range(0, len(recon), step)])
    else:
      f_real = features_fn(self.x_true)
      f_fake = features_fn(recon)
    return _fid(f_real, f_fake)

  # -- report -------------------------------------------------------------------
  def write_report(self, path: Optional[str] = None,
                   scores: Sequence[str] = ("elbo", "llk", "kl", "mig",
                                            "sap", "dci", "betavae",
                                            "factorvae", "tc",
                                            "active_units"),
                   verbose: bool = False) -> Dict[str, float]:
    """Compute a suite of scores and optionally write them to a text file.
    As in the JAX package, a score that raises is reported as
    ``<score>_error`` and the others go on (`verbose` re-raises)."""
    self._require_run()
    out: Dict[str, Any] = {}
    for s in scores:
      try:
        if s == "elbo":
          out["elbo"] = self.elbo()
        elif s == "llk":
          out["log_likelihood"] = self.log_likelihood()
        elif s == "kl":
          out["kl_divergence"] = self.kl_divergence()
          out["kl_unweighted"] = self.kl_unweighted()
          out["elbo_unweighted"] = self.elbo_unweighted()
        elif s == "mig":
          out["mig"] = self.mig_score()
        elif s == "sap":
          out["sap"] = self.sap_score()
        elif s == "dci":
          d, c, i = self.dci_score()
          out.update(dci_disentanglement=d, dci_completeness=c,
                     dci_informativeness=i)
        elif s == "betavae":
          out["betavae_score"] = self.betavae_score()
        elif s == "factorvae":
          out["factorvae_score"] = self.factorvae_score()
        elif s == "tc":
          out["total_correlation"] = self.total_correlation()
        elif s == "active_units":
          out["n_active_units"] = int(len(self.active_units()))
        elif s == "fid":
          out["fid"] = self.frechet_inception_distance()
        elif s == "clustering":
          out.update({f"clustering_{k}": v
                      for k, v in self.clustering_score().items()})
      except Exception as e:  # the report goes on; the error is its entry
        out[f"{s}_error"] = str(e)
        if verbose:
          raise
    if path is not None:
      with open(path, "w") as f:
        for k, v in out.items():
          f.write(f"{k}: {v}\n")
    return out


for _name in ("plot_reconstruction", "plot_latents_traverse",
              "plot_latents_tsne", "plot_correlation", "plot_histogram",
              "plot_distortion", "plot_latents_stats", "plot_interpolation",
              "plot_prior_sampling", "plot_pairwise_scatter"):
  setattr(DisentanglementGym, _name, _not_ported(_name))
