"""The port's decompositions (``odin_tpu_torch/ml/decompositions.py``)
against scikit-learn 1.9's ``PCA``/``IncrementalPCA`` (which the JAX
package wraps) and the JAX package's ``fast_pca``, ``PPCA``,
``SupervisedPPCA``, ``MiniBatchPCA`` and ``RandomizedPCA``, on the CPU.

Data: a few hundred rows of correlated Gaussians with a mean, in float64
and float32, shaped to reach each route of the ``auto`` solver.

Tolerances, each of the largest magnitude of the reference:

- float64: 1e-9 (components, variances and transforms; both sides are
  LAPACK-grade factorisations of the same matrix, measured at 1e-13 or
  below);
- float32: 1e-3 for components and transforms, 1e-4 for the explained
  variances: scikit-learn factors float32 data in float32 (its
  ``covariance_eigh`` forms X'X in float32), so its own components lie up
  to about 1.3e-4 from the float64 ones here, and the port's within the
  same distance of both;
- PPCA: both packages run the same float32 EM from the same numpy start
  and stop at the same iteration on this data (checked); W, σ² and the
  latents within 1e-4 (float32 rounding carried through 10-50 EM steps);
- RandomizedPCA from JAX's own sketch (``jax.random.normal`` of the same
  key, passed in): no sign convention, so components up to each row's
  sign, within 1e-4 (float32 QRs in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA as SkPCA
from sklearn.decomposition import IncrementalPCA as SkIPCA

from odin_tpu.ml import decompositions as J
from odin_tpu_torch.ml import decompositions as P
from odin_tpu_torch.weights import (from_jax_incremental_pca,
                                    from_jax_minibatch_pca, from_jax_pca,
                                    from_jax_ppca, from_jax_randomized_pca,
                                    from_jax_supervised_ppca,
                                    to_jax_incremental_pca,
                                    to_jax_minibatch_pca, to_jax_pca,
                                    to_jax_ppca, to_jax_randomized_pca,
                                    to_jax_supervised_ppca)

from torch_ml_common import close, up_to_sign

CPU = "cpu"
F64_TOL = 1e-9
F32_TOL = 1e-3
F32_VAR_TOL = 1e-4
PPCA_TOL = 1e-4


def _data(n, d, seed=0, dtype=np.float64):
  rng = np.random.RandomState(seed)
  A = rng.randn(d, d) * np.linspace(2.0, 0.1, d)[:, None]
  return (rng.randn(n, d) @ A + rng.randn(d) * 3).astype(dtype)


def _np(t):
  return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


# (rows, features, n_components) -> the route scikit-learn's auto picks
ROUTES = {"covariance_eigh": (400, 20, 5), "full": (120, 300, 10),
          "randomized": (700, 600, 20), "randomized-wide": (520, 900, 10)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pca_auto_routes_match_sklearn(route, dtype):
  n, d, k = ROUTES[route]
  X = _data(n, d, seed=len(route), dtype=dtype)
  want = SkPCA(n_components=k, random_state=1).fit(X)
  got = P.PCA(n_components=k, random_state=1, device=CPU).fit(X)
  assert got._fit_svd_solver == want._fit_svd_solver == route.split("-")[0]
  assert got.components_.dtype == torch.from_numpy(want.components_).dtype
  tol = F64_TOL if dtype == np.float64 else F32_TOL
  vtol = F64_TOL if dtype == np.float64 else F32_VAR_TOL
  close(got.components_, want.components_, tol, "components")
  close(got.explained_variance_, want.explained_variance_, vtol)
  close(got.explained_variance_ratio_, want.explained_variance_ratio_, vtol)
  close(got.singular_values_, want.singular_values_, vtol)
  close(got.noise_variance_, want.noise_variance_, vtol * 10)
  Xt = _data(50, d, seed=99, dtype=dtype)
  close(got.transform(Xt), want.transform(Xt), tol, "transform")


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_whiten_and_inverse_transform(whiten):
  X = _data(300, 12, seed=3)
  want = SkPCA(n_components=6, whiten=whiten).fit(X)
  got = P.PCA(n_components=6, whiten=whiten, device=CPU).fit(X)
  Z = want.transform(X)
  close(got.transform(X), Z, F64_TOL)
  close(got.inverse_transform(Z), want.inverse_transform(Z), F64_TOL)
  close(got.fit_transform(X), Z, F64_TOL)


@pytest.mark.parametrize("solver", ["full", "covariance_eigh", "randomized"])
def test_pca_explicit_solvers(solver):
  X = _data(200, 30, seed=4)
  want = SkPCA(n_components=7, svd_solver=solver, random_state=3).fit(X)
  got = P.PCA(n_components=7, svd_solver=solver, random_state=3,
              device=CPU).fit(X)
  close(got.components_, want.components_, F64_TOL)
  close(got.explained_variance_, want.explained_variance_, F64_TOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_incremental_pca_over_several_partial_fits(dtype):
  X = _data(600, 15, seed=5, dtype=dtype)
  want = SkIPCA(n_components=4)
  got = P.IncrementalPCA(n_components=4, device=CPU)
  for rows in (slice(0, 150), slice(150, 320), slice(320, 480),
               slice(480, 600)):
    want.partial_fit(X[rows])
    got.partial_fit(X[rows])
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    close(got.components_, want.components_, tol)
    close(got.explained_variance_, want.explained_variance_,
          F64_TOL if dtype == np.float64 else F32_VAR_TOL)
    close(got.mean_, want.mean_, 1e-12 if dtype == np.float64 else 1e-6)
    close(got.var_, want.var_, 1e-12 if dtype == np.float64 else 1e-6)
  assert got.n_samples_seen_ == want.n_samples_seen_
  close(got.transform(X[:40]), want.transform(X[:40]), F32_TOL)


def test_incremental_pca_fit_batches():
  """``fit``'s default batch (5x the features) and a last batch shorter
  than n_components merged into the one before it."""
  X = _data(503, 20, seed=6)
  for batch in (None, 100):
    want = SkIPCA(n_components=5, batch_size=batch).fit(X)
    got = P.IncrementalPCA(n_components=5, batch_size=batch,
                           device=CPU).fit(X)
    close(got.components_, want.components_, F64_TOL)
    close(got.singular_values_, want.singular_values_, F64_TOL)
    assert got.batch_size_ == want.batch_size_


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fast_pca_over_train_and_test(dtype):
  Xtr, Xte = _data(400, 20, seed=7, dtype=dtype), _data(80, 20, seed=8,
                                                          dtype=dtype)
  (a, b), model = J.fast_pca(Xtr, Xte, n_components=6, return_model=True)
  (ga, gb), gmodel = P.fast_pca(Xtr, Xte, n_components=6, return_model=True,
                                device=CPU)
  tol = F64_TOL if dtype == np.float64 else F32_TOL
  close(ga, a, tol)
  close(gb, b, tol)
  # the bridge both ways: the same transform from the same fitted state
  # (float32 products summed in another order: 1e-6)
  btol = F64_TOL if dtype == np.float64 else 1e-6
  close(from_jax_pca(model, CPU).transform(Xte), b, btol)
  back = to_jax_pca(gmodel)
  mirror = SkPCA(n_components=6)
  for k, v in back.items():
    setattr(mirror, k, v)
  close(mirror.transform(Xte), _np(gb), btol)
  single = P.fast_pca(Xtr, n_components=3, device=CPU)
  assert tuple(single.shape) == (400, 3)


def _ppca_data():
  rng = np.random.RandomState(11)
  X = rng.randn(500, 3) @ rng.randn(3, 8) * 2 + rng.randn(500, 8) * 0.3
  return (X + rng.randn(8)).astype("f")


def test_ppca_matches_jax():
  X = _ppca_data()
  want = J.PPCA(n_components=3, n_iter=100).fit(X)
  got = P.PPCA(n_components=3, n_iter=100, device=CPU).fit(X)
  close(got.W, want.W, PPCA_TOL, "W")
  assert abs(got.sigma2 - want.sigma2) <= PPCA_TOL * want.sigma2
  close(got.mean, want.mean, 1e-6)
  close(got.transform(X), want.transform(X), PPCA_TOL, "latents")
  Z = want.transform(X[:10])
  close(got.inverse_transform(Z), want.inverse_transform(Z), PPCA_TOL)
  # the principal subspace agrees with scikit-learn's PCA
  Q, _ = np.linalg.qr(_np(got.W))
  sv = np.linalg.svd(SkPCA(3).fit(X).components_ @ Q, compute_uv=False)
  assert np.all(sv > 0.99), sv
  # the bridge: JAX's fitted state gives JAX's latents in the port
  close(from_jax_ppca(want, CPU).transform(X), want.transform(X), 1e-6)
  mirror = J.PPCA(n_components=3)
  for k, v in to_jax_ppca(got).items():
    setattr(mirror, k, v)
  close(mirror.transform(X), _np(got.transform(X)), 1e-6)
  close(P.fast_pca(X, n_components=3, algo="ppca", device=CPU),
        J.fast_pca(X, n_components=3, algo="ppca"), PPCA_TOL)


def test_supervised_ppca_matches_jax():
  X = _ppca_data()
  y = (X[:, 0] > np.median(X[:, 0])).astype(int) + 2 * (X[:, 1] > 0)
  want = J.SupervisedPPCA(n_components=3, n_iter=60).fit(X, y)
  got = P.SupervisedPPCA(n_components=3, n_iter=60, device=CPU).fit(X, y)
  Zw = want.transform(X)
  close(up_to_sign(got.transform(X), Zw, axis=0), Zw, PPCA_TOL)
  close(from_jax_supervised_ppca(want, CPU).transform(X), Zw, 1e-6)
  rt = from_jax_supervised_ppca(to_jax_supervised_ppca(got), CPU)
  close(rt.transform(X), _np(got.transform(X)), 1e-12)
  assert P.SupervisedPPCA(2, device=CPU).fit(X)._rotation is None


def test_minibatch_pca_matches_jax():
  X = _data(700, 10, seed=12)
  want = J.MiniBatchPCA(n_components=4, batch_size=128).fit(X)
  got = P.MiniBatchPCA(n_components=4, batch_size=128, device=CPU).fit(X)
  close(got.components_, want.components_, F64_TOL)
  close(got.transform(X[:30]), want.transform(X[:30]), F64_TOL)
  want.partial_fit(X[:200])
  got.partial_fit(X[:200])
  close(got.components_, want.components_, F64_TOL)
  close(from_jax_minibatch_pca(want, CPU).transform(X[:30]),
        want.transform(X[:30]), F64_TOL)
  rt = from_jax_minibatch_pca(to_jax_minibatch_pca(got), CPU)
  close(rt.transform(X[:30]), _np(got.transform(X[:30])), 1e-14)
  ipca = from_jax_incremental_pca(to_jax_incremental_pca(got._model), CPU)
  close(ipca.components_, _np(got.components_), 0)


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("k", [3, None])
def test_randomized_pca_from_jax_sketch(whiten, k):
  X = _data(300, 14, seed=13, dtype=np.float32)
  want = J.RandomizedPCA(n_components=k, whiten=whiten,
                         random_state=5).fit(X)
  got = P.RandomizedPCA(n_components=k, whiten=whiten, random_state=5,
                        device=CPU)
  shape = got.sketch_shape(*X.shape)
  sketch = np.asarray(jax.random.normal(jax.random.PRNGKey(5), shape,
                                        jnp.float32))
  got.fit(X, sketch=sketch)
  close(up_to_sign(got.components_, want.components_, axis=1),
        want.components_, PPCA_TOL)
  close(got.singular_values_, want.singular_values_, PPCA_TOL)
  close(got.explained_variance_ratio_, want.explained_variance_ratio_,
        PPCA_TOL)
  Zw = want.transform(X)
  close(up_to_sign(got.transform(X), Zw, axis=0), Zw, PPCA_TOL)
  assert (got.transform(X).dtype == torch.float64) == whiten
  close(from_jax_randomized_pca(want, CPU).transform(X), Zw, 1e-5)
  close(from_jax_randomized_pca(want, CPU).inverse_transform(Zw),
        want.inverse_transform(Zw), 1e-5)
  rt = from_jax_randomized_pca(to_jax_randomized_pca(got), CPU)
  close(rt.transform(X), _np(got.transform(X)), 0)


def test_randomized_pca_draws_its_own_sketch():
  X = _data(300, 14, seed=14, dtype=np.float32)
  a = P.RandomizedPCA(n_components=4, random_state=2, device=CPU).fit(X)
  b = P.RandomizedPCA(n_components=4, random_state=2, device=CPU).fit(X)
  np.testing.assert_array_equal(_np(a.components_), _np(b.components_))
  pca = SkPCA(4).fit(X)
  close(up_to_sign(a.components_, pca.components_, axis=1),
        pca.components_, F32_TOL)
  with pytest.raises(ValueError):
    P.RandomizedPCA(n_components=4, device=CPU).fit(X, sketch=np.ones((3,
                                                                       3)))
