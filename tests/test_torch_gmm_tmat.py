"""The port's GMM and T-matrix (``odin_tpu_torch/ml/gmm_tmat.py``) against
the JAX package's (``odin_tpu/ml/gmm_tmat.py``) on the CPU.

Data: tests/test_ml.py's speech-like utterances (60 of 120 frames, 6
speakers, 12 dims, frames around 4 shared 'phonemes' plus a speaker
offset), made from a numpy seed; nmix 8, tv_dim 8.

Tolerances, each against the JAX value's largest magnitude unless said:
- one GMM E-step from the same state: 1e-5 (Z, F, S) and 1e-6 relative
  (llk): both packages compute in fp32 and sum chunks in float64, but
  XLA's and torch's fp32 matmuls sum in other orders; a frame's
  log-likelihood is a sum of terms up to |x²/σ| ~ 1e2 at 2^-24 each, and
  the posteriors follow it (measured: 4e-7 and 1e-7);
- one M-step + mixup from the same float64 statistics: 1e-12 relative,
  the same float64 arithmetic (measured: equal);
- the whole fit (31 E-steps): 1e-4, the E-step's differences carried
  through the EM (measured: 7e-6);
- transform / transform_batch: 1e-5 (one E-step; measured 1e-6);
- T-matrix E-step (LU, RU, llk, mean): 1e-5, fp32 Cholesky solves of
  8 x 8 precisions summed in other orders (measured 1e-7);
- T-matrix M-step from the same float64 LU/RU: 1e-10 up to a sign per row
  (float64 solves and SVD; LAPACK's and torch's signs may differ);
- T-matrix fit and i-vectors: 1e-4 up to a sign per row / dimension (five
  EM iterations of fp32 E-steps; measured 1e-5), and the sign-invariant
  Gram matrix of the i-vectors to the same limit.
"""
import numpy as np
import pytest
import torch

from odin_tpu.ml import GMM as JaxGMM
from odin_tpu.ml import Tmatrix as JaxTmatrix
from odin_tpu_torch.ml import GMM, Tmatrix
from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls
from odin_tpu_torch.weights import (from_jax_gmm, from_jax_tmatrix,
                                    to_jax_gmm, to_jax_tmatrix)

from torch_ml_common import close, up_to_sign, utterances

CPU = "cpu"
NMIX, TV_DIM = 8, 8


@pytest.fixture(scope="module")
def data():
  utts, labels = utterances()
  return utts, labels, np.concatenate(utts)


@pytest.fixture(scope="module")
def fitted(data):
  """The JAX GMM fitted on the frames, its per-utterance statistics, and
  a JAX T-matrix fitted on them."""
  utts, _, X = data
  jg = JaxGMM(nmix=NMIX, batch_size=2400).fit(X)
  Z, F = jg.transform_batch(utts)
  jt = JaxTmatrix(tv_dim=TV_DIM, gmm=jg, niter=5).fit((Z, F))
  return jg, Z, F, jt


# -- GMM ---------------------------------------------------------------------
def test_gmm_estep_matches_jax(data, fitted):
  _, _, X = data
  jg = fitted[0]
  Zj, Fj, Sj, lj = jg.expectation(X)
  Z, F, S, llk = from_jax_gmm(jg, CPU).expectation(X)
  assert Z.dtype == torch.float64 and Z.shape == (NMIX,)
  for got, want, name in ((Z, Zj, "Z"), (F, Fj, "F"), (S, Sj, "S")):
    close(got, want, 1e-5, name)
  assert llk == pytest.approx(lj, rel=1e-6)


def test_gmm_mstep_and_mixup_match_jax_from_the_same_stats(data, fitted):
  _, _, X = data
  jg = fitted[0]
  stats = jg.expectation(X)[:3]
  port = from_jax_gmm(jg, CPU).maximization(*stats).gmm_mixup()
  ref = JaxGMM(nmix=NMIX)
  ref.mu, ref.sigma, ref.w = jg.mu.copy(), jg.sigma.copy(), jg.w.copy()
  ref.maximization(*stats).gmm_mixup()
  for k in ("mu", "sigma", "w"):
    got = getattr(port, k)
    assert got.dtype == torch.float32 and tuple(got.shape) == \
        getattr(ref, k).shape
    np.testing.assert_allclose(got.numpy(), getattr(ref, k), rtol=1e-12,
                               atol=0, err_msg=k)


def test_gmm_mixup_ties_take_the_first_dim():
  gmm = GMM(nmix=2, device=CPU)
  gmm.mu = torch.zeros((1, 3))
  gmm.sigma = torch.tensor([[1.0, 4.0, 4.0]])
  gmm.w = torch.ones(1)
  gmm.gmm_mixup()
  np.testing.assert_array_equal(gmm.mu.numpy(),
                                [[0, -2, 0], [0, 2, 0]])
  np.testing.assert_array_equal(gmm.w.numpy(), [0.5, 0.5])


def test_gmm_fit_matches_jax(data, fitted):
  _, _, X = data
  jg = fitted[0]
  gmm = GMM(nmix=NMIX, batch_size=2400, device=CPU).fit(X)
  assert gmm.is_fitted and gmm.ndim == X.shape[1]
  for k in ("mu", "sigma", "w"):
    close(getattr(gmm, k), getattr(jg, k), 1e-4, k)
  # the schedule: 1+2+4 iterations below 8 mixtures, then at least
  # niter[3] + 1 at the final level
  levels = [m for m, _, _ in gmm.llk_history]
  assert levels[:7] == [1, 2, 2, 4, 4, 4, 4] and set(levels[7:]) == {8}
  assert len(levels) - 7 >= gmm.niter[3] + 1
  assert gmm.score(X) == pytest.approx(jg.score(X), rel=1e-5)
  # a list of utterances is concatenated, a tensor taken as it is
  gmm2 = GMM(nmix=NMIX, batch_size=2400, device=CPU).fit(
      [torch.from_numpy(u) for u in data[0]])
  np.testing.assert_array_equal(gmm2.mu.numpy(), gmm.mu.numpy())


def test_gmm_fit_trajectory_matches_jax_where_the_stop_is_close(data,
                                                                 capsys):
  """At nmix 4 the final level drifts slowly through a saddle for some 30
  iterations, so the llk test `gain / frame < tol` is met near rounding and
  the two packages may stop one iteration apart (then the params differ by
  that step, about 1e-3).  Every iteration both run agrees: the llk per
  frame to 1e-5 relative beside JAX's four printed decimals (the drift
  amplifies the E-step's rounding; measured 3.8e-6), and the stop to one
  iteration."""
  _, _, X = data
  JaxGMM(nmix=4, batch_size=2400).fit(X, verbose=True)
  want = [float(line.rsplit("=", 1)[1])
          for line in capsys.readouterr().out.splitlines()
          if line.startswith("[GMM]")]
  got = [llk for _, _, llk in
         GMM(nmix=4, batch_size=2400, device=CPU).fit(X).llk_history]
  assert abs(len(got) - len(want)) <= 1 and len(want) > 30
  n = min(len(got), len(want))
  # JAX prints 4 decimals
  np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=5e-5 + 1e-5 *
                             abs(want[0]))


def test_gmm_logprob_and_transforms_match_jax(data, fitted):
  utts, _, X = data
  jg = fitted[0]
  gmm = from_jax_gmm(jg, CPU)
  close(gmm.logprob(X[:500]), jg.logprob(X[:500]), 1e-5, "logprob")
  Zj, Fj = jg.transform(utts[3])
  Z, F = gmm.transform(utts[3])
  assert Z.shape == (NMIX,) and F.shape == (NMIX * X.shape[1],)
  close(Z, Zj, 1e-5, "Z")
  close(F, Fj, 1e-5, "F")
  # ragged lengths across buckets of 8, 32, 64 and 128 frames
  ragged = [utts[0][:5], utts[1][:33], utts[2], utts[3][:64], utts[4][:17]]
  Zbj, Fbj = jg.transform_batch(ragged, batch_size=2)
  Zb, Fb = gmm.transform_batch(ragged, batch_size=2)
  assert Zb.dtype == torch.float32 and Zb.shape == Zbj.shape
  close(Zb, Zbj, 1e-5, "Z batch")
  close(Fb, Fbj, 1e-5, "F batch")
  # tensors in, the same statistics
  Zt, Ft = gmm.transform_batch([torch.from_numpy(u) for u in ragged],
                               batch_size=2)
  np.testing.assert_array_equal(Zt.numpy(), Zb.numpy())
  np.testing.assert_array_equal(Ft.numpy(), Fb.numpy())


def test_gmm_save_load_and_bridge_round_trip(tmp_path, fitted):
  jg = fitted[0]
  gmm = from_jax_gmm(jg, CPU)
  state = to_jax_gmm(gmm)
  assert set(state) == {"nmix", "mu", "sigma", "w", "ndim"}
  for k in ("mu", "sigma", "w"):
    assert isinstance(state[k], np.ndarray)
    np.testing.assert_array_equal(state[k], getattr(jg, k))
  # the port's file loads in JAX and JAX's in the port
  gmm.save(str(tmp_path / "port.pkl"))
  back = JaxGMM.load(str(tmp_path / "port.pkl"))
  np.testing.assert_array_equal(back.sigma, jg.sigma)
  jg.save(str(tmp_path / "jax.pkl"))
  loaded = GMM.load(str(tmp_path / "jax.pkl"), device=CPU)
  np.testing.assert_array_equal(loaded.mu.numpy(), jg.mu)
  assert loaded.ndim == jg.ndim and loaded.is_fitted
  assert repr(loaded) == repr(jg)
  # from the saved dict too
  np.testing.assert_array_equal(from_jax_gmm(state, CPU).w.numpy(), jg.w)


# -- T-matrix ----------------------------------------------------------------
def _tmats(fitted):
  jg, Z, F, _ = fitted
  jt = JaxTmatrix(tv_dim=TV_DIM, gmm=jg, niter=5)
  pt = Tmatrix(tv_dim=TV_DIM, gmm=from_jax_gmm(jg, CPU), niter=5,
               device=CPU)
  return jt, pt, Z, F


def test_tmatrix_initialize_is_bitwise_jax(fitted):
  jt, pt, _, _ = _tmats(fitted)
  jt.initialize()
  pt.initialize()
  assert pt.Tm.dtype == torch.float64
  np.testing.assert_array_equal(pt.Tm.numpy(), jt.Tm)


def test_tmatrix_estep_matches_jax(fitted):
  jt, pt, Z, F = _tmats(fitted)
  jt.initialize()
  pt.initialize()
  LUj, RUj, lj = jt.expectation(Z, F)
  LU, RU, llk = pt.expectation(Z, F)
  assert LU.dtype == torch.float64 and LU.shape == (NMIX, TV_DIM, TV_DIM)
  close(LU, LUj, 1e-5, "LU")
  close(RU, RUj, 1e-5, "RU")
  assert llk == pytest.approx(lj, rel=1e-5)
  close(pt.transform((Z, F)), jt.transform((Z, F)), 1e-5, "mean")


def test_tmatrix_maximization_matches_jax_up_to_row_signs(fitted):
  jt, pt, Z, F = _tmats(fitted)
  jt.initialize()
  LU, RU, _ = jt.expectation(Z, F)
  pt.load_state({"tv_dim": jt.tv_dim, "Tm": jt.Tm})  # numpy
  jt.maximization(LU, RU)
  pt.maximization(LU, RU)
  close(up_to_sign(pt.Tm, jt.Tm, axis=1), jt.Tm, 1e-10, "Tm")
  # without the re-orthogonalisation there is no sign to choose
  jt.maximization(LU, RU, orthogonalize=False)
  pt.maximization(LU, RU, orthogonalize=False)
  close(pt.Tm, jt.Tm, 1e-10, "Tm unorthogonalised")


def test_tmatrix_fit_and_ivectors_match_jax(fitted):
  jg, Z, F, jt = fitted
  pt = Tmatrix(tv_dim=TV_DIM, gmm=from_jax_gmm(jg, CPU), niter=5,
               device=CPU).fit((torch.from_numpy(Z), F))
  close(up_to_sign(pt.Tm, jt.Tm, axis=1), jt.Tm, 1e-4, "Tm")
  want = jt.transform((Z, F))
  got = pt.transform((Z, F))
  assert got.dtype == torch.float32 and got.shape == (60, TV_DIM)
  close(up_to_sign(got, want, axis=0), want, 1e-4, "i-vectors")
  close(got.T @ got, want.T @ want, 1e-4, "Gram")
  # the bridge carries JAX's T-matrix: the same i-vectors up to rounding
  bridged = from_jax_tmatrix(jt, from_jax_gmm(jg, CPU), CPU)
  close(bridged.transform((Z, F)), want, 1e-5, "bridged i-vectors")
  assert to_jax_tmatrix(bridged)["Tm"].dtype == np.float64


def test_tmatrix_non_positive_definite_precision_gives_nan_as_jax(fitted):
  """A precision L = I + sum_m Z_m TT_m that is not positive definite (a
  negative occupancy): jnp.linalg.cholesky gives NaN and carries on; so
  does the port (cholesky_ex), where torch.linalg.cholesky would raise."""
  jt, pt, Z, F = _tmats(fitted)
  jt.initialize()
  pt.initialize()
  Z = Z.copy()
  Z[2] = -1e6
  LUj, RUj, lj = jt.expectation(Z, F)
  LU, RU, llk = pt.expectation(Z, F)
  assert np.isnan(LUj).all() and np.isnan(RUj).all() and np.isnan(lj)
  assert torch.isnan(LU).all() and torch.isnan(RU).all() and np.isnan(llk)
  want = jt.transform((Z, F))
  got = pt.transform((Z, F)).numpy()
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  assert np.isnan(want[2]).all() and not np.isnan(np.delete(want, 2, 0)).any()
  close(np.delete(got, 2, 0), np.delete(want, 2, 0), 1e-5, "the others")


# -- what is not ported, and TF32 ---------------------------------------------
def test_mesh_paths_raise(data, fitted):
  _, _, X = data
  gmm = from_jax_gmm(fitted[0], CPU)
  with pytest.raises(NotImplementedError, match="queue 1, item 7"):
    gmm.fit(X, mesh=object())
  with pytest.raises(NotImplementedError, match="queue 1, item 7"):
    gmm.expectation_sharded(X)
  tmat = Tmatrix(tv_dim=TV_DIM, gmm=gmm, device=CPU)
  with pytest.raises(NotImplementedError, match="queue 1, item 7"):
    tmat.fit((fitted[1], fitted[2]), mesh=object())
  with pytest.raises(NotImplementedError, match="queue 1, item 7"):
    tmat.expectation_sharded(fitted[1], fitted[2])


def test_no_card_raises_rather_than_running_on_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    GMM(nmix=4)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    Tmatrix(tv_dim=4)


def test_ieee_fp32_matmuls_restores_the_callers_setting():
  m = torch.backends.cuda.matmul
  name = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
  before = getattr(m, name)
  try:
    torch.set_float32_matmul_precision("high")  # TF32 on
    with ieee_fp32_matmuls():
      assert getattr(m, name) in ("ieee", False)
    assert getattr(m, name) in ("tf32", True)
  finally:
    torch.set_float32_matmul_precision("highest")
    setattr(m, name, before)
