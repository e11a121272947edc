"""GMM-UBM and total-variability matrix (i-vectors) of the port (PyTorch
port of ``odin_tpu/ml/gmm_tmat.py``).

``GMM`` is a diagonal-covariance GMM trained by EM with binary mixup
1 -> 2 -> ... -> nmix; ``Tmatrix`` is the i-vector extractor's EM over
per-utterance centered statistics.  Both run on their ``device`` (the card
unless the caller passes ``device="cpu"``):

- the GMM E-step is the JAX package's algebra in fp32 matmuls,
  ``x² @ (1/σ)ᵀ − 2·x @ (μ/σ)ᵀ + c``, ``logsumexp``, ``postᵀ @ x`` and
  ``postᵀ @ x²``, chunk by chunk; Z/F/S/llk accumulate in float64 on the
  device and reach the host once an E-step (JAX pulls every chunk);
- ``fit`` parks a corpus of up to ``PARK_BYTES`` (2 GiB as float32) on the
  device once; a larger one streams through a ring of ``_PIPELINE_DEPTH``
  pinned buffers, so at most that many chunks are in flight.  The size
  alone decides;
- the M-step is float64 from the float64 statistics, and the mixup splits
  along ``argmax`` of the float32 variances, ties at the first index, as
  numpy does; the params keep JAX's dtypes and layouts (``mu``/``sigma``
  (M, D) and ``w`` (M,) in ``dtype``), as tensors on the device;
- the T-matrix E-step computes the per-mixture ``TT`` blocks (M, R, R) once
  an EM iteration (JAX: once a chunk), factors each utterance's precision
  (B, R, R) with ``torch.linalg.cholesky_ex`` and solves with
  ``torch.cholesky_solve``; a precision that is not positive definite gives
  NaN, as ``jnp.linalg.cholesky`` does.  LU (M, R, R) and RU (R, M·D)
  accumulate in float64 on the device, and the M-step (per-mixture solves,
  then the SVD re-orthogonalisation) runs there in float64.

TF32: the fp32 matmuls of the E-steps cancel (``x²/σ − 2xμ/σ + μ²/σ``), and
TF32's 10-bit mantissa moves the posteriors far beyond fp32 rounding.  So
every E-step runs inside ``ieee_fp32_matmuls()``, which turns TF32 off for
cuBLAS's fp32 matmuls and restores the caller's setting afterwards, whatever
``torch.set_float32_matmul_precision`` the caller chose.

The SVD of the re-orthogonalisation may choose other column signs than
numpy's LAPACK: ``Tm`` then differs from JAX's by a sign on each row, and the
i-vectors by a sign on each dimension.  The EM is equivariant under such
flips, so cosine and PLDA scores do not change.

Not ported yet: ``expectation_sharded`` and ``fit(mesh=...)`` (ROADMAP.md
queue 1, item 7, parallelism); they raise.
"""
from __future__ import annotations

import contextlib
import math
import pickle
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device

__all__ = ["GMM", "Tmatrix", "ieee_fp32_matmuls"]

EPS = 1e-6
# chunks in flight on the streamed path: deep enough that copies overlap
# compute, bounded so that pending buffers never hold the corpus
_PIPELINE_DEPTH = 8
# fit parks a corpus of at most this many bytes (as float32) on the device
PARK_BYTES = 2 << 30
_LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))  # float32, as JAX's


def _chunk(n, size):
  for i in range(0, n, size):
    yield i, min(i + size, n)


def _not_ported(what: str) -> NotImplementedError:
  return NotImplementedError(
      f"{what} is not ported yet: the port runs on one card (ROADMAP.md "
      "queue 1, item 7, parallelism)")


@contextlib.contextmanager
def ieee_fp32_matmuls():
  """Run the block's fp32 cuBLAS matmuls in full fp32 (TF32 off), then
  restore the caller's setting.  Uses ``torch.backends.cuda.matmul
  .fp32_precision`` where this PyTorch has it (mixing it with the legacy
  flag raises), else ``allow_tf32``."""
  m = torch.backends.cuda.matmul
  name, off = (("fp32_precision", "ieee") if hasattr(m, "fp32_precision")
               else ("allow_tf32", False))
  before = getattr(m, name)
  setattr(m, name, off)
  try:
    yield
  finally:
    setattr(m, name, before)


def _numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def _on(x, device, dtype) -> torch.Tensor:
  """An array or a tensor as a `dtype` tensor on `device`."""
  if not isinstance(x, torch.Tensor):
    x = torch.from_numpy(np.ascontiguousarray(x))
  return x.to(device=device, dtype=dtype)


def _concat(utterances, device) -> Union[np.ndarray, torch.Tensor]:
  """Utterances concatenated along time: a float32 tensor on `device`
  where they are tensors, else a numpy array."""
  if any(isinstance(u, torch.Tensor) for u in utterances):
    return torch.cat([_on(u, device, torch.float32) for u in utterances])
  return np.concatenate([np.asarray(u) for u in utterances], 0)


def _stream(X, size: int, device: torch.device):
  """Float32 chunks of the host rows `X` on the card, through a ring of
  ``_PIPELINE_DEPTH`` pinned buffers: a buffer is refilled only after the
  copy out of it has ended (its event), so at most that many chunks are in
  flight."""
  n_chunks = -(-len(X) // size)
  ring = [torch.empty((size, X.shape[1]), dtype=torch.float32,
                      pin_memory=True)
          for _ in range(min(_PIPELINE_DEPTH, n_chunks))]
  copied: List[Optional[torch.cuda.Event]] = [None] * len(ring)
  for k, (i, j) in enumerate(_chunk(len(X), size)):
    slot = k % len(ring)
    if copied[slot] is not None:
      copied[slot].synchronize()
    buf = ring[slot][:j - i]
    if isinstance(X, torch.Tensor):
      buf.copy_(X[i:j])
    else:
      buf.numpy()[...] = X[i:j]
    x = buf.to(device, non_blocking=True)
    copied[slot] = torch.cuda.Event()
    copied[slot].record()
    yield x


def _log_joint(x, mu, inv, c, logw):
  """log(w_m N(x; mu_m, sigma_m)) of (N, D) frames, (N, M), through fp32
  matmuls: -0.5·(x² @ invᵀ − 2·x @ (mu·inv)ᵀ + c) + log w."""
  quad = torch.addmm(torch.mm(x * x, inv.T), x, (mu * inv).T, alpha=-2.0)
  return -0.5 * (quad + c) + logw


def _estep_chunk(x, mu, inv, c, logw):
  """(Z, F, S, llk) of one chunk of frames, fp32."""
  lj = _log_joint(x, mu, inv, c, logw)
  norm = torch.logsumexp(lj, 1, keepdim=True)
  post = torch.exp(lj - norm)  # responsibilities (N, M)
  return post.sum(0), post.T @ x, post.T @ (x * x), norm.sum()


def _estep_masked(x, mask, mu, inv, c, logw):
  """Per-utterance (Z (B, M), F (B, M, D)) of a padded batch x (B, T, D)
  with a (B, T) float mask: padding frames contribute nothing."""
  B, T, D = x.shape
  lj = _log_joint(x.reshape(B * T, D), mu, inv, c, logw).reshape(B, T, -1)
  norm = torch.logsumexp(lj, -1, keepdim=True)
  post = torch.exp(lj - norm) * mask[..., None]
  return post.sum(1), torch.einsum("btm,btd->bmd", post, x)


class GMM:
  """Diagonal-covariance GMM trained by EM with binary mixup, on `device`.

  ``GMM(nmix).fit(X)``, ``expectation``, ``maximization``, ``gmm_mixup``,
  ``logprob``/``score``, ``transform(X) -> (Z, F)`` centered statistics of
  one utterance and ``transform_batch`` of many.  Results are tensors on
  the device; ``save`` writes the JAX package's pickle (numpy arrays), which
  ``load`` and the JAX package's ``GMM.load`` both read.
  """

  STANDARD_BATCH_SIZE = 8192

  def __init__(self,
               nmix: int = 16,
               niter: Union[int, Sequence[int]] = None,
               batch_size: int = None,
               covariance_floor: float = 1e-3,
               seed: int = 1,
               dtype: str = "float32",
               device: Union[str, torch.device] = "cuda"):
    nmix = int(nmix)
    if nmix & (nmix - 1):
      raise ValueError(f"nmix must be a power of two, given {nmix}")
    self.nmix = nmix
    # iterations per mixup level (reference `fit` :641-652)
    n_levels = int(math.log2(nmix)) + 1
    default = [1, 2, 4, 4, 4, 4, 6, 6, 10, 10, 15]
    if niter is None:
      niter = default
    elif isinstance(niter, int):
      niter = [niter] * n_levels
    self.niter = list(niter) + [default[-1]] * max(0, n_levels - len(niter))
    self.batch_size = batch_size or self.STANDARD_BATCH_SIZE
    self.covariance_floor = float(covariance_floor)
    self.seed = int(seed)
    self.dtype = dtype
    self.device = resolve_device(device)
    self.mu: Optional[torch.Tensor] = None      # (M, D)
    self.sigma: Optional[torch.Tensor] = None   # (M, D) variances
    self.w: Optional[torch.Tensor] = None       # (M,)
    self.ndim: Optional[int] = None
    # (mixtures, iteration, llk per frame) of every E-step of `fit`
    self.llk_history: List[Tuple[int, int, float]] = []

  @property
  def _torch_dtype(self) -> torch.dtype:
    return getattr(torch, np.dtype(self.dtype).name)

  @property
  def is_fitted(self) -> bool:
    return self.mu is not None and len(self.w) == self.nmix

  # -- state ----------------------------------------------------------------
  def state(self) -> Dict:
    """``{nmix, mu, sigma, w, ndim}`` with numpy arrays: what ``save``
    writes, as the JAX package's ``GMM.save`` does."""
    return dict(nmix=self.nmix,
                mu=None if self.mu is None else _numpy(self.mu),
                sigma=None if self.sigma is None else _numpy(self.sigma),
                w=None if self.w is None else _numpy(self.w), ndim=self.ndim)

  @classmethod
  def from_state(cls, state, device: Union[str, torch.device] = "cuda"
                 ) -> "GMM":
    """A GMM of `nmix` mixtures holding the state's params (arrays or
    tensors) on `device`."""
    gmm = cls(nmix=state["nmix"], device=device)
    dt = gmm._torch_dtype
    gmm.mu, gmm.sigma, gmm.w = (_on(state[k], gmm.device, dt)
                                for k in ("mu", "sigma", "w"))
    gmm.ndim = None if state["ndim"] is None else int(state["ndim"])
    return gmm

  def save(self, path: str):
    with open(path, "wb") as f:
      pickle.dump(self.state(), f)

  @classmethod
  def load(cls, path: str, device: Union[str, torch.device] = "cuda"
           ) -> "GMM":
    with open(path, "rb") as f:
      return cls.from_state(pickle.load(f), device)

  # -- the E-step -------------------------------------------------------------
  def _estep_params(self):
    """(mu, 1/sigma, c, log w) in fp32 on the device."""
    mu = self.mu.to(torch.float32)
    sigma = self.sigma.to(torch.float32)
    inv = 1.0 / sigma
    c = torch.sum(mu * mu * inv + torch.log(sigma), 1) + \
        mu.shape[1] * _LOG_2PI
    return mu, inv, c, torch.log(self.w.to(torch.float32))

  def _chunks(self, X):
    """Float32 chunks of `batch_size` frames of X on the device: slices of X
    parked there (``_park``), else host rows streamed through pinned
    buffers to the card."""
    X = self._park(X)
    if isinstance(X, torch.Tensor) and X.device == self.device:
      for i, j in _chunk(len(X), self.batch_size):
        yield X[i:j].to(torch.float32)
    else:
      yield from _stream(X, self.batch_size, self.device)

  def expectation(self, X, device: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]:
    """Accumulate (Z (M,), F (M, D), S (M, D), llk) over the frames X
    (array or tensor) in chunks of `batch_size`: float64 tensors on the
    device and a float, after one host sync.

    `device` keeps the JAX signature ('cpu'|'gpu'|'mix'|'auto', the
    reference's dispatch) and is not used: the GMM's own device runs it.
    """
    mu, inv, c, logw = self._estep_params()
    M, D = mu.shape
    f64 = dict(dtype=torch.float64, device=self.device)
    Z, F, S = (torch.zeros(M, **f64), torch.zeros((M, D), **f64),
               torch.zeros((M, D), **f64))
    llk = torch.zeros((), **f64)
    with ieee_fp32_matmuls():
      for x in self._chunks(X):
        z, f, s, l = _estep_chunk(x, mu, inv, c, logw)
        Z += z
        F += f
        S += s
        llk += l
    return Z, F, S, float(llk)

  def expectation_sharded(self, X, mesh=None):
    raise _not_ported("GMM.expectation_sharded")

  # -- the M-step and the mixup -------------------------------------------------
  def maximization(self, Z, F, S, floor_const: Optional[float] = None):
    """Closed-form M-step in float64 with the variance floor (reference
    :1233-1276); the params are stored in `dtype`."""
    Z, F, S = (_on(a, self.device, torch.float64) for a in (Z, F, S))
    dt = self._torch_dtype
    iZ = 1.0 / torch.clamp(Z[:, None], min=EPS)
    self.w = (Z / Z.sum()).to(dt)
    self.mu = (F * iZ).to(dt)
    sigma = S * iZ - self.mu.to(torch.float64) ** 2
    floor = (floor_const if floor_const is not None
             else self.covariance_floor) * sigma.mean(0, keepdim=True)
    self.sigma = torch.maximum(sigma, floor).to(dt)
    return self

  def gmm_mixup(self, perturb: float = 1.0):
    """Split every component along its largest-variance dim (reference
    :1308-1342); a tie goes to the first dim."""
    M, D = self.mu.shape
    rows = torch.arange(M, device=self.device)
    idx = torch.argmax(self.sigma, 1)
    eps = torch.zeros_like(self.mu)
    eps[rows, idx] = torch.sqrt(self.sigma[rows, idx]) * perturb
    self.mu = torch.cat([self.mu - eps, self.mu + eps])
    self.sigma = torch.cat([self.sigma, self.sigma])
    self.w = torch.cat([self.w, self.w]) * 0.5
    return self

  def initialize(self, X):
    """One component from the first 100,000 frames, computed with numpy as
    the JAX package does, so that both start from the same params."""
    X = _numpy(X[:min(len(X), 100000)])
    self.ndim = X.shape[1]
    dt = self._torch_dtype
    self.mu = _on(X.mean(0, keepdims=True).astype(self.dtype), self.device,
                  dt)
    self.sigma = _on(np.maximum(X.var(0, keepdims=True), EPS).astype(
        self.dtype), self.device, dt)
    self.w = torch.ones(1, dtype=dt, device=self.device)
    return self

  def _park(self, X):
    """X on the device as float32 where it takes at most ``PARK_BYTES``
    there (or the device is the CPU), else X as it is: host rows, which
    every E-step streams."""
    if isinstance(X, torch.Tensor) and X.device == self.device:
      return X
    if self.device.type == "cpu" or X.shape[0] * X.shape[1] * 4 <= PARK_BYTES:
      return _on(X, self.device, torch.float32)
    return X

  def fit(self, X, verbose: bool = False, tol: float = 1e-5,
          max_final_iter: int = 50, mesh=None) -> "GMM":
    """Binary-mixup EM 1 -> 2 -> ... -> nmix (reference :625-700), `niter`
    iterations a level; the final level iterates until the llk gains less
    than `tol` per frame (after at least its `niter`), at most
    `max_final_iter` times.  X: (N, D) array or tensor, or a list of them."""
    if mesh is not None:
      raise _not_ported("GMM.fit(mesh=...)")
    if isinstance(X, (tuple, list)):
      X = _concat(X, self.device)
    self.initialize(X)
    n_frames = len(X)
    X = self._park(X)
    self.llk_history = []
    level = 0
    while True:
      final = len(self.w) >= self.nmix
      n_iter = max_final_iter if final else self.niter[level]
      prev_llk = -np.inf
      for it in range(n_iter):
        Z, F, S, llk = self.expectation(X)
        self.maximization(Z, F, S)
        self.llk_history.append((len(self.w), it, llk / n_frames))
        if verbose:
          print(f"[GMM] nmix={len(self.w):4d} iter={it} "
                f"llk/frame={llk / n_frames:.4f}")
        if final and it >= self.niter[level] and \
            (llk - prev_llk) / n_frames < tol:
          break
        prev_llk = llk
      if final:
        break
      self.gmm_mixup()
      level += 1
    return self

  # -- inference ----------------------------------------------------------------
  def logprob(self, X) -> torch.Tensor:
    """Per-frame log p(x) under the mixture, (N,) float32 on the device."""
    mu, inv, c, logw = self._estep_params()
    with ieee_fp32_matmuls():
      return torch.cat([torch.logsumexp(_log_joint(x, mu, inv, c, logw), 1)
                        for x in self._chunks(X)])

  def score(self, X) -> float:
    return float(torch.mean(self.logprob(X)))

  def transform(self, X, zero: bool = True, first: bool = True):
    """Centered statistics of one utterance (reference :708-768): Z (M,)
    and F − Z·mu flattened to (M·D,), in `dtype` on the device."""
    Z, F, _, _ = self.expectation(X)
    Fc = F - Z[:, None] * self.mu.to(torch.float64)
    dt = self._torch_dtype
    out = []
    if zero:
      out.append(Z.to(dt))
    if first:
      out.append(Fc.reshape(-1).to(dt))
    return out[0] if len(out) == 1 else tuple(out)

  def _padded(self, utterances, T: int, D: int):
    """(x (B, T, D), mask (B, T)) float32 on the device: numpy utterances
    are padded on the host and copied once, tensors on the device."""
    B = len(utterances)
    if any(isinstance(u, torch.Tensor) for u in utterances):
      x = torch.zeros((B, T, D), dtype=torch.float32, device=self.device)
      mask = torch.zeros((B, T), dtype=torch.float32, device=self.device)
      for b, u in enumerate(utterances):
        x[b, :len(u)] = _on(u, self.device, torch.float32)
        mask[b, :len(u)] = 1.0
      return x, mask
    x = np.zeros((B, T, D), np.float32)
    mask = np.zeros((B, T), np.float32)
    for b, u in enumerate(utterances):
      x[b, :len(u)] = u
      mask[b, :len(u)] = 1.0
    return (torch.from_numpy(x).to(self.device),
            torch.from_numpy(mask).to(self.device))

  def transform_batch(self, utterances: Sequence, batch_size: int = 64
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z (n, M), F (n, M·D)) centered statistics of many utterances (arrays
    or tensors), in `dtype` on the device: utterances are bucketed by their
    length padded to a power of two (at least 8), and each bucket runs in
    padded, masked batches (B, T, D) of `batch_size`, as in the JAX
    package."""
    mu, inv, c, logw = self._estep_params()
    M, D = mu.shape
    n = len(utterances)
    buckets: Dict[int, list] = {}
    for idx, u in enumerate(utterances):
      T = max(int(2 ** np.ceil(np.log2(max(len(u), 1)))), 8)
      buckets.setdefault(T, []).append(idx)
    dt = self._torch_dtype
    Zs = torch.zeros((n, M), dtype=dt, device=self.device)
    Fs = torch.zeros((n, M * D), dtype=dt, device=self.device)
    mu64 = mu.to(torch.float64)
    with ieee_fp32_matmuls():
      for T, items in sorted(buckets.items()):
        for s in range(0, len(items), batch_size):
          part = items[s:s + batch_size]
          x, mask = self._padded([utterances[i] for i in part], T, D)
          Z, F = _estep_masked(x, mask, mu, inv, c, logw)
          Z = Z.to(torch.float64)
          Fc = F.to(torch.float64) - Z[:, :, None] * mu64  # center
          rows = torch.tensor(part, device=self.device)
          Zs[rows] = Z.to(dt)
          Fs[rows] = Fc.reshape(len(part), -1).to(dt)
    return Zs, Fs

  def __repr__(self):
    m = len(self.w) if self.w is not None else 0
    return f"GMM(nmix={self.nmix}, fitted_mix={m}, ndim={self.ndim})"


class Tmatrix:
  """Total-variability matrix for i-vector extraction, on `device`
  (reference ``odin/ml/gmm_tmat.py:1343-2092``): EM over per-utterance
  centered (Z, F) statistics; ``transform`` gives the i-vectors, the
  posterior means.  ``Tm`` is a float64 (tv_dim, M·D) tensor."""

  def __init__(self,
               tv_dim: int = 100,
               gmm: Optional[GMM] = None,
               niter: int = 10,
               batch_size: int = 256,
               seed: int = 1,
               device: Union[str, torch.device] = "cuda"):
    self.tv_dim = int(tv_dim)
    self.gmm = gmm
    self.niter = int(niter)
    self.batch_size = int(batch_size)
    self.seed = int(seed)
    self.device = resolve_device(device)
    self.Tm: Optional[torch.Tensor] = None  # (tv_dim, M*D) float64

  @property
  def nmix(self):
    return len(self.gmm.w)

  @property
  def ndim(self):
    return self.gmm.ndim

  def _sigma64(self) -> torch.Tensor:
    return self.gmm.sigma.reshape(-1).to(self.device, torch.float64)

  def initialize(self):
    """Tm from ``np.random.RandomState(seed).randn``, scaled by the UBM's
    standard deviations, as the JAX package draws it (bitwise)."""
    rng = np.random.RandomState(self.seed)
    sigma = _numpy(self.gmm.sigma).reshape(-1).astype(np.float64)
    Tm = rng.randn(self.tv_dim, self.nmix * self.ndim) * \
        np.sqrt(sigma)[None, :] * 0.001
    self.Tm = torch.from_numpy(Tm).to(self.device)
    return self

  def _estep_params(self):
    """(T Σ⁻¹ (R, MD), TT (M, R, R)) in fp32, once an EM iteration:
    TT[m] = T_m Σ_m⁻¹ T_mᵀ."""
    R, M, D = self.tv_dim, self.nmix, self.ndim
    T = self.Tm.to(torch.float32)
    Ts = T * (1.0 / self._sigma64()).to(torch.float32)
    with ieee_fp32_matmuls():
      TT = torch.bmm(Ts.reshape(R, M, D).permute(1, 0, 2),
                     T.reshape(R, M, D).permute(1, 2, 0))
    return Ts, TT

  @staticmethod
  def _posterior(Z, F, Ts, TT):
    """(L (B, R, R), b (B, R), chol, mean (B, R)) of a chunk, fp32:
    L = I + Σ_m Z_m TT_m, b = T Σ⁻¹ F, mean = L⁻¹ b.  A precision that is
    not positive definite gets a NaN factor, as in JAX."""
    B, M = Z.shape
    R = TT.shape[1]
    eye = torch.eye(R, dtype=torch.float32, device=Z.device)
    L = eye + (Z @ TT.reshape(M, R * R)).reshape(B, R, R)
    b = F @ Ts.T
    chol, info = torch.linalg.cholesky_ex(L)
    chol = torch.where((info > 0)[:, None, None],
                       torch.full_like(chol, float("nan")), chol)
    mean = torch.cholesky_solve(b[..., None], chol)[..., 0]
    return L, b, chol, mean

  def _stats(self, Z, F):
    """The utterance statistics as float32 tensors on the device."""
    Z = torch.atleast_2d(_on(Z, self.device, torch.float32))
    F = torch.atleast_2d(_on(F, self.device, torch.float32))
    return Z, F

  def expectation(self, Z, F) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Accumulate LU (M, R, R) and RU (R, M·D), float64 tensors on the
    device, and the auxiliary llk (a float, one host sync) over the
    utterance statistics in chunks of `batch_size`."""
    Z, F = self._stats(Z, F)
    M, R = self.nmix, self.tv_dim
    Ts, TT = self._estep_params()
    f64 = dict(dtype=torch.float64, device=self.device)
    LU = torch.zeros((M, R, R), **f64)
    RU = torch.zeros((R, M * self.ndim), **f64)
    llk = torch.zeros((), **f64)
    eye = torch.eye(R, dtype=torch.float32, device=self.device)
    with ieee_fp32_matmuls():
      for i, j in _chunk(len(Z), self.batch_size):
        z, f = Z[i:j], F[i:j]
        L, b, chol, mean = self._posterior(z, f, Ts, TT)
        cov = torch.cholesky_solve(eye.expand(j - i, R, R), chol)
        Exx = cov + mean[:, :, None] * mean[:, None, :]      # (B, R, R)
        LU += (z.T @ Exx.reshape(j - i, R * R)).reshape(M, R, R)
        RU += mean.T @ f
        llk += -0.5 * torch.sum(Exx * (L - eye).transpose(1, 2)) + \
            torch.sum(mean * b)
    return LU, RU, float(llk)

  def expectation_sharded(self, Z, F, mesh=None):
    raise _not_ported("Tmatrix.expectation_sharded")

  def maximization(self, LU, RU, orthogonalize: bool = True):
    """Solve LU_m T_m = RU_m for every mixture at once (reference :1818),
    then re-orthogonalise the row space with U of the SVD of Tm Tmᵀ; float64
    on the device."""
    M, D, R = self.nmix, self.ndim, self.tv_dim
    LU = _on(LU, self.device, torch.float64)
    RU = _on(RU, self.device, torch.float64)
    X = torch.linalg.solve(LU, RU.reshape(R, M, D).permute(1, 0, 2))
    Tm = X.permute(1, 0, 2).reshape(R, M * D)
    if orthogonalize:
      U, _, _ = torch.linalg.svd(Tm @ Tm.T)
      Tm = U.T @ Tm
    self.Tm = Tm
    return self

  def fit(self, stats, verbose: bool = False, mesh=None) -> "Tmatrix":
    """`niter` EM iterations over the (Z, F) utterance statistics."""
    if mesh is not None:
      raise _not_ported("Tmatrix.fit(mesh=...)")
    Z, F = self._stats(*stats)
    if self.Tm is None:
      self.initialize()
    for it in range(self.niter):
      LU, RU, llk = self.expectation(Z, F)
      self.maximization(LU, RU)
      if verbose:
        print(f"[Tmatrix] iter={it} aux-llk={llk / len(Z):.4f}")
    return self

  def transform(self, stats) -> torch.Tensor:
    """Posterior-mean i-vectors (B, tv_dim), float32 on the device
    (reference :1898)."""
    Z, F = self._stats(*stats)
    Ts, TT = self._estep_params()
    with ieee_fp32_matmuls():
      return torch.cat([self._posterior(Z[i:j], F[i:j], Ts, TT)[3]
                        for i, j in _chunk(len(Z), self.batch_size)])

  def state(self) -> Dict:
    """``{tv_dim, Tm}`` with Tm a float64 numpy array, as the JAX package's
    ``Tmatrix.save`` writes."""
    return dict(tv_dim=self.tv_dim,
                Tm=None if self.Tm is None else _numpy(self.Tm))

  def load_state(self, state) -> "Tmatrix":
    self.tv_dim = int(state["tv_dim"])
    self.Tm = _on(state["Tm"], self.device, torch.float64)
    return self

  def save(self, path: str):
    with open(path, "wb") as f:
      pickle.dump(self.state(), f)

  def __repr__(self):
    return (f"Tmatrix(tv_dim={self.tv_dim}, "
            f"nmix={self.nmix if self.gmm else None})")
