"""Rejection samplers of the port with a fixed number of proposals, so that
a sampler runs inside a captured CUDA graph with no host sync.

A loop that runs until every row is accepted (the JAX package's
``jax.random.gamma`` and the vMF ``while_loop``) decides its trip count
on the device; the port draws every round's proposals at once and keeps a
row's first accepted one.  A row that no proposal accepted is NaN, never a
silent value, and is counted on the device (``RejectionStats``); the
caller raises after the call (``check_rejections``).

  * ``sample_log_gamma``: log Gamma(alpha, 1), Marsaglia-Tsang, 8
    proposal rounds, boosted by ``U^(1/alpha)`` where alpha < 1 (the JAX
    package's ``_sample_gamma``, ``odin_tpu/bay/distributions/
    continuous.py:32``, whose misses fall back to a value; here they
    count).
  * ``sample_beta``: ``X / (X + Y)`` of two such Gammas.
  * ``gamma_draws`` and ``log_gamma_pathwise``: the same scheme with the
    JAX package's draws in its order (a normal and a uniform a round,
    then the boost's uniform) and its fallback to ``d`` where no proposal
    accepted, differentiable in alpha along the accepted proposal's path
    (the ``Dirichlet``'s sampler).  Its misses are counted as kind
    ``'dirichlet'`` but do not raise: the value is the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["sample_log_gamma", "sample_beta", "gamma_draws",
           "log_gamma_pathwise", "RejectionStats",
           "rejection_stats", "reset_rejection_stats", "check_rejections"]

GAMMA_ROUNDS = 8


class RejectionStats:
  """Device counters of one kind of rejection sampler: proposals made,
  proposals accepted, rows drawn, and rows that no proposal accepted
  (int64, added to in place, so a graph replay counts too).  A kind that
  falls back to a value where no proposal accepted (`raises` False) is
  counted and never raised for."""

  FIELDS = ("proposals", "accepted", "rows", "failed")

  def __init__(self, device: torch.device, raises: bool = True):
    self.counts = torch.zeros(len(self.FIELDS), dtype=torch.int64,
                              device=device)
    self.raises = bool(raises)

  def add(self, proposals: int, accepted: torch.Tensor, rows: int,
          failed: torch.Tensor):
    """Counts of one call: Python ints for the static counts, 0-d device
    tensors for the drawn ones (no host copy, so a capture holds it)."""
    c = self.counts
    c[0].add_(int(proposals))
    c[1].add_(accepted)
    c[2].add_(int(rows))
    c[3].add_(failed)

  def read(self) -> Dict[str, int]:
    return dict(zip(self.FIELDS, (int(v) for v in self.counts.cpu())))


_STATS: Dict[tuple, RejectionStats] = {}


def _stats(kind: str, device: torch.device,
           raises: bool = True) -> RejectionStats:
  key = (kind, torch.device(device))
  if key not in _STATS:
    _STATS[key] = RejectionStats(key[1], raises)
  return _STATS[key]


def rejection_stats() -> Dict[str, Dict[str, int]]:
  """``{'<kind>@<device>': {proposals, accepted, rows, failed}}`` of every
  sampler that ran (reads the device)."""
  return {f"{k}@{d}": s.read() for (k, d), s in _STATS.items()}


def reset_rejection_stats():
  for s in _STATS.values():
    s.counts.zero_()


def _capturing() -> bool:
  return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def check_rejections():
  """Raise where a sampler left a row that no proposal accepted since the
  last check (reads the device; a no-op while a CUDA graph is being
  captured).  Each such row is reported once."""
  if _capturing():
    return
  for (kind, device), s in _STATS.items():
    if not s.raises:
      continue
    failed = int(s.counts[3])
    if failed:
      s.counts[3].zero_()
      raise RuntimeError(f"{failed} {kind} draws on {device} found no "
                         f"accepted proposal; they are NaN")


def sample_log_gamma(generator: Optional[torch.Generator], alpha, shape,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
  """log Gamma(alpha, 1) of `shape` from `generator`: `GAMMA_ROUNDS`
  rounds of Marsaglia-Tsang proposals (a normal and a uniform each), the
  first accepted kept, plus ``log(U) / alpha`` where alpha < 1 (the boost,
  in log space, as ``jax.random.loggamma`` keeps small variates)."""
  shape = tuple(int(i) for i in shape)
  if isinstance(alpha, torch.Tensor):
    alpha = alpha.to(dtype).expand(shape)
  else:  # a fill, not a host copy: a capture holds it
    alpha = torch.full(shape, float(alpha), dtype=dtype, device=device)
  device = alpha.device
  boosted = torch.where(alpha < 1.0, alpha + 1.0, alpha)
  d = boosted - 1.0 / 3.0
  c = 1.0 / torch.sqrt(9.0 * d)
  rounds = (GAMMA_ROUNDS,) + shape
  x = torch.randn(rounds, generator=generator, dtype=dtype, device=device)
  u = torch.rand(rounds, generator=generator, dtype=dtype,
                 device=device).clamp_(min=1e-12)
  v = (1.0 + c * x) ** 3
  ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v +
                  d * torch.log(torch.where(v > 0, v, torch.ones_like(v))))
  first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
  log_s = torch.log(d) + 3.0 * torch.log(torch.take_along_dim(
      torch.where(ok, 1.0 + c * x, torch.ones_like(x)), first, dim=0)[0])
  hit = ok.any(dim=0)
  log_s = torch.where(hit, log_s, torch.full_like(log_s, float("nan")))
  _stats("gamma", device).add(ok.numel(), ok.sum(), hit.numel(),
                              (~hit).sum())
  u_boost = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device).clamp_(min=1e-12)
  return log_s + torch.where(alpha < 1.0, torch.log(u_boost) / torch.clamp(
      alpha, min=1e-6), torch.zeros_like(alpha))


def sample_beta(generator: Optional[torch.Generator], a, b, shape,
                dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
  """Beta(a, b) of `shape`: ``X / (X + Y)``, X ~ Gamma(a), Y ~ Gamma(b),
  formed from their logs as ``jax.random.beta`` forms it."""
  log_a = sample_log_gamma(generator, a, shape, dtype, device)
  log_b = sample_log_gamma(generator, b, shape, dtype, device)
  log_max = torch.maximum(log_a, log_b)
  ga, gb = torch.exp(log_a - log_max), torch.exp(log_b - log_max)
  return ga / (ga + gb)


def gamma_draws(noise, shape, dtype: torch.dtype = torch.float32,
                device=None):
  """The draws of one Gamma(alpha, 1) sample of `shape` from a
  ``training.core.Noise``, in the JAX package's order
  (``odin_tpu/bay/distributions/continuous.py:47-66``): for each of the
  `GAMMA_ROUNDS` rounds a normal and a uniform, then the boost's uniform;
  the uniforms floored at 1e-12, as JAX's ``minval``.  Returns (x, u,
  u_boost), x and u stacked on a leading rounds axis."""
  shape = tuple(int(i) for i in shape)
  xs, us = [], []
  for _ in range(GAMMA_ROUNDS):
    xs.append(noise.normal(shape, dtype, device))
    us.append(noise.uniform(shape, dtype, device).clamp(min=1e-12))
  u_boost = noise.uniform(shape, dtype, device).clamp(min=1e-12)
  return torch.stack(xs), torch.stack(us), u_boost


def log_gamma_pathwise(alpha: torch.Tensor, x: torch.Tensor,
                       u: torch.Tensor, u_boost: torch.Tensor,
                       kind: str = "dirichlet") -> torch.Tensor:
  """log Gamma(alpha, 1) from the draws of ``gamma_draws``:
  ``log d + 3 log(1 + c x) + log(u_boost) / alpha`` (the boost only where
  alpha < 1) with the first accepted round's x, or ``log d`` where no
  round accepted (the JAX package's fallback, counted as `kind`).  The
  gradient with respect to alpha is the pathwise one through d, c and the
  boost with x and u held, as JAX differentiates ``_sample_gamma``; the
  log keeps a boosted variate that a float32 ``u^(1/alpha)`` would
  flush to 0."""
  boosted = torch.where(alpha < 1.0, alpha + 1.0, alpha)
  d = boosted - 1.0 / 3.0
  c = 1.0 / torch.sqrt(9.0 * d)
  with torch.no_grad():
    cd, dd = c.detach(), d.detach()
    v = (1.0 + cd * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v + dd * torch.log(
        torch.where(v > 0, v, torch.ones_like(v))))
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    hit = ok.any(dim=0)
    x_acc = torch.take_along_dim(x, first, dim=0)[0]
  _stats(kind, alpha.device, raises=False).add(ok.numel(), ok.sum(),
                                               hit.numel(), (~hit).sum())
  cube = torch.where(hit, 1.0 + c * x_acc, torch.ones_like(c))
  log_g = torch.log(d) + 3.0 * torch.log(cube)
  return log_g + torch.where(alpha < 1.0, torch.log(u_boost) / torch.clamp(
      alpha, min=1e-6), torch.zeros_like(alpha))
