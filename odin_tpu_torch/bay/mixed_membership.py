"""Mixed-membership models of the port (PyTorch port of
``odin_tpu/bay/mixed_membership.py``: ``_GoMCore`` :46-87 and
``GradeMembershipModel`` :90-184; the LDA family re-exported from the VAE
zoo, ``LatentDirichletAllocation`` the JAX package's name of its
decoder).

The Grade-of-Membership model reads integer answer sheets (B, Q) with
values in [0, A): each respondent has a Dirichlet posterior over K
profiles for each question, and each profile fixes an answer distribution
per question.  Every per-question parameter is stacked on a leading
question axis, so a sheet goes through three einsums (the encoder MLP, the
concentration head, the profile-to-answer mixture), as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.distributions import Dirichlet
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.lda_vae import (  # noqa: F401
    ALDA,
    LatentDirichletDecoder,
    amortizedLDA,
    auxiliaryLDA,
    nonlinearLDA,
)
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)
from odin_tpu_torch.training.core import as_noise

LatentDirichletAllocation = LatentDirichletDecoder

__all__ = ["LatentDirichletAllocation", "LatentDirichletDecoder",
           "amortizedLDA", "auxiliaryLDA", "nonlinearLDA", "ALDA",
           "GradeMembershipModel"]


def _glorot_normal(shape, generator) -> nn.Parameter:
  """flax's ``glorot_normal`` (a truncated normal of variance 2 / (fan_in
  + fan_out), the leading axes counted in both fans)."""
  receptive = int(np.prod(shape[:-2]))
  fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
  std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
  w = torch.empty(shape)
  nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                        generator=generator)
  return nn.Parameter(w)


class _GoMCore(nn.Module):
  """One-hot answers -> a Dirichlet posterior over the profiles for each
  question (``enc_w{i}``/``enc_b{i}`` (Q, in, out), ``conc_w``/``conc_b``);
  profiles -> answer probabilities (``profile_logits`` (Q, K, A))."""

  def __init__(self, n_questions: int, n_answers: int, n_components: int,
               hidden: Tuple[int, ...] = (16, 16)):
    super().__init__()
    self.n_questions = int(n_questions)
    self.n_answers = int(n_answers)
    self.n_components = int(n_components)
    self.hidden = tuple(int(h) for h in hidden)

  def build(self, input_shape=None, generator=None):
    q, a, k = self.n_questions, self.n_answers, self.n_components
    dims = (a,) + self.hidden
    for i in range(len(self.hidden)):
      setattr(self, f"enc_w{i}", _glorot_normal((q, dims[i], dims[i + 1]),
                                                generator))
      setattr(self, f"enc_b{i}", nn.Parameter(torch.zeros(q, dims[i + 1])))
    self.conc_w = _glorot_normal((q, dims[-1], k), generator)
    self.conc_b = nn.Parameter(torch.zeros(q, k))
    self.profile_logits = _glorot_normal((q, k, a), generator)

  def encode(self, x) -> Dirichlet:
    h = F.one_hot(x.long(), self.n_answers).to(torch.float32)
    for i in range(len(self.hidden)):
      h = F.relu(torch.einsum("bqi,qij->bqj", h, getattr(self, f"enc_w{i}"))
                 + getattr(self, f"enc_b{i}"))
    conc = F.softplus(torch.einsum("bqi,qik->bqk", h, self.conc_w) +
                      self.conc_b)
    return Dirichlet(torch.clamp(conc, 1e-3, 1e3))

  def decode(self, theta) -> torch.Tensor:
    probs = torch.softmax(self.profile_logits, dim=-1)        # (Q, K, A)
    answer = torch.einsum("...qk,qka->...qa", theta, probs)
    return torch.clamp(answer, 1e-4, 1.0 - 1e-4)

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    q = self.encode(args[0])
    return self.decode(q.mean()), q


class GradeMembershipModel(VariationalAutoencoder):
  """Grade-of-Membership model on answer sheets (B, n_questions): each
  respondent's per-question Dirichlet posterior over `n_components`
  profiles against the shared prior ``Dirichlet(components_prior)``; the
  ELBO is the per-question ``llk - KL`` averaged over the questions, the
  KL warmed up linearly over `warmup_steps` in training."""

  def __init__(self, n_questions: int, n_answers: int,
               n_components: int = 10, components_prior: float = 0.7,
               encoder_layers: Tuple[int, ...] = (16, 16),
               warmup_steps: int = 0, **kwargs):
    self.n_questions = int(n_questions)
    self.n_answers = int(n_answers)
    self.n_components = int(n_components)
    self.encoder_layers = tuple(int(u) for u in encoder_layers)
    for k in ("latents", "observation", "encoder", "decoder"):
      kwargs.pop(k, None)
    kwargs.setdefault("input_shape", (self.n_questions,))
    super().__init__(
        encoder=None, decoder=None,
        latents=RVconf(self.n_components, "dirichlet", projection=True,
                       name="profiles"),
        observation=RVconf((self.n_questions,), "deterministic",
                           projection=False, name="answers"),
        **kwargs)
    self.components_prior = float(components_prior)
    self.warmup_steps = int(warmup_steps)

  @property
  def latents_prior(self) -> Dirichlet:
    return Dirichlet(torch.full((self.n_components,), float(np.clip(
        self.components_prior, 1e-3, 1e3)), dtype=torch.float32))

  @property
  def zdim(self) -> int:
    return self.n_components

  def _build_core(self) -> nn.Module:
    return _GoMCore(self.n_questions, self.n_answers, self.n_components,
                    self.encoder_layers)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    q = self._apply(params, "encode", x, training, mutables, noise)
    theta = q.sample_from(noise)                              # (B, Q, K)
    answer_probs = self._apply(params, "decode", theta, training, mutables,
                               noise)
    onehot = F.one_hot(x.long(), self.n_answers).to(answer_probs.dtype)
    llk_q = torch.sum(onehot * torch.log(answer_probs), dim=-1)  # (B, Q)
    kl_q = kl_divergence(q, self._prior_on(theta.device),
                         analytic=self.analytic, q_sample=theta,
                         reverse=self.reverse)                 # (B, Q)
    if self.warmup_steps > 0 and training:
      kl_q = kl_q * torch.clamp(torch.as_tensor(step).to(torch.float32) /
                                self.warmup_steps, max=1.0)
    llk = {"llk_answers": torch.mean(llk_q, dim=-1)}
    kl = {"kl_profiles": torch.mean(kl_q, dim=-1)}
    return llk, kl, dict(qz=q, px=None, z=theta, x=x, y=y,
                         answer_probs=answer_probs)

  @torch.no_grad()
  def predict(self, x, seed: int = 0) -> np.ndarray:
    """The most likely answer to each question under the posterior-mean
    membership."""
    q = self.encode(x)
    probs = self._apply(self._params_of(), "decode", q.mean())
    return torch.argmax(probs, dim=-1).cpu().numpy()

  @torch.no_grad()
  def transform(self, x, seed: int = 0, per_question: bool = False):
    """Posterior-mean membership: (B, K) averaged over the questions (rows
    summing to 1), or (B, Q, K) with `per_question`."""
    theta = self.encode(x).mean()
    if not per_question:
      theta = torch.mean(theta, dim=1)
      theta = theta / torch.clamp(torch.sum(theta, -1, keepdim=True),
                                  min=1e-12)
    return theta.cpu().numpy()

  def get_profiles(self) -> np.ndarray:
    """Each profile's answer distribution per question (Q, K, A)."""
    return torch.softmax(self._params_of()["vae"]["profile_logits"],
                         dim=-1).cpu().numpy()
