"""Model explanation: adversarial attacks and DeepDream (PyTorch port of
``odin_tpu/explain``).  Both are gradient ascents on a model's input,
loops over ``torch.autograd.grad`` on the device of the input (the card
for an array unless `device` says otherwise); they return tensors there.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["fgsm_attack", "pgd_attack", "AdversarialAttack", "DeepDream"]


def _input(x, device) -> torch.Tensor:
  return as_tensor(x, device_of(x, device=device), torch.float32).detach()


def _grad(loss_fn: Callable, x: torch.Tensor) -> torch.Tensor:
  x = x.detach().requires_grad_()
  with torch.enable_grad():
    return torch.autograd.grad(loss_fn(x), x)[0]


def fgsm_attack(loss_fn: Callable, x, epsilon: float = 0.01,
                clip: tuple = (0.0, 1.0), device=None) -> torch.Tensor:
  """``clip(x + eps · sign(∇x loss))``: the fast gradient sign attack."""
  x = _input(x, device)
  return torch.clamp(x + epsilon * torch.sign(_grad(loss_fn, x)), *clip)


def pgd_attack(loss_fn: Callable, x, epsilon: float = 0.03,
               step_size: float = 0.007, n_steps: int = 10,
               clip: tuple = (0.0, 1.0), device=None) -> torch.Tensor:
  """Projected gradient descent: `n_steps` sign steps of `step_size`,
  each projected onto the L∞ ball of radius `epsilon` around x and onto
  `clip`."""
  x0 = _input(x, device)
  x_adv = x0
  for _ in range(int(n_steps)):
    x_adv = x_adv + step_size * torch.sign(_grad(loss_fn, x_adv))
    x_adv = torch.clamp(torch.minimum(torch.maximum(x_adv, x0 - epsilon),
                                      x0 + epsilon), *clip)
  return x_adv


class AdversarialAttack:
  """Attack a VAE: ascend its negative ELBO with respect to the input.

  Each loss evaluation draws the ELBO's noise afresh from a generator
  seeded `seed` on the model's device, so every step sees the same draw
  (the JAX package draws from ``PRNGKey(0)`` each time); `eps`, if given,
  is that draw instead (the standard normals of the posterior's sample,
  as ``elbo_components`` takes them)."""

  def __init__(self, model, epsilon: float = 0.01, method: str = "fgsm",
               n_steps: int = 10, seed: int = 0, eps=None):
    self.model = model
    self.epsilon = float(epsilon)
    self.method = method
    self.n_steps = int(n_steps)
    self.seed = int(seed)
    self.eps = eps

  def _loss(self, x) -> torch.Tensor:
    from odin_tpu_torch.training.core import Noise
    noise = (Noise(eps=self.eps) if self.eps is not None else
             Noise(torch.Generator(self.model.device).manual_seed(self.seed)))
    llk, kl, _ = self.model.elbo_components(self.model._params_of(), x,
                                            noise, 0)
    return -torch.mean(self.model.elbo(llk, kl))

  def attack(self, x) -> torch.Tensor:
    x = _input(x, self.model.device)
    if self.method == "fgsm":
      return fgsm_attack(self._loss, x, self.epsilon)
    return pgd_attack(self._loss, x, self.epsilon, self.epsilon / 3,
                      self.n_steps)


class DeepDream:
  """Gradient-ascent feature amplification: each of `n_steps` steps adds
  `step_size` times the gradient of ``mean(h²)`` (``h = feature_fn(x)``),
  divided by its population std plus 1e-8, and clips to the range."""

  def __init__(self, feature_fn: Callable, step_size: float = 0.01,
               n_steps: int = 50):
    self.feature_fn = feature_fn
    self.step_size = float(step_size)
    self.n_steps = int(n_steps)

  def dream(self, x, clip: tuple = (0.0, 1.0),
            device=None) -> torch.Tensor:
    def objective(x):
      h = self.feature_fn(x)
      return torch.mean(h * h)

    x = _input(x, device)
    for _ in range(self.n_steps):
      g = _grad(objective, x)
      g = g / (torch.std(g, correction=0) + 1e-8)
      x = torch.clamp(x + self.step_size * g, *clip)
    return x
