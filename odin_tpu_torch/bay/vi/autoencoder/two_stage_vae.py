"""TwoStageVAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/two_stage_vae.py``; Dai & Wipf 2019): stage
1 is the VAE over x, stage 2 a second VAE ``u ~ q(u|z)`` over stage 1's
codes, its own 'stage2' partition.  Both stages train in one step, the
second on codes with no gradient to the first."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from odin_tpu_torch.bay.helpers import kl_divergence, map_distributions
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import VAECore
from odin_tpu_torch.networks.base import Dense, SequentialNetwork
from odin_tpu_torch.training.core import TrainStep, as_noise

__all__ = ["TwoStageVAE"]


class TwoStageVAE(BetaVAE):

  def __init__(self,
               udim: Optional[int] = None,
               stage2_units: int = 128,
               stage2_layers: int = 2,
               **kwargs):
    super().__init__(**kwargs)
    self.udim = int(udim or self.zdim)
    dense = lambda: SequentialNetwork(
        [Dense(int(stage2_units), "relu") for _ in range(stage2_layers)])
    self.latents2_conf = RVconf(self.udim, "mvndiag", projection=True,
                                name="u")
    self.stage2 = VAECore(
        dense(), dense(), self.latents2_conf.create_posterior(),
        RVconf((self.zdim,), "gaussian", projection=True,
               name="z").create_posterior())
    self._u_priors: Dict[torch.device, object] = {}

  def extra_networks(self):
    return {"stage2": (self.stage2, (self.zdim,))}

  def _u_prior_on(self, device):
    if device not in self._u_priors:
      self._u_priors[device] = map_distributions(
          lambda t: t.to(device), self.latents2_conf.create_prior())
    return self._u_priors[device]

  def elbo_components2(self, params, z, rng, step, training=False):
    """The stage-2 ELBO terms over codes z (B, zdim)."""
    noise = as_noise(rng)
    qu = self._apply_module(params, "stage2", z, training=training,
                            method="encode")
    u = qu.sample_from(noise)
    pz = self._apply_module(params, "stage2", u, training=training,
                            method="decode")
    llk = {"llk_z": pz.log_prob(z)}
    kl = {"kl_u": kl_divergence(qu, self._u_prior_on(u.device),
                                analytic=self.analytic, q_sample=u,
                                reverse=self.reverse)}
    return llk, kl, dict(qu=qu, pz=pz, u=u)

  def _stage2_loss(self, params, batch, rng, step, mutables):
    x, _ = self._split_inputs(batch)
    noise = as_noise(rng)
    qz = self._apply(params, "encode", x, True, mutables, noise)
    z = qz.sample_from(noise).reshape(-1, self.zdim).detach()
    llk, kl, _ = self.elbo_components2(params, z, noise, step, training=True)
    loss = -torch.mean(self.elbo(llk, kl))
    metrics = {k: torch.mean(v) for k, v in {**llk, **kl}.items()}
    return loss, (metrics, mutables)

  def train_steps(self):
    return [
        TrainStep(loss_fn=self._vae_loss, partitions=("vae",), name="stage1"),
        TrainStep(loss_fn=self._stage2_loss, partitions=("stage2",),
                  name="stage2"),
    ]

  def sample_prior(self, n: int = 1, seed: int = 0) -> torch.Tensor:
    """Ancestral sampling through stage 2, the corrected prior of Dai &
    Wipf: u ~ p(u), then z ~ p(z|u)."""
    gen = self._generator(seed)
    u = self._u_prior_on(self.device).sample((n,), generator=gen)
    pz = self._apply_module(self._params_of(), "stage2", u, method="decode")
    return pz.sample(generator=gen)
