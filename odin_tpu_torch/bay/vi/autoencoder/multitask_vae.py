"""Multitask semi-supervised VAEs of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/multitask_vae.py:47-114``): ``MultitaskVAE``
(a labels head on the decoder's hidden state), ``SkiptaskVAE`` and
``MultiheadVAE`` (the head on the latents).  The labelled rows' labels
log-likelihood, weighted by `alpha`, joins the ELBO as ``llk_labels``
(``masked_mean_llk``: 0 on a batch with no labelled row).

Batches: ``x`` unlabelled, ``(x, y)`` labelled, ``(x, y, mask)``
semi-supervised with mask 1 on the labelled rows.
"""
from __future__ import annotations

from typing import Optional

from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import AnnealingVAE
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    masked_mean_llk,
)

__all__ = ["MultitaskVAE", "SkiptaskVAE", "MultiheadVAE"]


class MultitaskVAE(AnnealingVAE):
  """Semi-supervised VAE with a supervised head on the decoder's hidden
  state (Trong et al. 2019)."""

  def __init__(self,
               labels: Optional[RVconf] = None,
               alpha: float = 10.0,
               skip_decoder: bool = False,
               **kwargs):
    if labels is None:
      labels = RVconf(10, "onehot", projection=True, name="digits")
    self.alpha = float(alpha)
    self.skip_decoder = bool(skip_decoder)
    kwargs["labels"] = labels
    super().__init__(**kwargs)

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  def predict_labels(self, x=None, latents=None, params=None):
    """q(y|.) from the decoder's hidden state (the latents with
    ``skip_decoder``) of the posterior mean of x, or of `latents`."""
    params = params or self._params_of()
    mut = self._mutables()
    z = self.encode(x, params).mean() if latents is None \
        else self._tensor(latents)
    h = z if self.skip_decoder else self._core(params, "decoder_hidden", z,
                                               mutables=mut)
    return self._core(params, "predict_labels", h, mutables=mut)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    llk, kl, aux = super().elbo_components(params, x, rng, step,
                                           training=training,
                                           mutables=mutables)
    if y is not None:
      z = aux["z"]
      h = z if self.skip_decoder else self._core(
          params, "decoder_hidden", z, training=training, mutables=mutables)
      qy = self._core(params, "predict_labels", h, training=training,
                      mutables=mutables)
      llk["llk_labels"] = masked_mean_llk(self.alpha * qy.log_prob(y), mask)
      aux["qy"] = qy
    return llk, kl, aux


class SkiptaskVAE(MultitaskVAE):
  """The labels head on the latents."""

  def __init__(self, **kwargs):
    kwargs.pop("skip_decoder", None)
    super().__init__(skip_decoder=True, **kwargs)


class MultiheadVAE(MultitaskVAE):
  """A head for the labels on the latents; with one set of labels, the
  Skiptask model."""

  def __init__(self, **kwargs):
    kwargs.pop("skip_decoder", None)
    super().__init__(skip_decoder=True, **kwargs)
