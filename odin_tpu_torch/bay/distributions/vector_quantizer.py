"""``VectorQuantized`` of the port (PyTorch port of
``odin_tpu/bay/distributions/vector_quantizer.py:17-70``): the point mass
at a VQ-VAE's quantized codes, with the straight-through estimator and the
commitment and codebook losses."""
from __future__ import annotations

import torch

from odin_tpu_torch.bay.distributions.base import Distribution

__all__ = ["VectorQuantized"]


class VectorQuantized(Distribution):
  """`codes` (the nearest codebook entries), `inputs` (the encoder's
  outputs before quantization) and `indices` (the code of each position),
  all with the same leading dims."""
  _params = ("codes", "inputs", "indices")

  def __init__(self, codes, inputs, indices, commitment_weight: float = 0.25):
    self.codes = torch.as_tensor(codes)
    self.inputs = torch.as_tensor(inputs)
    self.indices = torch.as_tensor(indices)
    self.commitment_weight = float(commitment_weight)

  @property
  def batch_shape(self):
    return self.codes.shape[:-1]

  @property
  def event_shape(self):
    return self.codes.shape[-1:]

  def mean(self):
    """The codes forward, the identity on the inputs backward."""
    return self.inputs + (self.codes - self.inputs).detach()

  def sample(self, sample_shape=(), generator=None, eps=None):
    st = self.mean()
    return st.expand(tuple(sample_shape) + tuple(st.shape))

  def sample_from(self, noise, sample_shape=()):
    return self.sample(sample_shape)

  def mode(self):
    return self.codes

  def log_prob(self, x):
    return torch.zeros(self.batch_shape, dtype=self.codes.dtype,
                       device=self.codes.device)

  def commitment_loss(self):
    """``||sg(codes) - inputs||^2``: pulls the encoder toward its codes."""
    return torch.sum((self.codes.detach() - self.inputs) ** 2, dim=-1)

  def codebook_loss(self):
    """``||codes - sg(inputs)||^2``: moves the codebook toward the
    encodings (where the codebook is trained by gradient)."""
    return torch.sum((self.codes - self.inputs.detach()) ** 2, dim=-1)

  def kl_divergence(self, other=None, **kwargs):
    return self.commitment_weight * self.commitment_loss()
