"""Serving functions of a VAE (PyTorch port of the three functions that
``export_vae`` exports, ``odin_tpu/serving.py:160-210``).  They run the
model eagerly on its device; the exported bundle format is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["encode_mean", "decode_mean", "reconstruct"]


@torch.inference_mode()
def encode_mean(vae, x) -> torch.Tensor:
  """x (B, H, W, C) -> E[z|x] (B, zdim)."""
  return vae.encode(x).mean()


@torch.inference_mode()
def decode_mean(vae, z) -> torch.Tensor:
  """z (B, zdim) -> E[x|z] (B, H, W, C)."""
  return vae.decode(z).mean()


@torch.inference_mode()
def reconstruct(vae, x) -> torch.Tensor:
  """x -> E[x|E[z|x]]."""
  return vae.reconstruct(x)[1].mean()
