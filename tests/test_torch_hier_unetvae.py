"""UnetVAE of the port against the JAX package: the ELBO terms at steps 0
and 700 and one full training step at its defaults (beta 10, free bits 2,
no skip knob), JAX's draws replayed; its ELBO terms in training mode with
each skip knob at 0 (the knobs at 0.5 and 1.0:
tests/test_torch_hier_unetvae_{dropout,dropout1,gate,noise,noise1}.py);
and JAX's
tests/test_zoo_execution.py:291: at ``skip_sample_dropout=1.0`` the
training decode equals the generation decode exactly, while in evaluation
the gate is off and the skips flow."""
import numpy as np
import torch

import odin_tpu_torch.bay.vi as port_vi
from odin_tpu_torch.training import Noise
from torch_hier_common import (hier_matches_jax, ladder_networks,
                               unet_knob_matches_jax)

torch.set_num_threads(2)


def test_matches_jax():
  hier_matches_jax("UnetVAE")


def test_knobs_at_zero_draw_nothing_and_match_jax():
  draws = unet_knob_matches_jax("skip_dropout", 0.0)
  assert len(draws) == 1  # z alone


def test_skip_sample_gate_at_one_is_the_generation_decode():
  vae = port_vi.UnetVAE(skip_sample_dropout=1.0,
                        **ladder_networks("torch")).build(seed=0,
                                                          device="cpu")
  rs = np.random.RandomState(5)
  x = torch.from_numpy((rs.rand(6, 8, 8, 1) < 0.4).astype(np.float32))
  params = vae.state.params
  noise = lambda: Noise(torch.Generator().manual_seed(2))
  with torch.no_grad():
    qz, hiddens = vae._core(params, "encode", x, noise=noise())
    z = qz.mean()
    gated, _ = vae._core(params, "decode", z, hiddens, training=True,
                         noise=noise())
    no_skip, _ = vae._core(params, "decode", z, None, training=True,
                           noise=noise())
    evaluated, _ = vae._core(params, "decode", z, hiddens, noise=noise())
  assert torch.equal(gated.mean(), no_skip.mean())
  assert not torch.allclose(evaluated.mean(), no_skip.mean())
