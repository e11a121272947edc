"""bf16 compute and gradient clipping in the port's training step against
the JAX package on the CPU, on the full-width dSprites beta-VAE at batch
4 (see tests/test_torch_training.py for the set-up; params after the
steps by ``assert_params_close``, whose rule tests/torch_training_common.py
states; float32 losses rtol 1e-4).

bf16: both packages cast params and batch to bfloat16 inside the loss, so
every product rounds to bf16's 8-bit significand (relative step 2^-8)
where each library rounds it.  Losses: rtol 2^-8·4.  Params: the same rule
with atol 2e-4, a fifth of one step at lr 1e-3, for all but 0.5 % of the
elements (0.23 % measured); the rest are elements whose bf16 gradient is
rounding noise.
"""
import pytest
import torch

import jax.numpy as jnp

from torch_training_common import check_run, make_pair, run_both

torch.set_num_threads(2)

BF16_LOSS_RTOL = 2 ** -8 * 4
BF16_PARAM_ATOL = 2e-4
BF16_FAR_SHARE = 5e-3


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


def test_bf16_compute_matches_jax_bf16(pair):
  mets, js, s = run_both(pair, jax_dtype=jnp.bfloat16,
                         compute_dtype=torch.bfloat16)
  check_run(mets, js, s, loss_rtol=BF16_LOSS_RTOL, atol=BF16_PARAM_ATOL,
            share=BF16_FAR_SHARE)
  # master params, moments and metrics stay float32
  assert all(v.dtype == torch.float32 for v in s.params["vae"].values())
  assert all(v.dtype == torch.float32
             for v in s.opt_states["vae"]["mu"]["vae"].values())
  assert all(v.dtype == torch.float32 for v in mets[-1][1].values())


def test_clipping_matches_jax(pair):
  """clipvalue, then clip_by_block_rms (each tensor's RMS on its own),
  then clip_by_global_norm, each set low enough to clip this batch."""
  check_run(*run_both(pair, clipvalue=0.5, clipnorm=0.05,
                      global_clipnorm=2.0))
