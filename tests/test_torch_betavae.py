"""The port's dSprites beta-VAE and its serving functions against the JAX
package on the CPU.

The JAX ``BetaVAE(**get_networks('dsprites', zdim=10))`` is built once, its
params are carried across with ``from_jax_params``, and both models see the
same seeded batch of 4 binary 64x64 images and the same latents.  Outputs
are held to atol 1e-4 and the log-likelihood (a sum over 4,096 pixels) to
rtol 1e-4: fp32 convolutions summed in another order.
"""
import numpy as np
import pytest
import torch

import jax

from odin_tpu.bay.vi import BetaVAE as JaxBetaVAE
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu_torch import serving
from odin_tpu_torch.bay.distributions import (
    Bernoulli,
    Independent,
    MultivariateNormalDiag,
    Normal,
    exact_kl,
)
from odin_tpu_torch.bay.vi import BetaVAE
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

ATOL = 1e-4
RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
  jvae = JaxBetaVAE(beta=1.0, **jax_get_networks("dsprites", zdim=10))
  jvae.build(seed=1)
  params = jax.device_get(jvae.state.params)
  vae = BetaVAE(beta=1.0, **get_networks("dsprites", zdim=10))
  vae.build(seed=3, device="cpu")
  vae.core.load_state_dict(from_jax_params(params), strict=True)
  x = (np.random.RandomState(0).rand(4, 64, 64, 1) < 0.5).astype(np.float32)
  z = np.random.RandomState(1).randn(4, 10).astype(np.float32)
  return jvae, vae, params, x, z


def _np(t):
  return t.detach().cpu().numpy()


def test_encode_matches_jax(models):
  jvae, vae, _, x, _ = models
  want = jvae.encode(x, jit=False)
  got = vae.encode(x)
  assert isinstance(got, MultivariateNormalDiag)
  assert tuple(got.mean().shape) == (4, 10)
  np.testing.assert_allclose(_np(got.mean()), np.asarray(want.mean()),
                             atol=ATOL)
  np.testing.assert_allclose(_np(got.stddev()), np.asarray(want.stddev()),
                             atol=ATOL)


def test_decode_logits_match_jax(models):
  jvae, vae, _, _, z = models
  want = jvae.decode(z, jit=False)
  got = vae.decode(z)
  assert isinstance(got, Independent) and isinstance(got.distribution,
                                                     Bernoulli)
  assert tuple(got.event_shape) == (64, 64, 1)
  np.testing.assert_allclose(_np(got.distribution.logits),
                             np.asarray(want.distribution.logits), atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 2, 10), (3, 1, 10)])
def test_decode_with_sample_dims_matches_jax(models, shape):
  """z with leading sample dims is decoded flat and returns (px, lead)."""
  jvae, vae, _, _, _ = models
  z = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
  want, want_lead = jvae.decode(z, jit=False)
  got, lead = vae.decode(z)
  assert lead == tuple(want_lead) == shape[:-1]
  assert tuple(got.mean().shape) == (shape[0] * shape[1], 64, 64, 1)
  np.testing.assert_allclose(_np(got.distribution.logits),
                             np.asarray(want.distribution.logits), atol=ATOL)


def test_reconstruct_matches_jax(models):
  jvae, vae, _, x, _ = models
  jqz, jpx = jvae.reconstruct(x)
  qz, px = vae.reconstruct(x)
  np.testing.assert_allclose(_np(qz.mean()), np.asarray(jqz.mean()), atol=ATOL)
  np.testing.assert_allclose(_np(px.mean()), np.asarray(jpx.mean()), atol=ATOL)


def test_log_prob_matches_jax(models):
  jvae, vae, _, x, z = models
  want = np.asarray(jvae.decode(z, jit=False).log_prob(x))
  got = _np(vae.decode(z).log_prob(torch.from_numpy(x)))
  assert got.shape == (4,)
  np.testing.assert_allclose(got, want, rtol=RTOL)


def test_posterior_sample_and_log_prob_match_jax(models):
  """The reparameterised sample for a given noise, and its density."""
  jvae, vae, _, x, _ = models
  eps = np.random.RandomState(2).randn(4, 10).astype(np.float32)
  jqz = jvae.encode(x, jit=False)
  qz = vae.encode(x)
  want = np.asarray(jqz.loc) + np.asarray(jqz.scale_diag) * eps
  got = qz.sample(eps=torch.from_numpy(eps))
  np.testing.assert_allclose(_np(got), want, atol=ATOL)
  np.testing.assert_allclose(_np(qz.log_prob(got)),
                             np.asarray(jqz.log_prob(want)), rtol=RTOL)
  prior = vae.latents_prior
  assert isinstance(prior, MultivariateNormalDiag)
  np.testing.assert_allclose(
      _np(exact_kl(qz, prior)),
      np.asarray(jqz.kl_divergence(jvae.latents_prior)), rtol=RTOL)


def test_serving_functions_match_jax(models):
  jvae, vae, _, x, z = models
  enc = serving.encode_mean(vae, x)
  dec = serving.decode_mean(vae, z)
  rec = serving.reconstruct(vae, x)
  assert tuple(enc.shape) == (4, 10)
  assert tuple(dec.shape) == tuple(rec.shape) == (4, 64, 64, 1)
  assert float(dec.min()) >= 0.0 and float(dec.max()) <= 1.0
  np.testing.assert_allclose(_np(enc), np.asarray(jvae.encode(x).mean()),
                             atol=ATOL)
  np.testing.assert_allclose(_np(dec), np.asarray(jvae.decode(z).mean()),
                             atol=ATOL)
  np.testing.assert_allclose(_np(rec),
                             np.asarray(jvae.reconstruct(x)[1].mean()),
                             atol=ATOL)


def test_vae_weights_round_trip(models):
  _, vae, params, _, _ = models
  back = to_jax_params(vae.core)
  flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                    jax.tree_util.tree_flatten_with_path(t)[0]}
  want, got = flat(params["vae"]), flat(back)
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_is_seeded_and_shaped():
  a = BetaVAE(**get_networks("dsprites", zdim=10)).build(seed=5, device="cpu")
  b = BetaVAE(**get_networks("dsprites", zdim=10)).build(seed=5, device="cpu")
  c = BetaVAE(**get_networks("dsprites", zdim=10)).build(seed=6, device="cpu")
  sa, sb, sc = (m.core.state_dict() for m in (a, b, c))
  assert set(sa) == set(sb)
  assert all(torch.equal(sa[k], sb[k]) for k in sa)
  assert not torch.equal(sa["encoder.layers.1.weight"],
                         sc["encoder.layers.1.weight"])
  assert a.zdim == 10 and a.input_shape == (64, 64, 1)
  assert tuple(sa["decoder.layers.2.weight"].shape) == (8, 64, 4, 4)
  assert sum(v.numel() for v in sa.values()) == 373685


def test_normal_head_matches_jax_builder():
  """The 'normal' alias (loc, softplus + 1e-5 scale) on the same params."""
  from odin_tpu.bay.distribution_alias import parse_distribution as jparse
  from odin_tpu_torch.bay.distribution_alias import parse_distribution
  params = np.random.RandomState(3).randn(2, 12).astype(np.float32)
  x = np.random.RandomState(4).randn(2, 6).astype(np.float32)
  want = jparse("normal").builder(params, (6,))
  got = parse_distribution("normal").builder(torch.from_numpy(params), (6,))
  assert isinstance(got.distribution, Normal)
  np.testing.assert_allclose(_np(got.stddev()), np.asarray(want.stddev()),
                             atol=1e-6)
  np.testing.assert_allclose(_np(got.log_prob(torch.from_numpy(x))),
                             np.asarray(want.log_prob(x)), rtol=RTOL)


@pytest.mark.parametrize("family", ["normal", "mvndiag", "bernoulli"])
def test_analytic_kl_matches_jax(family):
  from odin_tpu.bay import distributions as jd
  from odin_tpu_torch.bay import distributions as td
  rs = np.random.RandomState(5)
  a, b = rs.randn(2, 3, 4).astype(np.float32)
  sa, sb = (np.exp(rs.randn(2, 3, 4)) + 0.1).astype(np.float32)
  if family == "normal":
    jq, jp = jd.Normal(a, sa), jd.Normal(b, sb)
    q, p = td.Normal(torch.from_numpy(a), torch.from_numpy(sa)), td.Normal(
        torch.from_numpy(b), torch.from_numpy(sb))
  elif family == "mvndiag":
    jq, jp = jd.MultivariateNormalDiag(a, sa), jd.MultivariateNormalDiag(b, sb)
    q = td.MultivariateNormalDiag(torch.from_numpy(a), torch.from_numpy(sa))
    p = td.MultivariateNormalDiag(torch.from_numpy(b), torch.from_numpy(sb))
  else:
    jq, jp = jd.Bernoulli(logits=a), jd.Bernoulli(logits=b)
    q, p = td.Bernoulli(torch.from_numpy(a)), td.Bernoulli(torch.from_numpy(b))
  np.testing.assert_allclose(_np(exact_kl(q, p)), np.asarray(jd.exact_kl(jq, jp)),
                             rtol=RTOL, atol=1e-6)
  x = (rs.rand(3, 4) < 0.5).astype(np.float32)
  np.testing.assert_allclose(_np(q.log_prob(torch.from_numpy(x))),
                             np.asarray(jq.log_prob(x)), rtol=RTOL, atol=1e-6)
