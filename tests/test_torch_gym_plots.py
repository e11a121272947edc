"""The data of the Gym's plots in the port (``odin_tpu_torch/bay/vi/
disentanglement_gym.py``'s ``_plot_data_<name>``, ``odin_tpu_torch/
search.py``) against the JAX package's Gym, on the CPU.

The models: ``BetaVAE`` at zdim 4 on the same weights (the JAX state made
from the port's params), as tests/test_torch_gym.py builds them, on 200
test images of ``dSpritesSmall(n_samples=256)``: the port's Gym runs them,
and the JAX model encodes and decodes them as the JAX Gym's ``run_model``
does (its ELBO terms, which no plot reads, left out).  Each plot's data,
which the port computes on the model's device in ``_plot_data_<name>``, is
held against what the JAX package's plot computes from those: the
reconstructions, traversal,
interpolation and prior-sample decodes (JAX's prior draws injected), the
per-pixel −log p(x|z) statistics, the latent statistics and the aligned
correlation matrix within 1e-4 (the two packages' ``z_mean`` differ by up
to 1e-5: XLA and torch round the convolutions apart); the histograms'
counts equal to ``np.histogram``'s on the port's latents (what matplotlib
counts).  tests/test_torch_gym_draw.py draws the plots;
tests/test_torch_tsne.py holds the t-SNE.
"""
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import odin_tpu.bay.vi as jvi
from odin_tpu.bay.vi import metrics as jm
from odin_tpu.fuel import dSpritesSmall as JdSpritesSmall
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu.search import diagonal_linear_assignment as jax_align
from odin_tpu.training.core import TrainState as JaxTrainState

import odin_tpu_torch.bay.vi as vi
from odin_tpu_torch.fuel import dSpritesSmall
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.weights import to_jax_params

torch.set_num_threads(2)
warnings.filterwarnings("ignore", module="sklearn")
ZDIM = 4
N_GYM = 200


@pytest.fixture(scope="module")
def gyms():
  """(the port's Gym, the JAX side: its model, inputs, posterior,
  reconstruction and factors, as the JAX Gym holds them)."""
  vae = vi.BetaVAE(**get_networks("dsprites", zdim=ZDIM)).build(
      seed=1, device="cpu")
  jvae = jvi.BetaVAE(**jax_get_networks("dsprites", zdim=ZDIM))
  jvae.input_shape = (64, 64, 1)
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(2), mutables={})
  ds = JdSpritesSmall(n_samples=256)
  x, y = ds.numpy("test")
  x, y = ds.normalize255(x)[:N_GYM], y[:N_GYM]
  qz = jvae.encode(x)
  ref = types.SimpleNamespace(model=jvae, x_true=x, factors_original=y,
                              qz=qz, z_mean=np.asarray(qz.mean()),
                              px=jvae.decode(qz.mean()))
  gym = vi.DisentanglementGym(dataset=dSpritesSmall(n_samples=256),
                              model=vae, batch_size=64)
  gym.run_model(n_samples=N_GYM, partition="test")
  return gym, ref


def close(got, want, atol=1e-4):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                             atol=atol)


def test_decode_plots_match_jax(gyms):
  gym, jgym = gyms
  jvae = jgym.model
  orig, recon = gym._plot_data_reconstruction(16)
  np.testing.assert_array_equal(orig, jgym.x_true[:16])
  close(recon, np.asarray(jgym.px.mean())[:16])
  want = np.asarray(jvae.sample_traverse(
      jgym.x_true[:1], feature_indices=list(range(ZDIM)),
      n_traverse_points=5, seed=1).mean()).reshape(ZDIM, 5, 64, 64, 1)
  close(gym._plot_data_latents_traverse(5, ZDIM, seed=1), want)
  za, zb = jgym.z_mean[3], jgym.z_mean[7]
  ts = np.linspace(0.0, 1.0, 6)[:, None]
  want = np.asarray(jvae.decode(((1 - ts) * za[None] + ts * zb[None]).astype(
      "f"), seed=1).mean())
  close(gym._plot_data_interpolation(3, 7, 6), want)
  z = np.asarray(jvae.sample_prior(9, seed=1))
  close(gym._plot_data_prior_sampling(9, z=torch.tensor(z)),
        np.asarray(jvae.decode(z, seed=1).mean()))
  assert gym._plot_data_prior_sampling(9).shape == (9, 64, 64, 1)


def test_statistics_plots_match_jax(gyms):
  gym, jgym = gyms
  base = getattr(jgym.px, "distribution", jgym.px)
  nll = -np.asarray(base.log_prob(jgym.x_true))
  mean, std = gym._plot_data_distortion()
  close(mean, nll.mean(0))
  close(std, nll.std(0))
  mu = np.asarray(jgym.qz.mean()).reshape(N_GYM, -1)
  sd = np.asarray(jgym.qz.stddev()).reshape(N_GYM, -1)
  kld = np.mean(0.5 * (mu ** 2 + sd ** 2 - 1.0 - 2.0 * np.log(sd)), 0)
  ids = np.argsort(sd.mean(0))
  for got, want in zip(gym._plot_data_latents_stats(),
                       (mu.mean(0)[ids], sd.mean(0)[ids], kld[ids])):
    close(got, want)
  want = jm.correlation_matrix(jgym.z_mean, jgym.factors_original)
  np.testing.assert_array_equal(
      gym._plot_data_correlation("spearman"),
      gym.correlation_matrix("spearman").numpy()[jax_align(np.abs(
          gym.correlation_matrix("spearman").numpy()))])
  close(gym._plot_data_correlation("spearman"),
        want[jax_align(np.abs(want))])


def test_histogram_plots_count_as_numpy(gyms):
  gym, _ = gyms
  z = gym.z_mean.numpy()
  counts, edges = gym._plot_data_histogram(40)
  zs, colors, (pair_counts, pair_edges) = \
      gym._plot_data_pairwise_scatter(1, 3)
  np.testing.assert_array_equal(zs, z[:, :3])
  np.testing.assert_array_equal(colors, gym.groundtruth.factors[:, 1])
  for j in range(ZDIM):
    want, want_edges = np.histogram(z[:, j], bins=40)
    np.testing.assert_array_equal(counts[j], want)
    np.testing.assert_array_equal(edges[j], want_edges)
  for j in range(3):
    want, want_edges = np.histogram(z[:, j], bins=30)
    np.testing.assert_array_equal(pair_counts[j], want)
    np.testing.assert_array_equal(pair_edges[j], want_edges)
