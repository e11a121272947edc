"""The close variants of the semi-supervised family are different models
(the port's counterparts of tests/test_zoo_differential.py's checks):
semafod against semafoh, the decode paths of semafos, semafosm and
semafosc, ConditionalM2VAE's marginal ELBO against the explicit sum over
its classes, M3's learned prior, M2's and M3's encode and decode, the
Semi-Factor pair putting its ELBO on the first (labelled) half of a
batch, M3's posteriors concatenated for the Gym, and ADGM's posterior path
against the JAX core's (the port's ``reconstruct``, the Gym's evaluation
surface, follows it where the JAX package's refuses its shapes)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import odin_tpu_torch.bay.vi as vi
from odin_tpu_torch.training import Noise
from torch_semi_common import N_LABELS, semi_batch, semi_networks, semi_pair
from torch_zoo_common import binary_images


def _model(name, **kwargs):
  return getattr(vi, name)(**kwargs, **semi_networks(name, "torch")).build(
      seed=2, device="cpu")


def _batch(name, seed=7):
  return tuple(torch.from_numpy(a) for a in semi_batch(name, seed))


def _terms(vae, batch, seed=0, step=0, training=True):
  noise = Noise(torch.Generator().manual_seed(seed))
  return vae.elbo_components(vae.state.params, batch, noise,
                             torch.tensor(step, dtype=torch.int32),
                             training=training,
                             mutables=dict(vae.state.mutables))


def test_semafod_and_semafoh_differ():
  """semafoh's q(z_y|.) reads [h, z], semafod's h alone."""
  md, mh = _model("semafod"), _model("semafoh")
  wd = md.state.params["vae"]["latents_y.projection.weight"]
  wh = mh.state.params["vae"]["latents_y.projection.weight"]
  assert wh.shape[1] == wd.shape[1] + md.zdim
  batch = _batch("semafod")
  a, _, _ = _terms(md, batch)
  b, _, _ = _terms(mh, batch)
  assert not np.allclose(float(a["llk_observation"].mean()),
                         float(b["llk_observation"].mean()))


def test_the_semafos_decode_paths_differ():
  ms, mm, mc = _model("semafos"), _model("semafosm"), _model("semafosc")
  z = torch.randn(6, ms.zdim, generator=torch.Generator().manual_seed(0))
  y0 = torch.zeros(6, N_LABELS)
  y1 = torch.ones(6, N_LABELS)

  def decode_mean(model, y):
    return model._core(model.state.params, "decode_zy", z, y).mean()

  assert not torch.allclose(decode_mean(ms, y0), decode_mean(ms, y1))
  assert torch.equal(decode_mean(mm, y0), decode_mean(mm, y1))
  # semafos takes the true labels of the labelled rows, semafosc never
  x, y, _ = _batch("semafos")
  mask = torch.ones(len(x))
  for model, changes in ((ms, True), (mc, False)):
    a, _, _ = _terms(model, (x, y, mask))
    b, _, _ = _terms(model, (x, -y, mask))
    same = torch.equal(a["llk_observation"], b["llk_observation"])
    assert same != changes


def test_conditional_m2_is_the_explicit_sum_over_its_classes():
  """``marginal_elbo = sum_k w_k (llk - kl)(x, one-hot k)``, each class's
  bound from the same draws as the tiled batch's (row b·K + k)."""
  model = _model("ConditionalM2VAE")
  x, y, mask = _batch("ConditionalM2VAE")
  noise = Noise(torch.Generator().manual_seed(3))
  params = model.state.params
  with torch.no_grad():
    llk, kl, aux = model.elbo_components(params, (x, y, mask), noise, 0)
    assert set(llk) == {"marginal_elbo", "H_qy", "llk_qy"} and not kl
    eps = noise.drawn[0]
    assert eps.shape[0] == len(x) * N_LABELS
    w = mask[:, None] * y + (1 - mask[:, None]) * aux["qy"].mean()
    explicit = torch.zeros(len(x))
    for k in range(N_LABELS):
      onehot = torch.zeros(len(x), N_LABELS)
      onehot[:, k] = 1
      lx, kz, *_ = model._components_xy(params, x, onehot,
                                        Noise(eps=[eps[k::N_LABELS]]),
                                        False, None)
      explicit += w[:, k] * (lx - kz)
  np.testing.assert_allclose(llk["marginal_elbo"].numpy(), explicit.numpy(),
                             rtol=1e-5, atol=1e-4)
  m2 = _model("M2VAE")
  l2, _, _ = _terms(m2, (x, y, mask))
  assert "marginal_elbo" not in l2 and "llk_image" in l2


def test_m3_learns_its_prior_and_reads_the_labels():
  model = _model("reparamsM3VAE")
  params = model.state.params
  reg = [k for k in params["vae"] if k.startswith("regressor.")]
  assert sorted(reg) == sorted(f"regressor.{n}" for n in (
      "diag_loc_true", "diag_loc_false", "diag_scale_true",
      "diag_scale_false"))
  x, y, mask = _batch("reparamsM3VAE")
  p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
       for k, v in params.items()}
  llk, kl, _ = model.elbo_components(p, x, Noise(
      torch.Generator().manual_seed(0)), 0, training=True)
  (-model.elbo(llk, kl).mean()).backward()
  assert any(float(p["vae"][k].grad.abs().sum()) > 0 for k in reg)
  shifted = {k: dict(v) for k, v in params.items()}
  shifted["vae"]["regressor.diag_loc_true"] = \
      params["vae"]["regressor.diag_loc_true"] + 1.0
  ones = torch.ones_like(mask)
  kls = []
  for labels in (y, y.flip(-1)):
    noise = Noise(torch.Generator().manual_seed(0))
    _, k, _ = model.elbo_components(shifted, (x, labels, ones), noise, 0)
    kls.append(k["kl_denotations"])
  assert not torch.allclose(*kls)


@pytest.mark.parametrize("name", ["reparamsM3VAE", "M2VAE",
                                  "auxiliaryVAE"])
def test_encode_and_decode_serve(name):
  model = _model(name)
  x = _batch(name)[0]
  qz = model.encode(x)
  width = model.zdim + (model.n_classes if name == "reparamsM3VAE" else 0)
  assert tuple(qz.event_shape) == (width,)
  assert model.decode(qz.mean()).mean().shape == x.shape
  _, px = model.reconstruct(x)
  assert px.mean().shape == x.shape


@pytest.mark.parametrize("name", ["SemiFactorVAE", "SemiFactor2VAE"])
def test_semi_factor_puts_its_elbo_on_the_labelled_half(name):
  """The ELBO step takes the first half of the batch, which a
  semi-supervised pipeline fills with the labelled rows; the
  discriminator's step (with the supervised term) takes the second."""
  from odin_tpu_torch.bay.vi.autoencoder.factor_vae import _split_half
  x, y, mask = _batch(name)
  first, second = _split_half((x, y, mask))
  assert torch.equal(first[2], torch.ones(len(x) // 2))
  assert torch.equal(second[2], torch.zeros(len(x) // 2))
  model = _model(name)
  _, (metrics, _) = model._disc_half_loss(
      model.state.params, (x, y, mask), Noise(
          torch.Generator().manual_seed(0)), 0, dict(model.state.mutables))
  # the second half's labels are zeros, so its supervised term is 0
  assert float(metrics["supv_loss"]) == 0.0
  _, (metrics, _) = model.dtc_loss(
      model.state.params, first, Noise(torch.Generator().manual_seed(0)), 0,
      dict(model.state.mutables))
  assert float(metrics["supv_loss"]) > 0.0


def test_m3s_joint_posteriors_concatenate():
  """The Gym concatenates each batch's q([z, z_c]|x), an Independent
  Normal: the concatenation of two halves is the whole batch's."""
  from odin_tpu_torch.bay.helpers import concat_distributions
  model = _model("reparamsM3VAE")
  x = _batch("reparamsM3VAE")[0]
  whole = model.encode(x)
  parts = concat_distributions([model.encode(x[:3]), model.encode(x[3:])])
  assert type(parts) is type(whole)
  assert torch.allclose(parts.mean(), whole.mean(), atol=1e-6)
  assert torch.allclose(parts.stddev(), whole.stddev(), atol=1e-6)


def test_adgm_reconstruct_is_the_cores_posterior_path():
  """The JAX package's ``auxiliaryVAE.reconstruct`` calls its core's
  encode without a and y, which its shapes refuse; the port's follows the
  core's ``__call__`` (a and y at their posterior means)."""
  jvae, vae = semi_pair("auxiliaryVAE")
  x = binary_images(8, 4)
  px, qz = jvae.core.apply({"params": jvae.state.params["vae"]},
                           jnp.asarray(x))
  qz_port, px_port = vae.reconstruct(x)
  np.testing.assert_allclose(qz_port.mean().numpy(), np.asarray(qz.mean()),
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(px_port.mean().numpy(), np.asarray(px.mean()),
                             rtol=1e-5, atol=1e-6)
  with pytest.raises(Exception):
    jvae.reconstruct(x)
