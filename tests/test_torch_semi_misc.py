"""The semi-supervised surface of the port outside the classes' objectives:
``masked_mean_llk`` (0, not NaN, on a batch with no labelled row), the
registry, the semi-supervised heads of ``get_networks``, a labels head on
``VariationalAutoencoder``, ``_split_inputs``'s mask, the helpers of
``SemiSupervisedVAE``, and ``HalfMoons`` against the JAX package's and
scikit-learn's ``make_moons``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.bay.vi.autoencoder.multitask_vae import (
    masked_mean_llk as jax_masked_mean_llk,
)
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi import masked_mean_llk
from torch_semi_common import SEMI
from torch_zoo_common import tiny_networks


@pytest.mark.parametrize("n_labelled", [0, 1, 5, 8])
def test_masked_mean_llk_matches_jax(n_labelled):
  rs = np.random.RandomState(n_labelled)
  llk = rs.randn(8).astype(np.float32) * 100
  mask = np.zeros(8, np.float32)
  mask[rs.permutation(8)[:n_labelled]] = 1
  got = masked_mean_llk(torch.from_numpy(llk), torch.from_numpy(mask))
  want = np.asarray(jax_masked_mean_llk(jnp.asarray(llk), jnp.asarray(mask)))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
  if n_labelled == 0:  # no labelled row: 0, not NaN
    assert torch.equal(got, torch.zeros(8))
  else:
    np.testing.assert_allclose(float(got.mean()),
                               llk[mask == 1].mean(), rtol=1e-5)
  assert torch.equal(masked_mean_llk(torch.from_numpy(llk), None),
                     torch.from_numpy(llk))


def test_a_batch_with_no_labelled_row_trains_without_nan():
  """A step on an (x, y, mask) batch whose mask is all zeros: the labels
  term is 0, the loss finite, no update skipped."""
  from torch_semi_common import semi_batch, semi_networks
  vae = port_vi.MultitaskVAE(**semi_networks("MultitaskVAE", "torch")).build(
      device="cpu")
  x, y, mask = semi_batch("MultitaskVAE", 3, n_labelled=0)
  s, m = vae.make_step_fn()(vae.state, tuple(
      torch.from_numpy(a) for a in (x, y, mask)))
  assert float(m["llk_labels"]) == 0.0
  assert np.isfinite(float(m["loss"]))
  assert int(s.skipped_updates) == 0


@pytest.mark.parametrize("name", SEMI)
def test_get_vae_resolves_the_family(name):
  cls = port_vi.get_vae(name)
  assert cls.__name__ == name and cls is getattr(port_vi, name)
  assert cls in port_vi.get_all_vae()
  assert cls.is_semi_supervised()
  assert cls.is_semi_supervised() == getattr(jax_vi, name).is_semi_supervised()
  assert port_vi.get_vae(name.lower()) is cls


def test_the_other_families_still_wait():
  """The families that waited for a later slice are ported: each of their
  names resolves to the port's class of the JAX package's name."""
  assert port_vi.AuxiliaryVAE is port_vi.auxiliaryVAE
  assert not port_vi.BetaVAE.is_semi_supervised()
  for name, cls in (("sequentialvae", "SequentialVAE"),
                    ("variationalrnn", "VariationalRNN"),
                    ("cycleconsistentvae", "CycleConsistentVAE"),
                    ("moevae", "MoeVAE"), ("alda", "ALDA")):
    assert port_vi.get_vae(name) is getattr(port_vi, cls)
  assert port_vi.auxiliaryLDA.is_semi_supervised()


def _rv_fields(rv):
  return (tuple(rv.event_shape), rv.posterior, rv.projection, rv.name)


def test_semi_supervised_heads_match_jax():
  from odin_tpu.networks.image_networks import get_networks as jax_nets
  from odin_tpu_torch.networks import get_networks
  for name in ("dsprites", "halfmoons"):
    got = get_networks(name, zdim=10, is_semi_supervised=True)
    want = jax_nets(name, zdim=10, is_semi_supervised=True)
    for key in ("latents", "observation", "labels"):
      if isinstance(got[key], RVconf):  # dSprites' observation is a head
        assert _rv_fields(got[key]) == _rv_fields(want[key]), (name, key)
    assert tuple(got["input_shape"]) == tuple(want["input_shape"])
  assert "labels" not in get_networks("dsprites")
  assert "labels" not in get_networks("halfmoons")
  from odin_tpu_torch.networks import SpaceToDepthConv
  encoder = get_networks("dsprites", space_to_depth=True)["encoder"]
  assert isinstance(encoder.layers[1], SpaceToDepthConv)


@pytest.mark.parametrize("skip_decoder", [True, False])
def test_a_vae_with_a_labels_head(skip_decoder):
  """``VariationalAutoencoder(labels=...)`` builds its head on the latents,
  or on the decoder's hidden state for a model with ``skip_decoder`` off,
  as the JAX package's core attaches it."""

  class Model(port_vi.VAE):
    pass

  Model.skip_decoder = skip_decoder
  nets = tiny_networks("torch")
  vae = Model(labels=RVconf(3, "onehot", name="digits"), **nets).build(
      device="cpu")
  head = vae.core.labels
  assert head.name == "labels" and vae.labels_conf.name == "digits"
  assert vae.core.labels_input == ("latents" if skip_decoder
                                   else "decoder_hidden")
  width = 4 if skip_decoder else 64  # zdim, or the decoder's 8x8x1 params
  assert tuple(head.projection.weight.shape) == (3, width)
  assert "labels.projection.weight" in vae.state.params["vae"]


def test_split_inputs_hands_out_the_mask():
  split = port_vi.VAE._split_inputs
  x, y, m = torch.ones(2, 3), torch.zeros(2, 4), torch.ones(2)
  assert split((x, y, m), mask=True) == (x, y, m)
  assert split((x, y), mask=True) == (x, y, None)
  assert split((x, y, m)) == (x, y)
  assert split(x, mask=True) == (x, None, None)
  got = split(dict(inputs=x, labels=y, mask=m), mask=True)
  assert got[0] is x and got[1] is y and got[2] is m


def test_semi_supervised_vae_helpers_match_jax():
  rs = np.random.RandomState(0)
  terms = {"a": rs.randn(4).astype(np.float32),
           "b": rs.randn(4).astype(np.float32)}
  from odin_tpu.bay.vi.autoencoder.variational_autoencoder import (
      SemiSupervisedVAE as JSSV)
  from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
      SemiSupervisedVAE as SSV)
  assert SSV.is_semi_supervised()
  for empty in (True, False):
    got = SSV.ignore_empty(torch.tensor(empty), {
        k: torch.from_numpy(v) for k, v in terms.items()})
    want = JSSV.ignore_empty(jnp.asarray(empty), terms)
    for k in terms:
      np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
  t = {k: torch.from_numpy(v) for k, v in terms.items()}
  got = SSV.merge_objectives(t, t, t, t)
  want = JSSV.merge_objectives(terms, terms, terms, terms)
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for k in w:
      np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-6)


def test_halfmoons_matches_jax_and_scikit_learn():
  sklearn = pytest.importorskip("sklearn.datasets")
  from odin_tpu.fuel.image_data.datasets import HalfMoons as JaxHalfMoons
  from odin_tpu_torch.fuel import HalfMoons, get_dataset
  from odin_tpu_torch.fuel.image_data import make_moons
  for n, noise, seed in ((3200, 0.05, 1), (7, None, 3), (101, 0.2, 0),
                         (10, 0.1, np.random.RandomState(5))):
    state = seed.get_state() if isinstance(seed, np.random.RandomState) \
        else None
    want = sklearn.make_moons(n_samples=n, noise=noise, random_state=seed)
    if state is not None:
      seed.set_state(state)
    got = make_moons(n_samples=n, noise=noise, random_state=seed)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g, w)
  ds, jds = get_dataset("halfmoons"), JaxHalfMoons()
  assert isinstance(ds, HalfMoons) and ds.labels == jds.labels
  for part in ("train", "valid", "test"):
    for g, w in zip(ds.numpy(part), jds.numpy(part)):
      np.testing.assert_array_equal(g, w)
  batch = next(iter(ds.create_dataset("train", batch_size=8,
                                      label_percent=0.1)))
  jbatch = next(iter(jds.create_dataset("train", batch_size=8,
                                        label_percent=0.1)))
  for g, w in zip(batch, jbatch):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
