"""The port's VAE zoo against the JAX package on the CPU, and its
registry.

Every ported class is held to its JAX counterpart, both on the same
params (tests/torch_zoo_common.py: the 8x8 networks of
tests/test_zoo_execution.py, B = 8) and JAX's draws injected: the ELBO
terms and the loss at steps 0 and 700 (the schedules move with the step)
within rtol 1e-5, each term relative to its largest magnitude over the
batch; then one full training step, every TrainStep, its metrics at rtol
1e-5, its params by the rule of tests/torch_training_common.py
(``assert_params_close``), its mutables and optimizer counts.  This file
holds the registry, the plain autoencoder and the information
objectives; the other classes are in tests/test_torch_zoo_*.py and
tests/test_torch_vqvae.py.
"""
import pytest
import torch

import odin_tpu.bay.vi.autoencoder as jax_zoo
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu_torch.bay.vi import autoencoder as port_zoo
from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax, tiny_networks)

torch.set_num_threads(2)

CLASSES = {
    "Autoencoder": {},
    "InfoVAE": dict(n_prior_samples=16, lamda=50.0),
    "MIVAE": dict(code_dim=2, mi_coef=0.5),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  pair = make_pair(case.split("-")[0], **CLASSES[case])
  elbo_matches_jax(pair, binary_images(B, 60))
  step_matches_jax(pair, binary_images(B, 61))


# the classes this port carries, by the JAX package's registered names
PORTED = sorted([
    "variationalautoencoder", "vae", "autoencoder", "betavae", "beta10vae",
    "betagammavae", "gamma10vae", "annealingvae", "betatcvae",
    "betacapacityvae", "factorvae", "factor2vae", "dipvae", "infovae",
    "mivae", "irmvae", "irmae", "hypersphericalvae", "powersphericalvae",
    "twostagevae", "vampriorvae", "vqvae", "stochasticvae", "imputevae",
    "distencoder", "semifactorvae", "semifactor2vae", "multitaskvae",
    "skiptaskvae", "multiheadvae", "m2vae", "conditionalm2vae",
    "structuredsemivae", "reparamsm3vae", "auxiliaryvae", "semafovae",
    "remafovae", "semafod", "semafoh", "semafos", "semafosm", "semafosc",
    "semafop", "semafot", "hierarchicalvae", "laddervae", "unetvae",
    "punetvae", "verydeepvae", "groupvae", "multilevelvae", "adaptivevae",
    "weaklysupervisedvae", "amortizedlda", "nonlinearlda", "auxiliarylda",
    "alda", "variationalrnn", "sequentialvae", "sequentialattentionvae",
    "cycleconsistentvae", "moevae"])
# the names that waited for a later slice before the last nine classes
FORMERLY_WAITING = sorted([
    "sequentialvae", "sequentialattentionvae", "variationalrnn",
    "cycleconsistentvae", "moevae", "alda", "amortizedlda", "auxiliarylda",
    "nonlinearlda"])


def test_every_ported_name_resolves_to_its_class():
  zoo = jax_zoo._zoo()
  for name in PORTED:
    cls = port_vi.get_vae(name)
    assert cls.__name__ == zoo[name].__name__
    assert port_vi.get_vae(cls) is cls
    assert port_vi.get_vae(name.upper()) is cls
  assert port_vi.get_vae("beta") is port_vi.BetaVAE  # 'vae' may be left off
  assert port_vi.get_vae("factor") is port_vi.FactorVAE
  assert port_vi.get_vae("two_stage") is port_vi.TwoStageVAE
  # 'vae' and 'laddervae' are aliases of VariationalAutoencoder and
  # HierarchicalVAE: 60 classes, the JAX package's
  assert {c.__name__.lower() for c in port_vi.get_all_vae()} == \
      set(PORTED) - {"vae", "laddervae"}
  assert len(port_vi.get_all_vae()) == 60
  assert [c.__name__ for c in port_vi.get_all_vae()] == \
      [c.__name__ for c in jax_zoo.get_all_vae()]
  assert set(PORTED) == set(jax_zoo._zoo())


@pytest.mark.parametrize("name", FORMERLY_WAITING)
def test_each_unported_jax_name_raises_not_implemented(name):
  """No JAX name is unported any more: each name that raised resolves to
  the class of the JAX package's name, and none waits."""
  assert not port_zoo._WAITING
  assert port_vi.get_vae(name).__name__ == jax_zoo._zoo()[name].__name__


def test_unknown_names_raise_value_error():
  with pytest.raises(ValueError, match="cannot find VAE"):
    port_vi.get_vae("nosuchvae")


@pytest.mark.parametrize("cls", ["SemiFactorVAE", "SemiFactor2VAE"])
def test_semi_factor_classes_raise_naming_the_roadmap(cls):
  """Ported with the semi-supervised family: the registry names no ROADMAP
  item for them any more, and they build with the discriminator's label
  outputs."""
  assert cls.lower() not in port_zoo._WAITING
  vae = getattr(port_zoo, cls)(n_labels=3, discriminator_units=(8,),
                               **tiny_networks("torch")).build(device="cpu")
  assert vae.discriminator.n_outputs == 4


def test_train_params_is_an_error_only_with_several_steps():
  """JAX's rule: a path override needs a model of one TrainStep."""
  _, vae = make_pair("DIPVAE")
  step = vae.make_step_fn(train_params=("vae/decoder",))
  s, _ = step(vae.state, binary_images(B, 2))
  for k, v in s.params["vae"].items():
    moved = not torch.equal(v, vae.state.params["vae"][k])
    assert moved == k.startswith("decoder."), k
  _, two = make_pair("TwoStageVAE", stage2_units=8)
  with pytest.raises(ValueError, match="single-TrainStep.*stage1.*stage2"):
    two.make_step_fn(train_params=("vae/decoder",))
