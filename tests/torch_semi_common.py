"""Shared set-up of the semi-supervised parity tests
(tests/test_torch_semi*.py): the 19 classes of the semi-supervised family
in both packages on the 8x8 networks of ``torch_zoo_common`` with a labels
head, their (x, y, mask) batches, and the JAX package's draws replayed
into the port (``torch_zoo_common.jit_with_draws``).

The labels heads: a Gaussian over 3 factors ('factors', as dSprites'
5-factor head) for the Multitask and Semafo families, a one-hot over 3
classes ('digits') for M2, M3 and ADGM, whose objective reads q(y|x)'s mean
as class probabilities (on a Gaussian head the JAX package's ``H_qy`` is
NaN), and the discriminator's label logits for the Semi-Factor pair.
"""
import numpy as np

from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax, tiny_networks)

SEMI = ["MultitaskVAE", "SkiptaskVAE", "MultiheadVAE", "M2VAE",
        "ConditionalM2VAE", "StructuredSemiVAE", "reparamsM3VAE",
        "auxiliaryVAE", "SemafoVAE", "RemafoVAE", "semafod", "semafoh",
        "semafos", "semafosm", "semafosc", "semafop", "semafot",
        "SemiFactorVAE", "SemiFactor2VAE"]
N_LABELS = 3
CATEGORICAL = ("M2VAE", "ConditionalM2VAE", "StructuredSemiVAE",
               "reparamsM3VAE", "auxiliaryVAE")


def head_of(cls: str) -> str:
  if cls.startswith("SemiFactor"):
    return "discriminator"
  return "onehot" if cls in CATEGORICAL else "gaussian"


def _rvconf(package):
  if package == "jax":
    from odin_tpu.bay.random_variable import RVconf
  else:
    from odin_tpu_torch.bay.random_variable import RVconf
  return RVconf


def class_kwargs(cls: str, package: str, n_labels: int = N_LABELS):
  """The small widths each class is built with."""
  RVconf = _rvconf(package)
  if cls.startswith("SemiFactor"):
    return dict(n_labels=n_labels, discriminator_units=(16, 16))
  if cls == "auxiliaryVAE":
    return dict(embed_dim=8, auxiliary=RVconf(4, "mvndiag", projection=True,
                                              name="auxiliary"))
  if cls in CATEGORICAL:
    return dict(classifier=(16, 16, 16, 16), embed_dim=8)
  return {}


def semi_networks(cls: str, package: str, zdim: int = 4):
  """``tiny_networks`` with the class's labels head and its small widths
  (its own arguments, in the same dict)."""
  RVconf = _rvconf(package)
  nets = tiny_networks(package, zdim=zdim)
  head = head_of(cls)
  if head == "gaussian":
    nets["labels"] = RVconf(N_LABELS, "gaussian", projection=True,
                            name="factors")
  elif head == "onehot":
    nets["labels"] = RVconf(N_LABELS, "onehot", projection=True,
                            name="digits")
  nets.update(class_kwargs(cls, package))
  return nets


def moons_networks(cls: str, package: str):
  """Both packages' ``halfmoons_networks(is_semi_supervised=True)`` (its
  one-hot head over the two moons; the Semi-Factor pair's labels are the
  discriminator's) with the class's small widths."""
  if package == "jax":
    from odin_tpu.networks.image_networks import halfmoons_networks
  else:
    from odin_tpu_torch.networks import halfmoons_networks
  nets = halfmoons_networks(is_semi_supervised=True)
  if cls.startswith("SemiFactor"):
    nets.pop("labels")
  nets.update(class_kwargs(cls, package, n_labels=2))
  return nets


def semi_pair(cls: str, seed: int = 1, moons: bool = False, **kwargs):
  """(JAX model, the port's model on the CPU) of `cls`, same params, on
  the 8x8 networks or (`moons`) the half-moons MLPs."""
  nets = moons_networks if moons else semi_networks
  return make_pair(cls, seed=seed, networks=nets(cls, "torch"),
                   jax_networks=nets(cls, "jax"), **kwargs)


def moons_batch(seed: int, n_labelled: int = B // 2):
  """An (x, y, mask) batch of B half-moons points (the first `n_labelled`
  labelled, one-hot over the 2 moons)."""
  from odin_tpu_torch.fuel import HalfMoons
  x, y = HalfMoons(n_samples=64, seed=seed).numpy("train")
  y = np.eye(2, dtype=np.float32)[y[:B].astype(int)]
  mask = np.zeros(B, np.float32)
  mask[:n_labelled] = 1
  y[n_labelled:] = 0
  return x[:B].astype(np.float32), y, mask


def matches_jax(cls: str, moons: bool):
  """`cls`'s ELBO terms (at steps 0 and 1,500: either side of the MI
  warm-up) and one full training step against the JAX package's, JAX's
  draws replayed."""
  pair = semi_pair(cls, moons=moons)
  batch = moons_batch if moons else lambda s: semi_batch(cls, s)
  elbo_matches_jax(pair, batch(10), steps=(0, 1500))
  step_matches_jax(pair, batch(20))


def semi_labels(cls: str, n: int, seed: int) -> np.ndarray:
  """Labels of `n` rows: one-hot rows for a categorical head (and the
  Semi-Factor pair), Gaussian factor values otherwise."""
  rs = np.random.RandomState(seed)
  if head_of(cls) == "gaussian":
    return rs.randn(n, N_LABELS).astype(np.float32)
  return np.eye(N_LABELS, dtype=np.float32)[rs.randint(0, N_LABELS, n)]


def semi_batch(cls: str, seed: int, n_labelled: int = B // 2):
  """An (x, y, mask) batch of B rows, the first `n_labelled` labelled and
  the others' labels zeros, as ``create_dataset(label_percent=...)``
  makes them."""
  x = binary_images(B, seed)
  y = semi_labels(cls, B, seed + 1)
  mask = np.zeros(B, np.float32)
  mask[:n_labelled] = 1
  y[n_labelled:] = 0
  return x, y, mask
