"""The port's ``backend`` rest (``maths``, ``losses``, ``alias``,
``keras_helpers``, the package's names) against the JAX package's on the
CPU.

Tolerance: the maths and losses within 1e-6 (absolute, and relative to
each value for the ones that reach hundreds), on inputs made with numpy
from a seed.  The parsers accept the same names as the JAX package's and
resolve them to the port's objects.
"""
import inspect
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.backend as jax_backend
from odin_tpu.backend import alias as jax_alias
from odin_tpu.backend import keras_helpers as jax_keras
from odin_tpu.backend import losses as jax_losses
from odin_tpu.backend import maths as jax_maths
import odin_tpu_torch.backend as backend
from odin_tpu_torch.backend import alias, keras_helpers, losses, maths

TOL = 1e-6
RS = np.random.RandomState(7)
X = RS.randn(6, 5).astype(np.float32)
POS = (RS.rand(6, 5).astype(np.float32) + 0.05)
COUNTS = RS.poisson(3.0, (6, 5)).astype(np.float32)
A = RS.randn(40, 4).astype(np.float32)
COV = (A.T @ A / 40 + 0.1 * np.eye(4)).astype(np.float32)
MASK = (RS.rand(6, 5) > 0.3).astype(np.float32)


def _close(got, want, tol=TOL):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                             atol=tol)


def _cpu(x):
  return torch.from_numpy(np.ascontiguousarray(x))


MATHS_CASES = {
    "softplus_inverse": ((POS,), {}),
    "length_norm": ((X,), {}),
    "length_norm_ord1": ((X,), {"ord": 1, "axis": 0}),
    "log_norm": ((COUNTS,), {}),
    "whitening": ((A,), {}),
    "whitening_given": ((A,), {"mean": A.mean(0, keepdims=True),
                               "cov": COV}),
    "logsumexp_mean": ((X,), {}),
    "logsumexp_mean_axis1": ((X,), {"axis": 1}),
    "to_llh": ((POS,), {}),
    "to_llr": ((X,), {}),
    "renorm_rms": ((X,), {}),
    "renorm_rms_target": ((X,), {"axis": 0, "target_rms": 2.5}),
    "poincare_normalize": ((X,), {}),
    "l2_normalize": ((X,), {}),
    "l2_normalize_axis": ((X,), {"axis": 1}),
    "calc_white_mat": ((COV,), {}),
    "reduce_logexp": ((X * 30,), {}),
    "reduce_logexp_axis": ((X * 30,), {"axis": 1}),
    "apply_mask": ((RS.randn(6, 5, 3).astype(np.float32), MASK), {}),
    "softmin": ((X,), {}),
    "softmin_axis0": ((X,), {"axis": 0}),
}


@pytest.mark.parametrize("case", sorted(MATHS_CASES))
def test_maths_match_jax(case):
  name = case.split("_ord")[0].split("_given")[0].split("_axis")[0] \
      .split("_target")[0]
  args, kwargs = MATHS_CASES[case]
  want = getattr(jax_maths, name)(*[jnp.asarray(a) for a in args], **kwargs)
  got = getattr(maths, name)(*[_cpu(a) for a in args], **kwargs)
  assert got.device.type == "cpu"
  assert tuple(got.shape) == tuple(want.shape)
  _close(got, want, 1e-5 if name in ("whitening", "calc_white_mat") else TOL)


def test_maths_to_sample_weights_and_masks():
  idx = RS.randint(0, 4, 10)
  w = RS.rand(4).astype(np.float32)
  _close(maths.to_sample_weights(_cpu(idx), _cpu(w)),
         jax_maths.to_sample_weights(idx, w))
  onehot = np.eye(4, dtype=np.float32)[idx]
  _close(maths.to_sample_weights(_cpu(onehot), w),
         jax_maths.to_sample_weights(onehot, w))
  for shape in ((4, 4), (2, 3, 5)):
    np.testing.assert_array_equal(maths.tril_mask(shape, device="cpu"),
                                  np.asarray(jax_maths.tril_mask(shape)))


@pytest.mark.parametrize("method", ["nn", "repeat", "pad_margin"])
def test_maths_upsample(method):
  x = RS.randn(2, 3, 4).astype(np.float32)
  for scale, axes in ((2, 1), ((2, 3), (1, 2)), (3, -1)):
    want = jax_maths.upsample(jnp.asarray(x), scale, axes, method)
    got = maths.upsample(_cpu(x), scale, axes, method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  with pytest.raises(ValueError):
    maths.upsample(_cpu(x), 2, 1, "bilinear")


def test_maths_array_inputs_go_to_the_card():
  if torch.cuda.is_available():
    assert maths.softmin(X).device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      maths.softmin(X)
  assert maths.softmin(X, device="cpu").device.type == "cpu"


# -- losses ---------------------------------------------------------------
Y01 = RS.randint(0, 2, 6).astype(np.float32)
DIST = np.abs(RS.randn(6)).astype(np.float32)
PROBS = RS.dirichlet(np.ones(3), 8).astype(np.float32)
LABELS = RS.randint(0, 3, 8)
HIDDEN = (1 / (1 + np.exp(-RS.randn(8, 5)))).astype(np.float32)
KERNEL = RS.randn(4, 5).astype(np.float32)  # flax layout (n_in, n_hidden)

LOSS_CASES = {
    "contrastive_loss": ((Y01, DIST), {}),
    "contrastive_loss_margin": ((Y01, DIST), {"margin": 0.5}),
    "triplet_loss": ((X, X[::-1], X * 0.5), {}),
    "cosine_similarity": ((X, X[:4] + 0.1), {}),
    "cosine_similarity_pairs": ((X, X[::-1]), {"one_vs_all": False}),
    "cosine_similarity_raw": ((X, X[:3]), {"unit_norm": False}),
    "bayes_crossentropy": ((np.eye(3, dtype=np.float32)[LABELS], PROBS),
                           {}),
    "bayes_crossentropy_ints": ((LABELS, PROBS), {"nb_classes": 3}),
    "bayes_crossentropy_binary": ((Y01.astype(np.int64), POS[:, 0]),
                                  {"nb_classes": 2}),
    "bayes_binary_crossentropy": ((Y01, POS[:, 0]), {}),
    "jacobian_regularize": ((HIDDEN, KERNEL), {}),
    "correntropy_regularize": ((X,), {}),
    "correntropy_regularize_sigma": ((X,), {"sigma": 0.3}),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(case):
  name = next(n for n in losses.__all__ if case.startswith(n) and (
      case == n or case[len(n)] == "_" and case[len(n) + 1:] in (
          "margin", "pairs", "raw", "ints", "binary", "sigma")))
  args, kwargs = LOSS_CASES[case]
  want = getattr(jax_losses, name)(*[jnp.asarray(a) for a in args], **kwargs)
  got = getattr(losses, name)(*[_cpu(a) for a in args], **kwargs)
  assert tuple(got.shape) == tuple(want.shape)
  _close(got, want)


def test_jacobian_regularize_layouts():
  """JAX's (n_in, n_hidden) kernel; a torch Linear's weight is its
  transpose, so the port takes ``weight.T``."""
  linear = torch.nn.Linear(4, 5)
  with torch.no_grad():
    linear.weight.copy_(_cpu(KERNEL.T))
  want = jax_losses.jacobian_regularize(HIDDEN, KERNEL)
  _close(losses.jacobian_regularize(_cpu(HIDDEN), linear.weight.T), want)
  _close(losses.jacobian_regularize(_cpu(HIDDEN), _cpu(KERNEL)), want)
  with pytest.raises(RuntimeError):  # the (out, in) weight does not fit
    losses.jacobian_regularize(_cpu(HIDDEN), linear.weight)


def test_bayes_crossentropy_needs_classes():
  with pytest.raises(ValueError, match="nb_classes"):
    losses.bayes_crossentropy(_cpu(LABELS), _cpu(PROBS))


# -- alias ----------------------------------------------------------------
def _accepted(parse, names):
  out = set()
  for n in names:
    try:
      parse(n)
      out.add(n)
    except ValueError:
      pass
  return out


def test_alias_all_equals_jax():
  assert alias.__all__ == jax_alias.__all__


@pytest.mark.parametrize("parser,names", [
    ("parse_activation", ["relu", "relu+tanh", "swish", "softplus1",
                          "gelu", "linear", "nope", "relu+nope"]),
    ("parse_initializer", ["zeros", "ones", "glorot_uniform",
                           "GlorotNormal", "xavier_uniform", "he_normal",
                           "kaiming_uniform", "lecun_normal",
                           "lecun_uniform", "orthogonal", "normal",
                           "random_normal", "truncated_normal", "uniform",
                           "random_uniform", "nope"]),
    ("parse_regularizer", ["l1", "l2", "l1l2", "l1_l2", "l3"]),
    ("parse_constraint", ["nonneg", "non_negative", "unitnorm",
                          "max_norm", "minmax"]),
    ("parse_reduction", ["min", "max", "avg", "mean", "sum", "stat",
                         "none", "", "median"]),
    ("parse_attention", ["attention", "self", "self_attention", "global",
                         "local", "localpredictive", "multihead",
                         "multi_head_attention", "cross"]),
    ("parse_normalizer", ["batchnorm", "batch_normalization", "layernorm",
                          "groupnorm", "rmsnorm", "instancenorm"]),
    ("parse_loss", ["mse", "mae", "huber", "categorical_crossentropy",
                    "sparse_categorical_crossentropy",
                    "binary_crossentropy", "cosine_similarity",
                    "contrastive", "triplet", "nope"] +
     list(jax_losses.__all__)),
    ("parse_metric", ["acc", "accuracy", "nope", "compute_EER"] +
     list(jax_backend.metrics.__all__)),
])
def test_parsers_accept_jax_names(parser, names):
  assert _accepted(getattr(alias, parser), names) == _accepted(
      getattr(jax_alias, parser), names)


def test_parse_layer_names():
  """Every network class of the JAX package resolves to the port's class
  of that name (the port's networks have six more classes, which the same
  rule accepts)."""
  import odin_tpu.networks as jax_nets
  import odin_tpu_torch.networks as nets
  names = [n for n in dir(jax_nets) if inspect.isclass(getattr(jax_nets, n))]
  for name in names + [n.lower() for n in names]:
    assert alias.parse_layer(name) is getattr(nets, jax_alias.parse_layer(
        name).__name__)
  with pytest.raises(ValueError):
    alias.parse_layer("nope")


def test_parsers_resolve_to_the_ports_objects():
  from odin_tpu_torch.networks import attention as att
  from odin_tpu_torch.networks.base import BatchNorm
  from odin_tpu_torch.training.core import Optimizer
  x = RS.randn(5, 4).astype(np.float32)
  _close(alias.parse_activation("relu+tanh")(_cpu(x)),
         jax_alias.parse_activation("relu+tanh")(x))
  assert alias.parse_activation(None)(3.0) == 3.0
  assert alias.parse_attention("self") is att.SelfAttention
  assert alias.parse_normalizer("batchnorm") is BatchNorm
  assert alias.parse_normalizer("layer_norm") is torch.nn.LayerNorm
  opt = alias.parse_optimizer("adam")(1e-3)
  assert isinstance(opt, Optimizer)
  for name in ("min", "max", "mean", "sum", "stat"):
    for axis in ((1,) if name == "stat" else (None, 1)):  # stat: 1-d parts
      _close(alias.parse_reduction(name)(_cpu(x), axis=axis),
             jax_alias.parse_reduction(name)(x, axis=axis))
    _close(alias.parse_reduction(name)(_cpu(x), axis=0, keepdims=True),
           jax_alias.parse_reduction(name)(x, axis=0, keepdims=True))
  tree = {"a": _cpu(x), "b": [_cpu(x[:2])]}
  jtree = {"a": x, "b": [x[:2]]}
  for name in ("l1", "l2", "l1l2"):
    _close(alias.parse_regularizer(name)(tree),
           jax_alias.parse_regularizer(name)(jtree), 1e-5)
  for name in ("nonneg", "unitnorm", "maxnorm"):
    _close(alias.parse_constraint(name)(_cpu(x)),
           jax_alias.parse_constraint(name)(x))
  y = RS.rand(5, 4).astype(np.float32)
  for name in ("mse", "mae", "huber", "categorical_crossentropy",
               "binary_crossentropy"):
    _close(alias.parse_loss(name)(_cpu(y), _cpu(x * 3)),
           jax_alias.parse_loss(name)(y, x * 3))
  labels = RS.randint(0, 4, 5)
  _close(alias.parse_loss("sparse_categorical_crossentropy")(
      _cpu(labels), _cpu(x)),
      jax_alias.parse_loss("sparse_categorical_crossentropy")(labels, x))
  assert alias.parse_loss("triplet") is losses.triplet_loss
  assert alias.parse_metric("accuracy")(labels, x) == pytest.approx(
      jax_alias.parse_metric("accuracy")(labels, x))
  assert alias.parse_metric("det_curve") is backend.metrics.det_curve


@pytest.mark.parametrize("name,std", [
    ("glorot_uniform", lambda fi, fo: np.sqrt(2.0 / (fi + fo))),
    ("glorot_normal", lambda fi, fo: np.sqrt(2.0 / (fi + fo))),
    ("he_uniform", lambda fi, fo: np.sqrt(2.0 / fi)),
    ("he_normal", lambda fi, fo: np.sqrt(2.0 / fi)),
    ("lecun_uniform", lambda fi, fo: np.sqrt(1.0 / fi)),
    ("lecun_normal", lambda fi, fo: np.sqrt(1.0 / fi)),
    ("normal", lambda fi, fo: 0.05),
])
def test_initializers_draw_flax_variances(name, std):
  """The port's in-place initializers in torch's (out, in) layout and
  JAX's on the (in, out) shape: the same variance (within 5 % on 64k
  draws) and range."""
  w = torch.empty(256, 256)
  alias.parse_initializer(name)(w, torch.Generator().manual_seed(0))
  jw = np.asarray(jax_alias.parse_initializer(name)(
      jax.random.PRNGKey(0), (256, 256), jnp.float32))
  for sample in (w.numpy(), jw):
    assert abs(sample.std() / std(256, 256) - 1) < 0.05
  assert abs(np.abs(w.numpy()).max() / np.abs(jw).max() - 1) < 0.1


def test_initializers_fixed_values():
  for name, check in (("zeros", 0.0), ("ones", 1.0)):
    w = alias.parse_initializer(name)(torch.empty(3, 4))
    assert torch.all(w == check)
  w = alias.parse_initializer("uniform")(torch.empty(100, 100),
                                         torch.Generator().manual_seed(0))
  assert 0 <= float(w.min()) and float(w.max()) < 0.05
  w = alias.parse_initializer("truncated_normal")(
      torch.empty(100, 100), torch.Generator().manual_seed(0))
  assert float(w.abs().max()) <= 0.1
  w = alias.parse_initializer("orthogonal")(torch.empty(8, 8),
                                            torch.Generator().manual_seed(0))
  _close(w @ w.T, np.eye(8), 1e-5)


# -- keras_helpers and the package ----------------------------------------
def test_count_params_and_layer2text():
  from odin_tpu_torch.bay.vi import BetaVAE
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.weights import to_jax_params
  assert keras_helpers.__all__ == jax_keras.__all__
  vae = BetaVAE(**get_networks("dsprites", zdim=10)).build(seed=1,
                                                           device="cpu")
  n = jax_keras.count_params(to_jax_params(vae.core))
  assert keras_helpers.count_params(vae.core) == n
  assert keras_helpers.count_params(vae) == n
  assert keras_helpers.count_params(dict(vae.core.named_parameters())) == n
  text = keras_helpers.layer2text(vae.core.encoder,
                                  torch.zeros(2, 64, 64, 1))
  assert text.splitlines()[-1] == \
      f"total parameters: {keras_helpers.count_params(vae.core.encoder):,}"
  assert "-> (2, " in text and "Conv" in text
  flat = keras_helpers.layer2text(vae)
  assert flat.splitlines()[-1] == f"total parameters: {n:,}"
  assert "vae/encoder.layers.1.weight" in flat


def test_backend_names_equal_jax():
  """``odin_tpu_torch.backend`` offers the JAX package's public names (its
  submodules aside) and the maths, losses and alias modules their
  ``__all__``."""
  public = lambda m: {n for n in dir(m) if not n.startswith("_") and
                      not isinstance(getattr(m, n), types.ModuleType)}
  assert public(backend) == public(jax_backend)
  assert maths.__all__ == jax_maths.__all__
  assert losses.__all__ == jax_losses.__all__
