"""``remat`` as a policy (``training.core.remat_policy``) on the CPU, on the
8x8 beta-VAE of tests/torch_zoo_common.py.

Each of JAX's ``jax.checkpoint_policies`` names that the port takes, and
``True``, gives the plain step's loss, gradients and params bit for bit
(the forward recomputed on the same inputs and the same noise), with the
noise injected and drawn from the generator; and one step matches the JAX
package's step built with the same ``remat`` (its noise replayed from its
key, params by ``assert_params_close``).  A torch
selective-checkpoint policy is taken as it is, and sees the step's
matmuls and convolutions; another name or type raises ``ValueError`` as
tests/test_support.py's ``test_remat_policy_validation`` requires of JAX.
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import jax

from odin_tpu_torch.training.core import build_train_step_fn, remat_policy
from torch_training_common import assert_params_close
from torch_zoo_common import binary_images, make_pair, np_tree, port_tree

torch.set_num_threads(2)

POLICIES = ["everything_saveable", "nothing_saveable", "dots_saveable",
            "checkpoint_dots", "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims"]
B = 8


@pytest.fixture(scope="module")
def pair():
  return make_pair("BetaVAE", beta=2.0)


def _step_outputs(vae, remat, x, eps=None, seed=None):
  start = vae.state
  step = vae.make_step_fn(learning_rate=1e-3, remat=remat)
  state = vae.state if seed is None else vae.state.replace(
      rng=torch.Generator().manual_seed(seed))
  loss, _, g = step.value_and_grad(state, x, eps=eps)
  if seed is not None:
    state = state.replace(rng=torch.Generator().manual_seed(seed))
  s, m = step(state, x, eps=eps)
  vae.state = start
  return float(loss), np_tree(g)["vae"], np_tree(s.params)["vae"], m


@pytest.mark.parametrize("remat", POLICIES + [True])
def test_policy_equals_plain_step(pair, remat):
  _, vae = pair
  x = binary_images(B, 11)
  eps = torch.from_numpy(np.random.RandomState(4).randn(B, 4).astype("f"))
  for kwargs in (dict(eps=eps), dict(seed=9)):
    want = _step_outputs(vae, False, x, **kwargs)
    got = _step_outputs(vae, remat, x, **kwargs)
    assert got[0] == want[0]
    for k in want[1]:
      np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
      np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)
    assert {k: float(v) for k, v in got[3].items()} == \
        {k: float(v) for k, v in want[3].items()}


@pytest.mark.parametrize("remat", POLICIES + [True])
def test_policy_matches_jax(pair, remat):
  """One step of each package under the same `remat`, JAX's noise replayed
  from its key (a draw recorded inside ``jax.checkpoint`` would leak its
  tracer): the step splits the state's key and the loss draws
  ``normal(split(step_rng)[1], (B, zdim))``."""
  jvae, vae = pair
  start = (jvae.state, vae.state)
  x = binary_images(B, 12)
  jstep = jax.jit(jvae.make_step_fn(learning_rate=1e-3, jit=False,
                                    remat=remat))
  js, jm = jax.device_get(jstep(jvae.state, x))
  step_rng = jax.random.split(start[0].rng)[1]
  eps = np.array(jax.random.normal(jax.random.split(step_rng)[1], (B, 4)))
  s, m = vae.make_step_fn(learning_rate=1e-3, remat=remat)(
      vae.state, x, eps=torch.from_numpy(eps))
  jvae.state, vae.state = start
  assert set(m) == set(jm)
  for k in jm:
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                               atol=1e-6, err_msg=k)
  assert_params_close(np_tree(s.params)["vae"], port_tree(js.params)["vae"],
                      1)


def test_dots_policies_save_the_products(pair):
  """What the policies keep: every op for 'everything_saveable', none for
  'nothing_saveable' (the plain recompute), the matmuls and convolutions
  for 'dots_saveable', the 2-D matmuls alone for the no-batch-dims
  names; a callable passes through."""
  _, vae = pair
  seen = []

  def spy(ctx, op, *args, **kwargs):
    if not ctx.is_recompute:
      seen.append(op.overloadpacket)
    return CheckpointPolicy.PREFER_RECOMPUTE

  assert remat_policy(spy) is spy
  _step_outputs(vae, spy, binary_images(B, 13), seed=1)
  aten = torch.ops.aten
  assert aten.convolution in seen and aten.addmm in seen
  ctx = type("Ctx", (), {"is_recompute": False})()
  saved = lambda name, op: remat_policy(name)(ctx, op) == \
      CheckpointPolicy.MUST_SAVE
  for op in (aten.convolution.default, aten.addmm.default, aten.mm.default,
             aten.bmm.default):
    assert saved("dots_saveable", op) and saved("checkpoint_dots", op)
    assert saved("everything_saveable", op)
  for name in ("dots_with_no_batch_dims_saveable",
               "checkpoint_dots_with_no_batch_dims"):
    assert saved(name, aten.mm.default) and saved(name, aten.addmm.default)
    assert not saved(name, aten.convolution.default)
    assert not saved(name, aten.bmm.default)
  for name in POLICIES[2:]:
    assert not saved(name, aten.relu.default)
    assert not saved(name, aten.add.Tensor)
  assert saved("everything_saveable", aten.relu.default)
  for off in (False, None, 0, True, "nothing_saveable"):
    assert remat_policy(off) is None


def test_policy_validation():
  with pytest.raises(ValueError, match="dots_saveable"):
    build_train_step_fn([], {}, remat="no_such_policy")
  with pytest.raises(ValueError, match="bool, str"):
    build_train_step_fn([], {}, remat=123)
  build_train_step_fn([], {}, remat=lambda ctx, op, *a, **k: True)
  build_train_step_fn([], {}, remat="dots_saveable")
