"""The port's optimizer against optax, and its schedules and param paths,
on the CPU.

The optimizer alone (Adam after optax's clip, clip_by_block_rms and
clip_by_global_norm) against optax on identical gradients for 10 steps:
1e-6 (rtol and atol), elementwise float32 arithmetic with pow and sqrt
from two libraries; the learning-rate schedules at rtol 1e-6.
"""
import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.networks import get_optimizer_info as jax_optimizer_info
from odin_tpu.training.core import make_optimizer as jax_make_optimizer
from odin_tpu_torch.networks import get_optimizer_info
from odin_tpu_torch.training import (exponential_decay, get_param_subtree,
                                     make_optimizer, merge_partitions,
                                     set_param_subtree)
from torch_training_common import jax_adam

OPT_TOL = 1e-6


CHAINS = {
    "adam": dict(),
    "clipvalue": dict(clipvalue=0.3),
    "clipnorm": dict(clipnorm=0.2),
    "global_clipnorm": dict(global_clipnorm=1.5),
    "all_clips": dict(clipvalue=0.8, clipnorm=0.5, global_clipnorm=2.0),
    "adam_options": dict(b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9),
}


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_optimizer_matches_optax(chain, schedule):
  """10 updates on the same gradients (a tree with a conv kernel, a matrix
  and a bias, of widely different scales) through the port's optimizer
  and optax's chain."""
  kwargs = CHAINS[chain]
  rs = np.random.RandomState(0)
  shapes = {"conv": (4, 4, 3, 8), "dense": (16, 5), "bias": (5,)}
  params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
  if schedule:
    lr_jax = optax.exponential_decay(1e-2, 3, 0.5, staircase=True)
    lr = exponential_decay(1e-2, 3, 0.5, staircase=True)
  else:
    lr_jax = lr = 1e-2
  jopt = jax_make_optimizer("adam", lr_jax, **kwargs)
  opt = make_optimizer("adam", lr, **kwargs)
  jstate = jopt.init({"p": params})
  tparams = {"p": {k: torch.from_numpy(v) for k, v in params.items()}}
  state = opt.init(tparams)
  for i in range(10):
    scale = {"conv": 3.0, "dense": 0.01, "bias": 0.5}
    grads = {k: (rs.randn(*s) * scale[k] * (1 + i)).astype(np.float32)
             for k, s in shapes.items()}
    jup, jstate = jopt.update({"p": grads}, jstate, {"p": params})
    up, state = opt.update(
        {"p": {k: torch.from_numpy(v) for k, v in grads.items()}}, state,
        tparams)
    for k in shapes:
      np.testing.assert_allclose(up["p"][k].numpy(), np.asarray(jup["p"][k]),
                                 rtol=OPT_TOL, atol=OPT_TOL, err_msg=k)
  adam = jax_adam(jstate)
  assert int(state["count"]) == int(adam.count) == 10
  for name in ("mu", "nu"):
    for k in shapes:
      np.testing.assert_allclose(state[name]["p"][k].numpy(),
                                 np.asarray(getattr(adam, name)["p"][k]),
                                 rtol=OPT_TOL, atol=OPT_TOL)
  assert ("lr_count" in state) == schedule


def test_optimizer_aliases_not_ported_raise():
  """Every alias of the JAX package is ported (held to optax in
  tests/test_torch_optimizers.py); a name or an option optax does not have
  raises."""
  for alias in ("adamw", "sgd", "rmsprop", "adagrad", "adamax", "lamb",
                "lion", "nadam"):
    assert make_optimizer(alias).init(
        {"p": {"w": torch.zeros(3)}}) is not None
  with pytest.raises(ValueError):
    make_optimizer("adamz")
  with pytest.raises(TypeError):
    make_optimizer("adam", momentum=0.9)
  assert make_optimizer("adam", nesterov=True).nesterov


def test_get_optimizer_info_matches_jax():
  for name in ("dsprites", "mnist", "cifar10", "shapes3dsmall", "halfmnist"):
    want, got = jax_optimizer_info(name, 64), get_optimizer_info(name, 64)
    assert got["max_iter"] == want["max_iter"]
    counts = np.array([0, 1, 9999, 10000, 25000, 4_000_000], np.int32)
    np.testing.assert_allclose(
        got["learning_rate"](torch.from_numpy(counts)).numpy(),
        np.asarray(want["learning_rate"](jnp.asarray(counts))), rtol=1e-6)
  with pytest.raises(NotImplementedError):
    get_optimizer_info("nope")


def test_param_subtrees():
  params = {"vae": {"encoder.a": torch.zeros(1), "decoder.layers.0.b":
                    torch.ones(2), "decoder.layers.1.c": torch.ones(3)}}
  dec = get_param_subtree(params, "vae/decoder")
  assert set(dec) == {"layers.0.b", "layers.1.c"}
  assert get_param_subtree(params, "vae/decoder/layers") == \
      {"0.b": dec["layers.0.b"], "1.c": dec["layers.1.c"]}
  new = set_param_subtree(params, "vae/decoder",
                          {k: v * 2 for k, v in dec.items()})
  assert list(new["vae"]) == list(params["vae"])
  assert float(new["vae"]["decoder.layers.1.c"][0]) == 2.0
  assert float(params["vae"]["decoder.layers.1.c"][0]) == 1.0
  same = merge_partitions(params, {"vae": params["vae"]})
  assert same["vae"] is params["vae"]
  with pytest.raises(KeyError):
    get_param_subtree(params, "vae/nothing")
