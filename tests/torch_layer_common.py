"""Shared helper of the layer tests (``tests/test_torch_time_delay.py``,
``tests/test_torch_util_layers.py``): a port layer built from a seed, its
parameters carried to a flax tree by the weight bridge, which must have
the paths and shapes of the JAX module's own init (``jax.eval_shape``) and
come back unchanged; then both packages apply to the same numpy inputs,
and the outputs, the inputs' gradients and every parameter's gradient
agree.

Tolerances (ROADMAP, "How a slice counts as done"): outputs within 1e-5 of
their largest magnitude, gradients within 1e-4 of each tensor's largest;
mutable collections moved in training mode within 1e-5.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from odin_tpu_torch.networks.base import collecting_updates
from odin_tpu_torch.weights import (from_jax_mutables, from_jax_params,
                                    to_jax_mutables, to_jax_params)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def leaves(tree):
  return {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
          jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, tol, msg=""):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (msg, got.shape, want.shape)
  scale = float(np.abs(want).max()) if want.size else 0.0
  np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(scale, 1e-30),
                             err_msg=msg)


def check_layer(port, jmod, inputs, build, training=False, jkw=None,
                pkw=None, grad=True):
  """`port` built by ``build(port, generator)``, against ``jmod.apply`` on
  `inputs` (numpy arrays; the float ones get gradients).  Returns the
  port's output as numpy."""
  jkw, pkw = dict(jkw or {}), dict(pkw or {})
  build(port, torch.Generator().manual_seed(0))
  jin = [jnp.asarray(a) for a in inputs]
  init = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jin,
                                          **jkw))
  params = to_jax_params(port)
  assert leaves(params) == leaves(init.get("params", {}))
  mutables = to_jax_mutables(port)
  assert leaves(mutables) == leaves(
      {k: v for k, v in init.items() if k != "params"})
  sd = port.state_dict()
  back = from_jax_params(params)
  back.update(from_jax_mutables(mutables))
  assert set(back) == set(sd)
  for k, v in back.items():
    assert torch.equal(v, sd[k]), k

  port.train(training)
  port.zero_grad(set_to_none=True)
  floats = [i for i, a in enumerate(inputs)
            if np.issubdtype(np.asarray(a).dtype, np.floating)]
  with torch.no_grad(), collecting_updates():
    out_shape = tuple(port(*[torch.from_numpy(np.asarray(a)) for a in inputs],
                           **pkw).shape)
  w_np = np.random.RandomState(7).randn(*out_shape).astype(np.float32)
  w = jnp.asarray(w_np)

  def jloss(p, *xs):
    args = list(jin)
    for i, x in zip(floats, xs):
      args[i] = x
    out = jmod.apply({"params": p, **mutables}, *args, training=training,
                     mutable=list(mutables) if training and mutables
                     else False, **jkw)
    y, upd = out if training and mutables else (out, {})
    return jnp.sum(y * w), (y, upd)

  (_, (jy, jupd)), jgrads = jax.jit(jax.value_and_grad(
      jloss, argnums=tuple(range(len(floats) + 1)), has_aux=True))(
          params, *[jin[i] for i in floats])
  tin = [torch.from_numpy(np.asarray(a).copy()) for a in inputs]
  for i in floats:
    tin[i].requires_grad_(True)
  with collecting_updates() as updates:
    y = port(*tin, **pkw)
  close(y.detach().numpy(), jy, OUT_TOL, "output")
  if not grad:
    return y.detach().numpy()
  torch.sum(y * torch.from_numpy(w_np)).backward()
  for i, jg in zip(floats, jgrads[1:]):
    close(tin[i].grad.numpy(), jg, GRAD_TOL, f"d input {i}")
  pgrads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in port.named_parameters()}
  if pgrads:
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_jax_params(port, pgrads))[0])
    for k, g in jax.tree_util.tree_flatten_with_path(jgrads[0])[0]:
      close(got[k], g, GRAD_TOL, jax.tree_util.keystr(k))
  if training and mutables:
    names = {f"{m_name}.{b}" if m_name else b: v
             for (mod, b), v in updates.items()
             for m_name, m in port.named_modules() if m is mod}
    for name, v in from_jax_mutables(jupd).items():
      close(names[name].detach().numpy(), v.numpy(), OUT_TOL, name)
  return y.detach().numpy()


def shape_build(*shapes):
  """A ``build`` for ``check_layer``: ``port.build(shape, generator)`` (a
  second shape goes in as the layer's own keyword where it takes one)."""
  def build(port, generator):
    port.build(shapes[0], generator, *shapes[1:])
  return build
