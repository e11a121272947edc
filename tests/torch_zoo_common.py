"""Shared set-up of the VAE-zoo parity tests (tests/test_torch_zoo*.py,
tests/test_torch_vqvae.py, tests/test_torch_spherical.py): both packages'
models on the same params, and the JAX package's random draws recorded
and replayed into the port.

The models run on the 8x8 networks of tests/test_zoo_execution.py
(``tiny_networks``), small enough that flax's init is never needed: the
JAX model's state is the port's freshly built params and buffers carried
across with ``to_jax_params``/``to_jax_mutables``.

``jax_draws()`` records every draw the JAX package makes, in order, while
a function is traced or run: ``jax.random.normal``, ``uniform`` and
``randint`` as they come out, ``jax.random.beta`` as the two log-Gamma
variates it forms its value from (what ``PowerSpherical`` of the port
draws), ``jax.random.categorical`` as the Gumbel variates whose argmax
with the logits it returns (what ``OneHotCategorical.sample_from`` of the
port draws), ``jax.random.bernoulli`` as the uniforms it compares with its
probability (what a U-Net skip's mask of the port draws), and
``VonMisesFisher._sample_w`` as the cosines it returns (a rejection loop
the port runs otherwise).  ``jit_with_draws(fn)`` returns
them beside fn's output from one jitted call.  The port's ``Noise(eps=
draws)`` hands them out in the same order.

A draw inside a ``lax.scan`` body (the sequential models' ``nn.scan``) is
a tracer of the body that cannot leave it; ``jit_with_scan_draws(fn)``
records ``jax.random.normal`` and ``uniform`` instead through an ordered
``jax.debug.callback``, which runs once per executed draw, so a scan of T
steps gives T draws in their order.
"""
import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.bay.distributions.spherical import VonMisesFisher as JaxVMF
from odin_tpu.training.core import TrainState as JaxTrainState
from odin_tpu_torch.weights import (from_jax_mutables, from_jax_params,
                                    to_jax_mutables, to_jax_params)

B = 8


def tiny_networks(package: str, zdim: int = 4, qz: str = "mvndiag"):
  """The 8x8x1 conv networks of tests/test_zoo_execution.py (without its
  ladder rung) in the JAX package ('jax') or the port ('torch')."""
  if package == "jax":
    from odin_tpu.bay.random_variable import RVconf
    from odin_tpu.networks.base import (Conv, ConvTranspose, Dense, Flatten,
                                        Reshape, SequentialNetwork)
    from odin_tpu.networks.image_networks import PackImageParams
    seq = lambda layers, name: SequentialNetwork(tuple(layers), name=name)
  else:
    from odin_tpu_torch.bay.random_variable import RVconf
    from odin_tpu_torch.networks import (Conv, ConvTranspose, Dense, Flatten,
                                         PackImageParams, Reshape,
                                         SequentialNetwork)
    seq = lambda layers, name: SequentialNetwork(layers)
  encoder = seq((Conv(8, 3, 1, "relu"), Conv(8, 3, 2, "relu"), Flatten(),
                 Dense(32, None)), "encoder")
  decoder = seq((Dense(4 * 4 * 8, "relu"), Reshape((4, 4, 8)),
                 ConvTranspose(8, 3, 2, "relu"), Conv(1, 1, 1, None),
                 PackImageParams(1)), "decoder")
  return dict(encoder=encoder, decoder=decoder,
              latents=RVconf((zdim,), qz, projection=True, name="latents"),
              observation=RVconf((8, 8, 1), "bernoulli", projection=False,
                                 name="image"),
              input_shape=(8, 8, 1))


def jax_state_of(vae, seed: int = 1):
  """The JAX package's ``TrainState`` of the port's built `vae`: every
  params partition, the core's mutables, the key ``build(seed)`` gives."""
  params = {"vae": to_jax_params(vae.core)}
  for name, module in vae.extras.items():
    params[name] = to_jax_params(module, vae.state.params[name])
  mutables = (to_jax_mutables(vae.core, vae.state.mutables["vae"])
              if "vae" in vae.state.mutables else {})
  return JaxTrainState(params=params, opt_states={},
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(seed + 1), mutables=mutables)


def make_pair(cls: str, seed: int = 1, networks=None, jax_networks=None,
              drop=(), **kwargs):
  """(JAX model, the port's model on the CPU) of class `cls` of both
  packages' ``bay.vi``, on the same params and buffers; `networks` (the
  port's) and `jax_networks` default to ``tiny_networks``, without the
  keys in `drop`."""
  nets = networks or tiny_networks("torch")
  jnets = jax_networks or tiny_networks("jax")
  for k in drop:
    nets.pop(k, None)
    jnets.pop(k, None)
  vae = getattr(port_vi, cls)(**kwargs, **nets).build(seed=seed,
                                                      device="cpu")
  jvae = getattr(jax_vi, cls)(**kwargs, **jnets)
  jvae.input_shape = vae.input_shape
  jvae.extra_networks()  # VampriorVAE makes its module here
  jvae.state = jax_state_of(vae, seed)
  return jvae, vae


def binary_images(n, seed, shape=(8, 8, 1)):
  return (np.random.RandomState(seed).rand(n, *shape) < 0.5).astype(
      np.float32)


@contextlib.contextmanager
def jax_draws():
  """Record the JAX package's draws (see the module's docstring)."""
  rec = []
  depth = [0]
  saved = {}

  def wrap(owner, name, post):
    fn = getattr(owner, name)
    saved[(owner, name)] = fn

    def recorded(*args, **kwargs):
      depth[0] += 1
      try:
        out = fn(*args, **kwargs)
      finally:
        depth[0] -= 1
      if depth[0] == 0:
        rec.extend(post(out, *args, **kwargs))
      return out

    setattr(owner, name, recorded)

  def beta_post(out, key, a, b, shape=None, dtype=jnp.float32):
    # jax.random.beta: split the key, one log-Gamma from each half
    shape = tuple(shape) if shape is not None else jnp.shape(out)
    key_a, key_b = jax.random.split(key)
    a = jnp.broadcast_to(jnp.asarray(jax.lax.stop_gradient(a), dtype), shape)
    b = jnp.broadcast_to(jnp.asarray(jax.lax.stop_gradient(b), dtype), shape)
    return [jax.random.loggamma(key_a, a, shape, dtype),
            jax.random.loggamma(key_b, b, shape, dtype)]

  def categorical_post(out, key, logits, axis=-1, shape=None, replace=True,
                       mode=None):
    # jax.random.categorical with replacement: the argmax of logits plus
    # Gumbel noise of (sample dims..., logits' shape), drawn from the key
    assert replace and axis == -1
    logits = jnp.asarray(logits)
    batch = jnp.shape(logits)[:-1]
    shape = batch if shape is None else tuple(shape)
    full = shape[:len(shape) - len(batch)] + jnp.shape(logits)
    return [jax.lax.stop_gradient(jax.random.gumbel(
        key, full, logits.dtype, mode=mode))]

  def bernoulli_post(out, key, p=0.5, shape=None, mode="low", **kwargs):
    # jax.random.bernoulli (mode 'low'): the uniforms of p's dtype, of the
    # output's shape, that it compares with p; drawn with the unrecorded
    # jax.random.uniform
    assert mode == "low"
    uniform = saved[(jax.random, "uniform")]
    return [uniform(key, jnp.shape(out), jnp.asarray(p).dtype)]

  as_is = lambda out, *a, **k: [jax.lax.stop_gradient(out)]
  for name in ("normal", "uniform", "randint"):
    wrap(jax.random, name, as_is)
  wrap(jax.random, "bernoulli", bernoulli_post)
  wrap(jax.random, "beta", beta_post)
  wrap(jax.random, "categorical", categorical_post)
  wrap(JaxVMF, "_sample_w", as_is)
  try:
    yield rec
  finally:
    for (owner, name), fn in saved.items():
      setattr(owner, name, fn)


def jit_with_draws(fn, **jit_kwargs):
  """``jax.jit`` of fn returning ``(fn's output, the draws it made)``."""

  def traced(*args):
    with jax_draws() as rec:
      out = fn(*args)
    return out, list(rec)

  return jax.jit(traced, **jit_kwargs)


@contextlib.contextmanager
def _scan_draws(rec):
  saved = {}

  def wrap(name):
    fn = getattr(jax.random, name)
    saved[name] = fn

    def recorded(*args, **kwargs):
      out = fn(*args, **kwargs)
      jax.debug.callback(lambda v: rec.append(np.array(v)),
                         jax.lax.stop_gradient(out), ordered=True)
      return out

    setattr(jax.random, name, recorded)

  for name in ("normal", "uniform"):
    wrap(name)
  try:
    yield
  finally:
    for name, fn in saved.items():
      setattr(jax.random, name, fn)


def jit_with_scan_draws(fn, **jit_kwargs):
  """``jax.jit`` of fn returning ``(fn's output, the draws it made)``, the
  draws of scan bodies included, one per iteration (see the module's
  docstring)."""
  rec = []

  def traced(*args):
    with _scan_draws(rec):
      return fn(*args)

  jitted = jax.jit(traced, **jit_kwargs)

  def call(*args):
    rec.clear()
    out = jitted(*args)
    jax.effects_barrier()
    return out, list(rec)

  return call


def to_torch(draws):
  return [torch.from_numpy(np.array(d)) for d in draws]


def port_tree(tree):
  """A JAX {partition: flax tree} -> the port's {partition: state_dict}."""
  return {k: from_jax_params(v) for k, v in tree.items()}


def np_tree(tree):
  return {k: {n: t.detach().cpu().numpy() for n, t in v.items()}
          for k, v in tree.items()}


def port_mutables(jax_mutables):
  return {k: v.numpy() for k, v in from_jax_mutables(jax_mutables).items()}


RTOL = 1e-5
LR = 1e-3


def assert_terms_close(got, want, rtol=RTOL, what="", scales=None):
  """{name: per-example term}: each within `rtol` of the term's largest
  magnitude over the batch (a term that is a difference of larger
  log-densities, as VampPrior's KL, keeps only their float32 rounding),
  or of ``scales[name]``, the magnitude of the log-densities a term that
  nearly cancels is the difference of."""
  assert set(got) == set(want), (sorted(got), sorted(want))
  for name, w in want.items():
    w = np.asarray(w)
    g = got[name].detach().cpu().numpy() if isinstance(got[name],
                                                       torch.Tensor) \
        else np.asarray(got[name])
    scale = (scales or {}).get(name, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                               err_msg=f"{name} {what}")


def elbo_matches_jax(pair, batch, steps=(0, 700), key=4,
                     recorder=jit_with_draws, scales=None):
  """The ELBO terms and the loss of both packages on `batch` (numpy, or a
  tuple of arrays), JAX's draws injected, at each of `steps`."""
  from odin_tpu_torch.training.core import Noise
  jvae, vae = pair
  fn = recorder(lambda p, b, k, s, m: jvae.elbo_components(
      p, b, k, s, training=False, mutables=m)[:2])
  tb = tuple(torch.from_numpy(b) for b in batch) if isinstance(
      batch, tuple) else torch.from_numpy(batch)
  for step in steps:
    (jl, jk), draws = fn(jvae.state.params, batch, jax.random.PRNGKey(key),
                         jnp.int32(step), jvae.state.mutables)
    l, k, _ = vae.elbo_components(vae.state.params, tb,
                                  Noise(eps=to_torch(draws)),
                                  torch.tensor(step, dtype=torch.int32),
                                  mutables=dict(vae.state.mutables))
    assert_terms_close({**l, **k}, {**jl, **jk}, what=f"at step {step}",
                       scales=scales)
    np.testing.assert_allclose(
        float(-vae.elbo(l, k).mean()), float(-jnp.mean(jvae.elbo(jl, jk))),
        rtol=RTOL)


def step_matches_jax(pair, batch, lr=LR, **step_kwargs):
  """One training step (every TrainStep) of both packages from the same
  state, JAX's draws injected: the metrics within rtol 1e-5 (atol 1e-6),
  every params partition by the rule of ``assert_params_close``, the
  mutables within 1e-6, each optimizer's count and the step count.
  Returns (JAX state, port state, JAX metrics, port metrics)."""
  from torch_training_common import assert_params_close, jax_adam
  jvae, vae = pair
  start = (jvae.state, vae.state)
  jstep = jit_with_draws(jvae.make_step_fn(learning_rate=lr, jit=False,
                                           **step_kwargs))
  (js, jm), draws = jstep(jvae.state, batch)
  tb = tuple(torch.from_numpy(b) for b in batch) if isinstance(
      batch, tuple) else torch.from_numpy(batch)
  s, m = vae.make_step_fn(learning_rate=lr, **step_kwargs)(
      vae.state, tb, eps=to_torch(draws))
  jvae.state, vae.state = start
  js, jm = jax.device_get(js), jax.device_get(jm)
  assert set(m) == set(jm)
  for k in jm:
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                               atol=1e-6, err_msg=k)
  assert set(s.params) == set(js.params)
  got, want = np_tree(s.params), port_tree(js.params)
  for part in want:
    assert_params_close(got[part], want[part], 1, lr=lr)
  if js.mutables:
    for k, v in port_mutables(js.mutables).items():
      np.testing.assert_allclose(s.mutables["vae"][k].numpy(), v, rtol=1e-6,
                                 atol=1e-6, err_msg=k)
  assert set(s.opt_states) == set(js.opt_states)
  for name, opt in js.opt_states.items():
    assert int(s.opt_states[name]["count"]) == int(jax_adam(opt).count)
  assert int(s.step) == int(js.step) == 1
  return js, s, jm, m


def steps_match_jax(pair, batches, lr=LR, recorder=jit_with_draws,
                    scales=None, **step_kwargs):
  """len(batches) training steps of both packages from the same state,
  JAX's draws injected at each: the metrics of every step within rtol
  1e-5 (atol 1e-6, or rtol times ``scales[name]`` as in
  ``assert_terms_close``), then every params partition by the rule of
  ``assert_params_close`` for that many steps.  Both models' states are
  left as they were.  Returns (JAX state, port state)."""
  from torch_training_common import assert_params_close
  jvae, vae = pair
  start = (jvae.state, vae.state)
  jstep = recorder(jvae.make_step_fn(learning_rate=lr, jit=False,
                                     **step_kwargs))
  step = vae.make_step_fn(learning_rate=lr, **step_kwargs)
  js, s = jvae.state, vae.state
  for i, batch in enumerate(batches):
    (js, jm), draws = jstep(js, batch)
    tb = tuple(torch.from_numpy(b) for b in batch) if isinstance(
        batch, tuple) else torch.from_numpy(batch)
    s, m = step(s, tb, eps=to_torch(draws))
    jm = jax.device_get(jm)
    assert set(m) == set(jm)
    for k in jm:
      atol = RTOL * scales[k] if k in (scales or {}) else 1e-6
      np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                 atol=atol, err_msg=f"{k} at step {i}")
  jvae.state, vae.state = start
  js = jax.device_get(js)
  got, want = np_tree(s.params), port_tree(js.params)
  assert set(got) == set(want)
  for part in want:
    assert_params_close(got[part], want[part], len(batches), lr=lr)
  assert int(s.step) == int(js.step) == len(batches)
  return js, s


def assert_tree_matches_jax_init(jvae, vae, *inputs):
  """The port's flax tree of every params partition (``to_jax_params``)
  has the paths and shapes of ``jax.eval_shape`` of the JAX model's own
  init on `inputs` (the JAX model is not changed)."""
  rng = jax.random.PRNGKey(0)

  def init():
    rngs = {"params": rng, "dropout": rng, "sample": rng}
    tree = {"vae": jvae.core.init(rngs, *inputs)["params"]}
    for name, (module, dummy) in jvae.extra_networks().items():
      tree[name] = module.init({"params": rng, "dropout": rng},
                               dummy())["params"]
    return tree

  want = jax.eval_shape(init)
  got = {"vae": to_jax_params(vae.core)}
  for name, module in vae.extras.items():
    got[name] = to_jax_params(module, vae.state.params[name])
  leaves = lambda t: {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
  assert leaves(got) == leaves(want)
