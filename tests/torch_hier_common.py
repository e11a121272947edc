"""Shared set-up of the hierarchical and grouped families' parity tests
(tests/test_torch_hier_*.py, tests/test_torch_group_*.py): both packages'
models on the same params, JAX's draws replayed into the port
(``torch_zoo_common``).

The hierarchical models run on the 8x8 networks of
tests/test_zoo_execution.py *with* its ladder rung (``ladder_networks``:
the rung reads the first conv's 8x8x8 state and sits after the decoder's
transposed conv, kernel 3, stride 2); the grouped ones on
``torch_zoo_common.tiny_networks`` and batches of pairs (``pairs``).  The
rungs alone run at each geometry of ``GEOMETRY`` (``rung_matches_jax``).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay.vi.autoencoder import hierarchical_vae as jax_hier
from odin_tpu_torch.bay.vi.autoencoder import hierarchical_vae as port_hier
from odin_tpu_torch.networks.base import collecting_updates
from odin_tpu_torch.training import Noise
from odin_tpu_torch.weights import from_jax_params
from torch_zoo_common import (B, binary_images, elbo_matches_jax,
                              jit_with_draws, make_pair, step_matches_jax,
                              tiny_networks)

HIERARCHY = dict(decoder_layer=2, encoder_layer=0, channels=8, filters=4,
                 kernel_size=3, strides=2)


def ladder_networks(package: str, latents: str = None):
  """tests/test_zoo_execution.py's ``_tiny_image_networks`` in the JAX
  package ('jax') or the port ('torch'), its rung of kind `latents`
  (biconv by default)."""
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
  h = dict(HIERARCHY, **({} if latents is None else {"latents": latents}))
  return dict(encoder=encoder, decoder=decoder,
              latents=RVconf((4,), "mvndiag", projection=True,
                             name="latents"),
              observation=RVconf((8, 8, 1), "bernoulli", projection=False,
                                 name="image"),
              input_shape=(8, 8, 1), hierarchy=(h,))


def ladder_pair(cls: str, latents: str = None, **kwargs):
  """(JAX model, the port's model) of a hierarchical class on the ladder
  networks, the same params."""
  return make_pair(cls, networks=ladder_networks("torch", latents),
                   jax_networks=ladder_networks("jax", latents), **kwargs)


def hier_matches_jax(cls: str, latents: str = None, steps=(0, 700),
                     **kwargs):
  """`cls`'s ELBO terms (each ``kl_ladder{i}`` too) at `steps` and one
  full training step against JAX's, JAX's draws replayed."""
  pair = ladder_pair(cls, latents, **kwargs)
  elbo_matches_jax(pair, binary_images(B, 70), steps=steps)
  step_matches_jax(pair, binary_images(B, 71))
  return pair


def pairs(seed: int, label: str = None):
  """A batch of B pairs of 8x8 binary images (x2 shares most of x1's
  pixels); with `label` 'rank' a (B,) 0/1 label, with 'restricted' (B, 2)
  factor values in [0, 1]."""
  rs = np.random.RandomState(seed)
  x1 = binary_images(B, seed)
  flip = (rs.rand(*x1.shape) < 0.2).astype(np.float32)
  x2 = np.abs(x1 - flip)
  if label == "rank":
    return x1, x2, (rs.rand(B) < 0.5).astype(np.float32)
  if label == "restricted":
    return x1, x2, rs.rand(B, 2).astype(np.float32)
  return x1, x2


def group_matches_jax(cls: str, label: str = None, **kwargs):
  """`cls`'s ELBO terms on pairs at steps 0 and 700 (``pair_loss`` too)
  and one full training step against JAX's, JAX's draws replayed; the
  unpaired fallback's terms too."""
  pair = make_pair(cls, **kwargs)
  elbo_matches_jax(pair, pairs(80, label))
  elbo_matches_jax(pair, binary_images(B, 81), steps=(0,))
  step_matches_jax(pair, pairs(82, label))
  return pair


def jax_shared(jvae, batch, key=4):
  """JAX's mean count of shared dimensions of `batch` (its aux)."""
  _, _, aux = jvae.elbo_components(jvae.state.params, batch,
                                   jax.random.PRNGKey(key), jnp.int32(0))
  return float(aux["n_shared"])


def unet_knob_matches_jax(knob: str, rate: float):
  """UnetVAE with the skip knob `knob` at `rate`: its ELBO terms in
  training mode (the skips' draws made: the per-sample gate, each skip's
  dropout uniforms and noise) and one full training step against JAX's,
  JAX's draws replayed.  At ``skip_dropout=1.0`` JAX divides the dropped
  skip by a keep rate of 0: its llk is NaN everywhere, and so is the
  port's (the step then skips its update in both)."""
  from odin_tpu_torch.training.core import Noise
  from torch_zoo_common import assert_terms_close, to_torch
  jvae, vae = pair = ladder_pair("UnetVAE", **{knob: rate})
  x = binary_images(B, 73)
  fn = jit_with_draws(lambda p, b, k: jvae.elbo_components(
      p, b, k, 0, training=True)[:2])
  (jl, jk), draws = fn(jvae.state.params, x, jax.random.PRNGKey(6))
  l, k, _ = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                Noise(eps=to_torch(draws)),
                                torch.tensor(0, dtype=torch.int32),
                                training=True)
  if knob == "skip_dropout" and rate == 1.0:
    assert np.isnan(np.asarray(jl["llk_image"])).all()
    assert torch.isnan(l["llk_image"]).all()
    jl, l = {}, {}
  assert_terms_close({**l, **k}, {**jl, **jk}, what=f"{knob}={rate}")
  step_matches_jax(pair, binary_images(B, 74))
  return draws


# ladder rungs, alone: kinds and geometries
KINDS = {
    "biconv": lambda m, **kw: m.BiConvLatents(**kw),
    "parallel": lambda m, **kw: m.ParallelLatents(residual_coef=0.5, **kw),
    "bidense": lambda m, filters, merge_channels, **kw: m.BiDenseLatents(
        units=filters, merge_units=merge_channels),
}
GEOMETRY = {  # (grid, kernel, stride, d channels, e channels, filters)
    "dsprites-16x16-k8s4": (16, 8, 4, 64, 32, 16),
    "odd-13x13-k8s4": (13, 8, 4, 8, 4, 4),
    "tiny-8x8-k3s2": (8, 3, 2, 8, 8, 4),
}


def rung_pair(kind: str, geometry: str):
  """(JAX rung, its params, the port's rung on them, d, e) of a rung kind
  at a geometry of ``GEOMETRY``."""
  n, k, s, cd, ce, f = GEOMETRY[geometry]
  kw = dict(filters=f, merge_channels=cd)
  if kind != "bidense":
    kw.update(kernel_size=k, strides=s)
  rs = np.random.RandomState(3)
  d = rs.randn(2, n, n, cd).astype(np.float32)
  e = rs.randn(2, n, n, ce).astype(np.float32)
  jrung = KINDS[kind](jax_hier, **kw)
  params = jax.device_get(jax.jit(jrung.init)(
      {"params": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)},
      d, e)["params"])
  rung = KINDS[kind](port_hier, **kw)
  rung.build(d.shape[1:], e.shape[1:], torch.Generator().manual_seed(0))
  rung.load_state_dict(from_jax_params(params))
  return jrung, params, rung, d, e


def _close(got, want, what):
  want = np.asarray(want)
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                             atol=1e-5 * max(float(np.abs(want).max()), 1.0),
                             err_msg=what)


def same_rung(out, jout, what):
  """A rung's (new d, qz, pz, z) of the port against JAX's."""
  (d, qz, pz, z), (jd, jqz, jpz, jz) = out, jout
  _close(d, jd, f"{what}: new state")
  _close(z, jz, f"{what}: z")
  for name, a, b in (("pz", pz, jpz), ("qz", qz, jqz)):
    assert (a is None) == (b is None), name
    if a is not None:
      assert tuple(a.event_shape) == tuple(b.event_shape), name
      _close(a.distribution.loc, b.distribution.loc, f"{what}: {name} loc")
      _close(a.distribution.scale, b.distribution.scale,
             f"{what}: {name} scale")
  if qz is not None:
    _close(qz.kl_divergence(pz, analytic=True),
           jqz.kl_divergence(jpz, analytic=True), f"{what}: KL")


def rung_matches_jax(kind: str, geometry: str):
  """Each path of a rung against JAX's: the posterior mean, a given z,
  generation from the prior, and a sample (JAX's draw replayed); JAX's
  four in one jitted call."""
  jrung, params, rung, d, e = rung_pair(kind, geometry)

  def paths(d, e, key):
    apply = lambda *a, **k: jrung.apply({"params": params}, *a, **k)
    posterior = apply(d, e, sample=False)
    z = posterior[3] * 0.5 + 0.1
    return (posterior, (z, apply(d, e, z=z)), apply(d, None, sample=False),
            apply(d, e, rngs={"sample": key}))

  (posterior, (z, given), prior, sampled), rec = jit_with_draws(paths)(
      d, e, jax.random.PRNGKey(5))
  assert len(rec) == 1
  td, te = torch.from_numpy(d), torch.from_numpy(e)
  with torch.no_grad():
    same_rung(rung(td, te, sample=False), posterior, "posterior")
    same_rung(rung(td, te, z=torch.tensor(np.asarray(z))), given, "given z")
    same_rung(rung(td, None, sample=False), prior, "prior")
    with collecting_updates(Noise(eps=[torch.tensor(np.asarray(rec[0]))])):
      out = rung(td, te)
    same_rung(out, sampled, "sampled")


__all__ = ["B", "HIERARCHY", "KINDS", "GEOMETRY", "rung_pair", "same_rung",
           "rung_matches_jax", "ladder_networks", "ladder_pair",
           "hier_matches_jax", "unet_knob_matches_jax", "pairs", "group_matches_jax", "jax_shared",
           "tiny_networks"]
