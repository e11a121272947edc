"""The port's serving layer (``odin_tpu_torch/serving.py``) against the JAX
package's (``odin_tpu/serving.py``) on the CPU.

Tolerances: a bundle's outputs within 1e-5 of the live model and of the
JAX package's loaded bundle (tests/test_serving.py's limit); int8 codes
and scales bit for bit after the bridge (``weights.from_jax_quantized``);
the int8 bundle under half the fp32 bundle's bytes and its reconstruction
within 0.15 of the fp32 one relative to the largest value
(tests/test_serving.py's limits).  The JAX models are not built: their
state is the port's params carried across (``to_jax_params``).
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
from odin_tpu import serving as jax_serving
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu.training.core import TrainState as JaxTrainState
from odin_tpu_torch import serving
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi import VQVAE, BetaVAE
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.networks.base import Dense, SequentialNetwork
from odin_tpu_torch.serving import (ServingBundle, dequantize_params,
                                    export_fn, export_vae, load_fn,
                                    quantize_params)
from odin_tpu_torch.weights import from_jax_quantized, to_jax_params
from torch_zoo_common import binary_images, tiny_networks

ATOL = 1e-5


def _jax_twin(vae, name, zdim, input_shape):
  """The JAX package's BetaVAE on the port model's params."""
  jvae = jax_vi.BetaVAE(**jax_get_networks(name, zdim=zdim))
  jvae.input_shape = input_shape
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(4),
      mutables={})
  return jvae


@pytest.fixture(scope="module")
def moons():
  return BetaVAE(**get_networks("halfmoons", zdim=2)).build(seed=3,
                                                            device="cpu")


def test_export_roundtrip_batch_polymorphic():
  """tests/test_serving.py:12: one program serves another batch size."""
  f = lambda x, w: x @ w + 1.0
  blob = export_fn(f, (torch.ones(2, 3), torch.ones(3, 4)),
                   batch_polymorphic=True)
  assert isinstance(blob, bytes)
  g = load_fn(blob, device="cpu")
  out = g(torch.ones(5, 3), torch.ones(3, 4))
  assert out.shape == (5, 4)
  np.testing.assert_allclose(out.numpy(), 4.0)
  # the same through the JAX package's artifact
  jg = jax_serving.load_fn(jax_serving.export_fn(
      f, (jnp.ones((2, 3)), jnp.ones((3, 4)))))
  np.testing.assert_allclose(out.numpy(),
                             np.asarray(jg(jnp.ones((5, 3)),
                                           jnp.ones((3, 4)))))


def test_example_batch_of_one_serves_batch_five():
  """An example of batch 1 is traced at 2, so the batch stays symbolic."""
  w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
  f = lambda x: torch.tanh(x @ w)
  g = load_fn(export_fn(f, (torch.ones(1, 3),)), device="cpu")
  x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
  np.testing.assert_allclose(g(x).numpy(), f(x).numpy(), atol=ATOL)
  assert g(x[:1]).shape == (1, 4)


def test_bundle_matches_jax_bundle_and_live_model(tmp_path, moons):
  """A bridged half-moons BetaVAE: the port's bundle, loaded in a fresh
  ``ServingBundle``, within 1e-5 of the live model and of the JAX
  package's loaded bundle, at batch 1 and 16, from the default example
  batch of 1."""
  jvae = _jax_twin(moons, "halfmoons", 2, (2,))
  bundle = export_vae(moons, str(tmp_path / "port"), device="cpu")
  jax_serving.export_vae(jvae, str(tmp_path / "jax"))
  assert set(bundle.names()) == {"encode_mean", "decode_mean",
                                 "reconstruct"}
  served = ServingBundle(str(tmp_path / "port"), device="cpu")
  jserved = jax_serving.ServingBundle(str(tmp_path / "jax"))
  assert served.manifest["encode_mean"]["zdim"] == 2
  assert served.manifest["encode_mean"]["input_shape"] == [2]
  assert set(served.manifest["reconstruct"]) == set(
      jserved.manifest["reconstruct"])
  X = np.random.RandomState(0).rand(16, 2).astype("f")
  Z = np.random.RandomState(1).randn(16, 2).astype("f")
  for name, arg in (("encode_mean", X), ("decode_mean", Z),
                    ("reconstruct", X)):
    live = getattr(serving, name)(moons, arg).numpy()
    for b in (1, 16):
      got = served[name](arg[:b]).numpy()
      want = np.asarray(jserved[name](jnp.asarray(arg[:b])))
      assert got.shape == want.shape == live[:b].shape
      np.testing.assert_allclose(got, live[:b], atol=ATOL)
      np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ema", [False, True])
def test_vqvae_bundle_serves_the_trained_state(tmp_path, ema):
  """A VQVAE fitted 4 steps, its codebook a param trained by the codebook
  loss or an EMA buffer in the state's mutables: the codebook gets no
  gradient through the straight-through codes, yet every program of the
  bundle (fp32, and int8 with min_size 64) serves the trained state, not
  the core's build-time copies.  fp32 within 1e-5 of the live model, int8
  within 0.15 relative."""
  vae = VQVAE(n_codes=8, ema=ema, ema_decay=0.5,
              **tiny_networks("torch")).build(seed=1, device="cpu")
  built = vae.core.latents.codebook.detach().clone()
  corpus = (binary_images(32, 11) * 255).astype(np.uint8)
  vae.fit_device_dataset(corpus, n_steps=4, batch_size=8, steps_per_call=2,
                         learning_rate=1e-2, seed=5, verbose=False)
  trained = (vae.state.mutables if ema else vae.state.params)["vae"][
      "latents.codebook"]
  assert float((trained - built).abs().max()) > 1e-3  # the codebook moved
  fp32 = export_vae(vae, str(tmp_path / "fp32"), device="cpu")
  q8 = export_vae(vae, str(tmp_path / "int8"), quantize=True, min_size=64,
                  device="cpu")
  X = binary_images(5, 12)
  Z = np.random.RandomState(13).randn(5, vae.zdim).astype("f")
  for name, arg in (("encode_mean", X), ("decode_mean", Z),
                    ("reconstruct", X)):
    live = getattr(serving, name)(vae, arg).numpy()
    np.testing.assert_allclose(fp32[name](arg).numpy(), live, atol=ATOL,
                               err_msg=name)
    got = q8[name](arg).numpy()
    assert np.abs(got - live).max() < 0.15 * np.abs(live).max(), name


def test_int8_codes_equal_jax_after_the_bridge():
  """The dSprites BetaVAE's params quantized by both packages: JAX's codes
  and scales, carried across, equal the port's bit for bit, including the
  decoder's ConvTranspose kernels (axis 1 in torch, the last in flax)."""
  vae = BetaVAE(**get_networks("dsprites", zdim=10)).build(seed=1,
                                                           device="cpu")
  for min_size in (1024, 64):
    mine = quantize_params(vae.core, min_size=min_size)
    theirs = from_jax_quantized(jax_serving.quantize_params(
        to_jax_params(vae.core), min_size=min_size))
    assert set(mine) == set(theirs)
    quantized = [k for k, v in mine.items() if isinstance(v, dict)]
    assert any("decoder.layers.2" in k for k in quantized)  # ConvTranspose
    for k, v in mine.items():
      if isinstance(v, dict):
        assert v["__int8__"].dtype == torch.int8
        assert torch.equal(v["__int8__"], theirs[k]["__int8__"]), k
        assert torch.equal(v["scale"], theirs[k]["scale"]), k
      else:
        assert not isinstance(theirs[k], dict), k
        assert torch.equal(v, theirs[k]), k
  axes = serving.channel_axes(vae.core)
  assert axes["decoder.layers.2.weight"] == 1
  assert axes["encoder.layers.2.weight"] == 0
  # the dequantized weights lie within half a step of the originals
  params = {k: v.detach() for k, v in vae.core.named_parameters()}
  for k, w in dequantize_params(quantize_params(vae.core, 64)).items():
    w = w.detach()
    assert w.shape == params[k].shape
    assert float((w - params[k]).abs().max()) <= \
        float(params[k].abs().max()) / 254 + 1e-8


def _wide_vae(width=256):
  nets = dict(
      encoder=SequentialNetwork((Dense(width, "relu"), Dense(width, "relu"))),
      decoder=SequentialNetwork((Dense(width, "relu"), Dense(width, "relu"))),
      latents=RVconf((2,), "mvndiag", projection=True, name="latents"),
      observation=RVconf((2,), "gaussian", projection=True,
                         name="observation"),
      input_shape=(2,))
  return BetaVAE(**nets).build(seed=3, device="cpu")


def test_int8_bundle_is_under_half_the_bytes(tmp_path):
  """tests/test_serving.py:109,114 at width 256 with min_size 64: the int8
  bundle under 0.5x the fp32 one's bytes, its programs holding int8
  buffers, and the reconstruction within 0.15 relative of fp32."""
  vae = _wide_vae()
  fp32 = export_vae(vae, str(tmp_path / "fp32"), device="cpu")
  q8 = export_vae(vae, str(tmp_path / "int8"), quantize=True, min_size=64,
                  device="cpu")
  size = lambda b: sum(v["bytes"] for v in b.manifest.values())
  assert size(q8) < 0.5 * size(fp32), (size(q8), size(fp32))
  assert all(v["has_weights"] for v in q8.manifest.values())
  assert not any(v["has_weights"] for v in fp32.manifest.values())
  for name in q8.names():
    assert os.path.getsize(tmp_path / "int8" / f"{name}.pt2") == \
        q8.manifest[name]["bytes"]
  ep = torch.export.load(str(tmp_path / "int8" / "reconstruct.pt2"))
  assert any(t.dtype == torch.int8 for t in ep.state_dict.values())
  X = np.random.RandomState(0).rand(8, 2).astype("f")
  r_fp = fp32["reconstruct"](X).numpy()
  r_q8 = q8["reconstruct"](X).numpy()
  assert np.isfinite(r_q8).all()
  rel = np.abs(r_fp - r_q8).max() / (np.abs(r_fp).max() + 1e-8)
  assert rel < 0.15, rel


def test_export_over_a_kernel_raises():
  """A function reaching K1 or K2 no longer raises: it exports, with the
  kernel's operator named in the program's graph, and the loaded program
  equals the function; with the plain options (``use_pallas=False``,
  ``flash=False``) the graph holds no such operator."""
  from odin_tpu_torch.networks.attention import MultiHeadAttention
  from odin_tpu_torch.ops.features import FeatureConfig, speech_features
  cfg = FeatureConfig()
  y = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0)) * 0.1

  def targets(blob):
    ep = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}

  for use_pallas in (True, False):
    fn = lambda y: speech_features(y, cfg, device="cpu",
                                   use_pallas=use_pallas)["mspec"]
    blob = export_fn(fn, (y,))
    assert ("odin_tpu_torch.logmel.default" in targets(blob)) == use_pallas
    g = load_fn(blob, device="cpu")
    np.testing.assert_allclose(g(y[:1]).numpy(), fn(y[:1]).numpy(),
                               atol=ATOL)
  x = torch.randn(2, 10, 16, generator=torch.Generator().manual_seed(1))
  for flash in (True, False):
    layer = MultiHeadAttention(num_heads=2, qkv_features=16, flash=flash)
    layer.build((10, 16), torch.Generator().manual_seed(0), device="cpu")
    blob = export_fn(layer, (x,))
    assert ("odin_tpu_torch.flash_attention.default" in targets(blob)) == \
        flash
    with torch.no_grad():
      np.testing.assert_allclose(load_fn(blob, device="cpu")(x).numpy(),
                                 layer(x).numpy(), atol=ATOL)


def test_bundle_loads_without_the_port(tmp_path, moons):
  """A loaded ``.pt2`` needs torch alone: a child process whose path lacks
  the repository runs the programs and imports no ``odin`` module."""
  export_vae(moons, str(tmp_path / "b"), device="cpu")
  X = np.random.RandomState(0).rand(3, 2).astype("f")
  np.save(tmp_path / "x.npy", X)
  code = "\n".join([
      "import sys, numpy as np, torch",
      f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))",
      f"f = torch.export.load({str(tmp_path / 'b' / 'reconstruct.pt2')!r})",
      "y = f.module()(x)",
      "assert tuple(y.shape) == (3, 2)",
      "assert not [m for m in sys.modules if m.startswith('odin')]",
      "np.save(sys.argv[1], y.detach().numpy())"])
  res = subprocess.run([sys.executable, "-c", code,
                        str(tmp_path / "y.npy")], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
  assert res.returncode == 0, res.stderr
  np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                             serving.reconstruct(moons, X).numpy(),
                             atol=ATOL)


def test_bundle_default_device_is_the_card(tmp_path, moons):
  """``bundle[name]`` loads onto the card unless asked for the CPU; without
  a card that raises, naming the way to the CPU."""
  export_vae(moons, str(tmp_path / "b"), device="cpu")
  bundle = ServingBundle(str(tmp_path / "b"))
  if torch.cuda.is_available():
    assert bundle["encode_mean"].device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      bundle["encode_mean"]
