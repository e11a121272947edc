"""The port's ``BNFExtractor`` against the JAX package's on the CPU.

A flax stack of ``nn.Dense`` layers with ReLUs between them (as
tests/test_preprocessing.py's bottleneck) is initialised from a seed; its
params go through ``weights.from_jax_dense_stack`` into the port's
``nn.Sequential``, and the same MFCCs and SAD mask (numpy, from a seed) go
through both extractors: equal within 1e-5 (fp32 products summed in
another order by XLA and by PyTorch).  The recipe's options (SAD kept or
dropped, no SAD, no MVN, no stacking, a last batch shorter than the others)
each give that agreement.
"""
import numpy as np
import pytest
import torch

from odin_tpu.preprocessing import BNFExtractor as JaxBNF
from odin_tpu_torch.preprocessing import BNFExtractor
from odin_tpu_torch.weights import from_jax_dense_stack

TOL = 1e-5
N_FRAMES, N_CEPS = 300, 13


def _flax_stack(widths, in_dim, seed=0):
  import flax.linen as nn
  import jax

  class Stack(nn.Module):
    @nn.compact
    def __call__(self, x):
      for i, w in enumerate(widths):
        x = nn.Dense(w)(x)
        if i < len(widths) - 1:
          x = nn.relu(x)
      return x

  mod = Stack()
  params = mod.init(jax.random.PRNGKey(seed), np.zeros((1, in_dim), "f"))
  return mod, jax.device_get(params)


@pytest.fixture(scope="module")
def data():
  rng = np.random.RandomState(0)
  return {"mfcc": (rng.randn(N_FRAMES, N_CEPS) * 3 + 1).astype("f"),
          "sad": rng.rand(N_FRAMES) > 0.3}


@pytest.fixture(scope="module")
def networks():
  return {c: _flax_stack((32, 7), N_CEPS * (2 * c + 1)) for c in (0, 10)}


CASES = [
    dict(stack_context=10, batch_size=128),
    dict(stack_context=10, batch_size=512, remove_non_speech=False),
    dict(stack_context=10, batch_size=100, sad_name=None),
    dict(stack_context=10, batch_size=64, pre_mvn=False),
    dict(stack_context=0, batch_size=2048),
]


@pytest.mark.parametrize("kwargs", CASES, ids=range(len(CASES)))
def test_bnf_matches_jax(data, networks, kwargs):
  mod, params = networks[kwargs["stack_context"]]
  feat = dict(data)
  if kwargs.get("sad_name", "sad") is None:
    feat.pop("sad")
  want = JaxBNF("mfcc", network=(mod, params), **kwargs).transform(feat)
  net = from_jax_dense_stack(params, device="cpu")
  got = BNFExtractor("mfcc", network=net, device="cpu", **kwargs
                     ).transform(feat)
  assert got["bnf"].dtype == np.float32 == want["bnf"].dtype
  assert got["bnf"].shape == want["bnf"].shape
  n = int(data["sad"].sum())
  expect = n if kwargs.get("sad_name", "sad") and \
      kwargs.get("remove_non_speech", True) else N_FRAMES
  assert got["bnf"].shape == (expect, 7)
  np.testing.assert_allclose(got["bnf"], want["bnf"], rtol=0, atol=TOL)
  for key in feat:
    np.testing.assert_array_equal(got[key], feat[key])


def test_deep_bottleneck_matches_jax(data):
  """Three ReLU layers and a linear bottleneck, as the card's network."""
  mod, params = _flax_stack((64, 64, 64, 16), N_CEPS * 7, seed=1)
  want = JaxBNF("mfcc", network=(mod, params), stack_context=3,
                batch_size=96).transform(data)["bnf"]
  net = from_jax_dense_stack(params, device="cpu")
  assert [type(m).__name__ for m in net] == ["Linear", "ReLU"] * 3 + [
      "Linear"]
  got = BNFExtractor("mfcc", net, stack_context=3, batch_size=96,
                     device="cpu").transform(data)["bnf"]
  np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_callable_network_and_errors(data):
  """A callable on tensors is taken as it is; the flax pair raises and
  names the bridge; the card is the default device, and without one the
  extractor raises rather than falling back to the CPU."""
  w = torch.from_numpy(np.random.RandomState(2).randn(N_CEPS * 3, 5)
                       .astype("f"))
  fn = lambda t: torch.tanh(t @ w)
  got = BNFExtractor("mfcc", fn, stack_context=1, device="cpu").transform(
      data)["bnf"]
  assert got.shape == (int(data["sad"].sum()), 5)
  with pytest.raises(TypeError, match="from_jax_dense_stack"):
    BNFExtractor("mfcc", (object(), {}), device="cpu")
  with pytest.raises(TypeError):
    BNFExtractor("mfcc", 3, device="cpu")
  with pytest.raises(ValueError, match="sad length"):
    BNFExtractor("mfcc", fn, stack_context=1, device="cpu").transform(
        {"mfcc": data["mfcc"], "sad": data["sad"][:10]})
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      BNFExtractor("mfcc", fn)


def test_bridge_rejects_other_layers():
  with pytest.raises(ValueError):
    from_jax_dense_stack({"params": {"Dense_0": {"kernel": np.ones((2, 2))},
                                     "Conv_0": {}}}, device="cpu")
  with pytest.raises(ValueError):
    from_jax_dense_stack({"params": {}}, device="cpu")
  net = from_jax_dense_stack({"Dense_1": {"kernel": np.ones((3, 2))},
                              "Dense_0": {"kernel": np.ones((4, 3)),
                                          "bias": np.zeros(3)}},
                             device="cpu")
  assert [tuple(m.weight.shape) for m in net[::2]] == [(3, 4), (2, 3)]
  assert net[2].bias is None
