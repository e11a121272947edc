"""K1 and K2 as operators (``torch.ops.odin_tpu_torch.logmel``,
``.flash_attention``) and the programs ``serving.export_fn`` makes over
them, against the JAX package's live calls on the CPU.

JAX exports a function over its Pallas kernels only at static shapes and
only on a TPU: at a symbolic batch ``pl.CostEstimate`` refuses the batch
in its flop count (``ValueError``), and in interpret mode, the only mode on
the CPU, serialization refuses the kernel's host callbacks
(``NotImplementedError``); ``test_jax_cannot_export_over_its_kernels``
pins both.  So the port's exported programs (batch-polymorphic and static)
are held against JAX's live ``use_pallas=True``/``flash=True`` calls, the
Pallas kernels run in interpret mode, on the same numpy inputs.  Limits:
0.01 dB on log-mels, 2e-5 on attention outputs, 1e-4 on gradients (the
JAX package's own, tests/test_ops_features.py and
tests/test_flash_attention.py).  The operators' CUDA implementations run
only on the card (tests/test_torch_cuda.py, ``chip_smoke.py`` phase 24).
"""
import importlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from odin_tpu import serving as jax_serving
from odin_tpu.networks import attention as ja
from odin_tpu.ops import features as jf
from odin_tpu.ops import pallas_attention as jpa
from odin_tpu_torch.networks import attention as ta
from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops.flash_attention import flash_attention
from odin_tpu_torch.ops.logmel import kernel_route, kernel_tables
from odin_tpu_torch.serving import export_fn, load_fn
from odin_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
# the modules (``odin_tpu_torch.ops`` names their wrappers alike)
k1 = importlib.import_module("odin_tpu_torch.ops.logmel")
k2 = importlib.import_module("odin_tpu_torch.ops.flash_attention")

ROOT = pathlib.Path(__file__).resolve().parent.parent
MSPEC_ATOL = 0.01
ATOL = 2e-5
GRAD_ATOL = 1e-4
# one config for each K1 kernel: the FFT (512), the mixed radix (Whisper's
# 400) and the dense DFT (551 at 22,050 Hz)
CONFIGS = {512: dict(), 400: dict(n_fft=400, n_mels=80, fmin=0.0),
           551: dict(sr=22050, frame_length=551, step_length=220, n_fft=551,
                     n_mels=80, fmin=0.0)}
BATCHES = (1, 2, 5)


def _audio(seed, b, n=4000):
  return (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32)


def _targets(blob):
  ep = torch.export.load(io.BytesIO(blob))
  return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"
          and str(n.target).startswith("odin_tpu_torch.")]


def _in_interpret_mode(fn, *args):
  """``jax.jit(fn)(*args)`` with the Pallas kernels in interpret mode, to
  the host.  One executable: dispatching JAX's ops one by one while the
  interpreted kernel's callbacks dispatch their own can deadlock JAX's CPU
  client under load."""
  with pltpu.force_tpu_interpret_mode():
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(fn)(*map(jnp.asarray, args)))


def _jax_mspec(y, jcfg):
  return _in_interpret_mode(
      lambda a: jf.speech_features(a, jcfg, use_pallas=True)["mspec"], y)


@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_exported_k1_matches_jax(n_fft):
  """One batch-polymorphic program over K1 at batches 1, 2 and 5, and a
  static one, against JAX's live ``use_pallas=True`` call."""
  cfg, jcfg = tf.FeatureConfig(**CONFIGS[n_fft]), jf.FeatureConfig(
      **CONFIGS[n_fft])
  y = _audio(n_fft, max(BATCHES))
  fn = lambda a: tf.speech_features(a, cfg, device="cpu")["mspec"]
  poly = export_fn(fn, (torch.from_numpy(y[:2]),))
  static = export_fn(fn, (torch.from_numpy(y[:2]),), batch_polymorphic=False)
  for blob in (poly, static):
    assert _targets(blob) == ["odin_tpu_torch.logmel.default"]
  program = load_fn(poly, device="cpu")
  for b in BATCHES:
    want = _jax_mspec(y[:b], jcfg)
    got = program(y[:b]).numpy()
    assert got.shape == want.shape == (b, cfg.n_frames(4000), cfg.n_mels)
    np.testing.assert_allclose(got, want, atol=MSPEC_ATOL)
  np.testing.assert_allclose(load_fn(static, device="cpu")(y[:2]).numpy(),
                             _jax_mspec(y[:2], jcfg), atol=MSPEC_ATOL)


@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_exported_k1_carries_its_kernels_tables(n_fft):
  """The program holds the routed kernel's tables as constants, equal to
  those the live call gives the kernel, and the config's cache holds no
  fake tensor after the export."""
  from torch._subclasses.fake_tensor import FakeTensor
  cfg = tf.FeatureConfig(**CONFIGS[n_fft])
  y = torch.from_numpy(_audio(1, 2))
  blob = export_fn(lambda a: tf.speech_features(a, cfg, device="cpu")[
      "mspec"], (y,))
  bases = cfg.device_bases("cpu")
  assert not any(isinstance(t, FakeTensor) for t in bases.values())
  tables = kernel_tables(kernel_route(n_fft), bases, n_fft)
  ep = torch.export.load(io.BytesIO(blob))
  node, = [n for n in ep.graph.nodes if n.op == "call_function" and
           str(n.target) == "odin_tpu_torch.logmel.default"]
  consts = {**ep.constants, **ep.state_dict}
  names = {s.arg.name: s.target for s in ep.graph_signature.input_specs}
  carried = [consts[names[a.name]] for a in node.args[4:7]]
  for got, want in zip(carried, tables):
    assert got.dtype == want.dtype and torch.equal(got, want)
  assert node.args[7:] == (n_fft, float(cfg.scale ** 2))


def _mha_pair(inputs):
  jm = ja.MultiHeadAttention(num_heads=4, flash=True)
  params = _in_interpret_mode(
      lambda *a: jm.init(jax.random.PRNGKey(0), *a)["params"], *inputs)
  tm = ta.MultiHeadAttention(num_heads=4, flash=True)
  tm.build(inputs[0].shape[1:], device="cpu")
  tm.load_state_dict(from_jax_params(params), strict=True)
  return jm, params, tm


def test_exported_mha_matches_jax():
  """``MultiHeadAttention(flash=True)`` exported batch-polymorphic and
  static, against JAX's module with the Pallas kernel in interpret mode."""
  x = np.random.RandomState(0).randn(5, 24, 32).astype(np.float32)
  jm, params, tm = _mha_pair((x[:2],))
  apply = lambda a: jm.apply({"params": params}, a)
  poly = export_fn(tm, (torch.from_numpy(x[:2]),))
  static = export_fn(tm, (torch.from_numpy(x[:2]),), batch_polymorphic=False)
  for blob in (poly, static):
    assert _targets(blob) == ["odin_tpu_torch.flash_attention.default"]
  program = load_fn(poly, device="cpu")
  for b in BATCHES:
    want = _in_interpret_mode(apply, x[:b])
    with torch.no_grad():
      got = program(x[:b]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
  with torch.no_grad():
    got = load_fn(static, device="cpu")(x[:2]).numpy()
  np.testing.assert_allclose(got, _in_interpret_mode(apply, x[:2]),
                             atol=ATOL)


def test_k2_gradient_through_the_operator_matches_jax():
  """The gradients of q, k and v through the operator (called directly,
  and through a loaded program of the function) against JAX's ``_bwd``."""
  rs = np.random.RandomState(3)
  q, k, v = (rs.randn(2, 2, 40, 16).astype(np.float32) * 0.5
             for _ in range(3))
  w = rs.randn(2, 2, 40, 16).astype(np.float32)

  def loss(q_, k_, v_):
    return jnp.sum(jpa.flash_attention(q_, k_, v_, None, True) * w)

  want = _in_interpret_mode(jax.grad(loss, argnums=(0, 1, 2)), q, k, v)
  fn = lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=True)
  program = torch.export.load(io.BytesIO(export_fn(
      fn, tuple(map(torch.from_numpy, (q, k, v))), poly_args=(0, 1, 2))
  )).module()
  direct = lambda q_, k_, v_: torch.ops.odin_tpu_torch.flash_attention(
      q_, k_, v_, 0.25, True)
  for call in (direct, program):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (call(*t) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip(t, want):
      np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                 atol=GRAD_ATOL)


def test_k1_gradient_is_the_plain_versions():
  """K1's gradient with respect to the frames is the plain version's."""
  from odin_tpu_torch.ops.logmel import logmel, logmel_reference
  cfg = tf.FeatureConfig()
  bases = cfg.device_bases("cpu")
  frames = torch.from_numpy((np.random.RandomState(4).randn(
      3, 7, 400) * 0.1).astype(np.float32) * cfg.window_fn)
  w = torch.randn(3, 7, 40, generator=torch.Generator().manual_seed(0))
  grads = []
  for fn in (lambda f: logmel(f, cfg),
             lambda f: logmel_reference(f, bases["cos"], bases["sin"],
                                        bases["mel_t"], cfg.scale ** 2)):
    f = frames.clone().requires_grad_()
    (fn(f) * w).sum().backward()
    grads.append(f.grad)
  torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_opcheck_passes_on_both_operators():
  """Schema, fake tensors (also at a symbolic batch), autograd
  registration and the AOT dispatch of each operator."""
  cfg = tf.FeatureConfig(n_fft=400, n_mels=80, fmin=0.0)
  bases = cfg.device_bases("cpu")
  frames = (torch.randn(2, 5, 400, generator=torch.Generator().manual_seed(
      0)) * 0.1 * bases["window"]).requires_grad_()
  args = (frames, bases["cos"], bases["sin"], bases["mel_t"],
          *kernel_tables("mixed", bases, 400), 400, float(cfg.scale ** 2))
  result = torch.library.opcheck(torch.ops.odin_tpu_torch.logmel.default,
                                 args)
  assert set(result.values()) == {"SUCCESS"}, result
  gen = torch.Generator().manual_seed(1)
  q, k, v = (torch.randn(2, 2, 9, 8, generator=gen).requires_grad_()
             for _ in range(3))
  for causal in (False, True):
    result = torch.library.opcheck(
        torch.ops.odin_tpu_torch.flash_attention.default,
        (q, k, v, 0.3, causal))
    assert set(result.values()) == {"SUCCESS"}, result


def _k1_call(n_fft):
  """(frames, bases, the routed kernel's tables) of CONFIGS[n_fft]."""
  cfg = tf.FeatureConfig(**CONFIGS[n_fft])
  bases = cfg.device_bases("cpu")
  frames = torch.zeros(3, cfg.frame_length)
  return frames, bases, kernel_tables(kernel_route(n_fft), bases, n_fft)


@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_k1_tables_check_passes_the_kernels_own(n_fft):
  """``check_tables`` takes what ``kernel_tables`` gives for each route,
  and keeps them as checked."""
  frames, bases, tables = _k1_call(n_fft)
  for _ in range(2):
    k1.check_tables(kernel_route(n_fft), frames, bases["mel_t"], *tables,
                    n_fft)
  hit = k1._CHECKED[id(tables[2])]
  assert hit[:4] == (tables[2], tables[0], tables[1], bases["mel_t"])


def _swap(tables, i, t):
  return tables[:i] + (t,) + tables[i + 1:]


@pytest.mark.parametrize("case", [
    "another route's tables", "another config's bands", "a band past the "
    "weights", "a band past the bins", "tables on another device",
    "float64 weights", "empty tables", "an edited band"])
def test_k1_cuda_implementation_refuses_tables_that_do_not_fit(case):
  """The operator's CUDA implementation raises ValueError, before any
  launch, on tables that do not fit its route and config: the kernels read
  them by raw pointer, so such tables, from a caller or a saved program,
  would be read out of bounds."""
  frames, bases, tables = _k1_call(512)
  if case == "another route's tables":
    tables = _k1_call(400)[2]
  elif case == "another config's bands":
    other = tf.FeatureConfig(n_mels=80).device_bases("cpu")
    tables = _swap(tables, 2, k1.fft_operands(other, 512)[2])
  elif case == "a band past the weights":
    bands = tables[2].clone()
    bands[-1, 2] = tables[1].numel()
    tables = _swap(tables, 2, bands)
  elif case == "a band past the bins":
    bands = tables[2].clone()
    bands[0, 1] = 512 // 2 + 2
    tables = _swap(tables, 2, bands)
  elif case == "tables on another device":
    tables = tuple(t.to("meta") for t in tables)
  elif case == "float64 weights":
    tables = _swap(tables, 1, tables[1].double())
  elif case == "empty tables":
    tables = (torch.empty(0), torch.empty(0), torch.empty(0, dtype=torch.int32))
  else:
    bands = tables[2].clone()
    k1.check_tables("fft", frames, bases["mel_t"], *tables[:2], bands, 512)
    bands[3, 2] = -1
    tables = _swap(tables, 2, bands)
  before = k1.logmel.launches
  with pytest.raises(ValueError, match="logmel's fft kernel"):
    k1._logmel_cuda(frames, bases["cos"], bases["sin"], bases["mel_t"],
                    *tables, 512, 1.0)
  assert k1.logmel.launches == before


def test_k1_dense_tables_must_fit_the_frame_length():
  """The dense kernel's bases are laid out for the frame length: those of
  another frame length are refused."""
  frames, bases, tables = _k1_call(551)
  with pytest.raises(ValueError, match="logmel's dense kernel"):
    k1._logmel_cuda(frames[:, :400].contiguous(), bases["cos"], bases["sin"],
                    bases["mel_t"], *tables, 551, 1.0)


@pytest.mark.parametrize("shapes", [((1, 2, 8, 16), (1, 2, 9, 8)),
                                    ((1, 2, 8, 16), (2, 2, 9, 16)),
                                    ((2, 8, 16), (1, 2, 9, 16))])
def test_k2_cuda_implementation_refuses_inputs_that_do_not_fit(shapes):
  """The operator's CUDA implementation checks q, k and v as the public
  call does, before any launch: a program may call it directly."""
  q, k = (torch.zeros(s) for s in shapes)
  with pytest.raises(ValueError):
    k2._forward_cuda(q, k, k, 0.25, False)
  with pytest.raises(TypeError):
    k2._forward_cuda(k.double(), k.double(), k.double(), 0.25, False)


LOADER = "\n".join([
    "import sys, numpy as np, torch",
    "name, root = sys.argv[1], sys.argv[2]",
    "if sys.argv[3] == 'register':",
    "  import importlib",
    "  importlib.import_module('odin_tpu_torch.ops.' + name)",
    "program = torch.export.load(f'{root}/{name}.pt2').module()",
    "with torch.no_grad():",
    "  got = program(torch.from_numpy(np.load(f'{root}/{name}.npy')))",
    "np.save(f'{root}/{name}_got.npy', got.numpy())",
    "print(sorted(m for m in sys.modules if m.startswith('odin')))"])


@pytest.mark.parametrize("name,register", [
    ("logmel", True), ("flash_attention", True), ("logmel", False)])
def test_a_program_loads_with_torch_and_the_registering_module(
    tmp_path, name, register):
  """A fresh process that imports torch and the module that registers the
  operator runs a saved program over K1 (or K2) and gives the function's
  output; without that module, the load fails."""
  if name == "logmel":
    cfg = tf.FeatureConfig()
    fn, arg = (lambda a: tf.speech_features(a, cfg, device="cpu")["mspec"],
               _audio(7, 3))
  else:
    fn = ta.MultiHeadAttention(num_heads=2, qkv_features=16, flash=True)
    fn.build((12, 16), torch.Generator().manual_seed(0), device="cpu")
    arg = np.random.RandomState(8).randn(3, 12, 16).astype(np.float32)
  (tmp_path / f"{name}.pt2").write_bytes(export_fn(
      fn, (torch.from_numpy(arg[:2]),)))
  np.save(tmp_path / f"{name}.npy", arg)
  res = subprocess.run(
      [sys.executable, "-c", LOADER, name, str(tmp_path),
       "register" if register else "none"], capture_output=True, text=True,
      timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=tmp_path)
  if not register:
    assert res.returncode != 0 and "odin_tpu_torch" in res.stderr
    return
  assert res.returncode == 0, res.stderr
  assert "odin_tpu_torch.ops." + name in res.stdout
  assert "'odin_tpu'" not in res.stdout and "jax" not in res.stdout
  with torch.no_grad():
    want = fn(torch.from_numpy(arg)).numpy()
  np.testing.assert_allclose(np.load(tmp_path / f"{name}_got.npy"), want,
                             atol=1e-6)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_jax_cannot_export_over_its_kernels(kernel):
  """JAX's own refusals on the CPU, which the port's export does not
  share: at a symbolic batch the kernel's ``CostEstimate`` takes no symbolic
  flop count; at a static batch, in interpret mode, serialization takes no
  host callback."""
  if kernel == "K1":
    cfg = jf.FeatureConfig()
    fn = lambda a: jf.speech_features(a, cfg, use_pallas=True)["mspec"]
    arg = _audio(9, 2)
  else:
    fn = lambda a: jpa.flash_attention(a, a, a)
    arg = np.random.RandomState(9).randn(2, 2, 16, 8).astype(np.float32)
  with pytest.raises(ValueError, match="CostEstimate must be ints"):
    jax_serving.export_fn(fn, (arg,))
  with pltpu.force_tpu_interpret_mode():
    with pytest.raises(NotImplementedError, match="host_callbacks"):
      jax_serving.export_fn(fn, (arg,), batch_polymorphic=False)
