"""The port's CUDA kernels on the card against their plain PyTorch versions.

These tests need an NVIDIA card and skip elsewhere.  They import neither
JAX nor the JAX package, so they run on a machine that has only PyTorch:

  python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances: 0.01 dB
on log-mel and 2e-5 on fp32 attention, the JAX package's own
(tests/test_ops_features.py, tests/test_flash_attention.py).  bf16 and
fp16 attention: the kernel and its plain version both accumulate in fp32
and round once to the 16-bit type, so each output may differ by one
rounding; the limit is two roundings of that output, 2^-6·|plain| in bf16
and 2^-9·|plain| in fp16, beside 1e-5 for fp32 sums taken in another order.

The training step (at the end): k steps from a CUDA graph against k eager
steps with cuDNN's deterministic algorithms, which run the same kernels on
the same inputs, so bitwise; a NaN batch skipped inside the graph; the
input pipeline's copies to the card; ``Trainer.fit`` graphed against eager
steps and ``fit_device_dataset`` resumed from a checkpoint, bitwise; and a
capture that fails raises.

The corpus path: ``DeviceCorpusProcessor`` on the card against the CPU at
``pipeline_depth`` 1 and 3 and with large batches after small ones (the
limits of tests/test_torch_corpus.py), one K1 launch per batch; streaming
features and Griffin-Lim on the card against the CPU (the limits of
tests/test_torch_streaming.py and tests/test_torch_inversion.py).

The Gym: its estimators on the card against the CPU on the same latents
(the boosted trees identical, their split search summing integers) and
the whole Gym on the card against the same model on the CPU.

The VAE zoo: each class's ELBO terms on the card against the CPU from
the same params and noise (1e-4 of each term's largest magnitude), and 3
graphed steps against 3 eager ones, bitwise, for the classes whose step
moves mutables or draws from a rejection sampler.

The semi-supervised family: 4 graphed steps that cross the Semafo MI
term's gate against 4 eager ones, bitwise (semafos on dSprites, two
TrainSteps on one optimizer; SemafoVAE on the half-moons, Gumbel draws on
the card), and ConditionalM2VAE's tiling: its marginal ELBO against the
explicit sum over the classes on the card and against the CPU.

The hierarchical and grouped families: each model's ELBO terms on the
card against the CPU from the same params and noise (1e-4 of each term's
largest magnitude; the ladder rungs' and U-Net skips' draws and the
grouped pairs' too), and 3 graphed steps against 3 eager ones, bitwise:
VeryDeepVAE (a BiConv rung, its KL warm-up read from the step tensor),
UnetVAE with every skip knob on (the skip masks drawn in the graph) and
AdaptiveVAE on pairs.

Speaker recognition (``odin_tpu_torch.ml``): the GMM E-step,
``transform_batch`` and the T-matrix E-step on the card against the CPU
from the same state (fp32 sums in another order: 1e-5 of the largest
value), the E-step unchanged bitwise by the caller's TF32 and through the
streamed path; Scorer and PLDA in float64 (1e-10, 1e-8).
"""
import importlib

import numpy as np
import pytest
import torch

from odin_tpu_torch import _build
from odin_tpu_torch.bay.vi import BetaVAE
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.networks.attention import MultiHeadAttention
from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_reference)
from odin_tpu_torch.ops.logmel import (harmonic_frames, logmel,
                                       logmel_reference)
from odin_tpu_torch.training import (TrainState, TrainStep,
                                     build_train_step_fn,
                                     device_dataset_steps, make_optimizer,
                                     scan_steps)

k1 = importlib.import_module("odin_tpu_torch.ops.logmel")

MSPEC_ATOL = 0.01
ATTN_ATOL = 2e-5
ATTN_BF16_RTOL = 2 ** -6
ATTN_BF16_ATOL = 1e-5
ATTN_RTOL = {torch.bfloat16: ATTN_BF16_RTOL, torch.float16: 2 ** -9}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda", 0)


@pytest.mark.parametrize("n_frames", [1, 33, 1000])
def test_logmel_kernel_matches_plain_on_card(cuda_device, n_frames):
  cfg = tf.FeatureConfig()
  rs = np.random.RandomState(n_frames)
  frames = ((rs.randn(n_frames, cfg.frame_length) * 0.1).astype(np.float32)
            * cfg.window_fn)
  frames = torch.from_numpy(frames).to(cuda_device)
  before = logmel.launches
  got = logmel(frames, cfg)
  assert logmel.launches == before + 1
  bases = cfg.device_bases(cuda_device)
  want = logmel_reference(frames, bases["cos"], bases["sin"], bases["mel_t"],
                          cfg.scale ** 2)
  torch.cuda.synchronize()
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             atol=MSPEC_ATOL)


def test_logmel_kernel_small_config_on_card(cuda_device):
  """8 kHz framing: 200-sample frames, 129 bins, 20 mels."""
  cfg = tf.FeatureConfig(sr=8000, frame_length=200, step_length=80,
                         n_fft=256, n_mels=20)
  rs = np.random.RandomState(0)
  frames = torch.from_numpy((rs.randn(3, 70, cfg.frame_length) * 0.1).astype(
      np.float32) * cfg.window_fn).to(cuda_device)
  got = logmel(frames, cfg)
  bases = cfg.device_bases(cuda_device)
  want = logmel_reference(frames, bases["cos"], bases["sin"], bases["mel_t"],
                          cfg.scale ** 2)
  assert tuple(got.shape) == (3, 70, 20)
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             atol=MSPEC_ATOL)


def test_logmel_kernel_large_fft_on_card(cuda_device):
  """n_fft 1024 and frame_length 1024: 513 bins, the FFT kernel."""
  cfg = tf.FeatureConfig(frame_length=1024, step_length=256, n_fft=1024)
  rs = np.random.RandomState(1)
  frames = torch.from_numpy((rs.randn(2, 333, cfg.frame_length) * 0.1).astype(
      np.float32) * cfg.window_fn).to(cuda_device)
  before = logmel.launches
  got = logmel(frames, cfg)
  assert logmel.launches == before + 1
  bases = cfg.device_bases(cuda_device)
  want = logmel_reference(frames, bases["cos"], bases["sin"], bases["mel_t"],
                          cfg.scale ** 2)
  torch.cuda.synchronize()
  assert tuple(got.shape) == (2, 333, cfg.n_mels)
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             atol=MSPEC_ATOL)


def test_logmel_kernel_long_frames_on_card(cuda_device):
  """frame_length 4000 (n_fft 4096, 2049 bins, 80 mels): the FFT kernel,
  one frame a group."""
  cfg = tf.FeatureConfig(frame_length=4000, step_length=1000, n_fft=4096,
                         n_mels=80)
  rs = np.random.RandomState(2)
  frames = torch.from_numpy((rs.randn(70, cfg.frame_length) * 0.1).astype(
      np.float32) * cfg.window_fn).to(cuda_device)
  got = logmel(frames, cfg)
  bases = cfg.device_bases(cuda_device)
  want = logmel_reference(frames, bases["cos"], bases["sin"], bases["mel_t"],
                          cfg.scale ** 2)
  torch.cuda.synchronize()
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             atol=MSPEC_ATOL)


def _frames(kind, n, cfg, device):
  """White noise (about equal power in every bin) or harmonic frames
  (about 80 dB across the mel bands), windowed, fp32, from a seed."""
  if kind == "harmonic":
    return harmonic_frames(n, cfg, seed=n, device=device)
  rs = np.random.RandomState(n)
  return torch.from_numpy((rs.randn(n, cfg.frame_length) * 0.1).astype(
      np.float32) * cfg.window_fn).to(device)


def _counts():
  return (logmel.launches, logmel.fft_launches, logmel.mixed_launches)


def _held_to_plain(frames, cfg, device):
  """(launches, FFT launches, mixed-radix launches) of one `logmel` call,
  held to the plain version at 0.01 dB."""
  bases = cfg.device_bases(device)
  before = _counts()
  got = logmel(frames, cfg)
  launched = tuple(a - b for a, b in zip(_counts(), before))
  want = logmel_reference(frames, bases["cos"], bases["sin"], bases["mel_t"],
                          cfg.scale ** 2)
  torch.cuda.synchronize()
  assert tuple(got.shape) == (frames.shape[0], cfg.n_mels)
  assert torch.isfinite(got).all()
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             atol=MSPEC_ATOL)
  return launched


@pytest.mark.parametrize("n_frames", [1, 31, 1000, 25472])
@pytest.mark.parametrize("kind", ["noise", "harmonic"])
@pytest.mark.parametrize("frame_length,n_fft", [(400, 512), (201, 256),
                                                (1024, 1024), (1600, 2048),
                                                (400, 256)])
def test_logmel_fft_kernel_matches_plain_on_card(cuda_device, frame_length,
                                                 n_fft, kind, n_frames):
  """The FFT kernel: frames shorter than n_fft (padded), as long, and
  longer (folded), groups of frames with a ragged last one."""
  cfg = tf.FeatureConfig(frame_length=frame_length,
                         step_length=frame_length // 4, n_fft=n_fft)
  frames = _frames(kind, n_frames, cfg, cuda_device)
  assert _held_to_plain(frames, cfg, cuda_device) == (1, 1, 0)


@pytest.mark.parametrize("n_frames", [1, 31, 1000, 25472])
@pytest.mark.parametrize("kind", ["noise", "harmonic"])
@pytest.mark.parametrize("sr,frame_length,n_fft,n_mels", [
    (16000, 400, 400, 80), (16000, 480, 480, 40), (48000, 1200, 1200, 40),
    (44100, 882, 882, 40), (16000, 1000, 400, 40), (16000, 300, 400, 40)])
def test_logmel_mixed_kernel_matches_plain_on_card(cuda_device, sr,
                                                   frame_length, n_fft,
                                                   n_mels, kind, n_frames):
  """The mixed-radix kernel: Whisper's framing (n_fft 400, 80 mels from
  0 Hz), 30 ms at 16 kHz, 25 ms at 48 kHz, 20 ms at 44.1 kHz (odd M, no
  middle bin), frames longer than n_fft (folded) and shorter (padded),
  groups of frames with a ragged last one."""
  cfg = tf.FeatureConfig(sr=sr, frame_length=frame_length,
                         step_length=frame_length // 4, n_fft=n_fft,
                         n_mels=n_mels, fmin=0.0)
  frames = _frames(kind, n_frames, cfg, cuda_device)
  assert _held_to_plain(frames, cfg, cuda_device) == (1, 0, 1)


@pytest.mark.parametrize("kind", ["noise", "harmonic"])
@pytest.mark.parametrize("sr,frame_length,n_fft,n_mels", [
    (22050, 551, 551, 80), (22050, 1102, 1102, 40), (16000, 4004, 4004, 80)])
def test_logmel_dense_kernel_for_other_n_fft_on_card(cuda_device, sr,
                                                     frame_length, n_fft,
                                                     n_mels, kind):
  """n_fft that neither FFT kernel takes launches the dense-DFT kernel:
  one group of bins (551, odd: 25 ms at 22,050 Hz), two (1102: half of it
  is 19·29), and frames in segments with seven groups (4004: half of it
  has the factors 11 and 13)."""
  cfg = tf.FeatureConfig(sr=sr, frame_length=frame_length,
                         step_length=frame_length // 4, n_fft=n_fft,
                         n_mels=n_mels)
  frames = _frames(kind, 333, cfg, cuda_device)
  assert _held_to_plain(frames, cfg, cuda_device) == (1, 0, 0)


def test_logmel_mixed_kernel_back_to_back_on_card(cuda_device):
  """Launches of the mixed-radix kernel queued back to back, at several
  framings and ragged frame counts, each held to the plain version after
  one synchronisation: groups staged while others are transformed, and
  blocks of one launch beside those of the next."""
  rs = np.random.RandomState(5)
  cases = []
  for sr, frame_length, n_fft in ((16000, 400, 400), (44100, 882, 882),
                                  (48000, 1200, 1200), (16000, 1000, 400)):
    cfg = tf.FeatureConfig(sr=sr, frame_length=frame_length,
                           step_length=frame_length // 4, n_fft=n_fft,
                           n_mels=40, fmin=0.0)
    for n in rs.randint(1, 3000, size=12):
      cases.append((cfg, _frames("noise", int(n), cfg, cuda_device)))
  before = _counts()
  outs = [logmel(frames, cfg) for cfg, frames in cases]
  torch.cuda.synchronize()
  assert tuple(a - b for a, b in zip(_counts(), before)) == (
      len(cases), 0, len(cases))
  for (cfg, frames), got in zip(cases, outs):
    bases = cfg.device_bases(cuda_device)
    want = logmel_reference(frames, bases["cos"], bases["sin"],
                            bases["mel_t"], cfg.scale ** 2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=MSPEC_ATOL)


def test_logmel_mixed_kernel_does_not_fall_back_on_card(cuda_device,
                                                        monkeypatch):
  """Where the mixed-radix library fails to load, `logmel` raises: it
  launches neither the dense kernel nor the plain version instead."""
  cfg = tf.FeatureConfig(n_fft=400, n_mels=80, fmin=0.0)
  frames = _frames("noise", 100, cfg, cuda_device)
  load, used = _build.load, []

  def failing_load(name):
    if name == "logmel_fft_mixed":
      raise RuntimeError("nvcc failed on logmel_fft_mixed.cu")
    return load(name)

  def recorded(name):
    def fn(*args, **kwargs):
      used.append(name)
      raise AssertionError(f"{name} was called")
    return fn

  monkeypatch.setattr(_build, "load", failing_load)
  monkeypatch.setattr(k1, "_library", recorded("the dense kernel"))
  monkeypatch.setattr(k1, "logmel_reference", recorded("the plain version"))
  before = _counts()
  with pytest.raises(RuntimeError, match="logmel_fft_mixed"):
    logmel(frames, cfg)
  assert _counts() == before and used == []


def test_whisper_speech_features_on_card_launch_the_mixed_kernel(
    cuda_device):
  rs = np.random.RandomState(10)
  y = (rs.randn(3, 16000) * 0.1 * 32768.0).clip(-32768, 32767).astype(
      np.int16)
  lengths = np.array([16000, 12000, 500])
  cfg = tf.FeatureConfig(n_fft=400, n_mels=80, fmin=0.0)
  before = _counts()
  got = tf.speech_features(y, cfg, lengths=lengths, device=cuda_device)
  assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 1)
  want = tf.speech_features(y, cfg, lengths=lengths, device="cpu")
  np.testing.assert_allclose(got["mspec"].cpu().numpy(),
                             want["mspec"].numpy(), atol=MSPEC_ATOL)


def test_speech_features_on_card_matches_cpu(cuda_device):
  rs = np.random.RandomState(9)
  y = (rs.randn(4, 16000) * 0.1 * 32768.0).clip(-32768, 32767).astype(
      np.int16)
  lengths = np.array([16000, 15000, 9000, 401])
  cfg = tf.FeatureConfig()
  before = (logmel.launches, logmel.fft_launches)
  got = tf.speech_features(y, cfg, lengths=lengths, device=cuda_device)
  assert (logmel.launches, logmel.fft_launches) == (before[0] + 1,
                                                    before[1] + 1)
  want = tf.speech_features(y, cfg, lengths=lengths, device="cpu")
  assert got["mspec"].device.type == "cuda"
  np.testing.assert_allclose(got["mspec"].cpu().numpy(),
                             want["mspec"].numpy(), atol=MSPEC_ATOL)
  np.testing.assert_array_equal(got["frame_mask"].cpu().numpy(),
                                want["frame_mask"].numpy())


def _qkv(device, b, h, tq, tk, d, dtype=torch.float32, seed=0):
  g = torch.Generator(device=device).manual_seed(seed)
  return tuple((torch.randn(b, h, t, d, device=device, generator=g) * 0.5
                ).to(dtype) for t in (tq, tk, tk))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 256, 256, 64), (1, 2, 200, 200, 32),
                                   (1, 1, 130, 300, 16), (1, 2, 77, 45, 100),
                                   (1, 1, 1, 1, 1), (2, 1, 65, 129, 128)])
def test_flash_kernel_matches_plain_on_card(cuda_device, shape, causal):
  """f32, causal and ragged: Tq != Tk, neither a tile multiple, any D."""
  q, k, v = _qkv(cuda_device, *shape)
  scale = shape[-1] ** -0.5
  before = flash_attention.launches
  got = flash_attention(q, k, v, causal=causal)
  assert flash_attention.launches == before + 1
  want = flash_attention_reference(q, k, v, scale, causal)
  torch.cuda.synchronize()
  assert got.dtype == torch.float32 and got.shape == q.shape
  assert torch.isfinite(got).all()
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_bf16_on_card(cuda_device, causal):
  q, k, v = _qkv(cuda_device, 2, 4, 300, 200, 64, torch.bfloat16)
  got = flash_attention(q, k, v, causal=causal)
  want = flash_attention_reference(q, k, v, 64 ** -0.5, causal)
  torch.cuda.synchronize()
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().cpu().numpy(),
                             want.float().cpu().numpy(), rtol=ATTN_BF16_RTOL,
                             atol=ATTN_BF16_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256, 72, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_mma_kernel_matches_plain_on_card(cuda_device, dtype, d,
                                                causal):
  """The tensor-core kernel at each of its widths (64, 128, 256) and at
  ragged D (72: cp.async's zero fill; 100: not a multiple of 8, plain
  loads), with Tq != Tk, neither a tile multiple."""
  q, k, v = _qkv(cuda_device, 2, 3, 150, 97, d, dtype, seed=d)
  before = (flash_attention.launches, flash_attention.mma_launches)
  got = flash_attention(q, k, v, causal=causal)
  assert (flash_attention.launches, flash_attention.mma_launches) == (
      before[0] + 1, before[1] + 1)
  want = flash_attention_reference(q, k, v, d ** -0.5, causal)
  torch.cuda.synchronize()
  assert got.dtype == dtype and got.shape == q.shape
  np.testing.assert_allclose(got.float().cpu().numpy(),
                             want.float().cpu().numpy(),
                             rtol=ATTN_RTOL[dtype], atol=ATTN_BF16_ATOL)


@pytest.mark.parametrize("dtype,d,launches", [
    (torch.float32, 256, 2), (torch.float32, 200, 2),
    (torch.bfloat16, 320, 2), (torch.float16, 600, 3)])
def test_flash_kernel_head_dims_above_a_launch_on_card(cuda_device, dtype, d,
                                                       launches):
  """Above a launch's width (128 fp32, 256 16-bit) the forward launches
  once per chunk of V's and O's columns."""
  for causal in (False, True):
    q, k, v = _qkv(cuda_device, 1, 2, 130, 70, d, dtype, seed=d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + launches
    want = flash_attention_reference(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
      np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                 atol=ATTN_ATOL)
    else:
      np.testing.assert_allclose(got.float().cpu().numpy(),
                                 want.float().cpu().numpy(),
                                 rtol=ATTN_RTOL[dtype], atol=ATTN_BF16_ATOL)


@pytest.mark.parametrize("sm_scale", [-0.3, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_sm_scale_sign_on_card(cuda_device, dtype, sm_scale):
  """A negative or zero sm_scale, causal: the 16-bit kernel takes the
  scale's sign onto Q and a zero scale as the least normal float."""
  q, k, v = _qkv(cuda_device, 1, 2, 90, 130, 64, dtype, seed=7)
  got = flash_attention(q, k, v, sm_scale=sm_scale, causal=True)
  want = flash_attention_reference(q, k, v, sm_scale, True)
  torch.cuda.synchronize()
  rtol = ATTN_RTOL.get(dtype, 0.0)
  atol = ATTN_ATOL if dtype == torch.float32 else ATTN_BF16_ATOL
  np.testing.assert_allclose(got.float().cpu().numpy(),
                             want.float().cpu().numpy(), rtol=rtol, atol=atol)


def test_flash_kernel_runs_for_a_cuda_tensor(cuda_device):
  """A CUDA tensor launches the kernel (the count rises), never the plain
  version; the gradient recomputes plain attention and launches nothing."""
  q, k, v = (t.requires_grad_() for t in _qkv(cuda_device, 1, 2, 70, 70, 32))
  before = flash_attention.launches
  out = flash_attention(q, k, v, causal=True)
  assert flash_attention.launches == before + 1
  out.sum().backward()
  assert flash_attention.launches == before + 1
  assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_flash_mha_on_card_matches_plain_and_cpu(cuda_device):
  g = torch.Generator().manual_seed(0)
  plain = MultiHeadAttention(num_heads=4, flash=False)
  plain.build((96, 64), g, device="cpu")
  flash = MultiHeadAttention(num_heads=4, flash=True)
  flash.build((96, 64), device=cuda_device)
  flash.load_state_dict(plain.state_dict())
  x = torch.randn(2, 96, 64, generator=g)
  with torch.no_grad():
    want = plain(x)
    plain.to(cuda_device)
    before = flash_attention.launches
    got = flash(x.to(cuda_device))
    assert flash_attention.launches == before + 1
    on_card = plain(x.to(cuda_device))
  np.testing.assert_allclose(got.cpu().numpy(), on_card.cpu().numpy(),
                             atol=ATTN_ATOL)
  np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


# -- the training step ------------------------------------------------------
def _train_setup(device, **kwargs):
  vae = BetaVAE(beta=1.0, **get_networks("dsprites", zdim=10)).build(
      seed=1, device=device)
  return vae, vae.make_step_fn(learning_rate=1e-3, **kwargs)


def _train_inputs(device, k, b):
  gen = torch.Generator(device=device).manual_seed(0)
  x = (torch.rand(k, b, 64, 64, 1, generator=gen, device=device) < 0.5
       ).float()
  return x, torch.randn(k, b, 10, generator=gen, device=device)


def test_graphed_steps_equal_eager_on_card(cuda_device):
  """With cuDNN's deterministic algorithms the CUDA graph runs the eager
  step's kernels on the same inputs: the params are equal bitwise.  A
  state returned by one call keeps its values through the next call."""
  torch.backends.cudnn.allow_tf32 = False
  vae, step = _train_setup(cuda_device)
  x, eps = _train_inputs(cuda_device, 4, 16)
  torch.backends.cudnn.deterministic = True
  try:
    s = vae.state
    for i in range(4):
      s, m = step(s, x[i], eps=eps[i])
    fused = scan_steps(step, 4)
    g, gm = fused(vae.state, x, eps=eps)
    torch.cuda.synchronize()
    for k, v in s.params["vae"].items():
      assert torch.equal(g.params["vae"][k], v), k
    assert float(gm["loss"]) == float(m["loss"])
    g2, _ = fused(g, x, eps=eps)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  assert fused.capture_seconds is not None
  assert int(g.step) == 4 and int(g2.step) == 8
  assert int(g2.opt_states["vae"]["count"]) == 8
  for k, v in s.params["vae"].items():
    assert torch.equal(g.params["vae"][k], v), k


def test_device_dataset_graph_equals_eager_on_card(cuda_device):
  torch.backends.cudnn.allow_tf32 = False
  vae, step = _train_setup(cuda_device)
  corpus = (torch.rand(100, 64, 64, 1, device=cuda_device) < 0.3).to(
      torch.uint8) * 255
  idx = torch.randint(0, 100, (3, 16), device=cuda_device)
  _, eps = _train_inputs(cuda_device, 3, 16)
  torch.backends.cudnn.deterministic = True
  try:
    outs = [device_dataset_steps(step, 16, 3, graph=graph)(
        vae.state, corpus, indices=idx, eps=eps) for graph in (False, True)]
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  (s_e, m_e), (s_g, m_g) = outs
  for k, v in s_e.params["vae"].items():
    assert torch.equal(s_g.params["vae"][k], v), k
  assert float(m_g["loss"]) == float(m_e["loss"])
  # drawn on the card: finite and counted
  s, m = device_dataset_steps(step, 16, 3)(vae.state, corpus)
  assert int(s.step) == 3 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("policy", ["skip", "stop"])
def test_nan_skip_graphed_on_card(cuda_device, policy):
  """Two batches holding a NaN through the graph: params and moments
  bitwise unchanged, both updates counted as skipped."""
  vae, step = _train_setup(cuda_device, nan_policy=policy)
  x, _ = _train_inputs(cuda_device, 2, 8)
  x[:, 0, 0, 0, 0] = float("nan")
  s0 = vae.state
  s, m = scan_steps(step, 2)(s0, x)
  torch.cuda.synchronize()
  assert int(s.skipped_updates) == 2 and int(s.step) == 2
  assert int(s.opt_states["vae"]["count"]) == 0
  for k, v in s0.params["vae"].items():
    assert torch.equal(s.params["vae"][k], v), k
  for name in ("mu", "nu"):
    assert all(bool((t == 0).all())
               for t in s.opt_states["vae"][name]["vae"].values())
  assert ("nan_gradients" in m) == (policy == "stop")
  if policy == "stop":
    assert float(m["nan_gradients"]) == 1.0


def test_training_state_stays_on_card(cuda_device):
  vae, step = _train_setup(cuda_device)
  s, m = step(vae.state, np.zeros((4, 64, 64, 1), np.float32))
  tensors = [s.step, s.skipped_updates, *s.params["vae"].values(),
             *s.opt_states["vae"]["mu"]["vae"].values(), *m.values()]
  assert all(t.device.type == "cuda" for t in tensors)


def test_pipeline_prefetch_to_card_equals_cpu(cuda_device):
  """Batches copied by the pipeline's thread (pinned, on a side stream)
  equal the host batches, in order, also when the step runs meanwhile."""
  from odin_tpu_torch.fuel import DataPipeline
  rs = np.random.RandomState(0)
  x = rs.rand(70, 64, 64, 1).astype(np.float32)
  y = rs.randint(0, 3, 70)
  kw = dict(batch_size=16, shuffle=True, epochs=3, seed=4, prefetch=3)
  want = list(DataPipeline((x, y), **kw))
  got = []
  for b in DataPipeline((x, y), to_device=cuda_device, **kw):
    assert all(t.device.type == "cuda" for t in b)
    torch.matmul(torch.ones(512, 512, device=cuda_device),
                 torch.ones(512, 512, device=cuda_device))
    got.append([t.cpu().numpy() for t in b])
  assert len(got) == len(want)
  for g, w in zip(got, want):
    for a, b in zip(g, w):
      np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 3])
def test_graphed_fit_equals_eager_on_card(cuda_device, k):
  """``Trainer.fit`` (a CUDA graph of one step, replayed k times a call)
  against the same steps called eagerly, cuDNN deterministic: bitwise."""
  from odin_tpu_torch.training import Trainer
  torch.backends.cudnn.allow_tf32 = False
  vae, step = _train_setup(cuda_device)
  x, _ = _train_inputs(cuda_device, 6, 16)
  batches = [x[i].cpu().numpy() for i in range(6)]
  torch.backends.cudnn.deterministic = True
  try:
    rng = vae.state.rng.get_state()
    s = vae.state
    for b in batches:
      s, m = step(s, b)
    torch.cuda.synchronize()
    vae.state.rng.set_state(rng)
    g = Trainer().fit(iter(batches), step, vae.state, steps_per_call=k,
                      verbose=False)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  assert int(g.step) == 6
  for key, v in s.params["vae"].items():
    assert torch.equal(g.params["vae"][key], v), key


def test_fit_device_dataset_resumes_on_card(cuda_device, tmp_path):
  """2 x 3 steps split by a checkpoint equal 6 unbroken, bitwise (cuDNN
  deterministic): the draws are keyed by the step count, the noise
  generator's state travels in the checkpoint."""
  torch.backends.cudnn.allow_tf32 = False
  corpus = (np.random.RandomState(1).rand(50, 64, 64, 1) < 0.3).astype(
      np.uint8) * 255
  kw = dict(batch_size=16, steps_per_call=3, seed=2, verbose=False)

  def model():
    return BetaVAE(beta=1.0, **get_networks("dsprites", zdim=10)).build(
        seed=1, device=cuda_device)

  torch.backends.cudnn.deterministic = True
  try:
    whole = model().fit_device_dataset(corpus, n_steps=6, **kw)
    path = str(tmp_path / "ckpt")
    model().fit_device_dataset(corpus, n_steps=3, checkpoint_path=path,
                               checkpoint_freq=3, **kw)
    resumed = model().load_weights(path)
    resumed.fit_device_dataset(corpus, n_steps=3, keep_opt_states=True, **kw)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  assert int(resumed.state.step) == 6
  for key, v in whole.state.params["vae"].items():
    assert torch.equal(resumed.state.params["vae"][key], v), key
  assert torch.equal(resumed.state.rng.get_state(),
                     whole.state.rng.get_state())


def _corpus_files(root, lengths, seed=0):
  """Int16 wav files of the synthetic speaker corpus cut to `lengths`."""
  from odin_tpu_torch.fuel.audio_data import synth_speaker_corpus
  from odin_tpu_torch.preprocessing.speech import save_wave
  utts, _ = synth_speaker_corpus(1, len(lengths), seed=seed,
                                 dur=max(lengths) / 16000)
  return [save_wave(str(root / f"u{i:03d}.wav"), u[:n], 16000)
          for i, (u, n) in enumerate(zip(utts, lengths))]


def _stores_agree(card, cpu):
  """The card's store against the CPU's: the indices equal, mspec within
  0.01 dB, mfcc_cmvn within 5e-3 (tests/test_preprocessing.py:382), the
  VAD equal on 99.9 % of the frames."""
  assert sorted(card["indices_mspec"]) == sorted(cpu["indices_mspec"])
  for feat in ("mspec", "mfcc_cmvn", "vad"):
    for name in cpu[f"indices_{feat}"]:
      assert card[f"indices_{feat}"][name] == cpu[f"indices_{feat}"][name]
  np.testing.assert_allclose(np.asarray(card["mspec"][:]),
                             np.asarray(cpu["mspec"][:]), rtol=0,
                             atol=MSPEC_ATOL)
  np.testing.assert_allclose(np.asarray(card["mfcc_cmvn"][:]),
                             np.asarray(cpu["mfcc_cmvn"][:]), rtol=5e-3,
                             atol=5e-3)
  vad_card, vad_cpu = np.asarray(card["vad"][:]), np.asarray(cpu["vad"][:])
  assert (vad_card == vad_cpu).mean() >= 0.999


@pytest.mark.parametrize("depth", [1, 3])
def test_corpus_processor_on_card_matches_cpu(cuda_device, tmp_path, depth):
  """One K1 launch per batch; the card's store equals the CPU's."""
  from odin_tpu_torch.preprocessing import DeviceCorpusProcessor
  lengths = np.random.RandomState(depth).randint(8000, 48001, 22)
  files = _corpus_files(tmp_path, lengths)
  kw = dict(batch_size=8, pipeline_depth=depth)
  before = _counts()
  card = DeviceCorpusProcessor(files, str(tmp_path / "card"),
                               device=cuda_device, **kw).run()
  launched = tuple(a - b for a, b in zip(_counts(), before))
  assert launched == (3, 3, 0)  # 22 files in batches of 8: the FFT kernel
  cpu = DeviceCorpusProcessor(files, str(tmp_path / "cpu"), device="cpu",
                              **kw).run()
  _stores_agree(card, cpu)
  assert card.attrs["phase_sec"]["device_wait"] >= 0.0


def test_corpus_processor_large_batch_after_small_on_card(cuda_device,
                                                          tmp_path):
  """Batches of 0.25 s, then 6 s, then 0.25 s and 6 s again, three in
  flight: a pinned buffer reused, or a result read, before its batch's
  event has fired would show as a store that differs from the CPU's."""
  from odin_tpu_torch.preprocessing import DeviceCorpusProcessor
  lengths = np.concatenate([np.full(4, 4000), np.full(4, 96000),
                            np.full(4, 4000), np.full(4, 96000),
                            np.full(3, 4000)])
  lengths = lengths - np.arange(len(lengths)) * 7
  files = _corpus_files(tmp_path, lengths, seed=4)
  kw = dict(batch_size=4, pipeline_depth=3)
  card = DeviceCorpusProcessor(files, str(tmp_path / "card"),
                               device=cuda_device, **kw).run()
  cpu = DeviceCorpusProcessor(files, str(tmp_path / "cpu"), device="cpu",
                              **kw).run()
  _stores_agree(card, cpu)
  f16 = DeviceCorpusProcessor(files, str(tmp_path / "f16"),
                              device=cuda_device, transfer_dtype="float16",
                              **kw).run()
  np.testing.assert_allclose(np.asarray(f16["mspec"][:]),
                             np.asarray(card["mspec"][:]), rtol=2e-3,
                             atol=2e-2)


def test_streaming_on_card_matches_cpu(cuda_device):
  from odin_tpu_torch.ops import streaming_features as ts
  cfg = tf.FeatureConfig()
  y = (np.random.RandomState(2).randn(3, 16000) * 0.1).astype(np.float32)
  fins = []
  for device in (cuda_device, "cpu"):
    state = ts.streaming_init(cfg, 3, device=device)
    outs = []
    for k in range(10):
      state, o = ts.streaming_step(cfg, state, y[:, 1600 * k:1600 * (k + 1)])
      outs.append(o)
    fins.append({k: v.cpu().numpy()
                 for k, v in ts.streaming_finalize(cfg, state, outs).items()})
  card, cpu = fins
  np.testing.assert_array_equal(card["frame_mask"], cpu["frame_mask"])
  np.testing.assert_array_equal(card["vad"], cpu["vad"])
  m = cpu["frame_mask"]
  for key, atol in (("spec", 1e-5), ("mspec", 1e-4), ("mfcc", 1e-4),
                    ("mspec_cmvn", 1e-3), ("mfcc_cmvn", 1e-3)):
    np.testing.assert_allclose(card[key][m], cpu[key][m], rtol=1e-4,
                               atol=atol, err_msg=key)


def test_griffin_lim_on_card_matches_cpu(cuda_device):
  from odin_tpu_torch.ops import inversion as ti
  t = np.arange(8192) / 8000.0
  y = np.stack([np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 330 * t)])
  re, im = ti.stft_device(y.astype("f") * 0.3, 256, 64, device="cpu")
  mag = torch.sqrt(re ** 2 + im ** 2)
  phase = torch.rand(mag.shape, generator=torch.Generator().manual_seed(0))
  phase = phase * (2 * np.pi)
  card = ti.griffin_lim_device(mag, 256, 64, 32, init_phase=phase,
                               device=cuda_device)
  cpu = ti.griffin_lim_device(mag, 256, 64, 32, init_phase=phase,
                              device="cpu")
  assert card.device.type == "cuda"
  np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                             atol=1e-3)


# -- the Gym's estimators and the Gym on the card --------------------------
def _gym_data(n=1200, d=6, seed=0):
  """Latents that mix dSprites-like factors (3, 6, 40, 32, 32 values)."""
  rng = np.random.RandomState(seed)
  sizes = (3, 6, 40, 32, 32)
  f = np.stack([rng.randint(0, k, n) for k in sizes], 1)
  mix = rng.rand(len(sizes), d) + np.eye(len(sizes), d)
  z = (f / (np.array(sizes) - 1.0)) @ mix + 0.3 * rng.randn(n, d)
  return z.astype(np.float32), f


@pytest.mark.parametrize("column", [0, 2])
def test_gradient_boosting_on_card_equals_cpu(cuda_device, column):
  """The split search sums integers, so the trees are the same on the card
  as on the CPU; importances within 1e-9 (float64 sums in another order),
  the same predictions."""
  from odin_tpu_torch.bay.vi.estimators import GradientBoostingClassifier
  z, f = _gym_data()
  fits = [GradientBoostingClassifier(n_estimators=10, random_state=1).fit(
      torch.tensor(z).to(dev), torch.tensor(f[:, column]).to(dev))
          for dev in (cuda_device, torch.device("cpu"))]
  card, cpu = fits
  for a, b in zip(card.trees_, cpu.trees_):
    for key in ("feature", "is_split"):
      np.testing.assert_array_equal(a[key].cpu().numpy(), b[key].numpy())
    np.testing.assert_array_equal(a["threshold"].cpu().numpy(),
                                  b["threshold"].numpy())
  np.testing.assert_allclose(card.feature_importances_.cpu().numpy(),
                             cpu.feature_importances_.numpy(), atol=1e-9)
  np.testing.assert_array_equal(
      card.predict(torch.tensor(z).to(cuda_device)).cpu().numpy(),
      cpu.predict(torch.tensor(z)).numpy())


def test_gym_estimators_on_card_equal_cpu(cuda_device):
  """Logistic regression and the batched SVMs in float64 (1e-9 of the
  largest coefficient), mutual information (1e-14), the bins, the
  FactorVAE votes and the split rows exactly, on the card and the CPU."""
  from odin_tpu_torch.bay.vi import downstream_metrics as dm
  from odin_tpu_torch.bay.vi import estimators as E
  from odin_tpu_torch.bay.vi.utils import discretizing
  z, f = _gym_data()
  zc, fc = torch.tensor(z), torch.tensor(f)
  zg, fg = zc.to(cuda_device), fc.to(cuda_device)
  for column in (0, 2):
    a = E.LogisticRegression().fit(zg, fg[:, column]).coef_.cpu().numpy()
    b = E.LogisticRegression().fit(zc, fc[:, column]).coef_.numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
  np.testing.assert_allclose(dm.sap_matrix(zg, fg).cpu().numpy(),
                             dm.sap_matrix(zc, fc).numpy(), atol=1e-12)
  np.testing.assert_array_equal(discretizing(zg, n_bins=20).cpu().numpy(),
                                discretizing(zc, n_bins=20).numpy())
  codes = discretizing(zc, n_bins=20)
  np.testing.assert_allclose(
      E.mutual_info_matrix(fg, codes.to(cuda_device)).cpu().numpy(),
      E.mutual_info_matrix(fc, codes).numpy(), rtol=0, atol=1e-14)
  kw = dict(n_mcmc=0, batch_size=64, n_samples=2000, seed=1,
            return_model=True)
  sg, lg = dm.factor_vae_score(zg, fg, **kw)
  sc, lc = dm.factor_vae_score(zc, fc, **kw)
  assert sg == sc
  np.testing.assert_array_equal(lg.cpu().numpy(), lc.numpy())
  assert dm.beta_vae_score(zg, fg, n_mcmc=0, seed=1) == pytest.approx(
      dm.beta_vae_score(zc, fc, n_mcmc=0, seed=1), abs=1.0 / 10000)


def test_gym_on_card_matches_cpu(cuda_device):
  """``run_model`` and ``write_report`` (default scores and FID) on the
  card against the same model on the CPU, TF32 off: ``z_mean`` within 1e-4
  (cuDNN and the CPU sum the convolutions apart), no ``_error`` key, TC,
  ``kl_unweighted`` and FID within rtol 1e-3 (their inputs differ at
  1e-5), the same active units."""
  from odin_tpu_torch.bay.vi import DisentanglementGym
  from odin_tpu_torch.fuel import dSpritesSmall
  ds = dSpritesSmall(n_samples=256)
  reports, gyms = [], []
  tf32 = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False  # fp32 convolutions, as the CPU
  try:
    for dev in (cuda_device, "cpu"):
      vae = BetaVAE(beta=4.0, **get_networks("dsprites", zdim=4)).build(
          seed=1, device=dev)
      gym = DisentanglementGym(dataset=ds, model=vae, batch_size=64)
      gym.run_model(n_samples=200, partition="test")
      reports.append(gym.write_report(scores=(
          "elbo", "llk", "kl", "mig", "sap", "dci", "betavae", "factorvae",
          "tc", "active_units", "fid")))
      gyms.append(gym)
  finally:
    torch.backends.cudnn.allow_tf32 = tf32
  card, cpu = reports
  assert gyms[0].z_mean.device.type == "cuda"
  assert not [k for k in card if k.endswith("_error")], card
  np.testing.assert_allclose(gyms[0].z_mean.cpu().numpy(),
                             gyms[1].z_mean.numpy(), rtol=0, atol=1e-4)
  for key in ("total_correlation", "kl_unweighted", "fid"):
    assert card[key] == pytest.approx(cpu[key], rel=1e-3), key
  assert card["n_active_units"] == cpu["n_active_units"]


def _speaker_data(n_utt=48, ndim=12):
  """tests/test_ml.py's utterance layout (tests/torch_ml_common.py), and a
  GMM of 16 mixtures fitted on it on the CPU."""
  from odin_tpu_torch.ml import GMM
  rng = np.random.RandomState(9)
  phones = rng.randn(6, ndim).astype("f") * 4.0
  shift = rng.randn(8, ndim).astype("f")
  utts = [phones[rng.randint(0, 6, n)] + shift[i % 8] +
          rng.randn(n, ndim).astype("f")
          for i, n in enumerate(rng.randint(40, 300, n_utt))]
  gmm = GMM(nmix=16, niter=2, batch_size=2048, device="cpu").fit(utts)
  return utts, np.repeat(np.arange(8), n_utt // 8), gmm


def _apart(got, want):
  """max |got - want| over max |want|."""
  got, want = got.detach().cpu().double(), want.detach().cpu().double()
  return float((got - want).abs().max() / want.abs().max())


def test_gmm_estep_on_card_matches_cpu(cuda_device, monkeypatch):
  """One E-step and transform_batch on the card against the CPU from the
  same state, within 1e-5 of the largest value (fp32 sums in another
  order, tests/test_torch_gmm_tmat.py); the same bits with the caller's
  TF32 on (the E-step turns it off) and through the streamed path (the
  same chunks through pinned buffers)."""
  from odin_tpu_torch.ml import GMM, gmm_tmat
  utts, _, cpu = _speaker_data()
  X = np.concatenate(utts)
  card = GMM.from_state(cpu.state(), device=cuda_device)
  card.batch_size = cpu.batch_size = 512
  want = cpu.expectation(X)
  got = card.expectation(X)
  assert got[0].device.type == "cuda" and got[0].dtype == torch.float64
  for g, w in zip(got[:3], want[:3]):
    assert _apart(g, w) < 1e-5
  assert got[3] == pytest.approx(want[3], rel=1e-6)
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    tf32 = card.expectation(X)
  finally:
    torch.backends.cuda.matmul.allow_tf32 = False
  for a, b in zip(tf32[:3], got[:3]):
    assert torch.equal(a, b)
  monkeypatch.setattr(gmm_tmat, "PARK_BYTES", 0)  # stream through 8 buffers
  streamed = card.expectation(X)
  for a, b in zip(streamed[:3], got[:3]):
    assert torch.equal(a, b)
  monkeypatch.undo()
  for g, w in zip(card.transform_batch(utts), cpu.transform_batch(utts)):
    assert g.device.type == "cuda" and _apart(g, w) < 1e-5


def test_tmatrix_estep_on_card_matches_cpu(cuda_device):
  """The T-matrix E-step (LU, RU, llk) and the i-vectors on the card
  against the CPU from the same state, within 1e-5 (fp32 Cholesky solves
  summed in another order); a precision that is not positive definite
  gives NaN on the card as on the CPU (and as in JAX)."""
  from odin_tpu_torch.ml import GMM, Tmatrix
  utts, _, gmm = _speaker_data()
  Z, F = gmm.transform_batch(utts)
  cpu = Tmatrix(tv_dim=10, gmm=gmm, device="cpu").initialize()
  cpu.fit((Z, F))
  card = Tmatrix(tv_dim=10, gmm=GMM.from_state(gmm.state(), cuda_device),
                 device=cuda_device).load_state(cpu.state())
  LUc, RUc, lc = cpu.expectation(Z, F)
  LU, RU, llk = card.expectation(Z, F)
  assert LU.device.type == "cuda"
  assert _apart(LU, LUc) < 1e-5 and _apart(RU, RUc) < 1e-5
  assert llk == pytest.approx(lc, rel=1e-5)
  assert _apart(card.transform((Z, F)), cpu.transform((Z, F))) < 1e-5
  Z = Z.clone()
  Z[3] = -1e6
  assert np.isnan(card.expectation(Z, F)[2])
  iv = card.transform((Z, F)).cpu()
  assert torch.isnan(iv[3]).all() and not torch.isnan(iv[:3]).any()


def test_scoring_and_plda_on_card_match_cpu(cuda_device):
  """Scorer (cosine, WCCN) and PLDA fitted in float64 on the card against
  the CPU: within 1e-10 (scores) and 1e-8 (PLDA's llrs), the same
  predictions; ``det_curve`` of a CUDA tensor equals numpy's."""
  from odin_tpu_torch.backend import det_curve
  from odin_tpu_torch.ml import PLDA, Scorer
  rng = np.random.RandomState(42)
  centers = rng.randn(10, 20) * 3
  X = np.concatenate([c + rng.randn(20, 20) for c in centers])
  y = np.repeat(np.arange(10), 20)
  Xte = np.concatenate([c + rng.randn(4, 20) for c in centers])
  s_card = Scorer(device=cuda_device).fit(X, y)
  s_cpu = Scorer(device="cpu").fit(X, y)
  assert s_card.enroll.device.type == "cuda"
  assert _apart(s_card.score(Xte), s_cpu.score(Xte)) < 1e-10
  np.testing.assert_array_equal(s_card.predict(Xte), s_cpu.predict(Xte))
  p_card = PLDA(n_phi=8, n_iter=8, device=cuda_device).fit(X, y)
  p_cpu = PLDA(n_phi=8, n_iter=8, device="cpu").fit(X, y)
  S = p_card.score_matrix(Xte, Xte)
  assert _apart(S, p_cpu.score_matrix(Xte, Xte)) < 1e-8
  np.testing.assert_array_equal(p_card.predict(Xte), p_cpu.predict(Xte))
  same = (np.arange(40)[:, None] // 4 == np.arange(40)[None] // 4)
  for got, want in zip(det_curve(torch.from_numpy(same.ravel()).to(
      cuda_device), S.reshape(-1)), det_curve(same.ravel(),
                                             S.cpu().numpy().ravel())):
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the VAE zoo (chip_smoke.py phase 12 at a test's size)
# ---------------------------------------------------------------------------
def _zoo_model(name, device, seed=0):
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.networks import vq_dsprites_networks
  nets = get_networks("dsprites", zdim=10)
  make = {
      "FactorVAE": lambda: vi.FactorVAE(tc_coef=35.0, **nets),
      "FactorVAE-bn": lambda: vi.FactorVAE(batchnorm=True,
                                           discriminator_units=(256, 256),
                                           **nets),
      "Factor2VAE": lambda: vi.Factor2VAE(
          **{k: v for k, v in nets.items() if k != "latents"}),
      "DIPVAE": lambda: vi.DIPVAE(**nets),
      "InfoVAE": lambda: vi.InfoVAE(**nets),
      "MIVAE": lambda: vi.MIVAE(**nets),
      "HypersphericalVAE": lambda: vi.HypersphericalVAE(**nets),
      "PowersphericalVAE": lambda: vi.PowersphericalVAE(**nets),
      "TwoStageVAE": lambda: vi.TwoStageVAE(**nets),
      "VampriorVAE": lambda: vi.VampriorVAE(**nets),
      "VQVAE": lambda: vi.VQVAE(spatial=True, ema=True, restart_dead=True,
                                **vq_dsprites_networks()),
      "StochasticVAE": lambda: vi.StochasticVAE(**nets),
      "irmAE": lambda: vi.irmAE(**nets),
  }[name]
  return make().build(seed=seed, device=device)


ZOO_CARD = ["FactorVAE", "Factor2VAE", "DIPVAE", "InfoVAE", "MIVAE",
            "HypersphericalVAE", "PowersphericalVAE", "TwoStageVAE",
            "VampriorVAE", "VQVAE", "StochasticVAE", "irmAE"]


@pytest.mark.parametrize("name", ZOO_CARD)
def test_zoo_elbo_on_card_matches_cpu(cuda_device, name):
  """The same params (built from one seed), batch and noise (the CPU's
  draws replayed on the card): each ELBO term within 1e-4 of its largest
  magnitude over the batch."""
  from odin_tpu_torch.training import Noise
  torch.backends.cudnn.allow_tf32 = False
  cpu = torch.device("cpu")
  ref, vae = _zoo_model(name, cpu), _zoo_model(name, cuda_device)
  x = (np.random.RandomState(0).rand(32, 64, 64, 1) < 0.3).astype(np.float32)
  noise = Noise(torch.Generator().manual_seed(0))
  step = torch.tensor(700, dtype=torch.int32)
  with torch.no_grad():
    l0, k0, _ = ref.elbo_components(ref.state.params, torch.from_numpy(x),
                                    noise, step,
                                    mutables=dict(ref.state.mutables))
    l1, k1, _ = vae.elbo_components(
        vae.state.params, torch.from_numpy(x).to(cuda_device),
        Noise(eps=[t.to(cuda_device) for t in noise.drawn]),
        step.to(cuda_device), mutables=dict(vae.state.mutables))
  for k, v in {**l0, **k0}.items():
    got = {**l1, **k1}[k].cpu()
    assert float((got - v).abs().max()) <= 1e-4 * float(v.abs().max()), k


@pytest.mark.parametrize("name", ["FactorVAE-bn", "VQVAE", "HypersphericalVAE",
                                  "PowersphericalVAE", "TwoStageVAE"])
def test_zoo_graphed_steps_equal_eager_on_card(cuda_device, name):
  """3 steps from a CUDA graph against 3 eager steps from the same
  generator state, cuDNN deterministic: bitwise, the mutables (BatchNorm's
  statistics, the EMA codebook) and every optimizer's state included;
  every rejection sampler accepted every row."""
  from odin_tpu_torch.bay.distributions import sampling
  from odin_tpu_torch.training.core import _state_leaves
  torch.backends.cudnn.allow_tf32 = False
  vae = _zoo_model(name, cuda_device)
  step = vae.make_step_fn()
  bs = 64 if name.startswith("Factor") else 32
  batches = torch.from_numpy((np.random.RandomState(1).rand(
      3, bs, 64, 64, 1) < 0.3).astype(np.float32)).to(cuda_device)
  torch.backends.cudnn.deterministic = True
  try:
    rng = vae.state.rng.get_state()
    s = vae.state
    for i in range(3):
      s, m = step(s, batches[i])
    vae.state.rng.set_state(rng)
    g, mg = scan_steps(step, 3)(vae.state, batches)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  want, got = _state_leaves(s), _state_leaves(g)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  assert int(g.skipped_updates) == 0
  sampling.check_rejections()


# ---------------------------------------------------------------------------
# the hierarchical and grouped families (chip_smoke.py phase 14 at a test's
# size)
# ---------------------------------------------------------------------------
HIER_CARD = {
    "HierarchicalVAE": lambda vi, n: vi.HierarchicalVAE(**n),
    "VeryDeepVAE": lambda vi, n: vi.VeryDeepVAE(**n),
    "UnetVAE-knobs": lambda vi, n: vi.UnetVAE(
        skip_dropout=0.2, skip_noise=0.1, skip_sample_dropout=0.5, **n),
    "PUnetVAE": lambda vi, n: vi.PUnetVAE(**n),
    "AdaptiveVAE": lambda vi, n: vi.AdaptiveVAE(**n),
    "WeaklySupervisedVAE-rank": lambda vi, n: vi.WeaklySupervisedVAE(
        strategy="rank", **n),
}


def _hier_model(name, device, seed=0):
  from odin_tpu_torch.bay import vi
  return HIER_CARD[name](vi, get_networks("dsprites", zdim=10)).build(
      seed=seed, device=device)


def _hier_batches(name, k, bs, device):
  """k batches: images, or (x1, x2[, y]) pairs for a grouped class."""
  rs = np.random.RandomState(2)
  x = lambda: torch.from_numpy((rs.rand(k, bs, 64, 64, 1) < 0.3).astype(
      np.float32)).to(device)
  if name in ("AdaptiveVAE", "WeaklySupervisedVAE-rank"):
    y = torch.from_numpy((rs.rand(k, bs) < 0.5).astype(np.float32)).to(
        device)
    return (x(), x(), y) if name.endswith("rank") else (x(), x())
  return x()


@pytest.mark.parametrize("name", sorted(HIER_CARD))
def test_hier_elbo_on_card_matches_cpu(cuda_device, name):
  """The same params, batch and noise (the CPU's draws replayed on the
  card), in training mode: each ELBO term within 1e-4 of its largest
  magnitude over the batch."""
  from odin_tpu_torch.training import Noise
  torch.backends.cudnn.allow_tf32 = False
  cpu = torch.device("cpu")
  ref, vae = _hier_model(name, cpu), _hier_model(name, cuda_device)
  batch = _hier_batches(name, 1, 32, cpu)
  batch = tuple(b[0] for b in batch) if isinstance(batch, tuple) \
      else batch[0]
  on_card = tuple(b.to(cuda_device) for b in batch) \
      if isinstance(batch, tuple) else batch.to(cuda_device)
  noise = Noise(torch.Generator().manual_seed(0))
  step = torch.tensor(700, dtype=torch.int32)
  with torch.no_grad():
    l0, k0, _ = ref.elbo_components(ref.state.params, batch, noise, step,
                                    training=True)
    l1, k1, _ = vae.elbo_components(
        vae.state.params, on_card,
        Noise(eps=[t.to(cuda_device) for t in noise.drawn]),
        step.to(cuda_device), training=True)
  for k, v in {**l0, **k0}.items():
    got = {**l1, **k1}[k].cpu()
    assert float((got - v).abs().max()) <= 1e-4 * float(v.abs().max()), k


@pytest.mark.parametrize("name", ["VeryDeepVAE", "UnetVAE-knobs",
                                  "AdaptiveVAE"])
def test_hier_graphed_steps_equal_eager_on_card(cuda_device, name):
  """3 steps from a CUDA graph against 3 eager steps from the same
  generator state, cuDNN deterministic: bitwise, every optimizer state
  included, no update skipped."""
  from odin_tpu_torch.training.core import _state_leaves
  torch.backends.cudnn.allow_tf32 = False
  vae = _hier_model(name, cuda_device)
  step = vae.make_step_fn()
  batches = _hier_batches(name, 3, 32, cuda_device)
  at = lambda i: tuple(b[i] for b in batches) \
      if isinstance(batches, tuple) else batches[i]
  torch.backends.cudnn.deterministic = True
  try:
    rng = vae.state.rng.get_state()
    s = vae.state
    for i in range(3):
      s, m = step(s, at(i))
    vae.state.rng.set_state(rng)
    g, mg = scan_steps(step, 3)(vae.state, batches)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  want, got = _state_leaves(s), _state_leaves(g)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  assert int(g.skipped_updates) == 0


# ---------------------------------------------------------------------------
# the semi-supervised family (chip_smoke.py phase 13 at a test's size)
# ---------------------------------------------------------------------------
def _semi_batches(np_rs, name, k, bs):
  if name.endswith("moons"):
    x = np_rs.randn(k, bs, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np_rs.randint(0, 2, (k, bs))]
  else:
    x = (np_rs.rand(k, bs, 64, 64, 1) < 0.3).astype(np.float32)
    y = np_rs.randint(0, 40, (k, bs, 5)).astype(np.float32)
  mask = np.zeros((k, bs), np.float32)
  mask[:, :bs // 2] = 1
  mask[1] = 0  # the second batch has no labelled row
  y[mask == 0] = 0
  return x, y, mask


@pytest.mark.parametrize("name", ["semafos", "SemafoVAE-moons"])
def test_semi_graphed_steps_straddling_the_gate_equal_eager_on_card(
    cuda_device, name):
  """4 steps from one CUDA graph against 4 eager steps from the same
  generator state, the MI term's gate (``steps_without_mi``) at step 2,
  the second batch with no labelled row (its labels term 0, not NaN),
  cuDNN deterministic: bitwise, every optimizer's state included (semafos
  trains two TrainSteps on one optimizer; the half-moons' one-hot head
  draws Gumbel noise on the card)."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.networks import halfmoons_networks
  from odin_tpu_torch.training.core import _state_leaves
  torch.backends.cudnn.allow_tf32 = False
  if name == "semafos":
    nets = get_networks("dsprites", zdim=10, is_semi_supervised=True)
    vae = vi.semafos(steps_without_mi=2, **nets)
  else:
    vae = vi.SemafoVAE(steps_without_mi=2,
                       **halfmoons_networks(is_semi_supervised=True))
  vae.build(seed=0, device=cuda_device)
  step = vae.make_step_fn()
  batches = tuple(torch.from_numpy(a).to(cuda_device) for a in
                  _semi_batches(np.random.RandomState(1), name, 4, 32))
  torch.backends.cudnn.deterministic = True
  try:
    rng = vae.state.rng.get_state()
    s = vae.state
    for i in range(4):
      s, m = step(s, tuple(b[i] for b in batches))
    vae.state.rng.set_state(rng)
    g, mg = scan_steps(step, 4)(vae.state, batches)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  want, got = _state_leaves(s), _state_leaves(g)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  assert int(g.step) == 4 and int(g.skipped_updates) == 0
  assert sorted(mg) == sorted(m)


def test_conditional_m2_tiling_on_card(cuda_device):
  """ConditionalM2VAE on the full-width dSprites networks with a one-hot
  head over 3 shapes: each image tiled once per class through the encoder
  and the decoder; ``marginal_elbo`` on the card equal to the explicit sum
  over the one-hot labels on the card (1e-5 of its largest magnitude), and
  every term to the CPU's from the same params and noise (1e-4)."""
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.training import Noise
  torch.backends.cudnn.allow_tf32 = False

  def model(device):
    nets = get_networks("dsprites", zdim=10, is_semi_supervised=True)
    nets["labels"] = RVconf(3, "onehot", projection=True, name="shape")
    return vi.ConditionalM2VAE(**nets).build(seed=0, device=device)

  rs = np.random.RandomState(2)
  x = (rs.rand(32, 64, 64, 1) < 0.3).astype(np.float32)
  y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)]
  mask = (np.arange(32) < 16).astype(np.float32)
  y[16:] = 0
  cpu = torch.device("cpu")
  ref, vae = model(cpu), model(cuda_device)
  noise = Noise(torch.Generator().manual_seed(0))
  with torch.no_grad():
    l0, _, _ = ref.elbo_components(ref.state.params, tuple(
        torch.from_numpy(a) for a in (x, y, mask)), noise, 0)
    xb, yb, mb = (torch.from_numpy(a).to(cuda_device) for a in (x, y, mask))
    eps = noise.drawn[0].to(cuda_device)
    assert eps.shape[0] == 32 * 3
    l1, kl, aux = vae.elbo_components(vae.state.params, (xb, yb, mb),
                                      Noise(eps=[eps]), 0)
    assert not kl
    w = mb[:, None] * yb + (1 - mb[:, None]) * aux["qy"].mean()
    explicit = torch.zeros(32, device=cuda_device)
    for k in range(3):
      onehot = torch.zeros_like(yb)
      onehot[:, k] = 1
      lx, kz, *_ = vae._components_xy(vae.state.params, xb, onehot,
                                      Noise(eps=[eps[k::3]]), False, None)
      explicit += w[:, k] * (lx - kz)
  got = l1["marginal_elbo"]
  assert float((got - explicit).abs().max()) <= \
      1e-5 * float(explicit.abs().max())
  for k, v in l0.items():
    assert float((l1[k].cpu() - v).abs().max()) <= \
        1e-4 * float(v.abs().max()), k


def test_failed_capture_raises_on_card(cuda_device):
  """A step that syncs with the host cannot be captured: scan_steps
  raises, and runs nothing eagerly in its place.  (Last in the file: a
  failed capture may leave the card unusable for the process.)"""

  def loss_fn(params, batch, rng, step, mutables):
    loss = (params["p"]["w"] * batch).sum()
    # float(): a host sync, legal eagerly but not inside a capture
    if float(loss.detach()) > 1e30:
      loss = loss * 0
    return loss, ({}, mutables)

  opt = make_optimizer("adam", 1e-3)
  params = {"p": {"w": torch.ones(4, device=cuda_device)}}
  state = TrainState(params=params, opt_states={"p": opt.init(params)},
                     step=torch.zeros((), dtype=torch.int32,
                                      device=cuda_device),
                     rng=torch.Generator(cuda_device))
  fn = build_train_step_fn([TrainStep(loss_fn, partitions=("p",))],
                           {"p": opt})
  batches = torch.ones(2, 4, device=cuda_device)
  s, _ = fn(state, batches[0])  # eagerly it runs
  assert int(s.step) == 1
  with pytest.raises(RuntimeError, match="CUDA graph capture"):
    scan_steps(fn, 2)(state, batches)
