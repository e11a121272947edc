"""The port's speech front-end (odin_tpu_torch.ops, .preprocessing) against
the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages.  Tolerances are
the JAX package's own (tests/test_ops_features.py): 0.01 dB on log-mel,
0.05 on MFCCs and deltas; the CMVN outputs are unit-scale, so 1e-3.  The
tests that need a CUDA card are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.ops import features as jf
from odin_tpu.preprocessing import processor as jproc
from odin_tpu.preprocessing import signal as jsig
from odin_tpu.preprocessing import speech as jspeech
from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops.logmel import logmel, logmel_reference
from odin_tpu_torch.preprocessing import processor as tproc
from odin_tpu_torch.preprocessing import signal as tsig

torch.set_num_threads(1)

MSPEC_ATOL = 0.01
MFCC_ATOL = 0.05
CMVN_ATOL = 1e-3


def _audio(kind, rng, shape):
  y = (rng.randn(*shape) * 0.1).astype(np.float32)
  if kind == "int16":
    return (y * 32768.0).clip(-32768, 32767).astype(np.int16)
  if kind == "ulaw":
    return rng.randint(0, 256, size=shape).astype(np.uint8)
  return y


def _windowed_frames(cfg, rng, n_frames):
  return ((rng.randn(n_frames, cfg.frame_length) * 0.1).astype(np.float32)
          * cfg.window_fn)


def test_signal_bases_equal_jax():
  cfg = tf.FeatureConfig()
  np.testing.assert_array_equal(tsig.hz2mel([0, 500, 1000, 4000]),
                                jsig.hz2mel([0, 500, 1000, 4000]))
  np.testing.assert_array_equal(tsig.mel2hz([0, 10, 20, 40]),
                                jsig.mel2hz([0, 10, 20, 40]))
  np.testing.assert_array_equal(tsig.mel_filters(16000, 512, 40, 64.0),
                                jsig.mel_filters(16000, 512, 40, 64.0))
  np.testing.assert_array_equal(tsig.dct_filters(21, 40),
                                jsig.dct_filters(21, 40))
  np.testing.assert_array_equal(tsig.get_window("hann", 400),
                                jsig.get_window("hann", 400))
  jcfg = jf.FeatureConfig()
  for name in ("window_fn", "mel_basis", "dct_basis"):
    np.testing.assert_array_equal(getattr(cfg, name), getattr(jcfg, name))
  assert cfg.scale == jcfg.scale
  for a, b in zip(tf.dft_bases(400, 512), jf.dft_bases(400, 512)):
    np.testing.assert_array_equal(a, b)


def test_frame_signal_matches_jax():
  y = np.random.RandomState(0).randn(2, 1000).astype(np.float32)
  np.testing.assert_array_equal(
      tf.frame_signal(torch.from_numpy(y), 400, 160).numpy(),
      np.asarray(jf.frame_signal(jnp.asarray(y), 400, 160)))


def test_ulaw_expand_bit_exact():
  codes = np.arange(256, dtype=np.uint8)
  port = tf.ulaw_expand_device(torch.from_numpy(codes)).numpy()
  np.testing.assert_array_equal(
      port, np.asarray(jf.ulaw_expand_device(jnp.asarray(codes))))
  np.testing.assert_array_equal(port, jspeech._ulaw_expand(codes))
  # the host expansion (float32 transfer) gives the same features as the
  # expansion after a uint8 transfer
  utt = [np.random.RandomState(1).randint(0, 256, 4000).astype(np.uint8)]
  host = tproc.batch_speech_features(utt, transfer_dtype=np.float32,
                                     device="cpu")[0]
  raw = tproc.batch_speech_features(utt, device="cpu")[0]
  for k in raw:
    np.testing.assert_array_equal(host[k], raw[k])


@pytest.mark.parametrize("width", [3, 9])
def test_batch_delta_matches_jax(width):
  x = np.random.RandomState(width).randn(2, 30, 5).astype(np.float32)
  np.testing.assert_allclose(
      tf._batch_delta(torch.from_numpy(x), width).numpy(),
      np.asarray(jf._batch_delta(jnp.asarray(x), width)), atol=1e-5)


def test_logmel_reference_matches_pallas_interpret():
  """K1's plain version against the Pallas kernel run in interpret mode."""
  from jax.experimental.pallas import tpu as pltpu
  from odin_tpu.ops.pallas_features import logmel_pallas
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  frames = _windowed_frames(cfg, np.random.RandomState(1),
                            cfg.n_frames(cfg.sr))  # 1 x 1 s
  with pltpu.force_tpu_interpret_mode():
    want = np.asarray(logmel_pallas(jnp.asarray(frames[None]), jcfg))[0]
  bases = cfg.device_bases("cpu")
  got = logmel_reference(torch.from_numpy(frames), bases["cos"],
                         bases["sin"], bases["mel_t"], cfg.scale ** 2)
  np.testing.assert_allclose(got.numpy(), want, atol=MSPEC_ATOL)


def test_logmel_on_cpu_runs_the_plain_version():
  cfg = tf.FeatureConfig()
  frames = torch.from_numpy(_windowed_frames(cfg, np.random.RandomState(2),
                                             37)).reshape(1, 37, -1)
  before = logmel.launches
  got = logmel(frames, cfg)
  assert logmel.launches == before  # the count is of kernel launches only
  bases = cfg.device_bases("cpu")
  want = logmel_reference(frames, bases["cos"], bases["sin"], bases["mel_t"],
                          cfg.scale ** 2)
  assert got.shape == (1, 37, cfg.n_mels)
  np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("frame_length,n_fft,n_mels", [(400, 512, 40),
                                                        (201, 256, 20),
                                                        (1024, 1024, 40),
                                                        (1600, 2048, 64)])
def test_logmel_kernel_operands(frame_length, n_fft, n_mels):
  """The kernel's layout of the bases (rows padded to CHUNK, bins in
  groups of MAX_FREQS, zeros) and mel bands give K1's plain result, also
  where the bins take more than one group."""
  from odin_tpu_torch.ops.logmel import CHUNK, MAX_FREQS, kernel_operands
  cfg = tf.FeatureConfig(frame_length=frame_length, n_fft=n_fft,
                         n_mels=n_mels)
  bases = cfg.device_bases("cpu")
  dft, bands = kernel_operands(bases)
  n_freqs = n_fft // 2 + 1
  padded = -(-frame_length // CHUNK) * CHUNK
  groups = -(-n_freqs // MAX_FREQS)
  assert tuple(dft.shape) == (groups, padded, 2, MAX_FREQS)
  assert kernel_operands(bases)[0] is dft  # built once per config and device
  # the groups side by side: (padded, 2, groups * MAX_FREQS)
  flat = dft.permute(1, 2, 0, 3).reshape(padded, 2, groups * MAX_FREQS)
  assert not flat[frame_length:].any() and not flat[:, :, n_freqs:].any()
  np.testing.assert_array_equal(flat[:frame_length, 0, :n_freqs].numpy(),
                                bases["cos"].numpy())
  np.testing.assert_array_equal(flat[:frame_length, 1, :n_freqs].numpy(),
                                bases["sin"].numpy())
  frames = torch.from_numpy(_windowed_frames(cfg, np.random.RandomState(3),
                                             6))
  x = torch.zeros(6, padded)
  x[:, :frame_length] = frames
  re, im = x @ flat[:, 0, :n_freqs], x @ flat[:, 1, :n_freqs]
  power = (re * re + im * im) * cfg.scale ** 2
  mel_t = bases["mel_t"]
  mel = torch.stack([power[:, lo:hi] @ mel_t[lo:hi, m]
                     for m, (lo, hi) in enumerate(bands.tolist())], dim=-1)
  want = logmel_reference(frames, bases["cos"], bases["sin"], mel_t,
                          cfg.scale ** 2)
  np.testing.assert_allclose(
      (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).numpy(),
      want.numpy(), atol=1e-4)


def test_logmel_checks_its_input():
  cfg = tf.FeatureConfig()
  good = torch.zeros(4, cfg.frame_length)
  with pytest.raises(TypeError):
    logmel(good.double(), cfg)
  with pytest.raises(ValueError):
    logmel(torch.zeros(4, cfg.frame_length + 1), cfg)
  with pytest.raises(ValueError):
    logmel(torch.zeros(cfg.frame_length, 4).t(), cfg)
  with pytest.raises(ValueError):
    logmel(torch.zeros(4, cfg.frame_length, device="meta"), cfg)


def test_cuda_entry_points_raise_without_a_card():
  """No silent CPU fallback: asking for the card where there is none fails."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present")
  cfg = tf.FeatureConfig()
  y = np.zeros((1, 4000), np.float32)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    tf.speech_features(y, cfg)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    tproc.batch_speech_features([y[0]], cfg, device="cuda")


@pytest.mark.parametrize("kind", ["float32", "int16", "ulaw"])
def test_speech_features_matches_jax(kind):
  rng = np.random.RandomState({"float32": 3, "int16": 4, "ulaw": 5}[kind])
  y = _audio(kind, rng, (3, 16000))
  lengths = np.array([16000, 11000, 6000])
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  want = jf.speech_features(jnp.asarray(y), jcfg,
                            lengths=jnp.asarray(lengths), use_pallas=False)
  got = tf.speech_features(y, cfg, lengths=lengths, device="cpu")
  assert "spec" not in got
  assert set(got) == set(want) - {"spec"}
  np.testing.assert_array_equal(got["frame_mask"].numpy(),
                                np.asarray(want["frame_mask"]))
  np.testing.assert_array_equal(got["vad"].numpy(), np.asarray(want["vad"]))
  tol = dict(mspec=MSPEC_ATOL, mfcc=MFCC_ATOL, mfcc_delta=MFCC_ATOL,
             mspec_cmvn=CMVN_ATOL, mfcc_cmvn=CMVN_ATOL, energy=1e-4)
  for key, atol in tol.items():
    assert got[key].shape == want[key].shape, key
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=atol, err_msg=key)


def test_speech_features_matches_jax_pallas_branch():
  """The JAX branch the port mirrors: use_pallas=True, in interpret mode."""
  from jax.experimental.pallas import tpu as pltpu
  y = _audio("float32", np.random.RandomState(6), (1, 16000))
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  with pltpu.force_tpu_interpret_mode():
    want = jf.speech_features(jnp.asarray(y), jcfg, use_pallas=True)
  got = tf.speech_features(y, cfg, device="cpu")
  assert set(got) == set(want)
  np.testing.assert_allclose(got["mspec"].numpy(), np.asarray(want["mspec"]),
                             atol=MSPEC_ATOL)


@pytest.mark.parametrize("kind", ["float32", "int16"])
def test_speech_features_spec_matches_jax(kind):
  """use_pallas=False: the plain matmul DFT, with the power spectrum, as
  JAX's default branch; tolerances of tests/test_ops_features.py (spec
  rtol 2e-3, atol 1e-7)."""
  rng = np.random.RandomState({"float32": 10, "int16": 11}[kind])
  y = _audio(kind, rng, (2, 8000))
  lengths = np.array([8000, 5000])
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  want = jf.speech_features(jnp.asarray(y), jcfg,
                            lengths=jnp.asarray(lengths), use_pallas=False)
  got = tf.speech_features(y, cfg, lengths=lengths, device="cpu",
                           use_pallas=False)
  assert set(got) == set(want)
  assert got["spec"].shape == want["spec"].shape == (
      2, cfg.n_frames(8000), cfg.n_fft // 2 + 1)
  np.testing.assert_allclose(got["spec"].numpy(), np.asarray(want["spec"]),
                             rtol=2e-3, atol=1e-7)
  np.testing.assert_allclose(got["mspec"].numpy(), np.asarray(want["mspec"]),
                             atol=MSPEC_ATOL)
  np.testing.assert_allclose(got["mfcc"].numpy(), np.asarray(want["mfcc"]),
                             atol=MFCC_ATOL)
  np.testing.assert_array_equal(got["vad"].numpy(), np.asarray(want["vad"]))


def test_batch_speech_features_spec_matches_jax():
  """Asking for "spec" returns it, as JAX does; on the CPU the logmel
  kernel's plain version is not run for such a batch (no count moves
  either way)."""
  rng = np.random.RandomState(12)
  utts = [_audio("int16", rng, (n,)) for n in (6000, 4500, 7100)]
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  feats = ("mspec", "spec")
  want = jproc.batch_speech_features(utts, jcfg, batch_size=2, features=feats)
  got = tproc.batch_speech_features(utts, cfg, batch_size=2, features=feats,
                                    device="cpu")
  for g, w, u in zip(got, want, utts):
    assert set(g) == set(w) == set(feats)
    assert g["spec"].shape == (cfg.n_frames(len(u)), cfg.n_fft // 2 + 1)
    np.testing.assert_allclose(g["spec"], w["spec"], rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(g["mspec"], w["mspec"], atol=MSPEC_ATOL)


def test_logmel_large_fft_matches_jax():
  """n_fft 1024 and frame_length 1024 (513 bins): K1's plain version
  against JAX's plain branch."""
  kw = dict(frame_length=1024, step_length=256, n_fft=1024)
  cfg, jcfg = tf.FeatureConfig(**kw), jf.FeatureConfig(**kw)
  y = _audio("float32", np.random.RandomState(13), (1, 8000))
  want = jf.speech_features(jnp.asarray(y), jcfg, use_pallas=False)
  got = tf.speech_features(y, cfg, device="cpu")
  np.testing.assert_allclose(got["mspec"].numpy(), np.asarray(want["mspec"]),
                             atol=MSPEC_ATOL)


def test_batch_speech_features_matches_jax():
  rng = np.random.RandomState(7)
  utts = [_audio("int16", rng, (n,)) for n in (8000, 5200, 6400)]
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  feats = ("mspec", "mfcc", "vad")
  want = jproc.batch_speech_features(utts, jcfg, batch_size=2, features=feats)
  got = tproc.batch_speech_features(utts, cfg, batch_size=2, features=feats,
                                    device="cpu")
  assert len(got) == len(want) == 3
  for g, w, u in zip(got, want, utts):
    assert set(g) == set(w) == set(feats)
    assert g["mspec"].shape == (cfg.n_frames(len(u)), cfg.n_mels)
    np.testing.assert_allclose(g["mspec"], w["mspec"], atol=MSPEC_ATOL)
    np.testing.assert_allclose(g["mfcc"], w["mfcc"], atol=MFCC_ATOL)
    np.testing.assert_array_equal(g["vad"], w["vad"])


@pytest.mark.parametrize("transfer", [np.float32, np.int16])
def test_batch_speech_features_transfer_dtypes(transfer):
  """Float utterances shipped as float32 or as raw int16 PCM."""
  rng = np.random.RandomState(8)
  utts = [_audio("float32", rng, (n,)) for n in (6000, 4100)]
  cfg, jcfg = tf.FeatureConfig(), jf.FeatureConfig()
  want = jproc.batch_speech_features(utts, jcfg, features=("mspec",),
                                     transfer_dtype=transfer)
  got = tproc.batch_speech_features(utts, cfg, features=("mspec",),
                                    transfer_dtype=transfer, device="cpu")
  for g, w in zip(got, want):
    np.testing.assert_allclose(g["mspec"], w["mspec"], atol=MSPEC_ATOL)
