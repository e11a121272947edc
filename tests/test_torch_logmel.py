"""K1's FFT kernel (odin_tpu_torch/csrc/logmel_fft.cu) on the CPU: its
twiddle table, the choice between the FFT and the dense-DFT kernel, the
tables it reads, and the function it must compute, held against JAX's
``logmel_pallas`` in interpret mode on frames with a high dynamic range.

The kernel itself runs only on the card (tests/test_torch_cuda.py); here a
numpy model of its algorithm (the same table, stage order and split step)
checks that the table drives a right FFT.  Tolerance: 0.01 dB on log-mel,
the JAX package's own (tests/test_ops_features.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.ops import features as jf
from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops.logmel import (fft_operands, fft_plan,
                                       fft_twiddle_index, fft_twiddles,
                                       harmonic_frames, kernel_route, logmel,
                                       logmel_reference)

torch.set_num_threads(1)

MSPEC_ATOL = 0.01


def _config(frame_length, n_fft, **kw):
  kw = dict(frame_length=frame_length, step_length=frame_length // 4,
            n_fft=n_fft, **kw)
  return tf.FeatureConfig(**kw), jf.FeatureConfig(**kw)


def _pallas_logmel(frames, jcfg):
  from jax.experimental.pallas import tpu as pltpu
  from odin_tpu.ops.pallas_features import logmel_pallas
  with pltpu.force_tpu_interpret_mode():
    return np.asarray(logmel_pallas(jnp.asarray(frames[None]), jcfg))[0]


def _folded_logmel64(frames, cfg):
  """The function in float64 by numpy's FFT: each frame folded over
  periods of n_fft samples (or padded to n_fft), as JAX's DFT bases
  define it for any frame length."""
  n, length = frames.shape
  folded = np.zeros((n, cfg.n_fft))
  for t0 in range(0, length, cfg.n_fft):
    seg = frames[:, t0:t0 + cfg.n_fft].astype(np.float64)
    folded[:, :seg.shape[1]] += seg
  power = np.abs(np.fft.rfft(folded, cfg.n_fft)) ** 2 * cfg.scale ** 2
  mel = power @ cfg.mel_basis.T.astype(np.float64)
  return 10.0 * np.log10(np.maximum(mel, 1e-10))


@pytest.mark.parametrize("n_fft", [16, 512, 1024, 8192])
def test_fft_twiddles_are_float64_rounded_once(n_fft):
  table = fft_twiddles(n_fft)
  k = fft_twiddle_index(n_fft)
  assert table.dtype == np.float32 and table.shape == (len(k), 2)
  assert k.min() >= 0 and k.max() < n_fft
  exact = np.exp(-2j * np.pi * k / n_fft)
  for part, got in ((exact.real, table[:, 0]), (exact.imag, table[:, 1])):
    # within half a unit in the last place of fp32
    half_ulp = np.spacing(np.abs(part).astype(np.float32)) / 2
    assert np.all(np.abs(got.astype(np.float64) - part) <= half_ulp)
  # the split step's twiddles close the table: exp(-2πik/n_fft), k < n_fft/4
  np.testing.assert_array_equal(k[len(k) - n_fft // 4:],
                                np.arange(n_fft // 4))


@pytest.mark.parametrize("n_fft,route", [
    (512, "fft"), (1024, "fft"), (2048, "fft"), (16, "fft"), (8192, "fft"),
    (400, "dense"), (480, "dense"), (16384, "dense"), (8, "dense"),
    (1000, "dense")])
def test_kernel_route(n_fft, route):
  assert kernel_route(n_fft) == route


@pytest.mark.parametrize("n_fft,radices", [
    (16, [8]), (32, [16]), (64, [2, 16]), (512, [16, 16]),
    (1024, [2, 16, 16]), (8192, [16, 16, 16])])
def test_fft_plan(n_fft, radices):
  """A radix-2, 4 or 8 pass first, then radix-16 passes, spanning M."""
  plan = fft_plan(n_fft)
  assert [radix for _, radix in plan] == radices
  assert [ns for ns, _ in plan] == list(np.cumprod([1] + radices[:-1]))
  assert np.prod(radices) == n_fft // 2


def _model_power(frames, n_fft):
  """The FFT kernel's algorithm in numpy complex64: fold or pad, read the
  frame as M = n_fft/2 complex points, run the Stockham passes of
  ``fft_plan`` with the table's twiddles, then the split step; returns
  |X|^2 (n, n_fft/2 + 1).  Each pass's radix-R butterflies are numpy's
  DFT: the kernel's own are held to it on the card."""
  n, length = frames.shape
  x = np.zeros((n, n_fft), np.float32)
  for t0 in range(0, length, n_fft):
    seg = frames[:, t0:t0 + n_fft]
    x[:, :seg.shape[1]] += seg
  m = n_fft // 2
  table = fft_twiddles(n_fft)
  tw = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
  z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
  offset = 0
  for ns, radix in fft_plan(n_fft):
    step = m // radix
    j = np.arange(step)
    k = j % ns
    v = np.stack([z[:, j + q * step] for q in range(radix)], axis=-1)
    if ns > 1:
      w = np.ones((step, radix), np.complex64)
      for q in range(1, radix):
        w[:, q] = tw[offset + (radix - 1) * k + q - 1]
      v = v * w
      offset += (radix - 1) * ns
    y = np.fft.fft(v, axis=-1).astype(np.complex64)
    z = np.empty_like(z)
    o = (j - k) * radix + k
    for q in range(radix):
      z[:, o + q * ns] = y[:, :, q]
  k = np.arange(m // 2)
  za, zb = z[:, k], z[:, (m - k) % m]
  s = za + np.conj(zb)
  wd = tw[offset:] * (-1j) * (za - np.conj(zb))
  power = np.empty((n, m + 1), np.float32)
  power[:, k] = np.abs(s + wd) ** 2 / 4
  power[:, m - k] = np.abs(s - wd) ** 2 / 4
  power[:, m // 2] = np.abs(z[:, m // 2]) ** 2
  return power


@pytest.mark.parametrize("frame_length,n_fft", [(16, 16), (20, 32),
                                                (60, 64), (400, 512),
                                                (1024, 1024), (400, 256),
                                                (3000, 2048), (8192, 8192)])
def test_twiddle_table_drives_the_kernels_fft(frame_length, n_fft):
  """The table in the kernel's order gives the folded frame's power
  spectrum to fp32 rounding."""
  frames = np.random.RandomState(n_fft).randn(3, frame_length)
  folded = np.zeros((3, n_fft))
  for t in range(0, frame_length, n_fft):
    seg = frames[:, t:t + n_fft]
    folded[:, :seg.shape[1]] += seg
  want = np.abs(np.fft.rfft(folded, n_fft)) ** 2
  got = _model_power(frames.astype(np.float32), n_fft)
  assert np.max(np.abs(got - want)) <= 1e-5 * want.max()


@pytest.mark.parametrize("frame_length,n_fft,n_mels", [(400, 512, 40),
                                                       (1024, 1024, 80)])
def test_fft_operands_pack_the_mel_bands(frame_length, n_fft, n_mels):
  cfg, _ = _config(frame_length, n_fft, n_mels=n_mels)
  bases = cfg.device_bases("cpu")
  twiddles, weights, bands = fft_operands(bases, n_fft)
  assert fft_operands(bases, n_fft)[0] is twiddles  # built once
  np.testing.assert_array_equal(twiddles.numpy(), fft_twiddles(n_fft))
  mel_t = bases["mel_t"]
  assert tuple(bands.shape) == (n_mels, 4) and bands.dtype == torch.int32
  assert weights.numel() == int(torch.count_nonzero(mel_t))
  power = torch.rand(5, n_fft // 2 + 1, dtype=torch.float64)
  banded = torch.stack([
      power[:, lo:hi] @ weights[off:off + hi - lo].double()
      for lo, hi, off, _ in bands.tolist()], dim=-1)
  np.testing.assert_allclose(banded.numpy(),
                             (power @ mel_t.double()).numpy(), rtol=1e-12)


def test_harmonic_frames_span_a_wide_range():
  """The harmonic frames are seeded, windowed fp32, and their mel bands
  span far more than white noise's (where every bin has about equal
  power)."""
  cfg, _ = _config(400, 512)
  frames = harmonic_frames(64, cfg, seed=3, device="cpu")
  assert frames.dtype == torch.float32 and tuple(frames.shape) == (64, 400)
  again = harmonic_frames(64, cfg, seed=3, device="cpu")
  np.testing.assert_array_equal(frames.numpy(), again.numpy())
  bases = cfg.device_bases("cpu")
  noise = torch.from_numpy((np.random.RandomState(3).randn(64, 400) * 0.1)
                           .astype(np.float32) * cfg.window_fn)
  spans = [logmel_reference(x, bases["cos"], bases["sin"], bases["mel_t"],
                            cfg.scale ** 2) for x in (frames, noise)]
  spans = [float((s.max(-1).values - s.min(-1).values).min()) for s in spans]
  assert spans[0] > 60.0 and spans[1] < 30.0, spans


@pytest.mark.parametrize("frame_length,n_fft", [(400, 512), (1024, 1024)])
def test_logmel_reference_matches_pallas_on_harmonic_frames(frame_length,
                                                            n_fft):
  cfg, jcfg = _config(frame_length, n_fft)
  frames = harmonic_frames(150, cfg, seed=n_fft, device="cpu").numpy()
  want = _pallas_logmel(frames, jcfg)
  bases = cfg.device_bases("cpu")
  got = logmel_reference(torch.from_numpy(frames), bases["cos"],
                         bases["sin"], bases["mel_t"], cfg.scale ** 2)
  assert float(want.max() - want.min()) > 60.0
  np.testing.assert_allclose(got.numpy(), want, atol=MSPEC_ATOL)
  np.testing.assert_allclose(_folded_logmel64(frames, cfg), want,
                             atol=MSPEC_ATOL)


@pytest.mark.parametrize("frame_length,n_fft", [(400, 256), (700, 128)])
def test_logmel_folds_frames_longer_than_n_fft(frame_length, n_fft):
  """Frames longer than n_fft fold over periods of n_fft samples (JAX's
  bases are periodic); they are not cut to n_fft as numpy's rfft would."""
  cfg, jcfg = _config(frame_length, n_fft, n_mels=20)
  frames = harmonic_frames(130, cfg, seed=frame_length,
                           device="cpu").numpy()
  want = _pallas_logmel(frames, jcfg)
  np.testing.assert_allclose(_folded_logmel64(frames, cfg), want,
                             atol=MSPEC_ATOL)
  cut = _folded_logmel64(frames[:, :n_fft], cfg)
  assert np.abs(cut - want).max() > 1.0  # truncation is another function
  bases = cfg.device_bases("cpu")
  got = logmel_reference(torch.from_numpy(frames), bases["cos"],
                         bases["sin"], bases["mel_t"], cfg.scale ** 2)
  np.testing.assert_allclose(got.numpy(), want, atol=MSPEC_ATOL)


@pytest.mark.parametrize("n_fft", [512, 400])
def test_logmel_on_cpu_launches_neither_kernel(n_fft):
  cfg, _ = _config(400, n_fft)
  frames = harmonic_frames(9, cfg, seed=1, device="cpu")
  before = (logmel.launches, logmel.fft_launches)
  got = logmel(frames, cfg)
  assert (logmel.launches, logmel.fft_launches) == before
  bases = cfg.device_bases("cpu")
  np.testing.assert_array_equal(
      got.numpy(), logmel_reference(frames, bases["cos"], bases["sin"],
                                    bases["mel_t"], cfg.scale ** 2).numpy())
