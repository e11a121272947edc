"""K1's FFT kernels (odin_tpu_torch/csrc/logmel_fft.cu for power-of-two
n_fft, csrc/logmel_fft_mixed.cu for the mixed radices) on the CPU: their
twiddle tables, plans and butterfly constants, the choice among the two FFT
kernels and the dense-DFT kernel, the tables they read, the mixed-radix
kernel's group and layout, and the function they must compute, held against
JAX's ``logmel_pallas`` in interpret mode on frames with a high dynamic
range.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here a numpy model of their algorithm (the same table, stage order and
split step) checks that the table drives a right FFT.  Tolerance: 0.01 dB
on log-mel, the JAX package's own (tests/test_ops_features.py).
"""
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.ops import features as jf
from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops.logmel import (fft_operands, fft_plan,
                                       fft_twiddle_index, fft_twiddles,
                                       harmonic_frames, kernel_route, logmel,
                                       logmel_reference, mixed_geometry)

k1 = importlib.import_module("odin_tpu_torch.ops.logmel")

torch.set_num_threads(1)

MIXED_SOURCE = (pathlib.Path(k1.__file__).resolve().parent.parent / "csrc" /
                "logmel_fft_mixed.cu")

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


@pytest.mark.parametrize("n_fft", [16, 512, 1024, 8192, 400, 480, 882, 1200,
                                   8100, 18])
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
  # the split step's twiddles close the table: exp(-2πik/n_fft) for
  # k < (M + 1) // 2, M = n_fft/2 (n_fft/4 of them for even M)
  pairs = (n_fft // 2 + 1) // 2
  np.testing.assert_array_equal(k[len(k) - pairs:], np.arange(pairs))


@pytest.mark.parametrize("n_fft,route", [
    (512, "fft"), (1024, "fft"), (2048, "fft"), (16, "fft"), (8192, "fft"),
    (400, "mixed"), (480, "mixed"), (16384, "dense"), (8, "dense"),
    (1000, "mixed"), (882, "mixed"), (551, "dense"), (4004, "dense"),
    (401, "dense"), (8100, "mixed"), (8400, "dense"), (18, "mixed")])
def test_kernel_route(n_fft, route):
  assert kernel_route(n_fft) == route


def test_kernel_route_enumerates_the_range():
  """Powers of two from 16 to 8192 take the FFT kernel; the other even
  n_fft from 16 to 8192 whose half has no prime factor above 7 the
  mixed-radix kernel; every other n_fft the dense kernel."""
  def largest_prime_factor(m):
    p, largest = 2, 1
    while m > 1:
      while m % p == 0:
        m, largest = m // p, p
      p += 1
    return largest

  routes = {"fft": 0, "mixed": 0, "dense": 0}
  for n_fft in range(1, 9001):
    if n_fft in (2 ** e for e in range(4, 14)):
      want = "fft"
    elif (n_fft % 2 == 0 and 16 <= n_fft <= 8192 and
          largest_prime_factor(n_fft // 2) <= 7):
      want = "mixed"
    else:
      want = "dense"
    assert kernel_route(n_fft) == want, n_fft
    routes[want] += 1
  assert routes == {"fft": 10, "mixed": 231, "dense": 8759}


@pytest.mark.parametrize("n_fft,radices", [
    (16, [8]), (32, [16]), (64, [2, 16]), (512, [16, 16]),
    (1024, [2, 16, 16]), (8192, [16, 16, 16]), (400, [8, 5, 5]),
    (480, [16, 3, 5]), (1200, [8, 3, 5, 5]), (882, [3, 3, 7, 7]),
    (320, [2, 16, 5]), (18, [3, 3]), (20, [2, 5]), (28, [2, 7]),
    (8100, [2, 3, 3, 3, 3, 5, 5]), (6144, [4, 16, 16, 3])])
def test_fft_plan(n_fft, radices):
  """For the power of two in M, a radix-2, 4 or 8 pass first, then
  radix-16 passes; then a pass of radix 3, 5 or 7 for each such factor,
  in that order; spanning M."""
  plan = fft_plan(n_fft)
  assert [radix for _, radix in plan] == radices
  assert [ns for ns, _ in plan] == list(np.cumprod([1] + radices[:-1]))
  assert np.prod(radices) == n_fft // 2


@pytest.mark.parametrize("n_fft", [551, 4004, 401, 22, 1102])
def test_fft_plan_refuses_what_no_fft_kernel_takes(n_fft):
  with pytest.raises(ValueError):
    fft_plan(n_fft)


def test_mixed_radix_constants_are_float64_rounded_once():
  """The mixed-radix kernel's butterfly constants (kCos<R>_<j>,
  kSin<R>_<j>, hex literals in its source) are cos and sin of 2πj/R
  computed in float64 and rounded once to fp32."""
  source = MIXED_SOURCE.read_text()
  found = re.findall(
      r"constexpr float k(Cos|Sin)(\d+)_(\d+) = (-?0x[0-9a-f.]+p[-+]?\d+)f;",
      source)
  names = {(fn, int(r), int(j)) for fn, r, j, _ in found}
  assert {(fn, r, j) for r, js in ((3, [1]), (5, [1, 2]), (7, [1, 2, 3]),
                                   (16, [1]))
          for j in js for fn in ("Cos", "Sin")} | {("Cos", 8, 1)} == names
  for fn, r, j, literal in found:
    exact = (np.cos if fn == "Cos" else np.sin)(2.0 * np.pi * int(j) /
                                                int(r))
    assert float.fromhex(literal) == float(np.float32(exact)), (fn, r, j)


@pytest.mark.parametrize("n_fft,group,idle", [
    (400, 19, [0.072, 0.010, 0.010]), (480, 16, [0.062, 0.0, 0.0]),
    (882, 8, [0.081, 0.081, 0.016, 0.016]),
    (1200, 6, [0.121, 0.062, 0.062, 0.062])])
def test_mixed_geometry_at_common_framings(n_fft, group, idle):
  """The groups and idle shares the mixed-radix kernel's source header
  lists (tools/k1_mixed_plan.py prints them)."""
  assert mixed_geometry(n_fft)[0] == group
  np.testing.assert_allclose(k1.mixed_idle_shares(n_fft), idle, atol=5e-4)


def test_mixed_geometry_fits_the_kernel_for_every_n_fft():
  """Every n_fft of the mixed route gets a group of at most 4096 points (or
  one frame) and one of the two layouts, the one the bank model counts
  cheapest; no pass idles more than half its slots."""
  for n_fft in range(16, 8193, 2):
    if kernel_route(n_fft) != "mixed":
      continue
    group, layout = mixed_geometry(n_fft)
    assert 1 <= group and group * n_fft // 2 <= k1.MIXED_GROUP_POINTS
    assert layout in range(len(k1.MIXED_LAYOUTS))
    assert max(k1.mixed_idle_shares(n_fft)) < 0.5, n_fft
  costs = [k1._bank_cost(400, 19, layout) for layout in range(2)]
  assert mixed_geometry(400)[1] == costs.index(min(costs)) == 1
  assert mixed_geometry(882)[1] == 0  # radix 3 first: odd strides, plain
  with pytest.raises(ValueError):
    mixed_geometry(512)


def test_bank_model_counts_wavefronts():
  """32 lanes on consecutive float2 take 2 wavefronts; a stride of 8 float2
  puts 16 lanes on each of two bank pairs, and the swizzle spreads them
  again; an odd stride is free of conflicts as it is, and the swizzle
  disturbs it."""
  lanes = np.arange(32)[None, :]
  live = np.ones((1, 32), bool)
  assert k1._wavefronts(lanes, live) == 2
  assert k1._wavefronts(8 * lanes, live) == 16
  assert k1._wavefronts(k1._layout(8 * lanes, 1), live) == 2
  assert k1._wavefronts(5 * lanes, live) == 2
  assert k1._wavefronts(k1._layout(3 * lanes, 1), live) > 2
  half = np.arange(32)[None, :] < 16
  assert k1._wavefronts(8 * lanes, half) == 8


def _model_power(frames, n_fft):
  """The FFT kernels' algorithm in numpy complex64: fold or pad, read the
  frame as M = n_fft/2 complex points, run the Stockham passes of
  ``fft_plan`` with the table's twiddles (in the routed kernel's layout,
  ``fft_twiddle_index``), then the split step (pairs k and
  M - k for k < (M + 1) // 2, and the middle bin for even M); returns
  |X|^2 (n, n_fft/2 + 1).  Each pass's radix-R butterflies are numpy's
  DFT: the kernels' own are held to it on the card."""
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
  by_pass = kernel_route(n_fft) != "fft"  # the mixed kernel's (r-1)·ns + k
  for ns, radix in fft_plan(n_fft):
    step = m // radix
    j = np.arange(step)
    k = j % ns
    v = np.stack([z[:, j + q * step] for q in range(radix)], axis=-1)
    if ns > 1:
      w = np.ones((step, radix), np.complex64)
      for q in range(1, radix):
        w[:, q] = tw[offset + ((q - 1) * ns + k if by_pass else
                               (radix - 1) * k + q - 1)]
      v = v * w
      offset += (radix - 1) * ns
    y = np.fft.fft(v, axis=-1).astype(np.complex64)
    z = np.empty_like(z)
    o = (j - k) * radix + k
    for q in range(radix):
      z[:, o + q * ns] = y[:, :, q]
  k = np.arange((m + 1) // 2)
  assert len(tw) - offset == len(k)
  za, zb = z[:, k], z[:, (m - k) % m]
  s = za + np.conj(zb)
  wd = tw[offset:] * (-1j) * (za - np.conj(zb))
  power = np.empty((n, m + 1), np.float32)
  power[:, k] = np.abs(s + wd) ** 2 / 4
  power[:, m - k] = np.abs(s - wd) ** 2 / 4
  if m % 2 == 0:
    power[:, m // 2] = np.abs(z[:, m // 2]) ** 2
  return power


@pytest.mark.parametrize("frame_length,n_fft", [
    (16, 16), (20, 32), (60, 64), (400, 512), (1024, 1024), (400, 256),
    (3000, 2048), (8192, 8192), (400, 400), (480, 480), (882, 882),
    (1200, 1200), (4000, 4000), (1000, 400), (2000, 882), (300, 400),
    (1000, 1200), (18, 18), (8100, 8100)])
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
                                                       (1024, 1024, 80),
                                                       (400, 400, 80)])
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


@pytest.mark.parametrize("frame_length,n_fft", [(400, 512), (1024, 1024),
                                                (400, 400), (480, 480)])
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


@pytest.mark.parametrize("n_fft", [512, 400, 551])
def test_logmel_on_cpu_launches_neither_kernel(n_fft):
  cfg, _ = _config(400, n_fft)
  frames = harmonic_frames(9, cfg, seed=1, device="cpu")
  before = (logmel.launches, logmel.fft_launches, logmel.mixed_launches)
  got = logmel(frames, cfg)
  assert (logmel.launches, logmel.fft_launches,
          logmel.mixed_launches) == before
  bases = cfg.device_bases("cpu")
  np.testing.assert_array_equal(
      got.numpy(), logmel_reference(frames, bases["cos"], bases["sin"],
                                    bases["mel_t"], cfg.scale ** 2).numpy())
