"""The port's spectrogram inversion (``odin_tpu_torch.ops.inversion``) against
the JAX package's on the CPU, on signals made with numpy from a seed.

Limits: ``stft_device`` within rtol 1e-4 and atol 1e-4 of JAX's;
``istft_device`` as well wherever the window-square envelope it divides by
is at least 1 % of its peak.  At the first and last few samples of a
waveform the Hann envelope falls to 1e-4 of its peak, and the division
magnifies the packages' fp32 rounding by as much (measured: 8e-4 apart at
sample 1); there the overlap-added sum before the division is held at 1e-4
instead.  ``griffin_lim_device`` started from JAX's initial phase
(``jax.random.uniform(PRNGKey(2), shape) * 2π``, passed as ``init_phase``)
within atol 1e-3 of JAX's output after 40 iterations; the convergence test
of tests/test_ops_features.py:207-227 (spectral convergence below 0.15)
from the same initial phase.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.ops import inversion as ji
from odin_tpu.preprocessing import signal as jsig
from odin_tpu_torch.ops import inversion as ti

torch.set_num_threads(2)

L, H = 256, 64
TOL = 1e-4
GL_ATOL = 1e-3


def _harmonic():
  t = np.arange(4096) / 8000.0
  y = np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 440 * t)
  return np.stack([y, np.roll(y, 100)]).astype("f") * 0.3


@pytest.mark.parametrize("n_fft", [None, 512])
def test_stft_and_istft_match_jax(n_fft):
  y = (np.random.RandomState(0).randn(2, 4096) * 0.3).astype("f")
  jre, jim = ji.stft_device(jnp.asarray(y), L, H, n_fft=n_fft)
  re, im = ti.stft_device(y, L, H, n_fft=n_fft, device="cpu")
  np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=TOL, atol=TOL)
  np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=TOL, atol=TOL)
  jy = np.asarray(ji.istft_device(jre, jim, L, H))
  got = ti.istft_device(re, im, L, H, device="cpu")
  _, norm = ti._overlap(L, H, re.shape[1], "hann", torch.device("cpu"))
  norm = norm.numpy()
  inner = norm >= 0.01 * norm.max()
  assert inner.mean() > 0.98
  np.testing.assert_allclose(got.numpy()[:, inner], jy[:, inner], rtol=TOL,
                             atol=TOL)
  np.testing.assert_allclose(got.numpy() * norm, jy * norm, rtol=TOL,
                             atol=TOL)
  if n_fft is None:
    # the host istft, and COLA away from the edges
    S_host = jsig.stft(y[0], L, H, n_fft=256)
    np.testing.assert_allclose(got.numpy()[0], jsig.istft(S_host, L, H),
                               rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(got.numpy()[:, L:-L],
                               y[:, :got.shape[1]][:, L:-L], rtol=1e-3,
                               atol=1e-3)


def test_one_dimensional_input():
  y = (np.random.RandomState(1).randn(2048) * 0.3).astype("f")
  re, im = ti.stft_device(y, L, H, device="cpu")
  assert re.shape == (1, 1 + (2048 - L) // H, L // 2 + 1)
  assert ti.istft_device(re[0], im[0], L, H, device="cpu").shape == \
      (1, 2048)


def _jax_phase(shape):
  return np.array(jax.random.uniform(jax.random.PRNGKey(2), shape) * 2 *
                    jnp.pi)


def test_griffin_lim_from_jax_phase_matches_jax():
  y = _harmonic()
  re, im = ji.stft_device(jnp.asarray(y), L, H)
  mag = jnp.sqrt(re ** 2 + im ** 2)
  want = ji.griffin_lim_device(mag, L, H, 40, key=jax.random.PRNGKey(2))
  got = ti.griffin_lim_device(np.array(mag), L, H, 40,
                              init_phase=_jax_phase(mag.shape), device="cpu")
  assert got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=GL_ATOL)


def test_griffin_lim_converges():
  """Spectral convergence on a harmonic target (the JAX package's test, from
  its initial phase); the port's own draw (a torch.Generator) is seeded."""
  y = _harmonic()
  re, im = ti.stft_device(y, L, H, device="cpu")
  mag = torch.sqrt(re ** 2 + im ** 2)
  y_rec = ti.griffin_lim_device(mag, L, H, 40,
                                init_phase=_jax_phase(tuple(mag.shape)),
                                device="cpu")
  re2, im2 = ti.stft_device(y_rec, L, H, device="cpu")
  mag2 = torch.sqrt(re2 ** 2 + im2 ** 2)[:, :mag.shape[1]]
  err = float(torch.linalg.norm(mag2 - mag) / torch.linalg.norm(mag))
  assert err < 0.15, f"spectral convergence {err}"
  assert bool(torch.isfinite(y_rec).all())
  a = ti.griffin_lim_device(mag, L, H, 2, device="cpu")
  b = ti.griffin_lim_device(mag, L, H, 2, device="cpu",
                            generator=torch.Generator().manual_seed(1))
  assert torch.equal(a, b)
