"""The port's CUDA kernels on the card against their plain PyTorch versions.

These tests need an NVIDIA card and skip elsewhere.  They import neither
JAX nor the JAX package, so they run on a machine that has only PyTorch:

  python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerance: 0.01 dB
on log-mel, the JAX package's own (tests/test_ops_features.py).
"""
import numpy as np
import pytest
import torch

from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops.logmel import logmel, logmel_reference

MSPEC_ATOL = 0.01

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


def test_speech_features_on_card_matches_cpu(cuda_device):
  rs = np.random.RandomState(9)
  y = (rs.randn(4, 16000) * 0.1 * 32768.0).clip(-32768, 32767).astype(
      np.int16)
  lengths = np.array([16000, 15000, 9000, 401])
  cfg = tf.FeatureConfig()
  before = logmel.launches
  got = tf.speech_features(y, cfg, lengths=lengths, device=cuda_device)
  assert logmel.launches == before + 1
  want = tf.speech_features(y, cfg, lengths=lengths, device="cpu")
  assert got["mspec"].device.type == "cuda"
  np.testing.assert_allclose(got["mspec"].cpu().numpy(),
                             want["mspec"].numpy(), atol=MSPEC_ATOL)
  np.testing.assert_array_equal(got["frame_mask"].cpu().numpy(),
                                want["frame_mask"].numpy())
