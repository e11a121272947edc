"""Shared by the port's classical-ML parity tests: tests/test_ml.py's
speech-like utterances and comparisons scaled by the reference's
magnitude."""
import numpy as np
import torch


def utterances(seed=9, n_utt=60, n_frames=120, n_speakers=6, ndim=12,
               n_phones=4):
  """tests/test_ml.py's `_utterances` layout, from its own RandomState."""
  rng = np.random.RandomState(seed)
  phones = rng.randn(n_phones, ndim).astype("f") * 4.0
  spk_shift = rng.randn(n_speakers, ndim).astype("f") * 1.0
  utts, labels = [], []
  for i in range(n_utt):
    spk = i % n_speakers
    ph = phones[rng.randint(0, n_phones, n_frames)]
    utts.append(ph + spk_shift[spk] + rng.randn(n_frames, ndim).astype("f"))
    labels.append(spk)
  return utts, np.asarray(labels)


def close(got, want, rtol, what=""):
  """|got - want| <= rtol · max|want| elementwise (NaN where want is)."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
      else np.asarray(got)
  want = np.asarray(want)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rtol * np.nanmax(np.abs(want)),
                             err_msg=what)


def up_to_sign(got, want, axis):
  """`got` with the sign of each slice along `axis` matched to `want`'s."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  s = np.sign(np.sum(got * want, axis=axis, keepdims=True))
  return got * s
