"""AudioFeatureLoader: a dataset of framed audio features (PyTorch port of
``odin_tpu/fuel/audio_data.py``).  Wav files or arrays are padded into one
block on the host and go to the device 64 utterances at a time, pinned on
the card; ``compat="odin"`` runs ``speech_features`` (K1 unless the feature
is ``"spec"``), ``compat="tf"`` the tf.signal path.  A corpus of wav paths
is decoded and packed by the native IO engine (``native.pack_batch``), as
in the JAX package; a list holding arrays by the port's ``read_wave``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.fuel.dataset_base import IterableDataset, get_partition

__all__ = ["AudioFeatureLoader", "synth_speaker_corpus"]

_BATCH = 64  # utterances a device call


class AudioFeatureLoader(IterableDataset):
  """Load utterances, extract their features on `device`, serve batches.

  `dataset` is a list of wav paths, a directory of wav files, or a list of
  (array, sr) tuples or arrays; frame_length/frame_step are in samples.
  Features are extracted once, at the first ``create_dataset``/``numpy``,
  and kept on the host.
  """

  def __init__(self,
               dataset: Union[str, Sequence],
               sr: int = 16000,
               frame_length: int = 400,
               frame_step: int = 160,
               n_fft: int = 512,
               n_mels: int = 40,
               n_ceps: int = 20,
               fmin: float = 64.0,
               fmax: Optional[float] = None,
               top_db: float = 80.0,
               feature: str = "mspec",
               labels: Optional[Sequence] = None,
               max_duration: float = 4.0,
               compat: str = "odin",
               log_mels: bool = False,
               seed: int = 1,
               device: Union[str, torch.device] = "cuda"):
    super().__init__(seed=seed)
    from odin_tpu_torch.ops.features import FeatureConfig, TFCompatConfig
    assert compat in ("odin", "tf"), compat
    self.compat = compat
    self.device = resolve_device(device)
    if compat == "tf":
      # tf.signal semantics: HTK mel, periodic Hann, no pre-emphasis,
      # fft_length the next power of 2
      assert feature in ("mels", "spec", "mfcc"), \
          f"compat='tf' supports mels/spec/mfcc, got {feature!r}"
      self.config = TFCompatConfig(
          frame_length=frame_length, frame_step=frame_step,
          fft_length=n_fft, sample_rate=sr, top_DB=top_db,
          num_mel_bins=n_mels,
          num_cepstral=n_ceps if feature == "mfcc" else None,
          log_mels=log_mels,
          lower_edge_hertz=fmin,
          upper_edge_hertz=fmax if fmax is not None else sr / 2 - 200.0)
      self.config.sr = sr  # the attribute _load_audio reads
    else:
      self.config = FeatureConfig(sr=sr, frame_length=frame_length,
                                  step_length=frame_step, n_fft=n_fft,
                                  n_mels=n_mels, n_ceps=n_ceps, fmin=fmin,
                                  fmax=fmax, top_db=top_db)
    self.feature = feature
    self.max_samples = int(max_duration * sr)
    if isinstance(dataset, str):
      paths = sorted(os.path.join(dataset, f) for f in os.listdir(dataset)
                     if f.lower().endswith(".wav"))
      self._items: List = paths
    else:
      self._items = list(dataset)
    self._labels = np.asarray(labels) if labels is not None else None
    self._cache = None

  @property
  def name(self):
    return "audiofeatures"

  @property
  def shape(self):
    n_frames = self.config.n_frames(self.max_samples)
    if self.compat == "tf":
      dim = {"mels": self.config.num_mel_bins,
             "mfcc": self.config.num_cepstral or self.config.num_mel_bins,
             "spec": self.config.fft_length // 2 + 1}[self.feature]
    else:
      dim = {"mspec": self.config.n_mels, "mspec_cmvn": self.config.n_mels,
             "mfcc": self.config.n_ceps, "mfcc_cmvn": self.config.n_ceps,
             "spec": self.config.n_fft // 2 + 1}[self.feature]
    return (n_frames, dim)

  def _load_audio(self, item) -> Tuple[np.ndarray, int]:
    from odin_tpu_torch.preprocessing.speech import read_wave
    if isinstance(item, str):
      y, sr = read_wave(item)
      if y.ndim > 1:
        y = y.mean(-1)
    elif isinstance(item, (tuple, list)):
      y, sr = np.asarray(item[0]), int(item[1])
    else:
      y, sr = np.asarray(item), self.config.sr
    return np.asarray(y, np.float32), sr

  def _pack(self) -> Tuple[np.ndarray, np.ndarray]:
    """The utterances as one zero-padded (n, max_samples) float32 block and
    their lengths.  A corpus of wav paths must hold the config's rate; a
    list with arrays is resampled item by item."""
    T = self.max_samples
    if all(isinstance(i, str) for i in self._items):
      # native ingest: C++ decode and pack straight into the padded block
      from odin_tpu_torch.native import pack_batch
      batch, lengths, srs = pack_batch(list(self._items), T)
      if not all(s in (0, self.config.sr) for s in srs):
        raise ValueError("sample-rate mismatch in corpus; resample first")
      return batch, lengths
    batch = np.zeros((len(self._items), T), np.float32)
    lengths = np.zeros(len(self._items), np.int32)
    for i, item in enumerate(self._items):
      y, sr = self._load_audio(item)
      if sr != self.config.sr:
        from math import gcd
        from scipy.signal import resample_poly
        g = gcd(self.config.sr, sr)
        y = resample_poly(y, self.config.sr // g, sr // g).astype(np.float32)
      y = y[:T]
      batch[i, :len(y)] = y
      lengths[i] = len(y)
    return batch, lengths

  def _extract(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if self._cache is None:
      from odin_tpu_torch.ops.features import (speech_features,
                                               tf_signal_features)
      batch, lengths = self._pack()
      if self.compat == "tf":
        fn = tf_signal_features
      else:
        use_pallas = self.feature != "spec"  # K1 never gives the spectrum
        fn = lambda a, config, lengths, device: speech_features(
            a, config, lengths=lengths, device=device, use_pallas=use_pallas)
      chunks = []
      for i in range(0, len(batch), _BATCH):
        y = torch.from_numpy(batch[i:i + _BATCH])
        n = torch.from_numpy(lengths[i:i + _BATCH])
        if self.device.type == "cuda":
          y = y.pin_memory().to(self.device, non_blocking=True)
          n = n.pin_memory().to(self.device, non_blocking=True)
        out = fn(y, self.config, lengths=n, device=self.device)
        chunks.append(out[self.feature].cpu().numpy())
      self._cache = np.concatenate(chunks, 0)
    return self._cache, self._labels

  def _load(self, partition: str):
    x, y = self._extract()
    n = len(x)
    sl = get_partition(partition, train=slice(0, int(0.8 * n)),
                       valid=slice(int(0.8 * n), int(0.9 * n)),
                       test=slice(int(0.9 * n), n), all=slice(None))
    return x[sl], (y[sl] if y is not None else None)


def synth_speaker_corpus(n_speakers: int,
                         n_utt: int,
                         seed: int = 0,
                         sr: int = 16000,
                         dur: float = 2.0,
                         n_phonemes: int = 12,
                         segs_per_utt: Tuple[int, int] = (6, 10),
                         ) -> Tuple[List[np.ndarray], np.ndarray]:
  """Phoneme-structured synthetic speaker corpus, a stand-in for a
  speaker-recognition corpus whose content varies within utterances (a copy
  of the JAX package's, which gives the same arrays bitwise from a seed).

  Content: a shared inventory of `n_phonemes` phonemes, each a triple of
  base formant frequencies; an utterance is a random phoneme sequence with
  per-segment durations and amplitude envelopes.  Speaker identity: pitch
  f0, a vocal-tract-length factor multiplying ALL formants, and a spectral
  tilt over the formant amplitudes — the classic source/filter split, so
  speaker information is present in every segment while the segment
  sequence (the 'text') is speaker-independent.

  Returns (list of float32 waveforms, int speaker labels).
  """
  rng = np.random.RandomState(seed)
  # shared phoneme inventory
  formants = np.sort(rng.uniform(350, 2900, (n_phonemes, 3)), axis=1)
  # speaker traits
  f0s = rng.uniform(90, 280, n_speakers)
  vtl = rng.uniform(0.85, 1.18, n_speakers)
  tilt = rng.uniform(0.5, 1.6, n_speakers)          # high-formant weighting
  utts, labels = [], []
  T = int(sr * dur)
  for s in range(n_speakers):
    amps = np.array([0.30, 0.22 * tilt[s], 0.12 * tilt[s] ** 2], "f")
    for u in range(n_utt):
      r = np.random.RandomState(seed + 7919 * s + u + 1)
      n_seg = r.randint(segs_per_utt[0], segs_per_utt[1] + 1)
      cuts = np.sort(r.choice(np.arange(1, 20), n_seg - 1, replace=False))
      bounds = np.round(np.concatenate([[0], cuts, [20]]) / 20.0 * T
                        ).astype(int)
      y = np.zeros(T, np.float32)
      t = np.arange(T, dtype=np.float32) / sr
      f0 = f0s[s] * (1.0 + 0.03 * r.randn())
      # voiced source: f0 + octave, present throughout
      y += 0.25 * np.sin(2 * np.pi * f0 * t).astype(np.float32)
      y += 0.08 * np.sin(2 * np.pi * 2 * f0 * t).astype(np.float32)
      for a, b in zip(bounds[:-1], bounds[1:]):
        ph = r.randint(n_phonemes)
        seg_t = t[a:b]
        env = np.hanning(b - a).astype(np.float32) ** 0.5
        for k in range(3):
          fk = formants[ph, k] * vtl[s] * (1.0 + 0.015 * r.randn())
          y[a:b] += amps[k] * env * np.sin(
              2 * np.pi * fk * seg_t + r.uniform(0, 2 * np.pi)
          ).astype(np.float32)
      y += 0.02 * r.randn(T).astype(np.float32)
      utts.append(y)
      labels.append(s)
  return utts, np.asarray(labels)
