"""The port's corpus extraction (``DeviceCorpusProcessor``, the feature store
and ``validate_features``) against the JAX package on the CPU.

Seven ragged utterances of the synthetic speaker corpus (0.6-1.5 s at 16
kHz, made with numpy from a seed) are written as int16 wav files and go
through both packages' ``DeviceCorpusProcessor`` with ``pad_seconds`` fixed,
so that JAX compiles one shape.  Limits: ``mspec`` within 0.01 dB (the JAX
package's log-mel limit, tests/test_ops_features.py); ``mfcc_cmvn`` within
rtol 5e-3 and atol 5e-3 (tests/test_preprocessing.py:382); ``vad`` equal on
at least 99.9 % of the frames; the indices equal; the float64 sums within
rtol 1e-5, except ``mfcc_cmvn``'s ``sum1``, a sum of per-utterance
normalized values that is zero but for rounding, held within atol
1e-3·sqrt(frames).  The float16 transfer is held to the float32 store at
rtol 2e-3 and atol 2e-2 (tests/test_preprocessing.py:406).
"""
import os
import pickle

import numpy as np
import pytest
import torch

from odin_tpu.fuel.dataset import Dataset as JaxDataset
from odin_tpu.fuel.audio_data import synth_speaker_corpus
from odin_tpu.preprocessing.processor import \
    DeviceCorpusProcessor as JaxProcessor
from odin_tpu.preprocessing.processor import \
    validate_features as jax_validate_features
from odin_tpu.preprocessing.speech import save_wave
from odin_tpu_torch.fuel.dataset import Dataset
from odin_tpu_torch.preprocessing import (DeviceCorpusProcessor,
                                          validate_features)

torch.set_num_threads(2)

SR = 16000
FEATS = ("mspec", "mfcc_cmvn", "vad")
PAD_SECONDS = 1.5
N_FILES = 7
BATCH = 3
MSPEC_ATOL = 0.01
CMVN_TOL = 5e-3
VAD_SHARE = 0.999
SUM_RTOL = 1e-5
F16_RTOL, F16_ATOL = 2e-3, 2e-2


def _lengths():
  return np.random.RandomState(1).randint(int(0.6 * SR), int(1.5 * SR) + 1,
                                          N_FILES)


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
  root = tmp_path_factory.mktemp("wavs")
  utts, _ = synth_speaker_corpus(2, 4, seed=3, sr=SR, dur=PAD_SECONDS)
  files = []
  for i, (y, n) in enumerate(zip(utts, _lengths())):
    path = str(root / f"utt{i}.wav")
    save_wave(path, y[:n], SR)
    files.append(path)
  return files


@pytest.fixture(scope="module")
def stores(wav_files, tmp_path_factory):
  """The port's float32 and float16 stores and JAX's float32 store."""
  root = tmp_path_factory.mktemp("stores")
  kw = dict(features=FEATS, batch_size=BATCH, pad_seconds=PAD_SECONDS)
  port = DeviceCorpusProcessor(wav_files, str(root / "port"), device="cpu",
                               **kw).run()
  port16 = DeviceCorpusProcessor(wav_files, str(root / "port16"),
                                 device="cpu", transfer_dtype="float16",
                                 **kw).run()
  jax_ds = JaxProcessor(wav_files, str(root / "jax"), **kw).run()
  return port, port16, jax_ds


def test_the_stores_match_jax(stores):
  port, _, jax_ds = stores
  assert sorted(port.keys()) == sorted(jax_ds.keys())
  names = [f"utt{i}.wav" for i in range(N_FILES)]
  for feat in FEATS:
    idx, jidx = port[f"indices_{feat}"], jax_ds[f"indices_{feat}"]
    assert sorted(idx) == sorted(jidx) == sorted(names)
    for name in names:
      assert idx[name] == jidx[name], (feat, name)
    got, want = np.asarray(port[feat][:]), np.asarray(jax_ds[feat][:])
    assert got.shape == want.shape and got.dtype == want.dtype, feat
  got, want = np.asarray(port["mspec"][:]), np.asarray(jax_ds["mspec"][:])
  np.testing.assert_allclose(got, want, rtol=0, atol=MSPEC_ATOL)
  got = np.asarray(port["mfcc_cmvn"][:])
  want = np.asarray(jax_ds["mfcc_cmvn"][:])
  np.testing.assert_allclose(got, want, rtol=CMVN_TOL, atol=CMVN_TOL)
  got, want = np.asarray(port["vad"][:]), np.asarray(jax_ds["vad"][:])
  assert got.dtype == np.uint8 and got.shape[1] == 1
  assert (got == want).mean() >= VAD_SHARE


def test_the_indices_count_each_utterances_frames(stores):
  port, _, _ = stores
  from odin_tpu_torch.ops.features import FeatureConfig
  cfg = FeatureConfig()
  for feat in FEATS:
    idx = port[f"indices_{feat}"]
    ends = []
    for i, n in enumerate(_lengths()):
      start, end = idx[f"utt{i}.wav"]
      assert type(start) is int and type(end) is int
      assert end - start == cfg.n_frames(int(n))
      ends.append(end)
    assert max(ends) == len(port[feat])
  with open(os.path.join(port.path, "indices_mspec.idx"), "rb") as f:
    index = pickle.load(f)
  assert all(type(v) is int for off_len in index.values() for v in off_len)
  assert port.attrs["frames"] == sum(cfg.n_frames(int(n)) for n in _lengths())
  assert set(port.attrs["phase_sec"]) == {"decode", "pad", "dispatch",
                                          "device_wait", "write"}
  assert port.attrs["frames_per_sec"] > 0
  assert os.path.exists(os.path.join(port.path, "log.txt"))


def test_the_sums_match_the_rows_and_jax(stores):
  port, _, jax_ds = stores
  frames = port.attrs["frames"]
  for feat in ("mspec", "mfcc_cmvn"):
    rows = np.asarray(port[feat][:], np.float64)
    s1, s2 = port[f"{feat}_sum1"], port[f"{feat}_sum2"]
    assert s1.dtype == s2.dtype == np.float64
    np.testing.assert_allclose(s1, rows.sum(0), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(s2, (rows ** 2).sum(0), rtol=1e-12)
    np.testing.assert_allclose(s2, jax_ds[f"{feat}_sum2"], rtol=SUM_RTOL)
    if feat == "mspec":
      np.testing.assert_allclose(s1, jax_ds[f"{feat}_sum1"], rtol=SUM_RTOL)
    else:
      np.testing.assert_allclose(s1, jax_ds[f"{feat}_sum1"], rtol=0,
                                 atol=1e-3 * frames ** 0.5)
  assert "vad_sum1" not in port


def test_float16_transfer_matches_float32(stores):
  port, port16, _ = stores
  for feat in ("mspec", "mfcc_cmvn"):
    a, b = np.asarray(port[feat][:]), np.asarray(port16[feat][:])
    assert b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=F16_RTOL, atol=F16_ATOL)
  np.testing.assert_array_equal(np.asarray(port16["vad"][:]),
                                np.asarray(port["vad"][:]))
  for name in port["indices_mspec"]:
    assert port16["indices_mspec"][name] == port["indices_mspec"][name]


def test_stores_open_in_the_other_package(stores):
  """A store written by the port opens in JAX's Dataset, and one written by
  JAX in the port's, with the same items, rows, indices and sums."""
  port, _, jax_ds = stores
  for writer, reader_cls in ((port, JaxDataset), (jax_ds, Dataset)):
    other = reader_cls(writer.path)
    assert sorted(other.keys()) == sorted(writer.keys())
    for key in writer.keys():
      a, b = writer[key], other[key]
      if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
      else:
        assert dict(a.items()) == dict(b.items())
  assert port.get_md5_checksum() == JaxDataset(port.path).get_md5_checksum()


def test_validate_features_reports_as_jax(stores):
  port, _, jax_ds = stores
  for feat in FEATS:
    want = jax_validate_features(jax_ds.path, feat)
    assert validate_features(port.path, feat) == want
    assert validate_features(jax_ds.path, feat) == want
  report = validate_features(port, "mspec")
  assert report["n_utterances"] == N_FILES
  assert report["n_nan"] == report["n_inf"] == 0


def test_pipeline_depth_gives_the_same_store(wav_files, stores, tmp_path):
  port, _, _ = stores
  ds = DeviceCorpusProcessor(wav_files, str(tmp_path / "d1"), features=FEATS,
                             batch_size=BATCH, pad_seconds=PAD_SECONDS,
                             pipeline_depth=1, device="cpu").run()
  for feat in FEATS:
    np.testing.assert_array_equal(np.asarray(ds[feat][:]),
                                  np.asarray(port[feat][:]))


def _write_sphere(path, codewords, sr):
  """A NIST SPHERE file of mono G.711 mu-law codewords."""
  fields = (f"sample_rate -i {sr}\nchannel_count -i 1\n"
            "sample_n_bytes -i 1\nsample_coding -s4 ulaw\n"
            f"sample_count -i {len(codewords)}\nend_head\n")
  header = ("NIST_1A\n   1024\n" + fields).encode("ascii")
  with open(path, "wb") as f:
    f.write(header + b" " * (1024 - len(header)) + codewords.tobytes())


def test_sphere_mu_law_branch(tmp_path):
  """A .sph file ships its raw mu-law codewords (padded with 0xFF, which
  decodes to 0): the same store as JAX's, and as the codewords given as a
  (name, array) pair."""
  rs = np.random.RandomState(5)
  files = []
  for i, n in enumerate((SR, SR - 3000)):
    path = str(tmp_path / f"u{i}.sph")
    _write_sphere(path, rs.randint(0, 256, n).astype(np.uint8), SR)
    files.append(path)
  kw = dict(features=FEATS, batch_size=2, pad_seconds=1.0)
  port = DeviceCorpusProcessor(files, str(tmp_path / "port"), device="cpu",
                               **kw).run()
  jax_ds = JaxProcessor(files, str(tmp_path / "jax"), **kw).run()
  from odin_tpu_torch.preprocessing.speech import read_sphere
  pairs = [(os.path.basename(f), read_sphere(f, raw=True)[0]) for f in files]
  assert pairs[0][1].dtype == np.uint8
  same = DeviceCorpusProcessor(pairs, str(tmp_path / "pairs"), device="cpu",
                               **kw).run()
  for name, _ in pairs:
    assert port["indices_mspec"][name] == jax_ds["indices_mspec"][name]
  np.testing.assert_allclose(np.asarray(port["mspec"][:]),
                             np.asarray(jax_ds["mspec"][:]), rtol=0,
                             atol=MSPEC_ATOL)
  np.testing.assert_array_equal(np.asarray(same["mspec"][:]),
                                np.asarray(port["mspec"][:]))


def test_cuda_device_without_a_card_raises(wav_files, tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a card is visible: the CUDA path runs in test_torch_cuda.py")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    DeviceCorpusProcessor(wav_files, str(tmp_path / "c"))
