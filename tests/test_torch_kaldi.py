"""The port's Kaldi interop (``odin_tpu_torch/preprocessing/kaldi.py``)
against the JAX package's on the CPU.

Archives round-trip (float, double, vectors, compressed matrices), and a
file either package writes is byte-equal to the other's and readable by
it.  The post-processors, ``count_frames``, ``KaldiFeaturesReader`` and
``KaldiDataset`` are NumPy copies: equal bit for bit on the same archives.
The checks of tests/test_kaldi.py are repeated on the port.
"""
import numpy as np
import pytest

from odin_tpu.preprocessing import kaldi as J
from odin_tpu_torch.preprocessing import kaldi as P
from torch_speech_common import assert_same


@pytest.fixture
def ark(tmp_path):
  rng = np.random.RandomState(0)
  data = {f"utt{i}": rng.randn(50 + 10 * i, 13).astype("f")
          for i in range(5)}
  path, scp = str(tmp_path / "feats.ark"), str(tmp_path / "feats.scp")
  specs = P.write_ark(path, data, scp_path=scp)
  return data, path, scp, specs


def test_ark_roundtrip(ark):
  data, path, scp, specs = ark
  for key, spec in specs.items():
    np.testing.assert_array_equal(P.read_mat(spec), data[key])
  loaded = dict(P.read_ark(path))
  assert sorted(loaded) == sorted(data)
  for key, arr in dict(P.read_scp(scp)).items():
    np.testing.assert_array_equal(arr, data[key])


def _objects():
  rng = np.random.RandomState(1)
  return {"f": rng.randn(30, 6).astype("f"),
          "d": rng.randn(7, 3),
          "v": rng.randn(11).astype("f"),
          "dv": rng.randn(5)}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_archives_cross_packages(tmp_path, writer, compress):
  """A file one package writes equals the other's byte for byte, and each
  reads it to the same arrays (compressed matrices too)."""
  objs = _objects()
  w, other = (P, J) if writer == "port" else (J, P)
  a, b = str(tmp_path / "a.ark"), str(tmp_path / "b.ark")
  specs = w.write_ark(a, objs, scp_path=a + ".scp", compress=compress)
  other.write_ark(b, objs, scp_path=b + ".scp", compress=compress)
  assert open(a, "rb").read() == open(b, "rb").read()
  for key, spec in specs.items():
    reader = "read_mat" if objs[key].ndim == 2 else "read_vec"
    assert_same(getattr(P, reader)(spec), getattr(J, reader)(spec), key)
  assert_same(dict(P.read_ark(a)), dict(J.read_ark(a)))
  assert_same(dict(P.read_scp(a + ".scp")), dict(J.read_scp(a + ".scp")))


def test_vector_and_double(tmp_path):
  v = np.arange(7, dtype="f")
  d = np.arange(12, dtype="f8").reshape(3, 4)
  specs = P.write_ark(str(tmp_path / "v.ark"), {"v": v, "d": d})
  np.testing.assert_array_equal(P.read_vec(specs["v"]), v)
  out = P.read_mat(specs["d"])
  assert out.dtype == np.float64
  np.testing.assert_array_equal(out, d)
  with pytest.raises(ValueError):
    P.read_mat(specs["v"])
  with pytest.raises(ValueError):
    P.read_vec(specs["d"])
  with pytest.raises(ValueError):
    P.write_ark(str(tmp_path / "x.ark"), {"x": np.zeros((2, 2, 2))})


def test_compressed_roundtrip(tmp_path):
  x = (np.random.RandomState(1).randn(200, 20) * 3).astype("f")
  specs = P.write_ark(str(tmp_path / "c.ark"), {"u": x}, compress=True)
  y = P.read_mat(specs["u"])
  assert np.abs(y - x).max() < 0.25
  assert np.corrcoef(y.ravel(), x.ravel())[0, 1] > 0.999


def test_count_frames(ark, tmp_path):
  data, path, scp, specs = ark
  counts = P.count_frames(list(specs.values()), is_matrix=True)
  assert counts == [len(data[k]) for k in specs]
  sad = np.array([1, 1, 0, 1], "f")
  sspec = P.write_ark(str(tmp_path / "sad.ark"), {"s": sad})["s"]
  assert P.count_frames([sspec, sspec + "&" + sspec]) == [3, 6]
  cspec = P.write_ark(str(tmp_path / "c.ark"), {"c": data["utt1"]},
                      compress=True)["c"]
  assert P.count_frames([cspec], is_matrix=True) == \
      J.count_frames([cspec], is_matrix=True) == [60]


POST = [
    ("compute_deltas", {}),
    ("compute_deltas", {"order": 1, "window": 3}),
    ("compute_shifted_deltas", {}),
    ("compute_shifted_deltas", {"window": 2, "block_shift": 2,
                                "num_blocks": 3}),
    ("sliding_window_cmn", {}),
    ("sliding_window_cmn", {"window": 30, "min_window": 10}),
    ("sliding_window_cmn", {"window": 25, "center": True,
                            "normalize_variance": True}),
]


@pytest.mark.parametrize("name,kwargs", POST,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(POST)])
def test_postprocessing_matches_jax(name, kwargs):
  x = (np.random.RandomState(2).randn(150, 8) * 4 + 1).astype("f")
  assert_same(getattr(P, name)(x, **kwargs), getattr(J, name)(x, **kwargs))


def test_deltas_and_cmn_semantics():
  x = np.arange(20, dtype="f")[:, None]
  d = P.compute_deltas(x, order=1, window=2)
  assert d.shape == (20, 2)
  np.testing.assert_allclose(d[5:-5, 1], 1.0, atol=1e-6)
  sdc = P.compute_shifted_deltas(x, window=1, block_shift=3, num_blocks=7)
  assert sdc.shape == (20, 8)
  cmn = P.sliding_window_cmn(np.ones((50, 3), "f") * 7.0, window=10)
  np.testing.assert_allclose(cmn, 0.0, atol=1e-6)
  y = np.random.RandomState(2).randn(500, 4).astype("f") * 5 + 3
  z = P.sliding_window_cmn(y, window=200, normalize_variance=True)
  assert abs(float(z.std()) - 1.0) < 0.15


def test_features_reader_pipeline(ark):
  data, path, scp, specs = ark
  kwargs = dict(delta_order=2, delta_window=2, cmn_window=30,
                cmn_min_window=10, sdelta_block_shift=3, sdelta_num_blocks=2,
                sdelta_window=1)
  reader = P.KaldiFeaturesReader("mfcc", **kwargs)
  jreader = J.KaldiFeaturesReader("mfcc", **kwargs)
  one = specs["utt0"]
  both = specs["utt0"] + "&" + specs["utt1"]
  assert reader.transform(one).shape == (50, 13 * 3 * 3)
  assert reader.transform(both).shape == (110, 117)
  for spec in (one, both):
    assert_same(reader.transform(spec), jreader.transform(spec))


def _dataset_ark(tmp_path):
  rng = np.random.RandomState(3)
  feats, sads, labels = {}, {}, []
  for i in range(12):
    n = 80 + int(rng.randint(0, 40))
    feats[f"u{i}"] = rng.randn(n, 8).astype("f")
    sads[f"u{i}"] = (rng.rand(n) > 0.2).astype("f")
    labels.append(i % 3)
  fs = P.write_ark(str(tmp_path / "f.ark"), feats)
  ss = P.write_ark(str(tmp_path / "s.ark"), sads)
  return [fs[k] for k in feats], [ss[k] for k in feats], labels


DATASETS = [
    dict(sad=True, batch_size=4, post_processing="xvector",
         clipping=(30, 50), batch_strategy="stratify", min_utt_per_batch=2,
         seed=1),
    dict(sad=True, batch_size=3, post_processing="ivector", shuffle=True,
         shuffle_batches=True),
    dict(sad=False, batch_size=5, post_processing="flatten",
         clipping=(20, 40), clipping_per_batch=False, batch_drop_last=True),
    dict(sad=False, batch_strategy="utt", min_frames_per_utt=90,
         return_labels=False),
    dict(sad=True, batch_size=4, batch_strategy="stratify",
         utt_per_label_in_epoch=2, min_utt_per_label=4, seed=7),
]


@pytest.mark.parametrize("kwargs", DATASETS, ids=range(len(DATASETS)))
def test_dataset_matches_jax(tmp_path, kwargs):
  fspecs, sspecs, labels = _dataset_ark(tmp_path)
  kwargs = dict(kwargs)
  with_sad = kwargs.pop("sad")
  out = []
  for M in (P, J):
    desc = {M.KaldiFeaturesReader("mfcc"): fspecs}
    if with_sad:
      desc[M.KaldiFeaturesReader("sad", is_matrix=False)] = sspecs
    ds = M.KaldiDataset(desc, sad_name="sad" if with_sad else None,
                        labels=labels, **kwargs)
    out.append([ds[i] for i in range(len(ds))])
  assert len(out[0]) == len(out[1]) > 0
  assert_same(out[0], out[1])


def test_dataset_xvector_batches(tmp_path):
  fspecs, sspecs, labels = _dataset_ark(tmp_path)
  ds = P.KaldiDataset({P.KaldiFeaturesReader("mfcc"): fspecs,
                       P.KaldiFeaturesReader("sad", is_matrix=False): sspecs},
                      sad_name="sad", labels=labels, batch_size=4,
                      post_processing="xvector", clipping=(30, 50),
                      batch_strategy="stratify", min_utt_per_batch=2, seed=1)
  assert len(ds) >= 2
  (x,), y = ds[0]
  assert x.ndim == 3 and x.shape[0] == 4 and x.shape[2] == 8
  assert 30 <= x.shape[1] <= 50
  assert len(set(y.tolist())) >= 2
  (x2,), _ = ds[0]
  np.testing.assert_array_equal(x, x2)
  assert len(list(ds.create_dataloader())) == len(ds)


def test_dataset_ivector_repeats_labels(tmp_path):
  rng = np.random.RandomState(4)
  feats = {f"u{i}": rng.randn(30, 5).astype("f") for i in range(6)}
  fs = P.write_ark(str(tmp_path / "f.ark"), feats)
  ds = P.KaldiDataset({P.KaldiFeaturesReader("m"): list(fs.values())},
                      labels=[0, 0, 1, 1, 2, 2], batch_size=3,
                      post_processing="ivector")
  (x,), y = ds[0]
  assert x.shape == (90, 5) and len(y) == 90
  with pytest.raises(ValueError):
    P.KaldiDataset({P.KaldiFeaturesReader("m"): list(fs.values())},
                   sad_name="nope")
