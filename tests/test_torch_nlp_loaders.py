"""The port's text readers (``odin_tpu_torch/fuel/nlp_data.py``) and
archive loaders (``odin_tpu_torch/fuel/loaders.py``) against the JAX
package's, on small files and corpora the tests write (the repository
holds none of the real ones).

* The port's ``TfidfVectorizer`` against scikit-learn's at the settings
  ``Newsgroup20`` uses (the same vocabulary in the same order, values
  within 1e-12 of float64's largest), on a corpus with stop words, upper
  case, digits, one-letter tokens, accents and tied term counts at the
  ``max_features`` cut.
* ``Newsgroup20`` and ``Newsgroup5`` with ``sklearn.datasets.
  fetch_20newsgroups`` replaced by the test corpus for both packages: the
  same float32 arrays (within 1e-6) and labels in every partition; a
  missing cache raises ``FileNotFoundError`` in both.
* ``Newsgroup20_clean``, ``TinyShakespear``, ``ImdbReview``, ``DataLoader``
  (``.npz`` and folder), ``load_glove`` and IRIS equal to JAX's.
"""
import os

import numpy as np
import pytest
from sklearn.datasets import load_iris as sk_iris
from sklearn.feature_extraction.text import TfidfVectorizer as SkTfidf
from sklearn.utils import Bunch

import odin_tpu.fuel.loaders as JL
import odin_tpu.fuel.nlp_data as JN
import odin_tpu_torch.fuel.loaders as PL
import odin_tpu_torch.fuel.nlp_data as PN

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega "
         "café naïve über 2024 x9 ab").split()
STOP = ("the and of to in is it you that he was for on are with as i his "
        "they be at one have this from").split()


def _corpus(n_docs, seed):
  rs = np.random.RandomState(seed)
  docs = []
  for _ in range(n_docs):
    words = rs.choice(WORDS + STOP, size=rs.randint(0, 30),
                      p=None).tolist()
    words = [w.upper() if rs.rand() < 0.1 else w for w in words]
    docs.append(" ".join(words) + rs.choice(["", ".", "!", " a b c", ", 7"]))
  return docs


@pytest.mark.parametrize("max_features", [None, 12, 20])
def test_vectorizer_matches_sklearn(max_features):
  train, test = _corpus(200, 0), _corpus(50, 1)
  sk = SkTfidf(max_features=max_features, stop_words="english")
  want = sk.fit_transform(train).toarray()
  mine = PN.TfidfVectorizer(max_features=max_features, stop_words="english")
  got = mine.fit_transform(train)
  assert list(mine.get_feature_names_out()) == list(
      sk.get_feature_names_out())
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
  np.testing.assert_allclose(mine.idf_, sk.idf_, rtol=1e-15)
  np.testing.assert_allclose(mine.transform(test),
                             sk.transform(test).toarray(), rtol=0,
                             atol=1e-12)
  assert PN.ENGLISH_STOP_WORDS == \
      __import__("sklearn.feature_extraction.text",
                 fromlist=["x"]).ENGLISH_STOP_WORDS


def test_max_features_tie_break_is_sklearns():
  """Twenty terms, each seen exactly twice: which ten survive is
  ``argsort``'s choice among equal counts, the same in both."""
  docs = [" ".join(WORDS[:20])] * 2
  sk = SkTfidf(max_features=10, stop_words="english").fit(docs)
  mine = PN.TfidfVectorizer(max_features=10)
  mine.fit_transform(docs)
  assert list(mine.get_feature_names_out()) == list(
      sk.get_feature_names_out())


def _fake_fetch(monkeypatch, n_train=120, n_test=40):
  import sklearn.datasets
  rs = np.random.RandomState(5)
  data = {"train": Bunch(data=_corpus(n_train, 2),
                         target=rs.randint(0, 20, n_train)),
          "test": Bunch(data=_corpus(n_test, 3),
                        target=rs.randint(0, 20, n_test))}

  def fetch(subset="train", download_if_missing=True, **kwargs):
    assert download_if_missing is False
    return data[subset]
  monkeypatch.setattr(sklearn.datasets, "fetch_20newsgroups", fetch)


@pytest.mark.parametrize("cls", ["Newsgroup20", "Newsgroup5"])
def test_newsgroups_match_jax(monkeypatch, cls):
  _fake_fetch(monkeypatch)
  port, jax_ds = getattr(PN, cls)(n_words=15), getattr(JN, cls)(n_words=15)
  assert port.name == jax_ds.name and port.labels == jax_ds.labels
  assert port.shape == jax_ds.shape == (15,)
  for part in ("train", "valid", "test"):
    (x, y), (jx, jy) = port._load(part), jax_ds._load(part)
    assert x.dtype == jx.dtype == np.float32
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y, jy)


def test_newsgroups_without_the_cache_raise(monkeypatch):
  import sklearn.datasets

  def missing(**kwargs):
    raise OSError("20newsgroups not found")
  monkeypatch.setattr(sklearn.datasets, "fetch_20newsgroups", missing)
  with pytest.raises(FileNotFoundError) as err:
    PN.Newsgroup20()._load("train")
  with pytest.raises(FileNotFoundError) as jerr:
    JN.Newsgroup20()._load("train")
  assert str(err.value) == str(jerr.value)


def test_newsgroup20_clean_matches_jax(tmp_path):
  rs = np.random.RandomState(0)
  path = str(tmp_path / "newsgroup20_clean.npz")
  np.savez(path, x_train=rs.poisson(1.0, (50, 7)).astype(np.float32),
           x_test=rs.poisson(1.0, (9, 7)).astype(np.float32),
           vocab=np.array(WORDS[:7]))
  port, jax_ds = PN.Newsgroup20_clean(path), JN.Newsgroup20_clean(path)
  assert port.vocabulary == jax_ds.vocabulary
  assert port.vocabulary_size == 7 and port.shape == jax_ds.shape
  for part in ("train", "valid", "test"):
    (x, y), (jx, jy) = port._load(part), jax_ds._load(part)
    np.testing.assert_array_equal(x, jx)
    assert y is None and jy is None
  with pytest.raises(FileNotFoundError, match="newsgroup20_clean"):
    PN.Newsgroup20_clean(str(tmp_path / "none.npz"))._load("train")


@pytest.mark.parametrize("cls", ["TinyShakespear", "ImdbReview"])
def test_text_corpora_match_jax(tmp_path, monkeypatch, cls):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path))
  port, jax_ds = getattr(PN, cls)(seq_len=16), getattr(JN, cls)(seq_len=16)
  assert port.path == jax_ds.path
  with pytest.raises(FileNotFoundError) as err:
    port._load("train")
  with pytest.raises(FileNotFoundError) as jerr:
    jax_ds._load("train")
  assert str(err.value) == str(jerr.value)
  text = "".join(_corpus(40, 4)) + "ünïcödé\n" * 3
  with open(port.path, "w", encoding="utf-8") as f:
    f.write(text)
  for part in ("train", "valid", "test"):
    (x, _), (jx, _) = port._load(part), jax_ds._load(part)
    assert x.dtype == np.int64
    np.testing.assert_array_equal(x, jx)
  assert port.char_to_id == jax_ds.char_to_id


def test_loaders_match_jax(tmp_path, monkeypatch):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path))
  from odin_tpu_torch.utils import get_data_path
  data = get_data_path()
  assert data == os.path.join(str(tmp_path), "datasets")
  np.savez(os.path.join(data, "tidigits.npz"), x=np.arange(6.0), y=[1, 2])
  got, want = PL.load("tidigits"), JL.load("tidigits")
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k])
  assert PL.TIDIGITS().is_available and PL.TIDIGITS().name == "tidigits"
  os.makedirs(os.path.join(data, "musan"))
  from odin_tpu_torch.fuel.dataset import Dataset
  ds = PL.MUSAN().load()
  assert isinstance(ds, Dataset) and ds.read_only
  for loader in (PL.DataLoader("cmuarctic"), PL.openSMILEsad()):
    assert not loader.is_available
    with pytest.raises(FileNotFoundError) as err:
      loader.load()
    with pytest.raises(FileNotFoundError) as jerr:
      JL.DataLoader(loader.name).load()
    assert str(err.value) == str(jerr.value)
  names = [n for n in JL.__all__ if n not in ("DataLoader", "load",
                                              "load_glove")]
  for name in names:
    assert getattr(PL, name)().name == getattr(JL, name)().name


def test_iris_is_sklearns():
  x, y = PL.IRIS().load()
  jx, jy = JL.IRIS().load()
  sk = sk_iris()
  assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
  np.testing.assert_array_equal(x, jx)
  np.testing.assert_array_equal(x, sk.data.astype(np.float32))
  np.testing.assert_array_equal(y, sk.target)


def test_load_glove_matches_jax(tmp_path):
  path = str(tmp_path / "glove.6B.4d.txt")
  rs = np.random.RandomState(0)
  with open(path, "w", encoding="utf-8") as f:
    for w in WORDS[:6] + [",", "."]:
      f.write(w + " " + " ".join(f"{v:.6f}" for v in rs.randn(4)) + "\n")
  got, want = PL.load_glove(4, path), JL.load_glove(4, path)
  assert list(got) == list(want)
  for k in want:
    assert got[k].dtype == np.float32
    np.testing.assert_array_equal(got[k], want[k])
  with pytest.raises(FileNotFoundError, match="GloVe"):
    PL.load_glove(4, str(tmp_path / "none.txt"))
