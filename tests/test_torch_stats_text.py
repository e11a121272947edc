"""The port's ``stats``, ``preprocessing.text``, ``textgrid``, ``image`` and
``video`` against the JAX package's on the CPU.

The host functions are copies and must give the same results exactly;
``classification_report`` is built from the port's own metrics and must
equal the JAX package's string (which scikit-learn prints) and
scikit-learn's numbers; ``batch_resize`` runs in torch and is held within
1e-5 of ``jax.image.resize``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.preprocessing.image as jax_image
import odin_tpu.preprocessing.text as jax_text
import odin_tpu.preprocessing.textgrid as jax_textgrid
import odin_tpu.preprocessing.video as jax_video
import odin_tpu.stats as jax_stats
import odin_tpu_torch.preprocessing.image as image
import odin_tpu_torch.preprocessing.text as text
import odin_tpu_torch.preprocessing.textgrid as textgrid
import odin_tpu_torch.preprocessing.video as video
import odin_tpu_torch.stats as stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIZE_TOL = 1e-5


@pytest.mark.parametrize("mod,jax_mod", [
    (stats, jax_stats), (text, jax_text), (textgrid, jax_textgrid),
    (image, jax_image), (video, jax_video)],
    ids=["stats", "text", "textgrid", "image", "video"])
def test_all_equals_jax(mod, jax_mod):
  assert mod.__all__ == jax_mod.__all__


# -- stats ----------------------------------------------------------------
def test_splits_counts_and_sampling_match_jax():
  items = [f"spk{i % 7}_{i}" for i in range(50)]
  for kw in ({}, {"train": 0.8, "inc_test": False}, {"valid": 0.1},
             {"idfunc": lambda s: s.split("_")[0], "seed": 3}):
    assert stats.train_valid_test_split(items, **kw) == \
        jax_stats.train_valid_test_split(items, **kw)
  words = list("abracadabra")
  for sorting in (None, "asc", "desc"):
    got = stats.freqcount(words, sorting=sorting)
    want = jax_stats.freqcount(words, sorting=sorting)
    assert got == want and list(got) == list(want)
  assert stats.freqcount(words, key=str.upper) == \
      jax_stats.freqcount(words, key=str.upper)
  assert stats.sampling_iter(range(100), 7, seed=2) == \
      jax_stats.sampling_iter(range(100), 7, seed=2)


def test_summaries_match_jax():
  x = np.random.RandomState(0).randn(20, 3).astype(np.float32)
  x[0, 0] = np.nan
  for shorten in (False, True):
    assert stats.describe(x, shorten) == jax_stats.describe(x, shorten)
  assert stats.summary is stats.describe
  c = np.random.RandomState(1).poisson(2.0, (40, 5)).astype(np.float64)
  for fn, args in (("is_discrete", (c,)), ("is_discrete", (c + 0.5,)),
                   ("is_binary", (c > 2,)), ("is_binary", (c,)),
                   ("sparsity_percentage", (c, 7))):
    assert getattr(stats, fn)(*args) == getattr(jax_stats, fn)(*args)
  for kw in ({}, {"axis": 0}, {"logged_values": True, "axis": 1}):
    np.testing.assert_array_equal(stats.logVMR(c + 1, **kw),
                                  jax_stats.logVMR(c + 1, **kw))


def test_prior2weights_and_kl_match_jax():
  prior = [0.5, 0.2, 0.0, 0.3]
  for kw in ({}, {"exponential": True}, {"min_value": 0.1, "max_value": 2},
             {"norm": True}):
    np.testing.assert_array_equal(stats.prior2weights(prior, **kw),
                                  jax_stats.prior2weights(prior, **kw))
  p, q = [3, 1, 0, 6], [2, 2, 1, 5]
  assert stats.KL_divergence(p, q) == jax_stats.KL_divergence(p, q)
  assert stats.KL_divergence({"a": 1, "b": 3}, {"b": 1, "c": 2}) == \
      jax_stats.KL_divergence({"a": 1, "b": 3}, {"b": 1, "c": 2})


@pytest.mark.parametrize("n,k,labels,seed", [
    (60, 3, ["x", "y", "z"], 0), (9, 4, ["cat", "dog", "eel", "fox"], 1),
    (30, 2, [0, 1], 2), (5, 5, list("abcde"), 3)])
def test_classification_report_equals_jax_and_sklearn(n, k, labels, seed):
  """The same string as the JAX package's (scikit-learn's report) and, read
  back, scikit-learn's numbers."""
  from sklearn import metrics
  rs = np.random.RandomState(seed)
  y_true, y_pred = rs.randint(0, k, n), rs.randint(0, k, n)
  got = stats.classification_report(y_pred, y_true, labels)
  assert got == jax_stats.classification_report(y_pred, y_true, labels)
  # one-hot and score rows are taken by argmax
  assert stats.classification_report(np.eye(k)[y_pred], np.eye(k)[y_true],
                                     labels) == got
  p, r, f, s = metrics.precision_recall_fscore_support(
      y_true, y_pred, labels=list(range(k)), zero_division=0)
  rows = got.split("\n")
  for i, name in enumerate(labels):
    line = next(l for l in rows if l.split()[:1] == [str(name)])
    assert [float(v) for v in line.split()[1:4]] == \
        [round(float(v), 2) for v in (p[i], r[i], f[i])]
    assert int(line.split()[4]) == s[i]
  assert rows[0] == f"Accuracy: {metrics.accuracy_score(y_true, y_pred):.4f}"
  cm = metrics.confusion_matrix(y_true, y_pred, labels=list(range(k)))
  assert got.endswith(f"Confusion matrix:\n{cm}")


def test_classification_report_with_unseen_labels():
  """A label seen outside `labels`: a micro average row, as scikit-learn
  prints it."""
  y_true, y_pred = np.array([0, 1, 2, 3]), np.array([0, 1, 1, 3])
  assert stats.classification_report(y_pred, y_true, ["a", "b", "c"]) == \
      jax_stats.classification_report(y_pred, y_true, ["a", "b", "c"])


def test_classification_diagnose_matches_jax():
  rs = np.random.RandomState(4)
  X = rs.randn(80, 2)
  y_true, y_pred = rs.randint(0, 3, 80), rs.randint(0, 3, 80)
  got = stats.classification_diagnose(X, y_true, y_pred, num_samples=4)
  want = jax_stats.classification_diagnose(X, y_true, y_pred, num_samples=4)
  assert list(got) == list(want)
  for key in got:
    np.testing.assert_array_equal(np.stack(got[key]), np.stack(want[key]))


# -- text -----------------------------------------------------------------
DOCS = ["the cat sat", "the dog sat on the mat"]


def test_tokenizer_matches_jax():
  """tests/test_text_audio.py's inputs."""
  for kw in ({"n_words": 50}, {"min_freq": 2}, {"char_level": True},
             {"lower": False, "n_words": 4}):
    tok = text.Tokenizer(**kw).fit(DOCS)
    jtok = jax_text.Tokenizer(**kw).fit(DOCS)
    assert tok.word_index == jtok.word_index
    assert tok.vocab_size == jtok.vocab_size
    for s in ("the cat jumped", "The Dog, sat!", ""):
      assert tok.encode(s) == jtok.encode(s)
      assert tok.decode(tok.encode(s)) == jtok.decode(jtok.encode(s))
    for mode in ("seq", "count", "binary", "tfidf"):
      for maxlen in (None, 4):
        np.testing.assert_array_equal(
            tok.transform(["the cat", "the the dog"], maxlen=maxlen,
                          mode=mode),
            jtok.transform(["the cat", "the the dog"], maxlen=maxlen,
                           mode=mode))
    np.testing.assert_array_equal(tok.fit_transform(DOCS, mode="count"),
                                  jtok.fit_transform(DOCS, mode="count"))
  tok = text.Tokenizer(n_words=50).fit(DOCS)
  assert tok.decode(tok.encode("the cat jumped")) == "the cat <unk>"
  with pytest.raises(ValueError):
    tok.transform(DOCS, mode="nope")


def test_tokens_ngrams_and_stopwords_match_jax():
  for s in ("Hello, World!", "it's 42 o'clock -- ok?"):
    for kw in ({}, {"lower": False}, {"keep_punct": True}):
      assert text.simple_tokenizer(s, **kw) == \
          jax_text.simple_tokenizer(s, **kw)
  assert text.ngrams(["a", "b", "c"]) == ["a_b", "b_c"]
  assert text.ngrams(list("abcd"), 3) == jax_text.ngrams(list("abcd"), 3)
  words = ["the", "And", "cat", "never", "zebra", "whereafter"]
  assert [text.is_stopword(w) for w in words] == \
      [jax_text.is_stopword(w) for w in words]
  text.add_stopword(["Zebra"])
  jax_text.add_stopword("zebra")
  try:
    assert text.is_stopword("zebra") and jax_text.is_stopword("zebra")
  finally:
    text._EXTRA_STOPWORDS.discard("zebra")
    jax_text._EXTRA_STOPWORDS.discard("zebra")
  with pytest.raises(ValueError):
    text.is_stopword("le", lang="fr")
  assert text.is_oov("cow", {"cat": 1}) and not text.is_oov("cat", {"cat": 1})


def test_preprocessors_and_filters_match_jax():
  s = "NASA said: the Cat, (and) the DOG!"
  for cls, kw in ((text.CasePreprocessor, {}),
                  (text.CasePreprocessor, {"keep_name": False}),
                  (text.CasePreprocessor, {"split": None}),
                  (text.TransPreprocessor, {}),
                  (text.TransPreprocessor, {"old": "aeiou", "new": "_"})):
    jcls = getattr(jax_text, cls.__name__)
    assert cls(**kw)(s) == jcls(**kw)(s)
    assert cls(**kw)([s, s.lower()]) == jcls(**kw)([s, s.lower()])
  tokens = ["Hello", "42", "naïve", "Title", "x1"]
  for kw in ({"is_alpha": True}, {"is_digit": True}, {"is_ascii": True},
             {"is_title": True}, {"is_alpha": True, "is_digit": True}):
    assert [text.TYPEfilter(**kw)(t) for t in tokens] == \
        [jax_text.TYPEfilter(**kw)(t) for t in tokens]
  tags = ["NOUN", "DET", None, "verb"]
  assert [text.POSfilter()(t, p) for t, p in zip(tokens, tags)] == \
      [jax_text.POSfilter()(t, p) for t, p in zip(tokens, tags)]
  with pytest.raises(NotImplementedError):
    text.TokenFilter()("x")


# -- textgrid -------------------------------------------------------------
TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = 2.5
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 2.5
        intervals [1]:
            xmin = 0
            xmax = 1.2
            text = "hello"
        intervals [2]:
            xmin = 1.2
            xmax = 2.5
            text = "world"
    item [2]:
        class = "TextTier"
        name = "events"
        xmin = 0
        xmax = 2.5
        points [1]:
            number = 0.7
            mark = "click"
        points [2]:
            number = 1.9
            mark = ""
'''


def test_read_textgrid_matches_jax(tmp_path):
  """tests/test_text_audio.py's grid with a point tier added, from a
  string and from a file."""
  path = tmp_path / "a.TextGrid"
  path.write_text(TEXTGRID)
  for src in (TEXTGRID, str(path)):
    tg, jtg = textgrid.read_textgrid(src), jax_textgrid.read_textgrid(src)
    assert (tg.xmin, tg.xmax, tg.tier_names) == \
        (jtg.xmin, jtg.xmax, jtg.tier_names)
    assert tg.tier_names == ["words", "events"]
    for a, b in zip(tg.tiers, jtg.tiers):
      assert (a.name, a.tier_type, len(a)) == (b.name, b.tier_type, len(b))
      assert [(i.xmin, i.xmax, i.text) for i in a] == \
          [(i.xmin, i.xmax, i.text) for i in b]
      for skip in (True, False):
        assert a.labels(skip) == b.labels(skip)
  tg = textgrid.read_textgrid(TEXTGRID)
  assert tg["words"].labels() == [(0.0, 1.2, "hello"), (1.2, 2.5, "world")]
  assert tg["words"].intervals[0].duration == pytest.approx(1.2)
  assert tg[1].name == "events"
  with pytest.raises(KeyError):
    tg["phones"]


# -- image ----------------------------------------------------------------
@pytest.mark.parametrize("method", ["bilinear", "nearest", "cubic",
                                    "lanczos3"])
@pytest.mark.parametrize("size", [(26, 34), (5, 7), (13, 9)],
                         ids=["up", "down", "mixed"])
def test_batch_resize_matches_jax_image_resize(method, size):
  x = np.random.RandomState(0).rand(2, 13, 17, 3).astype(np.float32)
  got = image.batch_resize(torch.from_numpy(x), size, method)
  want = np.asarray(jax_image.batch_resize(jnp.asarray(x), size, method))
  assert got.shape == want.shape == (2,) + size + (3,)
  np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_TOL)


def test_batch_resize_of_integers_and_bad_methods():
  x = np.random.RandomState(1).randint(0, 255, (1, 8, 8, 1)).astype(np.uint8)
  got = image.batch_resize(torch.from_numpy(x), (3, 5))
  assert got.dtype == torch.float32
  np.testing.assert_allclose(
      got.numpy(), np.asarray(jax_image.batch_resize(x, (3, 5))),
      atol=RESIZE_TOL * 255)
  with pytest.raises(ValueError, match="Unknown resize method"):
    image.batch_resize(torch.from_numpy(x), (3, 5), "area")


def test_host_image_helpers_match_jax(tmp_path):
  rs = np.random.RandomState(2)
  img = (rs.rand(12, 10, 3) * 255).astype(np.uint8)
  gray = img[..., :1].copy()
  np.testing.assert_array_equal(image.center_crop(img, (6, 4)),
                                jax_image.center_crop(img, (6, 4)))
  for mode in ("probs", "tanh", "raster"):
    np.testing.assert_array_equal(image.normalize_image(img, mode),
                                  jax_image.normalize_image(img, mode))
  m = np.array([[1.0, 0.2, 1.5], [0.1, 0.9, -2.0], [0, 0, 1]])
  np.testing.assert_array_equal(
      image.transform_matrix_offset_center(m, 12, 10),
      jax_image.transform_matrix_offset_center(m, 12, 10))
  np.testing.assert_array_equal(image.apply_transform(img, m),
                                jax_image.apply_transform(img, m))
  for fn, kw in (("rotate", {"rg": 30}), ("shift", {}), ("zoom", {}),
                 ("shear", {"intensity": 0.4})):
    np.testing.assert_array_equal(getattr(image, fn)(img, seed=5, **kw),
                                  getattr(jax_image, fn)(img, seed=5, **kw))
  # the PIL helpers, where PIL is installed
  from PIL import Image
  Image.fromarray(img).save(tmp_path / "a.png")
  for kw in ({}, {"grayscale": True}):
    np.testing.assert_array_equal(
        image.read_image(str(tmp_path / "a.png"), **kw),
        jax_image.read_image(str(tmp_path / "a.png"), **kw))
  for x in (img, gray):
    np.testing.assert_array_equal(image.resize_image(x, (5, 7)),
                                  jax_image.resize_image(x, (5, 7)))
    np.testing.assert_array_equal(image.rotate_image(x, 33.0),
                                  jax_image.rotate_image(x, 33.0))


def test_pil_functions_name_pil_where_it_is_missing():
  """The card's machine has no PIL: the module imports, its NumPy and
  torch functions run, and the PIL ones raise an ImportError naming it."""
  code = "\n".join([
      "import sys",
      "sys.modules['PIL'] = None",
      "import numpy as np, torch",
      "from odin_tpu_torch.preprocessing import image",
      "image.batch_resize(torch.zeros(1, 4, 4, 1), (2, 2))",
      "image.center_crop(np.zeros((4, 4, 1)), (2, 2))",
      "try:",
      "  image.read_image('x.png')",
      "except ImportError as e:",
      "  print(e)"])
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
  assert res.returncode == 0, res.stderr
  assert "PIL" in res.stdout


# -- video ----------------------------------------------------------------
def test_video_roundtrip_matches_jax(tmp_path):
  """Frames saved by the port read back as the JAX package reads them (a
  GIF, which imageio writes through PIL here)."""
  rs = np.random.RandomState(3)
  frames = (rs.rand(4, 16, 16, 3) * 255).astype(np.uint8)
  path = str(tmp_path / "v.gif")
  video.save(path, frames, fps=10)
  got, fps = video.read(path)
  want, jfps = jax_video.read(path)
  np.testing.assert_array_equal(got, want)
  assert fps == jfps and got.shape[0] == 4
  box = video.read(path, boxes=np.array([2, 10, 3, 12]), max_frames=2)[0]
  np.testing.assert_array_equal(
      box, jax_video.read(path, boxes=np.array([2, 10, 3, 12]),
                          max_frames=2)[0])
  assert box.shape == (2, 8, 9, 3)
