"""The port's ``ml/__init__.py`` wrappers (``linear_classifier`` over its
five algorithms, ``dimension_reduce``, ``DimReduce``, ``fast_umap``),
``evaluate`` and ``Evaluable`` (``ml/base.py``) and ``Transformer``
(``ml/neural_nlp.py``) against the JAX package's, on the CPU.

Data: 4 Gaussian classes of 40 rows in 6 dims; a tiny randomly initialised
BERT saved under ``tmp_path``.

Tolerances, of the largest magnitude:

- ``lda``: 1e-9 (tests/test_torch_discriminant.py); ``svm``: decision
  values 1e-3 (libsvm's stop, tests/test_torch_svm.py); ``rf``: equal;
- ``logistic``: the JAX package's lbfgs stops short of the minimiser
  (tests/test_torch_estimators.py), so the port's probabilities are held
  within 1e-5 of scikit-learn's run to convergence (tol 1e-14), and its
  predictions to the JAX package's call on all but 2 % of the rows;
- ``gbt``: the same trees (the port replays scikit-learn's feature draws):
  decision values within 1e-9;
- ``dimension_reduce``: PCA 1e-9; k-means distances 1e-5 (float32
  centres, tests/test_torch_cluster.py); k-NN distances 1e-12;
- ``evaluate``: the log loss within 1e-12; accuracy, C_norm, EER, minDCF
  and the confusion matrix equal (``to_llr`` in float32 in both packages
  orders the scores alike here);
- ``Transformer``: both packages run the same torch model on the CPU:
  equal within 1e-6.
"""

import numpy as np
import pytest
import torch

import odin_tpu.ml as J
import odin_tpu_torch.ml as P

from torch_ml_common import close

CPU = "cpu"


def _data(seed=0, n=40, d=6, K=4):
  rng = np.random.RandomState(seed)
  centres = rng.randn(K, d) * 2
  X = np.concatenate([rng.randn(n, d) + c for c in centres])
  return X, np.repeat(np.arange(K), n)


def _np(t):
  return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
      np.asarray(t)


def test_linear_classifier_lda_and_rf():
  X, y = _data(1)
  Xt, _ = _data(2)
  want = J.linear_classifier(X, y, algo="lda")
  got = P.linear_classifier(X, y, algo="lda", device=CPU)
  close(got.predict_proba(Xt), want.predict_proba(Xt), 1e-9)
  want = J.linear_classifier(X.astype("f"), y, algo="rf")
  got = P.linear_classifier(X.astype("f"), y, algo="rf", device=CPU)
  np.testing.assert_allclose(_np(got.predict_proba(Xt.astype("f"))),
                             want.predict_proba(Xt.astype("f")), atol=1e-15)


def test_linear_classifier_svm():
  X, y = _data(3)
  want = J.linear_classifier(X, y, algo="svm")
  got = P.linear_classifier(X, y, algo="svc", device=CPU)
  close(got.decision_function(X), want.decision_function(X), 1e-3)
  np.testing.assert_array_equal(got.predict(X), want.predict(X))


def test_linear_classifier_logistic():
  from sklearn.linear_model import LogisticRegression as SkLR
  X, y = _data(4)
  want = J.linear_classifier(X, y, algo="logistic")
  got = P.linear_classifier(torch.from_numpy(X), torch.from_numpy(y),
                            algo="logit")
  tight = SkLR(max_iter=50000, tol=1e-14).fit(X, y)
  close(got.predict_proba(X), tight.predict_proba(X), 1e-5)
  assert np.mean(_np(got.predict(X)) != want.predict(X)) <= 0.02


def test_linear_classifier_gbt():
  X, y = _data(5, n=25)
  want = J.linear_classifier(X, y, algo="gbt", n_estimators=20)
  got = P.linear_classifier(torch.from_numpy(X), torch.from_numpy(y),
                            algo="gbtree", n_estimators=20)
  close(got.decision_function(X), want.decision_function(X), 1e-9)
  close(got.predict_proba(X), want.predict_proba(X), 1e-9)
  with pytest.raises(ValueError):
    P.linear_classifier(X, y, algo="nope")


def test_dimension_reduce_matches_jax():
  X, _ = _data(6)
  Xt, _ = _data(7)
  a, b = J.dimension_reduce(X, Xt, algo="pca", n_components=3)
  ga, gb = P.dimension_reduce(X, Xt, algo="pca", n_components=3, device=CPU)
  close(ga, a, 1e-9)
  close(gb, b, 1e-9)
  Xf = torch.from_numpy(X.astype("f"))
  close(P.dimension_reduce(Xf, algo="kmeans", n_components=4),
        J.dimension_reduce(X.astype("f"), algo="kmeans", n_components=4),
        1e-5)
  close(P.dimension_reduce(torch.from_numpy(X), algo="knn", n_components=3),
        J.dimension_reduce(X, algo="knn", n_components=3), 1e-12)
  with pytest.raises(ValueError):
    P.dimension_reduce(X, algo="nope")


def test_dim_reduce_flags():
  X, _ = _data(8)
  both = (P.DimReduce.PCA | P.DimReduce.KNN)
  assert len(both) == 2 and not both.is_single
  got = both(torch.from_numpy(X), n_components=2)
  want = (J.DimReduce.PCA | J.DimReduce.KNN)(X, n_components=2)
  close(got[0], want[0], 1e-9)
  close(got[1], want[1], 1e-12)
  assert P.DimReduce.PCA.is_single
  close(P.DimReduce.PCA(torch.from_numpy(X)), J.DimReduce.PCA(X), 1e-9)


def test_fast_umap_falls_back_to_tsne():
  """``umap`` is absent here, as on the card's machine: both packages fall
  back to their t-SNE, the port's to its own ``fast_tsne``."""
  with pytest.raises(ImportError):
    import umap  # noqa: F401
  X = torch.from_numpy(_data(9, n=15)[0])
  got = P.fast_umap(X, n_components=2, random_state=3)
  np.testing.assert_array_equal(_np(got), _np(P.fast_tsne(
      X, n_components=2, random_state=3)))
  assert tuple(got.shape) == (60, 2)
  assert J.fast_umap(X.numpy(), n_components=2).shape == (60, 2)


def _probs(seed=10, n=200, K=5):
  rng = np.random.RandomState(seed)
  y = rng.randint(0, K, n)
  logits = rng.randn(n, K) + 2.5 * np.eye(K)[y]
  p = np.exp(logits)
  return y, (p / p.sum(1, keepdims=True)).astype("f")


def _same_report(got, want):
  if np.isnan(want["log_loss"]):  # no probabilities given
    assert np.isnan(got["log_loss"])
  else:
    assert abs(got["log_loss"] - want["log_loss"]) <= \
        1e-12 * want["log_loss"]
  for k in ("accuracy", "Cnorm", "EER", "minDCF"):
    assert got[k] == want[k], k
  np.testing.assert_array_equal(got["confusion_matrix"],
                                want["confusion_matrix"])


def test_evaluate_matches_jax(tmp_path, capsys):
  y, p = _probs()
  want = J.evaluate(y, p, print_log=False)
  got = P.evaluate(y, torch.from_numpy(p), print_log=True, title="t",
                   path=str(tmp_path / "report.pdf"))
  _same_report(got, want)
  out = capsys.readouterr().out
  assert "Accuracy" in out and "EER" in out
  pdf = (tmp_path / "report.pdf").read_bytes()
  assert pdf.startswith(b"%PDF")
  assert pdf.count(b"/Type /Page") - pdf.count(b"/Type /Pages") == 4
  _same_report(P.evaluate(np.eye(5)[y], y_pred_log_proba=np.log(p),
                          print_log=False, device=CPU),
               J.evaluate(np.eye(5)[y], y_pred_log_proba=np.log(p),
                          print_log=False))
  with pytest.raises(ValueError):
    P.evaluate(y)


def test_evaluable_mixin(tmp_path):
  X, y = _data(11)
  from odin_tpu.ml.gmm_embedding import GMMclassifier as JaxGMMclassifier
  from odin_tpu_torch.ml.gmm_embedding import GMMclassifier
  got = GMMclassifier(device=CPU).fit(X, y)
  assert got.evaluate(X, y, print_log=False,
                      path=str(tmp_path / "gmm.pdf")) is got
  want = J.evaluate(y, JaxGMMclassifier().fit(X, y).predict_proba(X),
                    print_log=False)
  assert got.last_evaluation_["accuracy"] == want["accuracy"]
  assert (tmp_path / "gmm.pdf").exists()

  class Scores(P.Evaluable):
    def predict_log_proba(self, X):
      return torch.log_softmax(torch.as_tensor(X), 1)

  assert Scores().evaluate(X[:, :4], y, print_log=False).last_evaluation_[
      "accuracy"] >= 0.0
  with pytest.raises(ValueError):
    P.Evaluable().evaluate(X, y)


def _tiny_bert(path):
  from transformers import BertConfig, BertModel, BertTokenizer
  words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat",
           "sat", "on", "mat", "a", "dog", "ran"]
  vocab = path / "vocab.txt"
  vocab.write_text("\n".join(words) + "\n")
  torch.manual_seed(0)
  model = BertModel(BertConfig(vocab_size=len(words), hidden_size=16,
                               num_hidden_layers=1, num_attention_heads=2,
                               intermediate_size=32,
                               max_position_embeddings=32))
  model.save_pretrained(str(path))
  BertTokenizer(str(vocab)).save_pretrained(str(path))


@pytest.mark.parametrize("pooling", ["mean", "cls", "max"])
def test_transformer_matches_jax(tmp_path, monkeypatch, pooling):
  monkeypatch.setenv("HF_HUB_OFFLINE", "1")
  _tiny_bert(tmp_path)
  sentences = ["the cat sat on the mat", "a dog ran", "the dog", "cat"]
  got = P.Transformer(str(tmp_path), pooling=pooling, device=CPU)
  want = J.Transformer(str(tmp_path), pooling=pooling)
  out = got.transform(sentences, batch_size=3)
  assert isinstance(out, torch.Tensor) and tuple(out.shape) == (4, 16)
  close(out, want.transform(sentences, batch_size=3), 1e-6)
  close(got(sentences), want(sentences), 1e-6)


def test_transformer_not_cached(monkeypatch):
  monkeypatch.setenv("HF_HUB_OFFLINE", "1")
  with pytest.raises(FileNotFoundError, match="not cached"):
    P.Transformer("no-such-org/no-such-model-cached-here", device=CPU)
