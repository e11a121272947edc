"""The port's procedural NLP datasets against the JAX package's: the same
``np.random.RandomState`` programs, so every array is equal for the same
seed, partition by partition."""
import numpy as np
import pytest

from odin_tpu.fuel import nlp_data as jax_nlp
from odin_tpu_torch.fuel import nlp_data

PARTITIONS = ("train", "valid", "test")


@pytest.mark.parametrize("kwargs", [
    dict(n_docs=300, n_words=50, n_topics=4),
    dict(n_docs=120, n_words=30, n_topics=3, doc_length=20, seed=7)])
def test_synthetic_bow_equals_jax(kwargs):
  ds, jds = nlp_data.SyntheticBoW(**kwargs), jax_nlp.SyntheticBoW(**kwargs)
  np.testing.assert_array_equal(ds.topics, jds.topics)
  for part in PARTITIONS:
    (x, y), (jx, jy) = ds.numpy(part), jds.numpy(part)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == np.float32 and y.dtype == np.int64
  assert ds.shape == jds.shape and ds.labels == jds.labels
  assert ds.name == jds.name and ds.data_type == jds.data_type == "text"


@pytest.mark.parametrize("kwargs", [dict(n_samples=400),
                                    dict(n_samples=150, max_operand=9,
                                         maxlen=6, seed=3)])
def test_math_arithmetic_equals_jax(kwargs):
  ds = nlp_data.MathArithmetic(**kwargs)
  jds = jax_nlp.MathArithmetic(**kwargs)
  for part in PARTITIONS:
    (x, y), (jx, jy) = ds.numpy(part), jds.numpy(part)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
  assert ds.vocab_size == jds.vocab_size and ds.shape == jds.shape
  x, y = ds.numpy("test")
  assert ds.decode(x[0]) == jds.decode(x[0])
  assert eval(ds.decode(x[0])) == int(ds.decode(y[0]))


def test_bag_of_words_batches_through_the_pipeline():
  ds = nlp_data.SyntheticBoW(n_docs=200, n_words=40, n_topics=4)
  batch = next(iter(ds.create_dataset("train", batch_size=16, epochs=1,
                                      inc_labels=True)))
  x, y = batch
  assert tuple(x.shape) == (16, 40) and tuple(y.shape) == (16,)
  np.testing.assert_array_equal(np.asarray(x).sum(-1), 80)
