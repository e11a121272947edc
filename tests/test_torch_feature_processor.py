"""The port's ``FeatureProcessor`` and ``mpi.MPI`` against the JAX package's
on the CPU.

Six wav files of synthetic speech (tests/test_preprocessing.py's
`synth_speech`, seeds 0-5) go through the standard recipe in both packages
at ``ncpu=1``: the port's store equals JAX's file for file, byte for byte
(features, ``indices_*``, sums, ``log.txt``).  Forked workers (``ncpu=2``)
run in a child Python without JAX, inside a time limit, and give the same
rows per utterance as the inline run.  A stage bound to a CUDA device makes
``FeatureProcessor(ncpu > 1)`` raise ``ValueError`` before anything forks.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import odin_tpu.preprocessing as J
import odin_tpu_torch.preprocessing as P
from odin_tpu_torch.mpi import MPI, SharedCounter, async_thread
from torch_speech_common import standard_pipeline, synth_speech, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


@pytest.fixture
def jobs(tmp_path):
  out = []
  for i in range(6):
    p = write_wav(str(tmp_path / f"utt{i}.wav"), synth_speech(seed=i))
    out.append({"path": p, "name": f"utt{i}"})
  return out


def _files(path):
  return {f: open(os.path.join(path, f), "rb").read()
          for f in sorted(os.listdir(path))}


def test_store_matches_jax(tmp_path, jobs):
  ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
  ds = P.FeatureProcessor(jobs, ours, standard_pipeline(P), ncpu=1).run()
  J.FeatureProcessor(jobs, theirs, standard_pipeline(J), ncpu=1).run()
  got, want = _files(ours), _files(theirs)
  assert sorted(got) == sorted(want)
  for name in want:
    assert got[name] == want[name], name
  for feat in ("mspec", "mfcc", "energy", "sad", "raw"):
    assert feat in ds and f"indices_{feat}" in ds
  idx = ds["indices_mspec"]
  assert len(idx) == 6
  assert ds["mspec"].shape[0] == sum(e - s for s, e in idx.values())
  assert ds["sad"].dtype == np.uint8
  assert open(os.path.join(ours, "log.txt")).read().startswith(
      "jobs: 6\nprocessed: 6\nerrors: 0")
  report = P.validate_features(ds, "mspec")
  assert report["n_utterances"] == 6 and report["n_nan"] == 0
  pca = P.calculate_pca(ds, "mspec", n_components=5, device="cpu")
  assert tuple(pca.components_.shape) == (5, 24)


def test_errors_are_logged(tmp_path, jobs):
  bad = jobs[:2] + [{"path": str(tmp_path / "missing.wav"), "name": "x"}]
  out = str(tmp_path / "port")
  ds = P.FeatureProcessor(bad, out, standard_pipeline(P)).run()
  assert len(ds["indices_mspec"]) == 2
  log = open(os.path.join(out, "log.txt")).read()
  assert log.startswith("jobs: 3\nprocessed: 2\nerrors: 1")
  with pytest.raises(RuntimeError):
    P.FeatureProcessor(bad, str(tmp_path / "stop"), standard_pipeline(P),
                       stop_on_failure=True).run()


def _on_card_stage():
  """A BNFExtractor built on the CPU, then bound to a CUDA device as a
  card's stage is (this machine has no card to build one on)."""
  bnf = P.BNFExtractor("mfcc", torch.nn.Linear(20 * 3, 4), stack_context=1,
                       device="cpu")
  bnf.device = torch.device("cuda", 0)
  return bnf


@pytest.mark.parametrize("ncpu", [2, 4])
def test_card_stage_refuses_to_fork(tmp_path, jobs, ncpu):
  pipe = P.make_pipeline([standard_pipeline(P), _on_card_stage()])
  out = str(tmp_path / "store")
  with pytest.raises(ValueError, match="BNFExtractor"):
    P.FeatureProcessor(jobs, out, pipe, ncpu=ncpu)
  assert not os.path.exists(out)  # refused before anything was made
  P.FeatureProcessor(jobs, out, pipe, ncpu=1)  # inline is allowed


CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, {root!r})
    sys.path.insert(0, os.path.join({root!r}, "tests"))
    import odin_tpu_torch.preprocessing as P
    from odin_tpu_torch.fuel.dataset import Dataset
    from odin_tpu_torch.mpi import MPI, SharedCounter, async_process
    from torch_speech_common import standard_pipeline
    jobs = json.loads(sys.argv[1])
    out = {{}}
    for ncpu in (1, 2):
      path = os.path.join(sys.argv[2], f"ncpu{{ncpu}}")
      P.FeatureProcessor(jobs, path, standard_pipeline(P, deltas=True),
                         ncpu=ncpu).run()
      ds = Dataset(path)
      out[ncpu] = {{f: {{n: np.asarray(ds[f][s:e]).tobytes().hex()
                        for n, (s, e) in ds["indices_" + f].items()}}
                   for f in ("mspec", "mfcc", "sad", "energy")}}
      out[ncpu]["sum1"] = np.load(os.path.join(path, "mfcc_sum1.npy")
                                  ).tolist()
    def f(batch):
      for x in batch:
        yield x * x
    squares = [x * x for x in range(20)]
    out["mpi"] = [sorted(MPI(range(20), f, ncpu=2, batch=3).run()) == squares,
                  MPI(range(20), f, ncpu=2, batch=4, ordered=True).run() ==
                  squares]
    c = SharedCounter()
    def bump(counter):
      counter.add(5)
    p = async_process(bump, c)
    p.join(30)
    out["mpi"].append(p.exitcode == 0 and c.value == 5)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def forked(tmp_path_factory):
  """One child Python without JAX, bounded by a time limit: the standard
  recipe (with Δ/ΔΔ) at ncpu=1 and ncpu=2 over six files, then MPI's
  forked map and async_process."""
  import json
  tmp = tmp_path_factory.mktemp("forked")
  jobs = []
  for i in range(6):
    p = write_wav(str(tmp / f"utt{i}.wav"), synth_speech(seed=i))
    jobs.append({"path": p, "name": f"utt{i}"})
  res = subprocess.run([sys.executable, "-c", CHILD.format(root=ROOT),
                        json.dumps(jobs), str(tmp)], capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S)
  assert res.returncode == 0, res.stderr[-3000:]
  return json.loads(res.stdout)


def test_forked_workers_equal_inline(forked):
  """ncpu=2 (forked workers) against ncpu=1: each utterance's rows equal
  bit for bit; the float64 sums, added in another order, within 1e-12
  relative."""
  inline, workers = forked["1"], forked["2"]
  for feat in ("mspec", "mfcc", "sad", "energy"):
    assert inline[feat] == workers[feat], feat
    assert sorted(inline[feat]) == [f"utt{i}" for i in range(6)]
  np.testing.assert_allclose(workers["sum1"], inline["sum1"], rtol=1e-12)


def _square_batch(batch):
  return [x * x for x in batch]


def _square_each(batch):
  for x in batch:
    yield x * x


def test_mpi_inline():
  """ncpu=1 runs in this process, in order; generators stream out."""
  assert MPI(range(7), _square_batch, ncpu=1, batch=3).run() == [
      [0, 1, 4], [9, 16, 25], [36]]
  assert MPI(range(5), _square_each, ncpu=1).run() == [0, 1, 4, 9, 16]
  assert len(MPI(range(5), _square_each)) == 5


def test_mpi_forked(forked):
  """Unordered and ordered maps over two forked workers, and a counter
  shared with an async_process."""
  assert forked["mpi"] == [True, True, True]


def test_async_thread_and_counter():
  fut = async_thread(lambda a, b: a + b, 2, b=3)
  assert fut.get(10) == 5 and fut.finished
  def boom():
    raise KeyError("x")
  with pytest.raises(KeyError):
    async_thread(boom).get(10)
  c = SharedCounter(3)
  assert c.add() == 4 and c.add(6) == 10 and c.value == 10
