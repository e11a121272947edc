"""The PyTorch port stands alone: odin_tpu_torch and chip_smoke.py import
nothing of JAX, nothing of the JAX package and nothing of scikit-learn (the
card's machine has none), and chip_smoke.py fails, printing no result,
where there is no CUDA card or no port beside it.  The one exception is
``Newsgroup20._fetch``, which reads 20-newsgroups from scikit-learn's local
cache as the JAX package does: its import stands inside that function
(``LAZY``), never at a module's top level."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "odin_tpu", "sklearn")
# (source, function, module) of the imports a function makes when it runs
LAZY = {("odin_tpu_torch/fuel/nlp_data.py", "_fetch", "sklearn.datasets")}
SOURCES = sorted((ROOT / "odin_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(node):
  if isinstance(node, ast.Import):
    return [alias.name for alias in node.names]
  if isinstance(node, ast.ImportFrom) and node.level == 0:
    return [node.module]
  return []


def _imported_modules(path):
  """The modules `path` imports, but those ``LAZY`` allows inside the
  function it names."""
  rel = path.relative_to(ROOT).as_posix()
  tree = ast.parse(path.read_text(), filename=str(path))
  lazy = set()
  for fn in ast.walk(tree):
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
      for node in ast.walk(fn):
        lazy |= {id(node) for m in _imports(node)
                 if (rel, fn.name, m) in LAZY}
  for node in ast.walk(tree):
    if id(node) not in lazy:
      yield from _imports(node)


def test_the_lazy_import_is_inside_its_function():
  """``Newsgroup20._fetch`` holds the one scikit-learn import, and the
  module's top level none."""
  path = ROOT / "odin_tpu_torch" / "fuel" / "nlp_data.py"
  tree = ast.parse(path.read_text())
  top = [m for node in tree.body for m in _imports(node)]
  assert not any(m.split(".")[0] == "sklearn" for m in top)
  fetch = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
           and n.name == "_fetch"]
  assert any(m == "sklearn.datasets" for fn in fetch
             for node in ast.walk(fn) for m in _imports(node))


def test_sources_exist():
  names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
  for kernel in ("logmel", "flash_attention"):
    assert f"odin_tpu_torch/ops/{kernel}.py" in names
    assert (ROOT / "odin_tpu_torch" / "csrc" / f"{kernel}.cu").exists()
  assert "odin_tpu_torch/networks/attention.py" in names
  # the 16-bit flash attention kernel, behind ops/flash_attention.py, and
  # K1's FFT kernel, behind ops/logmel.py
  for source in ("flash_attention_mma.cu", "logmel_fft.cu"):
    assert (ROOT / "odin_tpu_torch" / "csrc" / source).exists()
  # the training slice: its modules are among the sources checked below
  for module in ("training/core.py", "bay/helpers.py",
                 "backend/interpolation.py", "fuel/image_data/datasets.py",
                 "fuel/dataset_base.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the trainer slice
  for module in ("training/trainer.py", "training/callbacks.py",
                 "training/early_stopping.py", "fuel/pipeline.py",
                 "fuel/image_data/_base.py", "bay/vi/losses.py",
                 "bay/vi/autoencoder/beta_vae.py", "utils.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the corpus slice
  for module in ("preprocessing/speech.py", "preprocessing/processor.py",
                 "fuel/databases.py", "fuel/dataset.py",
                 "fuel/audio_data.py", "ops/streaming_features.py",
                 "ops/inversion.py", "ops/features.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the Gym slice
  for module in ("bay/vi/estimators.py", "bay/vi/utils.py",
                 "bay/vi/metrics.py", "bay/vi/downstream_metrics.py",
                 "bay/vi/giga.py", "bay/vi/disentanglement_gym.py",
                 "backend/metrics.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the speaker-recognition slice
  for module in ("ml/__init__.py", "ml/gmm_tmat.py", "ml/ivector.py",
                 "ml/scoring.py", "ml/plda.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the VAE zoo slice
  for module in ("bay/distributions/spherical.py",
                 "bay/distributions/sampling.py",
                 "bay/distributions/deterministic.py",
                 "bay/distributions/vector_quantizer.py",
                 "bay/vi/autoencoder/factor_discriminator.py",
                 "bay/vi/autoencoder/factor_vae.py",
                 "bay/vi/autoencoder/dip_vae.py",
                 "bay/vi/autoencoder/info_vae.py",
                 "bay/vi/autoencoder/irm_vae.py",
                 "bay/vi/autoencoder/hyperbolic_vae.py",
                 "bay/vi/autoencoder/two_stage_vae.py",
                 "bay/vi/autoencoder/vamprior.py",
                 "bay/vi/autoencoder/vq_vae.py",
                 "bay/vi/autoencoder/stochastic_vae.py",
                 "bay/vi/autoencoder/deterministic.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the clustering slice
  for module in ("bay/vi/cluster_scores.py",
                 "bay/vi/correlation_estimators.py",
                 "bay/vi/discretizers.py", "ml/cluster.py",
                 "ml/neighbors.py", "ml/naive_bayes.py", "ml/tsne.py",
                 "search.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the speech front-end slice, and the native IO engine's own source
  for module in ("preprocessing/signal.py", "preprocessing/_mixture.py",
                 "preprocessing/base.py", "preprocessing/audio.py",
                 "preprocessing/opensmile.py", "preprocessing/kaldi.py",
                 "mpi.py", "native.py"):
    assert f"odin_tpu_torch/{module}" in names
  assert (ROOT / "odin_tpu_torch" / "csrc" / "odin_io.cpp").exists()
  # the sweep slice
  for module in ("training/experimenter.py", "training/scores.py",
                 "networks/image_networks.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the last VAE classes: the LDA family, Grade of Membership, the cycle,
  # mixture-of-experts and sequential models, the Dirichlet, the NLP sets
  for module in ("bay/vi/autoencoder/lda_vae.py", "bay/mixed_membership.py",
                 "bay/vi/autoencoder/cycle_vae.py",
                 "bay/vi/autoencoder/moe_vae.py",
                 "bay/vi/autoencoder/sequential_vae.py",
                 "bay/distributions/continuous.py", "fuel/nlp_data.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the natural-image slice: the quantized and mixture likelihoods, the
  # residual and PixelCNN networks
  for module in ("bay/distributions/quantized.py",
                 "bay/distributions/mixture.py", "networks/resnets.py",
                 "networks/base.py", "bay/distribution_alias.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the distribution zoo and the gene-expression slice: the families, the
  # heads and layers, the stochastic initializers and the gene datasets
  for module in ("bay/distributions/conditional.py",
                 "bay/distributions/discrete.py",
                 "bay/distributions/deterministic.py",
                 "bay/layers/autoregressive.py",
                 "bay/layers/dense_distribution.py",
                 "bay/layers/distribution_layers.py",
                 "bay/layers/util_layers.py",
                 "bay/stochastic_initializers.py", "fuel/bio_data.py",
                 "networks/image_networks.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the x-vector slice: the TDNN layers, the utility layers and dropouts,
  # the text readers and loaders
  for module in ("networks/time_delay.py", "networks/util_layers.py",
                 "networks/dropout.py", "fuel/nlp_data.py",
                 "fuel/loaders.py"):
    assert f"odin_tpu_torch/{module}" in names
  # the classical-ML slice: the decompositions, discriminant analysis,
  # mixtures and their embeddings, SVC, forests, topic models, evaluate,
  # the Transformer embedder, the metrics' rest and the plotting helpers
  for module in ("ml/decompositions.py", "ml/discriminant.py",
                 "ml/mixture.py", "ml/gmm_embedding.py", "ml/svm.py",
                 "ml/forest.py", "ml/topics.py", "ml/base.py",
                 "ml/neural_nlp.py", "backend/maths.py",
                 "visual/__init__.py", "visual/extended.py"):
    assert f"odin_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_odin_tpu_imports(path):
  bad = [m for m in _imported_modules(path)
         if m.split(".")[0] in FORBIDDEN]
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_torch_cpp_extension():
  """Kernels are built with plain nvcc and bound with ctypes."""
  for path in SOURCES:
    text = path.read_text()
    assert "cpp_extension" not in text, path
  for path in (ROOT / "odin_tpu_torch" / "csrc").iterdir():
    assert "torch/extension.h" not in path.read_text(), path


def _run(args, cwd, env=None):
  return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=120)


def test_importing_the_port_loads_no_jax():
  code = ("import sys, odin_tpu_torch.ops, odin_tpu_torch.preprocessing, "
          "odin_tpu_torch.bay.vi, odin_tpu_torch.networks, "
          "odin_tpu_torch.serving, odin_tpu_torch.weights, "
          "odin_tpu_torch.training, odin_tpu_torch.backend, "
          "odin_tpu_torch.fuel, odin_tpu_torch.bay.helpers, "
          "odin_tpu_torch.training.trainer, odin_tpu_torch.utils, "
          "odin_tpu_torch.bay.vi.losses, odin_tpu_torch.fuel.databases, "
          "odin_tpu_torch.fuel.dataset, odin_tpu_torch.fuel.audio_data, "
          "odin_tpu_torch.preprocessing.speech, "
          "odin_tpu_torch.preprocessing.processor, "
          "odin_tpu_torch.ops.streaming_features, "
          "odin_tpu_torch.ops.inversion, odin_tpu_torch.bay.vi.estimators, "
          "odin_tpu_torch.bay.vi.utils, odin_tpu_torch.bay.vi.metrics, "
          "odin_tpu_torch.bay.vi.downstream_metrics, "
          "odin_tpu_torch.bay.vi.giga, "
          "odin_tpu_torch.bay.vi.disentanglement_gym, "
          "odin_tpu_torch.backend.metrics, odin_tpu_torch.ml, "
          "odin_tpu_torch.ml.gmm_tmat, odin_tpu_torch.ml.ivector, "
          "odin_tpu_torch.ml.scoring, odin_tpu_torch.ml.plda, "
          "odin_tpu_torch.mpi, odin_tpu_torch.native, "
          "odin_tpu_torch.preprocessing.base, "
          "odin_tpu_torch.preprocessing.audio, "
          "odin_tpu_torch.preprocessing.opensmile, "
          "odin_tpu_torch.preprocessing.kaldi, "
          "odin_tpu_torch.training.experimenter, "
          "odin_tpu_torch.training.scores, "
          "odin_tpu_torch.bay.mixed_membership, odin_tpu_torch.fuel.nlp_data, "
          "odin_tpu_torch.bay.vi.autoencoder.lda_vae, "
          "odin_tpu_torch.bay.vi.autoencoder.cycle_vae, "
          "odin_tpu_torch.bay.vi.autoencoder.moe_vae, "
          "odin_tpu_torch.bay.vi.autoencoder.sequential_vae, "
          "odin_tpu_torch.bay.layers, "
          "odin_tpu_torch.bay.stochastic_initializers, "
          "odin_tpu_torch.fuel.bio_data, odin_tpu_torch.fuel.loaders, "
          "odin_tpu_torch.networks.time_delay, "
          "odin_tpu_torch.networks.util_layers, "
          "odin_tpu_torch.networks.dropout, "
          "odin_tpu_torch.ml.decompositions, odin_tpu_torch.ml.discriminant, "
          "odin_tpu_torch.ml.mixture, odin_tpu_torch.ml.gmm_embedding, "
          "odin_tpu_torch.ml.svm, odin_tpu_torch.ml.forest, "
          "odin_tpu_torch.ml.topics, odin_tpu_torch.ml.base, "
          "odin_tpu_torch.ml.neural_nlp, odin_tpu_torch.backend.maths, "
          "odin_tpu_torch.visual\n"
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          f"{FORBIDDEN!r})\nassert not bad, bad")
  res = _run(["-c", code], cwd=ROOT)
  assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_a_card():
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  res = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env)
  assert res.returncode != 0
  assert "no CUDA card" in res.stderr
  assert '"ok"' not in res.stdout


def test_chip_smoke_fails_without_the_port(tmp_path):
  shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
             PYTHONPATH="", PYTHONNOUSERSITE="1")
  res = _run(["chip_smoke.py"], cwd=tmp_path, env=env)
  assert res.returncode != 0
  assert "No module named 'odin_tpu_torch'" in res.stderr
  assert '"ok"' not in res.stdout


def test_chip_smoke_phases_run_1_to_20():
  """Phases 1-21 stay, and phase 22 (the classical-ML slice) is the last:
  ``--phases 20`` runs phase 20 with the build alone, ``--phases 21``
  brings phase 9, whose wav files it reads, and ``--phases 22`` phases 9
  and 21, whose utterances and x-vectors it reads."""
  import chip_smoke
  assert chip_smoke.PHASES == tuple(range(1, 23))
  assert chip_smoke.selected_phases() == set(range(1, 23))
  assert chip_smoke.selected_phases("20") == {1, 20}
  assert chip_smoke.selected_phases("21") == {1, 9, 21}
  assert chip_smoke.selected_phases("22") == {1, 9, 21, 22}
  assert 20 not in chip_smoke.PHASE_NEEDS
  assert all(20 not in needs for needs in chip_smoke.PHASE_NEEDS.values())
  with pytest.raises(SystemExit, match="1-22"):
    chip_smoke.selected_phases("23")


def test_new_modules_need_neither_sklearn_nor_matplotlib():
  """The clustering slice's modules import with scikit-learn and matplotlib
  blocked, its estimators run, and a Gym plot raises ImportError only when
  it is drawn."""
  code = "\n".join([
      "import sys",
      "for name in ('sklearn', 'matplotlib'):",
      "  sys.modules[name] = None",
      "import torch",
      "import odin_tpu_torch.ml as ml",
      "import odin_tpu_torch.search",
      "from odin_tpu_torch.ml import cluster, naive_bayes, neighbors, tsne",
      "from odin_tpu_torch.bay.vi import (cluster_scores, discretizers,",
      "    correlation_estimators, metrics, utils, disentanglement_gym)",
      "z = torch.randn(60, 3, generator=torch.Generator().manual_seed(0))",
      "y = (z[:, 0] > 0).long()",
      "ml.fast_kmeans(z, n_clusters=3, framework='sklearn')",
      "metrics.unsupervised_clustering_scores(y, z)",
      "metrics.correlation_matrix(z, y[:, None], method='lasso')",
      "utils.discretizing(z, n_bins=3, strategy='gmm')",
      "gym = disentanglement_gym.DisentanglementGym(device='cpu')",
      "gym._z_mean = z",
      "try:",
      "  gym.plot_histogram()",
      "except ImportError:",
      "  print('plots need matplotlib')",
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
      "             ('sklearn', 'matplotlib', 'jax', 'odin_tpu')",
      "             and sys.modules[m] is not None)",
      "assert not bad, bad"])
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
  assert res.returncode == 0, res.stderr
  assert res.stdout.strip() == "plots need matplotlib"


def test_sweep_slice_imports_no_jax():
  """The sweep's entry points import, and a small sweep runs, with JAX and
  the JAX package blocked."""
  code = "\n".join([
      "import sys, tempfile",
      "for name in ('jax', 'jaxlib', 'flax', 'optax', 'odin_tpu'):",
      "  sys.modules[name] = None",
      "from odin_tpu_torch.training import (run_hydra, ScoreBoard,",
      "    multiseed_device_dataset_steps, stack_states, unstack_states,",
      "    parse_config, hash_config, get_output_dir)",
      "from odin_tpu_torch.training.core import remat_policy",
      "from odin_tpu_torch.fuel import get_dataset",
      "from odin_tpu_torch.fuel.image_data import FullGridMixin",
      "from odin_tpu_torch.networks import get_networks",
      "from odin_tpu_torch.utils import get_data_path",
      "get_networks('locatello', n_channels=3)",
      "get_networks('shapes3d')",
      "remat_policy('dots_saveable')",
      "root = tempfile.mkdtemp()",
      "main = run_hydra(output_dir=root)(lambda cfg: (cfg.a, cfg.output_dir))",
      "assert len(main(['a=1,2'])) == 2",
      "ScoreBoard(root + '/s.db').write('t', a=1)",
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
      "             ('jax', 'jaxlib', 'flax', 'optax', 'odin_tpu')",
      "             and sys.modules[m] is not None)",
      "assert not bad, bad"])
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
  assert res.returncode == 0, res.stderr


def test_image_slice_imports_no_jax():
  """The natural-image slice's networks, likelihoods and datasets import
  and run with JAX, the JAX package, scikit-learn and matplotlib
  blocked."""
  code = "\n".join([
      "import sys, tempfile, os",
      "for name in ('jax', 'jaxlib', 'flax', 'optax', 'odin_tpu', 'sklearn',",
      "             'matplotlib'):",
      "  sys.modules[name] = None",
      "os.environ['ODIN_TPU_HOME'] = tempfile.mkdtemp()",
      "import torch",
      "from odin_tpu_torch.networks import get_networks",
      "from odin_tpu_torch.networks.resnets import PixelCNNDecoder",
      "from odin_tpu_torch.bay.distributions import (QuantizedLogistic,",
      "    MixtureQuantizedLogistic, GaussianMixture, qNormal, qUniform)",
      "from odin_tpu_torch.fuel import get_dataset",
      "from odin_tpu_torch.fuel.image_data import make_halfmoons",
      "for name in ('mnist', 'halfmnist', 'omniglot', 'cifar10', 'svhn',",
      "             'celeba'):",
      "  get_networks(name, is_semi_supervised=True)",
      "get_networks('cifar10', resnet=True, skip_generator=True)",
      "get_networks('dsprites', space_to_depth=True)",
      "make_halfmoons(1)",
      "get_dataset('ydisentanglement', n_samples=4)._load('train')",
      "get_dataset('cifar10')",
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
      "             ('jax', 'jaxlib', 'flax', 'optax', 'odin_tpu', 'sklearn',",
      "              'matplotlib') and sys.modules[m] is not None)",
      "assert not bad, bad"])
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
  assert res.returncode == 0, res.stderr


def test_speech_front_end_needs_no_sklearn():
  """SADgmm, openSMILEsad, vad_energy and spectra run with scikit-learn
  blocked, as on the card's machine (their mixtures are carried in
  NumPy)."""
  code = "\n".join([
      "import sys",
      "sys.modules['sklearn'] = None",
      "import numpy as np",
      "from odin_tpu_torch.preprocessing import (SADgmm, openSMILEsad,",
      "    signal, make_pipeline, AudioReader, STFTExtractor)",
      "rng = np.random.RandomState(0)",
      "t = np.arange(32000) / 16000",
      "y = (0.3 * np.sin(2 * np.pi * 150 * t) * (t % 0.5 < 0.3)",
      "     + 0.01 * rng.randn(len(t))).astype('f')",
      "feat = make_pipeline([AudioReader(sr=16000), STFTExtractor()])",
      "feat = feat.transform({'raw': y, 'sr': 16000})",
      "sad = SADgmm().transform(feat)['sad']",
      "score = openSMILEsad().transform(feat)['sad']",
      "spec = signal.spectra(16000, 400, y=y, n_mels=40, n_ceps=20)",
      "label, thr = signal.vad_energy(feat['energy'].ravel())",
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
      "             ('sklearn', 'jax', 'odin_tpu')",
      "             and sys.modules[m] is not None)",
      "assert not bad, bad",
      "print(int(sad.sum()), float(score.sum()), float(spec['mfcc'].sum()),",
      "      float(thr))"])
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
  assert res.returncode == 0, res.stderr
  assert 0 < int(res.stdout.split()[0]) < 200


def _lazy_imports(path, function):
  """(imports inside `function`, imports at the module's top level)."""
  tree = ast.parse(path.read_text())
  top = [m for node in tree.body for m in _imports(node)]
  inside = [m for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
            and fn.name == function for node in ast.walk(fn)
            for m in _imports(node)]
  return inside, top


def test_transformers_and_umap_are_imported_where_they_are_used():
  """``Transformer`` imports ``transformers`` in its constructor and
  ``fast_umap`` imports ``umap`` in its body, never at a module's top."""
  inside, top = _lazy_imports(ROOT / "odin_tpu_torch" / "ml" /
                              "neural_nlp.py", "__init__")
  assert "transformers" in inside and "transformers" not in top
  inside, top = _lazy_imports(ROOT / "odin_tpu_torch" / "ml" / "__init__.py",
                              "fast_umap")
  assert "umap" in inside and "umap" not in top


def test_the_ml_and_metric_names_are_the_jax_packages():
  """The port's ``ml.__all__`` is the JAX package's, and every name of the
  JAX package's ``backend.metrics`` exists in the port's."""
  import odin_tpu.backend.metrics as jax_metrics
  import odin_tpu.ml as jax_ml

  import odin_tpu_torch.backend.metrics as metrics
  import odin_tpu_torch.ml as ml
  assert ml.__all__ == jax_ml.__all__
  for name in ml.__all__:
    assert hasattr(ml, name), name
  assert metrics.__all__ == jax_metrics.__all__
  for name in jax_metrics.__all__:
    assert callable(getattr(metrics, name)), name


def test_classical_ml_runs_without_sklearn():
  """The classical-ML slice's estimators fit and predict with scikit-learn,
  matplotlib, transformers and umap blocked."""
  code = "\n".join([
      "import sys",
      "for name in ('sklearn', 'matplotlib', 'transformers', 'umap'):",
      "  sys.modules[name] = None",
      "import numpy as np, torch",
      "import odin_tpu_torch.ml as ml",
      "from odin_tpu_torch.ml.mixture import GaussianMixture",
      "rng = np.random.RandomState(0)",
      "X = rng.randn(90, 5) + np.repeat(np.eye(5)[:3] * 4, 30, 0)",
      "y = np.repeat(np.arange(3), 30)",
      "kw = dict(device='cpu')",
      "ml.fast_pca(X, X, n_components=2, **kw)",
      "ml.PPCA(2, **kw).fit(X); ml.MiniBatchPCA(2, 30, **kw).fit(X)",
      "ml.RandomizedPCA(2, **kw).fit(X)",
      "ml.SupervisedPPCA(2, **kw).fit(X, y)",
      "for algo in ('lda', 'svm', 'rf'):",
      "  ml.linear_classifier(X, y, algo=algo, **kw).predict(X)",
      "ml.Scorer(method='svm', **kw).fit(X, y).predict_proba(X)",
      "ml.VectorNormalizer(lda=True, **kw).fit(X, y).transform(X)",
      "ml.GMMclassifier(**kw).fit(X, y).predict(X)",
      "ml.GMMThreshold(**kw).fit(X[:, 0])",
      "ml.ProbabilisticEmbedding(**kw).fit(np.abs(X[:, :2]))",
      "GaussianMixture(2, covariance_type='full', **kw).fit(X)",
      "lda = ml.fast_lda_topics(rng.poisson(2, (40, 12)), n_topics=3,",
      "                         max_iter=2, **kw)",
      "ml.get_topics_string(lda, [str(i) for i in range(12)])",
      "ml.evaluate(y, ml.linear_classifier(X, y, **kw).predict_proba(X),",
      "            print_log=False, **kw)",
      "try:",
      "  ml.Transformer('x', device='cpu')",
      "except FileNotFoundError:",
      "  pass",
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
      "             ('sklearn', 'matplotlib', 'jax', 'odin_tpu', 'umap',",
      "              'transformers') and sys.modules[m] is not None)",
      "assert not bad, bad"])
  res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
  assert res.returncode == 0, res.stderr
