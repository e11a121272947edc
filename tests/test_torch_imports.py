"""The PyTorch port stands alone: odin_tpu_torch and chip_smoke.py import
nothing of JAX, nothing of the JAX package and nothing of scikit-learn (the
card's machine has none), and chip_smoke.py fails, printing no result,
where there is no CUDA card or no port beside it."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "odin_tpu", "sklearn")
SOURCES = sorted((ROOT / "odin_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


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
          "odin_tpu_torch.ml.scoring, odin_tpu_torch.ml.plda\n"
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
