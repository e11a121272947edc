"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports an ``extern "C"`` launcher and includes no
PyTorch header, so ``nvcc`` compiles it in seconds into a shared library
(``build/odin_tpu_torch/lib<name>-<hash>.so`` under the repository root).  The
hash covers the source and the flags, so a second run in the same tree reuses
the library and an edited source is rebuilt.  Nothing is compiled when a
module is imported: the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["NVCC_FLAGS", "build_all", "library_path", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "odin_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
  path = os.path.join(cuda_home, "bin", "nvcc")
  if os.path.exists(path):
    return path
  path = shutil.which("nvcc")
  if path is None:
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
  return path


def library_path(name: str) -> Path:
  src = CSRC / f"{name}.cu"
  digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> List[Path]:
  """Compile every source not yet built, one ``nvcc`` after another.
  Prints each build's seconds and ptxas's register and spill report."""
  outs = []
  for name in names:
    out = library_path(name)
    if not out.exists():
      BUILD_DIR.mkdir(parents=True, exist_ok=True)
      tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
      t0 = time.perf_counter()
      log = subprocess.run(
          [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
          timeout=NVCC_TIMEOUT_S, check=True, capture_output=True,
          text=True)
      os.replace(tmp, out)
      print(f"nvcc {name}.cu: {time.perf_counter() - t0:.2f} s", flush=True)
      for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line:
          print(f"  {line.strip()}", flush=True)
    outs.append(out)
  return outs


def load(name: str) -> ctypes.CDLL:
  """The library built from ``csrc/<name>.cu``, built at first use."""
  if name not in _LIBS:
    path, = build_all([name])
    _LIBS[name] = ctypes.CDLL(str(path))
  return _LIBS[name]
