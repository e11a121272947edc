"""Build the port's CUDA sources with plain ``nvcc``, and its host C++
source with ``g++``, and load them with ctypes.

Each ``csrc/<name>.cu`` exports an ``extern "C"`` launcher and includes no
PyTorch header, so ``nvcc`` compiles it in seconds into a shared library
(``build/odin_tpu_torch/lib<name>-<hash>.so`` under the repository root).  The
hash covers the source and the flags, so a second run in the same tree reuses
the library and an edited source is rebuilt.  Nothing is compiled when a
module is imported: the first launch of a kernel builds it.

``csrc/odin_io.cpp``, the native corpus IO engine (``native.py``), is built
the same way with one ``g++ -O3 -shared -fPIC ... -lpthread`` at first use
(``build_host``), into the same directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["NVCC_FLAGS", "GXX_FLAGS", "build_all", "build_host",
           "host_library_path", "library_path", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "odin_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
GXX_TIMEOUT_S = 120

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


def _report(name: str, seconds: float, log: str) -> str:
  """When the build ended and what ``nvcc`` printed about each kernel's
  name, registers and spills."""
  lines = [f"nvcc {name}.cu: done {seconds:.2f} s after the builds began"]
  lines += [f"  {line.strip()}" for line in log.splitlines()
            if "entry function" in line or "registers" in line or
            "spill" in line]
  return "\n".join(lines)


def build_all(names: Sequence[str]) -> List[Path]:
  """Compile every source not yet built, one ``nvcc`` each, all started
  together.  Prints each build's seconds and ptxas's register and spill
  report."""
  outs = [library_path(name) for name in names]
  todo = [(name, out) for name, out in zip(names, outs) if not out.exists()]
  if todo:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
      tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
      procs.append((name, out, tmp, subprocess.Popen(
          [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    try:
      for name, out, tmp, proc in procs:
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        if proc.returncode:
          raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)
        print(_report(name, time.perf_counter() - t0, log), flush=True)
    finally:
      for *_, proc in procs:
        if proc.poll() is None:
          proc.kill()
          proc.wait()
  return outs


def load(name: str) -> ctypes.CDLL:
  """The library built from ``csrc/<name>.cu``, built at first use."""
  if name not in _LIBS:
    path, = build_all([name])
    _LIBS[name] = ctypes.CDLL(str(path))
  return _LIBS[name]


def host_library_path(name: str) -> Path:
  src = CSRC / f"{name}.cpp"
  digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
  """The shared library of ``csrc/<name>.cpp``, compiled with ``g++`` if
  not built yet (one call, within ``GXX_TIMEOUT_S``)."""
  out = host_library_path(name)
  if not out.exists():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    gxx = shutil.which("g++")
    if gxx is None:
      raise RuntimeError(f"g++ not found: csrc/{name}.cpp needs a C++ "
                         "compiler")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cpp"), "-lpthread"],
                         capture_output=True, text=True,
                         timeout=GXX_TIMEOUT_S)
    if res.returncode:
      raise RuntimeError(f"g++ failed on {name}.cpp:\n{res.stderr}")
    os.replace(tmp, out)
  return out
