"""Where K1's FFT kernel's time goes: times variants of
``odin_tpu_torch/csrc/logmel_fft.cu``, each with one part of the kernel
removed or changed by a text substitution, at the speech path's shape
(25,472 frames of 400 samples, n_fft 512, 40 mels) on the card.  The
variants compute wrong results by design; only their times mean anything.
A substitution that no longer matches the source fails loudly.

Run on a machine with an NVIDIA card and nvcc, from the repository root:

  python3 tools/k1_ablation.py

It builds one library per variant under build/k1_ablation/ (all nvcc
processes side by side) and prints, for each variant, the median device
time of a call (CUDA events around bursts of 10 back-to-back calls, median
of 10 bursts) in each of two rounds, and the card's name and power limit.
"""
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from odin_tpu_torch._build import NVCC_FLAGS  # noqa: E402
from odin_tpu_torch.ops.features import FeatureConfig  # noqa: E402
from odin_tpu_torch.ops.logmel import fft_operands  # noqa: E402

SRC = "odin_tpu_torch/csrc/logmel_fft.cu"
OUT = "build/k1_ablation"
FRAMES = 25472
MEL = "acc[r] = fmaf(p[r][k], wk, acc[r]);"
LOG = "10.0f * log10f(fmaxf(acc[r] * out_scale, 1e-10f))"
PASSES = "for (int ns = radix0; ns < m; ns *= 16) {"
NO_PASSES = "for (int ns = radix0; ns < 0; ns *= 16) {"
SPLIT = "if (f < rows) {\n        const float2* z = buf + f * m_pad;"
NO_SPLIT = "if (f < 0) {\n        const float2* z = buf + f * m_pad;"
VARIANTS = {
    "base": [],
    "no_mel_product": [(MEL, "")],
    "no_log": [(LOG, "acc[r]")],
    "no_later_passes": [(PASSES, NO_PASSES)],
    "no_split": [(SPLIT, NO_SPLIT)],
    # every group reads the same frames (L2-resident) in place of its own
    "same_frames": [("frames + next * group_stride", "frames")],
    # the frames staged, the first pass, and the mels written
    "first_pass_loads_stores": [(PASSES, NO_PASSES), (SPLIT, NO_SPLIT),
                                (MEL, ""), (LOG, "acc[r]")],
}


def build():
  src = open(SRC).read()
  os.makedirs(OUT, exist_ok=True)
  nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "nvcc")
  procs = {}
  for name, subs in VARIANTS.items():
    text = src
    for old, new in subs:
      if old not in text:
        sys.exit(f"{name}: {old!r} is not in {SRC}")
      text = text.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
      f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    procs[name] = (lib, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", lib, path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  libs = {}
  for name, (lib, proc) in procs.items():
    log, _ = proc.communicate(timeout=300)
    if proc.returncode:
      sys.exit(f"nvcc failed on {name}:\n{log}")
    libs[name] = ctypes.CDLL(lib)
  return libs


def cuda_ms(fn, reps=10, burst=10, warmup=3):
  """Median device time of one call of `fn` in ms: a pair of CUDA events
  around each burst of `burst` back-to-back calls, so that a call's host
  work overlaps the previous call's kernel, over the count; the median of
  `reps` bursts."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(burst):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / burst)
  times.sort()
  return times[len(times) // 2]


def main():
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip(), flush=True)
  libs = build()
  cuda = torch.device("cuda", 0)
  cfg = FeatureConfig()
  bases = cfg.device_bases(cuda)
  twiddles, weights, bands = fft_operands(bases, cfg.n_fft)
  gen = torch.Generator(device=cuda).manual_seed(0)
  frames = (torch.randn(FRAMES, cfg.frame_length, device=cuda,
                        generator=gen) * 0.1 * bases["window"]).contiguous()
  out = torch.empty(FRAMES, cfg.n_mels, device=cuda)
  stream = torch.cuda.current_stream(cuda).cuda_stream
  calls = {}
  for name, lib in libs.items():
    fn = lib.odin_logmel_fft
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(fn=fn, name=name):
      err = fn(frames.data_ptr(), twiddles.data_ptr(), weights.data_ptr(),
               bands.data_ptr(), out.data_ptr(), FRAMES, cfg.frame_length,
               cfg.n_fft.bit_length() - 1, cfg.n_mels, weights.numel(),
               float(cfg.scale ** 2), stream)
      if err:
        sys.exit(f"{name}: launch failed with CUDA error {err}")
    calls[name] = call
  for rnd in (1, 2):
    for name, call in calls.items():
      print(f"round {rnd} {name}: {cuda_ms(call):.4f} ms", flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
