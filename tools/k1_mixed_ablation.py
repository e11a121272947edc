"""Where the mixed-radix K1 kernel's time goes: times variants of
``odin_tpu_torch/csrc/logmel_fft_mixed.cu``, each with one part of the
kernel removed or changed by a text substitution, at Whisper's framing
(25,472 frames of 400 samples, n_fft 400, 80 mels from 0 Hz) on the card,
and prints what ptxas says of each variant's registers and spills.  The
variants that remove work compute wrong results by design; only their
times mean anything.  A substitution that no longer matches the source
fails loudly.

Run on a machine with an NVIDIA card and nvcc, from the repository root:

  python3 tools/k1_mixed_ablation.py [VARIANT ...]   (default: all)

It builds one library per variant under build/k1_mixed_ablation/ (all nvcc
processes side by side) and prints, for each variant, the median device
time of a call (CUDA events around bursts of 10 back-to-back calls, median
of 10 bursts) in each of two rounds, and the card's name and power limit.
With the base built, it also times the base at n_fft 400, 480, 882 and
1200 (25,472 frames as long as n_fft) with the groups that budgets of
2048, 4096, 6144 and 8192 points a group give (`_best_group`), beside the
group that `mixed_geometry` picks, and in each of the three shared-memory
layouts at that group, beside the layout it picks.
"""
import ctypes
import importlib
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from odin_tpu_torch._build import NVCC_FLAGS  # noqa: E402
from odin_tpu_torch.ops.features import FeatureConfig  # noqa: E402

k1 = importlib.import_module("odin_tpu_torch.ops.logmel")

SRC = "odin_tpu_torch/csrc/logmel_fft_mixed.cu"
OUT = "build/k1_mixed_ablation"
FRAMES = 25472
MEL = "acc[r] = fmaf(p[r][k], wk, acc[r]);"
LOG = "10.0f * log10f(fmaxf(acc[r] * out_scale, 1e-10f))"
PASSES = "for (int p = 1; p < plan_arg.passes; ++p) {"
NO_PASSES = "for (int p = 1; p < 1; ++p) {"
SPLIT = "for (int idx = threadIdx.x; idx < rows * pairs; idx += kThreads) {"
NO_SPLIT = "for (int idx = threadIdx.x; idx < 0; idx += kThreads) {"
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
# one radix's code replaced by radix 8's (n_fft 400 runs neither): which
# radix's code costs the registers; and all but radix 8's and 5's
for _radix in (2, 3, 4, 7, 16):
  VARIANTS[f"without_radix_{_radix}"] = [
      (f"fft_pass<{_radix}, kLayout, kFromStage>",
       "fft_pass<8, kLayout, kFromStage>")]
VARIANTS["only_radix_8_5"] = [
    sub for r in (2, 3, 4, 7, 16) for sub in VARIANTS[f"without_radix_{r}"]]
# other thread maps: threads a block and blocks an SM (the registers a
# thread may take follow)
THREADS = "constexpr int kThreads = 256;"
BLOCKS = "constexpr int kBlocksAnSm = 3;"
for _threads, _blocks in ((256, 2), (256, 4), (512, 2), (128, 6)):
  VARIANTS[f"threads_{_threads}_blocks_{_blocks}"] = [
      (THREADS, f"constexpr int kThreads = {_threads};"),
      (BLOCKS, f"constexpr int kBlocksAnSm = {_blocks};")]


def build(names):
  src = open(SRC).read()
  os.makedirs(OUT, exist_ok=True)
  nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "nvcc")
  procs = {}
  for name in names:
    text = src
    for old, new in VARIANTS[name]:
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
    spills = sorted({line.strip() for line in log.splitlines()
                     if "spill" in line or "registers" in line})
    print(f"{name}: " + " | ".join(spills), flush=True)
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
  libs = build(sys.argv[1:] or list(VARIANTS))
  cuda = torch.device("cuda", 0)
  cfg = FeatureConfig(n_fft=400, n_mels=80, fmin=0.0)
  bases = cfg.device_bases(cuda)
  twiddles, weights, bands = k1.fft_operands(bases, cfg.n_fft)
  geometry = k1.mixed_geometry(cfg.n_fft)
  gen = torch.Generator(device=cuda).manual_seed(0)
  frames = (torch.randn(FRAMES, cfg.frame_length, device=cuda,
                        generator=gen) * 0.1 * bases["window"]).contiguous()
  out = torch.empty(FRAMES, cfg.n_mels, device=cuda)
  stream = torch.cuda.current_stream(cuda).cuda_stream
  calls = {}
  for name, lib in libs.items():
    fn = lib.odin_logmel_fft_mixed
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    group, layout = geometry

    def call(fn=fn, name=name, layout=layout):
      err = fn(frames.data_ptr(), twiddles.data_ptr(), weights.data_ptr(),
               bands.data_ptr(), out.data_ptr(), FRAMES, cfg.frame_length,
               cfg.n_fft, cfg.n_mels, weights.numel(), group, layout,
               float(cfg.scale ** 2), stream)
      if err:
        sys.exit(f"{name}: launch failed with CUDA error {err}")
    calls[f"{name} ({k1.MIXED_LAYOUTS[layout]})"] = call
    if name == "base":  # the base in the layouts the bank model passed over
      for other in range(len(k1.MIXED_LAYOUTS)):
        if other != layout:
          calls[f"base ({k1.MIXED_LAYOUTS[other]})"] = (
              lambda base=call, other=other: base(layout=other))
  want = k1.logmel_reference(frames, bases["cos"], bases["sin"],
                             bases["mel_t"], cfg.scale ** 2)
  for name, call in calls.items():
    call()
    print(f"{name}: max |variant - plain| "
          f"{float((out - want).abs().max()):.3g} dB", flush=True)
  for rnd in (1, 2):
    for name, call in calls.items():
      print(f"round {rnd} {name}: {cuda_ms(call):.4f} ms", flush=True)
  if "base" in libs:
    framings(libs["base"].odin_logmel_fft_mixed, cuda, stream)
  return 0


def framings(fn, cuda, stream):
  """The base kernel at common framings with the groups of four budgets of
  points, and in each layout."""
  for sr, n_fft in ((16000, 400), (16000, 480), (44100, 882), (48000, 1200)):
    cfg = FeatureConfig(sr=sr, frame_length=n_fft, step_length=n_fft // 4,
                        n_fft=n_fft, n_mels=80 if n_fft == 400 else 40,
                        fmin=0.0)
    bases = cfg.device_bases(cuda)
    twiddles, weights, bands = k1.fft_operands(bases, n_fft)
    frames = (torch.randn(FRAMES, n_fft, device=cuda) * 0.1 *
              bases["window"]).contiguous()
    out = torch.empty(FRAMES, cfg.n_mels, device=cuda)
    picked = k1.mixed_geometry(n_fft)
    radices = [r for _, r in k1.fft_plan(n_fft)]

    def call(group, layout):
      err = fn(frames.data_ptr(), twiddles.data_ptr(), weights.data_ptr(),
               bands.data_ptr(), out.data_ptr(), FRAMES, n_fft, n_fft,
               cfg.n_mels, weights.numel(), group, layout,
               float(cfg.scale ** 2), stream)
      if err:
        sys.exit(f"n_fft {n_fft}: launch failed with CUDA error {err}")

    times = []
    for points in (2048, 4096, 6144, 8192):
      group = k1._best_group(n_fft // 2, radices, points)
      ms = cuda_ms(lambda: call(group, picked.layout))
      times.append(f"{points} points, group {group}: {ms:.4f} ms")
    print(f"n_fft {n_fft} ({'.'.join(map(str, radices))}), mixed_geometry "
          f"picks group {picked.group}: " + "; ".join(times), flush=True)
    times = [f"{name} {cuda_ms(lambda: call(picked.group, i)):.4f} ms"
             for i, name in enumerate(k1.MIXED_LAYOUTS)]
    print(f"n_fft {n_fft}, group {picked.group}, mixed_geometry picks "
          f"{k1.MIXED_LAYOUTS[picked.layout]}: " + "; ".join(times),
          flush=True)


if __name__ == "__main__":
  sys.exit(main())
