"""Where the 16-bit flash attention kernel's time goes: times variants of
``odin_tpu_torch/csrc/flash_attention_mma.cu``, each with one part of the
kernel removed or changed by a text substitution, at (B 4, H 8, T 4096,
D 64) bf16 non-causal on the card.  The variants compute wrong results by
design; only their times mean anything.  A substitution that no longer
matches the source fails loudly.

Run on a machine with an NVIDIA card and nvcc, from the repository root:

  python3 tools/k2_ablation.py

It builds one library per variant under build/k2_ablation/ (all nvcc
processes side by side) and prints, for each variant, the median of 20
CUDA-event timings in each of two rounds, and the card's name and power
limit.
"""
import ctypes
import os
import subprocess
import sys

import torch

SRC = "odin_tpu_torch/csrc/flash_attention_mma.cu"
OUT = "build/k2_ablation"
EXP = "s[n][i] = exp2f(fmaf(s[n][i], scale_log2e, -m_scaled[i % 4 / 2]));"
VARIANTS = {
    "base": [],
    "no_exp": [(EXP, "s[n][i] = fmaf(s[n][i], scale_log2e, "
                     "-m_scaled[i % 4 / 2]);")],
    "no_lo_product": [("wgmma_rs(acc[n], lo[j], b, T());", "")],
    "no_pv_product": [("wgmma_rs(acc[n], hi[j], b, T());", ""),
                      ("wgmma_rs(acc[n], lo[j], b, T());", "")],
    "no_qk_product": [("wgmma_ss(s[n], a, b, accumulate || kc > 0 ? 1 : 0, "
                       "T());", "")],
    # the loads kept, but of key tiles 0 and 1 every time (L2-resident);
    # the loads cannot simply go, since each stage's mbarrier waits for them
    "same_tile_loads": [("load_kv(kt + 2);", "load_kv(kt & 1);")],
    "no_hi_lo_split": [("lo = pack(x - hx, y - hy, unused_x, unused_y, T());",
                        "lo = hi;")],
    "no_softmax": [(EXP, ""), ("l[i % 4 / 2] += s[n][i];", ""),
                   ("lo = pack(x - hx, y - hy, unused_x, unused_y, T());",
                    "lo = hi;")],
}


def build():
  src = open(SRC).read()
  texts = {}
  for name, subs in VARIANTS.items():
    text = src
    for old, new in subs:
      if old not in text:
        sys.exit(f"{name}: {old!r} is not in {SRC}")
      text = text.replace(old, new)
    texts[name] = text
  os.makedirs(OUT, exist_ok=True)
  nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "nvcc")
  procs = {}
  for name, text in texts.items():
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
      f.write(text)
    procs[name] = subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
         os.path.join(OUT, f"lib{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  try:
    for name, proc in procs.items():
      log, _ = proc.communicate(timeout=300)
      if proc.returncode:
        sys.exit(f"nvcc failed on {name}:\n{log}")
  finally:
    for proc in procs.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()


def main():
  if not torch.cuda.is_available():
    sys.exit("k2_ablation: no CUDA card visible")
  build()
  B, H, T, D = 4, 8, 4096, 64
  gen = torch.Generator(device="cuda").manual_seed(0)
  q, k, v = ((torch.randn(B, H, T, D, device="cuda", generator=gen) * 0.5
              ).bfloat16() for _ in range(3))
  o = torch.empty_like(q)
  stream = torch.cuda.current_stream().cuda_stream
  times = {name: [] for name in VARIANTS}
  for _ in range(2):
    for name in VARIANTS:
      fn = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so")
                       ).odin_flash_attention_mma
      fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
          ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
      fn.restype = ctypes.c_int

      def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B * H, T, T, D, 0, D ** -0.5, 0, 1, stream)
        if err:
          sys.exit(f"{name}: launch failed with CUDA error {err}")

      for _ in range(3):
        call()
      ms = []
      for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
      times[name].append(sorted(ms)[10])
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip()
  print(smi)
  for name, ms in times.items():
    print(f"{name:16s} " + " ".join(f"{t:.4f}" for t in ms) + " ms")


if __name__ == "__main__":
  main()
