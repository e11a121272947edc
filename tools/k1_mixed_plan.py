"""The mixed-radix K1 kernel's geometry (``csrc/logmel_fft_mixed.cu``) for
each n_fft given: its Stockham passes, the frames a block transforms at
once, each pass's idle share of butterfly slots, and the
shared-memory wavefronts of a group under each layout, with the one the
kernel takes.

Runs on the CPU (it computes from ``ops/logmel.py`` alone):

  python3 tools/k1_mixed_plan.py [N_FFT ...]    (default: 400 480 882 1200)
"""
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
k1 = importlib.import_module("odin_tpu_torch.ops.logmel")


def main():
  for n_fft in [int(a) for a in sys.argv[1:]] or [400, 480, 882, 1200]:
    group, layout = k1.mixed_geometry(n_fft)
    radices = [r for _, r in k1.fft_plan(n_fft)]
    idle = k1.mixed_idle_shares(n_fft)
    costs = {name: k1._bank_cost(n_fft, group, i)
             for i, name in enumerate(k1.MIXED_LAYOUTS)}
    print(f"n_fft {n_fft}: M = {n_fft // 2} = "
          f"{'.'.join(map(str, radices))}, group {group} frames "
          f"({group * n_fft // 2} points); idle share of each pass: " +
          ", ".join(f"{100 * x:.1f} %" for x in idle) +
          "; wavefronts a group: " +
          ", ".join(f"{k} {v}" for k, v in costs.items()) +
          f"; layout {k1.MIXED_LAYOUTS[layout]}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
