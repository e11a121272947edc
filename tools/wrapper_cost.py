"""The host cost of K1's and K2's public calls on the card, for comparing
two versions of their wrappers.

For each tree given, in its own process: the host's microseconds a call of
``logmel`` (64 frames at each of n_fft 512, 400 and 551, one for each K1
kernel) and of ``flash_attention`` ((1, 1, 128, 64) in fp32 and bf16), on
inputs small enough that the card keeps up with the host
(``chip_smoke.host_us``: 2000 back-to-back calls on the host clock, the
card waited for after each run; the median of 5 runs); then the public
call's device time at the main paths' shapes as ``chip_smoke.py`` phases
2 and 5 time it (``chip_smoke.cuda_ms``: CUDA events around bursts of 10
back-to-back calls, median of 10 bursts): 25,472
frames of 400 samples at n_fft 512 and 400, 25,472 of 551 at n_fft 551,
and (4, 8, 4096, 64) in fp32 and bf16.

Run on a machine with an NVIDIA card and nvcc:

  python3 tools/wrapper_cost.py [ROOT ...]

Each ROOT (default: the repository holding this script) is a tree with an
``odin_tpu_torch`` package; give them in turns (parent, change, change,
parent) to compare two versions on one card.  The card's name and power
limit come first.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import cuda_ms, host_us  # noqa: E402  (the timers of phase 24)

FRAMES = 25472  # 64 utterances of 4 s at 16 kHz, 400-sample frames, step 160
SMALL_FRAMES = 64
# name, FeatureConfig's arguments
CONFIGS = (("n_fft 512", dict()),
           ("n_fft 400", dict(n_fft=400, n_mels=80, fmin=0.0)),
           ("n_fft 551", dict(sr=22050, frame_length=551, step_length=220,
                              n_fft=551, n_mels=80, fmin=0.0)))


def run(root):
  sys.path.insert(0, root)  # before HERE: the tree under test
  import torch
  from odin_tpu_torch.ops.features import FeatureConfig
  from odin_tpu_torch.ops.flash_attention import flash_attention
  from odin_tpu_torch.ops.logmel import logmel

  torch.backends.cuda.matmul.allow_tf32 = False
  cuda = torch.device("cuda", 0)
  gen = torch.Generator(device=cuda).manual_seed(0)
  line = []
  for name, kwargs in CONFIGS:
    cfg = FeatureConfig(**kwargs)
    window = cfg.device_bases(cuda)["window"]
    small = (torch.randn(SMALL_FRAMES, cfg.frame_length, device=cuda,
                         generator=gen) * 0.1 * window).contiguous()
    big = (torch.randn(FRAMES, cfg.frame_length, device=cuda,
                       generator=gen) * 0.1 * window).contiguous()
    line.append(f"logmel {name}: host_us={host_us(torch, lambda: logmel(small, cfg)):.2f} "
                f"ms={cuda_ms(torch, lambda: logmel(big, cfg)):.4f}")
  for dtype in (torch.float32, torch.bfloat16):
    small = torch.randn(1, 1, 128, 64, device=cuda, generator=gen).to(dtype)
    q, k, v = (torch.randn(4, 8, 4096, 64, device=cuda, generator=gen
                           ).to(dtype) for _ in range(3))
    line.append(
        f"flash_attention {dtype}: host_us="
        f"{host_us(torch, lambda: flash_attention(small, small, small)):.2f} "
        f"ms={cuda_ms(torch, lambda: flash_attention(q, k, v)):.4f}")
  print(f"{root}: " + "; ".join(line), flush=True)


def main():
  if len(sys.argv) > 1 and sys.argv[1] == "--one":
    run(os.path.abspath(sys.argv[2]))
    return 0
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip(), flush=True)
  for root in sys.argv[1:] or [HERE]:
    subprocess.run([sys.executable, __file__, "--one", root], check=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
