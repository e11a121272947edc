"""K1's kernels on the card: times the kernel that each config takes
(``kernel_route``: ``csrc/logmel_fft.cu`` for a power-of-two n_fft,
``csrc/logmel_fft_mixed.cu`` for n_fft 400), the dense-DFT kernel
(``csrc/logmel.cu``), the plain version and ``torch.fft.rfft`` + mel at the
speech path's shape (25,472 frames of 400 samples, n_fft 512), at n_fft
1024 with 1024-sample frames and at Whisper's framing (n_fft 400, 80 mels
from 0 Hz), on white noise, with the routed kernel's largest difference
from the plain version on white noise and on ``harmonic_frames``.

Run on a machine with an NVIDIA card and nvcc:

  python3 tools/k1_bench.py [ROOT ...]

Each ROOT (default: the repository holding this script) is a tree with an
``odin_tpu_torch`` package; each is run in its own process, in the order
given, so that two versions of the kernels can be compared in turns on one
card (for example: parent, change, change, parent).  Each prints, per
shape, the median device time of a call (CUDA events around bursts of 10
back-to-back calls, median of 10 bursts); the card's name and power limit
come first.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 25472  # 64 utterances of 4 s at 16 kHz, 400-sample frames, step 160
# frame_length, step, n_fft, n_mels, fmin
SHAPES = ((400, 160, 512, 40, 64.0), (1024, 256, 1024, 40, 64.0),
          (400, 160, 400, 80, 0.0))


def cuda_ms(torch, fn, reps=10, burst=10, warmup=3):
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


def run(root):
  sys.path.insert(0, root)
  import importlib

  import torch
  from odin_tpu_torch.ops.features import FeatureConfig
  k1 = importlib.import_module("odin_tpu_torch.ops.logmel")

  torch.backends.cuda.matmul.allow_tf32 = False
  cuda = torch.device("cuda", 0)
  for frame_length, step, n_fft, n_mels, fmin in SHAPES:
    cfg = FeatureConfig(frame_length=frame_length, step_length=step,
                        n_fft=n_fft, n_mels=n_mels, fmin=fmin)
    route = k1.kernel_route(n_fft)
    bases = cfg.device_bases(cuda)
    mel_t, scale_sq = bases["mel_t"], cfg.scale ** 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    noise = (torch.randn(FRAMES, frame_length, device=cuda, generator=gen) *
             0.1 * bases["window"]).contiguous()
    harmonic = k1.harmonic_frames(FRAMES, cfg, seed=0, device=cuda)
    out = torch.empty(FRAMES, cfg.n_mels, device=cuda)

    def plain(frames):
      return k1.logmel_reference(frames, bases["cos"], bases["sin"], mel_t,
                                 scale_sq)

    def library():
      spec = torch.fft.rfft(noise, n=n_fft)
      power = (spec.real ** 2 + spec.imag ** 2) * scale_sq
      return 10.0 * torch.log10(torch.clamp(power @ mel_t, min=1e-10))

    errs = []
    for frames in (noise, harmonic):
      k1._launch(route, frames, cfg, out)
      errs.append(float((out - plain(frames)).abs().max()))
    times = {name: cuda_ms(torch, fn) for name, fn in (
        (route, lambda: k1._launch(route, noise, cfg, out)),
        ("dense", lambda: k1._launch("dense", noise, cfg, out)),
        ("plain", lambda: plain(noise)), ("rfft+mel", library))}
    print(f"{root}: N={FRAMES} frame_length={frame_length} n_fft={n_fft} "
          f"n_mels={n_mels}: " +
          " ".join(f"{k}_ms={v:.4f}" for k, v in times.items()) +
          f" {route} max |kernel - plain| noise {errs[0]:.3g} dB, harmonic "
          f"{errs[1]:.3g} dB", flush=True)


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
