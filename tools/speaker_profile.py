"""Where the speaker path's time goes on the card: the GMM E-step and the
T-matrix EM iteration at phase 11's shapes, under ``torch.profiler``.

  python tools/speaker_profile.py        # on the card, from the repo root

Synthetic data from a seed at phase 11's shapes (the ops and their shapes
do not depend on the values): 761,437 frames of 20 dims, a UBM of 512
mixtures; 1280 utterances of 400-800 frames; a T-matrix of 100 dims.
Prints, with the card's name and power limit:

- the E-step's host-clock ms at ``batch_size`` 8192 (the default) and at
  65,536, median of 5, and for one E-step at 8192 the device's busy time
  (the union of its kernels' intervals in the trace) over the wall time,
  and the kernels' sums by name;
- the T-matrix iteration's ms split into its E-step, the per-mixture
  solves and the SVD, and a trace of one iteration by kernel.
"""
import os
import subprocess
import sys
import time


def main():
  sys.path.insert(0, os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  import numpy as np
  import torch
  from torch.profiler import ProfilerActivity, profile

  from odin_tpu_torch.ml import GMM, Tmatrix

  if not torch.cuda.is_available():
    sys.exit("speaker_profile: needs a CUDA card")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip()
  cuda = torch.device("cuda", 0)
  g = torch.Generator(cuda).manual_seed(0)
  M, D, N = 512, 20, 761437
  gmm = GMM(nmix=M, device="cuda")
  gmm.mu = torch.randn((M, D), generator=g, device=cuda)
  gmm.sigma = 0.5 + torch.rand((M, D), generator=g, device=cuda)
  gmm.w = torch.full((M,), 1.0 / M, device=cuda)
  gmm.ndim = D
  X = torch.randn((N, D), generator=g, device=cuda)

  def host_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
      torch.cuda.synchronize()
      t = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[reps // 2]

  def busy_share(prof, wall_ms):
    """Union of the device kernels' intervals over the wall time."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
      if end is None or a > end:
        busy += b - a
        end = b
      elif b > end:
        busy += b - end
        end = b
    return busy / 1e3, len(spans)

  def trace(fn, label):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall = 1e3 * (time.perf_counter() - t)
    busy, n = busy_share(prof, wall)
    print(f"{label}: wall {wall:.3f} ms under the profiler, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} %), {n} kernels; {smi}")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=12))

  for bs in (8192, 65536):
    gmm.batch_size = bs
    print(f"GMM E-step {M} x {D} over {N} frames, batch_size {bs}: "
          f"{host_ms(lambda: gmm.expectation(X)):.3f} ms (median of 5); "
          f"{smi}", flush=True)
  gmm.batch_size = 8192
  trace(lambda: gmm.expectation(X), "GMM E-step, batch_size 8192")

  rng = np.random.RandomState(0)
  utts = [X[590 * k:590 * k + n]
          for k, n in enumerate(rng.randint(400, 801, 1280))]
  Z, F = gmm.transform_batch(utts)
  tmat = Tmatrix(tv_dim=100, gmm=gmm, device="cuda").initialize()
  LU, RU, _ = tmat.expectation(Z, F)
  sync = torch.cuda.synchronize
  parts = {
      "E-step": lambda: tmat.expectation(Z, F),
      "solves": lambda: (torch.linalg.solve(LU, RU.reshape(100, M, D)
                                            .permute(1, 0, 2)), sync()),
      "SVD": lambda: (torch.linalg.svd(tmat.Tm @ tmat.Tm.T), sync()),
      "iteration": lambda: tmat.maximization(*tmat.expectation(Z, F)[:2])}
  print("T-matrix (R 100, 1280 utterances): " + ", ".join(
      f"{k} {host_ms(fn):.3f} ms" for k, fn in parts.items()) +
      f" (medians of 5); {smi}", flush=True)
  trace(parts["iteration"], "T-matrix iteration")


if __name__ == "__main__":
  main()
