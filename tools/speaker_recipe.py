"""Run the README's speaker recipe (``chip_smoke.speaker_recipe``, phase 11)
on phase 9's corpus at one nmix and device, and print how far the recipe's
fp32 steps lie from float64 on the first 128 files.

  python tools/speaker_recipe.py [--nmix 64] [--device cpu] [--root DIR]

The corpus (2048 int16 wav files, ``chip_smoke.write_corpus``) is written
under ``build/speaker_recipe`` (or DIR) unless it is there.  Printed, as
one JSON line at the end: the recipe's results (cosine EER, minDCF and
accuracy, PLDA EER and accuracy), its stage seconds on that device, and
the distances, each over the float64 value's largest magnitude:

- ``gmm_fp32``: one GMM E-step (Z, F, S) and ``transform_batch`` (Z, F) in
  fp32, as the port computes them, from the same computation in float64;
- ``tmat_fp32``: one T-matrix E-step (LU, RU) and the i-vectors likewise;
- ``float64_ulps``: the cosine scores and PLDA llrs refitted from
  i-vectors moved by a few float64 roundings (relative 2^-50), which bounds
  what summing in another order does to them.

Phase 11 fixes its learning limits from the CPU run at nmix 64 and holds
the card against the CPU at limits above these distances (a card's fp32
sums and the CPU's are each about this far from float64).
"""
import argparse
import json
import os
import sys
import time


def fp32_distances(torch, np, gmm, tmat, feats):
  """(GMM, T-matrix) {name: fp32 distance from float64} on `feats`."""
  from odin_tpu_torch.ml import gmm_tmat

  def apart(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())

  dev = gmm.device
  X = torch.from_numpy(np.concatenate(feats)).to(dev)
  mu, sigma = gmm.mu.double(), gmm.sigma.double()
  inv = 1.0 / sigma
  c = (mu * mu * inv + torch.log(sigma)).sum(1) + \
      mu.shape[1] * np.log(2 * np.pi)
  logw = torch.log(gmm.w.double())
  exact = [sum(v) for v in zip(*(
      gmm_tmat._estep_chunk(X[i:i + gmm.batch_size].double(), mu, inv, c,
                            logw)[:3]
      for i in range(0, len(X), gmm.batch_size)))]
  got = gmm.expectation(X)[:3]
  out = {f"estep_{k}": apart(g, e) for k, g, e in zip("ZFS", got, exact)}
  T = 1024  # the corpus's utterances are 400-800 frames
  x = torch.zeros((len(feats), T, X.shape[1]), dtype=torch.float64,
                  device=dev)
  mask = torch.zeros((len(feats), T), dtype=torch.float64, device=dev)
  for b, f in enumerate(feats):
    x[b, :len(f)] = torch.from_numpy(f)
    mask[b, :len(f)] = 1.0
  Z64, F64 = gmm_tmat._estep_masked(x, mask, mu, inv, c, logw)
  F64 = (F64 - Z64[:, :, None] * mu).reshape(len(feats), -1)
  Z, F = gmm.transform_batch(feats)
  out.update(batch_Z=apart(Z, Z64), batch_F=apart(F, F64))
  # the T-matrix E-step of the same statistics, fp32 against float64
  LU, RU, _ = tmat.expectation(Z, F)
  R, M, D = tmat.tv_dim, tmat.nmix, tmat.ndim
  Tm = tmat.Tm.double()
  Ts = Tm / gmm.sigma.double().reshape(-1)
  TT = torch.bmm(Ts.reshape(R, M, D).permute(1, 0, 2),
                 Tm.reshape(R, M, D).permute(1, 2, 0))
  Zd, Fd = Z.double(), F.double()
  L = torch.eye(R, dtype=torch.float64, device=dev) + \
      (Zd @ TT.reshape(M, R * R)).reshape(-1, R, R)
  mean = torch.linalg.solve(L, (Fd @ Ts.T)[..., None])[..., 0]
  Exx = torch.linalg.inv(L) + mean[:, :, None] * mean[:, None, :]
  tm = {"estep_LU": apart(LU, (Zd.T @ Exx.reshape(-1, R * R)).reshape(
      M, R, R)), "estep_RU": apart(RU, mean.T @ Fd),
        "ivectors": apart(tmat.transform((Z, F)), mean)}
  return out, tm


def float64_ulps(torch, np, x_train, y_train, x_test, y_test):
  """Largest change of the cosine scores and PLDA llrs, over their largest
  magnitude, when the i-vectors move by a relative 2^-50."""
  import chip_smoke
  from odin_tpu_torch.ml import PLDA, Scorer
  x_train, x_test = x_train.double().cpu(), x_test.double().cpu()
  g = torch.Generator().manual_seed(0)
  nudge = lambda x: x * (1 + 2.0 ** -50 * torch.randn(
      x.shape, generator=g, dtype=torch.float64))
  out = {}
  for name, make, score in (
      ("cosine", lambda: Scorer(method="cosine", wccn=True, device="cpu"),
       lambda m, t: m.score(t)),
      ("plda", lambda: PLDA(**chip_smoke.SPK_PLDA, device="cpu"),
       lambda m, t: m.score_matrix(t, t))):
    a = score(make().fit(x_train, y_train), x_test)
    b = score(make().fit(nudge(x_train), y_train), nudge(x_test))
    out[name] = float((a - b).abs().max() / a.abs().max())
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--nmix", type=int, default=64)
  parser.add_argument("--device", default="cpu")
  parser.add_argument("--root", default=None)
  args = parser.parse_args()
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, repo)
  import glob

  import numpy as np
  import torch

  import chip_smoke

  root = args.root or os.path.join(repo, "build", "speaker_recipe")
  files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
  if len(files) != chip_smoke.CORPUS_SPEAKERS * chip_smoke.CORPUS_UTTERANCES:
    t0 = time.perf_counter()
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    chip_smoke.write_corpus(root)
    files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
    print(f"wrote the corpus in {time.perf_counter() - t0:.1f} s",
          flush=True)
  r = chip_smoke.speaker_recipe(torch, np, files, args.device, args.nmix)
  gmm, tmat = r["ivec"].gmm, r["ivec"].tmat
  first = r["feats"][:chip_smoke.SPK_CPU_FILES]
  gmm_d, tmat_d = fp32_distances(torch, np, gmm, tmat, first)
  train = r["train"]
  ulps = float64_ulps(torch, np, r["x_train"], r["spk"][train],
                      r["x_test"], r["spk"][~train])
  print(json.dumps({
      "device": args.device, "nmix": args.nmix, "files": len(files),
      "frames": r["n_frames"], "cos_eer": r["cos_eer"],
      "cos_dcf": r["cos_dcf"], "cos_acc": r["cos_acc"],
      "plda_eer": r["plda_eer"], "plda_acc": r["plda_acc"],
      "levels_llk": chip_smoke.level_llks(gmm.llk_history),
      "n_estep": len(gmm.llk_history),
      "seconds": {k: v for k, v in r.items() if k.endswith("_s")},
      "gmm_fp32": gmm_d, "tmat_fp32": tmat_d, "float64_ulps": ulps}))


if __name__ == "__main__":
  main()
