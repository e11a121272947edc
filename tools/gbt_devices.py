"""Fit the port's ``GradientBoostingClassifier`` on the card and on the CPU
from the same inputs, over many seeded draws, and report how far the two
fits' probabilities lie apart.

The inputs have the shapes of ``chip_smoke.py``'s phase 22.4: 8 classes of
24 training and 8 test rows, 512 float32 features (x-vector-like: class
means plus noise; every other draw rounded to a grid of 0.25, which makes
equal feature values and tied gains common), 10 stages of depth 3.

Usage (on a machine with a CUDA card; each ROOT is a checkout of the repo
whose ``odin_tpu_torch`` is imported, in a process of its own)::

    python tools/gbt_devices.py [--trials 16] [ROOT ...]

One JSON line per root: the trials whose card and CPU probabilities differ
by more than 1e-12 and the largest difference, the trials whose raw
scores are not the same bits and their largest difference, the trials
whose trees differ, and the mean seconds of a fit on each device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

CLASSES, TRAIN, TEST, FEATURES, STAGES = 8, 24, 8, 512, 10


def draw(seed: int):
  rng = np.random.RandomState(seed)
  means = rng.randn(CLASSES, FEATURES) * 0.5
  y = np.repeat(np.arange(CLASSES), TRAIN + TEST)
  x = means[y] + rng.randn(len(y), FEATURES)
  if seed % 2:
    x = np.round(x * 4) / 4
  test = np.tile(np.arange(TRAIN + TEST) >= TRAIN, CLASSES)
  return x.astype(np.float32), y, test


def one_root(trials: int) -> dict:
  import torch

  from odin_tpu_torch.bay.vi.estimators import GradientBoostingClassifier
  sync = torch.cuda.synchronize
  apart, trees_apart, worst = [], 0, 0.0
  raw_apart, raw_worst = [], 0.0
  secs = {"cuda": [], "cpu": []}
  for seed in range(trials):
    x, y, test = draw(seed)
    out = {}
    for dev in ("cuda", "cpu"):
      X = torch.from_numpy(x).to(dev)
      sync()
      t = time.perf_counter()
      m = GradientBoostingClassifier(n_estimators=STAGES, random_state=1).fit(
          X[torch.from_numpy(~test).to(dev)], y[~test])
      p = m.predict_proba(X[torch.from_numpy(test).to(dev)])
      sync()
      secs[dev].append(time.perf_counter() - t)
      raw = m.decision_function(X[torch.from_numpy(test).to(dev)])
      out[dev] = (m, p.double().cpu().numpy(), raw.cpu().numpy())
    d = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    worst = max(worst, d)
    if d > 1e-12:
      apart.append(seed)
    r = float(np.abs(out["cuda"][2] - out["cpu"][2]).max())
    raw_worst = max(raw_worst, r)
    if r > 0:
      raw_apart.append(seed)
    same = all(bool(torch.equal(a[k].cpu(), b[k].cpu()))
               for a, b in zip(out["cuda"][0].trees_, out["cpu"][0].trees_)
               for k in ("feature", "threshold", "is_split"))
    trees_apart += not same
  return dict(trials=trials, proba_apart_trials=apart, max_abs_diff=worst,
              raw_apart_trials=raw_apart, raw_max_abs_diff=raw_worst,
              trees_apart=trees_apart,
              fit_s={k: float(np.mean(v)) for k, v in secs.items()},
              card=torch.cuda.get_device_name(0))


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("roots", nargs="*")
  ap.add_argument("--trials", type=int, default=16)
  ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.one:
    print(json.dumps(one_root(args.trials)))
    return 0
  here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  rc = 0
  for root in args.roots or [here]:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--trials", str(args.trials)], env=env,
                       capture_output=True, text=True)
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "{}"
    print(json.dumps(dict(json.loads(line), root=root, rc=r.returncode)))
    if r.returncode:
      sys.stderr.write(r.stderr[-4000:])
      rc = 1
  return rc


if __name__ == "__main__":
  sys.exit(main())
