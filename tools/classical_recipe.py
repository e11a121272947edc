"""Run phase 22's classical-ML path (``chip_smoke.classical_*``) on the
CPU at a reduced scale, and print the figures its limits stand on; with
``--device cuda``, make phase 21's x-vectors on the card and time the
trees' draws there.

  python tools/classical_recipe.py [--files 256] [--steps 300]
      [--frames 100] [--stages 10] [--trees 20] [--speakers 64]
      [--root DIR] [--vectors FILE.npy] [--device cpu]
      [--parts reductions,backends,topics,fp32]

The corpus (phase 9's 2048 int16 wav files, ``chip_smoke.write_corpus``)
is written under ``build/speaker_recipe`` (or DIR) unless it is there.
Steps, on ``--device`` (the CPU by default):

1. ``reductions``: the log-mels (40 mels, n_fft 512) of the first
   ``--files`` files, the five reductions of 22.1 and GMMThreshold on
   them, each against a float64 eigh (``classical_reductions``);
2. ``backends``: phase 21's x-vector recipe cut to ``--steps`` steps of
   ``--frames`` frames (0: phase 21's, the shortest utterance's) on all
   files, then the back-ends of 22.2 on its ``embedding_a`` vectors
   (``classical_backends``): each accuracy and EER, what ``CL_CPU``
   holds.  The CPU takes about 32 s a boosting stage and 0.6 s a forest
   tree at 64 speakers (and 30 minutes for the logistic regression's
   dense Newton), so the boosted trees run ``--stages`` stages and
   the forest ``--trees`` trees (the card runs the JAX package's 100 of
   each); ``--speakers`` keeps the first speakers only (a quick check of
   the path, not the limits' run); ``--vectors`` keeps the x-vectors in
   a .npy file and reads them from it when it exists (the recipe is then
   not run again);
3. ``topics``: 22.3 (``classical_topics``);
4. ``fp32``: 22.4's small shapes (``classical_small``) from float32 inputs
   against the same from float64 inputs, each over float64's largest
   magnitude: what ``CL_CARD``'s limits stand on;
5. ``card`` (``--device cuda``): 22.4 itself, the card against the CPU;
6. ``draws`` (``--device cuda``): 22.2's boosted trees and forest at the
   JAX package's 100 stages and trees, each fitted with the feature draws
   replayed by ``csrc/splitter_draws.cpp`` and by ``_SplitterDraws``'
   Python loop, in turns: each fit's seconds, and the largest difference
   between the two fits' probabilities.

``--parts`` runs the steps named (all but ``card`` and ``draws`` by
default; every step but ``reductions`` and ``topics`` needs the x-vectors,
so it runs the recipe or reads ``--vectors``).  One JSON line at the end
holds every figure and each step's seconds.  Phase 21's x-vectors on the
card: ``--device cuda --steps 1200 --frames 0 --parts draws,card
--vectors FILE.npy``.
"""
import argparse
import glob
import json
import os
import re
import sys
import time


def main(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--files", type=int, default=256)
  ap.add_argument("--steps", type=int, default=300)
  ap.add_argument("--frames", type=int, default=100)
  ap.add_argument("--stages", type=int, default=10)
  ap.add_argument("--trees", type=int, default=20)
  ap.add_argument("--speakers", type=int, default=64)
  ap.add_argument("--root", default=None)
  ap.add_argument("--vectors", default=None)
  ap.add_argument("--device", default="cpu")
  ap.add_argument("--parts", default="reductions,backends,topics,fp32")
  args = ap.parse_args(argv)
  root_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir)
  sys.path.insert(0, root_dir)
  import numpy as np
  import torch

  import chip_smoke as cs
  from odin_tpu_torch.ops.features import FeatureConfig
  from odin_tpu_torch.preprocessing import batch_speech_features
  from odin_tpu_torch.preprocessing.speech import read_wave_raw

  root = args.root or os.path.join(root_dir, "build", "speaker_recipe")
  if not os.path.isdir(os.path.join(root, "wav")):
    os.makedirs(root, exist_ok=True)
    cs.write_corpus(root)
  files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
  files = [f for f in files if int(re.match(
      r"s(\d+)_", os.path.basename(f)).group(1)) < args.speakers]
  names = [os.path.basename(f) for f in files]
  spk = np.array([int(re.match(r"s(\d+)_", n).group(1)) for n in names])
  utt = np.array([int(re.search(r"_u(\d+)", n).group(1)) for n in names])
  raw = [read_wave_raw(f)[0] for f in files]
  dev = args.device
  cuda = torch.device(dev).type == "cuda"
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  out = {"args": vars(args)}
  if cuda:
    import subprocess
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()

  parts = set(args.parts.split(","))
  t0 = time.perf_counter()
  feats = batch_speech_features(raw[:args.files], FeatureConfig(),
                                features=("mspec",), device=dev)
  frames = torch.from_numpy(np.concatenate([f["mspec"] for f in feats]))
  if "reductions" in parts:
    red, th = cs.classical_reductions(torch, np, frames.to(dev), dev, sync)
    out["reductions"] = {k: dict(ev=v[0], angle=v[1], share=v[2],
                                 seconds=v[3]) for k, v in red.items()}
    out["threshold"] = dict(low=th[0], threshold=th[1], high=th[2],
                            seconds=th[3], frames=int(frames.shape[0]))
    out["reductions_s"] = time.perf_counter() - t0

  vecs = None
  if parts & {"backends", "fp32", "card", "draws"}:
    t0 = time.perf_counter()
    if args.vectors and os.path.exists(args.vectors):
      vecs = torch.from_numpy(np.load(args.vectors))
    else:
      r = cs.xvector_recipe(torch, np, raw, spk, dev, steps=args.steps,
                            frames=args.frames or None)
      out["xvector_eer"] = r["eer"]
      vecs = r["vecs"].cpu()
      if args.vectors:
        np.save(args.vectors, vecs.numpy())
    out["xvector_s"] = time.perf_counter() - t0
  if "backends" in parts:
    t0 = time.perf_counter()
    res = cs.classical_backends(
        torch, np, vecs.to(dev), spk, utt, dev, sync,
        cuts={"gbt": {"n_estimators": args.stages},
              "rf": {"n_estimators": args.trees}})
    out["backends"] = {k: {m: v[m] for m in ("accuracy", "EER", "minDCF",
                                             "Cnorm", "log_loss", "seconds")}
                       for k, v in res.items()}
    out["backends_s"] = time.perf_counter() - t0
  if "topics" in parts:
    _, ppl, strings, match, secs = cs.classical_topics(torch, np, dev,
                                                       sync)
    out["topics"] = dict(first=ppl[0], last=ppl[-1], match=match,
                         seconds=secs)
    print("\n".join(strings))
  if "fp32" in parts:
    t0 = time.perf_counter()
    f32 = cs.classical_small(torch, np, frames.numpy(), vecs, spk, utt,
                             "cpu")
    f64 = cs.classical_small(torch, np, frames.numpy(), vecs, spk, utt,
                             "cpu", dtype=torch.float64)
    out["fp32"] = cs.apart(np, f32, f64)
    out["small_s"] = time.perf_counter() - t0
  if "card" in parts:
    t0 = time.perf_counter()
    card = cs.classical_small(torch, np, frames.numpy(), vecs, spk, utt, dev)
    cpu = cs.classical_small(torch, np, frames.numpy(), vecs, spk, utt,
                             "cpu")
    out["card_vs_cpu"] = cs.apart(np, card, cpu)
    out["card_s"] = time.perf_counter() - t0
  if "draws" in parts:
    out["draws"] = time_draws(torch, np, cs, vecs.to(dev), spk, utt, sync)
  print(json.dumps(out))
  return 0


def time_draws(torch, np, cs, vecs, spk, utt, sync, turns: int = 2):
  """22.2's boosted trees and forest on `vecs`, fitted with the library's
  draws and with the Python replay's in turns; -> {name: {"native":
  [seconds...], "python": [seconds...], "apart": the largest difference
  between their probabilities}}."""
  from odin_tpu_torch.bay.vi.estimators import SplitterDrawsBatch
  from odin_tpu_torch.ml import linear_classifier
  train = utt < cs.CL_TRAIN_UTT
  tr = torch.from_numpy(train).to(vecs.device)
  Xtr, Xte, ytr = vecs[tr], vecs[~tr], spk[train]
  visit = SplitterDrawsBatch.visit
  res = {}
  for algo in ("gbt", "rf"):
    r = res[algo] = {"native": [], "python": []}
    probs = {}
    for _ in range(turns):
      for native in (True, False):
        SplitterDrawsBatch.visit = (
            lambda self, *a, _n=native, **k: visit(self, *a, native=_n, **k))
        try:
          sync()
          t = time.perf_counter()
          model = linear_classifier(Xtr, ytr, algo=algo)
          sync()
          r["native" if native else "python"].append(time.perf_counter() - t)
        finally:
          SplitterDrawsBatch.visit = visit
        probs[native] = model.predict_proba(Xte)
    r["apart"] = float((probs[True] - probs[False]).abs().max())
  return res


if __name__ == "__main__":
  sys.exit(main())
