"""Run the x-vector recipe (``chip_smoke.xvector_recipe``, phase 21) on
phase 9's corpus on the CPU at a reduced scale, and print how far one
step's float32, and each layer's of phase 21.2, lie from float64.

  python tools/xvector_recipe.py [--steps 300] [--frames 100] [--root DIR]

The corpus (2048 int16 wav files, ``chip_smoke.write_corpus``) is written
under ``build/speaker_recipe`` (or DIR) unless it is there, the corpus of
``tools/speaker_recipe.py``.  ``--steps`` and ``--frames`` cut the
recipe's 1200 steps and its utterances (the shortest one's 398 frames
otherwise).  Printed, as one JSON line at the end: the recipe's EER and
minDCF, its stage seconds, the loss at the start and the end, and
``fp32``: one step of the recipe's loss at the initial weights on its
first batch of 32 (all frames up to the shortest utterance's) in float32
on the CPU against float64, each over float64's largest magnitude (loss,
logits, embedding, the largest over the gradient tensors); and
``layers_fp64``: each layer of phase 21.2 on the CPU in float64 against
float32 (output, gradient), what the phase's limits for the recurrent
layers stand on.

Phase 21 fixes its PLDA EER limit from the CPU run at a reduced scale and
holds one step on the card against the CPU at about 100x the ``fp32``
distances.
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
  ap.add_argument("--steps", type=int, default=300)
  ap.add_argument("--frames", type=int, default=100)
  ap.add_argument("--root", default=None)
  args = ap.parse_args(argv)
  root_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir)
  sys.path.insert(0, root_dir)
  import numpy as np
  import torch

  import chip_smoke
  from odin_tpu_torch.preprocessing.speech import read_wave_raw

  root = args.root or os.path.join(root_dir, "build", "speaker_recipe")
  if not os.path.isdir(os.path.join(root, "wav")):
    os.makedirs(root, exist_ok=True)
    chip_smoke.write_corpus(root)
  files = sorted(glob.glob(os.path.join(root, "wav", "*.wav")))
  spk = np.array([int(re.match(r"s(\d+)_", os.path.basename(f)).group(1))
                  for f in files])
  raw = [read_wave_raw(f)[0] for f in files]
  t0 = time.perf_counter()
  r = chip_smoke.xvector_recipe(torch, np, raw, spk, "cpu",
                                steps=args.steps, frames=args.frames)
  wall = time.perf_counter() - t0
  # one step at the card's shape: the first batch, every frame up to the
  # shortest utterance's
  frames = min(len(f) for f in r["feats"])
  idx = np.random.RandomState(1).randint(0, len(files), chip_smoke.XV_BATCH)
  x = torch.from_numpy(np.stack([r["feats"][i][:frames] for i in idx])
                       .astype(np.float32))
  y = torch.from_numpy(spk[idx])
  init = r["init"]
  f32 = chip_smoke.xvector_one_step(torch, r["net"], init, x, y, "cpu")
  f64 = chip_smoke.xvector_one_step(torch, r["net"], init, x, y, "cpu",
                                    torch.float64)
  layers_fp64, _ = chip_smoke.xvector_layers(torch, np, "cpu", torch.float64)
  losses = r["losses"]
  print(json.dumps({
      "steps": args.steps, "frames": r["frames"],
      "eer": r["eer"], "mindcf": r["mindcf"], "wall_s": wall,
      "features_s": r["features_s"], "train_s": r["train_s"],
      "loss_first50": float(losses[:50].mean()),
      "loss_last50": float(losses[-50:].mean()),
      "fp32": chip_smoke.xvector_apart(np, f32, f64),
      "layers_fp64": layers_fp64}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
