"""Held-out ELBO terms of phase 13's semi-supervised classes along their
training: each class of ``chip_smoke.semi_models`` trains as the phase
trains it (``fit`` on ``create_dataset(label_percent=0.1,
oversample_ratio=...)`` batches, the phase's batch size and networks, TF32
off), at each learning rate and data order (``create_dataset``'s `seed`;
the phase's is 1) asked for, and the terms of the phase's held-out batch
are read every `--k` steps.

  python3 tools/semi_trajectory.py [--classes MultitaskVAE ...]
      [--lrs 1e-3 1e-4] [--seeds 1 2 3] [--steps 200] [--k 20]
      [--device cuda] [--out chiprun_out/semi_trajectory.jsonl]

One JSON line a run, on standard output and appended to `--out`: the
class, learning rate, seed, the updates skipped, the labels head's mean
log-likelihood of the 256 held-out images before and after training (the
phase's second check), and the rows (step, {term: mean}) with the loss as
the phase's ``eval_fn`` computes it.  Then a summary line a run: the loss
at step 0, the largest after it, the last, and the largest KL term.
"""
import argparse
import json
import os
import sys
import time


def run(torch, np, cs, name, factory, bs, dname, share, lr, seed, args,
        data, held):
  """One class trained at one learning rate and data order: its JSON
  record."""
  from odin_tpu_torch.training import Noise

  dev = torch.device(args.device)
  hx, hy = held[dname]
  batch = tuple(torch.as_tensor(b).to(dev)
                for b in cs.semi_batch(np, hx, hy, bs, share))
  vae = factory().build(seed=cs.SEED, device=str(dev))

  @torch.no_grad()
  def terms(state):
    llk, kl, _ = vae.elbo_components(
        state.params, batch, Noise(torch.Generator(dev).manual_seed(0)),
        state.step, mutables=dict(state.mutables))
    out = {k: float(v.mean()) for k, v in {**llk, **kl}.items()}
    out["loss"] = -float(vae.elbo(llk, kl).mean())
    return out

  @torch.no_grad()
  def labels_llk():
    return float(vae.predict_labels(hx).log_prob(
        torch.as_tensor(hy).to(dev)).mean())

  rows = [(0, terms(vae.state))]
  llk0 = labels_llk()
  train = data[dname].create_dataset(
      "train", batch_size=bs, epochs=-1, prefetch=2,
      label_percent=cs.SEMI_LABELLED, oversample_ratio=share, seed=seed,
      to_device=dev)
  t0 = time.perf_counter()
  vae.fit(train, max_iter=args.steps, steps_per_call=args.k,
          learning_rate=lr, logging_interval=0, verbose=False,
          callbacks=[lambda tr, st, m: rows.append((int(st.step),
                                                    terms(st)))])
  return dict(cls=name, lr=lr, seed=seed, device=args.device,
              seconds=time.perf_counter() - t0,
              skipped=int(vae.state.skipped_updates),
              labels_llk=[llk0, labels_llk()], rows=rows)


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(prog="tools/semi_trajectory.py")
  ap.add_argument("--classes", nargs="+", default=["MultitaskVAE"])
  ap.add_argument("--lrs", nargs="+", type=float, default=[1e-3])
  ap.add_argument("--seeds", nargs="+", type=int, default=[1])
  ap.add_argument("--steps", type=int, default=200)
  ap.add_argument("--k", type=int, default=20)
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)

  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, repo)
  import numpy as np
  import torch

  import chip_smoke as cs
  from odin_tpu_torch.fuel import dSprites, get_dataset

  if args.device.startswith("cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
  data = {"dsprites": get_dataset("dsprites"),
          "position": cs.position_dsprites(np)}
  held = {"dsprites": dSprites(n_samples=cs.SEMI_HELD, seed=1).numpy("valid"),
          "position": cs.position_dsprites(np, n_samples=cs.SEMI_HELD,
                                           seed=1).numpy("valid")}
  models = {m[0]: m[1:] for m in cs.semi_models()}
  summary = []
  for name in args.classes:
    for lr in args.lrs:
      for seed in args.seeds:
        rec = run(torch, np, cs, name, *models[name], lr, seed, args, data,
                  held)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
          os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                      exist_ok=True)
          with open(args.out, "a") as f:
            f.write(line + "\n")
        loss = [t["loss"] for _, t in rec["rows"]]
        kl = max(v for _, t in rec["rows"] for k, v in t.items()
                 if k.startswith("kl"))
        summary.append(f"{name} lr {lr:g} seed {seed}: loss {loss[0]:.6g} "
                       f"at step 0, at most {max(loss[1:]):.6g} after it, "
                       f"{loss[-1]:.6g} at step {rec['rows'][-1][0]}; KL "
                       f"term at most {kl:.6g}; labels llk "
                       f"{rec['labels_llk'][0]:.6g} -> "
                       f"{rec['labels_llk'][1]:.6g}; skipped "
                       f"{rec['skipped']}")
  print("\n".join(summary), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
