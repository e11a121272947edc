"""The JAX package's and the port's semi-supervised VAE stepped side by
side on the CPU along ``chip_smoke.py`` phase 13's training run: the
full-width dSprites networks (zdim 10) with the 'factors' labels head,
the same initial weights (the port's ``build(seed=--seed)``, 0 as in the
phase, carried to JAX with ``to_jax_params``), the same (x, y, mask)
batches of ``create_dataset(label_percent=0.1, oversample_ratio=0.5,
seed=--order)`` at batch 64 (the phase's order is 1), and JAX's draws
replayed into the port at every step
(``tests/torch_zoo_common.jit_with_draws``).  The two runs are not
re-synchronised: each carries its own state for all the steps.

  python3 tests/semi_jax_trajectory.py [--classes MultitaskVAE SkiptaskVAE]
      [--lr 1e-3] [--steps 200] [--seed 0] [--order 1] [--out FILE]

One line a step and class: the step, both packages' loss and KL term of
that step's batch, and their relative difference; then one summary line a
class: the first step whose loss differs by more than 1e-3, the step of
each package's largest loss after step 0 and that loss.  It imports JAX,
so it runs on the CPU only (a few seconds a step and class on two cores).
"""
import argparse
import json
import os
import sys


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(prog="tests/semi_jax_trajectory.py")
  ap.add_argument("--classes", nargs="+",
                  default=["MultitaskVAE", "SkiptaskVAE"])
  ap.add_argument("--lr", type=float, default=1e-3)
  ap.add_argument("--steps", type=int, default=200)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--order", type=int, default=1)
  ap.add_argument("--out", default=None)
  args = ap.parse_args(argv)

  os.environ["JAX_PLATFORMS"] = "cpu"
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path[:0] = [repo, os.path.join(repo, "tests")]
  import jax
  jax.config.update("jax_platforms", "cpu")
  import numpy as np
  import torch

  import odin_tpu.bay.vi as jax_vi
  import odin_tpu_torch.bay.vi as port_vi
  from odin_tpu.networks import get_networks as jax_networks
  from odin_tpu_torch.fuel import get_dataset
  from odin_tpu_torch.networks import get_networks
  from torch_zoo_common import jax_state_of, jit_with_draws, to_torch

  data = get_dataset("dsprites").create_dataset(
      "train", batch_size=64, epochs=-1, prefetch=0, label_percent=0.1,
      oversample_ratio=0.5, seed=args.order)
  it = iter(data)
  batches = [tuple(np.asarray(b) for b in next(it))
             for _ in range(args.steps)]
  out = open(args.out, "a") if args.out else None
  summary = []
  for cls in args.classes:
    nets = dict(zdim=10, is_semi_supervised=True)
    vae = getattr(port_vi, cls)(**get_networks("dsprites", **nets)).build(
        seed=args.seed, device="cpu")
    jvae = getattr(jax_vi, cls)(**jax_networks("dsprites", **nets))
    jvae.input_shape = vae.input_shape
    jvae.state = jax_state_of(vae, args.seed)
    jstep = jit_with_draws(jvae.make_step_fn(learning_rate=args.lr,
                                             jit=False))
    step = vae.make_step_fn(learning_rate=args.lr)
    js, s = jvae.state, vae.state
    rows = []
    for i, batch in enumerate(batches):
      (js, jm), draws = jstep(js, batch)
      s, m = step(s, tuple(torch.from_numpy(b) for b in batch),
                  eps=to_torch(draws))
      jm = {k: float(v) for k, v in jax.device_get(jm).items()}
      m = {k: float(v) for k, v in m.items()}
      kl = next(k for k in sorted(jm) if k.startswith("kl"))
      row = dict(cls=cls, lr=args.lr, seed=args.seed, order=args.order,
                 step=i, jax_loss=jm["loss"],
                 port_loss=m["loss"], jax_kl=jm[kl], port_kl=m[kl],
                 rel=abs(m["loss"] - jm["loss"]) / max(abs(jm["loss"]),
                                                       1e-30))
      rows.append(row)
      line = json.dumps(row)
      print(line, flush=True)
      if out:
        out.write(line + "\n")
        out.flush()
    apart = next((r["step"] for r in rows if r["rel"] > 1e-3), None)
    jpeak = max(rows[1:], key=lambda r: r["jax_loss"])
    ppeak = max(rows[1:], key=lambda r: r["port_loss"])
    summary.append(
        f"{cls} lr {args.lr:g} seed {args.seed} order {args.order}: losses "
        f"first more than 1e-3 apart at step "
        f"{apart}; JAX's largest loss after step 0 {jpeak['jax_loss']:.6g} "
        f"at step {jpeak['step']} (KL {jpeak['jax_kl']:.6g}); the port's "
        f"{ppeak['port_loss']:.6g} at step {ppeak['step']} (KL "
        f"{ppeak['port_kl']:.6g}); last {rows[-1]['jax_loss']:.6g} / "
        f"{rows[-1]['port_loss']:.6g}; skipped "
        f"{int(np.asarray(js.skipped_updates))} / {int(s.skipped_updates)}")
  print("\n".join(summary), flush=True)
  if out:
    out.close()
  return 0


if __name__ == "__main__":
  sys.exit(main())
