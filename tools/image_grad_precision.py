"""How far the float32 gradients of phase 19's recipes lie from float64,
on the card and on the CPU: ``BetaVAE`` on ``mnist_networks``, on
``cifar10_networks`` and on ``chip_smoke.pixelcnn_networks`` ('pixelcnn':
the 10-component mixture head) at their fresh weights (``build(seed=0)``), one
held-out batch of phase 19's renders (YDisentanglement at 28 x 28;
Shapes3D downsampled to 32 x 32 x 3) and one set of noise drawn on the
CPU.  The gradient of the training loss is taken in float64 on the CPU
(the reference), in float32 on the CPU, and in float32 on the card with
cuDNN's default algorithms, with ``cudnn.deterministic``, and with cuDNN
off (ATen's own convolutions); TF32 off throughout.

  python3 tools/image_grad_precision.py [--rows 16 64]
      [--nets mnist cifar10 pixelcnn]

One line a network, batch size and route: the largest over tensors of
max |g - g64| / max |g64| (the tensor named), and the same for the card
against the CPU in float32, the check phase 19 makes.
"""
import argparse
import os
import sys


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(prog="tools/image_grad_precision.py")
  ap.add_argument("--rows", nargs="+", type=int, default=[16, 64])
  ap.add_argument("--nets", nargs="+",
                  default=["mnist", "cifar10", "pixelcnn"])
  args = ap.parse_args(argv)
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, repo)
  import numpy as np
  import torch

  import chip_smoke as cs
  from odin_tpu_torch.bay import vi
  from odin_tpu_torch.fuel import YDisentanglement
  from odin_tpu_torch.networks import get_networks
  from odin_tpu_torch.training import Noise

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
  # without a card only the CPU's float32 is held against float64
  if torch.cuda.is_available():
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
  n = max(args.rows)
  images = {
      "mnist": YDisentanglement(n_samples=n, image_size=28, seed=3)._load(
          "valid")[0],
      "cifar10": cs._shapes3d_renders(np, n, 3, 32)[0].astype(
          np.float32) / 255.0}
  images["pixelcnn"] = images["cifar10"]
  networks = lambda name: (cs.pixelcnn_networks(torch) if name == "pixelcnn"
                           else get_networks(name))

  def grads(vae, params, batch, drawn, device, dtype):
    leaves = {p: {k: v.detach().to(device, dtype).clone().requires_grad_()
                  for k, v in part.items()} for p, part in params.items()}
    step = torch.tensor(0, dtype=torch.int32, device=device)
    loss, _ = vae._vae_loss(leaves, batch.to(device, dtype), Noise(
        eps=[t.to(device, dtype) for t in drawn]), step, {})
    names = [(p, k) for p, part in leaves.items() for k in part]
    got = torch.autograd.grad(loss, [leaves[p][k] for p, k in names])
    return {"/".join(nm): g.detach().to(cpu, torch.float64)
            for nm, g in zip(names, got)}

  def worst(got, want):
    return max((float((got[k] - w).abs().max()) /
                max(float(w.abs().max()), 1e-300), k)
               for k, w in want.items())

  for name in args.nets:
    make = lambda d: vi.BetaVAE(beta=1.0, **networks(name)).build(
        seed=cs.SEED, device=d)
    ref = make(cpu)
    card = make(cuda) if torch.cuda.is_available() else None
    for rows in args.rows:
      batch = torch.from_numpy(np.ascontiguousarray(images[name][:rows]))
      noise = Noise(torch.Generator().manual_seed(cs.SEED))
      with torch.no_grad():
        ref.elbo_components(ref.state.params, batch, noise,
                            torch.tensor(0, dtype=torch.int32))
      drawn = noise.drawn
      params = ref.state.params
      g64 = grads(ref, params, batch, drawn, cpu, torch.float64)
      g32 = grads(ref, params, batch, drawn, cpu, torch.float32)
      out = {"cpu fp32": g32}
      for route, flags in (() if card is None else (
          ("card cudnn default", {}),
          ("card cudnn deterministic", {"deterministic": True}),
          ("card cudnn off", {"enabled": False}))):
        saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
        for k, v in flags.items():
          setattr(torch.backends.cudnn, k, v)
        try:
          out[route] = grads(card, params, batch, drawn, cuda, torch.float32)
        finally:
          for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)
      for route, g in out.items():
        err, tensor = worst(g, g64)
        line = (f"{name} rows {rows} {route}: against float64 {err:.3e} "
                f"({tensor})")
        if route != "cpu fp32":
          e2, t2 = worst(g, g32)
          line += f"; against the CPU's float32 {e2:.3e} ({t2})"
        print(line, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
