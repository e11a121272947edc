"""Serving of the port (PyTorch port of ``odin_tpu/serving.py``): a model's
inference functions exported with ``torch.export`` to ``.pt2`` programs
that load and run in a process holding only torch, with one symbolic batch
axis, and weight-only int8 quantization of a module's parameters.

``encode_mean``, ``decode_mean`` and ``reconstruct`` run a VAE eagerly on
its device; ``export_vae`` writes the same three functions into a
``ServingBundle`` directory (``<name>.pt2`` and ``manifest.json``).  A
function that reaches one of the port's hand-written kernels (K1 behind
``ops/logmel.py``, K2 behind ``ops/flash_attention.py``) exports with the
kernel's operator (``torch.ops.odin_tpu_torch.logmel``,
``.flash_attention``) as a node of the program: loaded on the card, the
program launches the kernel; on the CPU it runs the plain version.  Such a
program needs the operators registered where it loads: ``load_fn`` and
``ServingBundle`` import the modules that register them, and a process
that calls ``torch.export.load`` itself imports
``odin_tpu_torch.ops.logmel`` or ``odin_tpu_torch.ops.flash_attention``
first.  Exported programs hold the model's weights (and a kernel's
tables), on the device they were exported on; ``load_fn`` and a bundle
move them onto the card unless asked for the CPU.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from odin_tpu_torch.device import resolve_device

__all__ = ["export_fn", "load_fn", "export_vae", "ServingBundle",
           "quantize_params", "dequantize_params"]

_Q_KEY = "__int8__"


@torch.inference_mode()
def encode_mean(vae, x) -> torch.Tensor:
  """x (B, H, W, C) -> E[z|x] (B, zdim)."""
  return vae.encode(x).mean()


@torch.inference_mode()
def decode_mean(vae, z) -> torch.Tensor:
  """z (B, zdim) -> E[x|z] (B, H, W, C)."""
  return vae.decode(z).mean()


@torch.inference_mode()
def reconstruct(vae, x) -> torch.Tensor:
  """x -> E[x|E[z|x]]."""
  return vae.reconstruct(x)[1].mean()


# -- int8 weights -------------------------------------------------------------
def _channel_axis(module: nn.Module, name: str, p: torch.Tensor) -> int:
  """The output-channel axis of parameter `name` of `module`: 1 for a
  transposed convolution's weight ((in, out, k...)), the last for a
  parameter kept in flax's layout, else 0 (``Linear``/``Dense`` (out,
  in), ``Conv`` (out, in, k...), the stacked gates of a recurrent cell,
  vectors)."""
  from odin_tpu_torch import weights
  from odin_tpu_torch.networks.base import ConvTranspose
  if getattr(module, "flax_raw", False) or weights._is_raw(name):
    return p.ndim - 1
  if name == "weight":
    kind = getattr(module, "flax_kind", None)
    if isinstance(module, (ConvTranspose, nn.ConvTranspose1d,
                           nn.ConvTranspose2d, nn.ConvTranspose3d)) or (
        isinstance(kind, type) and issubclass(kind, ConvTranspose)):
      return 1
  return 0


def channel_axes(module: nn.Module) -> Dict[str, int]:
  """{parameter name: its output-channel axis} of every parameter of
  `module`, chosen from the layer that holds it."""
  out = {}
  for mname, m in module.named_modules():
    for pname, p in m.named_parameters(recurse=False):
      out[f"{mname}.{pname}" if mname else pname] = _channel_axis(m, pname, p)
  return out


def quantize_params(module: nn.Module, min_size: int = 1024,
                    params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, Any]:
  """Weight-only symmetric int8 quantization of a module's parameters (or
  of `params`, a {name: tensor} dict of the module's names, such as a
  VAE's ``state.params['vae']``).

  Each floating parameter of at least `min_size` elements becomes
  ``{'__int8__': int8 codes, 'scale': float32 scales}``, one scale per
  output channel on the axis the layer gives it (``channel_axes``: axis 0
  of a ``Dense``/``Linear`` (out, in) or ``Conv`` (out, in, kh, kw), axis
  1 of a ``ConvTranspose`` (in, out, kh, kw), the last of a parameter in
  flax's layout).  The scale is ``max|w| / 127`` over the other axes (1
  where that is 0), the codes ``round(w / scale)`` (half to even) clipped
  to ±127, all in float32, as the JAX package computes them: its codes,
  carried across by ``weights.from_jax_quantized``, equal these bit for
  bit.  Smaller parameters (biases, norm scales) stay as they are."""
  axes = channel_axes(module)
  if params is None:
    params = dict(module.named_parameters())
  out: Dict[str, Any] = {}
  for name, w in params.items():
    if w.is_floating_point() and w.numel() >= min_size and w.ndim >= 1:
      axis = axes[name]
      w = w.detach().float()
      others = tuple(i for i in range(w.ndim) if i != axis)
      scale = (torch.amax(torch.abs(w), dim=others, keepdim=True) if others
               else torch.abs(w)) / 127.0
      scale = torch.where(scale == 0, torch.ones_like(scale), scale)
      codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
      out[name] = {_Q_KEY: codes, "scale": scale}
    else:
      out[name] = w
  return out


def _is_q(leaf) -> bool:
  return isinstance(leaf, dict) and _Q_KEY in leaf


def dequantize_params(qparams: Dict[str, Any]) -> Dict[str, torch.Tensor]:
  """The inverse of ``quantize_params``: codes times scales in float32;
  a parameter left unquantized is returned as it is."""
  return {k: v[_Q_KEY].float() * v["scale"] if _is_q(v) else v
          for k, v in qparams.items()}


# -- export -------------------------------------------------------------------
class _Fn(nn.Module):
  """`fn` as a module, for ``torch.export``."""

  def __init__(self, fn: Callable):
    super().__init__()
    self.fn = fn

  def forward(self, *args):
    return self.fn(*args)


def _at_least_two(x):
  """An example of batch 1 repeated to batch 2: at 1 the exporter would
  fix the symbolic batch to 1."""
  if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == 1:
    return torch.cat([x, x])
  return x


def export_fn(fn: Callable, example_args: Sequence,
              batch_polymorphic: bool = True,
              poly_args: Sequence[int] = (0,)) -> bytes:
  """``fn(*example_args)`` exported (non-strict ``torch.export``) to the
  bytes of a ``.pt2`` program.

  With `batch_polymorphic`, the leading axis of the tensor arguments listed
  in `poly_args` (the first by default, the data batch) is one symbolic
  dim ``b`` >= 1, so one program serves every batch size; the other
  arguments keep their shapes.  An example batch of 1 is traced at batch 2
  (at 1 the exporter would fix the dim), and the program is then checked
  at the example's own batch.  A function that reaches K1 or K2 exports
  with the kernel's operator as a node, at a symbolic batch or a static
  one, on the CPU or on the card; its bases go into the program as
  constants."""
  module = _Fn(fn)
  args = tuple(example_args)
  poly = set(poly_args) if batch_polymorphic else set()
  if poly:
    batch = torch.export.Dim("b", min=1)
    traced = tuple(_at_least_two(a) if i in poly else a
                   for i, a in enumerate(args))
    dynamic = tuple({0: batch} if i in poly and isinstance(a, torch.Tensor)
                    and a.ndim >= 1 else None for i, a in enumerate(args))
    ep = torch.export.export(module, traced, dynamic_shapes=(dynamic,),
                             strict=False)
  else:
    ep = torch.export.export(module, args, strict=False)
  if poly:
    with torch.no_grad():
      got, want = ep.module()(*args), module(*args)
    shapes = [tuple(t.shape) for t in torch.utils._pytree.tree_leaves(got)]
    expected = [tuple(t.shape) for t in torch.utils._pytree.tree_leaves(want)]
    if shapes != expected:
      raise AssertionError(f"the exported program gave shapes {shapes} at "
                           f"the example's batch, the function {expected}")
  buf = io.BytesIO()
  torch.export.save(ep, buf)
  return buf.getvalue()


class _Loaded:
  """A loaded program: moves its tensor arguments (or arrays) onto the
  program's device and calls it."""

  def __init__(self, program, device: torch.device):
    self.program = program
    self.device = device

  def __call__(self, *args):
    return self.program(*(torch.as_tensor(a).to(self.device) for a in args))


def _load(f, device) -> _Loaded:
  device = resolve_device("cuda" if device is None else device)
  # the kernels' operators, which a program over K1 or K2 calls, must be
  # registered before it loads
  import odin_tpu_torch.ops.flash_attention  # noqa: F401
  import odin_tpu_torch.ops.logmel  # noqa: F401
  from torch.export.passes import move_to_device_pass
  ep = move_to_device_pass(torch.export.load(f), device)
  return _Loaded(ep.module(), device)


def load_fn(blob: bytes, device=None) -> Callable:
  """The program of ``export_fn``'s bytes as a callable on `device` (the
  card unless 'cpu'), its constants moved there; a program over K1 or K2
  then dispatches the kernel's operator on that device."""
  return _load(io.BytesIO(blob), device)


class ServingBundle:
  """A directory of exported functions (``<name>.pt2``) and their
  ``manifest.json`` (``bytes``, ``has_weights``: the program holds int8
  weights, and the caller's meta keys), for serving without model code.
  ``bundle[name]`` loads a program onto `device`: the card unless
  'cpu'."""

  def __init__(self, path: str, device=None):
    self.path = path
    self.device = device
    os.makedirs(path, exist_ok=True)
    self._fns: Dict[str, Callable] = {}
    self._manifest_path = os.path.join(path, "manifest.json")
    self.manifest: Dict[str, Any] = {}
    if os.path.exists(self._manifest_path):
      with open(self._manifest_path) as f:
        self.manifest = json.load(f)

  def add(self, name: str, fn: Callable, example_args: Sequence,
          batch_polymorphic: bool = True, **meta) -> "ServingBundle":
    """Export `fn` on `example_args` (``export_fn``) as ``<name>.pt2``."""
    blob = export_fn(fn, example_args, batch_polymorphic=batch_polymorphic)
    with open(os.path.join(self.path, f"{name}.pt2"), "wb") as f:
      f.write(blob)
    has_weights = isinstance(fn, nn.Module) and any(
        t.dtype == torch.int8 for t in fn.buffers())
    self.manifest[name] = dict(bytes=len(blob), has_weights=has_weights,
                               **meta)
    with open(self._manifest_path, "w") as f:
      json.dump(self.manifest, f, indent=1)
    return self

  def __getitem__(self, name: str) -> Callable:
    if name not in self._fns:
      self._fns[name] = _load(os.path.join(self.path, f"{name}.pt2"),
                              self.device)
    return self._fns[name]

  def names(self):
    return sorted(self.manifest)


class _Served(nn.Module):
  """One serving function of a VAE's core on fixed weights: every param and
  buffer of the core is a buffer here (int8 codes and float32 scales where
  quantized, dequantized in ``forward``), and the core is held outside the
  module tree, so that its own tensors (the build's copies, not the
  trained state) cannot reach the program."""

  def __init__(self, core: nn.Module, method: str,
               tensors: Dict[str, Any]):
    super().__init__()
    object.__setattr__(self, "core", core)
    self.method = method
    self.names = list(tensors)
    for i, name in enumerate(self.names):
      t = tensors[name]
      if _is_q(t):
        self.register_buffer(f"q{i}", t[_Q_KEY].clone())
        self.register_buffer(f"s{i}", t["scale"].clone())
      else:
        self.register_buffer(f"w{i}", t.detach().clone())

  def _tensors(self) -> Dict[str, torch.Tensor]:
    out = {}
    for i, name in enumerate(self.names):
      if hasattr(self, f"q{i}"):
        out[name] = getattr(self, f"q{i}").float() * getattr(self, f"s{i}")
      else:
        out[name] = getattr(self, f"w{i}")
    return out

  def forward(self, x):
    return _serve(self.core, self.method, self._tensors(), x)


def _serve(core: nn.Module, method: str, tensors: Dict[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
  """The mean of the core's distribution for `method` ('encode', 'decode'
  or 'reconstruct': decode E[z|x]) on `tensors`, which must name every
  param and buffer of the core (``strict``: none is read from the core)."""
  run = lambda m, arg: torch.func.functional_call(
      core, tensors, (arg,), {"method": m}, strict=True)
  if method == "reconstruct":
    return run("decode", run("encode", x).mean()).mean()
  return run(method, x).mean()


def export_vae(vae, path: str, example_batch: int = 1,
               quantize: bool = False, min_size: int = 1024,
               device=None) -> ServingBundle:
  """Export a built VAE's serving functions into a ``ServingBundle`` at
  `path`: ``encode_mean`` (x -> E[z|x]), ``decode_mean`` (z -> E[x|z])
  and ``reconstruct`` (x -> E[x|E[z|x]]), each batch-polymorphic, traced
  on zeros of `example_batch` rows on the model's device.

  Each program holds every weight of the model's state (its params and
  buffers, as the JAX package's bundle carries the whole tree), so
  serving needs torch alone: no ``odin_tpu_torch``, no model class.  With
  `quantize`, the params of at least `min_size` elements are held as int8
  codes and float32 per-channel scales (``quantize_params``) and
  dequantized inside the program; buffers stay as they are.  The returned
  bundle loads its programs onto `device` (the card unless 'cpu')."""
  core = vae.core
  core.eval()
  params = dict(vae._params_of()["vae"])
  mutables = dict(vae.state.mutables.get("vae", {})) if vae.state else {}
  dev = next(iter(params.values())).device
  x = torch.zeros((example_batch,) + tuple(vae.input_shape),
                  dtype=torch.float32, device=dev)
  z = torch.zeros((example_batch, vae.zdim), dtype=torch.float32,
                  device=dev)
  stored = quantize_params(core, min_size, params) if quantize else params
  bundle = ServingBundle(path, device=device)
  for name, method, arg, meta in (
      ("encode_mean", "encode", x, dict(input_shape=list(vae.input_shape),
                                        zdim=vae.zdim)),
      ("decode_mean", "decode", z, dict(zdim=vae.zdim)),
      ("reconstruct", "reconstruct", x,
       dict(input_shape=list(vae.input_shape)))):
    bundle.add(name, _Served(core, method, {**stored, **mutables}), (arg,),
               **meta)
  return bundle
