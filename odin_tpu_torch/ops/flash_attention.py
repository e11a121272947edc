"""K2: flash attention, a hand-written CUDA kernel, and its users' entry points.

PyTorch port of ``odin_tpu/ops/pallas_attention.py``.  ``flash_attention``
computes ``softmax(Q K^T * sm_scale) V`` over (B, H, T, D) tensors of
float32, bfloat16 or float16, at any head dim.  On a CUDA tensor its forward
launches a kernel that replaces ``_flash_kernel``
(``pallas_attention.py:35-90``) and raises if the launch fails; there is no
fallback.  float32 takes ``csrc/flash_attention.cu`` (fp32 FMAs), bfloat16
and float16 take ``csrc/flash_attention_mma.cu`` (tensor cores).  A launch
covers head dims up to the kernel's width (128 and 256); above it the
forward launches once per chunk of that many columns of V and O, and each
launch computes the scores over the whole head dim.  On a CPU tensor it runs
``flash_attention_reference``, the plain PyTorch version of the kernels'
function.  The forward is the operator ``torch.ops.odin_tpu_torch.
flash_attention``, which this module registers (CUDA: the kernels; CPU:
the plain version), so that ``torch.export`` keeps it in an exported
program as one node; a process that loads such a program imports this
module first.  As in JAX, the backward, registered with the operator,
recomputes plain attention (``reference_attention``) and takes its
gradients, so the forward saves only q, k and v.  The kernels' bounds on
the card and their designs are noted in the CUDA sources.

``flash_attention_fn`` is the drop-in attention function of
``networks.attention.MultiHeadAttention(flash=True)`` over (B, T, H, D);
``dot_product_attention`` is the plain attention it takes when a bias, a
mask or dropout is asked for, the port of flax's function of that name.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from odin_tpu_torch import _build
from odin_tpu_torch.ops.logmel import on_device, raw_stream

__all__ = ["flash_attention", "flash_attention_fn", "flash_attention_reference",
           "reference_attention", "dot_product_attention"]

NEG_INF = -1e30  # JAX's masking value (`_reference_attention`, `Attention`)
# per dtype: the kernel's source, its dtype code, and the widest head dim one
# launch covers (kMaxDim, which `_library` checks)
_KERNELS = {torch.float32: ("flash_attention", 0, 128),
            torch.bfloat16: ("flash_attention_mma", 1, 256),
            torch.float16: ("flash_attention_mma", 2, 256)}


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
  """Top-left aligned: query i sees keys j <= i."""
  return (torch.arange(tq, device=device)[:, None] >=
          torch.arange(tk, device=device)[None, :])


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, sm_scale: float,
                              causal: bool) -> torch.Tensor:
  """Plain PyTorch K2: the scores, the softmax and the product with V in
  fp32 from inputs of either dtype; the output in q's dtype.  A row with no
  valid key gives 0."""
  qf, kf, vf = q.float(), k.float(), v.float()
  s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
  if causal:
    s = s.masked_fill(~_causal_mask(q.shape[-2], k.shape[-2], q.device),
                      -math.inf)
  m = s.amax(dim=-1, keepdim=True) if s.shape[-1] else s.new_zeros(
      s.shape[:-1] + (1,))
  m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
  p = torch.exp(s - m)
  l = p.sum(dim=-1, keepdim=True)
  o = torch.matmul(p, vf)
  o = torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros_like(o))
  return o.to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float, causal: bool) -> torch.Tensor:
  """JAX's ``_reference_attention`` (``pallas_attention.py:152-159``): the
  scores in the input dtype, then fp32; the probabilities cast to q's dtype
  before the product with V.  The backward of ``flash_attention``."""
  s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
  if causal:
    s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s,
                    torch.full_like(s, NEG_INF))
  p = torch.softmax(s, dim=-1)
  return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def _library(name: str, width: int) -> ctypes.CDLL:
  lib = _build.load(name)
  fn = getattr(lib, f"odin_{name}")
  if fn.argtypes is None:
    max_dim = getattr(lib, f"odin_{name}_max_dim")
    max_dim.restype = ctypes.c_int
    if max_dim() != width:
      raise RuntimeError(f"csrc/{name}.cu and ops/flash_attention.py "
                         "disagree on the widest head dim of a launch")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def _check(q, k, v):
  if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
    raise ValueError("flash_attention takes (B, H, T, D) tensors, got "
                     f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
  if k.shape != v.shape or q.shape[:2] != k.shape[:2] or \
      q.shape[3] != k.shape[3]:
    raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                     f"{tuple(v.shape)} do not fit (B, H, Tq, D), "
                     "(B, H, Tk, D), (B, H, Tk, D)")
  if not q.dtype == k.dtype == v.dtype or q.dtype not in _KERNELS:
    raise TypeError("flash_attention takes float32, bfloat16 or float16 q, "
                    f"k and v of one dtype, got {q.dtype}, {k.dtype}, "
                    f"{v.dtype}")
  if not q.device == k.device == v.device or \
      q.device.type not in ("cpu", "cuda"):
    raise ValueError("q, k and v must lie on one 'cpu' or 'cuda' device, got "
                     f"{q.device}, {k.device}, {v.device}")


# -- the operator ------------------------------------------------------------
_LIB = torch.library.Library("odin_tpu_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, float sm_scale, "
            "bool causal) -> Tensor")


def _forward_cuda(q, k, v, sm_scale, causal):
  """The operator on the card: ceil(D / width) launches of the dtype's
  kernel, counted in ``flash_attention.launches`` (and ``mma_launches``).
  The kernels read q, k and v by raw pointer, so their shapes, dtypes and
  device are checked here too, where a program calls the operator."""
  _check(q, k, v)
  B, H, Tq, D = q.shape
  Tk = k.shape[2]
  q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
  out = torch.empty_like(q)
  if out.numel() == 0:
    return out
  name, code, width = _KERNELS[q.dtype]
  fn = getattr(_library(name, width), f"odin_{name}")
  stream = raw_stream(q.device)
  with on_device(q.device):
    for col0 in range(0, D, width):
      err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B * H, Tq, Tk, D, col0, sm_scale, int(causal), code, stream)
      if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA "
                           f"error {err}")
      flash_attention.launches += 1
      if name == "flash_attention_mma":
        flash_attention.mma_launches += 1
  return out


def _forward_cpu(q, k, v, sm_scale, causal):
  """The operator on the CPU: the plain version."""
  return flash_attention_reference(q, k, v, sm_scale, causal)


def _forward_fake(q, k, v, sm_scale, causal):
  return q.new_empty(q.shape)


def _setup(ctx, inputs, output):
  q, k, v, sm_scale, causal = inputs
  ctx.save_for_backward(q, k, v)
  ctx.sm_scale, ctx.causal = sm_scale, causal


def _backward(ctx, g):
  """JAX's ``_bwd``: the gradients of plain attention, recomputed."""
  q, k, v = ctx.saved_tensors
  with torch.enable_grad():
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = reference_attention(q, k, v, ctx.sm_scale, ctx.causal)
    gq, gk, gv = torch.autograd.grad(out, (q, k, v), g)
  return gq, gk, gv, None, None


_LIB.impl("flash_attention", _forward_cuda, "CUDA")
_LIB.impl("flash_attention", _forward_cpu, "CPU")
torch.library.register_fake("odin_tpu_torch::flash_attention", _forward_fake,
                            lib=_LIB)
torch.library.register_autograd("odin_tpu_torch::flash_attention", _backward,
                                setup_context=_setup, lib=_LIB)
_OP = torch.ops.odin_tpu_torch.flash_attention.default


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
  """Tiled online-softmax attention over (B, H, T, D) tensors of float32,
  bfloat16 or float16, any head dim; Tq and Tk may differ; the output has
  q's dtype.  ``causal`` masks key j from query i unless i >= j.
  ``sm_scale`` defaults to 1/sqrt(D).  On the card a call launches
  ceil(D / width) kernels, width 128 for float32 and 256 for 16-bit
  inputs."""
  _check(q, k, v)
  if sm_scale is None:
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
  return _OP(q, k, v, float(sm_scale), bool(causal))


# kernel launches: all of them, and those of the tensor-core kernel
flash_attention.launches = 0
flash_attention.mma_launches = 0


def dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          broadcast_dropout: bool = True,
                          dropout_rng: Optional[torch.Generator] = None,
                          dropout_rate: float = 0.0,
                          deterministic: bool = False,
                          dropout_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
  """flax's ``dot_product_attention`` over (..., T, H, D): the query scaled
  by 1/sqrt(D), the bias added to the (..., H, Tq, Tk) scores, masked
  scores set to the dtype's lowest value, softmax over the keys.

  Dropout, where ``dropout_rate > 0`` and not ``deterministic``: each weight
  is kept with probability ``1 - dropout_rate`` and scaled by
  ``1 / (1 - dropout_rate)``.  The keep mask is ``dropout_mask`` if given
  (any shape that broadcasts to the weights'), else drawn from
  ``dropout_rng``, a ``torch.Generator`` on the weights' device, in flax's
  shape: (1, ..., 1, Tq, Tk) with ``broadcast_dropout`` (one mask for every
  batch entry and head), else the weights' own."""
  dtype = torch.promote_types(torch.promote_types(query.dtype, key.dtype),
                              value.dtype)
  query, key, value = query.to(dtype), key.to(dtype), value.to(dtype)
  query = query / math.sqrt(query.shape[-1])
  w = torch.einsum("...qhd,...khd->...hqk", query, key)
  if bias is not None:
    w = w + bias
  if mask is not None:
    w = torch.where(mask.bool(), w,
                    torch.tensor(torch.finfo(w.dtype).min, dtype=w.dtype,
                                 device=w.device))
  w = torch.softmax(w, dim=-1).to(dtype)
  if dropout_rate > 0.0 and not deterministic:
    keep_prob = 1.0 - dropout_rate
    if dropout_mask is None:
      if dropout_rng is None:
        raise ValueError("attention dropout needs dropout_rng (a "
                         "torch.Generator) or dropout_mask")
      shape = ((1,) * (key.ndim - 2) + tuple(w.shape[-2:])
               if broadcast_dropout else tuple(w.shape))
      dropout_mask = torch.rand(shape, generator=dropout_rng,
                                device=w.device) < keep_prob
    w = w * (dropout_mask.to(dtype) /
             torch.tensor(keep_prob, dtype=dtype, device=w.device))
  return torch.einsum("...hqk,...khd->...qhd", w, value)


def flash_attention_fn(query, key, value, bias=None, mask=None,
                       broadcast_dropout=True, dropout_rng=None,
                       dropout_rate=0.0, deterministic=False,
                       dropout_mask=None, **_):
  """Drop-in attention function of ``MultiHeadAttention(flash=True)`` on
  (B, T, H, D) tensors.  With a bias, a mask or dropout it computes the
  plain attention (those need the explicit score matrix), as the JAX
  function does; ``dropout_rng`` is a ``torch.Generator`` and
  ``dropout_mask`` an optional keep mask (``dot_product_attention``).
  flax's other keyword arguments (``dtype``, ``precision``, ...) are taken
  and ignored, as on JAX's flash path."""
  if bias is not None or mask is not None or (dropout_rate > 0.0 and
                                              not deterministic):
    return dot_product_attention(
        query, key, value, bias=bias, mask=mask,
        broadcast_dropout=broadcast_dropout, dropout_rng=dropout_rng,
        dropout_rate=dropout_rate, deterministic=deterministic,
        dropout_mask=dropout_mask)
  out = flash_attention(query.transpose(1, 2), key.transpose(1, 2),
                        value.transpose(1, 2))
  return out.transpose(1, 2)
