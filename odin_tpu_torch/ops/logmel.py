"""K1: fused window-DFT-power-mel-log, three hand-written CUDA kernels.

``logmel`` takes windowed frames and returns ``10·log10(max(mel power,
1e-10))``, unclipped (top-dB applies outside with the per-utterance max).
The kernels replace ``_logmel_kernel`` (``odin_tpu/ops/pallas_features.py:
32-39``); the configuration alone picks one (``kernel_route``):

* ``csrc/logmel_fft.cu``, an fp32 real FFT in shared memory, where n_fft is
  a power of two from 16 to 8192 (every config of the repo: the default is
  512);
* ``csrc/logmel_fft_mixed.cu``, a mixed-radix fp32 real FFT (passes of
  radix 16, 8, 4, 2, 3, 5 and 7), where n_fft is even, from 16 to 8192, and
  n_fft/2 has no prime factor above 7 (Whisper's 400, and 320, 480, 882,
  1200);
* ``csrc/logmel.cu``, the dense real DFT, for every other n_fft (odd, a
  prime factor of 11 or more in n_fft/2, or above 8192).

``logmel`` calls the operator ``torch.ops.odin_tpu_torch.logmel``, which
this module registers, so that ``torch.export`` keeps the call in an
exported program as one node.  Its CUDA implementation launches the chosen
kernel and raises if the launch fails; there is no fallback and no retry.
Its CPU implementation is ``logmel_reference``, the plain PyTorch version of
the same function.  The operator takes the kernels' tables (the twiddles,
the packed mel weights and their bands, or the dense DFT bases) as tensor
arguments, so that an exported program carries them and runs on the card
however it was exported; a process that loads such a program imports this
module first.  Its gradient, with respect to the frames, is the plain
version's.  Each kernel's bound on the card and its design are noted in its
CUDA source.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import TYPE_CHECKING, List, NamedTuple, Tuple

import numpy as np
import torch

from odin_tpu_torch import _build

if TYPE_CHECKING:
  from odin_tpu_torch.ops.features import FeatureConfig

__all__ = ["fft_plan", "fft_twiddles", "harmonic_frames", "kernel_route",
           "logmel", "logmel_reference", "mixed_geometry", "power_spectrum"]

# the dense kernel's constants (csrc/logmel.cu); `_library` checks them
CHUNK = 8  # kChunk: sample rows per staged chunk of the bases
MAX_FREQS = 288  # kMaxFreqs: bins per group of the bases
TILE_FRAMES = 32  # kTileFrames: frames per block
# the FFT kernel's range of n_fft, 2^4 .. 2^13 (csrc/logmel_fft.cu);
# `_fft_library` checks it
FFT_LOG2_RANGE = (4, 13)
# the mixed-radix kernel's range of n_fft and its constants
# (csrc/logmel_fft_mixed.cu); `_mixed_library` checks them
MIXED_RANGE = (16, 8192)
MIXED_THREADS = 256  # kThreads: threads a block
# the points of a group (n_fft/2 * frames) at most, unless one frame has
# more: about 96 KB of shared memory a block at n_fft 400, 2 blocks an SM
# (tools/k1_mixed_ablation.py times groups of 2048-8192 points)
MIXED_GROUP_POINTS = 4096
# the kernel's layouts of a group's points in shared memory: point i at
# float2 i, or at i ^ ((i // 16) % 16) (the bank pair swizzled within each
# run of 16)
MIXED_LAYOUTS = ("plain", "swizzled")


def power_spectrum(frames: torch.Tensor, cos_b: torch.Tensor,
                   sin_b: torch.Tensor, scale_sq: float) -> torch.Tensor:
  """The scaled power of the real DFT by matmuls: (..., frame_length) ->
  (..., n_freqs), fp32."""
  re = torch.matmul(frames, cos_b)
  im = torch.matmul(frames, sin_b)
  return (re * re + im * im) * scale_sq


def logmel_reference(frames: torch.Tensor, cos_b: torch.Tensor,
                     sin_b: torch.Tensor, mel_t: torch.Tensor,
                     scale_sq: float) -> torch.Tensor:
  """Plain PyTorch K1: (..., frame_length) -> (..., n_mels), fp32."""
  mel = torch.matmul(power_spectrum(frames, cos_b, sin_b, scale_sq), mel_t)
  return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def _odd_part(m: int) -> int:
  """m without its factors 2, 3, 5 and 7."""
  for p in (2, 3, 5, 7):
    while m % p == 0:
      m //= p
  return m


@functools.lru_cache(maxsize=None)
def kernel_route(n_fft: int) -> str:
  """The K1 kernel that takes a config: ``"fft"`` where n_fft is a power of
  two in the FFT kernel's range, ``"mixed"`` where it is another even n_fft
  in the mixed-radix kernel's range whose half has no prime factor above
  7, else ``"dense"``.  The FFT kernels pad or fold a frame of any length to
  n_fft samples, as the dense bases do, so the frame length does not enter
  the choice."""
  lo, hi = FFT_LOG2_RANGE
  n_fft = int(n_fft)
  if n_fft > 0 and n_fft & (n_fft - 1) == 0 and 2 ** lo <= n_fft <= 2 ** hi:
    return "fft"
  if (n_fft % 2 == 0 and MIXED_RANGE[0] <= n_fft <= MIXED_RANGE[1] and
      _odd_part(n_fft // 2) == 1):
    return "mixed"
  return "dense"


def harmonic_frames(n_frames: int, config: "FeatureConfig", seed: int,
                    device) -> torch.Tensor:
  """(n_frames, frame_length) windowed fp32 frames with a high dynamic
  range, for holding K1 to its plain version: 40 harmonics of an f0 drawn
  from 80-400 Hz, the h-th at amplitude h^-3 (full scale at h = 1) with a
  random phase, below Nyquist only, plus white noise at -100 dB of full
  scale.  The mel bands then span about 80 dB, where white noise puts
  about equal power in every bin, so low-energy bins show an FFT's
  rounding.  Drawn with numpy from `seed`, summed in float64 on
  `device`."""
  rs = np.random.RandomState(seed)
  length, sr = config.frame_length, config.sr
  f0 = rs.uniform(80.0, 400.0, (n_frames, 1))
  phase = rs.uniform(0.0, 2.0 * np.pi, (n_frames, 40))
  noise = rs.randn(n_frames, length) * 1e-5
  t = torch.arange(length, dtype=torch.float64, device=device)
  f0 = torch.from_numpy(f0).to(device)
  phase = torch.from_numpy(phase).to(device)
  x = torch.from_numpy(noise).to(device)
  for h in range(1, 41):
    amp = h ** -3.0 * (h * f0 < sr / 2)
    x += amp * torch.cos(2.0 * np.pi * h / sr * f0 * t + phase[:, h - 1:h])
  window = torch.from_numpy(config.window_fn).to(device)
  return (x.to(torch.float32) * window).contiguous()


def fft_plan(n_fft: int) -> List[Tuple[int, int]]:
  """The FFT kernels' passes over the M = n_fft/2-point complex FFT, as
  (ns, R): a radix-R Stockham pass after passes that span ns points.  The
  power of two in M comes first: a radix-2, 4 or 8 pass for its bits
  beyond a multiple of 4, then radix-16 passes (csrc/logmel_fft.cu,
  `first_radix`); then a pass of radix 3, 5 or 7 for each such factor of M,
  in that order (csrc/logmel_fft_mixed.cu, `make_plan`).  M = 200 is 8·5·5,
  M = 441 is 3·3·7·7."""
  m = int(n_fft) // 2
  if int(n_fft) % 2 or m < 1 or _odd_part(m) != 1:
    raise ValueError(f"n_fft {n_fft} is odd, or n_fft/2 has a prime factor "
                     "above 7")
  log2_m = (m & -m).bit_length() - 1
  radices = ([1 << (log2_m % 4)] if log2_m % 4 else []) + [16] * (log2_m // 4)
  odd = m >> log2_m
  for p in (3, 5, 7):
    while odd % p == 0:
      radices.append(p)
      odd //= p
  plan, ns = [], 1
  for radix in radices:
    plan.append((ns, radix))
    ns *= radix
  return plan


def fft_twiddle_index(n_fft: int) -> np.ndarray:
  """The k of each entry exp(-2πi·k/n_fft) of the FFT kernels' twiddle
  table, in the kernel's order: for each pass after the first
  (``fft_plan``), the twiddles exp(-2πi·r·j/(ns·R)) for j < ns and
  r = 1 .. R-1, at (R-1)·j + r-1 for the power-of-two kernel
  (``twiddle_count``, csrc/logmel_fft.cu) and at (r-1)·ns + j for the
  mixed-radix kernel (``make_plan``, csrc/logmel_fft_mixed.cu); then the
  split step's exp(-2πi·k/n_fft) for k < (M + 1) // 2, M = n_fft/2
  (n_fft/4 entries for even M)."""
  n_fft = int(n_fft)
  by_pass = "ij" if kernel_route(n_fft) == "fft" else "xy"
  parts = []
  for ns, radix in fft_plan(n_fft)[1:]:
    j, r = np.meshgrid(np.arange(ns), np.arange(1, radix), indexing=by_pass)
    parts.append((r * j * (n_fft // (radix * ns))).ravel())
  parts.append(np.arange((n_fft // 2 + 1) // 2))
  return np.concatenate(parts).astype(np.int64)


def fft_twiddles(n_fft: int) -> np.ndarray:
  """The FFT kernels' twiddle table: (K, 2) float32 (real, imaginary),
  computed in float64 and rounded once."""
  angle = -2.0 * np.pi * fft_twiddle_index(n_fft) / n_fft
  return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)


def _rounds(butterflies: int) -> int:
  return -(-butterflies // MIXED_THREADS)


def _layout(i: np.ndarray, layout: int) -> np.ndarray:
  """The float2 where the mixed-radix kernel keeps a group's point i
  (``MIXED_LAYOUTS``; csrc/logmel_fft_mixed.cu, `at`)."""
  return i ^ ((i >> 4) & 15) if layout else i


def _wavefronts(addresses: np.ndarray, active: np.ndarray) -> int:
  """Shared-memory wavefronts of warp accesses of one float2 a lane
  ((warps, 32) float2 addresses; lanes where `active` is false take no
  part): for each warp, the most distinct addresses that fall on one of the
  16 pairs of 4-byte banks, summed over the warps."""
  warp = np.broadcast_to(np.arange(addresses.shape[0])[:, None],
                         addresses.shape)[active]
  keys = np.unique(warp * (1 << 24) + addresses[active])
  per_bank = np.unique((keys >> 24) * 16 + (keys & 15), return_counts=True)
  worst = np.zeros(addresses.shape[0], np.int64)
  np.maximum.at(worst, per_bank[0] // 16, per_bank[1])
  return int(worst.sum())


def _bank_cost(n_fft: int, group: int, layout: int) -> int:
  """The wavefronts of a group's shared-memory reads and writes of points in
  a layout: each Stockham pass after the first reads its points, every pass
  writes its outputs (the first reads the staged frames), then the split
  step reads Z[k] and Z[M-k]; in the kernel's thread map, a thread takes
  butterflies idx, idx + MIXED_THREADS, ...."""
  m = n_fft // 2
  lane = np.arange(MIXED_THREADS)
  total = 0

  def cost(live, points):
    return _wavefronts(_layout(points, layout).reshape(-1, 32),
                       live.reshape(-1, 32))

  for p, (ns, radix) in enumerate(fft_plan(n_fft)):
    step = m // radix
    idx = (lane[None, :] + MIXED_THREADS *
           np.arange(_rounds(group * step))[:, None]).ravel()
    live = idx < group * step
    f, j = idx // step, idx % step
    k = j % ns
    for q in range(radix):
      if p:
        total += cost(live, f * m + j + q * step)
      total += cost(live, f * m + (j - k) * radix + k + q * ns)
  pairs = (m + 1) // 2
  idx = (lane[None, :] + MIXED_THREADS *
         np.arange(_rounds(group * pairs))[:, None]).ravel()
  live = idx < group * pairs
  f, k = idx // pairs, idx % pairs
  total += cost(live, f * m + k) + cost(live, f * m + (m - k) % m)
  return total


class MixedGeometry(NamedTuple):
  group: int  # frames a block transforms at once
  layout: int  # an index into MIXED_LAYOUTS


def _best_group(m: int, radices: List[int], points: int) -> int:
  """The group of at most `points` points that gives the most frames for
  the point slots its passes' rounds take, the largest among equals."""
  best, group = 0.0, 1
  for g in range(1, points // m + 1):
    score = g / sum(_rounds(g * m // r) * r for r in radices)
    if score >= best:
      best, group = score, g
  return group


@functools.lru_cache(maxsize=None)
def mixed_geometry(n_fft: int) -> MixedGeometry:
  """(group, layout) of the mixed-radix kernel at n_fft.

  * ``group``: the frames a block transforms at once, of at most
    MIXED_GROUP_POINTS points (or one frame).  A pass of radix R has
    group·M/R butterflies, which MIXED_THREADS threads take in rounds; the
    group is the one that gives the most frames for the point slots its
    passes' rounds take (``mixed_idle_shares``), the largest among equals.
    At n_fft 400 (M = 200 = 8·5·5) it is 19 frames: 475, 760 and 760
    butterflies in 2, 3 and 3 rounds.
  * ``layout``: where the group's points lie in shared memory
    (``MIXED_LAYOUTS``), the one whose passes and split step take the
    fewest wavefronts (``_bank_cost``), the first among equals.  No one
    layout suits every plan: a power-of-two first pass writes with a
    stride of 2-16 points, which needs the swizzle, while an odd radix
    writes with an odd stride, conflict-free as it is."""
  n_fft = int(n_fft)
  if kernel_route(n_fft) != "mixed":
    raise ValueError(f"n_fft {n_fft} does not take the mixed-radix kernel")
  m = n_fft // 2
  radices = [radix for _, radix in fft_plan(n_fft)]
  group = _best_group(m, radices, max(MIXED_GROUP_POINTS, m))
  costs = [_bank_cost(n_fft, group, layout)
           for layout in range(len(MIXED_LAYOUTS))]
  return MixedGeometry(group, costs.index(min(costs)))


def mixed_idle_shares(n_fft: int) -> List[float]:
  """For each pass of the mixed-radix kernel at n_fft, the share of its
  threads' butterfly slots that find no butterfly in a full group."""
  group = mixed_geometry(n_fft).group
  m = int(n_fft) // 2
  return [1.0 - (group * m // r) / (MIXED_THREADS * _rounds(group * m // r))
          for _, r in fft_plan(n_fft)]


def _mel_bands(mel_t: torch.Tensor):
  """[lo, hi) of the rows where each column of mel_t is nonzero."""
  nonzero = (mel_t != 0).cpu().numpy()
  n_freqs = nonzero.shape[0]
  return [(int(np.argmax(col)), n_freqs - int(np.argmax(col[::-1])))
          if col.any() else (0, 0) for col in nonzero.T]


def fft_operands(bases: dict, n_fft: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The FFT kernel's tables, built once and kept beside the config's other
  bases (``FeatureConfig.device_bases``):

  * ``twiddles`` (K, 2) float32, ``fft_twiddles(n_fft)``;
  * ``weights``: each mel filter's weights over its nonzero bins, packed
    one filter after another;
  * ``bands`` (n_mels, 4) int32: lo, hi, the offset of the filter's
    weights in ``weights``, and 0, so that the kernel skips only exact
    zeros.
  """
  if "logmel_fft_twiddles" not in bases:
    mel_t = bases["mel_t"]
    bands, weights, offset = [], [], 0
    for m, (lo, hi) in enumerate(_mel_bands(mel_t)):
      bands.append((lo, hi, offset, 0))
      weights.append(mel_t[lo:hi, m])
      offset += hi - lo
    device = mel_t.device
    bases["logmel_fft_twiddles"] = torch.from_numpy(
        fft_twiddles(n_fft)).to(device)
    bases["logmel_fft_weights"] = torch.cat(weights).contiguous()
    bases["logmel_fft_bands"] = torch.tensor(bands, dtype=torch.int32,
                                             device=device)
  return (bases["logmel_fft_twiddles"], bases["logmel_fft_weights"],
          bases["logmel_fft_bands"])


def _library() -> ctypes.CDLL:
  lib = _build.load("logmel")
  fn = lib.odin_logmel
  if fn.argtypes is None:
    layout = lib.odin_logmel_bases_layout
    layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    layout.restype = None
    consts = [ctypes.c_int() for _ in range(3)]
    layout(*(ctypes.byref(c) for c in consts))
    if tuple(c.value for c in consts) != (CHUNK, MAX_FREQS, TILE_FRAMES):
      raise RuntimeError("csrc/logmel.cu and ops/logmel.py disagree on the "
                         "layout of the bases")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def kernel_operands(bases: dict) -> Tuple[torch.Tensor, torch.Tensor]:
  """The DFT bases and the mel bands in the kernel's layout, built once and
  kept beside the config's other bases (``FeatureConfig.device_bases``):

  * ``dft`` (groups, ceil(frame_length / CHUNK) * CHUNK, 2, MAX_FREQS),
    one group for each MAX_FREQS bins: row t of group g holds cos then sin
    of sample t at the bins g·MAX_FREQS + (0 .. MAX_FREQS − 1), zero past
    n_freqs; the padded rows are zero;
  * ``bands`` (n_mels, 2) int32: the rows [lo, hi) where mel_t's column is
    nonzero, so that the kernel skips only exact zeros.
  """
  if "logmel_dft" not in bases:
    cos_b, sin_b, mel_t = bases["cos"], bases["sin"], bases["mel_t"]
    frame_length, n_freqs = cos_b.shape
    padded = -(-frame_length // CHUNK) * CHUNK
    groups = -(-n_freqs // MAX_FREQS)
    dft = torch.zeros(groups, padded, 2, MAX_FREQS, dtype=torch.float32,
                      device=cos_b.device)
    for g in range(groups):
      bins = slice(g * MAX_FREQS, min((g + 1) * MAX_FREQS, n_freqs))
      n = bins.stop - bins.start
      dft[g, :frame_length, 0, :n] = cos_b[:, bins]
      dft[g, :frame_length, 1, :n] = sin_b[:, bins]
    bands = _mel_bands(mel_t)
    bases["logmel_dft"] = dft
    bases["logmel_bands"] = torch.tensor(bands, dtype=torch.int32,
                                         device=cos_b.device)
  return bases["logmel_dft"], bases["logmel_bands"]


def _fft_library() -> ctypes.CDLL:
  lib = _build.load("logmel_fft")
  fn = lib.odin_logmel_fft
  if fn.argtypes is None:
    limits = lib.odin_logmel_fft_limits
    limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    limits.restype = None
    lo, hi = ctypes.c_int(), ctypes.c_int()
    limits(ctypes.byref(lo), ctypes.byref(hi))
    count = lib.odin_logmel_fft_twiddle_count
    count.argtypes = [ctypes.c_int]
    count.restype = ctypes.c_int
    if (lo.value, hi.value) != FFT_LOG2_RANGE or any(
        count(k) != len(fft_twiddle_index(2 ** k))
        for k in range(lo.value, hi.value + 1)):
      raise RuntimeError("csrc/logmel_fft.cu and ops/logmel.py disagree on "
                         "the range of n_fft or the twiddle table")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def _mixed_library() -> ctypes.CDLL:
  lib = _build.load("logmel_fft_mixed")
  fn = lib.odin_logmel_fft_mixed
  if fn.argtypes is None:
    limits = lib.odin_logmel_fft_mixed_limits
    limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    limits.restype = None
    lo, hi, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    limits(ctypes.byref(lo), ctypes.byref(hi), ctypes.byref(threads))
    plan = lib.odin_logmel_fft_mixed_plan
    plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    count = lib.odin_logmel_fft_mixed_twiddle_count
    count.argtypes = [ctypes.c_int]
    count.restype = ctypes.c_int
    radices = (ctypes.c_int * 12)()
    agree = ((lo.value, hi.value) == MIXED_RANGE and
             threads.value == MIXED_THREADS)
    for n_fft in range(MIXED_RANGE[0] - 2, MIXED_RANGE[1] + 3):
      passes = plan(n_fft, radices)
      if kernel_route(n_fft) != "mixed":
        agree = agree and passes == 0 and count(n_fft) == 0
      else:
        agree = (agree and list(radices[:passes]) ==
                 [r for _, r in fft_plan(n_fft)] and
                 count(n_fft) == len(fft_twiddle_index(n_fft)))
      if not agree:
        raise RuntimeError("csrc/logmel_fft_mixed.cu and ops/logmel.py "
                           "disagree on the range of n_fft, the threads, the "
                           f"plan or the twiddle table (at n_fft {n_fft})")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def on_device(device: torch.device):
  """The CUDA device guard of a launch: none where `device` is already the
  current device (the guard costs microseconds a call)."""
  if device.index is None or device.index == torch._C._cuda_getDevice():
    return contextlib.nullcontext()
  return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
  """The current CUDA stream of `device` as the ``cudaStream_t`` a launcher
  takes, without making a ``torch.cuda.Stream`` object."""
  return torch._C._cuda_getCurrentRawStream(device.index)


@contextlib.contextmanager
def untraced():
  """Tensors made inside are real, whatever traces the caller: under
  ``torch.export`` neither the tracer's fake mode, its proxy mode nor its
  functionalization sees them, so a program takes them as constants (not
  the ops that made them), and a cache keeps no fake tensor after the
  export."""
  from torch._subclasses.fake_tensor import unset_fake_temporarily
  from torch._subclasses.functional_tensor import disable_functional_mode
  from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
  with unset_fake_temporarily(), disable_proxy_modes_tracing(), \
      disable_functional_mode():
    yield


def kernel_tables(kernel: str, bases: dict, n_fft: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """(table, weights, bands) of one K1 kernel, built once and kept in
  `bases` (``FeatureConfig.device_bases``): for ``"fft"`` and ``"mixed"``
  the twiddles, the packed mel weights and their bands
  (``fft_operands``); for ``"dense"`` the DFT bases in the kernel's layout,
  ``mel_t`` and the mel bands (``kernel_operands``).  Made ``untraced``:
  under ``torch.export`` they are the program's constants."""
  key = f"logmel_tables_{kernel}"
  if key not in bases:
    with untraced():
      if kernel == "dense":
        dft, bands = kernel_operands(bases)
        bases[key] = (dft, bases["mel_t"], bands)
      else:
        bases[key] = fft_operands(bases, n_fft)
  return bases[key]


def _run(kernel: str, frames: torch.Tensor, table: torch.Tensor,
         weights: torch.Tensor, bands: torch.Tensor, n_fft: int,
         scale_sq: float, out: torch.Tensor) -> None:
  """Launches one K1 kernel, ``"fft"``, ``"mixed"`` or ``"dense"``, on
  (..., frame_length) contiguous CUDA frames into (..., n_mels) ``out`` on
  the current stream, with the kernel's tables (``kernel_tables``); raises
  if the launch fails.  Counts nothing."""
  frame_length = frames.shape[-1]
  n = frames.numel() // frame_length
  n_mels = out.shape[-1]
  device = frames.device
  stream = raw_stream(device)
  with on_device(device):
    if kernel == "fft":
      err = _fft_library().odin_logmel_fft(
          frames.data_ptr(), table.data_ptr(), weights.data_ptr(),
          bands.data_ptr(), out.data_ptr(), n, frame_length,
          n_fft.bit_length() - 1, n_mels, weights.numel(), scale_sq, stream)
    elif kernel == "mixed":
      err = _mixed_library().odin_logmel_fft_mixed(
          frames.data_ptr(), table.data_ptr(), weights.data_ptr(),
          bands.data_ptr(), out.data_ptr(), n, frame_length, n_fft, n_mels,
          weights.numel(), *mixed_geometry(n_fft), scale_sq, stream)
    else:
      err = _library().odin_logmel(
          frames.data_ptr(), table.data_ptr(), weights.data_ptr(),
          bands.data_ptr(), out.data_ptr(), n, frame_length, n_fft // 2 + 1,
          n_mels, scale_sq, stream)
  if err != 0:
    raise RuntimeError(f"logmel {kernel} kernel launch failed with CUDA "
                       f"error {err}")


def _launch(kernel: str, frames: torch.Tensor, config: "FeatureConfig",
            out: torch.Tensor) -> None:
  """``_run`` with `config`'s tables on the frames' device: one K1 kernel
  on (n, frame_length) CUDA frames into (n, n_mels) ``out``.  Counts
  nothing: the operator's CUDA implementation does."""
  tables = kernel_tables(kernel, config.device_bases(frames.device),
                         config.n_fft)
  _run(kernel, frames, *tables, config.n_fft, float(config.scale ** 2), out)


# -- the operator ------------------------------------------------------------
_LIB = torch.library.Library("odin_tpu_torch", "FRAGMENT")
_LIB.define("logmel(Tensor frames, Tensor cos, Tensor sin, Tensor mel_t, "
            "Tensor table, Tensor weights, Tensor bands, int n_fft, "
            "float scale_sq) -> Tensor")


@functools.lru_cache(maxsize=None)
def _table_shapes(kernel: str, n_fft: int, frame_length: int
                  ) -> Tuple[Tuple[int, ...], int]:
  """The shape of `kernel`'s table (``kernel_tables``) for n_fft and
  frame_length, and the columns of its bands."""
  if kernel == "dense":
    n_freqs = n_fft // 2 + 1
    return ((-(-n_freqs // MAX_FREQS), -(-frame_length // CHUNK) * CHUNK, 2,
             MAX_FREQS), 2)
  return (len(fft_twiddle_index(n_fft)), 2), 4


# the tables already checked: id(bands) -> (bands, table, weights, mel_t,
# then the frames' device and length, n_fft and the four versions they were
# checked at); the tensors are held, so that an id is not reused while kept
_CHECKED = {}
_CHECKED_KEPT = 64


def check_tables(kernel: str, frames: torch.Tensor, mel_t: torch.Tensor,
                 table: torch.Tensor, weights: torch.Tensor,
                 bands: torch.Tensor, n_fft: int) -> None:
  """Raises ValueError unless `kernel`'s tables fit its launch on `frames`:
  contiguous, on the frames' device, of the dtypes and shapes that
  ``kernel_tables`` gives for n_fft, the frame length and mel_t's mels;
  for the FFT kernels, also every band within the bins and its weights
  within ``weights``.  The kernels read the tables by raw pointer, so a
  table of another route, config or device would be read out of bounds.
  Tables that passed are not checked again (nor their bands read to the
  host again) until one of them, the device, the frame length or n_fft
  changes."""
  device = frames.device
  frame_length = frames.shape[-1]
  seen = (device, frame_length, n_fft, mel_t._version, table._version,
          weights._version, bands._version)
  hit = _CHECKED.get(id(bands))
  if (hit is not None and hit[0] is bands and hit[1] is table and
      hit[2] is weights and hit[3] is mel_t and hit[4:] == seen):
    return
  n_freqs = n_fft // 2 + 1
  shape, columns = _table_shapes(kernel, n_fft, frame_length)
  if not (mel_t.dtype == table.dtype == weights.dtype == torch.float32 and
          bands.dtype == torch.int32 and
          device == mel_t.device == table.device == weights.device ==
          bands.device and
          mel_t.ndim == 2 and mel_t.shape[0] == n_freqs and
          table.shape == shape and
          (weights.shape == mel_t.shape if kernel == "dense" else
           weights.ndim == 1) and
          bands.shape == (mel_t.shape[1], columns) and
          mel_t.is_contiguous() and table.is_contiguous() and
          weights.is_contiguous() and bands.is_contiguous()):
    got = ", ".join(f"{name} {tuple(t.shape)} {t.dtype} on {t.device}"
                    for name, t in (("mel_t", mel_t), ("table", table),
                                    ("weights", weights), ("bands", bands)))
    raise ValueError(
        f"logmel's {kernel} kernel at n_fft {n_fft} cannot take {got} for "
        f"{tuple(frames.shape)} frames on {device}: it takes a contiguous "
        f"float32 table {shape} and int32 bands (n_mels, {columns}) on the "
        "frames' device (kernel_tables gives them)")
  if kernel != "dense":  # the dense kernel clamps its bands to the bins
    n_weights = weights.numel()
    lo, hi, offset, _ = bands.cpu().T.tolist()
    if not all(0 <= l <= h <= n_freqs and 0 <= o and o + h - l <= n_weights
               for l, h, o in zip(lo, hi, offset)):
      raise ValueError(f"logmel's {kernel} kernel: bands {bands.tolist()} "
                       f"lie outside {n_freqs} bins or {n_weights} weights")
  if len(_CHECKED) >= _CHECKED_KEPT:
    _CHECKED.clear()
  _CHECKED[id(bands)] = (bands, table, weights, mel_t) + seen


def _logmel_cuda(frames, cos, sin, mel_t, table, weights, bands, n_fft,
                 scale_sq):
  """The operator on the card: the kernel that ``kernel_route(n_fft)``
  names, on tables that ``check_tables`` passes, counted in
  ``logmel.launches`` and its route's share."""
  if frames.dtype != torch.float32:
    raise TypeError(f"logmel takes float32 frames, got {frames.dtype}")
  kernel = kernel_route(n_fft)
  check_tables(kernel, frames, mel_t, table, weights, bands, n_fft)
  frames = frames.contiguous()
  out = frames.new_empty(frames.shape[:-1] + (mel_t.shape[1],))
  if out.numel() == 0:
    return out
  _run(kernel, frames, table, weights, bands, n_fft, scale_sq, out)
  logmel.launches += 1
  if kernel == "fft":
    logmel.fft_launches += 1
  elif kernel == "mixed":
    logmel.mixed_launches += 1
  return out


def _logmel_cpu(frames, cos, sin, mel_t, table, weights, bands, n_fft,
                scale_sq):
  """The operator on the CPU: the plain version."""
  return logmel_reference(frames, cos, sin, mel_t, scale_sq)


def _logmel_fake(frames, cos, sin, mel_t, table, weights, bands, n_fft,
                 scale_sq):
  return frames.new_empty(frames.shape[:-1] + (mel_t.shape[1],),
                          dtype=torch.float32)


def _logmel_setup(ctx, inputs, output):
  frames, cos, sin, mel_t, *_, scale_sq = inputs
  ctx.save_for_backward(frames, cos, sin, mel_t)
  ctx.scale_sq = scale_sq


def _logmel_backward(ctx, g):
  """The plain version's gradient with respect to the frames."""
  frames, cos, sin, mel_t = ctx.saved_tensors
  with torch.enable_grad():
    frames = frames.detach().requires_grad_()
    out = logmel_reference(frames, cos, sin, mel_t, ctx.scale_sq)
    grad, = torch.autograd.grad(out, frames, g)
  return (grad,) + (None,) * 8


_LIB.impl("logmel", _logmel_cuda, "CUDA")
_LIB.impl("logmel", _logmel_cpu, "CPU")
torch.library.register_fake("odin_tpu_torch::logmel", _logmel_fake,
                            lib=_LIB)
torch.library.register_autograd("odin_tpu_torch::logmel", _logmel_backward,
                                setup_context=_logmel_setup, lib=_LIB)
_OP = torch.ops.odin_tpu_torch.logmel.default


def _op_args(config: "FeatureConfig", device: torch.device,
             tables: bool) -> tuple:
  """The operator's arguments after the frames for `config` on `device`,
  built once and kept beside its bases: the bases, the routed kernel's
  tables (``kernel_tables``) where `tables`, else empty ones, n_fft and
  the scale squared."""
  bases = config.device_bases(device)
  key = "logmel_op_args" if tables else "logmel_op_args_plain"
  args = bases.get(key)
  if args is None:
    if tables:
      kernel = kernel_route(config.n_fft)
      table = kernel_tables(kernel, bases, config.n_fft)
    else:
      with untraced():
        table = (torch.empty(0), torch.empty(0),
                 torch.empty(0, dtype=torch.int32))
    args = bases[key] = (bases["cos"], bases["sin"], bases["mel_t"], *table,
                         config.n_fft, float(config.scale ** 2))
  return args


def logmel(frames_windowed: torch.Tensor,
           config: "FeatureConfig") -> torch.Tensor:
  """(..., frame_length) fp32 contiguous windowed frames -> (..., n_mels),
  through ``torch.ops.odin_tpu_torch.logmel``.

  The kernel's tables go to the operator where a kernel may run them: on
  the card, and in a program that ``torch.export`` traces (which may be
  moved onto the card); an eager call on the CPU passes empty ones.
  ``logmel.launches`` counts the launches of the three kernels,
  ``logmel.fft_launches`` the power-of-two FFT kernel's share and
  ``logmel.mixed_launches`` the mixed-radix kernel's."""
  frame_length = config.frame_length
  if frames_windowed.dtype != torch.float32:
    raise TypeError(f"logmel takes float32 frames, got {frames_windowed.dtype}")
  if frames_windowed.ndim < 1 or frames_windowed.shape[-1] != frame_length:
    raise ValueError(f"logmel takes (..., {frame_length}) frames, got "
                     f"{tuple(frames_windowed.shape)}")
  if not frames_windowed.is_contiguous():
    raise ValueError("logmel takes contiguous frames")
  device = frames_windowed.device
  if device.type == "cuda":
    args = _op_args(config, device, True)
  elif device.type == "cpu":
    args = _op_args(config, device, torch.compiler.is_exporting())
  else:
    raise ValueError(f"logmel runs on 'cpu' or 'cuda', not {device}")
  return _OP(frames_windowed, *args)


logmel.launches = 0
logmel.fft_launches = 0
logmel.mixed_launches = 0
