"""Native Kaldi interop: ark/scp binary IO, feature post-processing, dataset
(host NumPy): a copy of ``odin_tpu/preprocessing/kaldi.py``.

Reference: ``odin/preprocessing/kaldi_io.py`` (KaldiFeaturesReader :150,
KaldiDataset :320, count_frames :83).  The reference delegates every byte of
IO and all DSP to ``pykaldi`` (an external CPython extension); this module
re-implements the Kaldi archive format and the three post-processors
natively in numpy so no Kaldi installation is required, and returns plain
``numpy`` arrays, as the JAX package's does.

Supported binary objects ("\\0B" streams):
  - "FM "/"DM " float/double matrices, "FV "/"DV " vectors
  - "CM " compressed matrices (format 1, per-column uint8 + percentile
    headers) — both read and write, so Kaldi-produced mfcc archives load
    directly.
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "read_mat", "read_vec", "read_ark", "read_scp", "write_ark",
    "compute_deltas", "compute_shifted_deltas", "sliding_window_cmn",
    "count_frames", "KaldiFeaturesReader", "KaldiDataset",
]

_BINARY_MAGIC = b"\0B"


# ===========================================================================
# Low-level binary IO
# ===========================================================================
def _read_int32(f) -> int:
  size = f.read(1)
  if size != b"\x04":
    raise ValueError(f"expected int32 size marker, got {size!r}")
  return struct.unpack("<i", f.read(4))[0]


def _write_int32(f, v: int) -> None:
  f.write(b"\x04" + struct.pack("<i", int(v)))


def _uint16_to_float(x: np.ndarray, min_value: float,
                     range_: float) -> np.ndarray:
  return min_value + range_ * (x.astype(np.float64) / 65535.0)


def _float_to_uint16(x: np.ndarray, min_value: float,
                     range_: float) -> np.ndarray:
  r = max(range_, 1e-20)
  q = np.round((x - min_value) / r * 65535.0)
  return np.clip(q, 0, 65535).astype(np.uint16)


def _read_compressed(f) -> np.ndarray:
  """Kaldi CompressedMatrix format 1 ("CM "): global header, per-column
  percentile headers (4 uint16), then one uint8 per element column-major."""
  min_value, range_, rows, cols = struct.unpack("<ffii", f.read(16))
  headers = np.frombuffer(f.read(cols * 8), np.uint16).reshape(cols, 4)
  data = np.frombuffer(f.read(cols * rows), np.uint8).reshape(cols, rows)
  p = _uint16_to_float(headers, min_value, range_)  # [cols, 4]
  p0, p25, p75, p100 = (p[:, i:i + 1] for i in range(4))
  c = data.astype(np.float64)
  lo = p0 + (p25 - p0) * (c / 64.0)
  mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
  hi = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
  out = np.where(c <= 64, lo, np.where(c <= 192, mid, hi))
  return out.T.astype(np.float32)  # [rows, cols]


def _write_compressed(f, mat: np.ndarray) -> None:
  mat = np.asarray(mat, np.float64)
  rows, cols = mat.shape
  min_value = float(mat.min())
  range_ = float(mat.max() - min_value)
  f.write(b"CM ")
  f.write(struct.pack("<ffii", min_value, range_, rows, cols))
  pcts = np.percentile(mat, [0, 25, 75, 100], axis=0).T  # [cols, 4]
  q = _float_to_uint16(pcts, min_value, range_)
  # keep the quantized percentiles strictly ordered so decode is monotone
  q = np.maximum.accumulate(q, axis=1)
  f.write(q.astype("<u2").tobytes())
  p = _uint16_to_float(q, min_value, range_)
  p0, p25, p75, p100 = (p[:, i:i + 1] for i in range(4))
  x = mat.T  # [cols, rows]
  with np.errstate(divide="ignore", invalid="ignore"):
    lo = 64.0 * (x - p0) / np.maximum(p25 - p0, 1e-20)
    mid = 64.0 + 128.0 * (x - p25) / np.maximum(p75 - p25, 1e-20)
    hi = 192.0 + 63.0 * (x - p75) / np.maximum(p100 - p75, 1e-20)
  c = np.where(x < p25, lo, np.where(x < p75, mid, hi))
  f.write(np.clip(np.round(c), 0, 255).astype(np.uint8).tobytes())


def _read_object(f) -> np.ndarray:
  magic = f.read(2)
  if magic != _BINARY_MAGIC:
    if len(magic) < 2:
      raise ValueError("hit end-of-file before a Kaldi object — "
                       "bad specifier offset or truncated archive")
    raise ValueError(
        f"expected Kaldi binary marker \\0B, got {magic!r} — "
        "text archives are not supported, convert with copy-feats first")
  token = f.read(3)
  if token == b"CM ":
    return _read_compressed(f)
  if token in (b"CM2", b"CM3"):
    raise NotImplementedError(f"compressed format {token!r} not supported")
  if token in (b"FM ", b"DM "):
    dtype = "<f4" if token == b"FM " else "<f8"
    rows, cols = _read_int32(f), _read_int32(f)
    n = rows * cols
    return np.frombuffer(f.read(n * int(dtype[-1])),
                         dtype).reshape(rows, cols)
  if token in (b"FV ", b"DV "):
    dtype = "<f4" if token == b"FV " else "<f8"
    dim = _read_int32(f)
    return np.frombuffer(f.read(dim * int(dtype[-1])), dtype)
  raise ValueError(f"unknown Kaldi object token {token!r}")


def _read_header_rows(f) -> Optional[int]:
  """Read only enough bytes to learn the frame count (matrix rows /
  vector dim) without materializing the data.  Returns None if the object
  is a compressed/bool stream where the count requires a full read."""
  magic = f.read(2)
  if magic != _BINARY_MAGIC:
    return None
  token = f.read(3)
  if token in (b"FM ", b"DM "):
    return _read_int32(f)
  if token in (b"FV ", b"DV "):
    return _read_int32(f)
  if token == b"CM ":
    _, _, rows, _ = struct.unpack("<ffii", f.read(16))
    return rows
  return None


def _split_specifier(specifier: str) -> Tuple[str, Optional[int]]:
  # Windows-safe: the offset is the digits after the LAST ':'
  if ":" in specifier:
    path, _, off = specifier.rpartition(":")
    if off.isdigit():
      return path, int(off)
  return specifier, None


def _open_at(specifier: str):
  path, offset = _split_specifier(specifier)
  f = open(path, "rb")
  if offset is not None:
    f.seek(offset)
  else:
    _skip_key(f)
  return f


def _skip_key(f) -> Optional[str]:
  """Consume 'utt_id ' preceding an object; returns the key or None at EOF."""
  key = b""
  while True:
    ch = f.read(1)
    if not ch:
      return None
    if ch == b" ":
      return key.decode()
    key += ch


def read_mat(specifier: str) -> np.ndarray:
  """Load one matrix from ``path.ark:offset`` (or first entry of a plain
  ark path).  Mirrors ``kaldi.util.io.read_matrix`` (reference :255)."""
  with _open_at(specifier) as f:
    out = _read_object(f)
  if out.ndim != 2:
    raise ValueError(f"{specifier} holds a vector, use read_vec")
  return out


def read_vec(specifier: str) -> np.ndarray:
  with _open_at(specifier) as f:
    out = _read_object(f)
  if out.ndim != 1:
    raise ValueError(f"{specifier} holds a matrix, use read_mat")
  return out


def read_ark(path: str):
  """Yield ``(utt_id, array)`` for every entry of a binary archive."""
  with open(path, "rb") as f:
    while True:
      key = _skip_key(f)
      if key is None:
        return
      yield key, _read_object(f)


def read_scp(path: str):
  """Yield ``(utt_id, array)`` following an scp index file."""
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      key, spec = line.split(None, 1)
      yield key, read_mat(spec) if _is_matrix_spec(spec) else _any_read(spec)


def _any_read(specifier: str) -> np.ndarray:
  with _open_at(specifier) as f:
    return _read_object(f)


def _is_matrix_spec(spec: str) -> bool:
  try:
    with _open_at(spec) as f:
      f.read(2)
      return f.read(3) in (b"FM ", b"DM ", b"CM ")
  except (OSError, ValueError):
    return True


def write_ark(path: str, data: Dict[str, np.ndarray],
              scp_path: Optional[str] = None,
              compress: bool = False) -> Dict[str, str]:
  """Write a binary archive; returns {utt_id: specifier} and optionally an
  scp file, so the output is readable by Kaldi's copy-feats as well."""
  specs = {}
  with open(path, "wb") as f:
    for key, arr in data.items():
      arr = np.asarray(arr)
      f.write(key.encode() + b" ")
      offset = f.tell()
      f.write(_BINARY_MAGIC)
      if arr.ndim == 2 and compress:
        _write_compressed(f, arr)
      elif arr.ndim == 2:
        token = b"DM " if arr.dtype == np.float64 else b"FM "
        f.write(token)
        _write_int32(f, arr.shape[0])
        _write_int32(f, arr.shape[1])
        dt = "<f8" if token == b"DM " else "<f4"
        f.write(np.ascontiguousarray(arr, dt).tobytes())
      elif arr.ndim == 1:
        token = b"DV " if arr.dtype == np.float64 else b"FV "
        f.write(token)
        _write_int32(f, arr.shape[0])
        dt = "<f8" if token == b"DV " else "<f4"
        f.write(np.ascontiguousarray(arr, dt).tobytes())
      else:
        raise ValueError(f"only 1-D/2-D arrays supported, got {arr.shape}")
      specs[key] = f"{path}:{offset}"
  if scp_path is not None:
    with open(scp_path, "w") as f:
      for key, spec in specs.items():
        f.write(f"{key} {spec}\n")
  return specs


# ===========================================================================
# Kaldi-semantics post-processing (pykaldi featfuncs equivalents)
# ===========================================================================
def compute_deltas(feats: np.ndarray, order: int = 2,
                   window: int = 2) -> np.ndarray:
  """Kaldi ``compute_deltas``: append regression deltas up to `order`;
  output has ``dim * (order+1)`` columns.  Edge frames are replicated
  (Kaldi's boundary behavior)."""
  feats = np.asarray(feats, np.float32)
  denom = sum(j * j for j in range(-window, window + 1))
  coeffs = np.arange(-window, window + 1, dtype=np.float64) / denom
  blocks = [feats]
  cur = feats
  for _ in range(order):
    padded = np.pad(cur, ((window, window), (0, 0)), mode="edge")
    # delta_t = sum_j j * x_{t+j} / sum_j j^2   (correlation, not conv)
    nxt = np.zeros_like(cur, np.float64)
    for j, c in zip(range(-window, window + 1), coeffs):
      nxt += c * padded[window + j:window + j + len(cur)]
    cur = nxt.astype(np.float32)
    blocks.append(cur)
  return np.concatenate(blocks, axis=1)


def compute_shifted_deltas(feats: np.ndarray, window: int = 1,
                           block_shift: int = 3,
                           num_blocks: int = 7) -> np.ndarray:
  """Kaldi shifted-delta cepstra: ``[x_t, d(t), d(t+P), ..., d(t+(k-1)P)]``
  with first-order deltas; output ``dim * (num_blocks + 1)`` columns.
  Block indices past the end are clamped to the final frame."""
  feats = np.asarray(feats, np.float32)
  n = len(feats)
  d = compute_deltas(feats, order=1, window=window)[:, feats.shape[1]:]
  blocks = [feats]
  for i in range(num_blocks):
    idx = np.minimum(np.arange(n) + i * block_shift, n - 1)
    blocks.append(d[idx])
  return np.concatenate(blocks, axis=1)


def sliding_window_cmn(feats: np.ndarray, window: int = 600,
                       min_window: int = 100, center: bool = False,
                       normalize_variance: bool = False) -> np.ndarray:
  """Kaldi ``sliding_window_cmn``: per-frame mean (and optional variance)
  normalization over a sliding window, clipped at utterance boundaries;
  non-centered windows near the start are widened to `min_window` frames."""
  feats = np.asarray(feats, np.float64)
  n = len(feats)
  t = np.arange(n)
  if center:
    ws = t - window // 2
    we = ws + window
  else:
    ws = t - window + 1
    we = t + 1
    short = (we - np.maximum(ws, 0)) < min_window
    we = np.where(short, np.minimum(min_window, n), we)
  ws = np.clip(ws, 0, n)
  we = np.clip(we, 0, n)
  ws = np.minimum(ws, we - 1)  # never empty
  csum = np.concatenate([np.zeros((1, feats.shape[1])), feats.cumsum(0)])
  cnt = (we - ws)[:, None].astype(np.float64)
  mean = (csum[we] - csum[ws]) / cnt
  out = feats - mean
  if normalize_variance:
    csq = np.concatenate([np.zeros((1, feats.shape[1])),
                          (feats ** 2).cumsum(0)])
    var = (csq[we] - csq[ws]) / cnt - mean ** 2
    out = out / np.sqrt(np.maximum(var, 1e-10))
  return out.astype(np.float32)


# ===========================================================================
# Reader / frame counting (reference API surface)
# ===========================================================================
def count_frames(specifiers: Sequence[str], is_matrix: bool = False,
                 is_bool_index: bool = True, progressbar: bool = False,
                 num_workers: int = 1, concat_char: str = "&") -> List[int]:
  """Frame count per specifier (reference :83).  Matrix counts read only
  the object header; boolean-SAD vectors sum their entries."""
  del progressbar, num_workers  # header reads are IO-trivial; keep serial
  counts = []
  for spec in specifiers:
    total = 0
    for s in spec.split(concat_char):
      if is_matrix or not is_bool_index:
        with _open_at(s) as f:
          rows = _read_header_rows(f)
        if rows is None:
          arr = _any_read(s)
          rows = len(arr)
        total += int(rows)
      else:
        total += int(np.sum(read_vec(s) != 0))
    counts.append(total)
  return counts


class KaldiFeaturesReader:
  """Load Kaldi archive features and post-process (delta -> shifted delta
  -> sliding-window CMN, in that order — reference :150).  Pure numpy; the
  constructor mirrors the reference's pykaldi option objects."""

  def __init__(self, name: str, delta_order: Optional[int] = None,
               delta_window: Optional[int] = None,
               sdelta_block_shift: Optional[int] = None,
               sdelta_num_blocks: Optional[int] = None,
               sdelta_window: Optional[int] = None,
               cmn_window: Optional[int] = None, cmn_min_window: int = 100,
               cmn_center: bool = False,
               cmn_normalize_variance: bool = False, is_matrix: bool = True,
               concat_char: str = "&"):
    self.name = str(name)
    self.is_matrix = bool(is_matrix)
    self.concat_char = str(concat_char)
    self.delta_opts = (dict(order=int(delta_order), window=int(delta_window))
                       if delta_order and delta_window else None)
    self.sdelta_opts = (dict(block_shift=int(sdelta_block_shift),
                             num_blocks=int(sdelta_num_blocks),
                             window=int(sdelta_window))
                        if sdelta_block_shift and sdelta_num_blocks and
                        sdelta_window else None)
    self.cmn_opts = (dict(window=int(cmn_window),
                          min_window=int(cmn_min_window),
                          center=bool(cmn_center),
                          normalize_variance=bool(cmn_normalize_variance))
                     if cmn_window and cmn_min_window else None)

  def transform(self, specifier: str) -> np.ndarray:
    all_feats = []
    for spec in specifier.split(self.concat_char):
      feats = read_mat(spec) if self.is_matrix else read_vec(spec)
      if self.is_matrix:
        if self.delta_opts is not None:
          feats = compute_deltas(feats, **self.delta_opts)
        if self.sdelta_opts is not None:
          feats = compute_shifted_deltas(feats, **self.sdelta_opts)
        if self.cmn_opts is not None:
          feats = sliding_window_cmn(feats, **self.cmn_opts)
      all_feats.append(np.asarray(feats))
    return all_feats[0] if len(all_feats) == 1 else np.concatenate(
        all_feats, axis=0)


# ===========================================================================
# Dataset
# ===========================================================================
class KaldiDataset:
  """Mini-batch dataset over Kaldi archives (reference :320), returning
  numpy arrays, as the JAX package's does.

  - ``post_processing``: 'xvector' -> [batch, frames, dim] stacked tensor
    (requires clipping_per_batch); 'ivector' -> frames vstacked with labels
    repeated; 'flatten' -> flat list; callable -> custom; None -> dict of
    name -> list.
  - ``batch_strategy``: 'naive' (chunk the utterance list), 'stratify'
    (round-robin over labels, capped at utt_per_label_in_epoch per label),
    'utt' (one utterance per batch).
  """

  def __init__(self, specifier_description: Dict[KaldiFeaturesReader,
                                                 List[str]],
               sad_name: Optional[str] = None,
               labels: Optional[Sequence[int]] = None, shuffle: bool = False,
               shuffle_batches: bool = False, batch_size: int = 32,
               post_processing: Union[None, str, Callable] = None,
               clipping: Optional[Tuple[int, int]] = None,
               clipping_per_batch: bool = True,
               utt_per_label_in_epoch: float = np.inf,
               min_utt_per_batch: int = 1,
               min_frames_per_utt: Optional[int] = None,
               min_utt_per_label: Optional[int] = None,
               remove_empty_utt: bool = True, batch_strategy: str = "naive",
               batch_drop_last: bool = False, return_labels: bool = True,
               seed: int = 8, verbose: bool = False):
    assert all(isinstance(r, KaldiFeaturesReader)
               for r in specifier_description), \
        "keys must be KaldiFeaturesReader"
    lengths = {len(v) for v in specifier_description.values()}
    assert len(lengths) == 1, f"specifier list length mismatch: {lengths}"
    self.readers = {r.name: r for r in specifier_description}
    self.specs = {r.name: list(v) for r, v in specifier_description.items()}
    self.sad_name = (sad_name.name if isinstance(sad_name,
                                                 KaldiFeaturesReader)
                     else sad_name)
    if self.sad_name is not None and self.sad_name not in self.readers:
      raise ValueError(f"sad_name={self.sad_name!r} not among readers "
                       f"{sorted(self.readers)}")
    n = lengths.pop()
    self.labels = None if labels is None else np.asarray(labels)
    self.return_labels = bool(return_labels) and self.labels is not None
    self.batch_size = int(batch_size)
    self.clipping = clipping
    self.clipping_per_batch = bool(clipping_per_batch)
    self.seed = int(seed)
    self.verbose = bool(verbose)
    if isinstance(post_processing, str):
      post_processing = {"xvector": self._post_xvector,
                         "ivector": self._post_ivector,
                         "flatten": self._post_flatten}[
                             post_processing.strip().lower()]
    self.post_processing = post_processing
    rand = np.random.RandomState(seed)

    # ---- frame counts (sad sums if available, else header rows) ----
    feat_names = [nm for nm in self.readers if nm != self.sad_name]
    count_name = self.sad_name or feat_names[0]
    frame_counts = np.asarray(count_frames(
        self.specs[count_name],
        is_matrix=self.readers[count_name].is_matrix,
        is_bool_index=count_name == self.sad_name,
        concat_char=self.readers[count_name].concat_char))

    # ---- filtering ----
    keep = np.ones(n, bool)
    if remove_empty_utt:
      keep &= frame_counts > 0
    if min_frames_per_utt is not None:
      keep &= frame_counts >= int(min_frames_per_utt)
    if min_utt_per_label is not None and self.labels is not None:
      uniq, cnt = np.unique(self.labels[keep], return_counts=True)
      bad = set(uniq[cnt < int(min_utt_per_label)])
      keep &= ~np.isin(self.labels, list(bad))
    idx = np.nonzero(keep)[0]
    if shuffle:
      rand.shuffle(idx)

    # ---- batching ----
    strategy = batch_strategy.strip().lower()
    if strategy == "utt":
      batches = [[i] for i in idx]
    elif strategy == "naive":
      batches = [idx[i:i + self.batch_size]
                 for i in range(0, len(idx), self.batch_size)]
    elif strategy == "stratify":
      if self.labels is None:
        raise ValueError("batch_strategy='stratify' requires labels")
      cap = (np.inf if not utt_per_label_in_epoch or
             utt_per_label_in_epoch <= 0 else float(utt_per_label_in_epoch))
      by_label = {}
      for i in idx:
        by_label.setdefault(int(self.labels[i]), []).append(i)
      pools = []
      for lab, utts in by_label.items():
        if cap < np.inf and len(utts) > cap:
          utts = list(rand.choice(utts, int(cap), replace=False))
        pools.append(utts)
      # round-robin so every batch mixes labels
      order = []
      for j in range(max(len(p) for p in pools)):
        for p in pools:
          if j < len(p):
            order.append(p[j])
      batches = [order[i:i + self.batch_size]
                 for i in range(0, len(order), self.batch_size)]
    else:
      raise ValueError(f"unknown batch_strategy {batch_strategy!r}")
    if batch_drop_last and batches and len(batches[-1]) < self.batch_size:
      batches = batches[:-1]
    if min_utt_per_batch > 1 and self.labels is not None:
      batches = [b for b in batches
                 if len(set(self.labels[list(b)])) >= int(min_utt_per_batch)]
    if shuffle_batches:
      rand.shuffle(batches)
    self.batches = [np.asarray(b) for b in batches]

  # ---- predefined post-processors (reference :446-467) ----
  @staticmethod
  def _post_xvector(data, labels):
    return [np.stack(dat, 0) for dat in data.values()], labels

  @staticmethod
  def _post_ivector(data, labels):
    if labels is not None:
      n_frames = [len(u) for u in next(iter(data.values()))]
      labels = np.repeat(labels, n_frames)
    return [np.vstack(dat) for dat in data.values()], labels

  @staticmethod
  def _post_flatten(data, labels):
    out = []
    for dat in data.values():
      out.extend(dat)
    return out, labels

  def __len__(self) -> int:
    return len(self.batches)

  def __getitem__(self, index: int):
    rng = np.random.RandomState(self.seed * 1000003 + index)
    batch = self.batches[index]
    data = {nm: [self.readers[nm].transform(self.specs[nm][i])
                 for i in batch]
            for nm in self.readers}
    if self.sad_name is not None:
      sad = data.pop(self.sad_name)
      for nm in data:
        data[nm] = [u[s[:len(u)].astype(bool)] for u, s in zip(data[nm], sad)]
    if self.clipping is not None:
      lo, hi = self.clipping
      if self.clipping_per_batch:
        # one shared length so 'xvector' can stack [batch, frames, dim]
        max_len = min(min(len(u) for u in dat) for dat in data.values())
        shared = min(int(rng.randint(lo, hi + 1)), max_len)
      for nm in data:
        clipped = []
        for u in data[nm]:
          length = shared if self.clipping_per_batch else min(
              int(rng.randint(lo, hi + 1)), len(u))
          s = int(rng.randint(0, max(len(u) - length, 0) + 1))
          clipped.append(u[s:s + length])
        data[nm] = clipped
    labels = self.labels[batch] if self.return_labels else None
    if self.post_processing is not None:
      return self.post_processing(data, labels)
    if labels is not None:
      data = dict(data, labels=labels)
    return data

  def __iter__(self):
    for i in range(len(self)):
      yield self[i]

  def create_dataloader(self):
    return iter(self)
