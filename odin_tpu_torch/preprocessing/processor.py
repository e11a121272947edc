"""Corpus feature extraction (PyTorch port of
``odin_tpu/preprocessing/processor.py``): ``FeatureProcessor``, the host
extractor pipeline fanned over files by ``mpi.MPI``; ``batch_speech_features``
on padded batches, ``DeviceCorpusProcessor`` from audio files to the
on-disk feature store, ``validate_features`` and ``calculate_pca`` over a
store.

The store is the JAX package's layout, byte for byte: one ``MmapArray`` per
feature, its ``indices_<feat>`` ``MmapDict`` of (start, end) rows per
utterance, ``<feat>_sum1.npy``/``<feat>_sum2.npy`` float64 sums and
``log.txt``; ``calculate_pca`` pickles the port's ``IncrementalPCA`` (not
scikit-learn's) to ``<feat>_pca.pkl``.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.fuel.databases import MmapArrayWriter, MmapDict
from odin_tpu_torch.fuel.dataset import Dataset
from odin_tpu_torch.ml.decompositions import \
    IncrementalPCA as _IncrementalPCA
from odin_tpu_torch.mpi import MPI
from odin_tpu_torch.preprocessing.base import ExtractorSignal, Pipeline

__all__ = ["FeatureProcessor", "DeviceCorpusProcessor", "validate_features",
           "calculate_pca", "IncrementalPCA", "batch_speech_features"]


def _stages_on_card(extractor) -> List[str]:
  """The names of the stages of `extractor` bound to a CUDA device."""
  steps = extractor.steps if isinstance(extractor, Pipeline) else [extractor]
  return [step.name for step in steps
          if isinstance(getattr(step, "device", None), (str, torch.device))
          and torch.device(step.device).type == "cuda"]


class FeatureProcessor:
  """Fan an extractor pipeline over a corpus and persist the outputs (the
  JAX package's ``FeatureProcessor``, ``odin_tpu/preprocessing/
  processor.py:33-127``): one ``MmapArray`` per feature, its
  ``indices_<feat>`` ``MmapDict``, float64 ``<feat>_sum1.npy`` and
  ``<feat>_sum2.npy`` and ``log.txt``.

  With ``ncpu > 1`` the jobs run in forked worker processes, which may not
  use the parent's CUDA context: a pipeline holding a stage bound to a CUDA
  device (``BNFExtractor(device="cuda")``) raises ``ValueError`` naming the
  stage, before anything is forked.  With ``ncpu=1`` the jobs run inline.
  """

  def __init__(self,
               jobs: Sequence[Any],
               path: str,
               extractor: Pipeline,
               n_cache: int = 120,
               ncpu: int = 1,
               override: bool = False,
               identifier: str = "name",
               log_path: Optional[str] = None,
               stop_on_failure: bool = False):
    on_card = _stages_on_card(extractor)
    if int(ncpu) > 1 and on_card:
      raise ValueError(
          f"FeatureProcessor(ncpu={ncpu}) would fork workers that cannot use "
          f"the parent's CUDA context, but stage(s) {on_card} run on a CUDA "
          "device; use ncpu=1 or put those stages on the CPU")
    self.jobs = list(jobs)
    self.path = str(path)
    self.extractor = extractor
    self.n_cache = int(n_cache)
    self.ncpu = int(ncpu)
    self.identifier = identifier
    self.stop_on_failure = bool(stop_on_failure)
    self.log_path = log_path or os.path.join(self.path, "log.txt")
    if override and os.path.exists(self.path):
      import shutil
      shutil.rmtree(self.path)
    os.makedirs(self.path, exist_ok=True)

  def run(self) -> Dataset:
    """Process all jobs; returns the output Dataset folder."""
    writers: Dict[str, MmapArrayWriter] = {}
    indices: Dict[str, MmapDict] = {}
    sum1: Dict[str, np.ndarray] = {}
    sum2: Dict[str, np.ndarray] = {}
    errors: List[str] = []
    counters = defaultdict(int)

    def _map(batch_jobs):
      # generator: one (status, result) per job, streamed back by MPI
      for job in batch_jobs:
        try:
          feat = self.extractor.transform(job)
          yield ("ok", feat)
        except ExtractorSignal as e:
          yield (e.action, f"{e.extractor}: {e.message}")
        except Exception:
          yield ("error", traceback.format_exc())

    mpi = MPI(jobs=self.jobs, func=_map, ncpu=self.ncpu, batch=1)
    for status, result in mpi:
      if status != "ok":
        errors.append(str(result))
        if status == "error" and self.stop_on_failure:
          raise RuntimeError(result)
        continue
      feat: Dict[str, Any] = result
      name = str(feat.get(self.identifier, counters["_n"]))
      counters["_n"] += 1
      for key, value in feat.items():
        if not isinstance(value, np.ndarray) or value.ndim == 0:
          continue
        if value.dtype == bool:
          value = value.astype("uint8")
        if value.ndim == 1:
          value = value[:, None]
        if key not in writers:
          writers[key] = MmapArrayWriter(
              os.path.join(self.path, key),
              shape=(0,) + value.shape[1:], dtype=value.dtype.name)
          indices[key] = MmapDict(os.path.join(self.path, f"indices_{key}"))
        w = writers[key]
        start = w.n_rows
        w.write(value)
        indices[key][name] = (start, w.n_rows)
        if value.dtype.kind == "f":
          s1 = value.sum(axis=0)
          s2 = (value.astype(np.float64) ** 2).sum(axis=0)
          if key in sum1:
            sum1[key] += s1
            sum2[key] += s2
          else:
            sum1[key] = s1.astype(np.float64)
            sum2[key] = s2
    # finalize
    ds = Dataset(self.path)
    for key, w in writers.items():
      w.close()
      indices[key].close()
    for key in sum1:
      np.save(os.path.join(self.path, f"{key}_sum1.npy"), sum1[key])
      np.save(os.path.join(self.path, f"{key}_sum2.npy"), sum2[key])
    with open(self.log_path, "w") as f:
      f.write(f"jobs: {len(self.jobs)}\nprocessed: {counters['_n']}\n"
              f"errors: {len(errors)}\n\n")
      f.write("\n".join(errors))
    ds._scan()
    return ds


def batch_speech_features(utterances: Sequence[np.ndarray],
                          config=None,
                          batch_size: int = 64,
                          features: Sequence[str] = ("mspec", "mfcc", "vad"),
                          pad_to: Optional[int] = None,
                          transfer_dtype: Optional[Any] = None,
                          device: Union[str, torch.device] = "cuda"
                          ) -> List[Dict[str, np.ndarray]]:
  """Pad utterances into fixed-shape batches, run the fused pipeline once
  per batch on `device`, and strip the padding from each utterance.

  Raw-transfer policy: when every utterance is int16 PCM (or uint8 G.711
  mu-law codewords), the batch crosses to the device in that dtype and is
  rescaled or expanded there, 2x (4x for mu-law) fewer bytes than float32.
  ``transfer_dtype=np.float32`` forces the host-side conversion and
  ``np.int16`` forces raw PCM for float inputs.  On the card the host batch
  is pinned, so the copy is a DMA that does not stage through pageable
  memory.

  Every feature of ``speech_features`` may be asked for, as in the JAX
  package.  The log-mel core runs through K1 unless ``"spec"`` is in
  ``features``: the power spectrum never leaves K1, so then the batch
  takes ``speech_features(use_pallas=False)``, the plain matmul DFT, which
  returns it.  The caller's ``features`` make that choice; nothing falls
  back.
  """
  from odin_tpu_torch.ops.features import (FeatureConfig, speech_features,
                                           ulaw_expand_device)
  config = config or FeatureConfig()
  device = resolve_device(device)
  out: List[Dict[str, np.ndarray]] = []
  if pad_to is None:
    pad_to = max(len(u) for u in utterances)
  if transfer_dtype is None:
    dtypes = {np.asarray(u).dtype for u in utterances}
    transfer_dtype = dtypes.pop() if len(dtypes) == 1 and dtypes.issubset(
        {np.dtype(np.int16), np.dtype(np.uint8)}) else np.float32
  transfer_dtype = np.dtype(transfer_dtype)
  # mu-law code 0xFF decodes to exactly 0: the right pad value
  pad_value = 0xFF if transfer_dtype == np.uint8 else 0
  for i in range(0, len(utterances), batch_size):
    chunk = utterances[i:i + batch_size]
    lengths = np.array([min(len(u), pad_to) for u in chunk], np.int64)
    batch = np.full((len(chunk), pad_to), pad_value, transfer_dtype)
    for j, u in enumerate(chunk):
      u = np.asarray(u)[:pad_to]
      if u.dtype != transfer_dtype:
        if transfer_dtype == np.uint8:
          raise ValueError("uint8 (mu-law) transfer requires every "
                           "utterance to already hold G.711 codewords")
        if transfer_dtype == np.int16:
          u = np.clip(u * 32768.0, -32768, 32767).astype(np.int16)
        elif u.dtype == np.int16:
          u = u.astype(np.float32) * (1.0 / 32768.0)
        elif u.dtype == np.uint8:
          u = ulaw_expand_device(torch.from_numpy(u)).numpy()
        else:
          u = u.astype(transfer_dtype)
      batch[j, :lengths[j]] = u
    y = torch.from_numpy(batch)
    if device.type == "cuda":
      y = y.pin_memory().to(device, non_blocking=True)
    res = speech_features(y, config, lengths=torch.from_numpy(lengths),
                          device=device, use_pallas="spec" not in features)
    res = {k: v.cpu().numpy() for k, v in res.items()
           if k in features or k == "frame_mask"}
    for j in range(len(chunk)):
      n = int(res["frame_mask"][j].sum())
      out.append({k: v[j][:n] for k, v in res.items() if k != "frame_mask"})
  return out


class DeviceCorpusProcessor:
  """Corpus feature extraction on `device` into the on-disk feature store.

  Files are decoded on the host to raw int16 PCM (``.wav``) or uint8 G.711
  mu-law codewords (``.sph``); a ``(name, array)`` pair passes through.
  They are padded into batches in their raw dtype (mu-law pads with 0xFF,
  which decodes to 0), copied to the device, rescaled or expanded there
  and run through ``speech_features`` (K1 unless ``"spec"`` is asked for).
  The valid frames of each feature are gathered on the device with one
  index, copied back, and appended to the feature's ``MmapArray`` in one
  write per batch, with the (start, end) rows of each utterance in its
  ``indices_<feat>`` ``MmapDict`` and float64 ``sum1``/``sum2``.
  ``transfer_dtype="float16"`` casts the float features on the device
  before the copy back; the host casts them to float32 before the store.

  On the card the host's work on batch k+1 overlaps the device's work on
  batch k: each batch is padded into a pinned buffer, copied in and out
  with non-blocking copies into pinned host buffers, and followed by one
  CUDA event; at most `pipeline_depth` batches are in flight, and a batch's
  outputs (and its input buffer) are touched only after its event has
  fired.  ``ds.attrs`` holds ``frames``, ``wallclock_sec``,
  ``frames_per_sec`` and ``phase_sec``, the wall clock split into
  ``decode``, ``pad``, ``dispatch``, ``device_wait`` (the wait on a batch's
  event, and the float16 cast back) and ``write``.
  """

  def __init__(self,
               files: Sequence[Any],
               path: str,
               config=None,
               features: Sequence[str] = ("mspec", "mfcc_cmvn", "vad"),
               batch_size: int = 64,
               pad_seconds: Optional[float] = None,
               reader: Optional[Callable] = None,
               override: bool = False,
               pipeline_depth: int = 3,
               transfer_dtype: Optional[str] = None,
               device: Union[str, torch.device] = "cuda"):
    from odin_tpu_torch.ops.features import FeatureConfig
    self.files = list(files)
    self.path = str(path)
    self.config = config or FeatureConfig()
    self.features = tuple(features)
    self.batch_size = int(batch_size)
    self.pad_seconds = pad_seconds
    self.reader = reader
    self.pipeline_depth = int(pipeline_depth)
    if self.pipeline_depth < 1:
      raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    self.transfer_dtype = transfer_dtype
    self.device = resolve_device(device)
    if override and os.path.exists(self.path):
      import shutil
      shutil.rmtree(self.path)
    os.makedirs(self.path, exist_ok=True)

  def _read(self, f):
    """-> (name, samples int16/uint8/float32), by the file's extension:
    .sph gives raw mu-law codewords, anything else is read as wav (int16)."""
    if self.reader is not None:
      return self.reader(f)
    from odin_tpu_torch.preprocessing.speech import read_sphere, read_wave_raw
    name = os.path.basename(f) if isinstance(f, str) else str(f[0])
    if not isinstance(f, str):
      return name, np.asarray(f[1])
    if f.lower().endswith(".sph"):
      y, _ = read_sphere(f, raw=True)
    else:
      y, _ = read_wave_raw(f)
    return name, y

  def _host_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor, pinned where the device is a card."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=self.device.type == "cuda")

  def _to_device(self, array: np.ndarray, held: List[torch.Tensor]
                 ) -> torch.Tensor:
    """`array` on the device: on the card through a pinned buffer, kept in
    `held` until the batch's event has fired, and a non-blocking copy."""
    host = torch.from_numpy(array)
    if self.device.type != "cuda":
      return host
    host = host.pin_memory()
    held.append(host)
    return host.to(self.device, non_blocking=True)

  def run(self, verbose: bool = False) -> Dataset:
    from odin_tpu_torch.ops.features import speech_features

    cfg = self.config
    device = self.device
    on_card = device.type == "cuda"
    writers: Dict[str, MmapArrayWriter] = {}
    indices: Dict[str, MmapDict] = {}
    sum1: Dict[str, np.ndarray] = {}
    sum2: Dict[str, np.ndarray] = {}
    phase = dict(decode=0.0, pad=0.0, dispatch=0.0, device_wait=0.0,
                 write=0.0)
    tdt = (torch.from_numpy(np.empty(0, np.dtype(self.transfer_dtype))).dtype
           if self.transfer_dtype else None)
    use_pallas = "spec" not in self.features

    def _dispatch(names, batch, lengths):
      """Launch one batch; returns its entry of the in-flight queue."""
      F = cfg.n_frames(int(batch.shape[1]))
      counts = np.clip(cfg.n_frames(lengths), 0, F).astype(np.int64)
      # the valid frames are a prefix of each row: their flat positions
      rows = np.repeat(np.arange(len(counts)) * F, counts)
      rows += np.arange(int(counts.sum())) - np.repeat(
          np.cumsum(counts) - counts, counts)
      held: List[torch.Tensor] = [batch]
      y = batch.to(device, non_blocking=True) if on_card else batch
      res = speech_features(y, cfg, lengths=self._to_device(lengths, held),
                            device=device, use_pallas=use_pallas)
      rows = self._to_device(rows, held)
      out = {}
      for key in self.features:
        v = res[key]
        flat = v.reshape((-1,) + tuple(v.shape[2:])).index_select(0, rows)
        if tdt is not None and flat.dtype == torch.float32:
          flat = flat.to(tdt)
        if on_card:
          host = self._host_buffer(flat.shape, flat.dtype)
          host.copy_(flat, non_blocking=True)
          flat = host
        out[key] = flat
      event = None
      if on_card:
        event = torch.cuda.Event()
        event.record()
      return names, counts, out, event, held

    def _drain(entry):
      names, counts, res, event, _ = entry
      t1 = time.perf_counter()
      if event is not None:
        event.synchronize()
      res = {k: v.numpy() for k, v in res.items()}
      if tdt is not None:
        res = {k: (v.astype(np.float32) if v.dtype == np.dtype(
            self.transfer_dtype) else v) for k, v in res.items()}
      phase["device_wait"] += time.perf_counter() - t1
      t1 = time.perf_counter()
      ends = np.cumsum(counts)
      starts = ends - counts
      for key, flat in res.items():
        if flat.dtype == bool:
          flat = flat.astype("uint8")
        if flat.ndim == 1:
          flat = flat[:, None]
        if key not in writers:
          writers[key] = MmapArrayWriter(
              os.path.join(self.path, key),
              shape=(0,) + flat.shape[1:], dtype=flat.dtype.name)
          indices[key] = MmapDict(os.path.join(self.path,
                                               f"indices_{key}"))
        w = writers[key]
        base = w.n_rows
        w.write(flat)
        idx = indices[key]
        for j, name in enumerate(names):
          idx[name] = (base + int(starts[j]), base + int(ends[j]))
        if flat.dtype.kind == "f":
          s1 = flat.sum(axis=0, dtype=np.float64)
          s2 = (flat.astype(np.float64) ** 2).sum(axis=0)
          if key in sum1:
            sum1[key] += s1
            sum2[key] += s2
          else:
            sum1[key] = s1
            sum2[key] = s2
      phase["write"] += time.perf_counter() - t1

    t0 = time.perf_counter()
    pending: List[Any] = []
    total_frames = 0
    pad_to = (int(self.pad_seconds * cfg.sr) if self.pad_seconds else None)
    for i in range(0, len(self.files), self.batch_size):
      t1 = time.perf_counter()
      chunk = [self._read(f) for f in self.files[i:i + self.batch_size]]
      phase["decode"] += time.perf_counter() - t1
      t1 = time.perf_counter()
      names = [c[0] for c in chunk]
      ys = [c[1] for c in chunk]
      T = pad_to or max(len(y) for y in ys)
      dt = ys[0].dtype if all(y.dtype == ys[0].dtype for y in ys) \
          else np.dtype(np.float32)
      pad_value = 0xFF if dt == np.uint8 else 0  # mu-law 0xFF decodes to 0
      # padded straight into the (pinned) buffer that is copied in
      buffer = self._host_buffer((len(ys), T),
                                 torch.from_numpy(np.empty(0, dt)).dtype)
      batch = buffer.numpy()
      batch.fill(pad_value)
      lengths = np.empty(len(ys), np.int64)
      for j, y in enumerate(ys):
        y = y[:T]
        lengths[j] = len(y)
        batch[j, :len(y)] = y if y.dtype == dt else y.astype(dt)
      total_frames += int(np.sum(cfg.n_frames(lengths)))
      phase["pad"] += time.perf_counter() - t1
      t1 = time.perf_counter()
      pending.append(_dispatch(names, buffer, lengths))
      phase["dispatch"] += time.perf_counter() - t1
      if len(pending) >= self.pipeline_depth:
        _drain(pending.pop(0))
      if verbose and (i // self.batch_size) % 20 == 0:
        rate = total_frames / max(time.perf_counter() - t0, 1e-9)
        print(f"[DeviceCorpusProcessor] {i + len(names)}/{len(self.files)} "
              f"files, {rate / 1e6:.2f}M frames/s sustained", flush=True)
    while pending:
      _drain(pending.pop(0))
    wall = time.perf_counter() - t0

    ds = Dataset(self.path)
    for key, w in writers.items():
      w.close()
      indices[key].close()
    for key in sum1:
      np.save(os.path.join(self.path, f"{key}_sum1.npy"), sum1[key])
      np.save(os.path.join(self.path, f"{key}_sum2.npy"), sum2[key])
    with open(os.path.join(self.path, "log.txt"), "w") as f:
      f.write(f"files: {len(self.files)}\nframes: {total_frames}\n"
              f"wallclock_sec: {wall:.1f}\n"
              f"frames_per_sec: {total_frames / max(wall, 1e-9):.0f}\n"
              f"phase_sec: {({k: round(v, 2) for k, v in phase.items()})}\n")
    ds._scan()
    ds.attrs = dict(frames=total_frames, wallclock_sec=wall,
                    frames_per_sec=total_frames / max(wall, 1e-9),
                    phase_sec=dict(phase))
    return ds

def validate_features(dataset: Union[str, Dataset],
                      feat_name: str = "mspec") -> Dict[str, Any]:
  """A report over a processed corpus: NaN/inf counts over the first
  100,000 rows and per-utterance length statistics."""
  if isinstance(dataset, str):
    dataset = Dataset(dataset)
  arr = dataset[feat_name]
  idx = dataset[f"indices_{feat_name}"]
  lengths = [end - start for start, end in idx.values()]
  sample = np.asarray(arr[:min(len(arr), 100000)])
  return dict(
      n_utterances=len(idx),
      n_frames=int(arr.shape[0]),
      feat_dim=tuple(arr.shape[1:]),
      n_nan=int(np.isnan(sample).sum()),
      n_inf=int(np.isinf(sample).sum()),
      length_min=int(np.min(lengths)) if lengths else 0,
      length_max=int(np.max(lengths)) if lengths else 0,
      length_mean=float(np.mean(lengths)) if lengths else 0.0,
  )


class IncrementalPCA(_IncrementalPCA):
  """The port's incremental PCA (``ml.decompositions.IncrementalPCA``,
  scikit-learn's ``IncrementalPCA.partial_fit`` on a torch device: the
  running mean and variance in float64, the SVD of the previous components
  scaled by their singular values stacked over the centred batch and the
  mean-correction row, ``svd_flip``'s signs) with its fitted attributes
  kept as numpy arrays between batches, so that ``calculate_pca`` pickles
  no device tensor: ``components_``, ``singular_values_``,
  ``explained_variance_``, ``explained_variance_ratio_``, ``mean_`` and
  ``var_`` with scikit-learn's dtypes (float32 data gives float32 factors
  from the first batch, float64 from a later one, whose stacked matrix
  holds the float64 mean correction), ``noise_variance_`` a float.
  """

  _ARRAYS = ("components_", "singular_values_", "explained_variance_",
             "explained_variance_ratio_", "mean_", "var_")

  def __init__(self, n_components: int,
               device: Union[str, torch.device] = "cuda"):
    super().__init__(n_components=int(n_components),
                     device=resolve_device(device))

  def partial_fit(self, X) -> "IncrementalPCA":
    """Update the fit with one (n_samples, n_features) batch."""
    for name in self._ARRAYS:
      value = getattr(self, name)
      if isinstance(value, np.ndarray):
        setattr(self, name, torch.from_numpy(value).to(self.device))
    # a copy: X may be a read-only memmap
    super().partial_fit(torch.tensor(np.asarray(X)).to(self.device))
    for name in self._ARRAYS:
      setattr(self, name, getattr(self, name).cpu().numpy())
    self.noise_variance_ = float(self.noise_variance_)
    return self

  def transform(self, X) -> np.ndarray:
    """Project (n, n_features) rows onto the components, in float64."""
    x = torch.as_tensor(np.asarray(X), dtype=torch.float64).to(self.device)
    comps = torch.from_numpy(self.components_).to(self.device,
                                                  torch.float64)
    mean = torch.from_numpy(self.mean_).to(self.device, torch.float64)
    return ((x - mean) @ comps.T).cpu().numpy()


def calculate_pca(dataset: Union[str, Dataset], feat_name: str = "mspec",
                  n_components: int = 20, batch_size: int = 8192,
                  device: Union[str, torch.device] = "cuda"
                  ) -> IncrementalPCA:
  """Incremental PCA over a stored feature on `device`, in chunks of
  `batch_size` rows (a last chunk shorter than `n_components` is skipped),
  pickled to ``<feat_name>_pca.pkl`` in the store."""
  if isinstance(dataset, str):
    dataset = Dataset(dataset)
  arr = dataset[feat_name]
  n_components = min(n_components, arr.shape[1])
  batch_size = max(batch_size, 2 * n_components)
  pca = IncrementalPCA(n_components=n_components, device=device)
  for i in range(0, arr.shape[0], batch_size):
    chunk = np.asarray(arr[i:i + batch_size])
    if len(chunk) >= n_components:
      pca.partial_fit(chunk)
  with open(os.path.join(dataset.path, f"{feat_name}_pca.pkl"), "wb") as f:
    pickle.dump(pca, f)
  return pca
