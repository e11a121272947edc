"""Video frame IO of the port (a copy of ``odin_tpu/preprocessing/video.py``,
host NumPy): decode a video into a ``[n_frames, height, width, channels]``
uint8 array and its fps, and encode one, through ``imageio``, imported when
a function runs; where it is missing the functions raise ImportError, as
the JAX package's do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["read", "save"]


def _require_imageio():
  try:
    import imageio
    return imageio
  except ImportError as e:
    raise ImportError("video IO requires the `imageio` package") from e


def read(path: str, boxes: Optional[np.ndarray] = None,
         max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
  """Decode a video file.

  Returns ``(frames, fps)`` with frames ``[n, h, w, c]`` uint8 (grayscale
  videos get an explicit channel axis).  `boxes` optionally crops each frame
  with ``(top, bottom, left, right)`` bounds before stacking.
  """
  imageio = _require_imageio()
  reader = imageio.get_reader(path)
  meta = reader.get_meta_data()
  fps = float(meta.get("fps", 0.0))
  if not fps and meta.get("duration"):  # gif stores ms-per-frame instead
    fps = 1000.0 / float(meta["duration"])
  frames = []
  try:
    for i, frame in enumerate(reader):
      if max_frames is not None and i >= max_frames:
        break
      frame = np.asarray(frame)
      if frame.ndim == 2:
        frame = frame[..., None]
      if boxes is not None:
        t, b, l, r = (int(v) for v in np.asarray(boxes).ravel()[:4])
        frame = frame[t:b, l:r]
      frames.append(frame)
  except RuntimeError:  # some containers mis-report nframes; stop at EOF
    pass
  finally:
    reader.close()
  if not frames:
    raise ValueError(f"no frames decoded from {path}")
  return np.stack(frames, 0), fps


def save(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
  """Encode ``[n, h, w, c]`` uint8 frames to a video file."""
  imageio = _require_imageio()
  frames = np.asarray(frames)
  if frames.dtype != np.uint8:
    frames = np.clip(frames, 0, 255).astype(np.uint8)
  writer = imageio.get_writer(path, fps=float(fps))
  try:
    for frame in frames:
      writer.append_data(frame if frame.shape[-1] > 1 else frame[..., 0])
  finally:
    writer.close()
