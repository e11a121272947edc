"""PyTorch port of ``odin_tpu`` for one NVIDIA H100.

The package mirrors ``odin_tpu``'s layout and keeps its public layouts (NHWC
images, (B, T) audio, (B, n_frames, n_mels) features).  It imports torch and
numpy (and scipy for window lookup), never JAX and nothing of ``odin_tpu``.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel is replaced by its
plain PyTorch version.
"""
from odin_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
