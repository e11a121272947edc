"""Device code of the port: the speech front-end and its CUDA kernel K1."""
from odin_tpu_torch.ops.features import (
    FeatureConfig,
    dft_bases,
    frame_signal,
    speech_features,
    ulaw_expand_device,
)
from odin_tpu_torch.ops.logmel import logmel, logmel_reference
