"""Device code of the port: the speech front-end and its CUDA kernel K1,
flash attention and its CUDA kernel K2."""
from odin_tpu_torch.ops.features import (
    FeatureConfig,
    dft_bases,
    frame_signal,
    speech_features,
    ulaw_expand_device,
)
from odin_tpu_torch.ops.flash_attention import (
    dot_product_attention,
    flash_attention,
    flash_attention_fn,
    flash_attention_reference,
    reference_attention,
)
from odin_tpu_torch.ops.logmel import logmel, logmel_reference
