"""Device code of the port: the speech front-end and its CUDA kernel K1,
the tf.signal path, streaming features, spectrogram inversion, flash
attention and its CUDA kernel K2."""
from odin_tpu_torch.ops.features import (
    FeatureConfig,
    TFCompatConfig,
    dft_bases,
    frame_signal,
    speech_features,
    tf_mel_matrix,
    tf_signal_features,
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
from odin_tpu_torch.ops.inversion import (griffin_lim_device, istft_device,
                                          stft_device)
from odin_tpu_torch.ops.streaming_features import (StreamState, carry_samples,
                                                   streaming_finalize,
                                                   streaming_init,
                                                   streaming_step)
