"""Host-side preprocessing of the port: DSP bases and corpus extraction."""
from odin_tpu_torch.preprocessing.processor import batch_speech_features
