"""Host-side preprocessing of the port: DSP bases, audio readers and
corpus extraction."""
from odin_tpu_torch.preprocessing.processor import (DeviceCorpusProcessor,
                                                    IncrementalPCA,
                                                    batch_speech_features,
                                                    calculate_pca,
                                                    validate_features)
from odin_tpu_torch.preprocessing.speech import (read, read_pcm, read_sphere,
                                                 read_wave, read_wave_raw,
                                                 save_wave)
