"""Speech and feature preprocessing of the port: the DSP library, the
extractor pipeline and its stages, openSMILE's replacements, Kaldi interop,
``FeatureProcessor`` over forked workers and the device corpus path; the
text, TextGrid, image and video readers."""
from odin_tpu_torch.preprocessing import (audio, kaldi, signal, text,
                                          textgrid, video)
from odin_tpu_torch.preprocessing.audio import (augment_audio, logscale_spec,
                                                pitch_shift, time_stretch)
from odin_tpu_torch.preprocessing.base import (AsType, Converter, Delete,
                                               DeltaExtractor, Duplicate,
                                               EqualizeShape0, Extractor,
                                               ExtractorSignal, Pipeline,
                                               Rename, RunningStatistics,
                                               StackFeatures, make_pipeline,
                                               set_extractor_debug)
from odin_tpu_torch.preprocessing.opensmile import (openSMILEf0,
                                                    openSMILEloudness,
                                                    openSMILEpitch,
                                                    openSMILEsad)
from odin_tpu_torch.preprocessing.processor import (DeviceCorpusProcessor,
                                                    FeatureProcessor,
                                                    IncrementalPCA,
                                                    batch_speech_features,
                                                    calculate_pca,
                                                    validate_features)
from odin_tpu_torch.preprocessing.speech import (
    AcousticNorm, ApplyingSAD, AudioAugmentor, AudioReader, BNFExtractor,
    CalculateEnergy, CQTExtractor, Dithering, Framing, MelsSpecExtractor,
    MFCCsExtractor, PitchExtractor, Power2Db, PowerSpecExtractor, PreEmphasis,
    RASTAfilter, Read3ColSAD, SADgmm, SADthreshold, SpectraExtractor,
    STFTExtractor, audio_segmenter, read, read_pcm, read_sphere, read_wave,
    read_wave_raw, save_wave)
