"""The port's extractor pipeline (``preprocessing/base.py``, the stages of
``preprocessing/speech.py``, ``preprocessing/audio.py``) against the JAX
package's on the CPU.

The stages are host NumPy copies, so the same numpy inputs (synthetic
speech made from a seed, as tests/test_preprocessing.py makes it) give
equal feature dicts bit for bit, ``SADgmm``'s carried EM included.  The
checks of tests/test_preprocessing.py on the pipeline, the SAD stages, the
delta stage, sphere/PCM ingest and ``audio_segmenter`` are repeated on the
port.
"""
import os

import numpy as np
import pytest

import odin_tpu.preprocessing as J
import odin_tpu_torch.preprocessing as P
from torch_speech_common import (SR, assert_same, standard_pipeline,
                                 synth_speech, write_wav)


def _feat(seed=0, n=SR):
  """A feature dict after the STFT stage (raw, sr, stft, energy)."""
  y = synth_speech(n, seed=seed)
  return J.make_pipeline([J.AudioReader(sr=SR), J.STFTExtractor()]
                         ).transform({"raw": y, "sr": SR})


def _mfcc_feat(seed=0):
  f = _feat(seed)
  f = J.PowerSpecExtractor().transform(f)
  f = J.MelsSpecExtractor().transform(f)
  f = J.MFCCsExtractor().transform(f)
  return J.SADgmm().transform(f)


# (stage name, constructor kwargs, input builder)
STAGES = [
    ("AudioReader", {"sr": SR}, lambda: synth_speech(seed=1)),
    ("AudioReader", {"sr": SR, "sr_new": 8000, "remove_dc": False},
     lambda: {"raw": synth_speech(seed=2), "sr": SR, "name": "u"}),
    ("AudioReader", {}, lambda: (np.stack([synth_speech(seed=3)] * 2, -1),
                                 SR)),
    ("Dithering", {}, lambda: {"raw": synth_speech()}),
    ("Dithering", {"dither": 3.0, "seed": 2}, lambda: {"raw": synth_speech()}),
    ("PreEmphasis", {}, lambda: {"raw": synth_speech()}),
    ("Framing", {}, lambda: {"raw": synth_speech(), "sr": SR}),
    ("Framing", {"frame_length": 256, "step_length": 100, "end": "pad"},
     lambda: {"raw": synth_speech(), "sr": SR}),
    ("CalculateEnergy", {}, lambda: J.Framing().transform(
        {"raw": synth_speech(), "sr": SR})),
    ("CalculateEnergy", {"log": False}, lambda: J.Framing().transform(
        {"raw": synth_speech(), "sr": SR})),
    ("STFTExtractor", {}, lambda: {"raw": synth_speech(), "sr": SR}),
    ("STFTExtractor", {"frame_length": 512, "step_length": 128, "n_fft": 1024,
                       "window": "hann", "padding": True, "energy": False},
     lambda: {"raw": synth_speech(), "sr": SR}),
    ("PowerSpecExtractor", {}, _feat),
    ("PowerSpecExtractor", {"power": 1.0, "output_name": "mag"}, _feat),
    ("MelsSpecExtractor", {}, lambda: J.PowerSpecExtractor().transform(
        _feat())),
    ("MelsSpecExtractor", {"n_mels": 80, "fmin": 0.0, "fmax": 7600.0,
                           "top_db": 60.0},
     lambda: J.PowerSpecExtractor().transform(_feat())),
    ("MFCCsExtractor", {}, lambda: J.MelsSpecExtractor().transform(
        J.PowerSpecExtractor().transform(_feat()))),
    ("MFCCsExtractor", {"n_ceps": 13, "remove_first_coef": False,
                        "first_coefficient_energy": True},
     lambda: J.MelsSpecExtractor().transform(
         J.PowerSpecExtractor().transform(_feat()))),
    ("Power2Db", {}, lambda: J.PowerSpecExtractor().transform(_feat())),
    ("SpectraExtractor", {}, lambda: {"raw": synth_speech(), "sr": SR}),
    ("SpectraExtractor", {"n_mels": 24, "n_ceps": 13, "log": False,
                          "power": 1.0},
     lambda: {"raw": synth_speech(), "sr": SR}),
    ("SADthreshold", {}, _feat),
    ("SADthreshold", {"energy_threshold": 0.2, "context": 5}, _feat),
    ("SADgmm", {}, _feat),
    ("SADgmm", {"nb_mixture": 2, "nb_train_it": 10}, lambda: _feat(3)),
    ("CQTExtractor", {"n_bins": 36, "fmin": 110.0},
     lambda: {"raw": synth_speech(8000), "sr": SR}),
    ("PitchExtractor", {}, lambda: {"raw": synth_speech(), "sr": SR}),
    ("PitchExtractor", {"otype": "f0", "fmin": 80.0},
     lambda: {"raw": synth_speech(seed=4), "sr": SR}),
    ("RASTAfilter", {}, _mfcc_feat),
    ("AcousticNorm", {}, _mfcc_feat),
    ("AcousticNorm", {"windowed_mean_var_norm": True, "win_length": 31,
                      "var_norm": False}, _mfcc_feat),
    ("AcousticNorm", {"mean_var_norm": False, "windowed_mean_var_norm": True,
                      "win_length": 21, "sad_name": None}, _mfcc_feat),
    ("ApplyingSAD", {}, _mfcc_feat),
    ("AudioAugmentor", {}, lambda: {"raw": synth_speech(4000), "sr": SR}),
    ("AudioAugmentor", {"allow_speedandpitch": False, "allow_pitch": False,
                        "seed": 3},
     lambda: {"raw": synth_speech(4000, seed=1), "sr": SR}),
]


@pytest.mark.parametrize("name,kwargs,make", STAGES,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(STAGES)])
def test_stage_matches_jax(name, kwargs, make):
  x = make()
  assert_same(getattr(P, name)(**kwargs).transform(x),
              getattr(J, name)(**kwargs).transform(x), name)


GENERIC = [
    (lambda M: M.Converter(lambda m: m * 2, input_name="m",
                           output_name="m2"), {}),
    (lambda M: M.DeltaExtractor(input_name=("m",), order=(0, 1, 2)), {}),
    (lambda M: M.DeltaExtractor(input_name=("m", "e"), width=5, order=(1,)),
     {}),
    (lambda M: M.EqualizeShape0(input_name=("m", "e")), {}),
    (lambda M: M.RunningStatistics(input_name=("m",), prefix="s_"), {}),
    (lambda M: M.AsType("float64", input_name=("m",)), {}),
    (lambda M: M.AsType("float16"), {}),
    (lambda M: M.Duplicate(input_name=("m",), output_name=("m_copy",)), {}),
    (lambda M: M.Rename({"m": "mfcc", "nope": "x"}), {}),
    (lambda M: M.Delete(("e",)), {}),
    (lambda M: M.StackFeatures(input_name=("m",), context=3), {}),
]


@pytest.mark.parametrize("build,_", GENERIC, ids=range(len(GENERIC)))
def test_generic_stage_matches_jax(build, _):
  rng = np.random.RandomState(4)
  x = {"m": rng.randn(50, 8).astype("f"), "e": rng.randn(47, 1).astype("f")}
  assert_same(build(P).transform(x), build(J).transform(x))


def test_pipeline_matches_jax(tmp_path):
  """The standard recipe (with Δ/ΔΔ) from a wav path, in both packages."""
  p = write_wav(str(tmp_path / "a.wav"), synth_speech())
  job = {"path": p, "name": "a"}
  got = standard_pipeline(P, deltas=True).transform(job)
  assert_same(got, standard_pipeline(J, deltas=True).transform(job))
  assert got["mspec"].shape[1] == 24 and got["mfcc"].shape[1] == 60
  assert got["sad"].dtype == bool
  assert abs(got["mfcc"].mean()) < 0.3


def test_pipeline_api(capsys):
  """make_pipeline flattens pipelines and wraps callables; the debug flag
  prints each stage's shapes; a raised ExtractorSignal carries its
  action."""
  inner = P.make_pipeline([P.PreEmphasis()])
  pipe = P.make_pipeline([inner, lambda feat: {"n": len(feat["raw"])}],
                         debug=True)
  assert len(pipe.steps) == 2 and isinstance(pipe.steps[1], P.Converter)
  out = pipe(synth_speech(1000))
  assert out["n"] == 1000
  assert "[PreEmphasis]" in capsys.readouterr().out
  try:
    P.set_extractor_debug(True)
    assert P.make_pipeline([]).debug
  finally:
    P.set_extractor_debug(False)
  assert not P.make_pipeline([]).debug
  with pytest.raises(ValueError):
    P.make_pipeline([3])
  with pytest.raises(P.ExtractorSignal) as err:
    P.AudioReader().transform(synth_speech(100))
  assert err.value.action == "error"
  assert err.value.set_action("warn").action == "warn"


def test_sad_extractors():
  feat = P.make_pipeline([P.AudioReader(sr=SR), P.STFTExtractor(energy=True)]
                         ).transform({"raw": synth_speech(), "sr": SR})
  sad_t = P.SADthreshold().transform(feat)["sad"]
  sad_g = P.SADgmm().transform(feat)["sad"]
  for sad in (sad_t, sad_g):
    assert 0.1 < sad.mean() < 0.95
  applied = P.ApplyingSAD(input_name=("energy",)).transform(
      {**feat, "sad": sad_g})
  assert len(applied["energy"]) == sad_g.sum()


def test_read3colsad(tmp_path):
  path = tmp_path / "sad.txt"
  path.write_text("a 0.05 0.20\na 0.5 9.0\nb 0.0 0.1\nbad line\n")
  feat = {"name": "a", "energy": np.zeros((80, 1), "f")}
  for M in (J, P):
    out = M.Read3ColSAD(str(path)).transform(feat)
    np.testing.assert_array_equal(out["sad"],
                                  J.Read3ColSAD(str(path)).transform(feat)
                                  ["sad"])
  assert P.Read3ColSAD(str(path)).transform(feat)["sad"].sum() == 15 + 30


AUDIO = [
    ("time_stretch", lambda: (synth_speech(4000), 1.2), {"frame_length": 512}),
    ("time_stretch", lambda: (synth_speech(4000), 0.8), {"frame_length": 256,
                                                         "step_length": 32}),
    ("pitch_shift", lambda: (synth_speech(4000), SR, 2.0),
     {"frame_length": 512}),
    ("augment_audio", lambda: (synth_speech(4000), SR),
     {"n_augment": 2, "seed": 5}),
    ("logscale_spec", lambda: (np.abs(J.signal.stft(synth_speech(), 400,
                                                    160, 512)),),
     {"sr": SR, "alpha": 1.2}),
]


@pytest.mark.parametrize("name,args,kwargs", AUDIO,
                         ids=[a[0] for a in AUDIO])
def test_audio_matches_jax(name, args, kwargs):
  a = args()
  assert_same(getattr(P, name)(*a, **kwargs), getattr(J, name)(*a, **kwargs))


def _write_sphere(path, pcm16, sr, coding="pcm", byte_format="01"):
  if coding == "ulaw":
    import audioop
    payload = audioop.lin2ulaw(pcm16.astype("<i2").tobytes(), 2)
    n_bytes = 1
  else:
    payload = pcm16.astype(">i2" if byte_format == "10" else "<i2").tobytes()
    n_bytes = 2
  header = ("NIST_1A\n   1024\n"
            f"sample_rate -i {sr}\nchannel_count -i 1\n"
            f"sample_count -i {len(pcm16)}\nsample_n_bytes -i {n_bytes}\n"
            f"sample_byte_format -s{len(byte_format)} {byte_format}\n"
            f"sample_coding -s{len(coding)} {coding}\nend_head\n")
  with open(path, "wb") as f:
    f.write(header.encode().ljust(1024, b" "))
    f.write(payload)


@pytest.mark.parametrize("kind", ["sph", "sph_be", "pcm", "wav"])
def test_audio_reader_ingest(tmp_path, kind):
  """AudioReader on sphere, headerless PCM and wav paths, in both
  packages."""
  pcm16 = (np.random.RandomState(0).randn(8000) * 3000).astype(np.int16)
  if kind.startswith("sph"):
    p = str(tmp_path / "a.sph")
    _write_sphere(p, pcm16, 8000, byte_format="10" if kind == "sph_be"
                  else "01")
  elif kind == "pcm":
    p = str(tmp_path / "a.pcm")
    pcm16.astype("<i2").tofile(p)
  else:
    p = write_wav(str(tmp_path / "a.wav"), pcm16 / 32768.0, 8000)
  got = P.AudioReader(sr=8000).transform(p)
  assert_same(got, J.AudioReader(sr=8000).transform(p))
  assert got["sr"] == 8000 and np.isfinite(got["raw"]).all()


def test_audio_segmenter(tmp_path):
  """audio_segmenter chunks, manifest and override contract, equal to the
  JAX package's files."""
  sr = 8000
  y = (np.random.RandomState(0).randn(int(5.3 * sr)) * 0.1).astype("f")
  src = str(tmp_path / "utt.wav")
  P.save_wave(src, y, sr)
  out, jout = str(tmp_path / "segs"), str(tmp_path / "jsegs")
  info = P.audio_segmenter(src, out, max_duration=2, sr=sr)
  jinfo = J.audio_segmenter(src, jout, max_duration=2, sr=sr)
  assert open(info).read() == open(jinfo).read()
  rows = [l.split() for l in open(info).read().strip().splitlines()[1:]]
  assert len(rows) == 3
  total = 0
  for i, (seg, origin, s, e) in enumerate(rows):
    assert seg == f"utt.{i}.wav" and origin == "utt.wav"
    assert float(e) - float(s) <= 2.0 + 1e-9
    with open(os.path.join(out, seg), "rb") as f, \
        open(os.path.join(jout, seg), "rb") as g:
      assert f.read() == g.read()
    total += len(P.read_wave(os.path.join(out, seg))[0])
  assert total == len(y)
  before = open(info).read()
  assert P.audio_segmenter(src, out, max_duration=1, sr=sr) == info
  assert open(info).read() == before
  info2 = P.audio_segmenter(src, out, max_duration=1, sr=sr, override=True)
  assert len(open(info2).read().strip().splitlines()) == 1 + 6
