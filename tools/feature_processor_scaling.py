"""Time ``FeatureProcessor`` over forked workers against the inline run, on
phase 16's recipe (``chip_smoke.extractor_recipe``), on the host's cores.

  python tools/feature_processor_scaling.py [--files 64] [--ncpu 1 4 1 4]
  OPENBLAS_NUM_THREADS=1 python tools/feature_processor_scaling.py

A corpus of int16 wav files of 4-8 s (``chip_smoke.write_corpus``'s
synthetic speakers, seed 0) is written under ``build/fp_scaling`` unless it
is there.  Each ``--ncpu`` value runs the recipe over the first ``--files``
files into a fresh store and prints one line: the workers, the seconds, the
files/s, and the BLAS thread setting the process was started with (each
forked worker inherits numpy's BLAS thread pool, one thread a core by
default).  Needs no card.
"""
import argparse
import glob
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_corpus(wav_dir, n_files):
  import numpy as np
  from odin_tpu_torch.fuel.audio_data import synth_speaker_corpus
  from odin_tpu_torch.preprocessing.speech import save_wave
  per_speaker = 8
  utts, _ = synth_speaker_corpus(-(-n_files // per_speaker), per_speaker,
                                 seed=0, sr=16000, dur=8.0)
  lengths = np.random.RandomState(0).randint(4 * 16000, 8 * 16000 + 1,
                                             len(utts))
  os.makedirs(wav_dir, exist_ok=True)
  for i, (y, n) in enumerate(zip(utts[:n_files], lengths)):
    save_wave(os.path.join(wav_dir, f"u{i:04d}.wav"), y[:n], 16000)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--files", type=int, default=64)
  parser.add_argument("--ncpu", type=int, nargs="+", default=[1, 4, 1, 4])
  args = parser.parse_args(argv)
  sys.path.insert(0, ROOT)
  import chip_smoke
  from odin_tpu_torch import preprocessing as P
  work = os.path.join(ROOT, "build", "fp_scaling")
  wav_dir = os.path.join(work, "wav")
  files = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))
  if len(files) < args.files:
    shutil.rmtree(wav_dir, ignore_errors=True)
    write_corpus(wav_dir, args.files)
    files = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))
  jobs = [{"path": f, "name": os.path.basename(f)}
          for f in files[:args.files]]
  blas = os.environ.get("OPENBLAS_NUM_THREADS", "unset")
  for ncpu in args.ncpu:
    store = os.path.join(work, "store")
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    P.FeatureProcessor(jobs, store, chip_smoke.extractor_recipe(P),
                       ncpu=ncpu).run()
    wall = time.perf_counter() - t0
    print(f"ncpu={ncpu}: {len(jobs)} files in {wall:.4f} s, "
          f"{len(jobs) / wall:.2f} files/s (host clock; "
          f"OPENBLAS_NUM_THREADS={blas}, {os.cpu_count()} cores)",
          flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
