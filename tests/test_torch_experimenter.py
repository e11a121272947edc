"""The experiment sweep and the scoreboard of the port
(``training/experimenter.py``, ``training/scores.py``) against the JAX
package's on the CPU: ``parse_config``, ``hash_config`` and
``get_output_dir`` give the same values; ``run_hydra`` runs the same sweep
points in the same output directories, with ``--reset``; ``-j2`` forks
(in a child Python, which imports no JAX: a fork inside a test process
that has imported JAX may deadlock) and refuses, before it forks, where
this process has started CUDA; a ``ScoreBoard`` written by one package
reads back in the other."""
import os
import subprocess
import sys

import pytest
import torch

import odin_tpu.training.experimenter as jax_exp
from odin_tpu.training.scores import ScoreBoard as JaxScoreBoard
from odin_tpu_torch.training import (ScoreBoard, get_output_dir, hash_config,
                                     parse_config, run_hydra)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = [{}, {"vae": "betavae"}, {"vae": "betatcvae", "zdim": 10},
             {"lr": 1e-3, "beta": 4.0, "ds": "shapes3d", "flag": True},
             {"a_rather_long_key_name": "value" * 12, "b": None},
             {"x": [1, 2], "y": "two words"}]


@pytest.mark.parametrize("ov", OVERRIDES)
def test_hash_and_output_dir_equal_jax(ov):
  assert hash_config(ov) == jax_exp.hash_config(ov)
  assert hash_config(ov, exclude=("vae",)) == \
      jax_exp.hash_config(ov, exclude=("vae",))
  assert get_output_dir("/r", ov) == jax_exp.get_output_dir("/r", ov)


def test_parse_config_equals_jax(tmp_path):
  text = "lr: 1e-3\nbeta: 4\nname: vae  # a comment\nflag: false\nz: null\n"
  path = tmp_path / "c.yaml"
  path.write_text(text)
  for config in (None, {"a": 1}, text, str(path), "x: 3\ny: true"):
    assert parse_config(config) == jax_exp.parse_config(config)
  assert parse_config("x: 3\ny: true") == {"x": 3, "y": True}


def _task(cfg):
  with open(os.path.join(cfg.output_dir, "ran.txt"), "a") as f:
    f.write(f"{cfg.vae},{cfg.zdim}\n")
  return (cfg.vae, cfg.zdim, os.path.basename(cfg.output_dir))


def test_sweep_equals_jax(tmp_path):
  argv = ["vae=betavae,betatcvae", "zdim=4,10", "ds=shapes3d"]
  config = {"zdim": 2, "lr": 1e-3}
  ours = run_hydra(output_dir=str(tmp_path / "port"), config=config)(_task)
  theirs = jax_exp.run_hydra(output_dir=str(tmp_path / "jax"),
                             config=config)(_task)
  got, want = ours(argv), theirs(argv)
  assert got == want and len(got) == 4
  assert sorted(os.listdir(tmp_path / "port")) == \
      sorted(os.listdir(tmp_path / "jax"))
  # --reset wipes each point's directory before it runs again
  marker = tmp_path / "port" / got[0][2] / "ran.txt"
  assert marker.read_text().count("\n") == 1
  ours(argv)
  assert marker.read_text().count("\n") == 2
  ours(argv + ["--reset"])
  assert marker.read_text().count("\n") == 1
  # one point: its result alone; `extra` keywords override
  assert ours(["vae=betavae"], zdim=3) == theirs(["vae=betavae"], zdim=3)


FORKED_SWEEP = """
import os, sys
from odin_tpu_torch.training import run_hydra

def task(cfg):
  with open(os.path.join(cfg.output_dir, "ran.txt"), "w") as f:
    f.write(str(os.getpid()))
  return (cfg.lr, cfg.beta)

out = run_hydra(output_dir=sys.argv[1])(task)(
    ["lr=0.1,0.01", "beta=1,4", "-j2"])
assert sorted(out) == [(0.01, 1), (0.01, 4), (0.1, 1), (0.1, 4)], out
pids = {open(os.path.join(sys.argv[1], d, "ran.txt")).read()
        for d in os.listdir(sys.argv[1])}
assert str(os.getpid()) not in pids and len(os.listdir(sys.argv[1])) == 4
assert not any(m.split(".")[0] in ("jax", "odin_tpu") for m in sys.modules)
print("forked", len(pids))
"""


def test_parallel_sweep_forks(tmp_path):
  res = subprocess.run([sys.executable, "-c", FORKED_SWEEP, str(tmp_path)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
  assert res.returncode == 0, res.stderr
  assert res.stdout.startswith("forked")


def test_parallel_sweep_refuses_after_cuda_started(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
  main = run_hydra(output_dir=str(tmp_path / "out"))(_task)
  with pytest.raises(ValueError, match="CUDA"):
    main(["vae=a,b", "zdim=1", "-j2"])
  assert not os.path.exists(tmp_path / "out")  # nothing ran, nothing forked
  # one job, or one point, forks nothing and runs
  assert len(main(["vae=a,b", "zdim=1", "-j1"])) == 2
  assert main(["vae=a", "zdim=1", "-j2"])[0] == "a"


def test_scoreboard_shared_with_jax(tmp_path):
  path = str(tmp_path / "scores.db")
  ours = ScoreBoard(path)
  ours.write("sweep", unique=["vae", "ds"], vae="betavae", ds="shapes3d",
             mig=0.1, steps=300, ok=True, extra={"k": [1, 2]})
  theirs = JaxScoreBoard(path)
  theirs.write("sweep", unique=["vae", "ds"], vae="betavae", ds="shapes3d",
               mig=0.3, steps=300, ok=True, extra={"k": [1, 2]})
  theirs.write("sweep", vae="betatcvae", ds="shapes3d", mig=0.2, sap=0.05)
  ours.write("sweep", unique="vae", replace=False, vae="betatcvae", mig=9.0)
  for board in (ours, theirs):
    rows = board.select("sweep", order_by="mig")
    assert [(r["vae"], r["mig"]) for r in rows] == [("betatcvae", 0.2),
                                                    ("betavae", 0.3)]
    assert rows[1]["extra"] == '{"k": [1, 2]}' and rows[1]["ok"] == 1
    assert rows[0]["sap"] == 0.05 and rows[1]["sap"] is None
    assert board.select("sweep", where={"vae": "betavae"})[0]["steps"] == 300
    assert board.select("missing") == [] and "sweep" in board.tables()
  ours.close()
  theirs.close()
