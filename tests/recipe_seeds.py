"""The recipes of ``examples/grade_membership.py`` and
``examples/topic_model.py`` in both packages on the CPU at several
seeds of the model (its init and its noise; the data fixed): each seed's
figures and their medians, for the JAX package (``jax``) and the port
(``port``).  Grade of Membership: held-out answer accuracy and membership
purity at seeds 0-20; the topic model: test perplexity and the topics'
best-match cosine at seeds 1-21 (the examples' seeds are 0 and 1).  The
figures of one seed spread widely in both packages (a run can fall into a
local optimum that merges two profiles or two topics), and a seed's
initial weights differ between PyTorch versions, so ``chip_smoke.py``
phase 18 holds the card's medians over seeds to the JAX package's.

Run: ``python tests/recipe_seeds.py gom jax port`` or ``... topic jax
port`` (the JAX package's GoM about 4 minutes, its topic model about 2;
the port's topic model about a minute a seed on the CPU).
"""
import contextlib
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SEEDS = tuple(range(21))
TOPIC_SEEDS = tuple(range(1, 22))


def figures(model, answers, members, n_train):
  test = answers[n_train:]
  acc = float(np.mean(np.asarray(model.predict(test)) == test))
  theta = np.asarray(model.transform(test))
  purity = 0.0
  for c in np.unique(theta.argmax(-1)):
    purity += np.max(np.bincount(members[n_train:][theta.argmax(-1) == c],
                                 minlength=3))
  return acc, purity / len(test)


def run(package, seed):
  import chip_smoke
  cfg = chip_smoke.GOM_CONFIG
  answers, members, n_train = chip_smoke.gom_data(np)
  kw = dict(n_questions=cfg["n_questions"], n_answers=cfg["n_answers"],
            n_components=cfg["n_components"], warmup_steps=cfg["warmup"])
  fit = dict(n_steps=cfg["max_iter"], batch_size=chip_smoke.GOM_BATCH,
             learning_rate=cfg["lr"], steps_per_call=100, seed=seed)
  x = answers[:n_train].astype("float32")
  if package == "jax":
    os.environ["JAX_PLATFORMS"] = "cpu"
    from odin_tpu.bay.mixed_membership import GradeMembershipModel
    model = GradeMembershipModel(**kw).build(seed=seed)
    with contextlib.redirect_stdout(io.StringIO()):
      model.fit_device_dataset(x, **fit)
  else:
    from odin_tpu_torch.bay.mixed_membership import GradeMembershipModel
    model = GradeMembershipModel(**kw).build(seed=seed, device="cpu")
    model.fit_device_dataset(x, verbose=False, **fit)
  return figures(model, answers, members, n_train)


def run_topic(package, seed):
  """``examples/topic_model.py``'s recipe with the model built at `seed`:
  (test perplexity, best-match cosine)."""
  import chip_smoke
  cfg = chip_smoke.TOPIC_CONFIG
  if package == "jax":
    os.environ["JAX_PLATFORMS"] = "cpu"
    from odin_tpu.bay.vi import amortizedLDA
    from odin_tpu.fuel import SyntheticBoW
    build = dict(seed=seed)
  else:
    from odin_tpu_torch.bay.vi import amortizedLDA
    from odin_tpu_torch.fuel import SyntheticBoW
    build = dict(seed=seed, device="cpu")
  ds = SyntheticBoW(n_docs=cfg["n_docs"], n_words=cfg["n_words"],
                    n_topics=cfg["n_topics"])
  lda = amortizedLDA(n_words=cfg["n_words"],
                     n_topics=cfg["n_topics"]).build(**build)
  with contextlib.redirect_stdout(io.StringIO()):
    lda.fit(ds.create_dataset("train", batch_size=64, epochs=-1),
            max_iter=cfg["max_iter"], learning_rate=cfg["lr"])
  return chip_smoke.topic_figures(np, lda, ds)


if __name__ == "__main__":
  args = sys.argv[1:]
  recipe = args.pop(0) if args and args[0] in ("gom", "topic") else "gom"
  fn, seeds, names = ((run, SEEDS, ("accuracy", "purity")) if recipe == "gom"
                      else (run_topic, TOPIC_SEEDS,
                            ("perplexity", "topic_match")))
  for package in args or ("jax", "port"):
    rows = [fn(package, s) for s in seeds]
    for s, row in zip(seeds, rows):
      print(f"{recipe} {package} seed {s}: " + ", ".join(
          f"{n} {v:.4f}" for n, v in zip(names, row)), flush=True)
    med = np.median(np.asarray(rows), axis=0)
    print(f"{recipe} {package} median over seeds {seeds}: " + ", ".join(
        f"{n} {v:.4f}" for n, v in zip(names, med)), flush=True)
