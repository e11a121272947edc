"""Every optimizer alias of the port against optax on the CPU.

  * Five updates of each alias (the nine of ``make_optimizer``, Adam with
    ``nesterov`` and with ``mu_dtype=bfloat16``, and the options that
    change an alias's state: masks, momentum, a centered rmsprop), with
    and without a learning-rate schedule and clipping, on the same random
    gradients (a tree with a conv kernel, a matrix and a bias of widely
    different scales): updates and states within rtol 1e-6, atol 1e-7,
    float32 arithmetic from two libraries.  The absolute limit scales with
    a tensor's largest value where that is above 1 (atol 1e-7·max|optax|):
    float32 cannot resolve 1e-7 there (a momentum trace of clipped
    gradients reaches 8, where one ulp is 9.5e-7, and an element near 0
    by cancellation keeps the rounding of its terms).  With clipping the
    absolute limit is 1e-6: the clip factors (each block's RMS, the global
    norm) are sums in another order, 1e-7 apart relative, and sgd's
    momentum trace carries that error of its terms (up to 0.8) into
    elements that cancel to near 0 (2e-7 measured).  lamb's trust ratio is a ratio of
    two norms summed in another order on each side, 1e-7 apart: the same
    limit holds.  A bfloat16 moment is held at one bfloat16 rounding
    (2^-8 relative), since both sides round the same float32 value.
  * One full step of the dSprites beta-VAE per alias against the JAX
    package, by the params rule of tests/torch_training_common.py,
    stated for steps of at most 1e-3: rmsprop runs at lr 1e-3·sqrt(0.1),
    since its first step is up to lr / sqrt(1 - decay).
  * Each alias's state carried JAX -> port -> JAX: exact.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.training.core import make_optimizer as jax_make_optimizer
from odin_tpu_torch.training import exponential_decay, make_optimizer
from odin_tpu_torch.weights import from_jax_state, to_jax_state
from torch_training_common import check_run, make_pair, run_both

torch.set_num_threads(2)

RTOL = 1e-6
ATOL = 1e-7
CLIP_ATOL = 1e-6
BF16_RTOL = 2 ** -8

SHAPES = {"conv": (4, 4, 3, 8), "dense": (16, 5), "bias": (5,)}
# name: (alias, JAX keywords, the port's keywords where they differ)
CASES = {
    "adam": ("adam", {}, None),
    "adam_nesterov": ("adam", dict(nesterov=True), None),
    "adam_mu_bf16": ("adam", dict(mu_dtype=jnp.bfloat16),
                     dict(mu_dtype=torch.bfloat16)),
    "adamw": ("adamw", dict(weight_decay=1e-2), None),
    "adamw_mask": ("adamw", dict(mask={"p": {"conv": True, "dense": False,
                                             "bias": True}}), None),
    "sgd": ("sgd", {}, None),
    "sgd_nesterov_momentum": ("sgd", dict(momentum=0.9, nesterov=True), None),
    "rmsprop": ("rmsprop", {}, None),
    "rmsprop_centered_momentum": (
        "rmsprop", dict(centered=True, momentum=0.8, bias_correction=True,
                        initial_scale=0.1), None),
    "adagrad": ("adagrad", {}, None),
    "adamax": ("adamax", {}, None),
    "lamb": ("lamb", dict(weight_decay=1e-2), None),
    "lion": ("lion", {}, None),
    "nadam": ("nadam", {}, None),
}
CLIP = dict(clipvalue=0.8, clipnorm=0.5, global_clipnorm=2.0)


def _schedules():
  return (optax.exponential_decay(1e-2, 3, 0.5, staircase=True),
          exponential_decay(1e-2, 3, 0.5, staircase=True))


def _np(t):
  return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want, err_msg="", atol=ATOL):
  want = np.asarray(want)
  rtol = BF16_RTOL if want.dtype == jnp.bfloat16 else RTOL
  scale = max(1.0, float(np.abs(want.astype(np.float32)).max()))
  np.testing.assert_allclose(_np(got), want.astype(np.float32), rtol=rtol,
                             atol=atol * scale, err_msg=err_msg)


def _fields(opt_state):
  """{field: value} of every state inside an optax state, the schedule's
  count as the port names it."""
  out = {}
  for part in jax.tree_util.tree_leaves(
      opt_state, is_leaf=lambda n: hasattr(n, "_fields")):
    if not hasattr(part, "_fields"):
      continue
    for f in part._fields:
      name = f
      if type(part).__name__ == "ScaleByScheduleState":
        name = "lr_count"
      if f != "inner_state":
        out[name] = getattr(part, f)
  return out


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("schedule", [False, True], ids=["lr", "schedule"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_alias_matches_optax(case, schedule, clip):
  alias, jkw, kw = CASES[case]
  kw = dict(jkw) if kw is None else kw
  if clip:
    jkw, kw = {**jkw, **CLIP}, {**kw, **CLIP}
  lr_jax, lr = _schedules() if schedule else (1e-2, 1e-2)
  jopt = jax_make_optimizer(alias, lr_jax, **jkw)
  opt = make_optimizer(alias, lr, **kw)
  atol = CLIP_ATOL if clip else ATOL
  rs = np.random.RandomState(0)
  params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
  jstate = jopt.init({"p": params})
  tparams = {"p": {k: torch.from_numpy(v) for k, v in params.items()}}
  state = opt.init(tparams)
  scale = {"conv": 3.0, "dense": 0.01, "bias": 0.5}
  for i in range(5):
    grads = {k: (rs.randn(*s) * scale[k] * (1 + i)).astype(np.float32)
             for k, s in SHAPES.items()}
    grads["bias"][0] = 0.0  # adagrad's and lion's zero branches
    jup, jstate = jopt.update({"p": grads}, jstate, {"p": params})
    up, state = opt.update(
        {"p": {k: torch.from_numpy(v) for k, v in grads.items()}}, state,
        tparams)
    for k in SHAPES:
      _close(up["p"][k], jup["p"][k], f"update {i} {k}", atol)
  want = _fields(jstate)
  assert set(state) == set(want)
  for name, w in want.items():
    if isinstance(w, dict):
      for k in SHAPES:
        _close(state[name]["p"][k], w["p"][k], f"{name} {k}", atol)
        assert state[name]["p"][k].dtype == (
            torch.bfloat16 if np.asarray(w["p"][k]).dtype == jnp.bfloat16
            else torch.float32)
    else:
      assert int(state[name]) == int(w), name


def test_optimizer_keywords_are_optax():
  with pytest.raises(TypeError):
    make_optimizer("sgd", 1e-3, b1=0.9)
  with pytest.raises(ValueError):
    make_optimizer("adamz")


ALIASES = ["adam", "adamw", "sgd", "rmsprop", "adagrad", "adamax", "lamb",
           "lion", "nadam", "adam_mu_bf16"]
STEP_KWARGS = {"sgd": dict(momentum=0.9), "rmsprop": dict(momentum=0.5),
               "adam_mu_bf16": dict(mu_dtype="bfloat16")}
# rmsprop's first step is up to lr / sqrt(1 - decay) = 3.16 lr: at this lr
# it is at most 1e-3, the step that the params rule is stated for
STEP_LR = {"rmsprop": 1e-3 * np.sqrt(0.1)}


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_step_matches_jax(pair, alias):
  """One step of the full-width dSprites beta-VAE, then the state carried
  JAX -> port -> JAX exactly (a bfloat16 moment too)."""
  kw = STEP_KWARGS.get(alias, {})
  mets, js, s = run_both(pair, n_steps=1, lr=STEP_LR.get(alias, 1e-3),
                         optimizer=alias.split("_")[0], **kw)
  check_run(mets, js, s, adam_count=False)
  port = from_jax_state(js, device="cpu")
  assert set(port.opt_states["vae"]) == set(s.opt_states["vae"])
  for name, tree in s.opt_states["vae"].items():
    if isinstance(tree, dict):  # a moment keeps its dtype
      assert {t.dtype for t in port.opt_states["vae"][name]["vae"].values()} \
          == {t.dtype for t in tree["vae"].values()}, name
  back = to_jax_state(port, js)
  flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
  want, got = flat(js), flat(back)
  assert [p for p, _ in want] == [p for p, _ in got]
  for (path, w), (_, g) in zip(want, got):
    w, g = np.asarray(w), np.asarray(g)
    assert w.dtype == g.dtype, path
    np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
