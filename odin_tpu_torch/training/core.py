"""Training-step machinery of the port (PyTorch port of
``odin_tpu/training/core.py``): ``TrainState``, ``TrainStep``, the
optimizer, ``build_train_step_fn``, ``scan_steps`` and
``device_dataset_steps``.

The step keeps the JAX package's pure interface,
``step_fn(state, batch) -> (state, metrics)``: the state is a tree of
tensors and a step returns a new one, leaving its input as it was.

  * Params are ``{partition: {name: tensor}}``, each partition a flat
    ``state_dict`` of a module (``{'vae': {'encoder.layers.1.weight': ...}}``).
    A partition path ``'vae/decoder'`` selects the entries of ``'vae'``
    under ``decoder.``, with the prefix taken off.
  * The optimizer is written as functions on tensors (not
    ``torch.optim``), so that a step with non-finite gradients keeps the
    old params and moments by a select on the device, with no sync.  Its
    arithmetic runs on one flat vector of all the partition's params.
  * Noise: a step draws from the state's ``torch.Generator``, or takes the
    noise itself (``eps``), so that a test can feed the JAX package's draws.
  * On the card, ``scan_steps`` and ``device_dataset_steps`` run k steps
    from a captured CUDA graph of one step over static copies of the
    state, and return copies; on the CPU they are a plain loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["TrainState", "TrainStep", "TrainStepFn", "Optimizer", "Noise",
           "make_optimizer", "exponential_decay", "build_train_step_fn",
           "scan_steps", "device_dataset_steps", "get_param_subtree",
           "set_param_subtree", "extract_partitions", "merge_partitions",
           "use_ema_params", "EMA_KEY"]

EMA_KEY = "__ema__"
_INT32_MAX = 2 ** 31 - 1
Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# state and trees
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainState:
  """Everything a step touches: params, optimizer states, the step count
  and the count of skipped updates (0-d int32 tensors on the params'
  device), and the generator the step's noise is drawn from."""

  params: Tree
  opt_states: Tree
  step: torch.Tensor
  rng: torch.Generator
  mutables: Tree = dataclasses.field(default_factory=dict)
  skipped_updates: Optional[torch.Tensor] = None

  def __post_init__(self):
    if self.skipped_updates is None:
      self.skipped_updates = torch.zeros((), dtype=torch.int32,
                                         device=self.step.device)

  def replace(self, **changes) -> "TrainState":
    return dataclasses.replace(self, **changes)

  @property
  def device(self) -> torch.device:
    return self.step.device


@dataclasses.dataclass
class TrainStep:
  """One optimization stage of a training iteration.

  Attributes:
    loss_fn: ``(params, batch, rng, step, mutables) -> (loss, (metrics,
      mutables))``; `params` is the full params tree, `rng` a ``Noise``.
    partitions: params paths this stage optimizes (``'vae'`` or
      ``'vae/decoder'``).
    optimizer: the optimizer's name; defaults to the first partition.
  """

  loss_fn: Callable
  partitions: Tuple[str, ...] = ("params",)
  optimizer: Optional[str] = None
  name: str = "step"


def _tree_leaves(tree) -> List[torch.Tensor]:
  if isinstance(tree, dict):
    return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
  if isinstance(tree, (list, tuple)):
    return [leaf for v in tree for leaf in _tree_leaves(v)]
  return [tree] if isinstance(tree, torch.Tensor) else []


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _split_path(params: Tree, path: str) -> Tuple[List[str], str]:
  """(dict keys to walk, dotted prefix inside the flat dict reached)."""
  keys = str(path).split("/")
  node, walk = params, []
  while keys and isinstance(node, dict) and keys[0] in node and \
      isinstance(node[keys[0]], dict):
    walk.append(keys[0])
    node = node[keys.pop(0)]
  return walk, ".".join(keys)


def get_param_subtree(params: Tree, path: str) -> Dict[str, torch.Tensor]:
  """The subtree at a '/'-separated path: dict keys first, then a prefix
  of the flat names (``'vae/decoder'`` -> ``{'layers.0.weight': ...}``)."""
  walk, prefix = _split_path(params, path)
  node = params
  for k in walk:
    node = node[k]
  if not prefix:
    return node
  head = prefix + "."
  sub = {k[len(head):]: v for k, v in node.items() if k.startswith(head)}
  if not sub:
    raise KeyError(f"no params under '{path}'")
  return sub


def set_param_subtree(params: Tree, path: str, value) -> Tree:
  """Replace the subtree at `path`, rebuilding only the dicts along the way
  (the input tree is not changed)."""
  walk, prefix = _split_path(params, path)

  def rec(node, i):
    if i == len(walk):
      if not prefix:
        return value
      head = prefix + "."
      return {k: (value[k[len(head):]] if k.startswith(head) else v)
              for k, v in node.items()}
    out = dict(node)
    out[walk[i]] = rec(node[walk[i]], i + 1)
    return out

  return rec(params, 0)


def extract_partitions(params: Tree, partitions: Sequence[str]) -> Tree:
  """{path: subtree} for each partition path."""
  return {p: get_param_subtree(params, p) for p in partitions}


def merge_partitions(params: Tree, sub: Tree) -> Tree:
  """Write each {path: subtree} back into the full params tree."""
  for p, v in sub.items():
    params = set_param_subtree(params, p, v)
  return params


class _FlatSpec:
  """The layout of a ``{partition: {name: tensor}}`` tree as one flat
  vector: ``cat`` gathers a tree of that layout, ``split`` gives a tree of
  views into a flat vector."""

  def __init__(self, tree: Tree):
    self.keys = [(p, k) for p, sub in tree.items() for k in sub]
    self.shapes = [tuple(tree[p][k].shape) for p, k in self.keys]
    self.sizes = [int(np.prod(s)) for s in self.shapes]

  def leaves(self, tree: Tree) -> List[torch.Tensor]:
    return [tree[p][k] for p, k in self.keys]

  def cat(self, leaves) -> torch.Tensor:
    if isinstance(leaves, dict):
      leaves = self.leaves(leaves)
    return torch.cat([t.reshape(-1) for t in leaves])

  def split_list(self, flat: torch.Tensor) -> List[torch.Tensor]:
    return [t.view(s) for t, s in zip(torch.split(flat, self.sizes),
                                      self.shapes)]

  def tree(self, leaves: Sequence[torch.Tensor]) -> Tree:
    out: Tree = {}
    for (p, k), t in zip(self.keys, leaves):
      out.setdefault(p, {})[k] = t
    return out

  def split(self, flat: torch.Tensor) -> Tree:
    return self.tree(self.split_list(flat))


def use_ema_params(state: TrainState) -> TrainState:
  """The state with its params swapped for their exponential moving
  average (the step must have been built with ``ema_decay``)."""
  if EMA_KEY not in state.opt_states:
    raise ValueError("no EMA tracked: build the step fn with ema_decay=...")
  return state.replace(params=state.opt_states[EMA_KEY])


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------
class Noise:
  """Where a step's random draws come from: a ``torch.Generator``, or the
  injected `eps` tensors, handed out in order.  ``rewind`` makes the next
  draws repeat the ones made so far, so that a forward recomputed for the
  backward (``remat``) sees the same noise."""

  def __init__(self, generator: Optional[torch.Generator] = None, eps=None):
    if generator is None and eps is None:
      raise ValueError("Noise needs a generator or eps")
    self.generator = generator
    self._eps = None if eps is None else (
        list(eps) if isinstance(eps, (list, tuple)) else [eps])
    self._drawn: List[torch.Tensor] = []
    self._cursor = 0

  def normal(self, shape, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    shape = tuple(int(i) for i in shape)
    if self._cursor < len(self._drawn):
      out = self._drawn[self._cursor]
    else:
      if self._eps is not None:
        if self._cursor >= len(self._eps):
          raise ValueError(f"the step made more draws than the "
                           f"{len(self._eps)} injected eps")
        out = torch.as_tensor(self._eps[self._cursor]).to(device=device,
                                                          dtype=dtype)
      else:
        out = torch.randn(shape, generator=self.generator, dtype=dtype,
                          device=device)
      self._drawn.append(out)
    if tuple(out.shape) != shape:
      raise ValueError(f"eps has shape {tuple(out.shape)}, the draw needs "
                       f"{shape}")
    self._cursor += 1
    return out

  def rewind(self):
    self._cursor = 0

  def split(self, n: int) -> List["Noise"]:
    """One source for each of `n` microbatches: the generator shared, or
    the injected eps split along their first axis."""
    if self._eps is None:
      return [Noise(self.generator) for _ in range(n)]
    for e in self._eps:
      if e.shape[0] != n:
        raise ValueError(f"eps for {n} microbatches needs a leading axis of "
                         f"{n}, got shape {tuple(e.shape)}")
    return [Noise(eps=[e[i] for e in self._eps]) for i in range(n)]


def as_noise(rng) -> Noise:
  """A ``Noise`` from a Noise, a generator, or eps tensor(s)."""
  if isinstance(rng, Noise):
    return rng
  if isinstance(rng, torch.Generator):
    return Noise(rng)
  return Noise(eps=rng)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False) -> Callable:
  """``optax.exponential_decay`` on a count tensor: ``init_value *
  decay_rate ** (count / transition_steps)``, the exponent floored with
  `staircase`."""
  if transition_steps <= 0 or decay_rate == 0:
    return lambda count: init_value

  def schedule(count):
    count = torch.as_tensor(count)
    p = count / transition_steps
    if staircase:
      p = torch.floor(p)
    return torch.where(count <= 0, init_value,
                       init_value * torch.pow(decay_rate, p))

  return schedule


class Optimizer:
  """optax's ``chain(clip, clip_by_block_rms, clip_by_global_norm, adam)``
  as functions on tensors.

  In optax's order: `clipvalue` clips each element, `clipnorm` each
  tensor's RMS on its own (``clip_by_block_rms``), `global_clipnorm` the
  norm of all gradients together; then Adam (b1, b2, eps, eps_root as
  ``optax.adam``) scales by the learning rate, a float or a schedule of
  its own update count.  State: ``{'count', 'mu', 'nu'}``, plus
  ``'lr_count'`` with a schedule; `mu` and `nu` are trees like the params.
  """

  def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               eps_root: float = 0.0, clipvalue: Optional[float] = None,
               clipnorm: Optional[float] = None,
               global_clipnorm: Optional[float] = None):
    self.learning_rate = learning_rate
    self.b1, self.b2 = float(b1), float(b2)
    self.eps, self.eps_root = float(eps), float(eps_root)
    self.clipvalue, self.clipnorm = clipvalue, clipnorm
    self.global_clipnorm = global_clipnorm

  def init(self, params: Tree) -> Tree:
    device = _tree_leaves(params)[0].device
    zeros = lambda: _tree_map(torch.zeros_like, params)
    state = {"count": torch.zeros((), dtype=torch.int32, device=device),
             "mu": zeros(), "nu": zeros()}
    if callable(self.learning_rate):
      state["lr_count"] = torch.zeros((), dtype=torch.int32, device=device)
    return state

  def update(self, grads: Tree, state: Tree,
             params: Optional[Tree] = None) -> Tuple[Tree, Tree]:
    """optax's ``update`` on trees: (updates, new state)."""
    spec = _FlatSpec(grads)
    u, flat = self.flat_update(spec, spec.cat(grads),
                               self.flatten_state(spec, state))
    return spec.split(u), self.unflatten_state(spec, flat)

  @staticmethod
  def flatten_state(spec: _FlatSpec, state: Tree) -> Tree:
    return {k: (spec.cat(v) if k in ("mu", "nu") else v)
            for k, v in state.items()}

  @staticmethod
  def unflatten_state(spec: _FlatSpec, flat: Tree) -> Tree:
    return {k: (spec.split(v) if k in ("mu", "nu") else v)
            for k, v in flat.items()}

  def _clip(self, spec: _FlatSpec, g: torch.Tensor) -> torch.Tensor:
    if self.clipvalue is not None:
      g = torch.clamp(g, -self.clipvalue, self.clipvalue)
    if self.clipnorm is not None:
      g = torch.cat([
          (u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.clipnorm,
                           min=1.0)).reshape(-1)
          for u in spec.split_list(g)])
    if self.global_clipnorm is not None:
      norm = torch.sqrt(torch.stack(
          [torch.sum(u * u) for u in spec.split_list(g)]).sum())
      g = torch.where(norm < self.global_clipnorm, g,
                      (g / norm) * self.global_clipnorm)
    return g

  def flat_update(self, spec: _FlatSpec, g: torch.Tensor,
                  state: Tree) -> Tuple[torch.Tensor, Tree]:
    """(flat updates, new flat state) from flat gradients."""
    g = self._clip(spec, g)
    b1, b2 = self.b1, self.b2
    mu = (1 - b1) * g + b1 * state["mu"]
    nu = (1 - b2) * (g * g) + b2 * state["nu"]
    count = state["count"]
    count_inc = torch.where(count < _INT32_MAX, count + 1, count)
    c = count_inc.to(torch.float32)
    mu_hat = mu / (1 - torch.pow(b1, c))
    nu_hat = nu / (1 - torch.pow(b2, c))
    u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
    new = {"count": count_inc, "mu": mu, "nu": nu}
    if callable(self.learning_rate):
      lr_count = state["lr_count"]
      u = (-1 * self.learning_rate(lr_count)) * u
      new["lr_count"] = torch.where(lr_count < _INT32_MAX, lr_count + 1,
                                    lr_count)
    else:
      u = (-1 * self.learning_rate) * u
    return u, new


_NOT_PORTED = ("adamw", "sgd", "rmsprop", "adagrad", "adamax", "lamb", "lion",
               "nadam")


def make_optimizer(name: Union[str, Optimizer] = "adam",
                   learning_rate: Union[float, Callable] = 1e-3,
                   clipnorm: Optional[float] = None,
                   global_clipnorm: Optional[float] = None,
                   clipvalue: Optional[float] = None,
                   **kwargs) -> Optimizer:
  """An ``Optimizer`` from its alias and the clipping options.  Only
  ``'adam'`` is ported; the JAX package's other aliases raise."""
  if isinstance(name, Optimizer):
    return name
  key = str(name).lower()
  if key in _NOT_PORTED:
    raise NotImplementedError(f"optimizer '{name}' is not ported yet; only "
                              "'adam' is")
  if key != "adam":
    raise ValueError(f"unknown optimizer '{name}'; available: "
                     f"{sorted(_NOT_PORTED + ('adam',))}")
  unknown = set(kwargs) - {"b1", "b2", "eps", "eps_root"}
  if unknown:
    raise NotImplementedError(f"adam options {sorted(unknown)} are not "
                              "ported yet")
  return Optimizer(learning_rate, clipvalue=clipvalue, clipnorm=clipnorm,
                   global_clipnorm=global_clipnorm, **kwargs)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _to_device(batch, device: torch.device):
  if isinstance(batch, dict):
    return {k: _to_device(v, device) for k, v in batch.items()}
  if isinstance(batch, (list, tuple)):
    return type(batch)(_to_device(v, device) for v in batch)
  if batch is None:
    return None
  return torch.as_tensor(batch).to(device)


def _cast_floats(tree, dtype):
  return _tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                   tree)


class TrainStepFn:
  """``step_fn(state, batch, eps=None) -> (state, metrics)``: one update of
  every TrainStep (see ``build_train_step_fn``).  `eps` injects the step's
  noise (one tensor, or a list in draw order; with ``accum_steps`` each
  carries a leading microbatch axis) in place of the state's generator."""

  def __init__(self, train_steps: Sequence[TrainStep],
               optimizers: Dict[str, Optimizer], nan_policy: str = "skip",
               accum_steps: int = 1, compute_dtype: Optional[torch.dtype] = None,
               ema_decay: Optional[float] = None, remat: bool = False):
    if nan_policy not in ("skip", "apply", "stop"):
      raise ValueError(f"nan_policy must be 'skip', 'apply' or 'stop', got "
                       f"{nan_policy!r}")
    if not isinstance(remat, bool):
      raise NotImplementedError(
          "remat policies (JAX's jax.checkpoint_policies names) are not "
          "ported yet; remat=True recomputes every activation")
    self.train_steps = list(train_steps)
    self.optimizers = dict(optimizers)
    self.nan_policy = nan_policy
    self.accum_steps = int(accum_steps)
    self.compute_dtype = compute_dtype
    self.remat = remat
    if ema_decay is None:
      self.ema = None
    else:  # d and 1 - d rounded to float32 as the JAX package computes them
      d = np.float32(ema_decay)
      self.ema = (float(d), float(np.float32(1.0) - d))

  def __call__(self, state: TrainState, batch,
               eps=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    return self.run(state, _to_device(batch, state.device),
                    Noise(state.rng) if eps is None else Noise(eps=eps))

  def value_and_grad(self, state: TrainState, batch, eps=None):
    """(loss, metrics, gradients) of the first TrainStep at `state`, the
    gradients averaged over microbatches as the step takes them."""
    batch = _to_device(batch, state.device)
    noise = Noise(state.rng) if eps is None else Noise(eps=eps)
    loss, metrics, spec, g, _ = self._grads(
        self.train_steps[0], state.params, batch, noise, state.step,
        state.mutables)
    return loss, metrics, spec.split(g)

  def _value_and_grad(self, ts: TrainStep, params: Tree, spec: _FlatSpec,
                      leaves, batch, noise: Noise, step, mutables):
    req = [t.detach().requires_grad_() for t in leaves]

    def loss_of(*ls):
      noise.rewind()
      full = merge_partitions(params, spec.tree(ls))
      mb = batch
      if self.compute_dtype is not None:
        full = _cast_floats(full, self.compute_dtype)
        mb = _cast_floats(mb, self.compute_dtype)
      loss, (metrics, mut) = ts.loss_fn(full, mb, noise, step, mutables)
      return loss, metrics, mut

    with torch.enable_grad():
      if self.remat:
        loss, metrics, mut = torch.utils.checkpoint.checkpoint(
            loss_of, *req, use_reentrant=False, preserve_rng_state=False)
      else:
        loss, metrics, mut = loss_of(*req)
      grads = torch.autograd.grad(loss, req, allow_unused=True)
    g = spec.cat([torch.zeros_like(t) if gr is None else gr
                  for t, gr in zip(leaves, grads)])
    return (loss.detach().to(torch.float32),
            {k: v.detach().to(torch.float32) for k, v in metrics.items()},
            g, mut)

  def _grads(self, ts: TrainStep, params: Tree, batch, noise: Noise, step,
             mutables):
    sub = extract_partitions(params, ts.partitions)
    spec = _FlatSpec(sub)
    leaves = spec.leaves(sub)
    n = self.accum_steps
    if n == 1:
      loss, metrics, g, mutables = self._value_and_grad(
          ts, params, spec, leaves, batch, noise, step, mutables)
      return loss, metrics, spec, g, mutables
    micro = _tree_map(lambda a: a.reshape((n, a.shape[0] // n) +
                                          tuple(a.shape[1:])), batch)
    g_sum, losses, mets = None, [], []
    for i, mb_noise in enumerate(noise.split(n)):
      mb = _tree_map(lambda a: a[i], micro)
      loss, metrics, g, mutables = self._value_and_grad(
          ts, params, spec, leaves, mb, mb_noise, step, mutables)
      g_sum = g if g_sum is None else g_sum + g
      losses.append(loss)
      mets.append(metrics)
    metrics = {k: torch.mean(torch.stack([m[k] for m in mets]), dim=0)
               for k in mets[0]}
    return (torch.mean(torch.stack(losses)), metrics, spec, g_sum / n,
            mutables)

  def run(self, state: TrainState, batch,
          noise: Noise) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The step on a batch already on the state's device."""
    metrics: Dict[str, torch.Tensor] = {}
    params = dict(state.params)
    opt_states = dict(state.opt_states)
    mutables = state.mutables
    any_nan = torch.zeros((), dtype=torch.bool, device=state.device)
    check = self.nan_policy in ("skip", "stop")
    for ts in self.train_steps:
      loss, step_metrics, spec, g, mutables = self._grads(
          ts, params, batch, noise, state.step, mutables)
      opt_name = ts.optimizer or ts.partitions[0]
      opt = self.optimizers[opt_name]
      p = spec.cat(extract_partitions(params, ts.partitions))
      old = opt.flatten_state(spec, opt_states[opt_name])
      u, new = opt.flat_update(spec, g, old)
      new_p = p + u
      if check:  # keep the old params and optimizer state, on the device
        finite = torch.isfinite(g).all()
        any_nan = any_nan | ~finite
        new_p = torch.where(finite, new_p, p)
        new = {k: torch.where(finite, v, old[k]) for k, v in new.items()}
      params = merge_partitions(params, spec.split(new_p))
      opt_states[opt_name] = opt.unflatten_state(spec, new)
      prefix = f"{ts.name}/" if len(self.train_steps) > 1 else ""
      metrics[f"{prefix}loss"] = loss
      for k, v in step_metrics.items():
        metrics[f"{prefix}{k}"] = v
    if self.nan_policy == "stop":
      metrics["nan_gradients"] = any_nan.to(torch.float32)
    if self.ema is not None:
      d, one_minus_d = self.ema
      spec = _FlatSpec(params)
      ema = d * spec.cat(opt_states[EMA_KEY]) + one_minus_d * spec.cat(params)
      opt_states[EMA_KEY] = spec.split(ema)
    new_state = TrainState(
        params=params, opt_states=opt_states, step=state.step + 1,
        rng=state.rng, mutables=mutables,
        skipped_updates=state.skipped_updates + any_nan.to(torch.int32))
    return new_state, metrics


def build_train_step_fn(train_steps: Sequence[TrainStep],
                        optimizers: Dict[str, Optimizer],
                        nan_policy: str = "skip",
                        accum_steps: int = 1,
                        compute_dtype: Optional[torch.dtype] = None,
                        ema_decay: Optional[float] = None,
                        remat: bool = False) -> TrainStepFn:
  """Compose TrainSteps into one ``(state, batch) -> (state, metrics)``.

  `nan_policy`: 'skip' drops the update when any gradient is non-finite
  and counts it in ``skipped_updates``; 'stop' does the same and emits
  ``metrics['nan_gradients']``; 'apply' always applies.  A skipped update
  keeps the whole optimizer state, its count included, while ``step``
  advances.

  `accum_steps > 1` splits the batch's leading axis into microbatches and
  averages their gradients before one update.  `compute_dtype` (e.g.
  ``torch.bfloat16``) casts params and batch inside the loss; the cast's
  backward casts the gradients back, so master params, gradients and
  moments stay float32.  `ema_decay` tracks a moving average of the params
  in ``opt_states['__ema__']``.  `remat=True` recomputes the forward in the
  backward (``torch.utils.checkpoint``).
  """
  return TrainStepFn(train_steps, optimizers, nan_policy=nan_policy,
                     accum_steps=accum_steps, compute_dtype=compute_dtype,
                     ema_decay=ema_decay, remat=remat)


# ---------------------------------------------------------------------------
# k steps per call
# ---------------------------------------------------------------------------
def _dequantize(a: torch.Tensor) -> torch.Tensor:
  # a corpus may sit on the card as uint8: cast per batch after the gather
  if a.dtype == torch.uint8:
    return a.to(torch.float32) / 255.0
  return a


def _named_leaves(tree, prefix: str = ""):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _named_leaves(v, f"{prefix}/{k}")
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _named_leaves(v, f"{prefix}/{i}")
  elif isinstance(tree, torch.Tensor):
    yield prefix, tree


def _state_leaves(state: TrainState) -> Dict[str, torch.Tensor]:
  """Every tensor of a state by its path in the state."""
  return dict(_named_leaves({
      "params": state.params, "opt_states": state.opt_states,
      "step": state.step, "mutables": state.mutables,
      "skipped_updates": state.skipped_updates}))


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
  """Copy each tensor of `src` into the one of the same path in `dst`."""
  if set(dst) != set(src):
    raise ValueError(f"the state's tensors changed: {sorted(set(dst) ^ set(src))}")
  pairs = [(dst[k], src[k]) for k in dst if dst[k] is not src[k]]
  if pairs:
    torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _signature(tensors: Dict[str, torch.Tensor]) -> tuple:
  return tuple((k, tuple(t.shape), t.dtype, t.device)
               for k, t in sorted(tensors.items()))


def _clone_state(state: TrainState) -> TrainState:
  """A state of fresh copies of `state`'s tensors (the generator shared)."""
  return TrainState(
      params=_tree_map(torch.clone, state.params),
      opt_states=_tree_map(torch.clone, state.opt_states),
      step=state.step.clone(), rng=state.rng,
      mutables=_tree_map(torch.clone, state.mutables),
      skipped_updates=state.skipped_updates.clone())


class _StepGraph:
  """k steps replayed from a CUDA graph of one step over static buffers.

  `body(state, slot) -> (state, metrics)` is one step reading its inputs
  at the device counter `slot` (1-D, one element); the graph holds one
  step and is replayed k times.  Each call copies the input state into the
  static state and returns copies of the static state and metrics, so
  that a state returned earlier keeps its values, as in the JAX package,
  whose k-step functions do not donate their input.
  """

  def __init__(self, n_steps: int):
    self.n_steps = int(n_steps)
    self.capture_seconds: Optional[float] = None
    self._key = None
    self._graph = None

  def run(self, state: TrainState, inputs: Dict[str, torch.Tensor], body,
          generators: Sequence[torch.Generator], key) -> Tuple[TrainState,
                                                                Dict]:
    key = (key, _signature(_state_leaves(state)), _signature(inputs),
           id(state.rng))
    if key != self._key:
      self._graph = None
      self._key = None
      self._capture(state, inputs, body, generators)
      self._key = key
    self._load(state, inputs)
    for _ in range(self.n_steps):
      self._graph.replay()
    return (_clone_state(self.state),
            {k: v.clone() for k, v in self._metrics.items()})

  def _load(self, state: TrainState, inputs):
    _copy_into(_state_leaves(self.state), _state_leaves(state))
    for k, v in inputs.items():
      self.inputs[k].copy_(v)
    self.slot.zero_()

  def _one_step(self, body):
    new, metrics = body(self.state, self.slot)
    _copy_into(_state_leaves(self.state), _state_leaves(new))
    self.slot.add_(1)
    return metrics

  def _capture(self, state: TrainState, inputs, body, generators):
    if state.device.type != "cuda":
      raise ValueError("a CUDA graph needs a state on the card; pass "
                       "graph=False to run the steps eagerly")
    t0 = time.perf_counter()
    self.state = _clone_state(state)
    self.inputs = {k: v.clone() for k, v in inputs.items()}
    self.slot = torch.zeros(1, dtype=torch.int64, device=state.device)
    saved = [g.get_state() for g in generators]
    # warm up on a side stream, so that cuDNN's heuristics and the
    # allocator settle before the capture
    side = torch.cuda.Stream(device=state.device)
    side.wait_stream(torch.cuda.current_stream(state.device))
    with torch.cuda.stream(side):
      for _ in range(2):
        self.slot.zero_()
        self._one_step(body)
    torch.cuda.current_stream(state.device).wait_stream(side)
    for g, s in zip(generators, saved):
      g.set_state(s)
    self._load(state, inputs)
    graph = torch.cuda.CUDAGraph()
    default = torch.cuda.default_generators[state.device.index or 0]
    for g in generators:
      if g is not default:
        graph.register_generator_state(g)
    try:
      with torch.cuda.graph(graph):
        metrics = self._one_step(body)
    except Exception as e:
      raise RuntimeError(f"CUDA graph capture of the training step failed "
                         f"({type(e).__name__}: {e}); pass graph=False to "
                         "run the steps eagerly") from e
    torch.cuda.synchronize(state.device)
    self._graph, self._metrics = graph, metrics
    self.capture_seconds = time.perf_counter() - t0


def _use_graph(graph: Optional[bool], state: TrainState) -> bool:
  on_card = state.device.type == "cuda"
  if graph and not on_card:
    raise ValueError("graph=True needs a state on the card")
  return on_card if graph is None else bool(graph)


def _at(buf: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
  return buf.index_select(0, slot)[0]


class _KSteps:
  """`n_steps` updates of `step_fn` per call, eagerly or from a
  ``_StepGraph``; a subclass says how a step's batch is made."""

  def __init__(self, step_fn: TrainStepFn, n_steps: int,
               graph: Optional[bool]):
    self.step_fn, self.n_steps, self.graph = step_fn, int(n_steps), graph
    self._graph = _StepGraph(n_steps)

  @property
  def capture_seconds(self) -> Optional[float]:
    return self._graph.capture_seconds

  def _run(self, state: TrainState, inputs: Dict[str, Any], batch_fn,
           generators: Sequence[torch.Generator], key):
    """`inputs`: tensors with a leading axis of `n_steps`, None where not
    given (``'eps'`` injects the noise); ``batch_fn({name: the step's
    slice})`` makes a step's batch."""
    inputs = {k: v for k, v in inputs.items() if v is not None}

    def one(s, at):
      noise = Noise(s.rng) if "eps" not in at else Noise(eps=at["eps"])
      return self.step_fn.run(s, batch_fn(at), noise)

    if not _use_graph(self.graph, state):
      metrics = None
      for i in range(self.n_steps):
        state, metrics = one(state, {k: v[i] for k, v in inputs.items()})
      return state, metrics
    static = self._graph

    def body(s, slot):
      return one(s, {k: _at(static.inputs[k], slot) for k in inputs})

    return static.run(state, inputs, body, generators, key)


class _ScanSteps(_KSteps):
  """``fused(state, batches, eps=None) -> (state, last_metrics)``."""

  def __call__(self, state: TrainState, batches, eps=None):
    batches = _to_device(batches, state.device)
    eps = _to_device(eps, state.device)
    lead = {int(t.shape[0]) for t in _tree_leaves([batches, eps])}
    if lead != {self.n_steps}:
      raise ValueError(f"batches and eps need a leading axis of "
                       f"{self.n_steps} steps, got {sorted(lead)}")
    names = [f"batch{i}" for i in range(len(_tree_leaves(batches)))]

    def batch_fn(at):
      it = iter(at[n] for n in names)
      return _tree_map(lambda _: next(it), batches)

    inputs = dict(zip(names, _tree_leaves(batches)), eps=eps)
    return self._run(state, inputs, batch_fn, [state.rng], key="scan")


def scan_steps(step_fn: TrainStepFn, n_steps: int,
               graph: Optional[bool] = None) -> _ScanSteps:
  """`n_steps` updates per call: ``fused(state, batches, eps=None) ->
  (state, last_metrics)``, `batches` (and `eps`) with a leading axis of
  `n_steps`.

  On the card the steps run from a CUDA graph of one step, replayed
  `n_steps` times with a step counter on the device; it is captured at
  the first call and again when a shape changes, and a capture that fails
  raises.  The input state is copied into the graph's buffers and the
  returned state is a copy of them, so no call changes a state held from
  an earlier one.  ``graph=False`` runs the steps eagerly; on the CPU they
  are a loop.
  """
  return _ScanSteps(step_fn, n_steps, graph)


class _DeviceDatasetSteps(_KSteps):
  """``fused(state, data, indices=None, eps=None) -> (state,
  last_metrics)``."""

  def __init__(self, step_fn: TrainStepFn, batch_size: int, n_steps: int,
               seed: int, sample_fn: Optional[Callable],
               graph: Optional[bool]):
    super().__init__(step_fn, n_steps, graph)
    self.batch_size, self.seed = int(batch_size), int(seed)
    self.sample_fn = sample_fn
    self._generators: Dict[torch.device, torch.Generator] = {}

  def _generator(self, device: torch.device) -> torch.Generator:
    if device not in self._generators:
      self._generators[device] = torch.Generator(device).manual_seed(self.seed)
    return self._generators[device]

  def _batch(self, data, gen, idx):
    if self.sample_fn is not None:
      return self.sample_fn(gen, data)
    if idx is None:
      n = _tree_leaves(data)[0].shape[0]
      idx = torch.randint(0, n, (self.batch_size,), generator=gen,
                          device=_tree_leaves(data)[0].device)
    return _tree_map(lambda a: _dequantize(a.index_select(0, idx)), data)

  def __call__(self, state: TrainState, data, indices=None, eps=None):
    device = state.device
    data = _to_device(data, device)
    indices = _to_device(indices, device)
    eps = _to_device(eps, device)
    gen = self._generator(device)
    if indices is not None and tuple(indices.shape) != (self.n_steps,
                                                        self.batch_size):
      raise ValueError(f"indices need shape {(self.n_steps, self.batch_size)}"
                       f", got {tuple(indices.shape)}")
    # the corpus is read in place: a new corpus tensor means a new graph
    key = ("data", tuple(t.data_ptr() for t in _tree_leaves(data)),
           _signature(dict(_named_leaves(data))))
    return self._run(state, {"indices": indices, "eps": eps},
                     lambda at: self._batch(data, gen, at.get("indices")),
                     [state.rng, gen], key)


def device_dataset_steps(step_fn: TrainStepFn, batch_size: int, n_steps: int,
                         seed: int = 0, sample_fn: Optional[Callable] = None,
                         graph: Optional[bool] = None) -> _DeviceDatasetSteps:
  """`n_steps` updates per call on batches drawn on the device from a
  corpus resident there: ``fused(state, data, indices=None, eps=None) ->
  (state, last_metrics)``.

  Each step draws `batch_size` indices uniformly, with replacement, from a
  generator seeded with `seed` (the JAX package keys its draws by the step
  count, so the two streams differ), gathers them and dequantizes a uint8
  corpus (``/255``) for that batch only.  `indices` (n_steps, batch_size)
  injects the draws.  `sample_fn(generator, data) -> batch` replaces the
  uniform gather.  On the card the steps run from a CUDA graph, as in
  ``scan_steps``, which also says how states are copied.
  """
  return _DeviceDatasetSteps(step_fn, batch_size, n_steps, seed, sample_fn,
                             graph)
