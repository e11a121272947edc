"""Training-step machinery of the port (PyTorch port of
``odin_tpu/training/core.py``): ``TrainState``, ``TrainStep``, the
optimizers, ``build_train_step_fn``, ``scan_steps``,
``device_dataset_steps`` and the multi-seed ``stack_states``,
``unstack_states`` and ``multiseed_device_dataset_steps``.

The step keeps the JAX package's pure interface,
``step_fn(state, batch) -> (state, metrics)``: the state is a tree of
tensors and a step returns a new one, leaving its input as it was.

  * Params are ``{partition: {name: tensor}}``, each partition a flat
    ``state_dict`` of a module (``{'vae': {'encoder.layers.1.weight': ...}}``).
    A partition path ``'vae/decoder'`` selects the entries of ``'vae'``
    under ``decoder.``, with the prefix taken off.
  * The optimizers (optax's nine aliases) are written as functions on
    tensors (not ``torch.optim``), so that a step with non-finite gradients
    keeps the old params and moments by a select on the device, with no
    sync.  Their arithmetic runs on one flat vector of all the partition's
    params.
  * Noise: a step draws from the state's ``torch.Generator``, or takes the
    noise itself (``eps``), so that a test can feed the JAX package's draws.
  * On the card, ``scan_steps``, ``device_dataset_steps`` and
    ``multiseed_device_dataset_steps`` run k steps from a captured CUDA
    graph of one step over static copies of the state, and return copies;
    on the CPU they are a plain loop.
  * ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``), all of it or, by a policy named as JAX's
    ``jax.checkpoint_policies``, all but the matmuls and convolutions.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["TrainState", "TrainStep", "TrainStepFn", "Optimizer", "Adam",
           "AdamW", "SGD", "RMSProp", "Adagrad", "Adamax", "Lamb", "Lion",
           "Noise", "make_optimizer", "exponential_decay",
           "build_train_step_fn", "scan_steps", "device_dataset_steps",
           "multiseed_device_dataset_steps", "stack_states", "unstack_states",
           "step_indices", "state_to_host", "state_from_host",
           "get_param_subtree", "set_param_subtree", "extract_partitions",
           "merge_partitions", "use_ema_params", "EMA_KEY"]

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


def state_to_host(state: TrainState) -> Dict[str, Any]:
  """A checkpoint of `state` (what ``jax.device_get`` of a state is in the
  JAX package): every tensor copied to the host, and the noise generator's
  state, so that a state restored from it draws the noise an unbroken run
  would.  Plain data: it pickles."""
  cpu = lambda t: t.detach().to("cpu", copy=True)
  return {"params": _tree_map(cpu, state.params),
          "opt_states": _tree_map(cpu, state.opt_states),
          "mutables": _tree_map(cpu, state.mutables),
          "step": cpu(state.step),
          "skipped_updates": cpu(state.skipped_updates),
          "device": str(state.device),
          "rng_state": state.rng.get_state(),
          "rng_device": state.rng.device.type,
          "rng_seed": state.rng.initial_seed()}


def state_from_host(host: Dict[str, Any],
                    device: Union[str, torch.device]) -> TrainState:
  """The ``TrainState`` of a ``state_to_host`` checkpoint, on `device`.  The
  generator's state carries over where the device type is the one it was
  saved from; elsewhere the generator restarts from its first seed."""
  device = torch.device(device)
  to = lambda t: t.to(device, copy=True)
  rng = torch.Generator(device)
  if host["rng_device"] == device.type:
    rng.set_state(host["rng_state"])
  else:
    rng.manual_seed(host["rng_seed"])
  return TrainState(params=_tree_map(to, host["params"]),
                    opt_states=_tree_map(to, host["opt_states"]),
                    step=to(host["step"]), rng=rng,
                    mutables=_tree_map(to, host["mutables"]),
                    skipped_updates=to(host["skipped_updates"]))


def use_ema_params(state: TrainState) -> TrainState:
  """The state with its params swapped for their exponential moving
  average (the step must have been built with ``ema_decay``)."""
  if EMA_KEY not in state.opt_states:
    raise ValueError("no EMA tracked: build the step fn with ema_decay=...")
  return state.replace(params=state.opt_states[EMA_KEY])


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------
def _replayable(make: Callable) -> Callable:
  """Mark a sampler whose draws depend on nothing but its generator (its
  shape, dtype and device fixed), so that a multi-seed run may make the
  same draw again from each lane's generator."""
  make.replayable = True
  return make


class Noise:
  """Where a step's random draws come from: a ``torch.Generator``, or the
  injected `eps` tensors, handed out in order.  ``rewind(mark)`` makes the
  next draws repeat the ones made since ``mark()`` was taken, so that a
  forward recomputed for the backward (``remat``) sees the same noise,
  while the next training step of the iteration draws anew.

  A draw of any kind (``normal``, ``uniform``, ``gumbel``, ``randint``,
  ``log_gamma``,
  or a sampler of the caller's through ``draw``) takes the next injected
  tensor whole, so a test hands a step the JAX package's draws in the
  order the step makes them."""

  def __init__(self, generator: Optional[torch.Generator] = None, eps=None):
    if generator is None and eps is None:
      raise ValueError("Noise needs a generator or eps")
    self.generator = generator
    self._eps = None if eps is None else (
        list(eps) if isinstance(eps, (list, tuple)) else [eps])
    self._drawn: List[torch.Tensor] = []
    self._cursor = 0

  def draw(self, shape, dtype: torch.dtype, device: torch.device,
           make: Callable[[torch.Generator], torch.Tensor]) -> torch.Tensor:
    """The next draw of `shape`: the next injected tensor, or
    ``make(generator)``."""
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
        out = make(self.generator)
      self._drawn.append(out)
    if tuple(out.shape) != shape:
      raise ValueError(f"eps has shape {tuple(out.shape)}, the draw needs "
                       f"{shape}")
    self._cursor += 1
    return out

  def normal(self, shape, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    return self.draw(shape, dtype, device, _replayable(lambda g: torch.randn(
        tuple(shape), generator=g, dtype=dtype, device=device)))

  def uniform(self, shape, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """Uniforms in [0, 1)."""
    return self.draw(shape, dtype, device, _replayable(lambda g: torch.rand(
        tuple(shape), generator=g, dtype=dtype, device=device)))

  def gumbel(self, shape, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """Standard Gumbel variates, ``-log(-log u)`` of uniforms u in
    (tiny, 1) (the noise of a Gumbel-max categorical draw)."""
    tiny = torch.finfo(dtype).tiny
    return self.draw(shape, dtype, device, _replayable(
        lambda g: -torch.log(-torch.log(torch.rand(
            tuple(shape), generator=g, dtype=dtype,
            device=device).clamp_(min=tiny)))))

  def randint(self, low: int, high: int, shape,
              device: torch.device) -> torch.Tensor:
    """int64 integers in [low, high)."""
    return self.draw(shape, torch.int64, device, _replayable(
        lambda g: torch.randint(int(low), int(high), tuple(shape),
                                generator=g, device=device)))

  def log_gamma(self, alpha, shape, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """log Gamma(alpha, 1) variates (`alpha` a float or a tensor broadcast
    to `shape`), from a fixed number of proposal rounds
    (``bay.distributions.sampling``)."""
    from odin_tpu_torch.bay.distributions.sampling import sample_log_gamma
    return self.draw(shape, dtype, device, lambda g: sample_log_gamma(
        g, alpha, shape, dtype, device))

  @property
  def drawn(self) -> List[torch.Tensor]:
    """The draws made so far, in order: ``Noise(eps=noise.drawn)`` replays
    them (on another device too)."""
    return list(self._drawn)

  def mark(self) -> int:
    """The position of the next draw."""
    return self._cursor

  def rewind(self, mark: int = 0):
    self._cursor = mark

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


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
  return torch.where(count < _INT32_MAX, count + 1, count)


def _bias_correction(moment: torch.Tensor, decay: float,
                     count: torch.Tensor) -> torch.Tensor:
  """optax's ``tree_bias_correction``: ``moment / (1 - decay ** count)``."""
  return moment / (1 - torch.pow(decay, count.to(torch.float32))).to(
      moment.dtype)


def _times(decay: float, t: torch.Tensor) -> torch.Tensor:
  """``decay * t`` as JAX computes it: the Python float takes t's dtype
  first (a weak type), so a 16-bit moment is scaled by a 16-bit decay."""
  if t.dtype != torch.float32:
    decay = float(torch.tensor(decay, dtype=t.dtype))
  return decay * t


def _dtype(dtype) -> Optional[torch.dtype]:
  """A torch dtype from a torch dtype, a numpy/JAX dtype or its name."""
  if dtype is None or isinstance(dtype, torch.dtype):
    return dtype
  name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
      or str(dtype)
  out = getattr(torch, str(name), None)
  if not isinstance(out, torch.dtype):
    raise ValueError(f"unknown dtype {dtype!r}")
  return out


def _segments(spec: "_FlatSpec", values: Sequence[torch.Tensor]
              ) -> torch.Tensor:
  """One 0-d value per leaf of `spec`, repeated over the leaf's elements
  (device ops only, so that a CUDA graph can hold it)."""
  return torch.cat([v.reshape(1).expand(n)
                    for v, n in zip(values, spec.sizes)])


class Optimizer:
  """An optax alias chained after optax's clipping, as functions on one flat
  vector of a partition's params.

  In optax's order: `clipvalue` clips each element, `clipnorm` each
  tensor's RMS on its own (``clip_by_block_rms``), `global_clipnorm` the
  norm of all gradients together; then the alias's transform (``_scale``),
  then the learning rate, a float or a schedule of its own update count
  (``'lr_count'`` in the state).  A state is ``{name: tensor or tree}``:
  counts are 0-d int32 tensors, the moments trees like the params, named
  as the fields of optax's states (``mu``, ``nu``, ``trace``,
  ``sum_of_squares``).  A subclass is one optax alias.
  """

  alias = ""
  moments: Tuple[str, ...] = ()  # the state's trees, in optax's field order

  def __init__(self, learning_rate: Union[float, Callable] = 1e-3,
               clipvalue: Optional[float] = None,
               clipnorm: Optional[float] = None,
               global_clipnorm: Optional[float] = None):
    self.learning_rate = learning_rate
    self.clipvalue, self.clipnorm = clipvalue, clipnorm
    self.global_clipnorm = global_clipnorm

  # -- the subclass's part ---------------------------------------------------
  def _init_moments(self, params: Tree, device: torch.device) -> Tree:
    """{state key: tree or 0-d tensor} of the alias's transform."""
    return {}

  def _scale(self, spec: "_FlatSpec", g: torch.Tensor, state: Tree,
             p: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """(updates, new state entries) of the alias's transform before the
    learning rate."""
    return g, {}

  def _after_lr(self, u: torch.Tensor, state: Tree,
                new: Tree) -> torch.Tensor:
    """What the alias chains after the learning rate (rmsprop's momentum)."""
    return u

  # -- optax's interface -----------------------------------------------------
  def init(self, params: Tree) -> Tree:
    device = _tree_leaves(params)[0].device
    state = self._init_moments(params, device)
    if callable(self.learning_rate):
      state["lr_count"] = torch.zeros((), dtype=torch.int32, device=device)
    return state

  def update(self, grads: Tree, state: Tree,
             params: Optional[Tree] = None) -> Tuple[Tree, Tree]:
    """optax's ``update`` on trees: (updates, new state)."""
    spec = _FlatSpec(grads)
    p = None if params is None else spec.cat(params)
    u, flat = self.flat_update(spec, spec.cat(grads),
                               self.flatten_state(spec, state), p)
    return spec.split(u), self.unflatten_state(spec, flat)

  @staticmethod
  def flatten_state(spec: "_FlatSpec", state: Tree) -> Tree:
    return {k: (spec.cat(v) if isinstance(v, dict) else v)
            for k, v in state.items()}

  def unflatten_state(self, spec: "_FlatSpec", flat: Tree) -> Tree:
    return {k: (spec.split(v) if k in self.moments else v)
            for k, v in flat.items()}

  def _clip(self, spec: "_FlatSpec", g: torch.Tensor) -> torch.Tensor:
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

  def flat_update(self, spec: "_FlatSpec", g: torch.Tensor, state: Tree,
                  p: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Tree]:
    """(flat updates, new flat state) from flat gradients and params."""
    g = self._clip(spec, g)
    u, new = self._scale(spec, g, state, p)
    if callable(self.learning_rate):
      lr_count = state["lr_count"]
      u = (-1 * self.learning_rate(lr_count)) * u
      new["lr_count"] = _safe_increment(lr_count)
    else:
      u = (-1 * self.learning_rate) * u
    return self._after_lr(u, state, new), new


def _zeros(params: Tree, dtype=None) -> Tree:
  return _tree_map(lambda t: torch.zeros_like(t, dtype=dtype), params)


def _full(params: Tree, value: float) -> Tree:
  return _tree_map(lambda t: torch.full_like(t, value), params)


def _count(device) -> torch.Tensor:
  return torch.zeros((), dtype=torch.int32, device=device)


class _DecayedWeights:
  """optax's ``add_decayed_weights(weight_decay, mask)``: ``g + wd * p`` on
  the leaves `mask` selects (a tree of bools shaped as the params, or a
  callable of the params tree giving one); a callable `weight_decay` is a
  schedule of its own count (``'wd_count'``)."""

  def _init_decay(self, weight_decay, mask):
    self.weight_decay, self.mask = weight_decay, mask

  def _decay_state(self, device) -> Tree:
    return {"wd_count": _count(device)} if callable(self.weight_decay) else {}

  def _decay(self, spec: "_FlatSpec", g: torch.Tensor, state: Tree,
             p: torch.Tensor, new: Tree) -> torch.Tensor:
    if p is None:
      raise ValueError(f"{self.alias} needs the params in update()")
    if callable(self.weight_decay):
      s = self.weight_decay(state["wd_count"])
      new["wd_count"] = state["wd_count"]  # optax never advances it
    else:
      s = self.weight_decay
    decayed = g + s * p
    if self.mask is None:
      return decayed
    mask = self.mask(spec.split(p)) if callable(self.mask) else self.mask
    keep = torch.cat([torch.full((n,), bool(m), device=g.device)
                      for m, n in zip(spec.leaves(mask), spec.sizes)])
    return torch.where(keep, decayed, g)


class Adam(Optimizer):
  """``optax.adam`` (``nesterov=True``: ``optax.nadam``); `mu_dtype` keeps
  the first moment in that dtype.  State: ``count``, ``mu``, ``nu``."""

  alias = "adam"
  moments = ("mu", "nu")

  def __init__(self, learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, eps_root: float = 0.0, mu_dtype=None, *,
               nesterov: bool = False, **clip):
    super().__init__(learning_rate, **clip)
    self.b1, self.b2 = float(b1), float(b2)
    self.eps, self.eps_root = float(eps), float(eps_root)
    self.mu_dtype = _dtype(mu_dtype)
    self.nesterov = bool(nesterov)

  def _init_moments(self, params, device):
    return {"count": _count(device), "mu": _zeros(params, self.mu_dtype),
            "nu": _zeros(params)}

  def _scale(self, spec, g, state, p):
    b1, b2 = self.b1, self.b2
    mu = (1 - b1) * g + _times(b1, state["mu"])
    nu = (1 - b2) * (g * g) + b2 * state["nu"]
    count_inc = _safe_increment(state["count"])
    if self.nesterov:
      mu_hat = (b1 * _bias_correction(mu, b1, _safe_increment(count_inc)) +
                (1 - b1) * _bias_correction(g, b1, count_inc))
    else:
      mu_hat = _bias_correction(mu, b1, count_inc)
    nu_hat = _bias_correction(nu, b2, count_inc)
    u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
    if self.mu_dtype is not None:
      mu = mu.to(self.mu_dtype)
    return u, {"count": count_inc, "mu": mu, "nu": nu}


class AdamW(_DecayedWeights, Adam):
  """``optax.adamw``: Adam, then ``add_decayed_weights``."""

  alias = "adamw"

  def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8,
               eps_root=0.0, mu_dtype=None, weight_decay=1e-4, mask=None, *,
               nesterov: bool = False, **clip):
    super().__init__(learning_rate, b1, b2, eps, eps_root, mu_dtype,
                     nesterov=nesterov, **clip)
    self._init_decay(weight_decay, mask)

  def _init_moments(self, params, device):
    return {**super()._init_moments(params, device),
            **self._decay_state(device)}

  def _scale(self, spec, g, state, p):
    u, new = super()._scale(spec, g, state, p)
    return self._decay(spec, u, state, p, new), new


class Lamb(AdamW):
  """``optax.lamb``: Adam, ``add_decayed_weights``, then
  ``scale_by_trust_ratio`` (each tensor's update scaled by ``|p| / |u|``,
  by 1 where either norm is 0)."""

  alias = "lamb"

  def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-6,
               eps_root=0.0, weight_decay=0.0, mask=None, **clip):
    super().__init__(learning_rate, b1, b2, eps, eps_root,
                     weight_decay=weight_decay, mask=mask, **clip)

  def _scale(self, spec, g, state, p):
    u, new = super()._scale(spec, g, state, p)
    p_norm = torch.stack([torch.linalg.vector_norm(t)
                          for t in spec.split_list(p)])
    u_norm = torch.stack([torch.linalg.vector_norm(t)
                          for t in spec.split_list(u)])
    ratio = torch.where((p_norm == 0) | (u_norm == 0),
                        torch.ones_like(p_norm), p_norm / u_norm)
    return u * _segments(spec, ratio), new


class Adamax(Optimizer):
  """``optax.adamax``: ``mu_hat / max(|g| + eps, b2 * nu)``.  State:
  ``count``, ``mu``, ``nu``."""

  alias = "adamax"
  moments = ("mu", "nu")

  def __init__(self, learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, **clip):
    super().__init__(learning_rate, **clip)
    self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

  def _init_moments(self, params, device):
    return {"count": _count(device), "mu": _zeros(params),
            "nu": _zeros(params)}

  def _scale(self, spec, g, state, p):
    count_inc = _safe_increment(state["count"])
    mu = (1 - self.b1) * g + self.b1 * state["mu"]
    nu = torch.maximum(torch.abs(g) + self.eps, self.b2 * state["nu"])
    u = _bias_correction(mu, self.b1, count_inc) / nu
    return u, {"count": count_inc, "mu": mu, "nu": nu}


class Lion(_DecayedWeights, Optimizer):
  """``optax.lion``: ``sign((1 - b1) g + b1 mu)``, the moment updated with
  b2, then ``add_decayed_weights``.  State: ``count``, ``mu``."""

  alias = "lion"
  moments = ("mu",)

  def __init__(self, learning_rate=1e-3, b1: float = 0.9, b2: float = 0.99,
               mu_dtype=None, weight_decay=1e-3, mask=None, **clip):
    super().__init__(learning_rate, **clip)
    self.b1, self.b2 = float(b1), float(b2)
    self.mu_dtype = _dtype(mu_dtype)
    self._init_decay(weight_decay, mask)

  def _init_moments(self, params, device):
    return {"count": _count(device), "mu": _zeros(params, self.mu_dtype),
            **self._decay_state(device)}

  def _scale(self, spec, g, state, p):
    m = state["mu"]
    u = torch.sign((1.0 - self.b1) * g + _times(self.b1, m))
    mu = (1 - self.b2) * g + _times(self.b2, m)
    if self.mu_dtype is not None:
      mu = mu.to(self.mu_dtype)
    new = {"count": _safe_increment(state["count"]), "mu": mu}
    return self._decay(spec, u, state, p, new), new


class SGD(Optimizer):
  """``optax.sgd``: with `momentum`, optax's ``trace`` (``trace = g +
  momentum * trace``; `nesterov` steps by ``g + momentum * trace``), the
  trace kept in `accumulator_dtype`.  State: ``trace`` with momentum."""

  alias = "sgd"

  def __init__(self, learning_rate=1e-3, momentum: Optional[float] = None,
               nesterov: bool = False, accumulator_dtype=None, **clip):
    super().__init__(learning_rate, **clip)
    self.momentum = None if momentum is None else float(momentum)
    self.nesterov = bool(nesterov)
    self.accumulator_dtype = _dtype(accumulator_dtype)
    self.moments = () if momentum is None else ("trace",)

  def _init_moments(self, params, device):
    if self.momentum is None:
      return {}
    return {"trace": _zeros(params, self.accumulator_dtype)}

  def _scale(self, spec, g, state, p):
    if self.momentum is None:
      return g, {}
    return _trace(g, state, self.momentum, self.nesterov,
                  self.accumulator_dtype)


def _trace(g, state, decay, nesterov, dtype=None):
  """optax's ``trace``: (updates, {'trace': new trace})."""
  t = g + _times(decay, state["trace"])
  u = g + decay * t if nesterov else t
  return u, {"trace": t if dtype is None else t.to(dtype)}


class RMSProp(Optimizer):
  """``optax.rmsprop``: ``scale_by_rms`` (``scale_by_stddev`` with
  `centered`), the learning rate, then optax's ``trace`` with `momentum`.
  State: ``nu`` (``mu`` too when centered; ``count`` with
  `bias_correction`; ``trace`` with momentum)."""

  alias = "rmsprop"

  def __init__(self, learning_rate=1e-3, decay: float = 0.9,
               eps: float = 1e-8, initial_scale: float = 0.0,
               eps_in_sqrt: bool = True, centered: bool = False,
               momentum: Optional[float] = None, nesterov: bool = False,
               bias_correction: bool = False, **clip):
    super().__init__(learning_rate, **clip)
    self.decay, self.eps = float(decay), float(eps)
    self.initial_scale = float(initial_scale)
    self.eps_in_sqrt, self.centered = bool(eps_in_sqrt), bool(centered)
    self.momentum = None if momentum is None else float(momentum)
    self.nesterov, self.bias_correction = bool(nesterov), bool(bias_correction)
    self.moments = (("mu", "nu") if centered else ("nu",)) + (
        () if momentum is None else ("trace",))

  def _init_moments(self, params, device):
    state = {"count": _count(device)} if self.bias_correction else {}
    if self.centered:
      state["mu"] = _zeros(params)
    state["nu"] = _full(params, self.initial_scale)
    if self.momentum is not None:
      state["trace"] = _zeros(params)
    return state

  def _scale(self, spec, g, state, p):
    d = self.decay
    nu = (1 - d) * (g * g) + d * state["nu"]
    new = {"nu": nu}
    if self.centered:
      new["mu"] = mu = (1 - d) * g + d * state["mu"]
    if self.bias_correction:
      new["count"] = count_inc = _safe_increment(state["count"])
      nu = _bias_correction(nu, d, count_inc)
      if self.centered:
        mu = _bias_correction(mu, d, count_inc)
    if self.centered:
      nu = nu - mu * mu
    if self.eps_in_sqrt:
      scaling = torch.rsqrt(nu + self.eps)
    else:
      scaling = 1 / (torch.sqrt(nu) + self.eps)
    return scaling * g, new

  def _after_lr(self, u, state, new):
    if self.momentum is None:
      return u
    u, t = _trace(u, state, self.momentum, self.nesterov)
    new.update(t)
    return u


class Adagrad(Optimizer):
  """``optax.adagrad``: ``g * rsqrt(sum_of_squares + eps)`` (0 where the sum
  is 0), the sum starting at `initial_accumulator_value`.  State:
  ``sum_of_squares``."""

  alias = "adagrad"
  moments = ("sum_of_squares",)

  def __init__(self, learning_rate=1e-3,
               initial_accumulator_value: float = 0.1, eps: float = 1e-7,
               **clip):
    super().__init__(learning_rate, **clip)
    self.initial_accumulator_value = float(initial_accumulator_value)
    self.eps = float(eps)

  def _init_moments(self, params, device):
    return {"sum_of_squares": _full(params, self.initial_accumulator_value)}

  def _scale(self, spec, g, state, p):
    s = g * g + state["sum_of_squares"]
    inv = torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0)
    return inv * g, {"sum_of_squares": s}


_ALIASES = {"adam": Adam, "adamw": AdamW, "sgd": SGD, "rmsprop": RMSProp,
            "adagrad": Adagrad, "adamax": Adamax, "lamb": Lamb, "lion": Lion,
            "nadam": functools.partial(Adam, nesterov=True)}


def make_optimizer(name: Union[str, Optimizer] = "adam",
                   learning_rate: Union[float, Callable] = 1e-3,
                   clipnorm: Optional[float] = None,
                   global_clipnorm: Optional[float] = None,
                   clipvalue: Optional[float] = None,
                   **kwargs) -> Optimizer:
  """An ``Optimizer`` from its alias (adam, adamw, sgd, rmsprop, adagrad,
  adamax, lamb, lion, nadam: optax's functions of those names, with their
  keywords and defaults) and the clipping options."""
  if isinstance(name, Optimizer):
    return name
  key = str(name).lower()
  if key not in _ALIASES:
    raise ValueError(f"unknown optimizer '{name}'; available: "
                     f"{sorted(_ALIASES)}")
  return _ALIASES[key](learning_rate, clipvalue=clipvalue, clipnorm=clipnorm,
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


# the products that JAX's policies call dots: ``dot_general`` and, for
# ``dots_saveable``, ``conv_general_dilated``; torch's matmuls and
# convolutions as they reach a selective-checkpoint policy (below autograd,
# where ``linear`` and ``conv2d`` have become these)
_MATMULS = ("mm", "addmm", "bmm", "baddbmm")
_CONVOLUTIONS = ("convolution",)
_NO_BATCH_MATMULS = ("mm", "addmm")
_REMAT_SAVES = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _MATMULS + _CONVOLUTIONS,
    "checkpoint_dots": _MATMULS + _CONVOLUTIONS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_MATMULS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_MATMULS,
}


def _saving(names: Optional[Tuple[str, ...]]) -> Callable:
  """A selective-checkpoint policy keeping the outputs of the aten ops
  named (of every op where `names` is None) and recomputing the rest."""
  from torch.utils.checkpoint import CheckpointPolicy
  keep = None if names is None else {getattr(torch.ops.aten, n)
                                     for n in names}

  def policy(ctx, op, *args, **kwargs):
    if keep is None or getattr(op, "overloadpacket", op) in keep:
      return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE

  return policy


def remat_policy(remat) -> Optional[Callable]:
  """The selective-checkpoint policy of a `remat` option, None for a
  recompute of everything (``True``, ``'nothing_saveable'``) or no
  checkpoint at all (a false value).  A name of ``_REMAT_SAVES`` (JAX's
  ``jax.checkpoint_policies`` of those names: the 'dots' are the matmuls
  and, for ``dots_saveable``/``checkpoint_dots``, the convolutions) keeps
  those ops' outputs; a callable is a policy of
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``
  (``(ctx, op, *args, **kwargs) -> CheckpointPolicy or bool``).  Raises
  ``ValueError`` for another name or another type."""
  if not remat or isinstance(remat, bool):
    return None
  if callable(remat):
    return remat
  if isinstance(remat, str):
    if remat not in _REMAT_SAVES:
      raise ValueError(f"unknown remat policy {remat!r}; valid names: "
                       f"{sorted(_REMAT_SAVES)}")
    saves = _REMAT_SAVES[remat]
    return None if saves == () else _saving(saves)
  raise ValueError(f"remat must be bool, str, or a checkpoint-policy "
                   f"callable; got {type(remat).__name__}")


class TrainStepFn:
  """``step_fn(state, batch, eps=None) -> (state, metrics)``: one update of
  every TrainStep (see ``build_train_step_fn``).  `eps` injects the step's
  noise (one tensor, or a list in draw order; with ``accum_steps`` each
  carries a leading microbatch axis) in place of the state's generator."""

  def __init__(self, train_steps: Sequence[TrainStep],
               optimizers: Dict[str, Optimizer], nan_policy: str = "skip",
               accum_steps: int = 1, compute_dtype: Optional[torch.dtype] = None,
               ema_decay: Optional[float] = None,
               remat: Union[bool, str, Callable] = False):
    if nan_policy not in ("skip", "apply", "stop"):
      raise ValueError(f"nan_policy must be 'skip', 'apply' or 'stop', got "
                       f"{nan_policy!r}")
    policy = remat_policy(remat)
    self._remat_context = None if policy is None else functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts, policy)
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
    from odin_tpu_torch.bay.distributions.sampling import check_rejections
    out = self.run(state, _to_device(batch, state.device),
                   Noise(state.rng) if eps is None else Noise(eps=eps))
    check_rejections()
    return out

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
                      leaves, batch, noise: Noise, step, mutables,
                      functional: bool = False):
    start = noise.mark()

    def loss_of(*ls):
      noise.rewind(start)
      full = merge_partitions(params, spec.tree(ls))
      mb = batch
      if self.compute_dtype is not None:
        full = _cast_floats(full, self.compute_dtype)
        mb = _cast_floats(mb, self.compute_dtype)
      # a loss writes the new values of its partitions' mutables into the
      # dicts it is given: each call gets its own
      mut = {k: dict(v) for k, v in mutables.items()}
      loss, (metrics, mut) = ts.loss_fn(full, mb, noise, step, mut)
      return loss, metrics, mut

    if functional:  # torch.func's gradient, which vmap can batch
      def aux_loss(ls):
        loss, metrics, mut = loss_of(*ls)
        return loss, (loss, metrics, mut)

      grads, (loss, metrics, mut) = torch.func.grad(aux_loss, has_aux=True)(
          list(leaves))
    else:
      req = [t.detach().requires_grad_() for t in leaves]
      with torch.enable_grad():
        if self.remat:
          extra = {} if self._remat_context is None else {
              "context_fn": self._remat_context}
          loss, metrics, mut = torch.utils.checkpoint.checkpoint(
              loss_of, *req, use_reentrant=False, preserve_rng_state=False,
              **extra)
        else:
          loss, metrics, mut = loss_of(*req)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    g = spec.cat([torch.zeros_like(t) if gr is None else gr
                  for t, gr in zip(leaves, grads)])
    return (loss.detach().to(torch.float32),
            {k: v.detach().to(torch.float32) for k, v in metrics.items()},
            g, _tree_map(torch.Tensor.detach, mut))

  def _grads(self, ts: TrainStep, params: Tree, batch, noise: Noise, step,
             mutables, functional: bool = False):
    sub = extract_partitions(params, ts.partitions)
    spec = _FlatSpec(sub)
    leaves = spec.leaves(sub)
    n = self.accum_steps
    if n == 1:
      loss, metrics, g, mutables = self._value_and_grad(
          ts, params, spec, leaves, batch, noise, step, mutables, functional)
      return loss, metrics, spec, g, mutables
    micro = _tree_map(lambda a: a.reshape((n, a.shape[0] // n) +
                                          tuple(a.shape[1:])), batch)
    g_sum, losses, mets = None, [], []
    for i, mb_noise in enumerate(noise.split(n)):
      mb = _tree_map(lambda a: a[i], micro)
      loss, metrics, g, mutables = self._value_and_grad(
          ts, params, spec, leaves, mb, mb_noise, step, mutables, functional)
      g_sum = g if g_sum is None else g_sum + g
      losses.append(loss)
      mets.append(metrics)
    metrics = {k: torch.mean(torch.stack([m[k] for m in mets]), dim=0)
               for k in mets[0]}
    return (torch.mean(torch.stack(losses)), metrics, spec, g_sum / n,
            mutables)

  def run(self, state: TrainState, batch, noise: Noise,
          functional: bool = False
          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The step on a batch already on the state's device; `functional`
    takes the gradients with ``torch.func.grad`` (so that ``vmap`` can
    batch the step) instead of ``torch.autograd``."""
    metrics: Dict[str, torch.Tensor] = {}
    params = dict(state.params)
    opt_states = dict(state.opt_states)
    mutables = state.mutables
    any_nan = torch.zeros((), dtype=torch.bool, device=state.device)
    check = self.nan_policy in ("skip", "stop")
    for ts in self.train_steps:
      loss, step_metrics, spec, g, mutables = self._grads(
          ts, params, batch, noise, state.step, mutables, functional)
      opt_name = ts.optimizer or ts.partitions[0]
      opt = self.optimizers[opt_name]
      p = spec.cat(extract_partitions(params, ts.partitions))
      old = opt.flatten_state(spec, opt_states[opt_name])
      u, new = opt.flat_update(spec, g, old, p)
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
                        remat: Union[bool, str, Callable] = False
                        ) -> TrainStepFn:
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
  backward (``torch.utils.checkpoint``); a name of JAX's
  ``jax.checkpoint_policies`` ('dots_saveable', 'checkpoint_dots',
  'dots_with_no_batch_dims_saveable', 'checkpoint_dots_with_no_batch_dims',
  'everything_saveable', 'nothing_saveable') or a torch selective-checkpoint
  policy keeps the outputs of the ops it saves and recomputes the rest
  (``remat_policy``); the step's numbers are the plain step's.
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
          generators: Sequence[torch.Generator], key,
          donate: bool = False) -> Tuple[TrainState, Dict]:
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
    metrics = {k: v.clone() for k, v in self._metrics.items()}
    return (self.state if donate else _clone_state(self.state)), metrics

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
      # thread_local: an input pipeline's thread may pin memory and copy
      # batches on its own stream while this thread captures
      with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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
               graph: Optional[bool], donate: bool = False):
    self.step_fn, self.n_steps, self.graph = step_fn, int(n_steps), graph
    self.donate = bool(donate)
    self._graph = _StepGraph(n_steps)

  @property
  def capture_seconds(self) -> Optional[float]:
    return self._graph.capture_seconds

  def _run(self, state: TrainState, inputs: Dict[str, Any], batch_fn,
           generators: Sequence[torch.Generator], key):
    """`inputs`: tensors with a leading axis of `n_steps`, None where not
    given (``'eps'`` injects the noise); ``batch_fn({name: the step's
    slice}, state)`` makes a step's batch."""
    inputs = {k: v for k, v in inputs.items() if v is not None}

    def one(s, at):
      return self._step(s, at, batch_fn)

    if not _use_graph(self.graph, state):
      metrics = None
      for i in range(self.n_steps):
        state, metrics = one(state, {k: v[i] for k, v in inputs.items()})
      return state, metrics
    static = self._graph

    def body(s, slot):
      return one(s, {k: _at(static.inputs[k], slot) for k in inputs})

    return static.run(state, inputs, body, generators, key, self.donate)

  def _step(self, s: TrainState, at: Dict[str, torch.Tensor], batch_fn):
    """One step on the inputs of its slot `at`."""
    noise = Noise(s.rng) if "eps" not in at else Noise(eps=at["eps"])
    return self.step_fn.run(s, batch_fn(at, s), noise)


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

    def batch_fn(at, _):
      it = iter(at[n] for n in names)
      return _tree_map(lambda _: next(it), batches)

    inputs = dict(zip(names, _tree_leaves(batches)), eps=eps)
    return self._run(state, inputs, batch_fn, [state.rng], key="scan")


def scan_steps(step_fn: TrainStepFn, n_steps: int,
               graph: Optional[bool] = None,
               donate: bool = False) -> _ScanSteps:
  """`n_steps` updates per call: ``fused(state, batches, eps=None) ->
  (state, last_metrics)``, `batches` (and `eps`) with a leading axis of
  `n_steps`.

  On the card the steps run from a CUDA graph of one step, replayed
  `n_steps` times with a step counter on the device; it is captured at
  the first call and again when a shape changes, and a capture that fails
  raises.  The input state is copied into the graph's buffers and the
  returned state is a copy of them, so no call changes a state held from
  an earlier one, unless `donate`: then the graph's own buffers are
  returned and the next call, given that state back, copies nothing in
  (the state a call returned holds only until the next call, as a state
  donated to a ``jax.jit`` call).  ``graph=False`` runs the steps eagerly;
  on the CPU they are a loop.
  """
  return _ScanSteps(step_fn, n_steps, graph, donate)


_M32 = 0xFFFFFFFF


def _mix32(x):
  """A 32-bit integer hash (xorshift-multiply rounds) of a Python int or an
  int64 tensor holding values in [0, 2^32); the multipliers are below
  2^31, so no int64 product overflows."""
  x = x ^ (x >> 16)
  x = (x * 0x7FEB352D) & _M32
  x = x ^ (x >> 15)
  x = (x * 0x2C1B3C6D) & _M32
  return x ^ (x >> 16)


def step_indices(seed: int, step, batch_size: int, n: int) -> torch.Tensor:
  """The `batch_size` indices in [0, n) that ``device_dataset_steps``
  draws at `step` (an int or a 0-d integer tensor, on the device the
  indices are made on): a counter-based hash of (seed, step, i), so a draw
  depends on nothing but the seed and the state's step count."""
  step = torch.as_tensor(step).to(torch.int64)
  return _keyed_indices(_mix32(int(seed) & _M32), step, batch_size, n)


def _keyed_indices(seed_key, step: torch.Tensor, batch_size: int,
                   n: int) -> torch.Tensor:
  """``step_indices`` from the hashed seed(s) `seed_key` (an int, or an
  int64 tensor broadcast with `step`): indices of shape ``step.shape +
  (batch_size,)``."""
  key = _mix32((seed_key + (step & _M32) * 0x9E3779B1) & _M32)[..., None]
  i = torch.arange(int(batch_size), dtype=torch.int64, device=step.device)
  h = _mix32((key + i * 0x85EBCA77) & _M32)
  return _mix32(h ^ key) % int(n)


class _DeviceDatasetSteps(_KSteps):
  """``fused(state, data, indices=None, eps=None) -> (state,
  last_metrics)``."""

  def __init__(self, step_fn: TrainStepFn, batch_size: int, n_steps: int,
               seed: int, sample_fn: Optional[Callable],
               graph: Optional[bool], donate: bool):
    super().__init__(step_fn, n_steps, graph, donate)
    self.batch_size, self.seed = int(batch_size), int(seed)
    self.sample_fn = sample_fn
    self._generators: Dict[torch.device, torch.Generator] = {}

  def _generator(self, device: torch.device) -> torch.Generator:
    if device not in self._generators:
      self._generators[device] = torch.Generator(device)
    return self._generators[device]

  def _batch(self, data, gen, idx, step):
    if self.sample_fn is not None:
      return self.sample_fn(gen, data)
    if idx is None:
      idx = step_indices(self.seed, step, self.batch_size,
                         _tree_leaves(data)[0].shape[0])
    return _tree_map(lambda a: _dequantize(a.index_select(0, idx)), data)

  def __call__(self, state: TrainState, data, indices=None, eps=None):
    device = state.device
    data = _to_device(data, device)
    indices = _to_device(indices, device)
    eps = _to_device(eps, device)
    gen = self._generator(device)
    if self.sample_fn is not None:  # keyed by the call's first step
      gen.manual_seed(int(_mix32((_mix32(self.seed & _M32) +
                                  int(state.step)) & _M32)))
    if indices is not None and tuple(indices.shape) != (self.n_steps,
                                                        self.batch_size):
      raise ValueError(f"indices need shape {(self.n_steps, self.batch_size)}"
                       f", got {tuple(indices.shape)}")
    # the corpus is read in place: a new corpus tensor means a new graph
    key = ("data", tuple(t.data_ptr() for t in _tree_leaves(data)),
           _signature(dict(_named_leaves(data))))
    return self._run(state, {"indices": indices, "eps": eps},
                     lambda at, s: self._batch(data, gen, at.get("indices"),
                                               s.step),
                     [state.rng, gen], key)


def device_dataset_steps(step_fn: TrainStepFn, batch_size: int, n_steps: int,
                         seed: int = 0, sample_fn: Optional[Callable] = None,
                         graph: Optional[bool] = None,
                         donate: bool = False) -> _DeviceDatasetSteps:
  """`n_steps` updates per call on batches drawn on the device from a
  corpus resident there: ``fused(state, data, indices=None, eps=None) ->
  (state, last_metrics)``.

  Each step draws `batch_size` indices uniformly, with replacement, keyed
  by `seed` and the state's step count alone (``step_indices``; the JAX
  package keys its draws the same way, by ``fold_in(PRNGKey(seed),
  step)``, with another generator), so a run split at any call boundary,
  through a checkpoint or a new object, draws what an unbroken run draws.
  It gathers them and dequantizes a uint8 corpus (``/255``) for that batch
  only.  `indices` (n_steps, batch_size) injects the draws.
  `sample_fn(generator, data) -> batch` replaces the uniform gather; its
  generator is seeded from `seed` and the step count at the start of each
  call, so its stream repeats where the calls start at the same steps.  On
  the card the steps run from a CUDA graph, as in ``scan_steps``, which
  also says how states are copied and what `donate` does.
  """
  return _DeviceDatasetSteps(step_fn, batch_size, n_steps, seed, sample_fn,
                             graph, donate)


# ---------------------------------------------------------------------------
# several seeds in one program
# ---------------------------------------------------------------------------
def _stack_trees(trees: Sequence[Any]):
  first = trees[0]
  if isinstance(first, dict):
    return {k: _stack_trees([t[k] for t in trees]) for k in first}
  if isinstance(first, (list, tuple)):
    return type(first)(_stack_trees(list(z)) for z in zip(*trees))
  if isinstance(first, torch.Tensor):
    return torch.stack(list(trees))
  return first


def stack_states(states: Sequence[TrainState]) -> TrainState:
  """S states (one model each, e.g. built from S seeds, each with its
  optimizer states) stacked leaf-wise into one state of (S, ...) tensors
  for ``multiseed_device_dataset_steps``; its ``rng`` is the tuple of the
  S states' generators."""
  states = list(states)
  return TrainState(
      params=_stack_trees([s.params for s in states]),
      opt_states=_stack_trees([s.opt_states for s in states]),
      step=torch.stack([s.step for s in states]),
      rng=tuple(s.rng for s in states),
      mutables=_stack_trees([s.mutables for s in states]),
      skipped_updates=torch.stack([s.skipped_updates for s in states]))


def unstack_states(stacked: TrainState) -> List[TrainState]:
  """The S states of a stacked state, each holding copies of its lane's
  tensors and its own generator."""
  lane = lambda i: (lambda t: t[i].clone())
  return [TrainState(params=_tree_map(lane(i), stacked.params),
                     opt_states=_tree_map(lane(i), stacked.opt_states),
                     step=stacked.step[i].clone(), rng=stacked.rng[i],
                     mutables=_tree_map(lane(i), stacked.mutables),
                     skipped_updates=stacked.skipped_updates[i].clone())
          for i in range(int(stacked.step.shape[0]))]


class _DrawRecorder(Noise):
  """The noise of one probe step: draws from a generator of its own, and
  keeps the sampler of each draw so that the draws can be made again from
  each lane's generator."""

  def __init__(self, device: torch.device):
    super().__init__(torch.Generator(device).manual_seed(0))
    self.samplers: List[Callable] = []

  def draw(self, shape, dtype, device, make):
    if self._cursor == len(self._drawn):
      if not getattr(make, "replayable", False):
        raise ValueError(
            "multiseed_device_dataset_steps makes each lane's draws from its "
            "own generator and replays Noise's normal, uniform, gumbel and "
            "randint draws only; this step draws otherwise (log_gamma or a "
            "sampler of its own): pass eps=")
      self.samplers.append(make)
    return super().draw(shape, dtype, device, make)


def _lane_tensors(state: TrainState) -> Tree:
  return {"params": state.params, "opt_states": state.opt_states,
          "step": state.step, "mutables": state.mutables,
          "skipped_updates": state.skipped_updates}


class _MultiSeedSteps(_KSteps):
  """``fused(stacked, data, indices=None, eps=None) -> (stacked,
  last_metrics)``."""

  def __init__(self, step_fn: TrainStepFn, batch_size: int, n_steps: int,
               seeds: Sequence[int], sample_fn: Optional[Callable]):
    if step_fn.accum_steps != 1 or step_fn.remat:
      raise ValueError("multiseed_device_dataset_steps takes a step without "
                       "accum_steps and remat")
    super().__init__(step_fn, n_steps, graph=None)
    self.batch_size = int(batch_size)
    self.seeds = [int(s) for s in seeds]
    self.sample_fn = sample_fn
    self._samplers: Optional[List[Callable]] = None
    self._sample_gens: Dict[torch.device, List[torch.Generator]] = {}
    self._vmapped = torch.func.vmap(self._lane_step, randomness="error")

  def _lane_step(self, tensors: Tree, batch, eps: List[torch.Tensor]):
    """One lane's step, batched by vmap: the state's tensors, the lane's
    batch and its noise in draw order."""
    state = TrainState(rng=None, **tensors)
    new, metrics = self.step_fn.run(state, batch, Noise(eps=list(eps)),
                                    functional=True)
    return _lane_tensors(new), metrics

  def _record(self, stacked: TrainState, data):
    """The samplers of a step's draws, from one step of lane 0 run alone
    (on a batch of the corpus's first rows and noise of its own)."""
    lane = unstack_states(stacked)[0]
    if self.sample_fn is not None:
      batch = self.sample_fn(torch.Generator(stacked.device).manual_seed(0),
                             data)
    else:
      batch = _tree_map(lambda a: _dequantize(a[:self.batch_size]), data)
    recorder = _DrawRecorder(stacked.device)
    self.step_fn.run(lane, batch, recorder)
    return recorder.samplers

  def _batch(self, data, gens, keys, idx, steps):
    if self.sample_fn is not None:
      return _stack_trees([self.sample_fn(g, data) for g in gens])
    n = _tree_leaves(data)[0].shape[0]
    if idx is None:
      idx = _keyed_indices(keys, steps.to(torch.int64), self.batch_size, n)
    flat = idx.reshape(-1)
    return _tree_map(lambda a: _dequantize(a.index_select(0, flat)).reshape(
        tuple(idx.shape) + tuple(a.shape[1:])), data)

  def _step(self, s, at, batch_fn):
    if any(k.startswith("eps") for k in at):
      eps = [at[k] for k in sorted((k for k in at if k.startswith("eps")),
                                   key=lambda k: int(k[3:]))]
    else:  # each lane's draws from its own generator, as its solo run's
      eps = [torch.stack([make(g) for g in s.rng]) for make in self._samplers]
    new, metrics = self._vmapped(_lane_tensors(s), batch_fn(at, s), eps)
    return TrainState(rng=s.rng, **new), metrics

  def __call__(self, stacked: TrainState, data, indices=None, eps=None):
    S = len(self.seeds)
    if tuple(stacked.step.shape) != (S,) or len(stacked.rng) != S:
      raise ValueError(f"a stacked state of {S} lanes is needed (stack_states"
                       f"), got steps of shape {tuple(stacked.step.shape)}")
    device = stacked.device
    data = _to_device(data, device)
    indices = _to_device(indices, device)
    eps = _to_device(eps, device)
    if isinstance(eps, torch.Tensor):
      eps = [eps]
    if indices is not None and tuple(indices.shape) != (
        self.n_steps, S, self.batch_size):
      raise ValueError(f"indices need shape {(self.n_steps, S, self.batch_size)}"
                       f", got {tuple(indices.shape)}")
    for e in eps or ():
      if tuple(e.shape[:2]) != (self.n_steps, S):
        raise ValueError(f"eps need leading axes {(self.n_steps, S)}, got "
                         f"{tuple(e.shape)}")
    if eps is None and self._samplers is None:
      self._samplers = self._record(stacked, data)
    keys = torch.tensor([_mix32(s & _M32) for s in self.seeds],
                        dtype=torch.int64, device=device)
    gens = self._sample_gens.setdefault(
        device, [torch.Generator(device) for _ in self.seeds])
    if self.sample_fn is not None:  # keyed by each lane's first step
      for g, seed, step in zip(gens, self.seeds, stacked.step.tolist()):
        g.manual_seed(int(_mix32((_mix32(seed & _M32) + int(step)) & _M32)))
    inputs = {"indices": indices}
    inputs.update({f"eps{i}": e for i, e in enumerate(eps or ())})
    key = ("multiseed", tuple(t.data_ptr() for t in _tree_leaves(data)),
           _signature(dict(_named_leaves(data))))
    return self._run(stacked, inputs,
                     lambda at, s: self._batch(data, gens, keys,
                                               at.get("indices"), s.step),
                     list(stacked.rng) + gens, key)


def multiseed_device_dataset_steps(step_fn: TrainStepFn, batch_size: int,
                                   n_steps: int, seeds: Sequence[int],
                                   sample_fn: Optional[Callable] = None
                                   ) -> _MultiSeedSteps:
  """S models trained as one program: ``fused(stacked, data, indices=None,
  eps=None) -> (stacked, last_metrics)``, `stacked` from ``stack_states``
  of S = len(seeds) states and `data` the corpus on the device, shared by
  every lane.

  ``torch.func.vmap`` runs the step (its gradients by ``torch.func.grad``)
  on every lane at once, so the S models' convolutions and products run in
  the same kernels (cuDNN's grouped convolutions, batched GEMMs); on the
  card the `n_steps` steps replay a CUDA graph of one, as in
  ``device_dataset_steps``, and a call returns copies (the lanes'
  generators are the input state's, and advance).  Lane i draws its batches with
  ``step_indices(seeds[i], step)`` and its noise from its own state's
  generator, so it makes the draws of ``device_dataset_steps(seed=
  seeds[i])`` from that state, and its params equal that run's to
  float tolerance.  A non-finite gradient skips that lane's update alone;
  every metric has a leading (S,) axis.  `indices` (n_steps, S,
  batch_size) and `eps` (a tensor or a list in draw order, each with
  leading axes (n_steps, S)) inject the draws; `sample_fn(generator,
  data)` makes a lane's batch from a generator seeded by the lane's seed
  and step count at the start of each call.  Without `eps`, the noise is
  replayed from the samplers of one probe step of lane 0 at the first
  call: Noise's normal, uniform, gumbel and randint draws of fixed
  shapes.  The step may not use ``accum_steps`` or ``remat``.
  """
  return _MultiSeedSteps(step_fn, batch_size, n_steps, seeds, sample_fn)
