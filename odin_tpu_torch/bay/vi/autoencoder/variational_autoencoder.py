"""VariationalAutoencoder of the port: build, encode, decode, sample, the
ELBO and its training step (PyTorch port of ``VAECore`` and
``VariationalAutoencoder``,
``odin_tpu/bay/vi/autoencoder/variational_autoencoder.py:55-466``).

As in the JAX package the model holds its hyperparameters and a
``TrainState``; every computation reads the params of a state
(``torch.func.functional_call`` on the ``VAECore``), so that a state a
training step returned serves once it is assigned to ``vae.state``.
``vae.core.load_state_dict`` writes through to ``vae.state`` and
``vae.core.state_dict()`` reads it.  Training: ``fit`` (``Trainer.fit`` over
``make_step_fn``) and ``fit_device_dataset`` (batches drawn on the card);
``save_weights``/``load_weights`` keep the whole state, the noise
generator's included.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.bay.distributions import Distribution
from odin_tpu_torch.bay.helpers import kl_divergence, map_distributions
from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi._base import VariationalModel, traverse_dims
from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.training.core import (
    EMA_KEY,
    Noise,
    TrainState,
    TrainStep,
    TrainStepFn,
    _clone_state,
    _to_device,
    as_noise,
    build_train_step_fn,
    device_dataset_steps,
    extract_partitions,
    make_optimizer,
    state_from_host,
    state_to_host,
)
from odin_tpu_torch.training.trainer import Trainer
from odin_tpu_torch.utils import md5_checksum

__all__ = ["VAECore", "VariationalAutoencoder"]


def _as_head(head, default_name: str) -> DistributionDense:
  """An ``RVconf`` becomes a head named by its role (`default_name`), as in
  the JAX package; a given ``DistributionDense`` keeps its own name."""
  if isinstance(head, RVconf):
    return head.create_posterior(name=default_name)
  if isinstance(head, DistributionDense):
    return head
  raise ValueError(f"cannot interpret {head!r} as a distribution head")


class VAECore(nn.Module):
  """encoder -> latents head; decoder -> observation head.  Its parameter
  names follow the flax tree (``encoder.layers.1.weight`` is
  ``encoder/layers_1/Conv_0/kernel``; see ``odin_tpu_torch.weights``)."""

  def __init__(self, encoder: nn.Module, decoder: nn.Module,
               latents: DistributionDense, observation: DistributionDense):
    super().__init__()
    self.encoder = encoder
    self.decoder = decoder
    self.latents = latents
    self.observation = observation

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    z = self.latents.build(h, generator)
    self.observation.build(self.decoder.build(z, generator), generator)

  def encode(self, x) -> Distribution:
    return self.latents(self.encoder(x))

  def decode(self, z) -> Distribution:
    return self.observation(self.decoder(z))

  def forward(self, x, method: Optional[str] = None):
    """``method`` ('encode' or 'decode') calls that method, so that
    ``functional_call`` can run either on given params; without it, x ->
    (px at the posterior mean, qz)."""
    if method is not None:
      return getattr(self, method)(x)
    qz = self.encode(x)
    return self.decode(qz.mean()), qz


class VariationalAutoencoder(VariationalModel):
  """Vanilla VAE: ``vae = BetaVAE(**get_networks('dsprites')).build()``,
  then ``qz = vae.encode(x)``, ``px = vae.decode(z)``,
  ``qz, px = vae.reconstruct(x)``; training:
  ``step = vae.make_step_fn()``, ``vae.state, metrics = step(vae.state,
  x)``.  Images are NHWC."""

  def __init__(self,
               encoder: nn.Module,
               decoder: nn.Module,
               latents: Union[RVconf, DistributionDense],
               observation: Union[RVconf, DistributionDense],
               input_shape: Optional[Tuple[int, ...]] = None,
               analytic: bool = False,
               reverse: bool = True,
               free_bits: Optional[float] = None,
               sample_shape: Union[int, Tuple[int, ...]] = (),
               allow_negative_kl: bool = True,
               name: Optional[str] = None,
               **kwargs):
    super().__init__(analytic=analytic, reverse=reverse, free_bits=free_bits,
                     sample_shape=sample_shape,
                     allow_negative_kl=allow_negative_kl, name=name)
    if kwargs.get("labels") is not None:
      raise NotImplementedError("labels heads are not ported yet")
    self.latents_conf = latents if isinstance(latents, RVconf) else None
    self.core = VAECore(encoder, decoder, _as_head(latents, "latents"),
                        _as_head(observation, "observation"))
    self.input_shape = tuple(input_shape) if input_shape is not None else None
    self.device: Optional[torch.device] = None
    self.state: Optional[TrainState] = None
    self.step = 0
    self._priors: Dict[torch.device, Distribution] = {}
    # ``self.state`` holds the params every computation reads; ``core``'s
    # own parameters are only where weights are built and loaded, so
    # loading a state_dict into ``core`` writes through to the state, and
    # ``core.state_dict()`` reads the state's params
    def loaded(module, incompatible_keys):
      if self.state is not None:
        self.state = self.state.replace(
            params={**self.state.params, "vae": self._core_params()})

    def saved(module, state_dict, prefix, local_metadata):
      if self.state is not None:
        for k, v in self.state.params["vae"].items():
          state_dict[prefix + k] = v.detach()

    self.core.register_load_state_dict_post_hook(loaded)
    self.core.register_state_dict_post_hook(saved)

  def _core_params(self) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in self.core.named_parameters()}

  @property
  def zdim(self) -> int:
    return int(np.prod(self.core.latents.event_shape))

  @property
  def latents_prior(self) -> Optional[Distribution]:
    return (self.latents_conf.create_prior() if self.latents_conf is not None
            else self.core.latents.prior)

  def _prior_on(self, device: torch.device) -> Distribution:
    """The latents prior with its parameters on `device`, built once per
    device (so that a captured graph finds it made)."""
    if device not in self._priors:
      self._priors[device] = map_distributions(lambda t: t.to(device),
                                               self.latents_prior)
    return self._priors[device]

  def build(self, input_shape: Optional[Sequence[int]] = None, seed: int = 1,
            device: Union[str, torch.device] = "cuda"
            ) -> "VariationalAutoencoder":
    """Create the parameters from `seed` (drawn on the CPU, so that a seed
    gives the same weights on every device), move them to `device`, and
    start ``self.state`` on them; the state's generator is seeded with
    ``seed + 1``, as the JAX package keys its state."""
    if input_shape is not None:
      self.input_shape = tuple(i for i in input_shape if i is not None)
    if self.input_shape is None:
      raise ValueError("input_shape must be provided")
    device = resolve_device(device)
    self.core.build(self.input_shape, torch.Generator().manual_seed(seed))
    self.core.to(device).eval()
    self.device = device
    self.state = TrainState(
        params={"vae": self._core_params()},
        opt_states={},
        step=torch.zeros((), dtype=torch.int32, device=device),
        rng=torch.Generator(device).manual_seed(seed + 1))
    return self

  # -- apply ----------------------------------------------------------------
  def _apply(self, params: Dict[str, Any], method: str, x):
    return torch.func.functional_call(self.core, params["vae"], (x,),
                                      {"method": method})

  def _params_of(self) -> Dict[str, Any]:
    if self.state is None:
      raise RuntimeError("call build() first")
    return self.state.params

  def _tensor(self, x) -> torch.Tensor:
    if self.device is None:
      raise RuntimeError("call build() first")
    return torch.as_tensor(x, dtype=torch.float32).to(self.device)

  def _generator(self, seed: int) -> torch.Generator:
    return torch.Generator(self.device).manual_seed(seed)

  # -- the reference's public API -------------------------------------------
  def encode(self, x, params: Optional[Dict] = None) -> Distribution:
    """x (B, H, W, C) -> qz."""
    return self._apply(params or self._params_of(), "encode", self._tensor(x))

  def decode(self, z, params: Optional[Dict] = None
             ) -> Union[Distribution, Tuple[Distribution, Tuple[int, ...]]]:
    """z (B, zdim) -> px.  z with leading sample dims (S..., B, zdim) is
    decoded as (S·...·B, zdim) and returns ``(px, lead)``, ``lead`` the
    shape z had without its last dim, as in the JAX package."""
    params = params or self._params_of()
    z = self._tensor(z)
    if z.ndim > 2:
      lead = tuple(z.shape[:-1])
      return self._apply(params, "decode", z.reshape(-1, z.shape[-1])), lead
    return self._apply(params, "decode", z)

  def __call__(self, x, seed: int = 0) -> Tuple[Distribution, Distribution]:
    """x -> (px, qz): decode a sample of qz drawn from `seed`."""
    qz = self.encode(x)
    z = qz.sample(generator=self._generator(seed))
    return self.decode(z), qz

  def reconstruct(self, x, params: Optional[Dict] = None
                  ) -> Tuple[Distribution, Distribution]:
    """x -> (qz, px) through the posterior mean: encode, then decode E[z|x]."""
    params = params or self._params_of()
    qz = self.encode(x, params)
    return qz, self._apply(params, "decode", qz.mean())

  def sample_prior(self, n: int = 1, seed: int = 0) -> torch.Tensor:
    """z ~ p(z), (n, zdim)."""
    return self._prior_on(self.device).sample((n,),
                                              generator=self._generator(seed))

  def sample_observation(self, n: int = 1, seed: int = 0) -> Distribution:
    """px of n draws from the prior."""
    return self.decode(self.sample_prior(n, seed))

  def sample_traverse(self, x, feature_indices=None, min_val=-2.0,
                      max_val=2.0, n_traverse_points: int = 11,
                      mode: str = "linear", seed: int = 0):
    """Encode x, sweep latent dims of the posterior mean
    (``traverse_dims``), and decode the grid."""
    z = self.encode(x).mean()
    return self.decode(traverse_dims(z, feature_indices, min_val, max_val,
                                     n_traverse_points, mode))

  # -- ELBO -----------------------------------------------------------------
  def elbo_components(self, params, batch, rng, step, training: bool = False,
                      mutables=None):
    """-> (llk dict, kl dict, aux).  `rng` is a ``Noise``, a generator or
    the noise itself: z is qz's reparameterised sample from
    ``sample_shape + (B, zdim)`` standard normals."""
    x, y = self._split_inputs(batch)
    qz = self._apply(params, "encode", x)
    mean = qz.mean()
    eps = as_noise(rng).normal(
        tuple(self.sample_shape) + tuple(qz.batch_shape) +
        tuple(qz.event_shape), mean.dtype, mean.device)
    z = qz.sample(self.sample_shape, eps=eps)
    if self.sample_shape:
      z_flat = z.reshape((-1, z.shape[-1]))
      px = self._apply(params, "decode", z_flat)
      n = int(np.prod(self.sample_shape))
      llk_s = px.log_prob(x.repeat((n,) + (1,) * (x.ndim - 1)))
      llk_x = llk_s.reshape(tuple(self.sample_shape) + (-1,)).mean(
          dim=tuple(range(len(self.sample_shape))))
    else:
      px = self._apply(params, "decode", z)
      llk_x = px.log_prob(x)
    obs_name = self.core.observation.name or "observation"
    llk = {f"llk_{obs_name}": llk_x}
    kl_z = kl_divergence(qz, self._prior_on(mean.device),
                         analytic=self.analytic,
                         q_sample=z if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    lat_name = self.core.latents.name or "latents"
    kl = {f"kl_{lat_name}": kl_z}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)

  @staticmethod
  def _split_inputs(batch):
    if isinstance(batch, (tuple, list)):
      x = batch[0]
      y = batch[1] if len(batch) > 1 else None
    elif isinstance(batch, dict):
      x = batch.get("inputs", batch.get("x"))
      y = batch.get("labels", batch.get("y"))
    else:
      x, y = batch, None
    return x, y

  # -- training -------------------------------------------------------------
  def _vae_loss(self, params, batch, rng, step, mutables):
    llk, kl, _ = self.elbo_components(params, batch, rng, step,
                                      training=True, mutables=mutables)
    elbo = self.elbo(llk, kl)
    loss = -torch.mean(elbo)
    metrics = {k: torch.mean(v) for k, v in {**llk, **kl}.items()}
    return loss, (metrics, mutables)

  def train_steps(self) -> List[TrainStep]:
    """One step over the 'vae' partition for the plain VAE."""
    return [TrainStep(loss_fn=self._vae_loss, partitions=("vae",), name="vae")]

  def optimizer_specs(self) -> Dict[str, Dict[str, Any]]:
    """Per-partition optimizer overrides; a subclass hook."""
    return {}

  def make_step_fn(self,
                   optimizer: str = "adam",
                   learning_rate: Union[float, Callable] = 1e-3,
                   clipnorm: Optional[float] = None,
                   global_clipnorm: Optional[float] = None,
                   nan_policy: str = "skip",
                   train_params: Optional[Sequence[str]] = None,
                   accum_steps: int = 1,
                   compute_dtype: Optional[torch.dtype] = None,
                   ema_decay: Optional[float] = None,
                   remat: bool = False,
                   keep_opt_states: bool = False,
                   **opt_kwargs) -> TrainStepFn:
    """The training step ``step(state, batch, eps=None) -> (state,
    metrics)``; also starts the optimizer states on ``self.state``.

    `train_params` restricts the update to the given param paths
    (``('vae/decoder',)`` trains the decoder, the encoder frozen);
    `keep_opt_states` resumes from the moments already in the state.  See
    ``training.core.build_train_step_fn`` for `nan_policy`,
    `accum_steps`, `compute_dtype`, `ema_decay` and `remat`.  For k steps
    per call (a CUDA graph on the card) wrap it in ``scan_steps`` or
    ``device_dataset_steps``."""
    if self.state is None:
      raise RuntimeError("call build() first")
    specs = self.optimizer_specs()
    steps = self.train_steps()
    if train_params is not None:
      if len(steps) != 1:
        raise ValueError("train_params needs a single-TrainStep model")
      steps = [dataclasses.replace(steps[0], partitions=tuple(train_params))]
    optimizers = {}
    for ts in steps:
      opt_name = ts.optimizer or ts.partitions[0]
      spec = specs.get(opt_name, {})
      optimizers[opt_name] = make_optimizer(
          spec.get("optimizer", optimizer),
          spec.get("learning_rate", learning_rate),
          clipnorm=spec.get("clipnorm", clipnorm),
          global_clipnorm=spec.get("global_clipnorm", global_clipnorm),
          **{**opt_kwargs, **spec.get("kwargs", {})})
    opt_states = dict(self.state.opt_states) \
        if keep_opt_states and self.state.opt_states else {}
    for ts in steps:
      opt_name = ts.optimizer or ts.partitions[0]
      if opt_name not in opt_states:
        sub = extract_partitions(self.state.params, ts.partitions)
        opt_states[opt_name] = optimizers[opt_name].init(sub)
    if ema_decay is not None:
      opt_states[EMA_KEY] = self.state.params
    self.state = self.state.replace(opt_states=opt_states)
    return build_train_step_fn(steps, optimizers, nan_policy=nan_policy,
                               accum_steps=accum_steps,
                               compute_dtype=compute_dtype,
                               ema_decay=ema_decay, remat=remat)

  def make_eval_fn(self) -> Callable:
    """``eval_fn(state, batch, eps=None) -> metrics``: the ELBO terms, the
    ELBO and the loss, without gradients; the noise is drawn from a
    generator seeded 0 unless `eps` is given."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch, eps=None):
      batch = _to_device(batch, state.device)
      rng = Noise(eps=eps) if eps is not None else Noise(
          torch.Generator(state.device).manual_seed(0))
      llk, kl, _ = self.elbo_components(state.params, batch, rng, state.step,
                                        training=False,
                                        mutables=state.mutables)
      elbo = self.elbo(llk, kl)
      m = {k: torch.mean(v) for k, v in {**llk, **kl}.items()}
      m["elbo"] = torch.mean(elbo)
      m["loss"] = -m["elbo"]
      return m

    return eval_fn

  # -- training loops -------------------------------------------------------
  def fit(self,
          train,
          valid=None,
          max_iter: int = 1000,
          optimizer: str = "adam",
          learning_rate: Union[float, Callable] = 1e-3,
          valid_freq: int = 0,
          valid_interval: float = 0.0,
          logdir: Optional[str] = None,
          logging_interval: float = 5.0,
          callbacks: Sequence[Callable] = (),
          on_valid_end: Sequence[Callable] = (),
          checkpoint_freq: int = 0,
          nan_policy: str = "skip",
          clipnorm: Optional[float] = None,
          global_clipnorm: Optional[float] = None,
          steps_per_call: int = 1,
          verbose: bool = True,
          **opt_kwargs) -> Trainer:
    """Train on the batches of `train` through ``Trainer.fit``: every call
    runs `steps_per_call` steps from a CUDA graph on the card (one step a
    call at the default of 1); logging, validation and checkpoints happen
    at that granularity.  Builds the model on the card from the first
    batch's shape if it is not built.  Returns the trainer."""
    if self.state is None:
      x0, _ = self._split_inputs(next(iter(train)))
      self.build(input_shape=tuple(x0.shape)[1:])
    step_fn = self.make_step_fn(optimizer=optimizer,
                                learning_rate=learning_rate,
                                clipnorm=clipnorm,
                                global_clipnorm=global_clipnorm,
                                nan_policy=nan_policy, **opt_kwargs)
    eval_fn = self.make_eval_fn() if valid is not None else None
    trainer = Trainer(logdir=logdir, logging_interval=logging_interval,
                      log_tag=self.name)
    self.trainer = trainer
    self.state = trainer.fit(train, step_fn, self.state, valid_ds=valid,
                             valid_freq=valid_freq,
                             valid_interval=valid_interval, eval_fn=eval_fn,
                             max_iter=max_iter, callbacks=callbacks,
                             on_valid_end=on_valid_end,
                             checkpoint_freq=checkpoint_freq,
                             steps_per_call=steps_per_call, verbose=verbose)
    self.step = int(self.state.step)
    return trainer

  def fit_device_dataset(self,
                         X,
                         n_steps: int = 10000,
                         batch_size: int = 256,
                         learning_rate: Union[float, Callable] = 1e-3,
                         optimizer: str = "adam",
                         steps_per_call: int = 1000,
                         seed: int = 0,
                         verbose: bool = True,
                         sample_fn: Optional[Callable] = None,
                         keep_opt_states: bool = False,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_freq: int = 0,
                         **opt_kwargs) -> "VariationalAutoencoder":
    """Train with the whole corpus `X` (an array, or a tuple of arrays with
    a shared first axis) on the device and batches drawn there
    (``device_dataset_steps``): one call, one CUDA graph replayed
    `steps_per_call` times, with no host traffic in between.  The draws
    are keyed by `seed` and the step count, so ``load_weights`` of a
    checkpoint and ``keep_opt_states=True`` resume the run exactly.  Every
    `checkpoint_freq` steps (and at the end) the whole state is written to
    `checkpoint_path`, between calls, without a new capture."""
    if self.state is None:
      x0 = X[0] if not isinstance(X, (tuple, list)) else X[0][0]
      self.build(input_shape=tuple(np.shape(x0)))
    raw = self.make_step_fn(optimizer=optimizer, learning_rate=learning_rate,
                            keep_opt_states=keep_opt_states, **opt_kwargs)
    data = _to_device(tuple(X) if isinstance(X, (tuple, list)) else X,
                      self.device)
    k = min(int(steps_per_call), int(n_steps))
    fused = device_dataset_steps(raw, int(batch_size), k, seed=seed,
                                 sample_fn=sample_fn, donate=True)
    state = self.state
    done = last_ckpt = 0
    t0 = time.time()
    while done < n_steps:
      state, metrics = fused(state, data)
      done += k
      if verbose:
        m = {key: float(v) for key, v in metrics.items()}
        rate = done / (time.time() - t0)
        print(f"[{self.name}] #{done} " +
              " ".join(f"{key}:{v:.4g}" for key, v in m.items()) +
              f" steps_per_sec:{rate:.1f}", flush=True)
      if (checkpoint_path and checkpoint_freq > 0 and
          (done - last_ckpt >= checkpoint_freq or done >= n_steps)):
        host = state_to_host(state)
        _write_atomic(checkpoint_path, host)
        last_ckpt = done
        if verbose:
          print(f"[{self.name}] checkpoint @ step {int(host['step'])} -> "
                f"{checkpoint_path}", flush=True)
    self.state = _clone_state(state)
    self.step = int(self.state.step)
    self.capture_seconds = fused.capture_seconds  # None off the card
    return self

  # -- marginal log prob ----------------------------------------------------
  @torch.no_grad()
  def marginal_log_prob(self, x, n_samples: int = 50, seed: int = 0,
                        batch_size: Optional[int] = None, eps=None):
    """Importance-sampled ``log p(x) ~ log 1/S sum p(x|z) p(z) / q(z|x)``
    with S = `n_samples` posterior draws (from a generator seeded `seed`,
    or `eps` (S, N, zdim) standard normals).  Returns (marginal llk,
    reconstruction llk), each (N,)."""
    params = self._params_of()
    gen = self._generator(seed)

    def one_batch(xb, eb):
      qz = self._apply(params, "encode", xb)
      mean = qz.mean()
      if eb is None:
        eb = torch.randn((n_samples,) + tuple(mean.shape), generator=gen,
                         dtype=mean.dtype, device=mean.device)
      z = qz.sample((n_samples,), eps=self._tensor(eb))  # (S, B, zdim)
      px = self._apply(params, "decode", z.reshape(-1, z.shape[-1]))
      lp_x = px.log_prob(xb.repeat((n_samples,) + (1,) * (xb.ndim - 1)))
      lp_x = lp_x.reshape(n_samples, -1)
      lp_z = self._prior_on(mean.device).log_prob(z)
      iw = self.importance_weighted(lp_x + lp_z - qz.log_prob(z), axis=0)
      return iw, torch.mean(lp_x, dim=0)

    x = self._tensor(x)
    if batch_size is None:
      return one_batch(x, eps)
    iws, recs = [], []
    for i in range(0, x.shape[0], batch_size):
      iw, rec = one_batch(x[i:i + batch_size],
                          None if eps is None else eps[:, i:i + batch_size])
      iws.append(iw)
      recs.append(rec)
    return torch.cat(iws), torch.cat(recs)

  # -- persistence ----------------------------------------------------------
  def save_weights(self, path: str):
    """Pickle the whole state (``state_to_host``: params, optimizer states,
    step, skipped updates, mutables and the noise generator's state)."""
    if self.state is None:
      raise RuntimeError("call build() first")
    _write_atomic(path, state_to_host(self.state))

  def load_weights(self, path: str) -> "VariationalAutoencoder":
    """The state of ``save_weights`` (or of a checkpoint), on the model's
    device; a model not built yet is built on the device the state was
    saved from."""
    with open(path, "rb") as f:
      host = pickle.load(f)
    if self.device is None:
      self.build(device=host["device"])
    self.state = state_from_host(host, self.device)
    self.step = int(self.state.step)
    return self

  def md5_checksum(self) -> str:
    """md5 of all the params as the JAX package hashes them: the flax tree
    of ``to_jax_params`` (flax's layouts), its leaves in flax's order (keys
    sorted at every level), raveled and concatenated, so that the digest
    names the same weights in both packages."""
    from odin_tpu_torch.weights import to_jax_params

    def leaves(tree):
      for key in sorted(tree):
        if isinstance(tree[key], dict):
          yield from leaves(tree[key])
        else:
          yield tree[key]

    self._params_of()  # raises before build()
    tree = {"vae": to_jax_params(self.core)}
    return md5_checksum(np.concatenate(
        [np.asarray(v).ravel() for v in leaves(tree)]))

  def __repr__(self):
    return (f"{type(self).__name__}(zdim={self.zdim}, "
            f"input_shape={self.input_shape}, step={self.step})")


def _write_atomic(path: str, obj):
  """Pickle `obj` to ``path + '.tmp'``, then rename it into place."""
  with open(path + ".tmp", "wb") as f:
    pickle.dump(obj, f)
  os.replace(path + ".tmp", path)
