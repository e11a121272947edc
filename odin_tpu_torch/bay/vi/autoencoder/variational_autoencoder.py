"""VariationalAutoencoder of the port: build, encode, decode, sample, the
ELBO and its training steps (PyTorch port of ``VAECore``,
``VariationalAutoencoder`` and ``Autoencoder``,
``SemiSupervisedVAE``,
``odin_tpu/bay/vi/autoencoder/variational_autoencoder.py:55-466,606-694``;
``masked_mean_llk`` of ``multitask_vae.py:37-44``).

As in the JAX package the model holds its hyperparameters and a
``TrainState``; every computation reads the params of a state
(``torch.func.functional_call`` on the ``VAECore``), so that a state a
training step returned serves once it is assigned to ``vae.state``.
``vae.core.load_state_dict`` writes through to ``vae.state`` and
``vae.core.state_dict()`` reads it.  Training: ``fit`` (``Trainer.fit`` over
``make_step_fn``) and ``fit_device_dataset`` (batches drawn on the card);
``save_weights``/``load_weights`` keep the whole state, the noise
generator's included.

A model's params are partitions: ``'vae'`` (the core) and one for each of
``extra_networks()`` (FactorVAE's ``'discriminator'``, TwoStageVAE's
``'stage2'``, VampriorVAE's ``'pseudo_inputs'``); its buffers (BatchNorm's
running statistics, a VQ codebook's EMA) are ``TrainState.mutables`` of
the same partitions.  A module applied in training mode to a ``mutables``
dict writes the new values of its partition's buffers into that dict
(``_call``); each ``TrainStep`` may have its own optimizer
(``optimizer_specs``).

An optional labels head (``labels=RVconf(...)``) reads the latents or, for
a model with ``skip_decoder = False``, the decoder's hidden state; the
choice is fixed when the core is made, so that the head's width is known.
Semi-supervised batches are ``(x, y, mask)``, mask 1 on the labelled rows
(``_split_inputs(batch, mask=True)``).
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
from odin_tpu_torch.bay.distributions.sampling import check_rejections
from odin_tpu_torch.bay.helpers import kl_divergence, map_distributions
from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi._base import VariationalModel, traverse_dims
from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.networks.base import (Dense, SequentialNetwork,
                                         collecting_updates)
from odin_tpu_torch.training.core import (
    EMA_KEY,
    Noise,
    TrainState,
    TrainStep,
    TrainStepFn,
    _clone_state,
    _mix32,
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

__all__ = ["VAECore", "VariationalAutoencoder", "VAE", "Autoencoder",
           "SemiSupervisedVAE", "masked_mean_llk"]


def masked_mean_llk(llk: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
  """Per-row `llk` scaled so that its batch mean is the mean over the
  labelled rows (``mask`` 1) alone; 0 on a batch with no labelled row
  (the sum of the mask is floored at 1).  No mask: `llk` as it is."""
  if mask is None:
    return llk
  mask = mask.reshape(-1).to(llk.dtype)
  denom = torch.clamp(torch.sum(mask), min=1.0)
  return llk * mask * (mask.shape[0] / denom)


def _as_head(head, default_name: str) -> nn.Module:
  """An ``RVconf`` becomes a head named by its role (`default_name`), as in
  the JAX package; a given module returning a distribution (a
  ``DistributionDense``, VQ-VAE's ``VectorQuantizer``) is the head."""
  if isinstance(head, RVconf):
    return head.create_posterior(name=default_name)
  if isinstance(head, nn.Module):
    return head
  raise ValueError(f"cannot interpret {head!r} as a distribution head")


def _buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
  return {k: v.detach().clone() for k, v in module.named_buffers()}


class VAECore(nn.Module):
  """encoder -> latents head; decoder -> observation head; an optional
  labels head on the latents (`labels_input` 'latents') or on the
  decoder's hidden state ('decoder_hidden').  Its parameter names follow
  the flax tree (``encoder.layers.1.weight`` is
  ``encoder/layers_1/Conv_0/kernel``; see ``odin_tpu_torch.weights``)."""

  def __init__(self, encoder: nn.Module, decoder: nn.Module,
               latents: nn.Module, observation: nn.Module,
               labels: Optional[nn.Module] = None,
               labels_input: str = "latents"):
    super().__init__()
    self.encoder = encoder
    self.decoder = decoder
    self.latents = latents
    self.observation = observation
    self.labels = labels
    self.labels_input = labels_input

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    z = self.latents.build(h, generator)
    hd = self.decoder.build(z, generator)
    self.observation.build(hd, generator)
    if self.labels is not None:
      self.labels.build(z if self.labels_input == "latents" else hd,
                        generator)

  def encode(self, x) -> Distribution:
    return self.latents(self.encoder(x))

  def decode(self, z) -> Distribution:
    return self.observation(self.decoder(z))

  def decoder_hidden(self, z) -> torch.Tensor:
    return self.decoder(z)

  def predict_labels(self, h) -> Distribution:
    return self.labels(h)

  def forward(self, *args, method: Optional[str] = None):
    """``method`` (any method's name: 'encode', 'decode', ...) calls that
    method on `args`, so that ``functional_call`` can run it on given
    params; without it, x -> (px at the posterior mean, qz)."""
    if method is not None:
      return getattr(self, method)(*args)
    qz = self.encode(args[0])
    return self.decode(qz.mean()), qz


class VariationalAutoencoder(VariationalModel):
  """Vanilla VAE: ``vae = BetaVAE(**get_networks('dsprites')).build()``,
  then ``qz = vae.encode(x)``, ``px = vae.decode(z)``,
  ``qz, px = vae.reconstruct(x)`` (the hook a model whose decoder needs the
  encoder's states overrides, as the ladder and U-Net models do); training:
  ``step = vae.make_step_fn()``, ``vae.state, metrics = step(vae.state,
  x)``.  Images are NHWC."""

  def __init__(self,
               encoder: Optional[nn.Module] = None,
               decoder: Optional[nn.Module] = None,
               latents: Union[RVconf, DistributionDense, None] = None,
               observation: Union[RVconf, DistributionDense, None] = None,
               labels: Union[RVconf, DistributionDense, None] = None,
               input_shape: Optional[Tuple[int, ...]] = None,
               hierarchy: Sequence[dict] = (),
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
    # the JAX package's defaults: 32 'mvndiag' latents, a Gaussian
    # observation of input_shape, two Dense(64, relu) each way
    if latents is None:
      latents = RVconf(32, "mvndiag", projection=True, name="latents")
    if observation is None and input_shape is not None:
      observation = RVconf(tuple(input_shape), "gaussian", projection=True,
                           name="observation")
    if encoder is None:
      encoder = SequentialNetwork(tuple(Dense(64, "relu") for _ in range(2)))
    if decoder is None:
      decoder = SequentialNetwork(tuple(Dense(64, "relu") for _ in range(2)))
    self.encoder_net = encoder
    self.decoder_net = decoder
    self.latents_conf = latents if isinstance(latents, RVconf) else None
    self.labels_conf = labels if isinstance(labels, RVconf) else None
    self.latents_head = _as_head(latents, "latents")
    self.observation_head = _as_head(observation, "observation")
    self.labels_head = _as_head(labels, "labels") if labels is not None \
        else None
    # the ladder rungs' and U-Net skips' spec (``get_networks`` gives it to
    # every class; the ladder and U-Net cores read it)
    self.hierarchy = tuple(hierarchy)
    self.core = self._build_core()
    self.input_shape = tuple(input_shape) if input_shape is not None else None
    self.device: Optional[torch.device] = None
    self.state: Optional[TrainState] = None
    self.step = 0
    self.extras: Dict[str, nn.Module] = {}
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

  def _build_core(self) -> nn.Module:
    """The core of the partition 'vae'; a subclass hook.  The labels head
    reads the latents unless the model sets ``skip_decoder = False``."""
    labels_input = "latents" if getattr(self, "skip_decoder", True) \
        else "decoder_hidden"
    return VAECore(self.encoder_net, self.decoder_net, self.latents_head,
                   self.observation_head, self.labels_head, labels_input)

  def _core_params(self) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in self.core.named_parameters()}

  def extra_networks(self) -> Dict[str, Tuple[nn.Module, Optional[tuple]]]:
    """Further modules, each its own params partition: ``{name: (module,
    the shape of one input without the batch dim, or None for a module
    that takes no input)}``; a subclass hook."""
    return {}
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
    """Create the parameters of every partition from `seed` (drawn on the
    CPU, so that a seed gives the same weights on every device: the core
    from a generator seeded `seed`, the i-th extra network from one seeded
    by a hash of `seed` and i, as the JAX package splits a key for each),
    move them to `device`, and start ``self.state`` on them with the
    modules' buffers as its mutables; the state's generator is seeded with
    ``seed + 1``, as the JAX package keys its state."""
    if input_shape is not None:
      self.input_shape = tuple(i for i in input_shape if i is not None)
    if self.input_shape is None:
      raise ValueError("input_shape must be provided")
    device = resolve_device(device)
    self.core.build(self.input_shape, torch.Generator().manual_seed(seed))
    self.core.to(device).eval()
    params = {"vae": self._core_params()}
    mutables = {"vae": _buffers(self.core)}
    self.extras = {}
    for i, (name, (module, in_shape)) in enumerate(
        self.extra_networks().items()):
      gen = torch.Generator().manual_seed(int(_mix32(
          (_mix32(int(seed) & 0xFFFFFFFF) + i + 1) & 0xFFFFFFFF)))
      module.build(in_shape, gen)
      module.to(device).eval()
      self.extras[name] = module
      params[name] = {k: v.detach().clone()
                      for k, v in module.named_parameters()}
      mutables[name] = _buffers(module)
    self.device = device
    self.state = TrainState(
        params=params,
        opt_states={},
        step=torch.zeros((), dtype=torch.int32, device=device),
        rng=torch.Generator(device).manual_seed(seed + 1),
        mutables={k: v for k, v in mutables.items() if v})
    return self

  # -- apply ----------------------------------------------------------------
  @staticmethod
  def _call(module: nn.Module, partition: str, params, args, kwargs=None,
            training: bool = False, mutables: Optional[Dict] = None,
            noise: Optional[Noise] = None):
    """`module` on the tensors of `partition`: its params, and its buffers
    from `mutables` (or the module's own).  In training mode with a
    `mutables` dict, the buffers' new values (``record_update``) replace
    ``mutables[partition]`` in that dict, as a flax ``apply(...,
    mutable=...)`` returns them; `noise` is where such a layer draws."""
    module.train(training)
    tensors = dict(params[partition])
    held = mutables.get(partition) if mutables else None
    if held:
      tensors.update(held)
    with collecting_updates(noise) as updates:
      out = torch.func.functional_call(module, tensors, tuple(args),
                                       kwargs or {})
    if training and held is not None and updates:
      prefix = {id(m): name for name, m in module.named_modules()}
      new = dict(held)
      for (m, buf), value in updates.items():
        new[f"{prefix[id(m)]}.{buf}" if prefix[id(m)] else buf] = value
      mutables[partition] = new
    return out

  def _apply(self, params: Dict[str, Any], method: str, x,
             training: bool = False, mutables: Optional[Dict] = None,
             noise: Optional[Noise] = None):
    """The core's `method` ('encode' or 'decode') on `params`."""
    return self._core(params, method, x, training=training,
                      mutables=mutables, noise=noise)

  def _core(self, params: Dict[str, Any], method: str, *args,
            training: bool = False, mutables: Optional[Dict] = None,
            noise: Optional[Noise] = None):
    """The core's `method` on `params`, with any number of arguments."""
    return self._call(self.core, "vae", params, args, {"method": method},
                      training, mutables, noise)

  def _apply_module(self, params: Dict[str, Any], name: str, *args,
                    training: bool = False, mutables: Optional[Dict] = None,
                    noise: Optional[Noise] = None,
                    method: Optional[str] = None):
    """The extra network `name` (its own partition) on `params`; `method`
    is passed to its forward (a ``VAECore``'s 'encode' or 'decode')."""
    return self._call(self.extras[name], name, params, args,
                      None if method is None else {"method": method},
                      training, mutables, noise)

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
  def _mutables(self) -> Dict:
    return self.state.mutables if self.state is not None else {}

  def encode(self, x, params: Optional[Dict] = None) -> Distribution:
    """x (B, H, W, C) -> qz."""
    return self._apply(params or self._params_of(), "encode", self._tensor(x),
                       mutables=self._mutables())

  def decode(self, z, params: Optional[Dict] = None
             ) -> Union[Distribution, Tuple[Distribution, Tuple[int, ...]]]:
    """z (B, zdim) -> px.  z with leading sample dims (S..., B, zdim) is
    decoded as (S·...·B, zdim) and returns ``(px, lead)``, ``lead`` the
    shape z had without its last dim, as in the JAX package."""
    params = params or self._params_of()
    z = self._tensor(z)
    mut = self._mutables()
    if z.ndim > 2:
      lead = tuple(z.shape[:-1])
      return self._apply(params, "decode", z.reshape(-1, z.shape[-1]),
                         mutables=mut), lead
    return self._apply(params, "decode", z, mutables=mut)

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
    return qz, self._apply(params, "decode", qz.mean(),
                           mutables=self._mutables())

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
    the noise itself: z is qz's sample of ``sample_shape`` from it (for a
    Gaussian posterior, ``sample_shape + (B, zdim)`` standard normals).
    In training mode the modules' buffers move in `mutables`."""
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz = self._apply(params, "encode", x, training, mutables, noise)
    z = qz.sample_from(noise, self.sample_shape)
    if self.sample_shape:
      z_flat = z.reshape((-1, z.shape[-1]))
      px = self._apply(params, "decode", z_flat, training, mutables, noise)
      n = int(np.prod(self.sample_shape))
      llk_s = px.log_prob(x.repeat((n,) + (1,) * (x.ndim - 1)))
      llk_x = llk_s.reshape(tuple(self.sample_shape) + (-1,)).mean(
          dim=tuple(range(len(self.sample_shape))))
    else:
      px = self._apply(params, "decode", z, training, mutables, noise)
      llk_x = px.log_prob(x)
    obs_name = self.core.observation.name or "observation"
    llk = {f"llk_{obs_name}": llk_x}
    kl_z = kl_divergence(qz, self._prior_on(z.device),
                         analytic=self.analytic,
                         q_sample=z if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    lat_name = self.core.latents.name or "latents"
    kl = {f"kl_{lat_name}": kl_z}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)

  @staticmethod
  def _split_inputs(batch, mask: bool = False):
    """(x, y) of a batch: x alone, a tuple ``(x, y[, mask])`` or a dict
    (``inputs``/``x``, ``labels``/``y``, ``mask``); y is None where the
    batch has none.  With `mask`, (x, y, mask), mask None where absent."""
    if isinstance(batch, (tuple, list)):
      x = batch[0]
      y = batch[1] if len(batch) > 1 else None
      m = batch[2] if len(batch) > 2 else None
    elif isinstance(batch, dict):
      x = batch.get("inputs", batch.get("x"))
      y = batch.get("labels", batch.get("y"))
      m = batch.get("mask")
    else:
      x, y, m = batch, None, None
    return (x, y, m) if mask else (x, y)

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
    ``device_dataset_steps``.

    Each ``TrainStep`` updates with the optimizer it names (its first
    partition by default), built from these arguments overridden by
    ``optimizer_specs()[name]``; steps that name one optimizer share it and
    its state, and each later step sees the params the earlier ones
    updated."""
    if self.state is None:
      raise RuntimeError("call build() first")
    specs = self.optimizer_specs()
    steps = self.train_steps()
    if train_params is not None:
      if len(steps) != 1:  # JAX's rule: whose partitions would it replace?
        raise ValueError(
            f"train_params override requires a single-TrainStep model; "
            f"{type(self).__name__} trains the steps "
            f"{[ts.name for ts in steps]}")
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
                                        mutables=dict(state.mutables))
      elbo = self.elbo(llk, kl)
      m = {k: torch.mean(v) for k, v in {**llk, **kl}.items()}
      m["elbo"] = torch.mean(elbo)
      m["loss"] = -m["elbo"]
      check_rejections()
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
    check_rejections()
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
    check_rejections()
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

    mut = self._mutables()

    def one_batch(xb, eb):
      qz = self._apply(params, "encode", xb, mutables=mut)
      mean = qz.mean()
      if eb is None:
        eb = torch.randn((n_samples,) + tuple(mean.shape), generator=gen,
                         dtype=mean.dtype, device=mean.device)
      z = qz.sample((n_samples,), eps=self._tensor(eb))  # (S, B, zdim)
      px = self._apply(params, "decode", z.reshape(-1, z.shape[-1]),
                       mutables=mut)
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
    of ``to_jax_params`` (flax's layouts) of every partition, its leaves in
    flax's order (keys sorted at every level), raveled and concatenated, so
    that the digest names the same weights in both packages."""
    from odin_tpu_torch.weights import to_jax_params

    def leaves(tree):
      for key in sorted(tree):
        if isinstance(tree[key], dict):
          yield from leaves(tree[key])
        else:
          yield tree[key]

    params = self._params_of()  # raises before build()
    tree = {"vae": to_jax_params(self.core)}
    for name, module in self.extras.items():
      tree[name] = to_jax_params(module, params[name])
    return md5_checksum(np.concatenate(
        [np.asarray(v).ravel() for v in leaves(tree)]))

  def __repr__(self):
    return (f"{type(self).__name__}(zdim={self.zdim}, "
            f"input_shape={self.input_shape}, step={self.step})")


VAE = VariationalAutoencoder


class SemiSupervisedVAE(VariationalAutoencoder):
  """Base for users subclassing the semi-supervised surface: marks the
  class semi-supervised and carries the merging of unsupervised and
  supervised objectives and the zeroing of an empty labelled batch.  The
  semi-supervised classes of the port (M2VAE, MultitaskVAE, SemafoVAE,
  SemiFactorVAE, ...) keep the same contract through
  ``is_semi_supervised``."""

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  @staticmethod
  def ignore_empty(is_empty, loss_dict):
    """Every term of `loss_dict` zeroed where `is_empty` (a boolean tensor,
    no host sync)."""
    return {k: torch.where(torch.as_tensor(is_empty, device=v.device),
                           torch.zeros_like(v), v)
            for k, v in loss_dict.items()}

  @staticmethod
  def merge_objectives(llk_uns, kl_uns, llk_sup, kl_sup):
    """The unsupervised terms under ``uns/`` and the batch means of the
    supervised ones under ``sup/``: (llk, kl)."""
    llk = {**{f"uns/{k}": v for k, v in llk_uns.items()},
           **{f"sup/{k}": torch.mean(v) for k, v in llk_sup.items()}}
    kl = {**{f"uns/{k}": v for k, v in kl_uns.items()},
          **{f"sup/{k}": torch.mean(v) for k, v in kl_sup.items()}}
    return llk, kl


class Autoencoder(VariationalAutoencoder):
  """Deterministic autoencoder: the latents are a point mass
  ('vdeterministic'), z is their value, and the KL term is 0."""

  def __init__(self, latents=None, **kwargs):
    if latents is None:
      latents = RVconf(32, "vdeterministic", projection=True, name="latents")
    elif isinstance(latents, RVconf):
      latents = latents.copy(posterior="vdeterministic")
    super().__init__(latents=latents, **kwargs)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz = self._apply(params, "encode", x, training, mutables, noise)
    z = qz.mean()
    px = self._apply(params, "decode", z, training, mutables, noise)
    llk = {"llk_observation": px.log_prob(x)}
    kl = {"kl_latents": torch.zeros(z.shape[0], dtype=z.dtype,
                                    device=z.device)}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)


def _write_atomic(path: str, obj):
  """Pickle `obj` to ``path + '.tmp'``, then rename it into place."""
  with open(path + ".tmp", "wb") as f:
    pickle.dump(obj, f)
  os.replace(path + ".tmp", path)
