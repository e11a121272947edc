"""Per-dataset architectures of the port (PyTorch port of
``odin_tpu/networks/image_networks.py``: ``_decoder_network`` :40,
``PackImageParams`` :59, ``_obs_distribution`` :77, ``mnist_networks``
:95-154, ``cifar_networks`` :157-240, ``dsprites_networks`` :243-307,
``vq_dsprites_networks`` :314-346, ``shapes3d_networks`` :348-358,
``locatello_networks`` :361-403, ``celeba_networks`` :406-417,
``halfmoons_networks`` :420-444, the gene sets' ``_gene_networks``,
``cortex_networks`` and ``pbmc_networks`` :447-482, ``get_networks``
:488, ``get_optimizer_info`` :512).  ``is_semi_supervised`` adds each
family's labels head."""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.training.core import exponential_decay
from odin_tpu_torch.networks.base import (
    CenterAt0,
    Conv,
    ConvTranspose,
    Dense,
    Flatten,
    LogNorm,
    Reshape,
    SequentialNetwork,
    SkipSequential,
    SpaceToDepthConv,
)

__all__ = ["PackImageParams", "mnist_networks", "fashionmnist_networks",
           "binarizedmnist_networks", "omniglot_networks",
           "halfmnist_networks", "cifar_networks", "cifar10_networks",
           "cifar20_networks", "cifar100_networks", "svhn_networks",
           "dsprites_networks", "vq_dsprites_networks", "shapes3d_networks",
           "locatello_networks", "celeba_networks", "halfmoons_networks",
           "cortex_networks", "pbmc_networks", "get_networks",
           "get_optimizer_info"]


def _decoder_network(layers, skip_generator: bool = False):
  """The plain sequential decoder, or the skip-generator one that adds the
  latent, projected, to every feature map (``SkipSequential``)."""
  return (SkipSequential if skip_generator else SequentialNetwork)(layers)


class PackImageParams(nn.Module):
  """(B, H, W, C·n) conv output -> (B, n·H·W·C) flat params whose chunk `i`
  is the i-th parameter map, the layout the alias builders expect."""

  def __init__(self, n_params: int):
    super().__init__()
    self.n_params = int(n_params)

  def build(self, in_shape, generator=None):
    return (int(np.prod(in_shape)),)

  def forward(self, x):
    if self.n_params == 1:
      return x.reshape(x.shape[0], -1)
    b, h, w, cn = x.shape
    c = cn // self.n_params
    return torch.cat([x[..., i * c:(i + 1) * c].reshape(b, -1)
                      for i in range(self.n_params)], dim=-1)


def _obs_distribution(input_shape: Tuple[int, ...], distribution: str):
  """n_params (the parameter maps a pixel's channel takes) and the
  observation head (a ``DistributionDense`` named 'image' on the raw
  params) of an image likelihood: 1 map for 'bernoulli', 2 for
  'gaussian'/'normal' and 'qlogistic', the alias's own ``params_size``
  over the pixels for any other.  A mixture ('mixqlogistic') mixes whole
  images, which no per-pixel map holds: its params come from a decoder of
  their own (a PixelCNN decoder and its packing), as in JAX."""
  if distribution == "bernoulli":
    n_params = 1
  elif distribution in ("gaussian", "normal", "qlogistic",
                        "quantizedlogistic"):
    n_params = 2
  elif distribution in ("mixqlogistic", "mixqlogist"):
    raise NotImplementedError("use the PixelCNN decoder for mixture "
                              "likelihoods")
  else:
    n_params = (RVconf(input_shape, distribution).params_size //
                int(np.prod(input_shape)))
  observation = RVconf(input_shape, distribution, projection=False,
                       name="image").create_posterior()
  return n_params, observation


def mnist_networks(qz: str = "mvndiag",
                   zdim: Optional[int] = None,
                   activation="elu",
                   is_semi_supervised: bool = False,
                   is_hierarchical: bool = False,
                   centerize_image: bool = True,
                   skip_generator: bool = False,
                   **kwargs) -> Dict[str, Any]:
  """Networks for 28x28 images: conv 32-32-64-64 (kernel 5, stride
  1-2-1-2), a 196-unit projection and the mirror-image decoder; zdim 32,
  a Bernoulli likelihood by default (`distribution`), one ladder rung on
  the 14 x 14 states.  With `is_semi_supervised`, a one-hot labels head
  over `n_classes` (10) named `labels_name` ('digits')."""
  n_channels = int(kwargs.get("n_channels", 1))
  proj_dim = 196
  input_shape = (28, 28, n_channels)
  zdim = 32 if zdim is None else int(zdim)
  n_params, observation = _obs_distribution(
      input_shape, kwargs.get("distribution", "bernoulli"))
  encoder = SequentialNetwork((
      CenterAt0(enable=centerize_image),
      Conv(32, 5, 1, activation),   # 28, 28, 32
      Conv(32, 5, 2, activation),   # 14, 14, 32
      Conv(64, 5, 1, activation),   # 14, 14, 64
      Conv(64, 5, 2, activation),   # 7, 7, 64
      Flatten(),
      Dense(proj_dim, activation=None),
  ))
  decoder = _decoder_network((
      Dense(proj_dim, activation=None),
      Reshape((7, 7, proj_dim // 49)),
      ConvTranspose(64, 5, 2, activation),  # 14, 14, 64
      Conv(64, 5, 1, activation),           # 14, 14, 64
      ConvTranspose(32, 5, 2, activation),  # 28, 28, 32
      Conv(32, 5, 1, activation),           # 28, 28, 32
      Conv(n_channels * n_params, 1, 1, None),
      PackImageParams(n_params),
  ), skip_generator)
  networks = dict(
      encoder=encoder,
      decoder=decoder,
      latents=RVconf((zdim,), qz, projection=True, name="latents"),
      observation=observation,
      input_shape=input_shape,
      hierarchy=(dict(decoder_layer=3, encoder_layer=3, channels=64,
                      filters=16, kernel_size=14, strides=7),),
  )
  if is_semi_supervised:
    networks["labels"] = RVconf(
        int(kwargs.get("n_classes", 10)), "onehot", projection=True,
        name=kwargs.get("labels_name", "digits"))
  return networks


fashionmnist_networks = functools.partial(mnist_networks,
                                          labels_name="fashion")
binarizedmnist_networks = mnist_networks
omniglot_networks = functools.partial(mnist_networks, n_channels=3)
halfmnist_networks = mnist_networks


def cifar_networks(qz: str = "mvndiag",
                   zdim: Optional[int] = None,
                   activation="elu",
                   is_semi_supervised: bool = False,
                   is_hierarchical: bool = False,
                   centerize_image: bool = True,
                   skip_generator: bool = False,
                   resnet: bool = False,
                   **kwargs) -> Dict[str, Any]:
  """Networks for 32x32x3 images: conv 32-32-64-64 (kernel 4, stride
  1-2-1-2), a 512-unit projection, zdim 256 and the quantized-logistic
  likelihood by default; two ladder rungs (16 x 16 and 32 x 32).
  ``resnet=True`` puts squeeze-excitation residual stacks in place of the
  conv stacks (down blocks in the encoder, up blocks in the decoder; no
  ladder rung).  With `is_semi_supervised`, a one-hot labels head over
  `n_classes` ('labels')."""
  n_channels = int(kwargs.get("n_channels", 3))
  input_shape = (32, 32, n_channels)
  zdim = 256 if zdim is None else int(zdim)
  proj_dim = 8 * 8 * 8
  n_params, observation = _obs_distribution(
      input_shape, kwargs.get("distribution", "qlogistic"))
  if resnet:
    from odin_tpu_torch.networks.resnets import ResidualSequential
    encoder = SequentialNetwork((
        CenterAt0(enable=centerize_image),
        ResidualSequential(filters=(32, 32, 64, 64), strides=(1, 2, 1, 2),
                           activation=activation, use_se=True),  # 8, 8, 64
        Flatten(),
        Dense(proj_dim, activation=None),
    ))
    decoder = _decoder_network((
        Dense(proj_dim, activation=None),
        Reshape((8, 8, proj_dim // 64)),
        ResidualSequential(filters=(64, 64, 32, 32), strides=(-2, 1, -2, 1),
                           activation=activation, use_se=True),  # 32, 32, 32
        Conv(n_channels * n_params, 1, 1, None),
        PackImageParams(n_params),
    ), skip_generator)
  else:
    encoder = SequentialNetwork((
        CenterAt0(enable=centerize_image),
        Conv(32, 4, 1, activation),   # 32, 32, 32
        Conv(32, 4, 2, activation),   # 16, 16, 32
        Conv(64, 4, 1, activation),   # 16, 16, 64
        Conv(64, 4, 2, activation),   # 8, 8, 64
        Flatten(),
        Dense(proj_dim, activation=None),
    ))
    decoder = _decoder_network((
        Dense(proj_dim, activation=None),
        Reshape((8, 8, proj_dim // 64)),
        ConvTranspose(64, 4, 2, activation),  # 16, 16, 64
        Conv(64, 4, 1, activation),           # 16, 16, 64
        ConvTranspose(32, 4, 2, activation),  # 32, 32, 32
        Conv(32, 4, 1, activation),           # 32, 32, 32
        Conv(n_channels * n_params, 1, 1, None),
        PackImageParams(n_params),
    ), skip_generator)
  networks = dict(
      encoder=encoder,
      decoder=decoder,
      latents=RVconf((zdim,), qz, projection=True, name="latents"),
      observation=observation,
      input_shape=input_shape,
      hierarchy=() if resnet else (
          dict(decoder_layer=3, encoder_layer=3, channels=64, filters=32,
               kernel_size=8, strides=4),
          dict(decoder_layer=5, encoder_layer=1, channels=32, filters=16,
               kernel_size=8, strides=4),
      ),
  )
  if is_semi_supervised:
    networks["labels"] = RVconf(int(kwargs.get("n_classes", 10)), "onehot",
                                projection=True, name="labels")
  return networks


cifar10_networks = functools.partial(cifar_networks, n_classes=10)
cifar20_networks = functools.partial(cifar_networks, n_classes=20)
cifar100_networks = functools.partial(cifar_networks, n_classes=100)
svhn_networks = functools.partial(cifar_networks, n_classes=10)


def dsprites_networks(qz: str = "mvndiag",
                      zdim: Optional[int] = None,
                      activation="elu",
                      is_semi_supervised: bool = False,
                      is_hierarchical: bool = False,
                      centerize_image: bool = True,
                      skip_generator: bool = False,
                      **kwargs) -> Dict[str, Any]:
  """Networks for 64x64 images: conv 32-32-64-64 stride 2, kernel 4, proj
  128, the mirror-image transposed-conv decoder, and the ``hierarchy``
  spec of the ladder and U-Net models.  With
  `is_semi_supervised`, a labels head regressing the 5 factors with a
  Gaussian ('factors'; `n_factors` of them).  ``space_to_depth=True``
  makes the first conv its exact ``SpaceToDepthConv`` rewrite (the same
  params)."""
  n_channels = int(kwargs.get("n_channels", 1))
  input_shape = (64, 64, n_channels)
  zdim = 10 if zdim is None else int(zdim)
  w = int(kwargs.get("width", 1))
  proj_dim = int(kwargs.get("proj_dim") or
                 (128 if n_channels == 1 else 256) * w)
  n_params, observation = _obs_distribution(
      input_shape, kwargs.get("distribution", "bernoulli"))
  first_conv = (SpaceToDepthConv(32 * w, activation)
                if kwargs.get("space_to_depth")
                else Conv(32 * w, 4, 2, activation))
  encoder = SequentialNetwork((
      CenterAt0(enable=centerize_image),
      first_conv,                       # 32, 32, 32w
      Conv(32 * w, 4, 2, activation),   # 16, 16, 32w
      Conv(64 * w, 4, 2, activation),   # 8, 8, 64w
      Conv(64 * w, 4, 2, activation),   # 4, 4, 64w
      Flatten(),
      Dense(proj_dim, activation=None),
  ))
  decoder = _decoder_network((
      Dense(proj_dim, activation=None),
      Reshape((4, 4, proj_dim // 16)),
      ConvTranspose(64 * w, 4, 2, activation),  # 8, 8, 64w
      ConvTranspose(64 * w, 4, 2, activation),  # 16, 16, 64w
      ConvTranspose(32 * w, 4, 2, activation),  # 32, 32, 32w
      ConvTranspose(32 * w, 4, 2, activation),  # 64, 64, 32w
      Conv(n_channels * n_params, 1, 1, None),
      PackImageParams(n_params),
  ), skip_generator)
  networks = dict(
      encoder=encoder,
      decoder=decoder,
      latents=RVconf((zdim,), qz, projection=True, name="latents"),
      observation=observation,
      input_shape=input_shape,
      # one ladder rung on the 16 x 16 states: the decoder's after its
      # second transposed conv (64 channels), the encoder's second conv
      # (32 channels); given whatever `is_hierarchical` says, as in JAX
      hierarchy=(dict(decoder_layer=3, encoder_layer=2, channels=64,
                      filters=16, kernel_size=8, strides=4),),
  )
  if is_semi_supervised:
    networks["labels"] = RVconf(int(kwargs.get("n_factors", 5)), "gaussian",
                                projection=True, name="factors")
  return networks


dspritessmall_networks = dsprites_networks
dsprites0_networks = dsprites_networks


def vq_dsprites_networks(activation="elu", centerize_image: bool = True,
                         **kwargs) -> Dict[str, Any]:
  """Map-preserving networks for the spatial VQ-VAE: the encoder stops at
  the 8x8 feature map (no Flatten, no Dense) and the decoder takes the
  quantized 8x8 code map.  For ``VQVAE(spatial=True, ...)``."""
  n_channels = int(kwargs.get("n_channels", 1))
  input_shape = (64, 64, n_channels)
  w = int(kwargs.get("width", 1))
  n_params, observation = _obs_distribution(
      input_shape, kwargs.get("distribution", "bernoulli"))
  encoder = SequentialNetwork((
      CenterAt0(enable=centerize_image),
      Conv(32 * w, 4, 2, activation),   # 32, 32, 32w
      Conv(32 * w, 4, 2, activation),   # 16, 16, 32w
      Conv(64 * w, 4, 2, activation),   # 8, 8, 64w
      Conv(64 * w, 3, 1, activation),   # 8, 8, 64w (the map is kept)
  ))
  decoder = _decoder_network((
      Conv(64 * w, 3, 1, activation),           # 8, 8, 64w
      ConvTranspose(64 * w, 4, 2, activation),  # 16, 16, 64w
      ConvTranspose(32 * w, 4, 2, activation),  # 32, 32, 32w
      ConvTranspose(32 * w, 4, 2, activation),  # 64, 64, 32w
      Conv(n_channels * n_params, 1, 1, None),
      PackImageParams(n_params),
  ))
  return dict(encoder=encoder, decoder=decoder, latents=None,
              observation=observation, input_shape=input_shape)


def shapes3d_networks(qz: str = "mvndiag", zdim: Optional[int] = None,
                      **kwargs) -> Dict[str, Any]:
  """Shapes3D's 64x64x3 images: the dSprites trunk with 3 channels (proj
  256) and 6 ground-truth factors for a labels head."""
  kwargs.setdefault("n_channels", 3)
  kwargs.setdefault("n_factors", 6)
  return dsprites_networks(qz=qz, zdim=zdim, **kwargs)


shapes3dsmall_networks = shapes3d_networks
shapes3d0_networks = shapes3d_networks


def locatello_networks(qz: str = "mvndiag", zdim: Optional[int] = None,
                       **kwargs) -> Dict[str, Any]:
  """disentanglement_lib's conv trunk (Locatello et al. 2019), behind the
  published dSprites and Shapes3D numbers: ReLU; encoder kernels 4-4-2-2
  (32-32-64-64, stride 2) and an fc-256 ReLU projection; a 256 -> 1024
  ReLU decoder stem; no input centring; no ``hierarchy`` rung."""
  n_channels = int(kwargs.get("n_channels", 1))
  input_shape = (64, 64, n_channels)
  zdim = 10 if zdim is None else int(zdim)
  n_params, observation = _obs_distribution(
      input_shape, kwargs.get("distribution", "bernoulli"))
  encoder = SequentialNetwork((
      Conv(32, 4, 2, "relu"),   # 32, 32, 32
      Conv(32, 4, 2, "relu"),   # 16, 16, 32
      Conv(64, 2, 2, "relu"),   # 8, 8, 64
      Conv(64, 2, 2, "relu"),   # 4, 4, 64
      Flatten(),
      Dense(256, activation="relu"),
  ))
  decoder = _decoder_network((
      Dense(256, activation="relu"),
      Dense(1024, activation="relu"),
      Reshape((4, 4, 64)),
      ConvTranspose(64, 4, 2, "relu"),  # 8, 8, 64
      ConvTranspose(64, 4, 2, "relu"),  # 16, 16, 64
      ConvTranspose(32, 4, 2, "relu"),  # 32, 32, 32
      ConvTranspose(n_channels * n_params, 4, 2, None),  # 64, 64, C·n
      PackImageParams(n_params),
  ), kwargs.get("skip_generator", False))
  return dict(
      encoder=encoder,
      decoder=decoder,
      latents=RVconf((zdim,), qz, projection=True, name="latents"),
      observation=observation,
      input_shape=input_shape,
      hierarchy=(),
  )


def celeba_networks(qz: str = "mvndiag", zdim: Optional[int] = None,
                    **kwargs) -> Dict[str, Any]:
  """CelebA's 64x64x3 images: the dSprites trunk with 3 channels, zdim
  45; with `is_semi_supervised`, a Bernoulli labels head over the
  `n_labels` (40) attributes ('attributes')."""
  kwargs.setdefault("n_channels", 3)
  zdim = 45 if zdim is None else zdim
  nets = dsprites_networks(qz=qz, zdim=zdim, **{k: v for k, v in kwargs.items()
                                                if k != "n_factors"})
  if kwargs.get("is_semi_supervised", False):
    nets["labels"] = RVconf(int(kwargs.get("n_labels", 40)), "bernoulli",
                            projection=True, name="attributes")
  return nets


def halfmoons_networks(qz: str = "mvndiag",
                       zdim: Optional[int] = None,
                       activation="relu",
                       is_semi_supervised: bool = False,
                       is_hierarchical: bool = False,
                       **kwargs) -> Dict[str, Any]:
  """MLPs for the 2-D half-moons: three Dense(64) each way, a Gaussian
  observation ('moons'); with `is_semi_supervised`, a one-hot labels head
  over the two moons ('labels')."""
  zdim = 2 if zdim is None else int(zdim)
  networks = dict(
      encoder=SequentialNetwork(tuple(Dense(64, activation)
                                      for _ in range(3))),
      decoder=SequentialNetwork(tuple(Dense(64, activation)
                                      for _ in range(3))),
      latents=RVconf((zdim,), qz, projection=True, name="latents"),
      observation=RVconf((2,), "gaussian", projection=True, name="moons"),
      input_shape=(2,),
      hierarchy=(),
  )
  if is_semi_supervised:
    networks["labels"] = RVconf(2, "onehot", projection=True, name="labels")
  return networks


def _gene_networks(input_dim: int, n_labels: int, qz: str = "mvndiag",
                   zdim: Optional[int] = None, activation="relu",
                   is_semi_supervised: bool = False,
                   is_hierarchical: bool = False,
                   **kwargs) -> Dict[str, Any]:
  """Gene-expression MLPs: ``LogNorm`` (log1p of counts per 10,000) then
  two Dense(`hidden_dim`, 128) in the encoder, two in the decoder, and a
  count likelihood over the genes ('genes'; `distribution`, 'zinbd' by
  default); with `is_semi_supervised`, a one-hot head over the cell types
  ('celltype')."""
  zdim = 10 if zdim is None else int(zdim)
  hidden = int(kwargs.get("hidden_dim", 128))
  networks = dict(
      encoder=SequentialNetwork((LogNorm(),) + tuple(
          Dense(hidden, activation) for _ in range(2))),
      decoder=SequentialNetwork(tuple(Dense(hidden, activation)
                                      for _ in range(2))),
      latents=RVconf((zdim,), qz, projection=True, name="latents"),
      observation=RVconf((input_dim,), kwargs.get("distribution", "zinbd"),
                         projection=True, name="genes"),
      input_shape=(input_dim,),
      hierarchy=(),
  )
  if is_semi_supervised:
    networks["labels"] = RVconf(n_labels, "onehot", projection=True,
                                name="celltype")
  return networks


cortex_networks = functools.partial(_gene_networks, input_dim=558, n_labels=7)
pbmc_networks = functools.partial(_gene_networks, input_dim=1000, n_labels=4)


_DSNAME_MAP = dict(halfmnist="mnist")


def get_networks(dataset_name, *, is_semi_supervised: bool = False,
                 is_hierarchical: bool = False, qz: str = "mvndiag",
                 zdim: Optional[int] = None, **kwargs) -> Dict[str, Any]:
  """Dispatch ``<name>_networks`` by dataset name."""
  if hasattr(dataset_name, "name"):
    dataset_name = dataset_name.name
  if zdim is not None and zdim <= 0:
    zdim = None
  name = str(dataset_name).lower().strip()
  name = _DSNAME_MAP.get(name, name)
  for key, fn in globals().items():
    if key.endswith("_networks") and key.split("_")[0] == name:
      return fn(qz=qz, zdim=zdim, is_semi_supervised=is_semi_supervised,
                is_hierarchical=is_hierarchical, **kwargs)
  raise ValueError(f"no pre-implemented network for dataset "
                   f"'{dataset_name}'")


def get_optimizer_info(dataset_name: str,
                       batch_size: int = 64) -> Dict[str, Any]:
  """Per-dataset training budget: ``max_iter`` and an exponential-decay
  learning-rate schedule of the optimizer's update count (0.996 every
  10,000 updates, staircase)."""
  name = str(dataset_name).strip().lower()
  name = _DSNAME_MAP.get(name, name)
  decay_rate, decay_steps, init_lr = 0.996, 10000, 1e-3
  if name == "halfmoons":
    n_epochs, n_samples = 200, 3200
  elif name == "mnist" or name == "binarizedmnist":
    n_epochs, n_samples = 800, 55000
  elif name == "fashionmnist":
    n_epochs, n_samples = 1000, 55000
  elif name == "omniglot":
    n_epochs, n_samples = 1000, 19280
  elif "svhn" in name:
    n_epochs, n_samples = 2000, 69594
  elif "cifar" in name:
    n_epochs, n_samples, init_lr = 2500, 48000, 5e-4
  elif "dsprites" in name:
    n_epochs, n_samples = 400, 663552
  elif "shapes3d" in name:
    n_epochs, n_samples, init_lr = (250 if "small" in name else 400), 432000, 2e-4
  elif "celeba" in name:
    n_epochs, n_samples, init_lr = (2000 if "small" in name else 3000), 162770, 2e-4
  elif "cortex" in name:
    n_epochs, n_samples, init_lr = 500, 5000, 1e-4
  elif "pbmc" in name:
    n_epochs, n_samples, init_lr = 500, 5000, 1e-4
  else:
    raise NotImplementedError(f"no optimizer info for dataset '{dataset_name}'")
  max_iter = int(n_samples / batch_size * n_epochs)
  lr = exponential_decay(init_lr, transition_steps=decay_steps,
                         decay_rate=decay_rate, staircase=True)
  return dict(max_iter=max_iter, learning_rate=lr)
