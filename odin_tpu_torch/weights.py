"""Bridge between flax parameter trees and the port's ``state_dict``s.

The trees are those of ``odin_tpu``'s models as numpy arrays, e.g.
``jax.device_get(vae.state.params)``; the state dicts are those of the
port's ``VAECore`` (or any module built from ``odin_tpu_torch.networks``).
The layout rules:

  * ``Conv`` kernels are HWIO in flax and OIHW in torch;
  * flax's ``ConvTranspose`` kernel is unflipped (kh, kw, in, out); the
    port's ``ConvTranspose`` weight is (in, out, kh, kw) with both spatial
    axes flipped (see ``networks.base.ConvTranspose``);
  * ``Dense`` kernels are (in, out) in flax and (out, in) in torch;
  * 1-D kernels (``networks.time_delay``'s TDNN layers, ``util_layers``'
    ``Conv1DTranspose``) are (k, in, out) in flax and (out, in, k) in the
    port, a transposed one's (in, out, k) flipped; a 1-D layer names the
    flax primitive that holds its weight (``flax_kind``: ``Conv_0``,
    ``Dense_0`` for an irregular ``TimeDelay`` context,
    ``ConvTranspose_0``), and ``TimeDelayConvTied``'s raw ``kernel`` is
    held by the layer itself;
  * activations stay NHWC, so ``Flatten`` before a ``Dense`` needs no
    permutation of the Dense kernel.

Attention (``networks.attention``):

  * flax's ``MultiHeadDotProductAttention_0`` has no module of its own in
    the port's ``MultiHeadAttention``; its ``query``, ``key`` and ``value``
    kernels (F_in, H, D_h) become ``Dense`` weights (H·D_h, F_in), their
    biases (H, D_h) become (H·D_h,), and the ``out`` kernel (H, D_h, F_out)
    becomes the weight (F_out, H·D_h);
  * ``Attention``'s raw parameter ``v_add`` keeps its name and shape.

Recurrent cells: flax's ``nn.GRUCell`` (gates ``ir``, ``iz``, ``in`` with
bias, ``hr``, ``hz`` without, ``hn`` with) is the port's ``GRUCell``:
``weight_ih`` is ``[ir; iz; in]`` and ``weight_hh`` ``[hr; hz; hn]``, each
kernel transposed, ``bias_ih`` ``[b_ir; b_iz; b_in]`` and ``bias_hn`` the
``hn`` bias.  ``nn.OptimizedLSTMCell`` (``ii/if/ig/io`` without bias,
``hi/hf/hg/ho`` with) is ``util_layers.LSTMCell``: ``weight_ih`` ``[ii;
if; ig; io]``, ``weight_hh`` ``[hi; hf; hg; ho]`` and ``bias_hh``;
``nn.SimpleCell`` (``i`` with bias, ``h`` without) is ``SimpleCell``:
``weight_ih``, ``weight_hh`` and ``bias_ih``.  ``BatchRenormalization``
holds its ``gamma`` and ``beta`` itself, its running ``mean`` and ``var``
in ``batch_stats``.

Path rules: flax's ``layers_<i>`` is ``layers.<i>``, and so are the
per-modality lists of ``MoeVAE`` (``encoders_<m>``, ``decoders_<m>``,
``latent_heads_<m>``, ``observations_<m>``); the primitive a
wrapper layer holds (``Conv_0``, ``ConvTranspose_0``, ``Dense_0``,
``BatchNorm_0``) has no module of its own in the port; ``Attention``'s
``position`` Dense is ``position_proj``; ``kernel`` is ``weight``; a
parameter a module holds itself (``v_add``, a VQ ``codebook``, VampPrior's
``pseudo_inputs``, a label embedder's ``table/embedding``, the four vectors
of M3's ``regressor``, the linear LDA decoder's ``topics_words``, the
Grade-of-Membership model's stacked ``enc_w<i>``/``enc_b<i>``,
``conc_w``/``conc_b`` and ``profile_logits``, an autoregressive head's
MADE ``kernel_<i>``/``bias_<i>``/``kernel_out``/``bias_out``, kept in
flax's (in, out) layout) keeps its name; a module marked ``flax_raw``
(``TrainableNormal``'s ``loc``/``scale``, ``VariationalDense``'s
``kernel_mu``/``kernel_rho``/``bias``) holds all of its parameters so,
and a ``DistributionNetwork``'s ``distributions_<i>`` is
``distributions.<i>``.  A
``Dense``, ``Conv`` or ``ConvTranspose`` built with ``bare=True`` stands
for one of flax's own
``nn.Dense``/``nn.Conv``/``nn.ConvTranspose`` layers (a head's
``projection``, ``Attention``'s and ``AttentionHeads``' projections, a
ladder rung's convolutions and heads, a U-Net's ``skip_{i}``, a
probabilistic U-Net's ``ladder_q{i}``/``ladder_p{i}``), whose flax path
has no ``Dense_0``/``Conv_0``/``ConvTranspose_0``; of those, a rung's
``merge_deconv`` is the transposed one.  Inside a block made of flax's
own unnamed layers (a residual block, a squeeze-excitation, a PixelCNN
decoder; ``networks.resnets``) the auto-named ``Conv_1``,
``ConvTranspose_0``, ``Dense_0``, ``BatchNorm_2``, ... are bare modules
of the port under those names: a primitive node with a sibling module,
or numbered above 0, while a lone ``Conv_0`` stays a wrapper layer's
own.  A ``SpaceToDepthConv`` and a ``MaskedConv2D`` hold their
``kernel`` themselves, in the plain ``Conv`` layout; a subpixel
``ConvTranspose`` holds the plain one's.

Classical ML (``ml``): ``from_jax_gmm`` / ``to_jax_gmm``,
``from_jax_tmatrix`` / ``to_jax_tmatrix``, ``from_jax_plda`` /
``to_jax_plda`` and ``from_jax_scorer`` / ``to_jax_scorer`` carry the numpy
state of the JAX package's ``GMM``, ``Tmatrix``, ``PLDA`` and ``Scorer``
(read from an object's attributes or from a mapping of the same names) into
the port's objects on a device, and back as plain dicts of numpy arrays,
which a JAX object takes with ``setattr`` (the normalizer's entries on its
``normalizer``).  The same holds for the fitted state of the estimators
the JAX package takes from scikit-learn, read by scikit-learn's attribute
names (no scikit-learn is imported): ``from_jax_pca`` (the ``PCA`` of
``fast_pca(return_model=True)``), ``from_jax_incremental_pca`` and
``from_jax_minibatch_pca``, ``from_jax_ppca``, ``from_jax_supervised_ppca``
and ``from_jax_randomized_pca``, ``from_jax_lda`` (a
``LinearDiscriminantAnalysis``, also inside ``VectorNormalizer`` and
``SupervisedPPCA``), ``from_jax_gaussian_mixture``,
``from_jax_gmm_classifier``, ``from_jax_probabilistic_embedding`` and
``from_jax_gmm_threshold``, ``from_jax_svc`` (support vectors, dual
coefficients, intercepts, ``probA_``/``probB_``), ``from_jax_forest``
(each tree's ``tree_`` arrays, which the port keeps in scikit-learn's
node order) and ``from_jax_topics`` (``LatentDirichletAllocation``), each
with its ``to_jax_*``.

A bare stack of flax ``nn.Dense`` layers (``Dense_0``, ``Dense_1``, ...,
the network of the JAX package's ``BNFExtractor((module, params))``)
becomes an ``nn.Sequential`` of ``nn.Linear`` with a ReLU between two of
them through ``from_jax_dense_stack``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.ml import GMM, PLDA, Scorer, Tmatrix, VectorNormalizer
from odin_tpu_torch.ml.decompositions import (PCA, PPCA, IncrementalPCA,
                                              MiniBatchPCA, RandomizedPCA,
                                              SupervisedPPCA)
from odin_tpu_torch.ml.discriminant import LinearDiscriminantAnalysis
from odin_tpu_torch.ml.forest import RandomForestClassifier
from odin_tpu_torch.ml.gmm_embedding import (GMMclassifier, GMMThreshold,
                                             ProbabilisticEmbedding)
from odin_tpu_torch.ml.mixture import GaussianMixture
from odin_tpu_torch.ml.svm import SVC
from odin_tpu_torch.ml.topics import LatentDirichletAllocation
from odin_tpu_torch.networks.attention import MultiHeadAttention
from odin_tpu_torch.networks.base import (BatchNorm, Conv, ConvTranspose,
                                         Dense, GRUCell)
from odin_tpu_torch.networks.util_layers import LSTMCell, SimpleCell
from odin_tpu_torch.training.core import EMA_KEY, TrainState, _dtype

__all__ = ["from_jax_params", "to_jax_params", "from_jax_mutables",
           "to_jax_mutables", "from_jax_state", "to_jax_state",
           "from_jax_gmm", "to_jax_gmm", "from_jax_tmatrix",
           "to_jax_tmatrix", "from_jax_plda", "to_jax_plda",
           "from_jax_scorer", "to_jax_scorer", "from_jax_dense_stack"]

_PRIMITIVES = {"Conv_0": Conv, "ConvTranspose_0": ConvTranspose,
               "Dense_0": Dense, "BatchNorm_0": BatchNorm}
_PRIMITIVE_NAMES = {v: k for k, v in _PRIMITIVES.items()}
# flax's auto-named primitives (``Conv_1``, ``ConvTranspose_0``, ...); one
# with siblings belongs to a block of flax's own layers (a residual
# block, a squeeze-excitation, a PixelCNN decoder) and is a bare module
# of the port under that name
_AUTO = re.compile(r"^(Conv|ConvTranspose|Dense|BatchNorm)_(\d+)$")
_KINDS = {"Conv": Conv, "ConvTranspose": ConvTranspose, "Dense": Dense,
          "BatchNorm": BatchNorm}
# flax's numbered submodules of a list attribute, a ModuleList in the port
_LISTS = ("layers", "encoders", "decoders", "latent_heads", "observations",
          "distributions")
_LAYER = re.compile(r"^(%s)_(\d+)$" % "|".join(_LISTS))
# flax's bare nn.ConvTranspose layers, by their module name (a ladder
# rung's merge); a bare 4-d kernel of another name is an nn.Conv's
_BARE_TRANSPOSED = ("merge_deconv",)
_MHA = "MultiHeadDotProductAttention_0"
_MHA_PROJECTIONS = ("query", "key", "value", "out")
# parameters held by a module itself, not by a Dense: attention's v_add, a
# VQ codebook, VampPrior's pseudo-inputs, a label embedder's lookup table
# (flax's ``nn.Embed``), M3's learned prior
_RAW = ("v_add", "codebook", "pseudo_inputs", "embedding", "diag_loc_true",
        "diag_loc_false", "diag_scale_true", "diag_scale_false")
_RAW += ("topics_words", "conc_w", "conc_b", "profile_logits")
# a MADE projection's masked kernels and biases, a VariationalDense's
# kernel posterior, a TrainableNormal's location
_RAW += ("kernel_out", "bias_out", "kernel_mu", "kernel_rho", "loc")
# BatchRenormalization's scale and shift
_RAW += ("gamma", "beta")
_RAW_NUMBERED = re.compile(r"^(enc_[wb]|kernel_|bias_)\d+$")
_PARAM_LEAVES = ("bias", "scale") + _RAW
_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")
_GRU_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hn")
_LSTM_IN, _LSTM_HIDDEN = ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")
_LSTM_LEAVES = ("weight_ih", "weight_hh", "bias_hh")
_RNN_LEAVES = ("weight_ih", "weight_hh", "bias_ih")
_CELL_LEAVES = set(_GRU_LEAVES + _LSTM_LEAVES + _RNN_LEAVES)


def _is_raw(leaf: str) -> bool:
  return leaf in _RAW or bool(_RAW_NUMBERED.match(leaf))


def _fuse_cells(tree: Mapping) -> Dict[str, Any]:
  """`tree` with each flax recurrent cell node (the tree itself too)
  replaced by the port's fused leaves, in the port's layout: a
  ``GRUCell``, an ``OptimizedLSTMCell`` (``LSTMCell``) or a
  ``SimpleCell``."""
  kernel = lambda gates: np.concatenate(
      [np.asarray(tree[g]["kernel"]).T for g in gates], 0)
  bias = lambda gates: np.concatenate([np.asarray(tree[g]["bias"])
                                       for g in gates])
  if set(tree) == set(_GRU_GATES):
    return {"weight_ih": kernel(("ir", "iz", "in")),
            "weight_hh": kernel(("hr", "hz", "hn")),
            "bias_ih": bias(("ir", "iz", "in")),
            "bias_hn": np.asarray(tree["hn"]["bias"])}
  if set(tree) == set(_LSTM_IN + _LSTM_HIDDEN):
    return {"weight_ih": kernel(_LSTM_IN), "weight_hh": kernel(_LSTM_HIDDEN),
            "bias_hh": bias(_LSTM_HIDDEN)}
  if set(tree) == {"i", "h"} and all(isinstance(v, Mapping)
                                     for v in tree.values()):
    return {"weight_ih": kernel(("i",)), "weight_hh": kernel(("h",)),
            "bias_ih": bias(("i",))}
  return {k: _fuse_cells(v) if isinstance(v, Mapping) else v
          for k, v in tree.items()}


def _unstack(w, gates, b=None) -> Dict[str, Any]:
  """A fused (gates·h, in) weight (and its bias) -> flax's gate nodes."""
  h = w.shape[0] // len(gates)
  out = {g: {"kernel": np.ascontiguousarray(w[i * h:(i + 1) * h].T)}
         for i, g in enumerate(gates)}
  if b is not None:
    for i, g in enumerate(gates):
      out[g]["bias"] = b[i * h:(i + 1) * h].copy()
  return out


def _lstm_gates(w_ih, w_hh, b_hh) -> Dict[str, Any]:
  return {**_unstack(w_ih, _LSTM_IN), **_unstack(w_hh, _LSTM_HIDDEN, b_hh)}


def _rnn_gates(w_ih, w_hh, b_ih) -> Dict[str, Any]:
  return {**_unstack(w_ih, ("i",), b_ih), **_unstack(w_hh, ("h",))}


def _gru_gates(w_ih, w_hh, b_ih, b_hn) -> Dict[str, Any]:
  """The port's fused GRU leaves -> flax's gate tree."""
  h = b_hn.shape[0]
  gates = {}
  for i, (gi, gh) in enumerate((("ir", "hr"), ("iz", "hz"), ("in", "hn"))):
    gates[gi] = {"kernel": np.ascontiguousarray(w_ih[i * h:(i + 1) * h].T),
                 "bias": b_ih[i * h:(i + 1) * h].copy()}
    gates[gh] = {"kernel": np.ascontiguousarray(w_hh[i * h:(i + 1) * h].T)}
  gates["hn"]["bias"] = b_hn.copy()
  return gates


def _split_cells(tree: Mapping) -> Dict[str, Any]:
  """The inverse of ``_fuse_cells``."""
  for leaves, gates in ((_GRU_LEAVES, _gru_gates),
                        (_LSTM_LEAVES, _lstm_gates),
                        (_RNN_LEAVES, _rnn_gates)):
    if set(tree) == set(leaves):
      return gates(*(np.asarray(tree[n]) for n in leaves))
  return {k: _split_cells(v) if isinstance(v, Mapping) else v
          for k, v in tree.items()}


# the leaves of flax's mutable collections (batch_stats, vq_stats)
_STAT_LEAVES = ("mean", "var", "codebook", "counts", "means")
_TO_PORT = {"position": "position_proj"}
_TO_FLAX = {v: k for k, v in _TO_PORT.items()}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
  for k, v in tree.items():
    if isinstance(v, Mapping):
      yield from _leaves(v, prefix + (str(k),))
    else:
      yield prefix + (str(k),), np.asarray(v)


def _transposed(kind) -> bool:
  return kind is not None and issubclass(kind, ConvTranspose)


def _kernel_to_torch(kind, kernel: np.ndarray) -> np.ndarray:
  if kernel.ndim == 2:  # Dense (in, out) -> (out, in)
    return kernel.T
  if kernel.ndim == 3:  # 1-D (k, in, out) -> (out, in, k); transposed
    return (kernel.transpose(1, 2, 0)[:, :, ::-1] if _transposed(kind)
            else kernel.transpose(2, 1, 0))  # -> flipped (in, out, k)
  if _transposed(kind):  # (kh, kw, in, out) -> flipped (in, out, kh, kw)
    return kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
  return kernel.transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _kernel_to_flax(kind, weight: np.ndarray) -> np.ndarray:
  if weight.ndim == 2:
    return weight.T
  if weight.ndim == 3:
    return (weight[:, :, ::-1].transpose(2, 0, 1) if _transposed(kind)
            else weight.transpose(2, 1, 0))
  if _transposed(kind):
    return weight[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
  return weight.transpose(2, 3, 1, 0)


def _kept_primitives(tree: Mapping, prefix: Tuple[str, ...] = ()) -> set:
  """The paths of `tree`'s auto-named primitive nodes that are modules of
  their own in the port: those with a sibling module, or numbered above
  0 (a wrapper layer holds its one primitive alone, as ``Conv_0``)."""
  subs = [k for k, v in tree.items() if isinstance(v, Mapping)]
  out = set()
  for k in subs:
    match = _AUTO.match(k)
    if match and (len(subs) > 1 or match.group(2) != "0"):
      out.add(prefix + (k,))
    out |= _kept_primitives(tree[k], prefix + (k,))
  return out


def _port_leaf(path: Tuple[str, ...], leaves=_PARAM_LEAVES,
               kept: frozenset = frozenset()):
  """A flax leaf path -> (the port's dotted name, the primitive layer that
  holds it or None); `leaves` are the leaf names kept as they are, `kept`
  the primitives' paths that stay modules (``_kept_primitives``)."""
  *modules, leaf = path
  if tuple(modules) in kept:
    return ".".join(_flax_to_port(modules) + [
        "weight" if leaf == "kernel" else leaf]), _KINDS[
            _AUTO.match(modules[-1]).group(1)]
  if len(modules) >= 2 and modules[-2] == _MHA and \
      modules[-1] in _MHA_PROJECTIONS:
    modules = modules[:-2] + modules[-1:]
  kind = _PRIMITIVES.get(modules[-1]) if modules else None
  if kind is not None:
    modules = modules[:-1]
  elif modules and modules[-1] in _BARE_TRANSPOSED:
    kind = ConvTranspose
  names = _flax_to_port(modules)
  if leaf == "kernel" and leaves is _PARAM_LEAVES:
    leaf = "weight"
  elif leaf not in leaves and not (leaves is _PARAM_LEAVES and (
      _is_raw(leaf) or leaf in _CELL_LEAVES)):
    raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
  return ".".join(names + [leaf]), kind


def _flax_to_port(modules):
  names = []
  for m in modules:
    match = _LAYER.match(m)
    names.extend(match.groups() if match else (_TO_PORT.get(m, m),))
  return names


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """flax params (a nested dict of arrays; a VAE's ``{'vae': ...}`` tree or
  the tree of one module) -> a ``state_dict`` for the port's module."""
  if set(params) == {"vae"}:
    params = params["vae"]
  out = {}
  kept = _kept_primitives(params)
  for path, value in _leaves(_fuse_cells(params)):
    *modules, leaf = path
    if len(modules) >= 2 and modules[-2] == _MHA and \
        modules[-1] in _MHA_PROJECTIONS:
      if modules[-1] == "out":  # (H, D_h, F_out) -> (H·D_h, F_out)
        value = value.reshape(-1, value.shape[-1]) if leaf == "kernel" \
            else value
      else:  # (F_in, H, D_h) -> (F_in, H·D_h); (H, D_h) -> (H·D_h,)
        value = value.reshape(value.shape[0], -1) if leaf == "kernel" \
            else value.reshape(-1)
    name, kind = _port_leaf(path, kept=kept)
    if leaf == "kernel":
      value = _kernel_to_torch(kind, value)
    out[name] = torch.from_numpy(value.astype(np.float32, order="C",
                                              copy=True))
  return out


def _tree_to_flax(state_dict: Mapping[str, torch.Tensor],
                  template: Mapping[str, Any]) -> Dict[str, Any]:
  """The inverse of ``from_jax_params`` on a flax tree of the same layout
  as `template`: each leaf of `template` read from `state_dict` by its
  port name, transposed back and shaped as the template's leaf."""
  out: Dict[str, Any] = {}
  kept = _kept_primitives(template)
  for path, value in _leaves(_fuse_cells(template)):
    name, kind = _port_leaf(path, kept=kept)
    w = _numpy(state_dict[name])
    if path[-1] == "kernel":
      w = _kernel_to_flax(kind, w)
    _node(out, path[:-1])[path[-1]] = np.ascontiguousarray(
        w.reshape(value.shape)).astype(value.dtype)
  return _split_cells(out)


def _flax_path(name: str):
  """A port module's dotted name -> its flax path."""
  parts = name.split(".") if name else []
  path = []
  i = 0
  while i < len(parts):
    if parts[i] in _LISTS and i + 1 < len(parts) and parts[i + 1].isdigit():
      path.append(f"{parts[i]}_{parts[i + 1]}")
      i += 2
    else:
      path.append(_TO_FLAX.get(parts[i], parts[i]))
      i += 1
  return path


def _node(tree: Dict[str, Any], path) -> Dict[str, Any]:
  for p in path:
    tree = tree.setdefault(p, {})
  return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
  t = t.detach().cpu()
  if t.dtype == torch.bfloat16:  # numpy has no bfloat16: exact in float32
    t = t.float()
  return t.numpy().copy()


def to_jax_params(module: nn.Module,
                  params: Mapping[str, torch.Tensor] = None) -> Dict[str, Any]:
  """The inverse of ``from_jax_params`` for a built module of the port:
  its parameters as a flax tree of numpy arrays, read from `params` (a
  partition of a state) or from its ``state_dict()`` (of a VAE's
  ``core``: the params of ``vae.state``)."""
  sd = module.state_dict() if params is None else params
  value = lambda *names: _numpy(sd[".".join(n for n in names if n)])
  tree: Dict[str, Any] = {}
  held = set()  # the Dense layers of a MultiHeadAttention
  for name, sub in module.named_modules():
    if isinstance(sub, MultiHeadAttention):
      heads = (sub.num_heads, sub.head_dim)
      for proj in _MHA_PROJECTIONS:
        dense = getattr(sub, proj)
        held.add(dense)
        node = _node(tree, _flax_path(name) + [_MHA, proj])
        kernel = value(name, proj, "weight").T
        if proj == "out":
          node["kernel"] = np.ascontiguousarray(kernel.reshape(
              heads + (kernel.shape[-1],)))
          node["bias"] = value(name, proj, "bias")
        else:
          node["kernel"] = np.ascontiguousarray(kernel.reshape(
              (kernel.shape[0],) + heads))
          node["bias"] = value(name, proj, "bias").reshape(heads)
      continue
    cell = next(((leaves, gates) for kind, leaves, gates in (
        (GRUCell, _GRU_LEAVES, _gru_gates),
        (LSTMCell, _LSTM_LEAVES, _lstm_gates),
        (SimpleCell, _RNN_LEAVES, _rnn_gates)) if isinstance(sub, kind)),
                None)
    if cell is not None:
      _node(tree, _flax_path(name)).update(cell[1](
          *(value(name, n) for n in cell[0])))
      continue
    if isinstance(sub, BatchNorm):
      node = _node(tree, _flax_path(name) + ([] if sub.bare
                                             else ["BatchNorm_0"]))
      node["scale"] = value(name, "scale")
      node["bias"] = value(name, "bias")
      continue
    if getattr(sub, "flax_raw", False):
      # a module that holds every parameter itself in flax's layout
      # (``bay.stochastic_initializers``)
      node = _node(tree, _flax_path(name))
      for leaf, _ in sub.named_parameters(recurse=False):
        node[leaf] = value(name, leaf)
      continue
    # the flax primitive a layer stands for: a 1-D layer of
    # ``networks.time_delay``/``util_layers`` names it (``flax_kind``)
    kind = getattr(sub, "flax_kind", None) or next(
        (k for k in (Conv, ConvTranspose, Dense) if isinstance(sub, k)), None)
    if kind is None or sub in held:
      continue
    path = _flax_path(name)
    if not sub.bare:
      path.append(_PRIMITIVE_NAMES[kind])
    node = _node(tree, path)
    w = value(name, "weight")
    node["kernel"] = np.ascontiguousarray(_kernel_to_flax(kind, w))
    if sub.bias is not None:
      node["bias"] = value(name, "bias")
  for name, _ in module.named_parameters():
    *owner, leaf = name.split(".")
    if _is_raw(leaf):
      _node(tree, _flax_path(".".join(owner)))[leaf] = value(name)
  return tree


def from_jax_mutables(mutables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """flax's mutable collections of a module (``{'batch_stats': ...}``,
  ``{'vq_stats': ...}``) -> its buffers by the port's dotted names (the
  collection level dropped: ``vq_stats/latents/codebook`` is
  ``latents.codebook``)."""
  out = {}
  for _, tree in mutables.items():
    kept = _kept_primitives(tree)
    for path, value in _leaves(tree):
      name, _ = _port_leaf(path, _STAT_LEAVES, kept)
      out[name] = torch.from_numpy(value.astype(np.float32, order="C",
                                                copy=True))
  return out


def _buffer_paths(module: nn.Module):
  """(collection, flax path, the port's dotted name) of every buffer of a
  module that holds a flax collection (``BatchNorm``, an EMA
  ``VectorQuantizer``)."""
  for name, sub in module.named_modules():
    collection = getattr(sub, "collection", None)
    if collection is None:
      continue
    path = _flax_path(name) + (["BatchNorm_0"] if isinstance(sub, BatchNorm)
                               and not sub.bare else [])
    for buf, _ in sub.named_buffers(recurse=False):
      yield collection, path + [buf], f"{name}.{buf}" if name else buf


def to_jax_mutables(module: nn.Module,
                    buffers: Mapping[str, torch.Tensor] = None
                    ) -> Dict[str, Any]:
  """The inverse of ``from_jax_mutables``: `buffers` (a partition of a
  state's mutables; the module's own by default) as flax collections of
  numpy arrays."""
  sd = dict(module.named_buffers()) if buffers is None else buffers
  tree: Dict[str, Any] = {}
  for collection, path, name in _buffer_paths(module):
    _node(tree.setdefault(collection, {}), path[:-1])[path[-1]] = \
        _numpy(sd[name])
  return tree


# ---------------------------------------------------------------------------
# whole training states
# ---------------------------------------------------------------------------
# the state fields that the port names otherwise (by optax state type)
_COUNT_NAMES = {"ScaleByScheduleState": "lr_count",
                "WeightDecaySchedule": "wd_count"}


def _optax_parts(node):
  """The NamedTuple states inside an optax state (chains are tuples, a
  masked transform's state holds its inner state)."""
  if hasattr(node, "_fields"):
    if node._fields == ("inner_state",):
      yield from _optax_parts(node.inner_state)
    else:
      yield node
  elif isinstance(node, (tuple, list)):
    for v in node:
      yield from _optax_parts(v)


def _port_name(part, field: str) -> str:
  return _COUNT_NAMES.get(type(part).__name__, field) if field == "count" \
      else field


def _tensor(a, device) -> torch.Tensor:
  return torch.as_tensor(np.array(a)).to(device)


def from_jax_state(state, device="cuda") -> TrainState:
  """A JAX package ``TrainState`` (numpy or JAX arrays, e.g.
  ``jax.device_get(vae.state)``) -> the port's ``TrainState`` on `device`:
  the params, each optimizer's optax state (every field of every state in
  the chain, by its optax name: ``count``, ``mu``, ``nu``, ``trace``,
  ``sum_of_squares``; a schedule's count as ``lr_count``, a weight-decay
  schedule's as ``wd_count``; moments keep their dtype), the EMA tree,
  the mutable collections (the core's, the port's ``'vae'`` partition),
  ``step`` and ``skipped_updates``.  Every params partition (``'vae'``
  and the extra networks') and every optimizer (one per name) carries
  over.  The port draws its noise from a ``torch.Generator``, seeded here
  with the last word of the JAX key."""
  device = resolve_device(device)

  def tree(t):
    out = {}
    for k, sub in t.items():
      dtype = _dtype(next(v for _, v in _leaves(sub)).dtype)
      out[k] = {n: v.to(device=device, dtype=dtype)
                for n, v in from_jax_params(sub).items()}
    return out

  opt_states = {}
  for name, opt in state.opt_states.items():
    if name == EMA_KEY:
      opt_states[name] = tree(opt)
      continue
    port = {}
    for part in _optax_parts(opt):
      for field in part._fields:
        value = getattr(part, field)
        port[_port_name(part, field)] = (tree(value) if isinstance(value, dict)
                                         else _tensor(value, device))
    opt_states[name] = port
  mutables = {}
  if state.mutables:
    mutables["vae"] = {k: v.to(device) for k, v in
                       from_jax_mutables(state.mutables).items()}
  seed = int(np.asarray(state.rng).ravel()[-1])
  return TrainState(params=tree(state.params), opt_states=opt_states,
                    step=_tensor(state.step, device),
                    rng=torch.Generator(device).manual_seed(seed),
                    mutables=mutables,
                    skipped_updates=_tensor(state.skipped_updates, device))


def _optax_like(node, port):
  """`node` (an optax state) with every field replaced from the port's
  optimizer state."""
  if hasattr(node, "_fields"):
    if node._fields == ("inner_state",):
      return node._replace(inner_state=_optax_like(node.inner_state, port))
    tree = lambda p, t: {k: _tree_to_flax(p[k], v) for k, v in t.items()}
    return node._replace(**{
        f: (tree(port[_port_name(node, f)], getattr(node, f))
            if isinstance(getattr(node, f), dict)
            else _numpy(port[_port_name(node, f)]))
        for f in node._fields})
  if isinstance(node, (tuple, list)):
    return type(node)(_optax_like(v, port) for v in node)
  return node


def to_jax_state(state: TrainState, template):
  """The port's ``TrainState`` -> a JAX package ``TrainState`` shaped as
  `template` (one of the JAX model's states, whose optax structure,
  collections and PRNG key it keeps), with numpy leaves.  JAX keeps no
  mutables of an extra network, so only the ``'vae'`` partition's go."""
  tree = lambda p, t: {k: _tree_to_flax(p[k], v) for k, v in t.items()}
  opt_states = {}
  for name, opt in template.opt_states.items():
    opt_states[name] = (tree(state.opt_states[name], opt) if name == EMA_KEY
                        else _optax_like(opt, state.opt_states[name]))
  mutables: Dict[str, Any] = {}
  for collection, sub in (template.mutables or {}).items():
    kept = _kept_primitives(sub)
    for path, value in _leaves(sub):
      name, _ = _port_leaf(path, _STAT_LEAVES, kept)
      _node(mutables.setdefault(collection, {}), path[:-1])[path[-1]] = \
          _numpy(state.mutables["vae"][name]).astype(value.dtype)
  return template.replace(params=tree(state.params, template.params),
                          opt_states=opt_states, step=_numpy(state.step),
                          mutables=mutables,
                          skipped_updates=_numpy(state.skipped_updates))


# ---------------------------------------------------------------------------
# classical ML: GMM, T-matrix, PLDA, Scorer
# ---------------------------------------------------------------------------
def _get(src, name, default=None):
  """`name` of a mapping or an object's attribute of that name."""
  if isinstance(src, Mapping):
    return src.get(name, default)
  return getattr(src, name, default)


def _host(x):
  """A tensor as a numpy array; None and arrays as they are."""
  return _numpy(x) if isinstance(x, torch.Tensor) else x


def _f64(x, device):
  return None if x is None else torch.as_tensor(
      np.asarray(x), dtype=torch.float64).to(device)


def from_jax_gmm(src, device="cuda") -> GMM:
  """A JAX ``GMM`` (or the dict its ``save`` writes: ``{nmix, mu, sigma,
  w, ndim}``) -> the port's ``GMM`` on `device`."""
  return GMM.from_state({k: _get(src, k) for k in
                         ("nmix", "mu", "sigma", "w", "ndim")}, device)


def to_jax_gmm(gmm: GMM) -> Dict[str, Any]:
  """``{nmix, mu, sigma, w, ndim}`` with numpy arrays."""
  return gmm.state()


def from_jax_tmatrix(src, gmm: GMM, device="cuda") -> Tmatrix:
  """A JAX ``Tmatrix`` (or ``{tv_dim, Tm}``) -> the port's ``Tmatrix`` over
  the port's `gmm`, on `device`."""
  return Tmatrix(tv_dim=_get(src, "tv_dim"), gmm=gmm,
                 device=device).load_state(
                     {"tv_dim": _get(src, "tv_dim"), "Tm": _get(src, "Tm")})


def to_jax_tmatrix(tmat: Tmatrix) -> Dict[str, Any]:
  """``{tv_dim, Tm}``, Tm a float64 numpy array."""
  return tmat.state()


_NORMALIZER_FLAGS = ("centering", "wccn", "unit_length")


def _normalizer_from(src, device) -> VectorNormalizer:
  flags = {k: _get(src, k, d) for k, d in zip(_NORMALIZER_FLAGS,
                                              (True, False, True))}
  vn = VectorNormalizer(**flags, device=device)
  vn.mean, vn.W = _f64(_get(src, "mean"), vn.device), _f64(_get(src, "W"),
                                                           vn.device)
  lda = _get(src, "lda_model")
  if lda is not None:
    vn.lda, vn.lda_model = True, from_jax_lda(lda, vn.device)
  return vn


def _normalizer_to(vn: VectorNormalizer) -> Dict[str, Any]:
  out = {k: getattr(vn, k) for k in _NORMALIZER_FLAGS}
  out.update(mean=_host(vn.mean), W=_host(vn.W),
             lda_model=None if vn.lda_model is None else
             to_jax_lda(vn.lda_model))
  return out


def from_jax_plda(src, device="cuda") -> PLDA:
  """A fitted JAX ``PLDA`` (or the dict ``to_jax_plda`` gives) -> the port's
  ``PLDA`` on `device`: mean, Phi, Sigma, the class latents and classes,
  and the normalizer's mean and W."""
  Phi = np.asarray(_get(src, "Phi"))
  plda = PLDA(n_phi=Phi.shape[1], device=device)
  plda.normalizer = _normalizer_from(_get(src, "normalizer"), plda.device)
  plda.mean, plda.Phi, plda.Sigma, plda._class_latents = (
      _f64(_get(src, k), plda.device)
      for k in ("mean", "Phi", "Sigma", "_class_latents"))
  plda._trained_classes = _get(src, "_trained_classes")
  return plda


def to_jax_plda(plda: PLDA) -> Dict[str, Any]:
  out = {k: _host(getattr(plda, k)) for k in
         ("mean", "Phi", "Sigma", "_class_latents", "_trained_classes")}
  out["normalizer"] = _normalizer_to(plda.normalizer)
  return out


def from_jax_scorer(src, device="cuda") -> Scorer:
  """A fitted JAX ``Scorer`` (or the dict ``to_jax_scorer`` gives) -> the
  port's ``Scorer`` on `device`: labels, enroll, the normalizer and, for
  ``method='svm'``, the SVC."""
  scorer = Scorer(method=_get(src, "method", "cosine"), device=device)
  scorer.normalizer = _normalizer_from(_get(src, "normalizer"),
                                       scorer.device)
  scorer.labels = _get(src, "labels")
  scorer.enroll = _f64(_get(src, "enroll"), scorer.device)
  if _get(src, "model") is not None:
    scorer.model = from_jax_svc(_get(src, "model"), scorer.device)
  return scorer


def to_jax_scorer(scorer: Scorer) -> Dict[str, Any]:
  out = {"method": scorer.method, "labels": scorer.labels,
         "enroll": _host(scorer.enroll),
         "normalizer": _normalizer_to(scorer.normalizer)}
  if scorer.model is not None:
    out["model"] = to_jax_svc(scorer.model)
  return out


# ---------------------------------------------------------------------------
# scikit-learn's estimators, by their attribute names
# ---------------------------------------------------------------------------
def _t(x, device, dtype=None):
  """An array (or tensor) as a tensor on `device`, its dtype kept unless
  given."""
  if x is None:
    return None
  if isinstance(x, torch.Tensor):
    return x.to(device=device, dtype=dtype or x.dtype)
  return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def _hosts(obj, names) -> Dict[str, Any]:
  return {k: _host(getattr(obj, k)) for k in names}


_PCA = ("components_", "mean_", "explained_variance_",
        "explained_variance_ratio_", "singular_values_", "noise_variance_")


def from_jax_pca(src, device="cuda") -> PCA:
  """A fitted scikit-learn ``PCA`` (the model ``fast_pca(...,
  return_model=True)`` returns) -> the port's ``PCA`` on `device`."""
  dev = resolve_device(device)
  pca = PCA(n_components=_get(src, "n_components_"),
            whiten=bool(_get(src, "whiten", False)), device=dev)
  for k in _PCA:
    setattr(pca, k, _t(_get(src, k), dev))
  pca.n_components_ = int(_get(src, "n_components_"))
  pca.n_samples_ = int(_get(src, "n_samples_"))
  return pca


def to_jax_pca(pca: PCA) -> Dict[str, Any]:
  out = _hosts(pca, _PCA)
  out.update(n_components_=pca.n_components_, n_samples_=pca.n_samples_,
             whiten=pca.whiten)
  return out


_IPCA = ("components_", "mean_", "var_", "singular_values_",
         "explained_variance_", "explained_variance_ratio_",
         "noise_variance_")


def from_jax_incremental_pca(src, device="cuda") -> IncrementalPCA:
  """A fitted scikit-learn ``IncrementalPCA`` -> the port's."""
  dev = resolve_device(device)
  ipca = IncrementalPCA(n_components=_get(src, "n_components"),
                        batch_size=_get(src, "batch_size"), device=dev)
  for k in _IPCA:
    setattr(ipca, k, _t(_get(src, k), dev))
  ipca.n_components_ = int(_get(src, "n_components_"))
  ipca.n_samples_seen_ = int(np.asarray(_get(src, "n_samples_seen_")))
  return ipca


def to_jax_incremental_pca(ipca: IncrementalPCA) -> Dict[str, Any]:
  out = _hosts(ipca, _IPCA)
  out.update(n_components=ipca.n_components, batch_size=ipca.batch_size,
             n_components_=ipca.n_components_,
             n_samples_seen_=ipca.n_samples_seen_)
  return out


def from_jax_minibatch_pca(src, device="cuda") -> MiniBatchPCA:
  """A JAX ``MiniBatchPCA`` (its ``_model``, or that model itself) -> the
  port's."""
  model = _get(src, "_model", src)
  out = MiniBatchPCA(device=device)
  out._model = from_jax_incremental_pca(model, device)
  return out


def to_jax_minibatch_pca(mb: MiniBatchPCA) -> Dict[str, Any]:
  return {"_model": to_jax_incremental_pca(mb._model)}


def from_jax_ppca(src, device="cuda", cls=PPCA) -> PPCA:
  """A fitted JAX ``PPCA`` -> the port's: W, sigma2 and mean."""
  dev = resolve_device(device)
  ppca = cls(n_components=_get(src, "n_components"),
             n_iter=_get(src, "n_iter", 50), tol=_get(src, "tol", 1e-4),
             random_state=_get(src, "random_state", 1), device=dev)
  ppca.W = _t(_get(src, "W"), dev, torch.float32)
  ppca.mean = _t(_get(src, "mean"), dev, torch.float32)
  ppca.sigma2 = float(_get(src, "sigma2"))
  return ppca


def to_jax_ppca(ppca: PPCA) -> Dict[str, Any]:
  return {"n_components": ppca.n_components, "W": _host(ppca.W),
          "mean": _host(ppca.mean), "sigma2": float(ppca.sigma2)}


def from_jax_supervised_ppca(src, device="cuda") -> SupervisedPPCA:
  """A fitted JAX ``SupervisedPPCA`` -> the port's, its LDA included."""
  ppca = from_jax_ppca(src, device, cls=SupervisedPPCA)
  rot = _get(src, "_rotation")
  ppca._rotation = None if rot is None else from_jax_lda(rot, ppca.device)
  return ppca


def to_jax_supervised_ppca(ppca: SupervisedPPCA) -> Dict[str, Any]:
  out = to_jax_ppca(ppca)
  out["_rotation"] = None if ppca._rotation is None else       to_jax_lda(ppca._rotation)
  return out


_RPCA = ("mean_", "singular_values_", "components_", "explained_variance_",
         "explained_variance_ratio_")


def from_jax_randomized_pca(src, device="cuda") -> RandomizedPCA:
  """A fitted JAX ``RandomizedPCA`` -> the port's."""
  dev = resolve_device(device)
  rp = RandomizedPCA(n_components=_get(src, "n_components"),
                     whiten=bool(_get(src, "whiten", False)), device=dev)
  for k in _RPCA:
    setattr(rp, k, _t(_get(src, k), dev))
  rp.n_samples_ = int(_get(src, "n_samples_"))
  return rp


def to_jax_randomized_pca(rp: RandomizedPCA) -> Dict[str, Any]:
  out = _hosts(rp, _RPCA)
  out.update(n_components=rp.n_components, whiten=rp.whiten,
             n_samples_=rp.n_samples_)
  return out


_LDA = ("priors_", "means_", "xbar_", "scalings_", "coef_", "intercept_",
        "explained_variance_ratio_")


def from_jax_lda(src, device="cuda") -> LinearDiscriminantAnalysis:
  """A fitted scikit-learn ``LinearDiscriminantAnalysis`` (svd solver) ->
  the port's on `device`."""
  dev = resolve_device(device)
  lda = LinearDiscriminantAnalysis(device=dev)
  for k in _LDA:
    setattr(lda, k, _t(_get(src, k), dev))
  lda.classes_ = np.asarray(_get(src, "classes_"))
  lda._max_components = int(_get(src, "_max_components"))
  return lda


def to_jax_lda(lda: LinearDiscriminantAnalysis) -> Dict[str, Any]:
  out = _hosts(lda, _LDA)
  out.update(classes_=lda.classes_, _max_components=lda._max_components,
             solver="svd")
  return out


_GM = ("weights_", "means_", "covariances_", "precisions_cholesky_")


def from_jax_gaussian_mixture(src, device="cuda") -> GaussianMixture:
  """A fitted scikit-learn ``GaussianMixture`` -> the port's."""
  dev = resolve_device(device)
  gm = GaussianMixture(int(_get(src, "n_components")),
                       covariance_type=_get(src, "covariance_type"),
                       device=dev)
  return gm.set_state(*(_t(_get(src, k), dev) for k in _GM))


def to_jax_gaussian_mixture(gm: GaussianMixture) -> Dict[str, Any]:
  out = _hosts(gm, _GM + ("precisions_",))
  out.update(n_components=gm.n_components,
             covariance_type=gm.covariance_type)
  return out


def from_jax_gmm_classifier(src, device="cuda") -> GMMclassifier:
  """A fitted JAX ``GMMclassifier`` -> the port's: its classes, log
  priors and one mixture per class."""
  dev = resolve_device(device)
  clf = GMMclassifier(n_components=_get(src, "n_components"),
                      covariance_type=_get(src, "covariance_type"),
                      device=dev)
  clf.classes_ = np.asarray(_get(src, "classes_"))
  clf._priors = _t(_get(src, "_priors"), dev, torch.float64)
  clf._gmms = [from_jax_gaussian_mixture(g, dev)
               for g in _get(src, "_gmms")]
  return clf


def to_jax_gmm_classifier(clf: GMMclassifier) -> Dict[str, Any]:
  return {"n_components": clf.n_components,
          "covariance_type": clf.covariance_type,
          "classes_": clf.classes_, "_priors": _host(clf._priors),
          "_gmms": [to_jax_gaussian_mixture(g) for g in clf._gmms]}


def from_jax_probabilistic_embedding(src, device="cuda"
                                     ) -> ProbabilisticEmbedding:
  """A fitted JAX ``ProbabilisticEmbedding`` (one mixture a column) -> the
  port's (one batched mixture)."""
  dev = resolve_device(device)
  pe = ProbabilisticEmbedding(_get(src, "n_components"), device=dev)
  gmms = _get(src, "_gmms")
  pe._gmm = GaussianMixture(pe.n_components, covariance_type="diag",
                            device=dev).set_state(
      *(np.stack([_host(_get(g, k)) for g in gmms]) for k in _GM),
      batched=True, device=dev)
  return pe


def to_jax_probabilistic_embedding(pe: ProbabilisticEmbedding
                                   ) -> Dict[str, Any]:
  return {"n_components": pe.n_components,
          "_gmms": [to_jax_gaussian_mixture(g) for g in pe._gmms]}


def from_jax_gmm_threshold(src, device="cuda") -> GMMThreshold:
  """A fitted JAX ``GMMThreshold`` -> the port's (its threshold)."""
  th = GMMThreshold(_get(src, "n_components"), device=device)
  th.threshold_ = float(_get(src, "threshold_"))
  th.device_ = resolve_device(device)
  return th


def to_jax_gmm_threshold(th: GMMThreshold) -> Dict[str, Any]:
  return {"n_components": th.n_components, "threshold_": th.threshold_}


def from_jax_svc(src, device="cuda") -> SVC:
  """A fitted scikit-learn ``SVC`` -> the port's: ``support_vectors_``,
  the unflipped ``_dual_coef_`` and ``_intercept_`` (libsvm's layout: for
  pair (i, j), class i's coefficients in row j − 1 and class j's in row
  i), ``_n_support``, ``probA_``/``probB_``, the kernel and ``_gamma``."""
  dev = resolve_device(device)
  svc = SVC(kernel=_get(src, "kernel"), degree=_get(src, "degree", 3),
            coef0=_get(src, "coef0", 0.0), device=dev)
  svc._gamma = float(_get(src, "_gamma"))
  svc.classes_ = np.asarray(_get(src, "classes_"))
  K = len(svc.classes_)
  n_support = np.asarray(_get(src, "_n_support", _get(src, "n_support_")))
  svc.n_support_ = n_support.astype(np.int32)
  svc.support_ = np.asarray(_get(src, "support_"))
  svc.support_vectors_ = _t(_get(src, "support_vectors_"), dev,
                            torch.float64)
  dual = np.asarray(_get(src, "_dual_coef_"), np.float64)
  start = np.r_[0, np.cumsum(n_support)]
  svc._pairs = [(i, j) for i in range(K) for j in range(i + 1, K)]
  coef = np.zeros((len(svc._pairs), dual.shape[1]))
  for p, (i, j) in enumerate(svc._pairs):
    coef[p, start[i]:start[i + 1]] = dual[j - 1, start[i]:start[i + 1]]
    coef[p, start[j]:start[j + 1]] = dual[i, start[j]:start[j + 1]]
  svc.coef_pairs_ = torch.from_numpy(coef).to(dev)
  svc.rho_ = -_t(_get(src, "_intercept_"), dev, torch.float64)
  a, b = _get(src, "probA_"), _get(src, "probB_")
  svc.probA_ = None if a is None or np.size(a) == 0 else       _t(a, dev, torch.float64)
  svc.probB_ = None if b is None or np.size(b) == 0 else       _t(b, dev, torch.float64)
  return svc


def to_jax_svc(svc: SVC) -> Dict[str, Any]:
  """The port's SVC in scikit-learn's names (``_dual_coef_`` and
  ``_intercept_`` unflipped, ``dual_coef_`` and ``intercept_`` as
  scikit-learn shows them)."""
  K = len(svc.classes_)
  flip = -1.0 if K == 2 else 1.0
  return {"kernel": svc.kernel, "degree": svc.degree, "coef0": svc.coef0,
          "_gamma": svc._gamma, "classes_": svc.classes_,
          "support_": svc.support_, "_n_support": svc.n_support_,
          "n_support_": svc.n_support_,
          "support_vectors_": _host(svc.support_vectors_),
          "_dual_coef_": flip * _host(svc.dual_coef_),
          "dual_coef_": _host(svc.dual_coef_),
          "_intercept_": -_host(svc.rho_), "intercept_": _host(svc.intercept_),
          "probA_": None if svc.probA_ is None else _host(svc.probA_),
          "probB_": None if svc.probB_ is None else _host(svc.probB_)}


def from_jax_forest(src, device="cuda") -> RandomForestClassifier:
  """A fitted scikit-learn ``RandomForestClassifier`` -> the port's: each
  tree's ``tree_`` (or a mapping of its arrays) ``children_left``,
  ``children_right``, ``feature``, ``threshold`` and ``value``, in
  scikit-learn's node order."""
  dev = resolve_device(device)
  trees = [_get(e, "tree_", e) for e in _get(src, "estimators_")]
  rf = RandomForestClassifier(n_estimators=len(trees), device=dev)
  rf.classes_ = np.asarray(_get(src, "classes_"))
  C = len(rf.classes_)
  N = max(len(np.asarray(_get(t, "children_left"))) for t in trees)
  T = len(trees)
  feature = np.zeros((T, N), np.int64)
  threshold = np.zeros((T, N))
  left = np.full((T, N), -1, np.int64)
  right = np.full((T, N), -1, np.int64)
  value = np.zeros((T, N, C))
  depth = 0
  for k, t in enumerate(trees):
    cl = np.asarray(_get(t, "children_left"))
    n = len(cl)
    left[k, :n], right[k, :n] = cl, np.asarray(_get(t, "children_right"))
    f = np.asarray(_get(t, "feature"))
    feature[k, :n] = np.where(cl >= 0, f, 0)
    threshold[k, :n] = np.asarray(_get(t, "threshold"))
    value[k, :n] = np.asarray(_get(t, "value")).reshape(n, -1)[:, :C]
    depth = max(depth, int(_get(t, "max_depth")))
  rf.feature_, rf.threshold_ = (torch.from_numpy(a).to(dev)
                                for a in (feature, threshold))
  rf.left_, rf.right_ = (torch.from_numpy(a).to(dev) for a in (left, right))
  rf.value_ = torch.from_numpy(value).to(dev)
  rf.depth_ = depth
  rf.n_features_in_ = int(_get(src, "n_features_in_", 0))
  return rf


def to_jax_forest(rf: RandomForestClassifier) -> Dict[str, Any]:
  """``{classes_, estimators_: [tree arrays]}``, each tree's nodes renumbered
  into scikit-learn's depth-first order, every node's value as its class
  fractions (n_nodes, 1, C) and -2 for a leaf's feature and threshold."""
  feature, threshold = _host(rf.feature_), _host(rf.threshold_)
  left, right, value = _host(rf.left_), _host(rf.right_), _host(rf.value_)
  trees = []
  for t in range(feature.shape[0]):
    order, stack = [], [0]
    while stack:
      k = stack.pop()
      order.append(k)
      if left[t, k] >= 0:
        stack += [right[t, k], left[t, k]]
    new = {k: i for i, k in enumerate(order)}
    o = np.asarray(order)
    leaf = left[t, o] < 0
    v = value[t].copy()
    for k in reversed(order):  # a split node holds its children's weights
      if left[t, k] >= 0:
        v[k] = v[left[t, k]] + v[right[t, k]]
    v = v[o]
    s = v.sum(1, keepdims=True)
    trees.append({
        "children_left": np.where(leaf, -1, [new.get(c, -1)
                                             for c in left[t, o]]),
        "children_right": np.where(leaf, -1, [new.get(c, -1)
                                              for c in right[t, o]]),
        "feature": np.where(leaf, -2, feature[t, o]),
        "threshold": np.where(leaf, -2.0, threshold[t, o]),
        "value": (v / np.where(s == 0, 1, s))[:, None, :],
        "max_depth": rf.depth_})
  return {"classes_": rf.classes_, "estimators_": trees,
          "n_features_in_": rf.n_features_in_}


_TOPICS = ("components_", "exp_dirichlet_component_")


def from_jax_topics(src, device="cuda") -> LatentDirichletAllocation:
  """A fitted scikit-learn ``LatentDirichletAllocation`` -> the port's."""
  dev = resolve_device(device)
  lda = LatentDirichletAllocation(
      int(_get(src, "n_components")),
      mean_change_tol=_get(src, "mean_change_tol", 1e-3),
      max_doc_update_iter=_get(src, "max_doc_update_iter", 100), device=dev)
  for k in _TOPICS:
    setattr(lda, k, _t(_get(src, k), dev))
  lda.doc_topic_prior_ = float(_get(src, "doc_topic_prior_"))
  lda.topic_word_prior_ = float(_get(src, "topic_word_prior_"))
  return lda


def to_jax_topics(lda: LatentDirichletAllocation) -> Dict[str, Any]:
  out = _hosts(lda, _TOPICS)
  out.update(n_components=lda.n_components,
             doc_topic_prior_=lda.doc_topic_prior_,
             topic_word_prior_=lda.topic_word_prior_,
             mean_change_tol=lda.mean_change_tol,
             max_doc_update_iter=lda.max_doc_update_iter)
  return out


# ---------------------------------------------------------------------------
# a bare Dense stack (BNFExtractor's network)
# ---------------------------------------------------------------------------
_DENSE = re.compile(r"^Dense_(\d+)$")


def from_jax_dense_stack(params: Mapping[str, Any],
                         device="cuda") -> nn.Sequential:
  """A flax module made of ``nn.Dense`` layers only, called in the order of
  their names (``Dense_0``, ``Dense_1``, ...) with a ReLU between two of
  them and none after the last, as an ``nn.Sequential`` of ``nn.Linear``
  and ``nn.ReLU`` on `device`.  `params` is the module's ``{"params":
  {...}}`` tree (or its inner dict) as numpy arrays."""
  tree = params.get("params", params)
  if not tree or not all(_DENSE.match(k) for k in tree):
    raise ValueError(f"expected only Dense_<i> layers, got {sorted(tree)}")
  names = sorted(tree, key=lambda k: int(_DENSE.match(k).group(1)))
  layers = []
  for i, name in enumerate(names):
    kernel = np.asarray(tree[name]["kernel"], np.float32)
    bias = tree[name].get("bias")
    linear = nn.Linear(kernel.shape[0], kernel.shape[1],
                       bias=bias is not None)
    with torch.no_grad():
      linear.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.T)))
      if bias is not None:
        linear.bias.copy_(torch.from_numpy(np.array(bias, np.float32)))
    layers.append(linear)
    if i < len(names) - 1:
      layers.append(nn.ReLU())
  return nn.Sequential(*layers).to(resolve_device(device))
