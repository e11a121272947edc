"""The grouped family's plumbing against the JAX package: ``_split_pair``'s
rules (a tuple pair, a pair with a label, a second element shaped unlike
x1 taken as a label, a ``(B, 2, ...)`` stacked pair, an unpaired batch),
the stacked form's ELBO equal to the tuple form's, the aggregation and
symmetric-KL helpers, and the two tie-breaking rules on inputs with
exact ties: ``match``'s double stable argsort and ``AdaptiveVAE``'s
``delta < (max + min) / 2``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.bay.vi.autoencoder import self_supervised_vae as jax_ss
from odin_tpu_torch.bay.vi.autoencoder import self_supervised_vae as port_ss
from odin_tpu_torch.training import Noise
from torch_hier_common import B, pairs
from torch_zoo_common import make_pair

torch.set_num_threads(2)


def _kinds(a):
  return None if a is None else tuple(np.shape(a))


@pytest.mark.parametrize("form", ["pair", "pair+label", "label-second",
                                  "stacked", "unpaired", "single-tuple"])
def test_split_pair_rules_match_jax(form):
  jvae, vae = make_pair("GroupVAE")
  x1, x2 = pairs(90)
  y = np.ones((B, 3), np.float32)
  batch = {"pair": (x1, x2), "pair+label": (x1, x2, y),
           "label-second": (x1, y), "stacked": np.stack([x1, x2], 1),
           "unpaired": x1, "single-tuple": (x1,)}[form]
  want = jvae._split_pair(batch)
  got = vae._split_pair(tuple(torch.from_numpy(b) for b in batch)
                        if isinstance(batch, tuple)
                        else torch.from_numpy(batch))
  assert [_kinds(g) for g in got] == [_kinds(w) for w in want]
  for g, w in zip(got, want):
    if w is not None:
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stacked_pairs_and_the_unpaired_fallback():
  _, vae = make_pair("MultiLevelVAE")
  x1, x2 = (torch.from_numpy(b) for b in pairs(91))
  noise = lambda: Noise(torch.Generator().manual_seed(0))
  step = torch.tensor(0)
  with torch.no_grad():
    l, k, _ = vae.elbo_components(vae.state.params, (x1, x2), noise(), step)
    ls, ks, _ = vae.elbo_components(vae.state.params,
                                    torch.stack([x1, x2], 1), noise(), step)
    lu, ku, _ = vae.elbo_components(vae.state.params, x1, noise(), step)
    lb, kb, _ = vae.elbo_components(vae.state.params, (x1,), noise(), step)
  for a, b in ((l, ls), (k, ks), (lu, lb), (ku, kb)):
    assert set(a) == set(b)
    for key in a:
      assert torch.equal(a[key], b[key]), key
  assert lu["llk_observation"].shape == (B,)
  # the fallback is the vanilla ELBO of x1 alone
  assert not torch.allclose(lu["llk_observation"], l["llk_observation"])


def test_aggregation_and_symmetric_kl_match_jax():
  rs = np.random.RandomState(4)
  m1, m2 = rs.randn(2, 5, 6).astype(np.float32)
  s1, s2 = np.exp(rs.randn(2, 5, 6)).astype(np.float32)
  t = [torch.from_numpy(a) for a in (m1, s1, m2, s2)]
  for how in ("group", "multilevel"):
    for got, want in zip(port_ss._aggregate(*t, how),
                         jax_ss._aggregate(m1, s1, m2, s2, how)):
      np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
  np.testing.assert_allclose(port_ss._sym_kl_per_dim(*t).numpy(),
                             np.asarray(jax_ss._sym_kl_per_dim(m1, s1, m2, s2)),
                             rtol=1e-6, atol=1e-7)
  with pytest.raises(ValueError, match="aggregation"):
    port_ss._aggregate(*t, "median")


def _tied_moments():
  """Rows whose per-dimension symmetric KLs hold exact ties: equal deltas
  (the match ranking's ties) and deltas equal to (max + min) / 2 (the
  adaptive threshold's)."""
  m1 = np.zeros((4, 6), np.float32)
  m2 = np.array([[0, 0, 1, 1, 2, 2],        # pairs of equal deltas
                 [0, 1, 2, 1, 0, 2],        # 1 sits on (max + min) / 2
                 [1, 1, 1, 1, 1, 1],        # every delta tied
                 [0, 0, 0, 0, 0, 0]],       # identical members
                np.float32)
  s = np.ones((4, 6), np.float32)
  return m1, s, m2, s


@pytest.mark.parametrize("cls,kwargs", [
    ("WeaklySupervisedVAE", dict(strategy="match", n_changed=1)),
    ("WeaklySupervisedVAE", dict(strategy="match", n_changed=3)),
    ("AdaptiveVAE", {}),
])
def test_tie_breaking_matches_jax(cls, kwargs):
  jvae, vae = make_pair(cls, **kwargs)
  m1, s1, m2, s2 = _tied_moments()
  want = np.asarray(jvae._shared_mask(jnp.asarray(m1), jnp.asarray(s1),
                                      jnp.asarray(m2), jnp.asarray(s2)))
  got = vae._shared_mask(*(torch.from_numpy(a) for a in (m1, s1, m2, s2)))
  np.testing.assert_array_equal(got.numpy(), want)


def test_constructor_arguments_as_jax():
  _, vae = make_pair("AdaptiveVAE", base_method="ml")
  assert vae.aggregation == "multilevel" and vae.n_shared is None
  with pytest.raises(ValueError, match="base_method"):
    make_pair("AdaptiveVAE", base_method="mean")
  with pytest.raises(ValueError, match="strategy"):
    make_pair("WeaklySupervisedVAE", strategy="order")
  jvae, vae = make_pair("WeaklySupervisedVAE", strategy="rank")
  assert (vae.strategy, vae.n_changed, vae.rank_dim, vae.rank_weight,
          vae.label_weight) == (jvae.strategy, jvae.n_changed, jvae.rank_dim,
                                jvae.rank_weight, jvae.label_weight)
