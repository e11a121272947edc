"""The port's Gym draws each of its ten plots and ``plot_latent_stats``
(``odin_tpu_torch/bay/vi/disentanglement_gym.py``) on the CPU with
matplotlib's Agg backend, from data computed on the model's device: a
``BetaVAE`` at zdim 4 and 64 test images of ``dSpritesSmall(n_samples=
256)``.  Each plot writes a PNG, or returns its figure without a path.
tests/test_torch_gym_plots.py holds each plot's data against the JAX
package's, and tests/test_torch_imports.py checks that a plot needs
matplotlib only when it is drawn.
"""

import numpy as np
import pytest
import torch

import odin_tpu_torch.bay.vi as vi
from odin_tpu_torch.fuel import dSpritesSmall
from odin_tpu_torch.networks import get_networks

torch.set_num_threads(2)
PNG = b"\x89PNG\r\n\x1a\n"
PLOTS = ("plot_reconstruction", "plot_latents_traverse", "plot_latents_tsne",
         "plot_correlation", "plot_histogram", "plot_distortion",
         "plot_latents_stats", "plot_interpolation", "plot_prior_sampling",
         "plot_pairwise_scatter")


@pytest.fixture(scope="module")
def gym():
  vae = vi.BetaVAE(**get_networks("dsprites", zdim=4)).build(seed=1,
                                                             device="cpu")
  g = vi.DisentanglementGym(dataset=dSpritesSmall(n_samples=256), model=vae,
                            batch_size=64)
  return g.run_model(n_samples=64, partition="test")


@pytest.mark.parametrize("name", PLOTS)
def test_plot_writes_a_png(gym, name, tmp_path):
  path = str(tmp_path / f"{name}.png")
  assert getattr(gym, name)(path=path) == path
  with open(path, "rb") as fh:
    assert fh.read(8) == PNG


def test_plots_return_figures(gym):
  import matplotlib.figure
  import matplotlib.pyplot as plt
  fig = gym.plot_latents_stats(title="q(z|x)")
  assert isinstance(fig, matplotlib.figure.Figure)
  assert len(fig.axes) == 2  # the statistics and the KL's twin axis
  plt.close(fig)
  fig = vi.plot_latent_stats(np.zeros(3), np.ones(3), kld=np.ones(3),
                             weights=torch.arange(3.0))
  assert len(fig.axes) == 2 and len(fig.axes[1].lines) == 2
  plt.close(fig)
