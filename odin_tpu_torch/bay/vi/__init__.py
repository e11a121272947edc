"""Variational inference of the port: the VAE family and the
disentanglement evaluation (the Gym, its metrics and their estimators)."""
from odin_tpu_torch.bay.vi._base import VariationalModel, traverse_dims
from odin_tpu_torch.bay.vi.utils import (
    discretizing,
    marginalize_categorical_labels,
    permute_dims,
    prepare_ssl_inputs,
    split_ssl_inputs,
)
from odin_tpu_torch.bay.vi.autoencoder import (
    AnnealingVAE,
    Beta10VAE,
    BetaCapacityVAE,
    BetaGammaVAE,
    BetaTCVAE,
    BetaVAE,
    Gamma10VAE,
    VAECore,
    VariationalAutoencoder,
)
from odin_tpu_torch.bay.vi.disentanglement_gym import (
    DisentanglementGym,
    GroundTruth,
    concat_mean,
    first_mean,
    plot_latent_stats,
)
from odin_tpu_torch.bay.vi.losses import total_correlation
from odin_tpu_torch.bay.vi.metrics import (
    Correlation,
    correlation_matrix,
    discrete_entropy,
    discrete_mutual_info,
    mutual_info_estimate,
    mutual_info_gap,
    relative_strength,
    unsupervised_clustering_scores,
)
from odin_tpu_torch.bay.vi.downstream_metrics import (
    beta_vae_score,
    completeness_score,
    dci_scores,
    disentanglement_score,
    factor_vae_score,
    importance_matrix,
    separated_attr_predictability,
)
from odin_tpu_torch.bay.vi.giga import estimate_Izx, estimate_Izy
