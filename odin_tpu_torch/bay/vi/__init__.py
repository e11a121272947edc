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
    MIVAE,
    VAE,
    VQVAE,
    AnnealingVAE,
    Autoencoder,
    Beta10VAE,
    BetaCapacityVAE,
    BetaGammaVAE,
    BetaTCVAE,
    BetaVAE,
    DIPVAE,
    DistEncoder,
    Factor2VAE,
    FactorDiscriminator,
    FactorVAE,
    Gamma10VAE,
    HypersphericalVAE,
    ImplicitRankMinimizer,
    ImputeVAE,
    InfoVAE,
    PowersphericalVAE,
    SemiFactor2VAE,
    SemiFactorVAE,
    StochasticVAE,
    TwoStageVAE,
    VAECore,
    VampriorVAE,
    VariationalAutoencoder,
    VectorQuantizer,
    get_all_vae,
    get_vae,
    irmAE,
    irmVAE,
)
from odin_tpu_torch.bay.vi.disentanglement_gym import (
    DisentanglementGym,
    GroundTruth,
    concat_mean,
    first_mean,
    plot_latent_stats,
)
from odin_tpu_torch.bay.vi.losses import (
    disentangled_inferred_prior_loss,
    gaussian_kernel,
    get_divergence,
    linear_kernel,
    maximum_mean_discrepancy,
    pairwise_distances,
    polynomial_kernel,
    total_correlation,
)
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
