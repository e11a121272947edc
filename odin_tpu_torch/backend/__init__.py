"""Backend utilities of the port: the annealing schedules, the verification
metrics (EER, minDCF, DET, ROC and precision-recall curves, Cavg/Cnorm,
accuracies, confusion matrix, label error rate), the Fréchet distances, the
math helpers, the metric-learning losses and the name parsers; the same
names as ``odin_tpu.backend``."""
from odin_tpu_torch.backend import alias, interpolation, losses, maths, metrics
from odin_tpu_torch.backend.interpolation import Interpolation
from odin_tpu_torch.backend.maths import (
    length_norm,
    log_norm,
    poincare_normalize,
    renorm_rms,
    softplus_inverse,
    to_llh,
    to_llr,
    to_sample_weights,
    whitening,
)
from odin_tpu_torch.backend.metrics import (
    LER,
    binary_accuracy,
    categorical_accuracy,
    compute_AUC,
    compute_Cavg,
    compute_Cnorm,
    compute_EER,
    compute_minDCF,
    confusion_matrix,
    det_curve,
    frechet_distance,
    frechet_inception_distance,
    prc_curve,
    roc_curve,
    roc_curve_,
)
from odin_tpu_torch.backend.losses import (
    bayes_binary_crossentropy,
    bayes_crossentropy,
    contrastive_loss,
    correntropy_regularize,
    cosine_similarity,
    jacobian_regularize,
    triplet_loss,
)
from odin_tpu_torch.backend.alias import (
    identity_function,
    parse_activation,
    parse_attention,
    parse_constraint,
    parse_initializer,
    parse_layer,
    parse_loss,
    parse_metric,
    parse_normalizer,
    parse_optimizer,
    parse_reduction,
    parse_regularizer,
)
