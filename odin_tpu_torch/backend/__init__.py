"""Backend utilities of the port: the annealing schedules, the verification
metrics (EER, minDCF, DET, ROC and precision-recall curves, Cavg/Cnorm,
accuracies, confusion matrix, label error rate), the Fréchet distances and
``to_llh``/``to_llr``."""
from odin_tpu_torch.backend import interpolation, maths, metrics
from odin_tpu_torch.backend.interpolation import Interpolation
from odin_tpu_torch.backend.metrics import (compute_AUC, compute_Cavg,
                                            compute_Cnorm, compute_EER,
                                            compute_minDCF, det_curve)
