"""Backend utilities of the port: the annealing schedules, the verification
metrics (EER, minDCF, DET curve, Cavg/Cnorm) and the Fréchet distances."""
from odin_tpu_torch.backend import interpolation, metrics
from odin_tpu_torch.backend.interpolation import Interpolation
from odin_tpu_torch.backend.metrics import (compute_AUC, compute_Cavg,
                                            compute_Cnorm, compute_EER,
                                            compute_minDCF, det_curve)
