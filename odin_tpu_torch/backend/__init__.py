"""Backend utilities of the port (the annealing schedules so far)."""
from odin_tpu_torch.backend import interpolation
from odin_tpu_torch.backend.interpolation import Interpolation
