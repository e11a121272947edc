"""Backend utilities of the port: the annealing schedules and the Fréchet
distances."""
from odin_tpu_torch.backend import interpolation, metrics
from odin_tpu_torch.backend.interpolation import Interpolation
