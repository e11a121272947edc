"""Distribution heads of the port."""
from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
