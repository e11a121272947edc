"""Datasets of the port (the procedural dSprites so far)."""
from odin_tpu_torch.fuel.dataset_base import get_partition
from odin_tpu_torch.fuel.image_data import dSprites
