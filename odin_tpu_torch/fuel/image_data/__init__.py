"""Image datasets of the port."""
from odin_tpu_torch.fuel.image_data.datasets import dSprites
