"""Image datasets of the port."""
from odin_tpu_torch.fuel.image_data._base import ImageDataset
from odin_tpu_torch.fuel.image_data.datasets import (dSprites, dSprites0,
                                                     dSpritesSmall)
