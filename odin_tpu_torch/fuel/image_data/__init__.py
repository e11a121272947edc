"""Image datasets of the port."""
from odin_tpu_torch.fuel.image_data._base import ImageDataset
from odin_tpu_torch.fuel.image_data.datasets import (HalfMoons, dSprites,
                                                     dSprites0, dSpritesSmall,
                                                     make_moons)
