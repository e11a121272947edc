"""Image datasets of the port."""
from odin_tpu_torch.fuel.image_data._base import ImageDataset
from odin_tpu_torch.fuel.image_data.datasets import (FullGridMixin, HalfMoons,
                                                     Shapes3D, Shapes3D0,
                                                     Shapes3DSmall, dSprites,
                                                     dSprites0, dSpritesSmall,
                                                     make_moons)
