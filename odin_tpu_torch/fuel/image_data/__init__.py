"""Image datasets of the port."""
from odin_tpu_torch.fuel.image_data._base import ImageDataset
from odin_tpu_torch.fuel.image_data.datasets import (
    CIFAR10, CIFAR20, CIFAR100, MNIST, SVHN, BinarizedAlphaDigits,
    BinarizedMNIST, CelebA, CelebABig, CelebASmall, FashionMNIST,
    FullGridMixin, HalfMNIST, HalfMoons, HalfMoonsImage, Kaokore, LegoFaces,
    NPZImageDataset, Omniglot, Shapes3D, Shapes3D0, Shapes3DSmall,
    YDisentanglement, dSprites, dSprites0, dSpritesSmall, make_halfmoons,
    make_moons)
