"""Data layer of the port: the input pipeline, the on-disk stores and the
feature-store ``Dataset``, ``AudioFeatureLoader``, and the datasets ported
so far (the ``.npz`` image sets, dSprites and Shapes3D with their
variants, YDisentanglement, the half-moons as points and as images, the
gene-expression and ATAC sets of ``bio_data``, the text sets of
``nlp_data``), and the archive loaders of ``loaders``.  ``get_dataset``
looks a dataset up by name, as the JAX package's does."""
from typing import List, Type, Union

from odin_tpu_torch.fuel.bio_data import (PBMC, BreastTumor, Cortex,
                                          Forebrain, GeneDataset,
                                          HumanEmbryos, HumanGenome,
                                          Insilico, Leukemia, Melanoma,
                                          SyntheticATAC, SyntheticGenes)
from odin_tpu_torch.fuel.audio_data import (AudioFeatureLoader,
                                            synth_speaker_corpus)
from odin_tpu_torch.fuel.databases import (MmapArray, MmapArrayWriter,
                                           MmapDict, SQLiteDict, TableDict)
from odin_tpu_torch.fuel.dataset import Dataset
from odin_tpu_torch.fuel.dataset_base import IterableDataset, get_partition
from odin_tpu_torch.fuel.image_data import (
    CIFAR10, CIFAR20, CIFAR100, MNIST, SVHN, BinarizedAlphaDigits,
    BinarizedMNIST, CelebA, CelebABig, CelebASmall, FashionMNIST, HalfMNIST,
    HalfMoons, HalfMoonsImage, ImageDataset, Kaokore, LegoFaces,
    NPZImageDataset, Omniglot, Shapes3D, Shapes3D0, Shapes3DSmall,
    YDisentanglement, dSprites, dSprites0, dSpritesSmall)
from odin_tpu_torch.fuel.nlp_data import (ImdbReview, MathArithmetic,
                                          Newsgroup5, Newsgroup20,
                                          Newsgroup20_clean, NLPDataset,
                                          SyntheticBoW, TinyShakespear)
from odin_tpu_torch.fuel.pipeline import DataPipeline

__all__ = ["get_dataset", "get_all_dataset", "get_partition",
           "IterableDataset", "ImageDataset", "DataPipeline",
           "NPZImageDataset", "MNIST", "FashionMNIST", "BinarizedMNIST",
           "HalfMNIST", "BinarizedAlphaDigits", "SVHN", "CIFAR10",
           "CIFAR100", "CIFAR20", "CelebA", "CelebASmall", "CelebABig",
           "Omniglot", "LegoFaces", "Kaokore", "HalfMoonsImage",
           "YDisentanglement", "dSprites",
           "dSpritesSmall", "dSprites0", "Shapes3D", "Shapes3DSmall",
           "Shapes3D0", "HalfMoons", "Dataset", "MmapDict", "SQLiteDict",
           "MmapArray", "MmapArrayWriter", "TableDict", "AudioFeatureLoader",
           "synth_speaker_corpus", "NLPDataset", "SyntheticBoW",
           "MathArithmetic", "Newsgroup20", "Newsgroup5", "Newsgroup20_clean",
           "TinyShakespear", "ImdbReview", "GeneDataset", "Cortex", "PBMC",
           "SyntheticGenes", "Melanoma", "Forebrain", "Insilico",
           "BreastTumor", "Leukemia", "HumanEmbryos", "SyntheticATAC",
           "HumanGenome"]

_DATASETS = (MNIST, FashionMNIST, BinarizedMNIST, HalfMNIST,
             BinarizedAlphaDigits, SVHN, CIFAR10, CIFAR100, CIFAR20, CelebA,
             CelebASmall, CelebABig, Omniglot, LegoFaces, Kaokore, dSprites,
             dSprites0, dSpritesSmall, Shapes3D, Shapes3DSmall, Shapes3D0,
             HalfMoons, HalfMoonsImage, YDisentanglement, Cortex, PBMC,
             SyntheticGenes, Melanoma, Forebrain, Insilico, BreastTumor,
             Leukemia, HumanEmbryos, SyntheticATAC, Newsgroup20, Newsgroup5,
             Newsgroup20_clean, SyntheticBoW, MathArithmetic, TinyShakespear,
             ImdbReview)


def get_all_dataset(data_type: str = None) -> List[Type[IterableDataset]]:
  """The dataset classes, optionally those of one `data_type` ('image',
  'gene', 'atac', 'text')."""
  return sorted((c for c in _DATASETS
                 if data_type is None or c.data_type.fget(c) == data_type),
                key=lambda c: c.__name__)


def get_dataset(name: Union[str, IterableDataset], **kwargs) -> IterableDataset:
  """A dataset by its class name (``'dsprites'``, ``'cortex'``) or by its
  file's or corpus's name (``'binaryalphadigits'``, ``'melanoma_atac'``,
  ``'imdbreview'``); an unknown name raises."""
  if isinstance(name, IterableDataset):
    return name
  key = str(name).lower().replace("_", "").strip()
  for cls in get_all_dataset():
    if cls.__name__.lower().replace("_", "") == key:
      return cls(**kwargs)
  for cls in get_all_dataset():
    if str(getattr(cls, "_name", None)).replace("_", "") == key:
      return cls(**kwargs)
  raise ValueError(f"cannot find dataset '{name}'; available: "
                   f"{[c.__name__ for c in get_all_dataset()]}")
