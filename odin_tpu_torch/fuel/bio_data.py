"""Gene-expression and chromatin-accessibility datasets of the port
(PyTorch port of ``odin_tpu/fuel/bio_data.py``): ``GeneDataset``,
``Cortex`` and ``PBMC`` (``.npz`` files of ``x`` counts and ``y`` cell
types, split 80/10/10), ``SyntheticGenes`` (:82, ZINB counts over latent
cell types), the ATAC readers (:125-168), ``HumanEmbryos``,
``SyntheticATAC`` (:177, Bernoulli peaks of a topic model) and the HGNC
table ``HumanGenome`` (:244).

The generators are copies of the JAX package's, draw for draw on numpy's
``RandomState``, so a seed gives the same arrays in both packages.  The
files are read from ``utils.get_data_path()`` (``$ODIN_TPU_HOME/
datasets``); nothing is downloaded.  ``HumanGenome`` keeps its table in
plain numpy columns (``GeneTable``) where the JAX package uses pandas.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from odin_tpu_torch.fuel.dataset_base import IterableDataset, get_partition
from odin_tpu_torch.utils import get_data_path

__all__ = ["GeneDataset", "Cortex", "PBMC", "SyntheticGenes",
           "Melanoma", "Forebrain", "Insilico", "BreastTumor", "Leukemia",
           "HumanEmbryos", "SyntheticATAC", "HumanGenome", "GeneTable"]


def _split(n: int, partition: str) -> slice:
  return get_partition(partition, train=slice(0, int(0.8 * n)),
                       valid=slice(int(0.8 * n), int(0.9 * n)),
                       test=slice(int(0.9 * n), n))


class GeneDataset(IterableDataset):

  @property
  def data_type(self):
    return "gene"


class _NPZGene(GeneDataset):
  _name = ""
  _n_genes = 0
  _labels: List[str] = []

  def __init__(self, path: Optional[str] = None, seed: int = 1):
    super().__init__(seed=seed)
    self.path = path or os.path.join(get_data_path(), f"{self._name}.npz")
    self._cache = None

  @property
  def name(self):
    return self._name

  @property
  def shape(self):
    return (self._n_genes,)

  @property
  def labels(self):
    return list(self._labels)

  def _load(self, partition: str):
    if self._cache is None:
      if not os.path.exists(self.path):
        raise FileNotFoundError(
            f"dataset '{self._name}' not found at {self.path} (no network "
            "egress — use SyntheticGenes for testing)")
      self._cache = dict(np.load(self.path))
    x, y = self._cache["x"], self._cache.get("y")
    sl = _split(len(x), partition)
    return x[sl], (y[sl] if y is not None else None)


class Cortex(_NPZGene):
  """Mouse cortex scRNA-seq: 558 genes, 7 cell types."""
  _name = "cortex"
  _n_genes = 558
  _labels = ["astrocytes_ependymal", "endothelial-mural", "interneurons",
             "microglia", "oligodendrocytes", "pyramidal CA1",
             "pyramidal SS"]


class PBMC(_NPZGene):
  """Peripheral blood mononuclear cells: 1000 genes, 4 cell types."""
  _name = "pbmc"
  _n_genes = 1000
  _labels = ["B cells", "CD4 T", "CD8 T", "NK cells"]


class SyntheticGenes(GeneDataset):
  """A ZINB count matrix over latent cell types: per-type Gamma(2, 2) gene
  means, a log-normal library size per cell, NB counts of dispersion 2,
  and 30 % of the counts zeroed."""

  def __init__(self, n_cells: int = 2000, n_genes: int = 200,
               n_types: int = 4, seed: int = 1):
    super().__init__(seed=seed)
    rng = np.random.RandomState(seed)
    self.n_genes = int(n_genes)
    self.n_types = int(n_types)
    means = rng.gamma(2.0, 2.0, size=(n_types, n_genes))
    types = rng.randint(0, n_types, n_cells)
    mu = means[types] * rng.lognormal(0, 0.3, size=(n_cells, 1))
    theta = 2.0
    p = mu / (mu + theta)
    counts = rng.negative_binomial(theta, 1 - p)
    dropout = rng.rand(n_cells, n_genes) < 0.3
    counts = np.where(dropout, 0, counts)
    self._x = counts.astype("float32")
    self._y = types.astype("int64")

  @property
  def name(self):
    return "syntheticgenes"

  @property
  def shape(self):
    return (self.n_genes,)

  @property
  def labels(self):
    return [f"type{i}" for i in range(self.n_types)]

  def _load(self, partition: str):
    sl = _split(len(self._x), partition)
    return self._x[sl], self._y[sl]


class _NPZAtac(_NPZGene):
  """Binary chromatin-accessibility matrices, read from their converted
  ``{x, y, labels_name}`` ``.npz`` files."""

  @property
  def data_type(self):
    return "atac"

  @property
  def labels(self):
    if self._cache is not None and "labels_name" in self._cache:
      return [str(s) for s in self._cache["labels_name"]]
    return list(self._labels)


class Melanoma(_NPZAtac):
  """Melanoma scATAC (Bravo González-Blas et al. 2019)."""
  _name = "melanoma_atac"
  _labels = ["MM001_proliferative", "MM011_proliferative",
             "MM031_proliferative", "MM047_invasive", "MM057_proliferative",
             "MM074_proliferative", "MM087_proliferative", "MM099_invasive"]


class Forebrain(_NPZAtac):
  _name = "forebrain_atac"
  _labels = []


class Insilico(_NPZAtac):
  _name = "insilico_atac"
  _labels = []


class BreastTumor(_NPZAtac):
  _name = "breast_tumor_atac"
  _labels = []


class Leukemia(_NPZAtac):
  _name = "leukemia_atac"
  _labels = []


class HumanEmbryos(_NPZGene):
  """scRNA-seq of human pre-implantation embryos."""
  _name = "human_embryos"
  _labels = ["E3", "E4", "E5", "E6", "E7"]


class SyntheticATAC(GeneDataset):
  """Binary accessibility from a latent topic model (cisTopic's
  assumptions): cell topic mixtures times topic-region profiles give each
  region's rate, and a peak is open with probability ``1 - exp(-rate)``."""

  def __init__(self, n_cells: int = 2000, n_regions: int = 300,
               n_topics: int = 5, seed: int = 1):
    super().__init__(seed=seed)
    rng = np.random.RandomState(seed)
    self.n_regions = int(n_regions)
    self.n_topics = int(n_topics)
    profiles = rng.dirichlet(np.full(n_regions, 0.1), size=n_topics)
    types = rng.randint(0, n_topics, n_cells)
    theta = rng.dirichlet(np.full(n_topics, 0.3), size=n_cells)
    theta = 0.7 * np.eye(n_topics)[types] + 0.3 * theta
    rate = theta @ profiles * n_regions * 0.5
    self._x = (rng.rand(n_cells, n_regions) <
               (1 - np.exp(-rate))).astype("float32")
    self._y = types.astype("int64")

  @property
  def name(self):
    return "syntheticatac"

  @property
  def data_type(self):
    return "atac"

  @property
  def shape(self):
    return (self.n_regions,)

  @property
  def labels(self):
    return [f"topic{i}" for i in range(self.n_topics)]

  def _load(self, partition: str):
    sl = _split(len(self._x), partition)
    return self._x[sl], self._y[sl]


# ---------------------------------------------------------------------------
# HGNC human-genome annotation table
# ---------------------------------------------------------------------------
_HGNC_HEADER = [
    "hgnc_id", "symbol", "name", "locus_group", "locus_type", "status",
    "location", "location_sortable", "alias_symbol", "alias_name",
    "prev_symbol", "prev_name", "gene_family", "gene_family_id",
    "date_approved_reserved", "date_symbol_changed", "date_name_changed",
    "date_modified", "entrez_id", "ensembl_gene_id", "vega_id", "ucsc_id",
    "ena", "refseq_accession", "ccds_id", "uniprot_ids", "pubmed_id",
    "mgd_id", "rgd_id", "lsdb", "cosmic", "omim_id", "mirbase", "homeodb",
    "snornabase", "bioparadigms_slc", "orphanet", "pseudogene.org",
    "horde_id", "merops", "imgt", "iuphar", "kznf_gene_catalog",
    "mamit-trnadb", "cd", "lncrnadb", "enzyme_id",
    "intermediate_filament_db", "rna_central_ids", "lncipedia", "gtrnadb",
    "agr",
]
_HGNC_FILTERED = ["ensembl_gene_id", "name", "symbol", "alias_symbol",
                  "alias_name", "locus_type", "location", "cd",
                  "uniprot_ids", "enzyme_id"]
_HGNC_CHROMOSOMES = [str(i) for i in range(1, 23)] + ["X", "Y", "Mitochondria"]


class GeneTable:
  """Rows of string columns: ``table[column]`` is a column (an object
  array), ``table.rows(mask)`` the rows where `mask` holds, ``shape``
  (rows, columns)."""

  def __init__(self, columns: Dict[str, np.ndarray]):
    self.columns = {k: np.asarray(v, dtype=object)
                    for k, v in columns.items()}

  @classmethod
  def concat(cls, tables: Sequence["GeneTable"]) -> "GeneTable":
    keys = list(tables[0].columns)
    return cls({k: np.concatenate([t.columns[k] for t in tables])
                for k in keys})

  @property
  def shape(self):
    n = len(next(iter(self.columns.values()))) if self.columns else 0
    return (n, len(self.columns))

  @property
  def header(self) -> np.ndarray:
    return np.asarray(list(self.columns), dtype=object)

  def __getitem__(self, column: str) -> np.ndarray:
    return self.columns[column]

  def rows(self, mask: np.ndarray) -> "GeneTable":
    return GeneTable({k: v[mask] for k, v in self.columns.items()})

  def __repr__(self):
    return f"GeneTable(rows={self.shape[0]}, columns={list(self.columns)})"


class HumanGenome:
  """The HGNC gene-annotation table: lookup of a gene's symbol, Ensembl
  id, CD marker and locus by any of its values.

  `path` holds the per-chromosome TSVs under their HGNC names
  (``protein-coding_gene_chr_<c>.txt``, ``non-coding_RNA_chr_<c>.txt``),
  or `table` is one TSV of the 52-column HGNC header (a path) or a
  ``GeneTable``; nothing is downloaded."""

  def __init__(self, path: str = "~/human_genome", table=None):
    frames = []
    if table is not None:
      if isinstance(table, str):
        table = self._read_tsv(table)
      frames.append(self._filter(table, chromosome=None))
    else:
      path = os.path.abspath(os.path.expanduser(path))
      if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} does not exist and this environment has no network "
            "egress: place the HGNC per-chromosome TSVs there (see "
            "genenames.org statistics-and-files) or pass `table=`")
      for chro in _HGNC_CHROMOSOMES:
        for kind in ("protein-coding_gene", "non-coding_RNA"):
          fpath = os.path.join(path, f"{kind}_chr_{chro}.txt")
          if os.path.exists(fpath):
            frames.append(self._filter(self._read_tsv(fpath),
                                       chromosome=str(chro).capitalize()))
      if not frames:
        raise FileNotFoundError(f"no HGNC TSV files found under {path}")
    self.db = GeneTable.concat(frames)
    self.unique_index = {
        col: {v for v in dict.fromkeys(self.db[col]) if len(str(v)) > 0}
        for col in self.header
    }

  @staticmethod
  def _read_tsv(fpath) -> GeneTable:
    rows = []
    with open(fpath, "r") as f:
      for line in f:
        rows.append([c.replace('"', "") for c in line.rstrip("\n").split("\t")])
    data = np.asarray(rows, dtype=object)
    if data.ndim != 2 or data.shape[1] != len(_HGNC_HEADER):
      raise ValueError(f"{fpath}: expected {len(_HGNC_HEADER)} HGNC columns")
    if list(data[0]) != _HGNC_HEADER:
      raise ValueError(f"{fpath}: unknown header {list(data[0][:5])}...")
    return GeneTable({str(c): data[1:, i] for i, c in enumerate(data[0])})

  @staticmethod
  def _filter(table: GeneTable, chromosome) -> GeneTable:
    cols = {k: table[k] for k in _HGNC_FILTERED}
    n = len(cols[_HGNC_FILTERED[0]])
    cols["chromosome"] = np.full(n, "" if chromosome is None else chromosome,
                                 dtype=object)
    return GeneTable(cols)

  @property
  def header(self) -> np.ndarray:
    return self.db.header

  def unique(self, column_name):
    return sorted(self.unique_index[column_name])

  def __contains__(self, key) -> bool:
    try:
      self[key]
      return True
    except KeyError:
      return False

  def __getitem__(self, key) -> GeneTable:
    """The rows holding a value in any column (a string key), or matching
    every column=value constraint (a dict or a list of pairs)."""
    if isinstance(key, (tuple, list, np.ndarray)):
      if not isinstance(key[0], (tuple, list, np.ndarray)):
        key = [key]
      key = dict(key)
    if isinstance(key, str):
      for col, values in self.unique_index.items():
        if key in values:
          return self.db.rows(self.db[col] == key)
      raise KeyError(f"Cannot find gene with key info: {key}")
    if isinstance(key, dict):
      mask = np.ones(self.db.shape[0], bool)
      for col, val in key.items():
        mask &= self.db[str(col)] == str(val)
      if not mask.any():
        raise KeyError(f"No gene matches {key}")
      return self.db.rows(mask)
    raise KeyError(f"key can be dict or string, given: {type(key)}")

  def _get(self, key, column) -> str:
    rows = self[key]
    assert rows.shape[0] == 1, f"Found multiple entries for key='{key}'"
    return str(rows[str(column)][0])

  def get_chromosome(self, key) -> str:
    return self._get(key, "chromosome")

  def get_locus_type(self, key) -> str:
    return self._get(key, "locus_type")

  def get_protein_cd(self, key) -> str:
    return self._get(key, "cd")

  def get_protein_id(self, key) -> str:
    return self._get(key, "uniprot_ids")

  def get_gene_symbol(self, key) -> str:
    return self._get(key, "symbol")

  def get_gene_id(self, key) -> str:
    return self._get(key, "ensembl_gene_id")

  def get_gene_name(self, key) -> str:
    return self._get(key, "name")

  def is_cd_gene(self, key) -> bool:
    if key not in self:
      return False
    return len(self.get_protein_cd(key)) > 0

  def __repr__(self):
    return (f"HumanGenome(genes={self.db.shape[0]}, "
            f"columns={list(self.header)})")
