"""The gene-expression and ATAC datasets of the port against the JAX
package's: the generators bitwise at two seeds, every ``.npz`` reader on
a small file the test writes (its splits, labels, names and missing-file
error), the HGNC table on a small TSV, and the registry's gene and ATAC
classes."""
import numpy as np
import pytest

import odin_tpu.fuel as jfuel
import odin_tpu.fuel.bio_data as JB
import odin_tpu_torch.fuel as pfuel
import odin_tpu_torch.fuel.bio_data as PB

READERS = ["Cortex", "PBMC", "HumanEmbryos", "Melanoma", "Forebrain",
           "Insilico", "BreastTumor", "Leukemia"]


@pytest.mark.parametrize("seed", [1, 7])
def test_generators_are_jaxs_bitwise(seed):
  for cls, kw in (("SyntheticGenes", dict(n_cells=300, n_genes=558,
                                          n_types=7)),
                  ("SyntheticATAC", dict(n_cells=200, n_regions=300,
                                         n_topics=5))):
    p, j = getattr(PB, cls)(seed=seed, **kw), getattr(JB, cls)(seed=seed,
                                                                 **kw)
    assert (p.name, p.data_type, p.shape, p.labels) == \
        (j.name, j.data_type, j.shape, j.labels)
    for part in ("train", "valid", "test"):
      for a, b in zip(p._load(part), j._load(part)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x, y = p.numpy("train", n=5)
    jx, jy = j.numpy("train", n=5)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
  x = PB.SyntheticGenes(n_cells=300, n_genes=558, seed=seed)._x
  assert 0.3 < (x == 0).mean() < 0.9


@pytest.mark.parametrize("cls", READERS)
def test_npz_readers_match_jax(cls, tmp_path):
  rs = np.random.RandomState(READERS.index(cls))
  path = str(tmp_path / f"{cls}.npz")
  arrays = dict(x=rs.poisson(2.0, (40, 12)).astype(np.float32),
                y=rs.randint(0, 3, 40))
  if cls == "Melanoma":
    arrays["labels_name"] = np.array(["a", "b", "c"])
  np.savez(path, **arrays)
  p, j = getattr(PB, cls)(path=path), getattr(JB, cls)(path=path)
  assert (p.name, p.data_type, p.shape) == (j.name, j.data_type, j.shape)
  assert p.labels == j.labels
  for part in ("train", "valid", "test"):
    (px, py), (jx, jy) = p._load(part), j._load(part)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
  assert p.labels == j.labels  # after the load (the ATAC names)
  assert len(p._load("train")[0]) == 32 and len(p._load("test")[0]) == 4
  with pytest.raises(ValueError):
    p._load("nope")
  missing = str(tmp_path / "absent.npz")
  with pytest.raises(FileNotFoundError) as err:
    getattr(PB, cls)(path=missing)._load("train")
  with pytest.raises(FileNotFoundError) as jerr:
    getattr(JB, cls)(path=missing)._load("train")
  assert str(err.value) == str(jerr.value)


def test_default_paths_are_the_data_path(tmp_path, monkeypatch):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path))
  assert PB.Cortex().path == JB.Cortex().path == str(
      tmp_path / "datasets" / "cortex.npz")


def _tsv(path, rows):
  with open(path, "w") as f:
    f.write("\t".join(JB._HGNC_HEADER) + "\n")
    for r in rows:
      line = [""] * len(JB._HGNC_HEADER)
      for k, v in r.items():
        line[JB._HGNC_HEADER.index(k)] = v
      f.write("\t".join(line) + "\n")


ROWS = [dict(hgnc_id="HGNC:1", symbol="CD4", name="CD4 molecule",
             ensembl_gene_id="ENSG1", locus_type="gene with protein product",
             cd="CD4", uniprot_ids="P01730", location="12p13.31"),
        dict(hgnc_id="HGNC:2", symbol="MALAT1", name='"metastasis" lnc',
             ensembl_gene_id="ENSG2", locus_type="RNA, long non-coding",
             location="11q13.1"),
        dict(hgnc_id="HGNC:3", symbol="TP53", name="tumor protein p53",
             ensembl_gene_id="ENSG3", locus_type="gene with protein product",
             uniprot_ids="P04637", alias_symbol="p53")]


def _same_genome(p, j):
  assert list(p.header) == list(j.header)
  assert p.db.shape == j.db.shape
  for col in j.header:
    assert [str(v) for v in p.db[col]] == [str(v) for v in j.db[col]], col
    assert p.unique(col) == j.unique(col)
  for key in ("CD4", "ENSG2", "p53", "P04637", "12p13.31"):
    assert (key in p) == (key in j)
    for get in ("get_chromosome", "get_locus_type", "get_protein_cd",
                "get_protein_id", "get_gene_symbol", "get_gene_id",
                "get_gene_name"):
      assert getattr(p, get)(key) == getattr(j, get)(key), (key, get)
    assert p.is_cd_gene(key) == j.is_cd_gene(key)
  assert ("nope" in p) == ("nope" in j) is False
  assert p.is_cd_gene("nope") == j.is_cd_gene("nope") is False
  rows = p[{"locus_type": "gene with protein product"}]
  jrows = j[{"locus_type": "gene with protein product"}]
  assert list(rows["symbol"]) == list(jrows["symbol"])
  assert list(p[("symbol", "TP53")]["ensembl_gene_id"]) == \
      list(j[("symbol", "TP53")]["ensembl_gene_id"])
  for bad in ({"symbol": "X"}, "nope"):
    with pytest.raises(KeyError):
      p[bad]
  assert repr(p) == repr(j)


def test_human_genome_matches_jax(tmp_path):
  table = str(tmp_path / "hgnc.tsv")
  _tsv(table, ROWS)
  _same_genome(PB.HumanGenome(table=table), JB.HumanGenome(table=table))
  folder = tmp_path / "chr"
  folder.mkdir()
  _tsv(folder / "protein-coding_gene_chr_12.txt", ROWS[:1])
  _tsv(folder / "non-coding_RNA_chr_11.txt", ROWS[1:2])
  _tsv(folder / "protein-coding_gene_chr_X.txt", ROWS[2:])
  _same_genome(PB.HumanGenome(str(folder)), JB.HumanGenome(str(folder)))
  for path in (str(tmp_path / "none"), str(tmp_path)):
    with pytest.raises(FileNotFoundError):
      PB.HumanGenome(path)
  bad = tmp_path / "bad.tsv"
  bad.write_text("\t".join(["id"] + JB._HGNC_HEADER[1:]) + "\n")
  with pytest.raises(ValueError, match="unknown header"):
    PB.HumanGenome(table=str(bad))
  bad.write_text("a\tb\n")
  with pytest.raises(ValueError, match="52 HGNC columns"):
    PB.HumanGenome(table=str(bad))


def test_registry_names_the_gene_sets():
  for kind in ("gene", "atac"):
    assert [c.__name__ for c in pfuel.get_all_dataset(kind)] == \
        [c.__name__ for c in jfuel.get_all_dataset(kind)]
  assert type(pfuel.get_dataset("cortex")).__name__ == \
      type(jfuel.get_dataset("cortex")).__name__ == "Cortex"
  assert isinstance(pfuel.get_dataset("pbmc"), PB.PBMC)
  assert isinstance(pfuel.get_dataset("melanoma_atac"), PB.Melanoma)
  ds = pfuel.get_dataset("syntheticgenes", n_cells=20, n_genes=5)
  assert isinstance(ds, PB.SyntheticGenes) and ds.shape == (5,)
