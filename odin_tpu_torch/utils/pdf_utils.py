"""PDF library management helpers.

Reference: ``odin/utils/pdf_utils.py`` — extract titles/text from a folder
of paper PDFs and rename the files to their titles.  Network (arXiv API)
and PyPDF parsing are environment-gated here: this box has no egress and no
PyPDF install, so `get_arxiv_titles` raises without network and
`get_pdf_text`/`get_pdf_titles` fall back to a minimal in-repo parser that
handles the common case (the `/Title` entry of the document info
dictionary in an uncompressed trailer) before giving up.  The rename logic
itself (`sanitize_title`, `rename_pdf`) is pure and fully tested.

The port's copy of the JAX package's ``odin_tpu/utils/pdf_utils.py``, which
imports no JAX.
"""
from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = ["get_arxiv_titles", "get_pdf_text", "get_pdf_titles",
           "rename_pdf", "sanitize_title"]

_ARXIV = re.compile(r"\d{4}\.\d{4,5}")


def _to_files(path: str) -> List[str]:
  path = os.path.abspath(os.path.expanduser(path))
  if os.path.isfile(path):
    return [path]
  return [os.path.join(path, name) for name in os.listdir(path)
          if name.lower().endswith(".pdf")]


def sanitize_title(title: Optional[str]) -> Optional[str]:
  """Normalize a raw PDF title into a filename (the reference's inline
  cleanup in ``pdf_utils.py:109-117``): newlines -> spaces, path
  separators -> dots, empty/untitled -> None."""
  if title is None:
    return None
  title = title.replace("\n", " ").replace("/", ".").replace("\\", ".")
  title = " ".join(title.split()).strip()
  if not title or "untitled" in title.lower():
    return None
  return title


def get_arxiv_titles(article_ids):
  """Query the arXiv export API for titles (reference ``pdf_utils.py:24``).
  Requires network access."""
  from urllib.request import urlopen
  from xml.etree import ElementTree
  if not isinstance(article_ids, (tuple, list)):
    article_ids = [article_ids]
  ids = ",".join(str(i) for i in article_ids if _ARXIV.match(str(i)))
  query = f"http://export.arxiv.org/api/query?id_list={ids}"
  with urlopen(query, timeout=30) as res:
    tree = ElementTree.fromstring(res.read().decode("utf-8"))
  titles = [e.text for child in tree if child.tag.endswith("}entry")
            for e in child if e.tag.endswith("}title")]
  if not titles:
    return None
  return titles[0] if len(titles) == 1 else tuple(titles)


def _info_title(raw: bytes) -> Optional[str]:
  """Best-effort /Title extraction from raw PDF bytes: finds literal
  ``/Title (...)`` or hex ``/Title <...>`` strings in uncompressed
  dictionaries."""
  m = re.search(rb"/Title\s*\(((?:[^()\\]|\\.)*)\)", raw)
  if m:
    text = re.sub(rb"\\([()\\])", rb"\1", m.group(1))
    try:
      return text.decode("utf-16") if text.startswith(b"\xfe\xff") \
          else text.decode("utf-8", "replace")
    except Exception:
      return None
  m = re.search(rb"/Title\s*<([0-9A-Fa-f\s]+)>", raw)
  if m:
    data = bytes.fromhex(m.group(1).decode("ascii").replace("\n", "")
                         .replace(" ", ""))
    try:
      return data.decode("utf-16") if data.startswith(b"\xfe\xff") \
          else data.decode("utf-8", "replace")
    except Exception:
      return None
  return None


def get_pdf_text(path: str) -> Dict[str, list]:
  """Per-file page texts (reference ``pdf_utils.py:45``).  Uses pypdf /
  PyPDF2 when installed (not bundled in this environment)."""
  try:
    try:
      from pypdf import PdfReader
    except ImportError:
      from PyPDF2 import PdfReader
  except ImportError as e:
    raise ImportError("get_pdf_text requires pypdf/PyPDF2 (not installed "
                      "in this environment)") from e
  results = {}
  for fpath in _to_files(path):
    reader = PdfReader(fpath)
    results[fpath] = [page.extract_text() for page in reader.pages]
  return results


def get_pdf_titles(path: str, use_arxiv: bool = False) -> Dict[str, Optional[str]]:
  """Map pdf path -> title (reference ``pdf_utils.py:67``): arXiv-id
  filenames resolve via the API only when ``use_arxiv`` (network); other
  files use the document-info /Title (pypdf when installed, else the
  in-repo raw scan)."""
  path2title: Dict[str, Optional[str]] = {}
  for fpath in sorted(_to_files(path)):
    filename = ".".join(os.path.basename(fpath).split(".")[:-1])
    if use_arxiv and _ARXIV.match(filename):
      try:
        title = get_arxiv_titles(filename)
        path2title[fpath] = sanitize_title(title)
        continue
      except Exception:
        pass
    title = None
    try:
      try:
        from pypdf import PdfReader
      except ImportError:
        from PyPDF2 import PdfReader
      info = PdfReader(fpath).metadata
      title = None if info is None else info.get("/Title")
    except Exception:
      # no pypdf installed, or it failed to parse: raw /Title scan
      try:
        with open(fpath, "rb") as f:
          title = _info_title(f.read())
      except Exception:
        title = None
    path2title[fpath] = sanitize_title(title)
  return path2title


def rename_pdf(path: str, verbose: bool = True,
               dry_run: bool = False) -> Dict[str, int]:
  """Rename every pdf under `path` to its extracted title (reference
  ``pdf_utils.py:122``).  Returns {'ignored': n, 'matched': n,
  'renamed': n}; `dry_run` reports without touching files."""
  stats: Dict[str, int] = defaultdict(int)
  logs = []
  for fpath, title in get_pdf_titles(path).items():
    if title is None:
      stats["ignored"] += 1
      logs.append(f"Ignore: {fpath}")
      continue
    ext = fpath.split(".")[-1]
    outpath = os.path.join(os.path.dirname(fpath), f"{title}.{ext}")
    if os.path.basename(fpath) == os.path.basename(outpath):
      stats["matched"] += 1
      logs.append(f"Matched: {fpath}")
    else:
      stats["renamed"] += 1
      logs.append(f"Rename: {fpath} to {os.path.basename(outpath)}")
      if not dry_run:
        os.rename(fpath, outpath)
  if verbose and logs:
    print("\n".join(sorted(logs)))
  return dict(stats)
