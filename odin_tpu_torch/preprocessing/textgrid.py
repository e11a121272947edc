"""Praat TextGrid parser of the port (a copy of
``odin_tpu/preprocessing/textgrid.py``, host Python): reads the interval
and point tiers of the long TextGrid format into Python structures."""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["Interval", "Tier", "TextGrid", "read_textgrid"]


@dataclass
class Interval:
  xmin: float
  xmax: float
  text: str

  @property
  def duration(self) -> float:
    return self.xmax - self.xmin


@dataclass
class Tier:
  name: str
  tier_type: str = "IntervalTier"
  xmin: float = 0.0
  xmax: float = 0.0
  intervals: List[Interval] = field(default_factory=list)

  def __iter__(self):
    return iter(self.intervals)

  def __len__(self):
    return len(self.intervals)

  def labels(self, skip_empty: bool = True) -> List[Tuple[float, float, str]]:
    return [(i.xmin, i.xmax, i.text) for i in self.intervals
            if i.text or not skip_empty]


@dataclass
class TextGrid:
  xmin: float = 0.0
  xmax: float = 0.0
  tiers: List[Tier] = field(default_factory=list)

  def __getitem__(self, key):
    if isinstance(key, int):
      return self.tiers[key]
    for t in self.tiers:
      if t.name == key:
        return t
    raise KeyError(key)

  def __len__(self):
    return len(self.tiers)

  @property
  def tier_names(self) -> List[str]:
    return [t.name for t in self.tiers]


_NUM = re.compile(r"(xmin|xmax|number)\s*=\s*([-\d.eE+]+)")
_TXT = re.compile(r"(text|mark|name|class)\s*=\s*\"(.*)\"")


def read_textgrid(path_or_text: str) -> TextGrid:
  """Parse the standard (long) TextGrid format."""
  import os
  text = path_or_text
  if os.path.exists(path_or_text):
    with open(path_or_text, encoding="utf-8", errors="replace") as f:
      text = f.read()
  tg = TextGrid()
  current_tier: Optional[Tier] = None
  current: dict = {}
  header_done = False
  for line in text.splitlines():
    line = line.strip()
    mnum = _NUM.search(line)
    mtxt = _TXT.search(line)
    if re.match(r"item \[\d+\]", line):  # 'item []:' header is not a tier
      if current_tier is not None and current.get("text") is not None:
        current_tier.intervals.append(Interval(
            current.get("xmin", 0.0), current.get("xmax", 0.0),
            current.get("text", "")))
      current_tier = Tier(name="")
      tg.tiers.append(current_tier)
      current = {}
      header_done = True
    elif line.startswith(("intervals [", "points [")):
      if current_tier is not None and current.get("text") is not None:
        current_tier.intervals.append(Interval(
            current.get("xmin", 0.0), current.get("xmax", 0.0),
            current.get("text", "")))
      current = {}
    elif mtxt:
      key, val = mtxt.group(1), mtxt.group(2)
      if current_tier is not None and key == "name":
        current_tier.name = val
      elif current_tier is not None and key == "class":
        current_tier.tier_type = val
      elif key in ("text", "mark"):
        current["text"] = val
    elif mnum:
      key, val = mnum.group(1), float(mnum.group(2))
      if current_tier is None:
        if not header_done:
          setattr(tg, key if key in ("xmin", "xmax") else "xmin", val) \
              if key in ("xmin", "xmax") else None
      else:
        if key == "number":
          current["xmin"] = current["xmax"] = val
        elif "text" in current or current:
          current[key] = val
        else:
          setattr(current_tier, key, val) if key in ("xmin", "xmax") else None
          current[key] = val
  if current_tier is not None and current.get("text") is not None:
    current_tier.intervals.append(Interval(
        current.get("xmin", 0.0), current.get("xmax", 0.0),
        current.get("text", "")))
  return tg
