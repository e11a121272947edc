"""A HuggingFace transformer as a sentence embedder (PyTorch port of
``odin_tpu/ml/neural_nlp.py``).  The weights must be in the local cache
(``local_files_only=True``): a model that is not raises
``FileNotFoundError``.  ``transformers`` is imported inside the
constructor.  The model runs on `device` (the card unless the caller asks
for the CPU) and ``transform`` returns a tensor there."""
from __future__ import annotations

from typing import List, Sequence

import torch

from odin_tpu_torch.device import resolve_device

__all__ = ["Transformer"]


class Transformer:
  """Mean, first-token (``'cls'``) or max pooling (any other `pooling`) of
  the last hidden state over the attention mask."""

  def __init__(self, model_name: str = "bert-base-uncased",
               pooling: str = "mean", device="cuda"):
    self.model_name = model_name
    self.pooling = pooling
    self.device = resolve_device(device)
    try:
      from transformers import AutoModel, AutoTokenizer
      self.tokenizer = AutoTokenizer.from_pretrained(model_name,
                                                     local_files_only=True)
      self.model = AutoModel.from_pretrained(model_name,
                                             local_files_only=True)
      self.model.eval()
    except Exception as e:
      raise FileNotFoundError(
          f"transformer '{model_name}' is not cached locally and this "
          "environment has no network egress; pre-download the model or use "
          "the TF-IDF/BoW datasets instead") from e
    self.model.to(self.device)

  def transform(self, sentences: Sequence[str],
                batch_size: int = 16) -> torch.Tensor:
    out: List[torch.Tensor] = []
    with torch.no_grad():
      for i in range(0, len(sentences), batch_size):
        batch = list(sentences[i:i + batch_size])
        enc = self.tokenizer(batch, padding=True, truncation=True,
                             return_tensors="pt").to(self.device)
        h = self.model(**enc).last_hidden_state
        mask = enc["attention_mask"].unsqueeze(-1).float()
        if self.pooling == "mean":
          emb = (h * mask).sum(1) / mask.sum(1)
        elif self.pooling == "cls":
          emb = h[:, 0]
        else:
          emb = (h * mask).max(1).values
        out.append(emb)
    return torch.cat(out)

  __call__ = transform
