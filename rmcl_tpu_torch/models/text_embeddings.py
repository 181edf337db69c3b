"""BERT text embeddings (port of ``rmcl_tpu/models/text_embeddings.py``):
word + position + token-type-0 embeddings summed in fp32, cast to the
activation type, then LayerNorm with eps 1e-12."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rmcl_tpu_torch.models.layers import Embedding, LayerNorm

BERT_LN_EPS = 1e-12


class TextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, max_position: int):
        super().__init__()
        self.word_embeddings = Embedding(vocab_size, hidden_size)
        self.position_embeddings = Embedding(max_position, hidden_size)
        self.token_type_embeddings = Embedding(2, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, BERT_LN_EPS)

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype,
                word_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) int ids -> (B, T, C) in ``dtype``.  ``word_embeds`` (B, T, C)
        replaces the word lookup: the greedy attack differentiates with
        respect to it (``attacks/greedy.py``)."""
        T = input_ids.shape[-1]
        x = self.word_embeddings(input_ids) if word_embeds is None else word_embeds
        x = (x + self.position_embeddings.weight[:T][None]
             + self.token_type_embeddings.weight[0][None, None])
        return self.LayerNorm(x.to(dtype))
