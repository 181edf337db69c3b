"""Task heads served by the port (port of ``rmcl_tpu/models/heads.py``):
pooler, ITM, MLM, VQA classifier, rank output and the MoCo projector.
Module names follow the reference state_dict."""

from __future__ import annotations

import torch
from torch import nn

from rmcl_tpu_torch.models.layers import LayerNorm, Linear, gelu
from rmcl_tpu_torch.models.text_embeddings import BERT_LN_EPS

TORCH_LN_EPS = 1e-5    # nn.LayerNorm's default, used by the moco and vqa heads


class Pooler(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = Linear(hidden, hidden)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        """tanh(dense(x[:, 0]))."""
        return torch.tanh(self.dense(hidden_states[:, 0]))


class ITMHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.fc = Linear(hidden, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class MLMHead(nn.Module):
    """dense + GELU + LayerNorm, then an untied decoder with no bias of its
    own and a separate ``bias`` parameter."""

    def __init__(self, hidden: int, vocab: int):
        super().__init__()
        self.transform = nn.ModuleDict({"dense": Linear(hidden, hidden),
                                        "LayerNorm": LayerNorm(hidden, BERT_LN_EPS)})
        self.decoder = Linear(hidden, vocab, bias=False)
        self.bias = nn.Parameter(torch.empty(vocab))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(self.transform["dense"](x))
        y = self.transform["LayerNorm"](y)
        return self.decoder(y) + self.bias.to(y.dtype)


class Classifier(nn.ModuleDict):
    """Linear -> LayerNorm(eps 1e-5) -> GELU -> Linear under keys 0, 1, 3
    (the VQA head)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__({"0": Linear(in_dim, hidden),
                          "1": LayerNorm(hidden, TORCH_LN_EPS),
                          "3": Linear(hidden, out_dim)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self["3"](gelu(self["1"](self["0"](x))))


class MoCoHead(nn.Module):
    """Linear -> LayerNorm(eps 1e-5) -> ReLU -> Linear (no bias)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.projector = nn.ModuleDict({"0": Linear(in_dim, hidden),
                                        "1": LayerNorm(hidden, TORCH_LN_EPS),
                                        "3": Linear(hidden, out_dim, bias=False)})

    def forward(self, cls_feats: torch.Tensor) -> torch.Tensor:
        y = self.projector["1"](self.projector["0"](cls_feats))
        return self.projector["3"](torch.relu(y))
