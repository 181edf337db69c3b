"""Task heads (port of ``rmcl_tpu/models/heads.py``): pooler, ITM, MLM, the
masked-patch heads (MPP, MPPD, MPFR), the VQA and NLVR2 classifiers, rank
output, the MoCo projector and the BarlowTwins projector.  Module names follow
the reference state_dict."""

from __future__ import annotations

import torch
from torch import nn

from rmcl_tpu_torch.models.layers import BatchNorm1d, LayerNorm, Linear, gelu
from rmcl_tpu_torch.models.text_embeddings import BERT_LN_EPS
from rmcl_tpu_torch.parallel.tp import copy_to_model, gather_from_model

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
    own and a separate ``bias`` parameter.  ``shards`` m > 1 (a model axis):
    the decoder and bias hold this rank's V/m rows of the vocabulary, and the
    logits of the model group are gathered (``parallel/tp.py``), so that every
    rank computes the loss on the full (.., V) logits."""

    def __init__(self, hidden: int, vocab: int, shards: int = 1):
        super().__init__()
        self.shards = shards
        if vocab % shards:
            raise ValueError(f"a model axis of {shards} does not divide the vocabulary {vocab}")
        self.transform = nn.ModuleDict({"dense": Linear(hidden, hidden),
                                        "LayerNorm": LayerNorm(hidden, BERT_LN_EPS)})
        self.decoder = Linear(hidden, vocab // shards, bias=False)
        self.bias = nn.Parameter(torch.empty(vocab // shards))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(self.transform["dense"](x))
        y = self.transform["LayerNorm"](y)
        if self.shards == 1:
            return self.decoder(y) + self.bias.to(y.dtype)
        return gather_from_model(self.decoder(copy_to_model(y)) + self.bias.to(y.dtype))


class PatchHead(nn.Module):
    """dense + GELU + LayerNorm (eps 1e-12), then a decoder with its bias:
    ``mpp_score`` (C -> 3 x 256 RGB bins), ``mppd_score`` (C -> P*P*3
    pixels) and ``mpfr_score`` (C -> C patch features)."""

    def __init__(self, hidden: int, out_dim: int):
        super().__init__()
        self.transform = nn.ModuleDict({"dense": Linear(hidden, hidden),
                                        "LayerNorm": LayerNorm(hidden, BERT_LN_EPS)})
        self.decoder = Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.transform["LayerNorm"](gelu(self.transform["dense"](x)))
        return self.decoder(y)


class Classifier(nn.ModuleDict):
    """Linear -> LayerNorm(eps 1e-5) -> GELU -> Linear under keys 0, 1, 3
    (the VQA head, and the NLVR2 head on 2C features)."""

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


class BarlowTwinsHead(nn.Module):
    """Linear (no bias) -> BatchNorm -> ReLU -> Linear (no bias) -> BatchNorm
    -> ReLU -> Linear (no bias) under ``projector`` keys 0, 1, 3, 4, 6, then
    ``norm``, a BatchNorm without affine parameters (reference heads.py:88-106).
    ``forward(cls_feats, training, update)``: the three BatchNorms in
    training mode (batch statistics) or not (running statistics); their
    running statistics move only when ``training`` and ``update``."""

    def __init__(self, in_dim: int, inner, out_dim: int):
        super().__init__()
        d0, d1, d2, d3 = in_dim, *inner, out_dim
        self.projector = nn.ModuleDict({"0": Linear(d0, d1, bias=False), "1": BatchNorm1d(d1),
                                        "3": Linear(d1, d2, bias=False), "4": BatchNorm1d(d2),
                                        "6": Linear(d2, d3, bias=False)})
        self.norm = BatchNorm1d(d3, affine=False)

    def forward(self, cls_feats: torch.Tensor, training: bool = True,
                update: bool = False) -> torch.Tensor:
        p = self.projector
        y = torch.relu(p["1"](p["0"](cls_feats), training, update))
        y = torch.relu(p["4"](p["3"](y), training, update))
        return self.norm(p["6"](y), training, update)
