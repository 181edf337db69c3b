"""Tensor-parallel sharding of the model's parameters (counterpart of
``rmcl_tpu/parallel/sharding_rules.py``), on reference-named state dicts.

The Megatron rules of the JAX package's ``_spec_for`` (:34-65), in torch
layouts (a linear weight is (out, in)):

    [k_]transformer.blocks.i.attn.qkv   weight (3C, C), bias  -> dim 0 (column parallel)
    [k_]transformer.blocks.i.attn.proj  weight (C, C)         -> dim 1 (row parallel)
    [k_]transformer.blocks.i.mlp.fc1    weight (4C, C), bias  -> dim 0
    [k_]transformer.blocks.i.mlp.fc2    weight (C, 4C)        -> dim 1
    mlm_score.decoder.weight (V, C), mlm_score.bias (V,)      -> dim 0 (vocab parallel)

Every other entry is replicated, the row-parallel biases (proj, fc2) among
them: the first shard of the model group adds them after its partial sum.
One departure in layout, not in rule: the qkv shard is aligned to heads.
Rank r of m holds the q, k and v rows of heads [r H/m, (r+1) H/m), so that
its fused attention half runs H/m whole heads.  The JAX package's
``P(None, "model")`` cuts the (C, 3C) kernel into contiguous blocks (at m = 2
all of q and half of k), which XLA reshards around the head split.

``shard_state_dict`` and ``gather_state_dict`` turn a full state dict into a
rank's shard and back, exactly; so the full dicts that
``ViLT.load_reference_state_dict``, checkpoints and serving read stay what
they are.  The gradients of the replicated LayerNorms and row-parallel biases
of the blocks are partial sums over the model group (``model_partial``), which
``parallel/dist.py:all_reduce_grads`` adds before the data mean.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch

_BLOCK = r"^(k_)?transformer\.blocks\.\d+\."
_RULES = ((re.compile(_BLOCK + r"attn\.qkv\.(weight|bias)$"), 0),
          (re.compile(_BLOCK + r"attn\.proj\.weight$"), 1),
          (re.compile(_BLOCK + r"mlp\.fc1\.(weight|bias)$"), 0),
          (re.compile(_BLOCK + r"mlp\.fc2\.weight$"), 1),
          (re.compile(r"^mlm_score\.(decoder\.weight|bias)$"), 0))
_QKV = re.compile(_BLOCK + r"attn\.qkv\.")
_PARTIAL = re.compile(_BLOCK + r"(norm1\.(weight|bias)|norm2\.(weight|bias)|"
                      r"attn\.proj\.bias|mlp\.fc2\.bias)$")


def shard_dim(name: str) -> Optional[int]:
    """The dimension of entry ``name`` that the model axis shards, or None
    (replicated)."""
    for pattern, dim in _RULES:
        if pattern.match(name):
            return dim
    return None


def model_partial(name: str) -> bool:
    """A replicated parameter whose gradient each model rank holds a part of:
    the blocks' LayerNorms (their backward runs inside the fused halves, on the
    rank's partial input gradient) and the row-parallel biases (the first
    shard alone adds them)."""
    return bool(_PARTIAL.match(name))


def check_shards(cfg, m: int) -> None:
    """Raise unless ``m`` divides the heads, the MLP width and, with an MLM
    head, the vocabulary."""
    if m < 1:
        raise ValueError(f"model axis of size {m}")
    sizes = {"num_heads": cfg.num_heads, "MLP width": cfg.mlp_ratio * cfg.hidden_size}
    if cfg.loss_names.get("mlm", 0) > 0:
        sizes["vocab_size"] = cfg.vocab_size
    bad = {k: v for k, v in sizes.items() if v % m}
    if bad:
        raise ValueError(f"a model axis of {m} does not divide {bad}")


def _qkv_blocks(t: torch.Tensor, m: int) -> List[List[torch.Tensor]]:
    """[part][rank] blocks of a qkv weight or bias: q, k and v each cut into m
    runs of whole heads."""
    return [list(part.chunk(m, 0)) for part in t.chunk(3, 0)]


def shard_tensor(name: str, t: torch.Tensor, rank: int, m: int) -> torch.Tensor:
    """Rank ``rank``'s shard of entry ``name`` (a copy), or ``t`` itself when
    the entry is replicated or m == 1."""
    dim = shard_dim(name)
    if dim is None or m == 1:
        return t
    if t.shape[dim] % (3 * m if _QKV.match(name) else m):
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not split into {m} shards")
    if _QKV.match(name):
        return torch.cat([blocks[rank] for blocks in _qkv_blocks(t, m)]).clone()
    return t.chunk(m, dim)[rank].clone()


def shard_state_dict(sd: Dict[str, torch.Tensor], rank: int, m: int
                     ) -> Dict[str, torch.Tensor]:
    """A full reference-named state dict -> model rank ``rank``'s of ``m``."""
    return {k: shard_tensor(k, v, rank, m) for k, v in sd.items()}


def gather_state_dict(shards: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the m ranks' dicts, in model-rank
    order -> the full dict (replicated entries from rank 0)."""
    m = len(shards)
    out = {}
    for k, v in shards[0].items():
        dim = shard_dim(k)
        if dim is None or m == 1:
            out[k] = v
        elif _QKV.match(k):
            parts = [s[k].chunk(3, 0) for s in shards]       # [rank][part]
            out[k] = torch.cat([parts[r][p] for p in range(3) for r in range(m)])
        else:
            out[k] = torch.cat([s[k] for s in shards], dim)
    return out


def check_zero1(cfg, m: int) -> None:
    """ZeRO-1 shards the optimizer's state over the data axis only, as
    ``zero1_shardings`` refuses a mesh with a model axis (:113-116)."""
    if cfg.zero1 and m > 1:
        raise ValueError("zero1 requires a pure-data mesh; optimizer state on "
                         "model-axis meshes already follows the tensor-parallel layout")


def shard_model(cfg, full, rank: int, m: int):
    """A ``ViLT`` of model rank ``rank``'s shards of the full model ``full``:
    every parameter and buffer its shard of ``full``'s, so that the shard is
    the same slice of the same weights on any grid."""
    from rmcl_tpu_torch.models.vilt import ViLT
    check_shards(cfg, m)
    model = ViLT(cfg, model_shards=m)
    model.load_state_dict(shard_state_dict(full.state_dict(), rank, m))
    return model.to(next(full.parameters()).device)


def gather_over_model(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full state dict from this rank's shard dict ``sd`` and its model
    group's (an all-gather over the active grid's model group; ``sd`` itself
    with a one-rank group)."""
    import torch.distributed as dist

    from rmcl_tpu_torch.parallel import mesh
    m = mesh.model_size()
    if m == 1:
        return dict(sd)
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(m)]
    for k, v in sd.items():
        if shard_dim(k) is None:
            for s in shards:
                s[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(m)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model_group())
        for s, part in zip(shards, parts):
            s[k] = part
    return gather_state_dict(shards)


def gather_model(cfg, model, grads: bool = False):
    """The unsharded ``ViLT`` of the model group's shards ``model`` (its
    parameters and buffers gathered, ``gather_over_model``), on the CPU; with
    ``grads`` each parameter's ``.grad`` the gathered gradient, where the
    shards have one.  Every rank of the model group must call it."""
    from rmcl_tpu_torch.models.vilt import ViLT
    full = ViLT(cfg)
    full.load_state_dict({k: v.cpu() for k, v in gather_over_model(
        {k: v.detach() for k, v in model.state_dict().items()}).items()})
    if grads:
        got = gather_over_model({n: p.grad for n, p in model.named_parameters()
                                 if p.grad is not None})
        for n, p in full.named_parameters():
            p.grad = got[n].cpu() if n in got else None
    return full
