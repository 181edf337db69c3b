"""A bare timm VisionTransformer state dict as the port's reference-named
transformer entries (port of ``rmcl_tpu/compat/torch_loader.py:load_timm_vit``).

The reference starts ViLT from timm's ImageNet weights (timm
``load_pretrained`` + ``checkpoint_filter_fn``, reference
vision_transformer.py:854-922).  Such a dict has keys like ``cls_token`` and
``blocks.0.attn.qkv.weight``, without the ``transformer.`` prefix:
  * a linear-format patch embedding (C, P*P*3) is reshaped to the conv layout
    (C, 3, P, P) first, as ``checkpoint_filter_fn`` does;
  * a pos-embed of another grid is resized to the model's
    (``models/vit.py:resize_pos_embed``, the JAX package's weights);
  * every key gets the ``transformer.`` prefix.
The result goes into a model through ``ViLT.load_reference_state_dict``,
which fills ``transformer.mask_token`` with zeros when the dict has none and
skips what the transformer does not hold (timm's classifier ``head``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rmcl_tpu_torch.models.vit import resize_pos_embed


def load_timm_vit(sd: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """timm ViT state dict (tensors or arrays) -> {``transformer.<key>``:
    CPU tensor} at the geometry of ``cfg``."""
    out = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v)) for k, v in sd.items()}
    pe = out.get("patch_embed.proj.weight")
    if pe is not None and pe.dim() == 2:
        P = cfg.patch_size
        out["patch_embed.proj.weight"] = pe.reshape(pe.shape[0], 3, P, P)
    n_model = (cfg.image_size // cfg.patch_size) ** 2 + 1
    if "pos_embed" in out and out["pos_embed"].shape[1] != n_model:
        out["pos_embed"] = resize_pos_embed(out["pos_embed"], n_model - 1)
    return {f"transformer.{k}": v for k, v in out.items()}
