"""Single-stream ViLT (port of ``rmcl_tpu/models/vilt.py``): the deterministic
forward and the training forward with dropout.

The module tree carries the reference state_dict names
(``rmcl_tpu/compat/torch_loader.py``), so a reference checkpoint, or the
JAX package's parameters and state through ``compat/from_jax.py``, load
with ``load_reference_state_dict``.  Heads are built per active loss as
``init_vilt`` builds them: pooler, ITM, MLM, the masked-patch heads of
``mpp``, ``mppd`` and ``mpfr``, VQA, NLVR2 (with the three-row token-type
table), rank output, the MoCo projector and, with the ``barlowtwins`` loss,
the BarlowTwins projector (``cfg.bt_proj_dims``; its BatchNorm running
statistics are buffers).  With
the ``moco`` loss active the model also carries the momentum twins
(``k_text_embeddings``, ``k_token_type_embeddings``, ``k_transformer``,
``k_moco_head``; the key path shares ``pooler``) and the negatives queue
(``proj_queue``, ``proj_queue_ptr``) as buffers; ``infer_k`` runs the twins.

Dropout.  The JAX package splits a key per task, view, layer and dropout
site.  Here one int32 tensor of seeds per step (``draw_seeds``: views x
(layers + 1) x 2 x B, from an explicit ``torch.Generator``, moved to the
device once) feeds the one Philox stream of ``ops/philox.py``: rows 0 ..
layers - 1 seed the blocks' two halves, the last row the dropout after the
text embeddings and after the visual embeddings (``ops/dropout.py``, draw 0).

Block configuration.  ``derive_block_impls`` ports ``_derive_attn_impl`` /
``_derive_mlp_impl`` (``rmcl_tpu/models/vilt.py:61-87``): the config's
``attention_impl`` and ``mlp_impl`` pick the ops of every block of the query
transformer and of its momentum twin (``models/vit.py:Block``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from rmcl_tpu_torch.models.heads import (BarlowTwinsHead, Classifier, ITMHead, MLMHead,
                                         MoCoHead, PatchHead, Pooler)
from rmcl_tpu_torch.models.layers import BatchNorm1d, Embedding, Linear, reset_all
from rmcl_tpu_torch.models.text_embeddings import TextEmbeddings
from rmcl_tpu_torch.models.vit import (ViT, as_patch_rows, normalize_u8, patch_index,
                                      resize_pos_embed)
from rmcl_tpu_torch.ops.dropout import dropout

MOCO_PROJ_DIM = 128
# parts the JAX package's conversion of a torch checkpoint does not read
# (rmcl_tpu/compat/torch_loader.py:convert_state_dict): from such a file they
# keep the model's own values
UNCONVERTED_PARTS = ("mppd_score", "mpfr_score")


def draw_seeds(generator: torch.Generator, views: int, num_layers: int, batch: int,
               device) -> torch.Tensor:
    """(views, num_layers + 1, 2, batch) int32 dropout seeds on ``device``: one
    ``seeds[v]`` per training forward of ``ViLT.infer``."""
    s = torch.randint(-2 ** 31, 2 ** 31, (views, num_layers + 1, 2, batch),
                      generator=generator, dtype=torch.int64)
    return s.to(torch.int32).to(device)


def derive_block_impls(cfg) -> Tuple[str, str]:
    """(attn_impl, mlp_impl) of the blocks from ``cfg.attention_impl`` and
    ``cfg.mlp_impl``.  "" derives what the JAX package derives on one chip
    with its kernels on: "fused" attention, and "fused_train", which needs a
    raised scoped-VMEM limit on the TPU and nothing here.  Explicit values are
    kept: "pallas" and "flash" run the unfused block around the attention-core
    op (``flash``'s library kernel computes the same function on every row
    that is read).  The plain XLA paths ("xla", "xla_bf16", ``mlp_impl="xla"``)
    are not ported: on the card every block runs hand-written kernels."""
    attn, mlp = cfg.attention_impl or "fused", cfg.mlp_impl or "fused_train"
    if attn in ("xla", "xla_bf16") or mlp == "xla":
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r}, mlp_impl={cfg.mlp_impl!r}: the plain "
            "XLA block paths are not ported (ROADMAP, Queue A, 'Not ported'); use "
            "'fused' / 'pallas' / 'flash' and 'fused' / 'fused_train'")
    if attn not in ("fused", "pallas", "flash") or mlp not in ("fused", "fused_train"):
        raise ValueError(f"unknown block configuration attention_impl="
                         f"{cfg.attention_impl!r}, mlp_impl={cfg.mlp_impl!r}")
    return attn, mlp


def _needs(cfg, *names: str) -> bool:
    return any(cfg.loss_names.get(n, 0) > 0 for n in names)


class ViLT(nn.Module):
    """``model_shards`` m > 1: model rank's shards of a tensor-parallel model
    (``parallel/sharding_rules.py``; built by ``shard_model`` from the full
    one, never initialised itself): the query transformer, its momentum twin
    and the MLM decoder."""

    def __init__(self, cfg, model_shards: int = 1):
        super().__init__()
        C = cfg.hidden_size
        self.model_shards = model_shards
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.grid_hw = tuple(cfg.grid_hw)
        self.patch_size = cfg.patch_size
        self.max_image_len = cfg.max_image_len
        self.drop_rate = cfg.drop_rate
        self.block_impls = derive_block_impls(cfg)

        self.text_embeddings = TextEmbeddings(cfg.vocab_size, C, cfg.max_text_len)
        self.token_type_embeddings = Embedding(
            3 if _needs(cfg, "nlvr2", "nlvr2_attacked") else 2, C)
        self.transformer = ViT(C, cfg.num_heads, cfg.num_layers, cfg.mlp_ratio,
                               cfg.patch_size, cfg.image_size, *self.block_impls,
                               model_shards)
        self.pooler = Pooler(C)
        if _needs(cfg, "mlm"):
            self.mlm_score = MLMHead(C, cfg.vocab_size, model_shards)
        if _needs(cfg, "itm", "irtr"):
            self.itm_score = ITMHead(C)
        if _needs(cfg, "mpp"):
            self.mpp_score = PatchHead(C, 256 * 3)
        if _needs(cfg, "mppd"):
            self.mppd_score = PatchHead(C, cfg.patch_size ** 2 * 3)
        if _needs(cfg, "mpfr"):
            self.mpfr_score = PatchHead(C, C)
        if _needs(cfg, "vqa", "vqa_attacked"):
            self.vqa_classifier = Classifier(C, 2 * C, cfg.vqav2_label_size)
        if _needs(cfg, "nlvr2", "nlvr2_attacked"):
            # on the two images' concatenated class features
            self.nlvr2_classifier = Classifier(2 * C, 2 * C, 2)
        if _needs(cfg, "irtr"):
            self.rank_output = Linear(C, 1)
        if _needs(cfg, "moco", "irtr_attacked"):
            self.moco_head = MoCoHead(C, C, MOCO_PROJ_DIM)
        if _needs(cfg, "moco"):
            self.k_text_embeddings = TextEmbeddings(cfg.vocab_size, C, cfg.max_text_len)
            self.k_token_type_embeddings = Embedding(
                self.token_type_embeddings.weight.shape[0], C)
            self.k_transformer = ViT(C, cfg.num_heads, cfg.num_layers, cfg.mlp_ratio,
                                     cfg.patch_size, cfg.image_size, *self.block_impls,
                                     model_shards)
            self.k_moco_head = MoCoHead(C, C, MOCO_PROJ_DIM)
            qdt = getattr(torch, cfg.queue_dtype or cfg.compute_dtype)
            self.register_buffer("proj_queue",
                                 torch.zeros(MOCO_PROJ_DIM, cfg.num_negative, dtype=qdt))
            self.register_buffer("proj_queue_ptr", torch.zeros(1, dtype=torch.int32))
        if _needs(cfg, "barlowtwins"):     # no momentum twins and no queue
            d1, d2, dout = cfg.bt_proj_dims
            self.barlowtwins_head = BarlowTwinsHead(C, (d1, d2), dout)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "ViLT":
        """Seeded initialisation, as ``init_vilt`` does it (different numbers:
        torch's generator is not JAX's)."""
        reset_all(self, generator)
        tte = self.token_type_embeddings.weight
        if tte.shape[0] == 3:
            tte[2] = tte[1]          # NLVR2's third row starts as the image row
        if hasattr(self, "rank_output"):
            self.rank_output.weight.copy_(self.itm_score.fc.weight[1:2])
            self.rank_output.bias.copy_(self.itm_score.fc.bias[1:2])
        if hasattr(self, "k_transformer"):
            # momentum twins start as exact copies; the queue as random
            # UNnormalised vectors (reference vilt_module.py:92-94, :270-273)
            for name in ("text_embeddings", "token_type_embeddings", "transformer",
                         "moco_head"):
                getattr(self, "k_" + name).load_state_dict(
                    getattr(self, name).state_dict())
            q = torch.randn(self.proj_queue.shape, generator=generator)
            self.proj_queue.copy_(q.to(self.proj_queue.dtype))
            self.proj_queue_ptr.zero_()
        return self

    def load_reference_state_dict(self, sd: Dict[str, torch.Tensor],
                                  reference_file: bool = False) -> List[str]:
        """Load a reference-named state dict into this model as the JAX
        package merges a converted checkpoint into its fresh init
        (``rmcl_tpu/train/loop.py:load_initial_params``' ``merge`` over
        ``rmcl_tpu/compat/torch_loader.py:convert_state_dict``):
          * a part (top-level module) the model builds but ``sd`` lacks keeps
            the model's own values: a head, the ``k_*`` twins, the pooler;
            so does the queue, and its pointer is 0 when ``sd`` has the queue
            without it;
          * a part ``sd`` has must be whole, as the conversion reads it: a
            missing entry raises, except a linear bias and a BatchNorm's
            weight and bias (the model's own stay) and
            ``transformer.mask_token`` (zeros);
          * repairs: a 2-row ``token_type_embeddings`` (and its twin) where
            the model has 3 rows (NLVR2) takes row 1 again as row 2; a
            ``transformer.pos_embed`` (and its twin) of another grid is
            resized to the model's (``vit.resize_pos_embed``);
          * a misshapen entry the repairs do not fix raises, naming it;
          * entries of parts this model does not build, entries its parts do
            not have and torch BatchNorm's ``num_batches_tracked`` counters are
            skipped and returned.  With ``reference_file`` (a torch file read
            as the conversion reads one) so are the parts it does not convert
            (``mppd_score``, ``mpfr_score``), which keep the model's own."""
        own_sd = self.state_dict()
        parts = ({name for name, _ in self.named_children()}
                 | {name for name, _ in self.named_buffers(recurse=False)}) - (
            set(UNCONVERTED_PARTS) if reference_file else set())
        keep = {k: v for k, v in sd.items() if k in own_sd and k.split(".", 1)[0] in parts}
        if "proj_queue" in keep:
            keep.setdefault("proj_queue_ptr", torch.zeros_like(own_sd["proj_queue_ptr"]))
        else:
            keep.pop("proj_queue_ptr", None)
        for prefix in ("", "k_"):
            name = f"{prefix}token_type_embeddings.weight"
            if name in keep and keep[name].shape[0] == 2 and own_sd[name].shape[0] == 3:
                keep[name] = torch.cat([keep[name], keep[name][1:2]], 0)
            name = f"{prefix}transformer.pos_embed"
            if name in keep and keep[name].shape[1] != own_sd[name].shape[1]:
                keep[name] = resize_pos_embed(keep[name], own_sd[name].shape[1] - 1)
            name = f"{prefix}transformer.mask_token"
            if any(k.startswith(f"{prefix}transformer.") for k in keep):
                keep.setdefault(name, torch.zeros_like(own_sd[name]))
        optional = {f"{m}.{p}" for m, mod in self.named_modules()
                    for p in (("bias",) if isinstance(mod, Linear) else
                              ("weight", "bias") if isinstance(mod, BatchNorm1d) else ())}
        present = {k.split(".", 1)[0] for k in keep}
        missing = sorted(k for k in own_sd if k.split(".", 1)[0] in present - {
            "proj_queue", "proj_queue_ptr"} and k not in keep and k not in optional)
        if missing:
            raise KeyError(f"the state dict lacks entries of parts it holds: {missing}")
        bad = [f"{k}: {tuple(v.shape)}, the model's {tuple(own_sd[k].shape)}"
               for k, v in keep.items() if v.shape != own_sd[k].shape]
        if bad:
            raise ValueError(f"misshapen entries: {bad}")
        own_sd.update(keep)
        self.load_state_dict(own_sd, strict=True)
        return sorted(k for k in sd if k not in keep)

    def infer(self, batch: Dict[str, torch.Tensor],
              block_matrices: Optional[List[Dict[str, torch.Tensor]]] = None,
              image_token_type_idx: int = 1,
              image_embeds: Optional[torch.Tensor] = None,
              image_masks: Optional[torch.Tensor] = None,
              prefix: str = "", deterministic: bool = True,
              seeds: Optional[torch.Tensor] = None,
              word_embeds: Optional[torch.Tensor] = None, mask_text: bool = False,
              mask_image: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Forward of a wire-format batch: ``image`` patch rows
        (B, N, P*P*3), or the canvas (B, H, W, 3) of ``image_layout="hwc"``
        (patch rows on entry), as uint8 with ``image_hw`` (B, 2), or
        normalised fp32;
        ``text_ids`` and ``text_masks`` (B, T).  A batch with ``image_0`` /
        ``image_1`` (NLVR2) is read at ``image_{image_token_type_idx - 1}``
        with its ``_hw``.  ``block_matrices`` are the
        transformer's weights cast once (``ViT.block_matrices``).  With
        ``image_embeds`` and ``image_masks`` (``ViT.visual_embed_from_prep``)
        the image is not embedded again.  ``prefix="k_"`` runs the momentum
        twins (with the shared pooler).  ``deterministic=False`` is the
        training forward: dropout at ``drop_rate`` after both embeddings and
        inside every block, from ``seeds`` (layers + 1, 2, B) int32, and
        gradients to the parameters.  ``word_embeds`` (B, T, C) replaces the
        word-embedding lookup of ``text_ids`` (the greedy attack's saliency
        gradient is taken with respect to it).  ``mask_text`` reads the MLM
        collator's ``text_ids_mlm`` and ``text_labels_mlm`` in place of
        ``text_ids`` and ``text_labels``; ``mask_image`` (2, B, N) bool, the
        drawn MPP masks (masked, replaced) over every patch, embeds the image
        with them (``ViT.visual_embed_masked``) and returns its
        ``image_labels``.  The returned dict is the JAX package's:
        ``text_feats``, ``image_feats``, ``cls_feats``, ``raw_cls_feats``,
        ``image_masks``, ``image_labels`` (None unmasked, and with
        ``image_embeds``), ``patch_index`` (B, L, 2) (None with
        ``image_embeds``), ``text_labels``, ``text_ids``, ``text_masks``."""
        dtype = self.compute_dtype
        if deterministic:
            seeds = None
        elif seeds is None:
            raise ValueError("the training forward needs seeds (draw_seeds)")
        p = self.drop_rate
        transformer = getattr(self, prefix + "transformer")
        mlm = "_mlm" if mask_text else ""
        text_ids = batch[f"text_ids{mlm}"]
        text = getattr(self, prefix + "text_embeddings")(text_ids, dtype, word_embeds)
        if seeds is not None:
            text = dropout(text, seeds[-1, 0], 0, p)
        image_labels = pidx = None
        if image_embeds is None and image_masks is None:
            key = f"image_{image_token_type_idx - 1}"
            key = key if key in batch else "image"
            img = batch[key]
            if img.dtype == torch.uint8:
                img = normalize_u8(img, batch.get(f"{key}_hw"), self.grid_hw,
                                   self.patch_size)
            # the HWC canvas (image_layout="hwc") as patch rows on its own grid
            img, grid_hw = as_patch_rows(img, self.grid_hw, self.patch_size)
            if mask_image is not None:
                image_embeds, image_masks, image_labels, pidx = \
                    transformer.visual_embed_masked(img, grid_hw, self.max_image_len,
                                                    dtype, mask_image[0], mask_image[1])
            else:
                prep = transformer.visual_embed_prepare(img, grid_hw, self.max_image_len)
                image_embeds, image_masks = transformer.visual_embed_from_prep(prep, None,
                                                                               dtype)
                pidx = patch_index(prep, grid_hw)
            if seeds is not None:
                image_embeds = dropout(image_embeds, seeds[-1, 1], 0, p)
        else:
            image_embeds = image_embeds.to(dtype)
        tte = getattr(self, prefix + "token_type_embeddings").weight
        text = text + tte[0].to(dtype)
        image = image_embeds + tte[image_token_type_idx].to(dtype)

        x = torch.cat([text, image], dim=1)
        masks = torch.cat([batch["text_masks"].int(), image_masks.int()], dim=1)
        x = transformer(x, masks, block_matrices,
                        None if seeds is None else seeds[:-1], p)
        T = text.shape[1]
        return {"text_feats": x[:, :T], "image_feats": x[:, T:],
                "cls_feats": self.pooler(x), "raw_cls_feats": x[:, 0],
                "image_masks": image_masks, "image_labels": image_labels,
                "patch_index": pidx, "text_labels": batch.get(f"text_labels{mlm}"),
                "text_ids": text_ids, "text_masks": batch["text_masks"]}

    def infer_k(self, batch: Dict[str, torch.Tensor], **kw) -> Dict[str, torch.Tensor]:
        """``infer`` through the momentum twins (the key encoder)."""
        return self.infer(batch, prefix="k_", **kw)
