"""ViT backbone of single-stream ViLT (port of ``rmcl_tpu/models/vit.py``):
the deterministic forward, differentiable with respect to its input, and
the training forward with dropout, differentiable with respect to its
parameters too.

* u8 wire format: ``normalize_u8`` is ``(v/255 - 0.5)/0.5`` in fp32, in that
  order, with padding forced to exactly 0.0 from ``image_hw`` per pixel.
* ``visual_embed`` takes patch rows (B, N, P*P*3): one matmul against the
  patch kernel, a validity mask read from each row's first pixel, a batched
  align_corners bilinear resample of the pos-embed to each sample's valid
  grid, and a stable sort by validity when ``max_image_len`` < N.  It is
  ``visual_embed_from_prep(visual_embed_prepare(rows))``: everything that
  does not depend on a pixel perturbation is in the ``VisualPrep``, so the
  PGD loop (``attacks/pgd.py``) prepares once and pays one matmul per
  iteration.
* ``ViT.visual_embed_masked`` is the masked-patch (MPP) embedding in the JAX
  package's order (``visual_embed(mask_it=True)``): the patch embedding of
  every patch, the learned ``mask_token`` in place of the replaced patches
  (``mask_tokens``), the ``max_image_len`` selection moving the labels and the
  patch grid coordinates with the features, -100 labels on padding patches
  and on the class token's row, then class token and pos-embed.  The labels
  are each patch's mean RGB of the unnormalised image in 256 bins; the two
  Bernoulli masks (masked, and replaced among the masked) are drawn by the
  caller over every patch before selection.
* ``ViT.forward`` runs the blocks, then the final LayerNorm.  Without
  ``seeds`` it is the deterministic forward (the key encoder, the attacks,
  serving); with ``seeds`` (layers, 2, B) the training forward at dropout rate
  ``p``, one seed per layer, half and sample, with gradients to every
  parameter.  ``Block.forward`` follows ``block_forward``'s dispatch
  (``rmcl_tpu/models/vit.py:444-553``) on the block configuration
  (``attn_impl``, ``mlp_impl``, derived by ``models/vilt.py:derive_block_impls``):

  attention half, ``attn_impl="fused"``:
    deterministic        ``attn_half`` (residual fused in)
    training, ``mlp_impl="fused_train"`` and p > 0
                         ``attn_half_train`` (dropout and residual inside)
    training otherwise   ``attn_half_full`` (``fused_attn_half``, row 2's
                         backward), then ``dropout`` and ``+ x`` outside
  attention half, ``attn_impl="pallas"`` or ``"flash"`` (the unfused block):
    ``layer_norm`` -> qkv ``linear`` -> head split -> ``masked_attention``
    (rows 10, 11) -> head merge -> proj ``linear`` [-> ``dropout``] -> ``+ x``
  MLP half:
    deterministic        ``mlp_half`` (residual fused in)
    training, ``mlp_impl="fused_train"``, or ``"fused"`` at p = 0
                         ``mlp_half_train(tail=True)``
    training, ``mlp_impl="fused"`` at p > 0
                         the plain block: LN2, fc1, GELU, ``dropout`` (draw 0),
                         fc2, ``dropout`` (draw 1), ``+ x``

  Under a model axis (``model_shards`` m > 1, tensor parallelism over the
  active grid's model group, ``parallel/mesh.py``) a block holds its shards
  (``parallel/sharding_rules.py``): qkv (3C/m, C) of H/m whole heads, proj
  (C, C/m), fc1 (4C/m, C), fc2 (C, 4C/m).  Every half, in every mode, runs
  the same op on the shards between Megatron's f and g (``parallel/tp.py``):
  f before it sums the input gradient over the model group, g after it sums
  the shards' partial outputs.  The first shard alone adds the residual and
  the proj / fc2 bias; the in-MLP mask of a shard starts at its first global
  hidden column.  Inside the fused training halves every shard drops its
  partial with the full (S, C) mask (dropout is linear for a fixed mask);
  where the dropout runs outside a kernel (F's attention half and plain MLP
  tail, P's attention half) it runs after g, on the sum.  The partials are
  rounded to the activation type by the ops and summed in it by g.  P's
  unfused attention runs the shard's H/m heads of width Ci/(H/m) between f
  and g.

  One kept deviation computes the same function another way: at p = 0 the
  JAX package runs ``fused_mlp_half`` (weight gradients from an XLA twin)
  where the port runs ``mlp_half_train`` (weight gradients from the
  kernels), for ``"fused"`` and for ``"fused_train"`` alike.  Every dropout, inside a kernel or outside (``ops/dropout.py``), draws
  from the one Philox convention, so the configurations compute the same
  function from the same seeds.  Unlike the TPU kernels the CUDA kernels
  mask their own ragged edges, so the sequence is not padded to 128.

LayerNorm eps inside the ViT is 1e-6.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rmcl_tpu_torch.models.layers import (LayerNorm, Linear, gelu, layer_norm, linear,
                                          trunc_normal_)
from rmcl_tpu_torch.ops.attention import masked_attention
from rmcl_tpu_torch.ops.dropout import dropout
from rmcl_tpu_torch.ops.fused_block import attn_half, attn_half_full, mlp_half
from rmcl_tpu_torch.ops.fused_block_train import attn_half_train, mlp_half_train
from rmcl_tpu_torch.parallel import mesh
from rmcl_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

VIT_LN_EPS = 1e-6


# ------------------------------------------------------------ u8 wire format
def normalize_u8(v: torch.Tensor, hw: Optional[torch.Tensor],
                 grid_hw: Tuple[int, int], patch_size: int) -> torch.Tensor:
    """u8 patch rows (B, N, P*P*3), or a u8 canvas (B, H, W, 3), -> fp32 in
    the same layout, normalised exactly as the host pipeline normalises;
    pixels outside each sample's (h, w) are 0.0."""
    x = (v.float() / 255.0 - 0.5) / 0.5
    if hw is None:
        return x
    if v.dim() == 4:                       # the canvas: the (h, w) rect itself
        yy = torch.arange(v.shape[1], device=v.device)[None, :, None]
        xx = torch.arange(v.shape[2], device=v.device)[None, None, :]
        valid = (yy < hw[:, 0, None, None]) & (xx < hw[:, 1, None, None])
        return torch.where(valid[..., None], x, 0.0)
    gw, P = grid_hw[1], patch_size
    if v.dim() != 3 or v.shape[1] != grid_hw[0] * gw:
        raise ValueError(f"u8 patch rows with hw metadata need the bucket grid "
                         f"{grid_hw}: got shape {tuple(v.shape)}")
    n = torch.arange(v.shape[1], device=v.device)
    e = torch.arange(v.shape[2], device=v.device)
    py = (n // gw)[:, None] * P + e[None, :] // (P * 3)
    px = (n % gw)[:, None] * P + (e[None, :] % (P * 3)) // 3
    valid = (py[None] < hw[:, 0, None, None]) & (px[None] < hw[:, 1, None, None])
    return torch.where(valid, x, 0.0)


# ------------------------------------------------------------ the HWC canvas
def to_patch_rows(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, gh*gw, P*P*3) rows in (ph, pw, ch) flat order."""
    B, H, W, _ = img.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = img.reshape(B, gh, P, gw, P, 3)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, P * P * 3)


def from_patch_rows(rows: torch.Tensor, grid_hw: Tuple[int, int],
                    patch_size: int) -> torch.Tensor:
    """(B, gh*gw, P*P*3) -> (B, H, W, 3): the inverse of ``to_patch_rows``."""
    gh, gw = grid_hw
    P = patch_size
    x = rows.reshape(rows.shape[0], gh, gw, P, P, 3)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(rows.shape[0], gh * P, gw * P, 3)


def as_patch_rows(img: torch.Tensor, grid_hw: Tuple[int, int], patch_size: int):
    """(patch rows, their grid) of patch rows (B, N, P*P*3) on ``grid_hw``,
    or of a canvas (B, H, W, 3) (``image_layout="hwc"``) on its own grid
    (H // P, W // P): the same numbers, permuted."""
    if img.dim() == 4:
        return to_patch_rows(img, patch_size), (img.shape[1] // patch_size,
                                                img.shape[2] // patch_size)
    return img, grid_hw


def normalize_image_inputs(batch: Dict[str, torch.Tensor], grid_hw: Tuple[int, int],
                           patch_size: int) -> Dict[str, torch.Tensor]:
    """Every uint8 image key of a wire-format batch (``image``, NLVR2's
    ``image_0`` / ``image_1``) as fp32 rows, each with its own ``<key>_hw``
    (``normalize_u8``); the batch itself when none is uint8."""
    out = None
    for k, v in batch.items():
        if (isinstance(v, torch.Tensor) and v.dtype == torch.uint8 and "image" in k
                and not k.endswith("_hw")):
            out = dict(batch) if out is None else out
            out[k] = normalize_u8(v, batch.get(f"{k}_hw"), grid_hw, patch_size)
    return batch if out is None else out


# ------------------------------------------------- pos-embed interpolation
def bilinear_weights(n_out: int, size: torch.Tensor, n_src: int) -> torch.Tensor:
    """(B, n_out, n_src) align_corners bilinear row weights for per-sample
    valid lengths ``size`` (B,); rows at or past ``size`` are zero."""
    r = torch.arange(n_out, dtype=torch.float32, device=size.device)
    denom = torch.clamp(size - 1, min=1).float()[:, None]
    src = r[None] * (n_src - 1) / denom                      # (B, n_out)
    i0 = torch.clamp(torch.floor(src).long(), 0, n_src - 1)
    i1 = torch.clamp(i0 + 1, max=n_src - 1)
    t = src - i0.float()
    cols = torch.arange(n_src, device=size.device)
    w = ((cols == i0[..., None]) * (1.0 - t[..., None])
         + (cols == i1[..., None]) * t[..., None])
    return w * (r[None, :, None] < size[:, None, None])


def _triangle_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``jax._src.image.scale.compute_weight_mat`` with the
    triangle kernel, antialias on, no translation): the kernel widened by
    n_in / n_out when shrinking, each column normalised, columns whose sample
    falls outside the input zeroed; the same fp32 steps."""
    inv = torch.tensor(n_in / n_out, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    width = torch.clamp(inv, min=1.0)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / width
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_pos_embed(pos: torch.Tensor, n_new: int) -> torch.Tensor:
    """(1, 1 + S*S, C) -> (1, 1 + n*n, C), n*n = ``n_new``: the class token
    kept, the spatial grid resized bilinearly as the JAX package resizes a
    reference checkpoint's pos-embed (``rmcl_tpu/compat/torch_loader.py:
    resize_pos_embed``, ``jax.image.resize`` with its antialiasing when it
    shrinks), in fp32."""
    n_tok = pos.shape[1] - 1
    s_old, s_new = round(n_tok ** 0.5), round(n_new ** 0.5)
    if s_old * s_old == n_tok and s_old == s_new:
        return pos
    cls, grid = pos[:, :1].float(), pos[:, 1:].float().reshape(1, s_old, s_old, -1)
    w = _triangle_weights(s_old, s_new)
    grid = torch.einsum("bijc,iy,jx->byxc", grid, w, w)
    return torch.cat([cls, grid.reshape(1, s_new * s_new, -1)], dim=1)


def resample_pos_embed(spatial: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                       gh: int, gw: int) -> torch.Tensor:
    """spatial (S, S, C) fp32; h, w (B,) valid grid sizes -> (B, gh, gw, C):
    bilinear to (h, w), zero past it."""
    S = spatial.shape[0]
    R = bilinear_weights(gh, h, S)                           # (B, gh, S)
    Cw = bilinear_weights(gw, w, S)                          # (B, gw, S)
    return torch.einsum("brs,stc,bwt->brwc", R, spatial.float(), Cw)


# ------------------------------------------------- hoisted visual geometry
def patch_mean_rgb(rows: torch.Tensor) -> torch.Tensor:
    """(B, N, P*P*3) -> each patch's mean RGB (B, N, 3)."""
    B, N, F = rows.shape
    return rows.reshape(B, N, F // 3, 3).mean(2)


def mask_tokens(rows: torch.Tensor, feats: torch.Tensor, mask_token: torch.Tensor,
                masked: torch.Tensor, replaced: torch.Tensor):
    """MPP masking (reference vision_transformer.py:525-557) on drawn masks:
    ``rows`` (B, N, P*P*3) normalised, ``feats`` (B, N, C), ``masked`` and
    ``replaced`` (B, N) bool.  Returns (feats with ``mask_token`` where
    replaced, labels (B, N, 3) int64: clip(int(mean RGB of rows * 0.5 + 0.5
    times 255), 0, 255) where masked, -100 elsewhere)."""
    pm = patch_mean_rgb(rows.float() * 0.5 + 0.5)
    labels = torch.clamp((pm * 255).long(), 0, 255)
    labels = torch.where(masked[..., None], labels, -100)
    feats = torch.where(replaced[..., None], mask_token.reshape(-1).to(feats.dtype), feats)
    return feats, labels


def patch_index(prep: "VisualPrep", grid_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, L, 2) grid coordinates (row, column) of the selected patches."""
    gw = grid_hw[1]
    B = prep.x_mask.shape[0]
    flat = (prep.sel if prep.sel is not None else
            torch.arange(prep.n_patches, device=prep.x_mask.device).expand(B, -1))
    return torch.stack([flat // gw, flat % gw], dim=-1)


class VisualPrep(NamedTuple):
    """The part of the visual embedding that a pixel perturbation cannot
    change, computed once from the clean image.  Padding patches are masked
    as attention keys and their own outputs never reach ``cls_feats``, so
    the loss gradient is exactly zero on padding pixels and on valid but
    unselected patches: the validity mask, the pos-embed resample and the
    patch selection stay what the clean image gave."""
    rows_sel: torch.Tensor            # (B, L, P*P*3) selected clean patch rows
    sel: Optional[torch.Tensor]       # (B, L) indices into the N-patch grid, or None
    pos_full: torch.Tensor            # (B, L+1, C) fp32 pos embeds incl the CLS row
    x_mask: torch.Tensor              # (B, L+1) int32
    n_patches: int                    # N = gh*gw


def scatter_delta(prep: VisualPrep, delta_sel: torch.Tensor) -> torch.Tensor:
    """A selected-space perturbation (B, L, F) back in full patch rows
    (B, N, F); unselected rows carry zero gradient, so zero-fill is exact."""
    if prep.sel is None:
        return delta_sel
    B, L, F = delta_sel.shape
    out = delta_sel.new_zeros(B, prep.n_patches, F)
    return out.scatter_(1, prep.sel[..., None].expand(-1, -1, F), delta_sel)


# ------------------------------------------------------------------ modules
class PatchEmbed(nn.Module):
    """Conv(P, stride P) patch embedding, applied to patch rows as one matmul."""

    def __init__(self, hidden_size: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(
            torch.empty(hidden_size, 3, patch_size, patch_size))
        self.proj.bias = nn.Parameter(torch.empty(hidden_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """rows (B, N, P*P*3) in (ph, pw, channel) order -> (B, N, C)."""
        w = self.proj.weight
        kernel = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)   # (C, P*P*3)
        return linear(rows.to(dtype), kernel, self.proj.bias)


def _same(x):
    return x


class Block(nn.Module):
    """Pre-norm transformer block; names follow the reference state_dict.
    ``attn_impl``: "fused" | "pallas" | "flash"; ``mlp_impl``: "fused" |
    "fused_train" (``models/vilt.py:derive_block_impls``).  ``model_shards``
    m > 1: this model rank's shards of the four matrices, and ``num_heads``
    the H/m heads it runs."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: int,
                 attn_impl: str = "fused", mlp_impl: str = "fused_train",
                 model_shards: int = 1):
        super().__init__()
        C, m = hidden_size, model_shards
        if num_heads % m or (mlp_ratio * C) % m:
            raise ValueError(f"a model axis of {m} does not divide {num_heads} heads "
                             f"and the MLP width {mlp_ratio * C}")
        self.num_heads, self.model_shards = num_heads // m, m
        self.attn_impl, self.mlp_impl = attn_impl, mlp_impl
        Ci, C4 = C // m, mlp_ratio * C // m
        self.norm1 = LayerNorm(C, VIT_LN_EPS)
        self.attn = nn.ModuleDict({"qkv": Linear(C, 3 * Ci), "proj": Linear(Ci, C)})
        self.norm2 = LayerNorm(C, VIT_LN_EPS)
        self.mlp = nn.ModuleDict({"fc1": Linear(C, C4), "fc2": Linear(C4, C)})

    def matrices(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The four weight matrices in ``dtype``, as the fused ops take them."""
        ws = {"wqkv": self.attn["qkv"].weight, "wproj": self.attn["proj"].weight,
              "w1": self.mlp["fc1"].weight, "w2": self.mlp["fc2"].weight}
        return {k: w.detach().to(dtype).contiguous() for k, w in ws.items()}

    def _unfused_attention(self, x, mask, mats, train: bool, bproj):
        """proj(MHA(qkv(LN1 x))) of the unfused block, around the attention
        core op, on this shard's heads (``bproj`` None: a shard but the
        first).  Training takes the float32 masters (cast at use, so that
        they receive the gradients), the deterministic forward the cast
        matrices."""
        B, S, _ = x.shape
        H = self.num_heads
        qkv, proj = self.attn["qkv"], self.attn["proj"]
        Ci = qkv.weight.shape[0] // 3
        y = layer_norm(x, self.norm1.weight, self.norm1.bias, VIT_LN_EPS)
        y = linear(y, qkv.weight if train else mats["wqkv"], qkv.bias)
        q, k, v = y.view(B, S, 3, H, Ci // H).permute(2, 0, 3, 1, 4).unbind(0)
        a = masked_attention(q, k, v, mask, (Ci // H) ** -0.5)
        a = a.transpose(1, 2).reshape(B, S, Ci)
        return linear(a, proj.weight if train else mats["wproj"], bproj)

    def _plain_mlp(self, x, seeds, p: float, f, g, lead: bool, col0: int):
        """fc2(drop(gelu(fc1(LN2 x)))) dropped: the MLP of the JAX package's
        plain block, on the kernels' mask convention; under a model axis f
        before LN2, g after fc2, this shard's hidden columns from ``col0``
        and fc2's bias on the first shard (``lead``)."""
        fc1, fc2 = self.mlp["fc1"], self.mlp["fc2"]
        y = layer_norm(f(x), self.norm2.weight, self.norm2.bias, VIT_LN_EPS)
        y = dropout(gelu(linear(y, fc1.weight, fc1.bias)), seeds, 0, p, col0)
        return dropout(g(linear(y, fc2.weight, fc2.bias if lead else None)), seeds, 1, p)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                mats: Dict[str, torch.Tensor],
                seeds: Optional[torch.Tensor] = None, p: float = 0.0) -> torch.Tensor:
        """``seeds`` (2, B) int32 selects the training forward (attention half,
        MLP half); ``mats`` are the weight matrices in the compute type, the
        training ops' operands, and the parameters receive the gradients."""
        train = seeds is not None
        sharded = self.model_shards > 1
        f, g = (copy_to_model, reduce_from_model) if sharded else (_same, _same)
        rank = mesh.model_rank() if sharded else 0
        lead = rank == 0        # the first shard adds the residual and the row-parallel biases
        n1, qkv, proj = self.norm1, self.attn["qkv"], self.attn["proj"]
        bproj = proj.bias if lead else None
        if self.attn_impl != "fused":
            a = g(self._unfused_attention(f(x), mask, mats, train, bproj))
            x = x + (dropout(a, seeds[0], 0, p) if train else a)
        elif not train:
            x = g(attn_half(f(x), mask, n1.weight, n1.bias, mats["wqkv"], qkv.bias,
                            mats["wproj"], bproj, self.num_heads, VIT_LN_EPS,
                            residual=lead))
        elif self.mlp_impl == "fused_train" and p > 0:
            x = g(attn_half_train(f(x), seeds[0], mask, n1.weight, n1.bias, qkv.weight,
                                  qkv.bias, proj.weight, bproj, self.num_heads, VIT_LN_EPS,
                                  p, wqkv_c=mats["wqkv"], wproj_c=mats["wproj"],
                                  residual=lead))
        else:
            a = g(attn_half_full(f(x), mask, n1.weight, n1.bias, qkv.weight, qkv.bias,
                                 proj.weight, bproj, self.num_heads, VIT_LN_EPS,
                                 wqkv_c=mats["wqkv"], wproj_c=mats["wproj"]))
            x = x + dropout(a, seeds[0], 0, p)

        n2, fc1, fc2 = self.norm2, self.mlp["fc1"], self.mlp["fc2"]
        b2 = fc2.bias if lead else None
        col0 = rank * fc1.weight.shape[0]       # this shard's first hidden column
        if not train:
            return g(mlp_half(f(x), n2.weight, n2.bias, mats["w1"], fc1.bias, mats["w2"],
                              b2, VIT_LN_EPS, residual=lead))
        if self.mlp_impl == "fused" and p > 0:
            return x + self._plain_mlp(x, seeds[1], p, f, g, lead, col0)
        return g(mlp_half_train(f(x), seeds[1], n2.weight, n2.bias, fc1.weight, fc1.bias,
                                fc2.weight, b2, p, VIT_LN_EPS, tail=True,
                                w1_c=mats["w1"], w2_c=mats["w2"], residual=lead, col0=col0))


class ViT(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 mlp_ratio: int, patch_size: int, img_size: int,
                 attn_impl: str = "fused", mlp_impl: str = "fused_train",
                 model_shards: int = 1):
        super().__init__()
        self.model_shards = model_shards
        C = hidden_size
        self.pos_grid = img_size // patch_size   # grid the pos-embed lives on
        self.patch_embed = PatchEmbed(C, patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, C))
        self.pos_embed = nn.Parameter(torch.empty(1, self.pos_grid ** 2 + 1, C))
        self.mask_token = nn.Parameter(torch.empty(1, 1, C))   # MPP's masked patches
        self.blocks = nn.ModuleList(
            Block(C, num_heads, mlp_ratio, attn_impl, mlp_impl, model_shards)
            for _ in range(num_layers))
        self.norm = LayerNorm(C, VIT_LN_EPS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.cls_token, generator)
        trunc_normal_(self.pos_embed, generator)
        nn.init.zeros_(self.mask_token)

    def block_matrices(self, dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
        """Every block's weight matrices cast to ``dtype`` once; pass the
        result to ``forward`` so that serving does not cast per call."""
        return [blk.matrices(dtype) for blk in self.blocks]

    def visual_embed_prepare(self, rows: torch.Tensor, grid_hw: Tuple[int, int],
                             max_image_len: int) -> "VisualPrep":
        """Everything in ``visual_embed`` that does not depend on a pixel
        perturbation, from the CLEAN normalised patch rows (B, N, P*P*3) on
        ``grid_hw``, or a canvas (B, H, W, 3) on its own grid."""
        rows, (gh, gw) = as_patch_rows(rows, grid_hw, self.patch_embed.patch_size)
        B, N, _ = rows.shape
        C = self.cls_token.shape[-1]
        # a patch is valid when its top-left pixel is: elements 0..2 of its row
        first = rows[:, :, :3].float()
        m = ((first[..., 0] + first[..., 1]) + first[..., 2] != 0).reshape(B, gh, gw)
        x_h, x_w = m[:, :, 0].sum(1), m[:, 0, :].sum(1)

        spatial = self.pos_embed[0, 1:].reshape(self.pos_grid, self.pos_grid, C)
        pos = resample_pos_embed(spatial, x_h, x_w, gh, gw).reshape(B, N, C)
        mask = m.reshape(B, N)

        L = N if max_image_len is None or max_image_len <= 0 else min(N, max_image_len)
        sel = None
        if L < N:
            # valid patches first in row-major order, like the JAX package
            sel = torch.argsort((~mask).int(), dim=1, stable=True)[:, :L]
            rows = torch.gather(rows, 1, sel[..., None].expand(-1, -1, rows.shape[-1]))
            pos = torch.gather(pos, 1, sel[..., None].expand(-1, -1, C))
            mask = torch.gather(mask, 1, sel)

        pos_full = torch.cat([self.pos_embed[:, :1].float().expand(B, 1, C), pos], dim=1)
        x_mask = torch.cat([torch.ones(B, 1, dtype=torch.int32, device=rows.device),
                            mask.int()], dim=1)
        return VisualPrep(rows, sel, pos_full, x_mask, N)

    def visual_embed_from_prep(self, prep: "VisualPrep",
                               delta_sel: Optional[torch.Tensor],
                               dtype: torch.dtype):
        """Patch rows (+ a perturbation in selected-patch space) -> embeddings
        with the prepared geometry: one matmul and the pos/cls adds.
        Returns (x (B, L+1, C), mask (B, L+1) int32)."""
        rows = prep.rows_sel if delta_sel is None else prep.rows_sel + delta_sel
        x = self.patch_embed(rows, dtype)
        B, _, C = x.shape
        x = torch.cat([self.cls_token.to(dtype).expand(B, 1, C), x], dim=1)
        return x + prep.pos_full.to(dtype), prep.x_mask

    def visual_embed(self, rows: torch.Tensor, grid_hw: Tuple[int, int],
                     max_image_len: int, dtype: torch.dtype):
        """Normalised patch rows (B, N, P*P*3), or a canvas (B, H, W, 3) ->
        (x (B, L+1, C), mask (B, L+1) int32)."""
        prep = self.visual_embed_prepare(rows, grid_hw, max_image_len)
        return self.visual_embed_from_prep(prep, None, dtype)

    def visual_embed_masked(self, rows: torch.Tensor, grid_hw: Tuple[int, int],
                            max_image_len: int, dtype: torch.dtype, masked: torch.Tensor,
                            replaced: torch.Tensor):
        """The masked-patch embedding of normalised patch rows (B, N, P*P*3)
        with the drawn masks ``masked`` and ``replaced`` (B, N) bool over every
        patch (a canvas (B, H, W, 3) on its own grid).  Returns (x (B, L+1, C),
        mask (B, L+1) int32, labels (B, L+1, 3) int64, patch_index (B, L, 2))."""
        rows, grid_hw = as_patch_rows(rows, grid_hw, self.patch_embed.patch_size)
        prep = self.visual_embed_prepare(rows, grid_hw, max_image_len)
        x = self.patch_embed(rows, dtype)          # every patch, as the JAX package
        x, labels = mask_tokens(rows, x, self.mask_token, masked, replaced)
        if prep.sel is not None:
            x = torch.gather(x, 1, prep.sel[..., None].expand(-1, -1, x.shape[-1]))
            labels = torch.gather(labels, 1, prep.sel[..., None].expand(-1, -1, 3))
        labels = torch.where(prep.x_mask[:, 1:, None] == 1, labels, -100)
        B, _, C = x.shape
        labels = torch.cat([labels.new_full((B, 1, 3), -100), labels], dim=1)
        x = torch.cat([self.cls_token.to(dtype).expand(B, 1, C), x], dim=1)
        return x + prep.pos_full.to(dtype), prep.x_mask, labels, patch_index(prep, grid_hw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                block_matrices: Optional[List[Dict[str, torch.Tensor]]] = None,
                seeds: Optional[torch.Tensor] = None, p: float = 0.0) -> torch.Tensor:
        """(B, S, C) activations, (B, S) int32 mask -> final-normed (B, S, C).
        ``seeds`` (layers, 2, B) int32: the training forward at dropout rate ``p``."""
        if self.model_shards > 1 and self.model_shards != mesh.model_size():
            raise RuntimeError(f"a transformer of {self.model_shards} model shards on a grid "
                               f"whose model axis has {mesh.model_size()} "
                               "(parallel/mesh.py:init_grid)")
        if block_matrices is None:
            block_matrices = self.block_matrices(x.dtype)
        for i, (blk, mats) in enumerate(zip(self.blocks, block_matrices)):
            x = blk(x, mask, mats, None if seeds is None else seeds[i], p)
        return self.norm(x)
