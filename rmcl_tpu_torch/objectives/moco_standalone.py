"""Standalone bidirectional MoCo (port of ``rmcl_tpu/objectives/moco_standalone.py``;
reference MoCo/MoCo_RMCL.py:19-265).

The reference module does not import (syntax errors at MoCo_RMCL.py:12, 39);
this is the JAX package's working equivalent of its documented semantics:

  * separate text / image projections of the two CLS positions
    (``text_feats[:, 0]``, ``image_feats[:, 0]``) through per-modality
    MoCo-style projector heads;
  * bidirectional InfoNCE: the attacked text query against the momentum
    image key, the attacked image query against the momentum text key, both
    against ONE shared negatives queue (``txt_img_queue``);
  * both key batches enqueue back to back into the shared queue (reference
    _dequeue_and_enqueue :76-93); over several processes, the keys of every
    rank (``parallel/dist.py:gather_rows``), as the JAX package's global
    batch.

Where the JAX package returns new parameter and state pytrees, the port
updates the model's momentum twins and its queue buffers in place, under
``no_grad``.  No named configuration reaches this objective, in either
package: it is a function with its tests.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from rmcl_tpu_torch.models.heads import MoCoHead
from rmcl_tpu_torch.models.layers import reset_all
from rmcl_tpu_torch.objectives.contrastive import infonce, momentum_update
from rmcl_tpu_torch.objectives.losses import l2_normalize
from rmcl_tpu_torch.parallel.dist import gather_rows

PROJ_DIM = 128
STANDALONE_TWINS = ("text_embeddings", "token_type_embeddings",
                    "transformer", "txt_projector", "img_projector")


@torch.no_grad()
def init_standalone_moco(cfg, model: torch.nn.Module,
                         generator: torch.Generator) -> torch.nn.Module:
    """Add per-modality projectors, their momentum twins (exact copies) and
    the shared queue (random columns of unit norm, reference :49-52) to a
    ViLT with momentum twins (``task_moco``), in place.  The queue is fp32,
    as the JAX package keeps it."""
    C = cfg.hidden_size
    dev = next(model.parameters()).device
    for name in ("txt_projector", "img_projector"):
        head = MoCoHead(C, C, PROJ_DIM)
        reset_all(head, generator)
        twin = MoCoHead(C, C, PROJ_DIM)
        twin.load_state_dict(head.state_dict())
        setattr(model, name, head.to(dev))
        setattr(model, "k_" + name, twin.to(dev))
    q = torch.randn(PROJ_DIM, cfg.num_negative, generator=generator)
    model.register_buffer("txt_img_queue", (q / q.norm(dim=0, keepdim=True)).to(dev))
    model.register_buffer("txt_img_queue_ptr", torch.zeros(1, dtype=torch.int32, device=dev))
    return model


def _project(model, infer, prefix: str = ""):
    txt = l2_normalize(getattr(model, prefix + "txt_projector")(infer["text_feats"][:, 0]),
                       dim=1)
    img = l2_normalize(getattr(model, prefix + "img_projector")(infer["image_feats"][:, 0]),
                       dim=1)
    return txt, img


@torch.no_grad()
def _shared_enqueue(model, keys_txt: torch.Tensor, keys_img: torch.Tensor) -> None:
    """Enqueue the text then the image keys into the shared circular queue
    (reference :76-93), in place.  K must be a multiple of the batch, or a
    write would run past the end while the pointer wraps."""
    queue, ptr = model.txt_img_queue, model.txt_img_queue_ptr
    K, B = queue.shape[1], keys_txt.shape[0]
    if K % B != 0:
        raise ValueError(f"standalone-MoCo queue size ({K}) must be divisible by "
                         f"the batch ({B})")
    for keys in (keys_txt, keys_img):
        cols = (ptr.long() + torch.arange(B, device=ptr.device)) % K   # no host read
        queue.index_copy_(1, cols, keys.t().to(queue.dtype))
        ptr.copy_((ptr + B) % K)


def compute_standalone_moco(
    model, batch: Dict[str, torch.Tensor], *,
    seeds: Optional[torch.Tensor] = None,
    block_matrices=None,
    k_block_matrices: Optional[Callable] = None,
    temperature: float = 0.07,
    momentum: float = 0.999,
    train: bool = True,
    attacked_text: Optional[Dict[str, torch.Tensor]] = None,
    pgd_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """One bidirectional MoCo step: the momentum update of
    ``STANDALONE_TWINS``, the key forward, the attacked query forward, the
    two InfoNCE losses against the shared queue, the enqueue.  The caller
    differentiates ``ret["standalone_moco_loss"]``.

    ``seeds`` (layers + 1, 2, B) int32 (``models/vilt.py:draw_seeds``): the
    query forward's dropout, needed when ``train``.  ``block_matrices`` /
    ``k_block_matrices()``: as ``compute_moco_contrastive`` takes them.
    ``attacked_text``: {"text_ids", "text_masks"} for the query.
    ``pgd_fn(batch, txt_k, queue) -> img_delta`` attacks the image query
    against the text keys (reference pgd :180-230)."""
    if train:
        momentum_update(model, momentum, twins=STANDALONE_TWINS)

    with torch.no_grad():
        infer_k = model.infer_k(
            batch, block_matrices=k_block_matrices() if k_block_matrices else None)
        txt_k, img_k = _project(model, infer_k, prefix="k_")
    queue = model.txt_img_queue.detach().clone() if train else model.txt_img_queue.detach()

    qbatch = dict(batch)
    if pgd_fn is not None:
        qbatch["image"] = batch["image"] + pgd_fn(batch, txt_k, queue).detach()
    if attacked_text is not None:
        qbatch.update(text_ids=attacked_text["text_ids"],
                      text_masks=attacked_text["text_masks"])

    infer_q = model.infer(qbatch, block_matrices, deterministic=not train,
                          seeds=seeds if train else None)
    txt_q, img_q = _project(model, infer_q)
    loss_txt, logits_txt = infonce(txt_q, img_k, queue, temperature)
    loss_img, logits_img = infonce(img_q, txt_k, queue, temperature)

    if train:     # every rank's keys, in rank order: the queue stays the same on every rank
        _shared_enqueue(model, gather_rows(txt_k), gather_rows(img_k))
    return {"standalone_moco_loss": 0.5 * (loss_txt + loss_img),
            "moco_txt_loss": loss_txt, "moco_img_loss": loss_img,
            "logits_txt": logits_txt, "logits_img": logits_img}
