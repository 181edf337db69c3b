"""The greedy attacker's construction and its extras (port of these functions
of ``rmcl_tpu/train/loop.py``: ``build_greedy_attacker``,
``GREEDY_FRAMEWORKS``, ``greedy_attack_framework``, ``greedy_attack_extras``
and ``make_greedy_extras_fn``).  Only the ``moco`` framework is ported; the
others raise.  The ``Trainer`` and the rest of that file are not ported yet
(ROADMAP A9)."""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch

from rmcl_tpu_torch.attacks import greedy as G
from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
from rmcl_tpu_torch.core.config import active_tasks
from rmcl_tpu_torch.objectives.contrastive import momentum_update
from rmcl_tpu_torch.objectives.losses import l2_normalize

GREEDY_FRAMEWORKS = ("moco", "barlowtwins", "nlvr2_attacked",
                     "vqa_attacked", "irtr_attacked")


def greedy_attack_framework(cfg) -> Optional[str]:
    tasks = active_tasks(cfg)
    return next((t for t in GREEDY_FRAMEWORKS if t in tasks), None)


def _refuse_other(framework: str) -> None:
    if framework != "moco":
        raise NotImplementedError(
            f"the greedy attack of the {framework!r} framework is not ported: the port "
            "has the moco framework only (ROADMAP A11)")


def build_greedy_attacker(cfg, model, tokenizer):
    """The framework's greedy attacker (reference vilt_module.py:102-107), or
    None when no greedy framework is active or the counter-fitted vectors
    are missing."""
    framework = greedy_attack_framework(cfg)
    if framework is None:
        return None
    _refuse_other(framework)
    if cfg.synonym == "cos_sim":
        if not os.path.isfile(cfg.embedding_path):
            print(f"[train] text_view requested but embedding_path "
                  f"{cfg.embedding_path!r} missing — text view disabled",
                  file=sys.stderr)
            return None
        syn = G.SynonymTable(cfg.embedding_path, cfg.n_candidates,
                             cfg.sim_thred, cache_path=cfg.sim_path or None,
                             device=next(model.parameters()).device)
    else:
        syn = G.WordnetSynonyms(cfg.n_candidates)
    attacker = G.GreedyAttackMoco(cfg, model, tokenizer, syn)
    if cfg.greedy_impl == "fused":
        attacker = FusedGreedyAttack(attacker)
    return attacker


@torch.no_grad()
def greedy_attack_extras(cfg, model, framework: str, batch):
    """The attacker's extras, with no lasting effect on the model.

    moco: the post-EMA key projection and the queue, (k, queue,
    temperature).  The reference runs the attack after the momentum update
    (objectives.py:256-265, then :277-285), so the keys come from the
    updated twins; the twins are updated in place for the key forward and
    restored after it.  The attacked step (``train/step.py``) takes the
    step's own keys instead and runs no second key forward."""
    _refuse_other(framework)
    twins = [p for name, p in model.named_parameters() if name.startswith("k_")]
    saved = [p.detach().clone() for p in twins]
    try:
        momentum_update(model, cfg.momentum)
        infer_k = model.infer_k(batch)
        k = l2_normalize(model.k_moco_head(infer_k["cls_feats"]), dim=1)
    finally:
        for p, s in zip(twins, saved):
            p.copy_(s)
    return (k, model.proj_queue.detach().clone(), cfg.temperature)


def make_greedy_extras_fn(cfg, model) -> Optional[Callable]:
    """``fn(ts, batch) -> extras`` for the active framework, or None."""
    framework = greedy_attack_framework(cfg)
    if framework is None:
        return None
    _refuse_other(framework)
    return lambda ts, batch: greedy_attack_extras(cfg, ts.model, framework, batch)
