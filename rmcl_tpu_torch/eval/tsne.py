"""t-SNE projection of contrastive embeddings (port of
``rmcl_tpu/eval/tsne.py``).

Behavioural spec: reference TSNE_vizualisation.py:16-46, which is broken as
committed (it uses an undefined ``neg_txt``, SURVEY.md §2.5).  This is the
repaired semantics: scatter the query / key projections against a sample of
the negative queue, coloured by group, saved as a png (or, without
matplotlib, the 2-D embedding as ``<out_path>.npy``).

It is host-side work on arrays the card has made: tensors are read with
``.detach().float().cpu()``; sklearn and matplotlib are imported inside.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def tsne_projection(q, k, neg_queue, out_path: str = "tsne.png",
                    max_negatives: int = 1000, perplexity: float = 30.0,
                    seed: int = 0) -> Optional[str]:
    """q, k: (B, C); neg_queue: (C, K), arrays or tensors.  Returns the
    saved path."""
    from sklearn.manifold import TSNE

    q, k = _host(q), _host(k)
    negs = _host(neg_queue).T
    if len(negs) > max_negatives:
        idx = np.random.RandomState(seed).choice(
            len(negs), max_negatives, replace=False)
        negs = negs[idx]

    data = np.concatenate([q, k, negs], axis=0)
    perplexity = min(perplexity, max((len(data) - 1) / 3.0, 2.0))
    emb = TSNE(n_components=2, perplexity=perplexity,
               random_state=seed, init="pca").fit_transform(data)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.save(out_path + ".npy", emb)
        return out_path + ".npy"

    B = len(q)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(emb[2 * B:, 0], emb[2 * B:, 1], s=4, c="lightgray",
               label="queue negatives")
    ax.scatter(emb[:B, 0], emb[:B, 1], s=16, c="tab:blue", label="query")
    ax.scatter(emb[B:2 * B, 0], emb[B:2 * B, 1], s=16, c="tab:orange",
               label="key")
    ax.legend()
    ax.set_title("MoCo projection space (t-SNE)")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
