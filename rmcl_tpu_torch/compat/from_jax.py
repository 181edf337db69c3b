"""The JAX package's parameters and state as the port's state dict, and the
port's parameters and gradients under the JAX package's paths, without jax.

The same mapping as ``rmcl_tpu/compat/torch_loader.py:export_state_dict``,
written over numpy only:
  * a linear ``kernel`` (in, out) becomes ``weight`` (out, in);
  * the patch-embed kernel (P*P*3, C) in (ph, pw, ch) order becomes the
    conv weight (C, 3, P, P);
  * the stacked ``transformer.blocks`` (leading layer axis) become
    ``transformer.blocks.{i}``;
  * ``mask_token`` (C,) becomes (1, 1, C);
  * every other leaf keeps its dotted path and its value; the momentum
    twins (``k_*`` trees) go through the same rules;
  * the model state's ``proj_queue`` keeps its (128, K) value and
    ``proj_queue_ptr`` () becomes (1,); so do standalone MoCo's shared
    ``txt_img_queue`` and ``txt_img_queue_ptr``, whose four projectors
    (``txt_projector``, ``img_projector`` and their ``k_`` twins) are
    MoCo heads under the rules above;
  * BatchNorm running statistics (``running_mean``, ``running_var``), which
    the JAX package keeps among the parameters, keep their paths and become
    the port's buffers.

``shard_from_jax`` cuts the same state dict to a rank's tensor-parallel
shards.  ``leaves_to_jax`` is the inverse, from a live model: it tells a linear weight
from a LayerNorm or embedding weight by the module that owns it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

# the model state's queues, each with its ``<queue>_ptr``: MoCo's negatives
# and standalone MoCo's shared text / image queue
QUEUES = ("proj_queue", "txt_img_queue")


def _leaves(prefix: str, node, num_layers: int, out: Dict[str, np.ndarray]):
    for key, val in node.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            if key == "blocks":
                for i in range(num_layers):
                    _leaves(f"{name}.{i}.", _layer(val, i), num_layers, out)
            else:
                _leaves(f"{name}.", val, num_layers, out)
            continue
        a = np.asarray(val)
        if name.endswith("patch_embed.proj.kernel"):
            P = int(round((a.shape[0] / 3) ** 0.5))
            name, a = (name[:-len("kernel")] + "weight",
                       a.reshape(P, P, 3, a.shape[1]).transpose(3, 2, 0, 1))
        elif key == "kernel":
            name, a = name[:-len("kernel")] + "weight", a.T
        elif key == "mask_token":
            a = a.reshape(1, 1, -1)
        out[name] = np.array(a, order="C")     # a writable copy in C order


def _layer(node, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in node.items()}


def state_dict_from_jax(params: Dict[str, Any], num_layers: int,
                        state: Optional[Dict[str, Any]] = None) -> Dict[str, np.ndarray]:
    """JAX parameter pytree (nested dicts of arrays), and optionally the
    model state (the MoCo queue), -> reference-named state dict of numpy
    arrays in torch layouts."""
    out: Dict[str, np.ndarray] = {}
    _leaves("", params, num_layers, out)
    for queue in QUEUES:
        if state and queue in state:
            out[queue] = np.array(state[queue], order="C")
            out[queue + "_ptr"] = np.array(state[queue + "_ptr"]).reshape(1)
    return out


def shard_from_jax(params: Dict[str, Any], num_layers: int, model_rank: int, m: int,
                   state: Optional[Dict[str, Any]] = None):
    """``state_dict_from_jax`` cut to model rank ``model_rank``'s shards of a
    tensor-parallel model of ``m`` (``parallel/sharding_rules.py:
    shard_state_dict``), as torch tensors: the weights a rank of a
    ``(data, model)`` grid loads (``ViLT(cfg, model_shards=m)``)."""
    import torch

    from rmcl_tpu_torch.parallel.sharding_rules import shard_state_dict
    sd = state_dict_from_jax(params, num_layers, state)
    return shard_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, model_rank, m)


def leaves_to_jax(model, grads: bool = False) -> Dict[str, np.ndarray]:
    """The model's parameters (or, with ``grads``, their gradients; a
    parameter without one is left out) as {"/"-joined JAX path: numpy array in
    the JAX package's layout}: the inverse of ``state_dict_from_jax``, so that
    a test can compare leaf by leaf with the JAX pytree.  When ``grads`` is
    off, the BatchNorm running statistics come under their parameter paths,
    as the JAX package keeps them, and the queue buffers (``QUEUES``) as
    ``<queue>`` and ``<queue>_ptr`` (a scalar) when the model has them."""
    from rmcl_tpu_torch.models.layers import Linear   # torch only from here on
    from rmcl_tpu_torch.models.vit import PatchEmbed

    linear = {name for name, m in model.named_modules() if isinstance(m, Linear)}
    patch = {name + ".proj" for name, m in model.named_modules()
             if isinstance(m, PatchEmbed)}
    flat: Dict[str, np.ndarray] = {}
    stats = [] if grads else [(n, b) for n, b in model.named_buffers()
                              if n.endswith((".running_mean", ".running_var"))]
    for name, p in list(model.named_parameters()) + stats:
        t = p.grad if grads else p
        if t is None:
            continue
        a = t.detach().float().cpu().numpy().copy()   # never a view of the live tensor
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if owner in patch and leaf == "weight":
            leaf, a = "kernel", a.transpose(2, 3, 1, 0).reshape(-1, a.shape[0])
        elif owner in linear and leaf == "weight":
            leaf, a = "kernel", a.T
        elif leaf == "mask_token":
            a = a.reshape(-1)
        flat["/".join(filter(None, [owner.replace(".", "/"), leaf]))] = a
    out: Dict[str, np.ndarray] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for path, a in flat.items():
        parts = path.split("/")
        if "blocks" in parts:
            i = parts.index("blocks")
            key = "/".join(parts[:i + 1] + parts[i + 2:])
            stacked.setdefault(key, {})[int(parts[i + 1])] = a
        else:
            out[path] = a
    for key, layers in stacked.items():
        out[key] = np.stack([layers[i] for i in range(len(layers))])
    for queue in QUEUES:
        if not grads and hasattr(model, queue):
            out[queue] = getattr(model, queue).detach().float().cpu().numpy().copy()
            out[queue + "_ptr"] = getattr(model, queue + "_ptr").detach().cpu().numpy(
            ).reshape(()).copy()
    return out
