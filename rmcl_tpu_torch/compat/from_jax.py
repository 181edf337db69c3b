"""The JAX package's parameters and state as the port's state dict, without jax.

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
    ``proj_queue_ptr`` () becomes (1,).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


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
    if state and "proj_queue" in state:
        out["proj_queue"] = np.array(state["proj_queue"], order="C")
        out["proj_queue_ptr"] = np.array(state["proj_queue_ptr"]).reshape(1)
    return out
