"""rmcl_tpu_torch: the PyTorch/CUDA port of rmcl_tpu for one NVIDIA H100.

The JAX package ``rmcl_tpu`` is the reference; this package imports torch
and never jax.  This slice is the serving path (``rmcl serve``):

  ops/        the two deterministic block halves (attn_half, mlp_half):
              hand-written CUDA kernels on CUDA tensors, plain versions on
              CPU tensors; nvcc build + ctypes binding (ops/_build.py)
  csrc/       the CUDA C++ sources, built at first use into _build/
  models/     layers, text embeddings, ViT, heads, ViLT (reference
              state_dict names)
  compat/     the JAX package's parameters as the port's state dict
  serve.py    build_infer_fn, batch_spec, Session
  cli/run.py  python -m rmcl_tpu_torch.cli.run serve ...

The config and the host pipeline are the JAX package's own jax-free
modules (see _host.py).
"""

from rmcl_tpu_torch._host import build_config  # noqa: F401
from rmcl_tpu_torch.models.vilt import ViLT  # noqa: F401
from rmcl_tpu_torch.serve import TASKS, Session, build_infer_fn  # noqa: F401
