"""rmcl_tpu_torch: the PyTorch/CUDA port of rmcl_tpu for one NVIDIA H100.

The JAX package ``rmcl_tpu`` is the reference; this package imports torch,
never jax, and nothing of ``rmcl_tpu``: what it needs of that package's
jax-free host modules it keeps as its own copies.  Ported so far: the
serving path (``rmcl serve``, live or from an ahead-of-time artifact of
``rmcl export``), the PGD image attack, the greedy text attack,
the task_moco and task_barlowtwins training steps and the training entry
point around them (the loader, the Trainer, checkpoints, ``cli.run with``),
under each of the JAX
package's kernel block configurations (``attention_impl`` "fused" /
"pallas" / "flash", ``mlp_impl`` "fused" / "fused_train").

  ops/         the two deterministic block halves and their dx-only
               backwards (attn_half, mlp_half, attn_half_dx, mlp_half_dx),
               the attention half with its full backward (attn_half_full),
               the two training halves with dropout inside and their full
               backwards (attn_half_train, mlp_half_train, *_bwd), the
               attention core on (B, H, S, D) (attention.py:
               masked_attention), the dropout outside the kernels
               (dropout.py), the Philox stream of the masks (philox.py):
               hand-written CUDA kernels on CUDA tensors, plain versions on
               CPU tensors; nvcc build + ctypes binding (ops/_build.py)
  csrc/        the CUDA C++ sources, built at first use into _build/
  core/        the config dataclass and its named presets
  data/        tokenizer, image transforms (pixelbert, RandAugment), patch-row
               relayout, arrow datasets, collate, MLM collator, the sharded
               loader, MultitaskDataModule
  eval/        the metric bag (MetricBag)
  models/      layers, text embeddings, ViT, heads (the BarlowTwins projector's
               BatchNorm statistics as buffers), ViLT with its momentum twins
               and MoCo queue (reference state_dict names)
  objectives/  the loss primitives, InfoNCE, the momentum update, the
               queue and the MoCo objective with its four views; the
               BarlowTwins correlation loss and objective with its three
               views; the downstream objectives; the pretraining objectives
               (MLM, MPP, MPPD, MPFR, ITM with its IPOT word-patch alignment)
  train/       parameter groups, schedule and AdamW / Adam / SGD (schedule.py);
               TrainState, make_train_step with accumulation,
               make_attacked_train_step, make_eval_step (step.py); the Trainer
               (loop.py), CheckpointManager (checkpoint.py), MetricLogger
               (logging.py)
  attacks/     PGD on the pixels (moco, barlowtwins, vqa, irtr), the greedy
               word attack (moco, barlowtwins)
  compat/      the JAX package's parameters as the port's state dict
  parallel/    data parallelism over processes under torchrun: the object
               collectives (comm.py), the process group and the step's
               tensor collectives (dist.py)
  serve.py     build_infer_fn, batch_spec, Session, postprocess; the AOT
               artifact (torch.export): export_inference, load_artifact,
               ArtifactSession
  cli/run.py   python -m rmcl_tpu_torch.cli.run with <config> ... | configs |
               serve ... | export ... | prepare ...
"""

from rmcl_tpu_torch.core.config import build_config  # noqa: F401
from rmcl_tpu_torch.models.vilt import ViLT  # noqa: F401
from rmcl_tpu_torch.serve import TASKS, Session, build_infer_fn  # noqa: F401
