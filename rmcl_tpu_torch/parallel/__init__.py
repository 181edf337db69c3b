"""Data parallelism over processes (port of ``rmcl_tpu/parallel/comm.py`` and of
the JAX package's multi-process paths).

  comm.py    host-level object collectives (``all_gather`` of picklable
             objects, ``gather``, ``reduce_dict``, ``shared_random_seed``,
             ``synchronize``), the identity in one process
  dist.py    the process group (``init_distributed``, from the torchrun
             environment) and the training step's tensor collectives: the
             gradient mean, the rank-ordered row gather, the global-batch
             draws and counts

Several processes are launched with torchrun (``torchrun
--nproc_per_node=N -m rmcl_tpu_torch.cli.run with ...``).
"""
