"""Data and tensor parallelism over processes (port of ``rmcl_tpu/parallel/``:
``comm.py``, ``mesh.py``, ``sharding_rules.py``, and of the JAX package's
multi-process paths).

  comm.py    host-level object collectives (``all_gather`` of picklable
             objects, ``gather``, ``reduce_dict``, ``shared_random_seed``,
             ``synchronize``), the identity in one process
  dist.py    the process group (``init_distributed``, from the torchrun
             environment) and the training step's tensor collectives: the
             gradient mean, the rank-ordered row gather, the global-batch
             draws and counts, over the grid's data group
  mesh.py    the ``(data, model)`` grid over the ranks (``init_grid``): each
             rank's data group and model group
  sharding_rules.py  the Megatron rules: which dimension of which parameter
             a model axis shards (qkv aligned to heads), shard and gather of
             full state dicts, the model-partial gradients
  tp.py      Megatron's f and g over the model group, and the gather of the
             vocabulary-parallel logits

Several processes are launched with torchrun (``torchrun
--nproc_per_node=N -m rmcl_tpu_torch.cli.run with ...``).  The Trainer and
``cli.run with`` run data-parallel, as the JAX package's Trainer does whatever
``mesh_shape`` says; the tensor-parallel step is built in the ranks as the JAX
package's ``create_train_state(..., mesh=)`` builds it::

    device = dist.init_distributed()
    mesh.init_grid(cfg.mesh_shape, cfg.mesh_axis_names)     # e.g. (2, 2), ("data", "model")
    ts = train.step.create_train_state(cfg, device=device)  # this rank's shards
    step = train.step.make_train_step(cfg, ts)              # or make_attacked_train_step
"""
