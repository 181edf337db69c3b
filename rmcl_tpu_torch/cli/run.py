"""Command line of the PyTorch port.

    python -m rmcl_tpu_torch.cli.run with <named_config> [key=value ...] [device=cpu]
    python -m rmcl_tpu_torch.cli.run configs
    python -m rmcl_tpu_torch.cli.run prepare <dataset> root=RAW_DIR out=ARROW_DIR
    python -m rmcl_tpu_torch.cli.run serve <task> input=reqs.jsonl [output=out.jsonl]
        [batch_size=N] [device=cuda|cpu] with <named_config> [key=value ...]
        [load_path=state_dict.pt]

(``rmcl-torch`` is the same command.)

``with``: train, as the reference's ``python run.py with task_moco
text_view=True image_view=True data_root=/data`` does (or ``with
task_mlm_itm``, ``task_mlm_itm_mpp``, ``task_finetune_vqa`` ..., or no named
config for the default pretraining losses, itm and mlm): the port's
``Trainer`` (``train/loop.py``) over the arrow tables under ``data_root``,
with validation and the ``last`` / ``best`` checkpoints under
``log_dir/exp_name``; ``test_only=True`` validates on the test split
instead; ``resume_from=last`` continues a run.  ``configs`` lists the named
configs.  On N cards of one machine::

    torchrun --nproc_per_node=N -m rmcl_tpu_torch.cli.run with task_moco ...

(``python -m torch.distributed.run`` is the same): with ``WORLD_SIZE`` > 1
every rank joins the NCCL process group on its ``cuda:LOCAL_RANK``
(``parallel/dist.py:init_distributed``), or gloo with ``device=cpu``, and
the Trainer runs data-parallel over the ranks.

``serve``: requests are one JSON object per line, ``{"image": path, "text":
str}``; each output line is the ``rmcl serve`` record of its request.

``load_path`` is a checkpoint directory of this package, or a
``torch.save``d reference-named state dict, plain or under ``"state_dict"``
as in a Lightning checkpoint; without it the weights are drawn from the
config's seed.  Both subcommands run on the first CUDA device and fail when
there is none; ``device=cpu`` asks for the CPU and the plain ops.

``prepare``: ``prepare {coco|f30k|gcc|sbu|vg|nlvr2|vqa} root=RAW_DIR
out=ARROW_DIR`` writes the arrow tables the loader reads
(``data/writers.py``; pyarrow on the host).

Not ported: ``export`` (ROADMAP "Not ported").
"""

from __future__ import annotations

import ast
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

from rmcl_tpu_torch.core.config import build_config, named_configs

# reference key spellings accepted verbatim: the GPU wording maps onto the
# device-count/per-device fields 1:1
_KEY_ALIASES = {
    "per_gpu_batchsize": "per_device_batchsize",
    "num_gpus": "num_devices",
}


def parse_with(argv: List[str]) -> Tuple[List[str], Dict[str, Any]]:
    """``name1 name2 key=value ...`` -> (named configs, overrides); values
    are Python literals where they parse as one, else strings."""
    names: List[str] = []
    overrides: Dict[str, Any] = {}
    for tok in argv:
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = _KEY_ALIASES.get(k, k)
            try:
                overrides[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                overrides[k] = v
        else:
            names.append(tok)
    return names, overrides


def _usage(tasks) -> int:
    print(f"usage: python -m rmcl_tpu_torch.cli.run serve {{{'|'.join(tasks)}}} "
          "input=FILE [output=FILE] [batch_size=N] [device=cuda|cpu] with <named_config> "
          "[load_path=FILE]", file=sys.stderr)
    return 2


def serve(argv: List[str]) -> int:
    from PIL import Image

    from rmcl_tpu_torch.data.tokenizer import get_tokenizer
    from rmcl_tpu_torch.serve import TASKS, Session, postprocess, seeded_model
    from rmcl_tpu_torch.train.checkpoint import load_initial_params
    if not argv or argv[0] not in TASKS:
        return _usage(TASKS)
    task, rest = argv[0], argv[1:]
    opts = {"input": None, "output": None, "batch_size": "1", "device": "cuda"}
    while rest and rest[0].split("=", 1)[0] in opts and "=" in rest[0]:
        k, v = rest[0].split("=", 1)
        opts[k] = v
        rest = rest[1:]
    if opts["input"] is None:
        return _usage(TASKS)
    if rest and rest[0] == "with":
        rest = rest[1:]
    names, overrides = parse_with(rest)
    cfg = build_config(*names, **overrides)

    model = load_initial_params(cfg, seeded_model(cfg))
    device = torch.device(opts["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: serve on a GPU, or pass device=cpu "
                           "to run the plain ops on the CPU")
    tok = get_tokenizer(cfg.tokenizer)
    sess = Session(cfg, model, task, int(opts["batch_size"]), device, tokenizer=tok)

    with open(opts["input"]) as fin:
        reqs = [json.loads(ln) for ln in fin if ln.strip()]
    fout = open(opts["output"], "w") if opts["output"] else sys.stdout
    try:
        B = sess.batch_size
        for i in range(0, len(reqs), B):
            chunk = reqs[i:i + B]
            images = []
            for r in chunk:
                with Image.open(r["image"]) as im:
                    images.append(im.convert("RGB"))
            texts = [r["text"] for r in chunk]
            batch = sess.assemble(images, texts)
            out = sess.infer(batch)
            for rec in postprocess(task, out, tokenizer=tok, text_ids=batch["text_ids"]):
                fout.write(json.dumps(rec) + "\n")
    finally:
        if opts["output"]:
            fout.close()
    print(f"[rmcl_tpu_torch] served {len(reqs)} {task} requests on {device} "
          f"(batch {sess.batch_size})", file=sys.stderr)
    return 0


def train(argv: List[str]) -> int:
    from rmcl_tpu_torch.parallel import comm, dist
    from rmcl_tpu_torch.train.loop import Trainer
    names, overrides = parse_with(argv)
    device = overrides.pop("device", None)
    try:
        cfg = build_config(*names, **overrides)
    except (KeyError, TypeError) as e:
        print(f"error: {e}\n  named configs: python -m rmcl_tpu_torch.cli.run configs\n"
              "  overrides must be valid RMCLConfig fields", file=sys.stderr)
        return 2
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        device = dist.init_distributed(device)
    try:
        trainer = Trainer(cfg, workdir=cfg.log_dir, device=device)
        trainer.setup()
        world = comm.get_world_size()
        main = comm.is_main_process()
        if main:
            print(f"[rmcl_tpu_torch] exp={cfg.exp_name} tasks="
                  f"{[k for k, v in cfg.loss_names.items() if v >= 1]} device={trainer.device} "
                  f"ranks={world} max_steps={trainer.max_steps} accum={trainer.accum_steps}")
        if cfg.test_only:
            metrics = trainer.validate(split="test")
        else:
            trainer.fit()
            metrics = trainer.validate(split="val")
        if main:
            for k, v in sorted(metrics.items()):
                print(f"{k}: {v}")
    finally:
        if joined:
            dist.destroy()
    return 0


def prepare(argv: List[str]) -> int:
    """``prepare <dataset> root=RAW_DIR out=ARROW_DIR``: the raw dataset's
    arrow tables (``data/writers.py:WRITERS``)."""
    from rmcl_tpu_torch.data.writers import WRITERS
    kw = dict(a.split("=", 1) for a in argv[1:] if "=" in a)
    root = kw.get("--root") or kw.get("root")
    out = kw.get("--out") or kw.get("out")
    if not argv or argv[0] not in WRITERS or not root or not out:
        print(f"usage: python -m rmcl_tpu_torch.cli.run prepare {{{'|'.join(WRITERS)}}} "
              f"root=RAW_DIR out=ARROW_DIR", file=sys.stderr)
        return 2
    WRITERS[argv[0]](root, out)
    return 0


NOT_PORTED = {
    "export": "the StableHLO export is not ported (ROADMAP, Not ported)",
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] == "configs":
        for n in named_configs():
            print(n)
        return 0
    if argv[0] == "serve":
        return serve(argv[1:])
    if argv[0] == "prepare":
        return prepare(argv[1:])
    if argv[0] in NOT_PORTED:
        raise NotImplementedError(f"{argv[0]}: {NOT_PORTED[argv[0]]}")
    if argv[0] == "with":
        argv = argv[1:]
    return train(argv)


if __name__ == "__main__":
    raise SystemExit(main())
