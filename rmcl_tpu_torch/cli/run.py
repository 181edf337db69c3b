"""Command line of the PyTorch port.

    python -m rmcl_tpu_torch.cli.run with <named_config> [key=value ...] [device=cpu]
    python -m rmcl_tpu_torch.cli.run configs
    python -m rmcl_tpu_torch.cli.run prepare <dataset> root=RAW_DIR out=ARROW_DIR
    python -m rmcl_tpu_torch.cli.run serve <task> input=reqs.jsonl [output=out.jsonl]
        [batch_size=N] [device=cuda|cpu] with <named_config> [key=value ...]
        [load_path=state_dict.pt]
    python -m rmcl_tpu_torch.cli.run export <task> OUT [batch_size=N] [device=cuda|cpu]
        with <named_config> [key=value ...] [load_path=...]
    python -m rmcl_tpu_torch.cli.run serve ARTIFACT [input=reqs.jsonl] [output=out.jsonl]
        [device=cuda|cpu] with <named_config> [key=value ...] [load_path=...]

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
``serve <task>`` serves the live model; ``serve ARTIFACT`` (a first argument
that is not a task) the program ``export`` wrote, with its ``ARTIFACT.json``
sidecar, on the config's weights, reading stdin without ``input``.

``export <task> OUT``: the task's inference program at a fixed batch size
(default 1) as an ahead-of-time artifact (``serve.py:export_inference``,
``torch.export``): ``OUT`` and its ``OUT.json`` sidecar.  The program holds
no parameter: ``serve ARTIFACT`` takes them from the config.

``load_path`` is a checkpoint directory of this package, or a
``torch.save``d reference-named state dict, plain or under ``"state_dict"``
as in a Lightning checkpoint; without it the weights are drawn from the
config's seed.  Every subcommand runs on the first CUDA device and fails
when there is none; ``device=cpu`` asks for the CPU and the plain ops.

``prepare``: ``prepare {coco|f30k|gcc|sbu|vg|nlvr2|vqa} root=RAW_DIR
out=ARROW_DIR`` writes the arrow tables the loader reads
(``data/writers.py``; pyarrow on the host).
"""

from __future__ import annotations

import ast
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

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
          "[load_path=FILE]\n"
          "       python -m rmcl_tpu_torch.cli.run serve ARTIFACT [input=FILE] [output=FILE] "
          "[device=cuda|cpu] with <named_config> [load_path=FILE]", file=sys.stderr)
    return 2


def _options(rest: List[str], opts: Dict[str, Any]) -> List[str]:
    """Leading ``key=value`` tokens of ``opts``' keys into ``opts``; the rest
    after an optional ``with``."""
    while rest and "=" in rest[0] and rest[0].split("=", 1)[0] in opts:
        k, v = rest[0].split("=", 1)
        opts[k] = v
        rest = rest[1:]
    return rest[1:] if rest and rest[0] == "with" else rest


def _config_and_model(rest: List[str]):
    """The config of ``with`` tokens and its model, weights from load_path
    (else drawn from the config's seed)."""
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.checkpoint import load_initial_params
    names, overrides = parse_with(rest)
    cfg = build_config(*names, **overrides)
    return cfg, load_initial_params(cfg, seeded_model(cfg))


def _serve_requests(reqs, sess, task: str, tok, fout) -> None:
    """Requests in chunks of the session's batch size (bounds the open images
    at B), each chunk's records to ``fout``."""
    from PIL import Image

    from rmcl_tpu_torch.serve import postprocess
    B = sess.batch_size
    for i in range(0, len(reqs), B):
        chunk = reqs[i:i + B]
        images = []
        for r in chunk:
            with Image.open(r["image"]) as im:
                images.append(im.convert("RGB"))
        batch = sess.assemble(images, [r["text"] for r in chunk])
        out = sess.infer(batch)
        for rec in postprocess(task, out, tokenizer=tok, text_ids=batch["text_ids"]):
            fout.write(json.dumps(rec) + "\n")


def serve(argv: List[str]) -> int:
    from rmcl_tpu_torch.data.tokenizer import get_tokenizer
    from rmcl_tpu_torch.serve import TASKS, ArtifactSession, Session, serving_device
    if not argv:
        return _usage(TASKS)
    live = argv[0] in TASKS
    opts = {"input": None, "output": None, "device": None,
            **({"batch_size": "1"} if live else {})}
    rest = _options(argv[1:], opts)
    if live and opts["input"] is None:
        return _usage(TASKS)
    device = serving_device(opts["device"])
    cfg, model = _config_and_model(rest)
    tok = get_tokenizer(cfg.tokenizer)
    if live:
        task = argv[0]
        sess = Session(cfg, model, task, int(opts["batch_size"]), device, tokenizer=tok)
    else:
        sess = ArtifactSession.open(argv[0], model.state_dict(), tok, device)
        task = sess.meta["task"]
    fin = open(opts["input"]) if opts["input"] else sys.stdin
    try:
        reqs = [json.loads(ln) for ln in fin if ln.strip()]
    finally:
        if opts["input"]:
            fin.close()
    fout = open(opts["output"], "w") if opts["output"] else sys.stdout
    try:
        _serve_requests(reqs, sess, task, tok, fout)
    finally:
        if opts["output"]:
            fout.close()
    print(f"[rmcl_tpu_torch] served {len(reqs)} {task} requests on {device} "
          f"({'live' if live else argv[0]}, batch {sess.batch_size})", file=sys.stderr)
    return 0


def export(argv: List[str]) -> int:
    """``export <task> OUT [batch_size=N] [device=...] with <cfg> ...``."""
    from rmcl_tpu_torch.serve import TASKS, export_inference
    if len(argv) < 2 or argv[0] not in TASKS:
        print(f"usage: python -m rmcl_tpu_torch.cli.run export {{{'|'.join(TASKS)}}} OUT "
              "[batch_size=N] [device=cuda|cpu] with <named_config> [load_path=FILE]",
              file=sys.stderr)
        return 2
    task, out = argv[0], argv[1]
    opts = {"batch_size": "1", "device": None}
    rest = _options(argv[2:], opts)
    cfg, model = _config_and_model(rest)
    bs = int(opts["batch_size"])
    blob = export_inference(cfg, model, task, bs, out_path=out, device=opts["device"])
    print(f"[rmcl_tpu_torch] exported {task} (batch {bs}, {cfg.image_dtype} wire) -> {out} "
          f"({len(blob)} bytes)")
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
    if argv[0] == "export":
        return export(argv[1:])
    if argv[0] == "with":
        argv = argv[1:]
    return train(argv)


if __name__ == "__main__":
    raise SystemExit(main())
