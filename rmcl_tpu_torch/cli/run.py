"""Command line of the PyTorch port.

    python -m rmcl_tpu_torch.cli.run serve <task> input=reqs.jsonl [output=out.jsonl]
        [batch_size=N] [device=cuda|cpu] with <named_config> [key=value ...]
        [load_path=state_dict.pt]

Requests are one JSON object per line, ``{"image": path, "text": str}``;
each output line is the ``rmcl serve`` record of its request.  ``load_path``
is a ``torch.save``d reference-named state dict, plain or under
``"state_dict"`` as in a Lightning checkpoint; without it the weights are
drawn from the config's seed.  Serves on the first CUDA device and fails
when there is none; ``device=cpu`` asks for the CPU and the plain ops.

``serve`` is the only subcommand.  Training has no command yet: the
``task_moco`` training step is reached from Python through
``rmcl_tpu_torch.train.step`` (``create_train_state``, ``make_train_step``)
until the Trainer is ported.
"""

from __future__ import annotations

import ast
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

from rmcl_tpu_torch.core.config import build_config

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
    from rmcl_tpu_torch.serve import (TASKS, Session, load_state_dict_file,
                                      postprocess, seeded_model)
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

    model = seeded_model(cfg)
    if cfg.load_path:
        skipped = model.load_reference_state_dict(load_state_dict_file(cfg.load_path))
        if skipped:
            print(f"[rmcl_tpu_torch] {len(skipped)} checkpoint entries not used "
                  f"for serving (e.g. {skipped[0]})", file=sys.stderr)
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


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        return serve(argv[1:])
    print(__doc__)
    if not argv or argv[0] in ("-h", "--help"):
        return 0
    print(f"unknown subcommand {argv[0]!r}: serve is the only one; training runs through "
          "rmcl_tpu_torch/train/step.py:make_train_step until the Trainer (ROADMAP A9) "
          "is ported", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
