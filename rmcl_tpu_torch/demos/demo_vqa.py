"""VQA demo (port of ``rmcl_tpu/demos/demo_vqa.py``; reference demo_vqa.py):
answer a free-form question about an image with a finetuned VQAv2
checkpoint.

    python -m rmcl_tpu_torch.demos.demo_vqa --ckpt vilt_vqa.ckpt \
        --image cat.jpg --question "what animal is this?"

It runs on the first CUDA device; ``--device cpu`` asks for the CPU and the
plain ops.  The checkpoint loads as in ``demos/demo.py``.
"""

from __future__ import annotations

import argparse
import json

from rmcl_tpu_torch.core.config import build_config
from rmcl_tpu_torch.data.tokenizer import get_tokenizer
from rmcl_tpu_torch.demos.demo import load_model
from rmcl_tpu_torch.demos.inference import DemoEngine


def config():
    """The VQA demo's model: task_finetune_vqa's 3,129 answers on the demo's
    608 x 608 canvas."""
    return build_config("task_finetune_vqa", test_only=True,
                        image_bucket_hw=(608, 608))


def build_engine(ckpt: str, vocab: str = None, answers_json: str = None,
                 device="cuda") -> DemoEngine:
    cfg = config()
    tok = get_tokenizer(cfg.tokenizer, vocab)
    id2answer = {}
    if answers_json:
        with open(answers_json) as fp:
            id2answer = {int(k): v for k, v in json.load(fp).items()}
    return DemoEngine(cfg, load_model(cfg, ckpt), tok, id2answer=id2answer,
                      device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--answers", default=None,
                    help="json {label_id: answer} from the datamodule vocab")
    ap.add_argument("--image", required=True)
    ap.add_argument("--question", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a GPU) or cpu (the plain ops)")
    ap.add_argument("--web", action="store_true")
    args = ap.parse_args(argv)

    from PIL import Image
    engine = build_engine(args.ckpt, args.vocab, args.answers, args.device)
    if args.web:
        import gradio as gr

        def infer(image, question):
            out = engine.answer(Image.fromarray(image), question)
            return {a: p for a, p in out}

        gr.Interface(fn=infer, inputs=[gr.Image(), gr.Textbox()],
                     outputs=gr.Label(num_top_classes=5)).launch()
    else:
        image = Image.open(args.image).convert("RGB")
        for a, p in engine.answer(image, args.question):
            print(f"{a}: {p:.4f}")


if __name__ == "__main__":
    main()
