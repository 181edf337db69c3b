"""MLM-fill + word-patch-alignment demo (port of ``rmcl_tpu/demos/demo.py``;
reference demo.py).

With ``--web`` (gradio): a web UI.  Otherwise: a one-shot CLI.
    python -m rmcl_tpu_torch.demos.demo --ckpt vilt_200k_mlm_itm.ckpt \
        --image cat.jpg --text "a [MASK] sitting on the grass" --hidx 2

The checkpoint is a reference-named state dict (a reference ``.ckpt``, plain
or under ``"state_dict"``), merged into the seeded model as ``load_path=``
merges one (``ViLT.load_reference_state_dict``).  It runs on the first CUDA
device; ``--device cpu`` asks for the CPU and the plain ops.  PIL and gradio
are imported where they are used.
"""

from __future__ import annotations

import argparse

import numpy as np

from rmcl_tpu_torch.core.config import build_config, loss_names
from rmcl_tpu_torch.data.tokenizer import get_tokenizer
from rmcl_tpu_torch.demos.inference import DemoEngine
from rmcl_tpu_torch.serve import load_state_dict_file, seeded_model


def load_model(cfg, ckpt: str):
    """The seeded model of ``cfg`` with the checkpoint merged into it."""
    model = seeded_model(cfg)
    model.load_reference_state_dict(load_state_dict_file(ckpt), reference_file=True)
    return model


def config():
    """The demo's model: the pretraining heads (MLM, ITM) on a 608 x 608
    canvas, every patch: S = 19 x 19 + 1 + 40 = 402."""
    return build_config(loss_names=loss_names({"mlm": 1, "itm": 1}),
                        image_bucket_hw=(608, 608))


def build_engine(ckpt: str, vocab: str = None, device="cuda") -> DemoEngine:
    cfg = config()
    tok = get_tokenizer(cfg.tokenizer, vocab)
    return DemoEngine(cfg, load_model(cfg, ckpt), tok, device=device)


def run_cli(args):
    from PIL import Image
    engine = build_engine(args.ckpt, args.vocab, args.device)
    image = Image.open(args.image).convert("RGB")
    filled, steps = engine.mlm_fill(image, args.text)
    print("filled:", filled)
    for i, s in enumerate(steps):
        print(f"  step {i}: {s}")
    if args.hidx > 0:
        heat, token = engine.wpa_heatmap(image, filled, args.hidx)
        print(f"alignment heatmap for token {token!r}:")
        for row in (heat * 9).astype(int):
            print("  " + "".join(str(v) for v in row))


def run_gradio(args):
    import gradio as gr
    from PIL import Image
    engine = build_engine(args.ckpt, args.vocab, args.device)

    def infer(image, text, hidx):
        image = Image.fromarray(image)
        filled, _ = engine.mlm_fill(image, text)
        token = ""
        if hidx and int(hidx) > 0:
            heat, token = engine.wpa_heatmap(image, filled, int(hidx))
            w, h = image.size
            overlay = Image.fromarray(
                np.uint8(heat * 255), "L").resize((w, h), Image.NEAREST)
            image = image.copy()
            image.putalpha(overlay)
        return np.array(image), filled, token

    gr.Interface(
        fn=infer,
        inputs=[gr.Image(), gr.Textbox(label="masked text"),
                gr.Number(value=0, label="token index for heatmap")],
        outputs=[gr.Image(), gr.Textbox(label="filled"),
                 gr.Textbox(label="selected token")],
    ).launch()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--text", default="a photo of a [MASK]")
    ap.add_argument("--hidx", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a GPU) or cpu (the plain ops)")
    ap.add_argument("--web", action="store_true")
    args = ap.parse_args(argv)
    if args.web:
        run_gradio(args)
    else:
        if not args.image:
            raise SystemExit("--image required in CLI mode")
        run_cli(args)


if __name__ == "__main__":
    main()
