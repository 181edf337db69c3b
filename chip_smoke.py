"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository.  ViLT-B/32 at full width
(``task_finetune_vqa``: C=768, 12 layers, 12 heads, patch 32, bucket
384x608 so S = 40 + 229 = 269, 3129 VQA labels, bf16 compute, u8 wire) with
seeded random weights.  Phases, any failure exits non-zero:

  1. device    a CUDA device, its name and power limit (nvidia-smi)
  2. build     nvcc builds rmcl_tpu_torch/csrc for sm_90a
  3. kernels   attn_half and mlp_half against their plain versions at
               B=8, S=269 with a random key mask: fp32 (TF32 off) error
               <= 2e-4 * max(1, max|ref|), bf16 error <= 2e-2 * max|ref|;
               kernel and plain times (median of 20 after warm-up, CUDA events)
  4. serving   a batch-8 Session answers 20 synthetic wire-format requests
               (last chunk short: padded); every block of every forward must
               go through both kernels (launch counters); outputs finite
  5. slice     the first 4 requests on the CPU in fp32 through the plain ops
               vs the card: fp32 kernels (VQA logits within
               1e-3 * max(1, max|ref|)) and bf16 kernels (cls_feats cosine
               >= 0.99 per request)

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

CONFIG = "task_finetune_vqa"
BATCH = 8
N_REQUESTS = 20
N_CPU = 4
SEED = 0
KERNELS = {  # op -> the Pallas kernel body it replaces
    "attn_half": "rmcl_tpu/ops/pallas_block.py:112",
    "mlp_half": "rmcl_tpu/ops/pallas_block.py:526",
}
SOURCE = "rmcl_tpu_torch/csrc/block_kernels.cu"


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return line


def phase_build() -> None:
    from rmcl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    print(f"[build] {path.name} in {secs:.1f} s (nvcc {_build.nvcc()})")
    for ln in log.splitlines():   # ptxas: registers, shared memory, spills per kernel
        if "registers" in ln or "spill" in ln:
            print(f"[build] {ln.strip()}")


def _block_inputs(dev, C=768, H=12, B=BATCH, S=269):
    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *s, std=0.02: torch.randn(*s, generator=g, device=dev) * std  # noqa: E731
    x = rn(B, S, C, std=1.0)
    mask = (torch.rand(B, S, generator=g, device=dev) > 0.3).int()
    mask[:, 0] = 1
    ln = (1.0 + rn(C, std=0.1), rn(C, std=0.1))
    attn = (rn(3 * C, C), rn(3 * C), rn(C, C), rn(C))
    mlp = (rn(4 * C, C), rn(4 * C), rn(C, 4 * C), rn(C))
    return x, mask, ln, attn, mlp, H


def phase_kernels(dev) -> dict:
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.models.vit import VIT_LN_EPS as eps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, mask, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2), H = _block_inputs(dev)
    res = {}
    with torch.inference_mode():
        for dtype, rtol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            xd = x.to(dtype)
            calls = {
                "attn_half": (FB.attn_half, FB.attn_half_plain,
                              (xd, mask, lw, lb, wq.to(dtype), bq, wp.to(dtype), bp, H, eps)),
                "mlp_half": (FB.mlp_half, FB.mlp_half_plain,
                             (xd, lw, lb, w1.to(dtype), b1, w2.to(dtype), b2, eps)),
            }
            for name, (op, plain, args) in calls.items():
                ref = plain(*args).float()
                out = op(*args).float()
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()), f"{name} {dtype}: non-finite output")
                err = (out - ref).abs().max().item()
                ref_max = ref.abs().max().item()
                tol = rtol * (max(1.0, ref_max) if dtype == torch.float32 else ref_max)
                ms = time_ms(lambda: op(*args))
                plain_ms = time_ms(lambda: plain(*args))
                tag = "fp32" if dtype == torch.float32 else "bf16"
                print(f"[kernels] {name} {tag} B=8 S=269 C=768 H=12: max_abs_err={err!r} "
                      f"(tol {tol:.3g}, max|ref|={ref_max:.4g}) kernel_ms={ms!r} "
                      f"plain_ms={plain_ms!r}")
                check(err <= tol, f"{name} {tag}: error {err} > {tol}")
                res.setdefault(name, {})[tag] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return res


def synthetic_requests(cfg, n: int, seed: int) -> dict:
    """n wire-format VQA requests: u8 patch rows of images with varied valid
    sizes (zero outside), and BERT-like id sequences of varied length."""
    r = np.random.RandomState(seed)
    H, W = cfg.image_bucket_hw
    P, T = cfg.patch_size, cfg.max_text_len
    gh, gw = cfg.grid_hw
    canvas = np.zeros((n, H, W, 3), np.uint8)
    hw = np.zeros((n, 2), np.int32)
    ids = np.zeros((n, T), np.int32)
    masks = np.zeros((n, T), np.int32)
    for i in range(n):
        h, w = r.randint(P, H + 1), r.randint(P, W + 1)
        hw[i] = (h, w)
        canvas[i, :h, :w] = r.randint(0, 256, (h, w, 3), np.uint8)
        L = r.randint(4, T + 1)
        ids[i, :L] = r.randint(1000, cfg.vocab_size, L)
        ids[i, 0], ids[i, L - 1] = 101, 102     # [CLS] ... [SEP]
        masks[i, :L] = 1
    rows = canvas.reshape(n, gh, P, gw, P, 3).transpose(0, 1, 3, 2, 4, 5)
    return {"image": np.ascontiguousarray(rows.reshape(n, gh * gw, P * P * 3)),
            "image_hw": hw, "text_ids": ids, "text_masks": masks}


def phase_serving(cfg, model, reqs, dev) -> tuple:
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch._host import reference_module
    from rmcl_tpu_torch.serve import Session
    postprocess = reference_module("serve").postprocess

    sess = Session(cfg, model, "vqa", BATCH, dev)
    sess.infer({k: v[:BATCH] for k, v in reqs.items()})     # warm-up
    torch.cuda.synchronize()
    FB.reset_launches()
    t0 = time.perf_counter()
    out = sess.infer(reqs)
    wall = time.perf_counter() - t0
    counts = dict(FB.launches)
    passes = -(-N_REQUESTS // BATCH)
    print(f"[serving] {N_REQUESTS} requests, batch {BATCH}: {passes} forward passes, "
          f"launches {counts}")
    for name in KERNELS:
        check(counts[name] == cfg.num_layers * passes,
              f"{name} launched {counts[name]} times, expected "
              f"{cfg.num_layers} x {passes}")
    check(out.shape == (N_REQUESTS, cfg.vqav2_label_size), f"output shape {out.shape}")
    check(bool(np.isfinite(out).all()), "non-finite VQA logits")
    recs = postprocess("vqa", out)
    check(len(recs) == N_REQUESTS, f"{len(recs)} records")

    full = {k: v[:BATCH] for k, v in reqs.items()}
    lat = []
    for _ in range(15):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.forward(full)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        sess.infer(reqs)
        walls.append(time.perf_counter() - t)
    rps = N_REQUESTS / statistics.median(walls)
    print(f"[serving] {len(recs)} postprocess records; first call {wall:.3f} s; "
          f"median batch-{BATCH} latency {statistics.median(lat)!r} ms; "
          f"{rps!r} requests/s (median of 5 runs of {N_REQUESTS})")
    return sess, counts


def phase_slice(cfg, cpu_state, sess, reqs, dev) -> None:
    from rmcl_tpu_torch.models.vilt import ViLT
    cfg32 = cfg.replace(compute_dtype="float32")
    few = {k: v[:N_CPU] for k, v in reqs.items()}

    def run(model, device, mats=None):
        batch = {k: torch.from_numpy(v).to(device) for k, v in few.items()}
        with torch.inference_mode():
            inf = model.infer(batch, mats)
            logits = model.vqa_classifier(inf["cls_feats"])
        return inf["cls_feats"].float().cpu(), logits.float().cpu()

    cpu32 = ViLT(cfg32)
    cpu32.load_state_dict(cpu_state)
    t0 = time.perf_counter()
    cls_ref, logits_ref = run(cpu32, "cpu")
    cpu_s = time.perf_counter() - t0
    gpu32 = copy.deepcopy(cpu32).to(dev)
    cls32, logits32 = run(gpu32, dev)
    cls16, _ = run(sess.model, dev, sess.block_matrices)

    diff = (logits32 - logits_ref).abs().max().item()
    tol = 1e-3 * max(1.0, logits_ref.abs().max().item())
    cos = torch.nn.functional.cosine_similarity(cls16, cls_ref, dim=1)
    print(f"[slice] {N_CPU} requests, CPU fp32 plain ({cpu_s:.1f} s) vs card fp32 kernels: "
          f"VQA logits max_abs_diff={diff!r} (tol {tol:.3g})")
    print(f"[slice] vs card bf16 kernels: cls_feats cosine per request "
          f"{[round(c, 6) for c in cos.tolist()]} (min {cos.min().item()!r}, need >= 0.99)")
    check(diff <= tol, f"fp32 slice differs from the CPU by {diff} > {tol}")
    check(bool((cos >= 0.99).all()), f"bf16 cls_feats cosine {cos.tolist()} < 0.99")


def main() -> int:
    try:
        from rmcl_tpu_torch import build_config
        from rmcl_tpu_torch.serve import seeded_model
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 1
    phase = "device"
    try:
        phase_device()
        dev = torch.device("cuda", 0)
        phase = "build"
        phase_build()
        phase = "kernels"
        kres = phase_kernels(dev)
        phase = "serving"
        cfg = build_config(CONFIG)
        model = seeded_model(cfg, SEED)
        cpu_state = copy.deepcopy(model.state_dict())
        reqs = synthetic_requests(cfg, N_REQUESTS, SEED)
        sess, counts = phase_serving(cfg, model, reqs, dev)
        phase = "slice"
        phase_slice(cfg, cpu_state, sess, reqs, dev)
    except Exception as e:  # noqa: BLE001  every phase failure ends the run
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": counts[name], "max_abs_err": kres[name]["bf16"]["err"],
         "ms": kres[name]["bf16"]["ms"], "plain_ms": kres[name]["bf16"]["plain_ms"]}
        for name, replaces in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
