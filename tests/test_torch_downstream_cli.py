"""The attacked IR/TR recall against the JAX package's, and ``cli.run with``
the three downstream named configurations on the CPU, at
tests/test_torch_downstream_eval.py's sizes, tables and tolerances (its module
docstring), whose helpers these tests share.  Apart from that file so that
the two run on separate workers."""

import numpy as np
import pytest
import torch

from rmcl_tpu.eval import retrieval as JR
from rmcl_tpu_torch.core.config import build_config, loss_names
from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
from rmcl_tpu_torch.eval import retrieval as TR
from rmcl_tpu_torch.train import loop as TL
from tests.test_torch_downstream_eval import _capture, _kw, _trainers, data  # noqa: F401
from tests.test_torch_train import _close
from tests._torch_threads import one_thread  # noqa: F401


def test_attacked_recall_matches_jax(data, tmp_path, monkeypatch):
    """compute_attacked_irtr_recall for task_finetune_irtr_coco_randaug_attacked
    with irtr beside irtr_attacked (the host attacker of each package):

      * the text view against the JAX package's on the same weights: every
        caption attacked on the 0.5 canvas as the JAX package attacks it, the
        score matrix within 1e-5 x max(1, max|ref|), the recall equal, the
        attack moving the scores;
      * the image view's PGD on an image's patch rows against the JAX
        package's on its (H, W, 3) canvas, toward a seeded unit text
        projection: delta relaid as patch rows within 2.5e-7;
      * the image view as both packages run it, toward the projection of its
        own input (an all-[PAD] text): a stationary point, whose gradient is
        at rounding level (below 1e-8 of the loss's scale, where the step
        normalises by max(max|g|, 1e-8)), so its delta is rounding noise
        that no two implementations share (ROADMAP, Queue C); it runs,
        finite, within the clip."""
    from rmcl_tpu import attacks as JA
    from rmcl_tpu.models.vit import from_patch_rows
    from rmcl_tpu_torch.attacks.pgd import make_pgd_irtr
    _, _, vectors = data
    # irtr beside irtr_attacked: the recall ranks by rank_output, which the
    # named configuration alone does not build (test_recall_needs_rank_output)
    jtr, tr = _trainers(data, tmp_path, "task_finetune_irtr_coco_randaug_attacked",
                        loss_names=loss_names({"irtr": 1, "irtr_attacked": 1}),
                        image_view=True, text_view=True, embedding_path=vectors,
                        greedy_impl="host", n_candidates=3, max_loops=2)
    jseen, seen = _capture(monkeypatch, JR), _capture(monkeypatch, TR)
    want = JR.compute_attacked_irtr_recall(jtr, image_view=False)
    got = TR.compute_attacked_irtr_recall(tr, image_view=False)
    _close("attacked recall scores", seen[0], jseen[0], 1e-5)
    assert got == want
    TR.compute_irtr_recall(tr)
    assert np.abs(seen[-1] - seen[0]).max() > 1e-4    # the attack moved the scores

    cfg = tr.cfg
    rows = TR.image_rows(cfg, tr.dm.make_no_false_dset("coco", "test").get_image(0)["image"][0])
    T = cfg.max_text_len
    text_repr = np.random.RandomState(0).randn(1, 128).astype(np.float32)
    text_repr /= np.linalg.norm(text_repr)
    canvas = np.asarray(from_patch_rows(rows, cfg.grid_hw, cfg.patch_size))
    jb = {"image": canvas, "text_ids": np.zeros((1, T), np.int32),
          "text_masks": np.ones((1, T), np.int32)}
    ref = JA.make_pgd_irtr(jtr.model, 2, cfg.adv_lr_img, cfg.adv_max_norm_img,
                           cfg.temperature)(jtr.ts.params, jb, text_repr)
    tb = {k: torch.from_numpy(v) for k, v in dict(jb, image=rows).items()}
    ours = make_pgd_irtr(tr.ts.model, 2, cfg.adv_lr_img, cfg.adv_max_norm_img,
                         cfg.temperature)(tb, torch.from_numpy(text_repr),
                                          block_matrices=tr.ts.block_matrices)
    relaid = hwc_to_patch_rows(np.asarray(ref), cfg.patch_size)
    np.testing.assert_allclose(ours.numpy(), relaid, atol=2.5e-7, rtol=0)
    assert np.abs(relaid).max() > 1e-3

    from rmcl_tpu_torch.attacks import pgd as P
    steps, inner = [], P._linf_normalised_step
    monkeypatch.setattr(P, "_linf_normalised_step",
                        lambda d, g, lr, mn: steps.append(g.abs().max().item()) or inner(
                            d, g, lr, mn))
    TR.compute_attacked_irtr_recall(tr, text_view=False)
    assert len(steps) == 3 and max(steps) < 1e-8, steps   # one step per image
    assert np.isfinite(seen[-1]).all()


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("config", ["task_finetune_nlvr2_randaug_attacked",
                                    "task_finetune_vqa_randaug_attacked",
                                    "task_finetune_irtr_coco"])
def test_cli_runs_the_downstream_configs_on_the_cpu(data, tmp_path, capsys, config):
    """``cli.run with <config> image_view=True text_view=True ... device=cpu``:
    one step (the fused greedy attack inside the attacked step, one PGD
    step), validation (the recall for IRTR) and the checkpoint; the same
    command without a card and without device=cpu raises."""
    from rmcl_tpu_torch.cli.run import main
    d, vocab, vectors = data
    kw = _kw(d, vocab, embedding_path=vectors, n_candidates=3, max_loops=2,
             log_dir=str(tmp_path / "log"), max_steps=1)
    args = ["with", config] + [f"{k}={v}" for k, v in kw.items()
                               if k not in ("vocab_size",)] + [
        f"vocab_size={kw['vocab_size']}", "image_view=True", "text_view=True"]
    args = [a.replace(" ", "") for a in args]
    assert main(args + ["device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "val/the_metric" in out
    if config.endswith("irtr_coco"):
        assert "ir_r1" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)


def test_recall_needs_rank_output(data, tmp_path):
    """task_finetune_irtr_coco_randaug_attacked alone builds no rank_output,
    the head the recall ranks by (the JAX package fails on it too): the
    recall says so."""
    d, vocab, _ = data
    cfg = build_config("task_finetune_irtr_coco_randaug_attacked",
                       log_dir=str(tmp_path), **_kw(d, vocab))
    tr = TL.Trainer(cfg, workdir=cfg.log_dir, device="cpu")
    tr.setup()
    assert not hasattr(tr.ts.model, "rank_output") and hasattr(tr.ts.model, "moco_head")
    with pytest.raises(ValueError, match="rank_output"):
        TR.compute_attacked_irtr_recall(tr, text_view=False)
