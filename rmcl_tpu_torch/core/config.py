"""Config system: frozen dataclass + named presets (the port's own copy of
the JAX package's ``core/config.py``; standard library only).

A typed, immutable re-design of the reference's Sacred experiment config
(reference vilt/config.py:24-116 base keys, :119-471 named configs).
``build_config("task_moco", text_view=True)`` mirrors
``python run.py with task_moco text_view=True``.

The dataclass has exactly the JAX package's fields and defaults, so a config
built by either package has the same fields and a command line written for
one parses for the other.  The fields under "JAX-package knobs" select
between implementations that exist only there (Pallas/XLA paths, remat,
meshes, dropout bit sources); the port carries them and reads none of them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Loss-name multiplexer — reference vilt/config.py:6-21.  A task is active
# iff its weight >= 1 (reference vilt/modules/vilt_utils.py:325-329).
LOSS_KEYS = (
    "moco",
    "barlowtwins",
    "itm",
    "mlm",
    "mpp",
    "vqa",
    "nlvr2",
    "irtr",
    "irtr_attacked",
    "nlvr2_attacked",
    "vqa_attacked",
    # extensions beyond the reference's 11 keys: the reference ships
    # compute_mppd/compute_mpfr (objectives.py:668-711) but no loss keys
    # or heads for them (dormant); here they are activatable.
    "mppd",
    "mpfr",
)


def loss_names(d: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    ret = {k: 0.0 for k in LOSS_KEYS}
    if d:
        ret.update(d)
    return ret


@dataclass(frozen=True)
class RMCLConfig:
    # Experiment
    exp_name: str = "rmcl"
    seed: int = 0
    datasets: Tuple[str, ...] = ("coco", "vg", "sbu", "gcc")
    loss_names: Dict[str, float] = field(default_factory=lambda: loss_names({"itm": 1, "mlm": 1}))
    # desired GLOBAL batch; when per_device_batchsize caps the per-step
    # batch below it, a trainer accumulates batch_size //
    # (per_device_batchsize * devices * hosts) micro-batches per
    # optimizer step (the reference's run.py:86-88)
    batch_size: int = 4096

    # Image
    train_transform_keys: Tuple[str, ...] = ("pixelbert",)
    val_transform_keys: Tuple[str, ...] = ("pixelbert",)
    image_size: int = 384
    max_image_len: int = -1
    patch_size: int = 32
    draw_false_image: int = 1
    # drop false-image/text draws no ACTIVE loss reads (only itm
    # consumes false_image_0, only irtr/irtr_attacked consume
    # false_text_i) — the reference decodes a false image per sample
    # even for task_moco, where nothing reads it (data/datamodule.py)
    skip_unused_false_draws: bool = True
    image_only: bool = False

    # Text
    vqav2_label_size: int = 3129
    max_text_len: int = 40
    tokenizer: str = "bert-base-uncased"
    vocab_size: int = 30522
    whole_word_masking: bool = False
    mlm_prob: float = 0.15
    draw_false_text: int = 0

    # Transformer
    vit: str = "vit_base_patch32_384"
    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_ratio: int = 4
    drop_rate: float = 0.1

    # Optimizer
    optim_type: str = "adamw"
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    decay_power: Any = 1  # 1 | "cosine" | float power
    max_epoch: int = 100
    max_steps: Optional[int] = 25000
    warmup_steps: Any = 2500  # int steps or float fraction of max_steps
    end_lr: float = 0.0
    lr_mult: float = 1.0  # downstream-head LR multiplier

    # Downstream
    get_recall_metric: bool = False

    # Contrastive
    multimodal: bool = False
    num_negative: int = 0
    text_view: bool = False
    image_view: bool = False
    augmentation: bool = False
    num_beams: int = 20
    num_return_sequences: int = 20
    type_txt_augm: Tuple[str, ...] = ("PEGASUS", "EDA")
    momentum: float = 1.0
    temperature: float = 1.0
    adv_lr: float = 0.0051  # doubles as the Barlow-Twins off-diag lambda
    # BarlowTwins projector widths (hidden -> d1 -> d2 -> out).  The
    # reference hardcodes 8192-8192-8192 (reference heads.py:88-106);
    # configurable here so scaled-down models/tests keep the head
    # proportionate.  Checkpoint compat is shape-driven, unaffected.
    bt_proj_dims: Tuple[int, int, int] = (8192, 8192, 8192)

    # Attacks — PGD (reference vilt/config.py:89-92)
    adv_steps_img: int = 5
    adv_lr_img: float = 0.5
    adv_max_norm_img: float = 0.1
    attack_idx: Tuple[bool, bool] = (False, False)
    # Attacks — geometric greedy (reference vilt/config.py:94-100)
    n_candidates: int = 5
    max_loops: int = 10
    sim_thred: float = 0.5
    cos_sim: bool = True
    synonym: str = "cos_sim"
    embedding_path: str = "./attack/counter-fitted-vectors.txt"
    sim_path: str = "cos_sim_counter_fitting.npy"

    # Trainer
    resume_from: Optional[str] = None
    fast_dev_run: bool = False
    val_check_interval: float = 1.0
    test_only: bool = False

    # Environment
    data_root: str = ""
    log_dir: str = "result"
    per_device_batchsize: int = 0
    num_devices: int = 1
    num_nodes: int = 1
    load_path: str = ""
    num_workers: int = 4
    # loader worker PROCESSES (0 = thread pool); fork-based, POSIX only
    num_worker_procs: int = 0
    precision: int = 16  # kept for parity with the reference; compute_dtype decides

    # ----- static shapes and the wire format (no reference counterpart) -----
    # image_bucket_hw: static pad canvas (H, W).  MinMaxResize at size=384
    # caps the long side at int(1333/800*384)=639 -> //32*32 = 608, so
    # (384, 608) holds every landscape image exactly; portrait images fit
    # via the bucket shrink.
    # image_layout: "hwc" pixel canvas (B, H, W, 3) or "patch" rows
    # (B, gh*gw, P*P*3); rows make patchify one matmul.  The port takes rows.
    # image_dtype: "uint8" ships raw resized pixels + per-sample (h, w) and
    # normalises on the device, bit-identical to the float32 pipeline.
    # compute_dtype: activation type; queue_dtype: MoCo queue storage type
    # ("" = compute_dtype).
    # attention_impl, mlp_impl: the block configuration
    # (models/vilt.py:derive_block_impls): "" | "fused" | "pallas" | "flash",
    # and "" | "fused" | "fused_train"; the XLA paths are not ported.
    # greedy_impl ("fused" | "host": train/loop.py:build_greedy_attacker),
    # greedy_compact_frac, greedy_score_max_rows and attack_text_bucket
    # (attacks/greedy_fused.py; the deprecated greedy_text_bucket umbrella
    # only through core/buckets.py:bucket_enabled): the greedy attack.
    # ----- JAX-package knobs: carried for field parity, not read by the port -----
    # use_pallas_attention, fuse_attack_step, eval_text_bucket,
    # train_text_bucket, graceful_preemption, preempt_sync_every,
    # dropout_impl, block_layout, mesh_shape, mesh_axis_names, zero1,
    # remat_blocks, remat_policy, pgd_remat, pgd_kernel_impl,
    # fuse_moco_views, host_prefetch.
    image_bucket_hw: Tuple[int, int] = (384, 608)
    image_layout: str = "patch"
    use_pallas_attention: bool = False
    attention_impl: str = ""
    mlp_impl: str = ""
    greedy_impl: str = "fused"
    fuse_attack_step: bool = True
    greedy_compact_frac: float = 0.5
    greedy_score_max_rows: int = 640
    attack_text_bucket: Optional[bool] = None
    eval_text_bucket: Optional[bool] = None
    train_text_bucket: Optional[bool] = None
    greedy_text_bucket: bool = True
    graceful_preemption: bool = True
    preempt_sync_every: int = 16
    dropout_impl: str = "rbg"
    block_layout: str = "3d"
    image_dtype: str = "uint8"
    compute_dtype: str = "bfloat16"
    queue_dtype: str = ""
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    zero1: bool = False
    remat_blocks: Optional[bool] = None
    remat_policy: str = "full"  # "full" | "dots" (save matmul outputs)
    pgd_remat: Optional[bool] = None
    pgd_kernel_impl: str = ""
    fuse_moco_views: bool = False
    host_prefetch: bool = True
    log_every_n_steps: int = 10

    # ---------------------------------------------------------------
    @property
    def per_step_bs(self) -> int:
        """Global per-optimizer-step batch (reference vilt_module.py:73)."""
        return self.num_devices * self.num_nodes * self.per_device_batchsize

    @property
    def grid_hw(self) -> Tuple[int, int]:
        """Static patch-grid dims of the padded canvas."""
        h, w = self.image_bucket_hw
        return h // self.patch_size, w // self.patch_size

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_hw
        return gh * gw

    @property
    def image_seq_len(self) -> int:
        """Image tokens incl. CLS after (optional) static patch selection."""
        n = self.num_patches
        if self.max_image_len and self.max_image_len > 0:
            n = min(n, self.max_image_len)
        return n + 1

    @property
    def text_seq_len(self) -> int:
        return self.max_text_len

    @property
    def seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    def replace(self, **kw) -> "RMCLConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Named presets — mirror reference vilt/config.py:119-471 one-for-one.
# Each maps to a dict of overrides applied on top of the base config.
# ---------------------------------------------------------------------------

_ATTACK_DEFAULTS = dict(
    adv_steps_img=5,
    adv_lr_img=0.05,
    adv_max_norm_img=0.005,
    n_candidates=5,
    max_loops=10,
    sim_thred=0.5,
    cos_sim=True,
    synonym="cos_sim",
)

NAMED_CONFIGS: Dict[str, Dict[str, Any]] = {
    # reference vilt/config.py:119-124
    "env_dandelin": dict(num_devices=8, num_nodes=1),
    # reference vilt/config.py:128-164
    "task_moco": dict(
        exp_name="moco",
        datasets=("coco",),
        multimodal=True,
        num_negative=65536,
        momentum=0.999,
        temperature=0.07,
        augmentation=False,
        num_beams=5,
        num_return_sequences=5,
        loss_names=loss_names({"moco": 1}),
        batch_size=128,
        max_epoch=1,
        max_image_len=200,
        **_ATTACK_DEFAULTS,
    ),
    # reference vilt/config.py:166-199
    "task_barlowtwins": dict(
        exp_name="barlowtwins",
        datasets=("coco",),
        multimodal=True,
        augmentation=False,
        loss_names=loss_names({"barlowtwins": 1}),
        adv_lr=0.0051,
        batch_size=128,
        max_epoch=1,
        max_image_len=200,
        **_ATTACK_DEFAULTS,
    ),
    # reference vilt/config.py:201-209
    "task_mlm_itm": dict(
        exp_name="mlm_itm",
        datasets=("coco",),
        loss_names=loss_names({"itm": 1, "mlm": 1}),
        batch_size=4096,
        max_epoch=10,
        max_image_len=200,
    ),
    # reference vilt/config.py:212-220
    "task_mlm_itm_randaug": dict(
        exp_name="mlm_itm_randaug",
        datasets=("coco", "vg", "sbu", "gcc"),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"itm": 1, "mlm": 1}),
        batch_size=4096,
        max_epoch=10,
        max_image_len=200,
    ),
    # reference vilt/config.py:223-230
    "task_mlm_itm_mpp": dict(
        exp_name="mlm_itm_mpp",
        datasets=("coco", "vg", "sbu", "gcc"),
        loss_names=loss_names({"itm": 1, "mlm": 1, "mpp": 1}),
        batch_size=4096,
        max_epoch=10,
        max_image_len=200,
    ),
    # reference vilt/config.py:233-243
    "task_finetune_nlvr2": dict(
        exp_name="finetune_nlvr2",
        datasets=("nlvr2",),
        loss_names=loss_names({"nlvr2": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
    ),
    # reference vilt/config.py:245-256
    "task_finetune_nlvr2_randaug": dict(
        exp_name="finetune_nlvr2_randaug",
        datasets=("nlvr2",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"nlvr2": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
    ),
    # reference vilt/config.py:258-287
    "task_finetune_nlvr2_randaug_attacked": dict(
        exp_name="finetune_nlvr2_randaug_attacked",
        datasets=("nlvr2",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"nlvr2_attacked": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        attack_idx=(True, True),
        **_ATTACK_DEFAULTS,
    ),
    # reference vilt/config.py:289-301
    "task_finetune_vqa": dict(
        exp_name="finetune_vqa",
        datasets=("vqa",),
        loss_names=loss_names({"vqa": 1}),
        batch_size=256,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        val_check_interval=0.1,
        lr_mult=10,
    ),
    # reference vilt/config.py:304-317
    "task_finetune_vqa_randaug": dict(
        exp_name="finetune_vqa_randaug",
        datasets=("vqa",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"vqa": 1}),
        batch_size=256,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        val_check_interval=0.1,
        lr_mult=10,
    ),
    # reference vilt/config.py:319-347
    "task_finetune_vqa_randaug_attacked": dict(
        exp_name="finetune_vqa_randaug_attacked",
        datasets=("vqa",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"vqa_attacked": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        draw_false_image=0,
        learning_rate=1e-4,
        val_check_interval=0.1,
        lr_mult=10,
        **_ATTACK_DEFAULTS,
    ),
    # reference vilt/config.py:349-360
    "task_finetune_irtr_coco": dict(
        exp_name="finetune_irtr_coco",
        datasets=("coco",),
        loss_names=loss_names({"itm": 0.5, "irtr": 1}),
        batch_size=256,
        max_epoch=128,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=15,
        learning_rate=1e-4,
    ),
    # reference vilt/config.py:363-375
    "task_finetune_irtr_coco_randaug": dict(
        exp_name="finetune_irtr_coco_randaug",
        datasets=("coco",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"itm": 0.5, "irtr": 1}),
        batch_size=128,
        max_epoch=2,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=15,
        learning_rate=1e-4,
    ),
    # reference vilt/config.py:377-406
    "task_finetune_irtr_coco_randaug_attacked": dict(
        exp_name="finetune_irtr_coco_randaug_attacked",
        datasets=("coco",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"itm": 0.5, "irtr_attacked": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=15,
        learning_rate=1e-4,
        test_only=True,
        attack_idx=(False, True),
        **{**_ATTACK_DEFAULTS, "max_loops": 4},
    ),
    # reference vilt/config.py:408-419
    "task_finetune_irtr_f30k": dict(
        exp_name="finetune_irtr_f30k",
        datasets=("f30k",),
        loss_names=loss_names({"itm": 0.5, "irtr": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=15,
        learning_rate=1e-4,
    ),
    # reference vilt/config.py:422-434
    "task_finetune_irtr_f30k_randaug": dict(
        exp_name="finetune_irtr_f30k_randaug",
        datasets=("f30k",),
        train_transform_keys=("pixelbert_randaug",),
        loss_names=loss_names({"itm": 0.5, "irtr": 1}),
        batch_size=128,
        max_epoch=10,
        max_steps=None,
        warmup_steps=0.1,
        get_recall_metric=True,
        draw_false_text=15,
        learning_rate=1e-4,
    ),
    # reference vilt/config.py:440-461
    "step25k": dict(max_epoch=100, max_steps=25000),
    "step50k": dict(max_epoch=100, max_steps=50000),
    "step100k": dict(max_epoch=100, max_steps=100000),
    "step200k": dict(max_epoch=200, max_steps=200000),
    # reference vilt/config.py:464-471
    "vit32_base": dict(
        vit="vit_base_patch32_384",
        patch_size=32,
        hidden_size=768,
        num_heads=12,
        num_layers=12,
    ),
}


def named_configs() -> List[str]:
    return sorted(NAMED_CONFIGS.keys())


# ------------------------------------------------------------- ViT presets
def _vit_geometry(patch: int, dim: int, depth: int, heads: int, size: int,
                  mlp: int = 4) -> Dict[str, Any]:
    # static canvas from the MinMax /32 math: shorter side = size,
    # longer = floor(1333/800 * size) floored to /32
    # (data/transforms.py:min_max_size; reference utils.py:5-27)
    longer = int((1333 / 800) * size) // 32 * 32
    return dict(patch_size=patch, hidden_size=dim, num_layers=depth,
                num_heads=heads, mlp_ratio=mlp, image_size=size,
                image_bucket_hw=(size, longer))


# Named ViT geometries — the reference registers ~25 timm factories
# (reference vision_transformer.py:926-1383) though its named configs only
# ever instantiate vit_base_patch32_384 (config.py:464-471).
# `build_config(vit=<name>)` fills in any geometry key not explicitly set;
# named configs and keyword overrides always win.  The in21k variants share
# their base geometry (only the pretraining data differs); hybrid-resnet
# backbones and the distillation-token variants are different architectures
# and are not reproduced (dead code in the reference).
VIT_PRESETS: Dict[str, Dict[str, Any]] = {
    # reference vision_transformer.py:927 — "custom small": d8 h8 mlp3
    "vit_small_patch16_224": _vit_geometry(16, 768, 8, 8, 224, mlp=3),
    "vit_base_patch16_224": _vit_geometry(16, 768, 12, 12, 224),
    "vit_base_patch32_224": _vit_geometry(32, 768, 12, 12, 224),
    "vit_base_patch16_384": _vit_geometry(16, 768, 12, 12, 384),
    "vit_base_patch32_384": _vit_geometry(32, 768, 12, 12, 384),
    "vit_large_patch16_224": _vit_geometry(16, 1024, 24, 16, 224),
    "vit_large_patch32_224": _vit_geometry(32, 1024, 24, 16, 224),
    "vit_large_patch16_384": _vit_geometry(16, 1024, 24, 16, 384),
    "vit_large_patch32_384": _vit_geometry(32, 1024, 24, 16, 384),
    "vit_base_patch16_224_in21k": _vit_geometry(16, 768, 12, 12, 224),
    "vit_base_patch32_224_in21k": _vit_geometry(32, 768, 12, 12, 224),
    "vit_large_patch16_224_in21k": _vit_geometry(16, 1024, 24, 16, 224),
    "vit_large_patch32_224_in21k": _vit_geometry(32, 1024, 24, 16, 224),
    # DeiT geometries (reference vision_transformer.py:1278-1323)
    "vit_deit_tiny_patch16_224": _vit_geometry(16, 192, 12, 3, 224),
    "vit_deit_small_patch16_224": _vit_geometry(16, 384, 12, 6, 224),
    "vit_deit_base_patch16_224": _vit_geometry(16, 768, 12, 12, 224),
    "vit_deit_base_patch16_384": _vit_geometry(16, 768, 12, 12, 384),
}


def build_config(*names: str, **overrides: Any) -> RMCLConfig:
    """Compose named presets left-to-right, then apply keyword overrides.

    Mirrors Sacred's `with name1 name2 key=value` composition order
    (reference run.py / vilt/config.py:437).
    """
    merged: Dict[str, Any] = {}
    for name in names:
        if name not in NAMED_CONFIGS:
            raise KeyError(
                f"Unknown named config {name!r}; available: {named_configs()}"
            )
        merged.update(NAMED_CONFIGS[name])
    merged.update(overrides)
    # `vit` name fills in geometry keys not explicitly set anywhere
    vit_name = merged.get("vit")
    if vit_name is not None and vit_name != RMCLConfig.vit:
        if vit_name not in VIT_PRESETS:
            raise KeyError(
                f"Unknown vit preset {vit_name!r}; available: "
                f"{sorted(VIT_PRESETS)}")
        for k, v in VIT_PRESETS[vit_name].items():
            merged.setdefault(k, v)
    # normalize container types
    for k in ("datasets", "train_transform_keys", "val_transform_keys",
              "type_txt_augm", "attack_idx", "image_bucket_hw",
              "mesh_shape", "mesh_axis_names"):
        if k in merged and isinstance(merged[k], list):
            merged[k] = tuple(merged[k])
    return RMCLConfig(**merged)


def active_tasks(cfg: RMCLConfig) -> List[str]:
    """Tasks with loss weight >= 1 (reference vilt_utils.py:325-329)."""
    return [k for k, v in cfg.loss_names.items() if v >= 1]
