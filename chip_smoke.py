"""Smoke run of the PyTorch port on one NVIDIA GPU: the serving path, the PGD
image attack and the task_moco training step under the three block
configurations (``attention_impl`` / ``mlp_impl``, ``models/vilt.py:
derive_block_impls``): the default ("fused", "fused_train"), P ("pallas": the
unfused block around the attention-core kernels) and F ("fused", "fused":
``attn_half_full`` with its full backward, the plain MLP); then the greedy
text attack and the attacked task_moco step; then the training entry point
around it, the Trainer (phase 15), the main path; then the same for
task_barlowtwins (phase 16): its attacked step, its fp32 check against the
CPU and its Trainer; then the downstream tasks (phase 17): the attacked VQA
and NLVR2 steps, the IRTR step, their fp32 checks, the VQA submission
writer and the recall; then the pretraining tasks (phase 18): the
task_mlm_itm_mpp step, MPPD / MPFR, the fp32 check and the task_mlm_itm
Trainer with the head graft; then the benign views and the remaining paths
(phase 19): the augmentation=True steps and Trainer, standalone MoCo, the
cross-entropy NLVR2 attacker, the HWC canvas, the native host libraries and
their fp32 checks; then the rest of the one-card paths (phase 20): the demos,
the golden replay, the timm loader and the learning runs; then distribution
(phase 21): the attacked step with a one-rank NCCL group, and two ranks; then
tensor parallelism (phase 22): the sharded block's ops at the shard shapes,
and two ranks of a (data, model) grid of (1, 2), configurations P and F
among them; then the AOT serving artifact (phase 23): exported on the host,
served on the card.

    python3 chip_smoke.py

Run from the root of the repository.  ViLT-B/32 at full width and depth
(C=768, 12 layers, 12 heads, patch 32, bucket 384x608, bf16 compute) with
seeded random weights: ``task_finetune_vqa`` for serving (S = 40 + 229 =
269, 3129 VQA labels, u8 wire) and ``task_moco`` for the attack
(max_image_len 200 so S = 40 + 201 = 241, 16 pairs, queue 65,536 x 128,
adv_steps_img 5, adv_lr_img 0.05, adv_max_norm_img 0.005, temperature 0.07)
and for the training step (the same, image and text views on, drop_rate 0.1,
momentum 0.999, AdamW at 1e-4 with warmup 0 so that the first update moves).
Phases, any failure exits non-zero:

  1. device    a CUDA device, its name and power limit (nvidia-smi)
  2. build     nvcc builds rmcl_tpu_torch/csrc for sm_90a; ptxas' registers,
               shared memory and spills per kernel; cuobjdump -sass must show
               HGMMA (wgmma) and UTMALDG (TMA loads) and no HMMA in each of the
               six bf16 GEMM kernels (ln_gemm, gemm_tn: csrc/hopper_gemm.cuh),
               and HGMMA in each of the two bf16 attention-forward kernels
               and the eight bf16 attention-backward kernels
               (csrc/hopper_attention.cuh: fwd with D padded to 64 or 128;
               dq and dkv, kRound or not, D padded to 64 or 128), with no
               spills at D = 64; the five fp32 GEMM kernels
               (csrc/simt_gemm.cuh: ln_gemm by weight layout and tile width,
               gemm_tn) and the fifteen fp32 attention kernels
               (csrc/simt_attention.cuh: the forward at D compiled as 32, 64
               and 128; bwd_dq and bwd_dkv, kRound or not, at the three
               widths) must be FFMA kernels with LDS.128 reads, no HMMA or
               HGMMA (no TF32), and spill nothing
  3. kernels   each op against its plain version on the same inputs, random
               key mask: attn_half and mlp_half at B=8, S=269 (serving) and,
               in bf16, at B=16, S=241 (the attack); attn_half_dx and
               mlp_half_dx, recomputing and from the saved qkv / h, at
               B=16, S=241 with a random g; in bf16 the four at B=80,
               S=217, the greedy attack's scoring batch (16 pairs x 5
               candidates, text bucket 16).  fp32 (TF32 off) error
               <= 2e-4 * max(1, max|ref|), bf16 error <= 2e-2 * max|ref|.
               Kernel and plain times are the median of 20 after warm-up,
               CUDA events.  Each op's bound is worked out from these shapes
               (bytes over 3.35 TB/s against operations over 989 TFLOP/s
               bf16).  The GEMM sub-kernels as the step runs them (M = 16 x
               241: qkv and fc1 with the LayerNorm, fc1 with GELU and
               dropout, proj and fc2 with the residual, the (K, N) dx
               products, the four weight gradients) against their plain
               versions (_gemm_plain, _gemm_tn_plain: bf16 2e-2 of max|ref|,
               masks bit for bit, gemm_tn bit-identical twice), each with its
               bound, its time per call (time_ms) and its device time
               (torch.profiler, no host share), beside the one PyTorch call
               of its product (F.linear, torch.matmul(g, W),
               torch.matmul(A.t(), B)); the bf16 attention forward on the
               packed layout (rows 1, 8, 2) against mha on the same heads,
               bit-identical twice, with its bound, time per call and device
               time beside F.scaled_dot_product_attention's; the bf16
               attention backward pair on the packed layout (rows 3, 9, 2) against
               _attn_dqkv_plain with Wproj = I, bit-identical twice, with its
               bound, time per call and device time beside the backward of
               F.scaled_dot_product_attention; the LayerNorm backward ln_bwd
               in its dx-only and training forms at M = 16 x 241, C = 768 with
               + g against _ln_backward_plain, and the column sums colsum at
               N = 768, 2304 and 3072 against _colsum_plain, bf16 and fp32
               (fp32 outputs within 1e-5 of max(1, max|ref|), bf16 dx and y
               within one bf16 ulp of max|ref|), bit-identical twice, each
               with its byte bound, time per call and device time beside
               torch.ops.aten.native_layer_norm_backward on fp32 copies (the
               nearest call: no + g, no y) and a.sum(0, dtype=float32).  The
               port never calls them.  The fp32 FMA GEMMs (ln_gemm_f32 with
               ln_stats, gemm_tn_f32): every instance above in fp32 at M =
               3,856, at the fp32 parity steps' ragged M (2 x 241, 3 x 37)
               and, for ln_gemm, at the scoring forward's M = 80 x 217,
               against their plain versions (2e-4 of max(1, max|ref|), the
               pre-GELU value likewise, masks bit for bit), bit-identical
               twice; at 3,856 and 17,360 by device time beside F.linear /
               torch.matmul in fp32 (TF32 off).  The fp32 attention kernels
               (csrc/simt_attention.cuh: the forward and the bwd_dq ->
               bwd_dkv pair) at B=8 S=269, B=16 S=241, B=80 S=217 and the
               two-way shard (6 heads), in the packed layout (against mha
               and _attn_dqkv_plain with Wproj = I) and on head views
               (against mha and masked_attention_bwd_plain), 2e-4 of max(1,
               max|ref|), bit-identical twice; at B=16 S=241 by device
               time beside F.scaled_dot_product_attention and its backward
               in fp32.  attn_half and mlp_half at the demos' B=1, S=402
               (fp32 and bf16, bit-identical twice, beside their bound); the
               attention kernels at H=8, D=96 (vit_small_patch16_224's heads,
               padded to 128) at B=16, S=349, bf16 and fp32, packed and on
               head views, bit-identical twice, the packed pair by device
               time beside its bound; ln_stats_kernel (the fp32 ln_gemm's
               row statistics) at M = 3,856 and 17,360, C = 768, its (mean,
               rstd) against torch.var_mean's, bit-identical twice, by device
               time beside its byte bound and torch.var_mean's.  Every fp32 reading (the ops
               above and these kernels) beside its fp32 bound: bytes at 4 B per
               element over 3.35 TB/s against FLOPs over the CUDA cores'
               fp32 FMA rate (67 TFLOP/s).
               The training ops at B=16, S=241, fp32 and bf16, p = 0.1 and
               p = 0: attn_half_train and mlp_half_train, and their backwards
               on the forward's kept tensors with a random g, every output
               against its plain version (each relative to its own max); the
               masks the kernels emit, forward and backward, equal
               philox.keep_mask bit for bit, keep rate within 0.002 of 0.9;
               two backward calls give identical bits.
               The ops of configurations P and F at B=16, S=241, fp32 and
               bf16: masked_attention (row 10) and its backward (row 11) on
               the heads of the block's qkv projection, beside
               F.scaled_dot_product_attention and its backward through
               torch.autograd.grad, in bf16 and in fp32 (both by device time
               too);
               attn_half_full and its backward (row 2), seven outputs
               bit-identical twice; the dropout op at (S, 4C),
               the plain version's bits exactly; attn_half and mlp_half at a
               two-way tensor-parallel shard's shapes (row 14: 6 heads, qkv
               768 -> 3 x 384, proj 384 -> 768, fc1 768 -> 1536).
  4. serving   a batch-8 Session answers 20 synthetic wire-format requests
               (last chunk short: padded); every block of every forward must
               go through both kernels (launch counters); outputs finite
  5. slice     the first 4 requests on the CPU in fp32 through the plain ops
               vs the card: fp32 kernels (VQA logits within
               1e-3 * max(1, max|ref|)) and bf16 kernels (cls_feats cosine
               >= 0.99 per request)
  6. pgd       make_pgd_moco(fast=True), 5 steps in bf16 on 16 synthetic
               pairs (ragged valid image sizes, padded text), keys from
               infer_k + k_moco_head, a seeded normalised queue.  Launch
               counters: 12 x 5 of each of the four ops, so every block
               forward and backward went through the kernels.  delta finite,
               0 < max|delta| <= 0.005 + 1e-6, zero on padding and unselected
               patches; InfoNCE of image + delta above the clean image's.
               Time per attack and per iteration (median of 3, host clock
               around the attack + synchronize).
  7. pgd slice 4 pairs in fp32: the CPU through the plain ops against the
               card's fp32 kernels, delta after 5 steps within 2.5e-4 (5% of
               the Linf bound) everywhere and within 1e-5 on at least 99% of
               the elements; and make_pgd_vqa for one step on phase 5's
               task_finetune_vqa models, same check.  Each step adds
               adv_lr * g / max|g| and clips, so an error in g moves an
               unclipped component by 0.05 times its relative size, and a
               near-tie for max|g| changes the divisor by that same relative
               amount: there is no discontinuity to special-case.  Where g
               is within its own error of 0 the sign may differ, which the
               small per-step size bounds (hence the two-part tolerance).

  8. train     create_train_state + make_train_step for task_moco, bf16, 16
               pairs with seeded attacked ids (three tokens of each caption
               substituted), one warm-up step and three timed.  Per step the
               launch counters read 48 of each training forward (12 x 4
               views), 36 of each training backward (12 x 3 views), 72 of
               each deterministic forward (12 key encoder + 60 attack) and 60
               of each dx op; every loss finite; every trainable parameter
               moved (but the unused mask_token) and no twin by more than the
               momentum step allows; the queue pointer advanced by 16 and the
               written columns equal the step's keys.  Step time (median of
               3, host clock + synchronize), pairs/s, the split by CUDA
               events into key forward / attack / views / optimizer, and
               max_memory_allocated.  The launch counters also read 14 of the
               dropout op (the embedding dropouts: text and image, four views
               forward, three backward) and 0 of every other op.
  9. train slice  one step of 4 pairs in fp32 at full width, 3 of the 12
               layers (SLICE_LAYERS; phase 16 holds all 12): the card's
               kernels against the CPU's plain ops from the same weights,
               batch and dropout seeds (so the same masks): loss within 1e-5
               relative; every gradient, updated parameter, twin and the
               queue within 2e-4 * max(1, max|ref|); the pointer equal.  An
               AdamW step moves an element by at most the rate (1e-4), so the
               share of elements within 2% of the rate is printed beside it.
               The card step's sub-kernels (the fp32 GEMMs and attention)
               follow its ops' launch counters (expected_sub_launches), the
               attention kernels launched at least once.
 10. train P, train F   phase 8 under configurations P and F.  Per step, P:
               masked_attention 120 (12 key forward, 60 PGD, 48 views),
               masked_attention_bwd 96, mlp_half 72, mlp_half_dx 60,
               mlp_half_train 48, mlp_half_train_bwd 36, dropout 98, every
               attn_half* op 0; F: attn_half 72, attn_half_dx 60,
               attn_half_full 48, attn_half_full_bwd 36, mlp_half 72,
               mlp_half_dx 60, dropout 266, every training op 0.
 11. train slice P, train slice F   phase 9 under P and F.
 12. greedy    the fused greedy word-substitution attack
               (attacks/greedy_fused.py on GreedyAttackMoco), bf16, 16 pairs,
               n_candidates 5, max_loops 10, against the post-EMA keys
               (attacks/greedy.py:greedy_attack_extras) and the seeded queue of
               65,536, on two caption mixes copied from bench.py:
               _greedy_setup (its synthetic vocabulary and 32-dimensional
               vectors; the real counter-fitted vectors are not in the
               repository): "worst", ten attackable words, and "realistic",
               content words alternating with function words.  Checks: every
               changed word a synonym candidate of the word it replaced, the
               changed words a sample's commits, none over min(int(0.2 *
               (sub-tokens + 1)), max_loops); some change in the worst mix;
               the launch counters equal the attack's own count (12 of
               attn_half, mlp_half, attn_half_dx and mlp_half_dx per gradient
               pass, 12 of attn_half and mlp_half per scoring forward) and
               the sub-kernels follow (expected_sub_launches).  Prints the
               loops, gradient passes, scoring forwards, host reads and the
               attack's time (median of 3, host clock + synchronize).
 13. train attacked worst, train attacked realistic   make_attacked_train_step
               with the default configuration, bf16, 16 pairs, the mix's
               captions and tables: phase 8's checks, the launch counters
               adding the attack's own count, num_changes and change_rate
               finite; step ms, pairs/s, the split (key forward, greedy
               attack, PGD, views, AdamW) by CUDA events, memory.
 14. train attacked slice   one fp32 attacked step of 4 pairs on the
               realistic captions at 3 layers (SLICE_LAYERS), the card's
               kernels against the CPU's plain ops from the same weights,
               batch and dropout seeds: the
               attacked token ids equal; where they differ, the first decision
               that parts (the pick, the best candidate or the commit) and its
               margin are printed, and it must be a tie within 2e-4 *
               max(1, |value|) (the rest of the step then runs on the CPU's
               ids); then phase 9's tolerances for the loss, gradients,
               updated leaves, twins and queue.
 15. trainer   the training entry point, the main path: Trainer.setup() /
               fit() / validate() (train/loop.py) as ``python -m
               rmcl_tpu_torch.cli.run with task_moco`` runs it, on the
               card: phase 13's configuration, batch_size 32 at
               per_device_batchsize 16 (accum 2), max_steps 3 optimizer
               steps (6 micro-steps), one validation batch of 16.  The data:
               a MultitaskDataModule whose datasets are in memory in the
               arrow dataset's sample format (the card's machine has no
               pyarrow or PIL): seeded ragged u8 images, phase 12's worst-mix
               captions, its vocabulary and vectors as files; the port's
               loader, collate, MLM collator, prefetch thread, attacked step,
               eval step, logger and CheckpointManager run as they are.  The
               timed run: its launches equal each micro-step's
               expected_launches and its attack's, plus the validation
               batch's expected_eval_launches and its attack's (the counts
               set to 0 just before, read just after: the kernels record's
               ``launches``); ms per micro-step (median after the first
               cycle), pairs/s, max_memory_allocated and host reads per
               micro-step beside phase 13's bare step; 'last' loads into a
               fresh ViLT with every tensor equal.  Then a run preempted
               (request_preemption) after micro-step 3, mid-cycle, and a new
               Trainer resuming it (resume_from): each micro-step's launches,
               the parameters unchanged mid-cycle and all moved at a cycle's
               end, the k_transformer twins moved every micro-step; the
               per-step losses and the final parameters and buffers equal
               the timed run's within 1e-6 relative (the largest difference
               printed).  Checkpoints go to chip_smoke_trainer.tmp/, removed
               at the end.
 16. bt attacked worst, bt attacked realistic, bt attacked slice, bt trainer
               task_barlowtwins at full width and depth (phase 13's model
               and mixes, bt_proj_dims (8192, 8192, 8192), lambda = adv_lr
               0.0051, 5-step PGD, the fused greedy attack on
               GreedyAttackBarlowTwins, drop_rate 0.1, AdamW 1e-4), bf16, 16
               pairs: make_attacked_train_step, one warm-up and three timed
               steps per mix; per step the launch counters equal
               expected_launches (three training views forward and
               backward) plus the attack's own, each loop's scoring forward
               all 80 rows (no compaction, no chunks); every parameter and
               every BatchNorm running statistic moved, finite, variances
               positive; step ms, pairs/s, the split by CUDA events (key
               forward, greedy attack, PGD, views, AdamW), the attack's
               loops, passes, scoring forwards and host reads, memory.  PGD
               alone and the greedy attack alone leave the running
               statistics as they were.  One fp32 attacked step of 4 pairs
               on the card and on the CPU: the token ids as phase 14 holds
               them and the loss within 1e-5 relative; then the card's step
               again on the CPU's ids, cut at the head's input (HeadSeam:
               the head fed the CPU's class features, the encoder below it
               the CPU's gradient, call by call): the card's class features
               at every head call, the gradients, parameters and running
               statistics within 2e-4 * max(1, max|ref|) of the CPU's; the
               first projection's spread over the rows printed beside it.  The
               Trainer for task_barlowtwins, one optimizer step (accum 2) on
               phase 15's in-memory data: launches, every parameter and
               statistic moved, micro-step 0's ms beside the bare step,
               'last' loads back equal, running statistics included.
 17. downstream   the downstream tasks at full width and depth, bf16, every
               patch (S = 40 + 229), image and text views, drop_rate 0.1,
               seeded weights: make_attacked_train_step for
               task_finetune_vqa_randaug_attacked and
               task_finetune_nlvr2_randaug_attacked on 16 pairs, both caption
               mixes (the fused greedy attack on GreedyAttackVqa /
               GreedyAttackNlvr2 with compaction, 5-step PGD, NLVR2 on two
               images), and make_train_step for task_finetune_irtr_coco on
               8 images x 16 texts: one warm-up and two timed steps each,
               per step the launch counters equal downstream_launches (the
               attack's own count, two forwards a pass for NLVR2) and the
               sub-kernels follow, every metric finite, every parameter the
               loss reaches moved; step ms (host clock), device busy ms
               (torch.profiler, one step), memory, the attack's loops and
               host reads, NLVR2's flip rate.  One fp32 step of each at
               SLICE_LAYERS on the card and on the CPU (4 pairs; IRTR one
               image x 16 texts): attacked_slice's token ids, then
               _train_results' tolerances.  Trainer.validate("test") of the
               attacked VQA config on 16 questions in memory writes the
               submission file (one answer per question).  The clean and the
               attacked IR/TR recall (compute_irtr_recall,
               compute_attacked_irtr_recall with the fused greedy IRTR
               attack and PGD) on 8 images x 5 captions in memory, irtr
               beside irtr_attacked: finite scores, recalls in [0, 1],
               seconds per image, launches.

 18. pretrain   the pretraining tasks at full width and depth, bf16,
               max_image_len 200 (S = 40 + 201), drop_rate 0.1, u8 wire, the
               MLM collator's masked text, seeded weights: make_train_step for
               task_mlm_itm_mpp on 16 pairs with false_image_0, one warm-up and
               three timed steps: per step the launch counters equal
               pretrain_launches (three training forwards: rows 8, 9, 6, 7 x 12
               each, four embedding dropouts a forward) and the sub-kernels
               follow, one IPOT solve of 50 rounds (objectives/ot.py's
               counter), 8 ITM positives, every metric finite, every parameter
               reached and moved (mask_token, mpp_score, mlm_score, itm_score
               among them); step ms (host clock), device busy (torch.profiler,
               one step), pairs/s, memory; one IPOT solve at the step's shapes
               by torch.profiler (kernel launches beside the derived 13 a
               round, device time).  One step with mppd and mpfr beside them
               (five forwards): finite, their heads moved.  One fp32 step of 4
               pairs at SLICE_LAYERS on the card and on the CPU from one
               generator: the same draws, _train_results' tolerances, MPP's
               labels equal but at a truncation boundary (within 1e-4 of an
               integer).  task_mlm_itm through the Trainer on 32 + 16 pairs in
               memory (accum 2, one optimizer step, then validate()):
               launches as derived, mlm_accuracy and itm_accuracy in [0, 1];
               its weights from a synthetic load_path with the MLM and ITM
               heads grafted from a synthetic
               models_weight/vilt_200k_mlm_itm.ckpt (load_initial_params),
               every grafted tensor equal.  The phase prints its seconds
               against its 45 s budget.
 19. views      the benign views (augmentation=True) and the rest of the
               port's host and objective paths, at full width and depth,
               bf16: the task_moco step (make_train_step, 16 pairs, S = 40 +
               201, drop_rate 0.1) on EDA text views of phase 12's worst
               captions (data/augmentation.py, global random seeded) and a
               STAND-IN image view (seeded fp32 384 x 384 pixels in the 384 x
               608 canvas: SimCLRTransform needs PIL, which the card's machine
               lacks), a warm-up and three timed steps: launches as
               benign_launches derives them (no dx op, rows 3 and 5; no "both"
               view, no PGD), finite metrics, every trained parameter moved,
               twins within the momentum step, the pointer; step ms, device
               busy, memory, EDA host ms per 16 captions; one task_barlowtwins
               benign step with the same checks and its running statistics
               moved; the Trainer with augmentation=True and image_view=False
               on phase 15's in-memory data (one optimizer step of two
               micro-steps, one validation batch): TextAugmentation and no
               attacker, launches as derived, every parameter moved;
               standalone MoCo (objectives/moco_standalone.py) at K = 65,536
               with a 5-step PGD of the image query: launches, finite losses,
               pointer + 32, the projectors' gradients and an AdamW step; the
               cross-entropy NLVR2 attacker (GreedyAttackNlvr2CrossEntropy) on
               8 pairs of phase 17's NLVR2 model: ms, loops, launches; a
               serving forward of 8 requests as the u8 HWC canvas equal bit
               for bit to the patch-row one; both native libraries built with
               g++ and loaded, the C++ token ids equal the Python path's and
               the C++ patch-row scatter the numpy relayout, with host ms of
               each; fp32 at SLICE_LAYERS on 2 pairs, card against CPU: the
               benign step (_train_results' tolerances), standalone MoCo with
               a 2-step PGD (loss within 1e-5 relative, gradients, twins and
               queues within 2e-4 x max(1, max|ref|)), the CE attacker's token
               ids after 2 loops equal.  The phase prints its seconds against
               its 45 s budget.
 20. rest      the remaining one-card paths, full width unless said: the
               demos (demos/demo.py and demo_vqa.py's build_engine from seeded
               checkpoints, S = 19 x 19 + 1 + 40 = 402, B = 1, bf16, default
               blocks, a seeded stand-in canvas for prepare_image: no PIL on
               the card's machine): mlm_fill with two masks, wpa_heatmap and
               answer, ms per call, launches as derived; then at SLICE_LAYERS
               in fp32, card against the CPU's plain engine: the same fills
               (a differing pick only at a tie within 2e-4 x max(1, p)), the
               heatmap within 1e-4, the answers' names and probabilities
               within 1e-6, cls_feats within 1e-3 x max(1, max|ref|); a golden
               file written by the CPU's plain fp32 infer (task_mlm_itm at
               vit32_base, the 384 x 384 HWC canvas, B = 1) replayed on the
               card's fp32 kernels by compat/golden.py:compare_golden at 5e-3;
               a seeded synthetic timm dict through compat/timm.py into the
               default ViLT-B/32 (7 x 7 grid resized to 12 x 12) and into
               vit_small_patch16_224 (8 heads of D = 96): each a forward and
               a timed training step of 16 pairs in bf16, then an fp32 step
               of 2 pairs at SLICE_LAYERS against the CPU (_train_results);
               the seven learning families of tests/test_torch_convergence*.py
               at their tiny configurations on the fp32 kernels, 60 steps,
               their criteria, the first three losses against the CPU's; at
               full width in bf16 (16 pairs, one fixed batch, 30 steps at lr
               5e-4) task_mlm_itm with MLM only and task_finetune_vqa, the
               mean of the last five losses under half the first.  The phase
               prints its seconds against its 60 s budget.
 21. ddp       distribution (parallel/, train/step.py's global batch),
               after printing torch.cuda.device_count(): (a) phase 13's
               attacked task_moco step (16 pairs, bf16, worst captions),
               one warm-up and 3 timed steps with a one-rank NCCL group live
               (init_distributed on cuda:0) and without one, from the same
               state and generator: metrics, parameters, twins and queue bit
               for bit, the launches equal, ms per step beside phase 13's,
               the NCCL kernels' device time in one profiled step; (b) two
               ranks (chip_smoke.py --ddp-rank under torchrun, its deadline
               240 s: tests/_torch_ddp_worker.py:torchrun; NCCL on cuda:0 /
               cuda:1 with two cards, gloo with the CUDA tensors of cuda:0
               with one): the fp32
               attacked task_moco and task_barlowtwins steps at SLICE_LAYERS,
               2 ranks x 2 pairs, against one process on the same 4 pairs on
               the card (made by the ranks before they join the group,
               rank 0 BarlowTwins', rank 1 MoCo's, and compared there): loss
               within 1e-5 relative, gradients within 2e-4 x max(1,
               max|ref|), the updated leaves within 2% of the rate where the
               gradient is firm and 2.5 x the rate elsewhere (the CPU tests'
               _close_params), the attacked ids equal, the ranks
               bit-identical; BarlowTwins' gradients and leaves those of a
               second step on the one-process ids cut at the head's input
               (HeadSeam, as phase 16 cuts it: the one process's records
               replayed by the ranks); (c) the two ranks' Trainer.fit of
               task_moco at full width, bf16, 2 x 16 pairs per micro-step,
               accum 2, 2 optimizer steps: ms per micro-step beside phase
               15's, max_memory_allocated per rank, 'last' loaded into a
               fresh ViLT equal on both ranks.  The phase prints its seconds
               against its 75 s budget.
 22. tp        tensor parallelism (parallel/mesh.py, tp.py,
               sharding_rules.py; models/vit.py:Block under a model axis):
               (b) every op of the sharded block at Queue B row 14's shapes
               (6 of 12 heads, qkv 768 -> 1152, proj 384 -> 768 partial,
               fc1 768 -> 1536, fc2 1536 -> 768 partial; B = 16, S = 241),
               both shards (the first with the residual and the row-parallel
               biases, the second without, its in-MLP mask from column
               1536), fp32 and bf16, against its plain version: the forward
               halves, the dx halves (saved and recomputing), F's attention
               half and backward, the training halves forward and backward
               at p = 0.1, the masks equal keep_mask with the column offset
               bit for bit, P's attention core (masked_attention forward and
               backward on the shard's 6 heads, views of its qkv), the
               second shard's calls timed beside their bounds; then two
               ranks of a (1, 2) grid (chip_smoke.py --tp-rank under
               torchrun, its deadline 300 s; NCCL with two cards, gloo with
               the CUDA tensors of cuda:0 with one): (a) the fp32 attacked
               task_moco step of phase 21, a task_moco + MLM step (the
               30,522-row decoder sharded) and phase 11's fp32 task_moco
               steps of configurations P and F (drop_rate 0.1) at
               SLICE_LAYERS on the 4 pairs against one process on the card,
               phase 21's tolerances on the gathered gradients and leaves,
               the ids equal, the replicated entries bit-identical on both
               ranks; (c) phase 13's attacked step in bf16 at TP_LAYERS on
               both ranks against one process at the same depth: ms per
               step, max_memory_allocated per rank, the launches of a step
               as expected_launches derives them.  The phase prints its
               seconds against its 75 s budget.
 23. export    the AOT serving artifact (serve.py: export_inference,
               load_artifact, ArtifactSession): (a) phase 4's cell
               (task_finetune_vqa, 12 layers, bf16, u8 wire, batch 8)
               exported on the host (device="cpu"), saved, loaded onto the
               card: no parameter or constant inside, 12 rmcl.attn_half and
               12 rmcl.mlp_half nodes; phase 4's 20 requests in batches of 8
               equal the live Session's output on the same weights bit for
               bit; 12 + 12 launches per forward; batch-8 ms (median of 15)
               and requests/s of the artifact and the live Session in turns,
               beside phase 4's; the file's bytes; (b) an fp32 task_moco
               embed artifact (12 layers, batch 4) on the card against the
               same artifact on the CPU within 1e-3 * max(1, max|ref|); (c)
               phase 4's cell under configuration P at SLICE_LAYERS: one
               rmcl.masked_attention node a layer, launched on the card,
               equal to the live Session bit for bit.  The phase prints its
               seconds against its 60 s budget.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside the
repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --profile

runs phases 1 and 2 and then, in place of the checks, traces five serving
forwards, two attacks, two training steps under each configuration, two
attacked steps per caption mix, phase 15's Trainer over its second
accumulation cycle (micro-steps 2 and 3, the host loop between them
included) and two attacked task_barlowtwins steps per caption mix with
``torch.profiler`` and prints, for each, the device time by kernel name,
the device-busy and wall time per call, the idle share and the kernel
count, and for the attacked steps the greedy attack's loops and host reads
(the breakdowns of PERF.md section 5).

    python3 chip_smoke.py --downstream

runs phases 1, 2 and 17 only;

    python3 chip_smoke.py --pretrain

phases 1, 2 and 18 only;

    python3 chip_smoke.py --rest

phases 1, 2 and 20 only;

    python3 chip_smoke.py --views

phases 1, 2 and 19 only;

    python3 chip_smoke.py --ddp

phases 1, 2 and 21 only;

    python3 chip_smoke.py --tp

phases 1, 2 and 22 only;

    python3 chip_smoke.py --export

phases 1, 2 and 23 only.

    python3 chip_smoke.py --gemm-times [ROOT]

times the GEMM sub-kernels of the package under ROOT (default: this
checkout) at phase 3's shapes, bf16 and fp32, the attention forward and
backward through their four C entry points (rmcl_masked_attention_fwd,
rmcl_attention_fwd, rmcl_masked_attention_bwd, rmcl_attention_bwd) at B=16,
S=241, H=12, D=64, bf16 and fp32, beside F.scaled_dot_product_attention's
forward (and, fp32, its backward), and the
LayerNorm backward (_ln_bwd_dx, _ln_backward) and column sums (_colsum) at
M = 16 x 241 in bf16, per call, by device time and by host enqueue time;
then the attack under the default configuration and P, and one unattacked
fp32 task_moco step (16 pairs, 12 layers: wall and device busy, and the
device time of its three fp32 attention kernels by name), phase 4's serving
cell through the live Session and, where the package has one, its artifact
(batch-8 ms, requests/s, device ms a forward, and the host time of one
attn_half call beside its launch alone), and phase 13's attacked step
(realistic captions, wall ms), through arguments every slice of the port
shares: run it on two checkouts in one
call to compare their kernels on one card.  Every phase also checks the
sub-kernels' launch counters (the GEMMs, the bf16 attention forward and
backward, the LayerNorm backward and the column sums) against the ops'
(expected_sub_launches).
"""

from __future__ import annotations

import copy
import gc
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

CONFIG = "task_finetune_vqa"
BATCH = 8
N_REQUESTS = 20
N_CPU = 4
SEED = 0
PGD_CONFIG = "task_moco"
BT_CONFIG = "task_barlowtwins"
PGD_BATCH = 16
GREEDY_ROWS, GREEDY_S = 16 * 5, 16 + 201    # the greedy attack's scoring forward
KERNELS = {  # op -> the Pallas kernel body it replaces
    "attn_half": "rmcl_tpu/ops/pallas_block.py:112",
    "mlp_half": "rmcl_tpu/ops/pallas_block.py:526",
    "attn_half_dx": "rmcl_tpu/ops/pallas_block.py:336",
    "mlp_half_dx": "rmcl_tpu/ops/pallas_block.py:626",
    "attn_half_train": "rmcl_tpu/ops/pallas_block.py:1260",
    "attn_half_train_bwd": "rmcl_tpu/ops/pallas_block.py:1280",
    "mlp_half_train": "rmcl_tpu/ops/pallas_block.py:743",
    "mlp_half_train_bwd": "rmcl_tpu/ops/pallas_block.py:795",
    # the other block configurations: F's attention half (row 1's forward
    # without the residual, row 2's backward), P's attention core (rows 10, 11)
    "attn_half_full": "rmcl_tpu/ops/pallas_block.py:112",
    "attn_half_full_bwd": "rmcl_tpu/ops/pallas_block.py:317",
    "masked_attention": "rmcl_tpu/ops/pallas_attention.py:53",
    "masked_attention_bwd": "rmcl_tpu/ops/pallas_attention.py:119",
    # the dropout outside the kernels (XLA in the JAX package)
    "dropout": "rmcl_tpu/models/layers.py:68",
}
TRAIN_OPS = ("attn_half_train", "attn_half_train_bwd", "mlp_half_train", "mlp_half_train_bwd")
CONFIG_OPS = ("attn_half_full", "attn_half_full_bwd", "masked_attention", "masked_attention_bwd",
              "dropout")
# the block configurations the training phases run (models/vilt.py:derive_block_impls)
IMPLS = {"default": {}, "P": {"attention_impl": "pallas"},
         "F": {"attention_impl": "fused", "mlp_impl": "fused"}}
TRAIN_STEPS = 3
DROP_P = 0.1
SOURCE = "rmcl_tpu_torch/csrc/block_kernels.cu"
GEMM_SOURCE = "rmcl_tpu_torch/csrc/hopper_gemm.cuh"
GEMM_KERNELS = {  # sub-kernel -> the Pallas body whose products it carries (rows 1-9, 2, 14)
    "ln_gemm": "rmcl_tpu/ops/pallas_block.py:526",
    "gemm_tn": "rmcl_tpu/ops/pallas_block.py:795",
}
# the LayerNorm backward and the bias-gradient column sums of block_kernels.cu:
# (the Pallas body of the kernels record, every body whose sums they carry)
LN_COLSUM_KERNELS = {
    "ln_bwd": ("rmcl_tpu/ops/pallas_block.py:795",
               "the LayerNorm backward (dx, and dLN in training) of pallas_block.py "
               ":336 (row 3), :626 (row 5), :1280 (row 9), :795 (row 7, :864-889), "
               ":221 (row 2, :305-313)"),
    "colsum": ("rmcl_tpu/ops/pallas_block.py:795",
               "the bias-gradient sums of pallas_block.py :795 (row 7: db1, db2), "
               ":1280 (row 9: dbqkv, dbproj), :369 (row 2)"),
}
# the bf16 GEMM kernels (4 ln_gemm and 2 gemm_tn instances) the SASS check reads
GEMM_BF16_KERNELS = ("ln_gemm_bf16_kernel", "gemm_tn_bf16_kernel")
# the fp32 FMA GEMM kernels of csrc/simt_gemm.cuh (4 ln_gemm instances: weight
# layout x tile width; 1 gemm_tn)
GEMM_F32_KERNELS = ("ln_gemm_f32_kernel", "gemm_tn_f32_kernel")
# the bf16 attention kernels: the forward (2 instances: D padded to 64, 128)
# and the backward (8 instances: dq, dkv x kRound x D padded to 64, 128)
ATTN_SOURCE = "rmcl_tpu_torch/csrc/hopper_attention.cuh"
ATTN_PREFIX, ATTN_FWD = "_ZN5hattn", "fwd_kernel"
# the fp32 attention kernels: the forward (D compiled as 32, 64, 128) and the
# backward pair (dq, dkv; kRound or not; the three widths)
F32_ATTN_SOURCE = "rmcl_tpu_torch/csrc/simt_attention.cuh"
F32_ATTN_PREFIX = "_ZN2sa"
F32_ATTN_KERNELS = {"fwd_kernel": 3, "bwd_dq_kernel": 6, "bwd_dkv_kernel": 6}
PEAK_BYTES_S = 3.35e12      # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12    # H100 SXM tensor cores, dense bf16
# H100 SXM fp32 on the CUDA cores (the FMA kernels compute_dtype="float32"
# reaches): 128 FP32 lanes per SM x 132 SMs x 2 operations per FMA x 1.98 GHz
PEAK_FP32_FLOPS = 128 * 132 * 2 * 1.98e9
# H100 SXM 32-bit integer rate, the dropout's Philox work: 64 INT32 lanes per
# SM (NVIDIA's Hopper architecture white paper: 16 per SM sub-partition) x
# 132 SMs x the 1.98 GHz boost clock.  67e12, the fp32 rate with an FMA
# counted as two operations, is not the rate of integer instructions.
PEAK_INT32_OPS = 64 * 132 * 1.98e9
PHILOX_OPS = 100            # 32-bit operations of one Philox-4x32-10 word, mask and scale
DELTA_TOL, DELTA_TIGHT, DELTA_TIGHT_SHARE = 2.5e-4, 1e-5, 0.99


# figures of earlier phases that a later phase prints beside its own
READINGS: dict = {}


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


def _demangle(names: list) -> list:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        return out if len(out) == len(names) else names
    except OSError:
        return names


def phase_build() -> None:
    from rmcl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    print(f"[build] {path.name} in {secs:.1f} s (nvcc {_build.nvcc()})")
    # ptxas -v: registers, shared memory and spills of every kernel, by name
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            rows.append((name, ln.split(":", 1)[-1].strip()))
    for (_, info), pretty in zip(rows, _demangle([n for n, _ in rows])):
        print(f"[build] {pretty[:110]}: {info}")
    _sass_check(path, rows)


def _sass_check(path, ptxas_rows) -> None:
    """The bf16 GEMM kernels as built must be wgmma (HGMMA) fed by TMA
    (UTMALDG), with no legacy mma.sync (HMMA) left in them.  The fp32 GEMM
    kernels must be FFMA mainloops with 16-byte shared-memory reads (LDS.128)
    and no tensor-core instruction (HMMA, HGMMA: no TF32), and spill
    nothing.  The bf16
    attention kernels (hopper_attention.cuh: the forward, and the backward's
    dq and dkv, kRound or not; D padded to 64 or 128) must contain HGMMA, and
    those at D = 64 spill nothing (ptxas -v).  The fp32 attention kernels
    (simt_attention.cuh: the forward and the backward pair, every width and
    kRound) must be FFMA kernels with LDS.128 reads, no tensor-core
    instruction, and spill nothing."""
    import shutil
    from rmcl_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).with_name("cuobjdump"))
    proc = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr.strip()[:500]}")
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", proc.stdout)[1:]:
        fname, body = chunk.split("\n", 1)
        funcs[fname.strip()] = body
    gemm = sorted(n for n in funcs if any(k in n for k in GEMM_BF16_KERNELS))
    check(len(gemm) == 6, f"expected 6 bf16 GEMM kernels in the SASS, found {gemm}")
    for fname, pretty in zip(gemm, _demangle(gemm)):
        body = funcs[fname]
        n_hgmma, n_tma = body.count("HGMMA"), body.count("UTMALDG")
        n_hmma = len(re.findall(r"\bHMMA\b", body))
        print(f"[build] SASS {pretty[:100]}: HGMMA x{n_hgmma}, UTMALDG x{n_tma}, HMMA x{n_hmma}")
        check(n_hgmma > 0 and n_tma > 0 and n_hmma == 0,
              f"{pretty}: not a wgmma + TMA kernel (HGMMA {n_hgmma}, UTMALDG {n_tma}, "
              f"HMMA {n_hmma})")
    spills = {}
    for name, info in ptxas_rows:
        if "spill" in info:
            spills[name] = re.findall(r"(\d+) bytes spill (?:stores|loads)", info)
    f32 = sorted(n for n in funcs if any(k in n for k in GEMM_F32_KERNELS))
    check(len(f32) == 5, f"expected 5 fp32 GEMM kernels in the SASS, found {f32}")
    for fname, pretty in zip(f32, _demangle(f32)):
        body, spill = funcs[fname], spills.get(fname)
        n_ffma, n_lds = len(re.findall(r"\bFFMA\b", body)), body.count("LDS.128")
        n_mma = len(re.findall(r"\bHMMA\b", body)) + body.count("HGMMA")
        print(f"[build] SASS {pretty[:100]}: FFMA x{n_ffma}, LDS.128 x{n_lds}, HMMA/HGMMA "
              f"x{n_mma}, spill bytes {spill}")
        # the mainloop's 16 k steps of an 8 x 8 accumulator are 1,024 FFMAs (512: a floor)
        check(n_ffma >= 512 and n_lds > 0 and n_mma == 0,
              f"{pretty}: not an FFMA mainloop (FFMA {n_ffma}, LDS.128 {n_lds}, "
              f"HMMA/HGMMA {n_mma})")
        check(spill is not None and all(b == "0" for b in spill),
              f"{pretty}: ptxas reports spills {spill}")
    attn = sorted(n for n in funcs if n.startswith(ATTN_PREFIX))
    fwd = [n for n in attn if ATTN_FWD in n]
    check(len(fwd) == 2, f"expected 2 bf16 attention-forward kernels in the SASS, found {fwd}")
    check(len(attn) - len(fwd) == 8, f"expected 8 bf16 attention-backward kernels in the "
                                     f"SASS, found {sorted(set(attn) - set(fwd))}")
    for fname, pretty in zip(attn, _demangle(attn)):
        n_hgmma = funcs[fname].count("HGMMA")
        spill = spills.get(fname)
        print(f"[build] SASS {pretty[:100]}: HGMMA x{n_hgmma}, spill bytes {spill}")
        check(n_hgmma > 0, f"{pretty}: no HGMMA in the bf16 attention kernel")
        if "ILi64E" in fname:
            check(spill is not None and all(b == "0" for b in spill),
                  f"{pretty}: ptxas reports spills {spill} at D = 64")
    f32a = sorted(n for n in funcs if n.startswith(F32_ATTN_PREFIX))
    counts = {k: sum(k in n for n in f32a) for k in F32_ATTN_KERNELS}
    check(counts == F32_ATTN_KERNELS, f"expected the fp32 attention kernels "
                                      f"{F32_ATTN_KERNELS} in the SASS, found {f32a}")
    for fname, pretty in zip(f32a, _demangle(f32a)):
        body, spill = funcs[fname], spills.get(fname)
        n_ffma, n_lds = len(re.findall(r"\bFFMA\b", body)), body.count("LDS.128")
        n_mma = len(re.findall(r"\bHMMA\b", body)) + body.count("HGMMA")
        print(f"[build] SASS {pretty[:100]}: FFMA x{n_ffma}, LDS.128 x{n_lds}, HMMA/HGMMA "
              f"x{n_mma}, spill bytes {spill}")
        # a score tile of 4 x 4 per 4 d is 64 FFMAs (their floor: 64)
        check(n_ffma >= 64 and n_lds > 0 and n_mma == 0,
              f"{pretty}: not an FFMA kernel (FFMA {n_ffma}, LDS.128 {n_lds}, HMMA/HGMMA {n_mma})")
        check(spill is not None and all(b == "0" for b in spill),
              f"{pretty}: ptxas reports spills {spill}")


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


def op_work(name: str, B: int, S: int, C: int, saved: bool = False, es: int = 2,
            m: int = 1) -> tuple:
    """(operations, bytes) one call of an op needs at these shapes, with
    activations and weights of ``es`` bytes (2: bf16, 4: fp32): each input
    read once, each output written once (biases, LayerNorm parameters and
    parameter gradients 4 bytes); 2 operations per multiply-add of every
    product the op is defined by.  ``m`` > 1: a tensor-parallel shard's call
    (phase 22), whose inner width (heads, the MLP's hidden columns) and
    matrices are 1/m of the block's; its input, output and gradients of the
    input stay (B, S, C)."""
    M, C4 = B * S, 4 * C
    act = es * M * C                      # one (B, S, C) activation
    inner = act // m                      # one (B, S, C / m) activation of the shard's heads
    if name in ("attn_half", "attn_half_train"):   # qkv, proj; q.k^T, p.v
        return ((8 * M * C * C + 4 * B * S * S * C) // m,
                2 * act + 4 * M + es * 4 * C * C // m + 4 * (3 * C + 3 * C // m))
    if name in ("mlp_half", "mlp_half_train"):     # fc1, fc2
        return 4 * M * C * C4 // m, 2 * act + es * 2 * C * C4 // m + 4 * (3 * C + C4 // m)
    if name == "attn_half_train_bwd":     # the dx work from the kept qkv, + dWqkv, dWproj;
        # reads x, g, qkv, attn; writes dx and the fp32 parameter gradients
        return ((16 * M * C * C + 10 * B * S * S * C) // m,
                3 * act + 4 * inner + 4 * M + es * 4 * C * C // m + 4 * 2 * C
                + 4 * (4 * C * C // m + 3 * C + 3 * C // m))
    if name == "mlp_half_train_bwd":      # g.W2, dh.W1, dW1, dW2; reads x, g, h, a_d
        return (8 * M * C * C4 // m,
                3 * act + es * 2 * M * C4 // m + es * 2 * C * C4 // m + 4 * 2 * C
                + 4 * (2 * C * C4 // m + 3 * C + C4 // m))
    if name == "attn_half_dx":            # [qkv], g.Wproj, dqkv.Wqkv; s, dp, dq, dk, dv
        return (((8 if saved else 14) * M * C * C + 10 * B * S * S * C) // m,
                3 * act + 4 * M + es * 4 * C * C // m + 4 * (2 * C + 3 * C // m)
                + (3 * inner if saved else 0))
    if name == "mlp_half_dx":             # [fc1], g.W2, dh.W1
        return ((4 if saved else 6) * M * C * C4 // m,
                3 * act + es * 2 * C * C4 // m + 4 * (2 * C + C4 // m)
                + (es * M * C4 // m if saved else 0))
    if name == "masked_attention":        # q.k^T, p.v; reads q, k, v, mask, writes out
        return 4 * B * S * S * C // m, 4 * inner + 4 * M
    if name == "masked_attention_bwd":    # s, dp, dq, dk, dv; reads q, k, v, g, mask
        return 10 * B * S * S * C // m, 7 * inner + 4 * M
    raise KeyError(name)


def bound(name: str, B: int, S: int, C: int, saved: bool = False, es: int = 2,
          m: int = 1) -> tuple:
    """(least ms, what bounds it) for one call at these shapes: bf16 (``es``
    2) against the tensor cores' dense bf16 rate, fp32 (``es`` 4) against the
    CUDA cores' fp32 FMA rate.  The dropout (C = its width N) does Philox
    integer work on the CUDA cores.  ``m``: a tensor-parallel shard's call
    (``op_work``)."""
    if name == "dropout":
        ops, nbytes, peak = PHILOX_OPS * B * S * C, 2 * es * B * S * C + 4 * B, PEAK_INT32_OPS
    else:
        alias = {"attn_half_full": "attn_half", "attn_half_full_bwd": "attn_half_train_bwd"}
        ops, nbytes = op_work(alias.get(name, name), B, S, C, saved, es, m)
        peak = PEAK_BF16_FLOPS if es == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _compare(name, tag, shape, op, plain, args, rtol, fp32):
    ref = plain(*args).float()
    out = op(*args).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{name} {tag}: non-finite output")
    err = (out - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    tol = rtol * (max(1.0, ref_max) if fp32 else ref_max)
    ms = time_ms(lambda: op(*args))
    plain_ms = time_ms(lambda: plain(*args))
    print(f"[kernels] {name} {tag} {shape}: max_abs_err={err!r} (tol {tol:.3g}, "
          f"max|ref|={ref_max:.4g}) kernel_ms={ms!r} plain_ms={plain_ms!r}")
    check(err <= tol, f"{name} {tag}: error {err} > {tol}")
    return dict(err=err, ms=ms, plain_ms=plain_ms)


def phase_kernels(dev) -> dict:
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.models.vit import VIT_LN_EPS as eps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    C = 768
    with torch.inference_mode():
        # ---- forwards at the serving shape
        x, mask, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2), H = _block_inputs(dev)
        for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"), (torch.bfloat16, 2e-2, "bf16")):
            xd = x.to(dtype)
            calls = {
                "attn_half": (FB.attn_half, FB.attn_half_plain,
                              (xd, mask, lw, lb, wq.to(dtype), bq, wp.to(dtype), bp, H, eps)),
                "mlp_half": (FB.mlp_half, FB.mlp_half_plain,
                             (xd, lw, lb, w1.to(dtype), b1, w2.to(dtype), b2, eps)),
            }
            for name, (op, plain, args) in calls.items():
                res.setdefault(name, {})[tag] = _compare(
                    name, tag, "B=8 S=269 C=768 H=12", op, plain, args, rtol,
                    dtype == torch.float32)

        # ---- the attack shape: the forwards in bf16, the dx ops in both types
        x, mask, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2), H = _block_inputs(
            dev, B=PGD_BATCH, S=241)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        g = torch.randn(x.shape, generator=gen, device=dev)
        shape = f"B={PGD_BATCH} S=241 C=768 H=12"
        for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"), (torch.bfloat16, 2e-2, "bf16")):
            xd, gd = x.to(dtype), g.to(dtype)
            a_w = (xd, mask, lw, lb, wq.to(dtype), bq, wp.to(dtype))
            m_w = (xd, lw, lb, w1.to(dtype), b1, w2.to(dtype))
            if tag == "bf16":
                for name, op, plain, args in (
                        ("attn_half", FB.attn_half, FB.attn_half_plain, (*a_w, bp, H, eps)),
                        ("mlp_half", FB.mlp_half, FB.mlp_half_plain, (*m_w, b2, eps))):
                    res[name]["bf16_pgd_shape"] = _compare(name, tag, shape, op, plain,
                                                           args, rtol, False)
            qkv = FB._attn_fwd(*a_w, bp, H, eps, True)[1]
            h = FB._mlp_fwd(*m_w, b2, eps, True, keep_h=True)[1]
            for variant, q_saved, h_saved in (("saved", qkv, h), ("recompute", None, None)):
                calls = {
                    "attn_half_dx": (FB.attn_half_dx, FB.attn_half_dx_plain,
                                     (*a_w, gd, H, eps, True, q_saved)),
                    "mlp_half_dx": (FB.mlp_half_dx, FB.mlp_half_dx_plain,
                                    (*m_w, gd, eps, True, h_saved)),
                }
                for name, (op, plain, args) in calls.items():
                    res.setdefault(name, {})[f"{tag}_{variant}"] = _compare(
                        f"{name}[{variant}]", tag, shape, op, plain, args, rtol,
                        dtype == torch.float32)

        # the greedy attack's scoring batch: 16 pairs x 5 candidates at the text
        # bucket of ten-word captions, S = 16 + 201 (the forwards; its gradient
        # pass runs the dx ops at B = 16); bf16
        xg, maskg, lng, attng, mlpg, _ = _block_inputs(dev, B=GREEDY_ROWS, S=GREEDY_S)
        gg = torch.randn(xg.shape, generator=gen, device=dev).to(torch.bfloat16)
        xg = xg.to(torch.bfloat16)
        a_g = (xg, maskg, *lng, attng[0].to(torch.bfloat16), attng[1],
               attng[2].to(torch.bfloat16))
        m_g = (xg, *lng, mlpg[0].to(torch.bfloat16), mlpg[1], mlpg[2].to(torch.bfloat16))
        gshape = f"B={GREEDY_ROWS} S={GREEDY_S} C=768 H=12"
        for name, op, plain, args in (
                ("attn_half", FB.attn_half, FB.attn_half_plain, (*a_g, attng[3], H, eps)),
                ("mlp_half", FB.mlp_half, FB.mlp_half_plain, (*m_g, mlpg[3], eps)),
                ("attn_half_dx", FB.attn_half_dx, FB.attn_half_dx_plain, (*a_g, gg, H, eps)),
                ("mlp_half_dx", FB.mlp_half_dx, FB.mlp_half_dx_plain, (*m_g, gg, eps))):
            res[name]["bf16_greedy_shape"] = _compare(name, "bf16", gshape, op, plain, args,
                                                      2e-2, False)
        del xg, maskg, gg, a_g, m_g
        _demo_shape_kernels(res, dev, FB, eps)
        _train_kernels(res, dev, x, mask, g, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2),
                       H, eps, shape)
        _config_kernels(res, dev, x, mask, g, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2),
                        H, eps, shape)
        res["shard_shapes"] = _shard_kernels(x, mask, (lw, lb), (wq, bq, wp, bp),
                                             (w1, b1, w2, b2), H, eps)
        res["sub_kernels"] = _library_yardsticks(dev, FB, x.to(torch.bfloat16), mask,
                                                 wq.to(torch.bfloat16), bq, H)
    for name in KERNELS:
        B, S = (BATCH, 269) if name in ("attn_half", "mlp_half") else (PGD_BATCH, 241)
        N = 4 * C if name == "dropout" else C
        res[name]["bound_ms"], res[name]["bound_by"] = bound(name, B, S, N, saved=True)
        print(f"[kernels] {name} bf16 B={B} S={S}: bound_ms={res[name]['bound_ms']!r} "
              f"(bound by {res[name]['bound_by']})")
    for name in ("attn_half", "mlp_half"):
        res[name]["pgd_shape_bound_ms"] = bound(name, PGD_BATCH, 241, C)[0]
    for name in ("attn_half_dx", "mlp_half_dx"):
        res[name]["recompute_bound_ms"] = bound(name, PGD_BATCH, 241, C, saved=False)[0]
    for name in ("attn_half", "mlp_half", "attn_half_dx", "mlp_half_dx"):
        # the dx ops at this shape recompute (no forward kept its qkv / h)
        res[name]["greedy_shape_bound_ms"] = bound(name, GREEDY_ROWS, GREEDY_S, C)[0]
    for name in KERNELS:   # the fp32 readings, each against its fp32 bound
        B, S = (BATCH, 269) if name in ("attn_half", "mlp_half") else (PGD_BATCH, 241)
        N = 4 * C if name == "dropout" else C
        key = next(k for k in ("fp32", f"fp32_p{DROP_P}", "fp32_saved") if k in res[name])
        b_ms, b_by = bound(name, B, S, N, saved=True, es=4)
        res[name]["fp32_bound_ms"], res[name]["fp32_bound_by"] = b_ms, b_by
        ms = res[name][key]["ms"]
        print(f"[kernels] {name} fp32 B={B} S={S}: kernel_ms={ms!r} fp32_bound_ms={b_ms!r} "
              f"(bound by {b_by}; {b_ms / ms:.3f} of it)")
    return res


GRADS = ("dx", "dln_w", "dln_b", "dw_first", "db_first", "dw_second", "db_second")


def _compare_all(name, tag, shape, op, plain, args, rtol, fp32, names, timed):
    """An op with several outputs: each against the plain version's, relative
    to its own max; two calls of the op must give identical bits."""
    ref = plain(*args)
    out, again = op(*args), op(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for n, o, o2, r in zip(names, out, again, ref):
        check(bool(torch.isfinite(o).all()), f"{name} {tag}: non-finite {n}")
        check(torch.equal(o, o2), f"{name} {tag}: {n} differs between two calls")
        err = (o.float() - r.float()).abs().max().item()
        ref_max = r.float().abs().max().item()
        tol = rtol * (max(1.0, ref_max) if fp32 else ref_max)
        check(err <= tol, f"{name} {tag}: {n} error {err} > {tol}")
        worst = max(worst, err / tol)
    rec = dict(err=(out[0].float() - ref[0].float()).abs().max().item(), worst=worst)
    if timed:
        rec.update(ms=time_ms(lambda: op(*args)), plain_ms=time_ms(lambda: plain(*args)))
    print(f"[kernels] {name} {tag} {shape}: {len(names)} outputs, bit-identical twice, "
          f"max_abs_err({names[0]})={rec['err']!r}, worst error/tolerance={worst:.3f} "
          f"kernel_ms={rec.get('ms')!r} plain_ms={rec.get('plain_ms')!r}")
    return rec


def _train_kernels(res, dev, x, mask, g, ln, attn_w, mlp_w, H, eps, shape) -> None:
    """The four training ops against their plain versions at the step's
    shape, fp32 and bf16, p = 0.1 (timed) and p = 0; masks against philox."""
    from rmcl_tpu_torch.ops import fused_block_train as FT
    from rmcl_tpu_torch.ops.philox import keep_mask
    lw, lb = ln
    wq, bq, wp, bp = attn_w
    w1, b1, w2, b2 = mlp_w
    B, S, C = x.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=gen, device=dev).int()
    for p in (DROP_P, 0.0):
        want = [keep_mask(seeds, 0, S, C, p), keep_mask(seeds, 0, S, 4 * C, p),
                keep_mask(seeds, 1, S, C, p)]
        rates = [m.float().mean().item() for m in want]
        check(all(abs(r - (1 - p)) <= 0.002 for r in rates), f"keep rates {rates} at p={p}")
        for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"), (torch.bfloat16, 2e-2, "bf16")):
            xd, gd = x.to(dtype), g.to(dtype)
            a_w = (lw, lb, wq.to(dtype), bq, wp.to(dtype), bp)
            m_w = (lw, lb, w1.to(dtype), b1, w2.to(dtype), b2)
            fp32, timed, key = dtype == torch.float32, p > 0, f"{tag}_p{p}"
            tag_p = f"{tag} p={p}"
            # forwards: the emitted masks, then the output
            _, m_a = FT.attn_half_train(xd, seeds, mask, *a_w, H, eps, p, emit_mask=True)
            _, m_1, m_2 = FT.mlp_half_train(xd, seeds, *m_w, p, eps, emit_mask=True)
            check(torch.equal(m_a, want[0]) and torch.equal(m_1, want[1])
                  and torch.equal(m_2, want[2]), f"forward masks differ from philox ({tag_p})")
            res.setdefault("attn_half_train", {})[key] = _compare_all(
                "attn_half_train", tag_p, shape,
                lambda *a: (FT.attn_half_train(*a),),
                lambda *a: (FT.attn_half_train_plain(*a),),
                (xd, seeds, mask, *a_w, H, eps, p), rtol, fp32, ("out",), timed)
            res.setdefault("mlp_half_train", {})[key] = _compare_all(
                "mlp_half_train", tag_p, shape,
                lambda *a: (FT.mlp_half_train(*a),),
                lambda *a: (FT.mlp_half_train_plain(*a),),
                (xd, seeds, *m_w, p, eps), rtol, fp32, ("out",), timed)
            # backwards on what the forward kernels kept
            _, qkv, att, _ = FT._attn_train_fwd(xd, seeds, mask, *a_w, H, eps, p)
            _, h, a_d, _, _ = FT._mlp_train_fwd(xd, seeds, *m_w, eps, p, True)
            a_args = (xd, seeds, mask, lw, lb, a_w[2], a_w[4], gd, qkv, att, H, eps, p)
            m_args = (xd, seeds, lw, lb, m_w[2], m_w[4], gd, h, a_d, p, eps)
            *_, m_a = FT.attn_half_train_bwd(*a_args, emit_mask=True)
            *_, m_1, m_2 = FT.mlp_half_train_bwd(*m_args, emit_mask=True)
            check(torch.equal(m_a, want[0]) and torch.equal(m_1, want[1])
                  and torch.equal(m_2, want[2]), f"backward masks differ from philox ({tag_p})")
            res.setdefault("attn_half_train_bwd", {})[key] = _compare_all(
                "attn_half_train_bwd", tag_p, shape, FT.attn_half_train_bwd,
                FT.attn_half_train_bwd_plain, a_args, rtol, fp32, GRADS, timed)
            res.setdefault("mlp_half_train_bwd", {})[key] = _compare_all(
                "mlp_half_train_bwd", tag_p, shape, FT.mlp_half_train_bwd,
                FT.mlp_half_train_bwd_plain, m_args, rtol, fp32, GRADS, timed)
        print(f"[kernels] p={p}: the masks of both directions equal philox.keep_mask bit "
              f"for bit; keep rates {rates}")


def _config_kernels(res, dev, x, mask, g, ln, attn_w, mlp_w, H, eps, shape) -> None:
    """The ops of configurations P and F against their plain versions at the
    step's shape, fp32 and bf16: masked_attention and its backward (rows 10,
    11) on the heads of the block's own qkv projection (views, as the unfused
    block hands them over), timed in bf16 beside F.scaled_dot_product_attention
    and its backward through torch.autograd.grad; attn_half_full and its
    backward (row 2), seven outputs bit-identical twice; the dropout op at the
    MLP's (S, 4C) width, bit for bit."""
    from rmcl_tpu_torch.models.layers import dropout as dropout_plain
    from rmcl_tpu_torch.ops import attention as A
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.ops.dropout import dropout
    from rmcl_tpu_torch.ops.philox import keep_mask
    lw, lb = ln
    wq, bq, wp, bp = attn_w
    B, S, C = x.shape
    D = C // H
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    g_heads = torch.randn(B, H, S, D, generator=gen, device=dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=gen, device=dev).int()
    wide = torch.randn(B, S, 4 * C, generator=gen, device=dev)
    for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"), (torch.bfloat16, 2e-2, "bf16")):
        fp32 = dtype == torch.float32
        xd, gd, gh = x.to(dtype), g.to(dtype), g_heads.to(dtype)
        a_w = (lw, lb, wq.to(dtype), bq, wp.to(dtype), bp)
        qkv = FB._attn_fwd(xd, mask, *a_w, H, eps, True)[1]
        q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        res.setdefault("masked_attention", {})[tag] = _compare(
            "masked_attention", tag, shape, A.masked_attention, A.mha,
            (q, k, v, mask, D ** -0.5), rtol, fp32)
        res.setdefault("masked_attention_bwd", {})[tag] = _compare_all(
            "masked_attention_bwd", tag, shape, A.masked_attention_bwd,
            A.masked_attention_bwd_plain, (q, k, v, mask, gh, D ** -0.5), rtol, fp32,
            ("dq", "dk", "dv"), True)
        # the pair's device time, without the host's share of a call; in fp32
        # the forward's too (rows 10, 11 of the fp32 table)
        res["masked_attention_bwd"][tag]["device_ms"] = dms = device_ms(
            lambda: A.masked_attention_bwd(q, k, v, mask, gh, D ** -0.5))
        print(f"[kernels] masked_attention_bwd {tag} {shape}: device_ms={dms!r}")
        if fp32:
            res["masked_attention"][tag]["device_ms"] = fms = device_ms(
                lambda: A.masked_attention(q, k, v, mask, D ** -0.5))
            print(f"[kernels] masked_attention {tag} {shape}: device_ms={fms!r}")
        _sdpa_yardsticks(res, q, k, v, mask, gh, tag)
        res.setdefault("attn_half_full", {})[tag] = _compare(
            "attn_half_full", tag, shape, FB.attn_half_full,
            lambda *a: FB.attn_half_plain(*a, residual=False), (xd, mask, *a_w, H, eps),
            rtol, fp32)
        _, qkv, att = FB._attn_fwd(xd, mask, *a_w, H, eps, False)
        res.setdefault("attn_half_full_bwd", {})[tag] = _compare_all(
            "attn_half_full_bwd", tag, shape, FB.attn_half_full_bwd,
            FB.attn_half_full_bwd_plain, (xd, mask, lw, lb, a_w[2], a_w[4], gd, qkv, att, H,
                                          eps), rtol, fp32, GRADS, True)
        wd = wide.to(dtype)
        plain = lambda: dropout_plain(wd, keep_mask(seeds, 0, S, 4 * C, DROP_P), DROP_P)  # noqa: E731
        check(torch.equal(dropout(wd, seeds, 0, DROP_P), plain()),
              f"dropout {tag}: the kernel's bits differ from philox.keep_mask")
        ms, plain_ms = time_ms(lambda: dropout(wd, seeds, 0, DROP_P)), time_ms(plain)
        res.setdefault("dropout", {})[tag] = dict(err=0.0, ms=ms, plain_ms=plain_ms)
        print(f"[kernels] dropout {tag} (B={B} S={S} N={4 * C}, p={DROP_P}): the plain "
              f"version's bits exactly; kernel_ms={ms!r} plain_ms={plain_ms!r}")


def _sdpa_backward_times(q, k, v, keep, g) -> tuple:
    """(ms per call, device ms) of F.scaled_dot_product_attention's backward
    on these heads through torch.autograd.grad, the graph built once."""
    import torch.nn.functional as F
    with torch.inference_mode(False), torch.enable_grad():
        q, k, v, keep, g = (t.clone() for t in (q, k, v, keep, g))
        for t in (q, k, v):
            t.requires_grad_(True)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        bwd = lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)  # noqa: E731
        return time_ms(bwd), device_ms(bwd)


def _sdpa_yardsticks(res, q, k, v, mask, g, tag) -> None:
    """F.scaled_dot_product_attention on the same heads and its backward
    (_sdpa_backward_times) in the heads' type (``tag``: bf16, or fp32 with
    TF32 off): the one-call yardsticks of rows 10 and 11, under library_*
    (bf16) or fp32_library_* (fp32)."""
    import torch.nn.functional as F
    keep = (mask > 0)[:, None, None, :]
    fwd = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)  # noqa: E731
    fwd_ms, fwd_dev_ms = time_ms(fwd), device_ms(fwd)
    bwd_ms, bwd_dev_ms = _sdpa_backward_times(q, k, v, keep, g)
    key = "library" if tag == "bf16" else "fp32_library"
    res["masked_attention"].update({f"{key}_ms": fwd_ms, f"{key}_device_ms": fwd_dev_ms})
    res["masked_attention_bwd"].update({f"{key}_ms": bwd_ms, f"{key}_device_ms": bwd_dev_ms})
    print(f"[kernels] F.scaled_dot_product_attention {tag} on the same heads: forward "
          f"{fwd_ms!r} ms (device {fwd_dev_ms!r} ms), backward through torch.autograd.grad "
          f"{bwd_ms!r} ms (device {bwd_dev_ms!r} ms)")


def _shard_kernels(x, mask, ln, attn_w, mlp_w, H, eps) -> list:
    """attn_half and mlp_half at a two-way tensor-parallel shard's shapes
    (scripts/bench_tp_kernel_shapes.py, Queue B row 14): 6 of 12 heads, qkv
    C -> 3 x 384, proj 384 -> C without the residual, fc1 C -> 1536, fc2
    1536 -> C; B=16 S=241, fp32 and bf16, each with its bound."""
    from rmcl_tpu_torch.ops import fused_block as FB
    lw, lb = ln
    wq, bq, wp, bp = attn_w
    w1, b1, w2, b2 = mlp_w
    B, S, C = x.shape
    Ci, Fi, M = C // 2, 2 * C, B * S
    rows = torch.cat([torch.arange(i * C, i * C + Ci, device=x.device) for i in range(3)])
    work = {"attn_half": (8 * M * C * Ci + 4 * B * S * S * Ci,
                          4 * M * C + 4 * M + 2 * 4 * C * Ci + 4 * (3 * Ci + 3 * C)),
            "mlp_half": (4 * M * C * Fi, 4 * M * C + 2 * 2 * C * Fi + 4 * (Fi + 3 * C))}
    out = []
    for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"), (torch.bfloat16, 2e-2, "bf16")):
        xd = x.to(dtype)
        calls = {"attn_half": (FB.attn_half, FB.attn_half_plain, (
                     xd, mask, lw, lb, wq[rows].to(dtype), bq[rows],
                     wp[:, :Ci].to(dtype).contiguous(), bp, H // 2, eps, False)),
                 "mlp_half": (FB.mlp_half, FB.mlp_half_plain, (
                     xd, lw, lb, w1[:Fi].to(dtype), b1[:Fi], w2[:, :Fi].to(dtype).contiguous(),
                     b2, eps, False))}
        for name, (op, plain, args) in calls.items():
            r = _compare(name, tag, f"tp2 shard B={B} S={S}", op, plain, args, rtol,
                         dtype == torch.float32)
            ops, nbytes = work[name]
            r.update(name=name, dtype=tag, shard="tp2", bound_ms=max(
                ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S) * 1e3)
            out.append(r)
    return out


# The GEMM sub-kernels as the step's main path runs them, at M = 16 x 241:
# (label, N, K, options).  ln: the LayerNorm operand; gelu: GELU keeping the
# pre-GELU value; drop: dropout (draw 0); res: + residual; kn: the weight
# stored (K, N), the backward's g . W; dgelu: times gelu'(aux); f32: fp32 out.
LN_GEMM_SUBS = (("qkv", 2304, 768, "ln"), ("fc1", 3072, 768, "ln gelu"),
                ("fc1 train", 3072, 768, "ln gelu drop"), ("proj", 768, 768, "res"),
                ("fc2", 768, 3072, "res"), ("g.Wproj", 768, 768, "kn"),
                ("g.W2 gelu'", 3072, 768, "kn dgelu drop"), ("dh.W1", 768, 3072, "kn f32"),
                ("dqkv.Wqkv", 768, 2304, "kn f32"))
GEMM_TN_SUBS = (("dWqkv", 2304, 768), ("dWproj", 768, 768), ("dW1", 3072, 768),
                ("dW2", 768, 3072))
GEMM_HEADLINE = {"ln_gemm": "fc2", "gemm_tn": "dW1"}   # their rows of the kernels record


def _sub_bound(flops: float, nbytes: float, core_ops: float = 0.0,
               peak: float = PEAK_BF16_FLOPS) -> tuple:
    """(least ms, what bounds it): FLOP at ``peak`` (the tensor cores' bf16
    rate, or PEAK_FP32_FLOPS for the fp32 FMA kernels), 32-bit integer work
    on the CUDA cores (the dropout's Philox) and bytes each at the card's
    peak."""
    t_ops = max(flops / peak, core_ops / PEAK_INT32_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def device_ms(fn, iters: int = 20, warmup: int = 3, kernel: str = ""):
    """Device time of one call: the time of the kernels it launches (of those
    whose name holds ``kernel``), summed from torch.profiler's device
    events, over ``iters`` calls.  Unlike
    ``time_ms`` it leaves out the host's share of a call (Python, ctypes,
    the launch), which a call shorter than that share cannot hide.  A
    profiler session now and then records no device event at all: it is
    tried three times, then the reading is None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / iters / 1e3
    return None


def _rate(num: float, ms, unit: str) -> str:
    """num / ms as "x.y unit", or "not measured" for a missing device time."""
    return "not measured" if ms is None else f"{num / ms:.3f} {unit}"


def _ln_gemm_case(dev, FB, gen, N, K, opts, dtype=torch.bfloat16, B=PGD_BATCH,
                  S=241) -> dict:
    """Inputs of one ln_gemm instance (see LN_GEMM_SUBS) in ``dtype`` at M = B
    S (dropout: S rows per sample), with the bytes it must move (each input
    read once, each output written once)."""
    M, opts, es = B * S, opts.split(), torch.empty(0, dtype=dtype).element_size()
    rn = lambda *s, std=1.0, dt=dtype: (  # noqa: E731
        torch.randn(*s, generator=gen, device=dev) * std).to(dt)
    kn = "kn" in opts
    c = dict(a=rn(M, K), w=rn(*((K, N) if kn else (N, K)), std=0.02), kn=kn, opts=opts, M=M,
             bias=None if kn else rn(N, std=0.02, dt=torch.float32), kw=dict(w_kn=kn))
    kw, nbytes = c["kw"], es * M * K + es * N * K + (0 if kn else 4 * N)
    if "ln" in opts:
        kw.update(ln=(1.0 + rn(K, std=0.1, dt=torch.float32), rn(K, std=0.1, dt=torch.float32)),
                  eps=1e-12)
        nbytes += 8 * K
    if "gelu" in opts:
        kw.update(gelu=True, aux=torch.empty(M, N, device=dev, dtype=dtype))
    if "res" in opts:
        kw["residual"] = rn(M, N)
    if "dgelu" in opts:
        kw.update(epi=FB._EPI_DGELU, aux=rn(M, N))
    if "f32" in opts:
        kw["epi"] = FB._EPI_F32
    c["bytes"] = nbytes + M * N * (4 if "f32" in opts else es) + es * M * N * (
        ("res" in opts) + ("gelu" in opts) + ("dgelu" in opts))
    c["plain_kw"], c["core_ops"] = {k: v for k, v in kw.items() if k != "aux" or
                                    "dgelu" in opts}, 0.0
    if "drop" in opts:
        seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=gen, device=dev).int()
        c["plain_kw"]["drop"] = (seeds, S, 0, DROP_P)
        kw["drop"] = (seeds, S, 0, DROP_P, None)
        c["core_ops"] = PHILOX_OPS * M * N
    c["out"] = torch.empty(M, N, device=dev, dtype=torch.float32 if "f32" in opts else dtype)
    return c


def _ln_gemm_sub(dev, FB, lib, gen, label, N, K, opts) -> dict:
    """One ln_gemm instance against _gemm_plain (bf16, 2e-2 of max|ref|; the
    pre-GELU value likewise; the emitted mask equal to keep_mask), timed
    beside its plain version and the one PyTorch call of its product
    (F.linear, or torch.matmul(g, W) for the (K, N) layout; neither has the
    LayerNorm or the epilogue)."""
    import torch.nn.functional as F
    c = _ln_gemm_case(dev, FB, gen, N, K, opts)
    a, w, bias, out, kw, kn, M = c["a"], c["w"], c["bias"], c["out"], c["kw"], c["kn"], c["M"]
    run = lambda: FB._gemm(lib, a, w, bias, out, **kw)  # noqa: E731
    plain = lambda: FB._gemm_plain(a, w, bias, **c["plain_kw"])  # noqa: E731
    lib_call = ((lambda: torch.matmul(a, w)) if kn else  # noqa: E731
                (lambda: F.linear(a, w, bias.bfloat16())))
    ref, pre, keep = plain()
    if keep is not None:   # once with the mask out, as the tests ask for it
        mask = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        FB._gemm(lib, a, w, bias, out, **dict(kw, drop=kw["drop"][:4] + (mask,)))
        check(torch.equal(mask > 0, keep), f"ln_gemm[{label}]: mask differs from keep_mask")
    run()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2e-2 * ref.float().abs().max().item()
    check(bool(torch.isfinite(out).all()) and err <= tol, f"ln_gemm[{label}]: error {err} > {tol}")
    if pre is not None:
        perr = (kw["aux"].float() - pre.float()).abs().max().item()
        check(perr <= 2e-2 * pre.float().abs().max().item(), f"ln_gemm[{label}]: aux {perr}")
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib_call)
    dev_ms, lib_dev_ms = device_ms(run), device_ms(lib_call)
    flops = 2 * M * N * K
    bound_ms, bound_by = _sub_bound(flops, c["bytes"], c["core_ops"])
    shape = f"M={M} N={N} K={K} {'+'.join(c['opts']) or 'bias'}"
    lib_name = "torch.matmul" if kn else "F.linear"
    print(f"[kernels] ln_gemm[{label}] ({shape}) bf16: kernel_ms={ms!r} "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound) device_ms="
          f"{dev_ms!r} ({_rate(bound_ms, dev_ms, 'of the bound')}) plain_ms={plain_ms!r} "
          f"{lib_name}_ms={lib_ms!r} (device {lib_dev_ms!r}, "
          f"{_rate(flops / 1e9, lib_dev_ms, 'TFLOP/s')}) bound_ms={bound_ms!r} ({bound_by}) "
          f"max_abs_err={err!r} (tol {tol:.3g})")
    return dict(name=f"ln_gemm[{label}]", shape=shape, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev_ms,
                library="torch.matmul(g, W)" if kn else "F.linear", bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def _gemm_tn_sub(dev, FB, lib, gen, label, Na, Nb) -> dict:
    """One gemm_tn instance against a^T . b in fp32 (1e-3 of max|ref|: exact
    products, summation order only), bit-identical across two calls, timed
    beside its plain version and torch.matmul(A.t(), B)."""
    M = PGD_BATCH * 241
    a = torch.randn(M, Na, generator=gen, device=dev).bfloat16()
    b = torch.randn(M, Nb, generator=gen, device=dev).bfloat16()
    run = lambda: FB._gemm_tn(lib, a, b)  # noqa: E731
    plain = lambda: FB._gemm_tn_plain(a, b)  # noqa: E731
    out, again, ref = run(), run(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-3 * ref.abs().max().item()
    check(torch.equal(out, again), f"gemm_tn[{label}]: two calls differ")
    check(err <= tol, f"gemm_tn[{label}]: error {err} > {tol}")
    lib_call = lambda: torch.matmul(a.t(), b)  # noqa: E731
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib_call)
    dev_ms, lib_dev_ms = device_ms(run), device_ms(lib_call)
    flops = 2 * M * Na * Nb
    bound_ms, bound_by = _sub_bound(flops, 2 * M * (Na + Nb) + 4 * Na * Nb)
    slabs = lib.rmcl_gemm_tn_slabs(1, M, Na, Nb)
    print(f"[kernels] gemm_tn[{label}] (M={M} -> {Na}x{Nb}, {slabs} slab(s)) bf16 in, fp32 "
          f"out: kernel_ms={ms!r} ({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
          f"bound) device_ms={dev_ms!r} ({_rate(bound_ms, dev_ms, 'of the bound')}) plain_ms="
          f"{plain_ms!r} torch.matmul(A.t(),B)_ms={lib_ms!r} (device {lib_dev_ms!r}, "
          f"{_rate(flops / 1e9, lib_dev_ms, 'TFLOP/s')}) bound_ms={bound_ms!r} ({bound_by}) "
          f"max_abs_err={err!r} (tol {tol:.3g}); bit-identical twice")
    return dict(name=f"gemm_tn[{label}]", shape=f"M={M} -> {Na}x{Nb}", ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, library="torch.matmul(A.t(), B)",
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, slabs=slabs)


# (B, S) of the fp32 GEMM checks: the step's M = 3,856; the ragged M of the
# fp32 parity steps (2 x 241 = 482, 3 x 37 = 111), which no tile divides; the
# greedy attack's scoring forward, M = 80 x 217 = 17,360.  Timed at the
# first and the last.
F32_GEMM_ROWS = ((PGD_BATCH, 241), (2, 241), (3, 37), (GREEDY_ROWS, GREEDY_S))
F32_TIMED_ROWS = (PGD_BATCH * 241, GREEDY_ROWS * GREEDY_S)


def _f32_check(name, got, again, ref, tol_rel=2e-4) -> float:
    """fp32 kernel output against its plain version (2e-4 of max(1, max|ref|):
    exact products, summation order only) and bit-identical to a second
    call; the error."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(torch.equal(got, again), f"{name}: two calls differ")
    err = (got.float() - ref.float()).abs().max().item()
    tol = tol_rel * max(1.0, ref.float().abs().max().item())
    check(err <= tol, f"{name}: error {err} > {tol}")
    return err


def _f32_ln_gemm(dev, FB, lib, gen, label, N, K, opts, B, S) -> dict:
    """One fp32 ln_gemm instance (the FMA kernel) at M = B S against
    _gemm_plain: the output, the pre-GELU value it keeps and the dropout mask
    it emits (equal to keep_mask bit for bit), each bit-identical over two
    calls; at F32_TIMED_ROWS timed by device time beside its fp32 bound, its
    plain version (at the step's M) and F.linear / torch.matmul(g, W) in fp32
    (TF32 off; neither has the LayerNorm or the epilogue)."""
    import torch.nn.functional as F
    c = _ln_gemm_case(dev, FB, gen, N, K, opts, torch.float32, B, S)
    a, w, bias, out, kw, kn, M = c["a"], c["w"], c["bias"], c["out"], c["kw"], c["kn"], c["M"]
    name, shape = f"ln_gemm[{label}]", f"M={M} N={N} K={K} {'+'.join(c['opts']) or 'bias'}"
    mask, mask2 = ((torch.empty(M, N, device=dev) for _ in range(2)) if "drop" in kw else
                   (None, None))

    def call(m):
        kw2 = dict(kw, drop=kw["drop"][:4] + (m,)) if "drop" in kw else kw
        FB._gemm(lib, a, w, bias, out, **kw2)
        return out.clone(), (kw["aux"].clone() if "aux" in kw and "gelu" in c["opts"] else None)
    (got, pre), (again, pre2) = call(mask), call(mask2)
    ref, ref_pre, keep = FB._gemm_plain(a, w, bias, **c["plain_kw"])
    torch.cuda.synchronize()
    err = _f32_check(f"{name} fp32 {shape}", got, again, ref)
    if ref_pre is not None:
        _f32_check(f"{name} fp32 {shape} aux", pre, pre2, ref_pre)
    if keep is not None:
        check(torch.equal(mask > 0, keep) and torch.equal(mask, mask2),
              f"{name} fp32 {shape}: mask differs from keep_mask")
    rec = dict(name=f"{name} fp32", dtype="fp32", shape=shape, M=M, max_abs_err=err)
    if M not in F32_TIMED_ROWS:
        return rec
    run = lambda: FB._gemm(lib, a, w, bias, out, **kw)  # noqa: E731
    lib_call = ((lambda: torch.matmul(a, w)) if kn else  # noqa: E731
                (lambda: F.linear(a, w, bias)))
    flops = 2 * M * N * K
    bound_ms, bound_by = _sub_bound(flops, c["bytes"], c["core_ops"], PEAK_FP32_FLOPS)
    rec.update(ms=time_ms(run), device_ms=device_ms(run), library_ms=time_ms(lib_call),
               library_device_ms=device_ms(lib_call), bound_ms=bound_ms, bound_by=bound_by,
               library="torch.matmul(g, W)" if kn else "F.linear",
               plain_ms=time_ms(lambda: FB._gemm_plain(a, w, bias, **c["plain_kw"]))
               if M == F32_TIMED_ROWS[0] else None)
    return rec


def _f32_gemm_tn(dev, FB, lib, gen, label, Na, Nb, B, S) -> dict:
    """One fp32 gemm_tn instance at M = B S against a^T . b in fp32 (2e-4 of
    max(1, max|ref|)), bit-identical twice, with the slices its plan cut the
    rows into; at the step's M timed beside its fp32 bound, its plain
    version and torch.matmul(A.t(), B)."""
    M = B * S
    a = torch.randn(M, Na, generator=gen, device=dev)
    b = torch.randn(M, Nb, generator=gen, device=dev)
    run = lambda: FB._gemm_tn(lib, a, b)  # noqa: E731
    name, shape = f"gemm_tn[{label}]", f"M={M} -> {Na}x{Nb}"
    got, again, ref = run(), run(), FB._gemm_tn_plain(a, b)
    torch.cuda.synchronize()
    err = _f32_check(f"{name} fp32 {shape}", got, again, ref)
    rec = dict(name=f"{name} fp32", dtype="fp32", shape=shape, M=M, max_abs_err=err,
               slabs=lib.rmcl_gemm_tn_slabs(0, M, Na, Nb))
    if M != F32_TIMED_ROWS[0]:
        return rec
    lib_call = lambda: torch.matmul(a.t(), b)  # noqa: E731
    bound_ms, bound_by = _sub_bound(2 * M * Na * Nb, 4 * (M * (Na + Nb) + Na * Nb), 0.0,
                                    PEAK_FP32_FLOPS)
    rec.update(ms=time_ms(run), device_ms=device_ms(run), plain_ms=time_ms(
        lambda: FB._gemm_tn_plain(a, b)), library_ms=time_ms(lib_call),
        library_device_ms=device_ms(lib_call), library="torch.matmul(A.t(), B)",
        bound_ms=bound_ms, bound_by=bound_by)
    return rec


def _f32_gemm_subs(dev, FB, lib, gen) -> list:
    """The fp32 FMA kernels that compute_dtype="float32" reaches,
    ln_gemm_f32_kernel (with ln_stats_kernel) and gemm_tn_f32_kernel: every
    LN_GEMM_SUBS and GEMM_TN_SUBS instance at every F32_GEMM_ROWS M, each
    against its plain version (fp32, TF32 off), bit-identical twice; timed
    at F32_TIMED_ROWS, each with its fp32 bound: bytes at 4 B per element
    over 3.35 TB/s against FLOPs over the fp32 FMA rate."""
    out = []
    for B, S in F32_GEMM_ROWS:
        out += [_f32_ln_gemm(dev, FB, lib, gen, *sub, B, S) for sub in LN_GEMM_SUBS]
        if B * S != GREEDY_ROWS * GREEDY_S:   # no weight gradient at the scoring forward
            out += [_f32_gemm_tn(dev, FB, lib, gen, *sub, B, S) for sub in GEMM_TN_SUBS]
    for r in out:
        timed = "" if "ms" not in r else (
            f" kernel_ms={r['ms']!r} device_ms={r['device_ms']!r} "
            f"({_rate(r['bound_ms'], r['device_ms'], 'of the bound')}) plain_ms="
            f"{r['plain_ms']!r} {r['library']}_ms={r['library_ms']!r} (device "
            f"{r['library_device_ms']!r}) fp32_bound_ms={r['bound_ms']!r} ({r['bound_by']})")
        slabs = f", {r['slabs']} slab(s)" if "slabs" in r else ""
        print(f"[kernels] {r['name']} ({r['shape']}{slabs}): max_abs_err={r['max_abs_err']!r}"
              f" within 2e-4 of max(1, max|ref|), bit-identical twice{timed}")
    # the records' key: the step's M
    return [dict(r, name=r["name"] if r["M"] == F32_TIMED_ROWS[0] else
                 f"{r['name']} M={r['M']}") for r in out]


# (B, S, heads) of the fp32 attention as phase 3 runs the fp32 ops: serving,
# the step, the greedy attack's scoring forward and a two-way shard (row 14)
F32_ATTN_SHAPES = ((BATCH, 269, 12), (PGD_BATCH, 241, 12), (GREEDY_ROWS, GREEDY_S, 12),
                   (PGD_BATCH, 241, 6))


def _f32_ds_probe(dev, FB, lib, qkv, mask, dattn, H, shape) -> None:
    """bwd_dq_kernel and bwd_dkv_kernel each recompute s, p, dp and ds.  With
    16 columns of q and k one-hot (q[s0[c], c] = k[t0[c], c] = 1, t0 valid
    keys), dq[s0[c'], c] from bwd_dq and dk[t0[c], c'] from bwd_dkv both hold
    ds at (s0[c'], t0[c]), each an exact sum of one product and zeros: equal
    bit for bit in both layouts, as one order of the sums over d makes them."""
    from rmcl_tpu_torch.ops import attention as A
    B, S, C3 = qkv.shape
    D, n = C3 // 3 // H, 16
    qkv = qkv.clone()
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    gen = torch.Generator().manual_seed(SEED)
    s0 = torch.stack([torch.randperm(S, generator=gen)[:n] for _ in range(B * H)]).view(B, H, n)
    valid = [mask[b].nonzero().flatten().cpu() for b in range(B)]
    t0 = torch.stack([valid[b][torch.randperm(len(valid[b]), generator=gen)[:n]]
                      for b in range(B) for _ in range(H)]).view(B, H, n)
    s0, t0 = s0.to(dev), t0.to(dev)
    at = torch.arange(S, device=dev)[:, None]
    for x, rows in ((q, s0), (k, t0)):       # views of qkv: written in place
        x[..., :n] = (at == rows[:, :, None, :]).float()
    dqkv, stats = torch.empty_like(qkv), torch.empty(B, H, S, 3, device=dev)
    FB._attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, H)
    g = dattn.view(B, S, H, D).transpose(1, 2)
    for layout, (dq, dk) in (("packed", dqkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)[:2]),
                             ("heads", A.masked_attention_bwd(q, k, v, mask, g, D ** -0.5)[:2])):
        at_q = dq.gather(2, s0[..., None].expand(-1, -1, -1, D))[..., :n]
        at_k = dk.gather(2, t0[..., None].expand(-1, -1, -1, D))[..., :n].transpose(-1, -2)
        check(torch.equal(at_q, at_k) and bool((at_q != 0).any()),
              f"attention_bwd fp32 {layout} {shape}: bwd_dq's ds and bwd_dkv's differ by up "
              f"to {(at_q - at_k).abs().max().item()!r}")
    print(f"[kernels] attention_bwd fp32 ({shape}): bwd_dq's and bwd_dkv's ds equal bit for bit "
          f"at {n} x {n} (query, key) pairs of each of the {B * H} (sample, head)s, packed and "
          f"heads")


def _f32_attention_subs(dev, FB, lib, gen) -> list:
    """The fp32 attention kernels (csrc/simt_attention.cuh: fwd_kernel, and
    bwd_dq_kernel -> bwd_dkv_kernel) at every F32_ATTN_SHAPES shape, D = 64,
    in both layouts: packed (rmcl_masked_attention_fwd / _bwd, the block
    halves' rounding points) against mha on the same heads and
    _attn_dqkv_plain with Wproj = I, and the heads on views of one qkv buffer
    (rmcl_attention_fwd / _bwd through masked_attention) against mha and
    masked_attention_bwd_plain; fp32 (TF32 off), 2e-4 of max(1, max|ref|),
    bit-identical twice.  At the step's shape _f32_ds_probe, and the packed
    forward and pair by time per call and device time beside their fp32
    bound, their plain versions and F.scaled_dot_product_attention's forward
    and backward in fp32."""
    import torch.nn.functional as F
    from rmcl_tpu_torch.ops import attention as A
    out = []
    for B, S, H in F32_ATTN_SHAPES:
        D = 64
        C, scale, shape = H * D, D ** -0.5, f"B={B} S={S} H={H} D={D}"
        qkv = torch.randn(B, S, 3 * C, generator=gen, device=dev)
        mask = (torch.rand(B, S, generator=gen, device=dev) > 0.3).int()
        mask[:, 0] = 1
        dattn = torch.randn(B, S, C, generator=gen, device=dev)
        q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        g = dattn.view(B, S, H, D).transpose(1, 2)
        att, dqkv = torch.empty(B, S, C, device=dev), torch.empty(B, S, 3 * C, device=dev)
        stats = torch.empty(B, H, S, 3, device=dev)
        fwd = lambda: FB._attn_fwd_packed(lib, qkv, mask, att, H)  # noqa: E731
        bwd = lambda: FB._attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, H)  # noqa: E731
        plain_fwd = lambda: A.mha(q, k, v, mask, scale).transpose(1, 2).reshape(B, S, C)  # noqa: E731
        eye = torch.eye(C, device=dev)
        plain_bwd = lambda: FB._attn_dqkv_plain(qkv, mask, eye, dattn, H)  # noqa: E731
        errs = {}
        for part, run, buf, plain in (("fwd", fwd, att, plain_fwd), ("bwd", bwd, dqkv, plain_bwd)):
            run()
            first = buf.clone()
            run()
            errs[f"{part} packed"] = _f32_check(f"attention_{part} fp32 packed {shape}", buf,
                                                first, plain())
        errs["fwd heads"] = _f32_check(f"attention_fwd fp32 heads {shape}",
                                       A.masked_attention(q, k, v, mask, scale),
                                       A.masked_attention(q, k, v, mask, scale),
                                       A.mha(q, k, v, mask, scale))
        ours, again = (A.masked_attention_bwd(q, k, v, mask, g, scale) for _ in range(2))
        ref = A.masked_attention_bwd_plain(q, k, v, mask, g, scale)
        errs["bwd heads"] = max(_f32_check(f"attention_bwd fp32 heads {shape} {n}", a, b, c)
                                for n, a, b, c in zip(("dq", "dk", "dv"), ours, again, ref))
        torch.cuda.synchronize()
        rec = dict(name=f"attention f32 {shape}", dtype="fp32", shape=shape, max_abs_err=errs)
        if (B, S, H) == (PGD_BATCH, 241, 12):
            _f32_ds_probe(dev, FB, lib, qkv, mask, dattn, H, shape)
            keep = (mask > 0)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)  # noqa: E731
            lib_bwd_ms, lib_bwd_dev = _sdpa_backward_times(q, k, v, keep, g)
            for part, run, plain, name in (("fwd", fwd, plain_fwd, "masked_attention"),
                                           ("bwd", bwd, plain_bwd, "masked_attention_bwd")):
                b_ms, b_by = bound(name, B, S, C, es=4)
                rec[part] = dict(ms=time_ms(run), device_ms=device_ms(run),
                                 plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by)
            rec["fwd"].update(library="F.scaled_dot_product_attention", library_ms=time_ms(sdpa),
                              library_device_ms=device_ms(sdpa))
            rec["bwd"].update(library="torch.autograd.grad of F.scaled_dot_product_attention",
                              library_ms=lib_bwd_ms, library_device_ms=lib_bwd_dev)
        timed = "".join(
            f"; {p} kernel_ms={r['ms']!r} device_ms={r['device_ms']!r} "
            f"({_rate(r['bound_ms'], r['device_ms'], 'of the bound')}) plain_ms="
            f"{r['plain_ms']!r} fp32_bound_ms={r['bound_ms']!r} ({r['bound_by']}) "
            f"{r['library']} device_ms={r['library_device_ms']!r}"
            for p, r in ((p, rec.get(p)) for p in ("fwd", "bwd")) if r)
        print(f"[kernels] attention fp32 ({shape}): max_abs_err {errs} within 2e-4 of max(1, "
              f"max|ref|), bit-identical twice{timed}")
        out.append(rec)
    return out


# The LayerNorm backward's two forms, as the main path runs them with + g:
# dx only (rows 3, 5: attn_half_dx, mlp_half_dx) and training (rows 9, 7:
# dx, y and dLN in one launch), at M = 16 x 241, C = 768; the bias gradients'
# widths (dbproj and db2 768, dbqkv 2304, db1 3072).
LN_BWD_FORMS = ("dx", "train")
COLSUM_WIDTHS = (768, 2304, 3072)
BIAS_GRADS = (768, 2304, 768, 3072)   # dbproj, dbqkv, db2, db1: one training step's four


def _sum_tol(ref, bf16_out: bool) -> float:
    """Tolerance of an output against its plain version, which differs in
    summation order only: fp32, 1e-5 of max(1, max|ref|); an output rounded
    to bf16 from such fp32 values, one bf16 ulp of max|ref|."""
    ref_max = ref.float().abs().max().item()
    if bf16_out:
        return 2.0 ** (np.floor(np.log2(ref_max)) - 7)
    return 1e-5 * max(1.0, ref_max)


def _ln_bwd_case(dev, gen, dtype, M=PGD_BATCH * 241, C=768) -> dict:
    """Inputs of ln_bwd at the step's shape: x, g in dtype, dy, ln_w, ln_b fp32."""
    rn = lambda *s, std=1.0, mu=0.0: (  # noqa: E731
        torch.randn(*s, generator=gen, device=dev) * std + mu)
    return dict(x=rn(M, C, std=2.0, mu=0.5).to(dtype), dy=rn(M, C), g=rn(M, C).to(dtype),
                ln_w=rn(C, std=0.1, mu=1.0), ln_b=rn(C, std=0.1))


def _ln_bwd_calls(FB, lib, c, form: str, eps: float) -> tuple:
    """(kernel call, plain call) of one form through the wrappers every slice
    of the port has had (_ln_bwd_dx, _ln_backward)."""
    x, dy, g, w, b = c["x"], c["dy"], c["g"], c["ln_w"], c["ln_b"]
    if form == "train":
        run = lambda: FB._ln_backward(lib, x, dy, w, b, g, eps, True)  # noqa: E731
    else:
        run = lambda: (FB._ln_bwd_dx(lib, x, dy, w, g, eps, True),)  # noqa: E731
    return run, lambda: FB._ln_backward_plain(x, dy, w, b, g, eps, True)


def _ln_bwd_bytes(M: int, C: int, es: int, form: str) -> int:
    """x, dy (fp32), g and ln_w read once, dx written; training: ln_b read,
    y and dln (2C fp32) written too."""
    nbytes = M * C * (3 * es + 4) + 4 * C
    return nbytes + (M * C * es + 4 * C + 8 * C if form == "train" else 0)


def _ln_bwd_sub(dev, FB, lib, gen, form: str, dtype) -> dict:
    """ln_bwd in one form at M = 16 x 241, C = 768 with + g against
    _ln_backward_plain (_sum_tol: fp32 outputs 1e-5 of max(1, max|ref|),
    bf16 dx and y one bf16 ulp of max|ref|), bit-identical twice; timed per
    call and by device time beside its plain version and
    torch.ops.aten.native_layer_norm_backward on fp32 copies with the
    forward's mean and rstd: the nearest library call, not the same function
    (no + g, no y)."""
    from rmcl_tpu_torch.models.vit import VIT_LN_EPS as eps
    c = _ln_bwd_case(dev, gen, dtype)
    x, dy, w, b = c["x"], c["dy"], c["ln_w"], c["ln_b"]
    M, C = x.shape
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    run, plain = _ln_bwd_calls(FB, lib, c, form, eps)
    out, again, ref = run(), run(), plain()
    torch.cuda.synchronize()
    errs = {}
    for n, o, o2, r in zip(("dx", "y", "dln_w", "dln_b"), out, again, ref):
        check(bool(torch.isfinite(o).all()), f"ln_bwd[{form}] {tag}: non-finite {n}")
        check(torch.equal(o, o2), f"ln_bwd[{form}] {tag}: {n} differs between two calls")
        errs[n] = (o.float() - r.float()).abs().max().item()
        tol = _sum_tol(r, o.dtype == torch.bfloat16)
        check(errs[n] <= tol, f"ln_bwd[{form}] {tag}: {n} error {errs[n]} > {tol}")
    x32 = x.float()
    _, mean, rstd = torch.ops.aten.native_layer_norm(x32, [C], w, b, eps)
    want = [True, form == "train", form == "train"]
    lib_call = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa: E731
        dy, x32, [C], mean, rstd, w, b, want)
    ms, dev_ms, plain_ms = time_ms(run), device_ms(run), time_ms(plain)
    lib_ms, lib_dev_ms = time_ms(lib_call), device_ms(lib_call)
    bound_ms, bound_by = _sub_bound(0.0, _ln_bwd_bytes(M, C, x.element_size(), form))
    shape = f"M={M} C={C} + g"
    if form == "train":   # the CTAs this device runs it on, which fix its summation order
        shape += f", {lib.rmcl_ln_bwd_grid(1 if tag == 'bf16' else 0, M, C)} CTAs"
    print(f"[kernels] ln_bwd[{form}] ({shape}) {tag}: kernel_ms={ms!r} device_ms={dev_ms!r} "
          f"({_rate(bound_ms, dev_ms, 'of the bound')}) plain_ms={plain_ms!r} "
          f"native_layer_norm_backward_ms={lib_ms!r} (device {lib_dev_ms!r}; fp32, no + g, "
          f"no y) bound_ms={bound_ms!r} ({bound_by}) max_abs_err={errs}; bit-identical twice")
    return dict(name=f"ln_bwd[{form}]", dtype=tag, shape=shape, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev_ms,
                library="torch.ops.aten.native_layer_norm_backward (fp32; the nearest call: "
                        "no + g, no y)",
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=errs["dx"], errors=errs)


def _colsum_sub(dev, FB, lib, gen, N: int, dtype) -> dict:
    """colsum at M = 16 x 241 rows of width N against _colsum_plain (fp32
    sums, 1e-5 of max(1, max|ref|)), bit-identical twice; timed per call and
    by device time beside its plain version and a.sum(0, dtype=float32)."""
    M = PGD_BATCH * 241
    a = (torch.randn(M, N, generator=gen, device=dev) + 0.5).to(dtype)
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    run = lambda: FB._colsum(lib, a)  # noqa: E731
    plain = lambda: FB._colsum_plain(a)  # noqa: E731
    lib_call = lambda: a.sum(0, dtype=torch.float32)  # noqa: E731
    out, again, ref = run(), run(), plain()
    torch.cuda.synchronize()
    err, tol = (out - ref).abs().max().item(), _sum_tol(ref, False)
    check(bool(torch.isfinite(out).all()) and torch.equal(out, again),
          f"colsum[{N}] {tag}: non-finite, or two calls differ")
    check(err <= tol, f"colsum[{N}] {tag}: error {err} > {tol}")
    ms, dev_ms, plain_ms = time_ms(run), device_ms(run), time_ms(plain)
    lib_ms, lib_dev_ms = time_ms(lib_call), device_ms(lib_call)
    bound_ms, bound_by = _sub_bound(0.0, M * N * a.element_size() + 4 * N)
    shape = f"M={M} N={N}"
    print(f"[kernels] colsum[{N}] ({shape}) {tag}: kernel_ms={ms!r} device_ms={dev_ms!r} "
          f"({_rate(bound_ms, dev_ms, 'of the bound')}) plain_ms={plain_ms!r} "
          f"sum_ms={lib_ms!r} (device {lib_dev_ms!r}) bound_ms={bound_ms!r} ({bound_by}) "
          f"max_abs_err={err!r} (tol {tol:.3g}); bit-identical twice")
    return dict(name=f"colsum[{N}]", dtype=tag, shape=shape, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev_ms,
                library="a.sum(0, dtype=torch.float32)", bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def _ln_colsum_kernels(dev, FB, lib) -> list:
    """ln_bwd in both forms and colsum at the bias gradients' widths, bf16 and
    fp32, with the four bias gradients of a step summed (bf16)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        out += [_ln_bwd_sub(dev, FB, lib, gen, form, dtype) for form in LN_BWD_FORMS]
        out += [_colsum_sub(dev, FB, lib, gen, N, dtype) for N in COLSUM_WIDTHS]
    by = {r["name"]: r for r in out if r["dtype"] == "bf16"}
    four = {k: sum(by[f"colsum[{N}]"][k] for N in BIAS_GRADS)
            for k in ("device_ms", "bound_ms", "library_device_ms")
            if all(by[f"colsum[{N}]"][k] is not None for N in BIAS_GRADS)}
    print(f"[kernels] colsum, the four bias gradients of a step (N = {BIAS_GRADS}), bf16: "
          f"{four}")
    return out


# demos/demo.py's sequence at B = 1: 19 x 19 patches of the 608 x 608 canvas,
# the class token and 40 text positions; vit="vit_small_patch16_224"'s heads
# (8 of D = 96, padded to 128 in both attention types) at its step's
# (B, S): 16 pairs of 14 x 22 patches + 1 + 40
DEMO_S = 19 * 19 + 1 + 40
D96_SHAPE = (PGD_BATCH, 14 * 22 + 1 + 40, 8, 96)


def _demo_shape_kernels(res, dev, FB, eps) -> None:
    """attn_half and mlp_half at the demos' B = 1, S = DEMO_S, fp32 and bf16,
    against their plain versions at phase 3's tolerances, bit-identical
    twice, timed per call and by device time beside their bound; in bf16 a
    trace of each (_trace: device time by kernel, the idle share)."""
    x, mask, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2), H = _block_inputs(dev, B=1,
                                                                           S=DEMO_S)
    shape = f"B=1 S={DEMO_S} C=768 H=12"
    for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"), (torch.bfloat16, 2e-2, "bf16")):
        xd = x.to(dtype)
        calls = {"attn_half": (FB.attn_half, FB.attn_half_plain,
                               (xd, mask, lw, lb, wq.to(dtype), bq, wp.to(dtype), bp, H, eps)),
                 "mlp_half": (FB.mlp_half, FB.mlp_half_plain,
                              (xd, lw, lb, w1.to(dtype), b1, w2.to(dtype), b2, eps))}
        for name, (op, plain, args) in calls.items():
            rec = _compare_all(name, tag, shape, lambda *a, op=op: (op(*a),),
                               lambda *a, plain=plain: (plain(*a),), args, rtol,
                               dtype == torch.float32, ("out",), True)
            rec["bound_ms"], rec["bound_by"] = bound(name, 1, DEMO_S, 768,
                                                     es=dtype.itemsize)
            rec["device_ms"] = device_ms(lambda op=op, args=args: op(*args))
            print(f"[kernels] {name} {tag} {shape}: bound_ms={rec['bound_ms']!r} "
                  f"({rec['bound_by']}; {rec['bound_ms'] / rec['ms']:.3f} of it per call), "
                  f"device_ms={rec['device_ms']!r} "
                  f"({_rate(rec['bound_ms'], rec['device_ms'], 'of the bound')})")
            if tag == "bf16":
                _trace(f"{name} bf16 {shape}", lambda op=op, args=args: op(*args), 20, top=6)
            res[name][f"{tag}_demo_shape"] = rec


def _attn_check(name, got, again, ref, fp32: bool) -> float:
    """Phase 3's attention tolerance: fp32 2e-4 of max(1, max|ref|)
    (_f32_check), bf16 2e-2 of max|ref|; bit-identical to a second call."""
    if fp32:
        return _f32_check(name, got, again, ref)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(torch.equal(got, again), f"{name}: two calls differ")
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2e-2 * ref.float().abs().max().item()
    check(err <= tol, f"{name}: error {err} > {tol}")
    return err


def _d96_attention(dev, FB, lib, gen) -> list:
    """The attention kernels at D96_SHAPE (H = 8, D = 96), bf16 and fp32,
    packed (rmcl_masked_attention_fwd / _bwd against mha on the same heads
    and _attn_dqkv_plain with Wproj = I) and on views of one qkv buffer
    (masked_attention / masked_attention_bwd against mha and
    masked_attention_bwd_plain), bit-identical twice; the packed forward and
    pair by time per call and device time beside their bound and
    F.scaled_dot_product_attention's forward and backward on the same heads
    (fp32 with TF32 off)."""
    import torch.nn.functional as F
    from rmcl_tpu_torch.ops import attention as A
    B, S, H, D = D96_SHAPE
    C, scale, shape = H * D, D ** -0.5, f"B={B} S={S} H={H} D={D}"
    out = []
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        fp32 = dtype == torch.float32
        qkv = torch.randn(B, S, 3 * C, generator=gen, device=dev).to(dtype)
        mask = (torch.rand(B, S, generator=gen, device=dev) > 0.3).int()
        mask[:, 0] = 1
        dattn = torch.randn(B, S, C, generator=gen, device=dev).to(dtype)
        q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
        g = dattn.view(B, S, H, D).transpose(1, 2).contiguous()
        att = torch.empty(B, S, C, device=dev, dtype=dtype)
        dqkv = torch.empty(B, S, 3 * C, device=dev, dtype=dtype)
        stats = torch.empty(B, H, S, 3, device=dev)
        fwd = lambda: FB._attn_fwd_packed(lib, qkv, mask, att, H)  # noqa: E731
        bwd = lambda: FB._attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, H)  # noqa: E731
        plain_fwd = lambda: A.mha(q, k, v, mask, scale).transpose(1, 2).reshape(B, S, C)  # noqa: E731
        eye = torch.eye(C, device=dev, dtype=dtype)
        plain_bwd = lambda: FB._attn_dqkv_plain(qkv, mask, eye, dattn, H)  # noqa: E731
        errs = {}
        for part, run, buf, plain in (("fwd", fwd, att, plain_fwd), ("bwd", bwd, dqkv, plain_bwd)):
            run()
            first = buf.clone()
            run()
            errs[f"{part} packed"] = _attn_check(f"attention_{part} {tag} packed {shape}", buf,
                                                 first, plain(), fp32)
        errs["fwd heads"] = _attn_check(f"attention_fwd {tag} heads {shape}",
                                        A.masked_attention(q, k, v, mask, scale),
                                        A.masked_attention(q, k, v, mask, scale),
                                        A.mha(q, k, v, mask, scale), fp32)
        ours, again = (A.masked_attention_bwd(q, k, v, mask, g, scale) for _ in range(2))
        ref = A.masked_attention_bwd_plain(q, k, v, mask, g, scale)
        errs["bwd heads"] = max(_attn_check(f"attention_bwd {tag} heads {shape} {n}", a, b, c,
                                            fp32)
                                for n, a, b, c in zip(("dq", "dk", "dv"), ours, again, ref))
        torch.cuda.synchronize()
        rec = dict(name=f"attention d96 {tag}", dtype=tag, shape=shape, max_abs_err=errs)
        for part, run, name in (("fwd", fwd, "masked_attention"),
                                ("bwd", bwd, "masked_attention_bwd")):
            b_ms, b_by = bound(name, B, S, C, es=dtype.itemsize)
            rec[part] = dict(ms=time_ms(run), device_ms=device_ms(run), bound_ms=b_ms,
                             bound_by=b_by)
        keep = (mask > 0)[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)  # noqa: E731
        lib_bwd_ms, lib_bwd_dev = _sdpa_backward_times(q, k, v, keep, g)
        rec["fwd"].update(library="F.scaled_dot_product_attention", library_ms=time_ms(sdpa),
                          library_device_ms=device_ms(sdpa))
        rec["bwd"].update(library="torch.autograd.grad of F.scaled_dot_product_attention",
                          library_ms=lib_bwd_ms, library_device_ms=lib_bwd_dev)
        timed = "; ".join(
            f"{p} kernel_ms={r['ms']!r} device_ms={r['device_ms']!r} "
            f"({_rate(r['bound_ms'], r['device_ms'], 'of the bound')}), {r['library']} "
            f"{r['library_ms']!r} ms (device {r['library_device_ms']!r})"
            for p, r in (("fwd", rec["fwd"]), ("bwd pair", rec["bwd"])))
        print(f"[kernels] attention {tag} ({shape}, packed and heads): max_abs_err {errs} "
              f"within phase 3's tolerance, bit-identical twice; packed {timed}")
        out.append(rec)
    return out


# ln_stats_kernel's rows: the step's M and the greedy scoring forward's
LN_STATS_ROWS = ((PGD_BATCH, 241), (GREEDY_ROWS, GREEDY_S))


def _ln_stats_subs(dev, FB, lib, gen) -> list:
    """ln_stats_kernel, the (mean, rstd) pass of every fp32 ln_gemm with a
    LayerNorm, at LN_STATS_ROWS, C = 768: the statistics it writes (read back
    through rmcl_ln_gemm with a scratch of ours, as _gemm calls it) against
    torch.var_mean's (2e-4 of max(1, max|ref|)), bit-identical twice; its
    device time inside ln_gemm[qkv] by kernel name beside its byte bound (M
    C x 4 bytes read, M x 2 x 4 written, over 3.35 TB/s), its plain version
    and torch.var_mean(x, -1, unbiased=False)'s device time."""
    out = []
    for B, S in LN_STATS_ROWS:
        c = _ln_gemm_case(dev, FB, gen, 2304, 768, "ln", torch.float32, B, S)
        a, M, (ln_w, ln_b), eps = c["a"], c["M"], c["kw"]["ln"], c["kw"]["eps"]
        K = a.shape[1]
        scratch = [torch.empty(M, 2, device=dev) for _ in range(2)]
        for st in scratch:
            rc = lib.rmcl_ln_gemm(FB._DTYPE_CODE[a.dtype], a.data_ptr(), ln_w.data_ptr(),
                                  ln_b.data_ptr(), eps, st.data_ptr(), c["w"].data_ptr(),
                                  c["bias"].data_ptr(), None, None, c["out"].data_ptr(), M,
                                  c["w"].shape[0], K, 0, FB._EPI_BIAS, 0, *FB._drop_args(None),
                                  FB._stream(a))
            check(rc == 0, f"rmcl_ln_gemm returned {rc}")

        def plain():
            var, mean = torch.var_mean(a, -1, unbiased=False)
            return torch.stack([mean, torch.rsqrt(var + eps)], -1)
        torch.cuda.synchronize()
        name = f"ln_stats[M={M}] fp32"
        err = _f32_check(name, scratch[0], scratch[1], plain())
        run = lambda: FB._gemm(lib, a, c["w"], c["bias"], c["out"], **c["kw"])  # noqa: E731
        lib_call = lambda: torch.var_mean(a, -1, unbiased=False)  # noqa: E731
        bound_ms, bound_by = _sub_bound(0.0, 4 * M * K + 8 * M, 0.0, PEAK_FP32_FLOPS)
        rec = dict(name=name, dtype="fp32", shape=f"M={M} C={K}", M=M, max_abs_err=err,
                   device_ms=device_ms(run, kernel="ln_stats_kernel"), plain_ms=time_ms(plain),
                   library="torch.var_mean", library_ms=time_ms(lib_call),
                   library_device_ms=device_ms(lib_call), bound_ms=bound_ms, bound_by=bound_by)
        print(f"[kernels] {name} (C={K}): max_abs_err={err!r} within 2e-4 of max(1, max|ref|), "
              f"bit-identical twice; device_ms={rec['device_ms']!r} "
              f"({_rate(bound_ms, rec['device_ms'], 'of the bound')}) plain_ms="
              f"{rec['plain_ms']!r} torch.var_mean device_ms={rec['library_device_ms']!r} "
              f"bound_ms={bound_ms!r} ({bound_by})")
        out.append(rec)
    return out


def _library_yardsticks(dev, FB, x, mask, wqkv, bqkv, H) -> list:
    """The device sub-kernels at the attack's and the step's shapes, bf16:
    every GEMM instance of the main path against its plain version, with its
    bound, beside the one PyTorch call of its product; the packed attention
    forward and backward beside F.scaled_dot_product_attention's; the
    LayerNorm backward and the column sums (_ln_colsum_kernels)."""
    from rmcl_tpu_torch.ops import _build
    lib = _build.library()
    B, S, C = x.shape
    M, D = B * S, C // H
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = [_ln_gemm_sub(dev, FB, lib, gen, *sub) for sub in LN_GEMM_SUBS]
    out += [_gemm_tn_sub(dev, FB, lib, gen, *sub) for sub in GEMM_TN_SUBS]
    qkv = torch.empty(M, 3 * C, device=dev, dtype=torch.bfloat16)
    FB._gemm(lib, x.view(M, C), wqkv, bqkv, qkv)
    out.append(_attention_fwd_sub(dev, FB, lib, qkv.view(B, S, 3 * C), mask, H))
    out.append(_attention_bwd_sub(dev, FB, lib, gen, qkv.view(B, S, 3 * C), mask, H))
    torch.backends.cuda.matmul.allow_tf32 = False      # the plain fp32 products
    out += _f32_gemm_subs(dev, FB, lib, gen)
    out += _f32_attention_subs(dev, FB, lib, gen)
    out += _d96_attention(dev, FB, lib, gen)
    out += _ln_stats_subs(dev, FB, lib, gen)
    return out + _ln_colsum_kernels(dev, FB, lib)


def _attention_fwd_sub(dev, FB, lib, qkv, mask, H) -> dict:
    """The bf16 attention forward on the packed layout, as the block halves
    launch it (rows 1, 8, 2), against mha on the same heads merged back to
    (B, S, C) (bf16 2e-2 of max|ref|), bit-identical twice; timed per call
    and by device time beside its plain version and
    F.scaled_dot_product_attention on the same heads (row 10's yardstick)."""
    import torch.nn.functional as F
    from rmcl_tpu_torch.ops import attention as A
    B, S, C3 = qkv.shape
    C = C3 // 3
    D = C // H
    att = torch.empty(B, S, C, device=dev, dtype=torch.bfloat16)
    run = lambda: FB._attn_fwd_packed(lib, qkv, mask, att, H)  # noqa: E731
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    plain = lambda: A.mha(q, k, v, mask, D ** -0.5).transpose(1, 2).reshape(B, S, C)  # noqa: E731
    keep = (mask > 0)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)  # noqa: E731
    run()
    first = att.clone()
    run()
    ref = plain()
    torch.cuda.synchronize()
    check(torch.equal(first, att), "attention_fwd: two calls differ")
    err = (att.float() - ref.float()).abs().max().item()
    tol = 2e-2 * ref.float().abs().max().item()
    check(bool(torch.isfinite(att).all()) and err <= tol, f"attention_fwd: error {err} > {tol}")
    sdpa_err = (att.view(B, S, H, D).float() - sdpa().transpose(1, 2).float()).abs().max().item()
    ms, dev_ms, plain_ms = time_ms(run), device_ms(run), time_ms(plain)
    lib_ms, lib_dev_ms = time_ms(sdpa), device_ms(sdpa)
    bound_ms, bound_by = bound("masked_attention", B, S, C)
    shape = f"B={B} S={S} H={H} D={D}"
    print(f"[kernels] attention_fwd (packed, {shape}) bf16: kernel_ms={ms!r} device_ms="
          f"{dev_ms!r} ({_rate(bound_ms, dev_ms, 'of the bound')}) plain_ms={plain_ms!r} "
          f"sdpa_ms={lib_ms!r} (device {lib_dev_ms!r}) bound_ms={bound_ms!r} ({bound_by}) "
          f"max_abs_err={err!r} (tol {tol:.3g}; against SDPA {sdpa_err!r}); "
          f"bit-identical twice")
    return dict(name="attention_fwd", shape=shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                library="F.scaled_dot_product_attention", bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def _attention_bwd_sub(dev, FB, lib, gen, qkv, mask, H) -> dict:
    """The bf16 attention backward pair on the packed layout, as the dx and
    training backwards launch it (rows 3, 9, 2), against _attn_dqkv_plain
    with Wproj the identity (so that dattn = g exactly), bf16 2e-2 of
    max|ref|, bit-identical twice; timed per call and by device time beside
    its plain version and the backward of F.scaled_dot_product_attention on
    the same heads (through torch.autograd.grad)."""
    B, S, C3 = qkv.shape
    C, M = C3 // 3, B * S
    D = C // H
    dattn = torch.randn(B, S, C, generator=gen, device=dev).bfloat16()
    dqkv = torch.empty(M, C3, device=dev, dtype=torch.bfloat16)
    stats = torch.empty(B, H, S, 3, device=dev, dtype=torch.float32)
    eye = torch.eye(C, device=dev, dtype=torch.bfloat16)
    run = lambda: FB._attn_bwd_packed(lib, qkv, mask, dattn, dqkv, stats, H)  # noqa: E731
    plain = lambda: FB._attn_dqkv_plain(qkv, mask, eye, dattn, H)  # noqa: E731
    run()
    first = dqkv.clone()
    run()
    ref = plain()
    torch.cuda.synchronize()
    check(torch.equal(first, dqkv), "attention_bwd: two calls differ")
    diff = (dqkv.float().view(B, S, C3) - ref.float()).abs()
    err = diff.max().item()
    tol = 2e-2 * ref.float().abs().max().item()
    check(bool(torch.isfinite(dqkv).all()) and err <= tol, f"attention_bwd: error {err} > {tol}")
    # dq comes from bwd_dq, dk and dv from bwd_dkv, each from its own s = q.k^T
    parts = {n: diff[..., i * C:(i + 1) * C].max().item() for i, n in enumerate(("dq", "dk", "dv"))}
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    lib_ms, lib_dev_ms = _sdpa_backward_times(q, k, v, (mask > 0)[:, None, None, :],
                                              dattn.view(B, S, H, D).transpose(1, 2))
    ms, dev_ms, plain_ms = time_ms(run), device_ms(run), time_ms(plain)
    bound_ms, bound_by = bound("masked_attention_bwd", B, S, C)
    shape = f"B={B} S={S} H={H} D={D}"
    print(f"[kernels] attention_bwd (packed, {shape}) bf16: kernel_ms={ms!r} device_ms="
          f"{dev_ms!r} ({_rate(bound_ms, dev_ms, 'of the bound')}) plain_ms={plain_ms!r} "
          f"sdpa_backward_ms={lib_ms!r} (device {lib_dev_ms!r}) bound_ms={bound_ms!r} "
          f"({bound_by}) max_abs_err={err!r} (tol {tol:.3g}; by output {parts}); "
          f"bit-identical twice")
    return dict(name="attention_bwd", shape=shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                library="torch.autograd.grad of F.scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


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
    from rmcl_tpu_torch.serve import Session, postprocess

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
          f"launches {counts}, sub-kernels {FB.sub_launches}")
    for name in ("attn_half", "mlp_half"):
        check(counts[name] == cfg.num_layers * passes,
              f"{name} launched {counts[name]} times, expected "
              f"{cfg.num_layers} x {passes}")
    counts = check_sub_launches("serving", counts, FB)
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
    READINGS["serving"] = (statistics.median(lat), rps)
    print(f"[serving] {len(recs)} postprocess records; first call {wall:.3f} s; "
          f"median batch-{BATCH} latency {statistics.median(lat)!r} ms; "
          f"{rps!r} requests/s (median of 5 runs of {N_REQUESTS})")
    return sess, counts


def phase_slice(cfg, cpu_state, sess, reqs, dev) -> tuple:
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
    return cpu32, gpu32


# ------------------------------------------------------------------- PGD
def pgd_batch(cfg, n: int, seed: int, dev) -> dict:
    """n pairs for the attack: normalised float32 patch rows (zero outside
    each image's valid size) and padded text, on ``dev``."""
    from rmcl_tpu_torch.models.vit import normalize_u8
    reqs = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_requests(cfg, n, seed).items()}
    img = normalize_u8(reqs["image"], reqs["image_hw"], cfg.grid_hw, cfg.patch_size)
    return {"image": img, "text_ids": reqs["text_ids"], "text_masks": reqs["text_masks"]}


def moco_keys(model, batch) -> torch.Tensor:
    from rmcl_tpu_torch.objectives.losses import l2_normalize
    with torch.inference_mode():
        k = l2_normalize(model.k_moco_head(model.infer_k(batch)["cls_feats"]), dim=1)
    return k.clone()


def moco_loss(model, batch, img, k, temperature) -> float:
    from rmcl_tpu_torch.objectives.contrastive import infonce
    from rmcl_tpu_torch.objectives.losses import l2_normalize
    with torch.inference_mode():
        q = l2_normalize(model.moco_head(model.infer(dict(batch, image=img))["cls_feats"]),
                         dim=1)
        return infonce(q, k, model.proj_queue, temperature)[0].item()


def live_patches(model, cfg, img) -> torch.Tensor:
    """(B, N) bool: patches that are valid and selected, where delta may be non-zero."""
    prep = model.transformer.visual_embed_prepare(img, cfg.grid_hw, cfg.max_image_len)
    valid = prep.x_mask[:, 1:] > 0
    if prep.sel is None:
        return valid
    return torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device).scatter_(
        1, prep.sel, valid)


def moco_model(cfg):
    """A seeded task_moco model on the CPU with a seeded queue of l2-normalised
    keys and momentum twins that differ from the query side."""
    from rmcl_tpu_torch.serve import seeded_model
    model = seeded_model(cfg, SEED).eval()
    g = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        q = torch.nn.functional.normalize(torch.randn(model.proj_queue.shape, generator=g),
                                          dim=0)
        model.proj_queue.copy_(q.to(model.proj_queue.dtype))
        for p in model.k_transformer.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return model


def pgd_setup(dev) -> tuple:
    """The attack's model (seeded, on ``dev``), its CPU state, 16 pairs, their
    keys and the attack closure."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.attacks.pgd import make_pgd_moco
    cfg = build_config(PGD_CONFIG)
    model = moco_model(cfg)
    cpu_state = copy.deepcopy(model.state_dict())
    model = model.to(dev)
    batch = pgd_batch(cfg, PGD_BATCH, SEED + 4, dev)
    k = moco_keys(model, batch)
    attack = make_pgd_moco(model, cfg.adv_steps_img, cfg.adv_lr_img, cfg.adv_max_norm_img,
                           cfg.temperature, fast=True)
    attack(batch, k, model.proj_queue)                     # warm-up
    torch.cuda.synchronize()
    return cfg, model, cpu_state, batch, k, attack


def phase_pgd(dev) -> tuple:
    from rmcl_tpu_torch.ops import fused_block as FB
    t0 = time.perf_counter()
    cfg, model, cpu_state, batch, k, attack = pgd_setup(dev)
    print(f"[pgd] {PGD_CONFIG}: model, queue {tuple(model.proj_queue.shape)} "
          f"{model.proj_queue.dtype}, {PGD_BATCH} pairs and keys ready in "
          f"{time.perf_counter() - t0:.1f} s; S = {cfg.seq_len}")

    FB.reset_launches()
    delta = attack(batch, k, model.proj_queue)
    torch.cuda.synchronize()
    counts = dict(FB.launches)
    want = cfg.num_layers * cfg.adv_steps_img
    print(f"[pgd] {cfg.adv_steps_img} steps, {PGD_BATCH} pairs, bf16: launches {counts}")
    for name in counts:
        expect = want if name in ("attn_half", "mlp_half", "attn_half_dx", "mlp_half_dx") else 0
        check(counts[name] == expect, f"{name} launched {counts[name]} times in the attack, "
                                      f"expected {expect}")
    print(f"[pgd] sub-kernels {FB.sub_launches}")
    counts = check_sub_launches("pgd", counts, FB)

    check(delta.shape == batch["image"].shape, f"delta shape {tuple(delta.shape)}")
    check(bool(torch.isfinite(delta).all()), "non-finite delta")
    dmax = delta.abs().max().item()
    check(0 < dmax <= cfg.adv_max_norm_img + 1e-6, f"max|delta| = {dmax}")
    live = live_patches(model, cfg, batch["image"])
    off = delta[~live].abs().max().item() if bool((~live).any()) else 0.0
    check(off == 0.0, f"delta is {off} on padding or unselected patches")
    moved = (delta.abs().amax(dim=-1) > 0)[live].float().mean().item()
    clean = moco_loss(model, batch, batch["image"], k, cfg.temperature)
    adv = moco_loss(model, batch, batch["image"] + delta, k, cfg.temperature)
    print(f"[pgd] max|delta|={dmax!r}; {int(live.sum())} live patches of "
          f"{live.numel()}, {moved:.3f} of them moved, delta 0 elsewhere; "
          f"InfoNCE clean={clean!r} attacked={adv!r}")
    check(adv > clean, f"InfoNCE did not rise: {clean} -> {adv}")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        attack(batch, k, model.proj_queue)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(walls)
    print(f"[pgd] attack {ms!r} ms, {ms / cfg.adv_steps_img!r} ms per iteration "
          f"(median of 3; forward + dx backward of {cfg.num_layers} blocks, heads, "
          f"InfoNCE over the queue, the step)")
    return cfg, cpu_state, counts


def _delta_check(what: str, ref: torch.Tensor, ours: torch.Tensor, bound_: float) -> None:
    diff = (ours.cpu() - ref).abs()
    worst = diff.max().item()
    tight = (diff <= DELTA_TIGHT).float().mean().item()
    print(f"[pgd slice] {what}: max|delta|={ref.abs().max().item()!r} (bound {bound_}); "
          f"card fp32 kernels vs CPU fp32 plain max_abs_diff={worst!r} (tol {DELTA_TOL}), "
          f"{tight:.5f} of the elements within {DELTA_TIGHT} (need {DELTA_TIGHT_SHARE})")
    check(ref.abs().max().item() > 0, f"{what}: the CPU attack did not move")
    check(worst <= DELTA_TOL, f"{what}: delta differs by {worst} > {DELTA_TOL}")
    check(tight >= DELTA_TIGHT_SHARE, f"{what}: only {tight} of delta within {DELTA_TIGHT}")


def phase_pgd_slice(cfg, cpu_state, vqa_cfg, vqa_cpu32, vqa_gpu32, dev) -> None:
    from rmcl_tpu_torch.attacks.pgd import make_pgd_moco, make_pgd_vqa
    from rmcl_tpu_torch.models.vilt import ViLT
    cfg32 = cfg.replace(compute_dtype="float32", queue_dtype="float32")
    cpu32 = ViLT(cfg32).eval()
    cpu32.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in cpu_state.items()})
    gpu32 = copy.deepcopy(cpu32).to(dev)
    batch = pgd_batch(cfg, N_CPU, SEED + 4, "cpu")
    on_dev = {k: v.to(dev) for k, v in batch.items()}
    k = moco_keys(cpu32, batch)
    args = (cfg.adv_steps_img, cfg.adv_lr_img, cfg.adv_max_norm_img, cfg.temperature)
    t0 = time.perf_counter()
    ref = make_pgd_moco(cpu32, *args)(batch, k, cpu32.proj_queue)
    cpu_s = time.perf_counter() - t0
    ours = make_pgd_moco(gpu32, *args)(on_dev, k.to(dev), gpu32.proj_queue)
    torch.cuda.synchronize()
    _delta_check(f"make_pgd_moco, {N_CPU} pairs, {args[0]} steps (CPU {cpu_s:.1f} s)",
                 ref, ours, cfg.adv_max_norm_img)

    # one BCE-ascent step on the serving phase's fp32 VQA models
    vb = pgd_batch(vqa_cfg, N_CPU, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED + 5)
    targets = torch.rand(N_CPU, vqa_cfg.vqav2_label_size, generator=gen)
    targets = torch.where(targets > 0.999, targets, 0.0)
    vargs = (1, cfg.adv_lr_img, cfg.adv_max_norm_img, vqa_cfg.vqav2_label_size)
    ref = make_pgd_vqa(vqa_cpu32, *vargs)(vb, targets)
    ours = make_pgd_vqa(vqa_gpu32, *vargs)({k_: v.to(dev) for k_, v in vb.items()},
                                           targets.to(dev))
    torch.cuda.synchronize()
    _delta_check(f"make_pgd_vqa, {N_CPU} requests, 1 step", ref, ours, cfg.adv_max_norm_img)


# ----------------------------------------------------------------- train
def train_batch(cfg, n: int, seed: int, dev) -> dict:
    """``pgd_batch`` plus attacked text: three tokens of each caption (never
    [CLS], [SEP] or padding) substituted, as a word-substitution attack leaves it."""
    batch = pgd_batch(cfg, n, seed, dev)
    r = np.random.RandomState(seed + 100)
    ids = batch["text_ids"].cpu().numpy().copy()
    lens = batch["text_masks"].cpu().numpy().sum(1)
    for i, L in enumerate(lens):
        pos = 1 + r.choice(L - 2, size=min(3, L - 2), replace=False)
        ids[i, pos] = r.randint(1000, cfg.vocab_size, len(pos))
    batch["attacked_text_ids"] = torch.from_numpy(ids).to(dev)
    batch["attacked_text_masks"] = batch["text_masks"]
    return batch


def train_config(config: str = "default"):
    from rmcl_tpu_torch import build_config
    return build_config(PGD_CONFIG, image_view=True, text_view=True, drop_rate=DROP_P,
                        warmup_steps=0, max_steps=1000, **IMPLS[config])


def expected_launches(cfg) -> dict:
    """Kernel launches of one training step of ``cfg`` (drop_rate > 0): the
    key forward and the PGD's forwards and backwards run the deterministic
    blocks, the views the training blocks (``models/vit.py:Block``): task_moco
    four forward (the clean view without a backward) and three backward,
    task_barlowtwins three and three; every embedding dropout runs the
    dropout op, text and image, each view forward and backward."""
    from rmcl_tpu_torch.core.config import active_tasks
    from rmcl_tpu_torch.models.vilt import derive_block_impls
    from rmcl_tpu_torch.ops import fused_block as FB
    attn, mlp = derive_block_impls(cfg)
    L, A = cfg.num_layers, cfg.adv_steps_img
    n_f = 4 if "moco" in active_tasks(cfg) else 3
    det_f, det_b, view_f, view_b = L + L * A, L * A, n_f * L, 3 * L
    want = dict.fromkeys(FB.launches, 0)
    want.update(mlp_half=det_f, mlp_half_dx=det_b, dropout=2 * n_f + 2 * 3)
    if attn == "fused":
        want.update(attn_half=det_f, attn_half_dx=det_b)
        if mlp == "fused_train":
            want.update(attn_half_train=view_f, attn_half_train_bwd=view_b)
        else:
            want.update(attn_half_full=view_f, attn_half_full_bwd=view_b)
            want["dropout"] += view_f + view_b
    else:
        want.update(masked_attention=det_f + view_f, masked_attention_bwd=det_b + view_b)
        want["dropout"] += view_f + view_b
    if mlp == "fused_train":
        want.update(mlp_half_train=view_f, mlp_half_train_bwd=view_b)
    else:
        want["dropout"] += 2 * (view_f + view_b)
    return want


def expected_sub_launches(ops: dict, lead: bool = True) -> dict:
    """Sub-kernel launches under block ops launched ``ops`` times, in bf16:
    two ln_gemm in every block op (the two products of a forward; the two
    g . W products of a dx op, whose forward kept qkv / h; those of a full
    backward), two gemm_tn (the weight gradients) in every full backward, and
    none in the attention core or the dropout op; the attention forward in
    every op whose forward runs attention, the attention backward pair in
    every op that differentiates through it; one ln_bwd (the LayerNorm
    backward) in every dx op and full backward, and two colsum (the bias
    gradients) in every full backward, one on a tensor-parallel shard that is
    not the first (``lead`` off: the row-parallel bias is the first's)."""
    full_bwd = ("attn_half_train_bwd", "mlp_half_train_bwd", "attn_half_full_bwd")
    dx = ("attn_half_dx", "mlp_half_dx")
    other = ("masked_attention", "masked_attention_bwd", "dropout")
    attn_fwd = ("attn_half", "attn_half_train", "attn_half_full", "masked_attention")
    attn_bwd = ("attn_half_dx", "attn_half_train_bwd", "attn_half_full_bwd",
                "masked_attention_bwd")
    return {"ln_gemm": 2 * sum(n for op, n in ops.items() if op not in other),
            "gemm_tn": 2 * sum(ops.get(op, 0) for op in full_bwd),
            "attention_fwd": sum(ops.get(op, 0) for op in attn_fwd),
            "attention_bwd": sum(ops.get(op, 0) for op in attn_bwd),
            "ln_bwd": sum(ops.get(op, 0) for op in dx + full_bwd),
            "colsum": (2 if lead else 1) * sum(ops.get(op, 0) for op in full_bwd)}


def check_sub_launches(where: str, ops: dict, FB, lead: bool = True) -> dict:
    """The sub-kernels' counters against the ops' counters; both merged."""
    subs, want = dict(FB.sub_launches), expected_sub_launches(ops, lead)
    check(subs == want, f"{where}: sub-kernel launches {subs}, expected {want}")
    return {**ops, **subs}


class _StepClock:
    """CUDA events at the attacks' and the optimizer's boundaries inside a
    training step, so that one step splits into key forward / greedy attack /
    PGD / views / optimizer without a timing hook in the package.  Install
    it before the step is made: ``greedy``'s attack body is wrapped in place."""

    def __init__(self, ts, greedy=None):
        import rmcl_tpu_torch.train.step as step_mod
        self.ev = {}
        self.key = ("momentum update + key forward" if hasattr(ts.model, "k_transformer")
                    else "key forward")
        self._restore = []
        for name in ("make_pgd_moco", "make_pgd_barlowtwins"):
            make = getattr(step_mod, name)

            def timed_make(*a, make=make, **kw):
                attack = make(*a, **kw)

                def timed_attack(*aa, **kk):
                    self.mark("attack0")
                    out = attack(*aa, **kk)
                    self.mark("attack1")
                    return out
                return timed_attack

            self._restore.append(lambda name=name, make=make: setattr(step_mod, name, make))
            setattr(step_mod, name, timed_make)
        if greedy is not None:
            body = greedy._attack

            def timed_greedy(*a, **kw):
                self.mark("greedy0")
                out = body(*a, **kw)
                self.mark("greedy1")
                return out
            greedy._attack = timed_greedy
            self._restore.append(lambda: delattr(greedy, "_attack"))
        self._hooks = [
            ts.optimizer.register_step_pre_hook(lambda *_: self.mark("opt0")),
            ts.optimizer.register_step_post_hook(lambda *_: self.mark("opt1"))]

    def mark(self, name):
        self.ev[name] = torch.cuda.Event(enable_timing=True)
        self.ev[name].record()

    def split(self) -> dict:
        t = lambda a, b: self.ev[a].elapsed_time(self.ev[b])  # noqa: E731
        if "greedy0" in self.ev:
            head = {self.key: t("start", "greedy0"),
                    "greedy text attack": t("greedy0", "greedy1"),
                    "PGD attack": t("greedy1", "attack1")}
        else:
            head = {self.key: t("start", "attack0"),
                    "attack": t("attack0", "attack1")}
        views = ("four views forward, three backward" if self.key != "key forward"
                 else "three views forward and backward")
        return {**head,
                views: t("attack1", "opt0"),
                "AdamW": t("opt0", "opt1"),
                "recast of the block matrices, metrics": t("opt1", "end")}

    def close(self):
        for restore in self._restore:
            restore()
        for h in self._hooks:
            h.remove()


def train_setup(dev, config: str = "default", mix=None, model=None) -> tuple:
    """(cfg, ts, batch, greedy, make_step) of the training phases.  With a
    caption ``mix`` the batch carries the mix's captions and the greedy
    attack's tables, ``greedy`` is the fused attacker and ``make_step()``
    makes the attacked step; else the batch carries seeded attacked ids and
    ``make_step()`` makes ``make_train_step``'s step.  ``model``: a CPU
    moco_model(cfg) to copy (default: made here)."""
    from rmcl_tpu_torch.train.step import (create_train_state, make_attacked_train_step,
                                           make_train_step)
    cfg = train_config(config)
    model = copy.deepcopy(model) if model is not None else moco_model(cfg)
    ts = create_train_state(cfg, model=model, device=dev)
    batch = train_batch(cfg, PGD_BATCH, SEED + 4, dev)
    if mix is None:
        return cfg, ts, batch, None, lambda: make_train_step(cfg, ts)
    greedy, batch, _ = attacked_batch(cfg, ts.model, batch, mix)
    return cfg, ts, batch, greedy, lambda: make_attacked_train_step(cfg, ts, greedy)


def _expected_keys(model, batch, old_pooler) -> torch.Tensor:
    """The keys of the step just taken: the twins are as its momentum update
    left them, but the shared pooler has since been trained, so the key
    forward runs with the pooler the step had."""
    from rmcl_tpu_torch.objectives.losses import l2_normalize
    new_pooler = copy.deepcopy(model.pooler.state_dict())
    model.pooler.load_state_dict(old_pooler)
    with torch.no_grad():
        k = l2_normalize(model.k_moco_head(model.infer_k(batch)["cls_feats"]), dim=1)
    model.pooler.load_state_dict(new_pooler)
    return k


def phase_train(dev, config: str = "default", mix=None) -> dict:
    from rmcl_tpu_torch.ops import fused_block as FB
    t0 = time.perf_counter()
    cfg, ts, batch, greedy, make_step = train_setup(dev, config, mix)
    model = ts.model
    tag = (f"[train attacked {mix}]" if mix else
           f"[train {config}]" if config != "default" else "[train]")
    gen = torch.Generator().manual_seed(SEED + 7)
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"{tag} {PGD_CONFIG}, blocks {model.block_impls}, image and text views, drop_rate "
          f"{cfg.drop_rate}, {n_train / 1e6:.1f} M trainable parameters, {PGD_BATCH} pairs, "
          f"state ready in {time.perf_counter() - t0:.1f} s"
          + (f"; the greedy attack inside the step, {mix} captions, text bucket "
             f"{batch['gw_tbucket'].shape[1]} of {cfg.max_text_len}" if mix else ""))
    clock = _StepClock(ts, greedy)
    walls, splits, counts, stats = [], [], None, []
    try:
        step = make_step()
        step(batch, gen)                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for it in range(TRAIN_STEPS):
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            old_pooler = copy.deepcopy(model.pooler.state_dict())
            ptr0 = int(model.proj_queue_ptr)
            FB.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            clock.mark("start")
            metrics = step(batch, gen)
            clock.mark("end")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            splits.append(clock.split())
            counts = dict(FB.launches)
            want = expected_launches(cfg)
            if greedy is not None:     # the attack's own count of its passes
                stats.append(dict(greedy.last_stats))
                attack = attack_launches(stats[-1], cfg.num_layers)
                want = {k: want[k] + attack[k] for k in want}
            check(counts == want, f"step {it}: launches {counts}, expected {want}")
            counts = check_sub_launches(f"{tag} step {it}", counts, FB)
            vals = {k: v.item() for k, v in metrics.items()}
            bad = [k for k, v in vals.items() if not np.isfinite(v)]
            check(not bad, f"step {it}: non-finite metrics {bad}")
            # parameters: the trained ones moved, the twins by the momentum step only
            m = cfg.momentum
            for n, p in model.named_parameters():
                moved = (p.detach() - before[n]).abs().max().item()
                if n.startswith("k_"):
                    gap = (before[n[2:]] - before[n]).abs().max().item()
                    check(moved <= (1 - m) * gap * 1.001 + 1e-7,
                          f"step {it}: twin {n} moved {moved}, momentum allows {(1 - m) * gap}")
                elif not n.endswith("mask_token"):     # mask_token: MPP only, zero, unused
                    check(moved > 0, f"step {it}: {n} did not move")
            # queue: the pointer advanced and the written columns are the keys
            ptr1 = int(model.proj_queue_ptr)
            check(ptr1 == (ptr0 + PGD_BATCH) % cfg.num_negative, f"pointer {ptr0} -> {ptr1}")
            k = _expected_keys(model, batch, old_pooler)
            written = model.proj_queue[:, ptr0:ptr0 + PGD_BATCH].t().float()
            kdiff = (written - k.to(model.proj_queue.dtype).float()).abs().max().item()
            check(kdiff <= 1e-6, f"step {it}: queue columns differ from the keys by {kdiff}")
            greedy_note = ""
            if greedy is not None:
                greedy_note = (f" num_changes={vals['num_changes']!r} change_rate="
                               f"{vals['change_rate']!r}; attack {stats[-1]};")
            print(f"{tag} step {it}: total_loss={vals['total_loss']!r} txt/img/both "
                  f"{vals['attacked_txt_loss']:.4f}/{vals['attacked_img_loss']:.4f}/"
                  f"{vals['attacked_both_loss']:.4f} lr={vals['lr']!r} pgd_delta="
                  f"{vals['pgd_delta']:.5f};{greedy_note} pointer {ptr0} -> {ptr1}, keys "
                  f"written exactly; {walls[-1]:.1f} ms")
    finally:
        clock.close()
    ms = statistics.median(walls)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    # device -> host reads per step: none in the step itself, the greedy
    # attack's own (one per loop and one at its start)
    reads = statistics.median(st["host_reads"] for st in stats) if stats else 0
    print(f"{tag} launches per step {counts}: every block through the kernels")
    print(f"{tag} step {ms!r} ms (median of {TRAIN_STEPS}, host clock + synchronize), "
          f"{PGD_BATCH / ms * 1e3!r} pairs/s; max_memory_allocated {mem:.2f} GiB; host "
          f"reads per step {reads}")
    print(f"{tag} split of a step by CUDA events, ms (median): "
          + "; ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return counts, {"ms": ms, "mem_gib": mem, "host_reads": reads}


def _loss_result(tag, results: dict, dev, pairs: int = N_CPU) -> None:
    """The loss of one step on the CPU and on the card within 1e-5 relative:
    results maps "cpu" and str(dev) to (loss, gradients, updated leaves,
    seconds)."""
    (l_ref, _, _, cpu_s), (l_gpu, _, _, _) = results["cpu"], results[str(dev)]
    rel = abs(l_gpu - l_ref) / abs(l_ref)
    print(f"{tag} {pairs} pairs, fp32, one step: CPU plain ops ({cpu_s:.1f} s) loss "
          f"{l_ref!r}, card kernels {l_gpu!r}, relative difference {rel!r} (tol 1e-5)")
    check(rel <= 1e-5, f"loss differs by {rel} relative")


def _train_results(tag, results: dict, dev, lr: float, rate=None, pairs: int = N_CPU) -> None:
    """Phase 9's comparison of one step on the CPU and on the card: the loss
    (_loss_result), then every gradient and updated leaf within 2e-4 *
    max(1, max|ref|).  With ``rate`` (path -> the leaf's learning rate;
    phase 17, whose heads train at lr x lr_mult = 1e-3) the updated leaves
    are held as AdamW's first step moves them, each element by about its
    rate times the sign of its gradient: within 2% of the rate where the
    gradient is firm (above 1e-4 of its tensor's largest and of the model's
    largest), within 2.5 x the rate where a rounding-level gradient may
    take either sign (tests/test_torch_downstream.py's rule)."""
    _loss_result(tag, results, dev, pairs)
    (_, g_ref, p_ref, _), (_, g_gpu, p_gpu, _) = results["cpu"], results[str(dev)]

    def worst(ours, ref, what):
        """(path, error / 2e-4 * max(1, max|ref|)) of the worst leaf."""
        check(set(ours) == set(ref), f"{what}: leaves differ")
        w = ("", 0.0)
        for path, r in ref.items():
            err = float(np.abs(ours[path] - r).max())
            tol = 2e-4 * max(1.0, float(np.abs(r).max()))
            check(err <= tol, f"{what} {path}: {err} > {tol}")
            w = max(w, (path, err / tol), key=lambda t: t[1])
        return w

    def worst_adamw(ours, ref):
        """(path, error / bound) of the worst leaf under AdamW's bounds."""
        check(set(ours) == set(ref), "updated leaf: leaves differ")
        top = max(float(np.abs(g).max()) for g in g_ref.values())
        w = ("", 0.0)
        for path, r in ref.items():
            err = np.abs(ours[path] - r)
            g = np.abs(g_ref[path]) if path in g_ref else np.zeros_like(r)
            firm = (g > 1e-4 * max(float(g.max()), 1e-30)) & (g > 1e-4 * top)
            ratio = max(float(err[firm].max(initial=0.0)) / (0.02 * rate(path)),
                        float(err.max()) / (2.5 * rate(path)))
            check(ratio <= 1.0, f"updated leaf {path}: {float(err.max())} beyond AdamW's "
                                f"bounds at rate {rate(path)}")
            w = max(w, (path, ratio), key=lambda t: t[1])
        return w

    wg = worst(g_gpu, g_ref, "gradient")
    wp = worst(p_gpu, p_ref, "updated leaf") if rate is None else worst_adamw(p_gpu, p_ref)
    if "proj_queue_ptr" in p_ref:
        check(int(p_gpu["proj_queue_ptr"]) == int(p_ref["proj_queue_ptr"]) == pairs, "pointer")
    trained = [p for p in g_ref if not p.startswith("k_")]
    near = (sum(int((np.abs(p_gpu[p] - p_ref[p]) <= 0.02 * lr).sum()) for p in trained)
            / sum(p_ref[p].size for p in trained))
    leaves = ("parameters, twins, queue; pointer " + str(pairs) if "proj_queue_ptr" in p_ref
              else "parameters, BatchNorm running statistics"
              if any(p.endswith("running_var") for p in p_ref) else "parameters")
    bounds = ("2e-4 * max(1, max|ref|)" if rate is None
              else "2e-4 * max(1, max|ref|) (gradients) and AdamW's bounds (leaves)")
    print(f"{tag} {len(g_ref)} gradients and {len(p_ref)} updated leaves ({leaves}) within "
          f"{bounds}: worst gradient {wg[0]} at {wg[1]:.4g} of its bound, "
          f"worst leaf {wp[0]} at {wp[1]:.6f}; {near:.6f} of the trained elements within "
          f"2% of the rate {lr}")


def _step_result(ts, metrics, t0) -> tuple:
    from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
    return (metrics["total_loss"].item(), leaves_to_jax(ts.model, grads=True),
            leaves_to_jax(ts.model), time.perf_counter() - t0)


# the depth of the fp32 steps against the CPU (phases 9, 11, 14 and 17):
# their CPU steps are most of those phases' time, every op runs at full
# width at any depth, and phase 16's fp32 step runs the default blocks at
# all 12 layers (6 until phase 17 added three such steps)
SLICE_LAYERS = 3


def phase_train_slice(dev, config: str = "default") -> dict:
    """One fp32 step of N_CPU pairs at SLICE_LAYERS on the CPU and on the
    card (phase 9 and, per configuration, 11); the card step's launch
    counters, the fp32 sub-kernels (FMA GEMMs, attention) following its ops
    (expected_sub_launches), are returned."""
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = f"[train slice {config}]" if config != "default" else "[train slice]"
    cfg32 = train_config(config).replace(compute_dtype="float32", queue_dtype="float32",
                                          num_layers=SLICE_LAYERS)
    base = moco_model(cfg32)
    batch = train_batch(cfg32, N_CPU, SEED + 4, "cpu")
    results = {}
    for where in ("cpu", dev):
        ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
        FB.reset_launches()
        t0 = time.perf_counter()
        metrics = make_train_step(cfg32, ts)({k: v.to(where) for k, v in batch.items()},
                                             torch.Generator().manual_seed(SEED + 8))
        results[str(where)] = _step_result(ts, metrics, t0)
    counts = check_sub_launches(f"{tag} fp32 step", dict(FB.launches), FB)
    check(counts["attention_fwd"] > 0 and counts["attention_bwd"] > 0,
          f"{tag}: the fp32 step launched no attention kernel: {counts}")
    counts["ln_stats"] = FB.stats_launches["ln_stats"]
    check(0 < counts["ln_stats"] <= counts["ln_gemm"],
          f"{tag}: ln_stats launches {counts['ln_stats']} of {counts['ln_gemm']} ln_gemm")
    print(f"{tag} the card's fp32 step: sub-kernel launches "
          f"{ {k: counts[k] for k in FB.sub_launches} }, ln_stats_kernel "
          f"{counts['ln_stats']} (of its {SLICE_LAYERS} layers)")
    _train_results(tag, results, dev, train_config().learning_rate)
    return counts


# ------------------------------------------------------- greedy attack
# the synthetic counter-fitted vocabulary of bench.py:_greedy_setup :150
# (its word lists :132 and :140): the real vectors and BERT vocabulary are
# not in the repository; the attack's device cost is set by B, n_candidates,
# max_loops and the model, not by the size of the vocabulary
GREEDY_WORDS = [
    "dog", "cat", "puppy", "kitten", "car", "auto", "red", "crimson",
    "blue", "azure", "big", "large", "small", "tiny", "runs", "sprints",
    "sits", "rests", "park", "garden", "street", "road", "man", "guy",
    "woman", "lady", "child", "kid", "house", "home", "tree", "plant",
    "fast", "quick", "slow", "sluggish", "happy", "glad", "sad", "gloomy",
    "in", "the", "a", "on", "with", "near",
]
GREEDY_GROUPS = [
    ["dog", "puppy"], ["cat", "kitten"], ["car", "auto"],
    ["red", "crimson"], ["blue", "azure"], ["big", "large"],
    ["small", "tiny"], ["runs", "sprints"], ["sits", "rests"],
    ["park", "garden"], ["street", "road"], ["man", "guy"],
    ["woman", "lady"], ["child", "kid"], ["house", "home"],
    ["tree", "plant"], ["fast", "quick"], ["slow", "sluggish"],
    ["happy", "glad"], ["sad", "gloomy"],
]
GREEDY_STOP = ["in", "the", "a", "on", "with", "near"]
# worst: every word attackable; realistic: content words alternating with
# function words, so that the budgets run out after one or two commits
GREEDY_MIXES = ("worst", "realistic")
GREEDY_SLICE_MIX = "realistic"


def greedy_setup(cfg, n: int, mix: str, keep_dir=None) -> tuple:
    """(tokenizer, synonym table, n captions) as bench.py:_greedy_setup makes
    them: the vocabulary, 32-dimensional vectors (synonym groups share a
    direction) and captions from one RandomState(0).  The files (vocab.txt,
    vectors.txt) are written into ``keep_dir`` and kept, or into a
    temporary directory."""
    import tempfile
    from rmcl_tpu_torch.attacks.greedy import SynonymTable
    from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer, make_tiny_vocab
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory(prefix="greedy_vocab_") as tmp:
        d = keep_dir or tmp
        tok = WordPieceTokenizer(make_tiny_vocab(f"{d}/vocab.txt", GREEDY_WORDS))
        vecs = {}
        for group in GREEDY_GROUPS:
            base = rng.randn(32)
            for w in group:
                vecs[w] = base + 0.05 * rng.randn(32)
        for w in GREEDY_WORDS:
            vecs.setdefault(w, rng.randn(32))
        with open(f"{d}/vectors.txt", "w") as f:
            for w, v in vecs.items():
                f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
        syn = SynonymTable(f"{d}/vectors.txt", cfg.n_candidates, cfg.sim_thred)
    content = [w for w in GREEDY_WORDS if w not in GREEDY_STOP]
    L = min(cfg.max_text_len - 2, 10)
    if mix == "realistic":
        sents = [" ".join(str(rng.choice(content if i % 2 == 0 else GREEDY_STOP))
                          for i in range(L)) for _ in range(n)]
    else:
        sents = [" ".join(rng.choice(content, size=L)) for _ in range(n)]
    return tok, syn, sents


def attacked_batch(cfg, model, batch, mix: str) -> tuple:
    """(the fused attacker on ``model``, ``batch`` with the mix's captions
    and the attack's host tables under TABLE_KEYS in place of attacked ids,
    the captions)."""
    from rmcl_tpu_torch.attacks.greedy import GREEDY_ATTACKERS, greedy_attack_framework
    from rmcl_tpu_torch.attacks.greedy_fused import FusedGreedyAttack
    tok, syn, sents = greedy_setup(cfg, batch["text_ids"].shape[0], mix)
    attacker = GREEDY_ATTACKERS[greedy_attack_framework(cfg)]
    greedy = FusedGreedyAttack(attacker(cfg, model, tok, syn))
    ids, masks = tok.batch_encode(sents, cfg.max_text_len)
    dev = batch["text_ids"].device
    out = {k: v for k, v in batch.items() if not k.startswith("attacked_")}
    out.update(text_ids=torch.from_numpy(ids).to(dev), text_masks=torch.from_numpy(masks).to(dev),
               **greedy.prep_tables(ids))
    return greedy, out, sents


def attack_launches(stats: dict, num_layers: int, passes: int = 1) -> dict:
    """Block-op launches of one greedy attack from its own count: every
    gradient pass runs the deterministic forward and the dx backward of each
    block, every scoring forward the deterministic forward; ``passes``
    forwards each (NLVR2: one per image)."""
    from rmcl_tpu_torch.ops import fused_block as FB
    g, s = stats["grad_passes"] * passes, stats["score_forwards"] * passes
    return {**dict.fromkeys(FB.launches, 0), "attn_half": num_layers * (g + s),
            "mlp_half": num_layers * (g + s), "attn_half_dx": num_layers * g,
            "mlp_half_dx": num_layers * g}


def check_substitutions(tag, syn, sents, texts, n_changed, n_tokens, max_loops) -> int:
    """Every changed word is a synonym candidate of the word it replaced, a
    sample's changed words are its commits, and no sample exceeds the budget
    min(int(0.2 * (sub-tokens + 1)), max_loops).  Returns the changed words."""
    total = 0
    for i, (orig, new, n, L) in enumerate(zip(sents, texts, n_changed, n_tokens)):
        ow, nw = orig.split(), new.split()
        check(len(ow) == len(nw), f"{tag} sample {i}: {orig!r} -> {new!r}")
        changed = [(a, b) for a, b in zip(ow, nw) if a != b]
        bad = [(a, b) for a, b in changed if b not in syn.candidates(a)]
        check(not bad, f"{tag} sample {i}: {bad} are not synonym candidates")
        check(len(changed) == n, f"{tag} sample {i}: {len(changed)} words changed, "
                                 f"{n} commits")
        check(n <= min(int(0.2 * (L + 1)), max_loops),
              f"{tag} sample {i}: {n} changes over the budget of {L} sub-tokens")
        total += n
    return total


def phase_greedy(dev) -> dict:
    """Phase 12: the fused greedy attack alone, per caption mix."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.attacks.greedy import greedy_attack_extras
    cfg = build_config(PGD_CONFIG)
    model = moco_model(cfg).to(dev)
    out = {}
    for mix in GREEDY_MIXES:
        tag = f"[greedy {mix}]"
        greedy, batch, sents = attacked_batch(
            cfg, model, pgd_batch(cfg, PGD_BATCH, SEED + 4, dev), mix)
        tok, syn = greedy.base.tokenizer, greedy.base.synonyms
        extras = greedy_attack_extras(cfg, model, "moco", batch)   # the post-EMA keys
        tables = [torch.as_tensor(batch[k], device=dev) for k in
                  ("gw_tok", "gw_len", "gw_attackable", "gw_cand_tok", "gw_cand_len",
                   "gw_cand_valid")]
        Ts = batch["gw_tbucket"].shape[1]
        attack = greedy.build_attack_body()

        def run():
            return attack(batch, extras, *tables, batch["gw_tbucket"])

        run()                                                   # warm-up
        torch.cuda.synchronize()
        FB.reset_launches()
        ids, masks, n_changed = run()
        torch.cuda.synchronize()
        counts, stats = dict(FB.launches), dict(greedy.last_stats)
        want = attack_launches(stats, cfg.num_layers)
        check(counts == want, f"{tag} launches {counts}, expected {want} from {stats}")
        counts = check_sub_launches(tag, counts, FB)
        n_changed = n_changed.cpu().tolist()
        texts = [tok.decode(row) for row in ids.cpu().numpy()]
        n_tokens = (batch["text_masks"].sum(1) - 2).cpu().tolist()
        total = check_substitutions(tag, syn, sents, texts, n_changed, n_tokens,
                                    cfg.max_loops)
        check(mix != "worst" or total > 0, f"{tag} no word changed")
        check(bool((masks.sum(1).cpu() == batch["text_masks"].sum(1).cpu()).all()),
              f"{tag} caption lengths changed")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        ms = statistics.median(walls)
        print(f"{tag} {PGD_BATCH} pairs, bf16, n_candidates {cfg.n_candidates}, max_loops "
              f"{cfg.max_loops}, queue {tuple(model.proj_queue.shape)}, text bucket Ts = {Ts} "
              f"(S = {Ts + cfg.image_seq_len}); loops {stats['loops']}, gradient passes "
              f"{stats['grad_passes']}, scoring forwards {stats['score_forwards']}, host reads "
              f"{stats['host_reads']}; {total} words changed (num_changes "
              f"{total / PGD_BATCH!r}), each a synonym candidate, within the budgets")
        print(f"{tag} e.g. {sents[0]!r} -> {texts[0]!r}")
        print(f"{tag} launches {counts}")
        print(f"{tag} attack {ms!r} ms (median of 3, host clock + synchronize; the host "
              f"tables made before)")
        out[mix] = counts
    return out


def _first_split(rec_a: list, rec_b: list) -> tuple:
    """(loop, sample, decision, margin, value) where two records of one attack
    first part: the pick (margin: the first record's saliency gap between the
    two picks), the best candidate (the score gap) or the commit (the best
    score against the per-sample loss); None when they do not part."""
    for li, (a, b) in enumerate(zip(rec_a, rec_b)):
        if not torch.equal(a["rows"], b["rows"]):
            return li, None, "rows", float("inf"), 0.0
        for j, row in enumerate(a["rows"].tolist()):
            pa, pb = int(a["pick"][j]), int(b["pick"][j])
            if pa != pb:
                sal = a["sal"][j].double()
                return li, row, "pick", abs(float(sal[pa] - sal[pb])), float(sal[pa])
            ba, bb = int(a["best"][j]), int(b["best"][j])
            sc = a["scores"][j].double()
            if ba != bb:
                return li, row, "best candidate", abs(float(sc[ba] - sc[bb])), float(sc[ba])
            if bool(a["improved"][j]) != bool(b["improved"][j]):
                per = float(a["per_loss"][j])
                return li, row, "commit", abs(float(sc[ba]) - per), per
    if len(rec_a) != len(rec_b):
        return min(len(rec_a), len(rec_b)), None, "loops", float("inf"), 0.0
    return None


def phase_train_attacked_slice(dev) -> None:
    """Phase 14: one fp32 attacked step of 4 pairs, the card's kernels against
    the CPU's plain ops from the same weights, batch and dropout seeds."""
    cfg32 = train_config().replace(compute_dtype="float32", queue_dtype="float32",
                                   num_layers=SLICE_LAYERS)
    attacked_slice(dev, "[train attacked slice]", cfg32, moco_model(cfg32))


def attacked_slice(dev, tag, cfg32, base, seam: bool = False, batch_fn=None,
                   rate=None) -> None:
    """One fp32 attacked step of ``cfg32`` on 4 pairs from the weights of
    ``base``, on the CPU and on the card, the same batch and dropout seeds:
    the attacked token ids (or, where they part, a tie within 2e-4 *
    max(1, |value|)), then _train_results' tolerances.  With ``seam``
    (task_barlowtwins) the loss and ids are the attacked step's, and the
    gradients, updated leaves and running statistics held to
    _train_results' tolerances are those of a second card step on the CPU's
    ids, cut at the head's input (HeadSeam).  ``batch_fn`` makes the batch
    (default ``train_batch``; phase 17: ``downstream_batch``); ``rate`` as
    _train_results takes it."""
    from rmcl_tpu_torch.train.step import (create_train_state, make_attacked_train_step,
                                           make_train_step)
    batch0 = (batch_fn or train_batch)(cfg32, N_CPU, SEED + 4, "cpu")
    results, attacked, records, seams = {}, {}, {}, {}
    for where in ("cpu", dev):
        ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
        greedy, batch, _ = attacked_batch(cfg32, ts.model, batch0, GREEDY_SLICE_MIX)
        greedy.record = []
        body = greedy._attack
        if seam and where == "cpu":
            seams["cpu"] = HeadSeam(ts.model.barlowtwins_head)

        def keep(*a, body=body, where=where, **kw):
            rec = seams.get(str(where))
            if rec is not None:           # the attack's own head calls are not the step's
                rec.paused = True
            out = body(*a, **kw)
            if rec is not None:
                rec.paused = False
            attacked[str(where)] = [t.cpu() for t in out]
            return out
        greedy._attack = keep
        t0 = time.perf_counter()
        metrics = make_attacked_train_step(cfg32, ts, greedy)(
            {k: v.to(where) if isinstance(v, torch.Tensor) else v for k, v in batch.items()},
            torch.Generator().manual_seed(SEED + 8))
        results[str(where)] = _step_result(ts, metrics, t0)
        records[str(where)] = greedy.record
        if str(where) in seams:
            seams[str(where)].stop()
        print(f"{tag} {where}: {GREEDY_SLICE_MIX} captions, attack {greedy.last_stats}, "
              f"num_changes {metrics['num_changes'].item()!r}")
    (ids_c, _, n_c), (ids_g, _, n_g) = attacked["cpu"], attacked[str(dev)]
    tied = not torch.equal(ids_c, ids_g)
    if not tied:
        print(f"{tag} attacked token ids equal on the card and the CPU "
              f"({int(n_c.sum())} commits, {len(records['cpu'])} loops)")
    else:
        split = _first_split(records["cpu"], records[str(dev)])
        check(split is not None, f"{tag} ids differ but no decision parted")
        loop, row, what, margin, value = split
        tol = 2e-4 * max(1.0, abs(value))
        print(f"{tag} attacked ids differ: first at loop {loop}, sample {row}, the "
              f"{what}: margin {margin!r} against {tol!r} (2e-4 * max(1, |{value!r}|))")
        check(margin <= tol, f"{tag} the {what} of sample {row} in loop {loop} parts by "
                             f"{margin}, more than the tie tolerance {tol}")

    def on_cpu_ids(where):
        """The step's batch on ``where`` with the CPU's attacked ids in it."""
        b = {k: v.to(where) for k, v in batch0.items()}
        b.update(text_ids=torch.as_tensor(batch["text_ids"]).to(where),
                 text_masks=torch.as_tensor(batch["text_masks"]).to(where),
                 attacked_text_ids=ids_c.to(where),
                 attacked_text_masks=attacked["cpu"][1].to(where))
        return b

    if seam:
        _loss_result(tag, results, dev)
        (_, g_ref, _, _), (_, g_gpu, _, _) = results["cpu"], results[str(dev)]
        whole = max(float(np.abs(g_gpu[p] - r).max()) / (2e-4 * max(1.0, float(np.abs(r).max())))
                    for p, r in g_ref.items())
        print(f"{tag} the attacked step's own gradients, not cut: the card's differ from the "
              f"CPU's by up to {whole:.4g} x 2e-4 * max(1, max|ref|) (not held; HeadSeam says why)")
        ts = create_train_state(cfg32, model=copy.deepcopy(base), device=dev)
        rec = seams["cpu"]
        handle = rec.replay(ts.model.barlowtwins_head, dev)
        t0 = time.perf_counter()
        metrics = make_train_step(cfg32, ts)(on_cpu_ids(dev),
                                             torch.Generator().manual_seed(SEED + 8))
        handle.remove()
        results[str(dev)] = _step_result(ts, metrics, t0)
        rec.check_forward(tag)
        _train_results(f"{tag} at the seam:", results, dev, cfg32.learning_rate)
        return
    if tied:
        # a true tie: the rest of the step is held on the CPU's attacked ids
        for where in ("cpu", dev):
            ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
            t0 = time.perf_counter()
            metrics = make_train_step(cfg32, ts)(on_cpu_ids(where),
                                                 torch.Generator().manual_seed(SEED + 8))
            results[str(where)] = _step_result(ts, metrics, t0)
    _train_results(tag, results, dev, cfg32.learning_rate, rate)


class _Seam(torch.autograd.Function):
    """``x_ref`` forward in place of ``x``, and ``g_ref`` backward in place of
    the gradient that reaches ``x``."""

    @staticmethod
    def forward(ctx, x, x_ref, g_ref):
        ctx.save_for_backward(g_ref)
        return x_ref.clone()

    @staticmethod
    def backward(ctx, _):
        return ctx.saved_tensors[0], None, None


class HeadSeam:
    """Phase 16's fp32 step cut at the BarlowTwins head's input.

    The head's gradients move far more than its input: its three BatchNorms
    normalise each feature over the 4 rows, and the correlation loss's
    gradient is mostly along the normalised features, which the last
    BatchNorm's backward takes out again, so what remains is a small part of
    large terms.  An fp32 rounding difference of the class features then
    moves the head's gradients by a large part of their largest, and through
    PGD's step (delta follows the sign of its gradient) every view's input:
    two fp32 implementations of the same step part by thousands of times
    the tolerance (printed beside the check).  Fed the same input and
    gradient at the seam, each part agrees.

    Made on the CPU's model, it keeps the head's input at every call of the
    step (the class features) and the gradient that reached it; the greedy
    attack's calls are skipped (``paused``).  ``replay(head, dev)`` on the
    card's model feeds the head, call by call, the CPU's input and hands the
    encoder below it the CPU's gradient, keeping the card's own input for
    ``check_forward``.  The card's encoder gradients (every kernel of the
    step, PGD's among them) then differ from the CPU's by the encoder's own
    rounding, and the head's gradients and statistics by the head's."""

    def __init__(self, head):
        self.x, self.g, self.seen, self.paused = [], {}, [], False
        self.handle = head.register_forward_pre_hook(self._record)

    @classmethod
    def of(cls, x: list, g: dict) -> "HeadSeam":
        """A seam from another process's records (phase 21's ranks), to replay."""
        rec = cls.__new__(cls)
        rec.x, rec.g, rec.seen, rec.paused, rec.handle = x, g, [], False, None
        return rec

    def _record(self, _, args):
        if self.paused:
            return None
        x, i = args[0], len(self.x)
        self.x.append(x.detach().clone())
        if x.requires_grad:
            x.register_hook(lambda g, i=i: self.g.__setitem__(i, g.detach().clone()))
        return None

    def stop(self) -> None:
        self.handle.remove()

    def replay(self, head, dev):
        def seam(_, args):
            x, i = args[0], len(self.seen)
            check(i < len(self.x), f"the card's step calls the head more than the CPU's "
                                   f"{len(self.x)} times")
            self.seen.append(x.detach().cpu())
            x_ref = self.x[i].to(dev)
            if not x.requires_grad:
                return (x_ref, *args[1:])
            check(i in self.g, f"head call {i}: the CPU's step has no gradient there")
            return (_Seam.apply(x, x_ref, self.g[i].to(dev)), *args[1:])
        return head.register_forward_pre_hook(seam)

    def check_forward(self, tag, ours: str = "the card's", ref: str = "the CPU's") -> None:
        """The card's class features at every head call against the CPU's
        (``ours`` and ``ref`` name the two sides)."""
        check(len(self.seen) == len(self.x), f"{tag}: the card's step called the head "
                                             f"{len(self.seen)} times, the CPU's {len(self.x)}")
        w = 0.0
        for got, want in zip(self.seen, self.x):
            err = float((got - want).abs().max())
            tol = 2e-4 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"{tag}: class features differ by {err} > {tol}")
            w = max(w, err / tol)
        print(f"{tag} {ours} class features at the head's {len(self.x)} calls of the "
              f"step ({len(self.g)} with a gradient: PGD's and the views') within 2e-4 * "
              f"max(1, max|ref|) of {ref}: worst at {w:.4f} of the bound")


# --------------------------------------------------------------- trainer
TRAINER_MIX = "worst"
TRAINER_OPT_STEPS, TRAINER_ACCUM = 3, 2   # batch_size 32 at 16 pairs per step
TRAINER_PREEMPT = 3                       # micro-steps before the preemption
TRAINER_VAL = PGD_BATCH                   # validation pairs: one batch
TRAINER_DIR = "chip_smoke_trainer.tmp"    # checkpoints, removed at the end


class MemoryDataset:
    """Samples in memory in the arrow datasets' format (the card's machine
    has no pyarrow or PIL): caption i with image i // captions_per_image,
    each image already resized to a /32 size within the bucket;
    ``extra(i)`` adds sample i's task keys.  ``get_text``, ``get_image`` and
    ``index_mapper`` serve the recall."""

    def __init__(self, tokenizer, texts, images, max_text_len, captions_per_image=1,
                 extra=None):
        self.tok, self.texts, self.images, self.T = tokenizer, texts, images, max_text_len
        self.k, self.extra = captions_per_image, extra or (lambda i: {})
        self.index_mapper = {i: (i // self.k, i % self.k) for i in range(len(texts))}

    def __len__(self):
        return len(self.texts)

    def get_text(self, i):
        text = self.texts[i]
        enc = self.tok(text, padding="max_length", truncation=True, max_length=self.T,
                       return_special_tokens_mask=True)
        return {"text": (text, enc), "img_index": i // self.k, "cap_index": i % self.k,
                "raw_index": i}

    def get_image(self, i):
        return {"image": [self.images[i // self.k]], "img_index": i // self.k}

    def __getitem__(self, i):
        return {**self.get_image(i), **self.get_text(i), "replica": False, **self.extra(i)}


def memory_datamodule(make_dataset, answers=None):
    """A MultitaskDataModule class whose datasets are ``make_dataset(tokenizer,
    split)``; ``answers`` is the VQA answer table, when there is one."""
    from rmcl_tpu_torch.data.datamodule import MultitaskDataModule

    class MemoryDataModule(MultitaskDataModule):
        def _make_dataset(self, name, split, no_false=False):
            return make_dataset(self.tokenizer, split)

        def _build_answer_vocab(self):
            self.answer2id = {a: i for i, a in enumerate(answers or [])}
            self.id2answer = dict(enumerate(answers or []))

    return MemoryDataModule


def memory_images(cfg, n: int, seed: int) -> list:
    """n seeded u8 images of /32 sizes from a half to all of the bucket."""
    r = np.random.RandomState(seed)
    H, W = cfg.image_bucket_hw
    return [r.randint(0, 256, (32 * r.randint(H // 64, H // 32 + 1),
                               32 * r.randint(W // 64, W // 32 + 1), 3), np.uint8)
            for _ in range(n)]


def trainer_setup(dev, d: str, bt: bool = False, opt_steps=None, ranks: int = 1) -> tuple:
    """(cfg, make_datamodule, model) of phase 15: task_moco at full width and
    depth as phase 13 runs it, 32 pairs per optimizer step at 16 per step, 3
    optimizer steps; the greedy vocabulary and vectors of greedy_setup written
    under ``d``, its worst-mix captions, seeded ragged u8 images.  ``bt``:
    phase 16's, task_barlowtwins as its attacked step runs it, one optimizer
    step.  ``opt_steps`` and ``ranks`` (phase 21): the optimizer steps, and
    the ranks that each take 16 pairs per micro-step (batch_size and the
    training captions ``ranks`` times phase 15's)."""
    opt_steps = opt_steps or (BT_TRAINER_OPT_STEPS if bt else TRAINER_OPT_STEPS)
    n_train = PGD_BATCH * TRAINER_ACCUM * opt_steps * ranks
    base = bt_config() if bt else train_config()
    _, _, sents = greedy_setup(base, n_train + TRAINER_VAL, TRAINER_MIX, keep_dir=d)
    cfg = base.replace(
        tokenizer=f"{d}/vocab.txt", embedding_path=f"{d}/vectors.txt", sim_path="",
        batch_size=PGD_BATCH * TRAINER_ACCUM * ranks, per_device_batchsize=PGD_BATCH,
        max_steps=opt_steps, max_epoch=1)
    images = memory_images(cfg, len(sents), SEED + 9)
    split = {"train": slice(0, n_train), "val": slice(n_train, None),
             "test": slice(n_train, None)}
    dm_cls = memory_datamodule(lambda tok, s: MemoryDataset(
        tok, sents[split[s]], images[split[s]], cfg.max_text_len))
    return cfg, dm_cls, (bt_model(cfg) if bt else moco_model(cfg))


def expected_eval_launches(cfg) -> dict:
    """Block-op launches of one validation batch of the default blocks, the
    greedy attack's aside: the attacker's key forward (its extras) and the
    eval step's, the PGD's forwards and backwards, the deterministic views
    (task_moco four, task_barlowtwins three)."""
    from rmcl_tpu_torch.core.config import active_tasks
    from rmcl_tpu_torch.ops import fused_block as FB
    L, A = cfg.num_layers, cfg.adv_steps_img
    n = (6 if "moco" in active_tasks(cfg) else 5) + A
    want = dict.fromkeys(FB.launches, 0)
    want.update(attn_half=n * L, mlp_half=n * L, attn_half_dx=A * L, mlp_half_dx=A * L)
    return want


def _trainer_run(dev, cfg, dm_cls, model, workdir, watch=False, preempt_at=None,
                 resume=False) -> tuple:
    """One Trainer.setup() / fit() on the card.  Every micro-step's loss stays
    on the device until the end and its greedy attack's stats are kept; with
    ``watch`` each micro-step's launches and which parameters it moved are
    recorded too (a copy of every parameter per micro-step: not in the timed
    run).  Returns (trainer, losses, per-micro-step records, end time)."""
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.train.loop import Trainer
    cfg = cfg.replace(log_dir=workdir, resume_from="last" if resume else None)
    tr = Trainer(cfg, workdir=workdir, datamodule=dm_cls(cfg), device=dev)
    tr.setup(model=copy.deepcopy(model))
    inner, losses, recs = tr.step_fn, [], []
    named = dict(tr.ts.model.named_parameters())

    def step_fn(db, gen):
        rec = {"t": time.perf_counter(), "micro": tr.ts.step % tr.accum_steps}
        if watch:
            ops0 = dict(FB.launches)
            before = {n: p.detach().clone() for n, p in named.items()}
        metrics = inner(db, gen)
        rec["t_out"] = time.perf_counter()
        losses.append(metrics["total_loss"])
        rec["stats"] = dict(tr.greedy.last_stats)
        if watch:
            rec.update(ops={k: FB.launches[k] - ops0[k] for k in ops0},
                       moved={n: not torch.equal(p, before[n]) for n, p in named.items()})
        recs.append(rec)
        if preempt_at is not None and len(losses) == preempt_at:
            tr.request_preemption()
        return metrics

    tr.step_fn = step_fn
    tr.fit()
    torch.cuda.synchronize()
    return tr, losses, recs, time.perf_counter()


def _trainer_expected(cfg, recs, val_stats) -> dict:
    """Launches of a Trainer run: each micro-step's (expected_launches and
    its greedy attack's), and the validation batch's when ``val_stats``."""
    L = cfg.num_layers
    parts = [expected_launches(cfg)] * len(recs) + [attack_launches(r["stats"], L) for r in recs]
    if val_stats is not None:
        parts += [expected_eval_launches(cfg), attack_launches(val_stats, L)]
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def _check_micro_steps(tag, cfg, recs) -> None:
    """Per micro-step: the launches, the parameters still mid-cycle and all
    moved at a cycle's end, every k_transformer twin moved."""
    for i, rec in enumerate(recs):
        want = _trainer_expected(cfg, [rec], None)
        check(rec["ops"] == want, f"{tag} micro-step {i}: launches {rec['ops']}, "
                                  f"expected {want}")
        trained = [p for p in rec["moved"]
                   if not p.startswith("k_") and not p.endswith("mask_token")]
        moved = sum(rec["moved"][p] for p in trained)
        if rec["micro"] < TRAINER_ACCUM - 1:
            check(moved == 0, f"{tag} micro-step {i}: {moved} parameters moved mid-cycle")
        else:
            check(moved == len(trained), f"{tag} micro-step {i}: {len(trained) - moved} "
                                         "parameters did not move at the cycle's end")
        still = [p for p, m in rec["moved"].items() if p.startswith("k_transformer") and not m]
        check(not still, f"{tag} micro-step {i}: twins {still[:3]} did not move")


def phase_trainer(dev, bare: dict) -> dict:
    """Phase 15: the training entry point, Trainer.setup() / fit() /
    validate() around the attacked step, on the card.  Returns the launches
    of its main run."""
    import shutil
    from rmcl_tpu_torch.models.vilt import ViLT
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import load_state_dict_file
    from rmcl_tpu_torch.train.checkpoint import MODEL_FILE
    tag = "[trainer]"
    root = Path(TRAINER_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        t0 = time.perf_counter()
        cfg, dm_cls, model = trainer_setup(dev, str(root))
        n = TRAINER_ACCUM * TRAINER_OPT_STEPS
        print(f"{tag} {PGD_CONFIG} through Trainer.setup() / fit() / validate(): image and "
              f"text views (the fused greedy attack on {TRAINER_MIX} captions), drop_rate "
              f"{cfg.drop_rate}, batch_size {cfg.batch_size} at per_device_batchsize "
              f"{cfg.per_device_batchsize} (accum {TRAINER_ACCUM}), max_steps {cfg.max_steps} "
              f"optimizer steps ({n} micro-steps), {TRAINER_VAL} validation pairs; data ready "
              f"in {time.perf_counter() - t0:.1f} s")
        # the main path, timed: counts set to 0 just before it, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FB.reset_launches()
        tr, losses, recs, t_end = _trainer_run(dev, cfg, dm_cls, model, str(root / "a"))
        counts = dict(FB.launches)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        check(tr.steps_done == n == len(recs), f"{tag} {tr.steps_done} micro-steps, want {n}")
        want = _trainer_expected(cfg, recs, tr.greedy.last_stats)
        check(counts == want, f"{tag} launches {counts}, expected {want}")
        counts = check_sub_launches(tag, counts, FB)
        loss_a = torch.stack(losses).cpu().numpy()
        check(bool(np.isfinite(loss_a).all()), f"{tag} non-finite losses {loss_a}")
        # from one micro-step's start to the next, after the first cycle: the
        # step's own call (it returns once its last kernels are queued) and
        # the Trainer's loop between two calls
        steady = list(zip(recs, recs[1:]))[TRAINER_ACCUM:]
        ms = statistics.median(b["t"] - a["t"] for a, b in steady) * 1e3
        call_ms = statistics.median(a["t_out"] - a["t"] for a, _ in steady) * 1e3
        loop_ms = statistics.median(b["t"] - a["t_out"] for a, b in steady) * 1e3
        attack_reads = sum(r["stats"]["host_reads"] for r in recs)
        reads = (tr.host_reads + attack_reads) / n
        print(f"{tag} launches of the run: each micro-step's expected_launches and its "
              f"attack's own, the validation batch's expected_eval_launches and its attack's: "
              f"{counts}")
        print(f"{tag} losses {[float(x) for x in loss_a]}")
        print(f"{tag} Trainer {ms!r} ms per micro-step (median of {len(steady)} after the "
              f"first cycle, host clock from one micro-step's start to the next: the step's "
              f"call {call_ms!r}, the loop between calls {loop_ms!r}), "
              f"{PGD_BATCH / ms * 1e3!r} pairs/s; max_memory_allocated {mem:.2f} GiB; host "
              f"reads per micro-step {reads!r} ({tr.host_reads} metric reads over {n} "
              f"micro-steps, {attack_reads} in the greedy attacks); the run with its "
              f"validation and two checkpoint saves {t_end - recs[0]['t']:.1f} s")
        READINGS["trainer_ms"] = ms
        print(f"{tag} bare attacked step (phase 13, {TRAINER_MIX} captions): {bare['ms']!r} ms, "
              f"{PGD_BATCH / bare['ms'] * 1e3!r} pairs/s, {bare['mem_gib']:.2f} GiB, host reads "
              f"per step {bare['host_reads']}; Trainer overhead {ms - bare['ms']!r} ms per "
              f"micro-step ({ms / bare['ms']:.3f}x)")

        # last: its state_dict loads into a fresh ViLT with every tensor equal
        path = Path(tr.ckpt.checkpoint_dir("last")) / MODEL_FILE
        fresh = ViLT(cfg)
        check(fresh.load_reference_state_dict(load_state_dict_file(str(path))) == [],
              f"{tag} {path}: entries not loaded")
        live, back = tr.ts.model.state_dict(), fresh.state_dict()
        same = [k for k in live if torch.equal(live[k].cpu(), back[k])]
        check(len(same) == len(live) == len(back), f"{tag} {len(live) - len(same)} tensors of "
                                                   "'last' differ from the trained model")
        check(tr.ckpt.has("best"), f"{tag} no 'best' checkpoint")
        print(f"{tag} 'last' ({path.parent.name}) loads into a fresh ViLT: {len(same)} "
              "tensors equal; 'best' saved")
        del fresh, back

        # preempted after micro-step 3 (mid-cycle), then resumed by a new
        # Trainer; both watched micro-step by micro-step
        t1 = time.perf_counter()
        first, loss_b, recs_b, _ = _trainer_run(dev, cfg, dm_cls, model, str(root / "b"),
                                                watch=True, preempt_at=TRAINER_PREEMPT)
        check(first.steps_done == TRAINER_PREEMPT and first.ckpt.has("last"),
              f"{tag} the preempted run stopped at {first.steps_done}")
        del first
        FB.reset_launches()
        second, loss_c, recs_c, _ = _trainer_run(dev, cfg, dm_cls, model, str(root / "b"),
                                                 watch=True, resume=True)
        check(second.steps_done == n, f"{tag} the resumed run ended at {second.steps_done}")
        _check_micro_steps(tag, cfg, recs_b + recs_c)
        want = _trainer_expected(cfg, recs_c, second.greedy.last_stats)
        check(dict(FB.launches) == want, f"{tag} resumed run: launches {dict(FB.launches)}, "
                                         f"expected {want}")
        loss_bc = torch.stack(loss_b + loss_c).cpu().numpy()
        rel_loss = float(np.max(np.abs(loss_bc - loss_a) / np.abs(loss_a)))
        a_sd, c_sd = tr.ts.model.state_dict(), second.ts.model.state_dict()
        rel_par = max(float((a_sd[k].double() - c_sd[k].double()).abs().max()
                            / a_sd[k].double().abs().max().clamp(min=1e-30))
                      for k in a_sd)
        print(f"{tag} {n} micro-steps watched: the launches of each, the parameters still "
              f"mid-cycle and all moved at each cycle's end, the k_transformer twins moved "
              f"every micro-step")
        print(f"{tag} preempted after micro-step {TRAINER_PREEMPT} (mid-cycle) and resumed by "
              f"a new Trainer: per-step total_loss largest relative difference {rel_loss!r}, "
              f"parameters and buffers {rel_par!r} (tol 1e-6; "
              f"{'bit for bit' if rel_loss == rel_par == 0 else 'not bit for bit'}); "
              f"{time.perf_counter() - t1:.1f} s")
        check(rel_loss <= 1e-6 and rel_par <= 1e-6,
              f"{tag} the resumed run differs: loss {rel_loss}, parameters {rel_par}")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------- BarlowTwins
BT_TRAINER_OPT_STEPS = 1                  # phase 16's Trainer: one optimizer step
BT_STATS = ("running_mean", "running_var")


def bt_config():
    """task_barlowtwins as phase 16 trains it: the ViLT-B/32 of task_moco's
    phases (max_image_len 200, S = 241), bt_proj_dims (8192, 8192, 8192),
    lambda = adv_lr 0.0051, 5-step PGD, the greedy attack (n_candidates 5,
    max_loops 10), the image and text views, drop_rate 0.1, AdamW at 1e-4
    with warmup 0 so that the first update moves, bf16."""
    from rmcl_tpu_torch import build_config
    return build_config(BT_CONFIG, image_view=True, text_view=True, drop_rate=DROP_P,
                        warmup_steps=0, max_steps=1000)


def bt_model(cfg):
    """A seeded task_barlowtwins model on the CPU."""
    from rmcl_tpu_torch.serve import seeded_model
    return seeded_model(cfg, SEED).eval()


def bt_stats(model) -> dict:
    """A copy of the BarlowTwins head's six BatchNorm running statistics."""
    return {n: b.detach().clone() for n, b in model.named_buffers() if n.endswith(BT_STATS)}


def check_stats_moved(tag, model, before: dict) -> None:
    """Every running statistic moved from ``before``, is finite, and every
    running variance is positive."""
    after = bt_stats(model)
    check(len(after) == len(before) == 6, f"{tag}: {len(after)} running statistics")
    for n, b in after.items():
        check(bool(torch.isfinite(b).all()), f"{tag}: {n} not finite")
        check(not torch.equal(b, before[n].to(b.device)), f"{tag}: {n} did not move")
        check(not n.endswith("running_var") or bool((b > 0).all()), f"{tag}: {n} <= 0")


def check_stats_kept(tag, model, before: dict) -> None:
    after = bt_stats(model)
    moved = [n for n, b in after.items() if not torch.equal(b, before[n])]
    check(not moved, f"{tag}: running statistics {moved} moved")


def phase_bt(dev, mix: str) -> tuple:
    """Phase 16: the attacked task_barlowtwins step on one caption mix.
    Returns (launches of a step, its readings)."""
    from rmcl_tpu_torch.attacks.greedy_fused import TABLE_KEYS
    from rmcl_tpu_torch.attacks.pgd import make_pgd_barlowtwins
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.train.step import create_train_state, make_attacked_train_step
    t0 = time.perf_counter()
    cfg = bt_config()
    ts = create_train_state(cfg, model=bt_model(cfg), device=dev)
    model = ts.model
    greedy, batch, _ = attacked_batch(cfg, model, train_batch(cfg, PGD_BATCH, SEED + 4, dev),
                                      mix)
    tag = f"[bt attacked {mix}]"
    gen = torch.Generator().manual_seed(SEED + 7)
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_head = sum(p.numel() for p in model.barlowtwins_head.parameters())
    print(f"{tag} {BT_CONFIG}, blocks {model.block_impls}, bt_proj_dims {cfg.bt_proj_dims}, "
          f"lambda {cfg.adv_lr}, image and text views, drop_rate {cfg.drop_rate}, "
          f"{n_train / 1e6:.1f} M trainable parameters ({n_head / 1e6:.1f} M in the head), "
          f"{PGD_BATCH} pairs, the greedy attack inside the step on {mix} captions, text "
          f"bucket {batch['gw_tbucket'].shape[1]} of {cfg.max_text_len}; state ready in "
          f"{time.perf_counter() - t0:.1f} s")
    clock = _StepClock(ts, greedy)
    walls, splits, stats = [], [], []
    try:
        step = make_attacked_train_step(cfg, ts, greedy)
        step(batch, gen)                                        # warm-up
        # earlier phases' tensors held in reference cycles would count in
        # the peak: collect them first
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for it in range(TRAIN_STEPS):
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            stats0 = bt_stats(model)
            FB.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            clock.mark("start")
            metrics = step(batch, gen)
            clock.mark("end")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            splits.append(clock.split())
            counts, st = dict(FB.launches), dict(greedy.last_stats)
            stats.append(st)
            attack = attack_launches(st, cfg.num_layers)
            want = {k: v + attack[k] for k, v in expected_launches(cfg).items()}
            check(counts == want, f"{tag} step {it}: launches {counts}, expected {want}")
            # the correlation couples the batch: no compaction, no chunks
            check(st["score_forwards"] == st["loops"],
                  f"{tag} step {it}: {st['score_forwards']} scoring forwards in "
                  f"{st['loops']} loops")
            counts = check_sub_launches(f"{tag} step {it}", counts, FB)
            vals = {k: v.item() for k, v in metrics.items()}
            bad = [k for k, v in vals.items() if not np.isfinite(v)]
            check(not bad, f"{tag} step {it}: non-finite metrics {bad}")
            for n, p in model.named_parameters():
                if not n.endswith("mask_token"):       # mask_token: MPP only, zero, unused
                    check(not torch.equal(p.detach(), before[n]),
                          f"{tag} step {it}: {n} did not move")
            check_stats_moved(f"{tag} step {it}", model, stats0)
            print(f"{tag} step {it}: barlowtwins_loss={vals['barlowtwins_loss']!r} "
                  "invariance/redundancy text "
                  f"{vals['barlowtwins_loss_invariance_text']:.4f}/"
                  f"{vals['barlowtwins_loss_redundancy_text']:.4f} img "
                  f"{vals['barlowtwins_loss_invariance_img']:.4f}/"
                  f"{vals['barlowtwins_loss_redundancy_img']:.4f} both "
                  f"{vals['barlowtwins_loss_invariance_both']:.4f}/"
                  f"{vals['barlowtwins_loss_redundancy_both']:.4f} lr={vals['lr']!r} "
                  f"num_changes={vals['num_changes']!r} change_rate={vals['change_rate']!r}; "
                  f"attack {st}; every parameter and running statistic moved; "
                  f"{walls[-1]:.1f} ms")
    finally:
        clock.close()
    ms = statistics.median(walls)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    split = {k: statistics.median(s_[k] for s_ in splits) for k in splits[0]}
    reads = statistics.median(st["host_reads"] for st in stats)
    print(f"{tag} launches per step {counts}: every block through the kernels, each loop's "
          f"scoring forward all {PGD_BATCH * cfg.n_candidates} rows")
    print(f"{tag} step {ms!r} ms (median of {TRAIN_STEPS}, host clock + synchronize), "
          f"{PGD_BATCH / ms * 1e3!r} pairs/s; max_memory_allocated {mem:.2f} GiB; host "
          f"reads per step {reads}")
    print(f"{tag} split of a step by CUDA events, ms (median): "
          + "; ".join(f"{k} {v:.2f}" for k, v in split.items()))

    # PGD alone and the greedy attack alone keep the running statistics
    clean = {k: v for k, v in batch.items() if k not in TABLE_KEYS}
    with torch.no_grad():
        k = model.barlowtwins_head(model.infer(clean, ts.block_matrices)["cls_feats"])
    stats0 = bt_stats(model)
    pgd = make_pgd_barlowtwins(model, cfg.adv_steps_img, cfg.adv_lr_img, cfg.adv_max_norm_img,
                               cfg.adv_lr)
    delta = pgd(clean, k, block_matrices=ts.block_matrices)
    check(bool(torch.isfinite(delta).all()) and 0 < delta.abs().max().item()
          <= cfg.adv_max_norm_img + 1e-6, f"{tag} PGD delta out of its bound")
    check_stats_kept(f"{tag} PGD alone", model, stats0)
    tables = [torch.as_tensor(batch[k_], device=dev) for k_ in TABLE_KEYS[:-2]]
    greedy.build_attack_body()(clean, (k, PGD_BATCH, cfg.adv_lr), *tables,
                               batch["gw_tbucket"], block_matrices=ts.block_matrices)
    torch.cuda.synchronize()
    check_stats_kept(f"{tag} greedy attack alone", model, stats0)
    print(f"{tag} the running statistics did not move in the PGD alone (max|delta| "
          f"{delta.abs().max().item():.5f}) nor in the greedy attack alone "
          f"({greedy.last_stats})")
    return counts, {"ms": ms, "mem_gib": mem, "host_reads": reads}


def phase_bt_slice(dev) -> None:
    """Phase 16's fp32 check: one attacked task_barlowtwins step of 4 pairs,
    the card's kernels against the CPU's plain ops (attacked_slice, cut at
    the head's input: HeadSeam).  The head's BatchNorms divide each feature
    by its spread over the 4 rows, so the spread of the first projection is
    printed beside the result."""
    tag = "[bt attacked slice]"
    cfg32 = bt_config().replace(compute_dtype="float32")
    base = bt_model(cfg32)
    with torch.no_grad():
        b = train_batch(cfg32, N_CPU, SEED + 4, "cpu")
        h = base.barlowtwins_head.projector["0"](base.infer(b)["cls_feats"])
        spread = (h.std(0) / h.abs().mean(0).clamp(min=1e-30)).sort().values
    print(f"{tag} the first projection's spread over the {N_CPU} rows (std / mean|h| per "
          f"feature): min {spread[0].item():.4g}, median "
          f"{spread[spread.numel() // 2].item():.4g}")
    attacked_slice(dev, tag, cfg32, base, seam=True)


def phase_trainer_bt(dev, bare: dict) -> dict:
    """Phase 16's Trainer: Trainer.setup() / fit() / validate() for
    task_barlowtwins, one optimizer step (accum 2) on phase 15's in-memory
    data.  Returns the launches of the run."""
    import shutil
    from rmcl_tpu_torch.models.vilt import ViLT
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import load_state_dict_file
    from rmcl_tpu_torch.train.checkpoint import MODEL_FILE
    tag = "[trainer bt]"
    root = Path(TRAINER_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        t0 = time.perf_counter()
        cfg, dm_cls, model = trainer_setup(dev, str(root), bt=True)
        n = TRAINER_ACCUM * BT_TRAINER_OPT_STEPS
        print(f"{tag} {BT_CONFIG} through Trainer.setup() / fit() / validate(): the fused "
              f"greedy attack on {TRAINER_MIX} captions, batch_size {cfg.batch_size} at "
              f"per_device_batchsize {cfg.per_device_batchsize} (accum {TRAINER_ACCUM}), "
              f"max_steps {cfg.max_steps} ({n} micro-steps), {TRAINER_VAL} validation pairs; "
              f"data ready in {time.perf_counter() - t0:.1f} s")
        stats0 = bt_stats(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FB.reset_launches()
        tr, losses, recs, t_end = _trainer_run(dev, cfg, dm_cls, model, str(root / "bt"))
        counts = dict(FB.launches)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        check(tr.steps_done == n == len(recs), f"{tag} {tr.steps_done} micro-steps, want {n}")
        want = _trainer_expected(cfg, recs, tr.greedy.last_stats)
        check(counts == want, f"{tag} launches {counts}, expected {want}")
        counts = check_sub_launches(tag, counts, FB)
        loss = torch.stack(losses).cpu().numpy()
        check(bool(np.isfinite(loss).all()), f"{tag} non-finite losses {loss}")
        check_stats_moved(tag, tr.ts.model, stats0)
        moved = [n_ for n_, p in tr.ts.model.named_parameters() if not n_.endswith("mask_token")
                 and torch.equal(p.detach().cpu(), dict(model.named_parameters())[n_])]
        check(not moved, f"{tag} parameters {moved[:3]} did not move")
        # micro-step 0's start to micro-step 1's: one micro-step with the loop
        ms = (recs[1]["t"] - recs[0]["t"]) * 1e3
        call_ms = (recs[0]["t_out"] - recs[0]["t"]) * 1e3
        print(f"{tag} launches of the run: each micro-step's expected_launches and its "
              f"attack's own, the validation batch's expected_eval_launches and its attack's: "
              f"{counts}")
        print(f"{tag} losses {[float(x) for x in loss]}; every parameter and running "
              "statistic moved")
        print(f"{tag} Trainer {ms!r} ms for micro-step 0 (host clock from its start to "
              f"micro-step 1's: the step's call {call_ms!r}, the loop {ms - call_ms!r}), "
              f"{PGD_BATCH / ms * 1e3!r} pairs/s; max_memory_allocated {mem:.2f} GiB; the run "
              f"with its validation and two checkpoint saves {t_end - recs[0]['t']:.1f} s")
        print(f"{tag} bare attacked step ({TRAINER_MIX} captions): {bare['ms']!r} ms, "
              f"{PGD_BATCH / bare['ms'] * 1e3!r} pairs/s, {bare['mem_gib']:.2f} GiB; "
              f"{ms / bare['ms']:.3f}x")
        path = Path(tr.ckpt.checkpoint_dir("last")) / MODEL_FILE
        fresh = ViLT(cfg)
        check(fresh.load_reference_state_dict(load_state_dict_file(str(path))) == [],
              f"{tag} {path}: entries not loaded")
        live, back = tr.ts.model.state_dict(), fresh.state_dict()
        same = [k for k in live if torch.equal(live[k].cpu(), back[k])]
        check(len(same) == len(live) == len(back), f"{tag} {len(live) - len(same)} tensors of "
                                                   "'last' differ from the trained model")
        print(f"{tag} 'last' loads into a fresh ViLT: {len(same)} tensors equal, the six "
              "running statistics among them")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------ downstream
DOWNSTREAM = {  # task -> the named configuration phase 17 trains it under
    "vqa_attacked": "task_finetune_vqa_randaug_attacked",
    "nlvr2_attacked": "task_finetune_nlvr2_randaug_attacked",
    "irtr": "task_finetune_irtr_coco",
}
DOWNSTREAM_STEPS = 2                    # timed steps per path, after one warm-up
IRTR_IMAGES = 8                         # x (1 + draw_false_text 15) texts: 128 rows
IRTR_CPU_IMAGES = 1                     # the fp32 check's: 16 rows
RECALL_IMAGES, RECALL_CAPTIONS = 8, 5   # 40 texts
WRITER_QUESTIONS = PGD_BATCH
DOWNSTREAM_DIR = "chip_smoke_downstream.tmp"   # the writer's file and vocabulary, removed


def downstream_config(task: str, **kw):
    """``task``'s named configuration as phase 17 runs it: ViLT-B/32 at full
    width and depth, every patch (max_image_len -1: S = 40 + 229), image and
    text views on, drop_rate 0.1, warmup 0, bf16."""
    from rmcl_tpu_torch import build_config
    return build_config(DOWNSTREAM[task], image_view=True, text_view=True, drop_rate=DROP_P,
                        warmup_steps=0, max_steps=1000, **kw)


def _has(cfg, prefix: str) -> bool:
    from rmcl_tpu_torch.core.config import active_tasks
    return any(t.startswith(prefix) for t in active_tasks(cfg))


def downstream_batch(cfg, n: int, seed: int, dev) -> dict:
    """``train_batch`` plus the keys of cfg's downstream task: seeded VQA
    soft targets (three answers per question), NLVR2's two images and its
    labels, IRTR's ``draw_false_text`` false texts."""
    batch = train_batch(cfg, n, seed, dev)
    r = np.random.RandomState(seed + 200)
    if _has(cfg, "vqa"):
        t = np.zeros((n, cfg.vqav2_label_size), np.float32)
        for i in range(n):
            t[i, r.choice(cfg.vqav2_label_size, 3, replace=False)] = (1.0, 0.6, 0.3)
        batch["vqa_targets"] = torch.from_numpy(t).to(dev)
    if _has(cfg, "nlvr2"):
        batch["image_0"] = batch.pop("image")
        batch["image_1"] = pgd_batch(cfg, n, seed + 1, dev)["image"]
        batch["answers"] = torch.from_numpy(r.randint(0, 2, n).astype(np.int32)).to(dev)
    if _has(cfg, "irtr"):
        for i in range(cfg.draw_false_text):
            other = pgd_batch(cfg, n, seed + 10 + i, dev)
            batch[f"false_text_{i}_ids"] = other["text_ids"]
            batch[f"false_text_{i}_masks"] = other["text_masks"]
    return batch


def downstream_launches(cfg, task: str, stats=None) -> dict:
    """Block-op launches of one step of a downstream task (default blocks,
    drop_rate > 0): PGD's forwards and dx backwards per image, the training
    forwards and backwards (VQA one, NLVR2 two per pass and two passes,
    IRTR one over B x 16 rows) and their embedding dropouts (text and image
    each way; IRTR's image embedding takes none), plus the greedy attack's
    own count (``stats``), two forwards a pass for NLVR2."""
    from rmcl_tpu_torch.ops import fused_block as FB
    L, A = cfg.num_layers, cfg.adv_steps_img
    images = 2 if task.startswith("nlvr2") else 1
    pgd = A * images * L if task.endswith("_attacked") and cfg.image_view else 0
    n_t = {"vqa_attacked": 1, "nlvr2_attacked": 4, "irtr": 1}[task]
    want = dict.fromkeys(FB.launches, 0)
    want.update(attn_half=pgd, mlp_half=pgd, attn_half_dx=pgd, mlp_half_dx=pgd,
                attn_half_train=n_t * L, attn_half_train_bwd=n_t * L,
                mlp_half_train=n_t * L, mlp_half_train_bwd=n_t * L,
                dropout=n_t * (2 if task == "irtr" else 4))
    if stats is not None:
        attack = attack_launches(stats, L, images)
        want = {k: v + attack[k] for k, v in want.items()}
    return want


def phase_downstream_step(dev, task: str, mix=None) -> tuple:
    """Phase 17: one downstream task's step at full width, bf16: the attacked
    step (the fused greedy attack on ``mix``'s captions, PGD, the training
    forwards) for vqa_attacked and nlvr2_attacked on 16 pairs, the clean
    step for irtr on 8 images x 16 texts.  Returns (launches of a step, its
    readings)."""
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.step import (create_train_state, make_attacked_train_step,
                                           make_train_step)
    t0 = time.perf_counter()
    cfg = downstream_config(task)
    n = IRTR_IMAGES if task == "irtr" else PGD_BATCH
    ts = create_train_state(cfg, model=seeded_model(cfg, SEED), device=dev)
    model = ts.model
    batch = downstream_batch(cfg, n, SEED + 4, dev)
    greedy = None
    if mix is not None:
        greedy, batch, _ = attacked_batch(cfg, model, batch, mix)
        step = make_attacked_train_step(cfg, ts, greedy)
    else:
        step = make_train_step(cfg, ts)
    tag = f"[downstream {task}{' ' + mix if mix else ''}]"
    rows = n * (cfg.draw_false_text + 1) if task == "irtr" else n
    print(f"{tag} {DOWNSTREAM[task]}, blocks {model.block_impls}, S = {cfg.max_text_len} + "
          f"{cfg.grid_hw[0] * cfg.grid_hw[1] + 1}, {n} {'images' if task == 'irtr' else 'pairs'}"
          f" ({rows} rows), drop_rate {cfg.drop_rate}, "
          + (f"PGD {cfg.adv_steps_img} steps, the greedy attack inside the step on {mix} "
             f"captions (n_candidates {cfg.n_candidates}, max_loops {cfg.max_loops}, "
             f"greedy_compact_frac {cfg.greedy_compact_frac}), text bucket "
             f"{batch['gw_tbucket'].shape[1]}" if mix else "the clean step")
          + f"; state ready in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(SEED + 7)
    step(batch, gen)                                        # warm-up
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, events, stats = [], [], []
    for it in range(DOWNSTREAM_STEPS):
        before = {n_: p.detach().clone() for n_, p in model.named_parameters()}
        FB.reset_launches()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0.record()
        metrics = step(batch, gen)
        e1.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        events.append(e0.elapsed_time(e1))
        counts = dict(FB.launches)
        st = dict(greedy.last_stats) if greedy is not None else None
        stats.append(st)
        want = downstream_launches(cfg, task, st)
        check(counts == want, f"{tag} step {it}: launches {counts}, expected {want}")
        counts = check_sub_launches(f"{tag} step {it}", counts, FB)
        vals = {k: v.item() for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        check(not bad, f"{tag} step {it}: non-finite metrics {bad}")
        # the loss reaches every parameter but MPP's mask_token and, for IRTR,
        # the ITM head of the inactive itm loss
        learnt = [n_ for n_, p in model.named_parameters()
                  if p.grad is not None and bool(p.grad.abs().max() > 0)]
        still = [n_ for n_ in learnt
                 if torch.equal(dict(model.named_parameters())[n_].detach(), before[n_])]
        check(learnt and not still, f"{tag} step {it}: {still[:3]} did not move")
        print(f"{tag} step {it}: " + " ".join(f"{k}={v!r}" for k, v in sorted(vals.items()))
              + (f"; attack {st}" if st else "") + f"; the {len(learnt)} parameters the loss "
              f"reaches moved; {walls[-1]:.1f} ms")
    busy = device_ms(lambda: step(batch, gen), iters=1, warmup=0)
    ms, ev = statistics.median(walls), statistics.median(events)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{tag} launches per step {counts}: every block through the kernels")
    print(f"{tag} step {ms!r} ms (median of {DOWNSTREAM_STEPS}, host clock + synchronize; "
          f"{ev!r} ms between CUDA events), device busy "
          f"{'not measured' if busy is None else repr(busy) + ' ms'} (torch.profiler, one "
          f"step), {n / ms * 1e3!r} {'images' if task == 'irtr' else 'pairs'}/s; "
          f"max_memory_allocated {mem:.2f} GiB")
    out = {"ms": ms, "device_ms": busy, "mem_gib": mem}
    if stats[0] is not None:
        out.update(loops=statistics.median(s_["loops"] for s_ in stats),
                   host_reads=statistics.median(s_["host_reads"] for s_ in stats),
                   num_changes=vals["num_changes"], change_rate=vals["change_rate"])
    if "nlvr2_flip_rate" in vals:
        out["flip_rate"] = vals["nlvr2_flip_rate"]
    return counts, out


def phase_downstream_slice(dev, task: str) -> None:
    """Phase 17's fp32 check of ``task``: one step of 4 pairs (IRTR: one
    image x 16 texts) at SLICE_LAYERS, the card's kernels against the CPU's
    plain ops from the same weights, batch and dropout seeds: the attacked
    token ids equal (attacked_slice), the loss within 1e-5 relative, every
    gradient within 2e-4 * max(1, max|ref|), every updated parameter within
    AdamW's bounds at its rate (the heads at lr x lr_mult)."""
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = f"[downstream slice {task}]"
    from rmcl_tpu_torch.train.schedule import HEAD_NAMES
    cfg32 = downstream_config(task).replace(compute_dtype="float32", num_layers=SLICE_LAYERS)
    base = seeded_model(cfg32, SEED)

    def rate(path):
        head = any(h in path for h in HEAD_NAMES)
        return cfg32.learning_rate * (cfg32.lr_mult if head else 1)

    if task.endswith("_attacked"):
        attacked_slice(dev, tag, cfg32, base, batch_fn=downstream_batch, rate=rate)
        return
    # one image and its 16 texts: as many rows as task_moco's fp32 step runs
    batch = downstream_batch(cfg32, IRTR_CPU_IMAGES, SEED + 4, "cpu")
    results = {}
    for where in ("cpu", dev):
        ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
        t0 = time.perf_counter()
        metrics = make_train_step(cfg32, ts)({k: v.to(where) for k, v in batch.items()},
                                             torch.Generator().manual_seed(SEED + 8))
        results[str(where)] = _step_result(ts, metrics, t0)
    _train_results(tag, results, dev, cfg32.learning_rate, rate)


def _memory_trainer(dev, cfg, make_dataset, model, answers=None):
    """A Trainer on the card, set up, over ``memory_datamodule``."""
    from rmcl_tpu_torch.train.loop import Trainer
    tr = Trainer(cfg, workdir=cfg.log_dir,
                 datamodule=memory_datamodule(make_dataset, answers)(cfg), device=dev)
    tr.setup(model=model)
    return tr


def phase_downstream_writer(dev, root: Path) -> dict:
    """Phase 17: Trainer.validate("test") for task_finetune_vqa_randaug_attacked
    on 16 questions in memory: the greedy attack and PGD of the eval step,
    the submission file in log_dir with one answer per question, each one of
    the answer table's.  Returns its launches."""
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    tag = "[downstream vqa writer]"
    base = downstream_config("vqa_attacked")
    _, _, sents = greedy_setup(base, WRITER_QUESTIONS, GREEDY_SLICE_MIX, keep_dir=str(root))
    cfg = base.replace(tokenizer=f"{root}/vocab.txt", embedding_path=f"{root}/vectors.txt",
                       sim_path="", batch_size=PGD_BATCH, log_dir=str(root / "log"))
    images = memory_images(cfg, WRITER_QUESTIONS, SEED + 11)
    answers = [f"answer{i}" for i in range(cfg.vqav2_label_size)]

    def vqa_keys(i):
        return {"vqa_answer": [], "vqa_labels": [], "vqa_scores": [], "qid": 1000 + i}

    def make(tok, split):
        return MemoryDataset(tok, sents, images, cfg.max_text_len, extra=vqa_keys)

    t0 = time.perf_counter()
    tr = _memory_trainer(dev, cfg, make, seeded_model(cfg, SEED), answers)
    torch.cuda.synchronize()
    FB.reset_launches()
    t = time.perf_counter()
    tr.validate("test")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(FB.launches)
    path = Path(cfg.log_dir) / f"vqa_submit_{cfg.exp_name}.json"
    check(path.is_file(), f"{tag} no submission at {path}")
    rows = json.loads(path.read_text())
    check(sorted(r["question_id"] for r in rows) == [1000 + i for i in range(WRITER_QUESTIONS)]
          and all(r["answer"] in answers for r in rows), f"{tag} the submission {rows[:3]}")
    check(counts["attn_half"] > 0 and counts["attn_half_dx"] > 0,
          f"{tag} launches {counts}: the eval step's attacks ran no kernel")
    counts = check_sub_launches(tag, counts, FB)
    print(f"{tag} validate('test') on {WRITER_QUESTIONS} questions ({GREEDY_SLICE_MIX} "
          f"captions; the greedy attack {tr.greedy.last_stats}, PGD, the eval forward) wrote "
          f"{path.name}: {len(rows)} answers, e.g. {rows[0]}; {wall:.2f} s (setup "
          f"{t - t0:.1f} s); launches {counts}")
    return counts


def phase_downstream_recall(dev, root: Path) -> tuple:
    """Phase 17: the IR/TR recall on 8 images x 5 captions in memory: clean
    (compute_irtr_recall) and attacked (compute_attacked_irtr_recall: the
    fused greedy IRTR attack on the captions, the IRTR PGD on each image),
    irtr beside irtr_attacked (rank_output and the MoCo head).  Returns
    (clean launches, attacked launches, readings)."""
    from rmcl_tpu_torch.core.config import loss_names
    from rmcl_tpu_torch.eval import retrieval
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    tag = "[downstream recall]"
    n_txt = RECALL_IMAGES * RECALL_CAPTIONS
    base = downstream_config("irtr", loss_names=loss_names({"irtr": 1, "irtr_attacked": 1}))
    _, _, sents = greedy_setup(base, n_txt, TRAINER_MIX, keep_dir=str(root))
    cfg = base.replace(tokenizer=f"{root}/vocab.txt", embedding_path=f"{root}/vectors.txt",
                       sim_path="", batch_size=PGD_BATCH, log_dir=str(root / "log"))
    images = memory_images(cfg, RECALL_IMAGES, SEED + 12)

    def make(tok, split):
        return MemoryDataset(tok, sents, images, cfg.max_text_len, RECALL_CAPTIONS)

    tr = _memory_trainer(dev, cfg, make, seeded_model(cfg, SEED))
    out, counts, seen = {}, {}, []
    ranked = retrieval.recall_at_k

    def recall_at_k(scores, iids, tiids):                 # keeps the matrix it ranks
        seen.append(np.asarray(scores).copy())
        return ranked(scores, iids, tiids)

    retrieval.recall_at_k = recall_at_k
    try:
        for name, fn in (("clean", lambda: retrieval.compute_irtr_recall(tr)),
                         ("attacked", lambda: retrieval.compute_attacked_irtr_recall(
                             tr, max_texts=n_txt))):
            fn()                                          # warm-up
            torch.cuda.synchronize()
            FB.reset_launches()
            t = time.perf_counter()
            recall = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            out[name] = _recall_reading(tag, name, cfg, recall, seen[-1], wall, FB, counts)
    finally:
        retrieval.recall_at_k = ranked
    check(counts["attacked"]["attn_half_dx"] > 0, f"{tag} the attacks ran no dx kernel")
    return counts["clean"], counts["attacked"], out


def _recall_reading(tag, name, cfg, recall, scores, wall, FB, counts) -> dict:
    """Checks one recall run (its tuple, the score matrix it ranked, its
    launches) and prints its readings."""
    n_txt = RECALL_IMAGES * RECALL_CAPTIONS
    counts[name] = check_sub_launches(f"{tag} {name}", dict(FB.launches), FB)
    check(scores.shape == (RECALL_IMAGES, n_txt) and np.isfinite(scores).all()
          and all(0.0 <= r <= 1.0 for r in recall), f"{tag} {name}: {recall}")
    check(counts[name]["attn_half"] >= RECALL_IMAGES * cfg.num_layers,
          f"{tag} {name}: launches {counts[name]}")
    print(f"{tag} {name}: {RECALL_IMAGES} images x {n_txt} texts, (ir_r1, ir_r5, ir_r10, "
          f"tr_r1, tr_r5, tr_r10) = {recall}; {wall!r} s ({wall / RECALL_IMAGES!r} s per "
          f"image); launches {counts[name]}")
    return {"s": wall, "s_per_image": wall / RECALL_IMAGES, "recall": recall}


def phase_downstream(dev) -> dict:
    """Phase 17 whole: the attacked VQA and NLVR2 steps on both caption mixes,
    the IRTR step, the fp32 checks, the VQA writer and the two recalls.
    Returns the launches by path."""
    import shutil
    counts, t = {}, [time.perf_counter()]
    for task in ("vqa_attacked", "nlvr2_attacked"):
        for mix in GREEDY_MIXES:
            counts[f"{task}_{mix}"] = phase_downstream_step(dev, task, mix)[0]
    counts["irtr"] = phase_downstream_step(dev, "irtr")[0]
    t.append(time.perf_counter())
    for task in DOWNSTREAM:
        phase_downstream_slice(dev, task)
    t.append(time.perf_counter())
    root = Path(DOWNSTREAM_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        counts["vqa_writer"] = phase_downstream_writer(dev, root)
        counts["recall"], counts["recall_attacked"], _ = phase_downstream_recall(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t.append(time.perf_counter())
    print(f"[downstream] phase 17 in {t[-1] - t[0]:.1f} s: the bf16 steps "
          f"{t[1] - t[0]:.1f} s, the fp32 card-against-CPU steps {t[2] - t[1]:.1f} s, "
          f"the VQA writer and the recalls {t[3] - t[2]:.1f} s")
    return counts


# ----------------------------------------------------------- pretraining
PRETRAIN_CONFIG = "task_mlm_itm_mpp"
PRETRAIN_STEPS = 3                       # timed steps, after one warm-up
PRETRAIN_DIR = "chip_smoke_pretrain.tmp"  # the Trainer's files and the graft's, removed
PRETRAIN_FORWARDS = ("mlm", "mpp", "mppd", "mpfr", "itm")   # one training forward each


def pretrain_config(config: str = PRETRAIN_CONFIG, **kw):
    """``config`` as phase 18 runs it: ViLT-B/32 at full width and depth,
    max_image_len 200 (S = 40 + 201), drop_rate 0.1, warmup 0, bf16."""
    from rmcl_tpu_torch import build_config
    return build_config(config, drop_rate=DROP_P, warmup_steps=0, max_steps=1000, **kw)


class _BertIds:
    """The BERT vocabulary's special ids, all the MLM collator reads of a
    tokenizer (the vocabulary file is not in the repository)."""
    pad_token_id, unk_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 100, 101, 102, 103
    vocab_size = 30522


def pretrain_batch(cfg, n: int, seed: int, dev) -> dict:
    """n pairs in the u8 wire format (``synthetic_requests``: ragged images,
    padded BERT-like ids), ``false_image_0`` with its ``_hw`` from other
    seeds, and the port's MLM collator's ``text_ids_mlm`` /
    ``text_labels_mlm``."""
    from rmcl_tpu_torch.data.mlm import MLMCollator
    reqs = synthetic_requests(cfg, n, seed)
    false = synthetic_requests(cfg, n, seed + 1)
    ids = reqs["text_ids"]
    special = np.isin(ids, [0, 101, 102])
    mlm_ids, mlm_labels = MLMCollator(_BertIds(), seed=seed)(ids, special)
    out = dict(reqs, false_image_0=false["image"], false_image_0_hw=false["image_hw"],
               text_ids_mlm=mlm_ids, text_labels_mlm=mlm_labels)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}


def pretrain_launches(cfg, train: bool = True) -> dict:
    """Block-op launches of one pretraining step of the default blocks at
    drop_rate > 0: a training forward and its backward per active task
    (``PRETRAIN_FORWARDS``), each with its text and image embedding
    dropouts both ways; of one validation batch with ``train`` off, a
    deterministic forward per task."""
    from rmcl_tpu_torch.core.config import active_tasks
    from rmcl_tpu_torch.ops import fused_block as FB
    L = cfg.num_layers
    n = sum(t in PRETRAIN_FORWARDS for t in active_tasks(cfg))
    want = dict.fromkeys(FB.launches, 0)
    if train:
        want.update(attn_half_train=n * L, attn_half_train_bwd=n * L, mlp_half_train=n * L,
                    mlp_half_train_bwd=n * L, dropout=4 * n)
    else:
        want.update(attn_half=n * L, mlp_half=n * L)
    return want


class _KeepDraws:
    """Keeps the draws of every ``pretrain_draws`` call while installed."""

    def __enter__(self):
        import rmcl_tpu_torch.train.step as step_mod
        self.mod, self.inner, self.seen = step_mod, step_mod.pretrain_draws, []

        def keep(*a, **kw):
            self.seen.append(self.inner(*a, **kw))
            return self.seen[-1]

        step_mod.pretrain_draws = keep
        return self

    def __exit__(self, *exc):
        self.mod.pretrain_draws = self.inner


def ipot_reading(dev, B: int, M: int, N: int) -> dict:
    """One IPOT solve (objectives/ot.py, 50 rounds) at the ITM forward's
    shapes on seeded costs with padding: its kernel launches counted by
    torch.profiler beside the derived ``LAUNCHES_PER_ROUND`` a round, its
    device time and its time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rmcl_tpu_torch.objectives import ot
    g = torch.Generator(device=dev).manual_seed(SEED)
    C = torch.rand(B, M, N, generator=g, device=dev) * 2
    x_pad = torch.arange(M, device=dev)[None] >= torch.randint(4, M, (B, 1), generator=g,
                                                                device=dev)
    y_pad = torch.arange(N, device=dev)[None] >= torch.randint(8, N, (B, 1), generator=g,
                                                                device=dev)
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    x_len, y_len = (M - x_pad.sum(1)).float(), (N - y_pad.sum(1)).float()

    def run():
        return ot.ipot(C, x_len, x_pad, y_len, y_pad, joint, 0.5, 50, 1)

    ms = time_ms(run, iters=5, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    n = sum(e.count for e in ev)
    us = sum(_device_us(e) for e in ev)
    check(bool(torch.isfinite(run()).all()), "[pretrain] IPOT plan not finite")
    return {"launches": n or None, "derived": 50 * ot.LAUNCHES_PER_ROUND,
            "device_ms": us / 1e3 if us > 0 else None, "ms": ms}


def _moved_params(model, before: dict) -> tuple:
    """(names whose gradient is nonzero, those of them that did not move)."""
    learnt = [n_ for n_, p in model.named_parameters()
              if p.grad is not None and bool(p.grad.abs().max() > 0)]
    named = dict(model.named_parameters())
    return learnt, [n_ for n_ in learnt if torch.equal(named[n_].detach(), before[n_])]


def phase_pretrain_step(dev) -> tuple:
    """Phase 18 (a): task_mlm_itm_mpp at full width, bf16, 16 pairs: one
    warm-up and three timed make_train_step steps.  Returns (launches of a
    step, readings)."""
    from rmcl_tpu_torch.objectives import ot
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = "[pretrain mlm_itm_mpp]"
    t0 = time.perf_counter()
    cfg = pretrain_config()
    ts = create_train_state(cfg, model=seeded_model(cfg, SEED), device=dev)
    model = ts.model
    batch = pretrain_batch(cfg, PGD_BATCH, SEED + 4, dev)
    step = make_train_step(cfg, ts)
    L = cfg.num_layers
    print(f"{tag} {PRETRAIN_CONFIG}, blocks {model.block_impls}, S = {cfg.max_text_len} + "
          f"{min(cfg.grid_hw[0] * cfg.grid_hw[1], cfg.max_image_len) + 1} ({cfg.grid_hw[0]} x "
          f"{cfg.grid_hw[1]} patches, max_image_len {cfg.max_image_len}), {PGD_BATCH} pairs, "
          f"u8 wire, drop_rate {cfg.drop_rate}, the MLM collator's masks "
          f"({int((batch['text_labels_mlm'] != -100).sum())} labelled tokens); state ready in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(SEED + 7)
    step(batch, gen)                                        # warm-up
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, events = [], []
    for it in range(PRETRAIN_STEPS):
        before = {n_: p.detach().clone() for n_, p in model.named_parameters()}
        FB.reset_launches()
        ot.reset_ipot_calls()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with _KeepDraws() as kept:
            torch.cuda.synchronize()
            t = time.perf_counter()
            e0.record()
            metrics = step(batch, gen)
            e1.record()
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        events.append(e0.elapsed_time(e1))
        counts, want = dict(FB.launches), pretrain_launches(cfg)
        check(counts == want, f"{tag} step {it}: launches {counts}, expected {want}")
        counts = check_sub_launches(f"{tag} step {it}", counts, FB)
        check(dict(ot.ipot_calls) == {"calls": 1, "rounds": 50},
              f"{tag} step {it}: IPOT calls {ot.ipot_calls}")
        vals = {k: v.item() for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        check(not bad, f"{tag} step {it}: non-finite metrics {bad}")
        ones = int(kept.seen[0]["itm"].sum())
        check(ones == PGD_BATCH // 2, f"{tag} step {it}: {ones} ITM positives")
        learnt, still = _moved_params(model, before)
        every = [n_ for n_, _ in model.named_parameters()]
        need = ("transformer.mask_token", "mpp_score.decoder.weight",
                "mlm_score.decoder.weight", "itm_score.fc.weight")
        check(set(learnt) == set(every) and not still and all(n_ in learnt for n_ in need),
              f"{tag} step {it}: not reached {sorted(set(every) - set(learnt))[:3]}, "
              f"not moved {still[:3]}")
        print(f"{tag} step {it}: " + " ".join(f"{k}={v!r}" for k, v in sorted(vals.items()))
              + f"; {ones} ITM positives; all {len(learnt)} parameters reached and moved "
              f"(mask_token, mpp_score, mlm_score, itm_score among them); {walls[-1]:.1f} ms")
    busy = device_ms(lambda: step(batch, gen), iters=1, warmup=0)
    ms, ev = statistics.median(walls), statistics.median(events)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    ipot = ipot_reading(dev, PGD_BATCH, cfg.max_text_len,
                        min(cfg.grid_hw[0] * cfg.grid_hw[1], cfg.max_image_len) + 1)
    print(f"{tag} launches per step {counts}: rows 8, 9, 6, 7 each {3 * L} (three training "
          f"forwards x {L} layers), dropout {4 * 3} (text and image, each forward both ways)")
    print(f"{tag} step {ms!r} ms (median of {PRETRAIN_STEPS}, host clock + synchronize; "
          f"{ev!r} ms between CUDA events), device busy "
          f"{'not measured' if busy is None else repr(busy) + ' ms'} (torch.profiler, one "
          f"step), {PGD_BATCH / ms * 1e3!r} pairs/s; max_memory_allocated {mem:.2f} GiB")
    print(f"{tag} IPOT, one solve per step at B={PGD_BATCH} M={cfg.max_text_len} "
          f"N={min(cfg.grid_hw[0] * cfg.grid_hw[1], cfg.max_image_len) + 1}: "
          f"{ipot['launches'] if ipot['launches'] else 'not measured'} kernel launches "
          f"(torch.profiler; derived {ipot['derived']} = 50 rounds x "
          f"{ot.LAUNCHES_PER_ROUND}, plus the set-up's), device "
          f"{'not measured' if ipot['device_ms'] is None else repr(ipot['device_ms']) + ' ms'}"
          f", {ipot['ms']!r} ms per call (CUDA events)")
    return counts, {"ms": ms, "device_ms": busy, "mem_gib": mem, "ipot": ipot, "model": model}


def phase_pretrain_dense(dev, trained) -> dict:
    """Phase 18 (b): one bf16 step with mppd and mpfr beside task_mlm_itm_mpp's
    losses, 16 pairs, from (a)'s ``trained`` model and two seeded heads: its
    launches (five training forwards), finite losses, the two regression
    heads moved.  Returns its launches."""
    from rmcl_tpu_torch.core.config import loss_names
    from rmcl_tpu_torch.models.layers import reset_all
    from rmcl_tpu_torch.models.vilt import ViLT
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = "[pretrain mppd mpfr]"
    cfg = pretrain_config(loss_names=loss_names(dict.fromkeys(PRETRAIN_FORWARDS, 1)))
    model = ViLT(cfg)
    g = torch.Generator().manual_seed(SEED + 6)
    reset_all(model.mppd_score, g)
    reset_all(model.mpfr_score, g)
    skipped = model.load_state_dict(trained.state_dict(), strict=False)
    check(sorted(skipped.missing_keys) == sorted(k for k in model.state_dict() if k.startswith(
        ("mppd_score.", "mpfr_score."))) and not skipped.unexpected_keys, f"{tag} {skipped}")
    ts = create_train_state(cfg, model=model, device=dev)
    batch = pretrain_batch(cfg, PGD_BATCH, SEED + 5, dev)
    before = {n_: p.detach().clone() for n_, p in ts.model.named_parameters()}
    torch.cuda.synchronize()
    FB.reset_launches()
    t = time.perf_counter()
    metrics = make_train_step(cfg, ts)(batch, torch.Generator().manual_seed(SEED + 7))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    counts, want = dict(FB.launches), pretrain_launches(cfg)
    check(counts == want, f"{tag} launches {counts}, expected {want}")
    counts = check_sub_launches(tag, counts, FB)
    vals = {k: v.item() for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    check(not bad, f"{tag} non-finite metrics {bad}")
    learnt, still = _moved_params(ts.model, before)
    heads = [n_ for n_ in before if n_.startswith(("mppd_score.", "mpfr_score."))]
    check(len(heads) == 12 and set(heads) <= set(learnt) and not still,
          f"{tag} heads reached {sorted(set(heads) & set(learnt))}, not moved {still[:3]}")
    print(f"{tag} one step, five training forwards: " + " ".join(
        f"{k}={v!r}" for k, v in sorted(vals.items()) if "mppd" in k or "mpfr" in k)
        + f"; the {len(heads)} mppd_score / mpfr_score parameters moved; launches {counts}; "
        f"{wall:.1f} ms (the first step of its state)")
    return counts


def _mpp_labels_agree(tag, cfg, model, batch, masks, dev) -> None:
    """MPP's labels of the masked embedding on the CPU and on the card, the
    same rows and masks: equal, but where the CPU's mean x 255 lies within
    1e-4 of an integer (the truncation of a mean whose reduction orders
    differ); the margin of every differing label is printed."""
    from rmcl_tpu_torch.models.vit import normalize_u8, patch_mean_rgb
    labels = {}
    for where in ("cpu", dev):
        m = copy.deepcopy(model).to(where)
        b = {k: v.to(where) for k, v in batch.items()}
        img = normalize_u8(b["image"], b["image_hw"], cfg.grid_hw, cfg.patch_size)
        with torch.no_grad():
            labels[str(where)] = m.transformer.visual_embed_masked(
                img, cfg.grid_hw, cfg.max_image_len, m.compute_dtype, *masks.to(where))[2].cpu()
            if where == "cpu":
                sel = m.transformer.visual_embed_prepare(img, cfg.grid_hw, cfg.max_image_len).sel
                scaled = patch_mean_rgb(img * 0.5 + 0.5) * 255
        del m
    margin = (scaled - scaled.round()).abs()
    if sel is not None:
        margin = torch.gather(margin, 1, sel[..., None].expand(-1, -1, 3))
    margin = torch.cat([torch.full_like(margin[:, :1], float("inf")), margin], dim=1)
    ref, ours = labels["cpu"], labels[str(dev)]
    differ = ref != ours
    check(torch.equal(ref == -100, ours == -100), f"{tag} MPP label masks differ")
    check(bool((margin[differ] < 1e-4).all()), f"{tag} MPP labels differ away from a "
                                               f"truncation boundary: {margin[differ]}")
    print(f"{tag} MPP labels: {int((ref[..., 0] != -100).sum())} masked patches x 3 "
          f"channels, {int(differ.sum())} labels differ"
          + (f" at CPU margins {margin[differ].tolist()}" if differ.any() else "")
          + " (truncation rule: within 1e-4 of an integer)")


def phase_pretrain_slice(dev) -> None:
    """Phase 18 (c): one fp32 task_mlm_itm_mpp step of 4 pairs at SLICE_LAYERS
    on the card and on the CPU from the same weights, batch and generator
    (the same dropout seeds, ITM labels and MPP masks): the draws equal,
    _train_results' tolerances, MPP's labels (_mpp_labels_agree)."""
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = "[pretrain slice]"
    cfg32 = pretrain_config().replace(compute_dtype="float32", num_layers=SLICE_LAYERS)
    base = seeded_model(cfg32, SEED)
    batch = pretrain_batch(cfg32, N_CPU, SEED + 4, "cpu")
    results, draws = {}, {}
    for where in ("cpu", dev):
        ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
        t0 = time.perf_counter()
        with _KeepDraws() as kept:
            metrics = make_train_step(cfg32, ts)({k: v.to(where) for k, v in batch.items()},
                                                 torch.Generator().manual_seed(SEED + 8))
        results[str(where)] = _step_result(ts, metrics, t0)
        draws[str(where)] = {k: v.cpu() for k, v in kept.seen[0].items()}
        del ts
    check(all(torch.equal(draws["cpu"][k], draws[str(dev)][k]) for k in draws["cpu"]),
          f"{tag} the card and the CPU drew differently")
    _train_results(tag, results, dev, cfg32.learning_rate)
    _mpp_labels_agree(tag, cfg32, base, batch, draws["cpu"]["mpp"], dev)


def phase_pretrain_trainer(dev, root: Path) -> tuple:
    """Phase 18 (d): task_mlm_itm through Trainer.setup() / fit() / validate()
    on an in-memory datamodule (32 pairs at 16 per step: accum 2, one
    optimizer step; 16 validation pairs), the weights loaded from a
    synthetic load_path with the MLM and ITM heads grafted from a synthetic
    models_weight/vilt_200k_mlm_itm.ckpt.  Returns (the fit's launches,
    validate's)."""
    import os
    from rmcl_tpu_torch.models.vilt import ViLT
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.checkpoint import ITM_HEAD_KEYS, MLM_HEAD_KEYS, load_initial_params
    tag = "[pretrain trainer]"
    n_train = PGD_BATCH * TRAINER_ACCUM
    t0 = time.perf_counter()
    base = pretrain_config("task_mlm_itm")
    _, _, sents = greedy_setup(base, n_train + TRAINER_VAL, TRAINER_MIX, keep_dir=str(root))
    cfg = base.replace(tokenizer=f"{root}/vocab.txt", datasets=("coco",),
                       batch_size=n_train, per_device_batchsize=PGD_BATCH, max_steps=1,
                       max_epoch=1, log_dir=str(root / "log"),
                       load_path=str(root / "weights.ckpt"))
    images = memory_images(cfg, len(sents), SEED + 13)
    split = {"train": slice(0, n_train), "val": slice(n_train, None),
             "test": slice(n_train, None)}

    def make(tok, s):
        texts, imgs = sents[split[s]], images[split[s]]
        return MemoryDataset(tok, texts, imgs, cfg.max_text_len,
                             extra=lambda i: {"false_image_0": [imgs[(i + 1) % len(imgs)]]})

    saved = seeded_model(cfg, SEED).state_dict()
    torch.save({"state_dict": saved}, cfg.load_path)
    g = torch.Generator().manual_seed(SEED + 14)
    heads = {k: torch.randn(saved[k].shape, generator=g) for k in MLM_HEAD_KEYS + ITM_HEAD_KEYS}
    (root / "models_weight").mkdir()
    torch.save({"state_dict": heads}, root / "models_weight" / "vilt_200k_mlm_itm.ckpt")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        model = load_initial_params(cfg, ViLT(cfg))   # every tensor comes from the files
    finally:
        os.chdir(cwd)
    sd = model.state_dict()
    check(all(torch.equal(sd[k], v) for k, v in heads.items()),
          f"{tag} the MLM / ITM heads were not grafted")
    check(all(torch.equal(sd[k], v) for k, v in saved.items() if k not in heads),
          f"{tag} the load_path's weights were not loaded")
    print(f"{tag} load_initial_params: {cfg.load_path} with the {len(heads)} MLM / ITM head "
          f"tensors grafted from models_weight/vilt_200k_mlm_itm.ckpt, every one equal; "
          f"data and weights ready in {time.perf_counter() - t0:.1f} s")
    tr = _memory_trainer(dev, cfg.replace(load_path=None), make, model)
    torch.cuda.synchronize()
    FB.reset_launches()
    t = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = dict(FB.launches)
    step_l, val_l = pretrain_launches(cfg), pretrain_launches(cfg, train=False)
    want = {k: TRAINER_ACCUM * step_l[k] + val_l[k] for k in step_l}
    check(tr.steps_done == TRAINER_ACCUM, f"{tag} {tr.steps_done} micro-steps")
    check(counts == want, f"{tag} fit: launches {counts}, expected {want}")
    counts = check_sub_launches(f"{tag} fit", counts, FB)
    FB.reset_launches()
    t = time.perf_counter()
    vm = tr.validate()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t
    vcounts = dict(FB.launches)
    check(vcounts == val_l, f"{tag} validate: launches {vcounts}, expected {val_l}")
    vcounts = check_sub_launches(f"{tag} validate", vcounts, FB)
    acc = {k: vm[k] for k in ("mlm_accuracy", "itm_accuracy")}
    check(all(0.0 <= v <= 1.0 for v in acc.values()), f"{tag} accuracies {acc}")
    print(f"{tag} fit: {TRAINER_ACCUM} micro-steps (accum {TRAINER_ACCUM}, one optimizer "
          f"step) and its validation, {fit_s:.2f} s, launches {counts}; validate(): "
          f"{TRAINER_VAL} pairs, {val_s:.2f} s, launches {vcounts} (two deterministic forwards "
          f"x {cfg.num_layers} layers), {acc}, val/the_metric {vm['val/the_metric']!r}")
    return counts, vcounts


def phase_pretrain(dev) -> dict:
    """Phase 18 whole: the full-width task_mlm_itm_mpp step, the step with
    mppd and mpfr, the fp32 step against the CPU, the task_mlm_itm Trainer
    with the graft.  Returns the launches by path."""
    import shutil
    counts, t = {}, [time.perf_counter()]
    counts["pretrain"], reading = phase_pretrain_step(dev)
    counts["pretrain_dense"] = phase_pretrain_dense(dev, reading.pop("model"))
    del reading
    t.append(time.perf_counter())
    phase_pretrain_slice(dev)
    t.append(time.perf_counter())
    root = Path(PRETRAIN_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        counts["pretrain_trainer"], counts["pretrain_validate"] = phase_pretrain_trainer(dev,
                                                                                       root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t.append(time.perf_counter())
    print(f"[pretrain] phase 18 in {t[-1] - t[0]:.1f} s (budget 45 s): the bf16 steps "
          f"{t[1] - t[0]:.1f} s, the fp32 card-against-CPU step {t[2] - t[1]:.1f} s, the "
          f"Trainer with the graft {t[3] - t[2]:.1f} s")
    return counts


# ------------------------------------------------------------------ views
VIEWS_STEPS = 3                          # timed benign-view task_moco steps, after a warm-up
VIEWS_MIX = "worst"                      # phase 12's caption mix of the views' captions
VIEW_HW = (384, 384)                     # the stand-in image view, top-left in the canvas
CE_PAIRS = 8                             # the cross-entropy NLVR2 attacker's pairs
VIEWS_CPU_PAIRS = 2                      # the fp32 checks' pairs (the CPU's steps are the cost)
CE_CPU_LOOPS = 2                         # the CE attacker's fp32 loops (the card's run: max_loops)
STANDALONE_CPU_PGD = 2                   # standalone MoCo's fp32 PGD steps (the card's run: 5)
HWC_BATCH = 8
VIEWS_DIR = "chip_smoke_views.tmp"       # the Trainer's files, removed


def views_config(bt: bool = False, **kw):
    """Phase 8's task_moco (``bt``: phase 16's task_barlowtwins) with the benign
    views in place of the attacks: augmentation=True, EDA text views (the
    PEGASUS paraphraser is a download), the image and text views on."""
    base = bt_config() if bt else train_config()
    return base.replace(augmentation=True, type_txt_augm=("EDA",), **kw)


def benign_launches(cfg, train: bool = True) -> dict:
    """Block-op launches of one benign-view step of the default blocks at
    drop_rate > 0: the key forward, deterministic; no PGD and no greedy
    attack, so no dx op (rows 3 and 5); a training forward and backward per
    view (text, image; no "both" view), task_moco's clean query forward, each
    with its text and image embedding dropouts.  With ``train`` off, one
    validation batch: every forward deterministic."""
    from rmcl_tpu_torch.core.config import active_tasks
    from rmcl_tpu_torch.ops import fused_block as FB
    L = cfg.num_layers
    views = int(cfg.text_view) + int(cfg.image_view)
    fwd = views + int("moco" in active_tasks(cfg))
    want = dict.fromkeys(FB.launches, 0)
    if not train:
        want.update(attn_half=(1 + fwd) * L, mlp_half=(1 + fwd) * L)
        return want
    want.update(attn_half=L, mlp_half=L, attn_half_train=fwd * L, mlp_half_train=fwd * L,
                attn_half_train_bwd=views * L, mlp_half_train_bwd=views * L,
                dropout=2 * (fwd + views))
    return want


def view_stand_in(cfg, n: int, seed: int, dev) -> torch.Tensor:
    """n seeded fp32 image views of VIEW_HW, uniform in [-1, 1], top-left in
    the bucket canvas, as patch rows: a stand-in for SimCLRTransform's views,
    which need PIL (the card's machine has none)."""
    from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
    H, W = cfg.image_bucket_hw
    canvas = np.zeros((n, H, W, 3), np.float32)
    canvas[:, :VIEW_HW[0], :VIEW_HW[1]] = np.random.RandomState(seed).uniform(
        -1, 1, (n, *VIEW_HW, 3))
    return torch.from_numpy(hwc_to_patch_rows(canvas, cfg.patch_size)).to(dev)


def views_batch(cfg, n: int, seed: int, dev) -> tuple:
    """(batch, EDA host ms per n captions): train_batch's images, phase 12's
    ``VIEWS_MIX`` captions as the text, their EDA views (TextAugmentation over
    the mix's synonym table, global ``random`` seeded; median of 5 calls, the
    last one's ids) as the attacked text, and the stand-in image view."""
    import random
    from rmcl_tpu_torch.data.augmentation import TextAugmentation
    tok, syn, sents = greedy_setup(cfg, n, VIEWS_MIX)
    aug = TextAugmentation(cfg, tok, synonym_table=syn)
    check(aug.pegasus is None and aug.ranker is None, "EDA views ranked by Jaccard expected")
    random.seed(seed)
    times = []
    for _ in range(5):
        t = time.perf_counter()
        texts, a_ids, a_masks = aug.augment(sents)
        times.append((time.perf_counter() - t) * 1e3)
    changed = sum(a != s for a, s in zip(texts, sents))
    check(changed > 0, f"EDA changed none of {n} captions")
    ids, masks = tok.batch_encode(sents, cfg.max_text_len)
    batch = train_batch(cfg, n, seed, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    batch.update(text_ids=t(ids), text_masks=t(masks), attacked_text_ids=t(a_ids),
                 attacked_text_masks=t(a_masks), augmented_image=view_stand_in(cfg, n, seed, dev))
    return batch, statistics.median(times), (sents[0], texts[0])


def _check_benign_step(tag, cfg, ts, metrics, before, counts, ptr0=None) -> None:
    """One benign step: its launches as benign_launches derives them, finite
    metrics with the views' losses and none of the "both" view or PGD, every
    trained parameter moved, task_moco's twins within the momentum step and
    its pointer advanced."""
    want = benign_launches(cfg)
    check(counts == want, f"{tag}: launches {counts}, expected {want}")
    vals = {k: v.item() for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    check(not bad, f"{tag}: non-finite metrics {bad}")
    views = (("barlowtwins_loss_invariance_text", "barlowtwins_loss_invariance_img")
             if ptr0 is None else ("attacked_txt_loss", "attacked_img_loss"))
    check(all(v in vals for v in views), f"{tag}: views {sorted(vals)}")
    check(not any("both" in k for k in vals) and "pgd_delta" not in vals,
          f"{tag}: a both view or PGD ran: {sorted(vals)}")
    model = ts.model
    for n_, p in model.named_parameters():
        moved = (p.detach() - before[n_]).abs().max().item()
        if n_.startswith("k_"):
            gap = (before[n_[2:]] - before[n_]).abs().max().item()
            check(moved <= (1 - cfg.momentum) * gap * 1.001 + 1e-7, f"{tag}: twin {n_} moved "
                                                                     f"{moved}")
        elif not n_.endswith("mask_token"):
            check(moved > 0, f"{tag}: {n_} did not move")
    if ptr0 is not None:
        ptr1 = int(model.proj_queue_ptr)
        check(ptr1 == (ptr0 + PGD_BATCH) % cfg.num_negative, f"{tag}: pointer {ptr0} -> {ptr1}")


def phase_views_step(dev, bt: bool = False) -> tuple:
    """Phase 19 (a): the benign-view task_moco step (``bt``: (b), one
    task_barlowtwins step) at full width and depth, bf16, 16 pairs, S = 40 +
    201, drop_rate 0.1, through make_train_step: a warm-up and VIEWS_STEPS
    timed steps (task_barlowtwins: one), each checked (_check_benign_step).
    Returns (launches of a step, readings, the model's initial CPU copy or
    None, the train state)."""
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = "[views bt]" if bt else "[views moco]"
    t0 = time.perf_counter()
    cfg = views_config(bt)
    model = bt_model(cfg) if bt else moco_model(cfg)
    cpu_copy = None if bt else copy.deepcopy(model)
    ts = create_train_state(cfg, model=model, device=dev)
    batch, eda_ms, example = views_batch(cfg, PGD_BATCH, SEED + 4, dev)
    step = make_train_step(cfg, ts)
    print(f"{tag} {BT_CONFIG if bt else PGD_CONFIG} augmentation=True, blocks "
          f"{model.block_impls}, S = {cfg.max_text_len} + {cfg.max_image_len + 1}, "
          f"{PGD_BATCH} pairs, drop_rate {cfg.drop_rate}; text views: EDA on phase 12's "
          f"{VIEWS_MIX} captions ({example[0]!r} -> {example[1]!r}), {eda_ms!r} ms of host "
          f"clock per {PGD_BATCH} captions (median of 5); image view: a STAND-IN, seeded "
          f"fp32 {VIEW_HW[0]} x {VIEW_HW[1]} pixels in the {cfg.image_bucket_hw[0]} x "
          f"{cfg.image_bucket_hw[1]} canvas (SimCLRTransform needs PIL); state ready in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(SEED + 7)
    if not bt:
        step(batch, gen)                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, events = [], []
    for it in range(1 if bt else VIEWS_STEPS):
        before = {n_: p.detach().clone() for n_, p in ts.model.named_parameters()}
        stats = bt_stats(ts.model) if bt else None
        ptr0 = None if bt else int(ts.model.proj_queue_ptr)
        FB.reset_launches()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0.record()
        metrics = step(batch, gen)
        e1.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        events.append(e0.elapsed_time(e1))
        counts = dict(FB.launches)
        _check_benign_step(f"{tag} step {it}", cfg, ts, metrics, before, counts, ptr0)
        counts = check_sub_launches(f"{tag} step {it}", counts, FB)
        if bt:
            check_stats_moved(f"{tag} step {it}", ts.model, stats)
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"{tag} step {it}: " + " ".join(
            f"{k}={v!r}" for k, v in sorted(vals.items()) if "loss" in k or k == "lr")
              + f"; every trained parameter moved; {walls[-1]:.1f} ms"
              + ("" if bt else f"; pointer {ptr0} -> {int(ts.model.proj_queue_ptr)}"))
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    busy = None if bt else device_ms(lambda: step(batch, gen), iters=1, warmup=0)
    ms, ev = statistics.median(walls), statistics.median(events)
    print(f"{tag} launches per step {counts}: rows 3 and 5 (dx) 0, no both view")
    print(f"{tag} step {ms!r} ms ({'median of ' + str(VIEWS_STEPS) if not bt else 'one step'}"
          f", host clock + synchronize; {ev!r} ms between CUDA events), device busy "
          f"{'not measured' if busy is None else repr(busy) + ' ms'} (torch.profiler, one "
          f"step), {PGD_BATCH / ms * 1e3!r} pairs/s; max_memory_allocated {mem:.2f} GiB; "
          f"EDA {eda_ms!r} ms per {PGD_BATCH} captions (host)")
    return counts, {"ms": ms, "device_ms": busy, "mem_gib": mem, "eda_ms": eda_ms}, cpu_copy, ts


def phase_views_trainer(dev, cpu_model, root: Path) -> tuple:
    """Phase 19 (c): task_moco with augmentation=True and image_view=False
    (the SimCLR views need PIL) through Trainer.setup() / fit() on phase 15's
    in-memory data (32 pairs at 16 per step: accum 2, one optimizer step; one
    validation batch of 16): the Trainer builds TextAugmentation and no
    attacker, the fit's and the validation's launches as derived, every
    trained parameter moved.  Returns (the fit's launches, the readings)."""
    from rmcl_tpu_torch.ops import fused_block as FB
    tag = "[views trainer]"
    n_train = PGD_BATCH * TRAINER_ACCUM
    base = views_config(image_view=False)
    _, _, sents = greedy_setup(base, n_train + TRAINER_VAL, VIEWS_MIX, keep_dir=str(root))
    cfg = base.replace(tokenizer=f"{root}/vocab.txt", batch_size=n_train,
                       per_device_batchsize=PGD_BATCH, max_steps=1, max_epoch=1,
                       log_dir=str(root / "log"))
    images = memory_images(cfg, len(sents), SEED + 9)
    split = {"train": slice(0, n_train), "val": slice(n_train, None),
             "test": slice(n_train, None)}

    def make(tok, s):
        return MemoryDataset(tok, sents[split[s]], images[split[s]], cfg.max_text_len)

    tr = _memory_trainer(dev, cfg, make, cpu_model)
    check(tr.greedy is None and tr.text_augment is not None and tr.image_augment is None
          and not tr._text_bucket, f"{tag} the Trainer's views: greedy {tr.greedy}, text "
                                   f"{tr.text_augment}, image {tr.image_augment}")
    named = dict(tr.ts.model.named_parameters())
    before = {n_: p.detach().clone() for n_, p in named.items()}
    torch.cuda.synchronize()
    FB.reset_launches()
    t = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = dict(FB.launches)
    step_l, val_l = benign_launches(cfg), benign_launches(cfg, train=False)
    want = {k: TRAINER_ACCUM * step_l[k] + val_l[k] for k in step_l}
    check(tr.steps_done == TRAINER_ACCUM, f"{tag} {tr.steps_done} micro-steps")
    check(counts == want, f"{tag} fit: launches {counts}, expected {want}")
    counts = check_sub_launches(f"{tag} fit", counts, FB)
    # the twins of the parts the seeded model did not perturb equal their query
    # side until its first optimizer step: k_transformer's move
    still = [n_ for n_, p in named.items()
             if (n_.startswith("k_transformer") or not n_.startswith("k_"))
             and not n_.endswith("mask_token") and torch.equal(p.detach(), before[n_])]
    check(not still, f"{tag} {len(still)} parameters did not move: {still[:3]}")
    print(f"{tag} fit: {TRAINER_ACCUM} micro-steps (accum {TRAINER_ACCUM}, one optimizer "
          f"step) on EDA text views, no image view, and one validation batch: {fit_s:.2f} s, "
          f"launches {counts}; every trained parameter and k_transformer twin moved")
    return counts, {"fit_s": fit_s}


def standalone_pgd(model, cfg, block_matrices):
    """``pgd_fn`` of compute_standalone_moco: the image query's InfoNCE
    against the momentum text keys and the shared queue, ascended by cfg's
    PGD (attacks/pgd.py's scaffold, the hoisted geometry)."""
    from rmcl_tpu_torch.attacks.pgd import _pgd_single_image
    from rmcl_tpu_torch.objectives.contrastive import infonce
    from rmcl_tpu_torch.objectives.losses import l2_normalize
    A = cfg.adv_steps_img

    def pgd_fn(batch, txt_k, queue):
        def head_loss(infer):
            q = l2_normalize(model.img_projector(infer["image_feats"][:, 0]), dim=1)
            return infonce(q, txt_k.detach(), queue.detach(), cfg.temperature)[0] / A

        return _pgd_single_image(model, batch, head_loss, A, cfg.adv_lr_img,
                                 cfg.adv_max_norm_img, True, block_matrices)

    return pgd_fn


def run_standalone(cfg, model, batch, gen, block_matrices=None):
    """compute_standalone_moco in training with its PGD and the batch's
    attacked text, then the backward.  Returns ret."""
    from rmcl_tpu_torch.models.vilt import draw_seeds
    from rmcl_tpu_torch.objectives.moco_standalone import compute_standalone_moco
    dev = batch["text_ids"].device
    seeds = draw_seeds(gen, 1, cfg.num_layers, batch["text_ids"].shape[0], dev)[0]
    model.zero_grad(set_to_none=True)
    ret = compute_standalone_moco(
        model, batch, seeds=seeds, block_matrices=block_matrices,
        k_block_matrices=lambda: model.k_transformer.block_matrices(model.compute_dtype),
        temperature=cfg.temperature, momentum=cfg.momentum,
        attacked_text={"text_ids": batch["attacked_text_ids"],
                       "text_masks": batch["attacked_text_masks"]},
        pgd_fn=standalone_pgd(model, cfg, block_matrices))
    ret["standalone_moco_loss"].backward()
    return ret


def phase_views_standalone(dev, ts) -> tuple:
    """Phase 19 (d): standalone bidirectional MoCo on (a)'s model, bf16, 16
    pairs, the shared queue at K = num_negative = 65,536: init_standalone_moco,
    then one forward (key forward, 5-step PGD of the image query against the
    text keys, the attacked query) and backward, and an AdamW step of the
    four projectors.  Checks: launches as derived, finite losses, pointer +
    2B, the projectors' gradients finite and nonzero, the projectors moved.
    Returns (launches, ms)."""
    from rmcl_tpu_torch.objectives.moco_standalone import init_standalone_moco
    from rmcl_tpu_torch.ops import fused_block as FB
    tag = "[views standalone moco]"
    cfg, model = views_config(), ts.model
    init_standalone_moco(cfg, model, torch.Generator().manual_seed(SEED + 15))
    K = model.txt_img_queue.shape[1]
    check(K == cfg.num_negative == 65536, f"{tag} queue of {K}")
    batch = train_batch(cfg, PGD_BATCH, SEED + 5, dev)
    L, A = cfg.num_layers, cfg.adv_steps_img
    FB.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    ret = run_standalone(cfg, model, batch, torch.Generator().manual_seed(SEED + 8),
                         ts.block_matrices)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    counts = dict(FB.launches)
    want = dict.fromkeys(FB.launches, 0)
    want.update(attn_half=L + A * L, mlp_half=L + A * L, attn_half_dx=A * L,
                mlp_half_dx=A * L, attn_half_train=L, attn_half_train_bwd=L, mlp_half_train=L,
                mlp_half_train_bwd=L, dropout=4)
    check(counts == want, f"{tag} launches {counts}, expected {want}")
    counts = check_sub_launches(tag, counts, FB)
    vals = {k: ret[k].item() for k in ("standalone_moco_loss", "moco_txt_loss", "moco_img_loss")}
    check(all(np.isfinite(v) for v in vals.values()), f"{tag} losses {vals}")
    ptr = int(model.txt_img_queue_ptr)
    check(ptr == 2 * PGD_BATCH, f"{tag} pointer {ptr}")
    projectors = [p for n_, p in model.named_parameters()
                  if n_.startswith(("txt_projector", "img_projector"))]
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              and bool(p.grad.abs().max() > 0) for p in projectors), f"{tag} projector gradients")
    before = [p.detach().clone() for p in projectors]
    torch.optim.AdamW(projectors, lr=cfg.learning_rate).step()
    check(all(not torch.equal(p.detach(), b) for p, b in zip(projectors, before)),
          f"{tag} a projector did not move")
    print(f"{tag} K = {K}, {PGD_BATCH} pairs: " + " ".join(f"{k}={v!r}" for k, v in vals.items())
          + f"; pointer 0 -> {ptr}; the {len(projectors)} projector tensors' gradients finite and "
          f"nonzero, moved by AdamW; launches {counts} ({A}-step PGD: rows 3 and 5); {ms:.1f} ms "
          f"(first call, host clock + synchronize)")
    return counts, ms


def ce_setup(cfg, model, n: int, seed: int, dev) -> tuple:
    """(the cross-entropy NLVR2 attacker on ``model`` moved to ``dev``, its
    batch: phase 12's captions, downstream_batch's two images, its labels)."""
    from rmcl_tpu_torch.attacks.greedy import GreedyAttackNlvr2CrossEntropy
    tok, syn, sents = greedy_setup(cfg, n, VIEWS_MIX)
    model = model.eval().to(dev)
    b = downstream_batch(cfg, n, seed, dev)
    ids, masks = tok.batch_encode(sents, cfg.max_text_len)
    batch = {"image_0": b["image_0"], "image_1": b["image_1"],
             "text_ids": torch.from_numpy(ids).to(dev),
             "text_masks": torch.from_numpy(masks).to(dev)}
    return GreedyAttackNlvr2CrossEntropy(cfg, model, tok, syn), batch, b["answers"]


def phase_views_ce(dev) -> tuple:
    """Phase 19 (e): GreedyAttackNlvr2CrossEntropy on CE_PAIRS NLVR2 pairs of
    phase 17's task_finetune_nlvr2_randaug_attacked model (bf16, every patch):
    the host attack of max_loops loops, each a saliency pass (two forwards and
    their dx backwards) and a first-order scoring pass (two forwards of B x
    n_candidates rows).  Checks: launches, the ids' masks, the change counts
    within budget.  Returns (launches, ms)."""
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    tag = "[views ce attacker]"
    cfg = downstream_config("nlvr2_attacked")
    atk, batch, labels = ce_setup(cfg, seeded_model(cfg, SEED), CE_PAIRS, SEED + 4, dev)
    L = cfg.num_layers
    atk.adv_attack_samples(batch, (labels,))                # warm-up
    FB.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = atk.adv_attack_samples(batch, (labels,))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    counts, loops = dict(FB.launches), cfg.max_loops
    want = dict.fromkeys(FB.launches, 0)
    want.update(attn_half=4 * L * loops, mlp_half=4 * L * loops, attn_half_dx=2 * L * loops,
                mlp_half_dx=2 * L * loops)
    check(counts == want, f"{tag} launches {counts}, expected {want}")
    counts = check_sub_launches(tag, counts, FB)
    n_tok = batch["text_masks"].sum(1).cpu().tolist()
    check(all(n <= min(int(0.2 * (L_ - 1)), loops) for n, L_ in
              zip(out["changes_verification"], n_tok)), f"{tag} budget exceeded")
    print(f"{tag} {CE_PAIRS} pairs, {loops} loops, n_candidates {cfg.n_candidates}: "
          f"num_changes {out['num_changes']!r}, change_rate {out['change_rate']!r}, changes "
          f"{out['changes_verification']}; {ms:.1f} ms (host clock + synchronize); launches "
          f"{counts} (per loop: saliency 2 forwards + 2 dx, scoring 2 forwards)")
    return counts, ms


def phase_views_hwc(dev, model) -> dict:
    """Phase 19 (f): a serving forward (ViLT.infer of the bf16 model, as
    Session runs it) of HWC_BATCH u8 requests as the (B, 384, 608, 3) canvas
    of image_layout="hwc" with image_hw, against the same requests as patch
    rows: text, image and class features equal bit for bit, launches as
    derived.  Returns the launches of the canvas forward."""
    from rmcl_tpu_torch.models.vit import from_patch_rows
    from rmcl_tpu_torch.ops import fused_block as FB
    tag = "[views hwc]"
    cfg = train_config()
    reqs = {k: torch.from_numpy(v).to(dev)
            for k, v in synthetic_requests(cfg, HWC_BATCH, SEED + 16).items()}
    canvas = dict(reqs, image=from_patch_rows(reqs["image"], cfg.grid_hw, cfg.patch_size))
    check(tuple(canvas["image"].shape) == (HWC_BATCH, *cfg.image_bucket_hw, 3)
          and canvas["image"].dtype == torch.uint8, f"{tag} canvas {canvas['image'].shape}")
    out = {}
    with torch.no_grad():
        for name, b in (("rows", reqs), ("hwc", canvas)):
            FB.reset_launches()
            out[name] = model.infer(b)
            torch.cuda.synchronize()
            counts = dict(FB.launches)
    L = cfg.num_layers
    want = {**dict.fromkeys(FB.launches, 0), "attn_half": L, "mlp_half": L}
    check(counts == want, f"{tag} launches {counts}, expected {want}")
    for k in ("text_feats", "image_feats", "cls_feats", "image_masks"):
        check(torch.equal(out["hwc"][k], out["rows"][k]), f"{tag} {k} differs")
    print(f"{tag} {HWC_BATCH} requests, u8 canvas {tuple(canvas['image'].shape)} with image_hw: "
          f"text, image and class features bit for bit the patch-row forward's; launches "
          f"{counts}")
    return check_sub_launches(tag, counts, FB)


def phase_views_native() -> None:
    """Phase 19 (g): both native libraries built with g++ into
    rmcl_tpu_torch/_build/ and loaded; the C++ WordPiece ids equal the Python
    path's on phase 12's captions (both mixes, 256 each), with host ms of
    each; the C++ patch-row scatter equals the numpy relayout on seeded u8
    images, with host ms of each."""
    from rmcl_tpu_torch.data import _native, patch_rows
    tag = "[views native]"
    wp, ip = _native.load_wordpiece(), _native.load_imageproc()
    check(wp is not None and ip is not None, f"{tag} g++ missing: wordpiece {wp}, imageproc {ip}")
    cfg = train_config()
    for mix in GREEDY_MIXES:
        tok, _, sents = greedy_setup(cfg, 256, mix)
        check(tok._native is wp, f"{tag} the tokenizer did not take the native encoder")
        fast = tok.batch_encode(sents, cfg.max_text_len)
        slow = tok(list(sents), max_length=cfg.max_text_len, return_tensors="np")
        check(np.array_equal(fast[0], slow["input_ids"]) and np.array_equal(
            fast[1], slow["attention_mask"]), f"{tag} {mix}: native ids differ")
        ms_fast = statistics.median(_host_ms(lambda: tok.batch_encode(sents, cfg.max_text_len))
                                    for _ in range(5))
        ms_slow = statistics.median(_host_ms(lambda: tok(
            list(sents), max_length=cfg.max_text_len, return_tensors="np")) for _ in range(5))
        print(f"{tag} {mix}: 256 captions, ids equal; batch_encode {ms_fast!r} ms native, "
              f"{ms_slow!r} ms Python (host clock, median of 5)")
    imgs = memory_images(cfg, PGD_BATCH, SEED + 17)
    H, W = cfg.image_bucket_hw
    fast = patch_rows.images_to_patch_rows(imgs, H, W, cfg.patch_size)
    canvas = np.zeros((len(imgs), H, W, 3), np.uint8)
    for i, im in enumerate(imgs):
        canvas[i, :im.shape[0], :im.shape[1]] = im
    slow = patch_rows.hwc_to_patch_rows(canvas, cfg.patch_size)
    check(np.array_equal(fast, slow), f"{tag} the native scatter differs")
    ms_fast = statistics.median(_host_ms(lambda: patch_rows.images_to_patch_rows(
        imgs, H, W, cfg.patch_size)) for _ in range(5))
    ms_slow = statistics.median(_host_ms(lambda: patch_rows.hwc_to_patch_rows(
        canvas, cfg.patch_size)) for _ in range(5))
    print(f"{tag} libraries {wp._name}, {ip._name} built with g++ at their first use and "
          f"loaded; "
          f"{PGD_BATCH} u8 images -> patch rows equal; {ms_fast!r} ms native scatter, "
          f"{ms_slow!r} ms numpy relayout of the canvas (host clock, median of 5)")


def _host_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def phase_views_slice(dev) -> None:
    """Phase 19 (h): fp32 at SLICE_LAYERS, card against CPU from the same
    weights and inputs, VIEWS_CPU_PAIRS pairs each: the benign-view task_moco
    step (_train_results' tolerances); standalone MoCo (its PGD of
    STANDALONE_CPU_PGD steps, the attacked query, the backward): loss within
    1e-5 relative, every gradient, twin and the queue within 2e-4 x max(1,
    max|ref|), the pointer; the cross-entropy NLVR2 attacker, CE_CPU_LOOPS
    loops: token ids equal."""
    from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
    from rmcl_tpu_torch.objectives.moco_standalone import init_standalone_moco
    from rmcl_tpu_torch.serve import seeded_model
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    tag = "[views slice]"
    cfg32 = views_config().replace(compute_dtype="float32", queue_dtype="float32",
                                   num_layers=SLICE_LAYERS)
    base, n = moco_model(cfg32), VIEWS_CPU_PAIRS
    batch, _, _ = views_batch(cfg32, n, SEED + 4, "cpu")
    results, std = {}, {}
    for where in ("cpu", dev):
        ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
        t0 = time.perf_counter()
        metrics = make_train_step(cfg32, ts)({k: v.to(where) for k, v in batch.items()},
                                             torch.Generator().manual_seed(SEED + 8))
        results[str(where)] = _step_result(ts, metrics, t0)
        model = ts.model
        del ts
        init_standalone_moco(cfg32, model, torch.Generator().manual_seed(SEED + 15))
        t0 = time.perf_counter()
        ret = run_standalone(cfg32.replace(adv_steps_img=STANDALONE_CPU_PGD), model,
                             {k: v.to(where) for k, v in batch.items()},
                             torch.Generator().manual_seed(SEED + 9))
        std[str(where)] = (ret["standalone_moco_loss"].item(),
                           leaves_to_jax(model, grads=True), leaves_to_jax(model),
                           time.perf_counter() - t0)
        del model
    _train_results(f"{tag} benign moco step", results, dev, cfg32.learning_rate, pairs=n)
    _loss_result(f"{tag} standalone moco", std, dev, n)
    worst = ("", 0.0)
    for i in (1, 2):
        ref, ours = std["cpu"][i], std[str(dev)][i]
        check(set(ref) == set(ours), f"{tag} standalone: leaves differ")
        for path, r in ref.items():
            err = float(np.abs(ours[path] - r).max())
            tol = 2e-4 * max(1.0, float(np.abs(r).max()))
            check(err <= tol, f"{tag} standalone {path}: {err} > {tol}")
            worst = max(worst, (path, err / tol), key=lambda w: w[1])
    check(int(std[str(dev)][2]["txt_img_queue_ptr"]) == 2 * n, f"{tag} standalone pointer")
    print(f"{tag} standalone moco: {len(std['cpu'][1])} gradients and {len(std['cpu'][2])} "
          f"leaves (parameters, twins, both queues) within 2e-4 * max(1, max|ref|), worst "
          f"{worst[0]} at {worst[1]:.4g} of its bound; pointer {2 * n}; {STANDALONE_CPU_PGD} "
          f"PGD steps")
    ncfg = downstream_config("nlvr2_attacked").replace(
        compute_dtype="float32", num_layers=SLICE_LAYERS, max_loops=CE_CPU_LOOPS)
    nbase, ids = seeded_model(ncfg, SEED), {}
    for where in ("cpu", dev):
        atk, b, labels = ce_setup(ncfg, copy.deepcopy(nbase), n, SEED + 4, where)
        t0 = time.perf_counter()
        out = atk.adv_attack_samples(b, (labels,))
        ids[str(where)] = (out["txt_input_ids"], out["changes_verification"],
                           time.perf_counter() - t0)
        del atk
    (ref, ch_ref, cpu_s), (ours, ch, _) = ids["cpu"], ids[str(dev)]
    check(np.array_equal(ref, ours) and ch_ref == ch,
          f"{tag} ce attacker: ids differ {ref.tolist()} vs {ours.tolist()}")
    print(f"{tag} ce attacker: {n} pairs, {CE_CPU_LOOPS} loops, fp32: the card's token ids "
          f"equal the CPU's ({cpu_s:.1f} s on the CPU), changes {ch}")


def phase_views(dev) -> dict:
    """Phase 19 whole: the benign-view steps, the Trainer with augmentation,
    standalone MoCo, the CE attacker, the HWC forward, the native libraries,
    the fp32 checks.  Returns the launches by path."""
    import shutil
    counts, t = {}, [time.perf_counter()]
    counts["views_moco"], reading, cpu_model, ts = phase_views_step(dev)
    counts["views_bt"] = phase_views_step(dev, bt=True)[0]
    t.append(time.perf_counter())
    root = Path(VIEWS_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        counts["views_trainer"] = phase_views_trainer(dev, cpu_model, root)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del cpu_model
    t.append(time.perf_counter())
    counts["views_hwc"] = phase_views_hwc(dev, ts.model)
    counts["views_standalone"] = phase_views_standalone(dev, ts)[0]
    del ts
    counts["views_ce"] = phase_views_ce(dev)[0]
    phase_views_native()
    t.append(time.perf_counter())
    phase_views_slice(dev)
    t.append(time.perf_counter())
    print(f"[views] phase 19 in {t[-1] - t[0]:.1f} s (budget 45 s): the benign steps "
          f"{t[1] - t[0]:.1f} s, the Trainer {t[2] - t[1]:.1f} s, HWC / standalone / CE / native "
          f"{t[3] - t[2]:.1f} s, the fp32 checks against the CPU {t[4] - t[3]:.1f} s")
    return counts


# ------------------------------------------------------------------ rest
REST_DIR = "chip_smoke_rest.tmp"          # vocabulary, checkpoints, golden file; removed
DEMO_TEXT = "a [MASK] sitting on the [MASK]"   # two masks: two passes of mlm_fill
DEMO_QUESTION = "what animal is sitting on the grass"
DEMO_HIDX = 2                             # the heatmap's token, in the filled text
DEMO_HW = (480, 608)                      # the stand-in image's part of the 608 x 608 canvas
DEMO_CALLS = 3                            # timed calls of each capability, after a warm-up
DEMO_WORDS = ("a", "dog", "cat", "sitting", "on", "the", "grass", "what", "animal", "is")
BERT_VOCAB = 30522
TIE_REL = 2e-4                            # a differing fill is a tie within this of max(1, p)
HEAT_TOL, PROB_TOL = 1e-4, 1e-6           # tests/test_torch_demos.py's
GOLDEN_HW = (384, 384)
TIMM_GRID = 7                             # the synthetic timm dict's grid for ViLT-B/32 (to 12)
LEARN_STEPS, LEARN_PARITY = 60, 3         # tests/test_convergence.py's steps; parity steps
FULL_STEPS, FULL_LR = 30, 5e-4            # the full-width bf16 runs (16 pairs)
# tests/test_convergence.py:_tiny, the JAX package's learning configuration
LEARN_TINY = dict(hidden_size=32, num_heads=2, num_layers=2, patch_size=16, image_size=32,
                  image_bucket_hw=(32, 48), max_text_len=10, vocab_size=64,
                  compute_dtype="float32", drop_rate=0.0, learning_rate=5e-3,
                  warmup_steps=0, max_steps=10000, decay_power=1, end_lr=0.0)
_VIEWS = dict(image_view=True, text_view=True, adv_lr_img=0.05, adv_max_norm_img=0.005)
# the seven families of tests/test_torch_convergence*.py: family -> (losses,
# overrides, pairs, the trends held as (key, factor, "first" or "peak"), the
# relative tolerance of the first LEARN_PARITY losses against the CPU's; the
# BarlowTwins head's BatchNorms compute from rounding noise at initialisation:
# tests/test_torch_convergence.py:BT_PARITY_RTOL)
LEARN_FAMILIES = {
    "mlm": ({"mlm": 1}, {}, 4, (("mlm_loss", 0.05, "first"),), 1e-5),
    "vqa": ({"vqa": 1}, {"vqav2_label_size": 8}, 4, (("vqa_loss", 0.1, "first"),), 1e-5),
    "nlvr2": ({"nlvr2": 1}, {}, 8, (("nlvr2_loss", 0.1, "first"),), 1e-5),
    "barlowtwins": ({"barlowtwins": 1},
                    dict(_VIEWS, learning_rate=2e-3, adv_lr=0.0051, bt_proj_dims=(64, 64, 32),
                         adv_steps_img=3), 8,
                    (("barlowtwins_loss", 0.5, "peak"),
                     ("barlowtwins_loss_invariance_text", 0.5, "peak")), 1e-3),
    "moco": ({"moco": 1},
             dict(_VIEWS, learning_rate=2e-3, num_negative=16, momentum=0.9, temperature=0.07,
                  adv_steps_img=5), 4,
             (("moco_loss", 0.55, "first"), ("attacked_img_loss", 0.5, "peak"),
              ("attacked_txt_loss", 0.5, "peak")), 1e-5),
    "irtr": ({"irtr": 1}, {"draw_false_text": 3}, 4, (("irtr_loss", 0.05, "first"),), 1e-5),
    "itm": ({"itm": 1}, {}, 8, (("itm_loss", 0.05, "first"),), 1e-5),
}
ACCURACY = {"nlvr2": "nlvr2_step_accuracy", "irtr": "irtr_step_accuracy",
            "itm": "itm_step_accuracy"}


def demo_vocab(root: Path) -> str:
    """A WordPiece vocabulary of BERT's size: the specials, DEMO_WORDS, then
    fillers, so that every id the MLM head picks decodes to its own token
    (BERT's file is not in the repository)."""
    from rmcl_tpu_torch.data.tokenizer import make_tiny_vocab
    path = root / "vocab.txt"
    make_tiny_vocab(str(path), DEMO_WORDS)
    have = path.read_text().splitlines()
    fill = [f"w{i:05d}" for i in range(BERT_VOCAB - len(have))]
    path.write_text("\n".join(have + fill) + "\n")
    return str(path)


def demo_canvas(cfg, seed: int) -> np.ndarray:
    """(1, H, W, 3) fp32: a seeded stand-in for demos/inference.py:
    prepare_image (which needs PIL, which the card's machine lacks): uniform
    in [-1, 1] on DEMO_HW, top-left, zero elsewhere."""
    H, W = cfg.image_bucket_hw
    canvas = np.zeros((1, H, W, 3), np.float32)
    h, w = min(DEMO_HW[0], H), min(DEMO_HW[1], W)
    canvas[0, :h, :w] = np.random.RandomState(seed).uniform(-1, 1, (h, w, 3))
    return canvas


def _demo_call(tag, FB, fn, want: dict) -> tuple:
    """(result, ms per call, launches): a warm-up, then DEMO_CALLS timed calls
    (host clock, synchronised); the launches of one call against ``want``
    (the block ops) and the sub-kernels following them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEMO_CALLS):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DEMO_CALLS * 1e3
    FB.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(FB.launches)
    check(counts == dict(dict.fromkeys(FB.launches, 0), **want),
          f"{tag}: launches {counts}, expected {want}")
    return out, ms, check_sub_launches(tag, counts, FB)


def _fill_pick(engine, canvas, text) -> tuple:
    """(probabilities of every position (T, vocab), the text's ids) of one
    mlm_fill pass on ``text``: what the pass's argmax reads."""
    batch = engine._text_batch(text, canvas)
    with torch.no_grad():
        logits = engine.model.mlm_score(engine._infer(batch)["text_feats"])[0]
        probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    return probs, batch["text_ids"][0].cpu().numpy()


def _fills_agree(tag, engines, canvas) -> None:
    """mlm_fill on the card and on the CPU: the same steps, or, where a step
    differs, the card's pick within TIE_REL of the CPU's best under the CPU's
    probabilities (a tie the two orders of summation break apart)."""
    gpu, cpu = engines
    (_, s_gpu), (_, s_cpu) = gpu.mlm_fill(canvas, DEMO_TEXT), cpu.mlm_fill(canvas, DEMO_TEXT)
    if s_gpu == s_cpu:
        print(f"{tag} mlm_fill: the card's {len(s_gpu) - 1} steps equal the CPU's: {s_gpu}")
        return
    i = next(i for i, (a, b) in enumerate(zip(s_gpu, s_cpu)) if a != b)
    p_cpu, ids = _fill_pick(cpu, canvas, s_cpu[i - 1])
    p_gpu = _fill_pick(gpu, canvas, s_gpu[i - 1])[0]
    masked = ids == cpu.tokenizer.mask_token_id
    best = p_cpu[masked].max()
    pos_g = np.flatnonzero(masked)[p_gpu[masked].max(-1).argmax()]
    pick = p_cpu[pos_g, p_gpu[pos_g].argmax()]
    check(best - pick <= TIE_REL * max(1.0, best),
          f"{tag} mlm_fill parts at step {i}: {s_gpu[i]!r} against {s_cpu[i]!r}, not a tie "
          f"({pick} against {best})")
    print(f"{tag} mlm_fill parts at step {i} on a tie ({pick!r} against {best!r}): "
          f"{s_gpu[i]!r} / {s_cpu[i]!r}")


def phase_rest_demos(dev, root: Path) -> dict:
    """demos/demo.py's and demos/demo_vqa.py's engines at full width (S = 19
    x 19 + 1 + 40 = 402, B = 1, bf16, default blocks) from seeded
    checkpoints through their build_engine: mlm_fill (two masks),
    wpa_heatmap and answer, ms per call and launches; then fp32 at
    SLICE_LAYERS on the card against the CPU's plain engine."""
    from rmcl_tpu_torch.data.tokenizer import WordPieceTokenizer
    from rmcl_tpu_torch.demos import demo, demo_vqa
    from rmcl_tpu_torch.demos.inference import DemoEngine
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    vocab, counts = demo_vocab(root), {}
    ckpt = {}
    for name, mod in (("demo", demo), ("vqa", demo_vqa)):
        ckpt[name] = str(root / f"{name}.ckpt")
        torch.save({"state_dict": seeded_model(mod.config(), SEED).state_dict()}, ckpt[name])
    t0 = time.perf_counter()
    eng = demo.build_engine(ckpt["demo"], vocab, device=dev)
    vqa = demo_vqa.build_engine(ckpt["vqa"], vocab, device=dev)
    load_s = time.perf_counter() - t0
    cfg, L = eng.cfg, eng.cfg.num_layers
    gh, gw = cfg.grid_hw
    S = gh * gw + 1 + cfg.max_text_len
    check(S == 402 and cfg.compute_dtype == "bfloat16", f"the demo's S = {S}")
    canvas = demo_canvas(cfg, SEED + 40)
    n_masks = DEMO_TEXT.count("[MASK]")
    (filled, steps), fill_ms, counts["demo_mlm_fill"] = _demo_call(
        "[rest] demo mlm_fill", FB, lambda: eng.mlm_fill(canvas, DEMO_TEXT),
        dict(attn_half=n_masks * L, mlp_half=n_masks * L))
    check(len(steps) == n_masks + 1 and "[MASK]" not in filled, f"mlm_fill: {steps}")
    (heat, token), heat_ms, counts["demo_heatmap"] = _demo_call(
        "[rest] demo wpa_heatmap", FB, lambda: eng.wpa_heatmap(canvas, filled, DEMO_HIDX),
        dict(attn_half=L, mlp_half=L))
    check(heat.shape == (gh, gw) and bool(np.isfinite(heat).all()) and heat.min() >= 0
          and heat.max() <= 1, f"heatmap {heat.shape}, range [{heat.min()}, {heat.max()}]")
    answers, ans_ms, counts["demo_answer"] = _demo_call(
        "[rest] demo_vqa answer", FB, lambda: vqa.answer(canvas, DEMO_QUESTION),
        dict(attn_half=L, mlp_half=L))
    probs = [p for _, p in answers]
    check(len(answers) == 5 and probs == sorted(probs, reverse=True) and 0 < sum(probs) <= 1,
          f"answers {answers}")
    print(f"[rest] demos at S = {S}, B = 1, bf16, {L} layers (two build_engine calls with "
          f"their checkpoints: {load_s:.1f} s): mlm_fill ({n_masks} masks) "
          f"{fill_ms:.2f} ms per call, steps {steps}; wpa_heatmap ({gh} x {gw}, token "
          f"{token!r}) {heat_ms:.2f} ms; answer {ans_ms:.2f} ms, top {answers[:2]}; launches "
          f"per call {[{k: v for k, v in counts[p].items() if v} for p in counts]}")
    del eng, vqa
    # fp32 at SLICE_LAYERS: the card's kernels against the CPU's plain engine
    tok = WordPieceTokenizer(vocab)
    cfg32 = cfg.replace(compute_dtype="float32", num_layers=SLICE_LAYERS)
    vcfg32 = demo_vqa.config().replace(compute_dtype="float32", num_layers=SLICE_LAYERS)
    t0 = time.perf_counter()
    fill, heats, ans, cls = {}, {}, {}, {}
    pair, base, vbase = [], seeded_model(cfg32, SEED), seeded_model(vcfg32, SEED)
    for where in (dev, "cpu"):
        e = DemoEngine(cfg32, copy.deepcopy(base), tok, device=where)
        v = DemoEngine(vcfg32, copy.deepcopy(vbase), tok,
                       id2answer={i: f"answer {i}" for i in range(vcfg32.vqav2_label_size)},
                       device=where)
        pair.append(e)
        key = str(where)
        fill[key] = e.mlm_fill(canvas, DEMO_TEXT)[0]
        heats[key] = e.wpa_heatmap(canvas, fill[key], DEMO_HIDX)
        ans[key] = v.answer(canvas, DEMO_QUESTION)
        cls[key] = e._infer(e._text_batch(DEMO_TEXT, canvas))["cls_feats"].float().cpu()
    _fills_agree("[rest] fp32", pair, canvas)
    g, c = str(dev), "cpu"
    heat_err = float(np.abs(heats[g][0] - heats[c][0]).max())
    check(heats[g][1] == heats[c][1] and heat_err <= HEAT_TOL,
          f"heatmap: token {heats[g][1]!r} / {heats[c][1]!r}, error {heat_err}")
    check([a for a, _ in ans[g]] == [a for a, _ in ans[c]], f"answers {ans[g]} / {ans[c]}")
    prob_err = max(abs(p - q) for (_, p), (_, q) in zip(ans[g], ans[c]))
    check(prob_err <= PROB_TOL, f"answer probabilities differ by {prob_err}")
    cls_err = float((cls[g] - cls[c]).abs().max())
    cls_tol = 1e-3 * max(1.0, float(cls[c].abs().max()))
    check(cls_err <= cls_tol, f"cls_feats differ by {cls_err} > {cls_tol}")
    print(f"[rest] fp32 demos at {SLICE_LAYERS} layers, card against CPU "
          f"({time.perf_counter() - t0:.1f} s): heatmap within {heat_err!r} (tol {HEAT_TOL}), "
          f"the same {len(ans[g])} answers, probabilities within {prob_err!r} (tol "
          f"{PROB_TOL}), cls_feats within {cls_err!r} (tol {cls_tol:.3g})")
    return counts


def phase_rest_golden(dev, root: Path) -> dict:
    """A golden file written on the CPU by the port's plain fp32 infer
    (task_mlm_itm at vit32_base, the 384 x 384 HWC canvas, B = 1) and
    replayed through compat/golden.py:compare_golden on the card's fp32
    kernels at its 5e-3 default."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.compat.golden import GOLDEN_KEYS, compare_golden, save_golden
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    cfg = build_config("task_mlm_itm", "vit32_base", image_bucket_hw=GOLDEN_HW, max_image_len=-1,
                       compute_dtype="float32", drop_rate=0.0, image_layout="hwc")
    r = np.random.RandomState(SEED + 50)
    T = cfg.max_text_len
    ids = np.zeros((1, T), np.int32)
    masks = np.zeros((1, T), np.int32)
    ids[0, :12] = r.randint(1000, cfg.vocab_size, 12)
    ids[0, 0], ids[0, 11] = 101, 102
    masks[0, :12] = 1
    batch = {"image": r.uniform(-1, 1, (1, *GOLDEN_HW, 3)).astype(np.float32),
             "text_ids": ids, "text_masks": masks}
    model = seeded_model(cfg, SEED).eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model.infer({k: torch.from_numpy(v) for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    path = str(root / "golden.npz")
    save_golden(path, batch, {k: out[k].numpy() for k in GOLDEN_KEYS},
                meta={"config": "task_mlm_itm vit32_base", "writer": "plain fp32, CPU"})
    FB.reset_launches()
    errs = compare_golden(path, model.to(dev))
    torch.cuda.synchronize()
    L = cfg.num_layers
    counts = check_sub_launches("[rest] golden", dict(FB.launches), FB)
    check(counts["attn_half"] == counts["mlp_half"] == L, f"golden launches {counts}")
    S = cfg.grid_hw[0] * cfg.grid_hw[1] + 1 + T
    print(f"[rest] golden (task_mlm_itm, vit32_base, {GOLDEN_HW[0]} x {GOLDEN_HW[1]} HWC, S = "
          f"{S}, B = 1, fp32, {L} layers; the CPU's forward {cpu_s:.1f} s): the card's replay "
          f"within 5e-3: {errs}")
    return counts


def timm_dict(cfg, grid: int, seed: int) -> dict:
    """A seeded bare timm ViT state dict at cfg's widths and depth, with a
    ``grid`` x ``grid`` pos-embed and timm's classifier head (which the
    loader skips): tests/test_compat.py:_synthetic_timm_sd's layout."""
    r = np.random.RandomState(seed)
    C, P, M, L = cfg.hidden_size, cfg.patch_size, cfg.mlp_ratio, cfg.num_layers
    rn = lambda *s: (0.05 * r.randn(*s)).astype(np.float32)  # noqa: E731
    sd = {"patch_embed.proj.weight": rn(C, 3, P, P), "patch_embed.proj.bias": rn(C),
          "cls_token": rn(1, 1, C), "pos_embed": rn(1, grid * grid + 1, C),
          "norm.weight": 1 + rn(C), "norm.bias": rn(C), "head.weight": rn(1000, C),
          "head.bias": rn(1000)}
    for i in range(L):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": 1 + rn(C), b + "norm1.bias": rn(C),
                   b + "attn.qkv.weight": rn(3 * C, C), b + "attn.qkv.bias": rn(3 * C),
                   b + "attn.proj.weight": rn(C, C), b + "attn.proj.bias": rn(C),
                   b + "norm2.weight": 1 + rn(C), b + "norm2.bias": rn(C),
                   b + "mlp.fc1.weight": rn(M * C, C), b + "mlp.fc1.bias": rn(M * C),
                   b + "mlp.fc2.weight": rn(C, M * C), b + "mlp.fc2.bias": rn(C)})
    return sd


def timm_model(cfg, sd: dict):
    """The seeded model of ``cfg`` with the timm dict loaded through
    compat/timm.py:load_timm_vit: every transformer entry of the dict there
    (the pos-embed resized), the classifier head skipped."""
    from rmcl_tpu_torch.compat.timm import load_timm_vit
    from rmcl_tpu_torch.serve import seeded_model
    model = seeded_model(cfg, SEED)
    skipped = model.load_reference_state_dict(load_timm_vit(sd, cfg))
    check({"transformer.head.weight", "transformer.head.bias"} <= set(skipped),
          f"timm: skipped {skipped[:4]}")
    own = model.state_dict()
    n_model = (cfg.image_size // cfg.patch_size) ** 2 + 1
    check(tuple(own["transformer.pos_embed"].shape) == (1, n_model, cfg.hidden_size),
          "timm: pos-embed shape")
    for i in range(cfg.num_layers):
        name = f"blocks.{i}.attn.qkv.weight"
        check(torch.equal(own[f"transformer.{name}"], torch.from_numpy(sd[name])),
              f"timm: {name} not loaded")
    return model


def phase_rest_timm(dev) -> dict:
    """A seeded synthetic timm dict into the default ViLT-B/32 (MLM loss;
    from a 7 x 7 grid, resized to 12 x 12) and into
    vit="vit_small_patch16_224" (8 layers, 8 heads of D = 96, MLP 3 x; its
    native 14 x 14 grid, its own canvas): for each, a forward and one
    make_train_step of 16 pairs on the card, bf16, timed; then one fp32 step
    of VIEWS_CPU_PAIRS pairs at SLICE_LAYERS on the card against the CPU at
    phase 9's tolerances (_train_results)."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.core.config import loss_names
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    counts = {}
    presets = {"b32": ({}, TIMM_GRID), "small": ({"vit": "vit_small_patch16_224"}, 14)}
    for name, (kw, grid) in presets.items():
        tag = f"[rest] timm {name}"
        cfg = build_config(loss_names=loss_names({"mlm": 1}), drop_rate=DROP_P,
                           warmup_steps=0, max_steps=1000, **kw)
        sd = timm_dict(cfg, grid, SEED + 60)
        model = timm_model(cfg, sd)
        batch = pretrain_batch(cfg, PGD_BATCH, SEED + 61, dev)
        ts = create_train_state(cfg, model=model, device=dev)
        with torch.no_grad():
            fwd = lambda: ts.model.infer(batch, ts.block_matrices)  # noqa: E731
            feats = fwd()["cls_feats"]
            check(bool(torch.isfinite(feats).all()), f"{tag}: forward not finite")
            fwd_ms = time_ms(fwd, iters=5, warmup=1)
        step = make_train_step(cfg, ts)
        gen = torch.Generator().manual_seed(SEED + 62)
        step(batch, gen)
        torch.cuda.synchronize()
        FB.reset_launches()
        t0 = time.perf_counter()
        m = step(batch, gen)
        loss = m["total_loss"].item()
        step_ms = (time.perf_counter() - t0) * 1e3
        ops, want = dict(FB.launches), pretrain_launches(cfg)
        check(np.isfinite(loss) and ops == want, f"{tag}: loss {loss}, launches {ops}, "
                                                 f"expected {want}")
        counts[f"timm_{name}"] = check_sub_launches(tag, ops, FB)
        S = cfg.grid_hw[0] * cfg.grid_hw[1] + 1 + cfg.max_text_len
        print(f"{tag}: {cfg.num_layers} layers, {cfg.num_heads} heads of D = "
              f"{cfg.hidden_size // cfg.num_heads}, MLP {cfg.mlp_ratio} x, S = {S}, pos-embed "
              f"{grid} x {grid} -> {cfg.image_size // cfg.patch_size} x "
              f"{cfg.image_size // cfg.patch_size}; bf16 forward of {PGD_BATCH} pairs "
              f"{fwd_ms:.2f} ms, one training step {step_ms:.1f} ms (host clock), loss {loss!r}")
        del ts, model, step, batch
        cfg32 = cfg.replace(compute_dtype="float32", num_layers=SLICE_LAYERS, drop_rate=0.0)
        base = timm_model(cfg32, sd)
        batch = pretrain_batch(cfg32, VIEWS_CPU_PAIRS, SEED + 63, "cpu")
        results = {}
        for where in ("cpu", dev):
            ts = create_train_state(cfg32, model=copy.deepcopy(base), device=where)
            t0 = time.perf_counter()
            metrics = make_train_step(cfg32, ts)({k: v.to(where) for k, v in batch.items()},
                                                 torch.Generator().manual_seed(SEED + 64))
            results[str(where)] = _step_result(ts, metrics, t0)
        _train_results(f"{tag} fp32", results, dev, cfg32.learning_rate,
                       pairs=VIEWS_CPU_PAIRS)
    return counts


def fake_batch(cfg, n: int, seed: int = 0) -> dict:
    """tests/conftest.py:make_fake_batch's numbers: n pairs of top-left-valid
    zero-padded HWC images and random ids, the last three positions padding."""
    r = np.random.RandomState(seed)
    H, W = cfg.image_bucket_hw
    img = np.zeros((n, H, W, 3), np.float32)
    for b in range(n):
        h, w = r.randint(H // 2, H + 1), r.randint(W // 2, W + 1)
        img[b, :h, :w] = r.uniform(-1, 1, (h, w, 3))
    T = cfg.max_text_len
    ids = r.randint(5, cfg.vocab_size, (n, T)).astype(np.int32)
    masks = np.ones((n, T), np.int32)
    masks[:, T - 3:] = 0
    ids[masks == 0] = 0
    return {"image": img, "text_ids": ids, "text_labels": np.full_like(ids, -100),
            "text_masks": masks}


def learn_config(family: str):
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.core.config import loss_names
    losses, kw = LEARN_FAMILIES[family][:2]
    return build_config(**dict(LEARN_TINY, loss_names=loss_names(losses), **kw))


def learn_batch(family: str, cfg) -> dict:
    """The fixed batch of ``family``'s learning test
    (tests/test_torch_convergence*.py), as numpy arrays."""
    from rmcl_tpu_torch.data.patch_rows import hwc_to_patch_rows
    n = LEARN_FAMILIES[family][2]
    b = fake_batch(cfg, n)
    if family in ("barlowtwins", "moco"):
        b["attacked_text_ids"] = np.roll(b["text_ids"], 1, axis=1)
        b["attacked_text_masks"] = b["text_masks"]
    elif family == "mlm":
        labels = np.full_like(b["text_ids"], -100)
        labels[:, 2:5] = b["text_ids"][:, 2:5]
        b.update(text_ids_mlm=b["text_ids"], text_labels_mlm=labels)
    elif family == "vqa":
        t = np.zeros((n, 8), np.float32)
        t[np.arange(n), np.arange(n)] = 1.0
        t[1, 5] = 0.3
        b["vqa_targets"] = t
    elif family == "nlvr2":
        b["image_1"] = fake_batch(cfg, n, seed=3)["image"]
        b["image_0"] = b.pop("image")
        b["answers"] = (np.arange(n) % 2).astype(np.int32)
    elif family == "irtr":
        for i in range(cfg.draw_false_text):
            f = fake_batch(cfg, n, seed=10 + i)
            b[f"false_text_{i}_ids"], b[f"false_text_{i}_masks"] = (f["text_ids"],
                                                                    f["text_masks"])
    elif family == "itm":
        b["image"] = hwc_to_patch_rows(b["image"], cfg.patch_size)
        b["false_image_0"] = hwc_to_patch_rows(fake_batch(cfg, n, seed=3)["image"],
                                               cfg.patch_size)
    return b


def learn_run(cfg, model, batch: dict, where, steps: int) -> tuple:
    """(scalar metrics of each step, ms per step) of ``steps`` make_train_step
    calls on the one batch from a copy of ``model``."""
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    ts = create_train_state(cfg, model=copy.deepcopy(model), device=where)
    step = make_train_step(cfg, ts)
    tb = {k: (v if isinstance(v, torch.Tensor) else
              torch.from_numpy(np.ascontiguousarray(v))).to(where) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(SEED)
    history = []
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(tb, gen)
        history.append({k: v.item() for k, v in metrics.items() if v.dim() == 0})
    return history, (time.perf_counter() - t0) / steps * 1e3


def check_trend(tag, history, key, factor, vs="first") -> tuple:
    """tests/test_convergence.py:_trend: the mean of the last five values of
    ``key`` below ``factor`` x the first (or the peak); (reference, last)."""
    losses = [h[key] for h in history]
    check(all(np.isfinite(losses)), f"{tag} {key}: not finite: {losses}")
    ref = max(losses) if vs == "peak" else losses[0]
    last = float(np.mean(losses[-5:]))
    check(last < factor * ref, f"{tag} {key}: {last} is not below {factor} x {ref} ({vs}): "
                               f"{losses}")
    return ref, last


def phase_rest_learning(dev) -> dict:
    """(a) The seven learning families of tests/test_torch_convergence*.py at
    their tiny configurations on the card's fp32 kernels, LEARN_STEPS steps
    from the port's seeded weights: the same criteria, and the first
    LEARN_PARITY losses against the CPU's plain steps.  (b) At full width in
    bf16 (16 pairs, default blocks, one fixed batch, FULL_STEPS steps at
    FULL_LR): task_mlm_itm with MLM only, and task_finetune_vqa; the mean of
    the last five losses under 0.5 x the first."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.core.config import loss_names
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import seeded_model
    counts = {}
    for family, (_, _, n, trends, rtol) in LEARN_FAMILIES.items():
        tag = f"[rest] learn {family}"
        cfg = learn_config(family)
        model, batch = seeded_model(cfg, SEED), learn_batch(family, cfg)
        cpu = learn_run(cfg, model, batch, "cpu", LEARN_PARITY)[0]
        FB.reset_launches()
        history, ms = learn_run(cfg, model, batch, dev, LEARN_STEPS)
        counts[f"learn_{family}"] = check_sub_launches(tag, dict(FB.launches), FB)
        check(sum(FB.launches.values()) > 0, f"{tag}: no kernel launched")
        key = trends[0][0]
        rel = [abs(g[key] - c[key]) / abs(c[key]) for g, c in zip(history, cpu)]
        check(max(rel) <= rtol, f"{tag}: the first {LEARN_PARITY} {key} differ from the CPU's "
                                f"by {rel} relative (tol {rtol})")
        held = [check_trend(tag, history, *t) for t in trends]
        if family in ACCURACY:
            acc = float(np.mean([h[ACCURACY[family]] for h in history[-5:]]))
            check(acc >= 0.99, f"{tag}: accuracy {acc}")
        print(f"{tag} ({n} pairs, fp32 kernels, {LEARN_STEPS} steps, {ms:.1f} ms per step): "
              f"{key} {history[0][key]!r} -> {history[-1][key]!r}; held "
              f"{[(t[0], t[1], t[2], r) for t, r in zip(trends, held)]}; first "
              f"{LEARN_PARITY} against the CPU within {max(rel)!r} relative (tol {rtol})")
    full = {"mlm": (build_config("task_mlm_itm", loss_names=loss_names({"mlm": 1}),
                                 learning_rate=FULL_LR, warmup_steps=0, max_steps=1000),
                    pretrain_batch, "mlm_loss"),
            "vqa": (build_config("task_finetune_vqa", learning_rate=FULL_LR, warmup_steps=0,
                                 max_steps=1000), downstream_batch, "vqa_loss")}
    for name, (cfg, make, key) in full.items():
        tag = f"[rest] learn full {name}"
        batch = make(cfg, PGD_BATCH, SEED + 70, dev)
        FB.reset_launches()
        history, ms = learn_run(cfg, seeded_model(cfg, SEED), batch, dev, FULL_STEPS)
        counts[f"learn_full_{name}"] = check_sub_launches(tag, dict(FB.launches), FB)
        losses = [h[key] for h in history]
        first, last = check_trend(tag, history, key, 0.5)
        print(f"{tag} ({PGD_BATCH} pairs, bf16, {cfg.num_layers} layers, lr {FULL_LR}, drop_rate "
              f"{cfg.drop_rate}, {FULL_STEPS} steps, {ms:.1f} ms per step): mean of the last "
              f"five {last!r} < 0.5 x the first {first!r}; {key} by step {losses}")
    return counts


def phase_rest(dev) -> dict:
    """Phase 20 whole: the demos, the golden replay, the timm loads, the
    learning runs.  Returns the launches by path."""
    import shutil
    counts, t = {}, [time.perf_counter()]
    root = Path(REST_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        counts.update(phase_rest_demos(dev, root))
        t.append(time.perf_counter())
        counts["golden"] = phase_rest_golden(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t.append(time.perf_counter())
    counts.update(phase_rest_timm(dev))
    t.append(time.perf_counter())
    counts.update(phase_rest_learning(dev))
    t.append(time.perf_counter())
    print(f"[rest] phase 20 in {t[-1] - t[0]:.1f} s (budget 60 s): the demos {t[1] - t[0]:.1f} s, "
          f"the golden replay {t[2] - t[1]:.1f} s, the timm loads {t[3] - t[2]:.1f} s, the "
          f"learning runs {t[4] - t[3]:.1f} s")
    return counts


# ---------------------------------------------------------- distribution
DDP_STEPS = 3                              # (a): timed steps after one warm-up, each run
DDP_TRAINER_OPT_STEPS = 2                  # (c): optimizer steps of the two ranks' Trainer
DDP_DIR = "chip_smoke_ddp.tmp"             # the ranks' spec, results and checkpoints; removed
DDP_WAIT_S = 240                           # the two ranks' deadline (the phase's budget: 75 s)
DDP_COLLECTIVE_S = 120                     # each collective's own deadline inside a rank


def _ddp_steps(step, batch, gen, greedy, steps: int) -> tuple:
    """One warm-up and ``steps`` timed calls of ``step``: (metrics of every
    call as floats, ms of the timed ones, the attack's stats of every call)."""
    out, walls, stats = [], [], []
    for it in range(steps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        if it:
            walls.append((time.perf_counter() - t) * 1e3)
        out.append({k: v.item() for k, v in metrics.items()})
        stats.append(dict(greedy.last_stats))
    return out, walls, stats


def phase_ddp_one_rank(dev, bare) -> dict:
    """Phase 21 (a): phase 13's attacked task_moco step (ViLT-B/32, 16
    pairs, bf16, worst captions) with a one-rank NCCL group live on ``dev``
    against the same step without a group, from the same state and
    generator: metrics, parameters, twins and queue bit for bit (a one-rank
    all-reduce is a copy, the division by 1 exact); the kernels' launches
    equal; ms per step beside phase 13's; the NCCL kernels' device time in
    one profiled step.  Returns the launches of the NCCL run."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.parallel import dist as D
    import socket
    tag = "[ddp one rank]"
    runs = {}
    with socket.socket() as sock:                          # a free port on localhost
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    group_env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))  # torchrun's, one rank
    base = moco_model(train_config())
    for mode in ("plain", "nccl"):
        cfg, ts, batch, greedy, make_step = train_setup(dev, mix="worst", model=base)
        saved = {k: os.environ.get(k) for k in group_env}
        if mode == "nccl":
            os.environ.update(group_env)
            D.init_distributed(dev)
            check(torch.distributed.get_backend() == "nccl", f"{tag} backend "
                                                               f"{torch.distributed.get_backend()}")
        try:
            step = make_step()
            FB.reset_launches()
            metrics, walls, stats = _ddp_steps(step, batch, torch.Generator().manual_seed(SEED + 7),
                                               greedy, DDP_STEPS)
            counts = check_sub_launches(f"{tag} {mode}", dict(FB.launches), FB)
            state = {k: v.detach().clone() for k, v in ts.model.state_dict().items()}
            nccl_ms = None
            if mode == "nccl":       # one more step, profiled, after the state was kept
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    step(batch, torch.Generator().manual_seed(SEED + 70))
                    torch.cuda.synchronize()
                from torch.autograd import DeviceType
                rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
                nccl_ms = sum(r[2] for r in rows) / 1e3
                check(rows, f"{tag} the profiled step shows no NCCL kernel")
                print(f"{tag} NCCL kernels of one profiled step: {nccl_ms!r} ms device time, "
                      + "; ".join(f"{k[:60]} x{c}" for k, c, _ in rows))
        finally:
            if mode == "nccl":
                D.destroy()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        want = {k: sum(expected_launches(cfg)[k] + attack_launches(st, cfg.num_layers)[k]
                       for st in stats) for k in FB.launches}
        check({k: counts[k] for k in want} == want,
              f"{tag} {mode}: launches {counts}, expected {want}")
        runs[mode] = dict(metrics=metrics, ms=statistics.median(walls), min_ms=min(walls),
                          counts=counts, state=state, nccl_ms=nccl_ms)
        del ts, step, greedy, batch
        gc.collect()
        torch.cuda.empty_cache()
    plain, nccl = runs["plain"], runs["nccl"]
    check(nccl["metrics"] == plain["metrics"], f"{tag} metrics differ: {nccl['metrics']} vs "
                                               f"{plain['metrics']}")
    differ = [k for k, v in plain["state"].items() if not torch.equal(v, nccl["state"][k])]
    check(not differ, f"{tag} {len(differ)} tensors differ, first {differ[:3]}")
    check(nccl["counts"] == plain["counts"], f"{tag} launches differ")
    print(f"{tag} {DDP_STEPS + 1} attacked steps (one warm-up) with a one-rank NCCL group "
          f"live (gathered keys, the metrics' and the gradients' all-reduce) and without: "
          f"metrics and all {len(plain['state'])} tensors of the state (parameters, twins, "
          f"queue, pointer) bit for bit; launches equal {nccl['counts']}")
    print(f"{tag} ms per step (median of {DDP_STEPS}, host clock + synchronize; the fastest "
          f"in brackets): without a group {plain['ms']!r} ({plain['min_ms']!r}), one-rank "
          f"NCCL {nccl['ms']!r} ({nccl['min_ms']!r}) ({nccl['ms'] / plain['ms']:.4f}x)"
          + (f"; phase 13's worst-mix step {bare['ms']!r}" if bare else ""))
    READINGS.update(ddp_ms=nccl["ms"], ddp_plain_ms=plain["ms"], nccl_ms=nccl["nccl_ms"])
    return nccl["counts"]


def _state_hash(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode() + v.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def ddp_slice_case(dev, name: str, rows=None, seam=None) -> dict:
    """One fp32 attacked step of phase 14's (``name`` "moco") or phase 16's
    ("bt") configuration at SLICE_LAYERS on ``dev``: the 4 pairs, or
    ``rows`` of them (a rank's).  Returns the loss, the attacked ids, the
    state's hash, and the gradients and updated leaves: for "moco" the
    attacked step's; for "bt" those of a second step from the same weights
    on the one-process attack's ids, cut at the head's input as phase 16
    cuts it (HeadSeam): in one process (``seam`` None) it records the head's
    input and gradient at every call (returned under "seam"); a rank
    (``seam``: those records) replays them and returns the head's inputs
    it saw ("seen")."""
    from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
    from rmcl_tpu_torch.train.step import (create_train_state, make_attacked_train_step,
                                           make_train_step)
    if name == "moco":
        cfg32 = train_config().replace(compute_dtype="float32", queue_dtype="float32",
                                       num_layers=SLICE_LAYERS)
        make_model = moco_model
    else:
        cfg32 = bt_config().replace(compute_dtype="float32", num_layers=SLICE_LAYERS)
        make_model = bt_model
    batch0 = train_batch(cfg32, N_CPU, SEED + 4, "cpu")
    ts = create_train_state(cfg32, model=make_model(cfg32), device=dev)
    greedy, batch, _ = attacked_batch(cfg32, ts.model, batch0, GREEDY_SLICE_MIX)
    sl = rows or slice(0, N_CPU)
    local = {k: v[sl] for k, v in batch.items() if not k.startswith("gw_")}
    local.update(greedy.prep_tables(local["text_ids"].numpy()))
    attacked = []
    body = greedy._attack

    def keep(*a, **kw):
        out = body(*a, **kw)
        attacked.append([t.cpu() for t in out[:2]])
        return out
    greedy._attack = keep
    gen = lambda: torch.Generator().manual_seed(SEED + 8)  # noqa: E731
    metrics = make_attacked_train_step(cfg32, ts, greedy)(
        {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in local.items()}, gen())
    out = dict(loss=metrics["total_loss"].item(), ids=attacked[0][0], hash=_state_hash(ts.model),
               cfg=cfg32)
    if name == "moco":
        return dict(out, **_full_leaves(cfg32, ts))
    ids, masks = (seam["ids"], seam["masks"]) if seam else attacked[0]
    ts = create_train_state(cfg32, model=make_model(cfg32), device=dev)
    step_batch = {k: v[sl].to(dev) for k, v in batch0.items() if not k.startswith("attacked_")}
    step_batch.update(text_ids=batch["text_ids"][sl].to(dev),
                      text_masks=batch["text_masks"][sl].to(dev),
                      attacked_text_ids=ids[sl].to(dev), attacked_text_masks=masks[sl].to(dev))
    if seam is None:
        rec = HeadSeam(ts.model.barlowtwins_head)
    else:
        rec = HeadSeam.of(seam["x"], seam["g"])
        handle = rec.replay(ts.model.barlowtwins_head, dev)
    make_train_step(cfg32, ts)(step_batch, gen())
    if seam is None:
        rec.stop()
        out["seam"] = dict(x=[t.cpu() for t in rec.x], g={i: g.cpu() for i, g in rec.g.items()},
                           ids=ids, masks=masks)
    else:
        handle.remove()
        out["seen"] = rec.seen
    return dict(out, grads=leaves_to_jax(ts.model, grads=True), leaves=leaves_to_jax(ts.model))


def ddp_trainer_rank(dev, root: str) -> dict:
    """Phase 21 (c) on this rank: phase 15's Trainer.setup() / fit() at full
    width, bf16, 16 pairs per rank and micro-step, accum 2,
    DDP_TRAINER_OPT_STEPS optimizer steps, the checkpoints under ``root``;
    then 'last' loaded into a fresh ViLT.  Returns ms per micro-step, peak
    memory, the micro-steps, the state's hash and whether 'last' equals the
    trained model."""
    from rmcl_tpu_torch.models.vilt import ViLT
    from rmcl_tpu_torch.parallel import comm
    from rmcl_tpu_torch.serve import load_state_dict_file
    from rmcl_tpu_torch.train.checkpoint import MODEL_FILE
    from rmcl_tpu_torch.train.loop import Trainer
    rank, world = comm.get_rank(), comm.get_world_size()
    Path(f"{root}/files{rank}").mkdir(parents=True, exist_ok=True)
    cfg, dm_cls, model = trainer_setup(dev, f"{root}/files{rank}",
                                       opt_steps=DDP_TRAINER_OPT_STEPS, ranks=world)
    cfg = cfg.replace(log_dir=f"{root}/run")
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, workdir=f"{root}/run", device=dev,
                 datamodule=dm_cls(cfg, process_index=rank, process_count=world))
    tr.setup(model=model)
    inner, starts = tr.step_fn, []

    def step_fn(db, gen):
        starts.append(time.perf_counter())
        return inner(db, gen)
    tr.step_fn = step_fn
    tr.fit()
    torch.cuda.synchronize(dev)
    starts.append(time.perf_counter())
    mem = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    path = Path(tr.ckpt.checkpoint_dir("last")) / MODEL_FILE
    fresh = ViLT(cfg)
    unused = fresh.load_reference_state_dict(load_state_dict_file(str(path)))
    live, back = tr.ts.model.state_dict(), fresh.state_dict()
    equal = sum(torch.equal(live[k].cpu(), back[k]) for k in live)
    gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])][1:]
    return dict(ms=statistics.median(gaps[:-1] or gaps), steps=tr.steps_done, mem_gib=mem,
                last_s=gaps[-1] / 1e3,
                accum=tr.accum_steps, per_rank=tr.per_host_batch, unused=len(unused),
                equal=equal, tensors=len(live), hash=_state_hash(tr.ts.model),
                best=tr.ckpt.has("best"))


def rank_device(rank: int, world: int) -> tuple:
    """(device, backend) of a rank of phase 21: NCCL on cuda:RANK with a card
    per rank, else gloo with the CUDA tensors of cuda:0."""
    if torch.cuda.device_count() >= world:
        return torch.device("cuda", rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def _held(tag: str, what: str, ours: dict, ref: dict) -> tuple:
    """Every leaf of ``ours`` within 2e-4 * max(1, max|ref|) of ``ref``;
    (path, error / bound) of the worst."""
    check(set(ours) == set(ref), f"{tag} {what}: leaves differ")
    worst = ("", 0.0)
    for path, r in ref.items():
        err = float(np.abs(ours[path] - r).max()) if r.size else 0.0
        tol = 2e-4 * max(1.0, float(np.abs(r).max()) if r.size else 0.0)
        check(err <= tol, f"{tag} {what} {path}: {err} > {tol}")
        worst = max(worst, (path, err / tol), key=lambda t: t[1])
    return worst


def _held_after_adamw(tag: str, ours: dict, ref: dict, grads: dict, cfg) -> tuple:
    """The leaves after one AdamW step from the same weights, as the CPU
    tests hold them (tests/test_torch_train.py:_close_params): AdamW's first
    step moves an element by its rate times the sign of its gradient, so
    where the reference gradient is firm (above 1e-4 of its tensor's
    largest) the leaf is held to 2% of the rate, and where it is at rounding
    level, whose sign is not determined, to 2.5 times the rate; the rate is
    the head's (x lr_mult) for the heads of schedule.HEAD_NAMES.  A leaf
    without a gradient (BatchNorm statistics, twins, queue) is held within
    2e-4 * max(1, max|ref|).  Returns the worst (path, error / bound) of the
    firm elements and of all."""
    from rmcl_tpu_torch.train.schedule import HEAD_NAMES
    check(set(ours) == set(ref), f"{tag} updated leaf: leaves differ")
    firm_worst, all_worst = ("", 0.0), ("", 0.0)
    for path, r in ref.items():
        diff = np.abs(ours[path] - r)
        if path not in grads:
            _held(tag, "updated leaf", {path: ours[path]}, {path: r})
            continue
        rate = cfg.learning_rate * (cfg.lr_mult if any(h in path for h in HEAD_NAMES) else 1)
        g = np.abs(grads[path])
        firm = g > 1e-4 * max(float(g.max()), 1e-30)
        worst_firm, worst = float(diff[firm].max(initial=0.0)), float(diff.max(initial=0.0))
        check(worst_firm <= 0.02 * rate, f"{tag} updated leaf {path}: {worst_firm} > "
                                        f"{0.02 * rate} where the gradient is firm")
        check(worst <= 2.5 * rate, f"{tag} updated leaf {path}: {worst} > {2.5 * rate}")
        firm_worst = max(firm_worst, (path, worst_firm / (0.02 * rate)), key=lambda t: t[1])
        all_worst = max(all_worst, (path, worst / (2.5 * rate)), key=lambda t: t[1])
    return firm_worst, all_worst


def _compare_slice(tag: str, name: str, ref: dict, mine: dict, summaries: list) -> str:
    """Phase 21 (b)'s checks of one configuration on the rank that made its
    one-process reference: every rank's state hash and loss equal, the ranks'
    ids in rank order the reference's, the loss within 1e-5 relative, this
    rank's gradients within 2e-4 * max(1, max|ref|) and its updated leaves as
    ``_held_after_adamw`` holds them (BarlowTwins: its seam step's, and every
    rank's gathered class features at the seam).  Returns the line it
    prints."""
    ctag = f"{tag} {name} fp32 attacked step, {SLICE_LAYERS} layers"
    ranks = [x[name] for x in summaries]
    check(len({r["hash"] for r in ranks}) == 1, f"{ctag}: the ranks' states differ")
    check(len({r["loss"] for r in ranks}) == 1, f"{ctag}: the ranks' losses differ")
    check(torch.equal(torch.cat([r["ids"] for r in ranks]), ref["ids"]),
          f"{ctag}: attacked ids differ from the one-process attack's")
    rel = abs(mine["loss"] - ref["loss"]) / abs(ref["loss"])
    check(rel <= 1e-5, f"{ctag}: loss {mine['loss']!r} vs {ref['loss']!r}")
    wg = _held(ctag, "gradient", mine["grads"], ref["grads"])
    wf, wp = _held_after_adamw(ctag, mine["leaves"], ref["leaves"], ref["grads"], ref["cfg"])
    seam = ""
    if name == "bt":      # the gradients and leaves are the seam step's
        for r in ranks:
            rec = HeadSeam.of(ref["seam"]["x"], ref["seam"]["g"])
            rec.seen = r["seen"]
            rec.check_forward(f"{ctag}, at the seam:", "a rank's gathered", "one process's")
        same = all(torch.equal(a, b) for a, b in zip(ranks[0]["seen"], ref["seam"]["x"]))
        seam = (f"; the gradients and leaves those of a second step on the one-process ids "
                f"cut at the head's input (HeadSeam, {len(ref['seam']['x'])} head calls); the "
                f"ranks' gathered class features there "
                f"{'bit for bit' if same else 'within 2e-4 but not bit for bit'} the one "
                f"process's")
    return (f"{ctag}: {len(ranks)} ranks x {N_CPU // len(ranks)} pairs against one process on "
            f"the {N_CPU} pairs on the card: loss {mine['loss']!r} vs {ref['loss']!r} "
            f"(relative {rel!r}, tol 1e-5); {len(ref['grads'])} gradients within 2e-4 * max(1, "
            f"max|ref|), worst {wg[0]} at {wg[1]:.4g} of its bound; {len(ref['leaves'])} updated "
            f"leaves, firm elements within 2% of the rate (worst {wf[0]} at {wf[1]:.4g} of it), "
            f"all within 2.5 x the rate (worst {wp[0]} at {wp[1]:.4g}); attacked ids equal; the "
            f"ranks bit-identical{seam}")


def ddp_rank_main(root: str) -> int:
    """``chip_smoke.py --ddp-rank ROOT``: one rank of phase 21's parts (b)
    and (c), started by phase_ddp_ranks in torchrun's environment.  With a
    card per rank, NCCL on cuda:RANK; with one card for both, gloo with the
    CUDA tensors of cuda:0 (NCCL refuses two ranks on one device).  Before
    it joins the group, rank 0 makes the one-process reference of
    BarlowTwins (whose seam records it then sends to rank 1) and rank 1
    MoCo's, each on the 4 pairs; after the ranks' steps each compares its
    configuration in memory (the leaves are too large to pass through
    files).  The readings and the lines to print go to ROOT/rank<r>.pt."""
    import os
    from rmcl_tpu_torch.parallel import comm
    from rmcl_tpu_torch.parallel import dist as D
    spawned = float(Path(f"{root}/spawned").read_text())
    marks = {"started": time.time() - spawned}
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev, backend = rank_device(rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mine_ref = ("bt", "moco")[rank] if world == 2 else None
    refs = {mine_ref: ddp_slice_case(dev, mine_ref)} if mine_ref else {}
    marks["reference"] = time.time() - spawned
    D.init_distributed(dev, backend=backend, timeout_s=DDP_COLLECTIVE_S)
    marks["joined"] = time.time() - spawned
    seam = comm.all_gather(refs["bt"]["seam"] if "bt" in refs else None)[0]
    sl = slice(rank * (N_CPU // world), (rank + 1) * (N_CPU // world))
    slices = {"moco": ddp_slice_case(dev, "moco", sl),
              "bt": ddp_slice_case(dev, "bt", sl, seam=seam)}
    summaries = comm.all_gather({n: {k: v for k, v in r.items()
                                     if k in ("hash", "loss", "ids", "seen")}
                                 for n, r in slices.items()})
    lines = [_compare_slice("[ddp two ranks]", n, refs[n], slices[n], summaries) for n in refs]
    marks["slices"] = time.time() - spawned
    del refs, slices, seam, summaries       # the Trainer's peak memory is its own
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"backend": torch.distributed.get_backend(), "lines": lines,
           "trainer": ddp_trainer_rank(dev, root)}
    marks["trainer"] = time.time() - spawned
    out["marks"] = marks
    torch.save(out, f"{root}/rank{rank}.pt")
    D.destroy()
    return 0


def phase_ddp_ranks(dev) -> None:
    """Phase 21 (b) and (c): two ranks of ``chip_smoke.py --ddp-rank`` under
    torchrun (tests/_torch_ddp_worker.py:torchrun: a failed rank makes
    torchrun end the other, the deadline kills both; either fails the
    phase).  (b): the fp32 attacked task_moco and task_barlowtwins steps at
    SLICE_LAYERS, 2 ranks x 2 pairs, against one process on the same 4 pairs
    on the card (ddp_rank_main, _compare_slice): the loss within 1e-5
    relative, every gradient within 2e-4 * max(1, max|ref|), the updated
    leaves as _held_after_adamw holds them, the attacked ids equal, the
    ranks bit-identical.  (c): the Trainer of two ranks at full width."""
    import os
    import shutil
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _torch_ddp_worker import torchrun                 # the two-process tests' launcher
    tag = "[ddp two ranks]"
    root = Path(DDP_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        t0 = time.perf_counter()
        (root / "spawned").write_text(repr(time.time()))
        out = torchrun([str(Path(__file__).resolve()), "--ddp-rank", str(root)], 2, DDP_WAIT_S,
                       env=dict(os.environ), cwd=str(Path.cwd()))
        wall = time.perf_counter() - t0
        for ln in out.splitlines():              # the ranks' own lines (their seam checks)
            if ln.startswith(("[ddp", "[epoch")):
                print(f"{tag} a rank: {ln}")
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
        backend = ranks[0]["backend"]
        print(f"{tag} {torch.cuda.device_count()} card(s): {backend} "
              + ("on cuda:0 and cuda:1" if backend == "nccl" else
                 "with the CUDA tensors of cuda:0 for both ranks (one card: NCCL refuses two "
                 "ranks on one device)") + f"; the ranks {wall:.1f} s from their spawn, seconds "
              "since it: " + "; ".join(f"rank {r} " + ", ".join(
                  f"{k} {v:.1f}" for k, v in x["marks"].items()) for r, x in enumerate(ranks)))
        lines = [ln for r in ranks for ln in r["lines"]]
        check(len(lines) == 2, f"{tag} {len(lines)} configurations compared, want 2")
        for ln in lines:
            print(ln)
        t0_, t1_ = (r["trainer"] for r in ranks)
        for r, t in enumerate((t0_, t1_)):
            check(t["steps"] == TRAINER_ACCUM * DDP_TRAINER_OPT_STEPS and t["accum"] ==
                  TRAINER_ACCUM and t["per_rank"] == PGD_BATCH,
                  f"{tag} Trainer rank {r}: {t['steps']} micro-steps, accum {t['accum']}")
            check(t["equal"] == t["tensors"] and t["unused"] == 0 and t["best"],
                  f"{tag} Trainer rank {r}: 'last' loads {t['equal']} of {t['tensors']} "
                  "tensors equal")
        check(t0_["hash"] == t1_["hash"], f"{tag} Trainer: the ranks' models differ")
        one = READINGS.get("trainer_ms")
        print(f"{tag} Trainer.fit, task_moco full width bf16, 2 ranks x {PGD_BATCH} pairs per "
              f"micro-step, accum {TRAINER_ACCUM}, {DDP_TRAINER_OPT_STEPS} optimizer steps: "
              f"ms per micro-step (median after the first, host clock) rank 0 {t0_['ms']!r}, "
              f"rank 1 {t1_['ms']!r}" + (f"; phase 15's one rank {one!r}" if one else "")
              + f"; max_memory_allocated rank 0 {t0_['mem_gib']:.2f} GiB, rank 1 "
              f"{t1_['mem_gib']:.2f} GiB; 'last' loads into a fresh ViLT equal on both ranks "
              f"({t0_['tensors']} tensors), the ranks' models bit-identical; the last "
              f"micro-step with validation and two checkpoint saves {t0_['last_s']:.1f} s, the "
              f"ranks' exit {wall - max(r['marks']['trainer'] for r in ranks):.1f} s")
        READINGS.update(ddp_trainer_ms=(t0_["ms"], t1_["ms"]), ddp_backend=backend)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_ddp(dev, bare=None) -> dict:
    """Phase 21: distribution (a) one-rank NCCL at full width, (b) and (c)
    two ranks.  Returns the launches of (a)'s NCCL run."""
    t0 = time.perf_counter()
    print(f"[ddp] {torch.cuda.device_count()} CUDA device(s)")
    counts = phase_ddp_one_rank(dev, bare)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_ddp_ranks(dev)
    t2 = time.perf_counter()
    print(f"[ddp] phase 21 in {t2 - t0:.1f} s (budget 75 s): one rank {t1 - t0:.1f} s, "
          f"two ranks {t2 - t1:.1f} s")
    return counts


# ------------------------------------------------------ tensor parallelism
TP_DIR = "chip_smoke_tp.tmp"               # the ranks' spec and results; removed
TP_WAIT_S = 300                            # the two ranks' deadline (the phase's budget: 75 s)
TP_COLLECTIVE_S = 120                      # each collective's own deadline inside a rank
TP_GRID = ((1, 2), ("data", "model"))      # two model ranks, one data rank
TP_SHARDS = 2
TP_LAYERS = 2      # (c): the bf16 step's depth; over gloo every f / g moves its activation
#                    through host memory (24 of (16, 241, 768) per forward at 12 layers)
TP_STEPS = 2                               # (c): timed steps after one warm-up
TP_MIX = "realistic"                       # (c): phase 12's caption mix
TP_ROW14 = {"attn_half": "scripts/bench_tp_kernel_shapes.py:80",    # Queue B row 14
            "mlp_half": "scripts/bench_tp_kernel_shapes.py:123"}


def _full_leaves(cfg, ts) -> dict:
    """The gradients and leaves of ``ts``'s model under the JAX package's
    paths; on a grid with a model axis those of the unsharded model the
    model group's shards make (``sharding_rules.gather_model``: every rank of
    the group calls it), with the hash of the entries a model axis does not
    shard."""
    from rmcl_tpu_torch.compat.from_jax import leaves_to_jax
    from rmcl_tpu_torch.parallel import mesh
    from rmcl_tpu_torch.parallel.sharding_rules import gather_model, shard_dim
    if mesh.model_size() == 1:
        return dict(grads=leaves_to_jax(ts.model, grads=True), leaves=leaves_to_jax(ts.model))
    full = gather_model(cfg, ts.model, grads=True)
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(ts.model.state_dict().items()):
        if shard_dim(k) is None:
            h.update(k.encode() + v.detach().cpu().contiguous().view(-1).view(torch.uint8)
                     .numpy().tobytes())
    return dict(grads=leaves_to_jax(full, grads=True), leaves=leaves_to_jax(full),
                replicated=h.hexdigest())


def tp_mlm_case(dev) -> dict:
    """One fp32 step of task_moco with the MLM task added (the decoder's
    30,522 rows sharded under a model axis, its logits gathered) at
    SLICE_LAYERS, on the 4 pairs of phase 14 with the port's MLM collator's
    masked ids: ``make_train_step`` with image and text views (seeded
    attacked ids).  Returns the loss, the gradients and updated leaves."""
    from rmcl_tpu_torch.core.config import loss_names
    from rmcl_tpu_torch.data.mlm import MLMCollator
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    cfg32 = train_config().replace(compute_dtype="float32", queue_dtype="float32",
                                   num_layers=SLICE_LAYERS,
                                   loss_names=loss_names({"moco": 1, "mlm": 1}))
    batch = train_batch(cfg32, N_CPU, SEED + 4, "cpu")
    ids = batch["text_ids"].numpy()
    mlm_ids, mlm_labels = MLMCollator(_BertIds(), seed=SEED)(ids, np.isin(ids, [0, 101, 102]))
    batch.update(text_ids_mlm=torch.from_numpy(mlm_ids), text_labels_mlm=torch.from_numpy(
        np.ascontiguousarray(mlm_labels)))
    ts = create_train_state(cfg32, model=moco_model(cfg32), device=dev)
    metrics = make_train_step(cfg32, ts)({k: v.to(dev) for k, v in batch.items()},
                                         torch.Generator().manual_seed(SEED + 8))
    return dict(loss=metrics["total_loss"].item(), mlm_loss=metrics["mlm_loss"].item(),
                ids=torch.from_numpy(ids), cfg=cfg32, **_full_leaves(cfg32, ts))


def tp_impl_case(dev, config: str) -> dict:
    """One fp32 task_moco step of block configuration ``config`` (P or F) at
    SLICE_LAYERS on the 4 pairs of phase 9: ``make_train_step`` with image
    and text views (seeded attacked ids) at drop_rate DROP_P.  Returns the
    loss, the gradients and updated leaves."""
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    cfg32 = train_config(config).replace(compute_dtype="float32", queue_dtype="float32",
                                          num_layers=SLICE_LAYERS)
    batch = train_batch(cfg32, N_CPU, SEED + 4, "cpu")
    ts = create_train_state(cfg32, model=moco_model(cfg32), device=dev)
    metrics = make_train_step(cfg32, ts)({k: v.to(dev) for k, v in batch.items()},
                                         torch.Generator().manual_seed(SEED + 8))
    return dict(loss=metrics["total_loss"].item(), ids=batch["text_ids"], cfg=cfg32,
                **_full_leaves(cfg32, ts))


TP_CASES = ("moco", "mlm", "P", "F")
TP_REFERENCES = (("mlm", "P"), ("moco", "F"))   # the one-process references each rank makes


def tp_slice_case(dev, name: str) -> dict:
    """Phase 22 (a)'s case ``name``: "moco", phase 21's fp32 attacked step
    (``ddp_slice_case``), "mlm" (``tp_mlm_case``), or "P" / "F", the step of
    that block configuration (``tp_impl_case``)."""
    if name in IMPLS:
        return tp_impl_case(dev, name)
    return ddp_slice_case(dev, "moco") if name == "moco" else tp_mlm_case(dev)


def _compare_tp(tag: str, name: str, ref: dict, mine: dict, summaries: list) -> str:
    """Phase 22 (a)'s checks of one case on the rank that made its
    one-process reference: both model ranks' losses and attacked ids equal
    each other and the reference's ids, the replicated entries the same bits
    on both, the loss within 1e-5 relative, the gathered gradients within
    2e-4 * max(1, max|ref|) and the gathered updated leaves as
    ``_held_after_adamw`` holds them (phase 21's MoCo tolerances)."""
    ctag = f"{tag} {name} fp32 step on a (1, {TP_SHARDS}) grid, {SLICE_LAYERS} layers"
    ranks = [x[name] for x in summaries]
    check(len({r["replicated"] for r in ranks}) == 1,
          f"{ctag}: the ranks' replicated entries differ")
    check(len({r["loss"] for r in ranks}) == 1, f"{ctag}: the ranks' losses differ")
    for r in ranks:
        check(torch.equal(r["ids"], ref["ids"]), f"{ctag}: ids differ from the one-process ids")
    rel = abs(mine["loss"] - ref["loss"]) / abs(ref["loss"])
    check(rel <= 1e-5, f"{ctag}: loss {mine['loss']!r} vs {ref['loss']!r}")
    wg = _held(ctag, "gradient", mine["grads"], ref["grads"])
    wf, wp = _held_after_adamw(ctag, mine["leaves"], ref["leaves"], ref["grads"], ref["cfg"])
    extra = (f"; MLM loss {mine['mlm_loss']!r} vs {ref['mlm_loss']!r}, the decoder's "
             f"{ref['cfg'].vocab_size} rows {ref['cfg'].vocab_size // TP_SHARDS} a rank"
             if name == "mlm" else "; attacked ids equal" if name == "moco" else
             f"; configuration {name} ({IMPLS[name]}), drop_rate {ref['cfg'].drop_rate}, "
             f"{ref['cfg'].num_heads // TP_SHARDS} heads a rank")
    return (f"{ctag}: {TP_SHARDS} model ranks against one process on the {N_CPU} pairs on the "
            f"card: loss {mine['loss']!r} vs {ref['loss']!r} (relative {rel!r}, tol 1e-5); "
            f"{len(ref['grads'])} gathered gradients within 2e-4 * max(1, max|ref|), worst "
            f"{wg[0]} at {wg[1]:.4g} of its bound; {len(ref['leaves'])} gathered leaves, firm "
            f"elements within 2% of the rate (worst {wf[0]} at {wf[1]:.4g} of it), all within "
            f"2.5 x the rate (worst {wp[0]} at {wp[1]:.4g}); the replicated entries "
            f"bit-identical on both ranks{extra}")


def tp_step_setup(dev) -> tuple:
    """(cfg, ts, batch, greedy, step) of phase 22 (c): phase 13's attacked
    task_moco step (bf16, 16 pairs, drop_rate 0.1, TP_MIX captions) at
    TP_LAYERS; under a model axis the state is this rank's shards."""
    from rmcl_tpu_torch.train.step import create_train_state, make_attacked_train_step
    cfg = train_config().replace(num_layers=TP_LAYERS)
    ts = create_train_state(cfg, model=moco_model(cfg), device=dev)
    greedy, batch, _ = attacked_batch(cfg, ts.model, train_batch(cfg, PGD_BATCH, SEED + 4, dev),
                                      TP_MIX)
    return cfg, ts, batch, greedy, make_attacked_train_step(cfg, ts, greedy)


def tp_step_reading(dev, tag: str, lead: bool = True) -> dict:
    """Phase 22 (c)'s step on this process: one warm-up and TP_STEPS timed
    steps, each step's launches against ``expected_launches`` plus the
    attack's own count, finite metrics.  Returns ms per step (median, host
    clock + synchronize), peak memory and the launches of the last step."""
    from rmcl_tpu_torch.ops import fused_block as FB
    cfg, ts, batch, greedy, step = tp_step_setup(dev)
    gen = torch.Generator().manual_seed(SEED + 7)
    step(batch, gen)                                          # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, counts = [], None
    for it in range(TP_STEPS):
        FB.reset_launches()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t) * 1e3)
        counts = dict(FB.launches)
        want = expected_launches(cfg)
        attack = attack_launches(greedy.last_stats, cfg.num_layers)
        want = {k: want[k] + attack[k] for k in want}
        check(counts == want, f"{tag} step {it}: launches {counts}, expected {want}")
        counts = check_sub_launches(f"{tag} step {it}", counts, FB, lead)
        vals = {k: v.item() for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"{tag} step {it}: {vals}")
    return dict(ms=statistics.median(walls), walls=walls, counts=counts,
                mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                loss=vals["total_loss"])


def tp_rank_main(root: str) -> int:
    """``chip_smoke.py --tp-rank ROOT``: one rank of phase 22's parts (a) and
    (c), started by phase_tp_ranks in torchrun's environment, on a (1, 2)
    grid (``parallel/mesh.py:init_grid``).  With a card per rank, NCCL on
    cuda:RANK; with one card for both, gloo with the CUDA tensors of cuda:0.
    Before it joins the group rank 0 makes the one-process reference of the
    "mlm" case and rank 1 the "moco" case's; after the grid's steps each
    compares its case.  The readings go to ROOT/rank<r>.pt."""
    import os
    from rmcl_tpu_torch.parallel import comm, mesh
    from rmcl_tpu_torch.parallel import dist as D
    spawned = float(Path(f"{root}/spawned").read_text())
    marks = {"started": time.time() - spawned}
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev, backend = rank_device(rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mine = TP_REFERENCES[rank]
    refs = {n: tp_slice_case(dev, n) for n in mine}
    marks["reference"] = time.time() - spawned
    D.init_distributed(dev, backend=backend, timeout_s=TP_COLLECTIVE_S)
    grid = mesh.init_grid(*TP_GRID)
    check((grid.data_rank, grid.model_rank) == (0, rank), f"rank {rank}: grid {grid}")
    marks["joined"] = time.time() - spawned
    cases = {n: tp_slice_case(dev, n) for n in TP_CASES}
    summaries = comm.all_gather({n: {k: r[k] for k in ("loss", "ids", "replicated")}
                                 for n, r in cases.items()})
    lines = [_compare_tp("[tp]", n, refs[n], cases[n], summaries) for n in mine]
    marks["checks"] = time.time() - spawned
    del refs, cases, summaries
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    step = tp_step_reading(dev, f"[tp rank {rank}]", lead=grid.model_rank == 0)
    marks["step"] = time.time() - spawned
    torch.save({"backend": torch.distributed.get_backend(), "lines": lines, "step": step,
                "marks": marks}, f"{root}/rank{rank}.pt")
    D.destroy()
    return 0


def phase_tp_ranks(dev) -> dict:
    """Phase 22 (a) and (c): two ranks of ``chip_smoke.py --tp-rank`` under
    torchrun (tests/_torch_ddp_worker.py:torchrun), beside the one-process
    step at TP_LAYERS on this process for (c).  Returns the readings."""
    import os
    import shutil
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _torch_ddp_worker import torchrun                 # the two-process tests' launcher
    tag = "[tp two ranks]"
    one = tp_step_reading(dev, "[tp one process]")
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(TP_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        t0 = time.perf_counter()
        (root / "spawned").write_text(repr(time.time()))
        out = torchrun([str(Path(__file__).resolve()), "--tp-rank", str(root)], 2, TP_WAIT_S,
                       env=dict(os.environ), cwd=str(Path.cwd()))
        wall = time.perf_counter() - t0
        for ln in out.splitlines():
            if ln.startswith("[tp"):
                print(f"{tag} a rank: {ln}")
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    backend = ranks[0]["backend"]
    print(f"{tag} {torch.cuda.device_count()} card(s): {backend} "
          + ("on cuda:0 and cuda:1" if backend == "nccl" else
             "with the CUDA tensors of cuda:0 for both ranks (one card: NCCL refuses two "
             "ranks on one device)") + f"; the ranks {wall:.1f} s from their spawn, seconds "
          "since it: " + "; ".join(f"rank {r} " + ", ".join(
              f"{k} {v:.1f}" for k, v in x["marks"].items()) for r, x in enumerate(ranks)))
    lines = [ln for r in ranks for ln in r["lines"]]
    check(len(lines) == len(TP_CASES),
          f"{tag} {len(lines)} cases compared, want {len(TP_CASES)}")
    for ln in lines:
        print(ln)
    s0, s1 = (r["step"] for r in ranks)
    # each step's launches were held to expected_launches and the attack's own
    # count in its process; the attack's loops follow its data-dependent
    # decisions, so the one process's bf16 step may take another number of them
    check(all(s1["counts"][k] == v for k, v in s0["counts"].items() if k != "colsum"),
          f"{tag} the ranks' launches per step differ: {s0['counts']}, {s1['counts']}")
    check(s0["loss"] == s1["loss"], f"{tag} the ranks' losses differ")
    trainer = READINGS.get("trainer_ms")
    print(f"{tag} (c) the attacked task_moco step, bf16, {PGD_BATCH} pairs, {TP_MIX} captions, "
          f"{TP_LAYERS} layers: ms per step (median of {TP_STEPS}, host clock + synchronize) "
          f"rank 0 {s0['ms']!r}, rank 1 {s1['ms']!r} against one process {one['ms']!r} "
          f"({s0['ms'] / one['ms']:.3f}x)" + (f"; phase 15's Trainer micro-step at 12 layers "
                                               f"{trainer!r}" if trainer else "")
          + f"; max_memory_allocated rank 0 {s0['mem_gib']:.3f} GiB, rank 1 "
          f"{s1['mem_gib']:.3f} GiB, one process {one['mem_gib']:.3f} GiB; launches per step "
          f"rank 0 {s0['counts']}, one process {one['counts']}")
    READINGS.update(tp_ms=(s0["ms"], s1["ms"]), tp_one_ms=one["ms"],
                    tp_mem_gib=(s0["mem_gib"], s1["mem_gib"]), tp_one_mem_gib=one["mem_gib"])
    return dict(counts=s0["counts"], ms=(s0["ms"], s1["ms"]), one_ms=one["ms"],
                mem_gib=(s0["mem_gib"], s1["mem_gib"]), one_mem_gib=one["mem_gib"],
                backend=backend)


def _tp_shard(w: dict, r: int, m: int) -> dict:
    """Shard ``r`` of ``m`` of a block's (ln, attn, mlp) weights, by the
    rules of ``parallel/sharding_rules.py``."""
    from rmcl_tpu_torch.parallel.sharding_rules import shard_tensor
    names = {"wq": "attn.qkv.weight", "bq": "attn.qkv.bias", "wp": "attn.proj.weight",
             "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias", "w2": "mlp.fc2.weight"}
    return {k: (shard_tensor(f"transformer.blocks.0.{names[k]}", v, r, m).contiguous()
                if k in names else v) for k, v in w.items()}


def _no_none(fn):
    return lambda *a, **kw: tuple(o for o in fn(*a, **kw) if o is not None)


def _one(fn):
    return lambda *a: (fn(*a),)


def tp_op_kernels(dev) -> dict:
    """Phase 22 (b): every op of the tensor-parallel block at Queue B row 14's
    shard shapes (two-way: 6 of 12 heads, qkv 768 -> 1152, proj 384 -> 768
    partial, fc1 768 -> 1536, fc2 1536 -> 768 partial; B = 16, S = 241),
    both shards (the first adds the residual and the proj / fc2 bias, the
    second neither and starts the in-MLP mask at column 1536), fp32 and
    bf16, against its plain version on the same inputs: the forward halves,
    the dx halves (from the kept qkv / h and recomputing), F's attention
    half and its backward, P's attention core forward and backward on the
    shard's heads, and the training halves forward and backward at p = 0.1.  Every mask the training kernels apply or regenerate equals
    ``keep_mask`` with the shard's column offset bit for bit; every
    multi-output op gives the same bits twice.  The second shard's calls are
    timed (CUDA events), each beside its bound at the shard's work."""
    from rmcl_tpu_torch.models.vit import VIT_LN_EPS as eps
    from rmcl_tpu_torch.ops import attention as A
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.ops import fused_block_train as FT
    from rmcl_tpu_torch.ops.philox import keep_mask
    torch.backends.cuda.matmul.allow_tf32 = False
    m = TP_SHARDS
    x, mask, (lw, lb), (wq, bq, wp, bp), (w1, b1, w2, b2), H = _block_inputs(
        dev, B=PGD_BATCH, S=241)
    B, S, C = x.shape
    C4, D = 4 * C // m, C // H
    full = dict(wq=wq, bq=bq, wp=wp, bp=bp, w1=w1, b1=b1, w2=w2, b2=b2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    g = torch.randn(x.shape, generator=gen, device=dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=gen, device=dev).int()
    g_heads = torch.randn(B, H // m, S, D, generator=gen, device=dev)
    shape = f"B={B} S={S} C={C} shard of {m}: {H // m} heads, qkv {C}->{3 * C // m}, fc1 {C}->{C4}"
    res = {}
    with torch.inference_mode():
        for r in range(m):
            s = _tp_shard(full, r, m)
            lead, col0, timed = r == 0, r * C4, r == m - 1
            bpr, b2r = (s["bp"], s["b2"]) if lead else (None, None)
            want = [keep_mask(seeds, 0, S, C, DROP_P), keep_mask(seeds, 0, S, C4, DROP_P, col0),
                    keep_mask(seeds, 1, S, C, DROP_P)]
            for dtype, rtol, tag in ((torch.float32, 2e-4, "fp32"),
                                     (torch.bfloat16, 2e-2, "bf16")):
                fp32 = dtype == torch.float32
                xd, gd = x.to(dtype), g.to(dtype)
                wqd, wpd, w1d, w2d = (s[k].to(dtype) for k in ("wq", "wp", "w1", "w2"))
                a_w = (xd, mask, lw, lb, wqd, s["bq"], wpd)
                m_w = (xd, lw, lb, w1d, s["b1"], w2d)
                tg = f"{tag} shard {r}"

                def keep(name, rec):
                    if timed:
                        res[f"{name} {tag}"] = rec
                qkv = FB._attn_fwd(*a_w, bpr, H // m, eps, lead)[1]
                h = FB._mlp_fwd(*m_w, b2r, eps, lead, keep_h=True)[1]
                for name, op, plain, args in (
                        ("attn_half", FB.attn_half, FB.attn_half_plain,
                         (*a_w, bpr, H // m, eps, lead)),
                        ("mlp_half", FB.mlp_half, FB.mlp_half_plain, (*m_w, b2r, eps, lead)),
                        ("attn_half_dx", FB.attn_half_dx, FB.attn_half_dx_plain,
                         (*a_w, gd, H // m, eps, lead, qkv)),
                        ("mlp_half_dx", FB.mlp_half_dx, FB.mlp_half_dx_plain,
                         (*m_w, gd, eps, lead, h)),
                        ("attn_half_dx[recompute]", FB.attn_half_dx, FB.attn_half_dx_plain,
                         (*a_w, gd, H // m, eps, lead)),
                        ("mlp_half_dx[recompute]", FB.mlp_half_dx, FB.mlp_half_dx_plain,
                         (*m_w, gd, eps, lead)),
                        ("attn_half_full", FB.attn_half_full,
                         lambda *a: FB.attn_half_plain(*a, residual=False),
                         (xd, mask, lw, lb, wqd, s["bq"], wpd, bpr, H // m, eps))):
                    keep(name, _compare_all(name, tg, shape, _one(op), _one(plain), args, rtol,
                                            fp32, ("out",), timed))
                _, fq, fa = FB._attn_fwd(xd, mask, lw, lb, wqd, s["bq"], wpd, bpr, H // m, eps,
                                         False)
                keep("attn_half_full_bwd", _compare_all(
                    "attn_half_full_bwd", tg, shape, _no_none(FB.attn_half_full_bwd),
                    _no_none(FB.attn_half_full_bwd_plain),
                    (xd, mask, lw, lb, wqd, wpd, gd, fq, fa, H // m, eps, lead), rtol, fp32,
                    GRADS, timed))
                # P's attention core on the shard's H/m heads: views of its qkv
                q, k, v = qkv.view(B, S, 3, H // m, D).permute(2, 0, 3, 1, 4).unbind(0)
                ghd = g_heads.to(dtype)
                keep("masked_attention", _compare_all(
                    "masked_attention", tg, shape, _one(A.masked_attention), _one(A.mha),
                    (q, k, v, mask, D ** -0.5), rtol, fp32, ("out",), timed))
                keep("masked_attention_bwd", _compare_all(
                    "masked_attention_bwd", tg, shape, A.masked_attention_bwd,
                    A.masked_attention_bwd_plain, (q, k, v, mask, ghd, D ** -0.5), rtol, fp32,
                    ("dq", "dk", "dv"), timed))
                # the training halves: masks first, then outputs and gradients
                ta = (xd, seeds, mask, lw, lb, wqd, s["bq"], wpd, bpr, H // m, eps, DROP_P)
                tm = (xd, seeds, lw, lb, w1d, s["b1"], w2d, b2r, DROP_P, eps)
                _, m_a = FT.attn_half_train(*ta, emit_mask=True, residual=lead)
                _, m_1, m_2 = FT.mlp_half_train(*tm, emit_mask=True, residual=lead, col0=col0)
                check(torch.equal(m_a, want[0]) and torch.equal(m_1, want[1])
                      and torch.equal(m_2, want[2]),
                      f"[tp] {tg}: forward masks differ from keep_mask at column {col0}")
                keep("attn_half_train", _compare_all(
                    "attn_half_train", tg, shape,
                    lambda *a: (FT.attn_half_train(*a, residual=lead),),
                    lambda *a: (FT.attn_half_train_plain(*a, residual=lead),), ta, rtol, fp32,
                    ("out",), timed))
                keep("mlp_half_train", _compare_all(
                    "mlp_half_train", tg, shape,
                    lambda *a: (FT.mlp_half_train(*a, residual=lead, col0=col0),),
                    lambda *a: (FT.mlp_half_train_plain(*a, residual=lead, col0=col0),), tm,
                    rtol, fp32, ("out",), timed))
                _, tq, tat, _ = FT._attn_train_fwd(*ta, residual=lead)
                _, th, ad, _, _ = FT._mlp_train_fwd(xd, seeds, lw, lb, w1d, s["b1"], w2d, b2r,
                                                    eps, DROP_P, True, residual=lead, col0=col0)
                ab = (xd, seeds, mask, lw, lb, wqd, wpd, gd, tq, tat, H // m, eps, DROP_P)
                mb = (xd, seeds, lw, lb, w1d, w2d, gd, th, ad, DROP_P, eps)
                kw_a, kw_m = dict(residual=lead, bias=lead), dict(residual=lead, bias=lead,
                                                                   col0=col0)
                *_, m_a = FT.attn_half_train_bwd(*ab, emit_mask=True, **kw_a)
                *_, m_1, m_2 = FT.mlp_half_train_bwd(*mb, emit_mask=True, **kw_m)
                check(torch.equal(m_a, want[0]) and torch.equal(m_1, want[1])
                      and torch.equal(m_2, want[2]),
                      f"[tp] {tg}: backward masks differ from keep_mask at column {col0}")
                keep("attn_half_train_bwd", _compare_all(
                    "attn_half_train_bwd", tg, shape,
                    _no_none(lambda *a: FT.attn_half_train_bwd(*a, **kw_a)),
                    _no_none(lambda *a: FT.attn_half_train_bwd_plain(*a, **kw_a)), ab, rtol,
                    fp32, GRADS, timed))
                keep("mlp_half_train_bwd", _compare_all(
                    "mlp_half_train_bwd", tg, shape,
                    _no_none(lambda *a: FT.mlp_half_train_bwd(*a, **kw_m)),
                    _no_none(lambda *a: FT.mlp_half_train_bwd_plain(*a, **kw_m)), mb, rtol,
                    fp32, GRADS, timed))
            print(f"[tp] shard {r}: every op at the shard's shapes within tolerance in fp32 and "
                  f"bf16; the training kernels' masks (attention, in-MLP from column {col0}, "
                  f"tail) equal keep_mask bit for bit in both directions")
    for key, rec in res.items():
        name, tag = key.rsplit(" ", 1)
        base = name.split("[")[0]
        b_ms, b_by = bound(base, B, S, C, saved="recompute" not in name,
                           es=4 if tag == "fp32" else 2, m=m)
        rec.update(bound_ms=b_ms, bound_by=b_by)
        print(f"[tp] {key} (second shard, {shape}): kernel_ms={rec['ms']!r} "
              f"plain_ms={rec['plain_ms']!r} bound_ms={b_ms!r} (by {b_by}; "
              f"{b_ms / rec['ms']:.3f} of it)")
    return res


def phase_tp(dev) -> dict:
    """Phase 22: tensor parallelism.  (b) every op at the shard shapes on
    this process; (a) and (c) two ranks of a (1, 2) grid.  Returns the
    readings of both."""
    t0 = time.perf_counter()
    ops = tp_op_kernels(dev)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = phase_tp_ranks(dev)
    t2 = time.perf_counter()
    print(f"[tp] phase 22 in {t2 - t0:.1f} s (budget 75 s): the ops {t1 - t0:.1f} s, the "
          f"ranks and the one-process step {t2 - t1:.1f} s")
    return dict(ops=ops, **ranks)


def tp_records(tp: dict) -> list:
    """Queue B row 14's records of the kernels line: the forward halves at the
    shard shapes (the second shard's bf16 calls), with their launches per
    tensor-parallel step of (c) (rank 0's; the attack's and the key
    forward's deterministic forwards)."""
    out = []
    for name, replaces in TP_ROW14.items():
        r, f = tp["ops"][f"{name} bf16"], tp["ops"][f"{name} fp32"]
        out.append({"name": f"{name}[tp{TP_SHARDS}]", "route": "cuda", "source": SOURCE,
                    "replaces": replaces, "launches": tp["counts"][name],
                    "launches_per": f"tensor-parallel attacked step, {TP_LAYERS} layers, "
                                    f"rank 0 of (1, {TP_SHARDS})",
                    "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                    "shape": f"B={PGD_BATCH} S=241, shard of {TP_SHARDS}",
                    "fp32_ms": f["ms"], "fp32_plain_ms": f["plain_ms"],
                    "fp32_bound_ms": f["bound_ms"],
                    "shard_ops": {k: {x: v.get(x) for x in ("ms", "plain_ms", "bound_ms", "err")}
                                  for k, v in tp["ops"].items()},
                    "step_ms": list(tp["ms"]), "one_process_ms": tp["one_ms"],
                    "mem_gib": list(tp["mem_gib"]), "one_process_mem_gib": tp["one_mem_gib"],
                    "backend": tp["backend"]})
    return out


# ---------------------------------------------------------------- export
EXPORT_DIR = "chip_smoke_export.tmp"      # the artifacts and their sidecars; removed
EXPORT_TIMED = 15                         # (a): timed batch-8 forwards, median


def _artifact_nodes(art) -> dict:
    """The ``rmcl::`` operator nodes of a loaded artifact's graph, by name."""
    counts: dict = {}
    for node in art.program.graph.nodes:
        name = str(node.target)
        if name.startswith("rmcl."):
            counts[name] = counts.get(name, 0) + 1
    return counts


def _artifact_checks(tag: str, art, want_nodes: dict) -> None:
    """No parameter inside the program, and the operator nodes ``want_nodes``."""
    check(len(art.program.state_dict) == 0 and len(art.program.constants) == 0,
          f"{tag}: the program holds {len(art.program.state_dict)} parameters and "
          f"{len(art.program.constants)} constants")
    nodes = _artifact_nodes(art)
    check(nodes == want_nodes, f"{tag}: operator nodes {nodes}, want {want_nodes}")


def _forward_launches(tag: str, FB, fn, want: dict) -> dict:
    """The launches of one forward ``fn()``: ``want``'s ops that many times,
    every other op none; the sub-kernels as the ops derive them."""
    FB.reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = dict(FB.launches)
    check(counts == {**{k: 0 for k in counts}, **want},
          f"{tag}: launches per forward {counts}, want {want}")
    counts = check_sub_launches(tag, counts, FB)
    return {k: v for k, v in counts.items() if v}


def _serving_times(sess, full: dict, reqs: dict) -> tuple:
    """(batch-8 ms: median of EXPORT_TIMED forwards, host clock + synchronize;
    requests/s: the median of 5 runs of ``infer`` over every request)."""
    lat = []
    for _ in range(EXPORT_TIMED):
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
    return statistics.median(lat), len(reqs["text_ids"]) / statistics.median(walls)


def phase_export_vqa(dev, root: Path) -> dict:
    """Phase 23 (a): phase 4's cell (task_finetune_vqa, ViLT-B/32 at full
    width and depth, bf16, u8 wire, batch 8) as an artifact exported on the
    host (device="cpu"), saved, loaded onto the card and serving phase 4's
    requests against the live Session on the same weights."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import (ArtifactSession, Session, export_inference, load_artifact,
                                      seeded_model)
    tag = "[export] (a)"
    cfg = build_config(CONFIG)
    model = seeded_model(cfg, SEED)
    reqs = synthetic_requests(cfg, N_REQUESTS, SEED)
    path = root / "vqa.pt2"
    t0 = time.perf_counter()
    blob = export_inference(cfg, model, "vqa", BATCH, out_path=str(path), device="cpu")
    t1 = time.perf_counter()
    art = load_artifact(str(path), dev)
    t2 = time.perf_counter()
    L = cfg.num_layers
    _artifact_checks(tag, art, {"rmcl.attn_half.default": L, "rmcl.mlp_half.default": L})
    meta = json.loads(Path(f"{path}.json").read_text())
    served = ArtifactSession(art, model.state_dict(), None, meta)
    live = Session(cfg, model, "vqa", BATCH, dev)
    chunks = [{k: v[i:i + BATCH] for k, v in reqs.items()} for i in range(0, N_REQUESTS, BATCH)]
    for i, c in enumerate(chunks):
        m = len(c["text_ids"])
        if m < BATCH:   # the sessions' pad by repeat
            c = {k: np.concatenate([v, np.repeat(v[:1], BATCH - m, axis=0)])
                 for k, v in c.items()}
        a, b = served.forward(c), live.forward(c)
        check(a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b),
              f"{tag} chunk {i}: the artifact's logits differ from the live Session's "
              f"(max abs {(a.float() - b.float()).abs().max().item()!r})")
    out = served.infer(reqs)
    check(out.shape == (N_REQUESTS, cfg.vqav2_label_size) and bool(np.isfinite(out).all()),
          f"{tag}: outputs {out.shape}, finite {bool(np.isfinite(out).all())}")
    full = chunks[0]
    counts = _forward_launches(tag, FB, lambda: served.forward(full),
                               {"attn_half": L, "mlp_half": L})
    # timed in turns: live, artifact, artifact, live
    times = {}
    for name, sess in (("live", live), ("artifact", served), ("artifact2", served),
                       ("live2", live)):
        times[name] = _serving_times(sess, full, reqs)
    ms = statistics.median([times["artifact"][0], times["artifact2"][0]])
    live_ms = statistics.median([times["live"][0], times["live2"][0]])
    rps = statistics.median([times["artifact"][1], times["artifact2"][1]])
    live_rps = statistics.median([times["live"][1], times["live2"][1]])
    p4 = READINGS.get("serving")
    print(f"{tag} {CONFIG}, {L} layers, bf16, u8 wire, batch {BATCH}: exported on the CPU in "
          f"{t1 - t0:.1f} s, {len(blob)} bytes ({path.name} + {path.name}.json), loaded onto "
          f"the card in {t2 - t1:.1f} s; no parameter or constant inside; {L} rmcl.attn_half "
          f"+ {L} rmcl.mlp_half nodes; {len(chunks)} batches of phase 4's {N_REQUESTS} "
          f"requests equal the live Session's bit for bit; launches per forward {counts}")
    print(f"{tag} batch-{BATCH} ms (median of {EXPORT_TIMED}, host clock + synchronize, in turns "
          f"live / artifact / artifact / live): artifact {ms!r} ({times['artifact'][0]!r}, "
          f"{times['artifact2'][0]!r}), live Session {live_ms!r}; requests/s (median of 5 runs "
          f"of {N_REQUESTS}): artifact {rps!r}, live Session {live_rps!r}"
          + (f"; phase 4's Session: {p4[0]!r} ms, {p4[1]!r} requests/s" if p4 else ""))
    READINGS.update(export_ms=ms, export_rps=rps)
    return dict(counts=counts, ms=ms, rps=rps, live_ms=live_ms, live_rps=live_rps,
                bytes=len(blob))


def phase_export_embed(dev, root: Path) -> None:
    """Phase 23 (b): an fp32 task_moco embed artifact (full width and depth,
    u8 wire, batch N_CPU) exported on the host, served on the card and on
    the CPU on the same 4 requests: within phase 5's 1e-3 * max(1, max|ref|)."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import export_inference, load_artifact, seeded_model
    tag = "[export] (b)"
    cfg = build_config(PGD_CONFIG, compute_dtype="float32")
    model = seeded_model(cfg, SEED)
    sd = model.state_dict()
    blob = export_inference(cfg, model, "embed", N_CPU, device="cpu")
    batch = synthetic_requests(cfg, N_CPU, SEED + 1)
    on_cpu, on_card = load_artifact(blob, "cpu"), load_artifact(blob, dev)
    t0 = time.perf_counter()
    ref = on_cpu(sd, batch).float()
    cpu_s = time.perf_counter() - t0
    L = cfg.num_layers
    got = {}
    counts = _forward_launches(tag, FB, lambda: got.setdefault("out", on_card(sd, batch)),
                               {"attn_half": L, "mlp_half": L})
    out = got["out"].float().cpu()
    diff = (out - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    print(f"{tag} {PGD_CONFIG} embed, fp32, {L} layers, batch {N_CPU}: {len(blob)} bytes; the "
          f"card's output vs the same artifact on the CPU ({cpu_s:.1f} s) max_abs_diff={diff!r} "
          f"(tol {tol:.3g}); launches per forward {counts}")
    check(out.shape == (N_CPU, 128) and diff <= tol,
          f"{tag}: shape {tuple(out.shape)}, max_abs_diff {diff} > {tol}")


def phase_export_p(dev, root: Path) -> dict:
    """Phase 23 (c): phase 4's cell under configuration P at SLICE_LAYERS:
    the artifact holds one rmcl.masked_attention node a layer, launches it
    on the card, and equals the live Session bit for bit."""
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import Session, export_inference, load_artifact, seeded_model
    tag = "[export] (c)"
    cfg = build_config(CONFIG, attention_impl="pallas", num_layers=SLICE_LAYERS)
    model = seeded_model(cfg, SEED)
    sd = model.state_dict()
    blob = export_inference(cfg, model, "vqa", BATCH, device="cpu")
    art = load_artifact(blob, dev)
    L = cfg.num_layers
    _artifact_checks(tag, art, {"rmcl.masked_attention.default": L, "rmcl.mlp_half.default": L})
    batch = {k: v[:BATCH] for k, v in synthetic_requests(cfg, BATCH, SEED + 2).items()}
    got = {}
    counts = _forward_launches(tag, FB, lambda: got.setdefault("out", art(sd, batch)),
                               {"masked_attention": L, "mlp_half": L})
    live = Session(cfg, model, "vqa", BATCH, dev).forward(batch)
    check(torch.equal(got["out"], live), f"{tag}: the artifact's logits differ from the live "
          f"Session's (max abs {(got['out'].float() - live.float()).abs().max().item()!r})")
    print(f"{tag} {CONFIG} under P (attention_impl='pallas'), bf16, {L} layers, batch {BATCH}: "
          f"{len(blob)} bytes; {L} rmcl.masked_attention + {L} rmcl.mlp_half nodes; equal to "
          f"the live Session bit for bit; launches per forward {counts}")
    return counts


def phase_export(dev) -> dict:
    """Phase 23: the AOT serving artifact (serve.py: export_inference,
    load_artifact, ArtifactSession), exported on the host and served on the
    card.  Returns the launches per forward of (a) and (c)."""
    import shutil
    t0 = time.perf_counter()
    root = Path(EXPORT_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        vqa = phase_export_vqa(dev, root)
        phase_export_embed(dev, root)
        p = phase_export_p(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[export] phase 23 in {time.perf_counter() - t0:.1f} s (budget 60 s)")
    return {"artifact": vqa["counts"], "artifact_P": p}


# --------------------------------------------------------------- profile
def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _trace(what: str, fn, calls: int, top: int = 12) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    _trace_report(what, prof, wall, calls, top)


def _trace_report(what: str, prof, wall: float, calls: int, top: int) -> None:
    """Device time by kernel of a finished profile over ``calls`` calls of
    ``wall`` ms each."""
    from torch.autograd import DeviceType
    # device-side events only: a host op's device time is its kernels' again, and so
    # is that of an annotation the optimizer puts on the device's timeline
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3 / calls
    check(busy > 0, f"{what}: the profiler saw no device time")
    print(f"[profile] {what}: wall {wall!r} ms per call under the profiler, device busy "
          f"{busy!r} ms, idle share {1 - busy / wall:.3f}; "
          f"{sum(r[1] for r in rows) / calls:.0f} device kernels and copies per call")
    for key, count, us in rows[:top]:
        print(f"[profile]   {us / 1e3 / calls:9.4f} ms  {100 * us / 1e3 / calls / wall:5.1f}% "
              f"of wall  x{count / calls:<6.0f} {key[:90]}")
    rest = sum(r[2] for r in rows[top:]) / 1e3 / calls
    print(f"[profile]   {rest:9.4f} ms  {100 * rest / wall:5.1f}% of wall  every other kernel")


def phase_profile(dev) -> None:
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.serve import Session, seeded_model
    cfg = build_config(CONFIG)
    sess = Session(cfg, seeded_model(cfg, SEED), "vqa", BATCH, dev)
    full = synthetic_requests(cfg, BATCH, SEED)
    for _ in range(3):
        sess.forward(full)
    _trace(f"serving, {CONFIG}, one batch-{BATCH} Session.forward, bf16",
           lambda: sess.forward(full), 5)
    del sess
    pcfg, model, _, batch, k, attack = pgd_setup(dev)
    _trace(f"pgd, {PGD_CONFIG}, one {pcfg.adv_steps_img}-step attack on {PGD_BATCH} pairs, "
           f"bf16", lambda: attack(batch, k, model.proj_queue), 2)
    del model, batch, k, attack
    for config in IMPLS:
        _, ts, tbatch, _, make_step = train_setup(dev, config)
        step = make_step()
        gen = torch.Generator().manual_seed(SEED + 7)
        step(tbatch, gen)
        _trace(f"train {config} {ts.model.block_impls}, {PGD_CONFIG}, one training step of "
               f"{PGD_BATCH} pairs (image and text views, drop_rate {DROP_P}), bf16",
               lambda: step(tbatch, gen), 2, top=24)
        del ts, tbatch, step
    for mix in GREEDY_MIXES:
        _, ts, tbatch, greedy, make_step = train_setup(dev, "default", mix)
        step = make_step()
        gen = torch.Generator().manual_seed(SEED + 7)
        step(tbatch, gen)
        _trace(f"train attacked {mix}, {PGD_CONFIG}, one attacked training step of "
               f"{PGD_BATCH} pairs (the greedy attack on {mix} captions, then as above), bf16",
               lambda: step(tbatch, gen), 2, top=24)
        print(f"[profile]   the greedy attack of the last step: {greedy.last_stats} "
              f"(host_reads: the packed reads of the live count and the commit flag)")
        del ts, tbatch, step, greedy
    _trace_trainer(dev)
    from rmcl_tpu_torch.train.step import create_train_state, make_attacked_train_step
    for mix in GREEDY_MIXES:
        cfg = bt_config()
        ts = create_train_state(cfg, model=bt_model(cfg), device=dev)
        greedy, tbatch, _ = attacked_batch(cfg, ts.model, train_batch(cfg, PGD_BATCH, SEED + 4,
                                                                      dev), mix)
        step = make_attacked_train_step(cfg, ts, greedy)
        gen = torch.Generator().manual_seed(SEED + 7)
        step(tbatch, gen)
        _trace(f"bt attacked {mix}, {BT_CONFIG}, one attacked training step of {PGD_BATCH} "
               f"pairs (the greedy attack on {mix} captions, PGD, three views; bt_proj_dims "
               f"{cfg.bt_proj_dims}), bf16", lambda: step(tbatch, gen), 2, top=24)
        print(f"[profile]   the greedy attack of the last step: {greedy.last_stats}")
        del ts, tbatch, step, greedy


def _trace_trainer(dev) -> None:
    """Phase 15's Trainer run with the profiler on over its second
    accumulation cycle: from the start of micro-step 2 to the start of
    micro-step 4, the host loop between the steps included."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from rmcl_tpu_torch.train.loop import Trainer
    root = Path(TRAINER_DIR).resolve()
    shutil.rmtree(root, ignore_errors=True)
    try:
        root.mkdir()
        cfg, dm_cls, model = trainer_setup(dev, str(root))
        cfg = cfg.replace(log_dir=str(root / "p"))
        tr = Trainer(cfg, workdir=cfg.log_dir, datamodule=dm_cls(cfg), device=dev)
        tr.setup(model=model)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        inner, window = tr.step_fn, {}

        def step_fn(db, gen):
            if tr.steps_done in (TRAINER_ACCUM, 2 * TRAINER_ACCUM):
                torch.cuda.synchronize()
                if tr.steps_done == TRAINER_ACCUM:
                    prof.start()
                    window["t0"] = time.perf_counter()
                else:
                    window["wall"] = (time.perf_counter() - window["t0"]) * 1e3
                    prof.stop()
            return inner(db, gen)

        tr.step_fn = step_fn
        tr.fit()
        check("wall" in window, "trainer profile: the window did not close")
        _trace_report(f"trainer, {PGD_CONFIG}, micro-steps {TRAINER_ACCUM} and "
                      f"{TRAINER_ACCUM + 1} of Trainer.fit (one optimizer step, accum "
                      f"{TRAINER_ACCUM}, {PGD_BATCH} pairs each, {TRAINER_MIX} captions), bf16",
                      prof, window["wall"] / TRAINER_ACCUM, TRAINER_ACCUM, 24)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call, enqueue only: the card is first held busy by a
    spin kernel, so the host never waits for it (median of 3 runs)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        torch.cuda._sleep(2_000_000_000)
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def attack_times(dev, config: str) -> tuple:
    """(wall ms, median of 7, host clock + synchronize; device busy ms) of
    the 5-step attack of phase 6 under a block configuration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rmcl_tpu_torch import build_config
    from rmcl_tpu_torch.attacks.pgd import make_pgd_moco
    cfg = build_config(PGD_CONFIG, **IMPLS[config])
    model = moco_model(cfg).to(dev)
    batch = pgd_batch(cfg, PGD_BATCH, SEED + 4, dev)
    k = moco_keys(model, batch)
    attack = make_pgd_moco(model, cfg.adv_steps_img, cfg.adv_lr_img, cfg.adv_max_norm_img,
                           cfg.temperature, fast=True)
    run = lambda: attack(batch, k, model.proj_queue)  # noqa: E731
    run()
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = sum(_device_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return statistics.median(walls), busy / 1e3


# the fp32 attention kernels by profiler name, this checkout's and the SIMT
# ones before them (masked_attention_*_kernel<float>), so that --gemm-times
# splits both packages' fp32 steps alike
F32_ATTN_NAMES = {"attention fwd": ("sa::fwd_kernel", "masked_attention_fwd_kernel"),
                  "attention bwd_dq": ("bwd_dq_kernel",),
                  "attention bwd_dkv": ("bwd_dkv_kernel",)}


def fp32_step_times(dev) -> tuple:
    """(wall ms, median of 3 after a warm-up, host clock + synchronize; device
    busy ms of one step under torch.profiler; that step's device ms of each
    fp32 attention kernel, F32_ATTN_NAMES) of phase 8's unattacked default
    task_moco step with compute_dtype="float32": 16 pairs, 12 layers, the
    fp32 kernels throughout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rmcl_tpu_torch.train.step import create_train_state, make_train_step
    cfg = train_config().replace(compute_dtype="float32", queue_dtype="float32")
    ts = create_train_state(cfg, model=moco_model(cfg), device=dev)
    batch = train_batch(cfg, PGD_BATCH, SEED + 4, dev)
    gen = torch.Generator().manual_seed(SEED + 7)
    step = make_train_step(cfg, ts)
    step(batch, gen)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch, gen)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(_device_us(e) for e in events)
    attn = {part: sum(_device_us(e) for e in events if any(n in e.key for n in names)) / 1e3
            for part, names in F32_ATTN_NAMES.items()}
    return statistics.median(walls), busy / 1e3, attn


def _attention_calls(dev, lib, gen, dtype=torch.bfloat16) -> dict:
    """The four C entry points of the attention forward and backward at
    B=16, S=241, H=12, D=64 in ``dtype`` (bf16: hopper_attention.cuh; fp32,
    dtype code 0: the FMA kernels), called as they have been since they
    exist: the packed layout (rmcl_masked_attention_fwd, rows 1, 8, 2;
    rmcl_masked_attention_bwd, rows 3, 9, 2) and the heads layout on views
    of one qkv buffer (rmcl_attention_fwd, row 10; rmcl_attention_bwd, row
    11); and F.scaled_dot_product_attention on the same heads and its
    backward (torch.autograd.grad), fp32 without TF32.  An fp32 name ends
    in " fp32"."""
    import torch.nn.functional as F
    B, S, H, D = PGD_BATCH, 241, 12, 64
    C, code = H * D, {torch.float32: 0, torch.bfloat16: 1}[dtype]
    qkv = torch.randn(B, S, 3 * C, generator=gen, device=dev).to(dtype)
    mask = (torch.rand(B, S, generator=gen, device=dev) > 0.3).int()
    mask[:, 0] = 1
    dattn = torch.randn(B, S, C, generator=gen, device=dev).to(dtype)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(B, H, S, 3, device=dev, dtype=torch.float32)
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    g = torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
    dq, dk, dv = dqkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    att = torch.empty(B, S, C, device=dev, dtype=dtype)
    o = torch.empty(B, S, H, D, device=dev, dtype=dtype).transpose(1, 2)
    keep = (mask > 0)[:, None, None, :]
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = D ** -0.5

    def packed_fwd():
        rc = lib.rmcl_masked_attention_fwd(code, qkv.data_ptr(), mask.data_ptr(),
                                           att.data_ptr(), B, S, H, D, scale, stream)
        check(rc == 0, f"rmcl_masked_attention_fwd returned {rc}")

    def heads_fwd():
        rc = lib.rmcl_attention_fwd(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    *q.stride()[:3], mask.data_ptr(), o.data_ptr(),
                                    *o.stride()[:3], B, S, H, D, scale, stream)
        check(rc == 0, f"rmcl_attention_fwd returned {rc}")

    def packed():
        rc = lib.rmcl_masked_attention_bwd(code, qkv.data_ptr(), mask.data_ptr(),
                                           dattn.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
                                           B, S, H, D, scale, stream)
        check(rc == 0, f"rmcl_masked_attention_bwd returned {rc}")

    def heads():
        rc = lib.rmcl_attention_bwd(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    *q.stride()[:3], mask.data_ptr(), g.data_ptr(),
                                    *g.stride()[:3], dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                    *dq.stride()[:3], stats.data_ptr(), B, S, H, D, scale,
                                    stream)
        check(rc == 0, f"rmcl_attention_bwd returned {rc}")

    calls = {"rmcl_masked_attention_fwd": packed_fwd, "rmcl_attention_fwd": heads_fwd,
             "F.scaled_dot_product_attention": lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=keep),
             "rmcl_masked_attention_bwd": packed, "rmcl_attention_bwd": heads}
    if dtype == torch.float32:
        with torch.inference_mode(False), torch.enable_grad():
            qg, kg, vg, keep2, g2 = (t.clone() for t in (q, k, v, keep, g))
            for t in (qg, kg, vg):
                t.requires_grad_(True)
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep2)

        def sdpa_bwd():
            with torch.inference_mode(False), torch.enable_grad():
                return torch.autograd.grad(out, (qg, kg, vg), g2, retain_graph=True)
        calls["torch.autograd.grad of F.scaled_dot_product_attention"] = sdpa_bwd
        calls = {f"{name} fp32": run for name, run in calls.items()}
    return calls


def serving_times(dev, root: str) -> dict:
    """Phase 4's cell (task_finetune_vqa, 12 layers, bf16, u8 wire, batch 8)
    through the live Session of the package on the path, and through its
    artifact where the package has one (phase 23 (a)): batch-8 ms (median of
    EXPORT_TIMED, host clock + synchronize), requests/s (median of 5 runs of
    phase 4's 20 requests) and the device time of one batch-8 forward; and the
    host time of one bf16 ``attn_half`` call at B=8, S=269 (enqueue only)
    beside its launch alone (``_attn_fwd``), and of ``masked_attention`` at
    that shape without and with a graph."""
    from rmcl_tpu_torch import build_config, serve
    from rmcl_tpu_torch.ops import fused_block as FB
    from rmcl_tpu_torch.serve import Session, seeded_model
    x, mask, (lw, lb), (wq, bq, wp, bp), _, H = _block_inputs(dev)
    args = (x.bfloat16(), mask, lw, lb, wq.bfloat16(), bq, wp.bfloat16(), bp, H, 1e-6)
    with torch.inference_mode():
        res = {"attn_half host_us": host_us(lambda: FB.attn_half(*args)),
               "_attn_fwd host_us": host_us(lambda: FB._attn_fwd(*args, True))}
    # P's attention core at that shape: q, k, v views of one qkv buffer, as
    # the unfused block makes them, without and with a graph (the attack's)
    from rmcl_tpu_torch.ops.attention import masked_attention
    B, S, C = x.shape
    qkv = torch.randn(B, S, 3, H, C // H, device=dev).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    with torch.no_grad():
        res["masked_attention host_us"] = host_us(lambda: masked_attention(q, k, v, mask, 0.125))
    qg, kg, vg = qkv.requires_grad_(True).permute(2, 0, 3, 1, 4).unbind(0)
    res["masked_attention autograd host_us"] = host_us(
        lambda: masked_attention(qg, kg, vg, mask, 0.125))
    cfg = build_config(CONFIG)
    model = seeded_model(cfg, SEED)
    reqs = synthetic_requests(cfg, N_REQUESTS, SEED)
    full = {k: v[:BATCH] for k, v in reqs.items()}
    sessions = {"live": Session(cfg, model, "vqa", BATCH, dev)}
    if hasattr(serve, "export_inference"):
        art = serve.load_artifact(serve.export_inference(cfg, model, "vqa", BATCH,
                                                         device="cpu"), dev)
        sessions["artifact"] = serve.ArtifactSession(art, model.state_dict(), None,
                                                     serve.export_meta(cfg, "vqa", BATCH))
    for name, sess in sessions.items():
        sess.infer(reqs)                                       # warm-up
        ms, rps = _serving_times(sess, full, reqs)
        res[name] = dict(ms=ms, rps=rps, device_ms=device_ms(lambda: sess.forward(full)))
    return res


def attacked_step_ms(dev, mix: str = "realistic") -> float:
    """Wall ms of phase 13's attacked task_moco step (16 pairs, bf16, the
    fused greedy attack inside), median of 5 after a warm-up, host clock +
    synchronize."""
    _, _, batch, _, make_step = train_setup(dev, mix=mix)
    step, gen = make_step(), torch.Generator().manual_seed(SEED + 7)
    step(batch, gen)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def gemm_times(root: str) -> None:
    """Times of the GEMM sub-kernels of the package under ``root`` at the
    step's shapes (LN_GEMM_SUBS, GEMM_TN_SUBS), of the attention forward and
    backward through their C entry points at B=16, S=241, H=12, D=64 in bf16
    and fp32, and of the LayerNorm backward (_ln_bwd_dx, _ln_backward) and
    the column sums (_colsum) at M = 16 x 241, bf16: per
    call as phase 3 times them (time_ms), by device time and by host enqueue
    time, through the arguments every slice of the port has had, so that two
    versions compare in one run; then the attack's wall and device time
    under the default configuration and P, and the fp32 step's, with its
    attention kernels' device time; phase 4's serving cell (``serving_times``)
    and phase 13's attacked step (``attacked_step_ms``)."""
    sys.path.insert(0, root)
    from rmcl_tpu_torch.ops import _build
    from rmcl_tpu_torch.ops import fused_block as FB
    dev = torch.device("cuda", 0)
    lib = _build.library()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = {}
    with torch.inference_mode():
        for label, N, K, opts in LN_GEMM_SUBS:
            c = _ln_gemm_case(dev, FB, gen, N, K, opts)
            def run(c=c):
                FB._gemm(lib, c["a"], c["w"], c["bias"], c["out"], **c["kw"])
            res[f"ln_gemm[{label}]"] = (time_ms(run), device_ms(run), host_us(run))
            if label == "qkv":   # its LayerNorm pass alone, by kernel name
                res["ln_rows_kernel"] = (None, device_ms(run, kernel="ln_rows_kernel"), None)
        torch.backends.cuda.matmul.allow_tf32 = False
        for label, N, K, opts in LN_GEMM_SUBS:   # the fp32 FMA kernels, the same arguments
            c = _ln_gemm_case(dev, FB, gen, N, K, opts, torch.float32)
            def run(c=c):
                FB._gemm(lib, c["a"], c["w"], c["bias"], c["out"], **c["kw"])
            res[f"ln_gemm[{label}] fp32"] = (time_ms(run), device_ms(run), host_us(run))
        for B, S in LN_STATS_ROWS:   # the fp32 statistics pass alone, by kernel name
            c = _ln_gemm_case(dev, FB, gen, 2304, 768, "ln", torch.float32, B, S)
            def run(c=c):
                FB._gemm(lib, c["a"], c["w"], c["bias"], c["out"], **c["kw"])
            res[f"ln_stats_kernel[M={c['M']}] fp32"] = (
                None, device_ms(run, kernel="ln_stats_kernel"), None)
            def run(a=c["a"]):
                return torch.var_mean(a, -1, unbiased=False)
            res[f"torch.var_mean[M={c['M']}] fp32"] = (time_ms(run), device_ms(run),
                                                       host_us(run))
        M = PGD_BATCH * 241
        for label, Na, Nb in GEMM_TN_SUBS:
            a, b = (torch.randn(M, n, generator=gen, device=dev) for n in (Na, Nb))
            def run(a=a, b=b):
                return FB._gemm_tn(lib, a, b)
            res[f"gemm_tn[{label}] fp32"] = (time_ms(run), device_ms(run), host_us(run))
        for label, Na, Nb in GEMM_TN_SUBS:
            a = torch.randn(M, Na, generator=gen, device=dev).bfloat16()
            b = torch.randn(M, Nb, generator=gen, device=dev).bfloat16()
            def run(a=a, b=b):
                return FB._gemm_tn(lib, a, b)
            res[f"gemm_tn[{label}]"] = (time_ms(run), device_ms(run), host_us(run))
            slabs = lib.rmcl_gemm_tn_slabs(1, M, Na, Nb)
            if slabs > 1:   # its slab sum alone, by kernel name, and torch's sum of the slabs
                res[f"split_sum_kernel[{label}, {slabs} slabs]"] = (
                    None, device_ms(run, kernel="split_sum_kernel"), None)
                part = torch.randn(slabs, Na, Nb, generator=gen, device=dev)
                def run(part=part):
                    return part.sum(0)
                res[f"partial.sum(0)[{label}]"] = (time_ms(run), device_ms(run), host_us(run))
        for dtype in (torch.bfloat16, torch.float32):   # fp32: TF32 is off (above)
            for name, run in _attention_calls(dev, lib, gen, dtype).items():
                res[name] = (time_ms(run), device_ms(run), host_us(run))
        from rmcl_tpu_torch.models.vit import VIT_LN_EPS
        c = _ln_bwd_case(dev, gen, torch.bfloat16)
        for form in LN_BWD_FORMS:
            run = _ln_bwd_calls(FB, lib, c, form, VIT_LN_EPS)[0]
            res[f"ln_bwd[{form}]"] = (time_ms(run), device_ms(run), host_us(run))
        for N in COLSUM_WIDTHS:
            a = (torch.randn(M, N, generator=gen, device=dev) + 0.5).bfloat16()
            def run(a=a):
                return FB._colsum(lib, a)
            res[f"colsum[{N}]"] = (time_ms(run), device_ms(run), host_us(run))
        # the yardstick of ln_rows_kernel (the bf16 LayerNorm pass of ln_gemm[qkv]):
        # F.layer_norm on (M, 768) rows, bf16 parameters
        x, lw, lb = c["x"], c["ln_w"].bfloat16(), c["ln_b"].bfloat16()
        def run():
            return torch.nn.functional.layer_norm(x, (x.shape[1],), lw, lb, VIT_LN_EPS)
        res["F.layer_norm"] = (time_ms(run), device_ms(run), host_us(run))
        from rmcl_tpu_torch.ops import fused_block_train as FT
        seeds = torch.randint(-2 ** 31, 2 ** 31, (PGD_BATCH,), generator=gen, device=dev).int()
        for N in (768, 3072):   # drop_scale at the residual's and the MLP hidden's widths
            g2d = torch.randn(M, N, generator=gen, device=dev).bfloat16()
            def run(g2d=g2d):
                return FT._drop_scale(lib, g2d, (seeds, 241, 0, DROP_P, None))
            res[f"drop_scale[{N}]"] = (time_ms(run), device_ms(run), host_us(run))
    for name, (ms, dms, hus) in res.items():
        print(f"[gemm-times] {root} {name}: kernel_ms={ms!r} device_ms={dms!r} "
              f"host_us={hus!r}")
    dms = [res[f"colsum[{N}]"][1] for N in BIAS_GRADS]
    print(f"[gemm-times] {root} colsum, the four bias gradients of a step: device_ms="
          f"{sum(dms) if None not in dms else None!r}")
    attacks = {}
    for config in ("default", "P"):
        attacks[config] = attack_times(dev, config)
        print(f"[gemm-times] {root} attack {config}: wall_ms={attacks[config][0]!r} "
              f"device_busy_ms={attacks[config][1]!r}")
    step32 = fp32_step_times(dev)
    share = sum(step32[2].values()) / step32[1]
    print(f"[gemm-times] {root} fp32 task_moco step ({PGD_BATCH} pairs, 12 layers, "
          f"unattacked): wall_ms={step32[0]!r} device_busy_ms={step32[1]!r}; its fp32 attention "
          f"kernels' device ms {step32[2]}, {share:.4f} of the busy time")
    serving = serving_times(dev, root)
    for name, r in serving.items():
        print(f"[gemm-times] {root} serving {name}: {r!r}")
    attacked = attacked_step_ms(dev)
    print(f"[gemm-times] {root} attacked task_moco step ({PGD_BATCH} pairs, bf16, realistic "
          f"captions): wall_ms={attacked!r}")
    print(json.dumps({"root": root, "times": res, "attacks": attacks, "fp32_step": step32,
                      "serving": serving, "attacked_step_ms": attacked}))


def main() -> int:
    if sys.argv[1:2] == ["--gemm-times"] and len(sys.argv) <= 3:
        try:
            phase_device()
            gemm_times(sys.argv[2] if len(sys.argv) == 3 else ".")
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --gemm-times: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    if sys.argv[1:] == ["--profile"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            phase_device()
            phase_build()
            phase_profile(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --profile: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    if sys.argv[1:] == ["--downstream"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            counts = phase_downstream(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --downstream: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "launches_by_path": counts}))
        return 0
    if sys.argv[1:] == ["--pretrain"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            counts = phase_pretrain(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --pretrain: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "launches_by_path": counts}))
        return 0
    if sys.argv[1:] == ["--views"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            counts = phase_views(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --views: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "launches_by_path": counts}))
        return 0
    if sys.argv[1:2] == ["--ddp-rank"] and len(sys.argv) == 3:
        try:
            return ddp_rank_main(sys.argv[2])
        except Exception as e:  # noqa: BLE001  the launcher kills the other rank
            traceback.print_exc()
            print(f"chip_smoke --ddp-rank: FAILED: {e}", file=sys.stderr)
            return 1
    if sys.argv[1:] == ["--ddp"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            counts = phase_ddp(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --ddp: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "launches_by_path": {"ddp": counts}}))
        return 0
    if sys.argv[1:2] == ["--tp-rank"] and len(sys.argv) == 3:
        try:
            return tp_rank_main(sys.argv[2])
        except Exception as e:  # noqa: BLE001  the launcher kills the other rank
            traceback.print_exc()
            print(f"chip_smoke --tp-rank: FAILED: {e}", file=sys.stderr)
            return 1
    if sys.argv[1:] == ["--tp"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            tp = phase_tp(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --tp: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "kernels": tp_records(tp)}))
        return 0
    if sys.argv[1:] == ["--export"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            counts = phase_export(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --export: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "launches_by_path": counts}))
        return 0
    if sys.argv[1:] == ["--rest"]:
        try:
            from rmcl_tpu_torch import build_config  # noqa: F401
            card = phase_device()
            phase_build()
            counts = phase_rest(torch.device("cuda", 0))
        except Exception as e:  # noqa: BLE001  any failure ends the run
            traceback.print_exc()
            print(f"chip_smoke --rest: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "launches_by_path": counts}))
        return 0
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py [--profile | --gemm-times [ROOT] | "
              "--downstream | "
              "--pretrain | --views | --rest | --ddp | --tp | --export]", file=sys.stderr)
        return 2
    try:
        from rmcl_tpu_torch import build_config
        from rmcl_tpu_torch.serve import seeded_model
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 1
    t_start, marks = time.perf_counter(), []    # marks: (phase, its start)

    def enter(name: str) -> str:
        marks.append((name, time.perf_counter()))
        return name

    phase = enter("device")
    try:
        phase_device()
        dev = torch.device("cuda", 0)
        phase = enter("build")
        phase_build()
        phase = enter("kernels")
        kres = phase_kernels(dev)
        phase = enter("serving")
        cfg = build_config(CONFIG)
        model = seeded_model(cfg, SEED)
        cpu_state = copy.deepcopy(model.state_dict())
        reqs = synthetic_requests(cfg, N_REQUESTS, SEED)
        sess, counts = phase_serving(cfg, model, reqs, dev)
        phase = enter("slice")
        vqa_cpu32, vqa_gpu32 = phase_slice(cfg, cpu_state, sess, reqs, dev)
        del sess, model
        phase = enter("pgd")
        pgd_cfg, pgd_state, pgd_counts = phase_pgd(dev)
        phase = enter("pgd slice")
        phase_pgd_slice(pgd_cfg, pgd_state, cfg, vqa_cpu32, vqa_gpu32, dev)
        del vqa_cpu32, vqa_gpu32
        phase = enter("train")
        train_counts = {"default": phase_train(dev)[0]}
        phase = enter("train slice")
        slice_counts = {"default": phase_train_slice(dev)}
        for config in ("P", "F"):
            phase = enter(f"train {config}")
            train_counts[config] = phase_train(dev, config)[0]
        for config in ("P", "F"):
            phase = enter(f"train slice {config}")
            slice_counts[config] = phase_train_slice(dev, config)
        phase = enter("greedy")
        greedy_counts = phase_greedy(dev)
        attacked_counts, bare = {}, {}
        for mix in GREEDY_MIXES:
            phase = enter(f"train attacked {mix}")
            attacked_counts[mix], bare[mix] = phase_train(dev, mix=mix)
        phase = enter("train attacked slice")
        phase_train_attacked_slice(dev)
        phase = enter("trainer")
        trainer_counts = phase_trainer(dev, bare[TRAINER_MIX])
        bt_counts, bt_bare = {}, {}
        for mix in GREEDY_MIXES:
            phase = enter(f"bt attacked {mix}")
            bt_counts[mix], bt_bare[mix] = phase_bt(dev, mix)
        phase = enter("bt attacked slice")
        phase_bt_slice(dev)
        phase = enter("bt trainer")
        bt_trainer_counts = phase_trainer_bt(dev, bt_bare[TRAINER_MIX])
        phase = enter("downstream")
        ds_counts = phase_downstream(dev)
        phase = enter("pretrain")
        pre_counts = phase_pretrain(dev)
        phase = enter("views")
        views_counts = phase_views(dev)
        phase = enter("rest")
        rest_counts = phase_rest(dev)
        phase = enter("ddp")
        ddp_counts = phase_ddp(dev, bare["worst"])
        phase = enter("tp")
        tp = phase_tp(dev)
        phase = enter("export")
        export_counts = phase_export(dev)
    except Exception as e:  # noqa: BLE001  every phase failure ends the run
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}: {e}", file=sys.stderr)
        return 1
    t_end = time.perf_counter()
    ends = [t for _, t in marks[1:]] + [t_end]
    print(f"[done] seconds by phase: "
          f"{ {name: round(e - t, 1) for (name, t), e in zip(marks, ends)} }")
    print(f"[done] every phase passed in {t_end - t_start:.1f} s")
    # the main path: python -m rmcl_tpu_torch.cli.run with task_moco, the
    # Trainer around the attacked step (default blocks), validation included
    main_path = trainer_counts

    def by_path(name):
        return {"serving": counts.get(name, 0), "pgd": pgd_counts[name],
                **{f"train_{c}": n[name] for c, n in train_counts.items()},
                "greedy": greedy_counts["worst"][name],
                "greedy_realistic": greedy_counts["realistic"][name],
                "train_attacked": attacked_counts["worst"][name],
                "train_attacked_realistic": attacked_counts["realistic"][name],
                "trainer": trainer_counts[name],
                "bt_attacked": bt_counts["worst"][name],
                "bt_attacked_realistic": bt_counts["realistic"][name],
                "bt_trainer": bt_trainer_counts[name],
                **{f"downstream_{k}": v[name] for k, v in ds_counts.items()},
                **{k: v[name] for k, v in pre_counts.items()},
                **{k: v[name] for k, v in views_counts.items()},
                **{f"rest_{k}": v[name] for k, v in rest_counts.items()},
                "ddp": ddp_counts[name], "tp": tp["counts"][name],
                **{k: v.get(name, 0) for k, v in export_counts.items()}}

    records = []
    for name, replaces in KERNELS.items():
        r = kres[name]
        dx, train, new = name.endswith("_dx"), name in TRAIN_OPS, name in CONFIG_OPS
        main = (r[f"bf16_p{DROP_P}"] if train else r["bf16_saved"] if dx else r["bf16"])
        # the main path's launches: the attacked step, or for an op of another
        # block configuration the step of the configuration that takes it
        path = ("F" if name.startswith("attn_half_full") or name == "dropout" else
                "P" if name.startswith("masked_attention") else None)
        rec = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
               "launches": (train_counts[path] if path else main_path)[name],
               "launches_by_path": by_path(name),
               "max_abs_err": main["err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r.get("library_ms"),
               "shape": "B=8 S=269" if not (dx or train or new) else "B=16 S=241"}
        rec.update(fp32_bound_ms=r["fp32_bound_ms"], fp32_bound_by=r["fp32_bound_by"])
        if train:
            rec.update(p=DROP_P, fp32_ms=r[f"fp32_p{DROP_P}"]["ms"],
                       fp32_plain_ms=r[f"fp32_p{DROP_P}"]["plain_ms"],
                       worst_error_over_tolerance=main["worst"])
        elif new:
            rec.update(fp32_ms=r["fp32"]["ms"], fp32_plain_ms=r["fp32"]["plain_ms"],
                       **{f"fp32_{f}": r.get(f"fp32_{f}") or r["fp32"].get(f)
                          for f in ("device_ms", "library_ms", "library_device_ms")},
                       library=("F.scaled_dot_product_attention" if name == "masked_attention"
                                else "torch.autograd.grad of F.scaled_dot_product_attention"
                                if name == "masked_attention_bwd" else None))
            if name == "dropout":
                rec["shape"] = "B=16 S=241 N=3072"
        elif dx:   # the path's default keeps qkv / h; the recomputing variant beside it
            rec.update(variant="saved", recompute_ms=r["bf16_recompute"]["ms"],
                       recompute_plain_ms=r["bf16_recompute"]["plain_ms"],
                       recompute_max_abs_err=r["bf16_recompute"]["err"],
                       recompute_bound_ms=r["recompute_bound_ms"])
        else:
            rec.update(pgd_shape_ms=r["bf16_pgd_shape"]["ms"],
                       pgd_shape_plain_ms=r["bf16_pgd_shape"]["plain_ms"],
                       pgd_shape_bound_ms=r["pgd_shape_bound_ms"])
        if "bf16_demo_shape" in r:   # demos/demo.py's B = 1, S = 402
            rec.update({f"{t}demo_shape_{f}": r[f"{t or 'bf16_'}demo_shape"][k]
                        for t in ("", "fp32_") for f, k in (
                            ("ms", "ms"), ("device_ms", "device_ms"), ("plain_ms", "plain_ms"),
                            ("max_abs_err", "err"), ("bound_ms", "bound_ms"))},
                       demo_shape=f"B=1 S={DEMO_S}")
        if "bf16_greedy_shape" in r:
            rec.update(greedy_shape=f"B={GREEDY_ROWS} S={GREEDY_S}",
                       greedy_shape_ms=r["bf16_greedy_shape"]["ms"],
                       greedy_shape_plain_ms=r["bf16_greedy_shape"]["plain_ms"],
                       greedy_shape_max_abs_err=r["bf16_greedy_shape"]["err"],
                       greedy_shape_bound_ms=r["greedy_shape_bound_ms"])
        records.append(rec)
    subs = {r["name"]: r for r in kres["sub_kernels"]}
    for name, replaces in GEMM_KERNELS.items():   # the GEMMs under every op above
        r = subs[f"{name}[{GEMM_HEADLINE[name]}]"]
        records.append({
            "name": name, "route": "cuda", "source": GEMM_SOURCE, "replaces": replaces,
            "launches": main_path[name], "launches_by_path": by_path(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library": r["library"], "shape": r["shape"],
            "instances": {k: v["ms"] for k, v in subs.items()
                          if k.startswith(name + "[") and v.get("dtype") != "fp32"},
            **{f"fp32_{f}": f32[f] for f32 in [subs[f"{name}[{GEMM_HEADLINE[name]}] fp32"]]
               for f in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library",
                         "library_ms", "library_device_ms")},
            "fp32_instances": {k: {f: v.get(f) for f in ("device_ms", "bound_ms",
                                                         "library_device_ms", "slabs")}
                               for k, v in subs.items()
                               if k.startswith(name + "[") and "ms" in v
                               and v.get("dtype") == "fp32"}})
        if name == "ln_gemm":   # its fp32 statistics pass, launched by the fp32 steps
            records[-1]["fp32_ln_stats"] = {
                "kernel": "ln_stats_kernel", "source": SOURCE,
                "launches": {f"train_slice_{c}": n["ln_stats"] for c, n in slice_counts.items()},
                **{k: {f: v[f] for f in ("device_ms", "plain_ms", "library", "library_ms",
                                         "library_device_ms", "bound_ms", "bound_by",
                                         "max_abs_err")}
                   for k, v in subs.items() if k.startswith("ln_stats[")}}
    f32a = subs[f"attention f32 B={PGD_BATCH} S=241 H=12 D=64"]
    d96 = {t: subs[f"attention d96 {t}"] for t in ("bf16", "fp32")}
    for name, part, body in (("attention_fwd", "fwd", "attn_half"),
                             ("attention_bwd", "bwd", "attn_half_dx")):
        # the bf16 kernels under rows 1, 8, 2 and 10 (forward), 3, 9, 2 and 11
        # (backward); their fp32 counterparts (simt_attention.cuh) beside them,
        # launched by the fp32 steps of phases 9 and 11
        r, f = subs[name], f32a[part]
        records.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": KERNELS[body], "launches": main_path[name],
            "launches_by_path": by_path(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
            "library": r["library"], "shape": r["shape"],
            "fp32_source": F32_ATTN_SOURCE,
            "fp32_launches": {f"train_slice_{c}": n[name] for c, n in slice_counts.items()},
            "fp32_max_abs_err": {sh: v["max_abs_err"] for sh, v in subs.items()
                                 if sh.startswith("attention f32")},
            **{f"fp32_{k}": f[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                            "bound_by", "library", "library_ms",
                                            "library_device_ms")},
            "d96": {t: dict(d96[t][part], shape=d96[t]["shape"],
                            max_abs_err=d96[t]["max_abs_err"]) for t in d96}})
    small = {f"{r['name']} {r['dtype']}": r for r in kres["sub_kernels"]
             if r["name"].startswith(("ln_bwd", "colsum"))}
    for name, head in (("ln_bwd", "ln_bwd[train] bf16"), ("colsum", "colsum[3072] bf16")):
        r = small[head]   # LN_COLSUM_KERNELS: the Pallas bodies whose sums they carry
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": LN_COLSUM_KERNELS[name][0], "replaces_parts": LN_COLSUM_KERNELS[name][1],
            "launches": main_path[name], "launches_by_path": by_path(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
            "library": r["library"], "shape": r["shape"],
            "instances": {k: {f: v[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "library_ms", "max_abs_err")}
                          for k, v in small.items() if k.startswith(name + "[")}})
    records += tp_records(tp)      # Queue B row 14: the forward halves at the shard shapes
    print(json.dumps({"kernels": records, "shard_shapes": kres["shard_shapes"],
                      "sub_kernels": kres["sub_kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
