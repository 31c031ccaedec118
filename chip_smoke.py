"""Drive the PyTorch/CUDA port (``moc_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. build: compile every kernel under ``moc_tpu_torch/ops/csrc`` with nvcc,
   one process per source, all started together, print each kernel's
   registers and spills from ``-Xptxas -v`` (a spill fails the run), and
   check that every tensor-core kernel (K2, K3 and K4, each in bf16 and in
   f32, three TF32 passes) was built at D 32, 64 and 128;
2. K1 parity: exact top-k membership bit-equal to its plain PyTorch version
   on the card, with exactly k True per row, row and column entries: 96
   base cases (random, tie-heavy, ±0.0 and NEG_INF-padded keys with k above
   the valid count, N in {1000, 16384, 131072}, k in {1, 10, 400, N}), then
   every cluster size and the streaming path the launcher picks: N in
   {1000, 1500, 4096, 16384, 65536, 131072, 400000 (past what a cluster of
   8 stages)}, R in {1, 2, 5, 40}, random keys at k = 10 and k = N, ties at
   v_k spread over every CTA of a cluster with the fill short of them, ties
   equal to the fill, all-equal rows; columns of a non-contiguous and a
   contiguous [2, N, 6], one launch a call;
3. K2 parity: the flash-attention forward against ``mha_reference`` on the
   card (O and lse), f32 within 2e-5 and within 1e-5 of the largest |O|,
   bf16 within 2e-2 and a mean |O - plain| at most 1% of the mean |O|, over
   D 32/64/128,
   L 785 (ragged) and 1024, causal and not, segment ids with rows that match
   no key (non-causal) or packed sequences (causal), and the
   ``flash_attention_padded`` ``padding_mask`` path;
4. serving: synthetic ``.pt`` bags at the reference operating point (D=512,
   C=2, C_ext=6, topj=400, topk=10, batch 8, the 16384 bucket) drained
   through ``cli.serve.watch_once`` by a ``Server`` on ``cuda``: every slide
   gets a row with finite probabilities summing to 1, K1 launches once per
   batch on each entry, the pooled logits match the same server on the CPU
   (rtol 1e-4, atol 1e-5: cuBLAS and the CPU sum the 512-wide products in
   another order), and the GPU's selection and pooling masks are bit-equal to
   the plain version fed the GPU's own logits; then K1's times per call
   (CUDA events around the wrapper) and kernel-only (``torch.profiler``)
   against its bound, its plain version and ``torch.topk`` plus a scatter,
   at the serving shapes, the training shapes [5, 4096] k=400 and [2, 4096]
   k=10 and the largest bucket [40, 131072], the batch-8 forward latency and
   a ``torch.profiler`` breakdown of it;
5. extraction: a release-layout CONCH checkpoint fabricated at full width
   from a seed, two raw-pixel ``.npz`` patch bags of 256 px patches (600 and
   424 patches) through ``cli.extract_features.main --flash --batch_size 64
   --out_format pt`` on ``cuda``: both bags of unit-norm 512-d rows, K2
   launched 12 x 17 times, the dense path on the card and the CPU agreeing
   within 1e-4; the same run with ``--bf16`` (K2 in bf16, 204 launches);
6. end to end: the extracted bags served by ``watch_once`` (nsclc, seeded
   SENet, synthetic D=512 weights) to finite probability rows, K1 launched;
7. times: K2 at [64, 12, 785, 64] and [32, 12, 512, 64] in f32 and bf16,
   and at MUSK-large's vision [64, 16, 577, 64] and text [176, 16, 100, 64]
   shapes (the text's padding as segment ids, the library given the same
   mask), first held against ``mha_reference`` on the same tensors (O and
   lse, the tolerances of 3),
   then per launch against its bound, its plain version and
   ``scaled_dot_product_attention`` (timed only), kernel-only by the
   profiler and queued behind a spin, the batch-64
   ``encode_image`` forward in four tiers (f32/bf16, dense/flash), and a
   ``torch.profiler`` breakdown of the f32 flash forward;
8. K3/K4 parity: the flash-attention backward (dq; dk and dv) against
   ``flash_bwd_reference`` on the card over the grid of 3 (f32 within 5e-4
   and within 1e-5 of the largest |grad|, bf16 within 2e-2 of the largest
   |grad| and a mean error at most 1% of the mean |grad|), on K2's own o
   and lse;
9. pretraining: ``cli.pretrain.main --device cuda`` at the BEiT-3-base
   width (12 layers of 768, FFN 3072, 12 heads of 64, sequence 512, batch
   32, vocab 1024, 5 steps) in f32 and with ``--compute_dtype bfloat16``:
   every loss finite, K2, K3 and K4 launched exactly 12 x 5 times each; then
   a 2-layer run at the CLI's default width (256, 8 heads of 32) from one
   state dict and one ``data_fn`` on the card and on the CPU: first-step
   gradients within 1e-4 of each parameter's largest |grad| (the key
   biases, whose gradient is rounding noise, aside), three steps' losses
   within 1e-4 and parameters within 3 lr;
10. times: K3 and K4 at [32, 12, 512, 64] in f32 and bf16, first held
   against ``flash_bwd_reference`` on the same tensors, then per launch
   against their bounds, the plain version and the backward of
   ``scaled_dot_product_attention`` (timed only; K3 + K4 together),
   kernel-only by the profiler and queued behind a spin; K2 and
   the library's forward at that shape; the full-width pretrain step by
   CUDA events (median) and tokens/s in f32 and bf16, and a
   ``torch.profiler`` breakdown of one step in each;
11. MOC training: ``cli.main_moc.main`` on ``cuda`` at the JAX CLI's
   full-width synthetic protocol (D=512, C=2, C_ext=6, topj=400, topk=10,
   shot 8, fold 0, 16 slides a class, bags of 1500-4000 patches, 25 epochs
   of 16 per-slide Adam steps, seed 0): every loss finite, the JAX
   package's result keys, test AUC at best val at least 0.8, K1 launched
   exactly 2 x 16 x 25 times by the training steps (counted around each
   ``train_epoch``), the saved ``.msgpack`` served by ``cli.serve.watch_once``
   matching ``eval_batch`` on the test bags within 1e-5; one epoch on the
   card against the CPU from one SENet and one set of keep masks
   (first-step gradients within 1e-5 of each largest |grad|, losses within
   1e-5, parameters within Adam's bound of lr a step) and K1 on keys that
   require grad; then the slide step by CUDA events on the gather and the
   masked route, with a ``torch.profiler`` breakdown of each, the epoch and
   episode walls and slide steps/s. K1 is also timed at the gather route's
   pooling columns, [2, 2432] k=10, in phase 4;
12. the fused sweep: ``cli.sweep.main --mode fused`` on ``cuda`` over all five
   folds of shot 8 at the protocol of 11, on its corpus: five
   ``best_results_*.json`` with the JAX package's keys, five
   ``zs_results_*.json`` and ``.msgpack`` files and ``summary_8.csv``; test AUC
   at best val at least 0.8 in every fold, every step's losses finite, K1
   launched exactly 2 x 16 x 25 times by the batched steps (counted around
   each ``sweep_step``), fold 0 equal to ``main_moc``'s fold 0 (the same best
   epoch, AUCs and accuracy within 1e-5); the sweep's wall and episodes/hour
   beside five ``main_moc`` episodes; the batched step (E = 5) by CUDA events
   with a profile, the eval packs and the trajectory's logits; and K1 at the
   sweep's shapes: selection rows [25, 4096] k=400, pooling columns
   [5, 2432, 2] and the trajectory's [1500, 2432, 2] k=10, and the eval
   packs' rows [300, 4096] k=400;
13. selection and pooling, between 11's parity and its times, on 11's corpus:
   ``union_selection`` and ``select_and_gather(method="sort")`` on the card
   bit-equal to the CPU on the card's own logits at the serving point and
   the training bucket, on tie-heavy logits and on signed zeros, where the
   threshold union parts from the sort union (and on real logits does not);
   all ten pooling families, ``return_indices`` both ways and the bottom-k
   ones with ``detection`` both ways, on the train split's zero-shot logits
   against the CPU (pooled values within 1e-6, indices equal, K1's masks at
   [16, 4096, 1] and [16, 4096, 2] bit-equal to plain, K1 launched only on
   the foreground families' mask route); ``cli.main_moc.main --select_method
   sort`` at 11's protocol with losses within 1e-6 of 11's threshold run,
   the same test AUC at best val, and no K1 row launch in its training
   steps; the zero-shot floor of every ``zs_pooling`` family on every split,
   card against CPU (equal AUC and accuracy, pooled logits within rtol
   1e-4); the sort union against the threshold union at the serving point
   (CUDA events and a profile of each) and ``select_and_gather`` of one
   training visit, and K1's column entry at the zero-shot floor's shapes;
14. zero-shot (``[zeroshot]``): a release-layout CONCH checkpoint fabricated
   at full width from seed 3 (text tower: 12 layers of 768, 12 heads,
   context 128, vocabulary 32007, output 512) loaded by ``load_conch`` on
   the card and on the CPU; ``W`` and ``W_ext`` of the vendored nsclc and
   rcc banks (176 and 220 prompts, hash vocabulary) built on both within
   1e-5, with the TF32 flags off at every text forward on the card; K1's
   column masks at MI-Zero's shapes ([16, 4096, 2], 1500-4000 valid rows,
   k in {1, 5, 10, 50, 100}) bit-equal to the plain version and timed;
   ``run_mizero`` over 16 slides (D = 512, nsclc's ``W``) on the card
   against the CPU (pooled logits within 1e-6, predictions and metrics
   equal, K1 launched once a j a batch); ``cli.main_moc.main --dataset
   nsclc`` on a data root of ``.pt`` bags only (the vendored table and
   1-shot split 0: 2 train, 50 val, 208 test bags of 500-2000 patches),
   building its weight caches from the vendored banks (result files, finite
   losses, K1 launched twice a training step), then again from the caches
   with a checkpoint path that does not exist (cache bytes unchanged).
15. serving tiers (``[tiers]``), on 4's corpus: ``cli.serve`` at every tier
   (exact f32; ``--dense``; ``--score_dtype bfloat16``; ``--storage_dtype``
   bfloat16 and int8; ``--dense --storage_dtype int8``) draining the 16
   slides through ``watch_once`` on the card and on the CPU: pooled logits
   within rtol 1e-4 / atol 1e-5 (bf16 scoring: each slide's union overlap
   card/CPU above 0.95, the views of the rows both select within that
   bound, and the logits held where no row moved), K1 launched once on the rows and once
   on the columns a batch (the dense tiers: on the columns only), K1's
   union and pooling masks bit-equal to plain on the card's own keys, the
   int8 product (``torch._int_mm``) equal to the CPU's; the forward by CUDA
   events with a profile, and ``pack_bags`` (native packer asserted) with
   the bytes it copies, beside the pad step through the native packer and
   through numpy; then ``cli.predict.main`` over the corpus with rows equal
   to the exact tier's served rows, and the port's ``.msgpack`` of the
   SENet served with the ``.pt``'s rows.

16. MUSK (``[musk]``, after 7): MUSK-large fabricated at full width in the
   release layout (24 multiway layers of 1024, FFN 4096, 16 heads, 384 px,
   vocabulary 64010; 673M parameters), saved in half precision under
   ``{"model": ...}`` and read by ``load_musk`` on the card and the CPU;
   the batch-64 vision forward in f32 and bf16 by CUDA events with a
   profile (busy share, K2's share; K2 launched 24 times a forward), two
   images' f32 embeddings within 1e-4 of the CPU, bf16 against f32 by the
   least cosine (above 0.98); the text tower over the nsclc banks (176
   prompts, hash tokenizer, padding as segments) with 16 rows within 1e-4
   of the CPU, and one mixed call against the CPU on every real token;
17. ResNet-50 (``[resnet]``): a fabricated torchvision-layout file (random
   BatchNorm statistics, ``layer4`` and ``fc`` included) read by
   ``load_resnet50``; the batch-64 trunk at 256 px in f32 and bf16 with
   TF32 off, 8 images within 1e-4 of the CPU;
18. extraction beyond CONCH (``[extract]``): ``cli.extract_features.main``
   with ``--backbone musk`` (16's file), ``resnet50`` (17's) and ``debug``
   over three ``.npz`` bags of 256 px patches (160, 90 and 3), and
   ``resnet50`` with ``--wsi_dir`` over two PNG slides and coords-only bags
   (a 256 px grid and crops past the edges): bags of the backbone's width,
   finite and (but ResNet-50's) unit-norm, K2 launched 24 times a MUSK
   batch, the small slide's rows within 1e-4 of a CPU run, images/s of the
   host wall.

19. MIL baselines (``[mil]``, after 12, on 11's corpus): ``cli.train_mil.main``
   on ``cuda`` for every single-scale head (CLAM-SB, CLAM-MB, ABMIL, MIL-fc,
   TransMIL, CHIEF, TITAN) at the conch width (D = 512), shot 8, fold 0, 3
   epochs of 16 slide steps: the JAX package's result keys, finite AUCs,
   the ``.msgpack`` beside each JSON; ``--folds 0 1 2 3 4 --fused`` for
   CLAM-SB and TransMIL with ``<model>_summary_8.csv``; each head on the card
   against the CPU from one initial state, dropout off (first-step
   gradients within 1e-5 of the largest |grad|, one epoch's step losses
   within 1e-5: all 16 train slides, or the 4 shortest for TransMIL and
   TITAN); the B = 1 slide step of each head by CUDA events with a profile
   (busy share, kernels a step); ``cli.predict``'s MIL path over each
   trained ``.msgpack`` at batch 8 on the 16384 bucket in f32 and bf16
   storage (forward by CUDA events, a profile, two slides' rows within rtol
   1e-4 of the CPU, TITAN's on their first 2048 patches); one ``cli.serve
   --model_kind mil`` drain of CLAM-SB's ``.msgpack``; K1-K4 launched no
   time on the MIL path (``launches_mil`` in the kernel records).
20. ViLa-MIL (``[vila]``, after 19, on its corpus): ``cli.train_mil.main
   --model_type vila`` on ``cuda`` over the corpus at two scales (the large
   scale written beside it: three quarters of each bag's rows, reordered,
   with noise; 1500-4000 patches) with a fabricated release-layout CONCH
   checkpoint (text tower 12 layers of 768, 12 heads, 128 tokens), 2 epochs:
   JAX's result keys, finite AUCs, K1-K4 launched no time (ViLa is dense);
   the step by CUDA events with a profile; a 2-layer text tower of that
   width on the card against the CPU (first-step gradients within 1e-5 of
   the largest |grad| or 4x the CPU's own float32 distance, a TF32 step as
   the control that limit must catch), the trained and a seeded model's
   logits within 1e-5 of the largest |logit|;
21. (MoE-)LoRA (``[lora]``): ``cli.lora_finetune.main`` on ``cuda`` at
   CONCH's trunk (448 px, patch 16, 12 layers of 768, 12 heads), rank 4 with
   1 and 4 experts: JAX's files and keys; the slide step (16 patches) by
   CUDA events with its peak memory and a profile; the flash trunk against
   the dense one at [8, 12, 785, 64] f32 (logits within 1e-5 of the largest,
   gradients within 1e-5 of the largest |grad|), K2, K3 and K4 launched 12
   times each, counted around it (``launches_lora_flash``); both trunks
   cast to bf16, the flash one (12 bf16 launches each) against the dense one
   at the bf16 K2-K4 limits; a 2-layer trunk of that width on the card
   against the CPU (with TF32 on as the control the float32 limit must
   catch), and the trained and a seeded model's logits;
22. the CLIP adapters (``[adapters]``): ``ClipAdapter``, ``TipAdapter``,
   ``MoEClipAdapter`` (switch gate, balance loss), ``AMUAdapter`` and
   ``zero_shot_pooled`` on a [16384, 512] bag, C = 2, top-j 10, forward and
   backward on the card against the CPU (within 1e-5), K1's column entry
   launched once a pooling, AMU twice (``launches_adapters``); each by CUDA
   events, and K1 at [16384, 2] k=10;
23. chunked-bag accumulation (``[accum]``): ``streaming_attention_pool`` on
   [16384, 512] in chunks of 2048, with and without remat, card against CPU;
24. MUSK's contrastive step (``[musk_contrastive]``, after 16, on its
   checkpoint): ``make_musk_contrastive_step`` on MUSK-large, 8 images at 384
   px and 8 padded texts of 100 tokens, 3 steps: finite losses, K2, K3 and K4
   48 launches a step, peak memory; 2 layers against the CPU;
25. MoE pretraining (``[moe]``): ``cli.pretrain.main --moe_experts 8
   --moe_freq 2`` at the BEiT-3-base width, batch 8 x 1024, vocab 8192, in f32
   and with bf16 compute and bf16 parameters: K2-K4 12 a step, step times,
   tokens/s, peak memory, the dropped share of top-2 choices;
26. dilated attention (``[dilated]``): [1, 8192, 12, 64] (segments
   2048/4096/8192, ratios 1/2/4) and a pad-corrected case (L = 8000, ratios
   1/2/6) on K2-K4 against the plain route, and a 12-layer dilated pretrain
   step at 1 x 8192 with and without remat (launches counted);
27. encoder options (``[encoder_options]``): 2-layer encoders of BEiT-3-base
   width with xPos, the relative bias, remat and MoE, card against CPU, MoE
   routing on the same gate logits bit for bit;
28. K2-K4 at this slice's shapes (``[times]``, ``SLICE_SHAPES``) against
   their plain versions, bounds and ``scaled_dot_product_attention``;
29. the caption decoder and RetNet (``[decoder]``, after 14, on its CONCH
   checkpoint): ``generate_caption`` greedy and beam 4 at CONCH's width over
   the vision tower's caption tokens, 2 layers against the CPU, RetNet's
   three forms at L = 2048.

The last lines are the card's name and power limit, one JSON object of
kernel records, and ``{"ok": true, "device": {...}}``. No phase falls back
to the CPU: without a GPU, or without the port beside it, the script fails.
"""

from __future__ import annotations

import csv
import dataclasses
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the reference operating point (bench.py): one batch of 8 bags in the
# 16384 bucket, CONCH width, NSCLC's 2 tumor + 4 normal-tissue classes
DIM, N_CLASSES, N_EXT, TOPJ, TOPK, BATCH, N_PAD = 512, 2, 6, 400, 10, 8, 16384
N_SLIDES = 16  # two batches
MIN_PATCHES, MAX_PATCHES = 12000, 16384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
# the least time for f32-accurate work on the card: three TF32 passes of every
# product (hi.hi + hi.lo + lo.hi), the f32 tier of K2, K3 and K4
F32_ACCURATE_OPS_PER_S = TF32_OPS_PER_S / 3
ROWS_SOURCE = "moc_tpu_torch/ops/csrc/topk_threshold.cu"
REPLACES = "moc_tpu/ops/topk_kernel.py:50"
K2_SOURCE = "moc_tpu_torch/ops/csrc/flash_fwd.cu"
K2_REPLACES = "moc_tpu/ops/flash_attention.py:68"
K2_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX package's flash tolerances
K2_KERNEL = {torch.float32: "flash_fwd_tf32_kernel", torch.bfloat16: "flash_fwd_mma_kernel"}
# f32 K2 beside that: max |O - plain| at most 1e-5 of the largest |O|. Three
# TF32 passes keep each product within a few units in 2^-22 (an emulation on
# the CPU: 3.2e-7 to 1.1e-6 of it); one pass misses 2e-5 itself.
F32_FWD_MAX_REL = 1e-5
BWD_SOURCE = "moc_tpu_torch/ops/csrc/flash_bwd.cu"
# the tensor-core kernels of each source, each built at D = 32, 64 and 128: K2,
# K3 and K4 in bf16 and in f32 (three TF32 passes)
MMA_KERNELS = {"flash_fwd": ("flash_fwd_mma_kernel", "flash_fwd_tf32_kernel"),
               "flash_bwd": ("flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
                             "flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel")}
K3_REPLACES = "moc_tpu/ops/flash_attention.py:188"
K4_REPLACES = "moc_tpu/ops/flash_attention.py:238"
# K3/K4: the JAX package's flash backward tolerance in f32; in bf16, a share
# of the largest |grad| (P and dS are rounded to bf16 before the products)
BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
# f32 K3/K4 beside that: max |kernel - plain| at most 1e-5 of the largest |grad|
# of the three. Three TF32 passes keep each product within a few units in 2^-22;
# one pass (2^-11) misses this limit.
F32_BWD_MAX_REL = 1e-5
# bf16 K2, K3 and K4, beside the limits above: mean |kernel - plain| at most 1% of
# mean |plain|. Rounding P in another order moves it by ~2^-9 of |plain|; a
# wrong mask or a dropped key tile moves it by several percent, which a limit
# on the largest element alone may not see.
BF16_MEAN_REL = 1e-2
# pretraining: the JAX CLI's docstring configuration (BEiT-3-base width) on one card
PRETRAIN_ARGV = ["--batch", "32", "--seq_len", "512", "--layers", "12", "--embed_dim", "768",
                 "--ffn_dim", "3072", "--heads", "12", "--vocab", "1024", "--mask_prob", "0.15",
                 "--lr", "1e-3", "--mesh", "data=1"]
PRETRAIN_STEPS, PRETRAIN_LAYERS, PRETRAIN_SHAPE = 5, 12, (32, 12, 512, 64)
# the 2-layer card-against-CPU run, at the CLI's default width (8 heads of 32)
NARROW_ARGV = ["--batch", "4", "--seq_len", "128", "--layers", "2", "--embed_dim", "256",
               "--ffn_dim", "1024", "--heads", "8", "--vocab", "1024"]
# extraction: CONCH ViT-B/16 at 448 px (785 tokens, 12 layers, 12 heads of 64)
# over 256 px patches, CLAM's usual size, at the JAX CLI's batch 64
PATCH_PX, EXTRACT_BATCH, SLIDE_PATCHES = 256, 64, (600, 424)
TRUNK_LAYERS, TOKENS, HEADS, HEAD_DIM = 12, 785, 12, 64
EXTRACT_BATCHES = sum(math.ceil(n / EXTRACT_BATCH) for n in SLIDE_PATCHES)  # 10 + 7
# MUSK-large (musk_large_patch16_384; JAX moc_tpu/models/musk.py:23-31): 24 multiway
# layers of 1024, FFN 4096, 16 heads of 64, 384 px (577 tokens), vocabulary 64010, text
# length 100; its text stream here is the vendored nsclc banks through the hash tokenizer
MUSK_LAYERS, MUSK_TOKENS, MUSK_HEADS, MUSK_TEXT_LEN, MUSK_OUT = 24, 577, 16, 100, 1024
MUSK_CPU_IMAGES, MUSK_CPU_PROMPTS = 2, 16  # the rows held against the CPU
RESNET_PX, RESNET_CPU_IMAGES = 256, 8
# K2's timing shapes: the CONCH trunk's at batch 64, the encoder's in pretraining, and
# MUSK's vision stream at batch 64 and text stream over the nsclc banks (its padding as
# segment ids; the batch is the banks' prompt count, 176)
K2_SHAPES = {"extraction": (EXTRACT_BATCH, HEADS, TOKENS, HEAD_DIM),
             "pretraining": PRETRAIN_SHAPE,
             "musk_vision": (EXTRACT_BATCH, MUSK_HEADS, MUSK_TOKENS, HEAD_DIM),
             "musk_text": (None, MUSK_HEADS, MUSK_TEXT_LEN, HEAD_DIM)}
# MOC training: the JAX CLI's synthetic protocol (moc_tpu/cli/main_moc.py:52-55,123-126):
# D=512, SENet 512-64-4, C=2 with 4 background concepts, topj 400, topk 10, shot 8,
# fold 0, 16 slides a class (val 2, test 4), bags of 1500-4000 patches (the 4096
# bucket), 25 epochs of shot x C = 16 per-slide Adam steps, seed 0
TRAIN_SHOT, TRAIN_EPOCHS, TRAIN_PATCHES = 8, 25, (1500, 4000)
TRAIN_VISITS = TRAIN_SHOT * N_CLASSES
TRAIN_ARGV = ["--dataset", "synthetic", "--shot", str(TRAIN_SHOT), "--fold", "0",
              "--topj", str(TOPJ), "--topk", str(TOPK), "--num_epochs", str(TRAIN_EPOCHS),
              "--synthetic_min_patches", str(TRAIN_PATCHES[0]),
              "--synthetic_max_patches", str(TRAIN_PATCHES[1]), "--seed", "0"]
# the fused sweep: every fold of shot 8 at the training protocol, through the JAX
# package's sweep entry point (moc_tpu/cli/sweep.py:13-14), on the training corpus
SWEEP_FOLDS = (0, 1, 2, 3, 4)
SWEEP_ARGV = ["--dataset", "synthetic", "--shots", str(TRAIN_SHOT),
              "--folds", *map(str, SWEEP_FOLDS), "--topj", str(TOPJ), "--topk", str(TOPK),
              "--num_epochs", str(TRAIN_EPOCHS), "--synthetic_min_patches", str(TRAIN_PATCHES[0]),
              "--synthetic_max_patches", str(TRAIN_PATCHES[1]), "--seed", "0"]
# the keys of the JAX package's best_results_shot_{s}_fold_{f}.json
RESULT_KEYS = ["zero_shot_train", "zero_shot_val", "zero_shot_test", "best_val",
               "test_at_best_val", "test_acc_at_best_val", "best_epoch", "best_model_path"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def _mean_rel(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> float:
    """mean |got - want| over mean |want|; fails past ``BF16_MEAN_REL`` in bf16."""
    w = want.float()
    rel = ((got.float() - w).abs().mean() / w.abs().mean()).item()
    check(dtype == torch.float32 or rel <= BF16_MEAN_REL,
          f"{what}: mean |kernel - plain| is {rel:.3e} of mean |plain|")
    return rel


def _k2_errors(o, lse, ro, rlse, dtype, what: str) -> dict:
    """Largest |kernel - plain| of K2's O and lse (``lse`` None: O alone) and,
    of O, that over the largest |plain O| (``max_rel``) and the mean
    |kernel - plain| over the mean |plain| (``mean_rel``); fails past
    ``K2_TOL``, in f32 past ``F32_FWD_MAX_REL`` of the largest |O| and in
    bf16 past ``BF16_MEAN_REL``."""
    tol = K2_TOL[dtype]
    check(o.dtype == dtype and (lse is None or lse.dtype == torch.float32),
          f"K2 output types {o.dtype}, {None if lse is None else lse.dtype}: {what}")
    err = {"o": (o.float() - ro.float()).abs().max().item(),
           "lse": 0.0 if lse is None else (lse - rlse).abs().max().item()}
    check(torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol),
          f"K2 O differs from the plain version by {err['o']}: {what}")
    check(lse is None or torch.allclose(lse, rlse, rtol=tol, atol=tol),
          f"K2 lse differs from the plain version by {err['lse']}: {what}")
    err["max_rel"] = err["o"] / ro.float().abs().max().item()
    check(dtype != torch.float32 or err["max_rel"] <= F32_FWD_MAX_REL,
          f"K2 O differs from the plain version by {err['max_rel']:.3e} of the largest "
          f"|O|: {what}")
    err["mean_rel"] = _mean_rel(o, ro, dtype, f"K2 O {what}")
    return err


def _kernel_name(mangled: str) -> str:
    """``name<D>`` of a mangled kernel entry: the last of its length-prefixed
    source names and its integer template arguments (the mangled name itself
    when it has none)."""
    pos, name = (3 if mangled.startswith("_ZN") else 2), None
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        pos = start + int(m.group())
        name = mangled[start:pos]
    if name is None:
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    return name + (f"<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>" if args else "")


def phase_build() -> dict:
    """Build every kernel; log each entry function's registers and spills
    from ``-Xptxas -v``, fail on a spill store or load, and fail unless
    every tensor-core kernel was built at D = 32, 64 and 128."""
    from moc_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"[build] {len(built)} kernel(s) in {time.perf_counter() - t0:.2f}s: "
        + ", ".join(f"{k} {v['seconds']:.2f}s" for k, v in built.items()))
    for name, rec in built.items():
        if rec["log"] == "cached":
            log(f"[build] {name}: an earlier build, spills not checked")
            continue
        entry, spills, seen = None, "", set()
        for line in rec["log"].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = _kernel_name(m.group(1))
            elif "spill" in line:
                spills = line.strip()
                check(", 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{name}: {entry} spills registers: {spills}")
            elif entry and (m := re.search(r"Used (\d+) registers", line)):
                smem = re.search(r"(\d+) bytes smem", line)
                log(f"[build] {name}: {entry}: {m.group(1)} registers, "
                    f"{smem.group(1) if smem else 0} bytes static shared memory; {spills}")
                seen.add(entry)
                entry = None
        if name == "topk_threshold":
            from moc_tpu_torch.ops.topk_kernel import MAX_STAGED_KEYS

            log(f"[build] {name}: dynamic shared memory 4 B a staged key, at most "
                f"{4 * MAX_STAGED_KEYS} B ({MAX_STAGED_KEYS} keys a CTA); each launch's in [times]")
        for kernel in MMA_KERNELS.get(name, ()):
            for d in (32, 64, 128):
                check(f"{kernel}<{d}>" in seen, f"{name}: {kernel}<{d}> is missing from the build")
    return built


def _parity_keys(kind: str, rows: int, n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    from moc_tpu_torch.ops import NEG_INF

    x = torch.randn((rows, n), generator=gen, device="cuda")
    if kind == "ties":
        x = torch.round(x * 2)
    elif kind == "signed_zeros":
        vals = torch.tensor([-0.0, 0.0, 1.0, -1.0], device="cuda")
        x = vals[torch.randint(0, 4, (rows, n), generator=gen, device="cuda")]
    elif kind == "padded":  # fewer valid keys than k
        x[:, max(1, k // 3):] = NEG_INF
    return x


def phase_parity() -> dict:
    """K1 against its plain version on the card; returns the largest
    |kernel - plain| over the cases of each entry (0 when bit-equal)."""
    from moc_tpu_torch.ops import threshold_topk_mask, topk_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"rows": 0.0, "cols": 0.0}
    cases = 0
    for n in (1000, 16384, 131072):
        for k in (1, 10, 400, n):
            for kind in ("normal", "ties", "signed_zeros", "padded"):
                x = _parity_keys(kind, 8, n, k, gen)
                got = topk_kernel.topk_threshold_mask_cuda(x, k)
                want = threshold_topk_mask(x, k, axis=-1)
                e = (got.int() - want.int()).abs().max().item()
                err["rows"] = max(err["rows"], float(e))
                check(e == 0 and bool((got.sum(-1) == k).all()),
                      f"K1 rows differ from the plain version: N={n} k={k} {kind}")
                cols = x.view(2, 4, n).transpose(1, 2)  # [B=2, N, C=4] strided view
                got = topk_kernel.col_topk_threshold_mask_cuda(cols, k)
                want = threshold_topk_mask(cols, k, axis=-2)
                e = (got.int() - want.int()).abs().max().item()
                err["cols"] = max(err["cols"], float(e))
                check(e == 0, f"K1 columns differ from the plain version: N={n} k={k} {kind}")
                cases += 2
    torch.cuda.synchronize()
    log(f"[parity] K1 bit-equal to its plain version on {cases} cases "
        f"(N in 1000/16384/131072, k in 1/10/400/N, random/ties/±0.0/padded)")
    cases, plans = _parity_clusters(gen, err)
    log(f"[parity] K1 bit-equal with exactly k per row on {cases} cluster cases (N in "
        f"{'/'.join(map(str, K1_NS))}, R in {'/'.join(map(str, K1_ROWS))}, random k=10 and "
        f"k=N, ties straddling the CTAs short of the fill, ties equal to the fill, all-equal; "
        f"columns of a strided and a contiguous [2, N, 6]); (cluster, staged) run: "
        f"{sorted(plans)}")
    return err


# N past 8 x MAX_STAGED_KEYS (393216) takes the streaming path
K1_NS = (1000, 1500, 4096, 16384, 65536, 131072, 400000)
K1_ROWS = (1, 2, 5, 40)


def _cluster_keys(kind: str, rows: int, n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """Rows whose k-th value has ``k - k // 3`` members left to fill among
    ties at 1.0 placed at random over the row: as many ties as the fill
    ("exact": no ranking) or more ("straddle": ties in every CTA of the
    cluster, ranked across them); all-equal rows; or normal keys."""
    if kind == "normal":
        return torch.randn((rows, n), generator=gen, device="cuda")
    if kind == "equal":
        return torch.full((rows, n), 0.5, device="cuda")
    x = torch.randn((rows, n), generator=gen, device="cuda") - 10
    above = k // 3
    ties = k - above if kind == "exact" else min(n - above, 2 * (k - above) + 1)
    pos = torch.argsort(torch.rand((rows, n), generator=gen, device="cuda"), dim=-1)
    x.scatter_(-1, pos[:, :above], 5.0 + torch.rand((rows, above), generator=gen, device="cuda"))
    x.scatter_(-1, pos[:, above:above + ties], 1.0)
    return x


def _parity_clusters(gen: torch.Generator, err: dict) -> tuple[int, set]:
    """K1 over every cluster size the launcher picks, the streaming path,
    the tie scan and its fast path, and the strided column entry."""
    from moc_tpu_torch.ops import threshold_topk_mask, topk_kernel

    def held(entry: str, fn, x: torch.Tensor, k: int, what: str) -> None:
        axis = -1 if entry == "rows" else -2
        before = fn.launches
        got = fn(x, k)
        want = threshold_topk_mask(x, k, axis=axis)
        e = (got.int() - want.int()).abs().max().item()
        err[entry] = max(err[entry], float(e))
        check(e == 0 and got.is_contiguous() and bool((got.sum(axis) == k).all())
              and fn.launches == before + 1,
              f"K1 {entry} differ from the plain version: {what}")

    cases, plans = 0, set()
    for n in K1_NS:
        k = min(400, n)
        for r in K1_ROWS:
            p = topk_kernel.plan(r, n, torch.cuda.get_device_properties(0).multi_processor_count)
            plans.add((p.cluster, p.staged))
            for kind, kk in (("normal", 10), ("normal", n), ("straddle", k), ("exact", k),
                             ("equal", k), ("equal", n)):
                held("rows", topk_kernel.topk_threshold_mask_cuda,
                     _cluster_keys(kind, r, n, kk, gen), kk, f"N={n} R={r} k={kk} {kind} {p}")
                cases += 1
        for layout in ("strided", "contiguous"):
            for kind, kk in (("normal", 10), ("straddle", k)):
                # 12 columns of N as [2, N, 6], a transposed view or contiguous
                cols = _cluster_keys(kind, 12, n, kk, gen).view(2, 6, n).transpose(1, 2)
                held("cols", topk_kernel.col_topk_threshold_mask_cuda,
                     cols if layout == "strided" else cols.contiguous(), kk,
                     f"N={n} k={kk} {kind} {layout}")
                cases += 1
    torch.cuda.synchronize()
    check({c for c, staged in plans if staged} == {1, 2, 4, 8} and (8, False) in plans,
          f"the K1 parity grid missed a cluster size or the streaming path: {sorted(plans)}")
    return cases, plans


def _flash_inputs(b, h, length, d, dtype, segments, causal, gen):
    q, k, v = (torch.randn((b, h, length, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if not segments:
        return q, k, v, None, None
    if causal:  # packed sequences: every row sees at least itself
        cuts = torch.sort(torch.randint(0, length, (b, 3), generator=gen, device="cuda")).values
        seg = (torch.arange(length, device="cuda")[None, None] >= cuts[:, :, None]).sum(1)
        return q, k, v, seg.int(), seg.int()
    kv_seg = torch.randint(0, 3, (b, length), generator=gen, device="cuda", dtype=torch.int32)
    q_seg = kv_seg.clone()
    q_seg[0, :16] = 9  # no key is in segment 9: rows masked everywhere
    return q, k, v, q_seg, kv_seg


def phase_flash_parity() -> dict:
    """K2 against its plain version on the card; returns, per dtype, the
    largest |kernel - plain| over O and over lse."""
    from moc_tpu_torch.ops.flash_attention import flash_attention_padded, mha_reference
    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    err = {dt: {"o": 0.0, "lse": 0.0} for dt in K2_TOL}
    rel = {dt: {"max_rel": 0.0, "mean_rel": 0.0} for dt in K2_TOL}

    def hold(dtype, o, lse, ro, rlse, what):
        e = _k2_errors(o, lse, ro, rlse, dtype, what)
        for part, store in (("o", err), ("lse", err), ("max_rel", rel), ("mean_rel", rel)):
            store[dtype][part] = max(store[dtype][part], e[part])

    cases = 0
    with torch.inference_mode():
        for dtype in K2_TOL:
            for d in (32, 64, 128):
                for length in (785, 1024):
                    for causal in (False, True):
                        for segments in (False, True):
                            q, k, v, qs, ks = _flash_inputs(2, 3, length, d, dtype, segments,
                                                            causal, gen)
                            before = flash_fwd_cuda.launches
                            o, lse = flash_fwd_cuda(q, k, v, qs, ks, causal=causal)
                            torch.cuda.synchronize()
                            check(flash_fwd_cuda.launches == before + 1, "K2 launch not counted")
                            ro, rlse = mha_reference(q, k, v, q_segment_ids=qs,
                                                     kv_segment_ids=ks, causal=causal)
                            hold(dtype, o, lse, ro, rlse,
                                 f"{dtype} D={d} L={length} causal={causal} "
                                 f"segments={segments}")
                            cases += 1
            # the padding_mask path of the wrapper the vision trunk calls
            q, k, v, _, _ = _flash_inputs(2, 3, 785, 64, dtype, False, False, gen)
            mask = torch.rand((2, 785), generator=gen, device="cuda") < 0.2
            seg = (~mask).int()
            before = flash_fwd_cuda.launches
            o = flash_attention_padded(q, k, v, padding_mask=mask)
            torch.cuda.synchronize()
            check(flash_fwd_cuda.launches == before + 1, "flash_attention_padded did not launch K2")
            ro, _ = mha_reference(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
            hold(dtype, o, None, ro, None, f"flash_attention_padded {dtype}")
            cases += 1
    for dtype, e in err.items():
        log(f"[parity] K2 {dtype}: max |O - plain| {e['o']:.3e}, max |lse - plain| "
            f"{e['lse']:.3e} (tolerance {K2_TOL[dtype]}); max |O - plain| at most "
            f"{rel[dtype]['max_rel']:.3e} of the largest |O|"
            f"{f' (limit {F32_FWD_MAX_REL})' if dtype == torch.float32 else ''}; mean "
            f"|O - plain| / mean |plain| at most {rel[dtype]['mean_rel']:.3e}")
    log(f"[parity] K2 matches its plain version on {cases} cases (f32/bf16, D 32/64/128, "
        "L 785/1024, causal or not, segments with rows masked everywhere, padding_mask)")
    return err


def write_corpus(root: str) -> list[str]:
    """Synthetic ``.pt`` bags, oracle weight matrices and a seeded SENet."""
    from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, sample_bag, zero_shot_weights
    from moc_tpu_torch.models.senet import SENet

    cfg = SyntheticWSIConfig(n_classes=N_CLASSES, n_bg_concepts=N_EXT - N_CLASSES, dim=DIM,
                             min_patches=MIN_PATCHES, max_patches=MAX_PATCHES, seed=0)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "bags", "pt_files"))
    ids = []
    for i in range(N_SLIDES):
        feats, _ = sample_bag(cfg, i % N_CLASSES, rng)
        ids.append(f"slide_{i:02d}")
        torch.save(torch.from_numpy(feats), os.path.join(root, "bags", "pt_files",
                                                         f"{ids[-1]}.pt"))
    w, w_ext = zero_shot_weights(cfg)
    np.savez(os.path.join(root, "w.npz"), weights=w)
    np.savez(os.path.join(root, "we.npz"), weights=w_ext)
    senet = SENet(DIM, generator=torch.Generator().manual_seed(0))
    torch.save(senet.state_dict(), os.path.join(root, "senet.pt"))
    return ids


def server_args(root: str, device: str, watch_dir: str | None = None, extra=(),
                model: str = "senet.pt"):
    from moc_tpu_torch.cli import serve

    return serve.get_args(["--dataset", "nsclc", "--model", os.path.join(root, model),
                           "--weights_npz", os.path.join(root, "w.npz"),
                           "--weights_ext_npz", os.path.join(root, "we.npz"),
                           "--topj", str(TOPJ), "--topk", str(TOPK),
                           "--batch_size", str(BATCH), "--device", device,
                           "--watch_dir", watch_dir or os.path.join(root, "bags"), "--once",
                           *extra])


def phase_serve(root: str, ids: list[str]) -> dict:
    """Drain the bags through the daemon on the GPU and check the rows, the
    launch counts, the CPU agreement and the masks."""
    from moc_tpu_torch.cli import serve
    from moc_tpu_torch.cli.predict import load_senet
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.moc.core import _dense_views_weights, fuse_views
    from moc_tpu_torch.ops import masked_col_topk_mask, topk_kernel, union_selection_threshold

    server = serve.Server(server_args(root, "cuda"))
    out_csv = os.path.join(root, "served.csv")
    rows_fn, cols_fn = (topk_kernel.topk_threshold_mask_cuda,
                        topk_kernel.col_topk_threshold_mask_cuda)
    rows_fn.launches = cols_fn.launches = 0
    t0 = time.perf_counter()
    n = serve.watch_once(server, os.path.join(root, "bags"), out_csv, set())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rows": rows_fn.launches, "cols": cols_fn.launches}
    n_batches = math.ceil(N_SLIDES / BATCH)
    log(f"[serve] watch_once scored {n} slides in {wall:.3f}s (reads and first-call "
        f"set-up included); K1 launches: {launches}")
    check(n == N_SLIDES, f"watch_once scored {n} of {N_SLIDES} slides")
    check(launches == {"rows": n_batches, "cols": n_batches},
          f"K1 launches {launches}, want {n_batches} per entry (one per batch)")
    with open(out_csv, newline="") as f:
        header, *lines = list(csv.reader(f))
    check(header == ["slide_id", "pred", "prob_0", "prob_1"], f"CSV header {header}")
    check(sorted(r[0] for r in lines) == ids, "a slide is missing from the CSV")
    probs = np.array([[float(v) for v in r[2:]] for r in lines])
    check(bool(np.isfinite(probs).all()) and np.abs(probs.sum(1) - 1).max() < 1e-5,
          "probabilities are not finite or do not sum to 1")

    # the same server on the CPU, and the masks of the GPU run on the CPU
    cpu_server = serve.Server(server_args(root, "cpu"))
    bags = [read_bag_pt(os.path.join(root, "bags", "pt_files", f"{s}.pt")) for s in ids]
    cfg = server.cfg
    senet = load_senet(os.path.join(root, "senet.pt")).cuda()
    w = torch.from_numpy(np.load(os.path.join(root, "w.npz"))["weights"]).cuda()
    w_ext = torch.from_numpy(np.load(os.path.join(root, "we.npz"))["weights"]).cuda()
    max_diff = 0.0
    for i in range(0, N_SLIDES, BATCH):
        gpu_batch = pack_bags(bags[i:i + BATCH], n_pad=N_PAD, device="cuda")
        cpu_batch = pack_bags(bags[i:i + BATCH], n_pad=N_PAD, device="cpu")
        lg = server.batch_logits(gpu_batch).cpu()
        lc = cpu_server.batch_logits(cpu_batch)
        check(bool(torch.isfinite(lg).all()) and lg.shape == (BATCH, N_CLASSES),
              f"GPU logits {tuple(lg.shape)} not finite")
        max_diff = max(max_diff, (lg - lc).abs().max().item())
        check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-5),
              f"GPU pooled logits differ from the CPU run by {(lg - lc).abs().max().item()}")
        with torch.inference_mode():
            views, weights, logits, logits_ext = _dense_views_weights(
                senet, gpu_batch.features, w, w_ext, cfg)
            union = union_selection_threshold(logits, logits_ext, gpu_batch.mask, TOPJ,
                                              N_CLASSES)
            union_cpu = union_selection_threshold(logits.cpu(), logits_ext.cpu(),
                                                  gpu_batch.mask.cpu(), TOPJ, N_CLASSES)
            check(torch.equal(union.cpu(), union_cpu),
                  "GPU selection union differs from the plain version on the same logits")
            fused = fuse_views(weights, views, cfg.include_flags())
            pool = masked_col_topk_mask(fused, union, TOPK)
            pool_cpu = masked_col_topk_mask(fused.cpu(), union_cpu, TOPK)
            check(torch.equal(pool.cpu(), pool_cpu),
                  "GPU pooling mask differs from the plain version on the same logits")
    log(f"[serve] pooled logits GPU vs CPU: max |diff| {max_diff:.3e} (rtol 1e-4, atol 1e-5); "
        f"selection and pooling masks bit-equal to the plain version; "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return {"launches": launches, "server": server, "bags": bags, "senet": senet,
            "w": w, "w_ext": w_ext, "cfg": cfg}


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _library_mask(keys: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    idx = torch.topk(keys, k, dim=dim).indices
    return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device).scatter_(dim, idx, True)


# K1 beyond the serving shapes: a B=1 training step's selection rows and
# pooling columns ([1, N, C=2] on the masked route, [1, capacity, C=2] on
# the gather route that training takes), and the largest bucket's rows
K1_SHAPES = (("rows", (5, 4096), TOPJ), ("cols", (1, 4096, N_CLASSES), TOPK),
             ("cols", (1, 2432, N_CLASSES), TOPK), ("rows", (40, 131072), TOPJ))
# K1's column entry at the zero-shot floor of the training protocol's train
# split (16 slides in the 4096 bucket): delta_diff's margin ranks whole rows,
# [B, N, 1]; the other foreground families rank [B, N, C]
ZS_K1_SHAPES = (("cols", (TRAIN_VISITS, 4096, 1), TOPK),
                ("cols", (TRAIN_VISITS, 4096, N_CLASSES), TOPK))


# a spin of 1e8 SM cycles (~50 ms on an H100) holds the stream while the
# host queues the calls that ``_gated_us`` times; queuing 50 K1 calls takes
# a few milliseconds
GATE_CYCLES = 100_000_000


def _gated_us(fn, calls: int) -> float | None:
    """Device time per call of ``calls`` calls of ``fn`` queued behind a spin
    kernel, by CUDA events around them: the kernels run back to back, free
    of the host's cost of launching them. None where the spin ended before
    the host had queued them all."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(GATE_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    held = not start.query()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls if held else None


def _kernel_us(fn, name: str, wrapper, calls: int = 50) -> dict:
    """Device time per launch of the kernels named ``name``, two ways over
    ``calls`` calls of ``fn`` each: ``kernel_us`` from ``torch.profiler``,
    the mean over the launch records it delivers (``kernel_records``), and
    ``device_us`` by ``_gated_us``. Late in a long run on an H100 the
    profiler has delivered 44 of 50 records, and once none: where it
    delivers fewer than half, ``kernel_us`` is None (not measured). Fails
    unless ``wrapper`` counted one launch a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    check(wrapper.launches - before == calls,
          f"{calls} calls launched {name} {wrapper.launches - before} times")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in events)
    check(count <= calls, f"the profiler delivered {count} records of {name} for {calls} launches")
    if count < calls:
        log(f"[times] the profiler delivered {count} of {calls} launch records of {name}; "
            + ("the mean is over those" if 2 * count >= calls else "kernel_us not measured"))
    device_us = _gated_us(fn, calls)
    if device_us is None:
        log(f"[times] the host had not queued {calls} calls of {name} before the spin ended; "
            "device_us not measured")
    return {"kernel_us": sum(e.self_device_time_total for e in events) / count
            if 2 * count >= calls else None, "kernel_records": count, "device_us": device_us}


def _us(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.2f} us"


def _k1_record(entry: str, keys: torch.Tensor, k: int, kernel, plain, lib) -> dict:
    """K1's times at one shape: per call by CUDA events around the wrapper
    (the method of every earlier run), kernel-only by the profiler and
    queued behind a spin (``_kernel_us``), against
    its bound, its plain version and ``torch.topk`` plus a scatter."""
    from moc_tpu_torch.ops import topk_kernel

    n = keys.shape[-1] if entry == "rows" else keys.shape[-2]
    r = keys.numel() // n
    p = topk_kernel.plan(r, n, torch.cuda.get_device_properties(0).multi_processor_count)
    # one read of the f32 keys and one write of the bool mask; one compare
    # per key per pass (4 radix passes + 1 mask pass)
    bytes_s = keys.numel() * (4 + 1) / HBM_BYTES_PER_S
    ops_s = keys.numel() * 5 / F32_OPS_PER_S
    rec = {"shape": list(keys.shape), "k": k, "ms": _time_ms(kernel),
           **_kernel_us(kernel, "topk_cluster_kernel", _k1_wrappers()[entry]),
           "plain_ms": _time_ms(plain), "library_ms": _time_ms(lib),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "cluster": p.cluster, "staged": p.staged,
           "dynamic_smem_bytes": 4 * p.slice if p.staged else 0}
    log(f"[times] K1 {entry} {list(keys.shape)} [{r} x {n}] k={k}: kernel {rec['ms']:.4f} ms "
        f"per call, {_us(rec['kernel_us'])} kernel-only (profiler), {_us(rec['device_us'])} a "
        f"call queued "
        f"behind a spin (CUDA events), plain "
        f"{rec['plain_ms']:.4f} ms, torch.topk+scatter {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); cluster {p.cluster}, "
        f"{'staged, ' + str(4 * p.slice) + ' B dynamic shared memory' if p.staged else 'streamed'}")
    return rec


def _k1_at_shapes(shapes, seed: int) -> dict:
    """K1's records (``_k1_record``) on random keys at each ``(entry, shape,
    k)``, each first held bit for bit against its plain version."""
    from moc_tpu_torch.ops import threshold_topk_mask, topk_kernel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    records = {"rows": [], "cols": []}
    with torch.inference_mode():
        for entry, shape, k in shapes:
            keys = torch.randn(shape, generator=gen, device="cuda")
            if entry == "rows":
                fns = (lambda: topk_kernel.topk_threshold_mask_cuda(keys, k),
                       lambda: threshold_topk_mask(keys, k, axis=-1),
                       lambda: _library_mask(keys, k, -1))
            else:
                fns = (lambda: topk_kernel.col_topk_threshold_mask_cuda(keys, k),
                       lambda: threshold_topk_mask(keys, k, axis=-2),
                       lambda: _library_mask(keys, k, -2))
            check(torch.equal(fns[0](), fns[1]()), f"K1 {entry} {shape} differs from plain")
            records[entry].append(_k1_record(entry, keys, k, *fns))
            del keys
    return records


def phase_times(state: dict) -> dict:
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.moc.core import _dense_views_weights, fuse_views
    from moc_tpu_torch.ops import masked_logits, threshold_topk_mask, topk_kernel
    from moc_tpu_torch.ops.selection import _stacked_policy_keys, union_selection_threshold

    cfg, server = state["cfg"], state["server"]
    batch = pack_bags(state["bags"][:BATCH], n_pad=N_PAD, device="cuda")
    with torch.inference_mode():
        views, weights, logits, logits_ext = _dense_views_weights(
            state["senet"], batch.features, state["w"], state["w_ext"], cfg)
        stacked, _ = _stacked_policy_keys(logits, logits_ext, batch.mask, N_CLASSES, ())
        sel_rows = stacked[:, :-1].reshape(-1, N_PAD).contiguous()  # [B·(2C+1), N]
        union = union_selection_threshold(logits, logits_ext, batch.mask, TOPJ, N_CLASSES)
        pool_cols = masked_logits(fuse_views(weights, views, cfg.include_flags()), union)
        records = {}
        for entry, keys, k, kernel, plain, lib in (
                ("rows", sel_rows, TOPJ, lambda: topk_kernel.topk_threshold_mask_cuda(sel_rows, TOPJ),
                 lambda: threshold_topk_mask(sel_rows, TOPJ, axis=-1),
                 lambda: _library_mask(sel_rows, TOPJ, -1)),
                ("cols", pool_cols, TOPK,
                 lambda: topk_kernel.col_topk_threshold_mask_cuda(pool_cols, TOPK),
                 lambda: threshold_topk_mask(pool_cols, TOPK, axis=-2),
                 lambda: _library_mask(pool_cols, TOPK, -2))):
            records[entry] = _k1_record(entry, keys, k, kernel, plain, lib)
        shapes = _k1_at_shapes(K1_SHAPES, seed=6)
        records["rows"]["shapes"], records["cols"]["shapes"] = shapes["rows"], shapes["cols"]

        def forward():
            server.batch_logits(batch)

        for _ in range(5):
            forward()
        torch.cuda.synchronize()
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(lat)
        dev_ms = _time_ms(forward, iters=30, warmup=3)
    pack = []
    for _ in range(5):
        t0 = time.perf_counter()
        pack_bags(state["bags"][:BATCH], n_pad=N_PAD, device="cuda")
        torch.cuda.synchronize()
        pack.append((time.perf_counter() - t0) * 1e3)
    log(f"[times] eval_batch, batch {BATCH} x {N_PAD} x {DIM}: {ms:.3f} ms host wall "
        f"(median of 30), {dev_ms:.3f} ms by CUDA events, {BATCH / ms * 1e3:.1f} slides/s; "
        f"pack_bags (pad + pinned copy) {statistics.median(pack):.3f} ms")
    records["eval_batch_ms"] = ms
    phase_profile(forward)
    return records


def phase_profile(forward, steps: int = 5, what: str = "forward", host_top: int = 0) -> dict:
    """Device time of ``forward`` (a batch forward, or a train step) by
    kernel, from ``torch.profiler``, and the device's busy share of the host
    wall over the same steps; with ``host_top``, also that many host-side
    operations by their own host time. Returns ``busy`` (the share),
    ``device_us`` a step and ``flash_fwd_share`` (K2's share of the device
    time); empty when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # a user annotation on the device (Adam's "Optimizer.step#Adam.step")
    # spans kernels that are counted on their own: counting it too would
    # count their time twice
    events = [e for e in device if not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    annotated_us = sum(e.self_device_time_total for e in device) - busy_us
    if busy_us <= 0:
        log("[profile] the profiler recorded no device time")
        return {}
    log(f"[profile] {steps} x {what}: device busy {busy_us / steps:.1f} us/{what} of "
        f"{wall_us / steps:.1f} us host wall ({100 * busy_us / wall_us:.1f}% busy), "
        f"{sum(e.count for e in events) // steps} kernels/{what} (user annotations over "
        f"them, not counted: {annotated_us / steps:.1f} us/{what})")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top ten, and the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < 10 or "flash_" in e.key or "topk_cluster" in e.key:
            log(f"[profile]   {e.self_device_time_total / steps:9.1f} us  "
                f"{100 * e.self_device_time_total / busy_us:5.1f}%  x{e.count // steps:<3d} "
                f"#{rank + 1:<3d} {e.key[:90]}")
    if host_top:
        host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
        host_us = sum(e.self_cpu_time_total for e in host)
        log(f"[profile] host side: {host_us / steps:.1f} us/{what} of its own time in "
            f"{sum(e.count for e in host) // steps} recorded operations "
            f"({100 * host_us / wall_us:.1f}% of the host wall; the rest runs between them)")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            log(f"[profile]   host {e.self_cpu_time_total / steps:9.1f} us  "
                f"x{e.count // steps:<4d} {e.key[:80]}")
    flash_us = sum(e.self_device_time_total for e in events if "flash_fwd" in e.key)
    return {"busy": busy_us / wall_us, "device_us": busy_us / steps,
            "flash_fwd_share": flash_us / busy_us,
            "kernels": sum(e.count for e in events) // steps, "wall_us": wall_us / steps,
            "top": [(e.key[:60], e.self_device_time_total / steps) for e in ranked[:5]]}


# the serving tiers at the serving point: name -> (flags of cli.serve / cli.predict)
TIERS = {"exact": [], "dense": ["--dense"], "score_bf16": ["--score_dtype", "bfloat16"],
         "storage_bf16": ["--storage_dtype", "bfloat16"],
         "storage_int8": ["--storage_dtype", "int8"],
         "dense_int8": ["--dense", "--storage_dtype", "int8"]}
# bf16 scoring may move a near-tied row of the union where the card and the
# CPU round a bf16 sum apart: the JAX package's bound for that tier
# (tests/test_moc_core.py:243-278), union overlap above 0.95; the views of
# the rows both select are f32 re-scores, held to the card-against-CPU bound
# of every tier (rtol 1e-4, atol 1e-5). JAX's 1e-6 on the views holds two
# routes on one backend: across devices the 512-term sums run in other
# orders (1.13e-6 apart on an H100 against its host's CPU)
BF16_UNION_OVERLAP, CARD_CPU_RTOL, CARD_CPU_ATOL = 0.95, 1e-4, 1e-5


def _drain(server, root: str, name: str) -> tuple[list[dict], dict, float]:
    """``watch_once`` of the corpus by ``server`` with K1's counts set to 0
    just before: (rows, K1 launches, wall s)."""
    from moc_tpu_torch.cli import serve

    rows_fn, cols_fn = _k1_wrappers().values()
    out_csv = os.path.join(root, f"served_{name}.csv")
    if os.path.exists(out_csv):
        os.remove(out_csv)
    rows_fn.launches = cols_fn.launches = 0
    t0 = time.perf_counter()
    n = serve.watch_once(server, os.path.join(root, "bags"), out_csv, set())
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rows": rows_fn.launches, "cols": cols_fn.launches}
    check(n == N_SLIDES, f"[tiers] {name}: watch_once scored {n} of {N_SLIDES} slides")
    with open(out_csv, newline="") as f:
        return list(csv.DictReader(f)), launches, wall


def _tier_masks(server, batch, cfg) -> tuple[int, int]:
    """K1's masks of one tier's forward against its plain version on the
    same keys, the card's own: the selection rows (the policy keys of the
    card's logits; none in the dense tier) and the pooling columns (the
    card's fused views, gated by the card's union). Keys computed apart on
    the CPU would differ by an ulp of ``exp`` where the softmax key ties.
    Returns the numbers of mask elements held."""
    from moc_tpu_torch.moc.core import _dense_views_weights, _precision, fuse_views
    from moc_tpu_torch.ops import (masked_col_topk_mask, threshold_topk_mask, topk_kernel,
                                   union_selection_threshold)
    from moc_tpu_torch.ops.selection import _stacked_policy_keys

    senet = server.senet
    with torch.inference_mode(), _precision(cfg, batch.scales):
        views, weights, logits, logits_ext = _dense_views_weights(
            senet, batch.features, server.w, server.w_ext, cfg, batch.scales)
        gate, n_rows = batch.mask, 0
        if not cfg.dense:
            stacked, _ = _stacked_policy_keys(logits, logits_ext, batch.mask, N_CLASSES, ())
            rows = stacked[:, :-1].reshape(-1, N_PAD).contiguous()  # [B·(2C+1), N]
            check(torch.equal(topk_kernel.topk_threshold_mask_cuda(rows, TOPJ).cpu(),
                              threshold_topk_mask(rows.cpu(), TOPJ, axis=-1)),
                  f"[tiers] {cfg}: K1's selection rows differ from plain on the card's keys")
            n_rows = rows.numel()
            gate = union_selection_threshold(logits, logits_ext, batch.mask, TOPJ, N_CLASSES)
        fused = fuse_views(weights, views, cfg.include_flags())
        pool = masked_col_topk_mask(fused, gate, TOPK)
        check(torch.equal(pool.cpu(), masked_col_topk_mask(fused.cpu(), gate.cpu(), TOPK)),
              f"[tiers] {cfg}: K1's pooling mask differs from plain")
    return n_rows, pool.numel()


def _bf16_selection_close(gpu_batch, cpu_batch, server, cpu_server) -> dict:
    """The bf16-score tier's gather route on the card and on the CPU: each
    slide's union overlap and the views of the rows both select."""
    from moc_tpu_torch.moc.core import slide_process

    with torch.inference_mode():
        sel_g = slide_process(gpu_batch.features, gpu_batch.mask, server.w, server.w_ext,
                              server.cfg)
        sel_c = slide_process(cpu_batch.features, cpu_batch.mask, cpu_server.w,
                              cpu_server.w_ext, cpu_server.cfg)
    worst_overlap, view_err, moved = 1.0, 0.0, 0
    for b in range(gpu_batch.batch_size):
        pos = []
        for sel in (sel_g, sel_c):
            idx, valid = sel.idx[b].cpu().numpy(), sel.valid[b].cpu().numpy()
            pos.append({int(i): p for p, i in enumerate(idx) if valid[p]})
        common = sorted(set(pos[0]) & set(pos[1]))
        union = set(pos[0]) | set(pos[1])
        worst_overlap = min(worst_overlap, len(common) / max(len(union), 1))
        moved += len(union) - len(common)
        vg = sel_g.views[b][:, [pos[0][i] for i in common]].cpu()
        vc = sel_c.views[b][:, [pos[1][i] for i in common]]
        view_err = max(view_err, (vg - vc).abs().max().item())
        check(torch.allclose(vg, vc, rtol=CARD_CPU_RTOL, atol=CARD_CPU_ATOL),
              f"[tiers] bf16 scoring: views of common rows differ by {view_err}")
    check(worst_overlap > BF16_UNION_OVERLAP,
          f"[tiers] bf16 scoring: union overlap card/CPU {worst_overlap} <= {BF16_UNION_OVERLAP}")
    return {"min_overlap": worst_overlap, "rows_moved": moved, "view_err": view_err}


def _pack_times(bags, dtype: str) -> dict:
    """``pack_bags`` of one batch to the card at a storage tier (host wall
    with the copy, median of 5) and the bytes it copies; and the pad step
    alone through the native packer and through numpy."""
    from moc_tpu_torch.data import native
    from moc_tpu_torch.data.batching import pack_bags

    feats = [b.features for b in bags]
    before = dict(native.native_calls)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        batch = pack_bags(bags, n_pad=N_PAD, device="cuda", dtype=dtype)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(native.native_calls["pack"] - before["pack"] == 5,
          f"[tiers] {dtype}: pack_bags did not run the native packer")
    check(native.native_calls["quantize"] - before["quantize"] == (5 if dtype == "int8" else 0),
          f"[tiers] {dtype}: the int8 rows were not quantized natively")
    copied = (batch.features.numel() * batch.features.element_size()
              + (0 if batch.scales is None else batch.scales.numel() * 4) + 2 * len(bags) * 4)
    buf = torch.empty((len(bags), N_PAD, DIM), pin_memory=True).numpy()
    pad = {}
    for route in ("native", "numpy"):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            if route == "native":
                native.pack_bags_native(feats, N_PAD, out=buf, required=True)
            else:
                for i, f in enumerate(feats):
                    buf[i, :len(f)] = f
                    buf[i, len(f):] = 0.0
            ts.append((time.perf_counter() - t0) * 1e3)
        pad[route] = statistics.median(ts)
    return {"pack_ms": statistics.median(times), "copied_bytes": copied,
            "pad_native_ms": pad["native"], "pad_numpy_ms": pad["numpy"]}


def phase_tiers(root: str, ids: list[str]) -> dict:
    """``[tiers]``: every serving tier through ``cli.serve`` at the serving
    point (``TIERS``): ``watch_once`` on the card and on the CPU (rows with
    equal predictions; pooled logits within rtol 1e-4 / atol 1e-5, or the
    bf16-score bounds), K1's launches per batch (1 row + 1 column launch, 0 +
    1 in the dense tiers), K1's masks bit-equal to plain on the card's keys,
    the int8 product equal to the CPU's, the forward by CUDA events with a
    profile, and ``pack_bags`` by tier and route with its bytes; then
    ``cli.predict.main`` over the corpus with rows equal to ``serve``'s, and
    the port's own ``.msgpack`` of the SENet served as the ``.pt`` is."""
    from moc_tpu_torch.cli import predict, serve
    from moc_tpu_torch.convert import senet_to_jax
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.ops import quant
    from moc_tpu_torch.utils.checkpoint import save_params

    bags = [read_bag_pt(os.path.join(root, "bags", "pt_files", f"{s}.pt")) for s in ids]
    n_batches = math.ceil(N_SLIDES / BATCH)
    out = {}
    for name, flags in TIERS.items():
        server = serve.Server(server_args(root, "cuda", extra=flags))
        cpu_server = serve.Server(server_args(root, "cpu", extra=flags))
        for srv in (server, cpu_server):  # the resident weights, for the checks below
            srv.senet = predict.load_senet(srv.args.model).to(srv.device)
            srv.w = torch.from_numpy(np.load(srv.args.weights_npz)["weights"]).to(srv.device)
            srv.w_ext = torch.from_numpy(np.load(srv.args.weights_ext_npz)["weights"]).to(
                srv.device)
        cfg, dtype = server.cfg, server.dtype
        rows, launches, wall = _drain(server, root, name)
        cpu_rows, _, cpu_wall = _drain(cpu_server, root, f"{name}_cpu")
        want = {"rows": 0 if cfg.dense else n_batches, "cols": n_batches}
        check(launches == want, f"[tiers] {name}: K1 launches {launches}, want {want}")
        check([r["slide_id"] for r in rows] == [r["slide_id"] for r in cpu_rows],
              f"[tiers] {name}: the card's rows are not the CPU's")
        probs = np.array([[float(r[f"prob_{c}"]) for c in range(N_CLASSES)] for r in rows])
        check(bool(np.isfinite(probs).all()) and np.abs(probs.sum(1) - 1).max() < 1e-5,
              f"[tiers] {name}: probabilities not finite or not summing to 1")
        rec = {"launches": launches, "drain_s": wall, "drain_cpu_s": cpu_wall,
               "pred_equal": all(a["pred"] == b["pred"] for a, b in zip(rows, cpu_rows))}
        logit_err, held, bf16 = 0.0, [0, 0], []
        for i in range(0, N_SLIDES, BATCH):
            gpu_batch = pack_bags(bags[i:i + BATCH], n_pad=N_PAD, device="cuda", dtype=dtype)
            cpu_batch = pack_bags(bags[i:i + BATCH], n_pad=N_PAD, device="cpu", dtype=dtype)
            lg = server.batch_logits(gpu_batch).cpu()
            lc = cpu_server.batch_logits(cpu_batch)
            check(bool(torch.isfinite(lg).all()) and lg.shape == (BATCH, N_CLASSES),
                  f"[tiers] {name}: logits {tuple(lg.shape)} not finite")
            err = (lg - lc).abs().max().item()
            logit_err = max(logit_err, err)
            moved = 0
            if name == "score_bf16":  # pooled logits are held where no union row moved
                bf16.append(_bf16_selection_close(gpu_batch, cpu_batch, server, cpu_server))
                moved = bf16[-1]["rows_moved"]
            check(moved > 0 or torch.allclose(lg, lc, rtol=CARD_CPU_RTOL, atol=CARD_CPU_ATOL),
                  f"[tiers] {name}: pooled logits differ from the CPU's by {err}")
            h = _tier_masks(server, gpu_batch, cfg)
            held = [held[0] + h[0], held[1] + h[1]]
            if dtype == torch.int8:
                w_cat = torch.cat([server.w, server.w_ext, server.senet.dense0.weight.t()], 1)
                got = quant.int8_row_matmul(gpu_batch.features, gpu_batch.scales, w_cat).cpu()
                ref = quant.int8_row_matmul(cpu_batch.features, cpu_batch.scales,
                                            w_cat.cpu())
                check(torch.equal(got, ref), f"[tiers] {name}: the int8 product on the card "
                      f"differs from the CPU's by {(got - ref).abs().max().item()}")
        if bf16:
            rec["bf16_selection"] = {"min_overlap": min(b["min_overlap"] for b in bf16),
                                     "rows_moved": sum(b["rows_moved"] for b in bf16),
                                     "view_err": max(b["view_err"] for b in bf16)}
        rec.update(logit_err=logit_err, masks_held=held)
        batch = pack_bags(bags[:BATCH], n_pad=N_PAD, device="cuda", dtype=dtype)

        def forward():
            server.batch_logits(batch)

        with torch.inference_mode():
            rec["forward_ms"] = _time_ms(forward, iters=30, warmup=5)
        rec.update(_pack_times(bags[:BATCH], server.args.storage_dtype))
        log(f"[tiers] {name} ({' '.join(flags) or 'f32, exact'}): watch_once {wall:.3f}s on "
            f"the card, {cpu_wall:.3f}s on the CPU; K1 launches {launches}; pooled logits "
            f"card vs CPU max |diff| {logit_err:.3e}; predictions equal: {rec['pred_equal']}; "
            f"K1 masks bit-equal to plain ({held[0]} selection-row, {held[1]} pooling elements); "
            f"forward {rec['forward_ms']:.4f} ms (CUDA events, median of 30); pack_bags "
            f"{rec['pack_ms']:.3f} ms, {rec['copied_bytes']} B to the card; pad step "
            f"native {rec['pad_native_ms']:.3f} ms, numpy {rec['pad_numpy_ms']:.3f} ms"
            + (f"; bf16 selection {rec['bf16_selection']}" if bf16 else "")
            + ("; int8 product equal to the CPU's" if dtype == torch.int8 else ""))
        log(f"[profile] tier {name}:")
        with torch.inference_mode():
            phase_profile(forward, steps=5, host_top=8)
        out[name] = rec

    # predict.main over the corpus: the exact tier's rows, as serve wrote them
    table = os.path.join(root, "slides.csv")
    with open(table, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(
            [("slide_id", "label"), *((s, ("LUAD", "LUSC")[i % N_CLASSES])
                                      for i, s in enumerate(ids))])
    pred_csv = os.path.join(root, "predicted.csv")
    argv = ["--dataset", "nsclc", "--model", os.path.join(root, "senet.pt"),
            "--feature_dir", os.path.join(root, "bags"), "--csv", table,
            "--weights_npz", os.path.join(root, "w.npz"),
            "--weights_ext_npz", os.path.join(root, "we.npz"), "--topj", str(TOPJ),
            "--topk", str(TOPK), "--batch_size", str(BATCH), "--out", pred_csv]
    rc = predict.main(argv)
    check(rc == 0, f"[tiers] predict.main returned {rc}")
    with open(pred_csv, newline="") as f:
        predicted = {r["slide_id"]: r for r in csv.DictReader(f)}
    with open(os.path.join(root, "served_exact.csv"), newline="") as f:
        served = {r["slide_id"]: r for r in csv.DictReader(f)}
    check(sorted(predicted) == sorted(served) == sorted(ids), "[tiers] predict's slides differ")
    for sid, r in served.items():
        p = predicted[sid]
        check(p["pred"] == r["pred"] and all(p[f"prob_{c}"] == r[f"prob_{c}"]
                                             for c in range(N_CLASSES)),
              f"[tiers] predict's row of {sid} differs from serve's: {p} vs {r}")
    # the port's .msgpack of the same SENet, served: the .pt's rows, bit for bit
    save_params(os.path.join(root, "senet.msgpack"),
                senet_to_jax(predict.load_senet(os.path.join(root, "senet.pt"))))
    msg_rows, _, _ = _drain(serve.Server(server_args(root, "cuda", model="senet.msgpack")),
                            root, "msgpack")
    check({r["slide_id"]: r for r in msg_rows} == served,
          "[tiers] the .msgpack SENet is served unlike the .pt")
    log(f"[tiers] predict.main over the {N_SLIDES} slides: rows equal to serve's exact tier; "
        f"the port's .msgpack of the SENet served as the .pt (rows equal)")
    return out


def write_patch_corpus(root: str) -> tuple[str, str, list[str]]:
    """A full-width release-layout CONCH checkpoint from seed 0 and the two
    raw-pixel ``.npz`` patch bags; returns (checkpoint, patch dir, bag paths)."""
    from moc_tpu_torch.zeroshot.convert import random_conch_state_dict

    t0 = time.perf_counter()
    ckpt = os.path.join(root, "conch.bin")
    sd = random_conch_state_dict(seed=0)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, ckpt)
    patch_dir = os.path.join(root, "patches")
    os.makedirs(os.path.join(patch_dir, "h5_files"))
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(SLIDE_PATCHES):
        paths.append(os.path.join(patch_dir, "h5_files", f"wsi_{i}.npz"))
        np.savez(paths[-1], imgs=rng.integers(0, 256, (n, PATCH_PX, PATCH_PX, 3), np.uint8),
                 coords=rng.integers(0, 100000, (n, 2)).astype(np.int32))
    log(f"[extract] fabricated a {sum(v.numel() for v in sd.values()) / 1e6:.1f}M-parameter "
        f"CONCH checkpoint and {len(paths)} patch bags in {time.perf_counter() - t0:.1f}s")
    return ckpt, patch_dir, paths


def run_extraction(ckpt: str, patch_dir: str, out_dir: str, bf16: bool) -> tuple[int, float]:
    """``cli.extract_features.main`` with K2 on the card; returns (K2 launches
    in the run, host wall seconds with reads, preprocessing and writes)."""
    from moc_tpu_torch.cli import extract_features
    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

    argv = ["--patch_dir", patch_dir, "--out_dir", out_dir, "--checkpoint", ckpt,
            "--backbone", "conch", "--flash", "--batch_size", str(EXTRACT_BATCH),
            "--out_format", "pt", "--device", "cuda"] + (["--bf16"] if bf16 else [])
    flash_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    rc = extract_features.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_fwd_cuda.launches
    check(rc == 0, f"extract_features.main returned {rc}")
    return launches, wall


def phase_extract(ckpt: str, patch_dir: str, paths: list[str], out_dir: str) -> dict:
    """The extraction path in f32 and bf16; the f32 bags against the dense
    path on the card and against the CPU."""
    from moc_tpu_torch.cli.extract_features import build_encoder
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.data.patches import PatchBagReader

    want_launches = TRUNK_LAYERS * EXTRACT_BATCHES
    pil = importlib.util.find_spec("PIL") is not None
    log(f"[extract] preprocessing resizes with {'PIL' if pil else 'the nearest-index fallback'}")
    res = {}
    for tier, bf16 in (("f32", False), ("bf16", True)):
        out = out_dir if not bf16 else out_dir + "_bf16"
        launches, wall = run_extraction(ckpt, patch_dir, out, bf16)
        n_img = sum(SLIDE_PATCHES)
        log(f"[extract] {tier} flash: {n_img} patches in {wall:.3f}s host wall "
            f"({n_img / wall:.1f} images/s, checkpoint load and reads included); "
            f"K2 launches {launches}")
        check(launches == want_launches,
              f"K2 launched {launches} times in the {tier} extraction, want {want_launches}")
        feats = []
        for i, n in enumerate(SLIDE_PATCHES):
            f = read_bag_pt(os.path.join(out, "pt_files", f"wsi_{i}.pt")).features
            check(f.shape == (n, 512), f"{tier} bag {i} has shape {f.shape}, want ({n}, 512)")
            # bf16 embeddings are normalised in bf16 (8 bits of mantissa)
            norm_err = np.abs(np.linalg.norm(f, axis=1) - 1).max()
            check(bool(np.isfinite(f).all()) and norm_err < (1e-2 if bf16 else 1e-4),
                  f"{tier} bag {i} is not finite and unit-norm (norm error {norm_err})")
            feats.append(f)
        res[tier] = {"launches": launches, "wall_s": wall, "images_per_s": n_img / wall,
                     "feats": feats}
    cos = min(float((a * b).sum(1).min()) for a, b in zip(res["f32"]["feats"],
                                                            res["bf16"]["feats"]))
    log(f"[extract] bf16 against f32 embeddings: least cosine {cos:.5f}")
    check(cos > 0.98, f"bf16 embeddings drift from f32 (least cosine {cos})")

    imgs = next(PatchBagReader(paths[0], image_size=448).batches(EXTRACT_BATCH))[0]
    dense = build_encoder("conch", ckpt, 448, True, False, flash=False, device="cuda")(imgs)
    e_dense = float(np.abs(dense - res["f32"]["feats"][0][:EXTRACT_BATCH]).max())
    check(e_dense < 1e-4, f"flash and dense embeddings differ by {e_dense}")
    cpu = build_encoder("conch", ckpt, 448, True, False, flash=True, device="cpu")(imgs[:2])
    e_cpu = float(np.abs(cpu - res["f32"]["feats"][0][:2]).max())
    check(e_cpu < 1e-4, f"GPU and CPU embeddings differ by {e_cpu}")
    log(f"[extract] f32 flash embeddings against the dense path on the card ({EXTRACT_BATCH} "
        f"images): max |diff| {e_dense:.3e}; against the CPU (2 images): {e_cpu:.3e} "
        "(atol 1e-4)")
    return res


def phase_serve_extracted(root: str, out_dir: str) -> dict:
    """The extracted bags drained through the serving daemon on the card."""
    from moc_tpu_torch.cli import serve
    from moc_tpu_torch.ops import topk_kernel

    server = serve.Server(server_args(root, "cuda", watch_dir=out_dir))
    out_csv = os.path.join(root, "served_extracted.csv")
    rows_fn, cols_fn = (topk_kernel.topk_threshold_mask_cuda,
                        topk_kernel.col_topk_threshold_mask_cuda)
    rows_fn.launches = cols_fn.launches = 0
    n = serve.watch_once(server, out_dir, out_csv, set())
    torch.cuda.synchronize()
    launches = {"rows": rows_fn.launches, "cols": cols_fn.launches}
    check(n == len(SLIDE_PATCHES), f"watch_once scored {n} of the extracted slides")
    check(launches["rows"] > 0 and launches["cols"] > 0, f"K1 launches {launches}")
    with open(out_csv, newline="") as f:
        lines = list(csv.DictReader(f))
    check(sorted(r["slide_id"] for r in lines) == [f"wsi_{i}" for i in range(len(SLIDE_PATCHES))],
          "an extracted slide is missing from the CSV")
    probs = np.array([[float(r[f"prob_{c}"]) for c in range(N_CLASSES)] for r in lines])
    check(bool(np.isfinite(probs).all()) and np.abs(probs.sum(1) - 1).max() < 1e-5,
          "probabilities of the extracted slides are not finite or do not sum to 1")
    log(f"[e2e] raw patches -> CONCH features -> MOC rows on the card: {n} slides, "
        f"probabilities {probs.round(4).tolist()}, K1 launches {launches}")
    return launches


def nsclc_prompts() -> list[str]:
    """Every prompt of the vendored nsclc banks, ``W``'s and ``W_ext``'s (176),
    class by class: the texts a zero-shot weight build for nsclc encodes."""
    from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT, NSCLC
    from moc_tpu_torch.zeroshot import load_prompt_bank

    out = []
    for f, labels in ((NSCLC.prompt_file, NSCLC.label_dict),
                      (NSCLC.prompt_file_ext, NSCLC.label_dict_ext)):
        bank = load_prompt_bank(os.path.join(DEFAULT_PROMPT_ROOT, f), labels)
        out += [t for c in range(bank.n_classes) for alias in bank.texts_for_class(c)
                for t in alias]
    return out


def musk_text_segments() -> torch.Tensor:
    """Segment ids ``[176, 100]`` on the card of the nsclc banks under MUSK's
    hash tokenizer: 1 on tokens, 0 on padding (``nn.encoder``'s convention)."""
    from moc_tpu_torch.zeroshot.musk_tokenizer import MuskTokenizer

    _, pad = MuskTokenizer(max_len=MUSK_TEXT_LEN)(nsclc_prompts())
    return torch.from_numpy(~pad).int().cuda()


def phase_flash_times() -> dict:
    """K2 at each shape of ``K2_SHAPES``: its O and lse held against its
    plain version on the same tensors, then its time per launch against its
    bound, its plain version and one library call
    (``scaled_dot_product_attention`` with the same mask). Returns
    ``records[tier][cell]``."""
    import torch.nn.functional as F

    from moc_tpu_torch.ops.flash_attention import mha_reference
    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {"f32": {}, "bf16": {}}
    with torch.inference_mode():
        for cell, shape in K2_SHAPES.items():
            seg = musk_text_segments() if cell == "musk_text" else None
            if seg is not None:
                shape = (seg.shape[0],) + shape[1:]
            b, h, length, d = shape
            # the library's mask: a query sees the keys of its own segment
            mask = None if seg is None else (seg[:, None, :, None] == seg[:, None, None, :])
            # the query-key pairs the function needs: every pair, or those within
            # a segment (a row's real tokens, and its padding among itself)
            pairs = (b * length * length if seg is None
                     else int(((seg == 1).sum(1) ** 2 + (seg == 0).sum(1) ** 2).sum()))
            for dtype, name, peak in ((torch.float32, "f32", F32_ACCURATE_OPS_PER_S),
                                      (torch.bfloat16, "bf16", BF16_OPS_PER_S)):
                q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                o, lse = flash_fwd_cuda(q, k, v, seg, seg)
                ro, rlse = mha_reference(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
                err = _k2_errors(o, lse, ro, rlse, dtype, f"{name} at {list(shape)}"
                                 + (" with segments" if seg is not None else ""))
                log(f"[parity] K2 {name} {list(shape)}{' segments' if seg is not None else ''}"
                    f": max |O - plain| {err['o']:.3e} ({err['max_rel']:.3e} of the largest "
                    f"|O|), max |lse - plain| {err['lse']:.3e} (tolerance {K2_TOL[dtype]}); "
                    f"mean |O - plain| / mean |plain| {err['mean_rel']:.3e}")
                del o, lse, ro, rlse
                # q, k, v read once and O written once, plus the f32 lse and the
                # int32 segment ids; two products of 2·D operations per pair a head
                bytes_s = (4 * q.numel() * q.element_size() + b * h * length * 4
                           + (0 if seg is None else 2 * seg.numel() * 4)) / HBM_BYTES_PER_S
                ops_s = 4 * h * pairs * d / peak
                rec = {"shape": list(shape), "segments": seg is not None,
                       "max_abs_err": max(err["o"], err["lse"]), "max_rel": err["max_rel"],
                       "ms": _time_ms(lambda: flash_fwd_cuda(q, k, v, seg, seg)),
                       **_kernel_us(lambda: flash_fwd_cuda(q, k, v, seg, seg), K2_KERNEL[dtype],
                                    flash_fwd_cuda),
                       "plain_ms": _time_ms(lambda: mha_reference(
                           q, k, v, q_segment_ids=seg, kv_segment_ids=seg), iters=20, warmup=3),
                       "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask)),
                       "bound_ms": max(bytes_s, ops_s) * 1e3,
                       "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
                records[name][cell] = rec
                log(f"[times] K2 {name} {list(shape)}: kernel {rec['ms']:.4f} ms "
                    f"({ops_s * peak / rec['ms'] / 1e9:.1f} TFLOP/s) per call, "
                    f"{_us(rec['kernel_us'])} kernel-only (profiler), {_us(rec['device_us'])} "
                    f"a call queued behind a spin, plain "
                    f"{rec['plain_ms']:.4f} ms, scaled_dot_product_attention "
                    f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']}; {ops_s * peak / 1e9:.1f} GFLOP)")
                del q, k, v
    return records


def phase_encode_tiers(ckpt: str) -> None:
    """The batch-64 ``encode_image`` forward in four tiers, by CUDA events,
    and a profile of the f32 flash forward."""
    from moc_tpu_torch.zeroshot.convert import load_conch

    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randn((EXTRACT_BATCH, 448, 448, 3), generator=gen, device="cuda")
    for dtype, tier in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for attn_impl in ("dense", "flash"):
            model = load_conch(ckpt, attn_impl=attn_impl, device="cuda").to(dtype)
            x = images.to(dtype)
            with torch.inference_mode():
                def forward():
                    model.encode_image(x)

                ms = _time_ms(forward, iters=10, warmup=2)
                log(f"[times] encode_image batch {EXTRACT_BATCH} {tier} {attn_impl}: "
                    f"{ms:.3f} ms by CUDA events (median of 10), "
                    f"{EXTRACT_BATCH / ms * 1e3:.1f} images/s")
                if tier == "f32" and attn_impl == "flash":
                    phase_profile(forward, steps=3)
            del model, x
            torch.cuda.empty_cache()


def _least_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a * b).sum(1).div(a.norm(dim=1) * b.norm(dim=1)).min())


def _tiers_forward(name: str, card, forward_of, images, want_launches: int) -> dict:
    """The batch forward of ``card`` in f32 and in bf16 (a bf16 copy of the
    weights and images): the output, K2's launches in one forward (checked
    against ``want_launches``), the forward by CUDA events and a profile of
    it. Returns ``{tier: {...}}``."""
    import copy

    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

    res = {}
    for tier, dtype, iters in (("f32", torch.float32, 5), ("bf16", torch.bfloat16, 10)):
        model = card if dtype == torch.float32 else copy.deepcopy(card).to(dtype)
        x = images.to(dtype)
        with torch.inference_mode():
            def forward():
                return forward_of(model, x)

            flash_fwd_cuda.launches = 0
            out = forward().float()
            torch.cuda.synchronize()
            launches = flash_fwd_cuda.launches
            check(launches == want_launches,
                  f"[{name}] {tier}: K2 launched {launches} times in one forward, "
                  f"want {want_launches}")
            check(bool(torch.isfinite(out).all()), f"[{name}] {tier}: output not finite")
            ms = _time_ms(forward, iters=iters, warmup=1)
            prof = phase_profile(forward, steps=2, what=f"{name} {tier} forward")
        res[tier] = {"out": out, "ms": ms, "images_per_s": images.shape[0] / ms * 1e3,
                     "k2_launches": launches, "busy": prof.get("busy"),
                     "device_us": prof.get("device_us"), "k2_share": prof.get("flash_fwd_share")}
        log(f"[{name}] batch {images.shape[0]} {tier} forward: {ms:.3f} ms by CUDA events "
            f"(median of {iters}), {res[tier]['images_per_s']:.1f} images/s, K2 launches "
            f"{launches}, busy {100 * (prof.get('busy') or 0):.1f}%, K2 "
            f"{100 * (prof.get('flash_fwd_share') or 0):.1f}% of the device time")
        if model is not card:
            del model
        del x
        torch.cuda.empty_cache()
    return res


def phase_musk(root: str) -> dict:
    """``[musk]``: MUSK-large fabricated at full width in the release layout
    (seed 6), saved in half precision under ``{"model": ...}`` and loaded by
    ``load_musk`` on the card and on the CPU; the batch-64 vision forward in
    f32 and bf16 (K2 24 times a forward), f32 embeddings of
    ``MUSK_CPU_IMAGES`` images within 1e-4 of the CPU, bf16 against f32 by
    the least cosine; the text tower over the nsclc banks through the hash
    tokenizer (its padding as segment ids) and ``MUSK_CPU_PROMPTS`` rows
    within 1e-4 of the CPU; one mixed call (2 images, 2 prompts) against
    the CPU on every real token. Returns the checkpoint's path and the
    records."""
    from moc_tpu_torch.models.musk import MuskConfig
    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda
    from moc_tpu_torch.zeroshot.convert_musk import load_musk, random_musk_state_dict
    from moc_tpu_torch.zeroshot.musk_tokenizer import MuskTokenizer

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sd = random_musk_state_dict(seed=6)
    ckpt = os.path.join(root, "musk.pth")
    torch.save({"model": {k: v.half() for k, v in sd.items()}}, ckpt)
    del sd
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = load_musk(ckpt, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    cpu = load_musk(ckpt, device="cpu")
    check(card.cfg == MuskConfig(), f"[musk] config read off the checkpoint: {card.cfg}")
    n_params = sum(p.numel() for p in card.parameters())
    log(f"[musk] fabricated a release-layout MUSK-large checkpoint (half precision, "
        f"{os.path.getsize(ckpt) / 1e9:.2f} GB) in {t_write:.1f}s; load_musk on cuda "
        f"{t_load:.2f}s: {n_params / 1e6:.1f}M parameters, 24 x 1024, 16 heads, 384 px")
    gen = torch.Generator(device="cuda").manual_seed(7)
    images = torch.randn((EXTRACT_BATCH, 384, 384, 3), generator=gen, device="cuda")
    res = _tiers_forward("musk", card, lambda m, x: m(images=x)[0], images, MUSK_LAYERS)
    f32, bf16 = res["f32"]["out"], res["bf16"]["out"]
    norm_err = float((f32.norm(dim=1) - 1).abs().max())
    check(f32.shape == (EXTRACT_BATCH, MUSK_OUT) and norm_err < 1e-4,
          f"[musk] vision embeddings {tuple(f32.shape)}, norm error {norm_err}")
    cos = _least_cosine(f32, bf16)
    check(cos > 0.98, f"[musk] bf16 vision embeddings drift from f32 (least cosine {cos})")
    with torch.inference_mode():
        want = cpu(images=images[:MUSK_CPU_IMAGES].cpu())[0]
        err_v = float((f32[:MUSK_CPU_IMAGES].cpu() - want).abs().max())
        check(err_v <= 1e-4, f"[musk] vision embeddings: max |card - CPU| {err_v}")
        prompts = nsclc_prompts()
        ids, pad = (torch.from_numpy(a) for a in MuskTokenizer(max_len=MUSK_TEXT_LEN)(prompts))
        ids = ids.long()
        ids_c, pad_c = ids.cuda(), pad.cuda()

        def text():
            return card(token_ids=ids_c, text_padding_mask=pad_c)[1]

        flash_fwd_cuda.launches = 0
        emb_t = text()
        torch.cuda.synchronize()
        text_launches = flash_fwd_cuda.launches
        check(text_launches == MUSK_LAYERS, f"[musk] text: K2 launched {text_launches} times")
        text_ms = _time_ms(text, iters=10, warmup=1)
        n = MUSK_CPU_PROMPTS
        want_t = cpu(token_ids=ids[:n], text_padding_mask=pad[:n])[1]
        err_t = float((emb_t[:n].cpu() - want_t).abs().max())
        check(emb_t.shape == (len(prompts), MUSK_OUT) and bool(torch.isfinite(emb_t).all())
              and err_t <= 1e-4, f"[musk] text embeddings {tuple(emb_t.shape)}: max |card - "
              f"CPU| {err_t}")
        mixed = {dev: model.beit3(textual_tokens=ids[:2].to(dev),
                                  visual_tokens=images[:2].to(dev),
                                  text_padding_mask=pad[:2].to(dev))[0].cpu()
                 for dev, model in (("cuda", card), ("cpu", cpu))}
        real = ~torch.cat([torch.zeros(2, card.cfg.n_vision_tokens, dtype=torch.bool), pad[:2]],
                          dim=1)
        err_m = float((mixed["cuda"] - mixed["cpu"])[real].abs().max())
        check(err_m <= 1e-4, f"[musk] mixed call: max |card - CPU| {err_m} on real tokens")
    log(f"[musk] f32 vision embeddings of {MUSK_CPU_IMAGES} images against the CPU: max |diff| "
        f"{err_v:.3e}; text over the nsclc banks ({len(prompts)} prompts, "
        f"{int((~pad).sum())} real of {pad.numel()} tokens, segments into K2): {text_ms:.3f} ms "
        f"by CUDA events, {text_launches} K2 launches, {n} rows against the CPU {err_t:.3e}; "
        f"mixed call (2 images + 2 prompts, split 577) against the CPU {err_m:.3e} (limit 1e-4); "
        f"bf16 against f32 vision embeddings: least cosine {cos:.5f}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"ckpt": ckpt, "params": n_params, "load_s": t_load, "write_s": t_write,
            "vision": {t: {k: v for k, v in r.items() if k != "out"} for t, r in res.items()},
            "bf16_least_cosine": cos, "vision_err": err_v, "text_err": err_t,
            "mixed_err": err_m, "text_ms": text_ms, "text_launches": text_launches,
            "text_prompts": len(prompts)}


def phase_resnet(root: str) -> dict:
    """``[resnet]``: a torchvision-layout ResNet-50 state dict fabricated
    from seed 8 (random BatchNorm statistics, ``layer4`` and ``fc``
    included), loaded by ``load_resnet50`` on the card and on the CPU; the
    batch-64 trunk at 256 px in f32 and bf16 with TF32 off, ``RESNET_CPU_IMAGES``
    rows within 1e-4 of the CPU, bf16 against f32 by the least cosine."""
    from moc_tpu_torch.models.convert_resnet import load_resnet50, random_resnet50_state_dict

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ckpt = os.path.join(root, "resnet50.pth")
    torch.save(random_resnet50_state_dict(seed=8), ckpt)
    card = load_resnet50(ckpt, device="cuda")
    cpu = load_resnet50(ckpt, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(9)
    images = torch.randn((EXTRACT_BATCH, RESNET_PX, RESNET_PX, 3), generator=gen, device="cuda")
    res = _tiers_forward("resnet", card, lambda m, x: m(x), images, 0)
    f32 = res["f32"]["out"]
    check(f32.shape == (EXTRACT_BATCH, 1024), f"[resnet] features {tuple(f32.shape)}")
    with torch.inference_mode():
        want = cpu(images[:RESNET_CPU_IMAGES].cpu())
    err = float((f32[:RESNET_CPU_IMAGES].cpu() - want).abs().max())
    check(err <= 1e-4, f"[resnet] features: max |card - CPU| {err}")
    cos = _least_cosine(f32, res["bf16"]["out"])
    check(cos > 0.98, f"[resnet] bf16 features drift from f32 (least cosine {cos})")
    log(f"[resnet] f32 features of {RESNET_CPU_IMAGES} images against the CPU: max |diff| "
        f"{err:.3e} (limit 1e-4; largest |feature| {float(want.abs().max()):.3f}); bf16 "
        f"against f32: least cosine {cos:.5f}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"ckpt": ckpt, "err": err, "bf16_least_cosine": cos,
            "forward": {t: {k: v for k, v in r.items() if k != "out"} for t, r in res.items()}}


# the extraction cohort of the other backbones: two slides and a small one that
# also runs on the CPU; the --wsi_dir cohort: two PNG slides and their coords
BACKBONE_SLIDES = {"s0": 160, "s1": 90, "tiny": 3}
WSI_SLIDES = {"big": (2048, 2048), "tiny": (600, 500)}
BACKBONE_DIM = {"musk": MUSK_OUT, "resnet50": 1024, "debug": 512}


def write_backbone_corpus(root: str) -> dict:
    """The raw-pixel ``.npz`` patch bags (256 px) and the ``--wsi_dir``
    cohort: PNG slides with coords-only ``.npz`` bags (a 256 px grid, and
    crops past the right and bottom edges); a CSV naming the small slide."""
    from PIL import Image

    rng = np.random.default_rng(10)
    dirs = {k: os.path.join(root, k) for k in ("bb_patches", "bb_coords", "bb_wsi")}
    for d in dirs.values():
        os.makedirs(os.path.join(d, "h5_files"), exist_ok=True)
    for slide, n in BACKBONE_SLIDES.items():
        np.savez(os.path.join(dirs["bb_patches"], "h5_files", f"{slide}.npz"),
                 imgs=rng.integers(0, 256, (n, PATCH_PX, PATCH_PX, 3), np.uint8),
                 coords=rng.integers(0, 100000, (n, 2)).astype(np.int32))
    wsi_patches = {}
    for slide, (w, h) in WSI_SLIDES.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(dirs["bb_wsi"], f"{slide}.png"))
        grid = [(x, y) for y in range(0, h - PATCH_PX + 1, PATCH_PX)
                for x in range(0, w - PATCH_PX + 1, PATCH_PX)]
        edge = [(w - 100, 0), (0, h - 50), (w - 30, h - 30)]
        coords = np.asarray(grid + edge, np.int32)
        np.savez(os.path.join(dirs["bb_coords"], "h5_files", f"{slide}.npz"), coords=coords)
        wsi_patches[slide] = len(coords)
    csv_path = os.path.join(root, "bb_tiny.csv")
    with open(csv_path, "w") as f:
        f.write("slide_id\ntiny\n")
    return {**dirs, "csv": csv_path, "wsi_patches": wsi_patches}


def _extract_run(corpus: dict, out: str, backbone: str, ckpt: str | None, device: str,
                 wsi: bool) -> tuple[int, float]:
    """``cli.extract_features.main`` over the cohort on ``device`` (on the CPU
    the small slide alone, at batch 4); returns (K2 launches, host wall s)."""
    from moc_tpu_torch.cli import extract_features
    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

    argv = ["--patch_dir", corpus["bb_coords" if wsi else "bb_patches"], "--out_dir", out,
            "--backbone", backbone, "--out_format", "pt", "--device", device,
            "--batch_size", str(EXTRACT_BATCH if device == "cuda" else 4)]
    argv += ["--checkpoint", ckpt] if ckpt else []
    argv += ["--wsi_dir", corpus["bb_wsi"], "--wsi_ext", ".png",
             "--patch_size", str(PATCH_PX)] if wsi else []
    argv += ["--csv", corpus["csv"]] if device == "cpu" else []
    flash_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    rc = extract_features.main(argv)
    if device == "cuda":
        torch.cuda.synchronize()
    check(rc == 0, f"extract_features.main {backbone} on {device} returned {rc}")
    return flash_fwd_cuda.launches, time.perf_counter() - t0


def phase_extract_backbones(root: str, musk_ckpt: str, resnet_ckpt: str) -> dict:
    """``[extract]`` beyond CONCH: ``cli.extract_features.main`` with
    ``--backbone musk`` (the half-precision MUSK-large file), ``resnet50``
    and ``debug`` over ``BACKBONE_SLIDES``, and ``resnet50`` with
    ``--wsi_dir`` over the PNG slides, on the card: every bag of the
    backbone's width, finite, unit-norm but for resnet50; MUSK launching K2
    24 times a batch; and the small slide's rows within 1e-4 of a CPU run."""
    from moc_tpu_torch.data.bags import read_bag_pt

    corpus = write_backbone_corpus(root)
    runs = {}
    for name, backbone, ckpt, wsi in (("musk", "musk", musk_ckpt, False),
                                      ("resnet50", "resnet50", resnet_ckpt, False),
                                      ("debug", "debug", None, False),
                                      ("wsi_resnet50", "resnet50", resnet_ckpt, True)):
        out = {dev: os.path.join(root, f"bb_out_{name}_{dev}") for dev in ("cuda", "cpu")}
        launches, wall = _extract_run(corpus, out["cuda"], backbone, ckpt, "cuda", wsi)
        _extract_run(corpus, out["cpu"], backbone, ckpt, "cpu", wsi)
        slides = corpus["wsi_patches"] if wsi else BACKBONE_SLIDES
        n_img = sum(slides.values())
        batches = sum(math.ceil(n / EXTRACT_BATCH) for n in slides.values())
        want_launches = MUSK_LAYERS * batches if backbone == "musk" else 0
        check(launches == want_launches, f"[extract] {name}: K2 launched {launches} times, "
              f"want {want_launches}")
        for slide, n in slides.items():
            f = read_bag_pt(os.path.join(out["cuda"], "pt_files", f"{slide}.pt")).features
            check(f.shape == (n, BACKBONE_DIM[backbone]) and bool(np.isfinite(f).all()),
                  f"[extract] {name} bag {slide}: shape {f.shape}")
            if backbone != "resnet50":
                norm_err = float(np.abs(np.linalg.norm(f, axis=1) - 1).max())
                check(norm_err < 1e-4, f"[extract] {name} bag {slide}: norm error {norm_err}")
        got, want = (read_bag_pt(os.path.join(out[dev], "pt_files", "tiny.pt")).features
                     for dev in ("cuda", "cpu"))
        err = float(np.abs(got - want).max())
        check(err <= 1e-4, f"[extract] {name}: the small slide's rows differ from the CPU's "
              f"by {err}")
        runs[name] = {"images": n_img, "wall_s": wall, "images_per_s": n_img / wall,
                      "launches": launches, "cpu_rows": len(want), "max_abs_err": err}
        log(f"[extract] {name}: {n_img} patches of {len(slides)} slides in {wall:.3f}s host "
            f"wall ({n_img / wall:.1f} images/s, checkpoint load, reads and preprocessing "
            f"included); K2 launches {launches}; the small slide's {len(want)} rows against "
            f"the CPU: max |diff| {err:.3e} (limit 1e-4)")
    return runs


def _bwd_errors(got, want, dtype) -> dict:
    """Largest |kernel - plain| of K3 (dq) and of K4 (dk, dv), the largest of
    the three over the largest |grad|, and the largest mean |kernel - plain| /
    mean |plain| of the three; fails past ``BWD_TOL``, in f32 past
    ``F32_BWD_MAX_REL`` of the largest |grad|, and in bf16 past
    ``BF16_MEAN_REL``."""
    largest = max(w.float().abs().max().item() for w in want)
    errs, rels = [], []
    for g, w in zip(got, want):
        check(g.dtype == dtype and g.shape == w.shape, f"gradient {g.dtype} {tuple(g.shape)}")
        e = (g.float() - w.float()).abs().max().item()
        errs.append(e)
        if dtype == torch.float32:
            ok = (torch.allclose(g, w, rtol=BWD_TOL[dtype], atol=BWD_TOL[dtype])
                  and e <= F32_BWD_MAX_REL * largest)
        else:
            ok = e <= BWD_TOL[dtype] * largest
        check(ok, f"K3/K4 differ from flash_bwd_reference by {e} (largest |grad| {largest})")
        rels.append(_mean_rel(g, w, dtype, "K3/K4 against flash_bwd_reference"))
    return {"dq": errs[0], "dkv": max(errs[1:]), "max_rel": max(errs) / largest,
            "mean_rel": max(rels), "mean_rel_dq": rels[0]}


def _bwd_inputs(q, k, v, qs, ks, causal, gen):
    """K2's o and lse for q, k, v, a random dO and delta = rowsum(dO * O)."""
    from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

    o, lse = flash_fwd_cuda(q, k, v, qs, ks, causal=causal)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    return o, lse, do, (o.float() * do.float()).sum(-1)


def phase_flash_bwd_parity() -> dict:
    """K3 and K4 against ``flash_bwd_reference`` on the card over the grid of
    K2's parity phase; returns, per dtype, the largest |kernel - plain|."""
    from moc_tpu_torch.ops.flash_attention import flash_bwd_reference
    from moc_tpu_torch.ops.flash_kernel import flash_bwd_dkv_cuda, flash_bwd_dq_cuda

    gen = torch.Generator(device="cuda").manual_seed(4)
    err = {dt: {"dq": 0.0, "dkv": 0.0, "max_rel": 0.0, "mean_rel": 0.0, "mean_rel_dq": 0.0}
           for dt in BWD_TOL}
    cases = 0
    with torch.inference_mode():
        for dtype in BWD_TOL:
            for d in (32, 64, 128):
                for length in (785, 1024):
                    for causal in (False, True):
                        for segments in (False, True):
                            q, k, v, qs, ks = _flash_inputs(2, 3, length, d, dtype, segments,
                                                            causal, gen)
                            o, lse, do, delta = _bwd_inputs(q, k, v, qs, ks, causal, gen)
                            before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
                            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, qs, ks,
                                                   causal=causal)
                            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, qs, ks,
                                                        causal=causal)
                            torch.cuda.synchronize()
                            check((flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
                                  == (before[0] + 1, before[1] + 1), "K3/K4 launch not counted")
                            want = flash_bwd_reference(q, k, v, o, lse, do, qs, ks, causal)
                            e = _bwd_errors((dq, dk, dv), want, dtype)
                            err[dtype] = {kk: max(err[dtype][kk], e[kk]) for kk in e}
                            cases += 1
    for dtype, e in err.items():
        log(f"[parity] K3/K4 {dtype}: max |dq - plain| {e['dq']:.3e}, max |dk, dv - plain| "
            f"{e['dkv']:.3e} (tolerance {BWD_TOL[dtype]}"
            f"{'' if dtype == torch.float32 else ' of the largest |grad|'}); at most "
            f"{e['max_rel']:.3e} of the case's largest |grad|"
            f"{f' (limit {F32_BWD_MAX_REL})' if dtype == torch.float32 else ''}; mean "
            f"|grad - plain| / mean |plain| at most {e['mean_rel']:.3e} (dq alone "
            f"{e['mean_rel_dq']:.3e})")
    log(f"[parity] K3 and K4 match flash_bwd_reference on {cases} cases (f32/bf16, "
        "D 32/64/128, L 785/1024, causal or not, segments with rows masked everywhere)")
    return err


def _counters():
    from moc_tpu_torch.ops.flash_kernel import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                                flash_fwd_cuda)

    return {"K2": flash_fwd_cuda, "K3": flash_bwd_dq_cuda, "K4": flash_bwd_dkv_cuda}


def run_pretrain_cli(tier: str) -> dict:
    """``cli.pretrain.main`` at the full width on the card; returns the
    per-step losses from its log, its K2/K3/K4 launches and host wall."""
    import contextlib
    import io

    from moc_tpu_torch.cli import pretrain

    argv = [*PRETRAIN_ARGV, "--steps", str(PRETRAIN_STEPS), "--log_every", "1",
            "--device", "cuda"] + (["--compute_dtype", "bfloat16"] if tier == "bf16" else [])
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    err, out = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = pretrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check(rc == 0, f"cli.pretrain.main returned {rc}")
    losses = [float(line.split("loss=")[1].split()[0]) for line in err.getvalue().splitlines()
              if line.startswith("step ")]
    final = out.getvalue().strip().splitlines()[-1]
    log(f"[pretrain] {tier}: {final}; losses {losses}; {wall:.2f}s host wall for "
        f"{PRETRAIN_STEPS} steps (model set-up included); launches {launches}")
    check(len(losses) == PRETRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"{tier} pretraining losses {losses} are not {PRETRAIN_STEPS} finite values")
    want = PRETRAIN_LAYERS * PRETRAIN_STEPS
    check(launches == {"K2": want, "K3": want, "K4": want},
          f"{tier} pretraining launched {launches}, want {want} of each")
    return {"launches": launches, "losses": losses, "wall_s": wall}


def _first_grads(cfg, state: dict, batch, device: str) -> dict:
    """The gradients of the first step from ``state`` on ``device``, on the CPU."""
    from moc_tpu_torch.train.pretrain import batch_to, make_pretrain_state, masked_token_loss

    model, _ = make_pretrain_state(cfg, device=device, state_dict=state)
    total, _, _ = masked_token_loss(cfg, model, *batch_to(torch.device(device), *batch))
    total.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def phase_pretrain_narrow() -> dict:
    """A 2-layer run at the CLI's default width (heads of 32) from one state
    dict and one ``data_fn``, on the card and on the CPU: the first step's
    gradients within 1e-4 of each parameter's largest |grad|, three steps'
    losses within 1e-4 and parameters within 3·lr (Adam moves a weight whose
    gradient is below the two devices' rounding noise by up to lr a step,
    whatever that gradient's size, so only its bound holds there)."""
    from moc_tpu_torch.cli import pretrain
    from moc_tpu_torch.train.pretrain import MaskedTokenModel, run_pretrain

    args = pretrain.get_args(NARROW_ARGV)
    cfg = pretrain.build_config(args)
    data_fn = pretrain.make_data_fn(args)
    state = MaskedTokenModel(cfg).init_parameters(torch.Generator().manual_seed(0)).state_dict()
    gg, gc = (_first_grads(cfg, state, data_fn(0), device) for device in ("cuda", "cpu"))
    grad_err = 0.0
    for name, g in gc.items():
        if name.endswith("k_proj.bias"):  # 0 in exact arithmetic: rounding noise on both
            continue
        grad_err = max(grad_err, float((gg[name] - g).abs().max() / g.abs().max()))
    check(grad_err <= 1e-4, f"narrow run gradients differ between card and CPU by {grad_err} "
          "of the largest |grad|")
    counters = _counters()
    runs = {}
    for device in ("cuda", "cpu"):
        before = {name: fn.launches for name, fn in counters.items()}
        model, _, losses = run_pretrain(cfg, data_fn, total_steps=3, device=device,
                                        state_dict=state)
        runs[device] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                        {name: fn.launches - before[name] for name, fn in counters.items()})
    (lg, pg, ng), (lc, pc, nc) = runs["cuda"], runs["cpu"]
    check(ng == {"K2": 6, "K3": 6, "K4": 6} and nc == {"K2": 0, "K3": 0, "K4": 0},
          f"narrow run launches: card {ng}, CPU {nc}")
    loss_err = max(abs(a - b) for a, b in zip(lg, lc))
    check(loss_err <= 1e-4, f"narrow run losses differ: card {lg}, CPU {lc}")
    param_err = max(float((t - pc[name]).abs().max()) for name, t in pg.items())
    check(param_err <= 3 * cfg.learning_rate,
          f"narrow run parameters differ between card and CPU by {param_err}")
    log(f"[pretrain] 2-layer run (width 256, 8 heads of 32, seq 128, batch 4) on the card "
        f"against the CPU: first-step gradients within {grad_err:.3e} of each largest |grad| "
        f"(tolerance 1e-4); 3 steps' losses {lg} vs {lc} (max |diff| {loss_err:.3e}, "
        f"tolerance 1e-4), parameters max |diff| {param_err:.3e} (tolerance 3 lr = "
        f"{3 * cfg.learning_rate}); card launches {ng}")
    return {"grad_err": grad_err, "loss_err": loss_err, "param_err": param_err}


def phase_flash_bwd_times() -> dict:
    """K3 and K4 at the pretraining shape, held against the plain version on
    the same tensors, then timed against their bounds, the plain version and
    the backward of ``scaled_dot_product_attention``; K2 at that shape."""
    import torch.nn.functional as F

    from moc_tpu_torch.ops.flash_attention import flash_bwd_reference, mha_reference
    from moc_tpu_torch.ops.flash_kernel import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                                flash_fwd_cuda)

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, length, d = PRETRAIN_SHAPE
    n = b * h * length * length * d
    records = {}
    for dtype, name, peak in ((torch.float32, "f32", F32_ACCURATE_OPS_PER_S),
                              (torch.bfloat16, "bf16", BF16_OPS_PER_S)):
        q, k, v = (torch.randn(PRETRAIN_SHAPE, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        with torch.no_grad():  # not inference mode: dO feeds the library's backward below
            o, lse, do, delta = _bwd_inputs(q, k, v, None, None, False, gen)
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
            want = flash_bwd_reference(q, k, v, o, lse, do)
            err = _bwd_errors((dq, dk, dv), want, dtype)
            err_k3, err_k4 = err["dq"], err["dkv"]
            del dq, dk, dv, want
            ro, rlse = mha_reference(q, k, v)
            k2 = _k2_errors(o, lse, ro, rlse, dtype, f"{name} at {list(PRETRAIN_SHAPE)}")
            k2_err = max(k2["o"], k2["lse"])
            del ro, rlse
            log(f"[parity] K3/K4 {name} {list(PRETRAIN_SHAPE)}: max |dq - plain| {err_k3:.3e} "
                f"(mean {err['mean_rel_dq']:.3e} of mean |plain|), max |dk, dv - plain| "
                f"{err_k4:.3e}, at most {err['max_rel']:.3e} of the largest |grad|; K2 max "
                f"|O, lse - plain| {k2_err:.3e} ({k2['max_rel']:.3e} of the largest |O|)")
            el = q.element_size()
            stats = b * h * length * 4  # one f32 [B, H, L] vector
            plain_ms = _time_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do), iters=20,
                                warmup=3)
            rec = {}
            # the profiler's names: flash_bwd_dq_ and flash_bwd_dkv_ match each
            # tier's kernel (the f32 tier's under any earlier name too)
            for kernel, fn, wrapper, ops, tensors in (
                    ("dq", lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta), flash_bwd_dq_cuda,
                     6 * n, 5),
                    ("dkv", lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
                     flash_bwd_dkv_cuda, 8 * n, 6)):
                # q, k, v, dO read once, lse and delta read once, grads written once
                bytes_s = (tensors * q.numel() * el + 2 * stats) / HBM_BYTES_PER_S
                ops_s = ops / peak
                rec[kernel] = {"ms": _time_ms(fn),
                               **_kernel_us(fn, f"flash_bwd_{kernel}_", wrapper),
                               "plain_ms": plain_ms,
                               "bound_ms": max(bytes_s, ops_s) * 1e3,
                               "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                               "max_abs_err": err_k3 if kernel == "dq" else err_k4,
                               "gflop": ops / 1e9}
            k2_bytes = (4 * q.numel() * el + stats) / HBM_BYTES_PER_S
            rec["k2_ms"] = _time_ms(lambda: flash_fwd_cuda(q, k, v))
            rec["k2_bound_ms"] = max(k2_bytes, 4 * n / peak) * 1e3
            rec["k2_library_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        # the library's backward, dq, dk and dv in one call (timed only)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves)
        lib_ms = _time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                          iters=50, warmup=5)
        del out, leaves
        for kernel in ("dq", "dkv"):
            rec[kernel]["library_ms"] = lib_ms
        records[name] = rec
        log(f"[times] {name} {list(PRETRAIN_SHAPE)}: K3 {rec['dq']['ms']:.4f} ms per call, "
            f"{_us(rec['dq']['kernel_us'])} kernel-only, {_us(rec['dq']['device_us'])} queued "
            f"(bound {rec['dq']['bound_ms']:.4f}, {rec['dq']['gflop']:.1f} GFLOP), "
            f"K4 {rec['dkv']['ms']:.4f} ms per call, {_us(rec['dkv']['kernel_us'])} kernel-only, "
            f"{_us(rec['dkv']['device_us'])} queued (bound {rec['dkv']['bound_ms']:.4f}, "
            f"{rec['dkv']['gflop']:.1f} GFLOP), plain backward {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention backward {lib_ms:.4f} ms (K3 + K4 together); "
            f"K2 {rec['k2_ms']:.4f} ms (bound {rec['k2_bound_ms']:.4f}), "
            f"scaled_dot_product_attention forward "
            f"{rec['k2_library_ms']:.4f} ms")
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()
    return records


def phase_pretrain_step_times() -> dict:
    """The full-width pretrain step by CUDA events (median of 5 after 2
    warm-ups) in f32 and bf16, tokens/s, peak memory, and a profile of one
    step in each."""
    from moc_tpu_torch.cli import pretrain
    from moc_tpu_torch.train.pretrain import batch_to, make_pretrain_state, make_train_step

    records = {}
    for tier in ("f32", "bf16"):
        argv = PRETRAIN_ARGV + (["--compute_dtype", "bfloat16"] if tier == "bf16" else [])
        args = pretrain.get_args(argv)
        cfg = pretrain.build_config(args)
        model, optimizer = make_pretrain_state(cfg, seed=0, device="cuda")
        step = make_train_step(cfg, model, optimizer)
        batch = batch_to(torch.device("cuda"), *pretrain.make_data_fn(args)(0))
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: step(*batch), iters=5, warmup=2)
        tokens = args.batch * args.seq_len
        rec = {"step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        records[tier] = rec
        log(f"[times] pretrain step {tier} (12 x 768, batch 32 x 512): {ms:.3f} ms by CUDA "
            f"events (median of 5), {rec['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{rec['peak_gib']:.2f} GiB")
        log(f"[profile] pretrain step {tier}:")
        phase_profile(lambda: step(*batch), steps=1, what="step")
        del model, optimizer, step, batch
        torch.cuda.empty_cache()
    return records


def _k1_wrappers():
    from moc_tpu_torch.ops import topk_kernel

    return {"rows": topk_kernel.topk_threshold_mask_cuda,
            "cols": topk_kernel.col_topk_threshold_mask_cuda}


def _main_moc_recorded(argv: list[str]):
    """``cli.main_moc.main(argv)`` with ``moc.episode.train_epoch`` swapped for
    a recorder and K1's counts set to 0 just before: returns the exit code,
    the standard output, the record (each epoch's losses, the K1 launches of
    the training steps, each epoch's training seconds and start), the K1
    launches of the whole run and its wall."""
    import contextlib
    import io

    from moc_tpu_torch.cli import main_moc
    from moc_tpu_torch.moc import episode

    k1 = _k1_wrappers()
    rec = {"losses": [], "steps": {"rows": 0, "cols": 0}, "train_s": [], "starts": []}
    inner = episode.train_epoch

    def recorded(*args, **kwargs):
        rec["starts"].append(time.perf_counter())
        before = {e: fn.launches for e, fn in k1.items()}
        losses = inner(*args, **kwargs)
        torch.cuda.synchronize()
        rec["train_s"].append(time.perf_counter() - rec["starts"][-1])
        for e, fn in k1.items():
            rec["steps"][e] += fn.launches - before[e]
        rec["losses"].append(losses.cpu().tolist())
        return losses

    episode.train_epoch = recorded  # run_episode looks it up at each call
    for fn in k1.values():
        fn.launches = 0
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main_moc.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        episode.train_epoch = inner
    launches = {e: fn.launches for e, fn in k1.items()}
    return rc, out.getvalue(), rec, launches, wall


def phase_train(root: str) -> dict:
    """``cli.main_moc.main`` on the card at the full-width synthetic protocol:
    every loss finite, the JAX package's result keys, test AUC at best val
    at least 0.8, K1 launched exactly twice a slide step (counted around each
    ``train_epoch``), and the saved ``.msgpack`` served by ``cli.serve``
    matching ``eval_batch`` on the test bags."""
    from moc_tpu_torch.cli import main_moc

    result_dir = os.path.join(root, "moc_train")
    argv = [*TRAIN_ARGV, "--result_dir", result_dir, "--device", "cuda"]
    t0 = time.perf_counter()
    corpus = main_moc._synthetic_setup(main_moc.get_args(argv))
    corpus_s = time.perf_counter() - t0
    rc, stdout, rec, launches, wall = _main_moc_recorded(argv)
    check(rc == 0, f"main_moc.main returned {rc}")
    lines = stdout.strip().splitlines()
    with open(os.path.join(result_dir, f"best_results_shot_{TRAIN_SHOT}_fold_0.json")) as f:
        result = json.load(f)
    losses = [x for epoch in rec["losses"] for x in epoch]
    check(list(result) == RESULT_KEYS, f"result keys {list(result)}")
    check(len(losses) == TRAIN_EPOCHS * TRAIN_VISITS and all(math.isfinite(x) for x in losses),
          f"{len(losses)} training losses, not all finite")
    check(result["test_at_best_val"] >= 0.8,
          f"test AUC at best val {result['test_at_best_val']} is below 0.8")
    want = TRAIN_EPOCHS * TRAIN_VISITS
    check(rec["steps"] == {"rows": want, "cols": want},
          f"the training steps launched K1 {rec['steps']}, want {want} on each entry")
    epoch_s = [b - a for a, b in zip(rec["starts"], rec["starts"][1:])]
    train_s = statistics.median(rec["train_s"])
    res = {"wall_s": wall, "corpus_s": corpus_s, "epoch_train_s": train_s,
           "epoch_with_eval_s": statistics.median(epoch_s),
           "steps_per_s": TRAIN_VISITS / train_s, "launches": launches,
           "launches_steps": rec["steps"], "result": result, "losses": rec["losses"],
           "loss_first": rec["losses"][0], "loss_last": rec["losses"][-1]}
    best = next(line for line in lines if line.startswith("Best Val"))
    log(f"[train] main_moc {' '.join(TRAIN_ARGV)} on cuda: {best}")
    log(f"[train] episode wall {wall:.3f}s (corpus of 32 bags written before it in "
        f"{corpus_s:.2f}s); epoch: {train_s * 1e3:.1f} ms of training ({TRAIN_VISITS} steps, "
        f"{res['steps_per_s']:.1f} slide steps/s), {res['epoch_with_eval_s'] * 1e3:.1f} ms "
        f"with its evaluation (medians of {TRAIN_EPOCHS} and {len(epoch_s)}); K1 launches: "
        f"training steps {rec['steps']}, whole run {launches}")
    log(f"[train] losses, epoch 0: {[round(x, 4) for x in rec['losses'][0]]}; epoch "
        f"{TRAIN_EPOCHS - 1}: {[round(x, 4) for x in rec['losses'][-1]]}; best epoch "
        f"{result['best_epoch']}, best val {result['best_val']}, test AUC at best val "
        f"{result['test_at_best_val']}, zero-shot test {result['zero_shot_test']}")
    res["served_err"] = _serve_trained(root, corpus, result["best_model_path"])
    return res


def _serve_trained(root: str, corpus: dict, model: str) -> float:
    """The trained ``.msgpack`` through ``cli.serve.watch_once`` on the card;
    each test slide's served probabilities against ``eval_batch`` with the
    same file on the same bags. Returns the largest difference."""
    from moc_tpu_torch.cli import serve
    from moc_tpu_torch.cli.predict import load_senet
    from moc_tpu_torch.data import BagLoader, SlideTable, pack_bags, read_split_csv
    from moc_tpu_torch.metrics import softmax_probs
    from moc_tpu_torch.moc import MOCConfig, eval_batch

    np.savez(os.path.join(root, "train_w.npz"), weights=corpus["weights"])
    np.savez(os.path.join(root, "train_we.npz"), weights=corpus["weights_ext"])
    args = serve.get_args(["--dataset", "nsclc", "--model", model,
                           "--weights_npz", os.path.join(root, "train_w.npz"),
                           "--weights_ext_npz", os.path.join(root, "train_we.npz"),
                           "--topj", str(TOPJ), "--topk", str(TOPK), "--device", "cuda",
                           "--watch_dir", corpus["data_dir"], "--once"])
    out_csv = os.path.join(root, "served_trained.csv")
    n = serve.watch_once(serve.Server(args), corpus["data_dir"], out_csv, set())
    check(n == 2 * 16, f"watch_once scored {n} of the 32 training-corpus slides")
    with open(out_csv, newline="") as f:
        served = {r["slide_id"]: [float(r[f"prob_{c}"]) for c in range(N_CLASSES)]
                  for r in csv.DictReader(f)}
    table = SlideTable.from_csv(corpus["csv_path"], corpus["label_dict"])
    split = read_split_csv(corpus["split_paths"][(TRAIN_SHOT, 0)])
    bags = BagLoader(table, corpus["data_dir"]).read_all(split.test)
    cfg = MOCConfig(n_classes=N_CLASSES, n_ext_classes=N_EXT, topj=TOPJ, topk=TOPK)
    w, w_ext = (torch.from_numpy(x).cuda() for x in (corpus["weights"], corpus["weights_ext"]))
    probs = softmax_probs(eval_batch(load_senet(model), pack_bags(bags, device="cuda"), w,
                                     w_ext, cfg)).cpu().numpy()
    err = max(float(np.abs(np.array(served[b.slide_id]) - p).max()) for b, p in zip(bags, probs))
    check(err <= 1e-5, f"served probabilities differ from eval_batch's by {err}")
    log(f"[train] the saved .msgpack served by watch_once (32 slides) against eval_batch on the "
        f"{len(bags)} test bags: max |diff| of the probabilities {err:.3e} (tolerance 1e-5)")
    return err


def _train_setup(root: str, device: str):
    """The training corpus's shot-8 fold-0 episode on ``device``, its weights
    and the full-width ``MOCConfig``."""
    from moc_tpu_torch.cli import main_moc
    from moc_tpu_torch.data import BagLoader, EpisodeBags, SlideTable, read_split_csv
    from moc_tpu_torch.moc import MOCConfig

    corpus = main_moc._synthetic_setup(main_moc.get_args(
        [*TRAIN_ARGV, "--result_dir", os.path.join(root, "moc_train")]))
    table = SlideTable.from_csv(corpus["csv_path"], corpus["label_dict"])
    split = read_split_csv(corpus["split_paths"][(TRAIN_SHOT, 0)])
    ep = EpisodeBags.load(BagLoader(table, corpus["data_dir"]), split.train, split.val,
                          split.test, repeat_num=TRAIN_VISITS, device=device)
    w, w_ext = (torch.from_numpy(x).to(device) for x in (corpus["weights"],
                                                          corpus["weights_ext"]))
    return ep, w, w_ext, MOCConfig(n_classes=N_CLASSES, n_ext_classes=N_EXT, topj=TOPJ,
                                   topk=TOPK)


def phase_train_parity(root: str) -> dict:
    """One epoch on the card and on the CPU from one initial SENet and one
    set of keep masks: first-step gradients within 1e-5 of each parameter's
    largest |grad|, the 16 losses within 1e-5, parameters within Adam's bound
    (lr a step); K1 twice a step on the card, never on the CPU. Also K1's
    wrappers on keys that require grad, in both entries."""
    import torch.nn.functional as F

    from moc_tpu_torch.moc import init_senet, make_optimizer, moc_slide_logits, train_epoch
    from moc_tpu_torch.moc.episode import draw_keep_masks
    from moc_tpu_torch.ops import threshold_topk_mask

    k1 = _k1_wrappers()
    # keys that require grad, as the masked route hands them over: no copy, no error
    keys = torch.randn((5, 4096), device="cuda", requires_grad=True) * 1.0
    check(torch.equal(k1["rows"](keys, TOPJ), threshold_topk_mask(keys.detach(), TOPJ, axis=-1)),
          "K1 rows on keys that require grad differ from the plain version")
    cols = (torch.randn((1, N_CLASSES, 2432), device="cuda", requires_grad=True) * 1.0
            ).transpose(1, 2)
    check(torch.equal(k1["cols"](cols, TOPK), threshold_topk_mask(cols.detach(), TOPK, axis=-2)),
          "K1 columns on a strided view that requires grad differ from the plain version")

    runs = {}
    for device in ("cuda", "cpu"):
        ep, w, w_ext, cfg = _train_setup(root, device)
        if device == "cuda":  # the same masks for both, drawn once on the CPU
            order = ep.train_epoch_order()
            keep = draw_keep_masks(torch.Generator().manual_seed(7), cfg, len(order),
                                   ep.train.padded_len)
        senet = init_senet(0, cfg, device)
        i = int(order[0])
        logits = moc_slide_logits(senet, ep.train.features[i:i + 1], ep.train.mask[i:i + 1],
                                  w, w_ext, cfg, keep[:1].to(device))
        F.cross_entropy(logits, ep.train.labels[i:i + 1].long()).backward()
        grads = {n: p.grad.detach().cpu() for n, p in senet.named_parameters()}
        senet = init_senet(0, cfg, device)
        before = {e: fn.launches for e, fn in k1.items()}
        losses = train_epoch(senet, make_optimizer(senet.parameters(), cfg), ep.train, order,
                             keep.to(device), w, w_ext, cfg).cpu()
        launched = {e: fn.launches - before[e] for e, fn in k1.items()}
        runs[device] = (grads, losses, {k: v.detach().cpu() for k, v in
                                        senet.state_dict().items()}, launched)
    (gg, lg, pg, ng), (gc, lc, pc, nc) = runs["cuda"], runs["cpu"]
    check(ng == {"rows": TRAIN_VISITS, "cols": TRAIN_VISITS} and nc == {"rows": 0, "cols": 0},
          f"one epoch's K1 launches: card {ng}, CPU {nc}")
    grad_err = max(float((gg[n] - g).abs().max() / g.abs().max()) for n, g in gc.items())
    smallest = min(float(g.abs().max()) for g in gc.values())
    check(grad_err <= 1e-5, f"first-step gradients differ by {grad_err} of the largest |grad|")
    loss_err = float((lg - lc).abs().max())
    check(loss_err <= 1e-5, f"one epoch's losses differ: card {lg.tolist()}, CPU {lc.tolist()}")
    param_err = max(float((t - pc[n]).abs().max()) for n, t in pg.items())
    bound = TRAIN_VISITS * cfg.learning_rate
    check(param_err <= bound, f"parameters differ by {param_err}, past Adam's bound {bound}")
    log(f"[train] one epoch on the card against the CPU ({TRAIN_VISITS} steps, same SENet and "
        f"masks): first-step gradients within {grad_err:.3e} of each largest |grad| (smallest "
        f"largest |grad| {smallest:.3e}; tolerance 1e-5), losses max |diff| {loss_err:.3e} "
        f"(tolerance 1e-5), parameters max |diff| {param_err:.3e} (Adam's bound {bound}); "
        f"K1 launches card {ng}, CPU {nc}; K1 on keys that require grad bit-equal in both "
        "entries")
    return {"grad_err": grad_err, "loss_err": loss_err, "param_err": param_err}


# the ranking keys of the five foreground pooling families, as K1's column
# entry sees them: [B, N, 1] for delta_diff's margin, [B, N, C] for the rest
def _foreground_keys(name: str, x: torch.Tensor) -> torch.Tensor:
    from moc_tpu_torch.ops import masked_row_margin
    from moc_tpu_torch.ops.masking import softmax

    return {"topj": lambda: x, "delta_softmax": lambda: softmax(x, dim=-1),
            "delta_diff": lambda: masked_row_margin(x)[..., None],
            "topj_delta_softmax": lambda: softmax(x, dim=-1) * x,
            "topj_delta_diff": lambda: x * masked_row_margin(x)[..., None]}[name]()


def _selection_cases(state: dict, ep, w, w_ext, cfg) -> dict:
    """``(logits, logits_ext, valid)`` on the card for the sort-path checks:
    the serving batch's logits at the serving point, the training bucket's
    train split, that split's logits rounded to halves (ties, signed zeros
    among them), and the serving logits' signs as ±0.0, where the sort and
    the threshold path part."""
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.moc.core import _dense_views_weights

    batch = pack_bags(state["bags"][:BATCH], n_pad=N_PAD, device="cuda")
    _, _, lg, le = _dense_views_weights(None, batch.features, state["w"], state["w_ext"],
                                        state["cfg"])
    _, _, tg, te = _dense_views_weights(None, ep.train.features, w, w_ext, cfg)
    return {"serving": (lg, le, batch.mask), "training": (tg, te, ep.train.mask),
            "training_ties": (torch.round(tg * 2) / 2, torch.round(te * 2) / 2, ep.train.mask),
            "serving_signed_zeros": (torch.where(lg < 0, -0.0, 0.0),
                                     torch.where(le < 0, -0.0, 0.0), batch.mask)}


def phase_select_pool(root: str, state: dict, trained: dict) -> dict:
    """The sort selection path and the ten pooling families on the card,
    each against the CPU on the card's own logits: (a) ``union_selection``
    and ``select_and_gather(method="sort")`` bit-equal at the serving point
    and the training bucket, and on tie-heavy and signed-zero logits, where
    the threshold path parts from them on the card as on the CPU; (b) every
    family, with ``return_indices`` both ways and the bottom-k ones with
    ``detection`` both ways, on the train split's zero-shot logits: K1's
    membership masks bit-equal to the plain version, pooled values within
    1e-6, indices equal; (c) ``main_moc.main --select_method sort`` at the
    training protocol: per-epoch losses within 1e-6 of ``phase_train``'s
    threshold run and the same test AUC at best val; (d) ``zs_eval_batches``
    with each ``zs_pooling`` family on every split, card against CPU: equal
    AUC and accuracy, pooled logits within rtol 1e-4. Then the times: the
    sort union against the threshold union at the serving shape, with a
    profile of each, and K1's column entry at the zero-shot floor's
    shapes."""
    from moc_tpu_torch.cli import main_moc
    from moc_tpu_torch.moc.core import selection_capacity_for
    from moc_tpu_torch.moc.episode import zs_eval_batches, zs_pooled_logits
    from moc_tpu_torch.ops import (FOREGROUND_POOLINGS, POOLING_REGISTRY, masked_col_topk_mask,
                                   masked_logits, select_and_gather, threshold_topk_mask,
                                   union_selection, union_selection_threshold)

    t_phase = time.perf_counter()
    k1 = _k1_wrappers()
    ep, w, w_ext, cfg = _train_setup(root, "cuda")
    ep_cpu, w_cpu, w_ext_cpu, _ = _train_setup(root, "cpu")
    res = {}
    with torch.inference_mode():
        # (a) the sort path, bit for bit against the CPU
        cases = _selection_cases(state, ep, w, w_ext, cfg)
        parted = {}
        for name, args in cases.items():
            cpu = tuple(a.cpu() for a in args)
            n = args[0].shape[-2]
            cap = selection_capacity_for(TOPJ, N_CLASSES, n)
            sort = union_selection(*args, TOPJ, N_CLASSES)
            check(torch.equal(sort.cpu(), union_selection(*cpu, TOPJ, N_CLASSES)),
                  f"union_selection on the card differs from the CPU ({name})")
            got = select_and_gather(*args, TOPJ, N_CLASSES, cap, method="sort")
            want = select_and_gather(*cpu, TOPJ, N_CLASSES, cap, method="sort")
            check(all(torch.equal(g.cpu(), x) for g, x in zip(got, want)),
                  f"select_and_gather(method='sort') on the card differs from the CPU ({name})")
            thr = union_selection_threshold(*args, TOPJ, N_CLASSES)
            check(torch.equal(thr.cpu(), union_selection_threshold(*cpu, TOPJ, N_CLASSES)),
                  f"union_selection_threshold on the card differs from the CPU ({name})")
            parted[name] = int((sort != thr).any(-1).sum())
        check(parted["serving"] == parted["training"] == 0,
              f"the sort and the threshold union part on real logits: {parted}")
        check(parted["serving_signed_zeros"] > 0,
              "the sort and the threshold union agree on signed zeros")
        log(f"[select] sort path bit-equal to the CPU (union_selection, select_and_gather) at "
            f"{ {k: list(v[0].shape) for k, v in cases.items()} }; slides where the sort and "
            f"the threshold union part: {parted}")
        del cases

        # (b) the ten pooling families on the train split's zero-shot logits
        fg, ext, valid = ep.train.features @ w, ep.train.features @ w_ext, ep.train.mask
        pool_err, n_calls = 0.0, 0
        for name, fn in POOLING_REGISTRY.items():
            is_fg = name in FOREGROUND_POOLINGS
            x = fg if is_fg else ext
            if is_fg:
                keys = _foreground_keys(name, x)
                check(torch.equal(masked_col_topk_mask(keys, valid, TOPK).cpu(),
                                  threshold_topk_mask(masked_logits(keys, valid).cpu(), TOPK,
                                                      axis=-2)),
                      f"K1's mask of {name} at {list(keys.shape)} differs from plain")
            for ri in (False, True):
                for kw in ([{}] if is_fg else [{"n_fg": N_CLASSES, "detection": d}
                                               for d in (False, True)]):
                    before = k1["cols"].launches
                    got = fn(x, valid, TOPK, return_indices=ri, **kw)
                    launched = k1["cols"].launches - before
                    check(launched == int(is_fg and not ri),
                          f"{name} {kw} return_indices={ri} launched K1 {launched} times")
                    want = fn(x.cpu(), valid.cpu(), TOPK, return_indices=ri, **kw)
                    if ri:
                        check(torch.equal(got[1].cpu(), want[1]),
                              f"{name} {kw}: indices on the card differ from the CPU")
                        got, want = got[0], want[0]
                    pool_err = max(pool_err, float((got.cpu() - want).abs().max()))
                    check(torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6),
                          f"{name} {kw} return_indices={ri}: pooled values differ from the CPU")
                    n_calls += 1
        log(f"[select] {n_calls} pooling-family calls on the train split's zero-shot logits "
            f"{list(fg.shape)} / {list(ext.shape)}: pooled values within {pool_err:.3e} of the "
            f"CPU (rtol = atol = 1e-6), indices equal; K1's masks of the five foreground "
            f"families bit-equal to plain at [B, N, 1] and [B, N, {N_CLASSES}]")
        del fg, ext

    # (c) a main_moc episode on the sort path against phase_train's threshold run
    corpus = main_moc._synthetic_setup(main_moc.get_args(
        [*TRAIN_ARGV, "--result_dir", os.path.join(root, "moc_train")]))
    sort_dir = os.path.join(root, "moc_train_sort")
    os.makedirs(sort_dir)
    corpus_root = os.path.dirname(corpus["csv_path"])
    os.symlink(corpus_root, os.path.join(sort_dir, os.path.basename(corpus_root)))
    rc, _, rec, launches, wall = _main_moc_recorded(
        [*TRAIN_ARGV, "--select_method", "sort", "--result_dir", sort_dir, "--device", "cuda"])
    check(rc == 0, f"main_moc.main --select_method sort returned {rc}")
    with open(os.path.join(sort_dir, f"best_results_shot_{TRAIN_SHOT}_fold_0.json")) as f:
        result = json.load(f)
    loss_err = max(abs(a - b) for x, y in zip(rec["losses"], trained["losses"])
                   for a, b in zip(x, y))
    check(len(rec["losses"]) == len(trained["losses"]) and loss_err <= 1e-6,
          f"the sort episode's losses differ from the threshold episode's by {loss_err}")
    check(result["test_at_best_val"] == trained["result"]["test_at_best_val"],
          f"test AUC at best val: sort {result['test_at_best_val']}, threshold "
          f"{trained['result']['test_at_best_val']}")
    want = TRAIN_EPOCHS * TRAIN_VISITS
    check(rec["steps"] == {"rows": 0, "cols": want},
          f"the sort episode's steps launched K1 {rec['steps']}, want no rows and {want} cols")
    res.update(sort_wall_s=wall, sort_loss_err=loss_err, launches_sort=launches,
               launches_sort_steps=rec["steps"])
    log(f"[select] main_moc --select_method sort: episode wall {wall:.3f}s (threshold "
        f"{trained['wall_s']:.3f}s); losses within {loss_err:.3e} of the threshold run's "
        f"(tolerance 1e-6), test AUC at best val {result['test_at_best_val']} (equal); K1 "
        f"launches: training steps {rec['steps']}, whole run {launches}")

    # (d) the zero-shot floor of every family, card against CPU
    zs_launches, zs_err = {}, 0.0
    for name in POOLING_REGISTRY:
        cfg_z = dataclasses.replace(cfg, zs_pooling=name)
        for fn in k1.values():
            fn.launches = 0
        card = {s: zs_eval_batches(c, w, w_ext, cfg_z, torch.device("cuda"))
                for s, c in (("train", [ep.train]), ("val", ep.val), ("test", ep.test))}
        zs_launches[name] = {e: fn.launches for e, fn in k1.items()}
        host = {s: zs_eval_batches(c, w_cpu, w_ext_cpu, cfg_z, torch.device("cpu"))
                for s, c in (("train", [ep_cpu.train]), ("val", ep_cpu.val),
                             ("test", ep_cpu.test))}
        for s in card:
            check(card[s].auc == host[s].auc and card[s].acc == host[s].acc,
                  f"zero-shot {name} {s}: card {card[s].to_dict()}, CPU {host[s].to_dict()}")
        with torch.inference_mode():
            got = zs_pooled_logits(ep.train.features, ep.train.mask, w, w_ext, cfg_z).cpu()
            want = zs_pooled_logits(ep_cpu.train.features, ep_cpu.train.mask, w_cpu, w_ext_cpu,
                                    cfg_z)
        zs_err = max(zs_err, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
              f"zero-shot {name}: pooled logits on the card differ from the CPU's")
        chunks = 1 + len(ep.val) + len(ep.test)
        check(zs_launches[name] == {"rows": 0, "cols": chunks if name in FOREGROUND_POOLINGS
                                    else 0}, f"zero-shot {name} launched K1 {zs_launches[name]}")
    res.update(launches_zs=zs_launches, zs_err=zs_err)
    log(f"[select] zero-shot floor of all {len(POOLING_REGISTRY)} families on the training "
        f"corpus: AUC and accuracy equal on the card and the CPU in every split, pooled "
        f"logits max |diff| {zs_err:.3e} (rtol 1e-4, atol 1e-5); K1 column launches per family "
        f"{ {k: v['cols'] for k, v in zs_launches.items()} }")

    # times: the sort union against the threshold union at the serving point
    with torch.inference_mode():
        cases = _selection_cases(state, ep, w, w_ext, cfg)
        args = cases["serving"]
        t_sort = _time_ms(lambda: union_selection(*args, TOPJ, N_CLASSES))
        t_thr = _time_ms(lambda: union_selection_threshold(*args, TOPJ, N_CLASSES))
        k1_thr = _kernel_us(lambda: union_selection_threshold(*args, TOPJ, N_CLASSES),
                            "topk_cluster_kernel", k1["rows"])
        train_args = tuple(a[:1] for a in cases["training"])
        cap = selection_capacity_for(TOPJ, N_CLASSES, train_args[0].shape[-2])
        t_gather = {m: _time_ms(lambda: select_and_gather(*train_args, TOPJ, N_CLASSES, cap,
                                                          method=m))
                    for m in ("sort", "threshold")}
        for what, fn in (("sort union", union_selection),
                         ("threshold union", union_selection_threshold)):
            phase_profile(lambda: fn(*args, TOPJ, N_CLASSES), steps=10, what=what, host_top=5)
    res["times"] = {"union_sort_ms": t_sort, "union_threshold_ms": t_thr,
                    "union_threshold_k1": k1_thr, "gather_sort_ms": t_gather["sort"],
                    "gather_threshold_ms": t_gather["threshold"]}
    log(f"[times] selection union at the serving point {list(args[0].shape)}, topj {TOPJ}: sort "
        f"(top_k) {t_sort:.4f} ms, threshold (K1) {t_thr:.4f} ms per call (CUDA events, median "
        f"of 100), K1 inside the threshold union {_us(k1_thr['kernel_us'])} kernel-only, "
        f"{_us(k1_thr['device_us'])} queued; select_and_gather of one training visit "
        f"{list(train_args[0].shape)}: sort {t_gather['sort']:.4f} ms, threshold "
        f"{t_gather['threshold']:.4f} ms")
    res["k1_zs"] = _k1_at_shapes(ZS_K1_SHAPES, seed=11)
    log(f"[select] phase wall {time.perf_counter() - t_phase:.1f}s")
    return res


def phase_train_times(root: str) -> dict:
    """The slide step (forward, backward, Adam) by CUDA events on the gather
    route that training takes and on the masked route, and a profile of
    each."""
    import torch.nn.functional as F

    from moc_tpu_torch.moc import init_senet, make_optimizer, moc_slide_logits
    from moc_tpu_torch.moc.episode import draw_keep_masks

    ep, w, w_ext, cfg = _train_setup(root, "cuda")
    keep = draw_keep_masks(torch.Generator(device="cuda").manual_seed(8), cfg, 1,
                           ep.train.padded_len)
    feats, mask, label = ep.train.features[:1], ep.train.mask[:1], ep.train.labels[:1].long()
    records = {}
    for impl in ("gather", "masked"):
        cfg_i = dataclasses.replace(cfg, exact_impl=impl)
        senet = init_senet(0, cfg_i, "cuda")
        opt = make_optimizer(senet.parameters(), cfg_i)

        def step():
            loss = F.cross_entropy(moc_slide_logits(senet, feats, mask, w, w_ext, cfg_i, keep),
                                   label)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

        records[impl] = _time_ms(step, iters=50, warmup=5)
        log(f"[times] slide step, {impl} route ([1, {ep.train.padded_len}, {DIM}], topj "
            f"{TOPJ}): {records[impl]:.3f} ms by CUDA events (median of 50)")
        phase_profile(step, steps=5, what="step", host_top=12)
    return records


def phase_sweep(root: str, trained: dict) -> dict:
    """``cli.sweep.main --mode fused`` on the card over all five folds of
    shot 8 at the training protocol, on ``phase_train``'s corpus: the result
    files with the JAX package's keys for every fold and ``summary_8.csv``,
    test AUC at best val at least 0.8 everywhere, every step's losses
    finite, K1 launched exactly twice a batched step (counted around each
    ``sweep_step``), and fold 0 equal to ``main_moc``'s fold 0 (the same
    best epoch, AUCs and accuracy within 1e-5)."""
    import contextlib
    import io

    from moc_tpu_torch.cli import sweep as sweep_cli
    from moc_tpu_torch.moc import sweep

    result_dir = os.path.join(root, "moc_train")  # phase_train's corpus is under it
    argv = [*SWEEP_ARGV, "--mode", "fused", "--device", "cuda", "--result_dir", result_dir]
    k1 = _k1_wrappers()
    steps = {"rows": 0, "cols": 0}
    losses = []
    inner = sweep.sweep_step

    def recorded(*args, **kwargs):
        before = {e: fn.launches for e, fn in k1.items()}
        ce = inner(*args, **kwargs)
        for e, fn in k1.items():
            steps[e] += fn.launches - before[e]
        losses.append(ce)  # read after the run: no wait for the device here
        return ce

    sweep.sweep_step = recorded  # make_sweep_fn looks it up at each visit
    for fn in k1.values():
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = sweep_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sweep.sweep_step = inner
    launches = {e: fn.launches for e, fn in k1.items()}
    check(rc == 0, f"cli.sweep.main returned {rc}")
    shot_dir = os.path.join(result_dir, f"{TRAIN_SHOT}_shot")
    results = {}
    for fold in SWEEP_FOLDS:
        name = f"shot_{TRAIN_SHOT}_fold_{fold}"
        with open(os.path.join(shot_dir, f"best_results_{name}.json")) as f:
            results[fold] = json.load(f)
        check(list(results[fold]) == RESULT_KEYS, f"fold {fold} result keys {list(results[fold])}")
        for path in (f"zs_results_{name}.json", f"best_model_{name}.msgpack"):
            check(os.path.exists(os.path.join(shot_dir, path)), f"the sweep wrote no {path}")
        check(results[fold]["test_at_best_val"] >= 0.8,
              f"fold {fold}: test AUC at best val {results[fold]['test_at_best_val']} below 0.8")
    with open(os.path.join(result_dir, f"summary_{TRAIN_SHOT}.csv"), newline="") as f:
        summary = list(csv.reader(f))
    check([r[0] for r in summary] == ["fold", *map(str, SWEEP_FOLDS), "mean"],
          f"summary_{TRAIN_SHOT}.csv rows {[r[0] for r in summary]}")
    step_losses = torch.stack(losses).cpu()  # [25·16, 5]
    want = TRAIN_EPOCHS * TRAIN_VISITS
    check(step_losses.shape == (want, len(SWEEP_FOLDS)) and bool(torch.isfinite(step_losses).all()),
          f"{tuple(step_losses.shape)} step losses, not all finite")
    check(steps == {"rows": want, "cols": want},
          f"the batched steps launched K1 {steps}, want {want} on each entry")
    ref, got = trained["result"], results[0]
    diff = max(abs(got[k] - ref[k]) for k in ("best_val", "test_at_best_val",
                                              "test_acc_at_best_val"))
    check(got["best_epoch"] == ref["best_epoch"] and diff <= 1e-5,
          f"sweep fold 0 {got} differs from main_moc fold 0 {ref}")
    eval_launches = {e: launches[e] - steps[e] for e in launches}
    episodes = len(SWEEP_FOLDS)
    breakdown = next(line for line in err.getvalue().splitlines() if "fused breakdown" in line)
    log(f"[sweep] cli.sweep {' '.join(SWEEP_ARGV)} --mode fused on cuda: {episodes} episodes in "
        f"{wall:.3f}s host wall ({episodes / wall * 3600:.0f} episodes/hour; corpus reused), "
        f"against {episodes} x main_moc's episode wall {trained['wall_s']:.3f}s = "
        f"{episodes * trained['wall_s']:.3f}s ({3600 / trained['wall_s']:.0f} episodes/hour)")
    log(f"[sweep] {breakdown.strip()}")
    log(f"[sweep] K1 launches: batched steps {steps} ({want} steps of all {episodes} folds), "
        f"evaluation and zero-shot floor {eval_launches}, whole run {launches}")
    log(f"[sweep] per fold (best epoch, best val, test AUC, test acc): "
        + "; ".join(f"{f}: {r['best_epoch']}, {r['best_val']}, {r['test_at_best_val']}, "
                    f"{r['test_acc_at_best_val']}" for f, r in results.items())
        + f"; fold 0 against main_moc's: max |diff| {diff:.3e} (tolerance 1e-5)")
    log(f"[sweep] step losses, mean over folds: first {step_losses[0].mean():.4f}, last "
        f"{step_losses[-1].mean():.4f}, all finite")
    return {"wall_s": wall, "episodes_per_hour": episodes / wall * 3600, "launches": launches,
            "launches_steps": steps, "launches_eval": eval_launches, "breakdown": breakdown,
            "fold0_diff": diff}


def phase_sweep_times(root: str) -> dict:
    """The sweep's batched step (all five folds, E = 5) by CUDA events and a
    profile of it; the evaluation's two parts, the eval packs and the
    trajectory's logits; K1 at the sweep's shapes."""
    from moc_tpu_torch.cli import main_moc
    from moc_tpu_torch.convert import senet_stack_from_states
    from moc_tpu_torch.data import BagLoader, SlideTable, read_split_csv
    from moc_tpu_torch.moc import (MOCConfig, assemble_episode, init_senet, make_optimizer,
                                   moc_logits_packed, pool_episode_splits, precompute_eval_pack,
                                   sweep_step)
    from moc_tpu_torch.moc.episode import draw_keep_masks
    from moc_tpu_torch.moc.sweep import _eval_slides

    corpus = main_moc._synthetic_setup(main_moc.get_args(
        [*TRAIN_ARGV, "--result_dir", os.path.join(root, "moc_train")]))
    table = SlideTable.from_csv(corpus["csv_path"], corpus["label_dict"])
    splits = [read_split_csv(corpus["split_paths"][(TRAIN_SHOT, f)]) for f in SWEEP_FOLDS]
    pooled = pool_episode_splits(BagLoader(table, corpus["data_dir"]), splits)
    ep = assemble_episode(torch.from_numpy(pooled.pool_feats).cuda(),
                          torch.from_numpy(pooled.pool_mask).cuda(), pooled.index)
    w, w_ext = (torch.from_numpy(x).cuda() for x in (corpus["weights"], corpus["weights_ext"]))
    cfg = MOCConfig(n_classes=N_CLASSES, n_ext_classes=N_EXT, topj=TOPJ, topk=TOPK)
    e, _, n = ep.train_feats.shape[:3]
    stack = senet_stack_from_states([init_senet(0, cfg).state_dict()] * e).cuda()
    opt = make_optimizer(stack.parameters(), cfg)
    keep = draw_keep_masks(torch.Generator(device="cuda").manual_seed(8), cfg, e, n)
    labels = ep.train_labels.long()

    def step():
        sweep_step(stack, opt, ep.train_feats[:, 0], ep.train_mask[:, 0], labels[:, 0], keep, w,
                   w_ext, cfg)

    step_ms = _time_ms(step, iters=50, warmup=5)
    log(f"[times] sweep step, all {e} folds ([{e}, {n}, {DIM}], topj {TOPJ}): {step_ms:.3f} ms by "
        f"CUDA events (median of 50), {step_ms / e:.3f} ms a fold, "
        f"{e * 1e3 / step_ms:.1f} slide steps/s")
    phase_profile(step, steps=5, what="step", host_top=12)
    feats, mask, mv = _eval_slides(ep)
    with torch.inference_mode():
        pack_ms = _time_ms(lambda: precompute_eval_pack(feats, mask, w, w_ext, cfg), iters=5,
                           warmup=1)
        pack = precompute_eval_pack(feats, mask, w, w_ext, cfg)
        traj = {k: p.detach().expand(TRAIN_EPOCHS, *p.shape).contiguous()
                for k, p in stack.named_parameters()}
        traj_ms = _time_ms(lambda: moc_logits_packed(traj, pack, cfg), iters=5, warmup=1)
    m, cap = feats.shape[1], pack.valid.shape[-1]
    log(f"[times] sweep evaluation: eval packs of [{e}, {m}, {n}, {DIM}] ({mv} val + {m - mv} "
        f"test slides a fold) {pack_ms:.3f} ms, the {TRAIN_EPOCHS}-epoch trajectory's logits "
        f"over [{TRAIN_EPOCHS}, {e}, {m}, {cap}] {traj_ms:.3f} ms (CUDA events, median of 5)")
    del feats, mask, pack, traj
    shapes = (("rows", (e * (2 * N_CLASSES + 1), n), TOPJ), ("cols", (e, cap, N_CLASSES), TOPK),
              ("cols", (TRAIN_EPOCHS * e * m, cap, N_CLASSES), TOPK),
              ("rows", (e * m * (2 * N_CLASSES + 1), n), TOPJ))
    k1 = _k1_at_shapes(shapes, seed=9)
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "pack_ms": pack_ms, "trajectory_ms": traj_ms, "k1": k1}


# The MIL baselines (moc_tpu/cli/train_mil.py, moc_tpu/cli/predict.py:185-200): every
# single-scale head trained by cli.train_mil on the MOC training corpus (D = 512,
# shot 8, fold 0, bags of 1500-4000 patches) at the conch width, clam_sb and transmil
# also as a fused grid of five folds, then scored by cli.predict's path at batch 8 on
# the 16384-patch bucket (f32 and bf16 storage) and served by cli.serve. Cut: epochs.
MIL_HEADS = ("clam_sb", "clam_mb", "abmil", "mil", "transmil", "chief", "titan")
MIL_FUSED = ("clam_sb", "transmil")
MIL_EPOCHS = 3
MIL_ARGV = ["--dataset", "synthetic", "--shot", str(TRAIN_SHOT), "--fold", "0", "--seed", "0",
            "--synthetic_min_patches", str(TRAIN_PATCHES[0]),
            "--synthetic_max_patches", str(TRAIN_PATCHES[1]), "--max_epochs", str(MIL_EPOCHS)]
MIL_RESULT_KEYS = ["val_auc", "val_acc", "test_auc", "test_acc", "test_bacc", "stop_epoch",
                   "class_summary", "patient_results", "model_type", "model_size", "n_classes"]
# heads whose CPU reference runs on the 4 shortest train slides (and 2 val, 2 test),
# not the whole split: a TITAN epoch at 4096 tokens costs the CPU minutes
MIL_SHORT_PARITY = ("transmil", "titan")
MIL_PREDICT_ITERS = {"titan": 2}
# card against CPU logits, relative to the largest |logit|; the seeded head's
# forward with TF32 on is printed beside it as the control this must catch
MIL_LOGIT_RTOL = 1e-5


def _all_launches() -> dict:
    k1 = _k1_wrappers()
    return {"rows": k1["rows"].launches, "cols": k1["cols"].launches,
            **{k: fn.launches for k, fn in _counters().items()}}


def _reset_launches() -> None:
    for fn in (*_k1_wrappers().values(), *_counters().values()):
        fn.launches = 0


def _mil_corpus(root: str):
    """The MOC training corpus (made once, by ``phase_train`` or here): the
    table, the shot-8 fold-0 split and its bags by split."""
    from moc_tpu_torch.cli import main_moc
    from moc_tpu_torch.data import BagLoader, SlideTable, read_split_csv

    corpus = main_moc._synthetic_setup(main_moc.get_args(
        [*TRAIN_ARGV, "--result_dir", os.path.join(root, "moc_train")]))
    table = SlideTable.from_csv(corpus["csv_path"], corpus["label_dict"])
    split = read_split_csv(corpus["split_paths"][(TRAIN_SHOT, 0)])
    loader = BagLoader(table, corpus["data_dir"])
    return {k: loader.read_all(getattr(split, k)) for k in ("train", "val", "test")}


def _run_train_mil(argv: list[str]) -> tuple[int, str, float]:
    import contextlib
    import io

    from moc_tpu_torch.cli import train_mil

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_mil.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def phase_mil_train(root: str) -> dict:
    """``cli.train_mil.main`` on the card for every head (3 epochs of 16
    slide steps) and a fused grid of five folds for CLAM-SB and TransMIL:
    the JAX package's result keys, finite AUCs, the ``.msgpack`` beside each
    JSON and ``<model>_summary_8.csv``; no kernel of the port launched."""
    result_dir = os.path.join(root, "moc_train")
    _mil_corpus(root)
    t_phase = time.perf_counter()
    _reset_launches()
    res = {"single": {}, "fused": {}}
    for head in MIL_HEADS:
        rc, stdout, wall = _run_train_mil([*MIL_ARGV, "--model_type", head, "--result_dir",
                                           result_dir, "--device", "cuda"])
        check(rc == 0, f"train_mil {head} returned {rc}")
        path = os.path.join(result_dir, f"{head}_shot_{TRAIN_SHOT}_fold_0.json")
        with open(path) as f:
            payload = json.load(f)
        check(list(payload) == MIL_RESULT_KEYS, f"{head} result keys {list(payload)}")
        check(all(math.isfinite(payload[k]) for k in ("val_auc", "test_auc", "test_acc")),
              f"{head}: non-finite metrics {payload}")
        check(os.path.exists(path[:-len(".json")] + ".msgpack"), f"{head}: no .msgpack")
        val_aucs = [float(line.split("auc=")[1].split()[0]) for line in stdout.splitlines()
                    if line.startswith("epoch ")]
        res["single"][head] = {"wall_s": wall, "test_auc": payload["test_auc"],
                               "val_auc": payload["val_auc"], "test_acc": payload["test_acc"],
                               "epoch_val_auc": val_aucs, "msgpack": path[:-5] + ".msgpack"}
        log(f"[mil] train_mil {head} on cuda ({MIL_EPOCHS} epochs of {TRAIN_VISITS} steps): "
            f"wall {wall:.2f}s, val AUC by epoch {val_aucs}, test AUC at best val "
            f"{payload['test_auc']:.4f}, test acc {payload['test_acc']:.4f}")
    for head in MIL_FUSED:
        rc, stdout, wall = _run_train_mil([*MIL_ARGV, "--model_type", head, "--result_dir",
                                           os.path.join(root, "mil_fused"), "--folds",
                                           *map(str, SWEEP_FOLDS), "--fused", "--device", "cuda"])
        check(rc == 0, f"train_mil --fused {head} returned {rc}")
        with open(os.path.join(root, "mil_fused", f"{head}_summary_{TRAIN_SHOT}.csv")) as f:
            summary = list(csv.DictReader(f))
        check([r["fold"] for r in summary] == [*map(str, SWEEP_FOLDS), "mean"],
              f"{head} fused summary rows {summary}")
        aucs = [float(r["test_auc"]) for r in summary[:-1]]
        check(all(math.isfinite(a) for a in aucs), f"{head} fused test AUCs {aucs}")
        res["fused"][head] = {"wall_s": wall, "test_auc": aucs,
                              "folds_per_hour": len(SWEEP_FOLDS) * 3600 / wall}
        log(f"[mil] train_mil {head} --fused, folds {list(SWEEP_FOLDS)} on cuda: wall "
            f"{wall:.2f}s ({res['fused'][head]['folds_per_hour']:.0f} folds/hour, beside "
            f"{res['single'][head]['wall_s']:.2f}s for one fold alone), test AUC at best val "
            f"by fold {[round(a, 4) for a in aucs]}")
    res["launches"] = _all_launches()
    check(not any(res["launches"].values()),
          f"the MIL training path launched the port's kernels: {res['launches']}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[mil] train phase wall {res['phase_s']:.1f}s")
    return res


def phase_mil_parity(root: str) -> dict:
    """Each head on the card against the CPU from one initial state, dropout
    off: the first step's gradients within 1e-5 of the largest |grad|, and
    one ``train_fold`` epoch's step losses within 1e-5 (the 16 train slides,
    or the 4 shortest for TransMIL and TITAN, whose CPU epoch takes minutes)."""
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.mil import MilTrainConfig, build_model, slide_losses, train_fold

    t_phase = time.perf_counter()
    bags = _mil_corpus(root)
    shortest = {k: sorted(v, key=lambda b: b.n_patches) for k, v in bags.items()}
    res = {}
    for head in MIL_HEADS:
        cfg = MilTrainConfig(model_type=head, max_epochs=1, steps_per_epoch=TRAIN_VISITS)
        init = build_model(cfg, in_dim=DIM)[2]()
        grads = {}
        for dev in ("cuda", "cpu"):
            batch = pack_bags(shortest["train"][:1], device=dev)
            state = {k: v.to(dev).requires_grad_() for k, v in init.items()}
            _, forward, _ = build_model(cfg, in_dim=DIM)
            with full_f32():
                loss = slide_losses(cfg, forward, state, batch.features, batch.mask,
                                    batch.labels)
                grads[dev] = [g.cpu() for g in torch.autograd.grad(loss.sum(),
                                                                   list(state.values()))]
        scale = max(float(g.abs().max()) for g in grads["cpu"])
        grad_err = max(float((a - b).abs().max()) for a, b in zip(grads["cuda"], grads["cpu"]))
        check(grad_err <= 1e-5 * scale, f"{head}: first-step gradients card/CPU differ by "
              f"{grad_err} (largest |grad| {scale})")
        short = head in MIL_SHORT_PARITY
        parts = {"train": shortest["train"][:4], "val": shortest["val"][:2],
                 "test": shortest["test"][:2]} if short else bags
        runs = {}
        for dev in ("cuda", "cpu"):
            loaders = {k: (lambda v=v, dev=dev: (pack_bags([b], device=dev) for b in v))
                       for k, v in parts.items()}
            runs[dev] = train_fold(loaders, cfg, init_params=init, dropout=False, device=dev)
        got, want = (np.array(runs[d].step_losses[0]) for d in ("cuda", "cpu"))
        loss_err = float(np.abs(got - want).max())
        check(loss_err <= 1e-5 * max(1.0, float(np.abs(want).max())),
              f"{head}: epoch losses card/CPU differ by {loss_err}")
        res[head] = {"grad_err": grad_err, "grad_scale": scale, "loss_err": loss_err,
                     "steps": len(got), "val_auc": [runs[d].val_auc for d in ("cuda", "cpu")]}
        log(f"[mil] {head} card vs CPU: first-step gradients max |diff| {grad_err:.3e} "
            f"(largest |grad| {scale:.3e}), {len(got)} step losses max |diff| {loss_err:.3e} "
            f"(tolerance 1e-5), val AUC {runs['cuda'].val_auc:.4f} / {runs['cpu'].val_auc:.4f}")
    log(f"[mil] parity phase wall {time.perf_counter() - t_phase:.1f}s")
    return res


def phase_mil_times(root: str) -> dict:
    """The B = 1 slide step of each head (forward, backward, Adam) at the
    training bucket by CUDA events, steps/s, and a profile: busy share and
    kernels a step."""
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.mil import MilTrainConfig, batch_loss, build_model, make_optimizer

    bags = _mil_corpus(root)
    batch = pack_bags(bags["train"][:1], n_pad=4096, device="cuda")
    res = {}
    for head in MIL_HEADS:
        cfg = MilTrainConfig(model_type=head, steps_per_epoch=TRAIN_VISITS)
        model, forward, _ = build_model(cfg, in_dim=DIM)
        model.cuda()
        opt, sched = make_optimizer(cfg, model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            with full_f32():
                loss = batch_loss(cfg, forward, None, batch, gen)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                sched.step()

        ms = _time_ms(step, iters=20, warmup=3)
        prof = phase_profile(step, steps=5, what="step")
        res[head] = {"step_ms": ms, "steps_per_s": 1e3 / ms, "busy": prof.get("busy"),
                     "kernels": prof.get("kernels"), "device_us": prof.get("device_us")}
        log(f"[mil] {head} slide step [1, 4096, {DIM}]: {ms:.3f} ms by CUDA events (median of "
            f"20), {1e3 / ms:.1f} steps/s, device {prof.get('device_us', float('nan')):.1f} "
            f"us a step ({100 * prof.get('busy', float('nan')):.1f}% busy), "
            f"{prof.get('kernels')} kernels a step")
        del model, opt
    torch.cuda.empty_cache()
    return res


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|``, on the host in f32."""
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max() / want.abs().max())


def _mil_logit_errs(head: str, argv: list, preset, card, cpu, bags: list, sub: str) -> dict:
    """Slide logits of ``bags`` on the card against the CPU, relative to the
    largest |logit|, for the trained head (``card``/``cpu``) and for a seeded
    untrained head of the same architecture served from a ``.pt`` through
    ``build_predictor``: its outputs are not saturated, so they move with the
    precision of every product and with every patch of the bag. Both are held
    to ``MIL_LOGIT_RTOL``. Controls, printed: bf16 storage for both heads, and
    the seeded head's forward with TF32 on, which the tolerance must catch."""
    from moc_tpu_torch.cli import predict
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.train.mil import MilTrainConfig, build_model, model_from_params

    cfg = MilTrainConfig(model_type=head, model_size="conch", n_classes=2)
    state = build_model(cfg, in_dim=DIM)[2](torch.Generator().manual_seed(5))
    path = os.path.join(sub, f"{head}_seeded.pt")
    torch.save(state, path)
    seeded = [*argv[:argv.index("--model") + 1], path, *argv[argv.index("--model") + 2:],
              "--model_type", head, "--model_size", "conch"]
    s_card, _ = predict.build_predictor(predict.get_args([*seeded, "--device", "cuda"]),
                                        preset, torch.device("cuda"))
    s_cpu, _ = predict.build_predictor(predict.get_args([*seeded, "--device", "cpu"]),
                                       preset, torch.device("cpu"))
    errs = {}
    on_card = pack_bags(bags, device="cuda")
    for name, c_fn, p_fn in (("trained", card, cpu), ("seeded", s_card, s_cpu)):
        want = p_fn(pack_bags(bags, device="cpu"))
        errs[name] = _rel_err(c_fn(on_card), want)
        errs[f"{name}_bf16"] = _rel_err(c_fn(pack_bags(bags, device="cuda", dtype="bfloat16")),
                                        want)
        if name == "seeded":
            model, forward = model_from_params(cfg, state)
            model.cuda().eval()
            saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                with torch.no_grad():
                    errs["seeded_tf32"] = _rel_err(forward(None, on_card.features,
                                                           on_card.mask)[0], want)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
            del model
    for name in ("trained", "seeded"):
        check(errs[name] <= MIL_LOGIT_RTOL, f"{head} ({name}): card logits differ from the "
              f"CPU's by {errs[name]} of the largest |logit|")
    check(errs["seeded_tf32"] > MIL_LOGIT_RTOL, f"{head}: a TF32 forward passes the logit "
          f"check ({errs['seeded_tf32']}), which then cannot see the precision")
    return errs


def _titan_chunk_err(card, bag, chunked: torch.Tensor) -> float:
    """TITAN's logits of ``bag`` alone at the 16384 bucket with the whole
    ``[8, L, L]`` score matrix a layer (no query chunks) against ``chunked``,
    the same slide's row of the timed batch."""
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.models import titan

    one = pack_bags([bag], n_pad=N_PAD, device="cuda")
    limit = titan._SCORE_ELEMS
    titan._SCORE_ELEMS = 2 ** 62
    try:
        whole = card(one)
    finally:
        titan._SCORE_ELEMS = limit
    torch.cuda.empty_cache()
    return _rel_err(chunked, whole)


def phase_mil_predict(root: str, trained: dict) -> dict:
    """``cli.predict``'s MIL path (``build_predictor``, ``score_bags``) over
    the trained ``.msgpack`` of each head at batch 8 on the 16384 bucket,
    f32 and bf16 storage: the forward by CUDA events and a profile, the rows
    of two slides against the CPU in f32 (rtol 1e-4; TITAN on their first
    2048 patches, whose dense attention costs the CPU minutes at 16384) and
    their logits (``_mil_logit_errs``, the trained and a seeded head), bf16's
    largest probability error against f32 printed, TITAN's query-chunked
    attention against the whole on the card (``_titan_chunk_err``); then one
    ``cli.serve`` drain of the 16 bags with CLAM-SB's ``.msgpack``,
    rows equal to ``score_bags``'s, and no kernel of the port launched."""
    import dataclasses as dc

    from moc_tpu_torch.cli import predict, serve
    from moc_tpu_torch.config import PRESETS
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.data.batching import pack_bags

    t_phase = time.perf_counter()
    sub = os.path.join(root, "mil_predict")
    os.makedirs(sub)
    ids = write_corpus(sub)
    bags = [read_bag_pt(os.path.join(sub, "bags", "pt_files", f"{i}.pt")) for i in ids]
    preset = PRESETS["nsclc"]
    _reset_launches()
    res = {}
    for head in MIL_HEADS:
        argv = ["--dataset", "nsclc", "--model_kind", "mil", "--model",
                trained["single"][head]["msgpack"], "--feature_dir", os.path.join(sub, "bags"),
                "--batch_size", str(BATCH)]
        card, serving = predict.build_predictor(predict.get_args([*argv, "--device", "cuda"]),
                                                preset, torch.device("cuda"))
        cpu, _ = predict.build_predictor(predict.get_args([*argv, "--device", "cpu"]), preset,
                                         torch.device("cpu"))
        rec, rows = {}, {}
        for storage in ("float32", "bfloat16"):
            # the rows first: their forward is the timing's warm-up
            rows[storage] = predict.score_bags(card, bags[:BATCH], batch_size=BATCH,
                                               n_classes=2, temperature=serving.temperature,
                                               device=torch.device("cuda"), dtype=storage)
            batch = pack_bags(bags[:BATCH], n_pad=N_PAD, device="cuda", dtype=storage)
            rec[f"{storage}_ms"] = _time_ms(lambda: card(batch),
                                            iters=MIL_PREDICT_ITERS.get(head, 5), warmup=0)
            if storage == "float32":
                prof = phase_profile(lambda: card(batch), steps=1 if head == "titan" else 2,
                                     what="forward")
                rec.update(busy=prof.get("busy"), kernels=prof.get("kernels"),
                           top=prof.get("top"))
                if head == "titan":
                    chunked = card(batch)[:1].cpu()
            del batch
        if head == "titan":
            # the timed batch attends in query chunks (256 rows at B = 8); its first
            # slide against that slide's whole-matrix attention, on the card
            rec["chunk_err"] = _titan_chunk_err(card, bags[0], chunked)
            check(rec["chunk_err"] <= MIL_LOGIT_RTOL, f"titan: query-chunked logits differ "
                  f"from the whole attention's by {rec['chunk_err']}")
        probs = {k: np.array([[r["prob_0"], r["prob_1"]] for r in v]) for k, v in rows.items()}
        check(all(np.isfinite(p).all() and p.shape == (BATCH, 2) for p in probs.values()),
              f"{head}: predict rows not finite")
        check_bags = bags[:2]
        if head == "titan":
            check_bags = [dc.replace(b, features=b.features[:2048]) for b in check_bags]
        got, want = (np.array([[r["prob_0"], r["prob_1"]] for r in predict.score_bags(
            fn, check_bags, batch_size=2, n_classes=2, temperature=1.0, device=dev)])
            for fn, dev in ((card, torch.device("cuda")), (cpu, torch.device("cpu"))))
        cpu_err = float(np.abs(got - want).max())
        check(np.allclose(got, want, rtol=1e-4, atol=1e-6),
              f"{head}: card rows differ from the CPU's by {cpu_err}")
        rec.update(cpu_err=cpu_err, bf16_err=float(np.abs(probs["bfloat16"]
                                                          - probs["float32"]).max()))
        rec["logits"] = _mil_logit_errs(head, argv, preset, card, cpu, check_bags, sub)
        res[head] = rec
        lg = rec["logits"]
        log(f"[mil] predict {head} [{BATCH}, {N_PAD}, {DIM}]: forward {rec['float32_ms']:.3f} ms "
            f"f32 / {rec['bfloat16_ms']:.3f} ms bf16 storage (CUDA events), "
            f"{100 * (rec.get('busy') or float('nan')):.1f}% busy, {rec.get('kernels')} kernels; "
            f"rows card vs CPU max |diff| {cpu_err:.3e} (rtol 1e-4), bf16 storage vs f32 max "
            f"|diff| {rec['bf16_err']:.3e}; logits card vs CPU max |diff| / max |logit|: "
            f"trained {lg['trained']:.3e}, seeded {lg['seeded']:.3e} (tolerance "
            f"{MIL_LOGIT_RTOL:.0e}); controls: bf16 storage {lg['trained_bf16']:.3e} / "
            f"{lg['seeded_bf16']:.3e}, seeded head with TF32 on {lg['seeded_tf32']:.3e}"
            + (f"; query-chunked vs whole attention on the card {rec['chunk_err']:.3e}"
               if "chunk_err" in rec else ""))
        del card, cpu
        torch.cuda.empty_cache()
    args = serve.get_args(["--dataset", "nsclc", "--model_kind", "mil", "--model",
                           trained["single"]["clam_sb"]["msgpack"], "--device", "cuda",
                           "--watch_dir", os.path.join(sub, "bags"), "--once",
                           "--batch_size", str(BATCH)])
    t0 = time.perf_counter()
    server = serve.Server(args)
    n = serve.watch_once(server, os.path.join(sub, "bags"), os.path.join(sub, "served.csv"),
                         set())
    wall = time.perf_counter() - t0
    check(n == len(ids), f"serve --model_kind mil scored {n} of {len(ids)} bags")
    with open(os.path.join(sub, "served.csv"), newline="") as f:
        served = {r["slide_id"]: float(r["prob_1"]) for r in csv.DictReader(f)}
    direct = predict.score_bags(server.batch_logits, bags, batch_size=BATCH, n_classes=2,
                                temperature=1.0, device=torch.device("cuda"))
    serve_err = max(abs(served[r["slide_id"]] - r["prob_1"]) for r in direct)
    check(serve_err <= 1e-6, f"served rows differ from score_bags's by {serve_err}")
    launches = _all_launches()
    check(not any(launches.values()), f"the MIL serving path launched kernels: {launches}")
    log(f"[mil] serve --model_kind mil (train_mil's clam_sb .msgpack): {n} bags drained in "
        f"{wall:.2f}s, rows within {serve_err:.1e} of score_bags; kernel launches on the MIL "
        f"path: {launches}; predict phase wall {time.perf_counter() - t_phase:.1f}s")
    return {"heads": res, "serve_wall_s": wall, "serve_err": serve_err, "launches": launches}


# MI-Zero evaluation (moc_tpu/zeroshot/eval.py:66-132) and main_moc on the vendored
# NSCLC protocol: the CONCH text tower at full width (12 layers of 768, 12 heads,
# context 128, vocabulary 32007, output 512) from a fabricated release checkpoint,
# the vendored banks (22 templates a class: 176 prompts for nsclc's W and W_ext,
# 220 for rcc's), top-j pooling at MI-Zero's j over 16 slides of 1500-4000 patches,
# and one episode of shot 1, fold 0 (2 train, 50 val, 208 test bags of 500-2000
# patches at D = 512, 2 epochs)
ZS_TOPJ = (1, 5, 10, 50, 100)
ZS_SLIDES, ZS_PAD, ZS_PATCHES = 16, 4096, (1500, 4000)
ZS_BAG_PATCHES = (500, 2000)
ZS_EPOCHS = 2
ZS_ARGV = ["--dataset", "nsclc", "--shot", "1", "--fold", "0", "--topj", str(TOPJ), "--topk",
           str(TOPK), "--num_epochs", str(ZS_EPOCHS), "--seed", "0", "--device", "cuda"]
ZS_W_TOL = 1e-5  # |W_card - W_cpu|: unit-norm columns of 512 have entries of ~0.044
ZS_LOGIT_TOL = 1e-6


def _timed_encode(model, device: str):
    """``make_encode_text_fn``'s encode on ``device``, with each call's time
    (CUDA events around it on the card, the host clock on the CPU) and the
    TF32 flags seen at each text forward."""
    from moc_tpu_torch.zeroshot.classifier import make_encode_text_fn

    base, ms, flags = make_encode_text_fn(model, device), [], []
    model.text.register_forward_pre_hook(lambda *_: flags.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))

    def encode(ids):
        if device == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = base(ids)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = base(ids)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return encode, ms, flags


def phase_zeroshot_weights(root: str) -> dict:
    """A full-width release-layout CONCH checkpoint from seed 3, loaded by
    ``load_conch`` on the card and on the CPU; ``W`` and ``W_ext`` of the
    vendored nsclc and rcc banks built on both (hash vocabulary), within
    ``ZS_W_TOL``, with the TF32 flags off at every text forward on the card
    (turned on just before)."""
    from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT, NSCLC, RCC
    from moc_tpu_torch.zeroshot import (ConchTokenizer, build_zero_shot_classifier, load_conch,
                                        load_prompt_bank)
    from moc_tpu_torch.zeroshot.convert import random_conch_state_dict

    t0 = time.perf_counter()
    ckpt = os.path.join(root, "conch_zs.bin")
    sd = random_conch_state_dict(seed=3)
    torch.save(sd, ckpt)
    n_text = sum(v.numel() for k, v in sd.items() if k.startswith("text."))
    del sd
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = load_conch(ckpt, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    cpu = load_conch(ckpt, device="cpu")
    check(card.cfg.text.layers == 12 and card.cfg.text.width == 768
          and card.cfg.text.output_dim == 512, f"text config {card.cfg.text}")
    tokenizer = ConchTokenizer()
    encode_card, ms_card, flags = _timed_encode(card, "cuda")
    encode_cpu, ms_cpu, _ = _timed_encode(cpu, "cpu")
    encode_card(tokenizer(["a warm-up prompt"]))  # cuBLAS's first-call set-up, untimed
    weights, rec = {}, {"banks": {}}
    for preset in (NSCLC, RCC):
        for suffix, f, labels in (("", preset.prompt_file, preset.label_dict),
                                  ("_ext", preset.prompt_file_ext, preset.label_dict_ext)):
            bank = load_prompt_bank(os.path.join(DEFAULT_PROMPT_ROOT, f), labels)
            n_prompts = sum(len(t) for c in range(bank.n_classes)
                            for t in bank.texts_for_class(c))
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            del ms_card[:], ms_cpu[:]
            t0 = time.perf_counter()
            w = build_zero_shot_classifier(encode_card, tokenizer, bank)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            w_cpu = build_zero_shot_classifier(encode_cpu, tokenizer, bank)
            wall_cpu = time.perf_counter() - t0
            err = float(np.abs(w - w_cpu).max())
            name = f"{preset.name}{suffix}"
            check(w.shape == (512, bank.n_classes) and np.isfinite(w).all(),
                  f"W {name} shape {w.shape}")
            check(err <= ZS_W_TOL, f"W {name}: max |card - cpu| {err} above {ZS_W_TOL}")
            weights[name] = w
            rec["banks"][name] = {"prompts": n_prompts, "calls": len(ms_card),
                                  "card_ms": sum(ms_card), "card_wall_s": wall,
                                  "cpu_ms": sum(ms_cpu), "cpu_wall_s": wall_cpu,
                                  "max_abs_err": err}
            log(f"[zeroshot] W {name} {tuple(w.shape)} from {n_prompts} prompts in "
                f"{len(ms_card)} calls: card {sum(ms_card):.2f} ms by CUDA events "
                f"(text forward, copies in and out), {wall * 1e3:.1f} ms wall; CPU "
                f"{wall_cpu * 1e3:.1f} ms; max |W_card - W_cpu| {err:.3e} (limit {ZS_W_TOL})")
    check(flags and not any(a or b for a, b in flags),
          f"TF32 on during {sum(a or b for a, b in flags)} of {len(flags)} text forwards")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rec.update(ckpt=ckpt, weights=weights, text_params=n_text, write_s=t_write, load_s=t_load,
               max_abs_err=max(b["max_abs_err"] for b in rec["banks"].values()))
    log(f"[zeroshot] fabricated a CONCH checkpoint ({n_text / 1e6:.1f}M text parameters) in "
        f"{t_write:.1f}s, load_conch on cuda {t_load:.2f}s; TF32 off at all {len(flags)} "
        f"text forwards; largest |W_card - W_cpu| {rec['max_abs_err']:.3e}")
    del card, cpu
    torch.cuda.empty_cache()
    return rec


def phase_zeroshot_mizero(w: np.ndarray) -> dict:
    """K1 at MI-Zero's shapes ([16, 4096, 2], 1500-4000 valid rows a slide,
    k in ZS_TOPJ) through ``masked_col_topk_mask``, bit-equal to its plain
    version on the same keys, and timed; then ``run_mizero`` over 16 slides
    at D = 512 with nsclc's ``W`` on the card and on the CPU: pooled logits
    within ``ZS_LOGIT_TOL``, equal predictions and metrics, K1 launched once
    a j a batch (counted from 0 around the card's run)."""
    from moc_tpu_torch.data import Bag, pack_bags
    from moc_tpu_torch.ops import masked_col_topk_mask, masked_logits, threshold_topk_mask
    from moc_tpu_torch.ops import topk_kernel
    from moc_tpu_torch.zeroshot import run_mizero

    gen = torch.Generator(device="cuda").manual_seed(12)
    counts = torch.randint(ZS_PATCHES[0], ZS_PATCHES[1] + 1, (ZS_SLIDES,), generator=gen,
                           device="cuda")
    valid = torch.arange(ZS_PAD, device="cuda") < counts[:, None]
    keys = torch.randn(ZS_SLIDES, ZS_PAD, N_CLASSES, generator=gen, device="cuda")
    masked = masked_logits(keys, valid)
    records = []
    with torch.inference_mode():
        for k in ZS_TOPJ:
            got = masked_col_topk_mask(keys, valid, k)
            want = threshold_topk_mask(masked, k, axis=-2)
            check(torch.equal(got, want), f"K1 at MI-Zero's [16, 4096, 2] k={k} differs from plain")
            check(bool((got & valid[..., None]).sum(-2).eq(k).all()),
                  f"K1 at k={k}: not k valid rows a column")
            records.append(_k1_record(
                "cols", masked, k, lambda: topk_kernel.col_topk_threshold_mask_cuda(masked, k),
                lambda: threshold_topk_mask(masked, k, axis=-2),
                lambda: _library_mask(masked, k, -2)))
    rng = np.random.default_rng(12)
    bags = []
    for i in range(ZS_SLIDES):
        n, y = int(rng.integers(ZS_PATCHES[0], ZS_PATCHES[1] + 1)), i % N_CLASSES
        f = rng.normal(size=(n, DIM)).astype(np.float32)
        f[: n // 4] += 0.05 * w[:, y]
        bags.append(Bag(slide_id=f"zs{i}", features=f, label=y,
                        coords=rng.integers(0, 10 ** 5, (n, 2)).astype(np.int32)))
    runs = {}
    for device in ("cuda", "cpu"):
        batches = [pack_bags(bags[i: i + BATCH], n_pad=ZS_PAD, device=device, with_coords=True)
                   for i in range(0, ZS_SLIDES, BATCH)]
        for fn in _k1_wrappers().values():
            fn.launches = 0
        t0 = time.perf_counter()
        runs[device] = run_mizero(batches, w, topj=ZS_TOPJ, dump_patch_level=True)
        wall = time.perf_counter() - t0
        launches = {e: fn.launches for e, fn in _k1_wrappers().items()}
        if device == "cuda":
            want = {"rows": 0, "cols": len(ZS_TOPJ) * len(batches)}
            check(launches == want, f"run_mizero launched K1 {launches}, want {want}")
            card_wall, card_launches = wall, launches["cols"]
    (res, dump), (res_cpu, dump_cpu) = runs["cuda"], runs["cpu"]
    err = max(float(np.abs(dump["logits"][j] - dump_cpu["logits"][j]).max()) for j in ZS_TOPJ)
    check(err <= ZS_LOGIT_TOL, f"run_mizero pooled logits differ by {err}")
    for j in ZS_TOPJ:
        check(np.array_equal(dump["preds"][j], dump_cpu["preds"][j]), f"preds differ at j={j}")
    for m, per_j in res.items():
        for j, v in per_j.items():
            same = (math.isnan(v) and math.isnan(res_cpu[m][j])) or v == res_cpu[m][j]
            check(same, f"run_mizero {m} at j={j}: card {v}, CPU {res_cpu[m][j]}")
    check(len(dump["coords"]) == ZS_SLIDES and all(
        np.array_equal(c, b.coords) for c, b in zip(dump["coords"], bags)), "coords dump")
    log(f"[zeroshot] run_mizero over {ZS_SLIDES} slides ({len(ZS_TOPJ)} j x 2 batches of "
        f"{BATCH} x {ZS_PAD} x {DIM}) on cuda: {card_wall * 1e3:.1f} ms wall, K1 launched "
        f"{card_launches} times; pooled logits within {err:.3e} of the CPU, predictions and "
        f"metrics equal; auc {res['roc_auc']}, bacc {res['bacc']}")
    return {"k1": records, "launches": card_launches, "logit_err": err, "wall_s": card_wall,
            "metrics": res}


def _write_nsclc_bags(data_root: str) -> int:
    """One seeded ``.pt`` bag at D = 512 (500-2000 patches) for each slide of
    the vendored nsclc 1-shot split 0, and nothing else under ``data_root``."""
    from moc_tpu_torch.config import NSCLC
    from moc_tpu_torch.data import read_split_csv
    from moc_tpu_torch.data.bags import write_bag_pt

    split = read_split_csv(NSCLC.split_csv(data_root, 1, 0))
    check((len(split.train), len(split.val), len(split.test)) == (2, 50, 208),
          f"vendored split sizes {len(split.train)}, {len(split.val)}, {len(split.test)}")
    rng = np.random.default_rng(5)
    ids = [*split.train, *split.val, *split.test]
    for sid in ids:
        n = int(rng.integers(ZS_BAG_PATCHES[0], ZS_BAG_PATCHES[1] + 1))
        write_bag_pt(os.path.join(data_root, NSCLC.feature_dir, "pt_files", f"{sid}.pt"),
                     rng.normal(size=(n, DIM)).astype(np.float32))
    return len(ids)


def phase_zeroshot_main_moc(root: str, ckpt: str) -> dict:
    """``cli.main_moc.main --dataset nsclc`` on the card with a data root of
    bags only: the table and split come from the vendored files, ``W`` and
    ``W_ext`` are built from the vendored banks through the text tower of
    ``ckpt`` into an empty cache; the result files are written; K1 runs in
    the training steps. A second run reads the caches, with a checkpoint
    path that does not exist, and leaves their bytes as they were."""
    from moc_tpu_torch.cli import main_moc

    data_root = os.path.join(root, "nsclc_data")
    t0 = time.perf_counter()
    n_bags = _write_nsclc_bags(data_root)
    write_s = time.perf_counter() - t0
    check(sorted(os.listdir(data_root)) == ["data"], f"data root holds {os.listdir(data_root)}")
    cache = os.path.join(root, "zs_weights")
    build_s = []
    inner = main_moc._build_weights

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        build_s.append(time.perf_counter() - t0)
        return out

    main_moc._build_weights = timed
    runs = []
    try:
        for i, path in enumerate((ckpt, os.path.join(root, "absent_conch.bin"))):
            result_dir = os.path.join(root, f"nsclc_run{i}")
            rc, stdout, rec, launches, wall = _main_moc_recorded(
                [*ZS_ARGV, "--data_root", data_root, "--conch_checkpoint", path,
                 "--weights_cache_dir", cache, "--result_dir", result_dir])
            check(rc == 0, f"main_moc --dataset nsclc run {i} returned {rc}")
            check("zeroshot weights: (512, 2), ext: (512, 6)" in stdout,
                  f"run {i} printed no zero-shot weight shapes")
            for name in ("best_results", "zs_results"):
                check(os.path.exists(os.path.join(result_dir, f"{name}_shot_1_fold_0.json")),
                      f"run {i} wrote no {name}")
            check(os.path.exists(os.path.join(result_dir, "best_model_shot_1_fold_0.msgpack")),
                  f"run {i} wrote no best_model")
            with open(os.path.join(result_dir, "best_results_shot_1_fold_0.json")) as f:
                result = json.load(f)
            losses = [x for epoch in rec["losses"] for x in epoch]
            check(list(result) == RESULT_KEYS, f"result keys {list(result)}")
            check(len(losses) == ZS_EPOCHS * N_CLASSES and all(map(math.isfinite, losses)),
                  f"run {i}: {len(losses)} training losses, not all finite")
            want = ZS_EPOCHS * N_CLASSES
            check(rec["steps"] == {"rows": want, "cols": want},
                  f"run {i}: the training steps launched K1 {rec['steps']}, want {want} each")
            caches = {n: open(os.path.join(cache, n), "rb").read()
                      for n in ("weights_nsclc_conch.npz", "weights_nsclc_ext_conch.npz")}
            runs.append({"wall_s": wall, "build_s": build_s[-1], "launches": launches,
                         "launches_steps": rec["steps"], "result": result, "caches": caches})
            log(f"[zeroshot] main_moc {' '.join(ZS_ARGV)} run {i} ("
                f"{'built the caches' if i == 0 else 'from the caches, checkpoint absent'}): "
                f"weights {build_s[-1]:.2f}s, episode wall {wall:.2f}s; K1 launches: training "
                f"steps {rec['steps']}, whole run {launches}; test AUC at best val "
                f"{result['test_at_best_val']}, zero-shot test {result['zero_shot_test']}")
    finally:
        main_moc._build_weights = inner
    check(runs[1]["caches"] == runs[0]["caches"], "the second run changed the weight caches")
    log(f"[zeroshot] {n_bags} nsclc bags written in {write_s:.1f}s; cache bytes equal after "
        f"the second run")
    return {"runs": [{k: v for k, v in r.items() if k != "caches"} for r in runs],
            "bags_write_s": write_s}



# --------------------------------------------- ViLa, the adapters, LoRA, accum

VILA_EPOCHS = 2
VILA_ARGV = [*MIL_ARGV[:-2], "--max_epochs", str(VILA_EPOCHS), "--model_type", "vila"]
VILA_RESULT_KEYS = ["val_auc", "test_auc", "test_acc", "stop_epoch", "model_type", "n_classes"]
NARROW_LAYERS = 2  # the depth of the card-against-CPU runs, at the full width
# LoRA: the JAX CLI's flags at CONCH's trunk (448 px, patch 16, 12 layers of 768, 12
# heads: [8, 12, 785, 64] a minibatch), rank 4; 16 patches a slide keep every
# minibatch's activations for the backward within the card's memory
LORA_ARGV = ["--image_size", "448", "--patch_size", "16", "--dim", "768", "--layers", "12",
             "--heads", "12", "--lora_rank", "4", "--epochs", "1", "--slides_per_class", "2",
             "--val_per_class", "2", "--patches_per_slide", "16", "--minibatch", "8",
             "--seed", "0"]
LORA_EXPERTS = (1, 4)
LORA_KEYS = ["best_val_auc", "lora_rank", "lora_experts", "balance_coef", "epochs"]
ADAPTER_VALID, ADAPTER_TOPJ, ADAPTER_AUX = 12000, 10, 1024


def _grad_err(card: list, cpu: list) -> tuple[float, float]:
    """(max |card - cpu| over every gradient, the largest |cpu grad|)."""
    scale = max(float(g.abs().max()) for g in cpu)
    return max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu)), scale


# a first step's card-against-CPU check in float64: the same code on both
# devices, free of f32's rounding order, so a wrong operation shows far
# above it
F64_GRAD_REL = 1e-9


def _first_step_parity(model0: torch.nn.Module, loss_of, what: str) -> dict:
    """One first step of ``model0`` on the card and the CPU:
    ``loss_of(model, device, dtype)`` moves its inputs there, runs the
    forward and returns the loss (freezing what it must first). In float64
    the card's loss and gradients must be within ``F64_GRAD_REL`` of the
    CPU's (relative to the largest |grad|). In float32 (TF32 off) the
    card's gradients are held against the float64 CPU reference: within
    1e-5 of the largest |grad|, or no farther from it than 4x the float32
    CPU's own distance (a sum of cancelling terms, such as a bias feeding a
    LayerNorm, keeps a relative rounding error of ~1e-4 on either device).
    The control: the float32 step on the card once more with TF32 allowed,
    which must land past that limit, else the limit cannot see a forward or
    backward left in TF32."""
    import copy

    from moc_tpu_torch.models.layers import full_f32

    runs = {}
    for dtype in (torch.float64, torch.float32):
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model0).to(device=dev, dtype=dtype)
            with full_f32():
                loss = loss_of(m, dev, dtype)
                loss.backward()
            runs[dev, dtype] = (float(loss.detach()),
                                [p.grad.detach().cpu().double() for p in m.parameters()
                                 if p.requires_grad])
    f64_err, scale = _grad_err(runs["cuda", torch.float64][1], runs["cpu", torch.float64][1])
    f64_loss = abs(runs["cuda", torch.float64][0] - runs["cpu", torch.float64][0])
    ref = runs["cpu", torch.float64][1]
    card32, _ = _grad_err(runs["cuda", torch.float32][1], ref)
    cpu32, _ = _grad_err(runs["cpu", torch.float32][1], ref)
    loss32 = abs(runs["cuda", torch.float32][0] - runs["cpu", torch.float32][0])
    check(f64_err <= F64_GRAD_REL * scale and f64_loss <= F64_GRAD_REL * max(1.0, abs(
        runs["cpu", torch.float64][0])), f"{what} first step in float64 card/CPU: gradients "
          f"{f64_err:.3e} (largest {scale:.3e}), loss {f64_loss:.3e}")
    m = copy.deepcopy(model0).to(device="cuda", dtype=torch.float32)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        loss_of(m, "cuda", torch.float32).backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    tf32, _ = _grad_err([p.grad.detach().cpu().double() for p in m.parameters()
                         if p.requires_grad], ref)
    limit = max(1e-5 * scale, 4 * cpu32)
    check(card32 <= limit,
          f"{what} first step in float32: the card's gradients {card32:.3e} from the float64 "
          f"reference, the CPU's {cpu32:.3e} (largest |grad| {scale:.3e})")
    check(tf32 > limit, f"{what} first step with TF32 on: gradients {tf32:.3e} from the "
          f"float64 reference, within the float32 limit {limit:.3e}, which then cannot see "
          f"the precision")
    return {"f64_grad_err": f64_err, "grad_scale": scale, "f64_loss_err": f64_loss,
            "f32_card_err": card32, "f32_cpu_err": cpu32, "f32_loss_err": loss32,
            "f32_limit": limit, "tf32_control_err": tf32}


def _write_large_scale(root: str) -> tuple[str, int]:
    """ViLa's second scale beside the MIL corpus: each slide's bag of its
    small-scale rows in a seeded order, three quarters of them (at least
    1500), plus noise of 0.05. Returns the dir and the bag count."""
    from moc_tpu_torch.cli import main_moc
    from moc_tpu_torch.data import SlideTable
    from moc_tpu_torch.data.bags import read_bag_pt, write_bag_pt

    corpus = main_moc._synthetic_setup(main_moc.get_args(
        [*TRAIN_ARGV, "--result_dir", os.path.join(root, "moc_train")]))
    table = SlideTable.from_csv(corpus["csv_path"], corpus["label_dict"])
    out = os.path.join(root, "vila_large")
    rng = np.random.default_rng(5)
    for sid in table.slide_ids_:
        f = read_bag_pt(os.path.join(corpus["data_dir"], "pt_files", f"{sid}.pt")).features
        n = max(TRAIN_PATCHES[0], 3 * len(f) // 4)
        rows = f[rng.permutation(len(f))[:n]] + 0.05 * rng.normal(size=(n, f.shape[1]))
        write_bag_pt(os.path.join(out, "pt_files", f"{sid}.pt"), rows.astype(np.float32))
    return out, len(table.slide_ids_)


def phase_vila(root: str) -> dict:
    """ViLa-MIL (``[vila]``): ``cli.train_mil.main --model_type vila`` on the
    card over the MIL corpus at two scales (1500-4000-patch bags), with a
    release-layout CONCH checkpoint fabricated from seed 4 (text tower at the
    release width: 12 layers of 768, 12 heads, 128 tokens, vocabulary 32007;
    its vision trunk narrowed, as ViLa reads only the text tower): JAX's file
    names and keys, finite AUCs, no kernel of the port launched (ViLa is
    dense, as in JAX); the step by CUDA events with a profile, the fold's
    wall; the first step's loss and gradients at a 2-layer text tower of the
    same width on the card against the CPU (within 1e-5 of the largest
    |grad|), and the trained and the seeded model's logits on test bags."""
    import copy
    import dataclasses

    from moc_tpu_torch.cli import train_mil
    from moc_tpu_torch.convert import from_jax
    from moc_tpu_torch.data.vila_data import DualScaleLoader
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.models.vila import (PromptTensors, ViLaMIL, VilaConfig,
                                           build_prompt_constants)
    from moc_tpu_torch.train.vila import graft_text_params, vila_loss
    from moc_tpu_torch.utils.checkpoint import load_params
    from moc_tpu_torch.zeroshot.convert import random_conch_state_dict
    from moc_tpu_torch.zeroshot.text_tower import TextConfig
    from moc_tpu_torch.zeroshot.tokenizer import ConchTokenizer
    from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

    t_phase = time.perf_counter()
    _mil_corpus(root)
    data_l, n_bags = _write_large_scale(root)
    ckpt = os.path.join(root, "conch_vila.bin")
    torch.save(random_conch_state_dict(
        VisionConfig(image_size=32, patch_size=16, width=64, layers=1, heads=1,
                     embed_dim_contrast=512, embed_dim_caption=64, n_queries_caption=4),
        seed=4, text=TextConfig()), ckpt)
    argv = [*VILA_ARGV, "--data_dir_l", data_l, "--conch_checkpoint", ckpt, "--result_dir",
            os.path.join(root, "moc_train"), "--device", "cuda"]
    _reset_launches()
    rc, stdout, wall = _run_train_mil(argv)
    launches = _all_launches()
    check(rc == 0, f"train_mil vila returned {rc}")
    path = os.path.join(root, "moc_train", f"vila_shot_{TRAIN_SHOT}_fold_0.json")
    with open(path) as f:
        payload = json.load(f)
    check(list(payload) == VILA_RESULT_KEYS, f"vila result keys {list(payload)}")
    check(all(math.isfinite(payload[k]) for k in ("val_auc", "test_auc", "test_acc")),
          f"vila: non-finite metrics {payload}")
    msgpack = path[:-len(".json")] + ".msgpack"
    check(os.path.exists(msgpack), "vila: no .msgpack")
    check(not any(launches.values()), f"the ViLa path launched the port's kernels: {launches}")
    val_aucs = [float(line.split("auc=")[1].split()[0]) for line in stdout.splitlines()
                if line.startswith("epoch ")]
    log(f"[vila] train_mil --model_type vila on cuda ({VILA_EPOCHS} epochs of {TRAIN_VISITS} "
        f"steps, {n_bags} large-scale bags beside the small): fold wall {wall:.2f}s, val AUC by "
        f"epoch {val_aucs}, test AUC at best val {payload['test_auc']:.4f}, test acc "
        f"{payload['test_acc']:.4f}; K1-K4 launches {launches}")

    args = train_mil.get_args(argv)
    table, data_dir, split, n_classes = train_mil._resolve_dataset(args, TRAIN_SHOT, 0)
    loader = DualScaleLoader(table, data_dir, data_l)
    bags = {k: loader.read_all(getattr(split, k)[:4]) for k in ("train", "test")}
    text_cfg, token_table, text_params = train_mil.vila_text_setup(args, DIM)
    prompts = build_prompt_constants(token_table, ConchTokenizer(),
                                     train_mil.vila_prompts(args, n_classes))
    cfg = VilaConfig(n_classes=n_classes, input_size=DIM, text=text_cfg)
    check(text_cfg.width == 768 and text_cfg.layers == 12 and text_cfg.heads == 12,
          f"text config {text_cfg}")
    prompts_card = PromptTensors.of(prompts, "cuda")

    model = ViLaMIL(cfg, torch.Generator().manual_seed(1), draw_text=False)
    graft_text_params(model, text_params)
    seeded = copy.deepcopy(model)
    model = model.cuda()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-5)
    bag = bags["train"][0].to("cuda")

    def step():
        with full_f32():
            loss = vila_loss(model, bag, prompts_card)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()

    step_ms = _time_ms(step, iters=20, warmup=3)
    prof = phase_profile(step, steps=5, what="step")
    log(f"[vila] the slide step (text tower 12 x 768 on 4 prompts of 128 tokens, both scales "
        f"of a {bag.feats_s.shape[0]}/{bag.feats_l.shape[0]}-row bag, AdamW) {step_ms:.2f} ms "
        f"by CUDA events; busy {100 * prof.get('busy', float('nan')):.1f}%")

    # the card against the CPU at a 2-layer text tower of the same width
    narrow = VilaConfig(n_classes=n_classes, input_size=DIM,
                        text=dataclasses.replace(text_cfg, layers=NARROW_LAYERS))
    base = ViLaMIL(narrow, torch.Generator().manual_seed(2), draw_text=False)
    graft_text_params(base, {k: v for k, v in text_params.items()
                             if not k.startswith("transformer.resblocks.")
                             or int(k.split(".")[2]) < NARROW_LAYERS})
    train_bag = bags["train"][0]

    def vila_first(m, dev, dtype):
        pt = PromptTensors.of(prompts, dev)
        pt.token_prefix, pt.token_suffix = pt.token_prefix.to(dtype), pt.token_suffix.to(dtype)
        b = train_bag.to(dev)
        b.feats_s, b.feats_l = b.feats_s.to(dtype), b.feats_l.to(dtype)
        return vila_loss(m, b, pt)

    first = _first_step_parity(base, vila_first, "vila")
    logit_errs = {}
    trained = from_jax(ViLaMIL(cfg), load_params(msgpack))
    for name, m in (("trained", trained), ("seeded", seeded)):
        out = {}
        for dev in ("cuda", "cpu"):
            md = copy.deepcopy(m).to(dev).eval()
            with torch.no_grad(), full_f32():
                out[dev] = torch.stack([md(b.feats_s.to(dev), b.mask_s.to(dev),
                                           b.feats_l.to(dev), b.mask_l.to(dev),
                                           PromptTensors.of(prompts, dev))["logits"]
                                        for b in bags["test"][:2]])
        logit_errs[name] = _rel_err(out["cuda"], out["cpu"])
        check(logit_errs[name] <= MIL_LOGIT_RTOL,
              f"vila {name} logits card/CPU differ by {logit_errs[name]:.3e} of the largest")
    log(f"[vila] card vs CPU, first step at {NARROW_LAYERS} text layers of 768: float64 "
        f"gradients max |diff| {first['f64_grad_err']:.3e} (largest |grad| "
        f"{first['grad_scale']:.3e}), loss {first['f64_loss_err']:.3e}; float32 gradients from "
        f"the float64 reference: card {first['f32_card_err']:.3e}, CPU "
        f"{first['f32_cpu_err']:.3e} (limit {first['f32_limit']:.3e}), TF32 on "
        f"{first['tf32_control_err']:.3e}, loss card/CPU {first['f32_loss_err']:.3e}; "
        f"logits of 2 test bags (12 layers), trained {logit_errs['trained']:.3e} and seeded "
        f"{logit_errs['seeded']:.3e} of the largest |logit| (limit {MIL_LOGIT_RTOL})")
    del model, opt, trained, seeded
    torch.cuda.empty_cache()
    res = {"wall_s": wall, "result": payload, "epoch_val_auc": val_aucs, "step_ms": step_ms,
           "busy": prof.get("busy"), "kernels_a_step": prof.get("kernels"),
           "first_step": first, "logit_err": logit_errs, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[vila] phase wall {res['phase_s']:.1f}s")
    return res


def _adapter_modules() -> dict:
    """Each adapter at the serving point's width, drawn from seeded CPU
    generators; ``zero_shot`` has no module."""
    from moc_tpu_torch.models import adapters as ad

    cfg = ad.AdapterConfig(c_in=DIM, n_classes=N_CLASSES, topj=ADAPTER_TOPJ)

    def g(seed):
        return torch.Generator().manual_seed(seed)

    return {"clip": ad.ClipAdapter(cfg, g(1)), "tip": ad.TipAdapter(cfg, generator=g(2)),
            "moe": ad.MoEClipAdapter(cfg, 5, use_switch_gate=True, use_balance_loss=True,
                                     generator=g(3)),
            "amu": ad.AMUAdapter(cfg, ADAPTER_AUX, 0.1, "entropy", generator=g(4)),
            "zero_shot": None}


def phase_adapters() -> dict:
    """The CLIP adapters (``[adapters]``) at the serving point, one bag of
    [16384, 512] (12000 valid), C = 2, top-j 10: each forward and backward
    on the card against the CPU (pooled outputs within 1e-5 of the largest
    |value|, gradients of the features and the parameters within 1e-5 of
    the largest |grad|), K1's column entry launched once a pooling (AMU
    twice), counted around the card's run; each forward + backward by CUDA
    events; K1 at [16384, 2] k=10."""
    import copy

    from moc_tpu_torch.models import adapters as ad
    from moc_tpu_torch.models.layers import full_f32

    cpu = torch.Generator().manual_seed(6)
    feats = torch.randn(N_PAD, DIM, generator=cpu)
    valid = torch.arange(N_PAD) < ADAPTER_VALID
    aux = torch.randn(N_PAD, ADAPTER_AUX, generator=cpu)
    clf = torch.nn.functional.normalize(torch.randn(DIM, N_CLASSES, generator=cpu), dim=0)
    on = {dev: (feats.to(dev), valid.to(dev), aux.to(dev), clf.to(dev)) for dev in ("cuda", "cpu")}

    def run(name, module, dev):
        f, v, a, c = on[dev]
        x = f.clone().requires_grad_()
        with full_f32():
            if name == "zero_shot":
                y = ad.zero_shot_pooled(x, v, c, ADAPTER_TOPJ)
            elif name == "amu":
                y = module(x, v, a, c)
            else:
                y = module(x, v, c)
            ys = y if isinstance(y, tuple) else (y,)
            sum((t * (i + 1)).sum() for i, t in enumerate(ys)).backward()
        grads = [x.grad] + ([] if module is None else [p.grad for p in module.parameters()])
        return [t.detach() for t in ys], grads

    res = {"adapters": {}, "launches": {}}
    for name, module in _adapter_modules().items():
        card = None if module is None else copy.deepcopy(module).cuda()
        _reset_launches()
        ys, grads = run(name, card, "cuda")
        torch.cuda.synchronize()
        launches = _all_launches()
        want = 2 if name == "amu" else 1
        check(launches["cols"] == want and launches["rows"] == 0
              and not any(launches[k] for k in ("K2", "K3", "K4")),
              f"adapter {name} launched {launches}, not {want} K1 column launch(es)")
        res["launches"][name] = launches["cols"]
        ys_cpu, grads_cpu = run(name, module, "cpu")
        out_err = max(_rel_err(a, b) for a, b in zip(ys, ys_cpu))
        grad_err, scale = _grad_err(grads, grads_cpu)
        check(out_err <= 1e-5 and grad_err <= 1e-5 * scale,
              f"adapter {name} card/CPU: outputs {out_err:.3e}, gradients {grad_err:.3e} "
              f"(largest {scale:.3e})")
        if card is not None:
            card.zero_grad(set_to_none=True)
        ms = _time_ms(lambda: run(name, card, "cuda"), iters=20, warmup=3)
        res["adapters"][name] = {"out_err": out_err, "grad_err": grad_err, "grad_scale": scale,
                                 "fwd_bwd_ms": ms, "k1_launches": launches["cols"]}
        log(f"[adapters] {name} at [{N_PAD}, {DIM}] ({ADAPTER_VALID} valid), C={N_CLASSES}, "
            f"top-j {ADAPTER_TOPJ}: forward + backward {ms:.3f} ms by CUDA events; K1 column "
            f"launches {launches['cols']}; card vs CPU outputs {out_err:.3e} of the largest, "
            f"gradients {grad_err:.3e} (largest |grad| {scale:.3e})")
    res["k1"] = _k1_at_shapes((("cols", (N_PAD, N_CLASSES), ADAPTER_TOPJ),), seed=6)["cols"][0]
    return res


def _lora_slide(args, seed: int):
    from moc_tpu_torch.cli import lora_finetune

    imgs, valid, label = lora_finetune.synthetic_bags(args, np.random.default_rng(seed), 1)[0]
    return torch.from_numpy(imgs), torch.from_numpy(valid), label


def _lora_randomized(model, seed: int):
    """``model`` with its zero-initialised LoRA B matrices and router drawn
    at random, so that the low-rank paths change the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.rsplit(".", 1)[-1].startswith(("lora_b", "lora_moe_b", "lora_router")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def phase_lora(root: str) -> dict:
    """(MoE-)LoRA fine-tuning (``[lora]``): ``cli.lora_finetune.main`` on the
    card at CONCH's trunk width (448 px, patch 16, 12 layers of 768, 12
    heads), rank 4 with 1 and with 4 experts, 1 epoch over 4 synthetic
    slides of 16 patches (minibatch 8) and 4 val slides: JAX's file names
    and keys, finite AUC; the slide step by CUDA events with a profile, its
    peak memory; the flash trunk (K2 forward, K3/K4 backward at [8, 12, 785,
    64] f32) against the dense trunk on the card at the f32 K2-K4 limits,
    K2, K3 and K4 launched 12 times each, counted around it, and both cast to
    bf16 at the bf16 limits; a 2-layer trunk of the same width on the card
    against the CPU (first-step loss and gradients, with a TF32 control);
    the trained and a seeded model's logits."""
    import contextlib
    import copy
    import io

    from moc_tpu_torch.cli import lora_finetune
    from moc_tpu_torch.convert import from_jax
    from moc_tpu_torch.models.layers import full_f32, softmax_cross_entropy
    from moc_tpu_torch.models.lora import init_patch_classifier, lora_optimizer
    from moc_tpu_torch.train.lora_finetune import (LoraFinetuneConfig, make_lora_train_step,
                                                   streamed_slide_logits)
    from moc_tpu_torch.utils.checkpoint import load_params

    t_phase = time.perf_counter()
    res = {"cli": {}, "step": {}, "parity": {}}
    for e in LORA_EXPERTS:
        out_dir = os.path.join(root, "lora")
        argv = [*LORA_ARGV, "--lora_experts", str(e), "--result_dir", out_dir, "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = lora_finetune.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"lora_finetune e={e} returned {rc}")
        launches = _all_launches()
        check(not any(launches.values()), f"the dense LoRA CLI launched {launches}")
        with open(os.path.join(out_dir, f"lora_r4_e{e}.json")) as f:
            payload = json.load(f)
        check(list(payload) == LORA_KEYS and math.isfinite(payload["best_val_auc"]),
              f"lora e={e} result {payload}")
        check(os.path.exists(os.path.join(out_dir, f"lora_r4_e{e}.msgpack")), "no .msgpack")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        res["cli"][e] = {"wall_s": wall, "best_val_auc": payload["best_val_auc"],
                         "peak_gib": peak}
        log(f"[lora] lora_finetune rank 4, {e} expert(s), on cuda: wall {wall:.2f}s, best val "
            f"AUC {payload['best_val_auc']:.4f}, peak {peak:.2f} GiB allocated")

        args = lora_finetune.get_args(argv)
        model = init_patch_classifier(lora_finetune.build_model(args),
                                      torch.Generator().manual_seed(0)).cuda()
        coef = args.balance_coef if e > 1 else 0.0
        cfg = LoraFinetuneConfig(minibatch=args.minibatch, learning_rate=args.lr,
                                 balance_coef=coef)
        step, _ = make_lora_train_step(lora_finetune.make_encode(model, coef), cfg, model)
        x, v, y = _lora_slide(args, 11)
        x, v = x.cuda(), v.cuda()

        def train_step():
            with full_f32():
                step(x, v, y)

        torch.cuda.reset_peak_memory_stats()
        step_ms = _time_ms(train_step, iters=5, warmup=1)
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = phase_profile(train_step, steps=2, what="step")
        res["step"][e] = {"ms": step_ms, "peak_gib": step_peak, "busy": prof.get("busy"),
                          "kernels": prof.get("kernels")}
        log(f"[lora] slide step ({args.patches_per_slide} patches, 2 minibatches of 8 at "
            f"448 px, 12 layers of 768, {e} expert(s), TF32 off): {step_ms:.1f} ms by CUDA "
            f"events, peak {step_peak:.2f} GiB, busy {100 * prof.get('busy', float('nan')):.1f}%")
        del model, step
        torch.cuda.empty_cache()

    # the flash trunk against the dense trunk: one state, one minibatch of 8
    args = lora_finetune.get_args([*LORA_ARGV, "--result_dir", root])
    x8 = _lora_slide(args, 12)[0][:8].cuda()
    base = _lora_randomized(init_patch_classifier(lora_finetune.build_model(args),
                                                  torch.Generator().manual_seed(3)), 4)
    runs = {}
    for impl in ("dense", "flash"):
        m = lora_finetune.build_model(args, attn_impl=impl)
        m.load_state_dict(base.state_dict())
        m = m.cuda()
        lora_optimizer(m, 1e-3, ("head",))

        def fwd_bwd(m=m):
            with full_f32():
                (m(x8) * torch.tensor([1.0, -1.5], device="cuda")).sum().backward()

        _reset_launches()
        with full_f32():
            logits = m(x8)
            (logits * torch.tensor([1.0, -1.5], device="cuda")).sum().backward()
        torch.cuda.synchronize()
        launches = _all_launches()
        grads = [p.grad.detach().clone() for p in m.parameters() if p.requires_grad]
        m.zero_grad(set_to_none=True)
        runs[impl] = {"logits": logits.detach(), "grads": grads, "launches": launches,
                      "ms": _time_ms(fwd_bwd, iters=5, warmup=1)}
        del m
        torch.cuda.empty_cache()
    fl = runs["flash"]["launches"]
    check(fl["K2"] == fl["K3"] == fl["K4"] == TRUNK_LAYERS and fl["rows"] == fl["cols"] == 0,
          f"the flash LoRA trunk launched {fl}, not {TRUNK_LAYERS} of each of K2, K3, K4")
    check(not any(runs["dense"]["launches"].values()), "the dense trunk launched kernels")
    fwd_err = _rel_err(runs["flash"]["logits"], runs["dense"]["logits"])
    dense_grads = [g.cpu() for g in runs["dense"]["grads"]]
    bwd_err, bwd_scale = _grad_err(runs["flash"]["grads"], dense_grads)
    check(fwd_err <= F32_FWD_MAX_REL and bwd_err <= F32_BWD_MAX_REL * bwd_scale,
          f"flash LoRA trunk against dense: logits {fwd_err:.3e}, gradients {bwd_err:.3e} "
          f"(largest {bwd_scale:.3e})")
    res["flash"] = {"launches": fl, "fwd_err": fwd_err, "bwd_err": bwd_err,
                    "bwd_scale": bwd_scale, "flash_ms": runs["flash"]["ms"],
                    "dense_ms": runs["dense"]["ms"]}
    log(f"[lora] flash trunk vs dense on the card (8 images, [8, {HEADS}, {TOKENS}, "
        f"{HEAD_DIM}] f32, 12 layers, rank 4): logits {fwd_err:.3e} of the largest (limit "
        f"{F32_FWD_MAX_REL}), gradients {bwd_err / bwd_scale:.3e} of the largest |grad| "
        f"{bwd_scale:.3e} (limit {F32_BWD_MAX_REL}); K2/K3/K4 launches "
        f"{fl['K2']}/{fl['K3']}/{fl['K4']}; forward + backward {runs['flash']['ms']:.1f} ms "
        f"flash, {runs['dense']['ms']:.1f} ms dense (CUDA events)")
    # both trunks cast to bf16 from the same state: K2, K3 and K4 in their bf16
    # tier against the dense trunk in bf16, at the bf16 K2-K4 limits (largest
    # and mean |flash - dense|); each one's distance from the f32 dense trunk
    # is printed beside them
    w16 = torch.tensor([1.0, -1.5], device="cuda")
    runs16 = {}
    for impl in ("dense", "flash"):
        m = lora_finetune.build_model(args, attn_impl=impl)
        m.load_state_dict(base.state_dict())
        m = m.to("cuda", torch.bfloat16)
        lora_optimizer(m, 1e-3, ("head",))

        def fwd_bwd16(m=m):
            (m(x8.bfloat16()).float() * w16).sum().backward()

        _reset_launches()
        logits16 = m(x8.bfloat16())
        (logits16.float() * w16).sum().backward()
        torch.cuda.synchronize()
        launches = _all_launches()
        grads16 = [p.grad.float() for p in m.parameters() if p.requires_grad]
        m.zero_grad(set_to_none=True)
        runs16[impl] = {"logits": logits16.detach().float(), "grads": grads16,
                        "launches": launches, "ms": _time_ms(fwd_bwd16, iters=5, warmup=1)}
        del m
        torch.cuda.empty_cache()
    l16 = runs16["flash"]["launches"]
    check(l16["K2"] == l16["K3"] == l16["K4"] == TRUNK_LAYERS and l16["rows"] == l16["cols"] == 0,
          f"the bf16 flash LoRA trunk launched {l16}")
    check(not any(runs16["dense"]["launches"].values()), "the bf16 dense trunk launched kernels")
    f16, d16 = runs16["flash"], runs16["dense"]
    check(all(bool(torch.isfinite(t).all())
              for r in (f16, d16) for t in [r["logits"], *r["grads"]]),
          "a bf16 LoRA trunk gave non-finite logits or gradients")
    g16_scale = max(float(g.abs().max()) for g in d16["grads"])
    flat_f, flat_d = (torch.cat([g.flatten() for g in r["grads"]]) for r in (f16, d16))
    bf = {"fwd_err": _rel_err(f16["logits"], d16["logits"]),
          "fwd_mean_rel": _mean_rel(f16["logits"], d16["logits"], torch.bfloat16,
                                    "bf16 flash LoRA trunk logits against the bf16 dense trunk"),
          "bwd_err": max(float((a - b).abs().max()) for a, b in zip(f16["grads"], d16["grads"]))
          / g16_scale,
          "bwd_mean_rel": _mean_rel(flat_f, flat_d, torch.bfloat16,
                                    "bf16 flash LoRA trunk gradients against the bf16 dense trunk"),
          "bwd_scale": g16_scale}
    check(bf["fwd_err"] <= K2_TOL[torch.bfloat16] and bf["bwd_err"] <= BWD_TOL[torch.bfloat16],
          f"bf16 flash LoRA trunk against the bf16 dense trunk: logits {bf['fwd_err']:.3e} of "
          f"the largest (limit {K2_TOL[torch.bfloat16]}), gradients {bf['bwd_err']:.3e} of the "
          f"largest |grad| (limit {BWD_TOL[torch.bfloat16]})")
    for name, r in (("flash", f16), ("dense", d16)):
        bf[f"{name}_fwd_err_vs_f32"] = _rel_err(r["logits"], runs["dense"]["logits"])
        bf[f"{name}_bwd_err_vs_f32"] = _grad_err(r["grads"], dense_grads)[0] / bwd_scale
    res["flash_bf16"] = {"launches": l16, "ms": f16["ms"], "dense_ms": d16["ms"], **bf}
    log(f"[lora] the trunks in bf16 (K2/K3/K4 launches {l16['K2']}/{l16['K3']}/{l16['K4']}): "
        f"flash against dense, logits {bf['fwd_err']:.3e} of the largest (limit "
        f"{K2_TOL[torch.bfloat16]}), mean {bf['fwd_mean_rel']:.3e} (limit {BF16_MEAN_REL}); "
        f"gradients {bf['bwd_err']:.3e} of the largest |grad| {g16_scale:.3e} (limit "
        f"{BWD_TOL[torch.bfloat16]}), mean {bf['bwd_mean_rel']:.3e}; from the f32 dense trunk: "
        f"flash {bf['flash_fwd_err_vs_f32']:.3e} / {bf['flash_bwd_err_vs_f32']:.3e}, dense "
        f"{bf['dense_fwd_err_vs_f32']:.3e} / {bf['dense_bwd_err_vs_f32']:.3e} (logits / "
        f"gradients); forward + backward {f16['ms']:.1f} ms flash, {d16['ms']:.1f} ms dense")

    # the card against the CPU: a 2-layer trunk of the same width, one slide
    # of 4 patches (two minibatches of 2, so the queue merges twice)
    x, v, y = _lora_slide(args, 13)
    x, v = x[:4], v[:4]
    for e in LORA_EXPERTS:
        nargs = lora_finetune.get_args([*LORA_ARGV, "--layers", str(NARROW_LAYERS),
                                        "--lora_experts", str(e), "--result_dir", root])
        coef = nargs.balance_coef if e > 1 else 0.0
        cfg = LoraFinetuneConfig(queue_size=3, minibatch=2, balance_coef=coef)
        m0 = _lora_randomized(init_patch_classifier(lora_finetune.build_model(nargs),
                                                    torch.Generator().manual_seed(5)), 6)

        def lora_first(m, dev, dtype, coef=coef, cfg=cfg):
            lora_optimizer(m, 1e-3, ("head",))
            out = streamed_slide_logits(lora_finetune.make_encode(m, coef), x.to(dev, dtype),
                                        v.to(dev), cfg, with_aux=coef > 0)
            logits, bal = out if coef > 0 else (out, 0.0)
            return softmax_cross_entropy(logits[None], torch.tensor([y], device=dev))[0] \
                + coef * bal

        res["parity"][e] = _first_step_parity(m0, lora_first, f"lora e={e}")
        p = res["parity"][e]
        log(f"[lora] card vs CPU, first step of {NARROW_LAYERS} layers of 768 at 448 px (4 "
            f"patches), {e} expert(s): float64 gradients {p['f64_grad_err']:.3e} (largest |grad| "
            f"{p['grad_scale']:.3e}), loss {p['f64_loss_err']:.3e}; float32 gradients from the "
            f"float64 reference: card {p['f32_card_err']:.3e}, CPU {p['f32_cpu_err']:.3e} "
            f"(limit {p['f32_limit']:.3e}), TF32 on {p['tf32_control_err']:.3e}")
    # logits of the trained (the CLI's best, 1 expert) and a seeded model
    trained = from_jax(lora_finetune.build_model(args),
                       load_params(os.path.join(root, "lora", "lora_r4_e1.msgpack")))
    seeded = init_patch_classifier(lora_finetune.build_model(args),
                                   torch.Generator().manual_seed(8))
    res["logit_err"] = {}
    for name, m in (("trained", trained), ("seeded", seeded)):
        out = {}
        for dev in ("cuda", "cpu"):
            with torch.no_grad(), full_f32():
                out[dev] = copy.deepcopy(m).to(dev)(x[:1].to(dev))
        res["logit_err"][name] = _rel_err(out["cuda"], out["cpu"])
        check(res["logit_err"][name] <= MIL_LOGIT_RTOL,
              f"lora {name} logits card/CPU {res['logit_err'][name]:.3e} of the largest")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[lora] logits of one image (12 layers) card vs CPU: trained "
        f"{res['logit_err']['trained']:.3e}, seeded {res['logit_err']['seeded']:.3e} of the "
        f"largest |logit|; phase wall {res['phase_s']:.1f}s")
    return res


def phase_accum() -> dict:
    """Chunked-bag accumulation (``[accum]``): ``streaming_attention_pool``
    over a [16384, 512] bag (12000 valid) in chunks of 2048 through a
    512-256-256 GELU encoder, with and without remat, on the card against
    the CPU (pooled embedding, logsumexp and the encoder's gradients within
    1e-5), and its forward + backward by CUDA events."""
    import copy

    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.accum import chunk_bag, streaming_attention_pool

    cpu = torch.Generator().manual_seed(9)
    feats = torch.randn(N_PAD, DIM, generator=cpu)
    valid = torch.arange(N_PAD) < ADAPTER_VALID
    enc = torch.nn.Sequential(torch.nn.Linear(DIM, 256), torch.nn.GELU(), torch.nn.Linear(256, 256))
    score = torch.nn.Linear(256, 1)
    with torch.no_grad():
        for p in (*enc.parameters(), *score.parameters()):
            p.copy_(torch.randn(p.shape, generator=cpu) * p.shape[-1] ** -0.5)
    res = {}
    for remat in (True, False):
        out = {}
        for dev in ("cuda", "cpu"):
            e, s = copy.deepcopy(enc).to(dev), copy.deepcopy(score).to(dev)

            def run(e=e, s=s, dev=dev):
                with full_f32():
                    pooled, lse = streaming_attention_pool(
                        e, s, *chunk_bag(feats.to(dev), valid.to(dev), 2048), remat=remat)
                    (pooled.sum() + lse).backward()
                return pooled, lse

            pooled, lse = run()
            out[dev] = ([pooled.detach(), lse.detach()],
                        [p.grad.cpu() for p in (*e.parameters(), *s.parameters())])
            if dev == "cuda":
                ms = _time_ms(run, iters=10, warmup=2)
        val_err = max(_rel_err(a, b) for a, b in zip(*(out[d][0] for d in ("cuda", "cpu"))))
        grad_err, scale = _grad_err(out["cuda"][1], out["cpu"][1])
        check(val_err <= 1e-5 and grad_err <= 1e-5 * scale,
              f"accum remat={remat} card/CPU: values {val_err:.3e}, gradients {grad_err:.3e}")
        res["remat" if remat else "plain"] = {"val_err": val_err, "grad_err": grad_err,
                                              "grad_scale": scale, "ms": ms}
        log(f"[accum] streaming_attention_pool [{N_PAD}, {DIM}] in chunks of 2048, remat "
            f"{remat}: forward + backward {ms:.3f} ms by CUDA events; card vs CPU values "
            f"{val_err:.3e}, gradients {grad_err:.3e} (largest |grad| {scale:.3e})")
    return res



# ------------------------------------------------ the encoder stack's model half
# MoE pretraining: the MoE point of the JAX package's scripts/pretrain_mfu.py (BEiT-3-base
# width, 8 experts every second layer, top-2 gather dispatch) at batch 8 x 1024, vocab 8192
MOE_ARGV = ["--batch", "8", "--seq_len", "1024", "--layers", "12", "--embed_dim", "768",
            "--ffn_dim", "3072", "--heads", "12", "--vocab", "8192", "--mask_prob", "0.15",
            "--lr", "1e-3", "--mesh", "data=1", "--moe_experts", "8", "--moe_freq", "2"]
MOE_STEPS, MOE_TIERS = 3, {"f32": [], "bf16_params": ["--compute_dtype", "bfloat16",
                                                      "--param_dtype", "bfloat16"]}
# dilated (LongNet) attention at one 8192-token sequence of BEiT-3-base heads
DILATED_SEGMENTS, DILATED_RATIOS, DILATED_SHAPE = (2048, 4096, 8192), (1, 2, 4), (1, 8192, 12, 64)
DILATED_PAD_LEN, DILATED_PAD_RATIOS = 8000, (1, 2, 6)
# the encoder options card against CPU: 2 layers of BEiT-3-base width, batch 2 x 512
OPTIONS_SHAPE = (2, 512)
# MUSK-large's contrastive step: 8 images at 384 px and 8 texts of 100 tokens
CONTRAST_BATCH, CONTRAST_STEPS, CONTRAST_LR = 8, 3, 1e-4
# the caption decoder at CONCH's width over the vision tower's caption tokens
CAPTION_IMAGES, CAPTION_LEN, CAPTION_BEAM = 16, 30, 4
RETNET_LEN = 2048
# RetNet's forms agree up to the per-head norm's eps: the JAX package's own limit
# between them (rtol 2e-3, tests/test_encoder_retnet.py), of the largest |out|
RETNET_FORMS_REL = 2e-3
# K2-K4 at this slice's shapes: a dilated branch, MoE pretraining and MUSK's vision tower
SLICE_SHAPES = {"dilated_branch": (4, 12, 2048, 64), "moe_pretrain": (8, 12, 1024, 64),
                "musk_contrastive_vision": (CONTRAST_BATCH, MUSK_HEADS, MUSK_TOKENS, HEAD_DIM)}


def _launches() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def _zero_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _moe_dropped_share(model, batch) -> float:
    """Share of the top-2 choices that capacity dropped, over the MoE layers,
    from one forward of ``batch`` (forward hooks rerun each layer's gate)."""
    from moc_tpu_torch.parallel.moe import MoELayer, capacity_for, top2_gate

    counts = [0, 0]

    def hook(module, inputs, _out):
        x, mask = inputs[0], inputs[1] if len(inputs) > 1 else None
        cap = capacity_for(x.shape[0], module.cfg.n_experts, "top2")
        (c1, c2), _ = top2_gate(module.gate_logits(x), cap, mask, compact=True)
        counts[0] += int(c1[2].sum() + c2[2].sum())
        counts[1] += 2 * x.shape[0]

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, MoELayer)]
    try:
        with torch.no_grad():
            model(*batch)
    finally:
        for h in handles:
            h.remove()
    return 1 - counts[0] / counts[1]


def phase_moe() -> dict:
    """``[moe]``: ``cli.pretrain.main --device cuda`` at the MoE point (12 x
    768, 8 experts every second layer, batch 8 x 1024, vocab 8192) for
    ``MOE_STEPS`` steps, in f32 and with bf16 compute and bf16 parameters:
    finite losses and exactly 12 K2, K3 and K4 launches a step; then the
    step by CUDA events (median of 5 after 2), tokens/s, peak memory, a
    profile of one step and the share of top-2 choices that capacity drops."""
    import contextlib
    import io

    from moc_tpu_torch.cli import pretrain
    from moc_tpu_torch.train.pretrain import batch_to, make_pretrain_state, make_train_step

    records = {}
    for tier, flags in MOE_TIERS.items():
        argv = [*MOE_ARGV, *flags]
        err, out = io.StringIO(), io.StringIO()
        _zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            rc = pretrain.main([*argv, "--steps", str(MOE_STEPS), "--log_every", "1",
                                "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        check(rc == 0, f"[moe] {tier}: cli.pretrain.main returned {rc}")
        losses = [float(line.split("loss=")[1].split()[0]) for line in err.getvalue().splitlines()
                  if line.startswith("step ")]
        auxes = [float(line.split("aux=")[1].split()[0]) for line in err.getvalue().splitlines()
                 if line.startswith("step ")]
        check(len(losses) == MOE_STEPS and all(math.isfinite(x) for x in losses + auxes),
              f"[moe] {tier}: losses {losses}, aux {auxes}")
        want = PRETRAIN_LAYERS * MOE_STEPS
        check(launches == {"K2": want, "K3": want, "K4": want},
              f"[moe] {tier}: launched {launches}, want {want} of each")
        args = pretrain.get_args(argv)
        cfg = pretrain.build_config(args)
        model, optimizer = make_pretrain_state(cfg, seed=0, device="cuda")
        n_params = sum(p.numel() for p in model.parameters())
        step = make_train_step(cfg, model, optimizer)
        batch = batch_to(torch.device("cuda"), *pretrain.make_data_fn(args)(0))
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: step(*batch), iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[profile] MoE pretrain step {tier}:")
        prof = phase_profile(lambda: step(*batch), steps=1, what="step")
        masked = torch.where(batch[1], cfg.vocab_size - 1, batch[0])
        dropped = _moe_dropped_share(model, (masked,))
        tokens = args.batch * args.seq_len
        records[tier] = {"launches": launches, "losses": losses, "aux": auxes, "wall_s": wall,
                         "step_ms": ms, "tokens_per_s": tokens / ms * 1e3, "peak_gib": peak,
                         "dropped_share": dropped, "params": n_params,
                         "busy": prof.get("busy"), "top": prof.get("top")}
        log(f"[moe] {tier}: cli.pretrain.main {MOE_STEPS} steps, losses {losses}, aux {auxes}, "
            f"{wall:.2f}s host wall (set-up included), launches {launches}; step {ms:.3f} ms "
            f"by CUDA events (median of 5), {tokens / ms * 1e3:.0f} tokens/s, peak "
            f"{peak:.2f} GiB, {n_params / 1e6:.1f}M parameters, {100 * dropped:.2f}% of top-2 "
            "choices dropped by capacity")
        del model, optimizer, step, batch
        torch.cuda.empty_cache()
    return records


def _dilated_run(q, k, v, do, cfg, use_flash):
    """Output and (dq, dk, dv) of dilated attention, and the launches it made."""
    import dataclasses

    from moc_tpu_torch.parallel.dilated import dilated_attention

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    _zero_launches()
    out = dilated_attention(*leaves, dataclasses.replace(cfg, use_flash=use_flash))
    out.backward(do)
    torch.cuda.synchronize()
    return out.detach(), [t.grad for t in leaves], _launches()


def _rel_to_largest(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)) / max(
        float(w.float().abs().max()) for w in want)


def phase_dilated() -> dict:
    """``[dilated]``: ``dilated_attention`` forward and backward at [1, 8192,
    12, 64] (segments 2048/4096/8192, ratios 1/2/4) on the flash route
    against the plain route (``use_flash=False``) on the card, f32 and bf16
    (f32: within 1e-5 of the largest |out| and |grad|; bf16 against the plain
    route in f32 on the same inputs: 2e-2 and a 1% mean); K2 three launches a call, K3/K4 three a backward. The pad
    correction's case (L = 8000, ratios 1/2/6): the same limits, K3/K4
    none (its branches take the dense backward of the lse). Then a 12-layer
    pretrain step with dilated attention at 1 x 8192, with and without
    remat: launches (K2 36, 72 with remat; K3 and K4 36), first-step
    gradients of the two within 1e-6 of the largest, step times, peak."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.parallel.dilated import DilatedConfig

    gen = torch.Generator(device="cuda").manual_seed(11)
    records = {}
    cases = (("f32", torch.float32, DILATED_SHAPE, DILATED_RATIOS),
             ("bf16", torch.bfloat16, DILATED_SHAPE, DILATED_RATIOS),
             ("pad_f32", torch.float32, (1, DILATED_PAD_LEN, 12, 64), DILATED_PAD_RATIOS))
    for name, dtype, shape, ratios in cases:
        cfg = DilatedConfig(DILATED_SEGMENTS, ratios)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        # the branches' lse weights are f32, so the output is f32 in either tier
        do = torch.randn(shape[0], shape[1], shape[2] * shape[3], generator=gen, device="cuda")
        with full_f32():
            out, grads, launches = _dilated_run(q, k, v, do, cfg, True)
            # the plain route in f32 on the same (bf16-valued) inputs: the bf16
            # plain route rounds elsewhere than K2-K4 and sits farther from it
            ref, ref_grads, ref_launches = _dilated_run(q.float(), k.float(), v.float(), do,
                                                        cfg, False)
        padded = name.startswith("pad")
        want = {"K2": 3, "K3": 0 if padded else 3, "K4": 0 if padded else 3}
        check(launches == want and ref_launches == {"K2": 0, "K3": 0, "K4": 0},
              f"[dilated] {name}: flash route launched {launches} (want {want}), plain route "
              f"{ref_launches}")
        fwd = _rel_to_largest([out], [ref])
        bwd = _rel_to_largest(grads, ref_grads)
        if dtype == torch.float32:
            check(fwd <= F32_FWD_MAX_REL and bwd <= F32_BWD_MAX_REL,
                  f"[dilated] {name}: flash against plain {fwd:.3e} (out), {bwd:.3e} (grads) "
                  "of the largest")
        else:
            check(fwd <= K2_TOL[dtype] and bwd <= BWD_TOL[dtype],
                  f"[dilated] {name}: bf16 flash against plain {fwd:.3e}, {bwd:.3e}")
            _mean_rel(out, ref, dtype, "[dilated] bf16 out")
            for g, w in zip(grads, ref_grads):
                _mean_rel(g, w, dtype, "[dilated] bf16 grads")
        ms = _time_ms(lambda: _dilated_run(q, k, v, do, cfg, True), iters=10, warmup=2)
        plain_ms = _time_ms(lambda: _dilated_run(q, k, v, do, cfg, False), iters=5, warmup=1)
        records[name] = {"shape": list(shape), "ratios": list(ratios), "launches": launches,
                         "out_rel_err": fwd, "grad_rel_err": bwd, "fwd_bwd_ms": ms,
                         "plain_fwd_bwd_ms": plain_ms}
        log(f"[dilated] {name} {list(shape)} ratios {list(ratios)}: flash route against the "
            f"plain route on the card: out {fwd:.3e}, grads {bwd:.3e} of the largest; launches "
            f"{launches}; forward + backward {ms:.3f} ms (plain route {plain_ms:.3f} ms) by "
            "CUDA events")
        del q, k, v, do, out, grads, ref, ref_grads
        torch.cuda.empty_cache()
    records["pretrain"] = _dilated_pretrain()
    return records


def _dilated_pretrain() -> dict:
    import dataclasses

    from moc_tpu_torch.cli import pretrain
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.parallel.dilated import DilatedConfig
    from moc_tpu_torch.train.pretrain import (MaskedTokenModel, batch_to, make_pretrain_state,
                                              make_train_step, masked_token_loss)

    args = pretrain.get_args(["--batch", "1", "--seq_len", str(DILATED_SHAPE[1]), "--layers",
                              "12", "--embed_dim", "768", "--ffn_dim", "3072", "--heads", "12",
                              "--vocab", "8192"])
    base = pretrain.build_config(args)
    dil = DilatedConfig(DILATED_SEGMENTS, DILATED_RATIOS)
    state = MaskedTokenModel(base).init_parameters(torch.Generator().manual_seed(0)).state_dict()
    batch = batch_to(torch.device("cuda"), *pretrain.make_data_fn(args)(0))
    out, grads = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, dilated=dil,
                                                                    remat=remat))
        model, optimizer = make_pretrain_state(cfg, device="cuda", state_dict=state)
        with full_f32():
            _zero_launches()
            total, loss, _ = masked_token_loss(cfg, model, *batch)
            total.backward()
            torch.cuda.synchronize()
            launches = _launches()
        grads[remat] = [p.grad.detach().clone() for p in model.parameters()]
        want = {"K2": 72 if remat else 36, "K3": 36, "K4": 36}
        check(launches == want and math.isfinite(float(loss.detach())),
              f"[dilated] pretrain step (remat {remat}): launched {launches}, want {want}; "
              f"loss {float(loss.detach())}")
        step = make_train_step(cfg, model, optimizer)
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: step(*batch), iters=3, warmup=1)
        out["remat" if remat else "plain"] = {
            "launches": launches, "loss": float(loss.detach()), "step_ms": ms,
            "tokens_per_s": DILATED_SHAPE[1] / ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, optimizer, step
        torch.cuda.empty_cache()
    err = _rel_to_largest(grads[True], grads[False])
    check(err <= 1e-6, f"[dilated] remat gradients differ from the plain step's by {err:.3e}")
    out["remat_grad_rel_err"] = err
    log(f"[dilated] 12-layer pretrain step (12 x 768, 1 x 8192, f32): plain "
        f"{out['plain']['step_ms']:.3f} ms, peak {out['plain']['peak_gib']:.2f} GiB, launches "
        f"{out['plain']['launches']}; remat {out['remat']['step_ms']:.3f} ms, peak "
        f"{out['remat']['peak_gib']:.2f} GiB, launches {out['remat']['launches']}; first-step "
        f"gradients with and without remat within {err:.3e} of the largest")
    return out


def _card_cpu(model_cpu, forward, what: str, skip=("k_proj.bias", "k_proj.A.bias",
                                                    "k_proj.B.bias")) -> dict:
    """``forward(model, device) -> (out, loss)`` on a copy of ``model_cpu`` on
    the card and on the CPU, TF32 off: the outputs within 1e-5 of the
    largest |out|, the gradients within 1e-5 of the largest |grad| (but a
    key bias's, 0 save for rounding under a softmax)."""
    import copy

    from moc_tpu_torch.models.layers import full_f32

    runs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model_cpu).to(dev)
        with full_f32():
            out, loss = forward(m, dev)
            loss.backward()
        runs[dev] = (out.detach().float().cpu(), {n: p.grad.detach().cpu()
                                                  for n, p in m.named_parameters()
                                                  if p.grad is not None})
    out_err = _rel_to_largest([runs["cuda"][0]], [runs["cpu"][0]])
    names = [n for n in runs["cpu"][1] if not n.endswith(skip)]
    grad_err = _rel_to_largest([runs["cuda"][1][n] for n in names],
                               [runs["cpu"][1][n] for n in names])
    check(out_err <= 1e-5 and grad_err <= 1e-5,
          f"{what}: card against CPU {out_err:.3e} (out), {grad_err:.3e} (grads) of the largest")
    return {"out_rel_err": out_err, "grad_rel_err": grad_err}


def phase_encoder_options() -> dict:
    """``[encoder_options]``: 2-layer encoders of BEiT-3-base width (batch 2 x
    512, a padding mask where the option takes one) with xPos, the relative
    bias (32 buckets, distance 128), remat and MoE (8 experts on layer 2):
    the card against the CPU from one state dict, forward and gradients
    (``_card_cpu``). MoE routing: the records of ``top2_gate`` on the card's
    gate logits, computed on the card and on the CPU, bit for bit; the
    tokens each device's own logits route differently are counted. K2-K4
    launch 2 a layer's forward and backward (none with the relative bias)."""
    import dataclasses

    from moc_tpu_torch.nn.encoder import Encoder, EncoderConfig, init_like_flax
    from moc_tpu_torch.parallel.moe import MoEConfig, MoELayer, capacity_for, top2_gate

    b, l = OPTIONS_SHAPE
    base = EncoderConfig(embed_dim=768, ffn_dim=3072, layers=2, heads=12)
    variants = {"xpos": dict(xpos=True), "rel_pos": dict(rel_pos_buckets=32, max_rel_pos=128),
                "remat": dict(remat=True), "moe": dict(moe_freq=2, moe=MoEConfig(n_experts=8))}
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(b, l, 768, generator=gen)
    pad = torch.zeros(b, l, dtype=torch.bool)
    pad[1, l - 100:] = True
    r = torch.randn(b, l, 768, generator=gen)
    records = {}
    for name, kw in variants.items():
        cfg = dataclasses.replace(base, **kw)
        model = init_like_flax(Encoder(cfg), torch.Generator().manual_seed(13))
        mask = pad if name in ("rel_pos", "moe") else None
        logits = {}

        def forward(m, dev):
            hooks = []
            if name == "moe":
                def grab(mod, inputs, _out):
                    logits[dev] = (mod.gate_logits(inputs[0]).detach(), inputs[1])
                hooks = [mod.register_forward_hook(grab) for mod in m.modules()
                         if isinstance(mod, MoELayer)]
            out, aux = m(x.to(dev), None if mask is None else mask.to(dev))
            for h in hooks:
                h.remove()
            keep = 1.0 if mask is None else (~mask.to(dev))[..., None].float()
            return out * keep, torch.sum(out * r.to(dev) * keep) + aux

        _zero_launches()
        rec = _card_cpu(model, forward, f"[encoder_options] {name}")
        rec["launches"] = _launches()
        dense = name == "rel_pos"
        want = (0 if dense else 2 * (2 if name == "remat" else 1)), (0 if dense else 2)
        check(rec["launches"] == {"K2": want[0], "K3": want[1], "K4": want[1]},
              f"[encoder_options] {name}: card launches {rec['launches']}")
        if name == "moe":
            (lg, mk), (lc, _) = logits["cuda"], logits["cpu"]
            cap = capacity_for(lg.shape[0], 8, "top2")
            on_card, _ = top2_gate(lg, cap, mk, compact=True)
            on_cpu, _ = top2_gate(lg.cpu(), cap, mk.cpu(), compact=True)
            for cc, cp in zip(on_card, on_cpu):
                for a, c in zip(cc[:3], cp[:3]):
                    check(torch.equal(a.cpu(), c), "[encoder_options] moe: top2_gate on the "
                          "same logits routes differently on the card and the CPU")
            own, _ = top2_gate(lc, cap, mk.cpu(), compact=True)
            moved = sum(int(((a[0].cpu() != c[0]) | (a[2].cpu() != c[2])).sum())
                        for a, c in zip(on_card, own))
            check(moved == 0, f"[encoder_options] moe: {moved} choices route differently on "
                  "each device's own logits")
            rec["routed_differently"] = moved
        records[name] = rec
        log(f"[encoder_options] {name} (2 x 768, batch {b} x {l}): card against CPU out "
            f"{rec['out_rel_err']:.3e}, grads {rec['grad_rel_err']:.3e} of the largest; "
            f"launches {rec['launches']}"
            + (f"; routing on the same logits bit-equal, {rec['routed_differently']} choices "
               "moved on each device's own" if name == "moe" else ""))
    return records


def phase_musk_contrastive(ckpt: str) -> dict:
    """``[musk_contrastive]``: ``make_musk_contrastive_step`` on MUSK-large
    (``load_musk`` of the fabricated checkpoint, f32, Adam) for
    ``CONTRAST_STEPS`` steps of 8 images at 384 px and 8 texts of 100
    tokens with padding: finite losses, K2, K3 and K4 48 launches a step (24
    vision, 24 text), step times, peak memory. Then its first two layers
    on the card against the CPU (2 images, 2 padded texts): the loss and the
    first-step gradients within 1e-5 of the largest."""
    import dataclasses

    from moc_tpu_torch.models.musk import MUSK
    from moc_tpu_torch.train.pretrain import clip_contrastive_loss, make_musk_contrastive_step
    from moc_tpu_torch.zeroshot.convert_musk import load_musk

    model = load_musk(ckpt, device="cuda").train()
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = CONTRAST_BATCH
    images = torch.randn(n, cfg.image_size, cfg.image_size, 3, generator=gen, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (n, MUSK_TEXT_LEN), generator=gen, device="cuda")
    lengths = torch.tensor([MUSK_TEXT_LEN - 11 * i for i in range(n)], device="cuda")
    pad = torch.arange(MUSK_TEXT_LEN, device="cuda")[None, :] >= lengths[:, None]
    step = make_musk_contrastive_step(model, torch.optim.Adam(model.parameters(),
                                                              lr=CONTRAST_LR))
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, times = [], []
    for _ in range(CONTRAST_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(float(step(images, ids, pad)))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = 2 * MUSK_LAYERS * CONTRAST_STEPS
    check(all(math.isfinite(x) for x in losses) and launches == {"K2": want, "K3": want,
                                                                 "K4": want},
          f"[musk_contrastive] losses {losses}, launches {launches} (want {want} of each)")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if not k.startswith("beit3.encoder.layers.") or int(k.split(".")[3]) < 2}
    del model, step
    torch.cuda.empty_cache()
    small = MUSK(dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, layers=2)))
    small.load_state_dict(state)
    sub = (images[:2].cpu(), ids[:2].cpu(), pad[[0, n - 1]].cpu())

    def forward(m, dev):
        v, t, s = m(sub[0].to(dev), sub[1].to(dev), text_padding_mask=sub[2].to(dev))
        return torch.cat([v, t]), clip_contrastive_loss(v, t, s)

    parity = _card_cpu(small, forward, "[musk_contrastive] 2-layer first step")
    rec = {"losses": losses, "step_ms": statistics.median(times), "step_ms_all": times,
           "launches": launches, "peak_gib": peak, **parity}
    log(f"[musk_contrastive] MUSK-large ({n} images at {cfg.image_size} px, {n} texts of "
        f"{MUSK_TEXT_LEN} tokens, {int(pad.sum())} pad): {CONTRAST_STEPS} steps, losses "
        f"{losses}, step {rec['step_ms']:.3f} ms by CUDA events (median; all {times}), peak "
        f"{peak:.2f} GiB, launches {launches}; 2 layers card against CPU: embeddings "
        f"{parity['out_rel_err']:.3e}, first-step gradients {parity['grad_rel_err']:.3e} of the "
        "largest")
    return rec


def phase_decoder(ckpt: str) -> dict:
    """``[decoder]``: ``generate_caption`` at CONCH's width (12 x 768, 12
    heads, vocabulary 32007, context 128, weights drawn from a seed) over the
    caption tokens of the fabricated CONCH checkpoint's vision tower (16
    images): greedy and beam 4, 30 tokens, ids in range, no K2-K4 launch,
    times. Its first 2 layers on the card against the CPU on the same
    caption tokens: greedy and beam ids equal, teacher-forced logits within
    1e-5 of the largest. RetNet at its defaults, L = 2048: the three forms
    on the card against each other (the per-head norm makes them one
    function up to its eps: within ``RETNET_FORMS_REL`` of the largest) and
    the parallel form against the CPU within 1e-5."""
    import dataclasses

    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.nn.encoder import init_like_flax
    from moc_tpu_torch.nn.retnet import RetNetConfig, RetNetDecoder
    from moc_tpu_torch.zeroshot.captioner import CaptionerConfig, CoCaCaptioner, generate_caption
    from moc_tpu_torch.zeroshot.convert import load_conch

    gen = torch.Generator(device="cuda").manual_seed(15)
    coca = load_conch(ckpt, device="cuda")
    images = torch.randn(CAPTION_IMAGES, 448, 448, 3, generator=gen, device="cuda")
    with torch.inference_mode(), full_f32():
        caption = coca.visual(images)[1].clone()
    del coca
    cfg = CaptionerConfig()
    cap = CoCaCaptioner(cfg)
    g = torch.Generator().manual_seed(16)
    init_like_flax(cap, g)
    with torch.no_grad():
        torch.nn.init.normal_(cap.token_embedding.weight, std=(1 / cfg.width) ** 0.5, generator=g)
        torch.nn.init.normal_(cap.positional_embedding, std=0.01, generator=g)
    card = cap.to("cuda")
    records = {}
    _zero_launches()
    for mode in ("greedy", "beam"):
        with full_f32():
            t0 = time.perf_counter()
            ids = generate_caption(card, caption, seq_len=CAPTION_LEN, mode=mode,
                                   beam_size=CAPTION_BEAM)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(ids.shape == (CAPTION_IMAGES, CAPTION_LEN) and bool(((ids >= 0)
              & (ids < cfg.vocab_size)).all()), f"[decoder] {mode} ids {tuple(ids.shape)}")
        records[mode] = {"wall_s": wall, "distinct_tokens": int(ids.unique().numel())}
    launches = _launches()
    check(launches == {"K2": 0, "K3": 0, "K4": 0}, f"[decoder] launched {launches}")
    small_cfg = dataclasses.replace(cfg, layers=2)
    small = CoCaCaptioner(small_cfg)
    small.load_state_dict({k: v for k, v in card.state_dict().items()
                           if not k.startswith("decoder.layers.") or int(k.split(".")[2]) < 2})
    del card, cap
    torch.cuda.empty_cache()
    parity = {}
    for mode in ("greedy", "beam"):
        out = {}
        for dev in ("cuda", "cpu"):
            with full_f32():
                out[dev] = generate_caption(small.to(dev), caption.to(dev), seq_len=CAPTION_LEN,
                                            mode=mode, beam_size=CAPTION_BEAM).cpu()
        check(torch.equal(out["cuda"], out["cpu"]),
              f"[decoder] 2-layer {mode} ids differ between card and CPU")
        parity[mode] = out["cpu"]
    with torch.no_grad(), full_f32():
        logits = {dev: small.to(dev)(parity["greedy"].to(dev), caption.to(dev)).cpu()
                  for dev in ("cuda", "cpu")}
    logit_err = _rel_to_largest([logits["cuda"]], [logits["cpu"]])
    check(logit_err <= 1e-5, f"[decoder] 2-layer logits: card against CPU {logit_err:.3e}")
    records["logit_rel_err"] = logit_err
    # RetNet at its defaults
    ret = init_like_flax(RetNetDecoder(RetNetConfig()), torch.Generator().manual_seed(17))
    x = torch.randn(1, RETNET_LEN, 512, generator=torch.Generator().manual_seed(18))
    forms = {}
    with torch.no_grad(), full_f32():
        ret_card = ret.to("cuda")
        for mode in ("parallel", "recurrent", "chunkwise"):
            t0 = time.perf_counter()
            forms[mode] = ret_card(x.cuda(), mode=mode)[0].cpu()
            forms[mode + "_s"] = time.perf_counter() - t0
        ret_cpu = ret.to("cpu")
        want = ret_cpu(x, mode="parallel")[0]
    chunk_err = _rel_to_largest([forms["chunkwise"]], [forms["recurrent"]])
    par_err = _rel_to_largest([forms["parallel"]], [forms["recurrent"]])
    cpu_err = _rel_to_largest([forms["parallel"]], [want])
    check(chunk_err <= RETNET_FORMS_REL and par_err <= RETNET_FORMS_REL and cpu_err <= 1e-5,
          f"[decoder] RetNet: chunkwise {chunk_err:.3e}, parallel {par_err:.3e} from "
          f"recurrent; parallel card against CPU {cpu_err:.3e}")
    records["retnet"] = {"chunkwise_vs_recurrent": chunk_err, "parallel_vs_recurrent": par_err,
                         "card_vs_cpu": cpu_err,
                         **{m + "_s": forms[m + "_s"] for m in ("parallel", "recurrent",
                                                                "chunkwise")}}
    log(f"[decoder] captioner 12 x 768 over {CAPTION_IMAGES} images' caption tokens: greedy "
        f"{records['greedy']['wall_s']:.2f}s, beam {CAPTION_BEAM} {records['beam']['wall_s']:.2f}s "
        f"host wall for {CAPTION_LEN} tokens; launches {launches}; 2 layers card against CPU: "
        f"greedy and beam ids equal, logits {logit_err:.3e} of the largest; RetNet L "
        f"{RETNET_LEN}: chunkwise/recurrent {chunk_err:.3e}, parallel/recurrent {par_err:.3e}, "
        f"card/CPU {cpu_err:.3e}; host wall parallel {forms['parallel_s']:.3f}s, recurrent "
        f"{forms['recurrent_s']:.2f}s, chunkwise {forms['chunkwise_s']:.3f}s")
    return records


def phase_slice_kernel_times() -> dict:
    """K2, K3 and K4 at this slice's shapes (``SLICE_SHAPES``), f32 and bf16:
    each held against its plain version on the same tensors (the limits of
    the parity phases), then timed per call by CUDA events (median) beside
    its bound, the plain version and ``scaled_dot_product_attention``
    (forward; its backward for K3 + K4 together), timed only."""
    import torch.nn.functional as F

    from moc_tpu_torch.ops.flash_attention import flash_bwd_reference, mha_reference
    from moc_tpu_torch.ops.flash_kernel import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                                flash_fwd_cuda)

    gen = torch.Generator(device="cuda").manual_seed(19)
    records = {}
    for cell, shape in SLICE_SHAPES.items():
        b, h, length, d = shape
        n = b * h * length * length * d
        for dtype, tier, peak in ((torch.float32, "f32", F32_ACCURATE_OPS_PER_S),
                                  (torch.bfloat16, "bf16", BF16_OPS_PER_S)):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            with torch.no_grad():
                o, lse, do, delta = _bwd_inputs(q, k, v, None, None, False, gen)
                ro, rlse = mha_reference(q, k, v)
                k2 = _k2_errors(o, lse, ro, rlse, dtype, f"{tier} {cell} {list(shape)}")
                dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta)
                dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
                bwd = _bwd_errors((dq, dk, dv), flash_bwd_reference(q, k, v, o, lse, do), dtype)
                el, stats = q.element_size(), b * h * length * 4
                rec = {"shape": list(shape)}
                for kid, fn, plain, ops, tensors, err in (
                        ("K2", lambda: flash_fwd_cuda(q, k, v), lambda: mha_reference(q, k, v),
                         4 * n, 4, max(k2["o"], k2["lse"])),
                        ("K3", lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta),
                         lambda: flash_bwd_reference(q, k, v, o, lse, do), 6 * n, 5, bwd["dq"]),
                        ("K4", lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
                         lambda: flash_bwd_reference(q, k, v, o, lse, do), 8 * n, 6,
                         bwd["dkv"])):
                    bytes_s = (tensors * q.numel() * el + (1 if kid == "K2" else 2) * stats
                               ) / HBM_BYTES_PER_S
                    ops_s = ops / peak
                    rec[kid] = {"ms": _time_ms(fn, iters=30, warmup=3),
                                "plain_ms": _time_ms(plain, iters=5, warmup=1),
                                "bound_ms": max(bytes_s, ops_s) * 1e3,
                                "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                                "max_abs_err": err}
                rec["K2"]["library_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                                                   iters=30, warmup=3)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves)
            lib = _time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                           iters=20, warmup=3)
            rec["K3"]["library_ms"] = rec["K4"]["library_ms"] = lib
            records[f"{cell}_{tier}"] = rec
            log(f"[times] {tier} {cell} {list(shape)}: " + "; ".join(
                f"{kid} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}, plain "
                f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, max |err| "
                f"{r['max_abs_err']:.2e})" for kid, r in rec.items() if kid != "shape"))
            del q, k, v, o, lse, do, delta, out, leaves
            torch.cuda.empty_cache()
    return records


def _slice_cells(tier: str, kid: str, moe, dilated, contrastive, options, slice_times) -> dict:
    """A K2/K3/K4 record's fields from this slice's paths: launches on the
    MoE, bf16-parameter, dilated, encoder-option and MUSK contrastive runs
    (each of a tier: MoE and the contrastive step in f32, bf16 parameters
    with bf16 compute, dilated in f32), and the kernel's time, bound, plain
    and library times at ``SLICE_SHAPES`` in this tier."""
    cells = {f"{k}_{cell.rsplit('_', 1)[0]}": v
             for cell, rec in slice_times.items() if cell.endswith("_" + tier)
             for k, v in rec[kid].items()}
    cells.update({f"shape_{cell.rsplit('_', 1)[0]}": rec["shape"]
                  for cell, rec in slice_times.items() if cell.endswith("_" + tier)})
    if tier == "f32":
        cells.update({"launches_moe": moe["f32"]["launches"][kid],
                      "launches_dilated_step": dilated["pretrain"]["plain"]["launches"][kid],
                      "launches_dilated_remat_step": dilated["pretrain"]["remat"]["launches"][kid],
                      "launches_dilated_attention": dilated["f32"]["launches"][kid],
                      "launches_encoder_options": {k: r["launches"][kid]
                                                   for k, r in options.items()},
                      "launches_musk_contrastive": contrastive["launches"][kid]})
    else:
        cells.update({"launches_moe_bf16_params": moe["bf16_params"]["launches"][kid],
                      "launches_dilated_attention": dilated["bf16"]["launches"][kid]})
    return cells


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU only", file=sys.stderr)
        return 1
    import moc_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    err = phase_parity()
    k2_err = phase_flash_parity()
    with tempfile.TemporaryDirectory() as root:
        ids = write_corpus(root)
        state = phase_serve(root, ids)
        times = phase_times(state)
        tiers = phase_tiers(root, ids)
        ckpt, patch_dir, paths = write_patch_corpus(root)
        out_dir = os.path.join(root, "features")
        extracted = phase_extract(ckpt, patch_dir, paths, out_dir)
        phase_serve_extracted(root, out_dir)
        k2_times = phase_flash_times()
        phase_encode_tiers(ckpt)
        musk = phase_musk(root)
        resnet = phase_resnet(root)
        backbones = phase_extract_backbones(root, musk["ckpt"], resnet["ckpt"])
        contrastive = phase_musk_contrastive(musk["ckpt"])
    bwd_err = phase_flash_bwd_parity()
    pretrained = {tier: run_pretrain_cli(tier) for tier in ("f32", "bf16")}
    phase_pretrain_narrow()
    bwd_times = phase_flash_bwd_times()
    phase_pretrain_step_times()
    moe = phase_moe()
    dilated = phase_dilated()
    options = phase_encoder_options()
    slice_times = phase_slice_kernel_times()
    with tempfile.TemporaryDirectory() as root:
        trained = phase_train(root)
        phase_train_parity(root)
        selpool = phase_select_pool(root, state, trained)
        train_times = phase_train_times(root)
        swept = phase_sweep(root, trained)
        sweep_times = phase_sweep_times(root)
        mil_trained = phase_mil_train(root)
        mil_parity = phase_mil_parity(root)
        mil_times = phase_mil_times(root)
        mil_pred = phase_mil_predict(root, mil_trained)
        vila = phase_vila(root)
        lora = phase_lora(root)
    adapters = phase_adapters()
    accum = phase_accum()
    with tempfile.TemporaryDirectory() as root:
        zs = phase_zeroshot_weights(root)
        mizero = phase_zeroshot_mizero(zs["weights"]["nsclc"])
        zs_main = phase_zeroshot_main_moc(root, zs["ckpt"])
        decoder = phase_decoder(zs["ckpt"])
    smi =subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[done] chip_smoke.py wall {time.perf_counter() - t_start:.1f}s")
    log(smi)
    kernels = []
    for entry, name in (("rows", "topk_threshold_rows"), ("cols", "topk_threshold_cols")):
        t = times[entry]
        kernels.append({"name": name, "route": "cuda", "source": ROWS_SOURCE,
                        "replaces": REPLACES, "launches": state["launches"][entry],
                        "max_abs_err": err[entry], "ms": t["ms"], "kernel_us": t["kernel_us"],
                        "device_us": t["device_us"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": t["shape"], "cluster": t["cluster"], "shapes": t["shapes"],
                        "launches_train": trained["launches_steps"][entry],
                        "launches_main_moc": trained["launches"][entry],
                        "launches_sweep": swept["launches_steps"][entry],
                        "launches_sweep_eval": swept["launches_eval"][entry],
                        "shapes_sweep": sweep_times["k1"][entry],
                        "launches_main_moc_sort": selpool["launches_sort"][entry],
                        "launches_train_sort": selpool["launches_sort_steps"][entry],
                        "launches_zs_floor": {k: v[entry]
                                              for k, v in selpool["launches_zs"].items()},
                        "shapes_zs_floor": selpool["k1_zs"][entry],
                        "launches_main_moc_nsclc": zs_main["runs"][0]["launches"][entry],
                        "launches_tiers": {k: v["launches"][entry] for k, v in tiers.items()},
                        "launches_train_nsclc": zs_main["runs"][0]["launches_steps"][entry],
                        "launches_mil": mil_trained["launches"][entry]
                        + mil_pred["launches"][entry],
                        "launches_vila": vila["launches"][entry],
                        **({"launches_mizero": mizero["launches"], "shapes_mizero": mizero["k1"],
                            "launches_adapters": adapters["launches"],
                            "shape_adapters": adapters["k1"]}
                           if entry == "cols" else {})})
    lora_run = {"f32": "flash", "bf16": "flash_bf16"}  # the LoRA trunk's run of each tier
    for tier, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        t, tp = k2_times[tier]["extraction"], k2_times[tier]["pretraining"]
        musk_cells = {f"{key}_{cell}": k2_times[tier][cell][key]
                      for cell in ("musk_vision", "musk_text")
                      for key in ("shape", "max_abs_err", "max_rel", "ms", "kernel_us",
                                  "device_us", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        kernels.append({"name": f"flash_fwd_{tier}", "route": "cuda", "source": K2_SOURCE,
                        "replaces": K2_REPLACES, "launches": extracted[tier]["launches"],
                        "max_abs_err": max(*k2_err[dtype].values(), t["max_abs_err"],
                                           *(k2_times[tier][c]["max_abs_err"]
                                             for c in ("musk_vision", "musk_text"))),
                        "max_abs_err_main_shape": t["max_abs_err"],
                        "max_rel_main_shape": t["max_rel"], "ms": t["ms"],
                        "kernel_us": t["kernel_us"], "device_us": t["device_us"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "launches_pretrain": pretrained[tier]["launches"]["K2"],
                        "ms_pretrain_shape": bwd_times[tier]["k2_ms"],
                        "kernel_us_pretrain_shape": tp["kernel_us"],
                        "device_us_pretrain_shape": tp["device_us"],
                        "bound_ms_pretrain_shape": bwd_times[tier]["k2_bound_ms"],
                        "library_ms_pretrain_shape": bwd_times[tier]["k2_library_ms"],
                        "launches_musk_forward": musk["vision"][tier]["k2_launches"],
                        "launches_musk_text": musk["text_launches"],
                        "launches_musk_extract": backbones["musk"]["launches"],
                        "launches_mil": mil_trained["launches"]["K2"]
                        + mil_pred["launches"]["K2"], "launches_vila": vila["launches"]["K2"],
                        "launches_lora_flash": lora[lora_run[tier]]["launches"]["K2"],
                        **_slice_cells(tier, "K2", moe, dilated, contrastive, options,
                                       slice_times),
                        **musk_cells})
    for entry, kid, replaces in (("dq", "K3", K3_REPLACES), ("dkv", "K4", K4_REPLACES)):
        for tier, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            t = bwd_times[tier][entry]
            kernels.append({"name": f"flash_bwd_{entry}_{tier}", "route": "cuda",
                            "source": BWD_SOURCE, "replaces": replaces,
                            "launches": pretrained[tier]["launches"][kid],
                            "max_abs_err": max(bwd_err[dtype][entry], t["max_abs_err"]),
                            "max_abs_err_main_shape": t["max_abs_err"], "ms": t["ms"],
                            "kernel_us": t["kernel_us"], "device_us": t["device_us"],
                            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                            "launches_mil": mil_trained["launches"][kid]
                            + mil_pred["launches"][kid],
                            "launches_vila": vila["launches"][kid],
                            "launches_lora_flash": lora[lora_run[tier]]["launches"][kid],
                            **_slice_cells(tier, kid, moe, dilated, contrastive, options,
                                           slice_times)})
    log("[tiers] summary " + json.dumps({k: {f: v for f, v in r.items() if f != "launches"}
                                         for k, r in tiers.items()}))
    log("[train] summary " + json.dumps({
        "step_ms": train_times, "episode_wall_s": trained["wall_s"],
        "epoch_train_s": trained["epoch_train_s"],
        "epoch_with_eval_s": trained["epoch_with_eval_s"],
        "steps_per_s": trained["steps_per_s"], "result": trained["result"]}))
    log("[sweep] summary " + json.dumps({
        "wall_s": swept["wall_s"], "episodes_per_hour": swept["episodes_per_hour"],
        "main_moc_episodes_per_hour": 3600 / trained["wall_s"],
        "step_ms": sweep_times["step_ms"], "pack_ms": sweep_times["pack_ms"],
        "trajectory_ms": sweep_times["trajectory_ms"], "fold0_diff": swept["fold0_diff"]}))
    log("[select] summary " + json.dumps({
        **selpool["times"], "sort_episode_wall_s": selpool["sort_wall_s"],
        "sort_loss_err": selpool["sort_loss_err"], "zs_max_abs_diff": selpool["zs_err"]}))
    log("[mil] summary " + json.dumps({
        "train": {k: {f: v for f, v in r.items() if f != "msgpack"}
                  for k, r in mil_trained["single"].items()},
        "fused": mil_trained["fused"], "parity": mil_parity, "step": mil_times,
        "predict": {k: {f: v for f, v in r.items() if f != "top"}
                    for k, r in mil_pred["heads"].items()},
        "serve_wall_s": mil_pred["serve_wall_s"], "launches": mil_pred["launches"]}))
    log("[vila] summary " + json.dumps({k: v for k, v in vila.items()}))
    log("[adapters] summary " + json.dumps({"adapters": adapters["adapters"],
                                           "k1_shape": adapters["k1"]}))
    log("[lora] summary " + json.dumps(lora))
    log("[accum] summary " + json.dumps(accum))
    log("[moe] summary " + json.dumps(moe))
    log("[dilated] summary " + json.dumps(dilated))
    log("[encoder_options] summary " + json.dumps(options))
    log("[musk_contrastive] summary " + json.dumps(contrastive))
    log("[decoder] summary " + json.dumps(decoder))
    log("[musk] summary " + json.dumps({k: v for k, v in musk.items() if k != "ckpt"}))
    log("[resnet] summary " + json.dumps({k: v for k, v in resnet.items() if k != "ckpt"}))
    log("[extract] backbones summary " + json.dumps(backbones))
    log("[zeroshot] summary " + json.dumps({
        "w_max_abs_err": zs["max_abs_err"], "banks": zs["banks"], "load_conch_s": zs["load_s"],
        "mizero_logit_err": mizero["logit_err"], "mizero_wall_s": mizero["wall_s"],
        "main_moc_nsclc": zs_main["runs"], "bags_write_s": zs_main["bags_write_s"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
