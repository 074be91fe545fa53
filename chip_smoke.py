#!/usr/bin/env python3
"""GPU drive of the PyTorch port (merlot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out details.json] [--parent DIR]

1. builds the kernels from csrc/ with nvcc, one process each, in
   parallel: K1 (attention forward), K2 (backward), K3 (the stacked KV
   cache), K4 (fused GroupNorm) and K5 (LayerNorm fused into matmuls);
2. K1 phase: holds K1 against its plain PyTorch version at the two
   zero-shot shapes (fp32 softmax) and the three pretrain shapes (bf16
   softmax), all in bf16, and times K1, the plain version and, as a
   yardstick, torch's scaled_dot_product_attention, beside the least time
   the card could take (bound);
3. K2 phase: the same for K2 at the three pretrain shapes in bf16 softmax
   and the joint shape in fp32 softmax (the VCR mode), with padded rows in
   the masks and a nonzero colsum cotangent at the lang shape; each shape
   also shows that its check sees a fault (the other softmax mode; at the
   lang shape, the missing colsum cotangent) and that dQ is exactly 0 on
   fully masked rows; K2 fed K1's saved row max and sum must equal K2
   computing them itself, and two runs must agree bit for bit;
3a. ablation phase: K1's probe at the three pretrain shapes (the kernel,
   its fp32 softmax, the softmax removed, the pass for the row max and sum
   skipped, and SDPA), timed in turns; with ``--parent DIR`` (a checkout of
   commit 83510f1, which holds the first designs of K1, K2, K3, K4 and K5)
   those designs are built from DIR and timed in turns with the current
   kernels at every shape (K3's decode over rotating copies, its launches
   queued), with per-path totals;
3b. K4 phase: holds K4 against its plain version at the 13 distinct
   GroupNorm shapes of the train step's LiteResNet (128 frames of 192x352)
   and the 13 of zero-shot's (20 frames of 384x384), bf16, with fault probes
   that must fail the bounds (channels grouped by c mod 32, the residual
   left out, the ReLU left out, where they apply), and times K4, the plain
   version and F.group_norm (+ add, ReLU) beside the bytes bound;
3c. K5 phase: the same for K5 at the ten LayerNorm+matmul shapes of the
   train step and zero-shot (q/k/v J=3 and the MLP J=1, K=768, bf16; the
   zero-shot rows leave tails), with two fault probes (z kept in fp32,
   beta left out), beside F.layer_norm + F.linear and the operations bound;
4. zero-shot phase: MerlotModel at the configs/pretrain_5seg.yaml model
   block (full width and depth, seeded random weights on the card) runs
   zero-shot story ordering on 3 batches of 2 synthetic stories, checks the
   outputs and that every batch launched K1 24 times, compares the batches
   with the same model on the plain attention, shows that this comparison
   sees a broken attention (the joint mask dropped), and reports stories/s
   and K1's time per batch (CUDA events around its launches), both as the
   median over the batches;
4b. fused zero-shot phase: the same weights with both fused norms on
   (fuse_ln_matmul, the GroupNorm backend on K4): 24 K1, 54 K4 and 48 K5
   launches per batch, probs against the unfused kernel run, stories/s and
   K4/K5 ms per batch;
5. train phase: MerlotPretrainModel and AdamW at the configs/pretrain_4seg.yaml
   model and optimizer blocks (full width and depth, seeded random weights
   on the card), bench.py's batch (8 x 16 chunks x 32 tokens, with padded
   chunk tails): one warm-up step, then 5 steps each timed alone, with
   segments/s, K1 and K2 ms per step, 36 launches of each per step and the
   peak memory; the loss falls over steps on the repeated batch (no
   warmup); one step's loss and gradients through the kernels match the
   plain attention's within a bound, and a backward with the mask dropped
   exceeds it; then torch.profiler over two more steps gives the device
   time by kernel family and the device's idle share;
5b. fused train phase: the train step with both fused norms on: 36 K1,
   36 K2, 54 K4 and 72 K5 launches per step, segments/s, K4 and K5 ms per
   step, peak memory, the loss falling; one step's loss and grads against
   the unfused kernel step's at its weights and masking (a K4 backward
   without the ReLU mask and a K5 backward without dgamma must exceed the
   bounds), and torch.profiler over two steps; then the A/B: unfused and
   fused steps in turns, fresh models, 3 warm-up and 8 timed steps each,
   with the host's enqueue time per step;
6. K3 phase: prints the decode kernels' registers and spills from ptxas,
   then holds K3 against its plain version at grover-medium's heads
   (16 x 64) with causal masks over cache positions and zero cache rows
   past the position, both given the live length kv_len = position + Sq:
   decode (B=8 bf16 and fp32, B=1 bf16; Sk=1537, the server's max_len,
   and 1216, bench.py's grover mode) and prefill (B=8 bf16, B=2 fp32;
   Sq=1024), with fault probes that must fail the bounds (the mask
   dropped; the values read from the key half; at decode, kv_len one
   short) and, at decode, NaN in the slots past kv_len that must not move
   the result and two launches that must agree bit for bit; times K3 (with
   kv_len and over the whole cache), the plain version and SDPA on the
   buffer's k/v views (whole cache and live slots) over rotating copies
   with the launches queued, beside the bound over the live slots and over
   the whole cache;
7. Grover decode phase: grover-medium (configs/grover_medium.json, full
   width and depth, seeded random weights, bf16, fused qkv and the stacked
   cache) under bench.py's grover method (B=8, prefix 1024, 32 and 192
   new tokens, p=0.005, k_prefilter 1024): decode tokens/s from the
   slope, the prefill ms, 24 K3 launches per prefill and per decode step,
   K3 ms per decode step (CUDA events), and torch.profiler over one
   32-token generation (K3's device time, the idle share, beside the bound
   of that generation's decode steps); the logits of a prefill and 8
   argmax decode steps through K3 against the plain attention fed the same
   tokens, with a mask-less plain run checked to exceed the bound; and a
   short fp32 generation (fp32 K3);
8. server phase: the port's DenoiseHTTPServer on 127.0.0.1 with the
   server's defaults (grover-medium, max_len 1537, top_p 0.94, --bf16,
   batching at max_batch 8) answers 4 concurrent POST /api/ask, coalesced
   (/stats mean_batch > 1), with 4 JSONL records and the seconds per batch.

Prints the card's name and power limit early, one JSON line of kernel
records before the last line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
``--out`` writes the per-shape details, the phase numbers, the profile
and the ptxas reports to a JSON file. Any
failed check raises, so the script exits non-zero; without a CUDA card it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HEADS, D_HEAD = 12, 64
# (name, batch, seq, masked, colsum, softmax_fp32): zero-shot at 2 stories
# per batch (ViT: 2 stories x 2 dups x 5 frames, 24*24 + 2 tokens; joint:
# 4 rows of 5*(12*12+1) + 5*32 tokens), then the pretrain shapes (ViT: 128
# frames of 12*22 + 2 tokens; joint: 32 rows of 4*(6*11+1) + 4*32 tokens;
# lang: 8 rows of 16*32 tokens)
ATTN_SHAPES = [
    ("zeroshot_vit", 20, 578, False, False, True),
    ("zeroshot_joint", 4, 885, True, False, True),
    ("pretrain_vit", 128, 266, False, False, False),
    ("pretrain_joint", 32, 396, True, False, False),
    ("pretrain_lang", 8, 512, True, True, False),
]
# K2's shapes: the three pretrain shapes, and the joint one in fp32 softmax
BWD_SHAPES = ATTN_SHAPES[2:] + [("pretrain_joint_fp32sm", 32, 396, True, False, True)]
# ctx (bf16) against the plain version. Both round the probs and ctx at the
# same points and differ only in the order of fp32 sums, so an element
# differs by at most an ulp of itself, and rarely (about 0.1% of elements
# on the H100):
#   - the largest error at most CTX_ULPS bf16 ulps of the largest |ctx|;
#   - the mean error at most CTX_MEAN_TOL, about 100x the kernel's ~1e-7.
#     Softmax in the other dtype changes more than half the elements and
#     moves the mean by 1.7e-4 to 3.1e-4 at these shapes, so each shape
#     also checks that the plain version in the other softmax mode fails
#     this bound: the check sees the mode;
#   - fully masked rows within UNIFORM_ULPS ulps of the mean of v (their
#     prob, 1/Sk, is itself rounded to bf16).
CTX_ULPS = 1
CTX_MEAN_TOL = 1e-5
UNIFORM_ULPS = 2
COLSUM_RTOL = 1e-3     # fp32 sums of the same probs in another order
# K1's saved row max and sum against the plain version's (relative; the max
# relative to at least 1): the fp32 softmax sums the same products and exps
# in another order; in the bf16 softmax a score may also round to the other
# bf16 neighbour (2^-7 relative)
STATS_RTOL = {"fp32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 2e-2)}
# dQ/dK/dV (bf16) against the plain backward, dO ~ 0.1 N(0, 1). K2 rebuilds
# P bit for bit, runs every product on fp32 operands (dS split into three
# exact bf16 terms) and rounds each grad once, so it differs from the plain
# version only by the order of fp32 sums: at most half a bf16 ulp of the
# largest |grad| and 1.4e-8 to 2.3e-8 on average on the H100. The plain
# backward in the other softmax mode moves the mean by 1.9e-5 to 2.8e-5,
# and leaving out the colsum cotangent moves dQ's by 5.3e-4: each must
# fail GRAD_MEAN_TOL (40x the kernel's, 19x below the smallest fault).
GRAD_ULPS = 1
GRAD_MEAN_TOL = 1e-6
# probs, kernel vs plain attention through 24 bf16 layers: 2.7e-3 to 3.3e-3
# on the H100; dropping the joint tower's mask moves them by 1.2e-2
SLICE_TOL = 6e-3
STORIES, CHUNKS, TOKENS = 2, 5, 32
BATCHES = 3
LAUNCHES_PER_BATCH = 24
# train phase: bench.py's per-chip batch; 12 layers x 3 towers per step
TRAIN_BATCH, TRAIN_CHUNKS, TRAIN_TOKENS = 8, 16, 32
TRAIN_STEPS = 5
LOSS_FALL_STEPS = 4
LAUNCHES_PER_STEP = 36
# one step's loss and grads, kernels vs plain attention (dropout off, the
# same masked tokens): each tensor's largest gradient difference over its
# largest |grad| (floored at 1e-3 of the largest |grad| of all, since some
# gradients are 0 analytically and hold only rounding noise). On the H100
# the worst tensor read 0.039 (a ResNet GroupNorm gamma; the median 0.004)
# and the loss 6.5e-6 relative: one-ulp differences of bf16 activations
# carried through 36 layers. A backward that leaves the mask out reads
# 0.68 and must exceed TRAIN_GRAD_TOL (2.6x the kernel's, 6.8x below it).
TRAIN_GRAD_TOL = 0.1
TRAIN_LOSS_RTOL = 1e-4

# K4 at every distinct GroupNorm site of the train step's LiteResNet (128
# frames of 192x352) and of zero-shot's (20 frames of 384x384): (name,
# frames, HW, C, kind, sites per ViT forward); kind "relu" is GN + ReLU,
# "proj" GN alone (the projection shortcut), "res" GN + residual + ReLU.
# Each path's 13 shapes cover its 54 sites.
GN_SHAPES = [
    ("stem_c32", 128, 16896, 32, "relu", 2),
    ("stem_c64", 128, 16896, 64, "relu", 1),
    ("group1_proj", 128, 4224, 256, "proj", 1),
    ("group1_c64", 128, 4224, 64, "relu", 6),
    ("group1_res", 128, 4224, 256, "res", 3),
    ("group2_c128_hw4224", 128, 4224, 128, "relu", 2),
    ("group2_proj", 128, 1056, 512, "proj", 1),
    ("group2_c128", 128, 1056, 128, "relu", 6),
    ("group2_res", 128, 1056, 512, "res", 4),
    ("group3_c256_hw1056", 128, 1056, 256, "relu", 2),
    ("group3_proj", 128, 264, 1024, "proj", 1),
    ("group3_c256", 128, 264, 256, "relu", 16),
    ("group3_res", 128, 264, 1024, "res", 9),
    ("zeroshot_stem_c32", 20, 36864, 32, "relu", 2),
    ("zeroshot_stem_c64", 20, 36864, 64, "relu", 1),
    ("zeroshot_group1_proj", 20, 9216, 256, "proj", 1),
    ("zeroshot_group1_c64", 20, 9216, 64, "relu", 6),
    ("zeroshot_group1_res", 20, 9216, 256, "res", 3),
    ("zeroshot_group2_c128_hw9216", 20, 9216, 128, "relu", 2),
    ("zeroshot_group2_proj", 20, 2304, 512, "proj", 1),
    ("zeroshot_group2_c128", 20, 2304, 128, "relu", 6),
    ("zeroshot_group2_res", 20, 2304, 512, "res", 4),
    ("zeroshot_group3_c256_hw2304", 20, 2304, 256, "relu", 2),
    ("zeroshot_group3_proj", 20, 576, 1024, "proj", 1),
    ("zeroshot_group3_c256", 20, 576, 256, "relu", 16),
    ("zeroshot_group3_res", 20, 576, 1024, "res", 9),
]
GN_GROUPS, GN_EPS = 32, 1e-4
# out (bf16) against the plain version: both round at the same points and
# differ only in the order of the fp32 statistic sums, so an element
# differs by at most one bf16 ulp, and rarely: the largest error at most
# GN_ULPS ulps of the largest |out|, the mean at most GN_MEAN_TOL; mean and
# rstd within GN_STAT_TOL (absolute; rstd relative). Fault probes that must
# fail these bounds: channels grouped by c mod 32 instead of c / (C/32)
# (where a group holds more than one channel), the residual left out, the
# ReLU left out (where the site has them).
# On the H100 the largest error was 1 ulp of the element (at most the
# bound), the mean 0.9e-8 to 3.9e-8 and the statistics 0.7e-7 to 6.4e-7;
# the probes move the mean by 4.3e-2 or more. So GN_MEAN_TOL is 25x the
# kernel's largest mean and GN_STAT_TOL 15x its largest statistic error.
GN_ULPS = 1
GN_MEAN_TOL = 1e-6
GN_STAT_TOL = 1e-5
# K5 at every LayerNorm+matmul site, K = 768: (name, rows M, consumers J,
# N): the train step's ViT (128 frames x 266 tokens), joint (32 x 396) and
# lang (8 x 512) towers, and zero-shot's ViT (20 x 578) and joint (4 x 885),
# whose row counts leave tails past the last 64-row block
LN_SHAPES = [
    ("pretrain_vit_qkv", 34048, 3, 768),
    ("pretrain_vit_mlp", 34048, 1, 3072),
    ("pretrain_joint_qkv", 12672, 3, 768),
    ("pretrain_joint_mlp", 12672, 1, 3072),
    ("pretrain_lang_qkv", 4096, 3, 768),
    ("pretrain_lang_mlp", 4096, 1, 3072),
    ("zeroshot_vit_qkv", 11560, 3, 768),
    ("zeroshot_vit_mlp", 11560, 1, 3072),
    ("zeroshot_joint_qkv", 3540, 3, 768),
    ("zeroshot_joint_mlp", 3540, 1, 3072),
]
LN_EPS = 1e-5
# y (bf16) against the plain version: the same rounding points (z and each
# product rounded to bf16 before the bias), fp32 sums in another order: the
# largest error at most LN_ULPS ulps of the largest |y|, the mean at most
# LN_MEAN_TOL. Fault probes that must fail them: z kept in fp32 (a rounding
# point moved), beta left out.
# On the H100 the largest error was at most 1 ulp of the largest |y|, the
# mean 1.7e-7 to 4.9e-7 (LN_MEAN_TOL is 20x that); z kept in fp32 moves
# the mean by 7.4e-4, beta left out by 4.2e-2.
LN_ULPS = 1
LN_MEAN_TOL = 1e-5
# the fused paths' launches: K1, K4, K5 per zero-shot batch; K1, K2, K4, K5
# per train step
# the A/B of the unfused and fused steps: warm-up and timed steps per run
AB_WARMUP, AB_STEPS = 3, 8
FUSED_LAUNCHES_PER_BATCH = (24, 54, 48)
FUSED_LAUNCHES_PER_STEP = (36, 36, 54, 72)
# fused vs unfused zero-shot probs: two more sums in another order in every
# layer (the GroupNorm statistics, the LayerNorm statistics and products)
# than the kernel-vs-plain attention comparison, through 24 bf16 layers:
# 3.1e-3 to 6.2e-3 on the H100, so 2.4x margin; K4 with the residual left
# out must exceed it
FUSED_SLICE_TOL = 1.5e-2
# fused vs unfused grads (grad_gap). The unfused path rounds dz and dW of
# every pre-LN product to bf16 (autograd through bf16 matmuls), the fused
# one keeps them fp32 as the JAX kernel's backward does: a ~2^-9 relative
# difference in every grad that reaches the ViT's input. In the LiteResNet
# that difference is magnified where a tensor's grad nearly cancels (the
# weight-standardized conv kernels, and the GroupNorms that feed another
# conv + GroupNorm, which make the loss blind to their scale): 1.13 of such
# a tensor's largest |grad| on the H100 (stem_gn2's gamma; the median
# tensor 0.0046). FUSED_RESNET_GRAD_TOL is 2.6x that, as TRAIN_GRAD_TOL is
# for the attention comparison, and a K4 backward without the ReLU mask
# must exceed it (1.1e6 on the H100). The other tensors read at most
# 0.0091 (the position embeddings): FUSED_GRAD_TOL is 2.7x that, and a K5
# backward without dgamma must exceed it (1.0).
FUSED_RESNET_GRAD_TOL = 3.0
FUSED_GRAD_TOL = 0.025

# the card's peak rates (NVIDIA's H100 SXM data sheet, dense, at 700 W):
# bf16 on the tensor cores, fp32 outside them, device memory
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# K3 at grover-medium's heads. Shapes: (name, batch, Sq, Sk, position of
# the first query, dtype); Sk is the server's max_len 1537, or 1216 (bench.py's
# grover mode: prefix 1024 + 192); the cache is zero past the last query
GROVER_HEADS, GROVER_D = 16, 64
STACKED_SHAPES = [
    ("decode_b8_bf16", 8, 1, 1537, 1100, "bf16"),
    ("decode_b8_fp32", 8, 1, 1537, 1100, "fp32"),
    ("decode_b1_bf16", 1, 1, 1537, 1100, "bf16"),
    ("prefill_b8_bf16", 8, 1024, 1537, 0, "bf16"),
    ("prefill_b2_fp32", 2, 1024, 1537, 0, "fp32"),
    ("decode_b8_bf16_bench", 8, 1, 1216, 1100, "bf16"),
]
# bf16 takes K1's bounds (CTX_ULPS, CTX_MEAN_TOL). fp32: the largest error
# over the largest |ctx|, both sides fp32 with sums in another order: 6.7e-7
# measured at decode (0 at prefill) on the H100, so 4.5x margin; the fault
# probes move it by > 0.18
STACKED_FP32_RTOL = 3e-6
# the Grover decode phase: bench.py's grover method
GROVER_BATCH, GROVER_PREFIX, GROVER_GENS = 8, 1024, (32, 192)
GROVER_REPEATS = 3
GREEDY_STEPS = 8
# prefill + 8 argmax decode steps, K3 vs the plain attention fed the same
# tokens: the largest |logit difference| (fp32 logits of |x| up to ~4.3,
# bf16 activations through 24 layers). Measured 0.054 on the H100, so 2.8x
# margin; the mask-less plain run moves them by 0.56 (decode) and 2.7
# (prefill)
GROVER_LOGIT_TOL = 0.15
SERVER_REQUESTS = 4
SERVER_TEXTS = [
    "so today were gonna make pasta with a to mate sauce from scratch",
    "the whether tomorrow is gonna be sunny in the after noon they said",
    "first you wanna pre heat the oven two three fifty degrees okay",
    "and thats how you fix a flat tire on a bike real quick guys",
]

# configs/pretrain_5seg.yaml, model block (init_checkpoint left out: the
# weights are random, drawn from a seed)
PRETRAIN_5SEG_MODEL = {
    "num_chunks_in_group": 5, "masking_use_attn": True, "masking_rate": 0.2,
    "masking_do_spanbert": True, "masking_choose_topk_prob": 0.5,
    "image_shuffle_prob": 0.5, "masking_spanbert_len_probs": [0.625, 0.25, 0.125],
    "resnet_layers": [3, 4, 9], "do_projection": True, "do_bias": True,
    "image_size": [384, 384], "patch_size": 16, "spatial_pool_size": 2,
    "use_bfloat16": True, "vocab_size": 50370, "hidden_size": 768,
    "contrastive_size": 768, "contrast_coef": 0.5, "contrast_temp": 0.05,
    "attention_probs_dropout_prob": 0.0, "hidden_dropout_prob": 0.1,
    "initializer_range": 0.02, "intermediate_size": 3072,
    "max_position_embeddings": 1024, "num_attention_heads": 12,
    "num_hidden_layers": 12, "num_vision_transformer_hidden_layers": 12,
    "num_lang_transformer_hidden_layers": 12, "share_params": True,
}
# configs/pretrain_4seg.yaml, model and optimizer blocks (the flagship:
# __graft_entry__._flagship_config is the same model)
PRETRAIN_4SEG_MODEL = {
    "num_chunks_in_group": 4, "masking_use_attn": True, "masking_rate": 0.2,
    "masking_do_spanbert": True, "masking_choose_topk_prob": 0.5,
    "image_shuffle_prob": 0.4, "masking_spanbert_len_probs": [0.625, 0.25, 0.125],
    "resnet_layers": [3, 4, 9], "do_projection": True, "do_bias": True,
    "image_size": [192, 352], "patch_size": 16, "spatial_pool_size": 2,
    "use_bfloat16": True, "vocab_size": 50370, "hidden_size": 768,
    "contrastive_size": 768, "contrast_coef": 0.25, "contrast_temp": 0.05,
    "attention_probs_dropout_prob": 0.0, "hidden_dropout_prob": 0.1,
    "initializer_range": 0.02, "intermediate_size": 3072,
    "max_position_embeddings": 1024, "num_attention_heads": 12,
    "num_hidden_layers": 12, "num_vision_transformer_hidden_layers": 12,
    "num_lang_transformer_hidden_layers": 12, "share_params": True,
    "remat": False, "attention_softmax_fp32": False, "scan_layers": False,
}
PRETRAIN_4SEG_OPTIMIZER = {
    "type": "adam_optimizer", "learning_rate": 0.0003, "num_train_steps": 460000,
    "num_warmup_steps": 10000, "weight_decay_rate": 0.1, "beta_2": 0.98,
    "clip_norm": 0.0, "use_bfloat16_adam": True,
    "param_overrides": [
        [["attn_ln", "mlp_ln", "final_ln", "embed_norm", "patches_pre_ln",
          "viz_final_ln", "/ln", "/gn", "proj_gn", "bias", "gamma", "beta"],
         {"weight_decay_rate": 0}],
    ],
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak of their type (bf16 on the tensor cores by
    default) and the bytes over the device-memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def attn_work(b: int, s: int, masked: bool, colsum: bool, backward: bool) -> tuple:
    """(flops, bytes) one attention call needs at [b, s, HEADS*D_HEAD] bf16:
    each input read once, each output written once. Forward: S = QK^T and
    ctx = PV. Backward: S again (P is not an input), dV, dP, dQ, dK."""
    n_products = 5 if backward else 2
    flops = 2 * n_products * b * HEADS * s * s * D_HEAD
    act = b * s * HEADS * D_HEAD * 2                  # one [b, s, H*D] bf16 tensor
    nbytes = act * (7 if backward else 4)             # q,k,v,dO + 3 grads | q,k,v + ctx
    nbytes += 4 * b * s * s if masked else 0
    nbytes += 4 * b * s if colsum else 0              # colsum out | its cotangent in
    return flops, nbytes


@contextlib.contextmanager
def wrapped(module, name: str, wrap):
    """Replace module.name by wrap(module.name) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def event_timed(spans: list):
    """A wrapper that records CUDA events around each call into ``spans``."""
    import torch

    def wrap(fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out
        return timed
    return wrap


def spans_ms(spans: list) -> float:
    return sum(start.elapsed_time(end) for start, end in spans)


def attn_inputs(dev, g, b, s, masked):
    """q, k, v bf16 ~ N(0, 1) [b, s, H*D]; with ``masked``, a validity mask
    with padding rows as the towers build it, and the validity."""
    import torch
    q, k, v = (torch.randn((b, s, HEADS * D_HEAD), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = valid = None
    if masked:
        valid = torch.rand((b, s), generator=g, device=dev) > 0.15
        valid[:, 0] = True
        mask = (valid[:, None] & valid[:, :, None]).float()
    return q, k, v, mask, valid


def sdpa_args(q3, k3, v3, mask):
    """torch's scaled_dot_product_attention on the same inputs: [B, H, S, D]
    views, the mask as an additive -1e10 bias in the input dtype."""
    b, s, hd = q3.shape
    heads = [t.view(b, s, HEADS, D_HEAD).transpose(1, 2) for t in (q3, k3, v3)]
    bias = None if mask is None else ((mask - 1.0) * 1e10).to(q3.dtype)[:, None]
    return heads, bias


def kernel_shape(dev, g, spec) -> dict:
    """K1 and its plain version at one shape: errors and times."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    name, b, s, masked, colsum, sm32 = spec
    q, k, v, mask, valid = attn_inputs(dev, g, b, s, masked)
    kw = dict(num_heads=HEADS, collect_colsum=colsum)
    stats = ca.new_stats(q, HEADS)
    ctx, cs = ca.attention_fwd_cuda(q, k, v, mask, softmax_fp32=sm32, stats=stats, **kw)
    torch.cuda.synchronize()
    ref, ref_cs = ca.flash_attention_plain(q, k, v, mask, softmax_fp32=sm32, **kw)
    ref_stats = ca.softmax_stats_plain(q, k, mask, num_heads=HEADS, softmax_fp32=sm32)
    other, _ = ca.flash_attention_plain(q, k, v, mask, softmax_fp32=not sm32, **kw)
    diff = (ctx.float() - ref.float()).abs()
    other_diff = (other.float() - ref.float()).abs()
    ref_max = ref.float().abs().max().item()
    row = {"shape": name, "batch": b, "seq": s, "masked": masked,
           "colsum": colsum, "softmax": "fp32" if sm32 else "bf16",
           "max_abs_err": diff.max().item(),
           "max_abs_err_bound": CTX_ULPS * bf16_ulp(ref_max),
           "ref_max_abs": ref_max,
           "mean_abs_err": diff.mean().item(),
           "differing_share": (diff > 0).float().mean().item(),
           "other_softmax_max_abs_diff": other_diff.max().item(),
           "other_softmax_mean_abs_diff": other_diff.mean().item(),
           "other_softmax_differing_share": (other_diff > 0).float().mean().item(),
           "stats_max_rel_err": ((stats[0] - ref_stats[0]).abs()
                                 / ref_stats[0].abs().clamp_min(1.0)).max().item(),
           "stats_sum_rel_err": ((stats[1] - ref_stats[1]).abs() / ref_stats[1]).max().item()}
    if colsum:
        row["colsum_max_rel_err"] = (
            (cs - ref_cs).abs() / ref_cs.abs().clamp_min(1e-6)).max().item()
    if masked:
        # fully masked rows: uniform over the true key length
        bi, qi = torch.nonzero(~valid, as_tuple=True)
        want = v.float().mean(dim=1)[bi]
        row["masked_row_uniform_err"] = (ctx[bi, qi].float() - want).abs().max().item()
        row["masked_row_uniform_bound"] = UNIFORM_ULPS * bf16_ulp(want.abs().max().item())
    kw["softmax_fp32"] = sm32
    row["ms"] = cuda_ms(lambda: ca.attention_fwd_cuda(q, k, v, mask, **kw))
    row["plain_ms"] = cuda_ms(lambda: ca.flash_attention_plain(q, k, v, mask, **kw))
    row["bound_ms"], row["bound_by"] = bound(*attn_work(b, s, masked, colsum, False))
    # the yardstick: one torch call of the same function, where there is one
    if colsum:
        row["library_ms"], row["library_note"] = None, "no single call (colsum)"
    else:
        heads, bias = sdpa_args(q, k, v, mask)
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(*heads, attn_mask=bias))
        row["library_note"] = ("same function" if sm32 else
                               "fp32 softmax (not the bf16-softmax rounding)")
    return row


def check_kernel_row(row: dict) -> None:
    name = row["shape"]
    check(row["max_abs_err"] <= row["max_abs_err_bound"],
          f"{name}: ctx max err {row['max_abs_err']} > {row['max_abs_err_bound']}")
    check(row["mean_abs_err"] <= CTX_MEAN_TOL,
          f"{name}: ctx mean err {row['mean_abs_err']} > {CTX_MEAN_TOL}")
    check(row["other_softmax_mean_abs_diff"] > CTX_MEAN_TOL,
          f"{name}: the other softmax mode passes the mean bound "
          f"({row['other_softmax_mean_abs_diff']}), so the check cannot see it")
    if row["colsum"]:
        check(row["colsum_max_rel_err"] <= COLSUM_RTOL,
              f"{name}: colsum rel err {row['colsum_max_rel_err']}")
    if row["masked"]:
        check(row["masked_row_uniform_err"] <= row["masked_row_uniform_bound"],
              f"{name}: fully masked rows not uniform ({row['masked_row_uniform_err']})")
    tol = STATS_RTOL[row["softmax"]]
    check(row["stats_max_rel_err"] <= tol[0] and row["stats_sum_rel_err"] <= tol[1],
          f"{name}: saved stats off: max {row['stats_max_rel_err']}, "
          f"sum {row['stats_sum_rel_err']} (bounds {tol})")


def kernel_phase(dev) -> list[dict]:
    """K1 against its plain version at the five shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for spec in ATTN_SHAPES:
        row = kernel_shape(dev, g, spec)
        print(f"[kernel] {json.dumps(row)}", flush=True)
        check_kernel_row(row)
        rows.append(row)
    return rows


def grad_errors(got, ref) -> dict:
    """Largest and mean |difference| of each of dQ, dK, dV, and the bound
    on the largest."""
    out = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        diff = (a.float() - r.float()).abs()
        out[name] = {"max_abs_err": diff.max().item(),
                     "max_abs_err_bound": GRAD_ULPS * bf16_ulp(r.float().abs().max().item()),
                     "mean_abs_err": diff.mean().item()}
    return out


def bwd_kernel_shape(dev, g, spec) -> dict:
    """K2 and its plain version at one shape: errors, fault probes, times."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    name, b, s, masked, colsum, sm32 = spec
    q, k, v, mask, valid = attn_inputs(dev, g, b, s, masked)
    do = (0.1 * torch.randn((b, s, HEADS * D_HEAD), generator=g, device=dev)
          ).to(torch.bfloat16)
    gcol = torch.randn((b, s), generator=g, device=dev) if colsum else None
    kw = dict(num_heads=HEADS, softmax_fp32=sm32)
    got = ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    again = ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    # the path's call: K1's saved row max and sum instead of K2's own pass
    stats = ca.new_stats(q, HEADS)
    ca.attention_fwd_cuda(q, k, v, mask, stats=stats, collect_colsum=False, **kw)
    saved = ca.attention_bwd_cuda(q, k, v, mask, do, gcol, stats=stats, **kw)
    torch.cuda.synchronize()
    ref = ca.attention_bwd_plain(q, k, v, mask, do, gcol, **kw)
    other = ca.attention_bwd_plain(q, k, v, mask, do, gcol, num_heads=HEADS,
                                   softmax_fp32=not sm32)
    row = {"shape": name, "batch": b, "seq": s, "masked": masked,
           "colsum_cotangent": colsum, "softmax": "fp32" if sm32 else "bf16",
           "grads": grad_errors(got, ref),
           "bitwise_repeatable": all(torch.equal(a, b_) for a, b_ in zip(got, again)),
           "saved_stats_equal": all(torch.equal(a, b_) for a, b_ in zip(got, saved)),
           "other_softmax_mean_abs_diff": min(
               e["mean_abs_err"] for e in grad_errors(other, ref).values())}
    if colsum:
        nog = ca.attention_bwd_plain(q, k, v, mask, do, None, **kw)
        row["no_colsum_cotangent_mean_abs_diff"] = grad_errors(nog, ref)["dq"]["mean_abs_err"]
    if masked:
        bi, qi = torch.nonzero(~valid, as_tuple=True)
        row["dq_masked_rows_max_abs"] = got[0][bi, qi].float().abs().max().item()
    row["max_abs_err"] = max(e["max_abs_err"] for e in row["grads"].values())
    row["ms"] = cuda_ms(lambda: ca.attention_bwd_cuda(q, k, v, mask, do, gcol,
                                                      stats=stats, **kw))
    row["ms_without_stats"] = cuda_ms(
        lambda: ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw))
    row["plain_ms"] = cuda_ms(lambda: ca.attention_bwd_plain(q, k, v, mask, do, gcol, **kw))
    row["bound_ms"], row["bound_by"] = bound(*attn_work(b, s, masked, colsum, True))
    # the yardstick: the backward of torch's attention (fp32 softmax, and no
    # colsum, so not the same rounding)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    heads, bias = sdpa_args(*leaves, mask)
    out = F.scaled_dot_product_attention(*heads, attn_mask=bias)
    do4 = do.view(b, s, HEADS, D_HEAD).transpose(1, 2)
    row["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True))
    row["library_note"] = ("backward of scaled_dot_product_attention: fp32 "
                           "softmax" + (", no colsum cotangent" if colsum else "")
                           + "; not the same rounding")
    return row


def check_bwd_row(row: dict) -> None:
    name = row["shape"]
    check(row["bitwise_repeatable"], f"{name}: two K2 runs differ")
    check(row["saved_stats_equal"],
          f"{name}: K2 fed K1's saved stats differs from K2 computing them")
    for g, e in row["grads"].items():
        check(e["max_abs_err"] <= e["max_abs_err_bound"],
              f"{name}: {g} max err {e['max_abs_err']} > {e['max_abs_err_bound']}")
        check(e["mean_abs_err"] <= GRAD_MEAN_TOL,
              f"{name}: {g} mean err {e['mean_abs_err']} > {GRAD_MEAN_TOL}")
    check(row["other_softmax_mean_abs_diff"] > GRAD_MEAN_TOL,
          f"{name}: the other softmax mode passes the mean bound "
          f"({row['other_softmax_mean_abs_diff']}), so the check cannot see it")
    if row["colsum_cotangent"]:
        check(row["no_colsum_cotangent_mean_abs_diff"] > GRAD_MEAN_TOL,
              f"{name}: dropping the colsum cotangent passes the mean bound "
              f"({row['no_colsum_cotangent_mean_abs_diff']})")
    if row["masked"]:
        check(row["dq_masked_rows_max_abs"] == 0.0,
              f"{name}: dQ on fully masked rows is not 0 "
              f"({row['dq_masked_rows_max_abs']})")


def bwd_kernel_phase(dev) -> list[dict]:
    """K2 against its plain version at the four shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for spec in BWD_SHAPES:
        row = bwd_kernel_shape(dev, g, spec)
        print(f"[kernel2] {json.dumps(row)}", flush=True)
        check_bwd_row(row)
        rows.append(row)
    return rows


# K1's ablation probe, the counterpart of tools/bench_attn_variants.py at
# the three pretrain shapes: the production kernel, the fp32 softmax, the
# softmax removed (p = round(s): staging and the two products alone), the
# softmax without its pass for the row max and sum (max = 0, sum = 1: one
# pass over K/V instead of two), and SDPA as the library yardstick (the
# tool's xla row). mm_only and no_max are wrong on purpose: only times kept.
ABLATION = ("prod", "sm_f32", "mm_only", "no_max", "library")


def ablation_phase(dev) -> list[dict]:
    """K1's variants timed in turns at each pretrain shape."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for name, b, s, masked, colsum, sm32 in ATTN_SHAPES[2:]:
        q, k, v, mask, _ = attn_inputs(dev, g, b, s, masked)
        kw = dict(num_heads=HEADS, collect_colsum=colsum)
        heads, bias = sdpa_args(q, k, v, mask)
        calls = {
            "prod": lambda: ca.attention_fwd_cuda(q, k, v, mask, softmax_fp32=sm32, **kw),
            "sm_f32": lambda: ca.attention_fwd_cuda(q, k, v, mask, softmax_fp32=True, **kw),
            "mm_only": lambda: ca.attention_fwd_variant_cuda(
                q, k, v, mask, softmax_fp32=sm32, variant="mm_only", **kw),
            "no_max": lambda: ca.attention_fwd_variant_cuda(
                q, k, v, mask, softmax_fp32=sm32, variant="no_max", **kw),
            "library": lambda: F.scaled_dot_product_attention(*heads, attn_mask=bias)}
        times = {v: [] for v in ABLATION}
        for order in (ABLATION, ABLATION[::-1]):
            for var in order:
                times[var].append(cuda_ms(calls[var], iters=20))
        row = {"shape": name, "batch": b, "seq": s,
               **{f"{v}_ms": statistics.mean(t) for v, t in times.items()},
               "library_note": "SDPA, fp32 softmax" + (", no colsum" if colsum else "")}
        row["bound_ms"], row["bound_by"] = bound(*attn_work(b, s, masked, colsum, False))
        print(f"[ablation] {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


# The first designs of K1, K2 and K3's prefill (mma.sync on 16-row tiles,
# full score rows in shared memory), K3's decode (a block per head over the
# whole cache, its C entry without kv_len), K4 (three launches per call) and
# K5 (mma.sync, cp.async) of commit 83510f1 against the current ones.
# ``--parent DIR`` (a checkout of that commit) builds its sources and times
# both in turns at every K1-K5 shape; without it the records'
# first_design_ms are null.


def parent_libraries(parent_dir: Path) -> dict:
    """The first design's K1, K2, K3, K4 and K5 libraries from parent_dir's
    csrc/, with that commit's C signatures."""
    import ctypes
    from merlot_tpu_torch import _build

    out = ROOT / "build" / "first_design"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    names = ("attention_fwd", "attention_bwd", "attention_stacked", "groupnorm", "ln_matmul")
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"lib{n}.so"),
         str(parent_dir / "merlot_tpu_torch" / "csrc" / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n in names}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"first design {n}.cu failed to build:\n{log}")
        libs[n] = ctypes.CDLL(str(out / f"lib{n}.so"))
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["attention_fwd"].merlot_attention_fwd.argtypes = [ptr] * 7 + [i] * 7 + [f, ptr]
    libs["attention_fwd"].merlot_attention_fwd_q_tile.argtypes = []
    libs["attention_bwd"].merlot_attention_bwd.argtypes = [ptr] * 10 + [i] * 7 + [f, ptr]
    libs["attention_stacked"].merlot_attention_stacked_fwd.argtypes = [ptr] * 4 + [i] * 8 + [f, ptr]
    libs["groupnorm"].merlot_group_norm_act.argtypes = [ptr] * 8 + [i] * 6 + [f, ptr]
    libs["groupnorm"].merlot_group_norm_workspace.argtypes = [i] * 4
    libs["groupnorm"].merlot_group_norm_workspace.restype = ctypes.c_long
    libs["ln_matmul"].merlot_ln_matmul.argtypes = [ptr] * 6 + [i] * 4 + [f, ptr]
    return libs


def parent_calls(libs, dev):
    """Callables of the first design: K1, K2, K3, K4 and K5 on the wrappers'
    inputs."""
    import torch
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def fwd(q, k, v, mask, sm32, colsum, heads=HEADS):
        b, sq, hd = q.shape
        sk = k.shape[1]
        out = torch.empty_like(q)
        part = cs = None
        if colsum:
            tile = libs["attention_fwd"].merlot_attention_fwd_q_tile()
            part = torch.empty((b, heads, -(-sq // tile), sk), device=dev)
            cs = torch.empty((b, sk), device=dev)
        err = libs["attention_fwd"].merlot_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(mask), ptr(out), ptr(part), ptr(cs), b, sq, sk,
            heads, hd // heads, 1, int(sm32), (hd // heads) ** -0.5, stream())
        check(err == 0, f"first-design K1 failed: {err}")
        return out

    def bwd(q, k, v, mask, do, gcol, sm32, heads=HEADS):
        b, sq, hd = q.shape
        sk = k.shape[1]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stats = torch.empty(3 * b * heads * sq, device=dev)
        err = libs["attention_bwd"].merlot_attention_bwd(
            ptr(q), ptr(k), ptr(v), ptr(mask), ptr(do), ptr(gcol), ptr(dq), ptr(dk),
            ptr(dv), ptr(stats), b, sq, sk, heads, hd // heads, 1, int(sm32),
            (hd // heads) ** -0.5, stream())
        check(err == 0, f"first-design K2 failed: {err}")
        return dq, dk, dv

    def stacked(q, kv, mask, heads=GROVER_HEADS):
        b, sq, hd = q.shape
        sk = kv.shape[1]
        out = torch.empty_like(q)
        err = libs["attention_stacked"].merlot_attention_stacked_fwd(
            ptr(q), ptr(kv), ptr(mask), ptr(out), b, sq, sk, heads, hd // heads,
            int(mask is not None and mask.shape[0] == b), int(q.dtype == torch.bfloat16),
            1, (hd // heads) ** -0.5, stream())
        check(err == 0, f"first-design K3 failed: {err}")
        return out

    def groupnorm(x, gamma, beta, r, num_groups, epsilon, relu):
        b, c = x.shape[0], x.shape[-1]
        hw = x.numel() // (b * c)
        lib = libs["groupnorm"]
        out = torch.empty_like(x)
        mean = torch.empty((b, num_groups), device=dev)
        rstd = torch.empty_like(mean)
        part = torch.empty(lib.merlot_group_norm_workspace(b, hw, c, 1), device=dev)
        err = lib.merlot_group_norm_act(
            ptr(x), ptr(gamma), ptr(beta), ptr(r), ptr(out), ptr(mean), ptr(rstd),
            ptr(part), b, hw, c, num_groups, 1, int(relu), epsilon, stream())
        check(err == 0, f"first-design K4 failed: {err}")
        return out, mean, rstd

    def ln_matmul(x, gamma, beta, w, bias, num_out, epsilon):
        m, k = x.shape
        n = w.shape[0] // num_out
        out = torch.empty((num_out, m, n), dtype=x.dtype, device=dev)
        err = libs["ln_matmul"].merlot_ln_matmul(
            ptr(x), ptr(gamma), ptr(beta), ptr(w), ptr(bias), ptr(out), m, k, n, num_out,
            epsilon, stream())
        check(err == 0, f"first-design K5 failed: {err}")
        return out
    return fwd, bwd, stacked, groupnorm, ln_matmul


def in_turns(first, second, iters: int = 10, timer=cuda_ms) -> tuple:
    """CUDA-event ms per call of two callables timed first, second,
    second, first: the mean of each's two readings."""
    a1 = timer(first, iters=iters)
    b1 = timer(second, iters=iters)
    b2 = timer(second, iters=iters)
    a2 = timer(first, iters=iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def first_design_phase(dev, parent_dir: Path) -> dict:
    """The first designs against the current kernels at every K1, K2, K4
    and K5 shape and K3's prefill shapes, in turns on this card; each pair's
    largest output difference is reported."""
    import torch
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm

    fwd, bwd, stacked, old_gn, old_ln = parent_calls(parent_libraries(parent_dir), dev)
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for name, b, s, masked, colsum, sm32 in ATTN_SHAPES:
        q, k, v, mask, _ = attn_inputs(dev, g, b, s, masked)
        # the train step's K1 also saves the softmax stats for K2
        stats = None if name.startswith("zeroshot") else ca.new_stats(q, HEADS)
        new = lambda: ca.attention_fwd_cuda(q, k, v, mask, num_heads=HEADS, softmax_fp32=sm32,
                                            collect_colsum=colsum, stats=stats)[0]
        old = lambda: fwd(q, k, v, mask, sm32, colsum)
        diff = (new().float() - old().float()).abs().max().item()
        first_ms, ms = in_turns(old, new)
        rows.append({"kernel": "K1", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff})
    for name, b, s, masked, colsum, sm32 in BWD_SHAPES:
        q, k, v, mask, _ = attn_inputs(dev, g, b, s, masked)
        do = (0.1 * torch.randn((b, s, HEADS * D_HEAD), generator=g, device=dev)
              ).to(torch.bfloat16)
        gcol = torch.randn((b, s), generator=g, device=dev) if colsum else None
        kw = dict(num_heads=HEADS, softmax_fp32=sm32)
        stats = ca.new_stats(q, HEADS)
        ca.attention_fwd_cuda(q, k, v, mask, stats=stats, collect_colsum=False, **kw)
        # the path's call: K1's stats given (the first design computed its own)
        new = lambda: ca.attention_bwd_cuda(q, k, v, mask, do, gcol, stats=stats, **kw)
        old = lambda: bwd(q, k, v, mask, do, gcol, sm32)
        diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(new(), old()))
        first_ms, ms = in_turns(old, new)
        rows.append({"kernel": "K2", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff})
    for name, b, sq, sk, pos0, dt in STACKED_SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, kv, mask = stacked_inputs(dev, g, b, sq, sk, pos0, dtype)
        kw = dict(num_heads=GROVER_HEADS, softmax_fp32=True, kv_len=pos0 + sq)
        new_fn = lambda q_, kv_, m_: ca.attention_stacked_fwd_cuda(q_, kv_, m_, **kw)
        diff = (new_fn(q, kv, mask).float() - stacked(q, kv, mask).float()).abs().max().item()
        if sq == 1:
            # decode: over rotating copies (a B=8 cache is about L2-sized),
            # the launches queued (the new kernel is shorter than the host's
            # enqueue of it); the first design reads the whole cache
            copies = stacked_copies(q, kv, mask)
            first_ms, ms = in_turns(rotating(stacked, copies), rotating(new_fn, copies),
                                    timer=queued_ms)
            del copies
        else:
            first_ms, ms = in_turns(lambda: stacked(q, kv, mask), lambda: new_fn(q, kv, mask))
        rows.append({"kernel": "K3", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff})
    for name, b, hw, c, kind, _ in GN_SHAPES:
        x, gamma, beta, r = gn_inputs(dev, g, b, hw, c, kind == "res")
        kw = dict(num_groups=GN_GROUPS, epsilon=GN_EPS, relu=kind != "proj")
        new = lambda: cg.group_norm_act_cuda(x, gamma, beta, r, **kw)
        old = lambda: old_gn(x, gamma, beta, r, **kw)
        diff = (new()[0].float() - old()[0].float()).abs().max().item()
        first_ms, ms = in_turns(old, new)
        rows.append({"kernel": "K4", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff})
        del x, r
        torch.cuda.empty_cache()
    for name, m, j, n in LN_SHAPES:
        x, gamma, beta, ws, bs = ln_inputs(dev, g, m, j, n)
        w, bias = torch.cat(ws).to(torch.bfloat16), torch.cat(bs).to(torch.bfloat16)
        new = lambda: lm.ln_matmul_cuda(x, gamma, beta, w, bias, num_out=j, epsilon=LN_EPS)
        old = lambda: old_ln(x, gamma, beta, w, bias, j, LN_EPS)
        diff = (new().float() - old().float()).abs().max().item()
        first_ms, ms = in_turns(old, new)
        rows.append({"kernel": "K5", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff})
    for row in rows:
        print(f"[first-design] {json.dumps(row)}", flush=True)
    by = {(r["kernel"], r["shape"]): r for r in rows}
    per = lambda kern, names, key, n=12: n * sum(by[(kern, x)][key] for x in names)
    zs, tr = ("zeroshot_vit", "zeroshot_joint"), ("pretrain_vit", "pretrain_joint",
                                                  "pretrain_lang")
    totals = {
        "k1_zero_shot_batch": (per("K1", zs, "first_design_ms"), per("K1", zs, "ms")),
        "k1_train_step": (per("K1", tr, "first_design_ms"), per("K1", tr, "ms")),
        "k2_train_step": (per("K2", tr, "first_design_ms"), per("K2", tr, "ms")),
        "k3_prefill": (per("K3", ("prefill_b8_bf16",), "first_design_ms", 24),
                       per("K3", ("prefill_b8_bf16",), "ms", 24)),
        "k3_decode_step": (per("K3", ("decode_b8_bf16_bench",), "first_design_ms", 24),
                           per("K3", ("decode_b8_bf16_bench",), "ms", 24))}
    # K4: each shape times its sites per forward; K5: 12 layers per shape
    for path, frames in (("train_step", TRAIN_BATCH * TRAIN_CHUNKS),
                         ("zero_shot_batch", 2 * STORIES * CHUNKS)):
        sites = [spec for spec in GN_SHAPES if spec[1] == frames]
        totals[f"k4_{path}"] = tuple(sum(spec[5] * by[("K4", spec[0])][key] for spec in sites)
                                     for key in ("first_design_ms", "ms"))
        prefix = "pretrain" if path == "train_step" else "zeroshot"
        names = [spec[0] for spec in LN_SHAPES if spec[0].startswith(prefix)]
        totals[f"k5_{path}"] = (per("K5", names, "first_design_ms"), per("K5", names, "ms"))
    result = {"rows": rows, "per_path": {k: {"first_design_ms": a, "ms": b_, "speedup": a / b_}
                                         for k, (a, b_) in totals.items()}}
    print(f"[first-design] {json.dumps(result['per_path'])}", flush=True)
    return result


# ---------------------------------------------------------------------------
# K4 and K5


def gn_inputs(dev, g, b, hw, c, res):
    """x bf16 [b, hw, c] shaped like a conv output (per-channel offsets and
    scales around N(0, 1)), gamma ~ 1 + 0.1 N, beta ~ 0.1 N, and a bf16
    residual ~ N(0, 1) or None."""
    import torch
    x = torch.randn((b, hw, c), generator=g, device=dev)
    x = (x * (1 + 0.5 * torch.rand(c, generator=g, device=dev))
         + 0.5 * torch.randn(c, generator=g, device=dev)).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    r = (torch.randn((b, hw, c), generator=g, device=dev).to(torch.bfloat16)
         if res else None)
    return x, gamma, beta, r


def gn_within(row: dict, max_err: float, mean_err: float) -> bool:
    return max_err <= row["max_abs_err_bound"] and mean_err <= GN_MEAN_TOL


def gn_shape(dev, g, spec) -> dict:
    """K4 and its plain version at one shape: errors, fault probes, times."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import norms

    name, b, hw, c, kind, sites = spec
    relu, res = kind != "proj", kind == "res"
    x, gamma, beta, r = gn_inputs(dev, g, b, hw, c, res)
    kw = dict(num_groups=GN_GROUPS, epsilon=GN_EPS, relu=relu)
    out, mean, rstd = cg.group_norm_act_cuda(x, gamma, beta, r, **kw)
    torch.cuda.synchronize()

    def plain(x, gamma, beta, r, relu=relu):
        return norms.group_norm_act_plain(x, gamma, beta, r, GN_GROUPS, GN_EPS, relu)

    ref, ref_mean, ref_rstd = plain(x, gamma, beta, r)

    def errs(o):
        d = (o.float() - ref.float()).abs()
        return d.max().item(), d.mean().item()

    ref_max = ref.float().abs().max().item()
    row = {"shape": name, "frames": b, "hw": hw, "channels": c, "kind": kind,
           "sites_per_forward": sites, "ref_max_abs": ref_max,
           "max_abs_err_bound": GN_ULPS * bf16_ulp(ref_max)}
    row["max_abs_err"], row["mean_abs_err"] = errs(out)
    row["mean_stat_max_abs_err"] = (mean - ref_mean).abs().max().item()
    row["rstd_stat_max_rel_err"] = ((rstd - ref_rstd).abs() / ref_rstd).max().item()
    probes = {}
    if c > GN_GROUPS:
        # group g holds channels g, g + 32, ...: run the plain version on the
        # channels permuted so that those sit together, and permute back
        perm = torch.arange(c, device=dev).view(c // GN_GROUPS, GN_GROUPS).t().reshape(-1)
        o, _, _ = plain(x[..., perm].contiguous(), gamma[perm], beta[perm],
                        None if r is None else r[..., perm].contiguous())
        probes["groups_by_c_mod_32"] = errs(o[..., torch.argsort(perm)])
    if res:
        probes["residual_left_out"] = errs(plain(x, gamma, beta, None)[0])
    if relu:
        probes["relu_left_out"] = errs(plain(x, gamma, beta, r, relu=False)[0])
    row["probes"] = {k: {"max_abs_diff": a, "mean_abs_diff": m} for k, (a, m) in probes.items()}
    row["ms"] = cuda_ms(lambda: cg.group_norm_act_cuda(x, gamma, beta, r, **kw))
    row["plain_ms"] = cuda_ms(lambda: plain(x, gamma, beta, r))
    # the yardstick: torch's group_norm on the NCHW view of the channels-last
    # memory, then the add and the ReLU where the site has them (gamma and
    # beta in bf16; not the same rounding)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

    def library():
        y = F.group_norm(x.permute(0, 2, 1), GN_GROUPS, gb, bb, GN_EPS)
        if r is not None:
            y = y + r.permute(0, 2, 1)
        return F.relu(y) if relu else y

    row["library_ms"] = cuda_ms(library)
    # x read once, out written once, the residual read once; per element the
    # sums (2), the normalize (4), the add and the ReLU, in fp32
    n = b * hw * c
    nbytes = 2 * n * (3 if res else 2) + 8 * c + 8 * b * GN_GROUPS
    row["bound_ms"], row["bound_by"] = bound((6 + res + relu) * n, nbytes, PEAK_FP32_FLOPS)
    return row


def check_gn_row(row: dict) -> None:
    name = row["shape"]
    check(gn_within(row, row["max_abs_err"], row["mean_abs_err"]),
          f"K4 {name}: max err {row['max_abs_err']} (bound {row['max_abs_err_bound']}), "
          f"mean {row['mean_abs_err']} (bound {GN_MEAN_TOL})")
    check(row["mean_stat_max_abs_err"] <= GN_STAT_TOL
          and row["rstd_stat_max_rel_err"] <= GN_STAT_TOL,
          f"K4 {name}: stats err {row['mean_stat_max_abs_err']}, "
          f"{row['rstd_stat_max_rel_err']}")
    check(bool(row["probes"]), f"K4 {name}: no fault probe applies")
    for probe, d in row["probes"].items():
        check(not gn_within(row, d["max_abs_diff"], d["mean_abs_diff"]),
              f"K4 {name}: the {probe} fault passes the bounds, so they cannot see it")


def gn_kernel_phase(dev) -> list[dict]:
    """K4 against its plain version at the 26 GroupNorm shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for spec in GN_SHAPES:
        row = gn_shape(dev, g, spec)
        print(f"[kernel4] {json.dumps(row)}", flush=True)
        check_gn_row(row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def ln_within(row: dict, max_err: float, mean_err: float) -> bool:
    return max_err <= row["max_abs_err_bound"] and mean_err <= LN_MEAN_TOL


def ln_inputs(dev, g, m, j, n):
    """x bf16 [m, 768] shaped like a residual stream (rows with offsets and
    scales of their own), gamma ~ 1 + 0.1 N, beta ~ 0.1 N, and J fp32
    weights [n, 768] ~ 0.02 N with biases ~ 0.01 N."""
    import torch
    k = HEADS * D_HEAD
    x = ((torch.randn((m, k), generator=g, device=dev)
          + 0.5 * torch.randn((m, 1), generator=g, device=dev))
         * (1 + torch.rand((m, 1), generator=g, device=dev))).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(k, generator=g, device=dev)
    beta = 0.1 * torch.randn(k, generator=g, device=dev)
    ws = [0.02 * torch.randn((n, k), generator=g, device=dev) for _ in range(j)]
    bs = [0.01 * torch.randn(n, generator=g, device=dev) for _ in range(j)]
    return x, gamma, beta, ws, bs


def ln_shape(dev, g, spec) -> dict:
    """K5 and its plain version at one shape: errors, fault probes, times."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm
    from merlot_tpu_torch.ops import norms

    name, m, j, n = spec
    k = HEADS * D_HEAD
    bf16 = torch.bfloat16
    x, gamma, beta, ws, bs = ln_inputs(dev, g, m, j, n)
    w, bias = torch.cat(ws).to(bf16), torch.cat(bs).to(bf16)
    kw = dict(num_out=j, epsilon=LN_EPS)
    y = lm.ln_matmul_cuda(x, gamma, beta, w, bias, **kw)
    torch.cuda.synchronize()
    ref = torch.stack(norms.ln_matmul_plain(x, gamma, beta, ws, bs, LN_EPS))

    def errs(o):
        d = (o.float() - ref.float()).abs()
        return d.max().item(), d.mean().item()

    ref_max = ref.float().abs().max().item()
    row = {"shape": name, "rows": m, "k": k, "consumers": j, "n": n,
           "ref_max_abs": ref_max, "max_abs_err_bound": LN_ULPS * bf16_ulp(ref_max)}
    row["max_abs_err"], row["mean_abs_err"] = errs(y)
    # fault probes: z kept in fp32 (the products of fp32 z and the bf16
    # weights, each rounded to bf16 before the bias); beta left out
    z32 = norms.layer_norm(x.float(), gamma, beta, LN_EPS)
    probes = {
        "z_in_fp32": errs(torch.stack([F.linear(z32, wj.to(bf16).float()).to(bf16)
                                       + bj.to(bf16) for wj, bj in zip(ws, bs)])),
        "beta_left_out": errs(torch.stack(norms.ln_matmul_plain(
            x, gamma, torch.zeros_like(beta), ws, bs, LN_EPS)))}
    del z32
    row["probes"] = {p: {"max_abs_diff": a, "mean_abs_diff": d} for p, (a, d) in probes.items()}
    row["ms"] = cuda_ms(lambda: lm.ln_matmul_cuda(x, gamma, beta, w, bias, **kw))
    row["plain_ms"] = cuda_ms(lambda: norms.ln_matmul_plain(x, gamma, beta, ws, bs, LN_EPS))
    # the yardstick: torch's layer_norm, then one linear over the J weights
    # concatenated (two calls; gamma and beta in bf16, not the same rounding)
    gb, bb = gamma.to(bf16), beta.to(bf16)
    row["library_ms"] = cuda_ms(lambda: F.linear(F.layer_norm(x, (k,), gb, bb, LN_EPS),
                                                 w, bias))
    nbytes = 2 * (m * k + j * n * k + j * n + j * m * n) + 8 * k
    row["bound_ms"], row["bound_by"] = bound(2 * m * k * j * n, nbytes)
    return row


def check_ln_row(row: dict) -> None:
    name = row["shape"]
    check(ln_within(row, row["max_abs_err"], row["mean_abs_err"]),
          f"K5 {name}: max err {row['max_abs_err']} (bound {row['max_abs_err_bound']}), "
          f"mean {row['mean_abs_err']} (bound {LN_MEAN_TOL})")
    for probe, d in row["probes"].items():
        check(not ln_within(row, d["max_abs_diff"], d["mean_abs_diff"]),
              f"K5 {name}: the {probe} fault passes the bounds, so they cannot see it")


def ln_kernel_phase(dev) -> list[dict]:
    """K5 against its plain version at the ten LayerNorm+matmul shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for spec in LN_SHAPES:
        row = ln_shape(dev, g, spec)
        print(f"[kernel5] {json.dumps(row)}", flush=True)
        check_ln_row(row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def fused_norms():
    """Both GroupNorm backends on K4 inside the block (the port's defaults,
    like the JAX package's, are the unfused composition)."""
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    with wrapped(cg, "BACKEND", lambda _: "cuda"), \
            wrapped(cg, "TRAIN_BACKEND", lambda _: "cuda"):
        yield


def counts() -> tuple:
    """(K1, K2, K4, K5) launches so far."""
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm
    return ca.launches, ca.bwd_launches, cg.launches, lm.launches


def reset_counts() -> None:
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm
    ca.launches = ca.bwd_launches = ca.stacked_launches = cg.launches = lm.launches = 0


@contextlib.contextmanager
def norm_spans(s4: list, s5: list):
    """CUDA events around every K4 and K5 launch inside the block."""
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm
    with wrapped(cg, "group_norm_act_cuda", event_timed(s4)), \
            wrapped(lm, "ln_matmul_cuda", event_timed(s5)):
        yield


def synthetic_stories(seed: int, image_size, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (STORIES, CHUNKS, *image_size, 3)).astype(np.float32)
    sents = rng.integers(100, 50357, (STORIES, CHUNKS, TOKENS)).astype(np.int64)
    for b in range(STORIES):
        for n in range(CHUNKS):
            sents[b, n, rng.integers(8, TOKENS + 1):] = 0      # lang padding
    return torch.from_numpy(images).to(dev), torch.from_numpy(sents).to(dev)


def check_probs(out: dict) -> None:
    import torch
    for name in ("lang_viz_probs", "viz_viz_probs"):
        p = out[name]
        check(tuple(p.shape) == (STORIES, CHUNKS, CHUNKS, 3), f"{name} shape {p.shape}")
        check(bool(torch.isfinite(p).all()), f"{name} not finite")
        check(bool(((p >= 0) & (p <= 1)).all()), f"{name} outside [0, 1]")
        check(bool((p.sum(-1) <= 1 + 1e-5).all()), f"{name} classes sum > 1")


def max_diff(a: dict, b: dict) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in b)


def run_batches(fn, model, batches, module, name: str):
    """Run the batches one by one, each timed on the host clock and with
    CUDA events around every call of module.name."""
    import torch
    from merlot_tpu_torch.ops import cuda_attention as ca

    outs, seconds, attn_ms, launches = [], [], [], []
    for images, sents in batches:
        spans: list = []
        before = ca.launches
        t0 = time.perf_counter()
        with wrapped(module, name, event_timed(spans)):
            outs.append(fn(model, images, sents))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        attn_ms.append(spans_ms(spans))
        launches.append(ca.launches - before)
    return outs, seconds, attn_ms, launches


def slice_phase(dev) -> dict:
    import torch
    from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.merlot import MerlotModel
    from merlot_tpu_torch.nn.layers import init_params
    from merlot_tpu_torch.ops import attention as attn_mod
    from merlot_tpu_torch.ops import cuda_attention as ca

    cfg = MerlotConfig.from_dict(PRETRAIN_5SEG_MODEL).eval_mode()
    t0 = time.perf_counter()
    model = MerlotModel(cfg, device=dev).eval()
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    fn = make_zero_shot_fn(STORIES, CHUNKS)
    plain_fn = make_zero_shot_fn(STORIES, CHUNKS, attn_backend="plain")
    batches = [synthetic_stories(seed, cfg.image_size, dev)
               for seed in range(BATCHES + 1)]
    warm, batches = batches[-1], batches[:BATCHES]

    check_probs(fn(model, *warm))                   # warm-up, not counted
    check_probs(plain_fn(model, *warm))
    torch.cuda.synchronize()

    ca.launches = 0
    outs, seconds, k1_ms, per_batch = run_batches(
        fn, model, batches, ca, "attention_fwd_cuda")
    launches = ca.launches
    check(per_batch == [LAUNCHES_PER_BATCH] * BATCHES,
          f"kernel launches per batch {per_batch}, want {LAUNCHES_PER_BATCH}")
    for out in outs:
        check_probs(out)

    plains, plain_seconds, plain_ms, plain_launches = run_batches(
        plain_fn, model, batches, attn_mod, "_plain_attention")
    check(plain_launches == [0] * BATCHES, "the plain run launched the kernel")
    diffs = [max_diff(o, p) for o, p in zip(outs, plains)]

    # what the comparison can see: the same plain run with the softmax in
    # bf16 (a subtle fault), and with the joint tower's validity mask
    # dropped (a gross one), each on the first batch
    with wrapped(attn_mod, "_plain_attention",
                 lambda f: lambda *a, **kw: f(*a, **{**kw, "softmax_fp32": False})):
        bf16_softmax_diff = max_diff(plain_fn(model, *batches[0]), plains[0])
    with wrapped(attn_mod, "_plain_attention",
                 lambda f: lambda q, k, v, mask, **kw: f(q, k, v, None, **kw)):
        no_mask_diff = max_diff(plain_fn(model, *batches[0]), plains[0])

    med = statistics.median(seconds)
    result = {"params": n_params, "init_s": init_s, "launches": launches,
              "launches_per_batch": per_batch,
              "batch_seconds": seconds,
              "stories_per_s": STORIES / med,
              "stories_per_s_spread": [STORIES / max(seconds), STORIES / min(seconds)],
              "k1_ms_per_batch": k1_ms,
              "k1_ms": statistics.median(k1_ms),
              "plain_batch_seconds": plain_seconds,
              "plain_attention_ms_per_batch": plain_ms,
              "plain_attention_ms": statistics.median(plain_ms),
              "vs_plain_max_abs_diff": diffs,
              "bf16_softmax_max_abs_diff": bf16_softmax_diff,
              "no_joint_mask_max_abs_diff": no_mask_diff,
              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[slice] {json.dumps(result)}", flush=True)
    check(max(diffs) <= SLICE_TOL, f"kernel vs plain slice: {diffs} > {SLICE_TOL}")
    check(no_mask_diff > SLICE_TOL,
          f"dropping the joint mask moves the probs by only {no_mask_diff}: "
          "the slice comparison cannot see a broken attention")
    return result, model, warm, batches, outs


def fused_slice_phase(dev, model, warm, batches, outs) -> dict:
    """Zero-shot with both fused norms on: the same weights in a model with
    fuse_ln_matmul, the GroupNorm backend on K4; probs against the unfused
    kernel run's on the same batches."""
    import dataclasses
    import torch
    from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
    from merlot_tpu_torch.models.merlot import MerlotModel

    fused = MerlotModel(dataclasses.replace(model.cfg, fuse_ln_matmul=True), device=dev).eval()
    fused.load_state_dict(model.state_dict())
    fn = make_zero_shot_fn(STORIES, CHUNKS)
    with fused_norms():
        check_probs(fn(fused, *warm))                # warm-up, not counted
        torch.cuda.synchronize()
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        fouts, seconds, k4_ms, k5_ms, per_batch = [], [], [], [], []
        for images, sents in batches:
            s4, s5 = [], []
            before = counts()
            t0 = time.perf_counter()
            with norm_spans(s4, s5):
                fouts.append(fn(fused, images, sents))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            k4_ms.append(spans_ms(s4))
            k5_ms.append(spans_ms(s5))
            after = counts()
            per_batch.append((after[0] - before[0], after[2] - before[2], after[3] - before[3]))
        k1, _, k4, k5 = counts()
    for out in fouts:
        check_probs(out)
    diffs = [max_diff(f, o) for f, o in zip(fouts, outs)]
    # what the comparison can see: the first batch with K4's residual left
    # out, and with K5's MLP products zeroed
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm
    no_res = lambda f: lambda x, gamma, beta, residual, **kw: f(x, gamma, beta, None, **kw)
    no_mlp = lambda f: lambda *a, num_out, **kw: (
        f(*a, num_out=num_out, **kw) * (num_out != 1))
    with fused_norms(), wrapped(cg, "group_norm_act_cuda", no_res):
        no_residual_diff = max_diff(fn(fused, *batches[0]), outs[0])
    with fused_norms(), wrapped(lm, "ln_matmul_cuda", no_mlp):
        no_mlp_diff = max_diff(fn(fused, *batches[0]), outs[0])
    med = statistics.median(seconds)
    result = {"launches": {"attention_fwd": k1, "groupnorm": k4, "ln_matmul": k5},
              "launches_per_batch": per_batch, "batch_seconds": seconds,
              "stories_per_s": STORIES / med,
              "stories_per_s_spread": [STORIES / max(seconds), STORIES / min(seconds)],
              "k4_ms_per_batch": k4_ms, "k4_ms": statistics.median(k4_ms),
              "k5_ms_per_batch": k5_ms, "k5_ms": statistics.median(k5_ms),
              "vs_unfused_max_abs_diff": diffs,
              "no_residual_max_abs_diff": no_residual_diff,
              "no_mlp_max_abs_diff": no_mlp_diff,
              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[fused-slice] {json.dumps(result)}", flush=True)
    check(per_batch == [FUSED_LAUNCHES_PER_BATCH] * BATCHES,
          f"fused zero-shot K1/K4/K5 launches per batch {per_batch}, "
          f"want {FUSED_LAUNCHES_PER_BATCH}")
    check(max(diffs) <= FUSED_SLICE_TOL,
          f"fused vs unfused slice: {diffs} > {FUSED_SLICE_TOL}")
    for probe in ("no_residual", "no_mlp"):
        check(result[f"{probe}_max_abs_diff"] > FUSED_SLICE_TOL,
              f"the {probe} fault moves the fused probs by only "
              f"{result[f'{probe}_max_abs_diff']}: the comparison cannot see it")
    del fused
    return result


def pretrain_batch(cfg, dev) -> dict:
    """__graft_entry__._make_batch (numpy seed 0) at bench.py's batch, with
    each chunk's tail padded with id 0 from a second seed: the towers then
    see padded rows, which the draws 100..50356 alone never give."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    h, w = cfg.image_size
    group = cfg.num_chunks_in_group
    n_img = TRAIN_BATCH * TRAIN_CHUNKS
    images = rng.uniform(0, 1, (n_img, h, w, 3)).astype(np.float32)
    ids = rng.integers(100, 50357, (TRAIN_BATCH, TRAIN_CHUNKS, TRAIN_TOKENS))
    pad = np.random.default_rng(1)
    for b in range(TRAIN_BATCH):
        for n in range(TRAIN_CHUNKS):
            ids[b, n, pad.integers(8, TRAIN_TOKENS + 1):] = 0
    batch = {"images": images, "input_ids": ids,
             "shuffled_idx_img": np.tile(np.arange(group), n_img // group),
             "video_src_ids": np.repeat(np.arange(n_img // group), group)
             .reshape(TRAIN_BATCH, TRAIN_CHUNKS)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def loss_and_grads(model, batch, draws) -> tuple:
    """One forward and backward with dropout off and the given masking
    draws: (loss, fp32 grads by parameter name)."""
    import torch
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss, _, _ = model(batch, deterministic=True, attn_backend="cuda",
                       masking_draws=draws)
    loss.backward()
    return loss.item(), {n: torch.zeros_like(p) if p.grad is None else
                         p.grad.detach().float().clone() for n, p in params.items()}


def grad_gap(grads: dict, ref: dict) -> dict:
    """Each tensor's largest gradient difference over its largest |grad|,
    floored at 1e-3 of the largest |grad| of all; the worst tensor, and the
    worst of the LiteResNet's tensors and of all the others."""
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    per = {n: (grads[n] - r).abs().max().item() / max(r.abs().max().item(), floor)
           for n, r in ref.items()}
    worst = max(per, key=per.get)
    out = {"max_rel": per[worst], "worst_tensor": worst,
           "median_rel": statistics.median(per.values())}
    for part, names in (("resnet", [n for n in per if ".resnet." in n]),
                        ("rest", [n for n in per if ".resnet." not in n])):
        w = max(names, key=per.get)
        out[f"max_rel_{part}"], out[f"worst_tensor_{part}"] = per[w], w
    return out


def train_phase(dev) -> dict:
    import torch
    from merlot_tpu_torch.models import merlot as merlot_mod
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.ops.masking import masking_draws
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
    from merlot_tpu_torch.train.train_step import init_train_state, make_train_step

    cfg = MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL)
    opt_cfg = AdamWConfig.from_config(PRETRAIN_4SEG_OPTIMIZER)
    t0 = time.perf_counter()
    model = MerlotPretrainModel(cfg, device=dev)
    opt = MerlotAdamW(opt_cfg)
    state = init_train_state(model, opt, seed=0)
    batch = pretrain_batch(cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(model, opt)
    g = torch.Generator(device=dev).manual_seed(1)
    segments = TRAIN_BATCH * TRAIN_CHUNKS

    torch.cuda.reset_peak_memory_stats(dev)
    first = {k: float(v) for k, v in step(model, state, batch, g).items()}
    torch.cuda.synchronize()
    check(all(math.isfinite(v) for v in first.values()), f"step 1 metrics {first}")

    # the timed steps: counts set to 0 just before, read just after
    ca.launches = ca.bwd_launches = 0
    seconds, k1_ms, k2_ms, per_step, losses = [], [], [], [], []
    for _ in range(TRAIN_STEPS):
        s1, s2 = [], []
        before = (ca.launches, ca.bwd_launches)
        t0 = time.perf_counter()
        with wrapped(ca, "attention_fwd_cuda", event_timed(s1)), \
                wrapped(ca, "attention_bwd_cuda", event_timed(s2)):
            metrics = step(model, state, batch, g)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        k1_ms.append(spans_ms(s1))
        k2_ms.append(spans_ms(s2))
        per_step.append((ca.launches - before[0], ca.bwd_launches - before[1]))
        losses.append(metrics["loss"].item())
    launches = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    check(per_step == [(LAUNCHES_PER_STEP, LAUNCHES_PER_STEP)] * TRAIN_STEPS,
          f"K1/K2 launches per step {per_step}, want {LAUNCHES_PER_STEP} each")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")

    # the loss falls on the repeated batch: no warmup (lr 3e-4 from the
    # first step), the same masking draws and dropout masks every step
    fall_opt = MerlotAdamW(AdamWConfig.from_config(
        dict(PRETRAIN_4SEG_OPTIMIZER, num_warmup_steps=0)))
    fall_state = fall_opt.init(dict(model.named_parameters()))
    fall_step = make_train_step(model, fall_opt)
    s = cfg.num_chunks_in_group
    draws = masking_draws(segments // s, TRAIN_TOKENS * s, vocab_size=cfg.vocab_size,
                          generator=torch.Generator(device=dev).manual_seed(2),
                          device=dev)
    fall = []
    for _ in range(LOSS_FALL_STEPS):
        fall.append(fall_step(model, fall_state, batch,
                              torch.Generator(device=dev).manual_seed(3),
                              masking_draws=draws)["loss"].item())
    check(fall[-1] < fall[0], f"the loss does not fall on a repeated batch: {fall}")

    # one step's loss and grads through the kernels and through the plain
    # attention (K1's and K2's plain versions), then through a broken
    # backward: the plain one with the mask left out. The masked positions
    # rank the lang tower's colsum, which K1 and its plain version sum in
    # another order, so near-ties can pick other positions from the same
    # draws: the plain runs reuse the kernel run's masking.
    masking = []
    record = lambda f: lambda *a, **kw: masking.append(f(*a, **kw)) or masking[-1]
    pin = lambda f: lambda *a, **kw: masking[0]
    with wrapped(merlot_mod, "attention_guided_span_mask", record):
        kernel_loss, kernel_grads = loss_and_grads(model, batch, draws)
    # what the fused step is held to: these weights, masking and grads
    ref = {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
           "masking": masking[0], "draws": draws, "loss": kernel_loss,
           "grads": kernel_grads}
    ca.launches = ca.bwd_launches = 0
    s1, s2 = [], []
    # the plain versions in the kernels' places: they take no saved stats
    # (the plain backward recomputes P)
    plain_fwd = lambda *a, stats=None, **kw: ca.flash_attention_plain(*a, **kw)
    plain_bwd = lambda *a, stats=None, **kw: ca.attention_bwd_plain(*a, **kw)
    with wrapped(merlot_mod, "attention_guided_span_mask", pin), \
            wrapped(ca, "attention_fwd_cuda", lambda f: event_timed(s1)(plain_fwd)), \
            wrapped(ca, "attention_bwd_cuda", lambda f: event_timed(s2)(plain_bwd)):
        plain_loss, plain_grads = loss_and_grads(model, batch, draws)
    check(ca.launches == ca.bwd_launches == 0, "the plain run launched a kernel")
    no_mask_bwd = lambda q, k, v, mask, *a, **kw: plain_bwd(q, k, v, None, *a, **kw)
    with wrapped(merlot_mod, "attention_guided_span_mask", pin), \
            wrapped(ca, "attention_fwd_cuda", lambda f: plain_fwd), \
            wrapped(ca, "attention_bwd_cuda", lambda f: no_mask_bwd):
        broken = grad_gap(loss_and_grads(model, batch, draws)[1], plain_grads)
    gap = grad_gap(kernel_grads, plain_grads)
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)

    med = statistics.median(seconds)
    result = {"params": n_params, "init_s": init_s, "segments_per_step": segments,
              "step_seconds": seconds,
              "segments_per_s": segments / med,
              "segments_per_s_spread": [segments / max(seconds), segments / min(seconds)],
              "k1_ms_per_step": k1_ms, "k1_ms": statistics.median(k1_ms),
              "k2_ms_per_step": k2_ms, "k2_ms": statistics.median(k2_ms),
              "launches": launches, "launches_per_step": per_step,
              "peak_mem_gib": peak_gib, "step1_metrics": first,
              "timed_losses": losses, "loss_fall_no_warmup": fall,
              "kernel_loss": kernel_loss, "plain_loss": plain_loss,
              "loss_rel_diff": loss_rel, "grads_vs_plain": gap,
              "plain_k1_ms_per_step": spans_ms(s1),
              "plain_k2_ms_per_step": spans_ms(s2),
              "mask_dropped_backward_vs_plain": broken}
    print(f"[train] {json.dumps(result)}", flush=True)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"kernel vs plain loss: {loss_rel}")
    check(gap["max_rel"] <= TRAIN_GRAD_TOL,
          f"kernel vs plain grads: {gap} > {TRAIN_GRAD_TOL}")
    check(broken["max_rel"] > TRAIN_GRAD_TOL,
          f"a backward without the mask moves the grads by only "
          f"{broken}: the train comparison cannot see it")
    return result, model, state, step, batch, ref


def fused_train_phase(dev, ref) -> dict:
    """The train step with both fused norms on (fuse_ln_matmul, the
    GroupNorm backend on K4): timed steps, launches, peak memory, the loss
    falling, one step's loss and grads against the unfused kernel step's at
    the same weights and masking (and a GroupNorm backward without the ReLU
    mask checked to fail that bound), and torch.profiler over two steps."""
    import dataclasses
    import torch
    from merlot_tpu_torch.models import merlot as merlot_mod
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm
    from merlot_tpu_torch.ops import norms
    from merlot_tpu_torch.ops.masking import masking_draws
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
    from merlot_tpu_torch.train.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL), fuse_ln_matmul=True)
    model = MerlotPretrainModel(cfg, device=dev)
    opt = MerlotAdamW(AdamWConfig.from_config(PRETRAIN_4SEG_OPTIMIZER))
    state = init_train_state(model, opt, seed=0)
    batch = pretrain_batch(cfg, dev)
    step = make_train_step(model, opt)
    g = torch.Generator(device=dev).manual_seed(1)
    segments = TRAIN_BATCH * TRAIN_CHUNKS
    with fused_norms():
        torch.cuda.reset_peak_memory_stats(dev)
        first = {k: float(v) for k, v in step(model, state, batch, g).items()}
        torch.cuda.synchronize()
        check(all(math.isfinite(v) for v in first.values()), f"fused step 1 metrics {first}")

        # the timed steps, then one more with CUDA events around every K4
        # and K5 launch: counts set to 0 just before, read just after
        reset_counts()
        seconds, per_step, losses = [], [], []
        s4, s5 = [], []
        for i in range(TRAIN_STEPS + 1):
            before = counts()
            t0 = time.perf_counter()
            with norm_spans(s4, s5) if i == TRAIN_STEPS else contextlib.nullcontext():
                metrics = step(model, state, batch, g)
            torch.cuda.synchronize()
            if i < TRAIN_STEPS:
                seconds.append(time.perf_counter() - t0)
            per_step.append(tuple(a - b for a, b in zip(counts(), before)))
            losses.append(metrics["loss"].item())
        k4_ms, k5_ms = spans_ms(s4), spans_ms(s5)
        k1, k2, k4, k5 = counts()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        check(per_step == [FUSED_LAUNCHES_PER_STEP] * (TRAIN_STEPS + 1),
              f"fused K1/K2/K4/K5 launches per step {per_step}, "
              f"want {FUSED_LAUNCHES_PER_STEP}")
        check(all(math.isfinite(x) for x in losses), f"fused losses {losses}")

        # the loss falls on the repeated batch (no warmup, fixed draws)
        fall_opt = MerlotAdamW(AdamWConfig.from_config(
            dict(PRETRAIN_4SEG_OPTIMIZER, num_warmup_steps=0)))
        fall_state = fall_opt.init(dict(model.named_parameters()))
        fall_step = make_train_step(model, fall_opt)
        s = cfg.num_chunks_in_group
        draws = masking_draws(segments // s, TRAIN_TOKENS * s, vocab_size=cfg.vocab_size,
                              generator=torch.Generator(device=dev).manual_seed(2),
                              device=dev)
        fall = [fall_step(model, fall_state, batch,
                          torch.Generator(device=dev).manual_seed(3),
                          masking_draws=draws)["loss"].item()
                for _ in range(LOSS_FALL_STEPS)]
        check(fall[-1] < fall[0], f"the fused loss does not fall on a repeated batch: {fall}")

        # one step's loss and grads against the unfused kernel step's, at its
        # weights and with its masking
        model.load_state_dict(ref["state"])
        pin = lambda f: lambda *a, **kw: ref["masking"]
        no_relu_mask = lambda f: lambda dy, x, gamma, mean, rstd, out, *a: f(
            dy, x, gamma, mean, rstd, None, *a)
        no_dgamma = lambda f: lambda *a: (lambda dx, dg, *rest: (dx, torch.zeros_like(dg),
                                                                 *rest))(*f(*a))
        with wrapped(merlot_mod, "attention_guided_span_mask", pin):
            fused_loss, fused_grads = loss_and_grads(model, batch, ref["draws"])
            with wrapped(norms, "group_norm_act_bwd", no_relu_mask):
                broken = grad_gap(loss_and_grads(model, batch, ref["draws"])[1], ref["grads"])
            with wrapped(lm, "ln_matmul_bwd", no_dgamma):
                broken_ln = grad_gap(loss_and_grads(model, batch, ref["draws"])[1],
                                     ref["grads"])
        gap = grad_gap(fused_grads, ref["grads"])
        loss_rel = abs(fused_loss - ref["loss"]) / abs(ref["loss"])
        del fused_grads
        # K4 and K5 launch one kernel per call
        prof = profile_steps(dev, step, model, state, batch, label="fused-profile",
                             counted={("K4 groupnorm",): lambda: counts()[2],
                                      ("K5 ln_matmul",): lambda: counts()[3]})

    med = statistics.median(seconds)
    result = {"segments_per_step": segments, "step_seconds": seconds,
              "segments_per_s": segments / med,
              "segments_per_s_spread": [segments / max(seconds), segments / min(seconds)],
              "k4_ms": k4_ms, "k5_ms": k5_ms,
              "launches": {"attention_fwd": k1, "attention_bwd": k2, "groupnorm": k4,
                           "ln_matmul": k5},
              "launches_per_step": per_step, "peak_mem_gib": peak_gib,
              "step1_metrics": first, "timed_losses": losses, "loss_fall_no_warmup": fall,
              "fused_loss": fused_loss, "unfused_loss": ref["loss"],
              "loss_rel_diff": loss_rel, "grads_vs_unfused": gap,
              "no_relu_mask_backward_vs_unfused": broken,
              "no_dgamma_ln_backward_vs_unfused": broken_ln,
              "profile": {k: v for k, v in prof.items() if k != "top_kernels"}}
    print(f"[fused-train] {json.dumps(result)}", flush=True)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"fused vs unfused loss: {loss_rel}")
    check(gap["max_rel_resnet"] <= FUSED_RESNET_GRAD_TOL
          and gap["max_rel_rest"] <= FUSED_GRAD_TOL,
          f"fused vs unfused grads: {gap} > {FUSED_RESNET_GRAD_TOL}, {FUSED_GRAD_TOL}")
    check(broken["max_rel_resnet"] > FUSED_RESNET_GRAD_TOL,
          f"a GroupNorm backward without the ReLU mask moves the grads by only "
          f"{broken}: the fused train comparison cannot see it")
    check(broken_ln["max_rel_rest"] > FUSED_GRAD_TOL,
          f"a LayerNorm+matmul backward without dgamma moves the grads by only "
          f"{broken_ln}: the fused train comparison cannot see it")
    del model, state, step, batch
    return result, prof


def ab_phase(dev) -> dict:
    """The unfused and the fused train step in turns (unfused, fused, fused,
    unfused), each a fresh model from seed 0 after AB_WARMUP steps: the host
    clock per step and the host's enqueue time (until step() returns)."""
    import dataclasses
    import torch
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
    from merlot_tpu_torch.train.train_step import init_train_state, make_train_step

    runs = []
    for fused in (False, True, True, False):
        cfg = dataclasses.replace(MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL),
                                  fuse_ln_matmul=fused)
        model = MerlotPretrainModel(cfg, device=dev)
        opt = MerlotAdamW(AdamWConfig.from_config(PRETRAIN_4SEG_OPTIMIZER))
        state = init_train_state(model, opt, seed=0)
        batch = pretrain_batch(cfg, dev)
        step = make_train_step(model, opt)
        g = torch.Generator(device=dev).manual_seed(1)
        with fused_norms() if fused else contextlib.nullcontext():
            for _ in range(AB_WARMUP):
                step(model, state, batch, g)
            torch.cuda.synchronize()
            wall, enqueue = [], []
            for _ in range(AB_STEPS):
                t0 = time.perf_counter()
                step(model, state, batch, g)
                enqueue.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
        segments = TRAIN_BATCH * TRAIN_CHUNKS
        runs.append({"fused": fused, "step_seconds": wall, "enqueue_seconds": enqueue,
                     "segments_per_s": segments / statistics.median(wall),
                     "enqueue_share": statistics.median(enqueue) / statistics.median(wall)})
        del model, state, step, batch, opt
        torch.cuda.empty_cache()
    result = {"runs": runs,
              "unfused_segments_per_s": [r["segments_per_s"] for r in runs if not r["fused"]],
              "fused_segments_per_s": [r["segments_per_s"] for r in runs if r["fused"]]}
    print(f"[train-ab] {json.dumps(result)}", flush=True)
    return result


def kernel_family(name: str) -> str:
    """A coarse family for a kernel name in a profile: this package's
    kernels, library matmuls and convolutions, or everything else
    (elementwise, reductions, norms, copies, RNG)."""
    low = name.lower()
    if any(t in low for t in ("::gn_kernel<", "gn_kerneli")):  # demangled or mangled
        return "K4 groupnorm"
    if "ln_matmul" in low:
        return "K5 ln_matmul"
    if "attention_decode" in low:
        return "K3 attention_decode"
    if "attention_fwd" in low:
        return "K1 attention_fwd"
    if "attention_bwd" in low:
        return "K2 attention_bwd"
    if any(t in low for t in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "matmul")):
        return "matmul"
    return "elementwise, reduction and other"


# a profile on the card now and then loses kernel records, with or without
# a kernel launched before the measured work: one that holds fewer
# launches than the wrappers counted over the same run is taken again
PROFILE_TRIES = 3


def profile_device(run, label: str, family=kernel_family, counted=None, **info) -> dict:
    """torch.profiler over run(): device time by kernel family and the
    device's idle share (the profiler's own overhead counts as idle).
    counted maps a tuple of families to a function that reads the wrappers'
    count of their kernels; the profile must hold every launch counted over
    its run(), within PROFILE_TRIES runs, and "tries" says how many it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counted = counted or {}
    for tries in range(1, PROFILE_TRIES + 1):
        before = {fams: read() for fams, read in counted.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        families = {}
        for e in events:
            fam = family(e.key)
            ms, n = families.get(fam, (0.0, 0))
            families[fam] = (ms + e.self_device_time_total / 1e3, n + e.count)
        missing = {"+".join(fams): (read() - before[fams],
                                    sum(families.get(f, (0, 0))[1] for f in fams))
                   for fams, read in counted.items()}
        missing = {k: v for k, v in missing.items() if v[0] != v[1]}
        if not missing:
            break
        print(f"[{label}] profile {tries} holds (counted, profiled) launches {missing}",
              flush=True)
    check(not missing, f"[{label}] no profile in {PROFILE_TRIES} held the launches the "
                       f"wrappers counted: {missing}")
    total = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:40]
    summary = {**info, "tries": tries, "wall_ms": wall_ms, "device_ms": total,
               "device_idle_share": 1 - total / wall_ms if wall_ms else None,
               "families": {f: {"ms": ms, "launches": n}
                            for f, (ms, n) in sorted(families.items(),
                                                     key=lambda x: -x[1][0])},
               "top_kernels": [{"name": e.key, "ms": e.self_device_time_total / 1e3,
                                "count": e.count} for e in top]}
    print(f"[{label}] {json.dumps({k: summary[k] for k in summary if k != 'top_kernels'})}",
          flush=True)
    return summary


def profile_steps(dev, step, model, state, batch, label: str = "profile",
                  counted=None) -> dict:
    """torch.profiler over two train steps."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)

    def run():
        for _ in range(2):
            step(model, state, batch, g)
    return profile_device(run, label, counted=counted, steps=2)


# ---------------------------------------------------------------------------
# K3 and Grover serving


def stacked_inputs(dev, g, b, sq, sk, pos0, dtype):
    """q, kv ~ N(0, 1) with the cache rows past the last query zero, and the
    causal mask over cache positions [1, Sq, Sk] (one for the batch, as the
    model builds it)."""
    import torch
    hd = GROVER_HEADS * GROVER_D
    q = torch.randn((b, sq, hd), generator=g, device=dev).to(dtype)
    kv = torch.randn((b, sk, 2 * hd), generator=g, device=dev).to(dtype)
    kv[:, pos0 + sq:] = 0
    mask = (torch.arange(sk, device=dev)[None]
            <= pos0 + torch.arange(sq, device=dev)[:, None]).float()[None]
    return q, kv, mask


def stacked_bound(b, sq, sk, pos0, dtype, live: bool = True) -> tuple:
    """K3's bound over what the inputs need: with ``live``, the slots below
    kv_len = pos0 + sq (past them the mask is 0 and the probs exactly 0),
    else all Sk slots. Query row r attends to pos0 + r + 1 keys (all Sk
    without ``live``): 4*B*H*D operations per key at the peak of the input
    type; the cache's rows, q and ctx once each in that type and the shared
    mask's columns in fp32."""
    import torch
    hd = GROVER_HEADS * GROVER_D
    elem = 2 if dtype == torch.bfloat16 else 4
    slots = pos0 + sq if live else sk
    keys = sum(pos0 + r + 1 for r in range(sq)) if live else sq * sk
    flops = 4 * b * GROVER_HEADS * keys * GROVER_D
    nbytes = elem * (b * slots * 2 * hd + 2 * b * sq * hd) + 4 * sq * slots
    return bound(flops, nbytes, PEAK_BF16_FLOPS if elem == 2 else PEAK_FP32_FLOPS)


def queued_ms(call, iters: int = 10) -> float:
    """CUDA-event ms per call of call(), the calls queued before the card
    starts on them: a sleep kernel that outlasts the host's enqueue of the
    calls goes first, so the events time the card's work and not the host's
    gaps (K3's decode takes less time on the card than its wrapper on the
    host)."""
    import torch
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * host_s + 1e-4)))   # cycles at up to 2 GHz
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fn, inputs: list):
    """fn over copies of its inputs taken in turn, so that a small cache is
    not served from L2 as the 24 layers' caches of a decode step would not
    be."""
    k = [0]

    def call():
        fn(*inputs[k[0] % len(inputs)])
        k[0] += 1
    return call


def rotating_ms(fn, inputs: list, iters: int = 10) -> float:
    return queued_ms(rotating(fn, inputs), iters=iters)


def stacked_copies(q, kv, mask) -> list:
    """Copies of (q, kv, mask) that together outgrow the 50 MB L2."""
    n = max(1, min(32, math.ceil(160e6 / (kv.numel() * kv.element_size()))))
    return [(q.clone(), kv.clone(), mask) for _ in range(n)]


def stacked_within(row: dict, max_err: float, mean_err: float) -> bool:
    if row["dtype"] == "fp32":
        return max_err <= STACKED_FP32_RTOL * row["ref_max_abs"]
    return max_err <= row["max_abs_err_bound"] and mean_err <= CTX_MEAN_TOL


def stacked_shape(dev, g, spec) -> dict:
    """K3 and its plain version at one shape, the kernel reading the live
    slots (kv_len = pos0 + Sq): errors, fault probes, times."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    name, b, sq, sk, pos0, dt = spec
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, kv, mask = stacked_inputs(dev, g, b, sq, sk, pos0, dtype)
    hd = GROVER_HEADS * GROVER_D
    live = pos0 + sq
    kw = dict(num_heads=GROVER_HEADS, softmax_fp32=True)
    ctx = ca.attention_stacked_fwd_cuda(q, kv, mask, kv_len=live, **kw)
    torch.cuda.synchronize()
    ref = ca.flash_attention_stacked_plain(q, kv, mask, kv_len=live, **kw)

    def errs(x):
        d = (x.float() - ref.float()).abs()
        return d.max().item(), d.mean().item()

    ref_max = ref.float().abs().max().item()
    row = {"shape": name, "batch": b, "sq": sq, "sk": sk, "first_query_pos": pos0,
           "kv_len": live, "dtype": dt, "ref_max_abs": ref_max,
           "max_abs_err_bound": (CTX_ULPS * bf16_ulp(ref_max) if dt == "bf16"
                                 else STACKED_FP32_RTOL * ref_max)}
    if sq <= ca.DECODE_ROWS:
        row["decode_plan"] = ca.decode_plan(b, GROVER_HEADS, sq, sk, GROVER_D,
                                            q.element_size())
    row["max_abs_err"], row["mean_abs_err"] = errs(ctx)
    # fault probes: the zero slots join the softmax; the values come from
    # the key half of the buffer
    row["no_mask_max_abs_diff"], row["no_mask_mean_abs_diff"] = errs(
        ca.flash_attention_stacked_plain(q, kv, None, **kw))
    row["v_from_k_max_abs_diff"], row["v_from_k_mean_abs_diff"] = errs(
        ca.flash_attention_stacked_plain(q, torch.cat([kv[..., :hd], kv[..., :hd]], -1),
                                         mask, **kw))
    if sq <= ca.DECODE_ROWS:
        # the decode kernel reads nothing past kv_len: NaN there changes
        # nothing; one live slot short must show
        dirty = kv.clone()
        dirty[:, live:] = float("nan")
        row["nan_past_kv_len_max_abs_err"], row["nan_past_kv_len_mean_abs_err"] = errs(
            ca.attention_stacked_fwd_cuda(q, dirty, mask, kv_len=live, **kw))
        del dirty
        row["kv_len_short_max_abs_diff"], row["kv_len_short_mean_abs_diff"] = errs(
            ca.attention_stacked_fwd_cuda(q, kv, mask, kv_len=live - 1, **kw))
        again = ca.attention_stacked_fwd_cuda(q, kv, mask, kv_len=live, **kw)
        row["repeat_bit_equal"] = bool(torch.equal(again, ctx))
    copies = stacked_copies(q, kv, mask)
    row["timing_copies"] = len(copies)
    row["ms"] = rotating_ms(
        lambda *a: ca.attention_stacked_fwd_cuda(*a, kv_len=live, **kw), copies)
    row["whole_cache_ms"] = rotating_ms(
        lambda *a: ca.attention_stacked_fwd_cuda(*a, **kw), copies)
    row["plain_ms"] = rotating_ms(
        lambda *a: ca.flash_attention_stacked_plain(*a, kv_len=live, **kw), copies)

    # the yardstick: SDPA on the k/v views of the buffer, the mask as an
    # additive -1e10 bias in the input dtype; over the whole cache (the
    # same inputs) and over the live slots' views
    def sdpa(q3, kv3, m, slots=sk):
        heads = lambda t, s: t.view(b, s, GROVER_HEADS, GROVER_D).transpose(1, 2)
        kv3 = kv3[:, :slots]
        bias = ((m[..., :slots] - 1.0) * 1e10).to(dtype)[:, None]
        return F.scaled_dot_product_attention(heads(q3, sq), heads(kv3[..., :hd], slots),
                                              heads(kv3[..., hd:], slots), attn_mask=bias)
    row["library_ms"] = rotating_ms(sdpa, copies)
    row["library_live_ms"] = rotating_ms(lambda *a: sdpa(*a, slots=live), copies)
    row["bound_ms"], row["bound_by"] = stacked_bound(b, sq, sk, pos0, dtype)
    row["bound_whole_cache_ms"], _ = stacked_bound(b, sq, sk, pos0, dtype, live=False)
    del copies
    return row


def check_stacked_row(row: dict) -> None:
    name = row["shape"]
    check(stacked_within(row, row["max_abs_err"], row["mean_abs_err"]),
          f"K3 {name}: max err {row['max_abs_err']} (bound {row['max_abs_err_bound']}), "
          f"mean {row['mean_abs_err']}")
    for probe in ("no_mask", "v_from_k") + (("kv_len_short",) if "decode_plan" in row else ()):
        check(not stacked_within(row, row[f"{probe}_max_abs_diff"],
                                 row[f"{probe}_mean_abs_diff"]),
              f"K3 {name}: the {probe} fault passes the bounds, so they cannot see it")
    if "decode_plan" in row:
        check(stacked_within(row, row["nan_past_kv_len_max_abs_err"],
                             row["nan_past_kv_len_mean_abs_err"]),
              f"K3 {name}: NaN past kv_len moves ctx by {row['nan_past_kv_len_max_abs_err']}")
        check(row["repeat_bit_equal"], f"K3 {name}: two launches differ")


def decode_ptxas(log: str) -> list:
    """(kernel, registers, spill bytes) of each decode kernel in a ptxas
    report (``-Xptxas -v``)."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if "attention_decode" in m.group(1) else None
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            t = re.search(r"attention_decodeI(\w+?)Li(\d+)ELi(\d+)E", name)
            short = (f"attention_decode<{'bf16' if 'bfloat16' in t.group(1) else 'fp32'}, "
                     f"MAXQ={t.group(2)}, LANES={t.group(3)}>" if t else name)
            out.append({"kernel": short, "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    return out


def stacked_phase(dev) -> list[dict]:
    """K3 against its plain version at the six shapes."""
    import torch
    from merlot_tpu_torch import _build

    for k in decode_ptxas(_build.build_logs.get("attention_stacked", "")):
        print(f"[kernel3] ptxas {json.dumps(k)}", flush=True)
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for spec in STACKED_SHAPES:
        row = stacked_shape(dev, g, spec)
        print(f"[kernel3] {json.dumps(row)}", flush=True)
        check_stacked_row(row)
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def grover_model(dev, bf16: bool):
    """grover-medium as the denoiser serves it (fused qkv, stacked cache),
    weights from seed 0; with bf16, cast for serving."""
    import dataclasses
    import torch
    from merlot_tpu_torch.models.grover import (GroverConfig, GroverLM,
                                                cast_params_for_serving)
    from merlot_tpu_torch.nn.layers import init_params
    cfg = dataclasses.replace(
        GroverConfig.from_json_file(str(ROOT / "configs" / "grover_medium.json")),
        use_bfloat16=bf16, fused_qkv=True, stacked_kv=True)
    model = GroverLM(cfg, device=dev).eval()
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    if bf16:
        cast_params_for_serving(model)
    return model


def split_spans(spans: list) -> tuple:
    """(prefill ms, decode launches, their ms) of one generation's spans:
    the prefill's 24 launches come first."""
    return spans_ms(spans[:24]), len(spans) - 24, spans_ms(spans[24:])


def greedy_logits(model, ctx, max_len: int, feed=None) -> tuple:
    """The prefill and GREEDY_STEPS decode steps, each fed the argmax of the
    logits before it (the sampler at p tiny), or the tokens ``feed``:
    (logits at every prefill position [B, P, V] fp32, logits of the decode
    steps' inputs' successors [steps + 1, B, V] fp32 (the prefill's last
    position first), fed tokens [steps, B])."""
    import torch
    from merlot_tpu_torch.models.grover import lm_logits_for_hidden
    with torch.inference_mode():
        cache = model.empty_cache(ctx.shape[0], max_len)
        _, cache, h = model(ctx, cache=cache, return_hidden=True, compute_logits=False)
        prefill = lm_logits_for_hidden(model.word_embed, model.cfg, h)
        logits = [prefill[:, -1]]
        toks = []
        for i in range(GREEDY_STEPS):
            toks.append(logits[-1].argmax(-1) if feed is None else feed[i])
            lg, cache = model(toks[-1][:, None], cache=cache,
                              position_offset=ctx.shape[1] + i)
            logits.append(lg[:, 0])
        return prefill, torch.stack(logits), torch.stack(toks)


def logits_gap(a: tuple, b: tuple) -> dict:
    """Largest |difference| of the prefill and of the decode logits."""
    return {"prefill": (a[0] - b[0]).abs().max().item(),
            "decode": (a[1] - b[1]).abs().max().item()}


def check_generation(toks, probs, ctx, vocab: int) -> None:
    import torch
    b, prefix = ctx.shape
    check(torch.equal(toks[:, :prefix].cpu(), torch.from_numpy(ctx)),
          "generation: the prefix was not kept")
    gen = toks[:, prefix:]
    check(bool(((gen > 0) & (gen < vocab)).all()), "generation: tokens out of range")
    check(bool(torch.isfinite(probs).all()) and bool(((probs >= 0) & (probs <= 1)).all()),
          "generation: probs not in [0, 1]")
    check(bool((probs[:, 1:] > 0).all()), "generation: a zero prob")


def grover_family(name: str) -> str:
    """kernel_family on the Grover path, where K1 is never launched (the
    phase checks it), so K1's tiled kernels are K3's prefill."""
    fam = kernel_family(name)
    return "K3 prefill (K1's tiled kernels)" if fam == "K1 attention_fwd" else fam


def grover_phase(dev) -> dict:
    import numpy as np
    import torch
    from merlot_tpu_torch.models.grover import make_seq2seq_sampler
    from merlot_tpu_torch.ops import cuda_attention as ca

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = grover_model(dev, bf16=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    ctx = np.random.default_rng(0).integers(100, 50257, (GROVER_BATCH, GROVER_PREFIX))
    ctx_t = torch.from_numpy(ctx).to(dev)
    lo, hi = GROVER_GENS
    samplers = {g: make_seq2seq_sampler(model, max_len=GROVER_PREFIX + g,
                                        prefix_len=GROVER_PREFIX, p_for_topp=0.005,
                                        eos_token=-1, k_prefilter=1024)
                for g in GROVER_GENS}
    gen = torch.Generator(device=dev)
    for g in GROVER_GENS:                           # warm-up
        samplers[g](ctx, gen.manual_seed(1))
    prefill_s = []
    for _ in range(GROVER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(ctx_t, cache=model.empty_cache(GROVER_BATCH, GROVER_PREFIX + hi),
                  return_hidden=True, compute_logits=False)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before, read just after
    ca.launches = ca.bwd_launches = ca.stacked_launches = 0
    times = {g: [] for g in GROVER_GENS}
    outs = {}
    for r in range(GROVER_REPEATS):
        for g in GROVER_GENS:
            t0 = time.perf_counter()
            outs[g] = samplers[g](ctx, gen.manual_seed(10 + r))
            torch.cuda.synchronize()
            times[g].append(time.perf_counter() - t0)
    spans: list = []
    with wrapped(ca, "attention_stacked_fwd_cuda", event_timed(spans)):
        samplers[hi](ctx, gen.manual_seed(20))
    torch.cuda.synchronize()
    k3_prefill_ms, n_dec, k3_decode_ms = split_spans(spans)
    # device time by kernel over one generation of `lo` tokens: K3's own
    # time on the path (the events above also hold the host's gaps
    # between launches when the step is host-bound), and the idle share
    k3_families = ("K3 attention_decode", "K3 prefill (K1's tiled kernels)")
    prof = profile_device(lambda: samplers[lo](ctx, gen.manual_seed(21)), "grover-profile",
                          family=grover_family,
                          counted={k3_families: lambda: ca.stacked_launches},
                          batch=GROVER_BATCH, prefix=GROVER_PREFIX, tokens=lo)
    k3_dec, k3_pre = (prof["families"].get(f, {"ms": 0.0, "launches": 0})
                      for f in k3_families)
    # one short fp32 generation: the prefill and 32 steps through fp32 K3
    model32 = grover_model(dev, bf16=False)
    t0 = time.perf_counter()
    toks32, probs32 = make_seq2seq_sampler(
        model32, max_len=GROVER_PREFIX + 33, prefix_len=GROVER_PREFIX, p_for_topp=0.005,
        eos_token=-1, k_prefilter=1024)(ctx, gen.manual_seed(30))
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    launches = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches,
                "attention_stacked": ca.stacked_launches}
    del model32
    want = 24 * (GROVER_REPEATS * sum(GROVER_GENS) + hi + lo * prof["tries"] + 33)
    check(launches == {"attention_fwd": 0, "attention_bwd": 0, "attention_stacked": want},
          f"Grover path launches {launches}, want {want} of K3 only")
    check(n_dec == 24 * (hi - 1), f"K3 launches: {n_dec} over {hi - 1} decode steps")
    check((k3_pre["launches"], k3_dec["launches"]) == (24, 24 * (lo - 1)),
          f"the profile shows {k3_pre['launches']} K3 prefill and {k3_dec['launches']} "
          f"K3 decode kernels over {lo - 1} steps")
    for g in GROVER_GENS:
        check_generation(*outs[g], ctx, cfg.vocab_size)
    check_generation(toks32, probs32, ctx, cfg.vocab_size)

    # kernels against the plain attention: the kernel run's argmax tokens
    # are fed to the plain runs, so all see the same inputs
    max_len = GROVER_PREFIX + hi
    kern = greedy_logits(model, ctx_t, max_len)
    toks = kern[2]
    plain_spans: list = []
    with wrapped(ca, "attention_stacked_fwd_cuda",
                 lambda f: event_timed(plain_spans)(ca.flash_attention_stacked_plain)):
        plain = greedy_logits(model, ctx_t, max_len, feed=toks)
    no_mask = lambda q3, kv3, mask, kv_len=None, **kw: ca.flash_attention_stacked_plain(
        q3, kv3, None, **kw)
    with wrapped(ca, "attention_stacked_fwd_cuda", lambda f: no_mask):
        broken = greedy_logits(model, ctx_t, max_len, feed=toks)
    check(ca.stacked_launches == launches["attention_stacked"] + 24 * (GREEDY_STEPS + 1),
          "the plain runs launched K3")
    plain_prefill_ms, n_plain_dec, plain_decode_ms = split_spans(plain_spans)
    gap = logits_gap(kern, plain)
    nm_gap = logits_gap(broken, plain)
    diff, nm_diff = max(gap.values()), max(nm_gap.values())
    same_argmax = (kern[1].argmax(-1) == plain[1].argmax(-1)).float().mean().item()
    logits_max = max(plain[0].abs().max().item(), plain[1].abs().max().item())
    del kern, plain, broken

    best = {g: min(times[g]) for g in GROVER_GENS}
    per_tok = (best[hi] - best[lo]) / (hi - lo)
    result = {"params": n_params, "init_s": init_s, "batch": GROVER_BATCH,
              "prefix": GROVER_PREFIX, "gens": list(GROVER_GENS),
              "run_seconds": {str(g): times[g] for g in GROVER_GENS},
              "decode_tokens_per_s": GROVER_BATCH / per_tok,
              "decode_ms_per_step": 1e3 * per_tok,
              "prefill_ms": 1e3 * statistics.median(prefill_s),
              "prefill_ms_runs": [1e3 * x for x in prefill_s],
              "launches": launches,
              "k3_launches_prefill": k3_pre["launches"],
              "k3_launches_per_decode_step": k3_dec["launches"] / (lo - 1),
              "k3_prefill_ms": k3_prefill_ms,
              "k3_event_ms_per_decode_step": k3_decode_ms / (hi - 1),
              "k3_device_ms_per_decode_step": k3_dec["ms"] / (lo - 1),
              # the bound of the profiled steps: 24 launches at the live
              # length of each (the token at position p reads p + 1 slots)
              "k3_bound_ms_per_decode_step": statistics.mean(
                  24 * stacked_bound(GROVER_BATCH, 1, GROVER_PREFIX + lo, p, torch.bfloat16)[0]
                  for p in range(GROVER_PREFIX, GROVER_PREFIX + lo - 1)),
              "k3_prefill_device_ms": k3_pre["ms"],
              "plain_prefill_ms": plain_prefill_ms,
              "plain_event_ms_per_decode_step": plain_decode_ms / n_plain_dec * 24,
              "profile": {k: v for k, v in prof.items() if k != "top_kernels"},
              "fp32_generation_s": fp32_s,
              "logits_max_abs_diff_vs_plain": gap,
              "logits_max_abs": logits_max,
              "argmax_agreement_vs_plain": same_argmax,
              "no_mask_logits_max_abs_diff": nm_gap,
              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"[grover] {json.dumps(result)}", flush=True)
    check(diff <= GROVER_LOGIT_TOL, f"K3 vs plain logits: {diff} > {GROVER_LOGIT_TOL}")
    check(nm_diff > GROVER_LOGIT_TOL,
          f"dropping the mask moves the logits by only {nm_diff}: the comparison "
          "cannot see it")
    del model, samplers
    torch.cuda.empty_cache()
    return result


def server_phase(dev, log_path: Path) -> dict:
    """The port's denoise server with its defaults, answering concurrent
    requests over HTTP on 127.0.0.1."""
    import threading
    import urllib.request
    import torch
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.tools.denoise_server import (DenoiseHTTPServer, Denoiser,
                                                       make_handler)

    t0 = time.perf_counter()
    den = Denoiser(str(ROOT / "configs" / "grover_medium.json"), None, max_len=1537,
                   top_p=0.94, bf16=True, max_batch=8, device=dev)
    init_s = time.perf_counter() - t0
    batch_s, batch_sizes = [], []
    run_batch = den.run_batch

    def timed_run_batch(ctxs, eos):
        t = time.perf_counter()
        out = run_batch(ctxs, eos)
        batch_s.append(time.perf_counter() - t)
        batch_sizes.append(len(ctxs))
        return out
    den.run_batch = timed_run_batch
    log_path.unlink(missing_ok=True)
    server = DenoiseHTTPServer(("127.0.0.1", 0), make_handler(den, str(log_path)))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers, errors = [None] * SERVER_REQUESTS, []

    def ask(i):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/ask",
                data=json.dumps({"noisyasr": SERVER_TEXTS[i]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                answers[i] = json.loads(resp.read())
        except Exception as e:
            errors.append(repr(e))

    try:
        ca.launches = ca.bwd_launches = ca.stacked_launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(SERVER_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall_s = time.perf_counter() - t0
        launches = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches,
                    "attention_stacked": ca.stacked_launches}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    records = log_path.read_text().strip().splitlines() if log_path.exists() else []
    result = {"init_s": init_s, "requests": SERVER_REQUESTS, "wall_s": wall_s,
              "batch_seconds": batch_s, "batch_sizes": batch_sizes,
              "stats": stats, "launches": launches, "log_records": len(records),
              "answers": [None if a is None else {"gen_chars": len(a["gen"]), "ppl": a["ppl"]}
                          for a in answers],
              "errors": errors}
    print(f"[server] {json.dumps(result)}", flush=True)
    check(not errors, f"server: {errors}")
    for a in answers:
        check(a is not None and isinstance(a["gen"], str)
              and isinstance(a["ppl"], float) and math.isfinite(a["ppl"]),
              f"server: bad answer {None if a is None else a['ppl']}")
    check(stats["batched_requests"] == SERVER_REQUESTS and stats["mean_batch"] > 1,
          f"server: requests not coalesced {stats}")
    check(len(records) == SERVER_REQUESTS, f"server: {len(records)} log records")
    check(launches["attention_stacked"] > 0 and launches["attention_stacked"] % 24 == 0
          and launches["attention_fwd"] == launches["attention_bwd"] == 0,
          f"server: launches {launches}")
    del den
    torch.cuda.empty_cache()
    return result


def kernel_records(k1_rows, k2_rows, k3_rows, k4_rows, k5_rows, sl, tr, fsl, ftr, fprof,
                   gv, sv, fd) -> list[dict]:
    """The kernels line: one record per kernel from the phases' results;
    fd: the first-design phase's per-path times, or None (then the
    first_design_ms fields are null)."""
    first = {k: fd["per_path"][k]["first_design_ms"] if fd else None
             for k in ("k1_zero_shot_batch", "k1_train_step", "k2_train_step", "k3_prefill",
                       "k3_decode_step", "k4_train_step", "k4_zero_shot_batch",
                       "k5_train_step", "k5_zero_shot_batch")}
    # per zero-shot batch (12 launches at each zero-shot shape), as ms and
    # plain_ms are
    zs = {r["shape"]: r for r in k1_rows}
    k1_bound = [zs[n]["bound_ms"] for n in ("zeroshot_vit", "zeroshot_joint")]
    k1_record = {
        "name": "attention_fwd", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "merlot_tpu/ops/pallas_attention.py:273",
        "launches": sl["launches"] + tr["launches"]["attention_fwd"],
        "launches_by_path": {"zero_shot": sl["launches"],
                             "train": tr["launches"]["attention_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        # per zero-shot batch on the main path (24 launches), median over
        # the batches: the kernel, and the plain attention in the same
        # model's plain run
        "ms": sl["k1_ms"], "plain_ms": sl["plain_attention_ms"],
        "bound_ms": 12 * sum(k1_bound),
        "bound_by": zs["zeroshot_vit"]["bound_by"],
        "library_ms": 12 * (zs["zeroshot_vit"]["library_ms"]
                            + zs["zeroshot_joint"]["library_ms"]),
        # the first design (per-call sums, 12 launches per shape), and the
        # same sum of this run's per-call times beside it
        "first_design_ms": first["k1_zero_shot_batch"],
        "shape_sum_ms": 12 * (zs["zeroshot_vit"]["ms"] + zs["zeroshot_joint"]["ms"]),
        # per train step: the path's CUDA events, the first design, the
        # library (SDPA at the ViT and joint shapes; lang has no single
        # call) and the bound over the three shapes
        "train_ms_per_step": tr["k1_ms"],
        "train_first_design_ms": first["k1_train_step"],
        "train_library_ms": 12 * (zs["pretrain_vit"]["library_ms"]
                                  + zs["pretrain_joint"]["library_ms"]),
        "train_bound_ms": 12 * sum(zs[n]["bound_ms"] for n in
                                   ("pretrain_vit", "pretrain_joint", "pretrain_lang"))}
    # per train step (12 launches at each pretrain shape)
    tb = {r["shape"]: r for r in k2_rows}
    train_shapes = ("pretrain_vit", "pretrain_joint", "pretrain_lang")
    k2_record = {
        "name": "attention_bwd", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "merlot_tpu/ops/pallas_attention.py:504",
        "launches": tr["launches"]["attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": tr["k2_ms"], "plain_ms": tr["plain_k2_ms_per_step"],
        "bound_ms": 12 * sum(tb[n]["bound_ms"] for n in train_shapes),
        "bound_by": tb["pretrain_vit"]["bound_by"],
        "library_ms": 12 * sum(tb[n]["library_ms"] for n in train_shapes),
        "first_design_ms": first["k2_train_step"],
        "shape_sum_ms": 12 * sum(tb[n]["ms"] for n in train_shapes),
        "library_note": "backward of scaled_dot_product_attention: fp32 softmax, "
                        "no colsum cotangent; not the same rounding"}
    # per decode step on the Grover path: 24 launches at its shape (B=8,
    # Sk=1216, kv_len 1101), the kernel, the plain version, SDPA and the
    # bound (live slots) all from the K3 phase's timing of that shape (the
    # path's own CUDA-event spans include the host's gaps between launches);
    # K3's device time on the path, from the profile of the 32-token
    # generation, beside the bound of that generation's own decode steps
    k3 = {r["shape"]: r for r in k3_rows}["decode_b8_bf16_bench"]
    pre = {r["shape"]: r for r in k3_rows}["prefill_b8_bf16"]
    k3_record = {
        "name": "attention_stacked", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/attention_stacked.cu",
        "replaces": "merlot_tpu/ops/pallas_attention.py:656",
        "launches": gv["launches"]["attention_stacked"]
        + sv["launches"]["attention_stacked"],
        "launches_by_path": {"grover_decode": gv["launches"]["attention_stacked"],
                             "server": sv["launches"]["attention_stacked"]},
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
        "ms": 24 * k3["ms"], "plain_ms": 24 * k3["plain_ms"],
        "bound_ms": 24 * k3["bound_ms"], "bound_by": k3["bound_by"],
        "bound_whole_cache_ms": 24 * k3["bound_whole_cache_ms"],
        "library_ms": 24 * k3["library_ms"], "library_live_ms": 24 * k3["library_live_ms"],
        "first_design_ms": first["k3_decode_step"],
        "path_device_ms": gv["k3_device_ms_per_decode_step"],
        "path_bound_ms": gv["k3_bound_ms_per_decode_step"],
        "unit": "per decode step: 24 launches at B=8, Sq=1, Sk=1216, kv_len 1101, bf16; "
                "path_*: the profiled 32-token generation (Sk=1056, kv_len 1025-1055)",
        # the prefill (K1's tiles): per prefill of 24 launches at B=8,
        # Sq=1024, Sk=1537, bf16, from the K3 phase's timing
        "prefill_first_design_ms": first["k3_prefill"],
        "prefill_ms": 24 * pre["ms"], "prefill_plain_ms": 24 * pre["plain_ms"],
        "prefill_library_ms": 24 * pre["library_ms"],
        "prefill_bound_ms": 24 * pre["bound_ms"], "prefill_bound_by": pre["bound_by"],
        "prefill_path_device_ms": gv["k3_prefill_device_ms"]}
    # per train step: the 54 GroupNorm sites and the 72 LayerNorm+matmul
    # sites (12 layers x 2 in each tower). "ms" is the kernel's device time
    # on the fused path (torch.profiler over two steps, halved), "event_ms"
    # CUDA events around its launches on the path (median of the timed
    # steps), the others sums over the sites of the per-shape times; the
    # zero_shot_* fields the same per fused zero-shot batch (54 K4 and 48
    # K5 launches), the path's time from CUDA events
    gn = {r["shape"]: r for r in k4_rows}
    gn_path = lambda frames, key: sum(spec[5] * gn[spec[0]][key] for spec in GN_SHAPES
                                      if spec[1] == frames)
    train_frames, zs_frames = TRAIN_BATCH * TRAIN_CHUNKS, 2 * STORIES * CHUNKS
    for frames, n in ((train_frames, FUSED_LAUNCHES_PER_STEP[2]),
                      (zs_frames, FUSED_LAUNCHES_PER_BATCH[1])):
        check(sum(spec[5] for spec in GN_SHAPES if spec[1] == frames) == n,
              f"the GroupNorm shapes of {frames} frames do not cover the path's sites")
    k4_record = {
        "name": "groupnorm", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/groupnorm.cu",
        "replaces": "merlot_tpu/ops/pallas_groupnorm.py:151",
        "launches": fsl["launches"]["groupnorm"] + ftr["launches"]["groupnorm"],
        "launches_by_path": {"zero_shot_fused": fsl["launches"]["groupnorm"],
                             "train_fused": ftr["launches"]["groupnorm"]},
        "max_abs_err": max(r["max_abs_err"] for r in k4_rows),
        "ms": fprof["families"]["K4 groupnorm"]["ms"] / 2, "event_ms": ftr["k4_ms"],
        "plain_ms": gn_path(train_frames, "plain_ms"),
        "bound_ms": gn_path(train_frames, "bound_ms"), "bound_by": gn["stem_c64"]["bound_by"],
        "library_ms": gn_path(train_frames, "library_ms"),
        "shape_sum_ms": gn_path(train_frames, "ms"),
        "first_design_ms": first["k4_train_step"],
        "zero_shot_ms_per_batch": fsl["k4_ms"],
        "zero_shot_shape_sum_ms": gn_path(zs_frames, "ms"),
        "zero_shot_first_design_ms": first["k4_zero_shot_batch"],
        "zero_shot_plain_ms": gn_path(zs_frames, "plain_ms"),
        "zero_shot_bound_ms": gn_path(zs_frames, "bound_ms"),
        "zero_shot_library_ms": gn_path(zs_frames, "library_ms"),
        "library_note": "F.group_norm on the NCHW view, + add, ReLU: not the same rounding",
        "unit": "per train step: 54 launches over 13 shapes, 128 frames, bf16"}
    ln = {r["shape"]: r for r in k5_rows}
    ln_path = lambda prefix, key: 12 * sum(ln[spec[0]][key] for spec in LN_SHAPES
                                           if spec[0].startswith(prefix))
    k5_record = {
        "name": "ln_matmul", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/ln_matmul.cu",
        "replaces": "merlot_tpu/ops/pallas_ln_matmul.py:117",
        "launches": fsl["launches"]["ln_matmul"] + ftr["launches"]["ln_matmul"],
        "launches_by_path": {"zero_shot_fused": fsl["launches"]["ln_matmul"],
                             "train_fused": ftr["launches"]["ln_matmul"]},
        "max_abs_err": max(r["max_abs_err"] for r in k5_rows),
        "ms": fprof["families"]["K5 ln_matmul"]["ms"] / 2, "event_ms": ftr["k5_ms"],
        "plain_ms": ln_path("pretrain", "plain_ms"),
        "bound_ms": ln_path("pretrain", "bound_ms"),
        "bound_by": ln["pretrain_vit_qkv"]["bound_by"],
        "library_ms": ln_path("pretrain", "library_ms"),
        "shape_sum_ms": ln_path("pretrain", "ms"),
        "first_design_ms": first["k5_train_step"],
        "zero_shot_ms_per_batch": fsl["k5_ms"],
        "zero_shot_shape_sum_ms": ln_path("zeroshot", "ms"),
        "zero_shot_first_design_ms": first["k5_zero_shot_batch"],
        "zero_shot_plain_ms": ln_path("zeroshot", "plain_ms"),
        "zero_shot_bound_ms": ln_path("zeroshot", "bound_ms"),
        "zero_shot_library_ms": ln_path("zeroshot", "library_ms"),
        "library_note": "F.layer_norm then one F.linear over the J weights: two calls, "
                        "not the same rounding",
        "unit": "per train step: 72 launches, 12 layers x (q/k/v, MLP) x 3 towers, K=768, bf16"}
    return [k1_record, k2_record, k3_record, k4_record, k5_record]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the run's details to this JSON file")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of the first designs' commit (83510f1): time them "
                         "against the current K1-K5 (first_design phase)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from merlot_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    libs = ("attention_fwd", "attention_bwd", "attention_stacked", "groupnorm", "ln_matmul")
    t0 = time.perf_counter()
    _build.build_libraries(libs)
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(libs)} in {build_s:.1f}s", flush=True)
    for name in libs:
        print(_build.build_logs.get(name, ""), flush=True)

    k1_rows = kernel_phase(dev)
    k2_rows = bwd_kernel_phase(dev)
    k3_rows = stacked_phase(dev)
    k4_rows = gn_kernel_phase(dev)
    k5_rows = ln_kernel_phase(dev)
    ab_rows = ablation_phase(dev)
    fd = first_design_phase(dev, args.parent) if args.parent else None
    sl, *zero_shot = slice_phase(dev)
    fsl = fused_slice_phase(dev, *zero_shot)
    del zero_shot
    tr, model, state, step, batch, ref = train_phase(dev)
    prof = profile_steps(dev, step, model, state, batch)
    del model, state, step, batch
    torch.cuda.empty_cache()
    ftr, fprof = fused_train_phase(dev, ref)
    del ref
    torch.cuda.empty_cache()
    ab = ab_phase(dev)
    gv = grover_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        sv = server_phase(dev, Path(tmp) / "denoise_log.jsonl")

    records = kernel_records(k1_rows, k2_rows, k3_rows, k4_rows, k5_rows, sl, tr, fsl,
                             ftr, fprof, gv, sv, fd)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernel_shapes": k1_rows,
             "bwd_kernel_shapes": k2_rows, "stacked_kernel_shapes": k3_rows,
             "groupnorm_kernel_shapes": k4_rows, "ln_matmul_kernel_shapes": k5_rows,
             "slice": sl, "fused_slice": fsl, "train": tr, "profile": prof,
             "fused_train": ftr, "fused_profile": fprof, "train_ab": ab,
             "grover": gv, "server": sv, "ablation": ab_rows,
             "first_design": fd,
             "records": records,
             "ptxas": {n: _build.build_logs.get(n, "") for n in libs}},
            indent=1))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
