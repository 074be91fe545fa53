#!/usr/bin/env python3
"""GPU drive of the PyTorch port (merlot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out details.json] [--parent DIR]
    python3 chip_smoke.py --dispatch-cost [--out details.json]

1. builds the kernels from csrc/ with nvcc, one process per source, all
   in parallel, then links each library: K1 (attention forward), K2
   (backward), K3 (the stacked KV cache), K4 (fused GroupNorm) and K5
   (LayerNorm fused into matmuls); K1's tiled launch and its fp32 route are
   sources of their own that K1's, K2's and K3's libraries share, and K2's
   fp32 route one of its own (each compile's and link's seconds are
   printed and kept in --out);
2. K1 phase: holds K1 against its plain PyTorch version at the two
   zero-shot shapes (fp32 softmax), the three pretrain shapes (bf16
   softmax) and VCR's four (fp32 softmax: the ViT at 16 x 1058 and the
   joint tower at 64 x 449 in a train step, 8 x 1058 and 32 x 449 in an
   eval batch), all in bf16, and Grover training's (8 x 1536, 16 heads,
   fp32 inputs and softmax, a causal mask: the fp32 route, whose fault
   probe is the mask dropped) with four fp32 probes (padded rows, a
   block-sparse mask, a ragged S of 1000, a head dim of 40 with the
   colsum), holds the saved row max and sum against the plain version's,
   and times K1, the plain version and, as a yardstick, torch's
   scaled_dot_product_attention, beside the least time the card could
   take (bound);
3. K2 phase: the same for K2 at the three pretrain shapes in bf16 softmax,
   the pretrain joint shape in fp32 softmax, VCR's train-step two and
   Grover training's fp32 causal shape (the mask dropped as its probe), with
   padded rows in the masks and a nonzero colsum cotangent at the lang
   shape; each shape
   also shows that its check sees a fault (the other softmax mode; at the
   lang shape, the missing colsum cotangent) and that dQ is exactly 0 on
   fully masked rows; the fp32 probes as for K1; K2 fed K1's saved row max
   and sum (and in fp32 its tile classes) must equal K2 computing them
   itself, and two runs must agree bit for bit;
3a. ablation phase: K1's probe at the three pretrain shapes (the kernel,
   its fp32 softmax, the softmax removed, the pass for the row max and sum
   skipped, and SDPA), timed in turns; with ``--parent DIR`` (a checkout of
   commit 83510f1, which holds the first designs of K1, K2, K3, K4 and K5)
   those designs are built from DIR and timed in turns with the current
   kernels at every shape (K3's decode over rotating copies, its launches
   queued), with per-path totals, and at Grover training's fp32 shape
   (PR 2's fp32 route, unchanged until the redesign) beside SDPA and the
   plain versions;
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
   exceeds it; then torch.profiler over one more step gives the device
   time by kernel family and the device's idle share;
5b. fused train phase: the train step with both fused norms on: 36 K1,
   36 K2, 54 K4 and 72 K5 launches per step, segments/s, K4 and K5 ms per
   step, peak memory, the loss falling; one step's loss and grads against
   the unfused kernel step's at its weights and masking (a K4 backward
   without the ReLU mask and a K5 backward without dgamma must exceed the
   bounds), and torch.profiler over one step; then the A/B: unfused and
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
8. server phase: the seed weights the server draws (grover-medium, fp32,
   seed 0) go through the checkpoint tools: named as the reference's TF
   variables (the inverse of grover_tf_name_map), converted
   (convert_arrays) and written (save_params_checkpoint) as a params-only
   checkpoint; the Denoiser loading its params.npz (--ckpt) must give
   the seed-weight Denoiser's greedy logits on one context bit for bit,
   with 24 K3 launches per prefill and per decode step. That Denoiser in
   the port's DenoiseHTTPServer on 127.0.0.1 with the server's defaults
   (top_p 0.94, --bf16, max_batch 8) but for max_len and the batching
   window (SERVER_MAX_LEN, SERVER_WINDOW_MS) answers 4 concurrent POST
   /api/ask, coalesced (/stats mean_batch > 1), with 4 JSONL records and
   the seconds per batch;
9. CLI phase: the pretraining entry point from tfrecords at full
   pretrain_4seg width. The machine's JPEG route (libjpeg, else pil) is
   held against the committed fixture bit for bit, nvJPEG (asked for by
   name) within its bounds, and a CMYK JPEG decodes through each as PIL
   decodes it; the port's writer makes 16 training
   and 16 validation examples of 16 chunks, 512x288 frames of smooth noise;
   a copy of configs/pretrain_4seg.yaml changes only CLI_REDUCED's keys and
   the paths. The loader alone is timed at the config's num_threads and at
   the cores it gets, there with the default JPEG route and nvJPEG in
   turns, and device_iterator's batches on the card are held
   against their host batches element for element. Run A is `python -m
   merlot_tpu_torch.train.pretrain a.yaml` in a subprocess (8 steps,
   checkpoints at 4 and 8, two evaluation batches), between two runs of
   the synthetic-batch step; run B is pretrain.main in this process from
   A's ckpt_4 with the kernels' counters (36 K1 and 36 K2 launches per
   step) and torch.profiler over one step, retaken over the next if it
   lost records (the device's idle share). B
   must resume at step 4, its losses and step-8 parameters must match A's
   and A's ckpt_8, loaded by convert.load_flax_params into a fresh model,
   must reproduce A's evaluation loss, within the tolerances at the top;
   segments/s through the CLI, checkpoint seconds and bytes are printed;
10. zero-shot CLI phase: the port's writer makes 1 synthetic story in
   all 120 orderings (600x800 frames); a fresh pretrain_5seg-width
   MerlotPretrainModel (seed 0) goes through the checkpoint tools: its
   weights named as the released TF checkpoints name them (the inverse of
   merlot_tf_name_map), converted (convert_arrays) and written
   (save_params_checkpoint) as the params-only checkpoints/ckpt_0; `python -m
   merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits zs.yaml`
   (a copy of configs/pretrain_5seg.yaml with data.num_chunks 5 and
   val_batch_size 2) runs in a subprocess and its .npz is scored; the same
   loader batches through make_zero_shot_fn in this process, on the model
   object itself (never written), must give the CLI's probs bit for bit,
   with 24 K1 launches per batch; fault probes (two of the first joint
   layer's kernels swapped among the TF arrays before converting,
   ZS_CLI_SWAPS) must move the first batch's probs: query and key at all,
   query and value past SLICE_TOL; stories/s is printed beside the
   zero-shot phase's;
11. VCR phase: configs/vcr_finetune.yaml's model block at full size
   (VCR_REDUCED lists the cuts) from synthetic shards built by the port's
   build_vcr_example (draw_grounding overlays on 540x960 frames):
   run A (`python -m merlot_tpu_torch.downstream.vcr.train a.yaml`,
   warm-started from a fresh pretrain_4seg-width checkpoint, 8 steps,
   checkpoints at 4 and 8), run B (in process from A's ckpt_4, with the
   counters: 24 K1 and 24 K2 per step, and a profile of one step) whose
   losses at steps 5-8 must equal A's; one step's loss through the
   kernels against the plain attention (the loss with the joint mask
   dropped in the forward is reported: it barely moves), and the grads of
   a random projection of the logits (the VCR loss's own grads cancel
   over the 4 choices: reported; a backward without the mask must fail
   the bound); A's ckpt_8
   evaluated in both modes (24 K1 per
   eval batch, kernel logits against plain, the joint mask dropped must
   fail the bound), and the eval sidecar's poll until its timeout, having
   logged both checkpoints. Prints train and eval examples/s, peak memory,
   B's idle share and K1/K2 ms per step.
12. Grover training phase: configs/grover_medium.json as it is (24 x 1024
   x 16 heads, fp32) from a seeded synthetic LM shard (the port's
   write_lm_shard; padded rows, is_target on each row's tail): run A
   (`python -m merlot_tpu_torch.tools.grover_train` at its defaults of
   batch 8 x 1536; GT_REDUCED lists the cuts: 8 steps, checkpoints at 4
   and 8), run B (in process from A's ckpt_4, with the counters: 24 K1 and
   24 K2 per step) whose losses at steps 5-8 must equal A's; one step's
   loss and grads through the kernels against the plain attention at full
   depth and batch 2, with the causal mask dropped on the kernel side
   failing both bounds; a profile of one more step of B's step function;
   A's ckpt_8 served by the port's
   Denoiser (fused qkv, stacked cache: K3's prefill) against the trained
   model's forward (K1); with ``--parent``, the step's forward and backward
   at the full batch through the first design's fp32 K1/K2 and the
   current ones in turns. Prints tokens/s, peak memory, the step's share of
   the fp32 peak, the profiled steps' idle share and K1/K2 ms per step.
13. corpus phase: 5 synthetic 1280x720 videos (cv2, black bars around a
   16:9 box) with their .grover.json through `python -m
   merlot_tpu_torch.data.process` into one shard, whose stored frames must
   all be 512x288; then pretrain.main on it for 2 steps with a copy of the
   CLI phase's reduced pretrain_4seg.yaml (36 K1 and 36 K2 per step,
   finite losses). Prints the frame route, videos/s and chunks/s.

14. data_parallel phase: the entry points as rank 0 of a world of one
   (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT set, each in a
   subprocess that joins an NCCL process group; none is left in this
   process): the pretraining CLI with use_zero1 on the CLI phase's config
   copy and shards for its first 4 steps (a checkpoint at 4), whose
   every metric must equal run A's at those steps and whose ckpt_4 must
   equal A's file for file, 36 K1 and 36 K2 per step; its ZeRO-1 ckpt_4
   restored by a run of no process group; the fault probe (the first
   step's loss with the mask loss's denominator summed twice must differ
   from A's); VCR with use_zero1 for 2 steps against VCR run A (24/24 per
   step); the zero-shot CLI, whose .npz must equal the CLI phase's bit for
   bit (24 K1 per batch); the VCR and zero-shot ranks run side by side.
   Prints segments/s beside run A's.
15. tensor_parallel phase: the model axis at model=2 as two ranks that share
   the card over gloo (TP_RANKS's comment; NCCL refuses two ranks on one
   device): pretrain_4seg at full width and depth, TP_STEPS steps with
   dropout and masking on, each loss and step 1's gathered gradients held
   against one process at model=1 from the same seed (the train phase's
   bounds), 36 K1 and 36 K2 per step per rank, a fault probe (a
   row-parallel all-reduce left out) that must fail them; then the Grover
   server at grover-medium, --tp 2, bf16 and fp32: ``Denoiser.run_batch``'s
   prefill and decode logits against --tp 1, 24 K3 per prefill and per
   decode step per rank. Prints segments/s and decode tokens/s beside the
   one-process runs. The kernel phases also hold K1 and K2 at 6 heads, K3
   at 8 and K5 at this rank's columns against their plain versions.
16. pipeline_parallel phase: the stage axis at pp=2 as two ranks that share
   the card over gloo (PP_STAGES's comment): grover-medium at full width
   and depth, fp32, 8 x 1536 in 8 microbatches of 1 row (96 K1 and 96 K2
   per step per rank, the fp32 routes under the causal mask); with dropout
   off PP_STEPS steps against one process at --pp 1 from the same seed
   (each loss within GT_LOSS_RTOL, step 1's gathered gradients within
   GT_GRAD_TOL, the Grover phase's bounds), a probe (the tied word_embed's
   gradient not summed over the end stages) that must fail them; then
   ``grover_train --pp 2`` as torchrun starts it (dropout on, 3 steps, a
   checkpoint at 2), resumed from ckpt_2 to step 3 bit for bit, the
   checkpoint in JAX's stages/ form [2, 12, ...], served by the Denoiser
   through K3 against the trained ranks' forward. Prints tokens/s of the
   slower rank beside one process, peak memory per rank, the hops' time
   and the bubble's share. The kernel phases hold K1 and K2 at the
   microbatch's shape (1 x 1536, 16 heads, fp32, causal).
17. remat_and_cross phase (after the fused train phase, on its weights):
   per-layer remat at pretrain_4seg's full width and depth, bench.py's
   batch, hidden dropout on from one generator seed: remat off, None,
   'dots', 'probs', 'probs_dots', and the fused configuration off and under
   None, each a warm-up and REMAT_STEPS timed forward+backward runs held
   bit for bit against its run without remat (loss, masked positions,
   every grad, the generator's state), with K1/K2/K4/K5 launches per step
   (K1 72 under None and 'dots', 36 under 'probs'), step ms and peak memory;
   the probe (the recompute drawing new dropout masks) must fail the
   grads' bound. K1 and K2 at cross-attention's shape (8 x 256 queries over
   396 keys, a rectangular validity mask) and K1 at the encoder cache's
   decode step (8 x 1 over 512 slots) against their plain versions, timed
   beside SDPA and the bound; then a 12-layer encoder at the joint tower's
   width: cross-attention's forward and backward through K1/K2 against the
   plain attention (the mask dropped must fail), and 64 tokens decoded one
   at a time into the cache after a 448-token prefix (K1 at Sq = 1), held
   against the full causal forward and the plain decode (the future slots
   attended must fail).

Prints the card's name and power limit early, one JSON line of kernel
records before the last line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
``--out`` writes the per-shape details, the phase numbers, the profile
and the ptxas reports to a JSON file. ``--dispatch-cost`` runs only the
cost of K1's and K5's forwards going through their dispatcher ops
(``dispatch_cost_phase``) and prints its JSON. Any
failed check raises, so the script exits non-zero; without a CUDA card it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
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
# lang: 8 rows of 16*32 tokens), then VCR's train step at batch 8
# (configs/vcr_finetune.yaml, fp32 softmax; ViT: 16 frames of 384x704,
# 24*44 + 2 tokens, the last 64-key tile ragged at 34; joint: 64 rows of
# 12*22 + 1 vision and 184 text tokens) and its eval batch of 8 (one mode:
# 8 frames, 32 joint rows)
PRETRAIN_SHAPES = [
    ("pretrain_vit", 128, 266, False, False, False),
    ("pretrain_joint", 32, 396, True, False, False),
    ("pretrain_lang", 8, 512, True, True, False),
]
VCR_SHAPES = [
    ("vcr_vit", 16, 1058, False, False, True),
    ("vcr_joint", 64, 449, True, False, True),
]
VCR_EVAL_SHAPES = [
    ("vcr_eval_vit", 8, 1058, False, False, True),
    ("vcr_eval_joint", 32, 449, True, False, True),
]
ATTN_SHAPES = [
    ("zeroshot_vit", 20, 578, False, False, True),
    ("zeroshot_joint", 4, 885, True, False, True),
] + PRETRAIN_SHAPES + VCR_SHAPES + VCR_EVAL_SHAPES
# K2's shapes: the three pretrain shapes, the joint one in fp32 softmax, and
# VCR's two
BWD_SHAPES = (PRETRAIN_SHAPES + [("pretrain_joint_fp32sm", 32, 396, True, False, True)]
              + VCR_SHAPES)
# Grover training's attention (tools/grover_train.py's defaults at
# configs/grover_medium.json): batch 8 x seq 1536, 16 heads of 64, fp32
# inputs and softmax, the causal mask [B, S, S]; K1's and K2's FMA routes.
# (name, batch, seq, masked, colsum, softmax_fp32, heads, dtype)
GROVER_TRAIN_SHAPES = [("grover_train", 8, 1536, "causal", False, True, 16, "fp32")]
# the fp32 route's probes beside Grover's shape (csrc/attention_fp32.cuh
# skips the mask's all-0 64 x 64 tiles): padded rows and keys (fully
# masked rows: their q tiles skip nothing), 64 x 64 blocks kept on the
# diagonal and at random (all-0 tiles beside rows that attend), a ragged S
# of 1000, and a head dim of 40 with the colsum on. (name, batch, seq,
# masked, colsum, softmax_fp32, heads, dtype, head dim)
FP32_PROBE_SHAPES = [
    ("fp32_padded", 2, 1000, True, False, True, 4, "fp32", 64),
    ("fp32_block_sparse", 2, 1024, "block", False, True, 4, "fp32", 64),
    ("fp32_causal_s1000", 2, 1000, "causal", False, True, 4, "fp32", 64),
    ("fp32_d40_colsum", 2, 1000, "causal", True, True, 4, "fp32", 40),
]
# fp32 inputs against the plain version: the same fp32 arithmetic, sums
# perhaps in another order; the largest error over the largest |ctx|
# (|grad|). On the H100 K1's ctx equalled the plain version's bit for bit
# and K2's grads were within 1.9e-7 of the largest, so FP32_GRAD_RTOL is
# 5.4x that. For fp32 inputs both softmax modes are fp32, so the fault
# probe is the mask dropped: it moved ctx by 1.0 of the largest |ctx| and
# the grads by 1e5 times the bound
FP32_CTX_RTOL = 1e-6
FP32_GRAD_RTOL = 1e-6
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
AB_WARMUP, AB_STEPS = 2, 2
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

# remat_and_cross phase. Per-layer remat at pretrain_4seg's full width and
# depth, bench.py's batch, one forward and backward with hidden dropout on
# (one generator seed) per case: (name, remat, remat_policy, fused norms).
# Each case is held against its run without remat (the unfused or the
# fused one): the loss, the masked positions and every grad bit for bit,
# since the recompute runs the same deterministic kernels on the same
# inputs; the grads also within TRAIN_GRAD_TOL (grad_gap), which the
# recompute without the dropout masks replayed must exceed
REMAT_CASES = [
    ("off", False, None, False), ("none", True, None, False), ("dots", True, "dots", False),
    ("probs", True, "probs", False), ("probs_dots", True, "probs_dots", False),
    ("fused_off", False, None, True), ("fused_none", True, None, True)]
# K1/K2/K4/K5 launches per step: K1 runs again in every layer's recompute
# unless the policy keeps its outputs ('probs', 'probs_dots'), and so does
# K5 in the fused configuration under None; K4 sits in the stem, outside
# the checkpointed layers
REMAT_LAUNCHES = {"off": (36, 36, 0, 0), "none": (72, 36, 0, 0), "dots": (72, 36, 0, 0),
                  "probs": (36, 36, 0, 0), "probs_dots": (36, 36, 0, 0),
                  "fused_off": (36, 36, 54, 72), "fused_none": (72, 36, 54, 144)}
REMAT_SEED = 7
REMAT_STEPS = 3        # timed runs per case, after one warm-up
# cross-attention and the encoder cache at the joint encoder's width (12
# layers x 768, 12 heads, bf16, the bf16 softmax of pretrain_4seg):
# queries B 8 x Sq 256 on an encoder source of Sk 396 (the joint tower's
# length) under a rectangular validity mask; decoding 64 tokens one at a
# time into max_len 512 after a 448-token cached prefix
CROSS_B, CROSS_SQ, CROSS_SK = 8, 256, 396
DECODE_B, DECODE_PREFIX, DECODE_LEN = 8, 448, 512
ENC_LAYERS = 12
# kernels vs plain versions through the 12-layer stack, and the cached
# decode against the full causal forward: the mean |difference| of the
# hidden states over their mean |value| (hidden_gap's mean_rel), and
# grad_gap of the grads. The bf16 stack passes one-ulp differences (fp32
# sums in another order in the attention, and in cuBLAS's products at
# other row counts: 8 rows a decode step against 4,096 in the full
# forward) on through the layers. Measured on one H100,
# cross-attention read 1.38e-3 against the mask dropped's 1.89e-2, its
# grads 0.025 against 0.82; the 64 decoded tokens 6.00e-3 from the full
# forward and 6.03e-3 from the plain decode, against 1.30e-2 with the
# future slots attended (at random init the attention is near uniform over
# ~480 live slots, so 63 zero slots more move it little). Each bound lies
# between the two, and each probe must exceed it
CROSS_HIDDEN_TOL = 5e-3
CROSS_GRAD_TOL = TRAIN_GRAD_TOL
DECODE_HIDDEN_TOL = 9e-3

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
GROVER_REPEATS = 1
GREEDY_STEPS = 8
# prefill + 8 argmax decode steps, K3 vs the plain attention fed the same
# tokens: the largest |logit difference| (fp32 logits of |x| up to ~4.3,
# bf16 activations through 24 layers). Measured 0.054 on the H100, so 2.8x
# margin; the mask-less plain run moves them by 0.56 (decode) and 2.7
# (prefill)
GROVER_LOGIT_TOL = 0.15
SERVER_REQUESTS = 4
# the server's max_len: 1537 by default; random weights never emit the eos,
# so each batch decodes to max_len (the decode kernel at 1537 slots is the K3
# phase's): cut to 512 for the script's time
SERVER_MAX_LEN = 512
# the batching window: 15 ms by default; the 4 requests' threads start
# within 100 ms, so they coalesce into one batch (on a slow host one of
# them missed 15 ms and a second batch decoded to max_len)
SERVER_WINDOW_MS = 100.0
# the converted weights' check: one context of this many tokens, a prefill
# and GREEDY_STEPS argmax decode steps
SERVER_CHECK_CTX = 64
SERVER_TEXTS = [
    "so today were gonna make pasta with a to mate sauce from scratch",
    "the whether tomorrow is gonna be sunny in the after noon they said",
    "first you wanna pre heat the oven two three fifty degrees okay",
    "and thats how you fix a flat tire on a bike real quick guys",
]

# the pretraining CLI phase: synthetic shards in the reference schema with
# frames of the size merlot_tpu/data/video.py stores for a 720p video
# (shorter side 288 under the 512 cap), and a copy of
# configs/pretrain_4seg.yaml with the keys of CLI_REDUCED changed (each
# listed under "reduced" in the phase's record; the model and optimizer
# blocks unchanged): bench.py's batch, 8 steps, checkpoints at 4 and 8,
# every step logged, two evaluation batches
CLI_EXAMPLES = 16           # training examples, and as many for validation
CLI_SHARDS = 2              # per split
CLI_FRAME_HW = (288, 512)
CLI_STEPS = 8
CLI_CKPT_EVERY = 4
CLI_VAL_BATCH = 8
CLI_EVAL_BATCHES = 2
CLI_REDUCED = {"train_batch_size": TRAIN_BATCH, "num_train_steps": CLI_STEPS,
               "iterations_per_loop": CLI_CKPT_EVERY, "log_every": 1,
               "val_batch_size": CLI_VAL_BATCH}
# run B's steps under torch.profiler, one profile per window: the idle
# share is read from the first window whose profile holds every K1/K2
# launch the wrappers counted in it (a profile now and then loses records)
CLI_PROFILE_WINDOWS = ((6,), (7,))
CLI_SYNTH_WARMUP, CLI_SYNTH_STEPS = 2, 2
CLI_FEED_STEPS = 2          # timed steps of each feed run, after two
CLI_LOADER_BATCHES = 2
CLI_SKIP_BATCHES = 10000    # batches a resumed loader passes over, timed
CLI_H2D_BATCHES = 3
CLI_TIMEOUT_S = 900
# nvJPEG against the fixture's libjpeg pixels, in levels of 255: its
# chroma upsampling is not libjpeg's fancy upsampling. On the H100 the
# 4:2:0 image read 20 max and 3.40 mean, the 4:2:2 one 9 and 2.39, the
# 4:4:4 one (no upsampling, the IDCT alone) 3 and 0.51
NVJPEG_MAX_ERR, NVJPEG_MEAN_ERR = 32, 5.0
# run B (resumed at step 4) against run A at steps 5-8: the largest
# relative loss gap, and the L2 gap of the step-8 parameters over the L2
# of A's parameter change from step 4 to 8; A's ckpt_8 loaded into a fresh
# model: its evaluation loss against A's. The step is deterministic on the
# H100 (K1 and K2 are; the embedding backward accumulates in index order),
# so all three are 0: every run so far read exactly 0
RESUME_LOSS_RTOL = 0.0
RESUME_PARAM_REL = 0.0
RELOAD_EVAL_RTOL = 0.0

# the zero-shot CLI phase: the port's writer makes ZS_CLI_STORIES synthetic
# stories, each in all 120 orderings, frames of uniform noise at VIST's
# thumbnail size (800 pixels on the long side); a copy of
# configs/pretrain_5seg.yaml with ZS_CLI_REDUCED's keys changed (one group
# of 5 is one story; the model block unchanged); a fresh model from seed 0
# written through the checkpoint tools as a params-only checkpoint
ZS_CLI_STORIES = 1
ZS_CLI_FRAME_HW = (600, 800)
ZS_CLI_BATCH = 2
ZS_CLI_REDUCED = {"num_chunks": CHUNKS, "val_batch_size": ZS_CLI_BATCH}
# The probes swap two same-shaped TF variables of the joint tower's first
# layer before converting. Query and key at random init (scores of std
# ~0.3 over ~885 keys: near-uniform attention, its matrix transposed) moved
# the probs by 4.1e-3 on an H100: seen by the CLI's bit-for-bit check,
# not past the kernel-vs-plain SLICE_TOL; query and value moved them by
# 0.044, past it.
ZS_CLI_SWAPS = {"query_key": ("encoder/layer00/query_layer/kernel",
                              "encoder/layer00/key_layer/kernel"),
                "query_value": ("encoder/layer00/query_layer/kernel",
                                "encoder/layer00/value_layer/kernel")}
# the VCR phase: a copy of configs/vcr_finetune.yaml with VCR_REDUCED's keys
# changed (each listed under "reduced"; the model block but for the
# warm-start path and the optimizer block but for num_train_steps
# unchanged): the reference's per-core batch (64 over a v3-8's 8 cores),
# 8 steps, checkpoints at 4 and 8, two evaluation batches, the sidecar's
# poll cut to seconds; synthetic shards from the port's build_vcr_example
VCR_BATCH = 8
VCR_STEPS = 8
VCR_CKPT_EVERY = 4
VCR_EVAL_BATCHES = 2
VCR_EVAL_TIMEOUT_S = 4
VCR_REDUCED = {"train_batch_size": VCR_BATCH, "num_train_steps": VCR_STEPS,
               "iterations_per_loop": VCR_CKPT_EVERY, "val_batch_size": VCR_BATCH,
               "eval_samples": VCR_EVAL_BATCHES * VCR_BATCH,
               "eval_timeout": VCR_EVAL_TIMEOUT_S}
VCR_TRAIN_EXAMPLES = 24     # 2 shards; 8 steps of 8 read 2.7 epochs
VCR_VAL_EXAMPLES = 16
VCR_FRAME_HW = (540, 960)   # larger than the 384x704 the loader pads to
# 12 layers in each of the ViT and the joint tower (VCR runs no lang-only
# tower), per train step and per eval batch
VCR_LAUNCHES_PER_STEP = 24
# VCR's step, kernels vs plain attention. The loss is ~ln 4 where the
# pretrain loss is ~11, so an absolute gap of the pretrain step's order
# (1.4e-4 on the H100) is 9.8e-5 of it; VCR_LOSS_RTOL is 4x that. At these weights the loss cannot see
# the attention: the forward with the joint mask dropped moved it by 2.2e-5
# (reported, not bounded). The VCR loss's grads cancel: the 4 choices of an
# image share its frame and context and sum(p - y) = 0 over them, so with
# the untrained heads' near-equal logits the net grad is ~1e-3 of each
# choice's and one-ulp bf16 differences move it by O(1) (grad_gap 1.51
# for the kernels, 2.51 for a backward without the mask: no bound between
# them means anything). Those grads are reported; the bound holds on the
# grads of sum(logits * r), r ~ N(0, 1) fixed, through the same forward
# and backward, which do not cancel: 0.050 for the kernels (a stem
# GroupNorm gamma), 1.91 for a backward without the mask, so
# TRAIN_GRAD_TOL sits 2.0x above the one and 19x below the other.
VCR_LOSS_RTOL = 4e-4
# eval logits, kernel vs plain attention at A's ckpt_8 (random pretrain
# weights, 8 VCR steps: the heads barely read their input, which damps the
# kernels' rounding and the fault alike): 2.27e-3 and 2.38e-3 on the H100,
# the joint mask dropped 7.25e-3 and 2.99e-2; VCR_LOGIT_TOL sits between
# (1.7x the kernels', 1.8x below the smaller fault)
VCR_LOGIT_TOL = 4e-3

# the Grover training phase: configs/grover_medium.json as it is (24 layers
# x 1024 x 16 heads, 355.9 M parameters, fp32: the JSON sets no
# use_bfloat16) under tools/grover_train.py's defaults for the data (seq
# 1536, batch 8: 12,288 tokens per step), the learning rate and the AdamW
# block; GT_REDUCED lists the cuts (CLI default -> the run's), all in the
# step counts. The data: GT_ROWS seeded synthetic rows in 2 shards from the
# port's write_lm_shard, some padded, is_target on each row's tail (4
# batches: the 8 steps read 2 epochs)
GT_SEQ, GT_BATCH = 1536, 8
GT_STEPS, GT_CKPT_EVERY = 8, 4
GT_REDUCED = {"num_train_steps": (80000, GT_STEPS), "num_warmup_steps": (1000, 2),
              "checkpoint_every": (5000, GT_CKPT_EVERY), "log_every": (50, 1)}
GT_ROWS = 32
GT_LAUNCHES_PER_STEP = 24
# one step's loss and grads through the kernels against the plain attention
# at full depth on GT_CHECK_BATCH rows of the first batch (the plain path
# keeps every layer's fp32 probs: 1.2 GB a layer at batch 8, 0.3 at 2), and
# the same with the causal mask dropped on the kernel side, which must fail
# both bounds. On the H100 the loss was equal and the grads within 3.9e-6
# (grad_gap; a key bias): GT_GRAD_TOL is 25x that. The mask dropped moved
# the loss by 6.9e-4 relative (69x GT_LOSS_RTOL) and the grads by 2.44
GT_CHECK_BATCH = 2
GT_TURN_STEPS = 2      # timed forward+backward steps per design and turn
GT_LOSS_RTOL = 1e-5
GT_GRAD_TOL = 1e-4
# the round trip: the Denoiser (fused qkv, the stacked cache, fp32) serving
# A's last checkpoint, its prefill logits through K3 over GT_ROUNDTRIP rows
# x tokens against the trained model's deterministic forward through K1.
# On the H100 they were equal (both fp32 FMA routes sum in one order);
# GT_ROUNDTRIP_TOL leaves room for another order, and ckpt_4's logits,
# 0.63 away, must fail it
GT_ROUNDTRIP = (2, 1024)
GT_ROUNDTRIP_TOL = 1e-4

# the data_parallel phase: the entry points launched as rank 0 of a world of
# 1 (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set), so
# that each joins an NCCL process group and runs its data-parallel path on
# the card (parallel/mesh.py): the pretraining CLI with use_zero1 on the CLI
# phase's copy of pretrain_4seg.yaml for its first DP_STEPS steps,
# checkpointed every DP_CKPT_EVERY (in the warmup the learning rate does
# not depend on num_train_steps), VCR with use_zero1 on the VCR phase's
# copy for DP_VCR_STEPS steps, and the zero-shot CLI on its phase's copy.
# At world 1 a rank's shares of the global losses are the losses, computed
# by the same operations, and the gradient all-reduce adds nothing: every
# metric, checkpoint and prob must equal the runs without a process group
# bit for bit (DP_RTOL). The fault probe: the pretraining rank recomputes
# its first step's global loss from a copy of the step's generator with the
# mask loss's denominator summed twice (an all-reduce that counts a rank's
# tokens again), which must fail the check the run passes.
DP_STEPS, DP_CKPT_EVERY = 4, 4
DP_VCR_STEPS = 2
DP_RTOL = 0.0

# the corpus phase: CORPUS_VIDEOS synthetic 1280x720 videos written by cv2
# (mp4v, CORPUS_FPS), each a 16:9 content box (CORPUS_CONTENT, smooth
# noise) inside black bars on all four sides, CORPUS_SECONDS long with a
# word every 1 / CORPUS_WORDS_PER_S s in its .grover.json; python -m
# merlot_tpu_torch.data.process writes them into one shard (frames trimmed
# to the content and stored at 512x288), and the pretraining CLI trains
# CORPUS_STEPS steps on it with a copy of the CLI phase's reduced
# pretrain_4seg.yaml (36 K1 and 36 K2 per step)
CORPUS_VIDEOS = 5
CORPUS_HW = (720, 1280)
CORPUS_CONTENT = (576, 1024)
CORPUS_FPS = 2.0
CORPUS_SECONDS = 150
CORPUS_WORDS_PER_S = 5
CORPUS_FRAME_HW = (288, 512)
CORPUS_MIN_EXAMPLES = 8
CORPUS_STEPS = 2

# the tensor_parallel phase: the model axis (parallel/mesh.py, model=2) as
# two ranks that share the one card over gloo, chosen by name (NCCL refuses
# two ranks on one device; gloo takes CUDA tensors for the all-reduce, the
# all-gather and the broadcasts the path needs, through the host). Not a
# reading of tensor parallelism's speed on separate cards.
#   * pretraining at pretrain_4seg's full width and depth (the train
#     phase's model and optimizer blocks, dropout and masking on) on
#     TP_BATCH examples of 16 chunks (a quarter of bench.py's batch: both
#     ranks' steps fit in the 80 GB, and the host carries half the
#     all-reduces of 4), TP_STEPS steps from seed 0, against the same
#     steps of one process at model=1 from the same seed and generator: each
#     step's loss within TRAIN_LOSS_RTOL and step 1's gradients (gathered
#     over the model group) within TRAIN_GRAD_TOL, the train phase's
#     kernel-vs-plain bounds. The masked positions rank the lang tower's
#     colsum, which the model group sums in another order, so near-ties could
#     pick others from the same draws: the ranks take one process's masking
#     (computing their own, which is reported). 36 K1 and 36 K2 per step per
#     rank. The fault probe: step 1's forward and backward with one
#     row-parallel all-reduce left out (the ViT's first out_proj) must fail
#     those bounds;
#   * the Grover server at grover-medium, --tp 2: ``Denoiser.run_batch`` on
#     TP_GROVER_ROWS contexts of TP_GROVER_PREFIX + TP_GROVER_DECODE tokens at
#     max_len = prefix + 16 (the Denoiser prefills max_len - 16 tokens and
#     force-feeds the rest from the contexts, so both runs decode the same
#     tokens): with --bf16 as the server phase runs it, the prefill's last
#     logits and the first TP_GROVER_CHECKED decode steps' against --tp 1
#     within GROVER_LOGIT_TOL; in fp32 the prefill's and the first decode
#     step's within TP_FP32_LOGIT_TOL (absolute; the same fp32 sums in another
#     order). 24 K3 per prefill and per decode step per rank.
TP_RANKS = 2
TP_BATCH = 2
TP_STEPS = 2
TP_GROVER_ROWS, TP_GROVER_PREFIX, TP_GROVER_DECODE = 8, 512, 16
TP_GROVER_CHECKED = 4
TP_FP32_LOGIT_TOL = 1e-3
TP_TIMEOUT_S = 600
# the pipeline_parallel phase: the stage axis (parallel/pipeline.py, pp=2) as
# two ranks that share the one card over gloo, chosen by name (NCCL refuses
# two ranks on one device; each hop moves through a pinned host buffer).
# Not a reading of pipeline parallelism's speed on separate cards.
#   * grover-medium uncut (configs/grover_medium.json: 24 x 1024 x 16 heads,
#     fp32) at grover_train's defaults, 8 x 1536 in PP_MICROBATCHES = 4 pp
#     microbatches of 1 row: 12 layers x 8 microbatches = 96 K1 and 96 K2
#     per step per rank;
#   * with hidden_dropout_prob 0.1 -> 0 (the compared runs draw nothing),
#     PP_STEPS steps (warmup 0, so step 2 sees step 1's update) against the
#     same steps of one process at --pp 1 from seed 0: each loss within
#     GT_LOSS_RTOL relative and step 1's gradients gathered over the stage
#     group onto stage 0 within GT_GRAD_TOL (grad_gap), the Grover phase's bounds. The
#     probe: the same step's gradients with the tied word_embed's left
#     unsummed over the end stages (stage 0's lookup part alone), which
#     must fail the gradient bound;
#   * the CLI as torchrun starts it (RANK, WORLD_SIZE, LOCAL_RANK 0, MASTER_*
#     set; --dist_backend gloo), the config as it is (dropout on), --pp 2,
#     PP_CLI_STEPS steps with a checkpoint at PP_CLI_CKPT_EVERY; the
#     straight run's ckpt_2 resumed in a fresh directory must give step 3's
#     loss bit for bit; the checkpoint's stages/ leaves [2, 12, ...]; the
#     Denoiser serving it (K3 prefill, GT_ROUNDTRIP rows x tokens) within
#     GT_ROUNDTRIP_TOL of the trained ranks' own pipeline forward (K1).
PP_STAGES = 2
PP_MICROBATCHES = 4 * PP_STAGES
PP_STEPS = 2
PP_CLI_STEPS, PP_CLI_CKPT_EVERY = 3, 2
PP_LAUNCHES_PER_STEP = 24 // PP_STAGES * PP_MICROBATCHES
PP_TIMEOUT_S = 420
# the kernels at the model axis's shapes: K1 and K2 at the pretrain towers'
# 6 of 12 heads (the first 6 heads of the pretrain rows' inputs: what model
# rank 0 computes on), K3 at grover-medium's 8 of 16 (the server's decode and
# prefill, B=8, bf16 and fp32), K5 at K=768 with this rank's columns: q|k|v
# 3 x 384 = 1152, the MLP's 1536 of 3072
TP_ATTN_SHAPES = [
    ("tp_pretrain_vit", 128, 266, False, False, False, 6, "bf16"),
    ("tp_pretrain_joint", 32, 396, True, False, False, 6, "bf16"),
    ("tp_pretrain_lang", 8, 512, True, True, False, 6, "bf16"),
]
# the pipeline_parallel phase's microbatch: one row of grover_train's 8 x
# 1536 at M = 8 microbatches, 16 heads, fp32, causal (K1's and K2's fp32
# routes)
PP_ATTN_SHAPES = [("pp_grover_mb1", 1, 1536, "causal", False, True, 16, "fp32")]
TP_STACKED_SHAPES = [
    ("tp_decode_b8_bf16", 8, 1, 1537, 1100, "bf16", 8),
    ("tp_decode_b8_fp32", 8, 1, 1537, 1100, "fp32", 8),
    ("tp_prefill_b8_bf16", 8, 1024, 1537, 0, "bf16", 8),
    ("tp_prefill_b8_fp32", 8, 1024, 1537, 0, "fp32", 8),
]
TP_LN_SHAPES = [
    ("tp_pretrain_vit_qkv", 34048, 3, 384),
    ("tp_pretrain_vit_mlp", 34048, 1, 1536),
    ("tp_pretrain_joint_qkv", 12672, 3, 384),
    ("tp_pretrain_joint_mlp", 12672, 1, 1536),
    ("tp_pretrain_lang_qkv", 4096, 3, 384),
    ("tp_pretrain_lang_mlp", 4096, 1, 1536),
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


def bound(flops: float, nbytes: float, peak: float) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    operations over ``peak``, the card's rate for their type
    (PEAK_BF16_FLOPS on the tensor cores, PEAK_FP32_FLOPS outside them),
    and the bytes over the device-memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def attn_work(b: int, s: int, masked: bool, colsum: bool, backward: bool,
              heads: int = HEADS, d: int = D_HEAD, elem: int = 2,
              pairs: int | None = None) -> tuple:
    """(flops, bytes) one attention call needs at [b, s, heads*d] with
    ``elem``-byte elements: each input read once, each output written once.
    Forward: S = QK^T and ctx = PV. Backward: S again (P is not an input),
    dV, dP, dQ, dK. ``pairs``: the (query, key) pairs the mask lets
    through, summed over the batch, where the work depends on it (a causal
    mask: the rest is known to be 0 and need not be computed); b*s*s by
    default."""
    n_products = 5 if backward else 2
    pairs = b * s * s if pairs is None else pairs
    flops = 2 * n_products * heads * pairs * d
    act = b * s * heads * d * elem                    # one [b, s, H*D] tensor
    nbytes = act * (7 if backward else 4)             # q,k,v,dO + 3 grads | q,k,v + ctx
    nbytes += 4 * b * s * s if masked else 0
    nbytes += 4 * b * s if colsum else 0              # colsum out | its cotangent in
    return flops, nbytes


def spec_parts(spec) -> tuple:
    """(name, b, s, masked, colsum, sm32, heads, dtype, head dim) of a K1/K2
    shape; the pretrain, zero-shot and VCR shapes are bf16 at 12 heads of
    64."""
    name, b, s, masked, colsum, sm32, *rest = spec
    heads, dtype, d = (*rest, D_HEAD)[:3] if rest else (HEADS, "bf16", D_HEAD)
    return name, b, s, masked, colsum, sm32, heads, dtype, d


def attn_bound(spec, backward: bool, mask=None) -> tuple:
    """bound() of one K1 (K2 with ``backward``) call at a shape: bf16 on the
    tensor cores, fp32 on the FMA units; a causal or block mask counts only
    the pairs it lets through."""
    _, b, s, masked, colsum, _, heads, dtype, d = spec_parts(spec)
    elem = 2 if dtype == "bf16" else 4
    pairs = int(mask.count_nonzero().item()) if masked in ("causal", "block") else None
    return bound(*attn_work(b, s, bool(masked), colsum, backward, heads, d, elem, pairs),
                 PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_FP32_FLOPS)


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


def attn_inputs(dev, g, b, s, masked, heads: int = HEADS, dtype: str = "bf16",
                d: int = D_HEAD):
    """q, k, v ~ N(0, 1) [b, s, heads*d] in ``dtype``; with ``masked``, a
    validity mask with padding rows as the towers build it, and the
    validity; with masked == "causal", Grover's causal mask [b, s, s]
    (contiguous, as the model passes it) and no validity; with "block", 64
    x 64 blocks of ones on the diagonal and at random (40%), zeros
    elsewhere."""
    import torch
    q, k, v = (torch.randn((b, s, heads * d), generator=g, device=dev)
               .to(torch.bfloat16 if dtype == "bf16" else torch.float32) for _ in range(3))
    mask = valid = None
    if masked == "causal":
        mask = torch.tril(torch.ones((s, s), device=dev)).expand(b, s, s).contiguous()
    elif masked == "block":
        nb = -(-s // 64)
        keep = torch.rand((b, nb, nb), generator=g, device=dev) < 0.4
        keep |= torch.eye(nb, dtype=torch.bool, device=dev)
        mask = (keep.repeat_interleave(64, 1).repeat_interleave(64, 2)[:, :s, :s]
                .float().contiguous())
    elif masked:
        valid = torch.rand((b, s), generator=g, device=dev) > 0.15
        valid[:, 0] = True
        mask = (valid[:, None] & valid[:, :, None]).float()
    return q, k, v, mask, valid


def sdpa_args(q3, k3, v3, mask, heads: int = HEADS):
    """torch's scaled_dot_product_attention on the same inputs: [B, H, S, D]
    views, the mask as an additive -1e10 bias in the input dtype."""
    b, s, hd = q3.shape
    views = [t.view(b, s, heads, hd // heads).transpose(1, 2) for t in (q3, k3, v3)]
    bias = None if mask is None else ((mask - 1.0) * 1e10).to(q3.dtype)[:, None]
    return views, bias


def first_heads(inputs: tuple, heads: int, d: int) -> tuple:
    """A shape's inputs cut to their first ``heads`` heads (contiguous): what
    model rank 0 of the model axis computes on; masks and cotangents over
    keys as they are."""
    return tuple(t[..., :heads * d].contiguous() if i < 3 else t
                 for i, t in enumerate(inputs))


def kernel_shape(dev, g, spec, drawn: dict = None) -> dict:
    """K1 and its plain version at one shape: errors and times. ``drawn``:
    each shape's inputs by name; a tensor-parallel shape (``tp_`` + the
    name of one drawn before it) takes the first heads of that shape's."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    name, b, s, masked, colsum, sm32, heads, dtype, d = spec_parts(spec)
    drawn = {} if drawn is None else drawn
    if name.startswith("tp_"):
        q, k, v, mask, valid = first_heads(drawn[name[len("tp_"):]], heads, d)
    else:
        q, k, v, mask, valid = drawn[name] = attn_inputs(dev, g, b, s, masked, heads,
                                                         dtype, d)
    kw = dict(num_heads=heads, collect_colsum=colsum)
    # K1 saves the row max and sum for K2, and in fp32 the mask's tile classes
    stats = ca.new_stats(q, heads)
    tile_class = None if dtype == "bf16" or mask is None else ca.new_tile_class(mask)
    saved = dict(stats=stats, tile_class=tile_class)
    ctx, cs = ca.attention_fwd_cuda(q, k, v, mask, softmax_fp32=sm32, **saved, **kw)
    torch.cuda.synchronize()
    ref, ref_cs = ca.flash_attention_plain(q, k, v, mask, softmax_fp32=sm32, **kw)
    ref_stats = ca.softmax_stats_plain(q, k, mask, num_heads=heads, softmax_fp32=sm32)
    diff = (ctx.float() - ref.float()).abs()
    ref_max = ref.float().abs().max().item()
    row = {"shape": name, "batch": b, "seq": s, "heads": heads, "head_dim": d,
           "dtype": dtype, "masked": masked, "colsum": colsum,
           "softmax": "fp32" if sm32 else "bf16",
           "max_abs_err": diff.max().item(),
           "max_abs_err_bound": (CTX_ULPS * bf16_ulp(ref_max) if dtype == "bf16"
                                 else FP32_CTX_RTOL * ref_max),
           "ref_max_abs": ref_max,
           "mean_abs_err": diff.mean().item(),
           "differing_share": (diff > 0).float().mean().item(),
           "stats_max_rel_err": ((stats[0] - ref_stats[0]).abs()
                                 / ref_stats[0].abs().clamp_min(1.0)).max().item(),
           "stats_sum_rel_err": ((stats[1] - ref_stats[1]).abs() / ref_stats[1]).max().item()}
    if tile_class is not None:
        row["tile_classes"] = torch.bincount(tile_class.flatten().long(), minlength=3).tolist()
    if dtype == "bf16":
        # the fault probe: the softmax in the other dtype
        other, _ = ca.flash_attention_plain(q, k, v, mask, softmax_fp32=not sm32, **kw)
        other_diff = (other.float() - ref.float()).abs()
        row.update({
            "other_softmax_max_abs_diff": other_diff.max().item(),
            "other_softmax_mean_abs_diff": other_diff.mean().item(),
            "other_softmax_differing_share": (other_diff > 0).float().mean().item()})
    else:
        # fp32 inputs softmax in fp32 in both modes: the probe is the mask dropped
        no_mask, _ = ca.flash_attention_plain(q, k, v, None, softmax_fp32=sm32, **kw)
        row["no_mask_max_abs_diff"] = (no_mask - ref).abs().max().item()
    if colsum:
        row["colsum_max_rel_err"] = (
            (cs - ref_cs).abs() / ref_cs.abs().clamp_min(1e-6)).max().item()
    if valid is not None:
        # fully masked rows: uniform over the true key length
        bi, qi = torch.nonzero(~valid, as_tuple=True)
        want = v.float().mean(dim=1)[bi]
        row["masked_row_uniform_err"] = (ctx[bi, qi].float() - want).abs().max().item()
        row["masked_row_uniform_bound"] = (UNIFORM_ULPS * bf16_ulp(want.abs().max().item())
                                           if dtype == "bf16" else row["max_abs_err_bound"])
    kw["softmax_fp32"] = sm32
    row["ms"] = cuda_ms(lambda: ca.attention_fwd_cuda(q, k, v, mask, **saved, **kw))
    row["plain_ms"] = cuda_ms(lambda: ca.flash_attention_plain(q, k, v, mask, **kw))
    row["bound_ms"], row["bound_by"] = attn_bound(spec, False, mask)
    # the yardstick: one torch call of the same function, where there is one
    if colsum:
        row["library_ms"], row["library_note"] = None, "no single call (colsum)"
    else:
        views, bias = sdpa_args(q, k, v, mask, heads)
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(*views, attn_mask=bias))
        row["library_note"] = ("same function" if sm32 else
                               "fp32 softmax (not the bf16-softmax rounding)")
    return row


def check_kernel_row(row: dict) -> None:
    name = row["shape"]
    check(row["max_abs_err"] <= row["max_abs_err_bound"],
          f"{name}: ctx max err {row['max_abs_err']} > {row['max_abs_err_bound']}")
    if row["dtype"] == "fp32":
        check(row["no_mask_max_abs_diff"] > row["max_abs_err_bound"],
              f"{name}: the mask dropped passes the bound ({row['no_mask_max_abs_diff']}), "
              "so the check cannot see it")
    else:
        check(row["mean_abs_err"] <= CTX_MEAN_TOL,
              f"{name}: ctx mean err {row['mean_abs_err']} > {CTX_MEAN_TOL}")
        check(row["other_softmax_mean_abs_diff"] > CTX_MEAN_TOL,
              f"{name}: the other softmax mode passes the mean bound "
              f"({row['other_softmax_mean_abs_diff']}), so the check cannot see it")
    tol = STATS_RTOL[row["softmax"]]
    check(row["stats_max_rel_err"] <= tol[0] and row["stats_sum_rel_err"] <= tol[1],
          f"{name}: saved stats off: max {row['stats_max_rel_err']}, "
          f"sum {row['stats_sum_rel_err']} (bounds {tol})")
    if row["colsum"]:
        check(row["colsum_max_rel_err"] <= COLSUM_RTOL,
              f"{name}: colsum rel err {row['colsum_max_rel_err']}")
    if "masked_row_uniform_err" in row:
        check(row["masked_row_uniform_err"] <= row["masked_row_uniform_bound"],
              f"{name}: fully masked rows not uniform ({row['masked_row_uniform_err']})")


def kernel_phase(dev) -> list[dict]:
    """K1 against its plain version at every shape of its paths."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    rows, drawn = [], {}
    for spec in (ATTN_SHAPES + GROVER_TRAIN_SHAPES + FP32_PROBE_SHAPES + TP_ATTN_SHAPES
                 + PP_ATTN_SHAPES):
        row = kernel_shape(dev, g, spec, drawn)
        if not spec[0].startswith("pretrain"):  # kept for the tensor-parallel rows
            drawn.pop(spec[0], None)
        print(f"[kernel] {json.dumps(row)}", flush=True)
        check_kernel_row(row)
        rows.append(row)
    return rows


def grad_errors(got, ref, dtype: str = "bf16") -> dict:
    """Largest and mean |difference| of each of dQ, dK, dV, and the bound
    on the largest (bf16: GRAD_ULPS ulps of the largest |grad|; fp32:
    FP32_GRAD_RTOL of it)."""
    out = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        diff = (a.float() - r.float()).abs()
        r_max = r.float().abs().max().item()
        out[name] = {"max_abs_err": diff.max().item(),
                     "max_abs_err_bound": (GRAD_ULPS * bf16_ulp(r_max) if dtype == "bf16"
                                           else FP32_GRAD_RTOL * r_max),
                     "mean_abs_err": diff.mean().item()}
    return out


def bwd_kernel_shape(dev, g, spec, drawn: dict = None) -> dict:
    """K2 and its plain version at one shape: errors, fault probes, times.
    ``drawn``: as for ``kernel_shape`` (dO cut with q, k and v)."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    name, b, s, masked, colsum, sm32, heads, dtype, d = spec_parts(spec)
    drawn = {} if drawn is None else drawn
    if name.startswith("tp_"):
        q, k, v, mask, valid, do, gcol = first_heads(drawn[name[len("tp_"):]], heads, d)
        do = do[..., :heads * d].contiguous()
    else:
        q, k, v, mask, valid = attn_inputs(dev, g, b, s, masked, heads, dtype, d)
        do = (0.1 * torch.randn((b, s, heads * d), generator=g, device=dev)).to(q.dtype)
        gcol = torch.randn((b, s), generator=g, device=dev) if colsum else None
        drawn[name] = (q, k, v, mask, valid, do, gcol)
    kw = dict(num_heads=heads, softmax_fp32=sm32)
    got = ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    again = ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    # the path's call: K1's saved row max and sum (and in fp32 the mask's
    # tile classes) instead of K2's own pass
    saved_kw = dict(stats=ca.new_stats(q, heads),
                    tile_class=None if dtype == "bf16" or mask is None
                    else ca.new_tile_class(mask))
    ca.attention_fwd_cuda(q, k, v, mask, collect_colsum=False, **saved_kw, **kw)
    saved = ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **saved_kw, **kw)
    torch.cuda.synchronize()
    ref = ca.attention_bwd_plain(q, k, v, mask, do, gcol, **kw)
    row = {"shape": name, "batch": b, "seq": s, "heads": heads, "head_dim": d,
           "dtype": dtype, "masked": masked, "colsum_cotangent": colsum,
           "softmax": "fp32" if sm32 else "bf16",
           "grads": grad_errors(got, ref, dtype),
           "bitwise_repeatable": all(torch.equal(a, b_) for a, b_ in zip(got, again)),
           "saved_stats_equal": all(torch.equal(a, b_) for a, b_ in zip(got, saved))}
    if dtype == "bf16":
        other = ca.attention_bwd_plain(q, k, v, mask, do, gcol, num_heads=heads,
                                       softmax_fp32=not sm32)
        row["other_softmax_mean_abs_diff"] = min(
            e["mean_abs_err"] for e in grad_errors(other, ref).values())
    else:
        # fp32: one softmax; the probe is the mask dropped
        nom = ca.attention_bwd_plain(q, k, v, None, do, gcol, **kw)
        row["no_mask_rel_diff"] = min(e["max_abs_err"] / e["max_abs_err_bound"]
                                      for e in grad_errors(nom, ref, dtype).values())
    if colsum:
        nog = ca.attention_bwd_plain(q, k, v, mask, do, None, **kw)
        row["no_colsum_cotangent_mean_abs_diff"] = grad_errors(nog, ref)["dq"]["mean_abs_err"]
    if valid is not None:
        bi, qi = torch.nonzero(~valid, as_tuple=True)
        row["dq_masked_rows_max_abs"] = got[0][bi, qi].float().abs().max().item()
    row["max_abs_err"] = max(e["max_abs_err"] for e in row["grads"].values())
    row["ms"] = cuda_ms(lambda: ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **saved_kw,
                                                      **kw))
    row["ms_without_stats"] = cuda_ms(lambda: ca.attention_bwd_cuda(q, k, v, mask, do, gcol,
                                                                    **kw))
    row["plain_ms"] = cuda_ms(lambda: ca.attention_bwd_plain(q, k, v, mask, do, gcol, **kw))
    row["bound_ms"], row["bound_by"] = attn_bound(spec, True, mask)
    # the yardstick: the backward of torch's attention (fp32 softmax, and no
    # colsum, so not the same rounding)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    views, bias = sdpa_args(*leaves, mask, heads)
    out = F.scaled_dot_product_attention(*views, attn_mask=bias)
    do4 = do.view(b, s, heads, d).transpose(1, 2)
    row["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True))
    row["library_note"] = ("backward of scaled_dot_product_attention: fp32 "
                           "softmax" + (", no colsum cotangent" if colsum else "")
                           + ("; the same function" if dtype == "fp32"
                              else "; not the same rounding"))
    return row


def check_bwd_row(row: dict) -> None:
    name = row["shape"]
    check(row["bitwise_repeatable"], f"{name}: two K2 runs differ")
    check(row["saved_stats_equal"],
          f"{name}: K2 fed K1's saved stats differs from K2 computing them")
    for g, e in row["grads"].items():
        check(e["max_abs_err"] <= e["max_abs_err_bound"],
              f"{name}: {g} max err {e['max_abs_err']} > {e['max_abs_err_bound']}")
    if row["dtype"] == "fp32":
        check(row["no_mask_rel_diff"] > 1.0,
              f"{name}: a backward without the mask passes the bounds "
              f"({row['no_mask_rel_diff']} of them), so the check cannot see it")
    else:
        for g, e in row["grads"].items():
            check(e["mean_abs_err"] <= GRAD_MEAN_TOL,
                  f"{name}: {g} mean err {e['mean_abs_err']} > {GRAD_MEAN_TOL}")
        check(row["other_softmax_mean_abs_diff"] > GRAD_MEAN_TOL,
              f"{name}: the other softmax mode passes the mean bound "
              f"({row['other_softmax_mean_abs_diff']}), so the check cannot see it")
    if row["colsum_cotangent"]:
        check(row["no_colsum_cotangent_mean_abs_diff"] > GRAD_MEAN_TOL,
              f"{name}: dropping the colsum cotangent passes the mean bound "
              f"({row['no_colsum_cotangent_mean_abs_diff']})")
    if "dq_masked_rows_max_abs" in row:
        check(row["dq_masked_rows_max_abs"] == 0.0,
              f"{name}: dQ on fully masked rows is not 0 "
              f"({row['dq_masked_rows_max_abs']})")


def bwd_kernel_phase(dev) -> list[dict]:
    """K2 against its plain version at every shape of its paths."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    rows, drawn = [], {}
    for spec in (BWD_SHAPES + GROVER_TRAIN_SHAPES + FP32_PROBE_SHAPES + TP_ATTN_SHAPES
                 + PP_ATTN_SHAPES):
        row = bwd_kernel_shape(dev, g, spec, drawn)
        if not spec[0].startswith("pretrain"):  # kept for the tensor-parallel rows
            drawn.pop(spec[0], None)
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
    for spec in PRETRAIN_SHAPES:
        name, b, s, masked, colsum, sm32 = spec
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
        row["bound_ms"], row["bound_by"] = attn_bound(spec, False)
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
        [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out / f"lib{n}.so"),
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
            heads, hd // heads, int(q.dtype == torch.bfloat16), int(sm32),
            (hd // heads) ** -0.5, stream())
        check(err == 0, f"first-design K1 failed: {err}")
        return out

    def bwd(q, k, v, mask, do, gcol, sm32, heads=HEADS):
        b, sq, hd = q.shape
        sk = k.shape[1]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stats = torch.empty(3 * b * heads * sq, device=dev)
        err = libs["attention_bwd"].merlot_attention_bwd(
            ptr(q), ptr(k), ptr(v), ptr(mask), ptr(do), ptr(gcol), ptr(dq), ptr(dk),
            ptr(dv), ptr(stats), b, sq, sk, heads, hd // heads,
            int(q.dtype == torch.bfloat16), int(sm32), (hd // heads) ** -0.5, stream())
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


def first_design_phase(dev, old) -> dict:
    """The first designs (``old``: parent_calls' callables) against the
    current kernels at every K1, K2, K4 and K5 shape and K3's prefill
    shapes, in turns on this card, and at Grover training's fp32 shape
    beside SDPA and the plain versions; each pair's largest output
    difference is reported."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.ops import cuda_groupnorm as cg
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm

    fwd, bwd, stacked, old_gn, old_ln = old
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    # Grover training's fp32 K1 and K2 (the first design's FMA route, PR 2's,
    # unchanged until this one) on the path's calls: K1 saving its stats
    # and tile classes, K2 taking them
    for spec in GROVER_TRAIN_SHAPES:
        name, b, s, masked, colsum, sm32, heads, dtype, d = spec_parts(spec)
        q, k, v, mask, _ = attn_inputs(dev, g, b, s, masked, heads, dtype, d)
        do = 0.1 * torch.randn((b, s, heads * d), generator=g, device=dev)
        kw = dict(num_heads=heads, softmax_fp32=sm32)
        saved = dict(stats=ca.new_stats(q, heads), tile_class=ca.new_tile_class(mask))
        new = lambda: ca.attention_fwd_cuda(q, k, v, mask, collect_colsum=colsum, **saved,
                                            **kw)[0]
        prev = lambda: fwd(q, k, v, mask, sm32, colsum, heads)
        diff = (new() - prev()).abs().max().item()
        first_ms, ms = in_turns(prev, new)
        views, bias = sdpa_args(q, k, v, mask, heads)
        rows.append({"kernel": "K1", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff,
                     "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                         *views, attn_mask=bias)),
                     "plain_ms": cuda_ms(lambda: ca.flash_attention_plain(
                         q, k, v, mask, collect_colsum=colsum, **kw))})
        new = lambda: ca.attention_bwd_cuda(q, k, v, mask, do, None, **saved, **kw)
        prev = lambda: bwd(q, k, v, mask, do, None, sm32, heads)
        diff = max((x - y).abs().max().item() for x, y in zip(new(), prev()))
        first_ms, ms = in_turns(prev, new)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lviews, _ = sdpa_args(*leaves, mask, heads)
        out = F.scaled_dot_product_attention(*lviews, attn_mask=bias)
        do4 = do.view(b, s, heads, d).transpose(1, 2)
        rows.append({"kernel": "K2", "shape": name, "first_design_ms": first_ms, "ms": ms,
                     "speedup": first_ms / ms, "max_abs_diff": diff,
                     "library_ms": cuda_ms(lambda: torch.autograd.grad(
                         out, leaves, do4, retain_graph=True)),
                     "plain_ms": cuda_ms(lambda: ca.attention_bwd_plain(
                         q, k, v, mask, do, None, **kw))})
        del q, k, v, mask, do, saved, leaves, lviews, out, do4, views, bias
        torch.cuda.empty_cache()
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
                           per("K3", ("decode_b8_bf16_bench",), "ms", 24)),
        "k3_prefill_fp32": (per("K3", ("prefill_b2_fp32",), "first_design_ms", 24),
                            per("K3", ("prefill_b2_fp32",), "ms", 24)),
        "k1_grover_step": (per("K1", ("grover_train",), "first_design_ms", 24),
                           per("K1", ("grover_train",), "ms", 24)),
        "k2_grover_step": (per("K2", ("grover_train",), "first_design_ms", 24),
                           per("K2", ("grover_train",), "ms", 24))}
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
    row["bound_ms"], row["bound_by"] = bound(2 * m * k * j * n, nbytes, PEAK_BF16_FLOPS)
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
    """K5 against its plain version at the ten LayerNorm+matmul shapes and
    the six of the towers at model=2."""
    import torch

    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for spec in LN_SHAPES + TP_LN_SHAPES:
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


def pretrain_batch(cfg, dev, examples: int = TRAIN_BATCH) -> dict:
    """__graft_entry__._make_batch (numpy seed 0) at bench.py's batch (or
    ``examples`` examples of as many chunks), with each chunk's tail padded
    with id 0 from a second seed: the towers then see padded rows, which the
    draws 100..50356 alone never give."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    h, w = cfg.image_size
    group = cfg.num_chunks_in_group
    n_img = examples * TRAIN_CHUNKS
    images = rng.uniform(0, 1, (n_img, h, w, 3)).astype(np.float32)
    ids = rng.integers(100, 50357, (examples, TRAIN_CHUNKS, TRAIN_TOKENS))
    pad = np.random.default_rng(1)
    for b in range(examples):
        for n in range(TRAIN_CHUNKS):
            ids[b, n, pad.integers(8, TRAIN_TOKENS + 1):] = 0
    batch = {"images": images, "input_ids": ids,
             "shuffled_idx_img": np.tile(np.arange(group), n_img // group),
             "video_src_ids": np.repeat(np.arange(n_img // group), group)
             .reshape(examples, TRAIN_CHUNKS)}
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
    worst of the LiteResNet's tensors and of all the others (where the model
    has a LiteResNet)."""
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    per = {n: (grads[n] - r).abs().max().item() / max(r.abs().max().item(), floor)
           for n, r in ref.items()}
    worst = max(per, key=per.get)
    out = {"max_rel": per[worst], "worst_tensor": worst,
           "median_rel": statistics.median(per.values())}
    for part, names in (("resnet", [n for n in per if ".resnet." in n]),
                        ("rest", [n for n in per if ".resnet." not in n])):
        if names:
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
    # the plain versions in the kernels' places: they take no saved stats or
    # tile classes (the plain backward recomputes P)
    plain_fwd = lambda *a, stats=None, tile_class=None, **kw: ca.flash_attention_plain(*a, **kw)
    plain_bwd = lambda *a, stats=None, tile_class=None, **kw: ca.attention_bwd_plain(*a, **kw)
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
    mask checked to fail that bound), and torch.profiler over PROFILE_STEPS."""
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


def remat_step(model, batch, dev, seed: int = REMAT_SEED) -> tuple:
    """One forward and backward with hidden dropout on, from a generator
    seeded with ``seed``: (loss, masked positions, fp32 grads by name, the
    generator's state after)."""
    import torch
    for p in model.parameters():
        p.grad = None
    g = torch.Generator(device=dev).manual_seed(seed)
    loss, _, fwd = model(batch, deterministic=False, attn_backend="cuda", generator=g)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().float()
             for n, p in model.named_parameters()}
    return loss.item(), fwd["lang_mask_info"]["masked_idx"], grads, g.get_state()


def remat_cases(dev, weights) -> dict:
    """Per-layer remat under each of REMAT_CASES: launches per step, step
    ms (REMAT_STEPS runs after a warm-up), peak memory, and the loss and
    grads against the run without remat; then the fault probe (None with
    the dropout masks redrawn)."""
    import torch
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.nn import transformer as transformer_mod

    batch = pretrain_batch(MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL), dev)
    cases, refs = {}, {}

    def build(remat, policy, fused):
        model = MerlotPretrainModel(MerlotConfig.from_dict(dict(
            PRETRAIN_4SEG_MODEL, remat=remat, remat_policy=policy, fuse_ln_matmul=fused)),
            device=dev)
        model.load_state_dict(weights)
        return model

    for name, remat, policy, fused in REMAT_CASES:
        model = build(remat, policy, fused)
        with fused_norms() if fused else contextlib.nullcontext():
            remat_step(model, batch, dev)                      # warm-up
            for p in model.parameters():
                p.grad = None
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()                # counts set to 0 just before the runs
            step_ms, per_step, grads = [], [], None
            for _ in range(REMAT_STEPS):
                grads = None              # the last run's grads are freed first
                before = counts()
                t0 = time.perf_counter()
                loss, masked, grads, gen_state = remat_step(model, batch, dev)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                per_step.append(tuple(a - b for a, b in zip(counts(), before)))
            peak = torch.cuda.max_memory_allocated(dev)
            launched = counts()           # and read just after
        check(len(set(per_step)) == 1, f"remat {name}: launches differ by step {per_step}")
        case = {"remat": remat, "policy": policy, "fused": fused, "loss": loss,
                "launches": list(launched), "launches_per_step": list(per_step[0]),
                "step_ms": step_ms,
                "step_ms_median": statistics.median(step_ms),
                # the peak, and above what was allocated before the runs (the
                # weights, and the reference runs' grads kept for comparison)
                "peak_mem_gib": peak / 2**30, "peak_above_base_gib": (peak - base) / 2**30}
        if not remat:
            refs[fused] = (loss, masked, grads, gen_state)
        else:
            r_loss, r_masked, r_grads, r_state = refs[fused]
            case.update({
                "loss_equal": loss == r_loss, "masked_equal": torch.equal(masked, r_masked),
                "grads_bitwise": all(torch.equal(grads[n], r) for n, r in r_grads.items()),
                "generator_state_equal": torch.equal(gen_state, r_state),
                "grads_vs_off": grad_gap(grads, r_grads)})
        if name == "none":
            # the fault probe: the recompute draws new dropout masks
            no_replay = lambda f: lambda policy, generator: f(policy, None)
            with wrapped(transformer_mod, "_remat_contexts", no_replay):
                case["masks_redrawn_vs_off"] = grad_gap(remat_step(model, batch, dev)[2],
                                                        refs[False][2])
        cases[name] = case
        print(f"[remat] {name} {json.dumps(case)}", flush=True)
        del model, grads
        torch.cuda.empty_cache()
    for name, case in cases.items():
        check(tuple(case["launches_per_step"]) == REMAT_LAUNCHES[name],
              f"remat {name}: K1/K2/K4/K5 launches {case['launches_per_step']}, "
              f"want {REMAT_LAUNCHES[name]}")
        check(math.isfinite(case["loss"]), f"remat {name}: loss {case['loss']}")
        if case["remat"]:
            check(case["loss_equal"] and case["masked_equal"] and case["generator_state_equal"]
                  and case["grads_bitwise"],
                  f"remat {name}: loss, masking, the generator's state or a grad differ "
                  f"from off")
            check(case["grads_vs_off"]["max_rel"] <= TRAIN_GRAD_TOL,
                  f"remat {name}: grads {case['grads_vs_off']} > {TRAIN_GRAD_TOL}")
    check(cases["none"]["masks_redrawn_vs_off"]["max_rel"] > TRAIN_GRAD_TOL,
          f"a recompute with new dropout masks moves the grads by only "
          f"{cases['none']['masks_redrawn_vs_off']}: the remat comparison cannot see it")
    return cases


DISPATCH_CALLS = 300   # host-timed calls per reading at the per-call shapes
DISPATCH_ROUNDS = 3    # op, direct, direct, op: this many times
DISPATCH_STEPS = 3     # timed steps (or batches) per reading, after one warm-up


def host_ms(call, n: int) -> float:
    """Host ms per call of call() over n calls, the card drained after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def op_vs_direct(call, n: int) -> dict:
    """call()'s ms with K1's and K5's forwards through their dispatcher
    ops (``named_ops.through_ops``, as under a selective remat policy) and
    called directly (the port's default), in turns (op, direct, direct,
    op; DISPATCH_ROUNDS times): every reading, and the median of each."""
    from merlot_tpu_torch.ops import named_ops
    readings = {"op": [], "direct": []}
    for way in ("op", "direct"):
        with named_ops.through_ops() if way == "op" else contextlib.nullcontext():
            call()
    for _ in range(DISPATCH_ROUNDS):
        for way in ("op", "direct", "direct", "op"):
            with named_ops.through_ops() if way == "op" else contextlib.nullcontext():
                readings[way].append(host_ms(call, n))
    op, direct = (statistics.median(readings[w]) for w in ("op", "direct"))
    return {"readings_ms": readings, "op_ms": op, "direct_ms": direct,
            "op_minus_direct_ms": op - direct}


def dispatch_cost_phase(dev) -> dict:
    """What K1's and K5's forwards cost by going through their dispatcher
    ops (so that a remat policy can name them; the port takes them only
    inside such a checkpoint) against calling the same functions
    directly, on one host in turns: host ms per call at the
    decode step's K1 (8 x 1 over 512 slots) and at a small K5 (64 rows,
    q/k/v), where the host's work outlasts the card's; then per
    pretrain_4seg forward and backward (bench.py's batch, remat off,
    unfused and fused) and per zero-shot batch (pretrain_5seg)."""
    import torch
    from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.merlot import MerlotModel
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.nn.layers import init_params
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.ops import cuda_ln_matmul as lm

    g = torch.Generator(device=dev).manual_seed(21)
    hd = HEADS * D_HEAD
    q = torch.randn((DECODE_B, 1, HEADS, D_HEAD), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((DECODE_B, DECODE_LEN, HEADS, D_HEAD), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    mask = torch.ones((DECODE_B, 1, DECODE_LEN), device=dev)
    x = torch.randn((64, hd), generator=g, device=dev).to(torch.bfloat16)
    gamma, beta = torch.ones(hd, device=dev), torch.zeros(hd, device=dev)
    ws = [0.02 * torch.randn((hd, hd), generator=g, device=dev) for _ in range(3)]
    bs = [torch.zeros(hd, device=dev) for _ in range(3)]
    out = {"per_call": {
        "k1_decode": op_vs_direct(lambda: ca.flash_attention(q, k, v, mask),
                                  DISPATCH_CALLS),
        "k5_qkv_64_rows": op_vs_direct(lambda: lm.ln_matmul(x, gamma, beta, ws, bs),
                                       DISPATCH_CALLS)}}
    del q, k, v, mask, x, ws, bs

    cfg = MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL)
    batch = pretrain_batch(cfg, dev)
    for fused in (False, True):
        model = MerlotPretrainModel(MerlotConfig.from_dict(
            dict(PRETRAIN_4SEG_MODEL, fuse_ln_matmul=fused)), device=dev)
        init_params(model, torch.Generator(device=dev).manual_seed(0))
        with fused_norms() if fused else contextlib.nullcontext():
            out["fused_step" if fused else "step"] = op_vs_direct(
                lambda: remat_step(model, batch, dev), DISPATCH_STEPS)
        del model
        torch.cuda.empty_cache()
    del batch

    zcfg = MerlotConfig.from_dict(PRETRAIN_5SEG_MODEL).eval_mode()
    model = MerlotModel(zcfg, device=dev).eval()
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    fn = make_zero_shot_fn(STORIES, CHUNKS)
    stories = synthetic_stories(0, zcfg.image_size, dev)
    out["zero_shot_batch"] = op_vs_direct(lambda: fn(model, *stories), DISPATCH_STEPS)
    for name, r in out["per_call"].items():
        check(r["op_ms"] > 0 and r["direct_ms"] > 0, f"dispatch cost {name}: {r}")
    return out


def rect_attn_bound(b, sq, sk, masked: bool, backward: bool, heads=HEADS, d=D_HEAD,
                    pairs=None, keys=None) -> tuple:
    """bound() of one bf16 K1 (K2 with ``backward``) call with Sq queries
    over Sk keys: the products over the (query, key) pairs (``pairs``, all
    b*sq*sk by default), each input read once and each output written once.
    ``keys``: the key rows (summed over the batch) the call needs, all b*sk
    by default; K/V and the mask are counted over those rows only (past a
    decode step's live slots the mask is 0 and the probs exactly 0)."""
    pairs = b * sq * sk if pairs is None else pairs
    keys = b * sk if keys is None else keys
    flops = 2 * (5 if backward else 2) * heads * pairs * d
    q_side, k_side = b * sq * heads * d * 2, keys * heads * d * 2
    nbytes = (3 * q_side + 4 * k_side) if backward else (2 * q_side + 2 * k_side)
    nbytes += 4 * sq * keys if masked else 0
    return bound(flops, nbytes, PEAK_BF16_FLOPS)


def rect_kernel_rows(dev) -> tuple:
    """K1 and K2 at cross-attention's shape (Sq 256, Sk 396, a rectangular
    validity mask with fully masked rows) and K1 at the decode step's (Sq 1
    over the 512-slot cache, each element's live slots masked in), bf16
    softmax, against their plain versions under the kernel phases' bounds,
    with their fault probes (the other softmax mode), beside the plain
    versions', SDPA's and the bound's times."""
    import torch
    import torch.nn.functional as F
    from merlot_tpu_torch.ops import cuda_attention as ca

    g = torch.Generator(device=dev).manual_seed(12)
    hd = HEADS * D_HEAD
    b, sq, sk = CROSS_B, CROSS_SQ, CROSS_SK
    q = torch.randn((b, sq, hd), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, sk, hd), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    valid_q = torch.rand((b, sq), generator=g, device=dev) > 0.15
    valid_k = torch.rand((b, sk), generator=g, device=dev) > 0.15
    valid_k[:, 0] = True
    mask = (valid_q[:, :, None] & valid_k[:, None]).float()
    do = (0.1 * torch.randn((b, sq, hd), generator=g, device=dev)).to(torch.bfloat16)
    kw = dict(num_heads=HEADS, softmax_fp32=False)
    stats = ca.new_stats(q, HEADS)
    ctx, _ = ca.attention_fwd_cuda(q, k, v, mask, collect_colsum=False, stats=stats, **kw)
    grads = ca.attention_bwd_cuda(q, k, v, mask, do, None, stats=stats, **kw)
    torch.cuda.synchronize()
    ref, _ = ca.flash_attention_plain(q, k, v, mask, collect_colsum=False, **kw)
    other, _ = ca.flash_attention_plain(q, k, v, mask, collect_colsum=False, num_heads=HEADS,
                                        softmax_fp32=True)
    ref_g = ca.attention_bwd_plain(q, k, v, mask, do, None, **kw)
    other_g = ca.attention_bwd_plain(q, k, v, mask, do, None, num_heads=HEADS,
                                     softmax_fp32=True)
    diff = (ctx.float() - ref.float()).abs()
    bi, qi = torch.nonzero(~valid_q, as_tuple=True)
    uniform = v.float().mean(dim=1)[bi]      # over the true Sk, masked keys too
    bias = ((mask - 1.0) * 1e10).to(q.dtype)[:, None]     # as sdpa_args makes it
    views = [t.view(b, t.shape[1], HEADS, D_HEAD).transpose(1, 2) for t in (q, k, v)]
    leaves = [t.detach().requires_grad_() for t in views]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    do4 = do.view(b, sq, HEADS, D_HEAD).transpose(1, 2)
    cross_fwd = {
        "shape": "cross_k1", "batch": b, "sq": sq, "sk": sk, "softmax": "bf16",
        "max_abs_err": diff.max().item(),
        "max_abs_err_bound": CTX_ULPS * bf16_ulp(ref.float().abs().max().item()),
        "mean_abs_err": diff.mean().item(),
        "other_softmax_mean_abs_diff": (other.float() - ref.float()).abs().mean().item(),
        "masked_row_uniform_err": (ctx[bi, qi].float() - uniform).abs().max().item(),
        "masked_row_uniform_bound": UNIFORM_ULPS * bf16_ulp(uniform.abs().max().item()),
        "ms": cuda_ms(lambda: ca.attention_fwd_cuda(q, k, v, mask, collect_colsum=False,
                                                    stats=stats, **kw)),
        "plain_ms": cuda_ms(lambda: ca.flash_attention_plain(q, k, v, mask,
                                                             collect_colsum=False, **kw)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*views, attn_mask=bias)),
        "library_note": "fp32 softmax (not the bf16-softmax rounding)"}
    cross_fwd["bound_ms"], cross_fwd["bound_by"] = rect_attn_bound(b, sq, sk, True, False)
    cross_bwd = {
        "shape": "cross_k2", "batch": b, "sq": sq, "sk": sk, "softmax": "bf16",
        "grads": grad_errors(grads, ref_g),
        "other_softmax_mean_abs_diff": min(e["mean_abs_err"] for e in
                                           grad_errors(other_g, ref_g).values()),
        "dq_masked_rows_max_abs": grads[0][bi, qi].float().abs().max().item(),
        "ms": cuda_ms(lambda: ca.attention_bwd_cuda(q, k, v, mask, do, None, stats=stats,
                                                    **kw)),
        "plain_ms": cuda_ms(lambda: ca.attention_bwd_plain(q, k, v, mask, do, None, **kw)),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(out, leaves, do4,
                                                          retain_graph=True)),
        "library_note": "backward of scaled_dot_product_attention: fp32 softmax; "
                        "not the same rounding"}
    cross_bwd["max_abs_err"] = max(e["max_abs_err"] for e in cross_bwd["grads"].values())
    cross_bwd["bound_ms"], cross_bwd["bound_by"] = rect_attn_bound(b, sq, sk, True, True)

    # the decode step: one query per element over the cache's 512 slots,
    # live slots up to a position that differs by element
    b, sk = DECODE_B, DECODE_LEN
    pos = DECODE_PREFIX + torch.arange(b, device=dev) * 8
    qd = torch.randn((b, 1, hd), generator=g, device=dev).to(torch.bfloat16)
    kd, vd = (torch.randn((b, sk, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    dmask = (torch.arange(sk, device=dev)[None, None] <= pos[:, None, None]).float()
    dctx, _ = ca.attention_fwd_cuda(qd, kd, vd, dmask, collect_colsum=False, **kw)
    torch.cuda.synchronize()
    dref, _ = ca.flash_attention_plain(qd, kd, vd, dmask, collect_colsum=False, **kw)
    dother, _ = ca.flash_attention_plain(qd, kd, vd, dmask, collect_colsum=False,
                                         num_heads=HEADS, softmax_fp32=True)
    ddiff = (dctx.float() - dref.float()).abs()
    dbias = ((dmask - 1.0) * 1e10).to(qd.dtype)[:, None]
    dviews = [t.view(b, t.shape[1], HEADS, D_HEAD).transpose(1, 2) for t in (qd, kd, vd)]
    decode = {
        "shape": "decode_k1", "batch": b, "sq": 1, "sk": sk, "softmax": "bf16",
        "max_abs_err": ddiff.max().item(),
        "max_abs_err_bound": CTX_ULPS * bf16_ulp(dref.float().abs().max().item()),
        "mean_abs_err": ddiff.mean().item(),
        "other_softmax_mean_abs_diff": (dother.float() - dref.float()).abs().mean().item(),
        "ms": queued_ms(lambda: ca.attention_fwd_cuda(qd, kd, vd, dmask, collect_colsum=False,
                                                      **kw)),
        "plain_ms": queued_ms(lambda: ca.flash_attention_plain(qd, kd, vd, dmask,
                                                               collect_colsum=False, **kw)),
        "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(*dviews,
                                                                       attn_mask=dbias)),
        "library_note": "fp32 softmax over all 512 slots"}
    # over the live slots (what the step needs), and over the whole cache
    live = int((pos + 1).sum().item())
    decode["live_slots"] = live
    decode["bound_ms"], decode["bound_by"] = rect_attn_bound(b, 1, sk, True, False,
                                                             pairs=live, keys=live)
    decode["bound_whole_cache_ms"], _ = rect_attn_bound(b, 1, sk, True, False)
    rows = [cross_fwd, cross_bwd, decode]
    for row in rows:
        print(f"[kernel-rect] {json.dumps(row)}", flush=True)
    for row in (cross_fwd, decode):
        check(row["max_abs_err"] <= row["max_abs_err_bound"],
              f"{row['shape']}: ctx max err {row['max_abs_err']} > {row['max_abs_err_bound']}")
        check(row["mean_abs_err"] <= CTX_MEAN_TOL < row["other_softmax_mean_abs_diff"],
              f"{row['shape']}: ctx mean err {row['mean_abs_err']} (bound {CTX_MEAN_TOL}), "
              f"the other softmax mode {row['other_softmax_mean_abs_diff']}")
    check(cross_fwd["masked_row_uniform_err"] <= cross_fwd["masked_row_uniform_bound"],
          f"cross_k1: fully masked rows not uniform ({cross_fwd['masked_row_uniform_err']})")
    for name, e in cross_bwd["grads"].items():
        check(e["max_abs_err"] <= e["max_abs_err_bound"] and e["mean_abs_err"] <= GRAD_MEAN_TOL,
              f"cross_k2: {name} errors {e}")
    check(cross_bwd["other_softmax_mean_abs_diff"] > GRAD_MEAN_TOL,
          f"cross_k2: the other softmax mode passes the mean bound "
          f"({cross_bwd['other_softmax_mean_abs_diff']})")
    check(cross_bwd["dq_masked_rows_max_abs"] == 0.0,
          f"cross_k2: dQ on fully masked rows is not 0 ({cross_bwd['dq_masked_rows_max_abs']})")
    return rows


def hidden_gap(a, b) -> dict:
    """The largest |a - b| over the largest |b|, and the mean |a - b| over
    the mean |b|."""
    diff, ref = (a.float() - b.float()).abs(), b.float().abs()
    return {"max_rel": (diff.max() / ref.max()).item(),
            "mean_rel": (diff.mean() / ref.mean()).item()}


def cross_and_decode(dev) -> dict:
    """A 12-layer encoder at the joint tower's width (seeded weights):
    cross-attention forward and backward through K1/K2 against the plain
    attention, and the cached decode through K1 at Sq = 1 against the full
    causal forward and against the plain decode, each with a fault probe."""
    import torch
    from merlot_tpu_torch.nn.layers import init_params
    from merlot_tpu_torch.nn.transformer import TransformerEncoder, TransformerHParams
    from merlot_tpu_torch.ops import cuda_attention as ca

    hp = TransformerHParams(hidden_size=HEADS * D_HEAD, num_layers=ENC_LAYERS, num_heads=HEADS,
                            intermediate_size=4 * HEADS * D_HEAD, dtype=torch.bfloat16,
                            softmax_fp32=False)
    enc = TransformerEncoder(hp, device=dev)
    init_params(enc, torch.Generator(device=dev).manual_seed(13))
    g = torch.Generator(device=dev).manual_seed(14)
    b, sq, sk, h = CROSS_B, CROSS_SQ, CROSS_SK, hp.hidden_size
    x = torch.randn((b, sq, h), generator=g, device=dev)
    x_enc = torch.randn((b, sk, h), generator=g, device=dev)
    valid_q = torch.rand((b, sq), generator=g, device=dev) > 0.15
    valid_k = torch.rand((b, sk), generator=g, device=dev) > 0.15
    valid_k[:, 0] = True
    mask = (valid_q[:, :, None] & valid_k[:, None]).float()
    r = torch.randn((b, sq, h), generator=g, device=dev) * valid_q[..., None]

    def fwd_bwd(backend, m=mask):
        enc.zero_grad(set_to_none=True)
        tx, te = (t.clone().requires_grad_() for t in (x, x_enc))
        hid = enc(tx, m, x_enc=te, attn_backend=backend)["hidden_state"]
        (hid.float() * r).sum().backward()
        grads = {n: p.grad.float().clone() for n, p in enc.named_parameters()}
        grads.update(x=tx.grad.float(), x_enc=te.grad.float())
        return hid.detach(), grads

    fwd_bwd("cuda")                                            # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_hid, k_grads = fwd_bwd("cuda")
    torch.cuda.synchronize()
    cross_ms = 1e3 * (time.perf_counter() - t0)
    cross_launches = counts()[:2]
    p_hid, p_grads = fwd_bwd("plain")
    check(counts()[:2] == cross_launches, "the plain cross-attention run launched a kernel")
    nm_hid, nm_grads = fwd_bwd("plain", torch.ones_like(mask))
    cross = {"layers": ENC_LAYERS, "batch": b, "sq": sq, "sk": sk,
             "launches": list(cross_launches), "fwd_bwd_ms": cross_ms,
             "hidden_vs_plain": hidden_gap(k_hid, p_hid),
             "grads_vs_plain": grad_gap(k_grads, p_grads),
             "mask_dropped_hidden_vs_plain": hidden_gap(nm_hid, p_hid),
             "mask_dropped_grads_vs_plain": grad_gap(nm_grads, p_grads)}
    del k_grads, p_grads, nm_grads
    print(f"[cross] {json.dumps(cross)}", flush=True)
    check(cross["launches"] == [ENC_LAYERS, ENC_LAYERS],
          f"cross-attention K1/K2 launches {cross['launches']}, want {ENC_LAYERS} each")
    check(cross["hidden_vs_plain"]["mean_rel"] <= CROSS_HIDDEN_TOL
          < cross["mask_dropped_hidden_vs_plain"]["mean_rel"],
          f"cross-attention hidden states: kernels {cross['hidden_vs_plain']}, mask dropped "
          f"{cross['mask_dropped_hidden_vs_plain']} (bound {CROSS_HIDDEN_TOL})")
    check(cross["grads_vs_plain"]["max_rel"] <= CROSS_GRAD_TOL
          < cross["mask_dropped_grads_vs_plain"]["max_rel"],
          f"cross-attention grads: kernels {cross['grads_vs_plain']}, mask dropped "
          f"{cross['mask_dropped_grads_vs_plain']} (bound {CROSS_GRAD_TOL})")

    # decode: the full causal forward, then a 448-token prefix and 64 tokens
    # one at a time through the cache
    b, n = DECODE_B, DECODE_LEN
    xs = torch.randn((b, n, h), generator=g, device=dev)
    ar = torch.arange(n, device=dev)

    def rows_mask(t0, t1):  # query rows t0..t1-1 over the n slots
        return (ar[None, None] <= ar[t0:t1, None][None]).float().expand(b, -1, -1).contiguous()

    def decode(backend, future=False):
        cache = enc.init_cache(b, n)
        outs = [enc(xs[:, :DECODE_PREFIX], rows_mask(0, DECODE_PREFIX), cache=cache,
                    cache_pos=0, attn_backend=backend)["hidden_state"]]
        spans = []
        for t in range(DECODE_PREFIX, n):
            m = torch.ones((b, 1, n), device=dev) if future else rows_mask(t, t + 1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(enc(xs[:, t:t + 1], m, cache=cache, cache_pos=t,
                            attn_backend=backend)["hidden_state"])
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return torch.cat(outs, dim=1), spans_ms(spans) / (n - DECODE_PREFIX)

    with torch.no_grad():
        full = enc(xs, rows_mask(0, n), attn_backend="cuda")["hidden_state"]
        reset_counts()
        k_dec, k_ms = decode("cuda")
        dec_launches = counts()[0]
        p_dec, p_ms = decode("plain")
        bad, _ = decode("cuda", future=True)
    tail = slice(DECODE_PREFIX, n)
    dec = {"layers": ENC_LAYERS, "batch": b, "prefix": DECODE_PREFIX, "max_len": n,
           "k1_launches": dec_launches, "ms_per_token": k_ms, "plain_ms_per_token": p_ms,
           "prefix_vs_full": hidden_gap(k_dec[:, :DECODE_PREFIX], full[:, :DECODE_PREFIX]),
           "decoded_tokens_vs_full": hidden_gap(k_dec[:, tail], full[:, tail]),
           "decoded_tokens_vs_plain_decode": hidden_gap(k_dec[:, tail], p_dec[:, tail]),
           "future_slots_attended_vs_full": hidden_gap(bad[:, tail], full[:, tail])}
    print(f"[decode] {json.dumps(dec)}", flush=True)
    check(dec_launches == ENC_LAYERS * (1 + n - DECODE_PREFIX),
          f"decode K1 launches {dec_launches}, want {ENC_LAYERS * (1 + n - DECODE_PREFIX)}")
    check(max(dec["decoded_tokens_vs_full"]["mean_rel"],
              dec["decoded_tokens_vs_plain_decode"]["mean_rel"])
          <= DECODE_HIDDEN_TOL < dec["future_slots_attended_vs_full"]["mean_rel"],
          f"decode: against the full forward {dec['decoded_tokens_vs_full']}, against the "
          f"plain decode {dec['decoded_tokens_vs_plain_decode']}, future slots attended "
          f"{dec['future_slots_attended_vs_full']} (bound {DECODE_HIDDEN_TOL})")
    return {"cross": cross, "decode": dec}


def remat_and_cross_phase(dev, weights) -> dict:
    """Per-layer remat at pretrain_4seg (``remat_cases``), then K1/K2 at
    cross-attention's and decode's shapes (``rect_kernel_rows``) and both
    paths through the encoder (``cross_and_decode``)."""
    result = {"remat": remat_cases(dev, weights), "kernel_rows": rect_kernel_rows(dev)}
    result.update(cross_and_decode(dev))
    return result


def kernel_family(name: str) -> str:
    """A coarse family for a kernel name in a profile: this package's
    kernels, library matmuls and convolutions, or everything else
    (elementwise, reductions, norms, copies, RNG). The fp32 routes' mask
    classifier has a family of its own: an fp32 K1 call with a mask
    launches it beside its main kernel (K2's entry does too when it is
    given no saved stats, and K3's fp32 prefill)."""
    low = name.lower()
    if "mask_tile_classes" in low:
        return "K1 mask_tile_classes"
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
# train steps under each torch.profiler window: reading a profile of the
# pretrain step's ~34,000 launches took ~18 s a step with the CPU's
# activity traced too and ~7 s with the card's alone (the same kernels,
# counts and device ms; the host's tracing also stretched the step's wall
# time, 0.94-1.19 s against 0.88-0.91, so it read a larger idle share:
# 0.40-0.52 against 0.35-0.37; H100 80GB HBM3, 700 W). The summaries use
# only the card's kernels, so only the card's activity is traced
PROFILE_STEPS = 1


def profile_activities() -> list:
    """What every torch.profiler window here traces: the card's kernels."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA]


def profile_summary(prof, wall_ms: float, family=kernel_family, **info) -> dict:
    """A finished torch.profiler's device time by kernel family and the
    device's idle share over ``wall_ms`` (the profiler's own overhead
    counts as idle)."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    families = {}
    for e in events:
        fam = family(e.key)
        ms, n = families.get(fam, (0.0, 0))
        families[fam] = (ms + e.self_device_time_total / 1e3, n + e.count)
    total = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:40]
    return {**info, "wall_ms": wall_ms, "device_ms": total,
            "device_idle_share": 1 - total / wall_ms if wall_ms else None,
            "families": {f: {"ms": ms, "launches": n}
                         for f, (ms, n) in sorted(families.items(), key=lambda x: -x[1][0])},
            "top_kernels": [{"name": e.key, "ms": e.self_device_time_total / 1e3,
                             "count": e.count} for e in top]}


def profile_device(run, label: str, family=kernel_family, counted=None, **info) -> dict:
    """torch.profiler over run(): device time by kernel family and the
    device's idle share (``profile_summary``). counted maps a tuple of
    families to a function that reads the wrappers' count of their
    kernels; the profile must hold every launch counted over its run(),
    within PROFILE_TRIES runs, and "tries" says how many it took."""
    import torch
    from torch.profiler import profile

    counted = counted or {}
    for tries in range(1, PROFILE_TRIES + 1):
        before = {fams: read() for fams, read in counted.items()}
        torch.cuda.synchronize()
        with profile(activities=profile_activities()) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        summary = profile_summary(prof, wall_ms, family, **info)
        missing = {"+".join(fams): (read() - before[fams],
                                    sum(summary["families"].get(f, {"launches": 0})["launches"]
                                        for f in fams))
                   for fams, read in counted.items()}
        missing = {k: v for k, v in missing.items() if v[0] != v[1]}
        if not missing:
            break
        print(f"[{label}] profile {tries} holds (counted, profiled) launches {missing}",
              flush=True)
    check(not missing, f"[{label}] no profile in {PROFILE_TRIES} held the launches the "
                       f"wrappers counted: {missing}")
    summary["tries"] = tries
    print(f"[{label}] {json.dumps({k: summary[k] for k in summary if k != 'top_kernels'})}",
          flush=True)
    return summary


def grover_profile_child(ckpt: str, train_files: str, out: str) -> int:
    """``chip_smoke.py --grover-profile CKPT --train-files GLOB --out JSON``:
    the Grover training step's checked profile in a process of its own
    (``profile_steps``: PROFILE_STEPS of grover_train's step function at CKPT's
    weights on the shards' first batch, already on the card, after one
    unprofiled step), written to JSON. In the Grover phase's own process,
    after the earlier phases' profiles, every such profile has lacked the
    records of one layer's forward (one K1 call with its matmuls and
    elementwise kernels); in a fresh process it has held every time."""
    import glob
    import torch
    from merlot_tpu_torch.convert import load_flax_params
    from merlot_tpu_torch.models.grover import GroverConfig, GroverLM
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.tools import grover_train
    from merlot_tpu_torch.tools.grover_data import lm_batches
    from merlot_tpu_torch.train.checkpoint import load_params
    from merlot_tpu_torch.train.train_step import init_train_state, make_loss_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = GroverConfig.from_json_file(str(ROOT / "configs" / "grover_medium.json"))
    model = GroverLM(cfg, device=dev)
    opt = grover_train.grover_optimizer(1e-5, GT_STEPS, GT_REDUCED["num_warmup_steps"][1])
    state = init_train_state(model, opt, seed=0)
    load_flax_params(model, load_params(ckpt))
    step = make_loss_train_step(grover_train.make_grover_loss(cfg, 4.0), opt, device=dev)
    first = next(lm_batches(sorted(glob.glob(train_files)), GT_SEQ, GT_BATCH))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    step(model, state, batch, torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    prof = profile_steps(dev, step, model, state, batch, "grover-train-profile",
                         counted={("K1 attention_fwd",): lambda: ca.launches,
                                  ("K2 attention_bwd",): lambda: 2 * ca.bwd_launches})
    Path(out).write_text(json.dumps(prof))
    return 0


def profile_steps(dev, step, model, state, batch, label: str = "profile",
                  counted=None) -> dict:
    """torch.profiler over PROFILE_STEPS train steps."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)

    def run():
        for _ in range(PROFILE_STEPS):
            step(model, state, batch, g)
    return profile_device(run, label, counted=counted, steps=PROFILE_STEPS)


# ---------------------------------------------------------------------------
# K3 and Grover serving


def stacked_inputs(dev, g, b, sq, sk, pos0, dtype, heads: int = GROVER_HEADS):
    """q, kv ~ N(0, 1) with the cache rows past the last query zero, and the
    causal mask over cache positions [1, Sq, Sk] (one for the batch, as the
    model builds it)."""
    import torch
    hd = heads * GROVER_D
    q = torch.randn((b, sq, hd), generator=g, device=dev).to(dtype)
    kv = torch.randn((b, sk, 2 * hd), generator=g, device=dev).to(dtype)
    kv[:, pos0 + sq:] = 0
    mask = (torch.arange(sk, device=dev)[None]
            <= pos0 + torch.arange(sq, device=dev)[:, None]).float()[None]
    return q, kv, mask


def stacked_bound(b, sq, sk, pos0, dtype, live: bool = True,
                  heads: int = GROVER_HEADS) -> tuple:
    """K3's bound over what the inputs need: with ``live``, the slots below
    kv_len = pos0 + sq (past them the mask is 0 and the probs exactly 0),
    else all Sk slots. Query row r attends to pos0 + r + 1 keys (all Sk
    without ``live``): 4*B*H*D operations per key at the peak of the input
    type; the cache's rows, q and ctx once each in that type and the shared
    mask's columns in fp32."""
    import torch
    hd = heads * GROVER_D
    elem = 2 if dtype == torch.bfloat16 else 4
    slots = pos0 + sq if live else sk
    keys = sum(pos0 + r + 1 for r in range(sq)) if live else sq * sk
    flops = 4 * b * heads * keys * GROVER_D
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

    name, b, sq, sk, pos0, dt, *rest = spec
    heads = rest[0] if rest else GROVER_HEADS
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, kv, mask = stacked_inputs(dev, g, b, sq, sk, pos0, dtype, heads)
    hd = heads * GROVER_D
    live = pos0 + sq
    kw = dict(num_heads=heads, softmax_fp32=True)
    ctx = ca.attention_stacked_fwd_cuda(q, kv, mask, kv_len=live, **kw)
    torch.cuda.synchronize()
    ref = ca.flash_attention_stacked_plain(q, kv, mask, kv_len=live, **kw)

    def errs(x):
        d = (x.float() - ref.float()).abs()
        return d.max().item(), d.mean().item()

    ref_max = ref.float().abs().max().item()
    row = {"shape": name, "batch": b, "sq": sq, "sk": sk, "heads": heads,
           "first_query_pos": pos0, "kv_len": live, "dtype": dt, "ref_max_abs": ref_max,
           "max_abs_err_bound": (CTX_ULPS * bf16_ulp(ref_max) if dt == "bf16"
                                 else STACKED_FP32_RTOL * ref_max)}
    if sq <= ca.DECODE_ROWS:
        row["decode_plan"] = ca.decode_plan(b, heads, sq, sk, GROVER_D, q.element_size())
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
        split = lambda t, s: t.view(b, s, heads, GROVER_D).transpose(1, 2)
        kv3 = kv3[:, :slots]
        bias = ((m[..., :slots] - 1.0) * 1e10).to(dtype)[:, None]
        return F.scaled_dot_product_attention(split(q3, sq), split(kv3[..., :hd], slots),
                                              split(kv3[..., hd:], slots), attn_mask=bias)
    row["library_ms"] = rotating_ms(sdpa, copies)
    row["library_live_ms"] = rotating_ms(lambda *a: sdpa(*a, slots=live), copies)
    row["bound_ms"], row["bound_by"] = stacked_bound(b, sq, sk, pos0, dtype, heads=heads)
    row["bound_whole_cache_ms"], _ = stacked_bound(b, sq, sk, pos0, dtype, live=False,
                                                   heads=heads)
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
    """K3 against its plain version at the six shapes, and at grover-medium's
    8 of 16 heads (model=2)."""
    import torch
    from merlot_tpu_torch import _build

    for k in decode_ptxas(_build.build_logs.get("attention_stacked", "")):
        print(f"[kernel3] ptxas {json.dumps(k)}", flush=True)
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for spec in STACKED_SHAPES + TP_STACKED_SHAPES:
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


def unfuse_qkv(flat: dict) -> dict:
    """A fused_qkv model's leaves -> the split query/key/value form (the
    inverse of grover.fuse_qkv_for_serving)."""
    import numpy as np
    out = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        if parts[1:2] != ["qkv"]:
            out[path] = leaf
            continue
        for name, third in zip(("query", "key", "value"), np.split(leaf, 3, axis=-1)):
            out["/".join([parts[0], name] + parts[2:])] = np.ascontiguousarray(third)
    return out


def launches_per_call(model, run) -> tuple:
    """(run()'s result, K3's launches in each of ``model``'s forward calls)."""
    from merlot_tpu_torch.ops import cuda_attention as ca
    per, forward = [], model.forward

    def counted(*args, **kw):
        before = ca.stacked_launches
        out = forward(*args, **kw)
        per.append(ca.stacked_launches - before)
        return out
    model.forward = counted
    try:
        return run(), per
    finally:
        del model.forward


def server_checkpoint(dev, d: Path) -> tuple:
    """The server's seed weights (grover-medium, fp32, as ``Denoiser`` draws
    them from seed 0 before the serving cast) named as the reference's TF
    variables, converted and written as a params-only checkpoint under
    ``d``: (its params.npz, the checkpoint tools' seconds)."""
    import dataclasses
    import gc
    import torch
    from merlot_tpu_torch.models.grover import GroverConfig, GroverLM
    from merlot_tpu_torch.nn.layers import init_params
    from merlot_tpu_torch.tools.convert_tf_checkpoint import grover_tf_name_map

    cfg = dataclasses.replace(
        GroverConfig.from_json_file(str(ROOT / "configs" / "grover_medium.json")),
        use_bfloat16=True, fused_qkv=True, stacked_kv=True)
    model = GroverLM(cfg, device=dev).eval()
    init_params(model, torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    _, tools_s = through_checkpoint_tools(unfuse_qkv(module_flax_numpy(model)),
                                          grover_tf_name_map(cfg.num_hidden_layers), d)
    tools_s["total_s"] = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return d / "params.npz", tools_s


def server_phase(dev, log_path: Path) -> dict:
    """The port's denoise server with its defaults on weights that came
    through the checkpoint tools (held against the seed weights' server),
    answering concurrent requests over HTTP on 127.0.0.1."""
    import threading
    import urllib.request
    import torch
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.tools.denoise_server import (DenoiseHTTPServer, Denoiser,
                                                       make_handler)

    card = card_line()
    config = str(ROOT / "configs" / "grover_medium.json")
    kw = dict(max_len=SERVER_MAX_LEN, top_p=0.94, bf16=True, max_batch=8,
              batch_window_ms=SERVER_WINDOW_MS, device=dev)
    ckpt, tools_s = server_checkpoint(dev, log_path.parent / "grover_converted")
    t0 = time.perf_counter()
    den = Denoiser(config, str(ckpt), **kw)
    init_s = time.perf_counter() - t0
    seeded = Denoiser(config, None, **dict(kw, batch_window_ms=0.0))
    ctx = torch.randint(100, den.cfg.vocab_size, (1, SERVER_CHECK_CTX),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    got, per_call = launches_per_call(
        den.model, lambda: greedy_logits(den.model, ctx, SERVER_MAX_LEN))
    want = greedy_logits(seeded.model, ctx, SERVER_MAX_LEN)
    converted_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    del seeded
    torch.cuda.empty_cache()
    print(f"[checkpoint-tools] {card}: grover-medium's seed weights through the TF names, "
          f"convert_arrays and save_params_checkpoint in {tools_s['total_s']:.2f} s "
          f"({json.dumps(tools_s)}); the Denoiser on them loaded in {init_s:.2f} s, greedy "
          f"logits equal to the seed weights': {converted_equal}, K3 per call {per_call}",
          flush=True)
    check(converted_equal, "the server's greedy logits from the converted checkpoint differ "
                           "from the seed weights'")
    check(per_call == [24] * (1 + GREEDY_STEPS),
          f"K3 launches per prefill and decode step {per_call}, want 24 each")
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
    result = {"checkpoint_tools": tools_s, "converted_equal": converted_equal,
              "k3_per_call": per_call,
              "init_s": init_s, "requests": SERVER_REQUESTS, "wall_s": wall_s,
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


# ---------------------------------------------------------------------------
# the pretraining CLI from tfrecords


def set_keys(text: str, values: dict, name: str) -> tuple:
    """``text`` (a YAML file's) with the value of each key in ``values``
    replaced (each key must occur once; its comment goes), and what
    changed."""
    import re

    reduced = []
    for key, value in values.items():
        pattern = re.compile(rf"^(\s*{key}:)[ \t]*([^#\n]*?)[ \t]*(#[^\n]*)?$", re.M)
        found = pattern.findall(text)
        check(len(found) == 1, f"{name}: {key} found {len(found)} times")
        reduced.append({"key": key, "yaml": found[0][1], "copy": value})
        text = pattern.sub(lambda m: f"{m.group(1)} {value}", text)
    return text, reduced


def config_copy(name: str, values: dict, added: tuple = (), extra: str = "") -> tuple:
    """configs/<name> with the value of each key in ``values`` replaced
    (each key must occur once; its comment goes), each (section, key,
    value) of ``added`` put at the head of its section, and ``extra``
    appended. Returns the copy's text, what changed, and both files as the
    port's reader reads them."""
    from merlot_tpu_torch.core.config import load_yaml

    src = (ROOT / "configs" / name).read_text()
    text, reduced = set_keys(src, values, name)
    for section, key, value in added:
        head = f"\n{section}:\n"
        check(text.count(head) == 1, f"{name}: section {section} found {text.count(head)} times")
        text = text.replace(head, f"{head}  {key}: {value}\n")
        reduced.append({"key": f"{section}.{key}", "yaml": None, "copy": value})
    text += extra
    return text, reduced, load_yaml(src), load_yaml(text)


def cli_yaml(out_dir: Path, train_glob: str, val_glob: str) -> tuple:
    """A copy of configs/pretrain_4seg.yaml with CLI_REDUCED's keys changed
    and a validate section added, and the list of what changed. The model
    block and the optimizer block but for num_train_steps stay as they are
    (checked with the port's reader)."""
    values = dict(CLI_REDUCED, train_file=f'"{train_glob}"', val_file=f'"{val_glob}"',
                  output_dir=f'"{out_dir}"')
    text, reduced, orig, copy = config_copy(
        "pretrain_4seg.yaml", values,
        extra=f"\nvalidate:\n  eval_samples: {CLI_EVAL_BATCHES * CLI_VAL_BATCH}\n")
    reduced.append({"key": "validate.eval_samples", "yaml": None,
                    "copy": CLI_EVAL_BATCHES * CLI_VAL_BATCH})
    check(copy["model"] == orig["model"]
          and dict(copy["optimizer"], num_train_steps=None)
          == dict(orig["optimizer"], num_train_steps=None),
          "the copy of pretrain_4seg.yaml changed its model or optimizer block")
    return text, reduced


def jpeg_route_check() -> dict:
    """The JPEG routes against the committed fixture (three JPEGs and the
    pixels PIL decodes from them): the machine's default route, libjpeg or
    pil (never nvJPEG where PIL imports), bit for bit; nvJPEG, asked for by
    name where the CUDA toolkit has it, within NVJPEG_MAX_ERR /
    NVJPEG_MEAN_ERR levels; and through each, a CMYK JPEG made here with
    PIL (the decoders refuse it and PIL decodes it, as in the JAX package)
    equal to PIL's pixels."""
    import io
    import numpy as np
    from PIL import Image
    from merlot_tpu_torch.data import _native

    route = _native.jpeg_route()
    check(route in ("libjpeg", "pil"), f"the default JPEG route is {route}, not JAX's pixels")
    routes = [route] + (["nvjpeg"] if _native._nvjpeg_header() is not None else [])
    rgb = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG", quality=90)
    want_cmyk = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    rows, cmyk = {r: [] for r in routes}, {}
    with np.load(ROOT / "merlot_tpu_torch" / "assets" / "jpeg_fixture.npz") as z:
        for r in routes:
            _native.set_jpeg_route(r)
            try:
                for i in range(3):
                    got = _native.decode_jpeg(z[f"jpeg{i}"].tobytes()).astype(np.int16)
                    want = z[f"pixels{i}"].astype(np.int16)
                    check(got.shape == want.shape,
                          f"{r} jpeg fixture {i}: {got.shape} vs {want.shape}")
                    err = np.abs(got - want)
                    rows[r].append({"shape": list(want.shape), "max_abs_err": int(err.max()),
                                    "mean_abs_err": float(err.mean()),
                                    "share_differing": float((err > 0).mean())})
                cmyk[r] = _native.decode_jpeg(buf.getvalue())
            finally:
                _native.set_jpeg_route(None)
    result = {"route": route, "fixture": rows[route],
              "nvjpeg_fixture": rows.get("nvjpeg"),
              "cmyk": {r: {"shape": list(x.shape),
                           "equals_pil": bool(np.array_equal(x, want_cmyk))}
                       for r, x in cmyk.items()}}
    print(f"[jpeg] {json.dumps(result)}", flush=True)
    for r in rows[route]:
        check(r["max_abs_err"] == 0, f"{route} decode differs from the fixture: {rows[route]}")
    for r in rows.get("nvjpeg", []):
        check(r["max_abs_err"] <= NVJPEG_MAX_ERR and r["mean_abs_err"] <= NVJPEG_MEAN_ERR,
              f"nvJPEG decode vs the fixture beyond ({NVJPEG_MAX_ERR}, "
              f"{NVJPEG_MEAN_ERR}): {rows['nvjpeg']}")
    for r, c in result["cmyk"].items():
        check(c["shape"] == [48, 64, 3] and c["equals_pil"], f"{r}: the CMYK JPEG gave {c}")
    return result


def write_cli_shards(d: Path) -> dict:
    """CLI_EXAMPLES training and validation examples of 16 chunks each, in
    CLI_SHARDS shards per split, frames CLI_FRAME_HW, written by the port's
    writer (the machine's JPEG route), one thread per shard."""
    from concurrent.futures import ThreadPoolExecutor
    from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard

    jobs = [(d / f"{split}-{i:02d}.tfrecord", 100 * s + i)
            for s, split in enumerate(("train", "val")) for i in range(CLI_SHARDS)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: write_synthetic_shard(
            str(j[0]), CLI_EXAMPLES // CLI_SHARDS, TRAIN_CHUNKS, seed=j[1],
            img_hw=CLI_FRAME_HW), jobs))
    return {"seconds": time.perf_counter() - t0,
            "bytes": sum(p.stat().st_size for p, _ in jobs),
            "frames": 2 * CLI_EXAMPLES * TRAIN_CHUNKS}


def loader_rate(files, config: dict, threads: int) -> dict:
    """The training loader alone (no device): segments/s over
    CLI_LOADER_BATCHES batches after one."""
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader

    loader = PretrainLoader(files, config, batch_size=TRAIN_BATCH, is_training=True,
                            num_threads=threads,
                            shuffle_buffer=config.get("shuffle_buffer_size", 256))
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(CLI_LOADER_BATCHES):
        next(it)
    dt = time.perf_counter() - t0
    it.close()
    return {"requested_threads": threads, "threads": loader.num_threads,
            "segments_per_s": CLI_LOADER_BATCHES * TRAIN_BATCH * TRAIN_CHUNKS / dt}


def skip_rate(files, config: dict) -> dict:
    """How fast a resumed loader passes over the batches before its start
    (``PretrainLoader.batches(start)``: counted and shuffled, not parsed):
    the time to the first batch from CLI_SKIP_BATCHES on, less the time to
    the first batch from 0, in records passed over per second."""
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader

    first = {}
    for start in (0, CLI_SKIP_BATCHES):
        loader = PretrainLoader(files, config, batch_size=TRAIN_BATCH, is_training=True,
                                num_threads=8,
                                shuffle_buffer=config.get("shuffle_buffer_size", 256))
        t0 = time.perf_counter()
        it = loader.batches(start)
        next(it)
        first[start] = time.perf_counter() - t0
        it.close()
    skip_s = first[CLI_SKIP_BATCHES] - first[0]
    records = CLI_SKIP_BATCHES * TRAIN_BATCH
    return {"batches": CLI_SKIP_BATCHES, "records": records, "first_batch_s": first[0],
            "skip_s": skip_s, "records_per_s": records / skip_s}


def h2d_check(dev, files, config: dict) -> dict:
    """device_iterator's batches on the card equal their host batches
    element for element (bf16 images), with the consumer's stream kept
    busy while the next copies are in flight (a pinned buffer reused too
    early, or a copy from unpinned memory, would show here)."""
    import numpy as np
    import torch
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader, device_iterator

    loader = PretrainLoader(files, config, batch_size=TRAIN_BATCH, is_training=True,
                            num_threads=8, shuffle_buffer=config.get("shuffle_buffer_size", 256))
    host = []

    def tee():
        for b in loader:
            host.append({k: np.array(v, copy=True) for k, v in b.items()})
            yield b

    it = device_iterator(tee(), dev)
    pinned = []
    for i in range(CLI_H2D_BATCHES):
        torch.cuda._sleep(50_000_000)  # ~30 ms of work on the consumer's stream
        batch = next(it)
        pinned.append(all(v.device.type == "cuda" for v in batch.values()))
        for k, v in batch.items():
            want = torch.from_numpy(host[i][k])
            if k == "images":
                want = want.to(torch.bfloat16)
            check(v.dtype == want.dtype and torch.equal(v.cpu(), want),
                  f"h2d: batch {i} key {k} differs from its host batch")
    it.close()
    return {"batches": CLI_H2D_BATCHES, "equal": True, "on_device": all(pinned)}


def synthetic_step_rate(dev) -> dict:
    """chip_smoke's synthetic-batch train step at the CLI's batch: a fresh
    model from seed 0, CLI_SYNTH_WARMUP steps, then CLI_SYNTH_STEPS timed
    alone on the host clock."""
    import torch
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
    from merlot_tpu_torch.train.train_step import init_train_state, make_train_step

    cfg = MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL)
    model = MerlotPretrainModel(cfg, device=dev)
    opt = MerlotAdamW(AdamWConfig.from_config(PRETRAIN_4SEG_OPTIMIZER))
    state = init_train_state(model, opt, seed=0)
    batch = pretrain_batch(cfg, dev)
    step = make_train_step(model, opt)
    g = torch.Generator(device=dev).manual_seed(1)
    for _ in range(CLI_SYNTH_WARMUP):
        step(model, state, batch, g)
    torch.cuda.synchronize()
    wall = []
    for _ in range(CLI_SYNTH_STEPS):
        t0 = time.perf_counter()
        step(model, state, batch, g)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    del model, state, step, batch, opt
    torch.cuda.empty_cache()
    segments = TRAIN_BATCH * TRAIN_CHUNKS
    return {"step_seconds": wall, "segments_per_s": segments / statistics.median(wall)}


def jsonl(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines() if x.strip()]


@contextlib.contextmanager
def cli_tf32():
    """torch's defaults for TF32 (matmuls off, cuDNN on), as the CLI's own
    process runs with them."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def feed_rates(dev, config, files, out: Path) -> list:
    """The Trainer over one pretrain_4seg model (fresh from seed 0) fed three
    ways, one after another, each for CLI_FEED_STEPS steps after two, read
    as the median of its logged perf/steps_per_sec: batches put on the card
    before the run (no loader running during the steps), then the live
    loader at the config's num_threads and at half the cores. No checkpoint
    is written."""
    import torch
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader, device_iterator
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.train import checkpoint as ckpt_mod
    from merlot_tpu_torch.train.harness import Trainer
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW

    merged = config.merged_data_model()
    model = MerlotPretrainModel(MerlotConfig.from_dict(config.model), device=dev)
    opt = MerlotAdamW(AdamWConfig.from_config(config.optimizer))
    threads = config.data["num_threads"]
    cores = len(os.sched_getaffinity(0))
    state, runs = None, []
    with cli_tf32(), wrapped(ckpt_mod.CheckpointManager, "save", lambda save: lambda *a, **k: None):
        for feed, n in (("preloaded", threads), ("live", threads), ("live", max(1, cores // 2))):
            loader = PretrainLoader(files, merged, batch_size=TRAIN_BATCH, is_training=True,
                                    num_threads=n,
                                    shuffle_buffer=merged.get("shuffle_buffer_size", 256))
            batches = device_iterator(iter(loader), dev)
            if feed == "preloaded":
                held = [next(batches) for _ in range(CLI_FEED_STEPS + 2)]
                batches.close()
                torch.cuda.synchronize()
                batches = iter(held)
            trainer = Trainer(model, opt, output_dir=str(out / f"feed{len(runs)}"), log_every=1,
                              checkpoint_every=10 ** 9, device=dev)
            state = trainer.init_state() if state is None else state
            state = trainer.run(state, batches, num_steps=state["step"] + CLI_FEED_STEPS + 2)
            if hasattr(batches, "close"):
                batches.close()
            rates = [x["perf/steps_per_sec"]
                     for x in jsonl(out / f"feed{len(runs)}" / "train_metrics.jsonl")][2:]
            check(len(rates) == CLI_FEED_STEPS, f"feed run {feed}: {len(rates)} timed steps")
            runs.append({"feed": feed, "threads": loader.num_threads,
                         "segments_per_s": TRAIN_BATCH * TRAIN_CHUNKS * statistics.median(rates),
                         "steps_per_sec": rates})
            print(f"[cli-feed] {json.dumps(runs[-1])}", flush=True)
    return runs


def run_module(module: str, args, cwd: Path, log: Path, env: dict = None) -> tuple:
    """``python -m module args`` (a path, or a list of arguments) in a
    subprocess from ``cwd`` with this checkout on its path and ``env``'s
    variables added: (exit code, seconds, its output)."""
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    argv = [str(a) for a in (args if isinstance(args, (list, tuple)) else [args])]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=cwd, env=env,
                              stdout=f, stderr=subprocess.STDOUT, timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    text = log.read_text()
    print(f"[{module}] output (last 3000 characters):\n{text[-3000:]}", flush=True)
    return proc.returncode, seconds, text


def counting_steps(per_step: list, windows: list):
    """A wrapper for a step factory (``harness.make_train_step``,
    ``make_loss_train_step``): every step it builds appends (step, K1
    launches, K2 launches) to ``per_step``, and the first step of each
    window of CLI_PROFILE_WINDOWS starts a torch.profiler that the window's
    last step stops (appended to ``windows``, its wall time taken from just
    after the start). The profiles are read after the run
    (``window_profiles``): reading one takes seconds that would stall the
    steps after it."""
    import torch
    from torch.profiler import profile
    from merlot_tpu_torch.ops import cuda_attention as ca

    def counting(make):
        def make_counted(*args, **kw):
            step = make(*args, **kw)

            def counted(model, opt_state, batch, generator, **kw2):
                n = opt_state["step"] + 1
                for w in CLI_PROFILE_WINDOWS:
                    if n == w[0]:
                        torch.cuda.synchronize()
                        prof = profile(activities=profile_activities())
                        prof.start()
                        windows.append({"steps": w, "prof": prof, "t0": time.perf_counter()})
                before = (ca.launches, ca.bwd_launches)
                out = step(model, opt_state, batch, generator, **kw2)
                per_step.append((n, ca.launches - before[0], ca.bwd_launches - before[1]))
                if windows and n == windows[-1]["steps"][-1]:
                    torch.cuda.synchronize()
                    windows[-1]["wall_ms"] = 1e3 * (time.perf_counter() - windows[-1]["t0"])
                    windows[-1]["prof"].stop()
                return out
            return counted
        return make_counted
    return counting


def window_summary(per_step: list, w: dict, label: str) -> dict:
    """One ``counting_steps`` window's profile, with its (profiled,
    counted) K1/K2 launches (a K2 call launches two kernels, the rows and
    the column kernel) and whether it held them all."""
    summary = profile_summary(w["prof"], w["wall_ms"], steps=len(w["steps"]))
    mine = [s for s in per_step if s[0] in w["steps"]]
    counted = {"K1 attention_fwd": sum(s[1] for s in mine),
               "K2 attention_bwd": 2 * sum(s[2] for s in mine)}
    summary["steps"] = list(w["steps"])
    summary["profiled_vs_counted"] = {
        fam: (summary["families"].get(fam, {"launches": 0})["launches"], n)
        for fam, n in counted.items()}
    summary["held_all"] = all(got == want for got, want
                              in summary["profiled_vs_counted"].values())
    print(f"[{label}] {json.dumps({k: v for k, v in summary.items() if k != 'top_kernels'})}",
          flush=True)
    return summary


def window_summaries(per_step: list, windows: list, label: str) -> list:
    """The profiles of all of ``counting_steps``' windows (``window_summary``)."""
    check([w["steps"] for w in windows] == list(CLI_PROFILE_WINDOWS),
          f"[{label}] profiled {[w['steps'] for w in windows]}")
    profiles = [window_summary(per_step, w, label) for w in windows]
    windows.clear()
    return profiles


def window_profiles(per_step: list, windows: list, label: str) -> tuple:
    """The windows' profiles read in order up to the first that held every
    counted launch (a later window is a retake, not read when not needed),
    and that one."""
    check([w["steps"] for w in windows] == list(CLI_PROFILE_WINDOWS),
          f"[{label}] profiled {[w['steps'] for w in windows]}")
    profiles = []
    for w in windows:
        profiles.append(window_summary(per_step, w, label))
        if profiles[-1]["held_all"]:
            break
    windows.clear()
    check(profiles[-1]["held_all"],
          f"[{label}] no profile held the K1/K2 launches counted in its window: "
          f"{[(p['steps'], p['profiled_vs_counted']) for p in profiles]}")
    return profiles, profiles[-1]


def cli_phase(dev, tmp: Path) -> dict:
    """The pretraining entry point at full pretrain_4seg width from
    tfrecords: run A (`python -m merlot_tpu_torch.train.pretrain a.yaml`
    in a subprocess: 8 steps, checkpoints at 4 and 8, then the held-out
    evaluation), the synthetic-batch step before A and after the feed runs
    that follow it (``feed_rates``), the loader alone, its resume skip and
    its copy to the card, then run B (pretrain.main in this
    process from A's ckpt_4: steps 5-8 with the kernels' counters and a
    profile of one step) against A, and A's ckpt_8 loaded into a fresh
    model against A's evaluation."""
    import gc
    import shutil
    import numpy as np
    import torch
    from merlot_tpu_torch.convert import flax_layout, flax_path, load_flax_params
    from merlot_tpu_torch.core.config import NeatConfig
    from merlot_tpu_torch.data import _native
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader, device_iterator
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.train import checkpoint as ckpt_mod
    from merlot_tpu_torch.train import harness, pretrain
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW

    card = card_line()
    jpeg = jpeg_route_check()
    shards = tmp / "shards"
    shards.mkdir()
    data = write_cli_shards(shards)
    yamls = {}
    for name in ("a", "b"):
        text, reduced = cli_yaml(tmp / name, f"{shards}/train-*.tfrecord",
                                 f"{shards}/val-*.tfrecord")
        yamls[name] = tmp / f"{name}.yaml"
        yamls[name].write_text(text)
    config = NeatConfig.from_yaml(str(yamls["a"]))
    merged = config.merged_data_model()
    train_files = config.data["train_file_expanded"]
    check(len(train_files) == CLI_SHARDS and len(config.data["val_file_expanded"]) == CLI_SHARDS,
          f"the copy's globs matched {config.data}")

    # the loader alone (no device), at the config's num_threads and at the
    # cores this process gets (the loader caps its threads there)
    cores = len(os.sched_getaffinity(0))
    loader = [loader_rate(train_files, merged, n)
              for n in dict.fromkeys((config.data["num_threads"], cores))]
    # at the cores, the default JPEG route and nvJPEG in turns
    by_route = {jpeg["route"]: [], "nvjpeg": []} if jpeg["nvjpeg_fixture"] else {}
    for route in (jpeg["route"], "nvjpeg", "nvjpeg", jpeg["route"]) if by_route else ():
        _native.set_jpeg_route(route)
        by_route[route].append(loader_rate(train_files, merged, cores)["segments_per_s"])
    _native.set_jpeg_route(None)
    loader_routes = {r: statistics.mean(x) for r, x in by_route.items()}
    print(f"[cli-jpeg-routes] {json.dumps(by_route)}", flush=True)
    skip = skip_rate(train_files, merged)
    print(f"[cli-skip] {json.dumps(skip)}", flush=True)
    h2d = h2d_check(dev, train_files, merged)

    # run A through the normal entry point, between two synthetic-step runs
    gc.collect()
    torch.cuda.empty_cache()
    synthetic = [synthetic_step_rate(dev)]
    rc, a_seconds, _ = run_module("merlot_tpu_torch.train.pretrain", yamls["a"], ROOT,
                                  tmp / "a.log")
    check(rc == 0, f"run A exited {rc}")
    feeds = feed_rates(dev, config, train_files, tmp / "feed")
    gc.collect()
    torch.cuda.empty_cache()
    synthetic.append(synthetic_step_rate(dev))

    a_lines = jsonl(tmp / "a" / "train_metrics.jsonl")
    a_train = {x["step"]: x for x in a_lines if "loss" in x}
    a_eval = [x for x in a_lines if "eval/loss" in x]
    check(sorted(a_train) == list(range(1, CLI_STEPS + 1)),
          f"run A logged steps {sorted(a_train)}, want 1..{CLI_STEPS}")
    check(len(a_eval) == 1, f"run A logged {len(a_eval)} evaluations")
    for x in a_lines:
        bad = {k: v for k, v in x.items() if not math.isfinite(v)}
        check(not bad, f"run A step {x['step']}: non-finite metrics {bad}")
    a_ckpt = ckpt_mod.CheckpointManager(str(tmp / "a" / "checkpoints"))
    check(a_ckpt.all_steps() == list(range(CLI_CKPT_EVERY, CLI_STEPS + 1, CLI_CKPT_EVERY)),
          f"run A's checkpoints at {a_ckpt.all_steps()}")
    rate = [a_train[s]["perf/steps_per_sec"] for s in range(3, CLI_STEPS + 1)]
    segments = TRAIN_BATCH * TRAIN_CHUNKS

    # run B: A's ckpt_4 in a fresh output directory, in this process, with
    # the kernels' counters per step and torch.profiler over one step
    resume_from = CLI_CKPT_EVERY
    (tmp / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(a_ckpt.path(resume_from), tmp / "b" / "checkpoints" / f"ckpt_{resume_from}",
                    copy_function=os.link)  # hard links: no file is rewritten
    per_step, windows, ckpt_s = [], [], []
    counting = counting_steps(per_step, windows)

    def timed_save(save):
        def timed(self, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            save(self, *args, **kw)
            ckpt_s.append(time.perf_counter() - t)
        return timed

    # B runs with torch's defaults for TF32, as A's process does
    with cli_tf32():
        ca.launches = ca.bwd_launches = ca.stacked_launches = 0
        with wrapped(harness, "make_train_step", counting), \
                wrapped(ckpt_mod.CheckpointManager, "save", timed_save):
            t0 = time.perf_counter()
            b = pretrain.main([str(yamls["b"])])
            b_seconds = time.perf_counter() - t0
    launches = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches,
                "attention_stacked": ca.stacked_launches}
    profiles, prof = window_profiles(per_step, windows, "cli-profile")

    b_lines = jsonl(tmp / "b" / "train_metrics.jsonl")
    b_train = {x["step"]: x for x in b_lines if "loss" in x}
    b_eval = [x for x in b_lines if "eval/loss" in x]
    for x in b_lines:
        bad = {k: v for k, v in x.items() if not math.isfinite(v)}
        check(not bad, f"run B step {x['step']}: non-finite metrics {bad}")
    check(sorted(b_train) == list(range(resume_from + 1, CLI_STEPS + 1)),
          f"run B logged steps {sorted(b_train)}: it did not resume at {resume_from}")
    check([n for n, *_ in per_step] == list(range(resume_from + 1, CLI_STEPS + 1)),
          f"run B stepped {[n for n, *_ in per_step]}")
    check(all(k1 == k2 == LAUNCHES_PER_STEP for _, k1, k2 in per_step),
          f"run B's K1/K2 launches per step {per_step}, want {LAUNCHES_PER_STEP} each")
    b_ckpt = ckpt_mod.CheckpointManager(str(tmp / "b" / "checkpoints"))
    check(b_ckpt.all_steps() == [resume_from, CLI_STEPS], f"run B's checkpoints {b_ckpt.all_steps()}")

    # B against A: the losses of steps 5-8, the step-8 parameters (the gap
    # over how far A's parameters moved from step 4 to 8) and the evaluation
    loss_gap = max(abs(b_train[s]["loss"] - a_train[s]["loss"]) / abs(a_train[s]["loss"])
                   for s in b_train)
    a4 = ckpt_mod.load_params(a_ckpt.path(resume_from))
    a8 = ckpt_mod.load_params(a_ckpt.path(CLI_STEPS))
    model_b = b["trainer"].model
    diff_sq = move_sq = 0.0
    param_max = 0.0
    for name, p in model_b.named_parameters():
        got = flax_layout(name, p.detach().float().cpu().numpy()).astype(np.float64)
        want, start = a8[flax_path(name)].astype(np.float64), a4[flax_path(name)]
        diff_sq += float(((got - want) ** 2).sum())
        move_sq += float(((want - start) ** 2).sum())
        param_max = max(param_max, float(np.abs(got - want).max()))
    param_rel = math.sqrt(diff_sq) / math.sqrt(move_sq)
    eval_gap = abs(b_eval[0]["eval/loss"] - a_eval[0]["eval/loss"]) / abs(a_eval[0]["eval/loss"])
    del b, model_b
    gc.collect()
    torch.cuda.empty_cache()

    # A's ckpt_8, loaded by convert.load_flax_params into a fresh model,
    # evaluated as the CLI evaluates
    fresh = MerlotPretrainModel(MerlotConfig.from_dict(config.model), device=dev)
    load_flax_params(fresh, a8)
    reload_dir = tmp / "reload"
    trainer = harness.Trainer(fresh, MerlotAdamW(AdamWConfig.from_config(config.optimizer)),
                              output_dir=str(reload_dir), device=dev)
    val = PretrainLoader(config.data["val_file_expanded"], merged, batch_size=CLI_VAL_BATCH,
                         is_training=False, num_threads=config.data["num_threads"],
                         shuffle_buffer=0, repeat=False)
    with cli_tf32():
        reload_means = trainer.evaluate(device_iterator(iter(val), dev),
                                        max_batches=CLI_EVAL_BATCHES)
    reload_gap = abs(reload_means["loss"] - a_eval[0]["eval/loss"]) / abs(a_eval[0]["eval/loss"])
    del trainer, fresh
    gc.collect()
    torch.cuda.empty_cache()

    ckpt_dir = Path(a_ckpt.path(CLI_STEPS))
    result = {
        "card": card, "jpeg_route": jpeg["route"], "jpeg_fixture": jpeg["fixture"],
        "jpeg": jpeg, "loader_by_jpeg_route": by_route,
        "loader_by_jpeg_route_mean": loader_routes,
        "reduced": reduced, "data": data,
        "cli_segments_per_s": segments * statistics.median(rate),
        "cli_steps_per_sec_3_to_8": rate,
        "synthetic_segments_per_s": [r["segments_per_s"] for r in synthetic],
        "synthetic_step_seconds": [r["step_seconds"] for r in synthetic],
        "loader_alone": loader, "resume_skip": skip, "feeds": feeds, "h2d": h2d,
        "run_a_seconds": a_seconds, "run_b_seconds": b_seconds,
        "a_losses": {s: a_train[s]["loss"] for s in sorted(a_train)},
        "b_losses": {s: b_train[s]["loss"] for s in sorted(b_train)},
        "a_eval": {k: v for k, v in a_eval[0].items() if k.startswith("eval/")},
        "b_eval_loss": b_eval[0]["eval/loss"],
        "resume_loss_rel_gap": loss_gap, "resume_param_rel_gap": param_rel,
        "resume_param_max_abs_gap": param_max, "resume_eval_rel_gap": eval_gap,
        "reload_eval_loss": reload_means["loss"], "reload_eval_rel_gap": reload_gap,
        "launches": launches, "launches_per_step": per_step,
        "device_idle_share": prof["device_idle_share"], "profile": prof,
        "profiles_held_all": [p["held_all"] for p in profiles],
        "checkpoint_seconds": ckpt_s,
        "checkpoint_bytes": sum(f.stat().st_size for f in ckpt_dir.iterdir())}
    print(f"[cli] {json.dumps({k: v for k, v in result.items() if k != 'profile'})}",
          flush=True)
    print(f"[cli] {card}: {result['cli_segments_per_s']:.2f} segments/s through the CLI; "
          f"synthetic-batch step {result['synthetic_segments_per_s']} before and after; "
          f"loader alone {[round(r['segments_per_s'], 2) for r in loader]} at "
          f"{[r['threads'] for r in loader]} threads, by JPEG route {loader_routes}; "
          f"Trainer fed "
          f"{[(r['feed'], r['threads'], round(r['segments_per_s'], 2)) for r in feeds]}; "
          f"resume skip {skip['records_per_s']:.0f} records/s; B's device idle "
          f"{prof['device_idle_share']:.3f} (steps {prof['steps']}); JPEG route {jpeg['route']}; checkpoint "
          f"{ckpt_s} s for {result['checkpoint_bytes']} bytes", flush=True)
    check(all(math.isfinite(v) for v in result["a_eval"].values())
          and all(math.isfinite(v) for v in reload_means.values()), "non-finite eval means")
    check(loss_gap <= RESUME_LOSS_RTOL, f"run B's losses vs A's: {loss_gap} > {RESUME_LOSS_RTOL}")
    check(param_rel <= RESUME_PARAM_REL,
          f"run B's step-{CLI_STEPS} params vs A's: {param_rel} > {RESUME_PARAM_REL}")
    check(reload_gap <= RELOAD_EVAL_RTOL,
          f"A's ckpt_{CLI_STEPS} reloaded: eval loss gap {reload_gap} > {RELOAD_EVAL_RTOL}")
    return result


# ---------------------------------------------------------------------------
# the downstream entry points: the zero-shot CLI and VCR


def zero_shot_cli_yaml(out_dir: Path, val_glob: str) -> tuple:
    """A copy of configs/pretrain_5seg.yaml with ZS_CLI_REDUCED's keys and
    the paths changed; its model block stays as it is."""
    values = dict(ZS_CLI_REDUCED, val_file=f'"{val_glob}"', output_dir=f'"{out_dir}"')
    text, reduced, orig, copy = config_copy("pretrain_5seg.yaml", values)
    check(copy["model"] == orig["model"], "the copy of pretrain_5seg.yaml changed its model block")
    return text, reduced


def save_fresh_pretrain(cfg, opt_block: dict, path: Path, dev) -> float:
    """A MerlotPretrainModel at ``cfg``, initialised from seed 0, saved as
    a port checkpoint at ``path`` (its tree roots at merlot/); returns the
    seconds the save took."""
    import gc
    import torch
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.train.checkpoint import save_checkpoint
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
    from merlot_tpu_torch.train.train_step import init_train_state

    model = MerlotPretrainModel(cfg, device=dev)
    state = init_train_state(model, MerlotAdamW(AdamWConfig.from_config(opt_block)), seed=0)
    t0 = time.perf_counter()
    save_checkpoint(str(path), dict(model.named_parameters()), state)
    seconds = time.perf_counter() - t0
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return seconds


def module_flax_numpy(model) -> dict:
    """A module's parameters by flax path, in the flax layout, on the host
    (their axes moved on the card)."""
    from merlot_tpu_torch.convert import flax_axes, flax_path
    return {flax_path(n): p.detach().permute(flax_axes(n, p.dim())).contiguous().cpu().numpy()
            for n, p in model.named_parameters()}


def tf_named(flat: dict, name_map: dict) -> dict:
    """Flax-path leaves named as the reference's TF variables: the inverse
    of a TF name map, which must cover them one for one."""
    check(len(set(name_map.values())) == len(name_map) and set(name_map.values()) == set(flat),
          f"the TF name map does not cover the model one for one: "
          f"{sorted(set(flat) ^ set(name_map.values()))[:5]}")
    return {tf: flat[ours] for tf, ours in name_map.items()}


def through_checkpoint_tools(flat: dict, name_map: dict, path: Path) -> tuple:
    """``flat`` named as TF variables, converted and written as a
    params-only checkpoint at ``path``: (the TF-named arrays, seconds per
    step)."""
    from merlot_tpu_torch.tools.convert_tf_checkpoint import convert_arrays
    from merlot_tpu_torch.train.checkpoint import save_params_checkpoint
    t0 = time.perf_counter()
    arrays = tf_named(flat, name_map)
    t1 = time.perf_counter()
    converted = convert_arrays(arrays, name_map, verbose=False)
    t2 = time.perf_counter()
    save_params_checkpoint(str(path), converted)
    t3 = time.perf_counter()
    return arrays, {"to_tf_names_s": t1 - t0, "convert_s": t2 - t1, "write_s": t3 - t2}


def zero_shot_cli_phase(dev, tmp: Path, slice_stories_per_s: float) -> dict:
    """The zero-shot CLI at pretrain_5seg width: the port's writer makes
    ZS_CLI_STORIES synthetic stories in all 120 orderings; a fresh
    pretrain model's weights go through the TF names and the converter
    into a params-only ckpt_0; `python -m
    merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits zs.yaml`
    runs in a subprocess and its .npz is scored; the same loader batches
    then go through make_zero_shot_fn in this process, on the model
    object's own weights, with K1's counter and CUDA events per batch: its
    probs must equal the CLI's bit for bit (K1 is deterministic); then the
    swap probes (ZS_CLI_SWAPS)."""
    import gc
    import numpy as np
    import torch
    from merlot_tpu_torch.convert import load_flax_params
    from merlot_tpu_torch.core.config import NeatConfig
    from merlot_tpu_torch.downstream.sort_story.data import write_synthetic_story_shard
    from merlot_tpu_torch.downstream.sort_story.dataloader import story_batches
    from merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits import merlot_subtree
    from merlot_tpu_torch.downstream.sort_story.score_permutations import score_file
    from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.merlot import MerlotModel
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.nn.layers import init_params
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.tools.convert_tf_checkpoint import convert_arrays, merlot_tf_name_map
    from merlot_tpu_torch.train.checkpoint import CheckpointManager

    card = card_line()
    d = tmp / "zero_shot_cli"
    (d / "run").mkdir(parents=True)
    shard = d / "val-00.tfrecord"
    t0 = time.perf_counter()
    records = write_synthetic_story_shard(str(shard), num_stories=ZS_CLI_STORIES,
                                          just_one_perm=False, seed=0, img_hw=ZS_CLI_FRAME_HW,
                                          pad_to_batch_size=ZS_CLI_BATCH)
    write_s = time.perf_counter() - t0
    text, reduced = zero_shot_cli_yaml(d / "out", str(shard))
    (d / "zs.yaml").write_text(text)
    config = NeatConfig.from_yaml(str(d / "zs.yaml"))
    cfg = MerlotConfig.from_dict(config.model)
    ckpt = CheckpointManager(str(d / "out" / "checkpoints"))
    # the model's weights as the released TF checkpoints name them, through
    # the converter into the CLI's ckpt_0
    pretrain = MerlotPretrainModel(cfg, device=dev)
    init_params(pretrain, torch.Generator(device=dev).manual_seed(0))
    name_map = merlot_tf_name_map(cfg)
    t0 = time.perf_counter()
    tf_arrays, tools_s = through_checkpoint_tools(module_flax_numpy(pretrain), name_map,
                                                  Path(ckpt.path(0)))
    tools_s["total_s"] = time.perf_counter() - t0
    check(ckpt.latest_step() == 0 and sorted(os.listdir(ckpt.path(0))) == [
        "meta.json", "params.npz"], "the converter's writer left no params-only ckpt_0")

    rc, cli_s, log = run_module("merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits",
                                d / "zs.yaml", d / "run", d / "cli.log")
    check(rc == 0, f"the zero-shot CLI exited {rc}")
    npz = d / "run" / "logits_val.npz"
    metrics = score_file(str(npz))

    # the same batches in this process, on the model object's own weights
    # (never written), with torch's TF32 defaults as the CLI's process has
    # them
    model = MerlotModel(cfg.eval_mode(), device=dev).eval()
    model.load_state_dict(pretrain.merlot.state_dict())
    del pretrain
    fn = make_zero_shot_fn(ZS_CLI_BATCH, CHUNKS)
    merged = {"num_chunks": CHUNKS, "image_size": list(cfg.image_size)}
    first, seconds, k1_ms, per_batch = {}, [], [], []
    with cli_tf32():
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        batches = story_batches(config.data["val_file_expanded"], merged, ZS_CLI_BATCH)
        t_all = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            spans: list = []
            before = ca.launches
            with wrapped(ca, "attention_fwd_cuda", event_timed(spans)):
                out = fn(model, torch.from_numpy(batch["images"]).to(dev),
                         torch.from_numpy(batch["sentences"]).to(dev))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if not per_batch:
                first_batch = (batch, out)
            seconds.append(time.perf_counter() - t0)
            k1_ms.append(spans_ms(spans))
            per_batch.append(ca.launches - before)
            for i, sid in enumerate(batch["story_id"]):
                first.setdefault(str(int(sid)), {k: v[i] for k, v in out.items()})
        loop_s = time.perf_counter() - t_all
        launches = ca.launches

        # the fault probes: two same-shaped TF variables swapped before
        # converting, the first batch's probs against the model's
        t0 = time.perf_counter()
        batch, want = first_batch
        swap_gap = {}
        for probe, (a, b) in ZS_CLI_SWAPS.items():
            swapped = dict(tf_arrays)
            swapped[a], swapped[b] = tf_arrays[b], tf_arrays[a]
            load_flax_params(model, merlot_subtree(convert_arrays(swapped, name_map,
                                                                  verbose=False)))
            got = fn(model, torch.from_numpy(batch["images"]).to(dev),
                     torch.from_numpy(batch["sentences"]).to(dev))
            swap_gap[probe] = max(float(np.abs(got[k].cpu().numpy() - want[k]).max())
                                  for k in want)
        tools_s["swap_probes_s"] = time.perf_counter() - t0
    del model, tf_arrays, swapped
    gc.collect()
    torch.cuda.empty_cache()

    with np.load(npz) as z:
        stories = sorted({k.split("/")[0] for k in z.files}, key=int)
        equal = all(np.array_equal(z[f"{sid}/{name}"], first[sid][name])
                    for sid in stories for name in first[sid])
        probs = np.stack([z[f"{sid}/{name}_probs"] for sid in stories
                          for name in ("lang_viz", "viz_viz")])
    examples = records - records % ZS_CLI_BATCH
    result = {"card": card, "reduced": reduced, "records": records, "write_s": write_s,
              "checkpoint_tools": tools_s, "swap_probe_gaps": swap_gap,
              "stories": stories, "scores": metrics,
              "cli_seconds": cli_s, "cli_wall_stories_per_s": examples / cli_s,
              "batches": len(per_batch), "launches": launches,
              "launches_per_batch": sorted(set(per_batch)),
              "stories_per_s": ZS_CLI_BATCH / statistics.median(seconds),
              "loop_stories_per_s": examples / loop_s,
              "slice_stories_per_s": slice_stories_per_s,
              "k1_ms_per_batch": statistics.median(k1_ms),
              "cli_equals_in_process": equal,
              "probs_min": float(probs.min()), "probs_max": float(probs.max())}
    print(f"[zero-shot-cli] {json.dumps(result)}", flush=True)
    print(f"[checkpoint-tools] {card}: pretrain_5seg through the TF names, convert_arrays and "
          f"save_params_checkpoint in {tools_s['total_s']:.2f} s ({json.dumps(tools_s)}); the swap "
          f"probes moved the probs by {json.dumps(swap_gap)}", flush=True)
    print(f"[zero-shot-cli] {card}: {result['stories_per_s']:.2f} stories/s through the "
          f"loader and make_zero_shot_fn (median batch of {ZS_CLI_BATCH}), "
          f"{result['cli_wall_stories_per_s']:.2f} over the CLI's whole process "
          f"({cli_s:.1f} s for {examples} story orderings); the slice phase's synthetic "
          f"batches {slice_stories_per_s:.2f}", flush=True)
    check(stories == [str(i) for i in range(ZS_CLI_STORIES)],
          f"the CLI wrote stories {stories}, want {ZS_CLI_STORIES}")
    check(f"wrote {ZS_CLI_STORIES} stories" in log, "the CLI did not report its stories")
    check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
          f"the CLI's probs outside [0, 1]: {probs.min()} .. {probs.max()}")
    check(per_batch == [LAUNCHES_PER_BATCH] * (examples // ZS_CLI_BATCH),
          f"in-process K1 launches per batch {sorted(set(per_batch))} over {len(per_batch)} "
          f"batches, want {LAUNCHES_PER_BATCH} over {examples // ZS_CLI_BATCH}")
    check(equal, "the CLI's probs from the converted checkpoint differ from make_zero_shot_fn's "
                 "on the model's own weights")
    check(swap_gap["query_key"] > 0, "swapping the query and key kernels before converting "
                                     "left the probs unchanged")
    check(swap_gap["query_value"] > SLICE_TOL,
          f"swapping the query and value kernels before converting moved the probs by "
          f"{swap_gap['query_value']}, not past {SLICE_TOL}")
    check(all(math.isfinite(v) for v in metrics.values()) and -1 <= metrics["spearman"] <= 1,
          f"scores {metrics}")
    return result


VCR_WORDS = ("the man woman is are going to with in on at why what how because they he "
             "she it this that holding looking walking sitting talking table door").split()
VCR_OBJECTS = ("person", "person", "person", "car", "dog", "chair", "cup", "bottle")


def vcr_item(rng, annot_id: str) -> tuple:
    """A synthetic VCR annotation in the reference's schema (inline object
    references, 4 answers and 4 rationales) and its objects' boxes and
    polygons on a VCR_FRAME_HW frame."""
    h, w = VCR_FRAME_HW
    n = int(rng.integers(3, 8))
    objects = [str(rng.choice(VCR_OBJECTS)) for _ in range(n)]
    boxes, segms = [], []
    for _ in range(n):
        x1, y1 = float(rng.uniform(0, 0.7 * w)), float(rng.uniform(0, 0.7 * h))
        x2, y2 = x1 + float(rng.uniform(0.05 * w, 0.3 * w)), y1 + float(rng.uniform(0.05 * h, 0.3 * h))
        boxes.append([x1, y1, x2, y2, float(rng.uniform(0.5, 1.0))])
        segms.append([[(float(rng.uniform(x1, x2)), float(rng.uniform(y1, y2)))
                       for _ in range(int(rng.integers(3, 7)))]])

    def stream(lo, hi):
        return [sorted({int(x) for x in rng.integers(0, n, int(rng.integers(1, 3)))})
                if rng.uniform() < 0.25 else str(rng.choice(VCR_WORDS))
                for _ in range(int(rng.integers(lo, hi)))]

    item = {"img_id": annot_id, "annot_id": annot_id, "objects": objects,
            "question": stream(6, 16) + ["?"],
            "answer_choices": [stream(4, 14) + ["."] for _ in range(4)],
            "rationale_choices": [stream(8, 24) + ["."] for _ in range(4)],
            "answer_label": int(rng.integers(0, 4)),
            "rationale_label": int(rng.integers(0, 4))}
    return item, {"bbox": boxes, "segm": segms}


def direct_tokens(text, objects) -> tuple:
    """(ids, tags) written directly, one id per word or object reference,
    as tests/test_downstream.py writes its VCR token lists: the route where
    sacremoses (VCRTokenizer's detokenizer) is missing."""
    import zlib
    ids, tags = [], []
    for word in text:
        for obj, tag in ([(objects[o], o + 1) for o in word] if isinstance(word, list)
                         else [(word, 0)]):
            ids.append(100 + zlib.crc32(obj.encode()) % 50000)
            tags.append(tag)
    return ids, tags


def write_vcr_shards(d: Path) -> dict:
    """VCR_TRAIN_EXAMPLES training examples in 2 shards and VCR_VAL_EXAMPLES
    validation examples, built by the port's build_vcr_example: each frame
    smooth noise of VCR_FRAME_HW, drawn with the mentions of each mode as
    bbox and segm overlays (draw_grounding) and saved as JPEG at quality 95
    (prepare_vcr_shard's route); tokens through VCRTokenizer where
    sacremoses imports, else ``direct_tokens``. One thread per shard."""
    import io
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from PIL import Image
    from merlot_tpu_torch.data.make_synthetic_tfrecord import smooth_frame
    from merlot_tpu_torch.data.tfrecord import TFRecordWriter
    from merlot_tpu_torch.downstream.vcr.data_prep import (VCRTokenizer, build_vcr_example,
                                                           collect_mentions, draw_grounding)
    try:
        tok, route = VCRTokenizer(), "VCRTokenizer"
    except ImportError:
        tok, route = direct_tokens, "direct token lists (no sacremoses)"
    half = VCR_TRAIN_EXAMPLES // 2
    jobs = [("train-00", 0, half), ("train-01", 1, half), ("val-00", 2, VCR_VAL_EXAMPLES)]

    def write(job):
        name, seed, n = job
        rng = np.random.default_rng(seed)
        with TFRecordWriter(str(d / f"{name}.tfrecord")) as w:
            for i in range(n):
                item, shapes = vcr_item(rng, f"{name}-{i}")
                frame = Image.fromarray(smooth_frame(rng, *VCR_FRAME_HW))
                drawn = {}
                for mode in ("answer", "rationale"):
                    mentions, objects = collect_mentions(item, mode)
                    for kind in ("bbox", "segm"):
                        buf = io.BytesIO()
                        draw_grounding(frame.copy(), shapes[kind], mentions, objects,
                                       kind=kind).save(buf, format="JPEG", quality=95)
                        drawn[f"{mode}/{kind}"] = buf.getvalue()
                w.write(build_vcr_example(item, drawn, tok))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(write, jobs))
    return {"token_route": route, "seconds": time.perf_counter() - t0,
            "bytes": sum((d / f"{j[0]}.tfrecord").stat().st_size for j in jobs),
            "train_examples": VCR_TRAIN_EXAMPLES, "val_examples": VCR_VAL_EXAMPLES}


def vcr_yaml(out_dir: Path, train_glob: str, val_glob: str, init: Path) -> tuple:
    """A copy of configs/vcr_finetune.yaml with VCR_REDUCED's keys, the
    paths and the warm-start checkpoint changed and device.log_every 1
    added; the model block but for init_checkpoint and the optimizer block
    but for num_train_steps stay as they are."""
    values = dict(VCR_REDUCED, train_file=f'"{train_glob}"', val_file=f'"{val_glob}"',
                  output_dir=f'"{out_dir}"', init_checkpoint=f'"{init}"')
    text, reduced, orig, copy = config_copy("vcr_finetune.yaml", values,
                                            added=(("device", "log_every", 1),))
    check(dict(copy["model"], init_checkpoint=None) == dict(orig["model"], init_checkpoint=None)
          and dict(copy["optimizer"], num_train_steps=None)
          == dict(orig["optimizer"], num_train_steps=None),
          "the copy of vcr_finetune.yaml changed its model or optimizer block")
    return text, reduced


def vcr_loss_and_grads(model, batch, weights=None) -> tuple:
    """One training forward and backward with dropout off, through the
    kernels' backend: (the VCR loss, fp32 grads by parameter name) of the
    VCR loss, or with ``weights`` of sum(logits * weights)."""
    import torch
    from merlot_tpu_torch.downstream.vcr.modeling import vcr_loss_and_metrics
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    logits = model(batch["images"], batch["lm_input"], deterministic=True, attn_backend="cuda")
    loss, _ = vcr_loss_and_metrics(logits, batch["lm_targets"])
    (loss if weights is None else (logits.float() * weights).sum()).backward()
    return loss.item(), {n: torch.zeros_like(p) if p.grad is None else
                         p.grad.detach().float().clone() for n, p in params.items()}


def vcr_phase(dev, tmp: Path) -> dict:
    """VCR finetuning and its eval sidecar at configs/vcr_finetune.yaml's
    model block from tfrecords: run A (`python -m
    merlot_tpu_torch.downstream.vcr.train a.yaml` in a subprocess, warm
    started from a fresh pretrain_4seg-width checkpoint: 8 steps,
    checkpoints at 4 and 8), run B (vcr.train.main in this process from
    A's ckpt_4, with the kernels' counters and a profile of one step)
    against A, one step's loss and grads through the kernels against the
    plain attention, A's ckpt_8 evaluated in both modes (kernel logits
    against plain ones), and the sidecar's poll over A's checkpoints until
    its timeout."""
    import gc
    import shutil
    import torch
    from merlot_tpu_torch.convert import load_flax_params
    from merlot_tpu_torch.core.config import NeatConfig
    from merlot_tpu_torch.data.pretrain_loader import device_iterator
    from merlot_tpu_torch.downstream.vcr import train as vcr_train
    from merlot_tpu_torch.downstream.vcr import validate
    from merlot_tpu_torch.downstream.vcr.dataloader import vcr_eval_batches, vcr_joint_batches
    from merlot_tpu_torch.downstream.vcr.modeling import VCRModel
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.ops import attention as attn_mod
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.train.checkpoint import CheckpointManager, load_params

    card = card_line()
    d = tmp / "vcr"
    (d / "shards").mkdir(parents=True)
    data = write_vcr_shards(d / "shards")
    print(f"[vcr] shards: {json.dumps(data)}", flush=True)
    init = d / "pretrain4" / "ckpt_1"
    init_save_s = save_fresh_pretrain(MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL),
                                      PRETRAIN_4SEG_OPTIMIZER, init, dev)
    yamls = {}
    for name in ("a", "b"):
        text, reduced = vcr_yaml(d / name, f"{d}/shards/train-*.tfrecord",
                                 f"{d}/shards/val-*.tfrecord", init)
        yamls[name] = d / f"{name}.yaml"
        yamls[name].write_text(text)
    config = NeatConfig.from_yaml(str(yamls["a"]))
    merged = dict(config.merged_data_model(), **config.downstream)
    train_files, val_files = config.data["train_file_expanded"], config.data["val_file_expanded"]
    check(len(train_files) == 2 and len(val_files) == 1, f"the copy's globs matched {config.data}")

    # run A through the entry point
    rc, a_seconds, a_log = run_module("merlot_tpu_torch.downstream.vcr.train", yamls["a"],
                                      ROOT, d / "a.log")
    check(rc == 0, f"VCR run A exited {rc}")
    warm = [x for x in a_log.splitlines() if x.startswith("warm_start: initialized")]
    check(len(warm) == 1, f"run A's warm start printed {warm}")
    initialized, total = (int(x) for x in warm[0].split()[2].split("/"))
    skipped = sum(x.startswith("warm_start: shape mismatch") for x in a_log.splitlines())
    a_train = {x["step"]: x for x in jsonl(d / "a" / "train_metrics.jsonl")}
    check(sorted(a_train) == list(range(1, VCR_STEPS + 1)),
          f"run A logged steps {sorted(a_train)}, want 1..{VCR_STEPS}")
    for x in a_train.values():
        bad = {k: v for k, v in x.items() if not math.isfinite(v)}
        check(not bad, f"run A step {x['step']}: non-finite metrics {bad}")
    a_ckpt = CheckpointManager(str(d / "a" / "checkpoints"))
    check(a_ckpt.all_steps() == list(range(VCR_CKPT_EVERY, VCR_STEPS + 1, VCR_CKPT_EVERY)),
          f"run A's checkpoints at {a_ckpt.all_steps()}")
    rate = [a_train[s]["perf/steps_per_sec"] for s in range(3, VCR_STEPS + 1)]

    # run B: A's ckpt_4 in a fresh output directory, in this process
    (d / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(a_ckpt.path(VCR_CKPT_EVERY), d / "b" / "checkpoints" / f"ckpt_{VCR_CKPT_EVERY}",
                    copy_function=os.link)  # hard links: no file is rewritten
    per_step, windows = [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with cli_tf32():
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        with wrapped(vcr_train, "make_loss_train_step", counting_steps(per_step, windows)):
            t0 = time.perf_counter()
            b = vcr_train.main([str(yamls["b"])])
            b_seconds = time.perf_counter() - t0
        launches = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    profiles, prof = window_profiles(per_step, windows, "vcr-profile")
    b_train = {x["step"]: x for x in jsonl(d / "b" / "train_metrics.jsonl")}
    check(sorted(b_train) == list(range(VCR_CKPT_EVERY + 1, VCR_STEPS + 1)),
          f"VCR run B logged steps {sorted(b_train)}: it did not resume at {VCR_CKPT_EVERY}")
    check([n for n, *_ in per_step] == list(range(VCR_CKPT_EVERY + 1, VCR_STEPS + 1)),
          f"VCR run B stepped {[n for n, *_ in per_step]}")
    loss_gap = max(abs(b_train[s]["loss"] - a_train[s]["loss"]) / abs(a_train[s]["loss"])
                   for s in b_train)

    # one step's loss and grads at B's weights on the loader's first batch:
    # the kernels, the plain versions in their places, and faults: the
    # plain forward without the mask (the loss, reported), the plain
    # backward without it (the grads); the VCR loss's grads (reported) and
    # the grads of sum(logits * r)
    model = b["trainer"].model
    del b
    it = device_iterator(vcr_joint_batches(train_files, merged, VCR_BATCH), dev)
    batch = next(it)
    it.close()
    r = torch.randn((2 * VCR_BATCH, 4), generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    plain_fwd = lambda *a, stats=None, tile_class=None, **kw: ca.flash_attention_plain(*a, **kw)
    plain_bwd = lambda *a, stats=None, tile_class=None, **kw: ca.attention_bwd_plain(*a, **kw)
    no_mask_fwd = lambda q, k, v, mask, *a, **kw: plain_fwd(q, k, v, None, *a, **kw)
    no_mask_bwd = lambda q, k, v, mask, *a, **kw: plain_bwd(q, k, v, None, *a, **kw)

    def through(fwd, bwd, weights=None):
        if fwd is None:
            return vcr_loss_and_grads(model, batch, weights)
        with wrapped(ca, "attention_fwd_cuda", lambda f: fwd), \
                wrapped(ca, "attention_bwd_cuda", lambda f: bwd):
            return vcr_loss_and_grads(model, batch, weights)

    kernel_loss, kernel_grads = through(None, None)
    plain_loss, plain_grads = through(plain_fwd, plain_bwd)
    vcr_loss_grads = grad_gap(kernel_grads, plain_grads)
    vcr_loss_broken = grad_gap(through(plain_fwd, no_mask_bwd)[1], plain_grads)
    no_mask_loss = through(no_mask_fwd, plain_bwd)[0]
    kernel_grads = through(None, None, r)[1]
    plain_grads = through(plain_fwd, plain_bwd, r)[1]
    broken = grad_gap(through(plain_fwd, no_mask_bwd, r)[1], plain_grads)
    gap = grad_gap(kernel_grads, plain_grads)
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    no_mask_loss_rel = abs(no_mask_loss - plain_loss) / abs(plain_loss)
    n_params = sum(p.numel() for p in model.parameters())
    del model, batch, kernel_grads, plain_grads
    gc.collect()
    torch.cuda.empty_cache()

    # A's ckpt_8 evaluated in both modes as the sidecar evaluates it
    emodel = VCRModel(MerlotConfig.from_dict(config.model).eval_mode(), device=dev).eval()
    load_flax_params(emodel, load_params(a_ckpt.path(VCR_STEPS)))
    no_mask = lambda f: lambda q, k, v, mask, **kw: f(q, k, v, None, **kw)
    evals = {}
    for mode in ("answer", "rationale"):
        spans: list = []
        pred_path = d / f"predictions_{mode}.jsonl"
        reset_counts()
        t0 = time.perf_counter()
        with wrapped(ca, "attention_fwd_cuda", event_timed(spans)):
            acc = validate.evaluate_checkpoint(emodel, val_files, merged, VCR_BATCH, mode,
                                               VCR_EVAL_BATCHES * VCR_BATCH, str(pred_path))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_launches = ca.launches
        preds = jsonl(pred_path)
        with torch.no_grad():
            host = [b for _, b in zip(range(VCR_EVAL_BATCHES),
                                      vcr_eval_batches(val_files, merged, VCR_BATCH, mode))]
            on_dev = [(torch.from_numpy(b["images"]).to(dev),
                       torch.from_numpy(b["lm_input"]).to(dev)) for b in host]
            kernel = [emodel(i, t, mode=mode) for i, t in on_dev]
            plain = [emodel(i, t, mode=mode, attn_backend="plain") for i, t in on_dev]
            with wrapped(attn_mod, "_plain_attention", no_mask):
                unmasked = [emodel(i, t, mode=mode, attn_backend="plain") for i, t in on_dev]
            wall = []
            for r in range(7):                       # 2 warm-up, 5 timed
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                emodel(*on_dev[0], mode=mode)
                torch.cuda.synchronize()
                if r >= 2:
                    wall.append(time.perf_counter() - t1)
        diff = max((a - p).abs().max().item() for a, p in zip(kernel, plain))
        evals[mode] = {
            "accuracy": acc, "examples": len(preds), "seconds": eval_s,
            "launches": eval_launches,
            "examples_per_s": len(preds) / eval_s,
            "preloaded_examples_per_s": VCR_BATCH / statistics.median(wall),
            "k1_ms_per_batch": spans_ms(spans) / VCR_EVAL_BATCHES,
            "vs_plain_max_abs_diff": diff,
            "no_joint_mask_max_abs_diff": max((u - p).abs().max().item()
                                              for u, p in zip(unmasked, plain)),
            "logits_max_abs": max(p.abs().max().item() for p in plain),
            "log_probs_finite": all(math.isfinite(x) for p in preds for x in p["log_probs"])}
        print(f"[vcr-eval] {mode}: {json.dumps(evals[mode])}", flush=True)
    del emodel
    gc.collect()
    torch.cuda.empty_cache()

    # the sidecar over A's checkpoints until its timeout
    t0 = time.perf_counter()
    seen = validate.watch_and_validate(config, poll_seconds=1.0, device=dev)
    sidecar_s = time.perf_counter() - t0
    logged = jsonl(d / "a" / "eval" / "eval_metrics.jsonl")
    mode = config.downstream["mode"]

    steps_in = lambda fam: prof["families"].get(fam, {"ms": 0.0})["ms"] / len(prof["steps"])
    result = {
        "card": card, "reduced": reduced, "data": data, "params": n_params,
        "init_checkpoint_save_s": init_save_s,
        "warm_start": {"initialized": initialized, "leaves": total, "skipped": skipped},
        "run_a_seconds": a_seconds, "run_b_seconds": b_seconds,
        "train_examples_per_s": VCR_BATCH * statistics.median(rate),
        "steps_per_sec_3_to_8": rate,
        "a_losses": {s: a_train[s]["loss"] for s in sorted(a_train)},
        "b_losses": {s: b_train[s]["loss"] for s in sorted(b_train)},
        "resume_loss_rel_gap": loss_gap,
        "launches": launches, "launches_per_step": per_step, "peak_mem_gib": peak_gib,
        "device_idle_share": prof["device_idle_share"], "profile": prof,
        "profiles_held_all": [p["held_all"] for p in profiles],
        "k1_ms_per_step": steps_in("K1 attention_fwd"),
        "k2_ms_per_step": steps_in("K2 attention_bwd"),
        "kernel_loss": kernel_loss, "plain_loss": plain_loss, "loss_rel_diff": loss_rel,
        "no_joint_mask_loss_rel_diff": no_mask_loss_rel, "vcr_loss_grads_vs_plain": vcr_loss_grads,
        "vcr_loss_mask_dropped_backward_vs_plain": vcr_loss_broken,
        "grads_vs_plain": gap, "mask_dropped_backward_vs_plain": broken,
        "eval": evals,
        "sidecar": {"seconds": sidecar_s, "accuracy_by_step": seen,
                    "logged_steps": [x["step"] for x in logged]}}
    print(f"[vcr] {json.dumps({k: v for k, v in result.items() if k != 'profile'})}", flush=True)
    print(f"[vcr] {card}: {result['train_examples_per_s']:.2f} train examples/s through the "
          f"CLI (batch {VCR_BATCH}), eval {evals['answer']['examples_per_s']:.2f} examples/s "
          f"through the loader and {evals['answer']['preloaded_examples_per_s']:.2f} on a "
          f"preloaded batch; peak {peak_gib:.2f} GiB; B's device idle "
          f"{prof['device_idle_share']:.3f}; K1 {result['k1_ms_per_step']:.2f} and K2 "
          f"{result['k2_ms_per_step']:.2f} ms per step (profiler); tokens: "
          f"{data['token_route']}; warm start {initialized}/{total} leaves, {skipped} skipped",
          flush=True)
    check(all(k1 == k2 == VCR_LAUNCHES_PER_STEP for _, k1, k2 in per_step),
          f"VCR run B's K1/K2 launches per step {per_step}, want {VCR_LAUNCHES_PER_STEP} each")
    check(loss_gap <= RESUME_LOSS_RTOL, f"VCR run B's losses vs A's: {loss_gap}")
    check(initialized > 0, "the warm start initialized no leaf")
    check(loss_rel <= VCR_LOSS_RTOL, f"VCR kernel vs plain loss: {loss_rel} > {VCR_LOSS_RTOL}")
    check(gap["max_rel"] <= TRAIN_GRAD_TOL,
          f"VCR kernel vs plain grads of sum(logits * r): {gap} > {TRAIN_GRAD_TOL}")
    check(broken["max_rel"] > TRAIN_GRAD_TOL,
          f"a VCR backward without the mask moves the grads by only {broken}: the "
          "comparison cannot see it")
    for m, e in evals.items():
        check(e["launches"] == VCR_LAUNCHES_PER_STEP * VCR_EVAL_BATCHES,
              f"VCR eval ({m}) launched K1 {e['launches']} times over {VCR_EVAL_BATCHES} batches")
        check(e["examples"] == VCR_EVAL_BATCHES * VCR_BATCH and e["log_probs_finite"],
              f"VCR eval ({m}) predictions: {e['examples']}, finite {e['log_probs_finite']}")
        check(e["vs_plain_max_abs_diff"] <= VCR_LOGIT_TOL,
              f"VCR eval ({m}) kernel vs plain logits: {e['vs_plain_max_abs_diff']}")
        check(e["no_joint_mask_max_abs_diff"] > VCR_LOGIT_TOL,
              f"VCR eval ({m}): dropping the joint mask moves the logits by only "
              f"{e['no_joint_mask_max_abs_diff']}: the comparison cannot see it")
    check(sorted(seen) == a_ckpt.all_steps() and [x["step"] for x in logged] == sorted(seen),
          f"the sidecar evaluated {seen}, logged {logged}")
    check(sidecar_s >= VCR_EVAL_TIMEOUT_S, f"the sidecar returned after {sidecar_s} s")
    check(seen[VCR_STEPS] == evals[mode]["accuracy"],
          f"the sidecar's step-{VCR_STEPS} accuracy {seen[VCR_STEPS]} is not "
          f"evaluate_checkpoint's {evals[mode]['accuracy']}")
    return result


# ---------------------------------------------------------------------------
# Grover denoiser training and the corpus pipeline


def grover_lm_rows(seed: int) -> tuple:
    """GT_ROWS rows of token ids for the LM shard, a quarter of them
    shorter than seq + 1 (write_lm_shard pads them), and is_target on each
    row's last third."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows, targets = [], []
    for i in range(GT_ROWS):
        n = GT_SEQ + 1 if i % 4 else int(rng.integers(GT_SEQ // 3, GT_SEQ))
        rows.append(rng.integers(1, 50257, n).tolist())
        targets.append([0] * (n - n // 3) + [1] * (n // 3))
    return rows, targets


def grover_step_flops(cfg) -> tuple:
    """(matmul parameters, FLOPs of one train step at GT_BATCH x GT_SEQ):
    6 per matmul parameter per token (forward and backward), plus the
    attention's products over the whole S x S square per layer, as the
    kernels compute them (K1's two, K2's five)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    params = cfg.num_hidden_layers * (4 * h * h + 2 * h * i) + cfg.vocab_size * h
    attn = sum(attn_work(GT_BATCH, GT_SEQ, True, False, bw, cfg.num_attention_heads,
                         cfg.d_head, 4)[0] for bw in (False, True))
    return params, 6 * params * GT_BATCH * GT_SEQ + cfg.num_hidden_layers * attn


def grover_turns(dev, model, batch, old, pad_token_id) -> dict:
    """The Grover step's forward and backward (the loss of run B's weights
    on the first batch at GT_BATCH x GT_SEQ, no optimizer) through the first
    design's fp32 K1 and K2 (``old``) and the current ones, in turns (first,
    current, current, first; GT_TURN_STEPS timed after one warm-up each):
    seconds and tokens/s, and K1/K2 ms per step from CUDA events around
    their launches."""
    import torch
    from merlot_tpu_torch.models.grover import grover_lm_loss
    from merlot_tpu_torch.ops import cuda_attention as ca

    fwd, bwd = old[:2]
    ids = torch.from_numpy(batch["input_ids"]).to(dev)
    is_t = torch.from_numpy(batch["is_target"]).to(dev)
    first_fwd = lambda f: lambda q3, k3, v3, mask, *, num_heads, softmax_fp32, \
        collect_colsum, **_: (fwd(q3, k3, v3, mask, softmax_fp32, collect_colsum, num_heads),
                              None)
    first_bwd = lambda f: lambda q3, k3, v3, mask, g3, gcol, *, num_heads, softmax_fp32, \
        **_: bwd(q3, k3, v3, mask, g3, gcol, softmax_fp32, num_heads)

    def step():
        for p in model.parameters():
            p.grad = None
        logits, _ = model(ids[:, :-1], attn_backend="cuda")
        loss, _ = grover_lm_loss(logits, ids[:, :-1], is_t[:, 1:], pad_token_id=pad_token_id)
        loss.backward()

    def run(design: str) -> dict:
        k1, k2 = [], []
        with contextlib.ExitStack() as stack:
            if design == "first":
                stack.enter_context(wrapped(ca, "attention_fwd_cuda", first_fwd))
                stack.enter_context(wrapped(ca, "attention_bwd_cuda", first_bwd))
            stack.enter_context(wrapped(ca, "attention_fwd_cuda", event_timed(k1)))
            stack.enter_context(wrapped(ca, "attention_bwd_cuda", event_timed(k2)))
            step()
            torch.cuda.synchronize()
            k1.clear(), k2.clear()
            t0 = time.perf_counter()
            for _ in range(GT_TURN_STEPS):
                step()
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - t0) / GT_TURN_STEPS
        return {"step_seconds": seconds, "tokens_per_s": GT_BATCH * GT_SEQ / seconds,
                "k1_ms_per_step": spans_ms(k1) / GT_TURN_STEPS,
                "k2_ms_per_step": spans_ms(k2) / GT_TURN_STEPS}

    runs = {"first": [], "current": []}
    for design in ("first", "current", "current", "first"):
        runs[design].append(run(design))
    for p in model.parameters():
        p.grad = None
    out = {design: {k: statistics.mean(r[k] for r in rs) for k in rs[0]}
           for design, rs in runs.items()}
    out["runs"] = runs
    out["speedup"] = out["first"]["step_seconds"] / out["current"]["step_seconds"]
    print(f"[grover-turns] {json.dumps(out)}", flush=True)
    return out


def grover_train_phase(dev, tmp: Path, old=None) -> dict:
    """Grover denoiser training at grover-medium's full width and depth in
    fp32 through its entry point: run A (`python -m
    merlot_tpu_torch.tools.grover_train` in a subprocess: 8 steps,
    checkpoints at 4 and 8), run B (grover_train.main in this process from
    A's ckpt_4, with the kernels' counters) against A, one step's loss and
    grads through the kernels against the plain attention (and with the
    causal mask dropped on the kernel side), the profiles of run B's own
    windows (loader on; reported, not checked), with ``old`` (parent_calls'
    callables) the step's forward and backward at the full batch through
    the first design's fp32 K1 and K2 and through the current ones, in
    turns, the side loop's profile in a process of its own
    (``grover_profile_child``, checked to hold every counted launch), and
    A's ckpt_8 served by the port's Denoiser against the trained model's
    forward."""
    import gc
    import shutil
    import torch
    from merlot_tpu_torch.convert import load_flax_params
    from merlot_tpu_torch.models.grover import GroverConfig, GroverLM, grover_lm_loss
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.tools import grover_train
    from merlot_tpu_torch.tools.denoise_server import Denoiser
    from merlot_tpu_torch.tools.grover_data import lm_batches, write_lm_shard
    from merlot_tpu_torch.train.checkpoint import CheckpointManager, load_params

    card = card_line()
    cfg_path = ROOT / "configs" / "grover_medium.json"
    cfg = GroverConfig.from_json_file(str(cfg_path))
    check(not cfg.use_bfloat16 and (cfg.num_hidden_layers, cfg.hidden_size,
                                    cfg.num_attention_heads) == (24, 1024, 16),
          f"configs/grover_medium.json is not grover-medium in fp32: {cfg}")
    d = tmp / "grover_train"
    (d / "shards").mkdir(parents=True)
    rows, targets = grover_lm_rows(12)
    for i in range(2):
        write_lm_shard(str(d / "shards" / f"lm-{i:02d}.tfrecord"), rows[i::2], GT_SEQ,
                       is_target=targets[i::2])
    files = sorted(str(p) for p in (d / "shards").glob("lm-*.tfrecord"))

    def argv(out: Path) -> list:
        return ["--config", cfg_path, "--train_files", f"{d}/shards/lm-*.tfrecord",
                "--output_dir", out, "--seq_length", GT_SEQ, "--batch_size", GT_BATCH,
                "--num_train_steps", GT_STEPS,
                "--num_warmup_steps", GT_REDUCED["num_warmup_steps"][1],
                "--checkpoint_every", GT_CKPT_EVERY, "--log_every", 1]

    rc, a_seconds, _ = run_module("merlot_tpu_torch.tools.grover_train", argv(d / "a"), ROOT,
                                  d / "a.log")
    check(rc == 0, f"Grover run A exited {rc}")
    a_train = {x["step"]: x for x in jsonl(d / "a" / "train_metrics.jsonl")}
    check(sorted(a_train) == list(range(1, GT_STEPS + 1)),
          f"Grover run A logged steps {sorted(a_train)}, want 1..{GT_STEPS}")
    for x in a_train.values():
        bad = {k: v for k, v in x.items() if not math.isfinite(v)}
        check(not bad, f"Grover run A step {x['step']}: non-finite metrics {bad}")
    a_ckpt = CheckpointManager(str(d / "a" / "checkpoints"))
    check(a_ckpt.all_steps() == list(range(GT_CKPT_EVERY, GT_STEPS + 1, GT_CKPT_EVERY)),
          f"Grover run A's checkpoints at {a_ckpt.all_steps()}")
    rate = [a_train[s]["perf/steps_per_sec"] for s in range(3, GT_STEPS + 1)]

    # run B: A's ckpt_4 in a fresh output directory, in this process
    (d / "b" / "checkpoints").mkdir(parents=True)
    shutil.copytree(a_ckpt.path(GT_CKPT_EVERY), d / "b" / "checkpoints" / f"ckpt_{GT_CKPT_EVERY}",
                    copy_function=os.link)  # hard links: no file is rewritten
    per_step, windows = [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts set to 0 just before, read just after
    reset_counts()
    with wrapped(grover_train, "make_loss_train_step", counting_steps(per_step, windows)):
        t0 = time.perf_counter()
        b = grover_train.main([str(a) for a in argv(d / "b")])
        b_seconds = time.perf_counter() - t0
    launches = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    # run B's own windows, the loader on: reported beside the side loop's
    # checked profile below, not checked (on the card a window of run B
    # has lacked one K1 record of its 24 or 48, a loss not yet explained;
    # each window's families show whether its mask classifier's went too)
    b_windows = window_summaries(per_step, windows, "grover-train-run-b")
    b_train = {x["step"]: x for x in jsonl(d / "b" / "train_metrics.jsonl")}
    check(sorted(b_train) == list(range(GT_CKPT_EVERY + 1, GT_STEPS + 1)),
          f"Grover run B logged steps {sorted(b_train)}: it did not resume at {GT_CKPT_EVERY}")
    check([n for n, *_ in per_step] == list(range(GT_CKPT_EVERY + 1, GT_STEPS + 1)),
          f"Grover run B stepped {[n for n, *_ in per_step]}")
    loss_gap = max(abs(b_train[s]["loss"] - a_train[s]["loss"]) / abs(a_train[s]["loss"])
                   for s in b_train)

    # one step's loss and grads at B's weights on the first batch's first
    # rows, dropout off: the kernels, the plain attention, and the kernels
    # with the causal mask dropped
    model = b["trainer"].model
    del b
    gc.collect()
    torch.cuda.empty_cache()
    first = next(lm_batches(files, GT_SEQ, GT_BATCH))
    ids = torch.from_numpy(first["input_ids"][:GT_CHECK_BATCH]).to(dev)
    is_t = torch.from_numpy(first["is_target"][:GT_CHECK_BATCH]).to(dev)

    def loss_and_grads(backend: str) -> tuple:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        logits, _ = model(ids[:, :-1], attn_backend=backend)
        loss, _ = grover_lm_loss(logits, ids[:, :-1], is_t[:, 1:],
                                 pad_token_id=cfg.pad_token_id)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in params.items()}

    kernel_loss, kernel_grads = loss_and_grads("cuda")
    plain_loss, plain_grads = loss_and_grads("plain")
    gap = grad_gap(kernel_grads, plain_grads)
    del kernel_grads
    drop = lambda f: lambda q3, k3, v3, mask, *a, **kw: f(q3, k3, v3, None, *a, **kw)
    with wrapped(ca, "attention_fwd_cuda", drop), wrapped(ca, "attention_bwd_cuda", drop):
        broken_loss, broken_grads = loss_and_grads("cuda")
    broken = grad_gap(broken_grads, plain_grads)
    loss_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    broken_loss_rel = abs(broken_loss - plain_loss) / abs(plain_loss)
    n_params = sum(p.numel() for p in model.parameters())
    del plain_grads, broken_grads
    turns = grover_turns(dev, model, first, old, cfg.pad_token_id) if old else None
    for p in model.parameters():
        p.grad = None
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the step's device time by kernel family and the device's idle share:
    # the side loop (``grover_profile_child``) in a process of its own, at
    # A's step-8 weights (B's, bit for bit)
    prof_json = d / "side_loop_profile.json"
    rc, side_s, _ = run_module("chip_smoke", ["--grover-profile", a_ckpt.path(GT_STEPS),
                                              "--train-files", f"{d}/shards/lm-*.tfrecord",
                                              "--out", prof_json], ROOT, d / "side_loop.log")
    check(rc == 0, f"the Grover side loop's profile exited {rc}")
    prof = json.loads(prof_json.read_text())

    # the round trip: A's last checkpoint served by the Denoiser
    trained = GroverLM(cfg, device=dev).eval()
    load_flax_params(trained, load_params(a_ckpt.path(GT_STEPS)))
    den = Denoiser(str(cfg_path), os.path.join(a_ckpt.path(GT_STEPS), "params.npz"),
                   batch_window_ms=0, device=dev)
    rt_rows, rt_len = GT_ROUNDTRIP
    ctx = torch.from_numpy(first["input_ids"][:rt_rows, :rt_len]).long().to(dev)
    with torch.no_grad():
        reset_counts()
        served, _ = den.model(ctx, cache=den.model.empty_cache(rt_rows, rt_len))
        torch.cuda.synchronize()
        rt_launches = {"attention_stacked": ca.stacked_launches}
        reset_counts()
        want, _ = trained(ctx)
        torch.cuda.synchronize()
        rt_launches["attention_fwd"] = ca.launches
        load_flax_params(trained, load_params(a_ckpt.path(GT_CKPT_EVERY)))
        earlier, _ = trained(ctx)
    roundtrip_gap = (served - want).abs().max().item()
    earlier_gap = (served - earlier).abs().max().item()
    del trained, den, served, want, earlier
    gc.collect()
    torch.cuda.empty_cache()

    mm_params, step_flops = grover_step_flops(cfg)
    step_s = 1 / statistics.median(rate)
    bound_s = step_flops / PEAK_FP32_FLOPS

    def steps_in(fam: str, p=prof) -> float:
        steps = p["steps"] if isinstance(p["steps"], int) else len(p["steps"])
        return p["families"].get(fam, {"ms": 0.0})["ms"] / steps

    result = {
        "card": card, "config": "configs/grover_medium.json", "params": n_params,
        "matmul_params": mm_params,
        "reduced": [{"key": k, "default": a, "run": r} for k, (a, r) in GT_REDUCED.items()]
        + [{"key": "plain-attention check batch", "default": GT_BATCH, "run": GT_CHECK_BATCH}],
        "data": {"rows": GT_ROWS, "shards": len(files), "padded_rows": GT_ROWS // 4},
        "run_a_seconds": a_seconds, "run_b_seconds": b_seconds,
        "tokens_per_step": GT_BATCH * GT_SEQ,
        "tokens_per_s": GT_BATCH * GT_SEQ * statistics.median(rate),
        "steps_per_sec_3_to_8": rate, "step_flops": step_flops,
        "step_bound_s": bound_s, "fp32_peak_share": bound_s / step_s,
        "a_losses": {s: a_train[s]["loss"] for s in sorted(a_train)},
        "b_losses": {s: b_train[s]["loss"] for s in sorted(b_train)},
        "a_trg_loss": {s: a_train[s]["trg_loss"] for s in sorted(a_train)},
        "resume_loss_rel_gap": loss_gap, "launches": launches, "launches_per_step": per_step,
        "peak_mem_gib": peak_gib,
        "profile_source": f"side loop in a process of its own: {PROFILE_STEPS} step(s) of "
                          "grover_train's step function at A's step-8 weights on one "
                          "batch already on the card, no loader",
        "side_loop_seconds": side_s,
        "device_idle_share": prof["device_idle_share"],
        "profile": prof, "profile_tries": prof["tries"],
        # K1's time counts its mask classifier's, launched in each call
        "k1_ms_per_step": steps_in("K1 attention_fwd") + steps_in("K1 mask_tile_classes"),
        "k1_classes_ms_per_step": steps_in("K1 mask_tile_classes"),
        "k2_ms_per_step": steps_in("K2 attention_bwd"),
        "run_b_windows": [
            {"steps": w["steps"], "held_all": w["held_all"],
             "profiled_vs_counted": w["profiled_vs_counted"],
             "classes_launches": w["families"].get("K1 mask_tile_classes",
                                                   {"launches": 0})["launches"],
             "device_idle_share": w["device_idle_share"],
             "k1_ms_per_step": steps_in("K1 attention_fwd", w)
             + steps_in("K1 mask_tile_classes", w),
             "k2_ms_per_step": steps_in("K2 attention_bwd", w)} for w in b_windows],
        "kernel_loss": kernel_loss, "plain_loss": plain_loss, "loss_rel_diff": loss_rel,
        "grads_vs_plain": gap, "mask_dropped_loss_rel_diff": broken_loss_rel,
        "mask_dropped_grads_vs_plain": broken,
        "roundtrip": {"rows": rt_rows, "tokens": rt_len, "max_abs_diff": roundtrip_gap,
                      "vs_ckpt_4_max_abs_diff": earlier_gap, "launches": rt_launches},
        "first_design_turns": turns}
    print(f"[grover-train] {json.dumps({k: v for k, v in result.items() if k != 'profile'})}",
          flush=True)
    print(f"[grover-train] {card}: {result['tokens_per_s']:.1f} tokens/s through the CLI "
          f"(batch {GT_BATCH} x {GT_SEQ}, fp32); peak {peak_gib:.2f} GiB; a step "
          f"{step_s:.3f} s against the fp32 peak's {bound_s:.3f} s "
          f"({result['fp32_peak_share']:.3f}); the side loop's device idle "
          f"{prof['device_idle_share']:.3f}, run B's windows' "
          f"{[w['device_idle_share'] for w in result['run_b_windows']]}; K1 (classifier "
          f"included) {result['k1_ms_per_step']:.2f} and K2 {result['k2_ms_per_step']:.2f} "
          f"ms per step (side loop's profile)", flush=True)
    check(all(k1 == k2 == GT_LAUNCHES_PER_STEP for _, k1, k2 in per_step),
          f"Grover run B's K1/K2 launches per step {per_step}, want {GT_LAUNCHES_PER_STEP} each")
    check(loss_gap <= RESUME_LOSS_RTOL, f"Grover run B's losses vs A's: {loss_gap}")
    check(loss_rel <= GT_LOSS_RTOL, f"Grover kernel vs plain loss: {loss_rel} > {GT_LOSS_RTOL}")
    check(gap["max_rel"] <= GT_GRAD_TOL,
          f"Grover kernel vs plain grads: {gap} > {GT_GRAD_TOL}")
    check(broken_loss_rel > GT_LOSS_RTOL and broken["max_rel"] > GT_GRAD_TOL,
          f"the kernels without the causal mask pass a bound (loss {broken_loss_rel}, grads "
          f"{broken['max_rel']}): the comparison cannot see it")
    check(rt_launches == {"attention_stacked": GT_LAUNCHES_PER_STEP,
                          "attention_fwd": GT_LAUNCHES_PER_STEP},
          f"the round trip's launches {rt_launches}")
    check(roundtrip_gap <= GT_ROUNDTRIP_TOL,
          f"the Denoiser's logits vs the trained model's: {roundtrip_gap} > {GT_ROUNDTRIP_TOL}")
    check(earlier_gap > GT_ROUNDTRIP_TOL,
          f"ckpt_{GT_CKPT_EVERY}'s logits are within the round trip's bound of ckpt_{GT_STEPS}'s "
          f"({earlier_gap}): the comparison cannot tell the checkpoints apart")
    return result


def write_corpus_videos(d: Path) -> dict:
    """CORPUS_VIDEOS mp4s of CORPUS_HW with a CORPUS_CONTENT box of smooth
    noise centred in black bars (8 content frames cycled), and each one's
    .grover.json: a word every 1 / CORPUS_WORDS_PER_S s, the denoised text
    the same words capitalized with a full stop every 12."""
    import cv2
    import numpy as np
    from merlot_tpu_torch.data.make_synthetic_tfrecord import smooth_frame

    h, w = CORPUS_HW
    ch, cw = CORPUS_CONTENT
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    words = ("so today we are going to make pasta with a tomato sauce from scratch and "
             "you want to heat the oven first then chop the onions very fine").split()
    videos = []
    t0 = time.perf_counter()
    for i in range(CORPUS_VIDEOS):
        rng = np.random.default_rng(40 + i)
        path = d / f"video{i:02d}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), CORPUS_FPS, (w, h))
        check(writer.isOpened(), f"cv2 cannot write {path}")
        content = []
        for _ in range(8):
            frame = np.zeros((h, w, 3), np.uint8)
            # content at least 40 everywhere, so the bars' edge is the box's
            frame[y0:y0 + ch, x0:x0 + cw] = 40 + (smooth_frame(rng, ch, cw).astype(np.uint16)
                                                  * 215 // 255).astype(np.uint8)
            content.append(frame)
        for f in range(int(CORPUS_SECONDS * CORPUS_FPS)):
            writer.write(content[(f // int(CORPUS_FPS * 10)) % len(content)])
        writer.release()
        n_words = CORPUS_SECONDS * CORPUS_WORDS_PER_S
        said = [words[j] for j in rng.integers(0, len(words), n_words)]
        item = {"subtitles": [{"word": x, "time": j / CORPUS_WORDS_PER_S}
                              for j, x in enumerate(said)],
                "denoised": [{"cleanasr": " ".join(
                    x.capitalize() + ("." if j % 12 == 11 else "") for j, x in enumerate(said))}],
                "info": {"id": f"synthetic{i:02d}", "title": f"synthetic video {i}",
                         "duration": float(CORPUS_SECONDS)}}
        (d / f"video{i:02d}.grover.json").write_text(json.dumps(item))
        videos.append(str(path))
    return {"videos": videos, "seconds": time.perf_counter() - t0,
            "bytes": sum(Path(v).stat().st_size for v in videos)}


def corpus_phase(dev, tmp: Path) -> dict:
    """The offline corpus pipeline on 720p videos, then the pretraining CLI
    on its shard: `python -m merlot_tpu_torch.data.process` in a
    subprocess, the stored frames' size, and pretrain.main in this process
    for CORPUS_STEPS steps with the kernels' counters."""
    from merlot_tpu_torch.data import _native
    from merlot_tpu_torch.data.tfrecord import parse_example, read_tfrecords
    from merlot_tpu_torch.train import harness, pretrain

    card = card_line()
    d = tmp / "corpus"
    (d / "videos").mkdir(parents=True)
    # cv2 in a process of its own, as the corpus pipeline runs
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"from pathlib import Path; "
            f"print(json.dumps(chip_smoke.write_corpus_videos(Path({str(d / 'videos')!r}))))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    check(proc.returncode == 0, f"writing the videos failed: {proc.stderr[-3000:]}")
    made = json.loads(proc.stdout.strip().splitlines()[-1])
    shard = d / "train-00.tfrecord"
    rc, seconds, log = run_module("merlot_tpu_torch.data.process",
                                  ["--videos", *made["videos"], "--out", shard], ROOT,
                                  d / "process.log")
    check(rc == 0, f"the corpus pipeline exited {rc}")
    built = json.loads(log.strip().splitlines()[-1])
    examples = [parse_example(r) for r in read_tfrecords(str(shard))]
    sizes = {(int(ex[f"c{i:02d}/image/height"][0]), int(ex[f"c{i:02d}/image/width"][0]))
             for ex in examples for i in range(TRAIN_CHUNKS)}
    decoded = _native.decode_jpeg(examples[0]["c00/image/encoded"][0]).shape

    text, reduced, orig, copy = config_copy("pretrain_4seg.yaml", dict(
        CLI_REDUCED, num_train_steps=CORPUS_STEPS, iterations_per_loop=CORPUS_STEPS,
        train_file=f'"{shard}"', val_file='""', output_dir=f'"{d / "pretrain"}"'))
    check(copy["model"] == orig["model"]
          and dict(copy["optimizer"], num_train_steps=None)
          == dict(orig["optimizer"], num_train_steps=None),
          "the copy of pretrain_4seg.yaml changed its model or optimizer block")
    (d / "pretrain.yaml").write_text(text)
    per_step, windows = [], []
    with cli_tf32():
        reset_counts()
        with wrapped(harness, "make_train_step", counting_steps(per_step, windows)):
            t0 = time.perf_counter()
            pretrain.main([str(d / "pretrain.yaml")])
            train_s = time.perf_counter() - t0
    losses = {x["step"]: x["loss"] for x in jsonl(d / "pretrain" / "train_metrics.jsonl")
              if "loss" in x}
    result = {"card": card, "frame_route": built["frame_route"], "videos": built["videos"],
              "chunks": built["chunks"], "examples": built["examples"],
              "process_seconds": built["seconds"], "process_wall_seconds": seconds,
              "videos_per_s": built["videos"] / built["seconds"],
              "chunks_per_s": built["chunks"] / built["seconds"],
              "video_write_seconds": made["seconds"], "video_bytes": made["bytes"],
              "shard_bytes": shard.stat().st_size, "stored_frame_sizes": sorted(sizes),
              "decoded_shape": list(decoded), "reduced": reduced, "pretrain_seconds": train_s,
              "launches_per_step": per_step, "losses": losses}
    print(f"[corpus] {json.dumps(result)}", flush=True)
    print(f"[corpus] {card}: frames by {built['frame_route']}; {result['videos_per_s']:.3f} "
          f"videos/s and {result['chunks_per_s']:.2f} chunks/s ({built['videos']} videos of "
          f"{CORPUS_HW[1]}x{CORPUS_HW[0]}, {built['chunks']} chunks, {built['examples']} "
          f"examples); pretraining losses {losses}", flush=True)
    check(built["examples"] >= CORPUS_MIN_EXAMPLES and len(examples) == built["examples"],
          f"the corpus pipeline wrote {built['examples']} examples ({len(examples)} read)")
    check(sizes == {CORPUS_FRAME_HW} and tuple(decoded) == (*CORPUS_FRAME_HW, 3),
          f"stored frames {sorted(sizes)} (decoded {decoded}), want {CORPUS_FRAME_HW}")
    check([n for n, *_ in per_step] == list(range(1, CORPUS_STEPS + 1))
          and all(k1 == k2 == LAUNCHES_PER_STEP for _, k1, k2 in per_step),
          f"the pretraining CLI's K1/K2 launches per step {per_step}")
    check(sorted(losses) == list(range(1, CORPUS_STEPS + 1))
          and all(math.isfinite(v) for v in losses.values()), f"pretraining losses {losses}")
    return result


# ---------------------------------------------------------------------------
# data parallelism: the entry points as ranks of an NCCL process group


def dp_env() -> dict:
    """The variables torchrun gives rank 0 of a world of 1, on a free port."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def dp_probe_loss(model, batch, generator, mesh) -> float:
    """The global loss of a step on ``batch`` from a copy of its generator,
    with the mask loss's denominator summed twice over the ranks (a broken
    all-reduce); the generator itself is left as it is."""
    import torch
    from merlot_tpu_torch.models import pretrain as mp
    from merlot_tpu_torch.ops.attention import training_backend
    from merlot_tpu_torch.train.train_step import global_metrics, rank_draws

    gen = torch.Generator(device=generator.device)
    gen.set_state(generator.get_state())
    real = mp.mask_loss

    class Doubled:  # adds every rank's count once more
        def all_reduce_sum(self, t):
            return mesh.all_reduce_sum(t) * 2

    mp.mask_loss = lambda m, fwd, _mesh=None: real(m, fwd, Doubled())
    try:
        dev = next(model.parameters()).device
        b = {k: v.to(dev) for k, v in batch.items()}
        g, draws = rank_draws(model.cfg, b["input_ids"], gen, mesh)
        loss, metrics, _ = model(b, deterministic=False, attn_backend=training_backend(dev),
                                 generator=g, masking_draws=draws, mesh=mesh)
        return float(global_metrics(loss.detach(), metrics, mesh)[0])
    finally:
        mp.mask_loss = real


def dp_child(kind: str, config: str, out: str) -> int:
    """One rank of the data_parallel phase (a subprocess with the rank's
    variables set): the entry point of ``kind`` ('pretrain', 'vcr' or
    'zero_shot') on ``config``, with the kernels' counters set to 0 just
    before it; for the train kinds (step, K1, K2 launches) per step, and
    for 'pretrain' the fault probe's loss (``dp_probe_loss``, before the
    first step, outside the counters). Writes them to ``out``."""
    from merlot_tpu_torch.downstream.sort_story import get_zero_shot_logits
    from merlot_tpu_torch.downstream.vcr import train as vcr_train
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.train import harness, pretrain

    per_step, probe = [], []

    def counting(make):
        def make_counted(*args, **kw):
            step = make(*args, **kw)

            def counted(model, opt_state, batch, generator, **kw2):
                if kind == "pretrain" and not probe:
                    probe.append(dp_probe_loss(model, batch, generator, kw["mesh"]))
                before = (ca.launches, ca.bwd_launches)
                result = step(model, opt_state, batch, generator, **kw2)
                per_step.append((opt_state["step"], ca.launches - before[0],
                                 ca.bwd_launches - before[1]))
                return result
            return counted
        return make_counted

    t0 = time.perf_counter()
    if kind == "pretrain":
        with wrapped(harness, "make_train_step", counting):
            reset_counts()
            pretrain.main([config])
    elif kind == "vcr":
        with wrapped(vcr_train, "make_loss_train_step", counting):
            reset_counts()
            vcr_train.main([config])
    else:
        reset_counts()
        get_zero_shot_logits.main([config])
    Path(out).write_text(json.dumps({
        "kind": kind, "seconds": time.perf_counter() - t0, "per_step": per_step,
        "launches": {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches},
        "probe_loss": probe[0] if probe else None}))
    return 0


def dp_run(kind: str, config: Path, cwd: Path, d: Path) -> tuple:
    """``dp_child`` in a subprocess as rank 0 of a world of 1: (its record,
    seconds). The rank must report an NCCL group."""
    rc, seconds, text = run_module(
        "chip_smoke", ["--dp-child", kind, "--dp-config", config, "--dp-out",
                       d / f"dp_{kind}.json"], cwd, d / f"dp_{kind}.log", env=dp_env())
    check(rc == 0, f"the {kind} rank exited {rc}")
    check("process group: backend nccl, world 1, rank 0" in text,
          f"the {kind} rank did not report an NCCL group of one rank")
    return json.loads((d / f"dp_{kind}.json").read_text()), seconds


def with_zero1(text: str, values: dict, name: str) -> str:
    """A YAML copy's text with ``values`` set and device.use_zero1 added."""
    text, _ = set_keys(text, values, name)
    check(text.count("\ndevice:\n") == 1, f"{name}: no single device section")
    return text.replace("\ndevice:\n", "\ndevice:\n  use_zero1: true\n")


def metrics_gap(got: dict, want: dict) -> float:
    """The largest relative gap between two runs' logged metrics (every key
    but the timings) at ``got``'s steps."""
    timing = {"step", "time", "perf/steps_per_sec", "perf/data_wait_s"}
    gap = 0.0
    for s, row in got.items():
        check(set(row) - timing == set(want[s]) - timing, f"step {s}: other metrics")
        for k in set(row) - timing:
            gap = max(gap, abs(row[k] - want[s][k]) / max(abs(want[s][k]), 1e-30))
    return gap


def npz_equal(a: Path, b: Path) -> bool:
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        return list(x.files) == list(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files)


def data_parallel_phase(dev, cli_tmp: Path, zs_tmp: Path, vcr_tmp: Path, cli: dict,
                        zs_cli: dict) -> dict:
    """The data-parallel paths at world size 1 through NCCL (DP_STEPS's
    comment): the pretraining CLI with use_zero1 against the CLI phase's
    run A (every metric of its steps, its last checkpoint, 36 K1 and 36 K2
    per step), its ZeRO-1 checkpoint at DP_CKPT_EVERY restored by a plain
    run, the fault probe; VCR with use_zero1 against the VCR phase's run A
    (24/24 per step); the zero-shot CLI's .npz against its phase's CLI run,
    24 K1 per batch."""
    import gc
    import numpy as np
    import torch
    from merlot_tpu_torch.convert import flax_layout, flax_path
    from merlot_tpu_torch.core.config import NeatConfig
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.train import checkpoint as ckpt_mod
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW

    card = card_line()
    t_phase = time.perf_counter()
    seconds = {}

    # the pretraining CLI, ZeRO-1, as rank 0
    check(DP_STEPS in range(CLI_CKPT_EVERY, CLI_STEPS + 1, CLI_CKPT_EVERY),
          "the data-parallel run's last step has no checkpoint of run A's")
    d = cli_tmp / "dp"
    (cli_tmp / "dp.yaml").write_text(with_zero1(
        (cli_tmp / "a.yaml").read_text(), {"output_dir": f'"{d}"', "num_train_steps": DP_STEPS,
                                           "iterations_per_loop": DP_CKPT_EVERY}, "a.yaml"))
    rank, seconds["pretrain"] = dp_run("pretrain", cli_tmp / "dp.yaml", ROOT, cli_tmp)
    a_train = {x["step"]: x for x in jsonl(cli_tmp / "a" / "train_metrics.jsonl") if "loss" in x}
    got = {x["step"]: x for x in jsonl(d / "train_metrics.jsonl") if "loss" in x}
    check(sorted(got) == list(range(1, DP_STEPS + 1)), f"the rank logged steps {sorted(got)}")
    gap = metrics_gap(got, a_train)
    probe_gap = abs(rank["probe_loss"] - a_train[1]["loss"]) / abs(a_train[1]["loss"])
    a_ckpt = Path(cli_tmp / "a" / "checkpoints" / f"ckpt_{DP_STEPS}")
    dp_ckpt = d / "checkpoints"
    check(sorted(p.name for p in dp_ckpt.iterdir())
          == sorted(f"ckpt_{s}" for s in range(DP_CKPT_EVERY, DP_STEPS + 1, DP_CKPT_EVERY)),
          f"the rank's checkpoints {sorted(p.name for p in dp_ckpt.iterdir())}")
    ckpt_equal = all(npz_equal(dp_ckpt / f"ckpt_{DP_STEPS}" / f, a_ckpt / f)
                     for f in (ckpt_mod.PARAMS_FILE, ckpt_mod.OPT_FILE))
    # its ZeRO-1 checkpoint at DP_CKPT_EVERY restored by a run of no group
    config = NeatConfig.from_yaml(str(cli_tmp / "dp.yaml"))
    model = MerlotPretrainModel(MerlotConfig.from_dict(config.model), device=dev)
    params = dict(model.named_parameters())
    opt = MerlotAdamW(AdamWConfig.from_config(config.optimizer))
    state = opt.init(params)
    mid = dp_ckpt / f"ckpt_{DP_CKPT_EVERY}"
    ckpt_mod.load_checkpoint(str(mid), model, state)
    with np.load(mid / ckpt_mod.PARAMS_FILE) as zp, np.load(mid / ckpt_mod.OPT_FILE) as zo:
        restored = (state["step"] == DP_CKPT_EVERY and all(
            np.array_equal(flax_layout(n, ckpt_mod._to_numpy(p)), zp[flax_path(n)])
            and all(np.array_equal(flax_layout(n, ckpt_mod._to_numpy(state[g][n])),
                                   zo[f"{g}/{flax_path(n)}"]) for g in ("m", "v"))
            for n, p in params.items()))
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    segments = TRAIN_BATCH * TRAIN_CHUNKS
    rate_steps = [st for st in sorted(got) if st >= 2 and (st - 1) % DP_CKPT_EVERY]
    pretrain_rec = {
        "reduced": {"num_train_steps": DP_STEPS, "iterations_per_loop": DP_CKPT_EVERY,
                    "use_zero1": True},
        "losses": {s: got[s]["loss"] for s in sorted(got)},
        "run_a_losses": {s: a_train[s]["loss"] for s in sorted(got)},
        "metrics_rel_gap": gap, "launches_per_step": rank["per_step"],
        "last_checkpoint_equals_run_a": ckpt_equal,
        "zero1_checkpoint_restored_plainly": bool(restored),
        "probe_loss": rank["probe_loss"], "probe_rel_gap": probe_gap,
        # the same steps of both runs: from 2 on, none after a checkpoint
        # write of the rank's
        "rate_steps": rate_steps,
        "steps_per_sec": {k: [r[st]["perf/steps_per_sec"] for st in rate_steps]
                          for k, r in (("rank", got), ("run_a", a_train))},
        "segments_per_s": segments * statistics.median(
            got[st]["perf/steps_per_sec"] for st in rate_steps),
        "run_a_segments_per_s": segments * statistics.median(
            a_train[st]["perf/steps_per_sec"] for st in rate_steps),
        "seconds": seconds["pretrain"]}

    # VCR with ZeRO-1 and the zero-shot CLI, each as rank 0 of its own
    # world, side by side on the card (their checks are bit for bit and
    # launch counts; neither reads a rate)
    vd = vcr_tmp / "vcr"
    (vd / "dp.yaml").write_text(with_zero1(
        (vd / "a.yaml").read_text(), {"output_dir": f'"{vd / "dp"}"',
                                      "num_train_steps": DP_VCR_STEPS,
                                      "iterations_per_loop": DP_VCR_STEPS}, "VCR a.yaml"))
    zd = zs_tmp / "zero_shot_cli"
    (zd / "run_dp").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        vjob = pool.submit(dp_run, "vcr", vd / "dp.yaml", ROOT, vd)
        zjob = pool.submit(dp_run, "zero_shot", zd / "zs.yaml", zd / "run_dp", zd)
        (vrank, seconds["vcr"]), (zrank, seconds["zero_shot"]) = vjob.result(), zjob.result()
    va = {x["step"]: x for x in jsonl(vd / "a" / "train_metrics.jsonl")}
    vgot = {x["step"]: x for x in jsonl(vd / "dp" / "train_metrics.jsonl")}
    check(sorted(vgot) == list(range(1, DP_VCR_STEPS + 1)),
          f"the VCR rank logged steps {sorted(vgot)}")
    vcr_rec = {"reduced": {"num_train_steps": DP_VCR_STEPS, "use_zero1": True},
               "losses": {s: vgot[s]["loss"] for s in sorted(vgot)},
               "run_a_losses": {s: va[s]["loss"] for s in sorted(vgot)},
               "metrics_rel_gap": metrics_gap(vgot, va),
               "launches_per_step": vrank["per_step"], "seconds": seconds["vcr"]}

    # the zero-shot CLI's rank
    zs_rec = {"npz_equals_cli": npz_equal(zd / "run_dp" / "logits_val.npz",
                                          zd / "run" / "logits_val.npz"),
              "launches": zrank["launches"]["attention_fwd"], "batches": zs_cli["batches"],
              "seconds": seconds["zero_shot"]}

    result = {"card": card, "backend": "nccl", "world_size": 1, "pretrain_cli": pretrain_rec,
              "vcr": vcr_rec, "zero_shot_cli": zs_rec,
              "launches": {
                  "attention_fwd": rank["launches"]["attention_fwd"]
                  + vrank["launches"]["attention_fwd"] + zs_rec["launches"],
                  "attention_bwd": rank["launches"]["attention_bwd"]
                  + vrank["launches"]["attention_bwd"]},
              "phase_seconds": time.perf_counter() - t_phase}
    print(f"[data-parallel] {json.dumps(result)}", flush=True)
    print(f"[data-parallel] {card}: NCCL, world 1: the pretraining CLI with use_zero1 "
          f"{pretrain_rec['segments_per_s']:.2f} segments/s (run A "
          f"{pretrain_rec['run_a_segments_per_s']:.2f}), metrics gap {gap} over {DP_STEPS} "
          f"steps, probe gap {probe_gap:.3g}; VCR gap {vcr_rec['metrics_rel_gap']}; zero-shot "
          f".npz equal {zs_rec['npz_equals_cli']}; {result['phase_seconds']:.1f} s", flush=True)
    check(gap <= DP_RTOL, f"the ZeRO-1 rank's metrics vs run A's: {gap} > {DP_RTOL}")
    check(probe_gap > DP_RTOL, f"the fault probe (the mask denominator summed twice) passed: "
                               f"{probe_gap}")
    check(all(k1 == k2 == LAUNCHES_PER_STEP for _, k1, k2 in rank["per_step"])
          and [s for s, *_ in rank["per_step"]] == list(range(1, DP_STEPS + 1)),
          f"the rank's K1/K2 launches per step {rank['per_step']}")
    check(ckpt_equal, f"the rank's ckpt_{DP_STEPS} differs from run A's")
    check(restored, f"the rank's ZeRO-1 ckpt_{DP_CKPT_EVERY} did not restore plainly")
    check(vcr_rec["metrics_rel_gap"] <= DP_RTOL,
          f"the VCR rank's metrics vs VCR run A's: {vcr_rec['metrics_rel_gap']}")
    check(all(k1 == k2 == VCR_LAUNCHES_PER_STEP for _, k1, k2 in vrank["per_step"])
          and len(vrank["per_step"]) == DP_VCR_STEPS,
          f"the VCR rank's K1/K2 launches per step {vrank['per_step']}")
    check(zs_rec["npz_equals_cli"], "the zero-shot rank's .npz differs from the CLI's")
    check(zs_rec["launches"] == LAUNCHES_PER_BATCH * zs_cli["batches"],
          f"the zero-shot rank launched K1 {zs_rec['launches']} times over "
          f"{zs_cli['batches']} batches")
    return result


def tp_masking_pinned(masking: list, seen: list):
    """attention_guided_span_mask computed as it is (its draws advance the
    generator as they would) but answered by one process's masking of the
    same call, in order; ``seen`` gets whether the two agreed."""
    import torch

    def wrap(real):
        def pinned(*a, **kw):
            got = real(*a, **kw)
            want = masking[len(seen)]
            seen.append(all(torch.equal(x, y) for x, y in zip(got, want)))
            return want
        return pinned
    return wrap


def tp_pretrain_parts(dev):
    """pretrain_4seg's config, optimizer config and the phase's batch."""
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.train.optimizer import AdamWConfig
    cfg = MerlotConfig.from_dict(PRETRAIN_4SEG_MODEL)
    return cfg, AdamWConfig.from_config(PRETRAIN_4SEG_OPTIMIZER), pretrain_batch(
        cfg, dev, TP_BATCH)


def tp_pretrain_run(dev, d: Path, mesh=None) -> dict:
    """TP_STEPS train steps from seed 0 (generator seeded 1): one process
    (``mesh`` None: records its masking and step 1's gradients under ``d``)
    or this rank of the model group (takes that masking; step 1's gradients
    gathered over the model group, which global rank 0 holds against one
    process's; first the fault probe)."""
    import torch
    from merlot_tpu_torch.models import merlot as merlot_mod
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.parallel import tensor_parallel as tpm
    from merlot_tpu_torch.nn import transformer as tr_mod
    from merlot_tpu_torch.train.optimizer import MerlotAdamW
    from merlot_tpu_torch.train.train_step import init_train_state, make_train_step

    cfg, opt_cfg, batch = tp_pretrain_parts(dev)
    model = MerlotPretrainModel(cfg, device=dev)
    opt = MerlotAdamW(opt_cfg)
    state = init_train_state(model, opt, seed=0, tp=mesh)
    step = make_train_step(model, opt, device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "seconds": [], "launches_per_step": []}
    masking, seen = [], []
    if mesh is None:
        record = lambda f: lambda *a, **kw: masking.append(f(*a, **kw)) or masking[-1]
        hook = wrapped(merlot_mod, "attention_guided_span_mask", record)
    else:
        masking = torch.load(d / "tp_masking.pt", map_location=dev)
        hook = wrapped(merlot_mod, "attention_guided_span_mask",
                       tp_masking_pinned(masking, seen))
        # the fault probe: step 1's loss and gradients with the ViT's first
        # out_proj summed over no rank (each rank keeps its partial sum), from
        # a copy of the step's generator; no update
        probe_gen = torch.Generator(device=dev)
        probe_gen.set_state(gen.get_state())
        calls = []

        def broken(dense, x, m):
            calls.append(1)
            if len(calls) > 1:
                return tpm.row_parallel(dense, x, m)
            y = tpm._PartialProduct.apply(x.to(dense.dtype), dense.weight.to(dense.dtype))
            return y.to(dense.dtype) + dense.bias.to(dense.dtype)

        probe_seen = []
        with wrapped(merlot_mod, "attention_guided_span_mask",
                     tp_masking_pinned(masking, probe_seen)), \
                wrapped(tr_mod, "row_parallel", lambda f: broken):
            loss, _, _ = model({k: v for k, v in batch.items()}, deterministic=False,
                               attn_backend="cuda", generator=probe_gen, mesh=mesh)
            loss.backward()
        out["probe_loss"] = loss.item()
        probe_grads = mesh.gather_model({n: p.grad.detach().float()
                                         for n, p in model.named_parameters()})
        for p in model.parameters():
            p.grad = None
        if mesh.is_chief:
            ref_grads = torch.load(d / "tp_ref_grads.pt", map_location=dev)
            out["probe_grad_gap"] = grad_gap(probe_grads, ref_grads)
        del probe_grads
    ca.launches = ca.bwd_launches = 0
    with hook:
        for i in range(TP_STEPS):
            before = (ca.launches, ca.bwd_launches)
            t0 = time.perf_counter()
            metrics = step(model, state, batch, gen)
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["launches_per_step"].append((ca.launches - before[0],
                                             ca.bwd_launches - before[1]))
            out["losses"].append(metrics["loss"].item())
            if i:
                continue
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().float()
                     for n, p in model.named_parameters()}
            if mesh is None:
                torch.save({n: g.cpu() for n, g in grads.items()}, d / "tp_ref_grads.pt")
            else:
                grads = mesh.gather_model(grads)
                if mesh.is_chief:
                    out["grad_gap"] = grad_gap(grads, ref_grads)
                    del ref_grads
            del grads
    if mesh is None:
        torch.save(masking, d / "tp_masking.pt")
    out["own_masking_equal"] = seen
    out["launches"] = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # the last step's: the first one warms up
    out["segments_per_s"] = TP_BATCH * TRAIN_CHUNKS / out["seconds"][-1]
    del model, state, step
    torch.cuda.empty_cache()
    return out


def tp_grover_contexts() -> list:
    """TP_GROVER_ROWS contexts of prefix + decode tokens (ids below the
    special ones at the top of the vocabulary: none is an eos)."""
    import numpy as np
    rng = np.random.default_rng(7)
    n = TP_GROVER_PREFIX + TP_GROVER_DECODE
    return [list(rng.integers(10, 50000, n)) for _ in range(TP_GROVER_ROWS)]


def tp_grover_run(dev, bf16: bool, mesh=None) -> dict:
    """``Denoiser.run_batch`` at grover-medium (seed 0's weights), --tp 1
    without ``mesh``, else this rank of a --tp 2 server (rank 0 runs the
    batch, the other follows): the logits of the prefill's last position
    and of each decode step [B, V] fp32 on the host, the K3 launches before
    each, and the host's clock at each."""
    import torch
    from merlot_tpu_torch.models import grover as grover_mod
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.tools.denoise_server import Denoiser

    t0 = time.perf_counter()
    den = Denoiser(str(ROOT / "configs" / "grover_medium.json"), None,
                   max_len=TP_GROVER_PREFIX + TP_GROVER_DECODE, bf16=bf16,
                   batch_window_ms=0.0, device=dev, tp=1 if mesh is None else mesh.model,
                   mesh=mesh)
    init_s = time.perf_counter() - t0
    logits, launches, clock = [], [], []

    def record(f):
        def recorded(word_embed, cfg, h):
            out = f(word_embed, cfg, h)
            if h.dim() == 2 or h.shape[1] == 1:  # not the prefill's probability chunks
                logits.append(out.reshape(out.shape[0], -1).float().cpu())
                launches.append(ca.stacked_launches)
                clock.append(time.perf_counter())
            return out
        return recorded

    ca.stacked_launches = 0
    with wrapped(grover_mod, "lm_logits_for_hidden", record):
        t0 = time.perf_counter()
        if mesh is None or mesh.model_rank == 0:
            den.run_batch(tp_grover_contexts(), den.tok.end_article)
            if mesh is not None:
                den.stop()
        else:
            den.follow()
        seconds = time.perf_counter() - t0
    del den
    torch.cuda.empty_cache()
    steps = len(logits) - 1
    return {"logits": logits, "launches": launches, "init_s": init_s, "seconds": seconds,
            "decode_steps": steps,
            "decode_tokens_per_s": TP_GROVER_ROWS * (steps - 1) / (clock[-1] - clock[1]),
            "total_launches": ca.stacked_launches}


def tp_launch_steps(launches: list) -> list:
    """K3 launches of the prefill and of each decode step."""
    return [b - a for a, b in zip([0] + launches[:-1], launches)]


def tp_child(rank: int, port: str, d: str) -> int:
    """One rank of the tensor_parallel phase: two ranks on cuda:0 over gloo
    (LOCAL_RANK 0 for both), one model group; the pretraining run, then the
    Grover server's in bf16 and in fp32. Writes its record under ``d``."""
    import torch
    from merlot_tpu_torch.parallel import mesh as pm

    d = Path(d)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = pm.init_multihost(init_method=f"tcp://127.0.0.1:{port}", world_size=TP_RANKS,
                            rank=rank, device="cuda", backend="gloo")
    mesh = pm.make_mesh(model=TP_RANKS)
    out = {"rank": rank, "device": str(dev), "backend": mesh.backend,
           "data": mesh.data, "model": mesh.model, "model_rank": mesh.model_rank}
    out["pretrain"] = tp_pretrain_run(dev, d, mesh)
    for name, bf16 in (("grover_bf16", True), ("grover_fp32", False)):
        run = tp_grover_run(dev, bf16, mesh)
        ref = torch.load(d / f"tp_ref_{name}.pt")
        n = TP_GROVER_CHECKED + 1 if bf16 else 2
        run["logits_max_abs_diff"] = max((a - b).abs().max().item() for a, b in
                                         zip(run["logits"][:n], ref["logits"][:n]))
        run["logits_compared"] = n
        run["launches_per_step"] = tp_launch_steps(run.pop("launches"))
        run.pop("logits")
        out[name] = run
    pm.leave(mesh)
    (d / f"tp_rank{rank}.json").write_text(json.dumps(out))
    return 0


def tensor_parallel_phase(dev) -> dict:
    """The model axis at model=2 as two ranks sharing the card over gloo
    (TP_RANKS's comment): the references in this process, then the ranks."""
    import socket
    import torch

    card = card_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ref = {"pretrain": tp_pretrain_run(dev, d)}
        for name, bf16 in (("grover_bf16", True), ("grover_fp32", False)):
            run = tp_grover_run(dev, bf16)
            torch.save({"logits": run["logits"]}, d / f"tp_ref_{name}.pt")
            run["launches_per_step"] = tp_launch_steps(run.pop("launches"))
            run.pop("logits")
            ref[name] = run
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, LOCAL_RANK="0", PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                           if p]))
        procs = []
        for r in range(TP_RANKS):
            with open(d / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-child", str(r),
                     "--tp-port", str(port), "--tp-dir", str(d)], cwd=ROOT, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, TP_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            text = (d / f"rank{r}.log").read_text()
            print(f"[tensor-parallel] rank {r} output (last 3000 characters):\n"
                  f"{text[-3000:]}", flush=True)
            check(p.returncode == 0, f"tensor-parallel rank {r} exited {p.returncode}")
        ranks = [json.loads((d / f"tp_rank{r}.json").read_text()) for r in range(TP_RANKS)]
    rp = ranks[0]["pretrain"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(rp["losses"], ref["pretrain"]["losses"])]
    probe_loss_rel = abs(rp["probe_loss"] - ref["pretrain"]["losses"][0]) / abs(
        ref["pretrain"]["losses"][0])
    result = {
        "card": card, "backend": ranks[0]["backend"], "ranks": TP_RANKS,
        "mesh": {"data": ranks[0]["data"], "model": ranks[0]["model"]},
        "note": "two ranks sharing one card over gloo: not a reading of tensor "
                "parallelism's speed on separate cards",
        "reduced": {"batch": f"{TP_BATCH} examples x {TRAIN_CHUNKS} chunks (bench.py: "
                             f"{TRAIN_BATCH})", "steps": TP_STEPS,
                    "grover_max_len": TP_GROVER_PREFIX + TP_GROVER_DECODE},
        "pretrain": {"model_1": ref["pretrain"], "ranks": [r["pretrain"] for r in ranks],
                     "loss_rel_diff": loss_rel, "grad_gap": rp["grad_gap"],
                     "probe_loss_rel_diff": probe_loss_rel,
                     "probe_grad_gap": rp["probe_grad_gap"]},
        "grover_bf16": {"tp_1": ref["grover_bf16"],
                        "ranks": [r["grover_bf16"] for r in ranks]},
        "grover_fp32": {"tp_1": ref["grover_fp32"],
                        "ranks": [r["grover_fp32"] for r in ranks]},
        "launches": {"attention_fwd": sum(r["pretrain"]["launches"]["attention_fwd"]
                                          for r in ranks),
                     "attention_bwd": sum(r["pretrain"]["launches"]["attention_bwd"]
                                          for r in ranks),
                     "attention_stacked": sum(r[g]["total_launches"] for r in ranks
                                              for g in ("grover_bf16", "grover_fp32"))},
        "phase_seconds": time.perf_counter() - t_phase}
    print(f"[tensor-parallel] {json.dumps(result)}", flush=True)
    print(f"[tensor-parallel] {card}: model=2, two ranks sharing the card over gloo: "
          f"pretrain_4seg {min(r['pretrain']['segments_per_s'] for r in ranks):.2f}"
          f" segments/s (one process at model=1: "
          f"{ref['pretrain']['segments_per_s']:.2f}), loss gaps {loss_rel}, grad gap "
          f"{rp['grad_gap']['max_rel']:.4g}; probe loss gap {probe_loss_rel:.4g}, grad gap "
          f"{rp['probe_grad_gap']['max_rel']:.4g}; grover-medium --tp 2 decode "
          f"{ranks[0]['grover_bf16']['decode_tokens_per_s']:.2f} tokens/s bf16 (--tp 1: "
          f"{ref['grover_bf16']['decode_tokens_per_s']:.2f}), logits gaps "
          f"{ranks[0]['grover_bf16']['logits_max_abs_diff']:.4g} bf16, "
          f"{ranks[0]['grover_fp32']['logits_max_abs_diff']:.4g} fp32; "
          f"{result['phase_seconds']:.1f} s", flush=True)
    check(all(x <= TRAIN_LOSS_RTOL for x in loss_rel),
          f"tensor-parallel losses vs model=1: {loss_rel} > {TRAIN_LOSS_RTOL}")
    check(rp["grad_gap"]["max_rel"] <= TRAIN_GRAD_TOL,
          f"tensor-parallel step-1 grads vs model=1: {rp['grad_gap']} > {TRAIN_GRAD_TOL}")
    check(probe_loss_rel > TRAIN_LOSS_RTOL or rp["probe_grad_gap"]["max_rel"] > TRAIN_GRAD_TOL,
          f"the probe (a row-parallel all-reduce left out) passes the bounds: loss "
          f"{probe_loss_rel}, grads {rp['probe_grad_gap']}")
    for r in ranks:
        check(r["pretrain"]["launches_per_step"]
              == [[LAUNCHES_PER_STEP, LAUNCHES_PER_STEP]] * TP_STEPS,
              f"rank {r['rank']}: K1/K2 launches per step {r['pretrain']['launches_per_step']}")
        for g, tol in (("grover_bf16", GROVER_LOGIT_TOL), ("grover_fp32", TP_FP32_LOGIT_TOL)):
            run = r[g]
            check(run["decode_steps"] == TP_GROVER_DECODE - 1
                  and run["launches_per_step"] == [24] * TP_GROVER_DECODE,
                  f"rank {r['rank']} {g}: K3 launches per prefill and decode step "
                  f"{run['launches_per_step']}")
            if r["rank"] == 0:
                check(run["logits_max_abs_diff"] <= tol,
                      f"{g}: --tp 2 logits vs --tp 1: {run['logits_max_abs_diff']} > {tol}")
    check(ref["pretrain"]["launches_per_step"] == [(LAUNCHES_PER_STEP, LAUNCHES_PER_STEP)]
          * TP_STEPS, f"model=1: K1/K2 launches per step {ref['pretrain']['launches_per_step']}")
    return result


def pp_config():
    """grover-medium as configs/grover_medium.json gives it, and with the
    hidden dropout off (the compared steps)."""
    import dataclasses
    from merlot_tpu_torch.models.grover import GroverConfig
    cfg = GroverConfig.from_json_file(str(ROOT / "configs" / "grover_medium.json"))
    return cfg, dataclasses.replace(cfg, hidden_dropout_prob=0.0)


def pp_batches(d: Path) -> list:
    """The compared steps' batches: the first PP_STEPS of the phase's shards."""
    import itertools
    from merlot_tpu_torch.tools.grover_data import lm_batches
    files = sorted(str(p) for p in (d / "shards").glob("lm-*.tfrecord"))
    return list(itertools.islice(lm_batches(files, GT_SEQ, GT_BATCH), PP_STEPS))


def pp_reference(dev, d: Path) -> dict:
    """PP_STEPS steps of one process at --pp 1 (grover_train's loss and
    AdamW block, warmup 0, dropout off) from seed 0: losses, seconds, and
    step 1's gradients saved under ``d`` for the ranks."""
    import gc
    import torch
    from merlot_tpu_torch.models.grover import GroverLM
    from merlot_tpu_torch.tools import grover_train
    from merlot_tpu_torch.train.train_step import (init_train_state, make_loss_train_step,
                                                   step_generator)

    _, cfg0 = pp_config()
    model = GroverLM(cfg0, device=dev)
    opt = grover_train.grover_optimizer(1e-5, 80000, 0)
    state = init_train_state(model, opt, seed=0)
    step = make_loss_train_step(grover_train.make_grover_loss(cfg0, 4.0), opt, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "seconds": []}
    for i, batch in enumerate(pp_batches(d)):
        t0 = time.perf_counter()
        metrics = step(model, state, {k: torch.from_numpy(v) for k, v in batch.items()},
                       step_generator(0, i, dev))
        out["losses"].append(metrics["loss"].item())
        out["seconds"].append(time.perf_counter() - t0)
        if i == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                       d / "pp_ref_grads.pt")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["tokens_per_s"] = GT_BATCH * GT_SEQ / out["seconds"][-1]
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_whole_names(stacked: dict, per: int) -> dict:
    """Gathered stage tensors (``stages.<leaf>`` [pp, L/pp, ...]) -> GroverLM
    names (``layer{i:02d}.<leaf>``); the replicated ones as they are."""
    out = {}
    for n, t in stacked.items():
        if not n.startswith("stages."):
            out[n] = t
            continue
        flat = t.reshape((-1,) + tuple(t.shape[2:]))
        for i in range(flat.shape[0]):
            out[f"layer{i:02d}.{n[len('stages.'):]}"] = flat[i]
    return out


def pp_steps(dev, d: Path, mesh) -> dict:
    """This rank's PP_STEPS compared steps (the phase's comment): losses,
    seconds, K1/K2 launches and hop seconds and bytes per step; on the
    chief, step 1's gathered gradients and the probe's against one
    process."""
    import gc
    import torch
    from merlot_tpu_torch.models.grover import GroverStage
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.parallel import mesh as pm
    from merlot_tpu_torch.tools import grover_train
    from merlot_tpu_torch.train.train_step import (init_train_state,
                                                   make_pipeline_loss_train_step,
                                                   step_generator)

    _, cfg0 = pp_config()
    stage = GroverStage(cfg0, mesh.stage, mesh.stage_rank, device=dev)
    opt = grover_train.grover_optimizer(1e-5, 80000, 0)
    state = init_train_state(stage, opt, seed=0)
    loss_fn = grover_train.make_grover_pipeline_loss(cfg0, 4.0, mesh, PP_MICROBATCHES)
    pipes, unsummed = [], []

    def kept(stage_, batch, gen):
        loss, metrics, pipe = loss_fn(stage_, batch, gen)
        pipes.append(pipe)
        return loss, metrics, pipe

    def keep_unsummed(real):
        def summed(m, grads):
            if not unsummed:  # the probe's word_embed gradient: this stage's part
                unsummed.append(stage.word_embed.grad.detach().clone())
            return real(m, grads)
        return summed

    step = make_pipeline_loss_train_step(kept, opt, mesh=mesh, device=dev)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in pp_batches(d)]
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "seconds": [], "launches_per_step": [], "hop_seconds": [],
           "hop_copy_seconds": [], "hop_bytes": []}
    # the main path: counts set to 0 just before, read just after
    ca.launches = ca.bwd_launches = 0
    for i, batch in enumerate(batches):
        before = (ca.launches, ca.bwd_launches)
        torch.cuda.synchronize()
        mesh.barrier()  # both stages start the timed step together
        t0 = time.perf_counter()
        with wrapped(pm.Mesh, "stage_all_reduce_", keep_unsummed):
            metrics = step(stage, state, batch, step_generator(0, i, dev))
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["launches_per_step"].append((ca.launches - before[0], ca.bwd_launches - before[1]))
        out["losses"].append(metrics["loss"].item())
        hops = pipes[-1].hops
        out["hop_seconds"].append(hops.seconds)
        out["hop_copy_seconds"].append(hops.copy_seconds)
        out["hop_bytes"].append(hops.bytes)
        if i:
            continue
        grads = mesh.gather_stages({n: p.grad.detach() for n, p in stage.named_parameters()})
        if mesh.is_chief:
            ref = {n: g.to(dev) for n, g in torch.load(d / "pp_ref_grads.pt").items()}
            per = cfg0.num_hidden_layers // mesh.stage
            whole = pp_whole_names(grads, per)
            out["grad_gap"] = grad_gap(whole, ref)
            whole["word_embed"] = unsummed[0]
            out["probe_grad_gap"] = grad_gap(whole, ref)
            out["probe_word_embed_rel"] = ((unsummed[0] - ref["word_embed"]).abs().max()
                                           / ref["word_embed"].abs().max()).item()
            del ref, whole
        del grads
    out["launches"] = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches}
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["tokens_per_s"] = GT_BATCH * GT_SEQ / out["seconds"][-1]
    del stage, state, step, pipes
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pp_cli(rank: int, d: Path, out_dir: Path, port: int) -> dict:
    """grover_train --pp 2 as torchrun starts this rank (LOCAL_RANK 0: the
    ranks share the card over gloo)."""
    from merlot_tpu_torch.tools import grover_train
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(PP_STAGES), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        return grover_train.main([
            "--config", str(ROOT / "configs" / "grover_medium.json"),
            "--train_files", f"{d}/shards/lm-*.tfrecord", "--output_dir", str(out_dir),
            "--seq_length", str(GT_SEQ), "--batch_size", str(GT_BATCH),
            "--num_train_steps", str(PP_CLI_STEPS), "--num_warmup_steps", "2",
            "--checkpoint_every", str(PP_CLI_CKPT_EVERY), "--log_every", "1",
            "--pp", str(PP_STAGES), "--dist_backend", "gloo"])
    finally:  # LOCAL_RANK stays 0: the phase set it for both ranks
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)


def pp_child(rank: int, ports: str, d: str) -> int:
    """One rank of the pipeline_parallel phase: two ranks on cuda:0 over gloo
    (LOCAL_RANK 0 for both); the compared steps, the CLI run and its resume,
    then the trained ranks' forward and (the last stage) the Denoiser on the
    checkpoint. Writes its record under ``d``."""
    import gc
    import shutil
    import numpy as np
    import torch
    from merlot_tpu_torch.models.grover import grover_pipeline_forward
    from merlot_tpu_torch.ops import cuda_attention as ca
    from merlot_tpu_torch.parallel import mesh as pm
    from merlot_tpu_torch.tools.denoise_server import Denoiser

    import faulthandler
    d = Path(d)
    ports = [int(p) for p in ports.split(",")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank that hangs prints every thread's stack before the phase kills it
    faulthandler.dump_traceback_later(PP_TIMEOUT_S - 60, exit=False)
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        print(f"[pp-child {rank}] {time.perf_counter() - t_start:.1f}s {what}", flush=True)

    dev = pm.init_multihost(init_method=f"tcp://127.0.0.1:{ports[0]}", world_size=PP_STAGES,
                            rank=rank, device="cuda", backend="gloo")
    mesh = pm.make_mesh(stage=PP_STAGES)
    out = {"rank": rank, "device": str(dev), "backend": mesh.backend,
           "stage": mesh.stage, "stage_rank": mesh.stage_rank,
           "steps": pp_steps(dev, d, mesh)}
    pm.leave(mesh)
    out["steps_done_s"] = time.perf_counter() - t_start
    mark(f"compared steps done: {out['steps']['seconds']} s a step")

    # the CLI, on the main path too: counts set to 0 just before
    ca.launches = ca.bwd_launches = 0
    t0 = time.perf_counter()
    run = pp_cli(rank, d, d / "cli_a", ports[1])
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["cli_a_s"] = time.perf_counter() - t0
    mark("CLI run A done")
    if rank == 0:  # the straight run's ckpt_2 in a fresh directory (the other
        # rank waits in the CLI's rendezvous); hard links: no file is rewritten
        shutil.copytree(d / "cli_a" / "checkpoints" / f"ckpt_{PP_CLI_CKPT_EVERY}",
                        d / "cli_b" / "checkpoints" / f"ckpt_{PP_CLI_CKPT_EVERY}",
                        copy_function=os.link)
    t0 = time.perf_counter()
    trained = pp_cli(rank, d, d / "cli_b", ports[2])["trainer"].model.eval()
    out["cli_b_s"] = time.perf_counter() - t0
    out["cli_launches"] = {"attention_fwd": ca.launches, "attention_bwd": ca.bwd_launches}
    mark("CLI run B (resumed) done")

    # the trained ranks' forward (K1) and the Denoiser on the checkpoint (K3)
    dev = pm.init_multihost(init_method=f"tcp://127.0.0.1:{ports[3]}", world_size=PP_STAGES,
                            rank=rank, device="cuda", backend="gloo")
    mesh = pm.make_mesh(stage=PP_STAGES)
    rows, tokens = GT_ROUNDTRIP
    first = pp_batches(d)[0]
    ctx = torch.from_numpy(first["input_ids"][:rows, :tokens]).long().to(dev)
    ca.launches = 0
    with torch.no_grad():
        want, _ = grover_pipeline_forward(trained, ctx, mesh=mesh, num_microbatches=rows)
    torch.cuda.synchronize()
    out["forward_launches"] = ca.launches
    mark("the trained forward done")
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.is_last_stage:
        ckpt = d / "cli_b" / "checkpoints" / f"ckpt_{PP_CLI_STEPS}"
        with np.load(ckpt / "params.npz") as z:
            out["ckpt_stage_shapes"] = {k: list(z[k].shape) for k in z.files
                                        if k.startswith("stages/")}
        den = Denoiser(str(ROOT / "configs" / "grover_medium.json"), str(ckpt / "params.npz"),
                       batch_window_ms=0, device=dev)
        ca.stacked_launches = 0
        with torch.no_grad():
            served, _ = den.model(ctx, cache=den.model.empty_cache(rows, tokens))
        torch.cuda.synchronize()
        out["roundtrip"] = {"rows": rows, "tokens": tokens,
                            "max_abs_diff": (served - want).abs().max().item(),
                            "launches": {"attention_stacked": ca.stacked_launches}}
        del den, served
        mark("the Denoiser done")
    pm.leave(mesh)
    faulthandler.cancel_dump_traceback_later()
    out["seconds"] = time.perf_counter() - t_start
    (d / f"pp_rank{rank}.json").write_text(json.dumps(out))
    return 0


def pipeline_parallel_phase(dev) -> dict:
    """The stage axis at pp=2 as two ranks sharing the card over gloo
    (PP_STAGES's comment): the shards and the one-process reference in this
    process, then the ranks."""
    import socket
    import torch
    from merlot_tpu_torch.tools.grover_data import write_lm_shard

    card = card_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "shards").mkdir()
        rows, targets = grover_lm_rows(12)
        for i in range(2):
            write_lm_shard(str(d / "shards" / f"lm-{i:02d}.tfrecord"), rows[i::2], GT_SEQ,
                           is_target=targets[i::2])
        ref = pp_reference(dev, d)
        print(f"[pipeline-parallel] the one-process reference: {json.dumps(ref)}; "
              f"{time.perf_counter() - t_phase:.1f} s into the phase", flush=True)
        ports = []
        for _ in range(4):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                ports.append(str(sock.getsockname()[1]))
        env = dict(os.environ, LOCAL_RANK="0", PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                           if p]))
        procs = []
        for r in range(PP_STAGES):
            with open(d / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--pp-child", str(r),
                     "--pp-ports", ",".join(ports), "--pp-dir", str(d)], cwd=ROOT, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, PP_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r in range(PP_STAGES):
            text = (d / f"rank{r}.log").read_text()
            print(f"[pipeline-parallel] rank {r} output (last 6000 characters):\n"
                  f"{text[-6000:]}", flush=True)
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"pipeline-parallel rank {r} exited {p.returncode}")
        ranks = [json.loads((d / f"pp_rank{r}.json").read_text()) for r in range(PP_STAGES)]
        a_train = {x["step"]: x for x in jsonl(d / "cli_a" / "train_metrics.jsonl")}
        b_train = {x["step"]: x for x in jsonl(d / "cli_b" / "train_metrics.jsonl")}
    chief, last = ranks[0], ranks[-1]
    st = chief["steps"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(st["losses"], ref["losses"])]
    slower = max(r["steps"]["seconds"][-1] for r in ranks)
    bubble = (PP_STAGES - 1) / (PP_MICROBATCHES + PP_STAGES - 1)
    result = {
        "card": card, "backend": chief["backend"], "stages": PP_STAGES,
        "microbatches": PP_MICROBATCHES,
        "note": "two ranks sharing one card over gloo (hops through pinned host "
                "memory): not a reading of pipeline parallelism's speed on separate cards",
        "reduced": [{"key": "hidden_dropout_prob (compared steps)", "default": 0.1, "run": 0.0},
                    {"key": "num_warmup_steps (compared steps)", "default": 1000, "run": 0},
                    {"key": "num_train_steps", "default": 80000,
                     "run": f"{PP_STEPS} compared, {PP_CLI_STEPS} CLI"},
                    {"key": "num_warmup_steps (CLI)", "default": 1000, "run": 2},
                    {"key": "checkpoint_every", "default": 5000, "run": PP_CLI_CKPT_EVERY}],
        "model_1": ref, "ranks": [r["steps"] for r in ranks],
        "loss_rel_diff": loss_rel, "grad_gap": st["grad_gap"],
        "probe_grad_gap": st["probe_grad_gap"],
        "probe_word_embed_rel": st["probe_word_embed_rel"],
        "tokens_per_s_slower_rank": GT_BATCH * GT_SEQ / slower,
        "tokens_per_s_one_process": ref["tokens_per_s"],
        "peak_mem_gib_per_rank": [r["steps"]["peak_mem_gib"] for r in ranks],
        "hop_seconds_per_step": [r["steps"]["hop_seconds"] for r in ranks],
        "hop_bytes_per_step": [r["steps"]["hop_bytes"] for r in ranks],
        "bubble_share": bubble,
        "cli": {"a_losses": {s: a_train[s]["loss"] for s in sorted(a_train)},
                "b_losses": {s: b_train[s]["loss"] for s in sorted(b_train)},
                "seconds": [[r["cli_a_s"], r["cli_b_s"]] for r in ranks],
                "launches": [r["cli_launches"] for r in ranks]},
        "ckpt_stage_shapes": last["ckpt_stage_shapes"], "roundtrip": last["roundtrip"],
        "forward_launches": [r["forward_launches"] for r in ranks],
        "rank_seconds": [r["seconds"] for r in ranks],
        "launches": {"attention_fwd": sum(r["steps"]["launches"]["attention_fwd"]
                                          + r["cli_launches"]["attention_fwd"]
                                          + r["forward_launches"] for r in ranks),
                     "attention_bwd": sum(r["steps"]["launches"]["attention_bwd"]
                                          + r["cli_launches"]["attention_bwd"] for r in ranks),
                     "attention_stacked": last["roundtrip"]["launches"]["attention_stacked"]},
        "phase_seconds": time.perf_counter() - t_phase}
    print(f"[pipeline-parallel] {json.dumps(result)}", flush=True)
    print(f"[pipeline-parallel] {card}: pp=2, two ranks sharing the card over gloo: "
          f"grover-medium {result['tokens_per_s_slower_rank']:.1f} tokens/s (the slower "
          f"rank's step 2; one process: {ref['tokens_per_s']:.1f}), loss gaps {loss_rel}, "
          f"grad gap {st['grad_gap']['max_rel']:.4g}, probe grad gap "
          f"{st['probe_grad_gap']['max_rel']:.4g}; peak "
          f"{result['peak_mem_gib_per_rank']} GiB per rank (one process "
          f"{ref['peak_mem_gib']:.2f}); hops {result['hop_seconds_per_step']} s per step; "
          f"bubble {bubble:.4f}; round trip {last['roundtrip']['max_abs_diff']:.3g}; "
          f"{result['phase_seconds']:.1f} s", flush=True)
    check(all(x <= GT_LOSS_RTOL for x in loss_rel),
          f"pipeline-parallel losses vs one process: {loss_rel} > {GT_LOSS_RTOL}")
    check(st["grad_gap"]["max_rel"] <= GT_GRAD_TOL,
          f"pipeline-parallel step-1 grads vs one process: {st['grad_gap']} > {GT_GRAD_TOL}")
    check(st["probe_grad_gap"]["max_rel"] > GT_GRAD_TOL,
          f"the probe (word_embed's gradient not summed over the stages) passes the bound: "
          f"{st['probe_grad_gap']}")
    for r in ranks:
        check(r["steps"]["launches_per_step"]
              == [[PP_LAUNCHES_PER_STEP, PP_LAUNCHES_PER_STEP]] * PP_STEPS,
              f"rank {r['rank']}: K1/K2 launches per step {r['steps']['launches_per_step']}, "
              f"want {PP_LAUNCHES_PER_STEP} each")
        check(r["cli_launches"] == {"attention_fwd": PP_LAUNCHES_PER_STEP * (PP_CLI_STEPS + 1),
                                    "attention_bwd": PP_LAUNCHES_PER_STEP * (PP_CLI_STEPS + 1)},
              f"rank {r['rank']}: the CLI runs' K1/K2 launches {r['cli_launches']}")
        check(r["forward_launches"] == 24 // PP_STAGES * GT_ROUNDTRIP[0],
              f"rank {r['rank']}: the trained forward's K1 launches {r['forward_launches']}")
    check(sorted(a_train) == list(range(1, PP_CLI_STEPS + 1))
          and sorted(b_train) == [PP_CLI_STEPS],
          f"the CLI runs logged steps {sorted(a_train)} and {sorted(b_train)}")
    for x in a_train.values():
        bad = {k: v for k, v in x.items() if not math.isfinite(v)}
        check(not bad, f"the --pp 2 CLI's step {x['step']}: non-finite metrics {bad}")
    check(b_train[PP_CLI_STEPS]["loss"] == a_train[PP_CLI_STEPS]["loss"],
          f"the resumed --pp 2 run's step {PP_CLI_STEPS} loss {b_train[PP_CLI_STEPS]['loss']} "
          f"!= the straight run's {a_train[PP_CLI_STEPS]['loss']}")
    shapes = last["ckpt_stage_shapes"]
    check(bool(shapes) and all(v[:2] == [PP_STAGES, 24 // PP_STAGES] for v in shapes.values()),
          f"the checkpoint's stages/ leaves {shapes}")
    check(last["roundtrip"]["launches"] == {"attention_stacked": 24},
          f"the round trip's K3 launches {last['roundtrip']['launches']}")
    check(last["roundtrip"]["max_abs_diff"] <= GT_ROUNDTRIP_TOL,
          f"the Denoiser's logits vs the trained ranks': {last['roundtrip']['max_abs_diff']} > "
          f"{GT_ROUNDTRIP_TOL}")
    return result


def per_path(prefix: str, rows: dict, shapes: tuple, launches: int = 12) -> dict:
    """The plain version's, SDPA's and the bound's ms over a path's
    ``launches`` at each of ``shapes`` (per-call times of the kernel
    phases)."""
    return {f"{prefix}_{k}": launches * sum(rows[n][k] for n in shapes)
            for k in ("plain_ms", "library_ms", "bound_ms")}


def remat_launches(rc: dict, i: int) -> dict:
    """Launches of kernel ``i`` (K1, K2, K4, K5) over each remat case's
    timed steps, where it launched."""
    return {f"remat_{name}": c["launches"][i] for name, c in rc["remat"].items()
            if c["launches"][i]}


def rect_row(rc: dict, shape: str) -> dict:
    """A cross-attention or decode kernel row's times and bound per call."""
    row = {r["shape"]: r for r in rc["kernel_rows"]}[shape]
    return {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                "bound_whole_cache_ms") if k in row}


def kernel_records(k1_rows, k2_rows, k3_rows, k4_rows, k5_rows, sl, tr, fsl, ftr, fprof,
                   gv, sv, fd, cli, zs_cli, vcr, gt, cp, dp, tp, ppl, rc) -> list[dict]:
    """The kernels line: one record per kernel from the phases' results;
    fd: the first-design phase's per-path times, or None (then the
    first_design_ms fields are null)."""
    k1_rc = {**remat_launches(rc, 0), "cross_attention": rc["cross"]["launches"][0],
             "encoder_cache_decode": rc["decode"]["k1_launches"]}
    k2_rc = {**remat_launches(rc, 1), "cross_attention": rc["cross"]["launches"][1]}
    first = {k: fd["per_path"][k]["first_design_ms"] if fd else None
             for k in ("k1_zero_shot_batch", "k1_train_step", "k2_train_step", "k3_prefill",
                       "k3_decode_step", "k4_train_step", "k4_zero_shot_batch",
                       "k5_train_step", "k5_zero_shot_batch", "k3_prefill_fp32",
                       "k1_grover_step", "k2_grover_step")}
    # per zero-shot batch (12 launches at each zero-shot shape), as ms and
    # plain_ms are
    zs = {r["shape"]: r for r in k1_rows}
    k1_bound = [zs[n]["bound_ms"] for n in ("zeroshot_vit", "zeroshot_joint")]
    k1_record = {
        "name": "attention_fwd", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "merlot_tpu/ops/pallas_attention.py:273",
        "launches": sl["launches"] + tr["launches"]["attention_fwd"]
        + cli["launches"]["attention_fwd"] + zs_cli["launches"]
        + vcr["launches"]["attention_fwd"] + sum(e["launches"] for e in vcr["eval"].values())
        + gt["launches"]["attention_fwd"] + gt["roundtrip"]["launches"]["attention_fwd"]
        + sum(k1 for _, k1, _ in cp["launches_per_step"]) + dp["launches"]["attention_fwd"]
        + tp["launches"]["attention_fwd"] + ppl["launches"]["attention_fwd"]
        + sum(k1_rc.values()),
        "launches_by_path": {**k1_rc, "zero_shot": sl["launches"],
                             "train": tr["launches"]["attention_fwd"],
                             "pretrain_cli": cli["launches"]["attention_fwd"],
                             "zero_shot_cli": zs_cli["launches"],
                             "vcr_train": vcr["launches"]["attention_fwd"],
                             **{f"vcr_eval_{m}": e["launches"]
                                for m, e in vcr["eval"].items()},
                             "grover_train": gt["launches"]["attention_fwd"],
                             "grover_roundtrip_forward":
                                 gt["roundtrip"]["launches"]["attention_fwd"],
                             "corpus_pretrain_cli": sum(k1 for _, k1, _ in
                                                        cp["launches_per_step"]),
                             "data_parallel_pretrain_cli": sum(
                                 k1 for _, k1, _ in dp["pretrain_cli"]["launches_per_step"]),
                             "data_parallel_vcr_train": sum(
                                 k1 for _, k1, _ in dp["vcr"]["launches_per_step"]),
                             "data_parallel_zero_shot_cli": dp["zero_shot_cli"]["launches"],
                             "tensor_parallel_pretrain_both_ranks":
                                 tp["launches"]["attention_fwd"],
                             "pipeline_parallel_grover_both_ranks":
                                 ppl["launches"]["attention_fwd"]},
        "max_abs_err": max([r["max_abs_err"] for r in k1_rows]
                           + [r["max_abs_err"] for r in rc["kernel_rows"]
                              if r["shape"] != "cross_k2"]),
        # per call at cross-attention's shape (8 x 256 queries over 396
        # keys, a rectangular mask) and at the encoder cache's decode step
        # (8 x 1 query over 512 slots), from the remat_and_cross phase
        "cross_per_call": rect_row(rc, "cross_k1"),
        "decode_per_call": rect_row(rc, "decode_k1"),
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
                                   ("pretrain_vit", "pretrain_joint", "pretrain_lang")),
        # per zero-shot CLI batch (the slice's shapes): CUDA events on the
        # in-process run over the CLI's loader batches
        "zero_shot_cli_ms_per_batch": zs_cli["k1_ms_per_batch"],
        # per VCR train step (12 launches at each VCR shape): the profile of
        # run B, and the per-call times at those shapes; per VCR eval batch
        # (12 at each eval shape): CUDA events on the path (median of the
        # modes) and the eval shapes' per-call times
        "vcr_train_ms_per_step": vcr["k1_ms_per_step"],
        **per_path("vcr_train", zs, ("vcr_vit", "vcr_joint")),
        "vcr_eval_ms_per_batch": statistics.median(
            e["k1_ms_per_batch"] for e in vcr["eval"].values()),
        **per_path("vcr_eval", zs, ("vcr_eval_vit", "vcr_eval_joint")),
        # per Grover train step (24 launches at B 8 x S 1536, 16 heads, fp32,
        # causal): the side loop's profile (the mask classifier included),
        # and the per-call times at that shape
        "grover_train_ms_per_step": gt["k1_ms_per_step"],
        "grover_train_shape_sum_ms": 24 * zs["grover_train"]["ms"],
        "grover_train_first_design_ms": first["k1_grover_step"],
        **per_path("grover_train", zs, ("grover_train",), 24),
        # per train step of one rank at model=2 (12 launches at each tower's
        # shape at 6 heads): the per-call times; SDPA at the ViT and joint
        # shapes (lang has no single call)
        **{f"tp_train_{k}": 12 * sum(zs[n[0]][k] for n in TP_ATTN_SHAPES)
           for k in ("ms", "plain_ms", "bound_ms")},
        "tp_train_library_ms": 12 * (zs["tp_pretrain_vit"]["library_ms"]
                                     + zs["tp_pretrain_joint"]["library_ms"]),
        # per pp=2 Grover train step of one rank (12 layers x 8 microbatches
        # of 1 x 1536): the per-call times at the microbatch's shape
        **{f"pp_grover_step_{k}": PP_LAUNCHES_PER_STEP * zs["pp_grover_mb1"][k]
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    # per train step (12 launches at each pretrain shape)
    tb = {r["shape"]: r for r in k2_rows}
    train_shapes = ("pretrain_vit", "pretrain_joint", "pretrain_lang")
    k2_record = {
        "name": "attention_bwd", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "merlot_tpu/ops/pallas_attention.py:504",
        "launches": tr["launches"]["attention_bwd"] + cli["launches"]["attention_bwd"]
        + vcr["launches"]["attention_bwd"] + gt["launches"]["attention_bwd"]
        + sum(k2 for _, _, k2 in cp["launches_per_step"]) + dp["launches"]["attention_bwd"]
        + tp["launches"]["attention_bwd"] + ppl["launches"]["attention_bwd"]
        + sum(k2_rc.values()),
        "launches_by_path": {**k2_rc, "train": tr["launches"]["attention_bwd"],
                             "pretrain_cli": cli["launches"]["attention_bwd"],
                             "vcr_train": vcr["launches"]["attention_bwd"],
                             "grover_train": gt["launches"]["attention_bwd"],
                             "corpus_pretrain_cli": sum(k2 for _, _, k2 in
                                                        cp["launches_per_step"]),
                             "data_parallel_pretrain_cli": sum(
                                 k2 for _, _, k2 in dp["pretrain_cli"]["launches_per_step"]),
                             "data_parallel_vcr_train": sum(
                                 k2 for _, _, k2 in dp["vcr"]["launches_per_step"]),
                             "tensor_parallel_pretrain_both_ranks":
                                 tp["launches"]["attention_bwd"],
                             "pipeline_parallel_grover_both_ranks":
                                 ppl["launches"]["attention_bwd"]},
        "max_abs_err": max([r["max_abs_err"] for r in k2_rows]
                           + [{r["shape"]: r for r in rc["kernel_rows"]}["cross_k2"]
                              ["max_abs_err"]]),
        "cross_per_call": rect_row(rc, "cross_k2"),
        "ms": tr["k2_ms"], "plain_ms": tr["plain_k2_ms_per_step"],
        "bound_ms": 12 * sum(tb[n]["bound_ms"] for n in train_shapes),
        "bound_by": tb["pretrain_vit"]["bound_by"],
        "library_ms": 12 * sum(tb[n]["library_ms"] for n in train_shapes),
        "first_design_ms": first["k2_train_step"],
        "shape_sum_ms": 12 * sum(tb[n]["ms"] for n in train_shapes),
        "library_note": "backward of scaled_dot_product_attention: fp32 softmax, "
                        "no colsum cotangent; not the same rounding",
        # per VCR train step (12 launches at each VCR shape, fp32 softmax):
        # the profile of run B, and the per-call times at those shapes
        "vcr_train_ms_per_step": vcr["k2_ms_per_step"],
        **per_path("vcr_train", tb, ("vcr_vit", "vcr_joint")),
        # per Grover train step (24 launches, fp32, causal): the side loop's
        # profile, and the per-call times at that shape (SDPA's backward is
        # the same function there)
        "grover_train_ms_per_step": gt["k2_ms_per_step"],
        "grover_train_shape_sum_ms": 24 * tb["grover_train"]["ms"],
        "grover_train_first_design_ms": first["k2_grover_step"],
        **per_path("grover_train", tb, ("grover_train",), 24),
        **{f"tp_train_{k}": 12 * sum(tb[n[0]][k] for n in TP_ATTN_SHAPES)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        **{f"pp_grover_step_{k}": PP_LAUNCHES_PER_STEP * tb["pp_grover_mb1"][k]
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    # per decode step on the Grover path: 24 launches at its shape (B=8,
    # Sk=1216, kv_len 1101), the kernel, the plain version, SDPA and the
    # bound (live slots) all from the K3 phase's timing of that shape (the
    # path's own CUDA-event spans include the host's gaps between launches);
    # K3's device time on the path, from the profile of the 32-token
    # generation, beside the bound of that generation's own decode steps
    tk = {r["shape"]: r for r in k3_rows}
    k3 = tk["decode_b8_bf16_bench"]
    pre = {r["shape"]: r for r in k3_rows}["prefill_b8_bf16"]
    pre32 = {r["shape"]: r for r in k3_rows}["prefill_b2_fp32"]
    k3_record = {
        "name": "attention_stacked", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/attention_stacked.cu",
        "replaces": "merlot_tpu/ops/pallas_attention.py:656",
        "launches": gv["launches"]["attention_stacked"]
        + sv["launches"]["attention_stacked"]
        + gt["roundtrip"]["launches"]["attention_stacked"]
        + tp["launches"]["attention_stacked"] + ppl["launches"]["attention_stacked"],
        "launches_by_path": {"grover_decode": gv["launches"]["attention_stacked"],
                             "server": sv["launches"]["attention_stacked"],
                             "grover_train_roundtrip_prefill":
                                 gt["roundtrip"]["launches"]["attention_stacked"],
                             "tensor_parallel_server_both_ranks":
                                 tp["launches"]["attention_stacked"],
                             "pipeline_parallel_roundtrip_prefill":
                                 ppl["launches"]["attention_stacked"]},
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
        "prefill_path_device_ms": gv["k3_prefill_device_ms"],
        # the fp32 prefill (attention_fp32.cuh's K1 kernel): 24 launches at
        # B=2, Sq=1024, Sk=1537, as Grover training's round trip serves
        "prefill_fp32_ms": 24 * pre32["ms"], "prefill_fp32_plain_ms": 24 * pre32["plain_ms"],
        "prefill_fp32_library_ms": 24 * pre32["library_ms"],
        "prefill_fp32_bound_ms": 24 * pre32["bound_ms"],
        "prefill_fp32_first_design_ms": first["k3_prefill_fp32"],
        # one rank at model=2 (8 of 16 heads), from the K3 phase's timing:
        # 24 launches per decode step (B=8, Sk=1537, kv_len 1101) and per
        # prefill (B=8, Sq=1024), bf16 and fp32
        **{f"{n}_{k}": 24 * tk[n][k] for n in tk if n.startswith("tp_")
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    # per train step: the 54 GroupNorm sites and the 72 LayerNorm+matmul
    # sites (12 layers x 2 in each tower). "ms" is the kernel's device time
    # on the fused path (torch.profiler, per step), "event_ms"
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
        "launches": fsl["launches"]["groupnorm"] + ftr["launches"]["groupnorm"]
        + sum(remat_launches(rc, 2).values()),
        "launches_by_path": {"zero_shot_fused": fsl["launches"]["groupnorm"],
                             "train_fused": ftr["launches"]["groupnorm"],
                             **remat_launches(rc, 2)},
        "max_abs_err": max(r["max_abs_err"] for r in k4_rows),
        "ms": fprof["families"]["K4 groupnorm"]["ms"] / fprof["steps"],
        "event_ms": ftr["k4_ms"],
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
    ln_path = lambda prefix, key: 12 * sum(ln[spec[0]][key] for spec in LN_SHAPES + TP_LN_SHAPES
                                           if spec[0].startswith(prefix))
    k5_record = {
        "name": "ln_matmul", "route": "cuda",
        "source": "merlot_tpu_torch/csrc/ln_matmul.cu",
        "replaces": "merlot_tpu/ops/pallas_ln_matmul.py:117",
        "launches": fsl["launches"]["ln_matmul"] + ftr["launches"]["ln_matmul"]
        + sum(remat_launches(rc, 3).values()),
        "launches_by_path": {"zero_shot_fused": fsl["launches"]["ln_matmul"],
                             "train_fused": ftr["launches"]["ln_matmul"],
                             **remat_launches(rc, 3)},
        "max_abs_err": max(r["max_abs_err"] for r in k5_rows),
        "ms": fprof["families"]["K5 ln_matmul"]["ms"] / fprof["steps"],
        "event_ms": ftr["k5_ms"],
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
        "unit": "per train step: 72 launches, 12 layers x (q/k/v, MLP) x 3 towers, K=768, bf16",
        # a fused step's sites at model=2 (this rank's columns), summed over
        # the sites from the per-shape times
        **{f"tp_train_{k}": ln_path("tp_pretrain", k)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    return [k1_record, k2_record, k3_record, k4_record, k5_record]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the run's details to this JSON file")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of the first designs' commit (83510f1): time them "
                         "against the current K1-K5 (first_design phase)")
    ap.add_argument("--grover-profile", metavar="CKPT",
                    help="only the Grover training step's profile at this checkpoint "
                         "(with --train-files and --out; the Grover phase runs it)")
    ap.add_argument("--train-files", help="with --grover-profile: the LM shards' glob")
    ap.add_argument("--dp-child", choices=("pretrain", "vcr", "zero_shot"),
                    help="only one rank of the data_parallel phase (with --dp-config and "
                         "--dp-out; the phase runs it with the rank's variables set)")
    ap.add_argument("--dp-config", help="with --dp-child: the entry point's config")
    ap.add_argument("--dp-out", help="with --dp-child: where its record goes")
    ap.add_argument("--tp-child", type=int, metavar="RANK",
                    help="only one rank of the tensor_parallel phase (with --tp-port and "
                         "--tp-dir; the phase starts both)")
    ap.add_argument("--tp-port", help="with --tp-child: the process group's port")
    ap.add_argument("--tp-dir", help="with --tp-child: the phase's directory")
    ap.add_argument("--pp-child", type=int, metavar="RANK",
                    help="only one rank of the pipeline_parallel phase (with --pp-ports and "
                         "--pp-dir; the phase starts both)")
    ap.add_argument("--pp-ports", help="with --pp-child: the process groups' ports")
    ap.add_argument("--pp-dir", help="with --pp-child: the phase's directory")
    ap.add_argument("--dispatch-cost", action="store_true",
                    help="only K1's and K5's forwards through their dispatcher ops against "
                         "direct calls, in turns (dispatch_cost_phase)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.grover_profile:
        return grover_profile_child(args.grover_profile, args.train_files, args.out)
    if args.dp_child:
        return dp_child(args.dp_child, args.dp_config, args.dp_out)
    if args.tp_child is not None:
        return tp_child(args.tp_child, args.tp_port, args.tp_dir)
    if args.pp_child is not None:
        return pp_child(args.pp_child, args.pp_ports, args.pp_dir)
    from merlot_tpu_torch import _build
    if args.dispatch_cost:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
        _build.build_libraries(("attention_fwd", "attention_bwd", "groupnorm", "ln_matmul"))
        result = {"card": card, "dispatch_cost": dispatch_cost_phase(torch.device("cuda", 0))}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(json.dumps(result), flush=True)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    libs = ("attention_fwd", "attention_bwd", "attention_stacked", "groupnorm", "ln_matmul",
            "jpeg")
    t0 = time.perf_counter()
    _build.build_libraries(libs)
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(libs)} in {build_s:.1f}s; each compile and link: "
          f"{json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})}", flush=True)
    for name in libs:
        print(_build.build_logs.get(name, ""), flush=True)

    # each phase's wall seconds, printed as it ends and kept in --out
    phase_s = {"build": build_s}
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name], last[0] = now - last[0], now
        print(f"[time] {name} {phase_s[name]:.1f}s", flush=True)

    k1_rows = kernel_phase(dev)
    lap("k1")
    k2_rows = bwd_kernel_phase(dev)
    lap("k2")
    k3_rows = stacked_phase(dev)
    lap("k3")
    k4_rows = gn_kernel_phase(dev)
    lap("k4")
    k5_rows = ln_kernel_phase(dev)
    lap("k5")
    ab_rows = ablation_phase(dev)
    lap("ablation")
    old = parent_calls(parent_libraries(args.parent), dev) if args.parent else None
    fd = first_design_phase(dev, old) if old else None
    lap("first_design")
    sl, *zero_shot = slice_phase(dev)
    lap("zero_shot")
    fsl = fused_slice_phase(dev, *zero_shot)
    del zero_shot
    lap("fused_zero_shot")
    tr, model, state, step, batch, ref = train_phase(dev)
    prof = profile_steps(dev, step, model, state, batch)
    del model, state, step, batch
    torch.cuda.empty_cache()
    lap("train")
    ftr, fprof = fused_train_phase(dev, ref)
    torch.cuda.empty_cache()
    lap("fused_train")
    rc = remat_and_cross_phase(dev, ref["state"])
    del ref
    torch.cuda.empty_cache()
    lap("remat_and_cross")
    ab = ab_phase(dev)
    lap("train_ab")
    gv = grover_phase(dev)
    lap("grover_decode")
    with tempfile.TemporaryDirectory() as tmp:
        sv = server_phase(dev, Path(tmp) / "denoise_log.jsonl")
    lap("server")
    # shards and ~1.7 GB checkpoints; the data_parallel phase reads all three
    with tempfile.TemporaryDirectory() as cli_tmp, tempfile.TemporaryDirectory() as zs_tmp, \
            tempfile.TemporaryDirectory() as vcr_tmp:
        cli = cli_phase(dev, Path(cli_tmp))
        lap("pretrain_cli")
        zs_cli = zero_shot_cli_phase(dev, Path(zs_tmp), sl["stories_per_s"])
        lap("zero_shot_cli")
        vcr = vcr_phase(dev, Path(vcr_tmp))
        lap("vcr")
        dp = data_parallel_phase(dev, Path(cli_tmp), Path(zs_tmp), Path(vcr_tmp), cli, zs_cli)
        lap("data_parallel")
    with tempfile.TemporaryDirectory() as tmp:  # ~4.3 GB checkpoints
        gt = grover_train_phase(dev, Path(tmp), old)
    lap("grover_train")
    with tempfile.TemporaryDirectory() as tmp:
        cp = corpus_phase(dev, Path(tmp))
    lap("corpus")
    tp = tensor_parallel_phase(dev)
    lap("tensor_parallel")
    ppl = pipeline_parallel_phase(dev)
    lap("pipeline_parallel")

    records = kernel_records(k1_rows, k2_rows, k3_rows, k4_rows, k5_rows, sl, tr, fsl,
                             ftr, fprof, gv, sv, fd, cli, zs_cli, vcr, gt, cp, dp, tp, ppl, rc)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "build_seconds": _build.build_seconds,
             "phase_seconds": phase_s,
             "kernel_shapes": k1_rows,
             "bwd_kernel_shapes": k2_rows, "stacked_kernel_shapes": k3_rows,
             "groupnorm_kernel_shapes": k4_rows, "ln_matmul_kernel_shapes": k5_rows,
             "slice": sl, "fused_slice": fsl, "train": tr, "profile": prof,
             "fused_train": ftr, "fused_profile": fprof, "remat_and_cross": rc,
             "train_ab": ab,
             "grover": gv, "server": sv, "cli": cli, "zero_shot_cli": zs_cli,
             "vcr": vcr, "data_parallel": dp, "grover_train": gt, "corpus": cp,
             "tensor_parallel": tp, "pipeline_parallel": ppl,
             "ablation": ab_rows,
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
