#!/usr/bin/env python3
"""GPU drive of the PyTorch port (merlot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out details.json]

1. builds the attention kernels from csrc/ with nvcc, one process each, in
   parallel: K1 (forward) and K2 (backward);
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
   fully masked rows;
4. zero-shot phase: MerlotModel at the configs/pretrain_5seg.yaml model
   block (full width and depth, seeded random weights on the card) runs
   zero-shot story ordering on 3 batches of 2 synthetic stories, checks the
   outputs and that every batch launched K1 24 times, compares the batches
   with the same model on the plain attention, shows that this comparison
   sees a broken attention (the joint mask dropped), and reports stories/s
   and K1's time per batch (CUDA events around its launches), both as the
   median over the batches;
5. train phase: MerlotPretrainModel and AdamW at the configs/pretrain_4seg.yaml
   model and optimizer blocks (full width and depth, seeded random weights
   on the card), bench.py's batch (8 x 16 chunks x 32 tokens, with padded
   chunk tails): one warm-up step, then 5 steps each timed alone, with
   segments/s, K1 and K2 ms per step, 36 launches of each per step and the
   peak memory; the loss falls over steps on the repeated batch (no
   warmup); one step's loss and gradients through the kernels match the
   plain attention's within a bound, and a backward with the mask dropped
   exceeds it; then torch.profiler over two more steps gives the device
   time by kernel family and the device's idle share.

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

# the card's peak rates (NVIDIA's H100 SXM data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

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


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the bf16 tensor-core peak and the bytes over the
    device-memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
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
    ctx, cs = ca.attention_fwd_cuda(q, k, v, mask, softmax_fp32=sm32, **kw)
    torch.cuda.synchronize()
    ref, ref_cs = ca.flash_attention_plain(q, k, v, mask, softmax_fp32=sm32, **kw)
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
           "other_softmax_differing_share": (other_diff > 0).float().mean().item()}
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
    torch.cuda.synchronize()
    ref = ca.attention_bwd_plain(q, k, v, mask, do, gcol, **kw)
    other = ca.attention_bwd_plain(q, k, v, mask, do, gcol, num_heads=HEADS,
                                   softmax_fp32=not sm32)
    row = {"shape": name, "batch": b, "seq": s, "masked": masked,
           "colsum_cotangent": colsum, "softmax": "fp32" if sm32 else "bf16",
           "grads": grad_errors(got, ref),
           "other_softmax_mean_abs_diff": min(
               e["mean_abs_err"] for e in grad_errors(other, ref).values())}
    if colsum:
        nog = ca.attention_bwd_plain(q, k, v, mask, do, None, **kw)
        row["no_colsum_cotangent_mean_abs_diff"] = grad_errors(nog, ref)["dq"]["mean_abs_err"]
    if masked:
        bi, qi = torch.nonzero(~valid, as_tuple=True)
        row["dq_masked_rows_max_abs"] = got[0][bi, qi].float().abs().max().item()
    row["max_abs_err"] = max(e["max_abs_err"] for e in row["grads"].values())
    row["ms"] = cuda_ms(lambda: ca.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw))
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
    floored at 1e-3 of the largest |grad| of all; the worst tensor."""
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    per = {n: (grads[n] - r).abs().max().item() / max(r.abs().max().item(), floor)
           for n, r in ref.items()}
    worst = max(per, key=per.get)
    return {"max_rel": per[worst], "worst_tensor": worst,
            "median_rel": statistics.median(per.values())}


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
    ca.launches = ca.bwd_launches = 0
    s1, s2 = [], []
    with wrapped(merlot_mod, "attention_guided_span_mask", pin), \
            wrapped(ca, "attention_fwd_cuda",
                    lambda f: event_timed(s1)(ca.flash_attention_plain)), \
            wrapped(ca, "attention_bwd_cuda",
                    lambda f: event_timed(s2)(ca.attention_bwd_plain)):
        plain_loss, plain_grads = loss_and_grads(model, batch, draws)
    check(ca.launches == ca.bwd_launches == 0, "the plain run launched a kernel")
    no_mask_bwd = lambda q, k, v, mask, *a, **kw: ca.attention_bwd_plain(q, k, v, None,
                                                                         *a, **kw)
    with wrapped(merlot_mod, "attention_guided_span_mask", pin), \
            wrapped(ca, "attention_fwd_cuda", lambda f: ca.flash_attention_plain), \
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
    return result, model, state, step, batch


def kernel_family(name: str) -> str:
    """A coarse family for a kernel name in a profile: this package's two
    kernels, library matmuls and convolutions, or everything else
    (elementwise, reductions, norms, copies, RNG)."""
    low = name.lower()
    if "attention_fwd" in low:
        return "K1 attention_fwd"
    if "attention_bwd" in low:
        return "K2 attention_bwd"
    if any(t in low for t in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "matmul")):
        return "matmul"
    return "elementwise, reduction and other"


def profile_steps(dev, step, model, state, batch) -> dict:
    """torch.profiler over two train steps: device time by kernel and the
    device's idle share (the profiler's own overhead counts as idle)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(model, state, batch, g)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:40]
    families = {}
    for e in events:
        fam = kernel_family(e.key)
        ms, n = families.get(fam, (0.0, 0))
        families[fam] = (ms + e.self_device_time_total / 1e3, n + e.count)
    summary = {"steps": 2, "wall_ms": wall_ms, "device_ms": total,
               "device_idle_share": 1 - total / wall_ms if wall_ms else None,
               "families": {f: {"ms": ms, "launches": n}
                            for f, (ms, n) in sorted(families.items(),
                                                     key=lambda x: -x[1][0])},
               "top_kernels": [{"name": e.key, "ms": e.self_device_time_total / 1e3,
                                "count": e.count} for e in top]}
    print(f"[profile] {json.dumps({k: summary[k] for k in summary if k != 'top_kernels'})}",
          flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the run's details to this JSON file")
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

    t0 = time.perf_counter()
    _build.build_libraries(["attention_fwd", "attention_bwd"])
    build_s = time.perf_counter() - t0
    print(f"[build] attention_fwd, attention_bwd in {build_s:.1f}s", flush=True)
    for name in ("attention_fwd", "attention_bwd"):
        print(_build.build_logs.get(name, ""), flush=True)

    k1_rows = kernel_phase(dev)
    k2_rows = bwd_kernel_phase(dev)
    sl = slice_phase(dev)
    tr, model, state, step, batch = train_phase(dev)
    prof = profile_steps(dev, step, model, state, batch)

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
        "train_ms_per_step": tr["k1_ms"]}
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
        "library_note": "backward of scaled_dot_product_attention: fp32 softmax, "
                        "no colsum cotangent; not the same rounding"}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernel_shapes": k1_rows,
             "bwd_kernel_shapes": k2_rows, "slice": sl, "train": tr,
             "profile": prof, "records": [k1_record, k2_record],
             "ptxas": {n: _build.build_logs.get(n, "")
                       for n in ("attention_fwd", "attention_bwd")}},
            indent=1))
    print(json.dumps({"kernels": [k1_record, k2_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
