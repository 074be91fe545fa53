#!/usr/bin/env python3
"""GPU drive of the PyTorch port (merlot_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out details.json]

1. builds the attention-forward kernel from csrc/ with nvcc;
2. kernel phase: holds the kernel against its plain PyTorch version at the
   two zero-shot shapes (fp32 softmax) and the three pretrain shapes (bf16
   softmax), all in bf16, and times both with CUDA events;
3. slice phase: builds MerlotModel at the configs/pretrain_5seg.yaml model
   block (full width and depth, seeded random weights on the card), runs
   zero-shot story ordering on 3 batches of 2 synthetic stories, checks the
   outputs and that every batch launched the kernel 24 times, compares the
   batches with the same model on the plain attention, shows that this
   comparison sees a broken attention (the joint mask dropped), and reports
   stories/s and the kernel's time per batch, both as the median over the
   batches (the kernel's time from CUDA events around its launches).

Prints the card's name and power limit early, one JSON line of kernel
records before the last line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
``--out`` writes the per-shape details, the slice numbers and the ptxas
report to a JSON file. Any failed check raises, so the script exits
non-zero; without a CUDA card it exits 1 and prints no result.
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
# 4 rows of 5*(12*12+1) + 5*32 tokens), then the pretrain shapes
ATTN_SHAPES = [
    ("zeroshot_vit", 20, 578, False, False, True),
    ("zeroshot_joint", 4, 885, True, False, True),
    ("pretrain_vit", 128, 266, False, False, False),
    ("pretrain_joint", 32, 396, True, False, False),
    ("pretrain_lang", 8, 512, True, True, False),
]
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
# probs, kernel vs plain attention through 24 bf16 layers: 2.7e-3 to 3.3e-3
# on the H100; dropping the joint tower's mask moves them by 1.2e-2
SLICE_TOL = 6e-3
STORIES, CHUNKS, TOKENS = 2, 5, 32
BATCHES = 3
LAUNCHES_PER_BATCH = 24

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


def kernel_shape(dev, g, spec) -> dict:
    """The kernel and its plain version at one shape: errors and times."""
    import torch
    from merlot_tpu_torch.ops import cuda_attention as ca

    name, b, s, masked, colsum, sm32 = spec
    q, k, v = (torch.randn((b, s, HEADS * D_HEAD), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = valid = None
    if masked:   # validity mask with padding rows, as the towers build it
        valid = torch.rand((b, s), generator=g, device=dev) > 0.15
        valid[:, 0] = True
        mask = (valid[:, None] & valid[:, :, None]).float()
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
    """The kernel against its plain version at the five shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for spec in ATTN_SHAPES:
        row = kernel_shape(dev, g, spec)
        print(f"[kernel] {json.dumps(row)}", flush=True)
        check_kernel_row(row)
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
    from merlot_tpu_torch.ops import cuda_attention as ca

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    ca.load_kernel()
    build_s = time.perf_counter() - t0
    print(f"[build] attention_fwd in {build_s:.1f}s", flush=True)
    print(_build.build_logs.get("attention_fwd", ""), flush=True)

    rows = kernel_phase(dev)
    sl = slice_phase(dev)

    record = {"name": "attention_fwd", "route": "cuda",
              "source": "merlot_tpu_torch/csrc/attention_fwd.cu",
              "replaces": "merlot_tpu/ops/pallas_attention.py:273",
              "launches": sl["launches"],
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              # per zero-shot batch on the main path (24 launches), median
              # over the batches: the kernel, and the plain attention in the
              # same model's plain run
              "ms": sl["k1_ms"],
              "plain_ms": sl["plain_attention_ms"]}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernel_shapes": rows, "slice": sl,
             "record": record, "ptxas": _build.build_logs.get("attention_fwd", "")},
            indent=1))
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
