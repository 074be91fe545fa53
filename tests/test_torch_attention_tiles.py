"""The Hopper attention kernels' algorithms, emulated tile by tile on the CPU.

K1 (csrc/attention_fwd_tiles.cuh) runs a warpgroup per 64-row q tile and
makes two passes over 64-key K tiles: the row max of the rounded, masked
scores with the row sum of exp(s - max) (rescaled when the max grows), then
p = round_sm(exp(s - max) / sum), its column sums and ctx += round(p) . V.
It saves the max and sum. K2 (csrc/attention_bwd.cu) takes them: a rows
kernel (per 64-row q tile, two passes over K/V: D = rowsum((dP + g/H) * P),
then dS and dQ = dS . K with dS as three exact bf16 terms) and a column
kernel (per 64-key tile, walking the q tiles: dV += P^T . dO, dK += dS^T .
Q). The kernels pair two warpgroups in a block; the emulation's tiles are
each warpgroup's. K3's prefill runs K1's tiles over the stacked
[B, Sk, 2*H*D] cache, values at column H*D, one mask shared by the batch.

``emulate_fwd`` and ``emulate_bwd`` replay those tiles, ragged edges and
rounding points in plain PyTorch (fp32 sums in torch's order, not the
card's). ``emulate_fwd_f32`` and ``emulate_bwd_f32`` replay the fp32 routes
(csrc/attention_fp32.cuh): fp32 products on the same tiles, the mask's
64 x 64 tiles sorted by ``tile_classes`` (all 0, all 1, mixed) and the
all-0 tiles skipped by ``skip_zero_tiles``'s rule; with skip=False they
visit every tile, and the two must agree bit for bit. They are held
against the TPU kernels (``_flash_fwd``, ``_flash_bwd_pallas``,
``flash_attention_stacked``) run in interpret mode, and, more tightly,
against the port's plain versions. Inputs are made by numpy from a seed.

Tolerances (their reasons):
  - vs the TPU kernels: those of tests/test_torch_attention.py and
    tests/test_torch_attention_bwd.py. Forward: fp32 2e-5 (sums in another
    order); bf16 2e-2 on ctx and 2e-3 on colsum (a prob may round to the
    other bf16 neighbour, moving ctx by up to ~1e-2). Backward, relative to
    the largest |grad|: fp32 2e-6; bf16 4e-3 with the fp32 softmax (one ulp)
    and 1.5e-2 with the bf16 softmax (JAX rounds exp and its sum to bf16,
    torch only the result).
  - vs the plain versions (the same rounding points, fp32 sums in another
    order): fp32 2e-6 of the largest |output|; bf16 at most one bf16 ulp of
    the largest |output| and 1e-5 (ctx) or 1e-6 (grads) on average, the
    kernels' own bounds on the card.
  - saved stats vs the softmax of JAX's scores: 2e-6 relative in the fp32
    softmax; with the bf16 softmax a score may round to the other bf16
    neighbour, so the max within one bf16 ulp (2^-7 relative) and the sum
    within 2e-2 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import merlot_tpu.ops.pallas_attention as pa
from merlot_tpu_torch.ops import cuda_attention as ca

TILE = 64
PENALTY = 1e10
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODES = [("float32", True), ("bfloat16", True), ("bfloat16", False)]
SHAPES = {  # b, sq, sk, h, d, mask kind, colsum
    "ragged_masked_colsum": (2, 70, 130, 2, 16, "padded", True),
    "one_tile_unmasked": (2, 64, 64, 2, 32, "none", False),
    "short_dense_colsum": (2, 10, 37, 2, 16, "dense", True),
}


# ---------------------------------------------------------------------------
# the emulation


def _round_sm(x, sm_bf16):
    return x.to(torch.bfloat16).float() if sm_bf16 else x


def _tile(x, r0, c0, d, rows):
    """Rows [r0, r0 + 64) and columns [c0, c0 + d) of a [S, cols] tensor as
    fp32, zero past `rows`: what a TMA box of the kernels holds."""
    out = torch.zeros((TILE, d), dtype=torch.float32)
    n = max(0, min(TILE, rows - r0))
    out[:n] = x[r0:r0 + n, c0:c0 + d].float()
    return out


def _mask_tile(mask, r0, k0, sq, sk):
    """The mask at rows r0.., keys k0..; 1 (no mask) past Sq and Sk."""
    out = torch.ones((TILE, TILE), dtype=torch.float32)
    rn, kn = max(0, min(TILE, sq - r0)), max(0, min(TILE, sk - k0))
    out[:rn, :kn] = mask[r0:r0 + rn, k0:k0 + kn]
    return out


def _scores(qt, kt, m, k0, sk, scale, sm_bf16):
    """A tile's rounded, masked scores; keys at or past Sk are -inf."""
    s = _round_sm((qt @ kt.T) * scale, sm_bf16)
    if m is not None:
        s = _round_sm(s * m - PENALTY * (1 - m), sm_bf16)
    s[:, max(0, sk - k0):] = -math.inf
    return s


def _split3(x):
    """fp32 x as three bf16 terms whose sum is x exactly."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    assert torch.equal(hi + mid + lo, x), "the three-term split is not exact"
    return hi, mid, lo


def emulate_fwd(q3, k_buf, v_buf, mask, *, num_heads, softmax_fp32, collect_colsum,
                k_col0=0, v_col0=0):
    """K1's tiles over q3 [B, Sq, H*D], keys and values of head h at columns
    k_col0 + h*D and v_col0 + h*D of k_buf/v_buf [B, Sk, ld]; mask
    [B or 1, Sq, Sk] (one row of masks for the whole batch when its first
    dimension is 1). Returns (ctx, colsum or None, stats [2, B, H, Sq])."""
    b_, sq, hd = q3.shape
    sk = k_buf.shape[1]
    h_, d = num_heads, hd // num_heads
    scale = 1.0 / math.sqrt(d)
    sm_bf16 = not softmax_fp32
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    ctx = torch.zeros((b_, sq, hd), dtype=torch.float32)
    part = torch.zeros((b_, h_, n_qt, sk), dtype=torch.float32)
    stats = torch.zeros((2, b_, h_, sq), dtype=torch.float32)
    for b in range(b_):
        mb = None if mask is None else mask[b if mask.shape[0] > 1 else 0]
        for h in range(h_):
            for qt in range(n_qt):
                q0 = qt * TILE
                real = torch.arange(q0, q0 + TILE) < sq
                qtile = _tile(q3[b], q0, h * d, d, sq)

                def tile_scores(kt):
                    k0 = kt * TILE
                    m = None if mb is None else _mask_tile(mb, q0, k0, sq, sk)
                    return _scores(qtile, _tile(k_buf[b], k0, k_col0 + h * d, d, sk), m,
                                   k0, sk, scale, sm_bf16)

                # pass 1: the running row max, and the row sum of exp(s - max)
                # rescaled whenever the max grows
                mx = torch.full((TILE,), -math.inf)
                total = torch.zeros(TILE)
                for kt in range(n_kt):
                    s = tile_scores(kt)
                    new = torch.maximum(mx, s.amax(dim=1))
                    grown = new != mx
                    total = torch.where(grown, total * torch.exp(mx - new), total)
                    mx = new
                    total += torch.exp(s - mx[:, None]).sum(dim=1)
                acc = torch.zeros((TILE, d))
                for kt in range(n_kt):                         # pass 2
                    k0 = kt * TILE
                    p = _round_sm(torch.exp(tile_scores(kt) - mx[:, None]) / total[:, None],
                                  sm_bf16)
                    kn = min(TILE, sk - k0)
                    part[b, h, qt, k0:k0 + kn] = (p * real[:, None]).sum(dim=0)[:kn]
                    pv = p.to(q3.dtype).float()
                    acc += pv @ _tile(v_buf[b], k0, v_col0 + h * d, d, sk)
                rn = min(TILE, sq - q0)
                ctx[b, q0:q0 + rn, h * d:(h + 1) * d] = acc[:rn]
                stats[0, b, h, q0:q0 + rn] = mx[:rn]
                stats[1, b, h, q0:q0 + rn] = total[:rn]
    colsum = part.sum(dim=2).sum(dim=1) / h_ if collect_colsum else None
    return ctx.to(q3.dtype), colsum, stats


def _probs(s, mx, total, sm_bf16):
    """P rebuilt from the saved stats, 0 past Sk and on padded rows."""
    p = _round_sm(torch.exp(s - mx[:, None]) / total[:, None], sm_bf16)
    return torch.where(torch.isinf(s), torch.zeros_like(p), p)


def emulate_bwd(q3, k3, v3, mask, g3, gcol, stats, *, num_heads, softmax_fp32):
    """K2's two kernels from K1's saved stats: returns (dq, dk, dv) in the
    input dtype."""
    b_, sq, hd = q3.shape
    sk = k3.shape[1]
    h_, d = num_heads, hd // num_heads
    scale = 1.0 / math.sqrt(d)
    sm_bf16 = not softmax_fp32
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    dq = torch.zeros((b_, sq, hd))
    dk = torch.zeros((b_, sk, hd))
    dv = torch.zeros((b_, sk, hd))
    row_d = torch.zeros((b_, h_, sq))

    def rows_of(x, r0):  # saved stats of rows r0..: 0 / 1 past Sq
        out = x.new_zeros(TILE)
        n = max(0, min(TILE, sq - r0))
        out[:n] = x[r0:r0 + n]
        return out

    def tile_grads(b, h, q0, k0):
        """P, dS (fp32) of one (q tile, key tile), masked to real rows/keys."""
        cols = slice(h * d, (h + 1) * d)
        qt, dot = _tile(q3[b], q0, h * d, d, sq), _tile(g3[b], q0, h * d, d, sq)
        kt, vt = _tile(k3[b], k0, h * d, d, sk), _tile(v3[b], k0, h * d, d, sk)
        m = None if mask is None else _mask_tile(mask[b], q0, k0, sq, sk)
        s = _scores(qt, kt, m, k0, sk, scale, sm_bf16)
        real = (torch.arange(q0, q0 + TILE) < sq)[:, None]
        total = rows_of(stats[1, b, h], q0)
        total[total == 0] = 1.0
        p = _probs(s, rows_of(stats[0, b, h], q0), total, sm_bf16) * real
        dp = dot @ vt.T
        if gcol is not None:
            g = torch.zeros(TILE)
            kn = min(TILE, sk - k0)
            g[:kn] = gcol[b, k0:k0 + kn] / h_
            dp = dp + g[None]
        return p, dp, m, qt, dot, kt, vt, cols

    for b in range(b_):              # rows kernel: D, then dS and dQ
        for h in range(h_):
            for qt in range(n_qt):
                q0 = qt * TILE
                dd = torch.zeros(TILE)
                for kt in range(n_kt):
                    p, dp, *_ = tile_grads(b, h, q0, kt * TILE)
                    dd += (dp * p).sum(dim=1)
                rn = min(TILE, sq - q0)
                row_d[b, h, q0:q0 + rn] = dd[:rn]
                acc = torch.zeros((TILE, d))
                for kt in range(n_kt):
                    p, dp, m, _, _, ktile, _, cols = tile_grads(b, h, q0, kt * TILE)
                    ds = p * (dp - dd[:, None])
                    if m is not None:
                        ds = ds * m
                    ds = ds * scale
                    for term in _split3(ds):
                        acc += term @ ktile
                dq[b, q0:q0 + rn, cols] = acc[:rn]
    for b in range(b_):              # column kernel: dV and dK
        for h in range(h_):
            for kt in range(n_kt):
                k0 = kt * TILE
                acc_v, acc_k = torch.zeros((TILE, d)), torch.zeros((TILE, d))
                for qt in range(n_qt):
                    q0 = qt * TILE
                    p, dp, m, qtile, dot, _, _, cols = tile_grads(b, h, q0, k0)
                    ds = p * (dp - rows_of(row_d[b, h], q0)[:, None])
                    if m is not None:
                        ds = ds * m
                    ds = ds * scale
                    p_terms = (p,) if sm_bf16 else _split3(p)
                    if sm_bf16:
                        assert torch.equal(p.to(torch.bfloat16).float(), p)
                    for term in p_terms:
                        acc_v += term.T @ dot
                    for term in _split3(ds):
                        acc_k += term.T @ qtile
                kn = min(TILE, sk - k0)
                dv[b, k0:k0 + kn, cols] = acc_v[:kn]
                dk[b, k0:k0 + kn, cols] = acc_k[:kn]
    dt = q3.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# the fp32 routes (csrc/attention_fp32.cuh): fp32 FMA products, 64 x 64
# tiles, the mask's all-0 tiles skipped where that changes nothing


ZERO, ONE, MIXED = 0, 1, 2


def tile_classes(mask):
    """The class of each 64 x 64 tile of a [Bm, Sq, Sk] mask (real elements
    only): 0 all 0, 1 all 1, 2 anything else; [Bm, n_qt, n_kt] uint8."""
    bm, sq, sk = mask.shape
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    out = torch.empty((bm, n_qt, n_kt), dtype=torch.uint8)
    for b in range(bm):
        for qt in range(n_qt):
            for kt in range(n_kt):
                t = mask[b, qt * TILE:(qt + 1) * TILE, kt * TILE:(kt + 1) * TILE]
                out[b, qt, kt] = ZERO if bool((t == 0).all()) else ONE if bool((t == 1).all()) \
                    else MIXED
    return out


def zero_tile_prob(mx, total):
    """p at a key of an all-0 tile (score exactly -1e10) for each row."""
    return torch.exp(-PENALTY - mx) / total


def skip_zero_tiles(cls_row, mx, total, real):
    """The skip rule of a q tile: its all-0 tiles may be left out when p0
    is exactly 0 on every real row (each has a key scored above -1e10)."""
    return bool((cls_row == ZERO).any()) and not bool(
        (zero_tile_prob(mx, total)[real] != 0).any())


def emulate_fwd_f32(q3, k_buf, v_buf, mask, *, num_heads, collect_colsum, k_col0=0,
                    v_col0=0, skip=True):
    """The fp32 K1: per (64-row q tile, head, batch element) pass 1 (row max
    and rescaled sum; an all-0 tile's real keys enter as -1e10 without a
    product), then pass 2 (p from the stats, its column sums, ctx += p . V)
    over the tiles that are not all 0, or over every tile in order when
    some real row has p0 != 0. skip=False visits every tile in both passes
    (the function the skipping must not change). Returns (ctx, colsum,
    stats [2, B, H, Sq], tile classes)."""
    b_, sq, hd = q3.shape
    sk = k_buf.shape[1]
    h_, d = num_heads, hd // num_heads
    scale = 1.0 / math.sqrt(d)
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    cls = None if mask is None else tile_classes(mask)
    ctx = torch.zeros((b_, sq, hd))
    part = torch.zeros((b_, h_, n_qt, sk))
    stats = torch.zeros((2, b_, h_, sq))
    for b in range(b_):
        mb = None if mask is None else mask[b if mask.shape[0] > 1 else 0]
        for h in range(h_):
            for qt in range(n_qt):
                q0 = qt * TILE
                real = torch.arange(q0, q0 + TILE) < sq
                qtile = _tile(q3[b], q0, h * d, d, sq)
                crow = (torch.full((n_kt,), ONE, dtype=torch.uint8) if cls is None
                        else cls[b if cls.shape[0] > 1 else 0, qt])

                def tile_scores(kt):
                    k0 = kt * TILE
                    m = None if mb is None or crow[kt] == ONE else _mask_tile(mb, q0, k0, sq, sk)
                    return _scores(qtile, _tile(k_buf[b], k0, k_col0 + h * d, d, sk), m,
                                   k0, sk, scale, False)

                zero = [kt for kt in range(n_kt) if skip and crow[kt] == ZERO]
                n0 = sum(min(TILE, sk - kt * TILE) for kt in zero)
                mx = torch.full((TILE,), -PENALTY if n0 else -math.inf)
                total = torch.full((TILE,), float(n0))
                for kt in range(n_kt):                         # pass 1
                    if kt in zero:
                        continue
                    s = tile_scores(kt)
                    new = torch.maximum(mx, s.amax(dim=1))
                    grown = new != mx
                    total = torch.where(grown, total * torch.exp(mx - new), total)
                    mx = new
                    total += torch.exp(s - mx[:, None]).sum(dim=1)
                if skip_zero_tiles(crow, mx, total, real) if skip else False:
                    visit = [kt for kt in range(n_kt) if crow[kt] != ZERO]
                else:
                    visit = range(n_kt)
                acc = torch.zeros((TILE, d))
                for kt in visit:                                 # pass 2
                    k0 = kt * TILE
                    p = torch.exp(tile_scores(kt) - mx[:, None]) / total[:, None]
                    p = torch.where(real[:, None], p, torch.zeros_like(p))
                    kn = min(TILE, sk - k0)
                    part[b, h, qt, k0:k0 + kn] = p.sum(dim=0)[:kn]
                    acc += p @ _tile(v_buf[b], k0, v_col0 + h * d, d, sk)
                rn = min(TILE, sq - q0)
                ctx[b, q0:q0 + rn, h * d:(h + 1) * d] = acc[:rn]
                stats[0, b, h, q0:q0 + rn] = mx[:rn]
                stats[1, b, h, q0:q0 + rn] = total[:rn]
    colsum = part.sum(dim=2).sum(dim=1) / h_ if collect_colsum else None
    return ctx, colsum, stats, cls


def emulate_bwd_f32(q3, k3, v3, mask, g3, gcol, stats, cls, *, num_heads, skip=True):
    """The fp32 K2 from K1's saved stats and tile classes: the rows kernel
    (pass 1 D over the tiles not all 0, every tile when a real row has p0
    != 0; pass 2 dS and dQ over the tiles not all 0) and the column kernel
    (per key tile, the q tiles whose tile is not all 0 or whose rows have
    p0 != 0: dV += P^T . dO, dK += dS^T . Q). skip=False visits every tile.
    Returns (dq, dk, dv)."""
    b_, sq, hd = q3.shape
    sk = k3.shape[1]
    h_, d = num_heads, hd // num_heads
    scale = 1.0 / math.sqrt(d)
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    dq, dk, dv = torch.zeros((b_, sq, hd)), torch.zeros((b_, sk, hd)), torch.zeros((b_, sk, hd))
    row_d = torch.zeros((b_, h_, sq))

    def rows_of(x, r0, fill):
        out = torch.full((TILE,), fill)
        n = max(0, min(TILE, sq - r0))
        out[:n] = x[r0:r0 + n]
        return out

    def klass(b, qt, kt):
        return ONE if cls is None else int(cls[b, qt, kt])

    def p0_nonzero(b, h, qt):
        q0 = qt * TILE
        real = torch.arange(q0, q0 + TILE) < sq
        p0 = zero_tile_prob(rows_of(stats[0, b, h], q0, 0.0), rows_of(stats[1, b, h], q0, 1.0))
        return bool((p0[real] != 0).any())

    def tile_grads(b, h, q0, k0, c):
        cols = slice(h * d, (h + 1) * d)
        qt_, dot = _tile(q3[b], q0, h * d, d, sq), _tile(g3[b], q0, h * d, d, sq)
        kt_, vt = _tile(k3[b], k0, h * d, d, sk), _tile(v3[b], k0, h * d, d, sk)
        m = None if mask is None or c == ONE else _mask_tile(mask[b], q0, k0, sq, sk)
        s = _scores(qt_, kt_, m, k0, sk, scale, False)
        real = (torch.arange(q0, q0 + TILE) < sq)[:, None]
        p = _probs(s, rows_of(stats[0, b, h], q0, 0.0), rows_of(stats[1, b, h], q0, 1.0),
                   False) * real
        dp = dot @ vt.T
        if gcol is not None:
            g = torch.zeros(TILE)
            kn = min(TILE, sk - k0)
            g[:kn] = gcol[b, k0:k0 + kn] / h_
            dp = dp + g[None]
        return p, dp, m, qt_, dot, kt_, cols

    for b in range(b_):              # rows kernel
        for h in range(h_):
            for qt in range(n_qt):
                q0 = qt * TILE
                nz = p0_nonzero(b, h, qt)
                pass1 = [kt for kt in range(n_kt)
                         if not skip or nz or klass(b, qt, kt) != ZERO]
                pass2 = [kt for kt in range(n_kt) if not skip or klass(b, qt, kt) != ZERO]
                dd = torch.zeros(TILE)
                for kt in pass1:
                    p, dp, *_ = tile_grads(b, h, q0, kt * TILE, klass(b, qt, kt))
                    dd += (dp * p).sum(dim=1)
                rn = min(TILE, sq - q0)
                row_d[b, h, q0:q0 + rn] = dd[:rn]
                acc = torch.zeros((TILE, d))
                for kt in pass2:
                    p, dp, m, _, _, ktile, cols = tile_grads(b, h, q0, kt * TILE,
                                                             klass(b, qt, kt))
                    ds = p * (dp - dd[:, None])
                    if m is not None:
                        ds = ds * m
                    acc += (ds * scale) @ ktile
                dq[b, q0:q0 + rn, cols] = acc[:rn]
    for b in range(b_):              # column kernel
        for h in range(h_):
            nz = [p0_nonzero(b, h, qt) for qt in range(n_qt)]
            for kt in range(n_kt):
                k0 = kt * TILE
                acc_v, acc_k = torch.zeros((TILE, d)), torch.zeros((TILE, d))
                for qt in range(n_qt):
                    if skip and klass(b, qt, kt) == ZERO and not nz[qt]:
                        continue
                    q0 = qt * TILE
                    p, dp, m, qtile, dot, _, cols = tile_grads(b, h, q0, k0, klass(b, qt, kt))
                    ds = p * (dp - rows_of(row_d[b, h], q0, 0.0)[:, None])
                    if m is not None:
                        ds = ds * m
                    acc_v += p.T @ dot
                    acc_k += (ds * scale).T @ qtile
                kn = min(TILE, sk - k0)
                dv[b, k0:k0 + kn, cols] = acc_v[:kn]
                dk[b, k0:k0 + kn, cols] = acc_k[:kn]
    return dq, dk, dv


# ---------------------------------------------------------------------------
# inputs and checks


def _inputs(seed, b, sq, sk, h, d, mask_kind, colsum):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h * d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h * d)).astype(np.float32) for _ in range(2))
    g = (0.1 * rng.standard_normal((b, sq, h * d))).astype(np.float32)
    mask = None
    if mask_kind == "padded":        # padded rows and keys: fully masked rows
        valid = np.ones((b, max(sq, sk)), bool)
        valid[0, sq - 7:] = False
        valid[1, 3] = False
        mask = (valid[:, :sq, None] & valid[:, None, :sk]).astype(np.float32)
    elif mask_kind == "dense":
        mask = (rng.random((b, sq, sk)) < 0.7).astype(np.float32)
        mask[:, :, 0] = 1.0
        mask[0, 3] = 0.0
    gc = rng.standard_normal((b, sk)).astype(np.float32) if colsum else None
    return q, k, v, mask, g, gc


def _torch(arrays, dt):
    return [None if a is None else torch.from_numpy(a).to(dt) for a in arrays]


def _ulp_close(got, want, mean_tol, name):
    """At most one bf16 ulp of the largest |want|, and mean_tol on average."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    diff = (got - want).abs()
    assert diff.max().item() <= ulp, f"{name}: max err {diff.max().item():.3g} > {ulp:.3g}"
    assert diff.mean().item() <= mean_tol, f"{name}: mean err {diff.mean().item():.3g}"


def _rel_close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)
    assert err <= tol, f"{name}: max err {err:.3g} of the largest |value| > {tol}"


def _fwd_case(dtype, softmax_fp32, shape, seed=0):
    b, sq, sk, h, d, mask_kind, colsum = SHAPES[shape]
    q, k, v, mask, g, gc = _inputs(seed, b, sq, sk, h, d, mask_kind, colsum)
    tq, tk, tv, tm = _torch((q, k, v), TORCH_DT[dtype]) + _torch((mask,), torch.float32)
    got = emulate_fwd(tq, tk, tv, tm, num_heads=h, softmax_fp32=softmax_fp32,
                      collect_colsum=colsum)
    return (q, k, v, mask, h, colsum), (tq, tk, tv, tm), got


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_tiles_match_pallas_interpret(dtype, softmax_fp32, shape):
    (q, k, v, mask, h, colsum), _, (ctx, cs, _) = _fwd_case(dtype, softmax_fp32, shape)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        j_ctx, j_cs, _ = pa._flash_fwd(
            *(jnp.asarray(a, jdt) for a in (q, k, v)),
            None if mask is None else jnp.asarray(mask), num_heads=h,
            softmax_fp32=softmax_fp32, collect_colsum=colsum)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ctx.float().numpy(), np.asarray(j_ctx, np.float32),
                               atol=tol, rtol=tol)
    if colsum:
        tol = 2e-5 if dtype == "float32" else 2e-3
        np.testing.assert_allclose(cs.numpy(), np.asarray(j_cs), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_tiles_match_plain(dtype, softmax_fp32, shape):
    (_, _, _, _, h, colsum), (tq, tk, tv, tm), (ctx, cs, stats) = _fwd_case(
        dtype, softmax_fp32, shape)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32)
    ref, ref_cs = ca.flash_attention_plain(tq, tk, tv, tm, collect_colsum=colsum, **kw)
    ref_stats = ca.softmax_stats_plain(tq, tk, tm, **kw)
    if dtype == "float32":
        _rel_close(ctx, ref, 2e-6, "ctx")
    else:
        _ulp_close(ctx, ref, 1e-5, "ctx")
    if colsum:
        torch.testing.assert_close(cs, ref_cs, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats[0], ref_stats[0], atol=0, rtol=2e-6)
    torch.testing.assert_close(stats[1], ref_stats[1], atol=0, rtol=2e-6)


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", ["ragged_masked_colsum", "short_dense_colsum"])
def test_saved_stats_match_jax_softmax(dtype, softmax_fp32, shape):
    """The row max and sum that K1 saves (the emulation's and the plain
    version's) against those of the scores JAX's attention softmaxes."""
    (q, k, v, mask, h, _), (tq, tk, _, tm), (_, _, stats) = _fwd_case(
        dtype, softmax_fp32, shape)
    b, sq, hd = q.shape
    d = hd // h
    jdt = jnp.dtype(dtype)
    sm_dt = jnp.float32 if softmax_fp32 else jdt
    s = jnp.einsum("bqhd,bkhd->bhqk",
                   *(jnp.asarray(a, jdt).astype(jnp.float32).reshape(b, -1, h, d)
                     for a in (q, k))) * (1.0 / math.sqrt(d))
    s = s.astype(sm_dt)
    if mask is not None:
        m = jnp.asarray(mask).astype(sm_dt)[:, None]
        s = s * m - jnp.asarray(PENALTY, sm_dt) * (1 - m)
    s = s.astype(jnp.float32)
    j_max = s.max(axis=-1)
    j_sum = jnp.exp(s - j_max[..., None]).sum(axis=-1)
    plain = ca.softmax_stats_plain(tq, tk, tm, num_heads=h, softmax_fp32=softmax_fp32)
    max_tol, sum_tol = (2e-6, 2e-6) if softmax_fp32 else (2.0 ** -7, 2e-2)
    for got in (stats, plain):
        _rel_close(got[0], j_max, max_tol, "row max")
        np.testing.assert_allclose(got[1].numpy(), np.asarray(j_sum), rtol=sum_tol)


def _bwd_case(dtype, softmax_fp32, shape, seed=1):
    b, sq, sk, h, d, mask_kind, colsum = SHAPES[shape]
    q, k, v, mask, g, gc = _inputs(seed, b, sq, sk, h, d, mask_kind, colsum)
    tdt = TORCH_DT[dtype]
    tq, tk, tv, tg = _torch((q, k, v, g), tdt)
    tm, tgc = _torch((mask, gc), torch.float32)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32)
    _, _, stats = emulate_fwd(tq, tk, tv, tm, collect_colsum=False, **kw)
    got = emulate_bwd(tq, tk, tv, tm, tg, tgc, stats, **kw)
    return (q, k, v, mask, g, gc, h), (tq, tk, tv, tm, tg, tgc), got


BWD_TOL = {("float32", True): 2e-6, ("bfloat16", True): 4e-3, ("bfloat16", False): 1.5e-2}


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_tiles_match_pallas_interpret(dtype, softmax_fp32, shape):
    (q, k, v, mask, g, gc, h), _, got = _bwd_case(dtype, softmax_fp32, shape)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = pa._flash_bwd_pallas(
            *(jnp.asarray(a, jdt) for a in (q, k, v)),
            None if mask is None else jnp.asarray(mask), jnp.asarray(g, jdt),
            None if gc is None else jnp.asarray(gc), num_heads=h,
            softmax_fp32=softmax_fp32, use_gcol=gc is not None)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _rel_close(a.float().numpy(), w, BWD_TOL[(dtype, softmax_fp32)], name)


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_backward_tiles_match_plain(dtype, softmax_fp32, shape):
    (_, _, _, mask, _, _, h), (tq, tk, tv, tm, tg, tgc), got = _bwd_case(
        dtype, softmax_fp32, shape)
    ref = ca.attention_bwd_plain(tq, tk, tv, tm, tg, tgc, num_heads=h,
                                 softmax_fp32=softmax_fp32)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == r.dtype
        if dtype == "float32":
            _rel_close(a, r, 2e-6, name)
        else:
            _ulp_close(a, r, 1e-6, name)
    if shape == "ragged_masked_colsum":       # fully masked rows: dQ exactly 0
        assert not got[0][0, -7:].any() and not got[0][1, 3].any()


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
def test_stacked_prefill_tiles(dtype, softmax_fp32):
    """K3's prefill strides: K1's tiles over one [B, Sk, 2*H*D] cache, keys
    at column 0 and values at column H*D of the same rows, and one causal
    mask [1, Sq, Sk] for the batch (cache rows past the last query zero)."""
    b, sq, sk, h, d = 2, 70, 100, 2, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, sq, h * d)).astype(np.float32)
    kv = rng.standard_normal((b, sk, 2 * h * d)).astype(np.float32)
    pos0 = 20
    kv[:, pos0 + sq:] = 0.0
    mask = (np.arange(sk)[None] <= pos0 + np.arange(sq)[:, None]).astype(np.float32)[None]
    tdt = TORCH_DT[dtype]
    tq, tkv = _torch((q, kv), tdt)
    tm = torch.from_numpy(mask)
    ctx, _, _ = emulate_fwd(tq, tkv, tkv, tm, num_heads=h, softmax_fp32=softmax_fp32,
                            collect_colsum=False, k_col0=0, v_col0=h * d)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        j_ctx = pa.flash_attention_stacked(
            jnp.asarray(q, jdt).reshape(b, sq, h, d), jnp.asarray(kv, jdt),
            jnp.asarray(np.broadcast_to(mask, (b, sq, sk)).copy()),
            softmax_fp32=softmax_fp32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ctx.float().numpy().reshape(b, sq, h, d),
                               np.asarray(j_ctx, np.float32), atol=tol, rtol=tol)
    ref = ca.flash_attention_stacked_plain(tq, tkv, tm, num_heads=h,
                                           softmax_fp32=softmax_fp32)
    if dtype == "float32":
        _rel_close(ctx, ref, 2e-6, "ctx")
    else:
        _ulp_close(ctx, ref, 1e-5, "ctx")


def test_split3_is_exact_on_scaled_gradients():
    """dS = P (dP - D) m scale spans many binades; its three bf16 terms
    hold it exactly (the kernels' claim that the dQ/dK products run on fp32
    operands)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(4096) *
                          np.exp2(rng.integers(-60, 10, 4096))).astype(np.float32))
    hi, mid, lo = _split3(x)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)


# ---------------------------------------------------------------------------
# the fp32 routes: B 2, S 200 (ragged against 64), 2 heads, D 64 and 40,
# four masks with all-0 tiles, the colsum and its cotangent on

F32_B, F32_S, F32_H = 2, 200, 2
F32_D = [64, 40]
F32_MASKS = ["causal", "padded", "block_sparse", "non_binary"]


def _f32_mask(kind, rng):
    """[B, S, S]: causal; padded rows and keys (fully masked rows); 64 x 64
    blocks kept on the diagonal and at random (all-0 tiles beside rows that
    attend); those blocks times uniform values (not 0 or 1)."""
    b, s = F32_B, F32_S
    if kind == "causal":
        return np.broadcast_to(np.tril(np.ones((s, s), np.float32)), (b, s, s)).copy()
    if kind == "padded":
        valid = np.ones((b, s), bool)
        valid[0, s - 70:] = False
        valid[1, 5] = False
        return (valid[:, :, None] & valid[:, None, :]).astype(np.float32)
    nb = -(-s // TILE)
    keep = np.eye(nb, dtype=bool)[None] | (rng.random((b, nb, nb)) < 0.4)
    keep[:, 0, nb - 1] = False                   # an all-0 tile off the diagonal
    m = np.repeat(np.repeat(keep, TILE, 1), TILE, 2)[:, :s, :s].astype(np.float32)
    if kind == "non_binary":
        m *= rng.uniform(0.05, 1.0, m.shape).astype(np.float32)
    return m


def _f32_case(kind, d, seed=8):
    rng = np.random.default_rng(seed)
    b, s, h = F32_B, F32_S, F32_H
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    g = (0.1 * rng.standard_normal((b, s, h * d))).astype(np.float32)
    gc = rng.standard_normal((b, s)).astype(np.float32)
    mask = _f32_mask(kind, rng)
    return (q, k, v, mask, g, gc), [torch.from_numpy(a) for a in (q, k, v, mask, g, gc)]


def _f32_run(tensors, skip=True):
    tq, tk, tv, tm, tg, tgc = tensors
    ctx, cs, stats, cls = emulate_fwd_f32(tq, tk, tv, tm, num_heads=F32_H,
                                          collect_colsum=True, skip=skip)
    grads = emulate_bwd_f32(tq, tk, tv, tm, tg, tgc, stats, cls, num_heads=F32_H, skip=skip)
    return ctx, cs, stats, cls, grads


@pytest.mark.parametrize("kind", F32_MASKS)
@pytest.mark.parametrize("d", F32_D)
def test_fp32_tiles_match_pallas_interpret(kind, d):
    arrays, tensors = _f32_case(kind, d)
    q, k, v, mask, g, gc = arrays
    ctx, cs, _, _, grads = _f32_run(tensors)
    with pltpu.force_tpu_interpret_mode():
        j_ctx, j_cs, _ = pa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
                                       num_heads=F32_H, softmax_fp32=True, collect_colsum=True)
        want = pa._flash_bwd_pallas(*(jnp.asarray(a) for a in (q, k, v, mask, g, gc)),
                                    num_heads=F32_H, softmax_fp32=True, use_gcol=True)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(j_ctx), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(j_cs), atol=2e-5, rtol=2e-5)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        _rel_close(a.numpy(), w, BWD_TOL[("float32", True)], name)


@pytest.mark.parametrize("kind", F32_MASKS)
@pytest.mark.parametrize("d", F32_D)
def test_fp32_tiles_match_plain(kind, d):
    _, tensors = _f32_case(kind, d)
    tq, tk, tv, tm, tg, tgc = tensors
    ctx, cs, stats, _, grads = _f32_run(tensors)
    kw = dict(num_heads=F32_H, softmax_fp32=True)
    ref, ref_cs = ca.flash_attention_plain(tq, tk, tv, tm, collect_colsum=True, **kw)
    _rel_close(ctx, ref, 2e-6, "ctx")
    torch.testing.assert_close(cs, ref_cs, atol=1e-5, rtol=1e-5)
    ref_stats = ca.softmax_stats_plain(tq, tk, tm, **kw)
    torch.testing.assert_close(stats[0], ref_stats[0], atol=0, rtol=2e-6)
    torch.testing.assert_close(stats[1], ref_stats[1], atol=0, rtol=2e-6)
    for name, a, r in zip(("dq", "dk", "dv"), grads,
                          ca.attention_bwd_plain(tq, tk, tv, tm, tg, tgc, **kw)):
        _rel_close(a, r, 2e-6, name)
    dead = tm.amax(dim=-1) == 0                  # fully masked rows: dQ exactly 0
    assert not grads[0][dead].any()


@pytest.mark.parametrize("kind", F32_MASKS)
def test_fp32_tile_classes_and_skip_rule(kind):
    """The tile classes against the mask read tile by tile in numpy, and
    the skip rule: ctx, colsum, dQ, dK and dV with the all-0 tiles skipped
    equal them with every tile visited, bit for bit. The causal and
    block-sparse masks skip tiles; a q tile with a fully masked row skips
    none (its p0 = 1/Sk is not 0)."""
    arrays, tensors = _f32_case(kind, 64)
    mask = arrays[3]
    skipped = _f32_run(tensors, skip=True)
    full = _f32_run(tensors, skip=False)
    cls = skipped[3]
    n = -(-F32_S // TILE)
    for b in range(F32_B):
        for qt in range(n):
            for kt in range(n):
                t = mask[b, qt * TILE:(qt + 1) * TILE, kt * TILE:(kt + 1) * TILE]
                want = ZERO if (t == 0).all() else ONE if (t == 1).all() else MIXED
                assert cls[b, qt, kt] == want, (b, qt, kt)
    for name, a, w in zip(("ctx", "colsum", "dq", "dk", "dv"),
                          skipped[:2] + skipped[4], full[:2] + full[4]):
        assert torch.equal(a, w), name
    stats = skipped[2]

    def rule(b, qt):                             # head 0's q tile qt
        rows = slice(qt * TILE, (qt + 1) * TILE)
        n_real = len(range(F32_S)[rows])
        pad = lambda x, fill: torch.cat([x, torch.full((TILE - n_real,), fill)])
        return skip_zero_tiles(cls[b, qt], pad(stats[0, b, 0, rows], 0.0),
                               pad(stats[1, b, 0, rows], 1.0), torch.arange(TILE) < n_real)

    rule = [rule(b, qt) for b in range(F32_B) for qt in range(n)]
    if kind in ("causal", "block_sparse"):
        assert any(rule)
    if kind == "padded":                         # batch 0's last q tiles: fully masked rows
        assert not rule[n - 1] and not rule[n - 2]
