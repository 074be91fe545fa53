"""K3's decode kernel (csrc/attention_stacked.cu, Sq <= 8) on the CPU.

The kernel runs one thread-block cluster of C blocks per (batch element,
head); block r takes the keys [r*n, min((r+1)*n, kv_len)), n = ceil(kv_len
/ C) rounded up to 8. Each block rounds and masks its scores, finds its row
max m_r and its sum of exp(s - m_r); across the cluster M = max m_r and the
sum is the ranks' sums rescaled by exp(m_r - M), added in rank order; p =
round_sm(exp(s - M) / sum) is rounded to the input dtype for the value
product, each block sums its keys' p . v in fp32, and the ranks' partial
contexts are added in rank order and stored in the input dtype.

``emulate_decode`` replays that block by block in plain PyTorch (fp32 sums
in torch's order, not the card's). It is held against the TPU kernel
``flash_attention_stacked`` in Pallas interpret mode and against the port's
plain version. The launch plan (``cuda_attention.decode_plan``) is checked
at every shape of the serving path. Inputs are made by numpy from a seed.

Tolerances (their reasons):
  - vs the plain version (the same rounding points, fp32 sums in another
    order), those of the kernel's cases in tests/test_torch_cuda_kernel.py:
    fp32 1e-5; bf16 one bf16 ulp of the largest |ctx| and 1e-5 on average.
  - vs the TPU kernel: fp32 1e-5; bf16 with the fp32 softmax, one bf16 ulp
    of the largest |ctx| and 1e-5 on average; bf16 with the bf16 softmax,
    2e-2 (JAX's softmax rounds its exps and their sum to bf16, the port only
    the scores and the result; the bound of
    tests/test_torch_attention_tiles.py).
  - the plain version with kv_len against the plain version over the whole
    cache: fp32 within 4 fp32 ulps of the largest |ctx| (torch's CPU sums
    over the live slots and over the whole cache are not taken in the same
    order, so the last bits may differ); bf16 as vs the plain version.
"""

import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import merlot_tpu.ops.pallas_attention as pa
from merlot_tpu_torch.ops import cuda_attention as ca

PENALTY = 1e10
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODES = [("float32", True), ("bfloat16", True), ("bfloat16", False)]
B, SK, H, D, KV_LEN = 2, 300, 2, 32, 213


# ---------------------------------------------------------------------------
# the emulation


def _round_sm(x, sm_bf16):
    return x.to(torch.bfloat16).float() if sm_bf16 else x


def decode_ranges(kv_len, cluster):
    """[start, end) of the keys of each rank, as the kernel splits them
    (empty ranges at the end where kv_len is short)."""
    n = ca.decode_chunk_rows(kv_len, cluster)
    return [(min(r * n, kv_len), min((r + 1) * n, kv_len)) for r in range(cluster)]


def emulate_decode(q3, kv3, mask, *, num_heads, softmax_fp32, kv_len, cluster):
    """K3's decode cluster over q3 [B, Sq, H*D] and the stacked cache kv3
    [B, Sk, 2*H*D] (keys in columns [:H*D], values in [H*D:]); mask
    [B or 1, Sq, Sk]. Reads only the slots below kv_len."""
    b_, sq, hd = q3.shape
    d = hd // num_heads
    scale = 1.0 / math.sqrt(d)
    sm_bf16 = not softmax_fp32
    ctx = torch.zeros((b_, sq, hd), dtype=torch.float32)
    for b in range(b_):
        mb = mask[b if mask.shape[0] > 1 else 0].float()
        for h in range(num_heads):
            q = q3[b, :, h * d:(h + 1) * d].float()
            blocks = []
            for k0, k1 in decode_ranges(kv_len, cluster):
                k = kv3[b, k0:k1, h * d:(h + 1) * d].float()
                v = kv3[b, k0:k1, hd + h * d:hd + (h + 1) * d].float()
                s = _round_sm((q @ k.T) * scale, sm_bf16)
                m = mb[:, k0:k1]
                s = _round_sm(s * m - PENALTY * (1 - m), sm_bf16)
                if k1 > k0:
                    mx = s.amax(dim=1)
                    total = torch.exp(s - mx[:, None]).sum(dim=1)
                else:                       # an empty block: max -inf, sum 0
                    mx, total = torch.full((sq,), -math.inf), torch.zeros(sq)
                blocks.append((s, v, mx, total))
            # the cluster's stats: the ranks' maxima, their sums rescaled and
            # added in rank order
            big = torch.stack([blk[2] for blk in blocks]).amax(dim=0)
            total = torch.zeros(sq)
            for _, _, mx, t in blocks:
                total = total + t * torch.exp(mx - big)
            acc = torch.zeros((sq, d))
            for s, v, _, _ in blocks:       # the ranks' partials in rank order
                p = _round_sm(torch.exp(s - big[:, None]) / total[:, None], sm_bf16)
                acc = acc + p.to(q3.dtype).float() @ v
            ctx[b, :, h * d:(h + 1) * d] = acc
    return ctx.to(q3.dtype)


# ---------------------------------------------------------------------------
# inputs, the TPU kernel, tolerances


@lru_cache(maxsize=None)
def _case(sq, dtype, softmax_fp32):
    """numpy inputs (the cache zero past kv_len, the causal mask over cache
    positions with the last query at kv_len - 1) and the TPU kernel's ctx
    over the whole cache, in interpret mode."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((B, sq, H * D)).astype(np.float32)
    kv = rng.standard_normal((B, SK, 2 * H * D)).astype(np.float32)
    kv[:, KV_LEN:] = 0.0
    pos0 = KV_LEN - sq
    mask = (np.arange(SK)[None] <= pos0 + np.arange(sq)[:, None]).astype(np.float32)[None]
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        j_ctx = pa.flash_attention_stacked(
            jnp.asarray(q, jdt).reshape(B, sq, H, D), jnp.asarray(kv, jdt),
            jnp.asarray(np.broadcast_to(mask, (B, sq, SK)).copy()),
            softmax_fp32=softmax_fp32)
    return q, kv, mask, np.array(j_ctx, np.float32).reshape(B, sq, H * D)


def _torch_case(sq, dtype, softmax_fp32):
    q, kv, mask, j_ctx = _case(sq, dtype, softmax_fp32)
    tdt = TORCH_DT[dtype]
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(kv).to(tdt),
            torch.from_numpy(mask), torch.from_numpy(j_ctx))


def _ulp_close(got, want, name):
    """At most one bf16 ulp of the largest |want|, and 1e-5 on average."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    diff = (got - want).abs()
    assert diff.max().item() <= ulp, f"{name}: max err {diff.max().item():.3g} > {ulp:.3g}"
    assert diff.mean().item() <= 1e-5, f"{name}: mean err {diff.mean().item():.3g}"


def _kernel_close(got, want, name):
    """The bounds of the kernel's K3 cases."""
    if want.dtype == torch.float32 and got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _ulp_close(got, want, name)


# ---------------------------------------------------------------------------
# (a) the launch plan at every shape of the serving path


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("sk", [1056, 1216, 1537, 2048])
@pytest.mark.parametrize("b", [1, 8])
def test_decode_plan_at_path_shapes(b, sk, elem):
    plan = ca.decode_plan(b, 16, 1, sk, 64, elem)
    c = plan["cluster"]
    assert c in (1, 2, 4, 8, 16) and plan["blocks"] == b * 16 * c
    assert plan["blocks"] >= ca.SM_COUNT            # a block for every SM
    assert plan["smem_bytes"] <= ca.MAX_SMEM
    assert ca.decode_smem_bytes(8, sk, 64, elem, c) <= ca.MAX_SMEM   # Sq = 8 fits too
    stages = plan["stages"]
    assert stages % ca.DECODE_WARPS == 0
    assert stages * ca.DECODE_STAGE_ROWS * 64 * elem <= ca.DECODE_RING_BYTES
    chunk = ca.decode_chunk_rows(sk, c)
    odd = min(sk, 8 * c * 3 + 5)                    # not a multiple of the chunk
    for kv_len in sorted({1, 7, max(1, c - 1), odd, sk}):
        ranges = decode_ranges(kv_len, c)
        assert len(ranges) == c
        covered = []
        for start, end in ranges:
            assert start % ca.DECODE_BOX_ROWS == 0 or start == kv_len
            assert 0 <= end - start <= chunk       # the score rows hold it
            covered.extend(range(start, end))
        assert covered == list(range(kv_len))       # [0, kv_len) exactly once
    assert ca.decode_plan(b, 16, 1, sk, 64, elem) == ca._decode_plan(b, 16, 1, sk, 64, elem)


def test_decode_plan_does_not_depend_on_the_live_length():
    """The grid and shared memory come from (B, H, Sq, Sk, D) alone: a
    decode step at any position reuses one launch."""
    assert "kv_len" not in ca.decode_plan.__code__.co_varnames
    plan = ca.decode_plan(8, 16, 1, 1537, 64, 2)
    assert plan["cluster"] == 2 and plan["stages"] == 8


# ---------------------------------------------------------------------------
# (b) the cluster algorithm against the TPU kernel and the plain version


@pytest.mark.parametrize("cluster", ["plan", 2])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
def test_decode_cluster_matches_pallas_and_plain(dtype, softmax_fp32, sq, cluster):
    tq, tkv, tm, j_ctx = _torch_case(sq, dtype, softmax_fp32)
    c = (ca.decode_plan(B, H, sq, SK, D, tq.element_size())["cluster"]
         if cluster == "plan" else cluster)
    got = emulate_decode(tq, tkv, tm, num_heads=H, softmax_fp32=softmax_fp32,
                         kv_len=KV_LEN, cluster=c)
    assert got.dtype == tq.dtype and bool(torch.isfinite(got).all())
    if dtype == "float32" or softmax_fp32:
        _kernel_close(got.float(), j_ctx, "vs Pallas")
    else:
        np.testing.assert_allclose(got.float().numpy(), j_ctx.numpy(), atol=2e-2, rtol=2e-2)
    ref = ca.flash_attention_stacked_plain(tq, tkv, tm, num_heads=H,
                                           softmax_fp32=softmax_fp32, kv_len=KV_LEN)
    _kernel_close(got, ref, "vs plain")


def test_decode_emulation_sees_a_short_live_length():
    """The check above can tell a cluster that drops the last live key."""
    tq, tkv, tm, _ = _torch_case(1, "bfloat16", True)
    kw = dict(num_heads=H, softmax_fp32=True)
    ref = ca.flash_attention_stacked_plain(tq, tkv, tm, kv_len=KV_LEN, **kw)
    short = emulate_decode(tq, tkv, tm, kv_len=KV_LEN - 1, cluster=2, **kw)
    with pytest.raises(AssertionError):
        _kernel_close(short, ref, "short")


# ---------------------------------------------------------------------------
# (c) the plain version's live length, (d) nothing read past it


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kv_len_matches_whole_cache(dtype, sq):
    tq, tkv, tm, j_ctx = _torch_case(sq, dtype, True)
    kw = dict(num_heads=H, softmax_fp32=True)
    live = ca.flash_attention_stacked_plain(tq, tkv, tm, kv_len=KV_LEN, **kw)
    whole = ca.flash_attention_stacked_plain(tq, tkv, tm, **kw)
    if dtype == "float32":
        tol = 4 * torch.finfo(torch.float32).eps * whole.abs().max().item()
        torch.testing.assert_close(live, whole, atol=tol, rtol=0)
    else:
        _ulp_close(live, whole, "live vs whole")
    _kernel_close(live.float(), j_ctx, "vs Pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kv_len_ignores_what_lies_past_it(dtype):
    tq, tkv, tm, _ = _torch_case(1, dtype, True)
    kw = dict(num_heads=H, softmax_fp32=True, kv_len=KV_LEN)
    clean = ca.flash_attention_stacked_plain(tq, tkv, tm, **kw)
    dirty = tkv.clone()
    dirty[:, KV_LEN:] = float("nan")
    got = ca.flash_attention_stacked_plain(tq, dirty, tm, **kw)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, clean)
    # the CPU path of the entry point the model calls, and the emulation
    q4 = tq.reshape(B, 1, H, D)
    got4 = ca.flash_attention_stacked(q4, dirty, tm, softmax_fp32=True, kv_len=KV_LEN)
    assert torch.equal(got4.reshape(B, 1, H * D), clean)
    emu = emulate_decode(tq, dirty, tm, cluster=2, **kw)
    assert torch.equal(emu, emulate_decode(tq, tkv, tm, cluster=2, **kw))
    # without kv_len the dead slots join the product and poison it
    assert not bool(torch.isfinite(ca.flash_attention_stacked_plain(
        tq, dirty, tm, num_heads=H, softmax_fp32=True)).all())


def test_kv_len_out_of_range_is_refused():
    tq, tkv, tm, _ = _torch_case(1, "float32", True)
    for bad in (0, -3, SK + 1):
        with pytest.raises(ValueError, match="kv_len"):
            ca.flash_attention_stacked_plain(tq, tkv, tm, num_heads=H, softmax_fp32=True,
                                             kv_len=bad)
