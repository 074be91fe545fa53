"""The hand-written kernels (attention: K1 forward, K2 backward, K3 over the
stacked KV cache; K4 the fused GroupNorm and K4B its backward; K5 the
LayerNorm fused into its consumer products) against their plain PyTorch versions, on a CUDA card. Marked ``gpu``; skipped where no card is present. Run on the
card with ``python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernel.py``
(tests/conftest.py imports jax, which the GPU machine may lack).

Tolerances: fp32 inputs 1e-5 (the same fp32 arithmetic summed in another
order). bf16 inputs: both sides round the probs and ctx at the same points
and differ only in the order of fp32 sums, so ctx may differ by at most
BF16_ULPS bf16 ulps of the largest |ctx|, and by at most BF16_MEAN_TOL on
average; softmax in the other dtype moves the mean by far more, which
``test_bf16_check_sees_softmax_mode`` shows. colsum 1e-3 relative.

K2 (dO ~ 0.1 N(0, 1)): fp32 inputs 1e-5 of the largest |grad|; bf16 inputs
at most BF16_ULPS bf16 ulps of the largest |grad| and BWD_MEAN_TOL on
average (K2 rebuilds P bit for bit and runs every product on fp32
operands, so only the order of fp32 sums differs); dQ exactly 0 on fully
masked rows.

K3: the bounds of K1 (fp32 1e-5; bf16 BF16_ULPS of the largest |ctx| and
BF16_MEAN_TOL on average), on causal masks over cache positions with zero
cache rows past the position; its prefill runs K1's tiles with the stacked
cache's strides. Its decode kernel with a live length kv_len is held to the
same bounds against the plain version over the live slice, with the dead
slots zero and then NaN; two of its launches must agree bit for bit.

K1's saved row max and sum against the plain version's: relative 1e-5 in
the fp32 softmax (dot products and exps summed in another order, each exp
a few ulps off on the special-function unit; the max also absolute 1e-5);
in the bf16 softmax a score
may round to the other bf16 neighbour, so the max within 2^-7 and the sum
within 2e-2. K2 with the forward's saved stats and without them, and two
K2 runs, must agree bit for bit.
"""

import math

import pytest
import torch

from merlot_tpu_torch.ops import cuda_attention, cuda_groupnorm, cuda_ln_matmul, norms
from merlot_tpu_torch.ops.attention import attention_core

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b, sq, sk, h, d, dtype, masked, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    mask = None
    if masked:
        mask = (torch.rand((b, sq, sk), generator=g, device=cuda) < 0.7).float()
        mask[:, :, 0] = 1.0
        mask[0, min(3, sq - 1)] = 0.0           # a fully masked row
    return q, k, v, mask


BF16_ULPS = 1
BF16_MEAN_TOL = 1e-5
SHAPES = [  # b, sq, sk, h, d, masked, colsum
    (2, 37, 37, 2, 64, True, True),
    (3, 50, 129, 4, 32, False, True),
    (1, 16, 2048, 2, 128, True, False),
    (2, 100, 7, 3, 80, True, True),
    (2, 33, 45, 2, 40, True, True),     # fp32 only: bf16 needs d % 16 == 0
]
CASES = [(dt, sm, *shape) for dt, sm in [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)]
    for shape in SHAPES if dt == torch.float32 or shape[4] % 16 == 0]
# VCR finetuning's shapes (configs/vcr_finetune.yaml): the ViT over 384x704
# frames (24*44 patches + 2 tokens, a ragged last 34-key tile) and the joint
# tower (12*22 pooled + 1 vision tokens, then 184 text tokens), bf16 with
# the config's fp32 softmax
VCR_SHAPES = [(16, 1058, 1058, 12, 64, False, False), (64, 449, 449, 12, 64, True, False)]
CASES += [(torch.bfloat16, True, *shape) for shape in VCR_SHAPES]
# pretrain_4seg's towers at model=2 (tensor parallelism): 6 of 12 heads of
# 64 per rank, the bf16 softmax; the lang tower collects the colsum
TP_SHAPES = [(128, 266, 266, 6, 64, False, False), (32, 396, 396, 6, 64, True, False),
             (8, 512, 512, 6, 64, True, True)]
CASES += [(torch.bfloat16, False, *shape) for shape in TP_SHAPES]


def _bf16_bound(ref):
    """BF16_ULPS bf16 ulps (8 significant bits) of the largest |ref|."""
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


@pytest.mark.parametrize("dtype,softmax_fp32,b,sq,sk,h,d,masked,colsum", CASES)
def test_kernel_matches_plain(cuda, dtype, softmax_fp32, b, sq, sk, h, d,
                              masked, colsum):
    q, k, v, mask = _inputs(cuda, b, sq, sk, h, d, dtype, masked)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32, collect_colsum=colsum)
    before = cuda_attention.launches
    ctx, cs = cuda_attention.attention_fwd_cuda(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    ref, ref_cs = cuda_attention.flash_attention_plain(q, k, v, mask, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(ctx, ref, atol=1e-5, rtol=1e-5)
    else:
        diff = (ctx.float() - ref.float()).abs()
        assert diff.max().item() <= _bf16_bound(ref.float())
        assert diff.mean().item() <= BF16_MEAN_TOL
    if colsum:
        torch.testing.assert_close(cs, ref_cs, atol=1e-4, rtol=1e-3)
    else:
        assert cs is None


@pytest.mark.parametrize("softmax_fp32", [True, False])
def test_bf16_check_sees_softmax_mode(cuda, softmax_fp32):
    q, k, v, mask = _inputs(cuda, 2, 256, 256, 4, 64, torch.bfloat16, True)
    kw = dict(num_heads=4, collect_colsum=False)
    ctx, _ = cuda_attention.attention_fwd_cuda(q, k, v, mask,
                                               softmax_fp32=softmax_fp32, **kw)
    ref, _ = cuda_attention.flash_attention_plain(q, k, v, mask,
                                                  softmax_fp32=softmax_fp32, **kw)
    other, _ = cuda_attention.flash_attention_plain(q, k, v, mask,
                                                    softmax_fp32=not softmax_fp32, **kw)
    assert (ctx.float() - ref.float()).abs().mean().item() <= BF16_MEAN_TOL
    assert (other.float() - ref.float()).abs().mean().item() > BF16_MEAN_TOL


def test_kernel_refuses_bad_inputs(cuda):
    q, k, v, mask = _inputs(cuda, 1, 8, 8, 2, 16, torch.float16, False)
    with pytest.raises(ValueError, match="dtype"):
        cuda_attention.attention_fwd_cuda(q, k, v, None, num_heads=2,
                                          softmax_fp32=True, collect_colsum=False)
    q, k, v, _ = _inputs(cuda, 1, 8, 8, 2, 16, torch.float32, False)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.attention_fwd_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                                          k, v, None, num_heads=2, softmax_fp32=True,
                                          collect_colsum=False)
    q, k, v, _ = _inputs(cuda, 1, 8, 8, 2, 40, torch.bfloat16, False)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_attention.attention_fwd_cuda(q, k, v, None, num_heads=2,
                                          softmax_fp32=True, collect_colsum=False)
    q, k, v, _ = _inputs(cuda, 1, 8, 8, 2, 16, torch.float32, False)
    buf = torch.empty(q.numel() + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        cuda_attention.attention_fwd_cuda(buf[1:].view(q.shape), k, v, None,
                                          num_heads=2, softmax_fp32=True,
                                          collect_colsum=False)


BWD_MEAN_TOL = 1e-6


def _bwd_extra(cuda, b, sq, sk, h, d, dtype, colsum, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    do = (0.1 * torch.randn((b, sq, h * d), generator=g, device=cuda)).to(dtype)
    gcol = torch.randn((b, sk), generator=g, device=cuda) if colsum else None
    return do, gcol


@pytest.mark.parametrize("dtype,softmax_fp32,b,sq,sk,h,d,masked,colsum", CASES)
def test_bwd_kernel_matches_plain(cuda, dtype, softmax_fp32, b, sq, sk, h, d,
                                  masked, colsum):
    q, k, v, mask = _inputs(cuda, b, sq, sk, h, d, dtype, masked)
    do, gcol = _bwd_extra(cuda, b, sq, sk, h, d, dtype, colsum)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32)
    before = cuda_attention.bwd_launches
    got = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    torch.cuda.synchronize()
    assert cuda_attention.bwd_launches == before + 1
    ref = cuda_attention.attention_bwd_plain(q, k, v, mask, do, gcol, **kw)
    for a, r in zip(got, ref):
        assert a.dtype == dtype and a.shape == r.shape
        diff = (a.float() - r.float()).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-5 * r.abs().max().item()
        else:
            assert diff.max().item() <= _bf16_bound(r.float())
            assert diff.mean().item() <= BWD_MEAN_TOL
    if masked:
        assert not got[0][0, min(3, sq - 1)].any()      # the fully masked row


def test_flash_attention_autograd_runs_both_kernels(cuda):
    """Autograd through FlashAttention on CUDA tensors launches K1 forward
    and K2 backward once each, takes a non-contiguous dO, and matches
    autograd through the plain versions."""
    q, k, v, mask = _inputs(cuda, 2, 50, 50, 4, 64, torch.bfloat16, True)
    grads = []
    for backend in ("cuda", "plain"):
        leaves = [t.reshape(2, 50, 4, 64).detach().requires_grad_() for t in (q, k, v)]
        before = (cuda_attention.launches, cuda_attention.bwd_launches)
        ctx, _ = attention_core(*leaves, mask, backend=backend, softmax_fp32=False)
        loss = (ctx.transpose(1, 2).float() * torch.arange(
            50, device=cuda).float().view(1, 1, 50, 1)).sum()     # non-contiguous dO
        grads.append(torch.autograd.grad(loss, leaves))
        launched = (cuda_attention.launches - before[0],
                    cuda_attention.bwd_launches - before[1])
        assert launched == ((1, 1) if backend == "cuda" else (0, 0))
    for a, r in zip(*grads):
        diff = (a.float() - r.float()).abs()
        # autograd through the plain bf16 path rounds dP and dS to bf16
        # (tensors of the input dtype); K2 keeps them in fp32, as the TPU
        # kernel does: a few bf16 ulps of the largest |grad| at most
        assert diff.max().item() <= 4 * _bf16_bound(r.float())


# cross-attention (queries over an encoder source of another length) under
# a rectangular validity mask [B, Sq, Sk], and the encoder cache's decode
# step (one query over the cache's slots, those past each element's
# position masked out): K1 and K2, bf16 and fp32, both softmax modes
RECT_CASES = [(dt, sm, b, sq, sk) for dt, sm in [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)]
    for b, sq, sk in [(8, 256, 396), (2, 70, 200), (3, 130, 64)]]


def _rect_inputs(cuda, dtype, b, sq, sk, h=4, d=64, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h * d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, h * d), generator=g, device=cuda).to(dtype) for _ in range(2))
    valid_q = torch.rand((b, sq), generator=g, device=cuda) > 0.2
    valid_k = torch.rand((b, sk), generator=g, device=cuda) > 0.2
    valid_q[0, 1] = False                             # a fully masked row
    valid_k[:, 0] = True
    return q, k, v, (valid_q[:, :, None] & valid_k[:, None]).float(), valid_q


def _within(got, ref, dtype, mean_tol):
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5 * max(ref.abs().max().item(), 1.0)
    else:
        assert diff.max().item() <= _bf16_bound(ref.float())
        assert diff.mean().item() <= mean_tol


@pytest.mark.parametrize("dtype,softmax_fp32,b,sq,sk", RECT_CASES)
def test_cross_attention_kernels_match_plain(cuda, dtype, softmax_fp32, b, sq, sk):
    """K1 and K2 at Sq != Sk under a rectangular mask: ctx, dQ/dK/dV within
    the bounds above, dQ 0 on the fully masked rows, and K2 from K1's saved
    stats equal to K2 computing them."""
    q, k, v, mask, valid_q = _rect_inputs(cuda, dtype, b, sq, sk)
    do, _ = _bwd_extra(cuda, b, sq, sk, 4, 64, dtype, False)
    kw = dict(num_heads=4, softmax_fp32=softmax_fp32)
    stats = cuda_attention.new_stats(q, 4)
    tile_class = cuda_attention.new_tile_class(mask) if dtype == torch.float32 else None
    ctx, _ = cuda_attention.attention_fwd_cuda(q, k, v, mask, collect_colsum=False,
                                               stats=stats, tile_class=tile_class, **kw)
    got = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, None, stats=stats,
                                            tile_class=tile_class, **kw)
    again = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, None, **kw)
    torch.cuda.synchronize()
    ref, _ = cuda_attention.flash_attention_plain(q, k, v, mask, collect_colsum=False, **kw)
    _within(ctx, ref, dtype, BF16_MEAN_TOL)
    for a, r, b_ in zip(got, cuda_attention.attention_bwd_plain(q, k, v, mask, do, None, **kw),
                        again):
        _within(a, r, dtype, BWD_MEAN_TOL)
        assert torch.equal(a, b_)
    assert not got[0][~valid_q].any()


@pytest.mark.parametrize("dtype,softmax_fp32", [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)])
@pytest.mark.parametrize("sk", [512, 200])
def test_decode_step_kernel_matches_plain(cuda, dtype, softmax_fp32, sk):
    """K1 at Sq = 1 over a cache of sk slots, each element attending the
    slots up to its own position (zeros past it), against the plain
    version."""
    b, h, d = 8, 4, 64
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, 1, h * d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, h * d), generator=g, device=cuda).to(dtype) for _ in range(2))
    pos = torch.randint(0, sk, (b,), generator=g, device=cuda)
    live = torch.arange(sk, device=cuda)[None, :, None] <= pos[:, None, None]
    k, v = k * live, v * live
    mask = live.transpose(1, 2).float().contiguous()
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32, collect_colsum=False)
    ctx, _ = cuda_attention.attention_fwd_cuda(q, k, v, mask, **kw)
    ref, _ = cuda_attention.flash_attention_plain(q, k, v, mask, **kw)
    _within(ctx, ref, dtype, BF16_MEAN_TOL)


@pytest.mark.parametrize("s", [200, 1536])
def test_fp32_causal_kernels_at_grover_heads(cuda, s):
    """Grover training's attention (fp32 inputs and softmax, 16 heads of
    64, a causal [B, S, S] mask; S 1536 is grover_train's default): K1 and
    K2 (the FMA routes) within 1e-5 of the plain versions, which the
    forward with the mask dropped misses."""
    b, h, d = 2, 16, 64
    q, k, v, _ = _inputs(cuda, b, s, s, h, d, torch.float32, False, seed=3)
    mask = torch.tril(torch.ones((s, s), device=cuda)).expand(b, s, s).contiguous()
    do, _ = _bwd_extra(cuda, b, s, s, h, d, torch.float32, False)
    kw = dict(num_heads=h, softmax_fp32=True)
    ctx, _ = cuda_attention.attention_fwd_cuda(q, k, v, mask, collect_colsum=False, **kw)
    ref, _ = cuda_attention.flash_attention_plain(q, k, v, mask, collect_colsum=False, **kw)
    no_mask, _ = cuda_attention.flash_attention_plain(q, k, v, None, collect_colsum=False,
                                                      **kw)
    torch.testing.assert_close(ctx, ref, atol=1e-5, rtol=1e-5)
    assert (no_mask - ref).abs().max().item() > 1e-2
    got = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, None, **kw)
    for a, r in zip(got, cuda_attention.attention_bwd_plain(q, k, v, mask, do, None, **kw)):
        assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item()


# K1's tiles (64-row q tiles, 64-key K/V tiles, TMA zero-fill past Sq and Sk)
# at lengths on either side of a tile edge and at the limit, every head dim
# class of the wgmma descriptors; bf16, the softmax mode alternating
EDGE_LENS = [1, 63, 64, 65, 266, 885, 2048]
EDGE_CASES = [(sq, sk, d) for sq in EDGE_LENS for sk in EDGE_LENS for d in (16, 64, 128)]


@pytest.mark.parametrize("sq,sk,d", EDGE_CASES)
def test_kernel_tile_edges_match_plain(cuda, sq, sk, d):
    softmax_fp32 = (sq + sk + d) % 2 == 0
    q, k, v, mask = _inputs(cuda, 1, sq, sk, 2, d, torch.bfloat16, True)
    kw = dict(num_heads=2, softmax_fp32=softmax_fp32, collect_colsum=True)
    stats = cuda_attention.new_stats(q, 2)
    ctx, cs = cuda_attention.attention_fwd_cuda(q, k, v, mask, stats=stats, **kw)
    torch.cuda.synchronize()
    ref, ref_cs = cuda_attention.flash_attention_plain(q, k, v, mask, **kw)
    diff = (ctx.float() - ref.float()).abs()
    assert diff.max().item() <= _bf16_bound(ref.float())
    assert diff.mean().item() <= BF16_MEAN_TOL
    torch.testing.assert_close(cs, ref_cs, atol=1e-4, rtol=1e-3)
    ref_stats = cuda_attention.softmax_stats_plain(q, k, mask, num_heads=2,
                                                   softmax_fp32=softmax_fp32)
    # the saved row max and sum: the scores' fp32 sums in another order
    # (absolute 1e-5 at scores of order 1), exps summed in another order; in
    # the bf16 softmax a score may round to the other neighbour
    max_tol, sum_tol = (1e-5, 1e-5) if softmax_fp32 else (2.0 ** -7, 2e-2)
    torch.testing.assert_close(stats[0], ref_stats[0], atol=1e-5, rtol=max_tol)
    torch.testing.assert_close(stats[1], ref_stats[1], atol=0, rtol=sum_tol)


@pytest.mark.parametrize("softmax_fp32", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,d,colsum", [(2, 70, 130, 2, 64, True),
                                                 (4, 266, 266, 12, 64, False),
                                                 (1, 65, 885, 2, 128, True)])
def test_bwd_saved_stats_and_repeatable(cuda, softmax_fp32, b, sq, sk, h, d, colsum):
    """K2 fed K1's saved row max and sum gives the same bits as K2 that
    computes them itself, and two runs give the same bits (no atomics)."""
    q, k, v, mask = _inputs(cuda, b, sq, sk, h, d, torch.bfloat16, True)
    do, gcol = _bwd_extra(cuda, b, sq, sk, h, d, torch.bfloat16, colsum)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32)
    stats = cuda_attention.new_stats(q, h)
    cuda_attention.attention_fwd_cuda(q, k, v, mask, stats=stats, collect_colsum=colsum,
                                      **kw)
    saved = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, stats=stats, **kw)
    own = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    again = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    torch.cuda.synchronize()
    for a, o, r in zip(saved, own, again):
        assert torch.equal(a, o) and torch.equal(o, r)


# the fp32 route's mask tiles: all 0 (skipped), all 1, mixed
FP32_MASKS = ["causal", "padded", "block_sparse", "non_binary"]


def _fp32_mask(cuda, kind, b, s):
    """A [b, s, s] mask of one kind: causal; padded rows and keys (fully
    masked rows); 64 x 64 blocks kept or dropped off the diagonal (all-0
    tiles beside rows that still attend); values in [0, 1] with zero
    blocks."""
    g = torch.Generator(device=cuda).manual_seed(11)
    if kind == "causal":
        return torch.tril(torch.ones((s, s), device=cuda)).expand(b, s, s).contiguous()
    if kind == "padded":
        valid = torch.ones((b, s), dtype=torch.bool, device=cuda)
        valid[0, s - 70:] = False
        valid[-1, 5] = False
        return (valid[:, None] & valid[:, :, None]).float()
    nb = -(-s // 64)
    keep = torch.rand((b, nb, nb), generator=g, device=cuda) < 0.4
    keep |= torch.eye(nb, dtype=torch.bool, device=cuda)
    m = keep.repeat_interleave(64, 1).repeat_interleave(64, 2)[:, :s, :s].float()
    if kind == "non_binary":
        m = m * torch.rand((b, s, s), generator=g, device=cuda)
    return m.contiguous()


@pytest.mark.parametrize("kind", FP32_MASKS)
@pytest.mark.parametrize("s,d,colsum", [(200, 64, False), (1000, 40, True)])
def test_fp32_masked_tiles_match_plain(cuda, kind, s, d, colsum):
    """The fp32 route on masks with all-0 tiles: ctx, colsum and grads
    within 1e-5 of the plain versions, dQ exactly 0 on fully masked rows,
    K2 with K1's saved stats and classes equal to K2 on its own, twice."""
    b, h = 2, 2
    q, k, v, _ = _inputs(cuda, b, s, s, h, d, torch.float32, False, seed=5)
    mask = _fp32_mask(cuda, kind, b, s)
    do, gcol = _bwd_extra(cuda, b, s, s, h, d, torch.float32, colsum)
    kw = dict(num_heads=h, softmax_fp32=True)
    stats, cls = cuda_attention.new_stats(q, h), cuda_attention.new_tile_class(mask)
    ctx, cs = cuda_attention.attention_fwd_cuda(q, k, v, mask, stats=stats, tile_class=cls,
                                                collect_colsum=colsum, **kw)
    saved = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, stats=stats,
                                              tile_class=cls, **kw)
    own = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    again = cuda_attention.attention_bwd_cuda(q, k, v, mask, do, gcol, **kw)
    torch.cuda.synchronize()
    ref, ref_cs = cuda_attention.flash_attention_plain(q, k, v, mask, collect_colsum=colsum,
                                                       **kw)
    assert (ctx - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if colsum:
        torch.testing.assert_close(cs, ref_cs, atol=1e-4, rtol=1e-3)
    for a, r in zip(saved, cuda_attention.attention_bwd_plain(q, k, v, mask, do, gcol, **kw)):
        assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    for a, o, r in zip(saved, own, again):
        assert torch.equal(a, o) and torch.equal(o, r)
    dead = mask.amax(dim=-1) == 0
    assert not saved[0][dead].any()


def test_bwd_refuses_bad_stats(cuda):
    q, k, v, mask = _inputs(cuda, 1, 8, 8, 2, 16, torch.bfloat16, False)
    do, _ = _bwd_extra(cuda, 1, 8, 8, 2, 16, torch.bfloat16, False)
    with pytest.raises(ValueError, match="stats"):
        cuda_attention.attention_bwd_cuda(q, k, v, None, do, None, num_heads=2,
                                          softmax_fp32=True,
                                          stats=torch.empty(2, 1, 2, 8, device=cuda))


# K3: cached attention over the stacked KV cache, fp32 inputs 1e-5, bf16
# inputs the bounds of K1 (the same rounding points, sums in another order)
STACKED_SHAPES = [  # b, sq, sk, h, d, shared mask
    (8, 1, 1537, 16, 64, True),      # the server's decode step
    (1, 1, 300, 4, 64, False),
    (2, 5, 100, 2, 32, True),        # decode kernel, several query rows
    (3, 8, 77, 3, 128, False),
    (2, 40, 129, 4, 64, True),       # prefill: K1's tiled kernels
    (1, 17, 2048, 2, 128, False),
    (2, 1024, 1537, 16, 64, True),   # Grover's prefill at the server's max_len
    (1, 65, 63, 2, 16, False),       # one row and one key past a tile
    (8, 1, 1537, 8, 64, True),       # grover-medium at model=2: 8 of 16 heads
    (8, 1024, 1537, 8, 64, True),
]
STACKED_CASES = [(dt, sm, *shape) for dt, sm in [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)]
    for shape in STACKED_SHAPES]


def _stacked_inputs(cuda, b, sq, sk, h, d, dtype, shared, seed=0, kv_len=None):
    """q, a stacked cache whose rows past the last query's position are
    zero, and the causal mask over cache positions ([1, Sq, Sk] if shared).
    The last query sits at kv_len - 1 if kv_len is given, else near Sk / 2."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h * d), generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, sk, 2 * h * d), generator=g, device=cuda).to(dtype)
    pos0 = max(sk // 2 - sq, 0) if kv_len is None else kv_len - sq
    kv[:, pos0 + sq:] = 0
    mask = (torch.arange(sk, device=cuda)[None] <=
            pos0 + torch.arange(sq, device=cuda)[:, None]).float()[None]
    return q, kv, mask if shared else mask.expand(b, sq, sk).contiguous()


@pytest.mark.parametrize("dtype,softmax_fp32,b,sq,sk,h,d,shared", STACKED_CASES)
def test_stacked_kernel_matches_plain(cuda, dtype, softmax_fp32, b, sq, sk, h, d,
                                      shared):
    q, kv, mask = _stacked_inputs(cuda, b, sq, sk, h, d, dtype, shared)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32)
    before = cuda_attention.stacked_launches
    ctx = cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, **kw)
    torch.cuda.synchronize()
    assert cuda_attention.stacked_launches == before + 1
    ref = cuda_attention.flash_attention_stacked_plain(q, kv, mask, **kw)
    assert ctx.dtype == dtype and ctx.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(ctx, ref, atol=1e-5, rtol=1e-5)
    else:
        diff = (ctx.float() - ref.float()).abs()
        assert diff.max().item() <= _bf16_bound(ref.float())
        assert diff.mean().item() <= BF16_MEAN_TOL


def test_stacked_kernel_refuses_bad_inputs(cuda):
    q, kv, mask = _stacked_inputs(cuda, 2, 1, 64, 2, 64, torch.bfloat16, True)
    kw = dict(num_heads=2, softmax_fp32=True)
    with pytest.raises(ValueError, match="kv must be"):
        cuda_attention.attention_stacked_fwd_cuda(q, kv[..., :128].contiguous(), mask, **kw)
    with pytest.raises(ValueError, match="mask must be"):
        cuda_attention.attention_stacked_fwd_cuda(q, kv, mask[:, :, :10].contiguous(), **kw)
    with pytest.raises(ValueError, match="dtype"):
        cuda_attention.attention_stacked_fwd_cuda(q.float(), kv, mask, **kw)
    q, kv, mask = _stacked_inputs(cuda, 2, 1, 64, 2, 40, torch.bfloat16, True)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, **kw)
    q, kv, mask = _stacked_inputs(cuda, 2, 1, 64, 2, 30, torch.float32, True)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, **kw)


# K3's decode kernel with a live length: it reads only the slots below
# kv_len (the causal mask is 0 past it), so it must meet the plain version
# over the live slice within K3's bounds, whatever the dead slots hold
KV_LEN_SHAPES = [  # b, sq, sk, h, d, shared mask, kv_len
    (8, 1, 1537, 16, 64, True, 1101),    # the server's decode step
    (8, 1, 1216, 16, 64, True, 1101),    # bench.py's grover mode
    (1, 1, 1537, 16, 64, True, 1101),    # batch 1
    (1, 1, 1537, 16, 64, True, 1),
    (1, 1, 1537, 16, 64, True, 13),      # not a multiple of the 8-row box
    (2, 5, 100, 2, 32, False, 61),       # several query rows, per-row mask
    (3, 8, 2048, 3, 128, True, 2048),
]
KV_LEN_CASES = [(dt, sm, *shape) for dt, sm in [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)]
    for shape in KV_LEN_SHAPES]


def _check_stacked(ctx, ref):
    assert ctx.dtype == ref.dtype and ctx.shape == ref.shape
    assert bool(torch.isfinite(ctx).all())
    if ctx.dtype == torch.float32:
        torch.testing.assert_close(ctx, ref, atol=1e-5, rtol=1e-5)
    else:
        diff = (ctx.float() - ref.float()).abs()
        assert diff.max().item() <= _bf16_bound(ref.float())
        assert diff.mean().item() <= BF16_MEAN_TOL


@pytest.mark.parametrize("dtype,softmax_fp32,b,sq,sk,h,d,shared,kv_len", KV_LEN_CASES)
def test_stacked_decode_kv_len_matches_plain(cuda, dtype, softmax_fp32, b, sq, sk, h, d,
                                             shared, kv_len):
    q, kv, mask = _stacked_inputs(cuda, b, sq, sk, h, d, dtype, shared, kv_len=kv_len)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32)
    ref = cuda_attention.flash_attention_stacked_plain(q, kv, mask, kv_len=kv_len, **kw)
    ctx = cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, kv_len=kv_len, **kw)
    torch.cuda.synchronize()
    _check_stacked(ctx, ref)
    # the dead slots hold NaN: nothing past kv_len is read
    kv[:, kv_len:] = float("nan")
    _check_stacked(cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, kv_len=kv_len,
                                                             **kw), ref)


def test_stacked_decode_is_deterministic(cuda):
    q, kv, mask = _stacked_inputs(cuda, 8, 1, 1537, 16, 64, torch.bfloat16, True,
                                  kv_len=1101)
    kw = dict(num_heads=16, softmax_fp32=True, kv_len=1101)
    first = cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, **kw)
    for _ in range(3):
        assert torch.equal(cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, **kw),
                           first)


def test_stacked_kernel_refuses_bad_kv_len(cuda):
    q, kv, mask = _stacked_inputs(cuda, 2, 1, 64, 2, 64, torch.bfloat16, True)
    kw = dict(num_heads=2, softmax_fp32=True)
    for bad in (0, 65, -1):
        with pytest.raises(ValueError, match="kv_len"):
            cuda_attention.attention_stacked_fwd_cuda(q, kv, mask, kv_len=bad, **kw)
    # the C entry refuses them too
    lib = cuda_attention.load_stacked_kernel()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (0, 65):
        err = lib.merlot_attention_stacked_fwd(
            q.data_ptr(), kv.data_ptr(), mask.data_ptr(), out.data_ptr(), None, 2, 1, 64,
            bad, 2, 64, 0, 1, 1, 8, 0.125, stream)
        assert err != 0


# K4: fused GroupNorm(+residual+ReLU) over channels-last [B, HW, C]. fp32
# inputs 1e-5 (the same fp32 steps, sums in another order); bf16 inputs at
# most BF16_ULPS bf16 ulps of the largest |out| and BF16_MEAN_TOL on
# average (an fp32 difference of the statistics flips an element's bf16
# rounding now and then); mean and rstd 1e-5.
GN_SHAPES = [  # b, hw, c, groups, kind
    (2, 37, 64, 32, "relu"),
    (3, 100, 256, 32, "res"),
    (1, 5, 32, 32, "proj"),
    (2, 1000, 1024, 32, "res"),
    (4, 3000, 32, 32, "relu"),       # several row chunks per image
    (2, 77, 40, 4, "relu"),          # 10 channels per group
    (2, 16896, 64, 32, "relu"),      # a cluster of 16 that streams rows
    (1, 36864, 64, 32, "relu"),      # the zero-shot stem: most rows streamed
    (3, 264, 1024, 32, "res"),
    (2, 1056, 512, 32, "proj"),
    (2, 9216, 128, 32, "relu"),
    (5, 1, 32, 32, "relu"),          # one row per image
    (2, 4099, 256, 32, "res"),       # ranks with a ragged last range
]
GN_CASES = [(dt, *shape) for dt in (torch.float32, torch.bfloat16) for shape in GN_SHAPES]


def _gn_inputs(cuda, b, hw, c, dtype, res, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((b, hw, c), generator=g, device=cuda)
         + torch.randn(c, generator=g, device=cuda)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda)
    r = torch.randn((b, hw, c), generator=g, device=cuda).to(dtype) if res else None
    return x, gamma, beta, r


@pytest.mark.parametrize("dtype,b,hw,c,groups,kind", GN_CASES)
def test_groupnorm_kernel_matches_plain(cuda, dtype, b, hw, c, groups, kind):
    x, gamma, beta, r = _gn_inputs(cuda, b, hw, c, dtype, kind == "res")
    kw = dict(num_groups=groups, epsilon=1e-4, relu=kind != "proj")
    before = cuda_groupnorm.launches
    out, mean, rstd = cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, r, **kw)
    torch.cuda.synchronize()
    assert cuda_groupnorm.launches == before + 1
    ref, ref_mean, ref_rstd = norms.group_norm_act_plain(x, gamma, beta, r, groups,
                                                         kw["epsilon"], kw["relu"])
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(mean, ref_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, atol=1e-5, rtol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    else:
        diff = (out.float() - ref.float()).abs()
        assert diff.max().item() <= _bf16_bound(ref.float())
        assert diff.mean().item() <= BF16_MEAN_TOL


def test_groupnorm_kernel_refuses_bad_inputs(cuda):
    x, gamma, beta, _ = _gn_inputs(cuda, 2, 6, 64, torch.bfloat16, False)
    kw = dict(num_groups=32, epsilon=1e-4, relu=True)
    with pytest.raises(ValueError, match="contiguous"):      # an NCHW tensor's NHWC view
        cuda_groupnorm.group_norm_act_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                                           gamma, beta, None, **kw)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        cuda_groupnorm.group_norm_act_cuda(x.half(), gamma, beta, None, **kw)
    x, gamma, beta, _ = _gn_inputs(cuda, 2, 6, 36, torch.bfloat16, False)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, None, **dict(kw, num_groups=4))


def test_groupnorm_autograd_runs_the_kernel(cuda):
    """GroupNormAct on CUDA tensors launches K4 once forward and K4B once
    backward (through 'cuda' and 'auto' alike), and its gradients match
    autograd through the unfused composition (fp32)."""
    x, gamma, beta, r = _gn_inputs(cuda, 2, 300, 128, torch.float32, True)
    dy = torch.randn_like(x)
    grads = []
    for backend in ("cuda", "auto", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta, r)]
        before = cuda_groupnorm.launches, cuda_groupnorm.bwd_launches
        out = cuda_groupnorm.group_norm_act(*leaves[:3], residual=leaves[3], relu=True,
                                            backend=backend)
        kernels = backend != "plain"
        assert cuda_groupnorm.launches == before[0] + kernels
        grads.append(torch.autograd.grad(out, leaves, dy))
        assert cuda_groupnorm.bwd_launches == before[1] + kernels
    assert all(torch.equal(a, b) for a, b in zip(grads[0], grads[1]))
    for a, b in zip(grads[0], grads[2]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


# K4B: the fused backward, at every distinct (HW, C, residual, ReLU) site of
# the LiteResNet [3, 4, 9] stem in the pretrain step (192x352 frames: 96x176
# after the stem's first conv, then 48x88, 24x44, 12x22) and in zero-shot
# (384x384: 192x192, 96x96, 48x48, 24x24); 2 images a case (the batch only
# adds clusters). Against the plain saved-stats backward
# (``norms.group_norm_act_bwd``) on the same saved (x, mean, rstd, out):
#   - dx, fp32 inputs: within 1e-5 of the largest |dx|. Both run the same
#     fp32 steps on each element; only m1 and m2 differ, by sums in another
#     order (gamma factored out of the group sums): a few 1e-6 of the
#     largest at worst.
#   - dx, bf16 inputs: at most BF16_ULPS bf16 ulps of the largest |dx| and
#     BF16_MEAN_TOL on average (that fp32 difference flips an element's bf16
#     rounding now and then).
#   - dgamma, dbeta: fp32 sums of B * HW terms in another order, within
#     GN_SUM_TOL of the channel's sum of |terms| (a sum's rounding error is
#     at most ~eps per sequential add of the longer path; K4B's is ~200).
#   - dresidual: dy under the same mask, bit for bit.
# Against autograd through the unfused composition (the forward the port ran
# before 'auto') under K4's own ReLU mask (a pre-ReLU value within fp32 noise
# of 0 may fall on either side of it in the two forwards): 2e-4 of the
# largest |grad| in fp32, the bound of the existing autograd check (the
# composition's backward through E[x^2] - E[x]^2 rounds differently); in
# bf16, dx at most 2 bf16 ulps of the largest and 1e-4 on average.
GN_SUM_TOL = 2e-5
GN_BWD_SITES = [  # hw per resolution (pretrain, zero-shot), c, residual, relu
    (0, 32, False, True), (0, 64, False, True), (1, 64, False, True), (1, 256, False, False),
    (1, 256, True, True), (1, 128, False, True), (2, 128, False, True),
    (2, 512, False, False), (2, 512, True, True), (2, 256, False, True),
    (3, 256, False, True), (3, 1024, False, False), (3, 1024, True, True),
]
GN_HW = {"pretrain": (16896, 4224, 1056, 264), "zeroshot": (36864, 9216, 2304, 576)}
GN_BWD_CASES = [(dt, GN_HW[path][level], c, res, relu)
                for dt in (torch.float32, torch.bfloat16) for path in GN_HW
                for level, c, res, relu in GN_BWD_SITES]


def _close_to_max(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,hw,c,res,relu", GN_BWD_CASES)
def test_groupnorm_bwd_kernel_matches_plain(cuda, dtype, hw, c, res, relu):
    x, gamma, beta, r = _gn_inputs(cuda, 2, hw, c, dtype, res)
    dy = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda).to(dtype)
    out, mean, rstd = cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, r, num_groups=32,
                                                         epsilon=1e-4, relu=relu)
    saved = out if relu else None
    before = cuda_groupnorm.bwd_launches
    dx, dgamma, dbeta, dres = cuda_groupnorm.group_norm_act_bwd_cuda(
        dy, x, gamma, mean, rstd, saved, res, 32)
    torch.cuda.synchronize()
    assert cuda_groupnorm.bwd_launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape and dgamma.dtype == torch.float32
    w_dx, w_dgamma, w_dbeta, w_dres = norms.group_norm_act_bwd(dy, x, gamma, mean, rstd,
                                                               saved, res, 32)
    if dtype == torch.float32:
        _close_to_max(dx, w_dx, 1e-5)
    else:
        diff = (dx.float() - w_dx.float()).abs()
        assert diff.max().item() <= _bf16_bound(w_dx.float())
        assert diff.mean().item() <= BF16_MEAN_TOL
    dyg = (torch.where(out > 0, dy, 0) if relu else dy).float().reshape(-1, c)
    x_hat = ((x.float().reshape(2, hw, 32, -1) - mean[:, None, :, None])
             * rstd[:, None, :, None]).reshape(-1, c)
    for got, want, terms in ((dbeta, w_dbeta, dyg), (dgamma, w_dgamma, dyg * x_hat)):
        assert ((got - want).abs() <= GN_SUM_TOL * terms.abs().sum(0)).all()
    assert (dres is None) == (not res)
    if res:
        assert torch.equal(dres, w_dres)
    # autograd through the composition, under K4's mask
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta, r) if t is not None]
    comp = norms.group_norm_act(*leaves[:3], residual=leaves[3] if res else None, relu=False)
    want = torch.autograd.grad(comp, leaves, dyg.reshape(x.shape).to(dtype))
    if dtype == torch.float32:
        _close_to_max(dx, want[0], 2e-4)
    else:
        diff = (dx.float() - want[0].float()).abs()
        assert diff.max().item() <= 2 * _bf16_bound(want[0].float())
        assert diff.mean().item() <= 1e-4
    _close_to_max(dgamma, want[1], 2e-4)
    _close_to_max(dbeta, want[2], 2e-4)
    if res:
        assert torch.equal(dres, want[3])


def test_groupnorm_bwd_kernel_is_deterministic(cuda):
    """K4B at a cluster of 16 that streams rows gives the same bits run to
    run (no atomics; every sum in a fixed order)."""
    x, gamma, beta, r = _gn_inputs(cuda, 3, 16896, 64, torch.bfloat16, True)
    dy = torch.randn_like(x)
    out, mean, rstd = cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, r, num_groups=32,
                                                         epsilon=1e-4, relu=True)
    runs = [cuda_groupnorm.group_norm_act_bwd_cuda(dy, x, gamma, mean, rstd, out, True, 32)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_groupnorm_bwd_kernel_refuses_bad_inputs(cuda):
    x, gamma, beta, _ = _gn_inputs(cuda, 2, 6, 64, torch.bfloat16, False)
    out, mean, rstd = cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, None, num_groups=32,
                                                         epsilon=1e-4, relu=True)
    dy = torch.randn_like(x)
    with pytest.raises(ValueError, match="dy"):
        cuda_groupnorm.group_norm_act_bwd_cuda(dy.float(), x, gamma, mean, rstd, out, False, 32)
    with pytest.raises(ValueError, match="mean and rstd"):
        cuda_groupnorm.group_norm_act_bwd_cuda(dy, x, gamma, mean[:, :16], rstd, out, False, 32)


def test_gn_kernel_counter_on_the_card(cuda):
    """``gn.kernel`` reads 1 for a CUDA call on the kernels ('auto'), 0 for
    one on the composition ('plain')."""
    from torch.profiler import ProfilerActivity, profile

    from merlot_tpu_torch.core import trace
    x, gamma, beta, _ = _gn_inputs(cuda, 2, 40, 64, torch.bfloat16, False)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("step"):
            for backend in ("auto", "plain", None):
                cuda_groupnorm.group_norm_act(x, gamma, beta, relu=True, backend=backend)
    assert trace.counted()[-1]["gn.kernel"] == [1.0, 0.0, 1.0]
    trace.clear()


def _small_merlot_fp32(cuda):
    from merlot_tpu_torch.models.config import MerlotConfig
    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.nn.layers import init_params
    cfg = MerlotConfig(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                       contrastive_size=128, num_hidden_layers=1,
                       num_vision_transformer_hidden_layers=1,
                       num_lang_transformer_hidden_layers=1, image_size=(64, 96),
                       resnet_layers=(1, 1, 1), num_chunks_in_group=2, use_bfloat16=False,
                       hidden_dropout_prob=0.0)
    model = MerlotPretrainModel(cfg, device=cuda)
    init_params(model, torch.Generator(device=cuda).manual_seed(0))
    return model


def _merlot_step(model, batch, cuda, replay=None):
    """One forward and backward of the pretrain loss: (loss, grads, the
    ReLU masks ``out > 0`` of every GroupNorm+ReLU site on the kernels, in
    call order, K4 launches, K4B calls). With ``replay``, the composition's
    ReLUs apply those masks in that order in place of their own."""
    masks, replayed = [], iter(replay or ())
    apply, composition = cuda_groupnorm.GroupNormAct.apply, norms.group_norm_act

    def kernels(x, gamma, beta, residual, num_groups, epsilon, relu):
        out = apply(x, gamma, beta, residual, num_groups, epsilon, relu)
        if relu:
            masks.append(out > 0)
        return out

    def unfused(x, gamma, beta, *, relu=False, **kw):
        out = composition(x, gamma, beta, relu=relu and replay is None, **kw)
        return torch.where(next(replayed), out, 0) if relu and replay is not None else out

    before = cuda_groupnorm.launches, cuda_groupnorm.bwd_launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_groupnorm.GroupNormAct, "apply", kernels)
        mp.setattr(norms, "group_norm_act", unfused)
        model.zero_grad(set_to_none=True)
        loss, _, _ = model(batch, deterministic=False,
                           generator=torch.Generator(device=cuda).manual_seed(1))
        loss.backward()
    torch.cuda.synchronize()
    assert next(replayed, None) is None
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return (loss.item(), grads, masks, cuda_groupnorm.launches - before[0],
            cuda_groupnorm.bwd_launches - before[1])


def test_merlot_step_grads_on_the_kernels_match_the_composition(cuda, monkeypatch):
    """One MERLOT pretrain step's forward and backward (fp32, dropout off,
    the same masking draws, TF32 off) with the stem's 15 GroupNorms on K4
    and K4B ('auto') and on the composition ('plain'): the loss within 1e-5
    relative and each tensor's grads within 2e-4 of its largest |grad|
    (floored at 1e-6 of the largest of all), the CPU step checks' bounds
    (the two differ by fp32 sums in another order). The composition's 12
    ReLUs take K4's masks: a pre-ReLU value within fp32 noise of 0 may fall
    on either side in the two forwards, and move a weight-standardized
    kernel's nearly cancelling grad by up to 4e-3 of its largest
    (tests/test_torch_fused_step.py), which is no fault of either."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = _small_merlot_fp32(cuda)
    examples, chunks, tokens = 2, 4, 8
    g = torch.Generator(device=cuda).manual_seed(0)
    n_img = examples * chunks
    batch = {"input_ids": torch.randint(100, 50357, (examples, chunks, tokens), generator=g,
                                        device=cuda),
             "images": torch.rand((n_img, 64, 96, 3), generator=g, device=cuda),
             "shuffled_idx_img": torch.arange(2, device=cuda).repeat(n_img // 2),
             "video_src_ids": torch.arange(n_img // 2, device=cuda).repeat_interleave(2)
             .reshape(examples, chunks)}
    monkeypatch.setattr(cuda_groupnorm, "BACKEND", "auto")
    loss_a, ga, masks, k4, k4b = _merlot_step(model, batch, cuda)
    assert (k4, k4b) == (15, 15) and len(masks) == 12
    monkeypatch.setattr(cuda_groupnorm, "BACKEND", "plain")
    loss_p, gp, _, k4, k4b = _merlot_step(model, batch, cuda, replay=masks)
    assert (k4, k4b) == (0, 0)
    assert abs(loss_a - loss_p) <= 1e-5 * abs(loss_p)
    assert ga.keys() == gp.keys()
    floor = 1e-6 * max(v.abs().max().item() for v in gp.values())
    for n, want in gp.items():
        err = (ga[n] - want).abs().max().item()
        assert err <= 2e-4 * want.abs().max().item() + floor, (n, err)


# K5: LayerNorm fused into J consumer products, bf16: at most BF16_ULPS bf16
# ulps of the largest |y| and BF16_MEAN_TOL on average (the same rounding
# points, fp32 sums in another order)
LN_SHAPES = [  # m, k, n, j
    (100, 768, 768, 3),              # a row tail
    (64, 128, 256, 1),
    (130, 256, 40, 2),               # N not a multiple of 128: tiles span consumers
    (4096, 768, 3072, 1),
    (3540, 768, 768, 3),             # the zero-shot joint tower's rows
    (11560, 768, 3072, 1),           # the zero-shot ViT's MLP rows
    (1, 768, 8, 1),                  # one row, one 8-column consumer
    (127, 1024, 768, 3),             # K = 1024: 64 rows per block
    (300, 832, 200, 2),
    (129, 64, 3072, 1),              # one k block
    (12672, 768, 384, 3),            # the joint tower at model=2: q|k|v N 1152
    (12672, 768, 1536, 1),           # and its MLP's half of 3072 columns
]


def _ln_inputs(cuda, m, k, n, j, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((m, k), generator=g, device=cuda)
         + torch.randn((m, 1), generator=g, device=cuda)).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(k, generator=g, device=cuda)
    beta = 0.1 * torch.randn(k, generator=g, device=cuda)
    ws = [0.02 * torch.randn((n, k), generator=g, device=cuda) for _ in range(j)]
    bs = [0.01 * torch.randn(n, generator=g, device=cuda) for _ in range(j)]
    return x, gamma, beta, ws, bs


@pytest.mark.parametrize("m,k,n,j", LN_SHAPES)
def test_ln_matmul_kernel_matches_plain(cuda, m, k, n, j):
    x, gamma, beta, ws, bs = _ln_inputs(cuda, m, k, n, j)
    before = cuda_ln_matmul.launches
    y = cuda_ln_matmul.ln_matmul_cuda(x, gamma, beta, torch.cat(ws).bfloat16(),
                                      torch.cat(bs).bfloat16(), num_out=j, epsilon=1e-5)
    torch.cuda.synchronize()
    assert cuda_ln_matmul.launches == before + 1
    ref = torch.stack(norms.ln_matmul_plain(x, gamma, beta, ws, bs))
    assert y.shape == (j, m, n) and y.dtype == torch.bfloat16
    diff = (y.float() - ref.float()).abs()
    assert diff.max().item() <= _bf16_bound(ref.float())
    assert diff.mean().item() <= BF16_MEAN_TOL


def test_fused_norm_kernels_are_deterministic(cuda):
    """K4 (a cluster of 16, streamed rows) and K5 (a persistent walk with row
    tails) give the same bits run to run."""
    x, gamma, beta, r = _gn_inputs(cuda, 2, 16896, 64, torch.bfloat16, True)
    kw = dict(num_groups=32, epsilon=1e-4, relu=True)
    a = cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, r, **kw)
    b = cuda_groupnorm.group_norm_act_cuda(x, gamma, beta, r, **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    x, gamma, beta, ws, bs = _ln_inputs(cuda, 3540, 768, 768, 3)
    w, bias = torch.cat(ws).bfloat16(), torch.cat(bs).bfloat16()
    y1, y2 = (cuda_ln_matmul.ln_matmul_cuda(x, gamma, beta, w, bias, num_out=3, epsilon=1e-5)
              for _ in range(2))
    assert torch.equal(y1, y2)


def test_ln_matmul_kernel_refuses_bad_inputs(cuda):
    x, gamma, beta, ws, bs = _ln_inputs(cuda, 64, 128, 128, 1)
    w, b = ws[0].bfloat16(), bs[0].bfloat16()
    kw = dict(num_out=1, epsilon=1e-5)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_ln_matmul.ln_matmul_cuda(x.float(), gamma, beta, ws[0], bs[0], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ln_matmul.ln_matmul_cuda(x.t().contiguous().t(), gamma, beta, w, b, **kw)
    # contiguous but misaligned views, as slices of a flat parameter buffer
    # give: gamma and beta are read 16 bytes at a time, the bias 4
    flat = torch.empty(2 * 128 + 1, device=cuda)
    g1 = flat[1:129].copy_(gamma)
    with pytest.raises(ValueError, match="aligned"):
        cuda_ln_matmul.ln_matmul_cuda(x, g1, beta, w, b, **kw)
    b1 = flat[129:].copy_(beta)
    with pytest.raises(ValueError, match="aligned"):
        cuda_ln_matmul.ln_matmul_cuda(x, gamma, b1, w, b, **kw)
    flat16 = torch.empty(129, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cuda_ln_matmul.ln_matmul_cuda(x, gamma, beta, w, flat16[1:].copy_(b), **kw)
    x, gamma, beta, ws, bs = _ln_inputs(cuda, 64, 96, 128, 1)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_ln_matmul.ln_matmul_cuda(x, gamma, beta, ws[0].bfloat16(), bs[0].bfloat16(),
                                      **kw)


def test_ln_matmul_autograd_runs_the_kernel(cuda):
    """LnMatmul on CUDA tensors launches K5 once; its backward (bf16
    operands, fp32 products through torch.mm's out_dtype) matches the same
    Function on CPU copies (products on widened operands)."""
    x, gamma, beta, ws, bs = _ln_inputs(cuda, 200, 256, 128, 3)
    dys = [torch.randn((200, 128), device=cuda).bfloat16() for _ in range(3)]
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, gamma, beta, *ws, *bs)]
        before = cuda_ln_matmul.launches
        ys = cuda_ln_matmul.ln_matmul(leaves[0], leaves[1], leaves[2], leaves[3:6],
                                      leaves[6:])
        assert cuda_ln_matmul.launches == before + (dev.type == "cuda")
        grads.append(torch.autograd.grad(ys, leaves, [d.to(dev) for d in dys]))
    for a, r in zip(*grads):
        err = (a.float().cpu() - r.float()).abs().max().item()
        if r.dtype == torch.bfloat16:      # dx, rounded once from fp32
            assert err <= _bf16_bound(r.float())
        else:                              # fp32 sums in another order
            assert err <= 1e-4 * r.abs().max().item()
