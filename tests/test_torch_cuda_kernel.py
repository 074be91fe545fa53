"""The hand-written kernels (attention: K1 forward, K2 backward, K3 over the
stacked KV cache; K4 the fused GroupNorm; K5 the LayerNorm fused into its
consumer products) against their plain PyTorch versions, on a CUDA card. Marked ``gpu``; skipped where no card is present. Run on the
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
            q.data_ptr(), kv.data_ptr(), mask.data_ptr(), out.data_ptr(), 2, 1, 64, bad,
            2, 64, 0, 1, 1, 8, 0.125, stream)
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
    """GroupNormAct on CUDA tensors launches K4 once, and its saved-stats
    backward matches autograd through the unfused composition (fp32)."""
    x, gamma, beta, r = _gn_inputs(cuda, 2, 300, 128, torch.float32, True)
    dy = torch.randn_like(x)
    grads = []
    for backend in ("cuda", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta, r)]
        before = cuda_groupnorm.launches
        out = cuda_groupnorm.group_norm_act(*leaves[:3], residual=leaves[3], relu=True,
                                            backend=backend)
        assert cuda_groupnorm.launches == before + (backend == "cuda")
        grads.append(torch.autograd.grad(out, leaves, dy))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


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
