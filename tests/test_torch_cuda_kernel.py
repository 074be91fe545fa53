"""The hand-written attention kernels (K1 forward, K2 backward, K3 over the
stacked KV cache) against their plain PyTorch versions, on a CUDA card. Marked ``gpu``; skipped where no card is present. Run on the
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
cache rows past the position.
"""

import math

import pytest
import torch

from merlot_tpu_torch.ops import cuda_attention
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


# K3: cached attention over the stacked KV cache, fp32 inputs 1e-5, bf16
# inputs the bounds of K1 (the same rounding points, sums in another order)
STACKED_SHAPES = [  # b, sq, sk, h, d, shared mask
    (8, 1, 1537, 16, 64, True),      # the server's decode step
    (1, 1, 300, 4, 64, False),
    (2, 5, 100, 2, 32, True),        # decode kernel, several query rows
    (3, 8, 77, 3, 128, False),
    (2, 40, 129, 4, 64, True),       # prefill: K1's tiled kernels
    (1, 17, 2048, 2, 128, False),
]
STACKED_CASES = [(dt, sm, *shape) for dt, sm in [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)]
    for shape in STACKED_SHAPES]


def _stacked_inputs(cuda, b, sq, sk, h, d, dtype, shared, seed=0):
    """q, a stacked cache whose rows past the last query's position are
    zero, and the causal mask over cache positions ([1, Sq, Sk] if shared)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h * d), generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, sk, 2 * h * d), generator=g, device=cuda).to(dtype)
    pos0 = max(sk // 2 - sq, 0)
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
