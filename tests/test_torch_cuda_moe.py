"""The DeepSeek-V3 block's kernels on the card against their plain versions:
K1 and K2 at MLA's heads (Q.K 192, V 128, fp32 softmax; causal at Sq = Sk
= 4096, and with a mask tensor), the routing kernel (``csrc/moe_route.cu``)
and the held experts' products (``nn/moe.HeldExperts``: ``torch._grouped_mm``
and ``ops/moe_experts.py``'s row kernels, which stop at the rows in use). Marked ``gpu``; skipped where no card is present.
Run on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_moe.py`` (tests/conftest.py imports jax, which the
GPU machine may lack).

Tolerances:
  * K1's context and K2's gradients within 1e-2 of each output's largest:
    the kernels take exp from ex2.approx (a few fp32 ulps) and round P to
    bf16 for P.V as the plain path does, so one bf16 ulp of a product moves
    where an exp lands on the other side of a rounding; K1's saved row max
    and sum within 1e-5 relative (fp32 sums in another order, the exps a
    few ulps apart);
  * the routing: the same picks, counts, offsets and layout exactly (the
    kernel's sigmoid, 1 / (1 + expf(-x)), is torch's on the card); the
    weights within 1e-6 relative (the chosen scores' sum in another order);
  * the grouped products within 1e-2 of the largest (bf16 products, fp32
    sums in another order), the weights' gradients likewise.
"""

import pytest
import torch

from merlot_tpu_torch.nn import moe as moe_nn
from merlot_tpu_torch.ops.attention import causal_mask
from merlot_tpu_torch.ops import cuda_attention as ca
from merlot_tpu_torch.ops import moe_route

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def close(got, want, rel):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.parametrize("b,s,h,causal", [(2, 4096, 4, True), (1, 200, 3, True),
                                          (2, 320, 2, False)])
def test_k1_k2_at_mla_heads(cuda, b, s, h, causal):
    g = torch.Generator(device=cuda).manual_seed(s + h)
    d, dv = ca.MLA_DIMS
    q, k = (torch.randn(b, s, h * d, generator=g, device=cuda).bfloat16() for _ in range(2))
    v = torch.randn(b, s, h * dv, generator=g, device=cuda).bfloat16()
    do = torch.randn(b, s, h * dv, generator=g, device=cuda).bfloat16()
    mask = None if causal else (torch.rand(b, s, s, generator=g, device=cuda) > 0.2).float()
    kw = dict(num_heads=h, softmax_fp32=True)
    stats = ca.new_stats(q, h)
    out, _ = ca.attention_fwd_cuda(q, k, v, mask, collect_colsum=False, stats=stats,
                                   causal=causal, **kw)
    ref, _ = ca.flash_attention_plain(q, k, v, mask, collect_colsum=False, causal=causal, **kw)
    assert out.shape == (b, s, h * dv)
    close(out, ref, 1e-2)
    full = mask if not causal else causal_mask(s, s, cuda).expand(b, s, s).contiguous()
    want = ca.softmax_stats_plain(q, k, full, **kw)
    torch.testing.assert_close(stats[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(stats[1], want[1], rtol=1e-5, atol=0)
    got = ca.attention_bwd_cuda(q, k, v, mask, do, None, stats=stats, causal=causal, **kw)
    again = ca.attention_bwd_cuda(q, k, v, mask, do, None, stats=stats, causal=causal, **kw)
    want = ca.attention_bwd_plain(q, k, v, mask, do, None, causal=causal, **kw)
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)           # deterministic
        close(a, w, 1e-2)


def test_mla_kernels_refuse_what_they_do_not_take(cuda):
    d, dv = ca.MLA_DIMS
    q = torch.zeros(1, 128, 2 * d, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(1, 128, 2 * dv, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):   # no colsum with causal
        ca.attention_fwd_cuda(q, q, v, None, num_heads=2, softmax_fp32=True,
                              collect_colsum=True, causal=True)
    with pytest.raises(ValueError):   # causal needs Sq = Sk
        ca.attention_fwd_cuda(q[:, :64], q, v, None, num_heads=2, softmax_fp32=True,
                              collect_colsum=False, causal=True)
    with pytest.raises(ValueError):   # fp32 has no MLA route
        ca.attention_fwd_cuda(q.float(), q.float(), v.float(), None, num_heads=2,
                              softmax_fp32=True, collect_colsum=False, causal=True)


@pytest.mark.parametrize("t,e,k,s,held", [(8192, 64, 6, 4096, (0, 8)), (300, 8, 2, 100, (2, 4)),
                                          (64, 64, 6, 32, (56, 8))])
def test_routing_kernel(cuda, t, e, k, s, held):
    g = torch.Generator(device=cuda).manual_seed(t + e)
    logits = 0.3 * torch.randn(t, e, generator=g, device=cuda)
    logits[::7] = 0.1                     # whole rows of ties
    bias = 1e-3 * torch.randint(-2, 3, (e,), generator=g, device=cuda).float()
    b1 = bias.clone()
    got = moe_route.route_cuda(logits, b1, top_k=k, seq_len=s, held=held, scale=2.446)
    want = moe_route.route_plain(logits, bias, top_k=k, seq_len=s, held=held, scale=2.446)
    for name in ("idx", "counts", "seq_counts", "offs", "row_tk", "stats"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.weights, want.weights, rtol=1e-6, atol=0)
    assert torch.equal(b1, bias)          # the bias is only read
    assert float(got.stats[1]) == 0.0


@pytest.mark.parametrize("t,h,k,held", [(8192, 2048, 6, (0, 8)), (300, 64, 2, (2, 4))])
def test_gather_kernel(cuda, t, h, k, held):
    g = torch.Generator(device=cuda).manual_seed(t)
    logits = torch.randn(t, 16, generator=g, device=cuda)
    r = moe_route.route_plain(logits, torch.zeros(16, device=cuda), top_k=k, seq_len=t,
                              held=held, scale=1.0)
    y = torch.randn(t, h, generator=g, device=cuda).bfloat16()
    end = int(r.offs[-1])
    x = moe_route.gather(y, r.row_tk, r.offs[-1:], k)
    token = (r.row_tk[:end] // k).long()
    want = torch.cat([y, y.new_zeros(1, h)]).index_select(0, token)
    assert torch.equal(x[:end], want)     # a copy: bit for bit, 0 on pad rows
    with pytest.raises(ValueError):
        moe_route.gather(y.float(), r.row_tk, r.offs[-1:], k)


@pytest.mark.parametrize("t,hidden,width,e,k,held,empty", [
    (1024, 256, 128, 16, 4, (4, 8), None), (500, 192, 96, 8, 2, (0, 4), 1),
    (4096, 2048, 1408, 64, 6, (0, 8), None)])
def test_held_experts_grouped_products(cuda, t, hidden, width, e, k, held, empty):
    g = torch.Generator(device=cuda).manual_seed(7)
    logits = torch.randn(t, e, generator=g, device=cuda)
    if empty is not None:   # a held expert no token picks: an empty group
        logits[:, held[0] + empty] = -30.0
    r = moe_route.route_cuda(logits, torch.zeros(e, device=cuda), top_k=k, seq_len=t,
                             held=held, scale=1.5)
    y = torch.randn(t, hidden, generator=g, device=cuda).bfloat16().requires_grad_()
    weights = r.weights.clone().requires_grad_()
    w_gu = (0.05 * torch.randn(held[1], 2 * width, hidden, generator=g, device=cuda)
            ).bfloat16().requires_grad_()
    w_dn = (0.05 * torch.randn(held[1], hidden, width, generator=g, device=cuda)
            ).bfloat16().requires_grad_()
    out = moe_nn.HeldExperts.apply(y, weights, w_gu, w_dn, r.row_tk, r.offs, k)
    go = torch.randn(t, hidden, generator=g, device=cuda)
    grads = torch.autograd.grad(out, (y, weights, w_gu, w_dn), go)
    # a plain loop over the held experts' tokens
    leaves = [x.detach().clone().requires_grad_() for x in (y, weights, w_gu, w_dn)]
    yy, ww, gu, dn = leaves
    want = torch.zeros(t, hidden, device=cuda)
    for i in range(held[1]):
        rows, cols = torch.nonzero(r.idx == held[0] + i, as_tuple=True)
        x = yy[rows]
        act = moe_nn.swiglu(x @ gu[i].t())
        want = want.index_add(0, rows, (act @ dn[i].t()).float() * ww[rows, cols][:, None])
    want_grads = torch.autograd.grad(want, leaves, go)
    close(out, want, 1e-2)
    for a, b in zip(grads, want_grads):
        close(a, b, 1e-2)
