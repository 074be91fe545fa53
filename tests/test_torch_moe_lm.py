"""The DeepSeek-V3 block's LM in the port (models/moe_lm.py, nn/moe.py,
ops/moe_route.py, MLA's attention through ops/cuda_attention.py's plain
versions) against the benchmark's plain reference
(benchmark/reference/moe_lm.py) on the CPU, with seeded random weights at
a tiny size: hidden 64, 4 heads, Q.K 24 (16 + 8 rope), V 16, latent 32, 8
experts of width 32 choosing 2 plus 1 shared, 3 layers (1 dense of 128),
vocab 512.

Tolerances:
  * the reference rounds the sites the port computes in bf16 (``Precision
    ('bf16')``), so the two differ by the order of fp32 sums and a rare
    double rounding (F.linear rounded once against fp32-then-bf16): logits
    within 2e-2 of their largest (a bf16 ulp of the logits is 4e-3 of it,
    and three layers carry a flip or two), the loss 2e-3 relative;
  * the gradients by tensor: 3e-2 of each tensor's largest, plus 1e-3 of
    the largest of all (bf16's rounding of activations moves a gradient by
    a few of its ulps);
  * the parameters' change after 3 AdamW steps by its norm, leaf by leaf,
    1e-2 relative (Adam divides by the root of the second moment, so an
    element whose gradient is rounding noise moves by +-lr on either side:
    elementwise the change differs by up to 1.5 lr, its norm by 4e-3);
  * the correction biases exactly (each step moves them by 1e-3 times a
    sign of integer counts, the same counts);
  * the expert shares' sum against the uncut layer 1e-6 of its largest
    (the same bf16 products, fp32 sums in another order), and against the
    reference's uncut layer in bf16 2e-2 of its largest;
  * the plain attention at d_v != d_qk against autograd through a dense
    float32 attention 1e-5 (the same fp32 operations in another order);
  * routing: the same picks, weights within 1e-6 relative.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import moe_lm as ref
from benchmark.reference.adamw import AdamW as RefAdamW
from benchmark.reference.nn import Precision
from merlot_tpu_torch.core import trace
from merlot_tpu_torch.models import moe_lm
from merlot_tpu_torch.nn import moe as moe_nn
from merlot_tpu_torch.ops import cuda_attention, moe_route
from merlot_tpu_torch.tools import grover_data, grover_train

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
            n_shared_experts=1, first_k_dense_replace=1, routed_scaling_factor=2.446,
            rms_norm_eps=1e-5, rope_theta=50000.0, max_position_embeddings=64,
            aux_loss_alpha=1e-4, bias_update_speed=1e-3, initializer_range=0.05)
B, S = 2, 32
OPT = dict(learning_rate=1e-3, num_train_steps=100, num_warmup_steps=0, weight_decay_rate=0.1,
           beta_1=0.9, beta_2=0.95, epsilon=1e-8, clip_norm=1.0,
           param_overrides=[[["gamma"], {"weight_decay_rate": 0.0}]])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(held=(0, 8), seed=0):
    cfg = moe_lm.MoeLMConfig(**TINY, experts_held=held)
    port = moe_lm.MoeLM(cfg)
    port.init_tree(torch.Generator().manual_seed(seed))
    c = dict(TINY, experts_held=list(held))
    reference = ref.MoeLM(c, Precision("bf16"))
    reference.load_state_dict(port.state_dict())
    return port, reference


def _ids(seed=0, b=B, s=S):
    # Zipf-like ids, so the routing is uneven
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.minimum(rng.zipf(1.3, (b, s + 1)) - 1, 511).astype(np.int64))


class _Picks:
    """Records the port's chosen experts per MoE layer call."""

    def __init__(self, monkeypatch):
        self.idx = []
        route = moe_route.route

        def rec(*a, **kw):
            r = route(*a, **kw)
            self.idx.append(r.idx.clone())
            return r
        monkeypatch.setattr(moe_route, "route", rec)


def _close(a, b, rel, floor=0.0):
    a, b = a.float(), b.float()
    tol = rel * b.abs().max() + floor
    assert (a - b).abs().max() <= tol, ((a - b).abs().max().item(), tol.item())


def test_forward_and_grads_match_reference(monkeypatch):
    port, reference = _models(held=(2, 4))
    picks = _Picks(monkeypatch)
    ids = _ids()
    logits, balance = port(ids[:, :-1])
    loss = torch.nn.functional.cross_entropy(logits.float().reshape(-1, 512),
                                             ids[:, 1:].reshape(-1)) + balance
    record = []
    r_logits, r_balance, _ = reference(ids[:, :-1], picks.idx, record)
    r_loss = torch.nn.functional.cross_entropy(r_logits.reshape(-1, 512),
                                               ids[:, 1:].reshape(-1)) + r_balance
    _close(logits, r_logits, 2e-2)
    assert abs(float(loss.detach() - r_loss.detach())) <= 2e-3 * abs(float(r_loss.detach()))
    # the reference's own choice agrees up to rounding at the boundary
    assert all(r["gap"] < 1e-3 for r in record), record
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    r_params = dict(reference.named_parameters())
    r_grads = torch.autograd.grad(r_loss, [r_params[n] for n in params])
    top = max(g.abs().max() for g in r_grads)
    for n, g, rg in zip(params, grads, r_grads):
        _close(g, rg, 3e-2, 1e-3 * top)


def test_three_adamw_steps_match_reference(monkeypatch):
    port, reference = _models(held=(0, 8))
    picks = _Picks(monkeypatch)
    opt = moe_lm.moe_lm_optimizer(OPT["learning_rate"], OPT["num_train_steps"],
                                  OPT["num_warmup_steps"])
    step = moe_lm.moe_lm_train_step(opt, device="cpu")
    state = opt.init(dict(port.named_parameters()))
    w0 = {n: p.detach().clone() for n, p in port.named_parameters()}
    batches = [{"input_ids": _ids(seed)} for seed in range(3)]
    losses = [float(step(port, state, b, None)["loss"]) for b in batches]
    r_opt = RefAdamW(OPT)
    r_params = dict(reference.named_parameters())
    r_losses = []
    for i, b in enumerate(batches):
        loss, counts = ref.lm_loss(reference, b, forced=picks.idx[2 * i:2 * i + 2])
        grads = dict(zip(r_params, torch.autograd.grad(loss, list(r_params.values()))))
        r_opt.update(r_params, grads)
        reference.update_biases(counts)
        r_losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, r_losses, rtol=2e-3)
    change = {n: p.detach() - w0[n] for n, p in port.named_parameters()}
    r_change = {n: p.detach() - w0[n] for n, p in reference.named_parameters()}
    for n in change:
        got, want = float(change[n].norm()), float(r_change[n].norm())
        assert abs(got - want) <= 1e-2 * want, (n, got, want)
    for n, bias in reference.biases().items():
        assert torch.equal(port.get_buffer(n), bias), n
        assert bias.abs().max() > 0


def test_expert_shares_add_up_to_the_uncut_layer():
    torch.manual_seed(1)
    h, w = TINY["hidden_size"], TINY["moe_intermediate_size"]
    args = (h, w, 8, 2, 1)
    uncut = moe_nn.MoE(*args, held=(0, 8), scale=2.446, bias_update_speed=0.0,
                       balance_alpha=0.0)
    for p in uncut.parameters():
        moe_nn.trunc_normal(p, 0.05, torch.Generator().manual_seed(p.numel()))
    uncut.eval()
    shares = []
    for first in range(0, 8, 2):
        share = moe_nn.MoE(*args, held=(first, 2), scale=2.446, bias_update_speed=0.0,
                           balance_alpha=0.0).eval()
        with torch.no_grad():
            share.router.copy_(uncut.router)
            share.experts_gate_up.copy_(uncut.experts_gate_up[first:first + 2])
            share.experts_down.copy_(uncut.experts_down[first:first + 2])
            for name, p in share.shared.named_parameters():
                p.copy_(uncut.shared.get_parameter(name))
        shares.append(share)
    y = torch.randn(B, S, h)
    with torch.no_grad():
        whole, _ = uncut(y)
        shared = uncut.shared(y.to(torch.bfloat16)).float()
        parts = sum(share(y)[0] - shared for share in shares) + shared
        _close(parts, whole, 1e-6)
        # the uncut reference layer computes the same sum
        c = dict(TINY, experts_held=[0, 8])
        r_layer = ref.MoE(c, Precision("bf16"))
        r_layer.load_state_dict(uncut.state_dict())
        r_out, _, _ = r_layer(y)
        _close(parts, r_out, 2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_mla_head_dims(causal):
    g = torch.Generator().manual_seed(2)
    b, s, h, d, dv = 2, 40, 3, 24, 16
    q, k = (torch.randn(b, s, h * d, generator=g) for _ in range(2))
    v = torch.randn(b, s, h * dv, generator=g)
    do = torch.randn(b, s, h * dv, generator=g)
    mask = None if causal else (torch.rand(b, s, s, generator=g) > 0.3).float()
    out, _ = cuda_attention.flash_attention_plain(q, k, v, mask, num_heads=h,
                                                  softmax_fp32=True, collect_colsum=False,
                                                  causal=causal)
    dq, dk, dv_ = cuda_attention.attention_bwd_plain(q, k, v, mask, do, None, num_heads=h,
                                                     softmax_fp32=True, causal=causal)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qq.view(b, s, h, d), kk.view(b, s, h, d)) / d ** 0.5
    m = torch.ones(s, s).tril()[None] if causal else mask
    sc = sc * m[:, None] - 1e10 * (1 - m[:, None])
    dense = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vv.view(b, s, h, dv))
    dense = dense.reshape(b, s, h * dv)
    gq, gk, gv = torch.autograd.grad(dense, (qq, kk, vv), do)
    for got, want in ((out, dense), (dq, gq), (dk, gk), (dv_, gv)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attention_core_routes_mla_heads():
    q, k = torch.randn(1, 8, 2, 24), torch.randn(1, 8, 2, 24)
    v = torch.randn(1, 8, 2, 16)
    out, _ = moe_lm.attention_core(q, k, v, None, causal=True, backend="plain")
    assert out.shape == (1, 8, 2, 16)
    # the kernels take MLA's heads at (192, 128) only: another pair raises
    with pytest.raises(ValueError, match="kernels do not take"):
        moe_lm.attention_core(q.bfloat16(), k.bfloat16(), v.bfloat16(), None, causal=True,
                              backend="cuda")


def _route_loop(logits, bias, k, held, scale):
    """The routing token by token: the K best of s + bias (ties to the lower
    expert), the weights, the held experts' rows."""
    s = torch.sigmoid(logits)
    picks, weights = [], []
    for t in range(s.shape[0]):
        order = sorted(range(s.shape[1]), key=lambda e: (-float(s[t, e] + bias[e]), e))[:k]
        picks.append(order)
        tot = sum(float(s[t, e]) for e in order)
        weights.append([float(s[t, e]) / tot * scale for e in order])
    rows = {e: [t * k + j for t in range(len(picks)) for j, pe in enumerate(picks[t]) if pe == e]
            for e in range(held[0], held[0] + held[1])}
    return picks, weights, rows


def test_routing_and_permutation_match_a_token_loop():
    g = torch.Generator().manual_seed(3)
    t, e, k, held = 96, 8, 3, (2, 4)
    logits = torch.randn(t, e, generator=g)
    logits[::5] = 0.25          # whole rows of ties
    logits[1::7, 3] = logits[1::7, 4]
    bias = torch.zeros(e)
    bias[5] = 1e-3
    r = moe_route.route_plain(logits, bias.clone(), top_k=k, seq_len=32, held=held,
                              scale=2.446)
    picks, weights, rows = _route_loop(logits, bias, k, held, 2.446)
    assert r.idx.tolist() == picks
    torch.testing.assert_close(r.weights, torch.tensor(weights), rtol=1e-6, atol=0)
    start = 0
    for i, l in enumerate(range(held[0], held[0] + held[1])):
        got = r.row_tk[start:start + len(rows[l])].tolist()
        assert got == rows[l]
        end = int(r.offs[i])
        assert end == start + -(-len(rows[l]) // moe_route.ALIGN) * moe_route.ALIGN
        assert (r.row_tk[start + len(rows[l]):end] == t * k).all()
        start = end
    assert (r.row_tk[start:] == t * k).all()
    assert r.row_tk.numel() == moe_route.held_rows(t, k, held[1])
    counts = torch.bincount(torch.tensor(picks).reshape(-1), minlength=e)
    assert torch.equal(r.counts.long(), counts)
    assert torch.equal(r.seq_counts.sum(0).long(), counts)
    n_held = sum(len(v) for v in rows.values())
    assert r.stats.tolist()[:2] == [n_held, 0.0]
    # the routing only reads the bias; the layer's update moves it by
    # sign(mean load - load) * gamma, exact
    assert torch.equal(r.counts, moe_route.route_plain(
        logits, bias, top_k=k, seq_len=32, held=held, scale=2.446).counts)
    layer = moe_nn.MoE(16, 8, e, k, 1, held=held, scale=2.446, bias_update_speed=1e-3,
                       balance_alpha=0.0)
    with torch.no_grad():
        layer.e_score_correction_bias.copy_(bias)
    layer.loads = r.counts
    layer.update_bias()
    want = bias + 1e-3 * torch.sign(counts.sum() - e * counts).float()
    assert torch.equal(layer.e_score_correction_bias, want) and layer.loads is None


def test_bias_moves_once_a_step_by_the_steps_loads():
    torch.manual_seed(5)
    layer = moe_nn.MoE(16, 8, 8, 2, 1, held=(0, 4), scale=2.446, bias_update_speed=1e-3,
                       balance_alpha=0.0)
    for p in layer.parameters():
        moe_nn.trunc_normal(p, 0.5, torch.Generator().manual_seed(p.numel()))
    y1, y2 = torch.randn(2, 16, 16), torch.randn(2, 16, 16)
    with torch.no_grad():
        layer.eval()
        layer(y1)                          # an evaluation forward adds no load
        assert layer.loads is None
        layer.train()
        layer(y1)
        layer(y1)                          # a second forward (a recompute, a micro-batch)
        bias = layer.e_score_correction_bias.clone()
        assert torch.equal(bias, torch.zeros(8))   # nothing moves inside the forwards
        loads = layer.loads.clone()
        layer.update_bias()
    r = moe_route.route_plain(F.linear(y1.reshape(32, 16), layer.router), torch.zeros(8),
                              top_k=2, seq_len=16, held=(0, 4), scale=2.446)
    assert torch.equal(loads, 2 * r.counts)
    want = 1e-3 * torch.sign(loads.sum() - 8 * loads).float()
    assert torch.equal(layer.e_score_correction_bias, want)
    layer.update_bias()                    # no forward since: no move
    assert torch.equal(layer.e_score_correction_bias, want)
    with torch.no_grad():
        layer(y2)
    assert not torch.equal(layer.loads, loads)


def test_route_weights_gradient():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(16, 8, generator=g, dtype=torch.float64).float().requires_grad_()
    r = moe_route.route(logits, torch.zeros(8), top_k=3, seq_len=16, held=(0, 8), scale=2.0)
    gw = torch.randn(16, 3, generator=g)
    (got,) = torch.autograd.grad(r.weights, logits, gw)
    x = logits.detach().clone().requires_grad_()
    sel = torch.sigmoid(x).gather(1, r.idx.long())
    (want,) = torch.autograd.grad(sel / sel.sum(-1, keepdim=True) * 2.0, x, gw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_counters_null_without_a_profiler_and_read_after_the_window(monkeypatch):
    trace.clear()
    with trace.span("step"):
        trace.count("moe.tokens_held", torch.tensor(5.0))
    assert trace.counted() == []
    held = []
    from torch.profiler import ProfilerActivity, profile

    def no_read(self, *a, **kw):
        raise AssertionError("a counter was read inside the step")
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.Tensor, "item", no_read)
        monkeypatch.setattr(torch.Tensor, "__float__", no_read)
        with trace.span("step"):
            for v in (3.0, 4.0):
                t = torch.tensor(v)
                held.append(t)
                trace.count("moe.load_max_over_mean", t)
        monkeypatch.undo()
    got = trace.counted()
    assert got == [{"moe.load_max_over_mean": [3.0, 4.0]}]
    trace.clear()


def test_model_counters_and_spans_in_a_traced_step():
    port, _ = _models(held=(0, 4))
    trace.clear()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("step"):
            with trace.span("step.forward"):
                moe_lm.moe_lm_loss(port, {"input_ids": _ids()})
    (spans,) = trace.recorded()
    names = {s.name for s in spans}
    assert {"model.mla", "model.moe.route", "model.moe.experts",
            "model.moe.shared"} <= names
    assert all(s.parent == "step.forward" for s in spans if s.name.startswith("model."))
    (counters,) = trace.counted()
    assert counters["moe.dropped"] == [0.0, 0.0]
    assert all(v > 0 for v in counters["moe.tokens_held"])
    assert all(v >= 1.0 for v in counters["moe.load_max_over_mean"])
    trace.clear()


def test_config_from_moonlight_keys():
    moonlight = {"model_type": "deepseek_v3", "hidden_size": 2048, "num_hidden_layers": 27,
                 "n_routed_experts": 64, "num_experts_per_tok": 6, "q_lora_rank": None,
                 "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
                 "topk_group": 1, "norm_topk_prob": True, "experts_held": [0, 8],
                 "num_nextn_predict_layers": 0, "ep_size": 1}
    cfg = moe_lm.MoeLMConfig.from_dict(moonlight)
    assert cfg.held == (0, 8) and cfg.qk_head_dim == 192
    with pytest.raises(ValueError, match="scoring_func"):
        moe_lm.MoeLMConfig.from_dict(dict(moonlight, scoring_func="softmax"))


def test_cli_trains_deepseek_v3_from_an_lm_shard(tmp_path):
    seq = 32
    rng = np.random.default_rng(5)
    grover_data.write_lm_shard(str(tmp_path / "lm.tfrecord"),
                               [rng.integers(0, 512, seq + 1).tolist() for _ in range(8)], seq)
    cfg = dict(TINY, model_type="deepseek_v3", experts_held=[0, 4], q_lora_rank=None)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))

    def argv(steps):
        return ["--config", str(tmp_path / "cfg.json"), "--train_files",
                str(tmp_path / "*.tfrecord"), "--output_dir", str(tmp_path / "out"),
                "--seq_length", str(seq), "--batch_size", "2", "--num_train_steps", str(steps),
                "--num_warmup_steps", "0", "--learning_rate", "1e-3", "--checkpoint_every",
                "1", "--log_every", "1", "--device", "cpu"]
    out = grover_train.main(argv(2))
    assert int(out["opt_state"]["step"]) == 2
    model = out["trainer"].model
    assert isinstance(model, moe_lm.MoeLM)
    bias = model.layers[1].mlp.e_score_correction_bias.clone()
    assert bias.abs().max() > 0
    assert os.path.isdir(tmp_path / "out" / "checkpoints" / "ckpt_2")
    # a third step resumes from ckpt_2, correction biases included
    again = grover_train.main(argv(3))
    assert int(again["opt_state"]["step"]) == 3
    resumed = again["trainer"].model.layers[1].mlp.e_score_correction_bias
    assert ((resumed - bias).abs() <= 1e-3 + 1e-9).all() and not torch.equal(resumed, 0 * bias)
