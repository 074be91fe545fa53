"""The Moonlight cell (``traffic/moe_lm_train.py``) end to end at a CPU
size: the harness's run (set-up, a window, the release, the check) comes
out correct on a sound program and not correct with a fault planted in
it: the correction bias ignored in the choice, the shared experts left
out, a step that leaves its state unchanged. Its readers find nothing in
an empty trace, and its operation counts against hand counts.

The size: hidden 64, 4 heads, MLA's latent 32 and heads of 16 + 8 and 16,
8 routed experts (4 held) choosing 2 and 1 shared of width 32, 3 layers,
a vocabulary slice of 512, 2 rows of 64; the configuration's own
precision (bf16 products) and init std. The limits are the cell's own,
but for the gradients and the change, whose bf16 rounding at this width is
not the full size's: those take ``TINY_LIMITS`` (a sound run here reads
1.6e-3 and 8.9e-4 on them; a state left unchanged reads 1).
"""

import copy
import time

import pytest
import torch

from benchmark.harness import counts_moe, registry
from benchmark.harness.cell import Context
from benchmark.harness.measure import Readings, run_cell

WORKLOAD = "moonlight-16b-a3b-ep8.train"
BENCH = registry.benchmark()
SEED = 2 ** 31 + 11
TINY = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=8, experts_held=[2, 4], num_experts_per_tok=2,
            n_shared_experts=1, vocab_size=512, max_position_embeddings=128)
TINY_LIMITS = dict(grad_gap=0.1, change_gap=0.1)


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    wl = registry.workload(WORKLOAD)
    c = copy.deepcopy(registry.config(wl["config"]))
    c["model"].update(TINY)
    params = dict(wl["params"], batch=2, seq=64)
    limits = dict(wl["limits"], **TINY_LIMITS)
    ctx = Context(config=c, params=params, limits=limits, seed=SEED,
                  device=torch.device("cpu"))
    return registry.traffic(wl["traffic"]).Cell(ctx)


def run():
    return run_cell(tiny_cell(), registry.workload(WORKLOAD),
                    registry.cell_metrics(BENCH, WORKLOAD), seconds=0.3, trace=False,
                    t_start=time.perf_counter())


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["checks"]["bias_gap"]["value"] == 0.0
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}


def test_bias_ignored_in_the_choice(monkeypatch):
    from merlot_tpu_torch.ops import moe_route
    route = moe_route.route_plain

    def unbiased(logits, bias, **kw):
        return route(logits, torch.zeros_like(bias), **kw)
    monkeypatch.setattr(moe_route, "route_plain", unbiased)
    res = run()
    assert not res["correct"], res["checks"]


def test_shared_experts_left_out(monkeypatch):
    from merlot_tpu_torch.nn import moe
    monkeypatch.setattr(moe.SwiGLUMLP, "forward", lambda self, x: torch.zeros_like(x)
                        if self.gate_proj.shape[0] == 32 else _swiglu(self, x))
    res = run()
    assert not res["correct"], res["checks"]


def _swiglu(self, x):
    import torch.nn.functional as F
    x = x.to(torch.bfloat16)
    gate = F.linear(x, self.gate_proj.to(torch.bfloat16))
    up = F.linear(x, self.up_proj.to(torch.bfloat16))
    return F.linear((F.silu(gate.float()) * up.float()).to(torch.bfloat16),
                    self.down_proj.to(torch.bfloat16))


def test_state_left_unchanged(monkeypatch):
    from merlot_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.MerlotAdamW, "update", lambda self, *a, **kw: {})
    res = run()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("metric", [
    "mla_ms.moe_train", "route_ms.moe_train", "experts_ms.moe_train", "shared_ms.moe_train",
    "expert_load.moe_train", "k1_mla_roofline.moe_train", "k2_mla_roofline.moe_train",
    "route_roofline.moe_train"])
def test_readers_find_nothing_in_an_empty_trace(metric, monkeypatch):
    from merlot_tpu_torch.core import trace
    trace.clear()
    monkeypatch.setattr(counts_moe, "MLA", None)
    monkeypatch.setattr(counts_moe, "ROUTE", None)
    r = Readings(trace={"steps": 2, "family_s_per_step": {}, "busy_s": 0.0, "window_s": 1.0,
                        "launches_per_step": 0},
                 calls={"k1": [], "k2": []}, optimizer_ms=None, flops_per_step=0.0,
                 peak_flops=1.0, window={"steps": 0, "seconds": 1.0, "work": 0})
    assert registry.reader(metric).read(r) is None
    counts_moe.describe({"d_qk": 192, "d_v": 128}, {"tokens": 8192, "experts": 64,
                                                    "top_k": 6, "held": 8, "seq": 4096,
                                                    "layers": 26})
    assert registry.reader(metric).read(r) is None


def test_mla_and_route_counts():
    flops, nbytes = counts_moe.mla_attn_work(2, 4096, 16, 192, 128, backward=False)
    pairs = 2 * 4096 * 4097 // 2
    assert flops == 2 * 16 * pairs * (192 + 128)
    assert nbytes == 2 * 4096 * 16 * 2 * (2 * 192 + 2 * 128)
    bflops, bbytes = counts_moe.mla_attn_work(2, 4096, 16, 192, 128, backward=True)
    assert bflops == 2 * 16 * pairs * (3 * 192 + 2 * 128)
    assert bbytes == 2 * 4096 * 16 * 2 * (4 * 192 + 3 * 128)
    rows = 8192 * 6 + 8 * 15
    want = 4 * (8192 * 64 + 64) + 4 * (2 * 8192 * 6 + 64 + 2 * 64 + 8 + rows + 3 + 64)
    assert counts_moe.route_bytes(8192, 64, 6, 8, 4096) == want
    # the step at the cell's size: ~68 TFLOP (the held experts at an even share)
    from benchmark.traffic.moe_lm_train import model_keys
    step = 3 * counts_moe.moe_lm_forward_flops(model_keys(registry.config(
        "moonlight-16b-a3b-ep8")), 2, 4096)
    assert 60e12 < step < 75e12
