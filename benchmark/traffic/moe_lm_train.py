"""Training steps of the DeepSeek-V3 block's LM (``models/moe_lm.py``) as
one share of an expert-parallel deployment, back to back (a closed loop).

Each step is the one ``tools/grover_train.py`` builds for a deepseek_v3
config: ``moe_lm_train_step(moe_lm_optimizer(...))``, the next-token loss
and the balance losses, the backward, the multi-tensor AdamW, then the
correction biases' update. Parameters:

    batch, seq      rows a step and tokens a row (the rows hold seq + 1 ids:
                    packed documents, every position filled, one causal
                    mask over the row)
    zipf_s          the ids' Zipf exponent over the vocabulary's slice (id
                    r - 1 has probability r^-s over the sum), as text's
                    are, so the routing is uneven
    distinct        distinct batches, made from the seed (the first
                    ``check_steps`` steps all differ)
    check_steps     steps the reference follows

The configuration's file gives the catalog's keys at the top level, with
``n_routed_experts`` the experts held here; its ``model`` block overrides
them for the port: ``n_routed_experts`` the router's width,
``experts_held`` the held range, the assumed balance and init values.

The check (beside ``TrainingCell``'s): the reference takes the program's
chosen experts for the checked steps and reports, over the MoE layers and
steps, the share of tokens whose own fp32 choice differs
(``route_flip_share``) and the largest gap of its biased scores at the
boundary there (``route_gap``): its hidden states are not the program's
bf16-rounded ones, so a choice near the boundary moves. The routing step
itself is held exactly: the plain routing of the program's own router
logits and correction bias at each call must pick what the program picked,
up to the boundary gap ``route_step_gap`` (the kernel's sigmoid against
torch's: ulps). Then the correction biases after the checked steps
(``bias_gap``, in units of the update's step gamma). The
weights are drawn from the seed again for the parameters' change instead
of kept beside the state: at 2.78 B parameters a second copy does not fit
beside the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from benchmark.harness import compare, counts, counts_moe
from benchmark.harness.cell import (TrainingCell, free_cuda, generator, step_seed)
from benchmark.harness.weights import load_into, make_weights, param_shapes

def model_keys(config: Dict[str, Any]) -> Dict[str, Any]:
    """The port's configuration from the file: the catalog's numbers at
    the top level under the ``model`` block's (the router over all the
    routed experts, ``experts_held`` of them here, the assumed balance and
    init values)."""
    keys = {k: v for k, v in config.items()
            if not isinstance(v, (dict, list)) or k == "experts_held"}
    keys.update(config["model"])
    return keys


def zipf_batches(dev, seed: int, *, n: int, batch: int, seq: int, vocab: int, s: float
                 ) -> List[Dict[str, torch.Tensor]]:
    ranks = torch.arange(1, vocab + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -s, 0)
    cdf = (cdf / cdf[-1]).float()
    out = []
    for k in range(n):
        g = generator(dev, step_seed(seed, k, salt=3))
        u = torch.rand((batch, seq + 1), generator=g, device=dev)
        ids = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
        out.append({"input_ids": ids.int()})
    return out


class _Picks:
    """The program's routing calls, per step and MoE layer, while on: the
    router logits and correction bias each call took, and its picks."""

    def __init__(self):
        self.steps: List[List[torch.Tensor]] = []
        self.inputs: List[List[tuple]] = []

    def __enter__(self):
        from merlot_tpu_torch.ops import moe_route
        self.module, self.route = moe_route, moe_route.route

        def rec(logits, bias, **kw):
            taken = (logits.detach().clone(), bias.clone())
            r = self.route(logits, bias, **kw)
            self.steps[-1].append(r.idx.clone())
            self.inputs[-1].append(taken + (kw["top_k"],))
            return r
        moe_route.route = rec
        return self

    def __exit__(self, *exc):
        self.module.route = self.route
        return False


@torch.no_grad()
def route_step_gap(picks: _Picks) -> float:
    """The largest gap, over the recorded calls and tokens, between the K-th
    best biased score of the plain routing of a call's own logits and bias
    and the least biased score the program picked (0 where they agree)."""
    worst = 0.0
    for idx_step, in_step in zip(picks.steps, picks.inputs):
        for idx, (logits, bias, k) in zip(idx_step, in_step):
            biased = torch.sigmoid(logits) + bias
            own = torch.sort(biased, dim=-1, descending=True, stable=True).indices[:, :k]
            kth = biased.gather(1, own[:, -1:])[:, 0]
            least = biased.gather(1, idx.long()).min(-1).values
            worst = max(worst, float((kth - least).max()))
    return worst


class Cell(TrainingCell):
    causal_attention = True
    control = "fp8"

    def build_program(self):
        from merlot_tpu_torch.models.moe_lm import (MoeLM, MoeLMConfig, moe_lm_optimizer,
                                                    moe_lm_train_step)
        c, p = self.ctx.config, self.ctx.params
        self.keys = model_keys(c)
        cfg = MoeLMConfig.from_dict(self.keys)
        o = c["optimizer"]
        opt = moe_lm_optimizer(o["learning_rate"], o["num_train_steps"], o["num_warmup_steps"])
        self.beta_1 = opt.cfg.beta_1
        self.work_per_step = p["batch"] * p["seq"]
        first, held = cfg.held
        counts_moe.describe(
            {"d_qk": cfg.qk_head_dim, "d_v": cfg.v_head_dim},
            {"tokens": self.work_per_step, "experts": cfg.n_routed_experts,
             "top_k": cfg.num_experts_per_tok, "held": held, "seq": p["seq"],
             "layers": cfg.num_hidden_layers - cfg.first_k_dense_replace})
        return MoeLM(cfg, device=self.dev), opt, moe_lm_train_step(opt, device=self.dev)

    def setup(self) -> None:
        """``TrainingCell.setup`` with the weights' std of the configuration,
        the program's chosen experts and correction biases kept from the
        checked steps, and the gradients freed before the weights are drawn
        again for the change."""
        p = self.ctx.params
        self.check_steps = p.get("check_steps", 3)
        self.model, self.opt, self.step_fn = self.build_program()
        self.shapes = param_shapes(self.model)
        self.std = self.keys["initializer_range"]
        load_into(self.model, make_weights(self.shapes, self.ctx.seed, self.dev, self.std))
        params = dict(self.model.named_parameters())
        self.opt_state = self.opt.init(params)
        self.batches = self.make_batches()
        self.i = 0
        losses = []
        with _Picks() as picks:
            for _ in range(self.check_steps):
                picks.steps.append([])
                picks.inputs.append([])
                losses.append(self.step()[1])
                if self.i == 1:
                    grad = {n: m.float() / (1.0 - self.beta_1)
                            for n, m in self.opt_state["m"].items()}
                    self.prog_grad = compare.leaf_norms(grad)
                    del grad
        self.picks = picks.steps
        self.route_step_gap = route_step_gap(picks)
        self.prog_bias = {n: b.clone() for n, b in self.model.named_buffers()}
        for q in params.values():
            q.grad = None
        self.prog_change = self._change(params)
        self.prog_losses = [float(x) for x in losses]
        self.prog_parts = [{} for _ in losses]

    @torch.no_grad()
    def _change(self, params) -> Dict[str, float]:
        w0 = make_weights(self.shapes, self.ctx.seed, self.dev, self.std)
        out = compare.leaf_norms({n: q.float() - w0[n] for n, q in params.items()})
        del w0
        free_cuda()
        return out

    def make_batches(self):
        p = self.ctx.params
        return zipf_batches(self.dev, self.ctx.seed, n=p["distinct"], batch=p["batch"],
                            seq=p["seq"], vocab=self.keys["vocab_size"], s=p["zipf_s"])

    def half_batch(self, batch):
        return {"input_ids": batch["input_ids"][:self.ctx.params["batch"] // 2]}

    def build_reference(self, precision: str):
        from benchmark.reference.moe_lm import MoeLM
        from benchmark.reference.nn import Precision
        return MoeLM(self.keys, Precision(precision), device=self.dev)

    def reference_run(self, precision: str = "fp32", fault=None) -> Dict[str, Any]:
        """The reference's first ``check_steps`` steps from the same weights
        and batches, on the program's chosen experts (cut to the first half
        of each batch's tokens under the half-batch fault), each layer
        checkpointed; its correction biases moved after each step."""
        from benchmark.reference.adamw import AdamW
        from benchmark.reference.moe_lm import lm_loss
        model = self.build_reference(precision)
        load_into(model, make_weights(self.shapes, self.ctx.seed, self.dev, self.std))
        params = dict(model.named_parameters())
        opt = AdamW(self.ctx.config["optimizer"])
        losses, grad, record = [], None, []
        for i in range(self.check_steps):
            batch = self.batches[i % len(self.batches)]
            forced = self.picks[i]
            if fault == "half_batch":
                batch = self.half_batch(batch)
                forced = [f[:f.shape[0] // 2] for f in forced]
            loss, n_picks = lm_loss(model, batch, forced, record, remat=True)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            used = opt.update(params, grads)
            model.update_biases(n_picks)
            if i == 0:
                grad = compare.leaf_norms(used)
            losses.append(float(loss.detach()))
            del grads, used, loss
        bias = {n: b.clone() for n, b in model.biases().items()}
        change = self._change(params)
        del model, params, opt
        free_cuda()
        flips = sum(r["flips"] for r in record)
        return {"losses": losses, "parts": [{} for _ in losses], "grad": grad,
                "change": change, "bias": bias,
                "route_flip_share": flips / max(1, sum(r["tokens"] for r in record)),
                "route_gap": max((r["gap"] for r in record), default=0.0)}

    def check(self, outs: List[Any]) -> Dict[str, Dict[str, float]]:
        from benchmark.harness.cell import tf32
        with tf32(False):
            ref = self.reference_run()
        checks = compare.training_checks(self.program_readings(), ref, self.ctx.limits)
        return {**checks, **self.routing_checks(ref)}

    def routing_checks(self, ref: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
        gamma = self.keys["bias_update_speed"]
        bias_gap = max(float((self.prog_bias[n] - b).abs().max()) / gamma
                       for n, b in ref["bias"].items())
        lim = self.ctx.limits
        return {"route_gap": {"value": ref["route_gap"], "limit": lim["route_gap"]},
                "route_flip_share": {"value": ref["route_flip_share"],
                                     "limit": lim["route_flip_share"]},
                "route_step_gap": {"value": self.route_step_gap,
                                   "limit": lim["route_step_gap"]},
                "bias_gap": {"value": bias_gap, "limit": lim["bias_gap"]}}

    def flops_per_step(self) -> float:
        """3x the forward, the held experts at the traced steps' own picks
        (``moe.tokens_held``) where the program counted them."""
        from merlot_tpu_torch.core import trace
        p = self.ctx.params
        moe_layers = self.keys["num_hidden_layers"] - self.keys["first_k_dense_replace"]
        held = None
        steps = [c["moe.tokens_held"] for c in trace.counted() if "moe.tokens_held" in c]
        if steps:
            held = sum(sum(s) for s in steps) / len(steps) / moe_layers
        return 3.0 * counts_moe.moe_lm_forward_flops(self.keys, p["batch"], p["seq"], held)

    def peak_flops(self) -> float:
        return counts.peak_flops("bf16")
