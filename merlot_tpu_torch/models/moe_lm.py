"""The DeepSeek-V3 block (arXiv 2412.19437 section 2.1; Hugging Face's
``deepseek_v3`` modelling, which Moonlight-16B-A3B's config names) as a
causal LM trained on one share of an expert-parallel deployment.

For a layer input h [B, S, hidden] (fp32 residual stream):

  MLA (no q LoRA):
    x = RMSNorm(h)
    [q_nope, q_pe] = x W_q                       per head 128 + 64
    [c_kv, k_pe]   = x W_kva                     512 + 64 (k_pe one head)
    [k_nope, v]    = RMSNorm_kv(c_kv) W_kvb      per head 128 + 128
    q_pe, k_pe     rotated by RoPE (theta 50000), Hugging Face's
                   ``apply_rotary_pos_emb`` of deepseek_v3: each head's
                   interleaved pairs gathered into halves, then rotate_half
    q = [q_nope, q_pe], k = [k_nope, k_pe]       Q.K at 192, V at 128
    h = h + W_o causal_attention(q, k, v)        scale 192^-0.5, fp32 softmax
  then, in the first ``first_k_dense_replace`` layers a SwiGLU MLP of
  ``intermediate_size``, in the others the expert layer (``nn/moe.py``):
    h = h + MLP(RMSNorm(h))  or  h = h + MoE(RMSNorm(h))

and a final RMSNorm and an untied head over the vocabulary, next-token
cross-entropy plus the layers' sequence-wise balance losses. The attention
runs on K1/K2 at MLA's shapes on a card (``ops/attention.py``, causal,
no mask tensor), the plain path on the CPU.

Precision: fp32 parameters and residual stream, RMSNorm and the router in
fp32, every product on bf16 operands (fp32 accumulation) with a bf16
result, no dropout.

The expert-parallel share: ``experts_held`` (first, count) of the router's
``n_routed_experts`` live here; the router keeps its full width and its
experts per token, and the layer computes what its own experts give.
``vocab_size`` is the share's slice of the vocabulary when the deployment
slices it.

``MoeLMConfig.from_dict`` reads a Hugging Face ``config.json`` of
``model_type`` deepseek_v3 (and refuses what this block does not compute);
``moe_lm_train_step`` (``moe_lm_loss`` through ``make_loss_train_step``,
then the correction biases' update) and ``moe_lm_optimizer`` are what
``tools/grover_train.py`` trains it with.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from merlot_tpu_torch.core import trace
from merlot_tpu_torch.nn.moe import MoE, SwiGLUMLP, trunc_normal
from merlot_tpu_torch.ops.attention import attention_core, training_backend
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import make_loss_train_step

# Hugging Face keys whose values this block does not compute otherwise
_REQUIRED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "n_group": 1, "topk_group": 1, "norm_topk_prob": True, "moe_layer_freq": 1,
             "tie_word_embeddings": False, "attention_bias": False, "hidden_act": "silu"}


@dataclass(frozen=True)
class MoeLMConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    # (first, count) of the routed experts held here; None: all of them
    experts_held: Optional[Tuple[int, int]] = None
    # DeepSeek-V3's training-time balance: the sequence-wise loss's alpha
    # and the correction bias's update speed gamma
    aux_loss_alpha: float = 1e-4
    bias_update_speed: float = 1e-3
    initializer_range: float = 0.006

    @property
    def held(self) -> Tuple[int, int]:
        return tuple(self.experts_held) if self.experts_held else (0, self.n_routed_experts)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MoeLMConfig":
        if d.get("model_type", "deepseek_v3") != "deepseek_v3":
            raise ValueError(f"model_type {d.get('model_type')!r} is not deepseek_v3")
        for k, want in _REQUIRED.items():
            if k in d and d[k] != want:
                raise ValueError(f"{k}={d[k]!r}: this block computes only {k}={want!r}")
        if d.get("num_nextn_predict_layers", 0):
            raise ValueError("multi-token prediction (num_nextn_predict_layers > 0) is not "
                             "computed")
        if d.get("rope_scaling"):
            raise ValueError("rope_scaling is not computed")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if kw.get("experts_held") is not None:
            kw["experts_held"] = tuple(kw["experts_held"])
        return cls(**kw)

    @classmethod
    def from_json_file(cls, path: str) -> "MoeLMConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * gamma in fp32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gamma


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.gamma, self.eps)


def rope_tables(seq: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [seq, dim] fp32 of positions 0.., each pair's frequency
    theta^(-2i/dim) repeated over the two halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device).float() / dim))
    freqs = torch.arange(seq, device=device).float()[:, None] * inv_freq[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, h, d] rotated in fp32, Hugging Face deepseek_v3's layout:
    the interleaved pairs gathered into halves, then x cos + rotate_half(x)
    sin. Returned in x's dtype."""
    b, s, h, d = x.shape
    x32 = x.float().reshape(b, s, h, d // 2, 2).transpose(-1, -2).reshape(b, s, h, d)
    half = torch.cat([-x32[..., d // 2:], x32[..., :d // 2]], dim=-1)
    return (x32 * cos[None, :, None] + half * sin[None, :, None]).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.linear(x.to(torch.bfloat16), w.to(torch.bfloat16))


class MLA(nn.Module):
    """Multi-head latent attention without a q LoRA (weights [out, in])."""

    def __init__(self, c: MoeLMConfig, device=None):
        super().__init__()
        self.c = c
        h, n = c.hidden_size, c.num_attention_heads
        self.q_proj = nn.Parameter(torch.empty(n * c.qk_head_dim, h, device=device))
        self.kv_a_proj = nn.Parameter(torch.empty(c.kv_lora_rank + c.qk_rope_head_dim, h,
                                                  device=device))
        self.kv_norm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, device)
        self.kv_b_proj = nn.Parameter(torch.empty(n * (c.qk_nope_head_dim + c.v_head_dim),
                                                  c.kv_lora_rank, device=device))
        self.o_proj = nn.Parameter(torch.empty(h, n * c.v_head_dim, device=device))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                backend: str) -> torch.Tensor:
        c = self.c
        b, s, _ = x.shape
        n, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = _linear(x, self.q_proj).view(b, s, n, nope + rope)
        kv_a = _linear(x, self.kv_a_proj)
        c_kv, k_pe = kv_a.split([c.kv_lora_rank, rope], dim=-1)
        kv = _linear(self.kv_norm(c_kv), self.kv_b_proj).view(b, s, n, nope + c.v_head_dim)
        k_nope, v = kv.split([nope, c.v_head_dim], dim=-1)
        q_pe = apply_rope(q[..., nope:], cos, sin)
        k_pe = apply_rope(k_pe.view(b, s, 1, rope), cos, sin).expand(b, s, n, rope)
        q = torch.cat([q[..., :nope], q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        ctx, _ = attention_core(q, k, v.contiguous(), None, causal=True, backend=backend,
                                softmax_fp32=True)
        return _linear(ctx.reshape(b, s, n * c.v_head_dim), self.o_proj)


class DecoderLayer(nn.Module):
    def __init__(self, c: MoeLMConfig, dense: bool, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
        self.attn = MLA(c, device)
        self.mlp_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
        if dense:
            self.mlp = SwiGLUMLP(c.hidden_size, c.intermediate_size, device)
        else:
            self.mlp = MoE(c.hidden_size, c.moe_intermediate_size, c.n_routed_experts,
                           c.num_experts_per_tok, c.n_shared_experts, c.held,
                           c.routed_scaling_factor, c.bias_update_speed, c.aux_loss_alpha,
                           device)

    def forward(self, h, cos, sin, backend) -> Tuple[torch.Tensor, torch.Tensor]:
        with trace.span("model.mla"):
            h = h + self.attn(self.attn_norm(h), cos, sin, backend).float()
        y = self.mlp_norm(h)
        if isinstance(self.mlp, MoE):
            out, balance = self.mlp(y)
            return h + out, balance
        return h + self.mlp(y).float(), h.new_zeros(())


class MoeLM(nn.Module):
    """The causal LM: embedding, the decoder layers, the final norm and the
    untied head. ``forward(input_ids [B, S]) -> (logits [B, S, V] bf16, the
    layers' summed balance loss)``."""

    def __init__(self, c: MoeLMConfig, device=None):
        super().__init__()
        self.cfg = c
        self.embed = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size, device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(c, i < c.first_k_dense_replace, device)
            for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
        self.head = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size, device=device))

    @torch.no_grad()
    def init_tree(self, gen: torch.Generator) -> None:
        """Every matrix normal of std initializer_range (clipped at two
        standard deviations), the norms' scales 1, the correction biases 0;
        in name order."""
        for name, p in sorted(self.named_parameters()):
            if name.endswith("gamma"):
                p.fill_(1.0)
            else:
                trunc_normal(p, self.cfg.initializer_range, gen)
        for name, buf in self.named_buffers():
            buf.zero_()

    def forward(self, input_ids: torch.Tensor, backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b, s = input_ids.shape
        if s > c.max_position_embeddings:
            raise ValueError(f"{s} positions, the model has {c.max_position_embeddings}")
        backend = backend or training_backend(input_ids.device)
        cos, sin = rope_tables(s, c.qk_rope_head_dim, c.rope_theta, input_ids.device)
        h = self.embed[input_ids.long()]
        balance = h.new_zeros(())
        for layer in self.layers:
            h, part = layer(h, cos, sin, backend)
            balance = balance + part
        logits = _linear(self.norm(h), self.head)
        return logits, balance

    def update_biases(self) -> None:
        """Each expert layer's correction bias moved by the loads of the
        training forwards since the last call (``MoE.update_bias``)."""
        for layer in self.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.update_bias()


def moe_lm_loss(model: MoeLM, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``loss_fn(model, batch, generator)`` of ``make_loss_train_step``: the
    next-token cross-entropy over every position of input_ids[:, :-1]
    against input_ids[:, 1:] (packed rows: no padding), in fp32, plus the
    balance losses. The model draws nothing: no dropout."""
    ids = batch["input_ids"]
    logits, balance = model(ids[:, :-1])
    lm = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         ids[:, 1:].reshape(-1).long())
    return lm + balance, {"lm_loss": lm.detach(), "balance_loss": balance.detach()}


def moe_lm_train_step(optimizer: MerlotAdamW, device="cuda") -> Callable:
    """``step(model, opt_state, batch, generator) -> metrics``:
    ``make_loss_train_step(moe_lm_loss, optimizer)``, then the correction
    biases moved once by the step's loads, after the update (DeepSeek-V3
    section 2.1.2)."""
    step = make_loss_train_step(moe_lm_loss, optimizer, device=device)

    def train_step(model: MoeLM, opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]) -> Dict[str, Any]:
        metrics = step(model, opt_state, batch, generator)
        model.update_biases()
        return metrics

    return train_step


# DeepSeek-V3's AdamW block (section 4.2): no weight decay on the norms'
# scales; the correction biases are buffers, outside the optimizer
NO_DECAY = ("gamma",)


def moe_lm_optimizer(learning_rate: float = 2.2e-4, num_train_steps: int = 100000,
                     num_warmup_steps: int = 2000) -> MerlotAdamW:
    """Weight decay 0.1, beta (0.9, 0.95), epsilon 1e-8, global-norm clip
    1.0, fp32 moments; linear warmup then linear decay."""
    return MerlotAdamW(AdamWConfig(
        learning_rate=learning_rate, num_train_steps=num_train_steps,
        num_warmup_steps=num_warmup_steps, weight_decay_rate=0.1, beta_1=0.9, beta_2=0.95,
        epsilon=1e-8, clip_norm=1.0, use_bfloat16_adam=False,
        param_overrides=((NO_DECAY, {"weight_decay_rate": 0.0}),)))
