"""Pre-LN transformer encoder stack (counterpart of
merlot_tpu/nn/transformer.py).

Per layer ``x += drop(attn(LN(x))); x += drop(mlp(LN(x)))``, then a final
LN; exact-erf gelu MLP; hidden dropout at the JAX package's two sites
unless ``deterministic``, from an explicit ``torch.Generator``. Validity
masks stay multiplicative on every path (the JAX package's additive-bias
form gives the same results). ``num_layers`` runs a prefix of the stack
(how the lang-only tower shares the joint encoder's weights); colsum is
summed over layers. ``attn_backend`` picks the attention path per call:
'cuda' (training_backend on a card) runs the forward and backward kernels.
With ``fuse_ln_matmul`` each pre-LN is fused into its consumer products
(``ops.cuda_ln_matmul.ln_matmul``: K5 on a card): the attention LN into
q/k/v and the MLP LN into the intermediate product, over the same
parameters.

Tensor parallelism (``parallel.mesh.shard_params`` sets ``tp``, the
mesh, on ``SelfAttention`` and ``MlpBlock``): q/k/v and the MLP's
intermediate product are column-parallel (this model rank's heads and
hidden columns; the fused LayerNorm's K5 on those columns), ``out_proj``
and the MLP's output row-parallel, their biases added once after the
model group's sum. The attention runs on the rank's ``num_heads / model``
heads; a head-meaned colsum (or probs) is the model group's sum over
``model``, so its cotangent reaches each rank divided by ``model``. The
hidden dropout acts on the replicated sums, and every model rank of one
data index draws the same masks from the same generator state.

Not ported: attention-prob dropout (0 in every config), scan over layers,
remat, the KV cache, cross-attention and the fused q/k/v forms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from merlot_tpu_torch.nn.layers import DenseTN, LayerNorm, dropout
from merlot_tpu_torch.ops.activations import gelu
from merlot_tpu_torch.ops.attention import attention_core
from merlot_tpu_torch.ops.cuda_ln_matmul import ln_matmul
from merlot_tpu_torch.parallel.tensor_parallel import row_parallel


@dataclass(frozen=True)
class TransformerHParams:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    initializer_range: float = 0.02
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # fp32 softmax, or softmax in the compute dtype (the reference's bf16)
    softmax_fp32: bool = True
    # fuse each pre-LN into its consumer products (same math and parameters)
    fuse_ln_matmul: bool = False


class SelfAttention(nn.Module):
    def __init__(self, hp: TransformerHParams, device=None):
        super().__init__()
        self.hp = hp
        h = hp.hidden_size
        for name in ("query", "key", "value", "out_proj"):
            self.add_module(name, DenseTN(h, h, dtype=hp.dtype,
                                          initializer_range=hp.initializer_range,
                                          device=device))
        self.tp = None  # the mesh, once shard_params has cut the heads

    def check_tp(self, model: int) -> None:
        if self.hp.num_heads % model:
            raise ValueError(f"tensor parallelism: {self.hp.num_heads} heads do not "
                             f"split over model={model}")

    def forward(self, x_norm: torch.Tensor, mask: Optional[torch.Tensor], *,
                collect: str = "none", attn_backend: str = "auto",
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None, ln_params=None):
        """ln_params: the fp32 (gamma, beta) of the pre-attention LN. When
        given, ``x_norm`` is the raw residual stream and the LN is fused
        into the q/k/v products."""
        hp = self.hp
        if not deterministic and hp.attention_probs_dropout_prob > 0.0:
            raise NotImplementedError("attention-prob dropout is not ported")
        b, s, h = x_norm.shape
        d_head = h // hp.num_heads
        tp = self.tp
        heads = hp.num_heads if tp is None else hp.num_heads // tp.model
        if tp is not None:  # this rank's heads read the replicated input
            x_norm = tp.copy_to_model(x_norm)
            if ln_params is not None:
                ln_params = tuple(tp.copy_to_model(t) for t in ln_params)
        names = ("query", "key", "value")
        if ln_params is not None:
            dense = [getattr(self, n) for n in names]
            qkv = ln_matmul(x_norm.to(hp.dtype), *ln_params, [d.weight for d in dense],
                            [d.bias for d in dense])
        else:
            qkv = [getattr(self, n)(x_norm) for n in names]
        q, k, v = (t.reshape(b, s, heads, d_head) for t in qkv)
        ctx, extra = attention_core(q, k, v, mask, collect=collect,
                                    backend=attn_backend,
                                    softmax_fp32=hp.softmax_fp32)
        if tp is None:
            out = self.out_proj(ctx.reshape(b, s, h))
        else:
            out = row_parallel(self.out_proj, ctx.reshape(b, s, heads * d_head), tp)
            if extra is not None:  # the mean over the local heads -> over all
                extra = tp.reduce_from_model(extra) / tp.model
        return dropout(out, hp.hidden_dropout_prob, deterministic=deterministic,
                       generator=generator), extra


class MlpBlock(nn.Module):
    def __init__(self, hp: TransformerHParams, device=None):
        super().__init__()
        self.hp = hp
        kw = dict(dtype=hp.dtype, initializer_range=hp.initializer_range,
                  device=device)
        self.intermediate = DenseTN(hp.hidden_size, hp.intermediate_size, **kw)
        self.output = DenseTN(hp.intermediate_size, hp.hidden_size, **kw)
        self.tp = None  # the mesh, once shard_params has cut the hidden columns

    def forward(self, x_norm: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                ln_params=None) -> torch.Tensor:
        """ln_params: the fp32 (gamma, beta) of the pre-MLP LN; when given,
        ``x_norm`` is the raw residual stream and the LN is fused into the
        intermediate product."""
        inter, tp = self.intermediate, self.tp
        if tp is not None:  # this rank's hidden columns read the replicated input
            x_norm = tp.copy_to_model(x_norm)
            if ln_params is not None:
                ln_params = tuple(tp.copy_to_model(t) for t in ln_params)
        if ln_params is not None:
            (h0,) = ln_matmul(x_norm.to(self.hp.dtype), *ln_params, [inter.weight],
                              [inter.bias])
        else:
            h0 = inter(x_norm)
        out = (self.output(gelu(h0)) if tp is None
               else row_parallel(self.output, gelu(h0), tp))
        return dropout(out, self.hp.hidden_dropout_prob,
                       deterministic=deterministic, generator=generator)


class TransformerLayer(nn.Module):
    def __init__(self, hp: TransformerHParams, device=None):
        super().__init__()
        self.fuse_ln_matmul = hp.fuse_ln_matmul
        self.attn_ln = LayerNorm(hp.hidden_size, device=device)
        self.attention = SelfAttention(hp, device=device)
        self.mlp_ln = LayerNorm(hp.hidden_size, device=device)
        self.mlp = MlpBlock(hp, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                collect: str = "none", attn_backend: str = "auto",
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        kw = dict(deterministic=deterministic, generator=generator)
        if self.fuse_ln_matmul:
            # the raw residual stream and the LN's parameters: the LN runs
            # inside the consumer products
            attn_out, extra = self.attention(
                x, mask, collect=collect, attn_backend=attn_backend,
                ln_params=(self.attn_ln.gamma, self.attn_ln.beta), **kw)
            x = x + attn_out
            return x + self.mlp(x, ln_params=(self.mlp_ln.gamma, self.mlp_ln.beta),
                                **kw), extra
        attn_out, extra = self.attention(self.attn_ln(x), mask, collect=collect,
                                         attn_backend=attn_backend, **kw)
        x = x + attn_out
        x = x + self.mlp(self.mlp_ln(x), **kw)
        return x, extra


class TransformerEncoder(nn.Module):
    """Stack of pre-LN layers ``layer00``, ``layer01``, ... + ``final_ln``.

    Returns a dict with
      hidden_state [B, S, H] (compute dtype);
      attn_colsum  [B, S] fp32, summed over layers (collect='colsum');
      attn_probs   [B, num_layers, S, S] fp32 head-meaned (collect='probs').
    """

    def __init__(self, hp: TransformerHParams, device=None):
        super().__init__()
        self.hp = hp
        for i in range(hp.num_layers):
            self.add_module(f"layer{i:02d}", TransformerLayer(hp, device=device))
        self.final_ln = LayerNorm(hp.hidden_size, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], *,
                collect: str = "none", attn_backend: str = "auto",
                num_layers: Optional[int] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        hp = self.hp
        x = x.to(hp.dtype)
        if mask is not None:
            mask = mask.to(torch.float32)

        n = hp.num_layers if num_layers is None else num_layers
        if not 0 < n <= hp.num_layers:
            raise ValueError(f"num_layers={n} outside 1..{hp.num_layers}")
        colsum = None
        probs_all = []
        for i in range(n):
            x, extra = getattr(self, f"layer{i:02d}")(
                x, mask, collect, attn_backend, deterministic=deterministic,
                generator=generator)
            if collect == "colsum":
                colsum = extra if colsum is None else colsum + extra
            elif collect == "probs":
                probs_all.append(extra)
        out: Dict[str, torch.Tensor] = {}
        if collect == "colsum":
            out["attn_colsum"] = colsum
        elif collect == "probs":
            out["attn_probs"] = torch.stack(probs_all, dim=1)
        out["hidden_state"] = self.final_ln(x)
        return out
