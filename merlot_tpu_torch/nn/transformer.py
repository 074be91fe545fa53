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
data index draws the same masks from the same generator state; the
attention-prob dropout draws its mask over all heads and each rank keeps
its own heads' share, so the ranks drop what one process would.

Cross-attention and the KV cache (the reference attention layer's
x_enc and cache): with ``x_enc`` [B, Sk, H] the keys and values project
from it (raw, not the layer's LN) and the queries from the layer's input;
with ``cache`` (``TransformerEncoder.init_cache``: per layer ``kNN``/``vNN``
[B, max_len, heads, d] in the compute dtype) each layer writes its new keys
and values in place at ``cache_pos`` and attends over the whole buffer
under a [B, Sq, max_len] mask; the forward returns the cache under
``new_cache``. Neither runs the fused LN+matmul (the JAX package skips it
there too). Attention-prob dropout draws from the layers' generator.

Per-layer remat (``hp.remat``; the JAX package's ``nn.remat`` of each
layer): each layer runs under ``torch.utils.checkpoint`` (non-reentrant)
and its activations are recomputed in the backward, except what
``hp.remat_policy`` saves (``REMAT_SAVES``, torch's selective checkpoint
naming dispatcher ops):
  - None: nothing; the whole layer recomputes, the attention forward
    included;
  - 'dots': every matmul output: q/k/v, out_proj and the MLP's two
    products (the fused LN+matmul's outputs when fused), and on the plain
    path the score and context products;
  - 'dots_no_batch': the weight-stationary products only (on the kernel
    path the same as 'dots');
  - 'probs': the softmax's probs on the plain path (the JAX package's
    ``attn_probs``); on the kernel path the attention forward's outputs
    and its row stats (``cuda_attention.attention_fwd_op``, taken through
    the op inside the checkpoint: ``ops/named_ops.py``), which the
    backward kernel reads in place of the probs, so the recompute
    launches no attention forward;
  - 'probs_dots': 'probs' and 'dots_no_batch'.
A layer's recompute replays its dropout masks: the generator's state is
set back to what it was before the layer's forward, and restored after.
A cached call (decoding) never checkpoints, as in the JAX package.

Not ported: scan over layers and the fused q/k/v forms (the same math
over the same parameters).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from merlot_tpu_torch.nn.layers import DenseTN, LayerNorm, dropout
from merlot_tpu_torch.ops import named_ops
from merlot_tpu_torch.ops.activations import gelu
from merlot_tpu_torch.ops.attention import attention_core
from merlot_tpu_torch.ops.cuda_attention import ATTENTION_FWD
from merlot_tpu_torch.ops.cuda_ln_matmul import LN_MATMUL, ln_matmul
from merlot_tpu_torch.parallel.tensor_parallel import row_parallel

_aten = torch.ops.aten
# the products without batch dimensions (weight-stationary), those with
# (the plain attention's score and context products), and what the
# attention's probs are on each path
_WEIGHT_DOTS = frozenset({_aten.mm, _aten.addmm, LN_MATMUL})
_BATCH_DOTS = frozenset({_aten.bmm, _aten.baddbmm})
_PROBS = frozenset({_aten._softmax, ATTENTION_FWD})
# the ops whose outputs each remat policy keeps (None keeps nothing)
REMAT_SAVES = {
    None: frozenset(),
    "dots": _WEIGHT_DOTS | _BATCH_DOTS,
    "dots_no_batch": _WEIGHT_DOTS,
    "probs": _PROBS,
    "probs_dots": _PROBS | _WEIGHT_DOTS,
}


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
    # checkpoint each layer (recompute its activations in the backward),
    # saving what the policy names (REMAT_SAVES)
    remat: bool = False
    remat_policy: Optional[str] = None

    def __post_init__(self):
        if self.remat_policy not in REMAT_SAVES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; one of "
                             f"{sorted(REMAT_SAVES, key=str)}")


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
                generator: Optional[torch.Generator] = None, ln_params=None,
                x_enc: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None, cache_pos: int = 0):
        """ln_params: the fp32 (gamma, beta) of the pre-attention LN. When
        given, ``x_norm`` is the raw residual stream and the LN is fused
        into the q/k/v products (self-attention without a cache only).
        x_enc: the cross-attention source [B, Sk, H] of the keys and values.
        cache: {'k', 'v'} [B, max_len, heads, d], written in place at
        ``cache_pos``; the attention then runs over the whole buffer.
        Returns (out, extra, the cache or None)."""
        hp = self.hp
        b, s, h = x_norm.shape
        d_head = h // hp.num_heads
        tp = self.tp
        heads = hp.num_heads if tp is None else hp.num_heads // tp.model
        if ln_params is not None and (x_enc is not None or cache is not None):
            raise ValueError("the fused LN+matmul is self-attention without a cache only")
        if tp is not None:  # this rank's heads read the replicated input
            x_norm = tp.copy_to_model(x_norm)
            if x_enc is not None:
                x_enc = tp.copy_to_model(x_enc)
            if ln_params is not None:
                ln_params = tuple(tp.copy_to_model(t) for t in ln_params)
        names = ("query", "key", "value")
        if ln_params is not None:
            dense = [getattr(self, n) for n in names]
            qkv = ln_matmul(x_norm.to(hp.dtype), *ln_params, [d.weight for d in dense],
                            [d.bias for d in dense])
        else:
            kv_src = x_norm if x_enc is None else x_enc
            qkv = [self.query(x_norm), self.key(kv_src), self.value(kv_src)]
        q, k, v = (t.reshape(b, t.shape[1], heads, d_head) for t in qkv)
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
            k, v = ck.to(q.dtype), cv.to(q.dtype)
        rate = 0.0 if deterministic else hp.attention_probs_dropout_prob
        ctx, extra = attention_core(q, k, v, mask, collect=collect,
                                    backend=attn_backend,
                                    softmax_fp32=hp.softmax_fp32,
                                    dropout_rate=rate, generator=generator,
                                    dropout_heads=None if tp is None
                                    else (tp.model_rank * heads, hp.num_heads))
        if tp is None:
            out = self.out_proj(ctx.reshape(b, s, h))
        else:
            out = row_parallel(self.out_proj, ctx.reshape(b, s, heads * d_head), tp)
            if extra is not None:  # the mean over the local heads -> over all
                extra = tp.reduce_from_model(extra) / tp.model
        return dropout(out, hp.hidden_dropout_prob, deterministic=deterministic,
                       generator=generator), extra, cache


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
                generator: Optional[torch.Generator] = None,
                x_enc: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None, cache_pos: int = 0):
        """Returns (x, extra, the layer's cache or None)."""
        kw = dict(deterministic=deterministic, generator=generator)
        if self.fuse_ln_matmul and x_enc is None and cache is None:
            # the raw residual stream and the LN's parameters: the LN runs
            # inside the consumer products
            attn_out, extra, _ = self.attention(
                x, mask, collect=collect, attn_backend=attn_backend,
                ln_params=(self.attn_ln.gamma, self.attn_ln.beta), **kw)
            x = x + attn_out
            return x + self.mlp(x, ln_params=(self.mlp_ln.gamma, self.mlp_ln.beta),
                                **kw), extra, None
        attn_out, extra, cache = self.attention(
            self.attn_ln(x), mask, collect=collect, attn_backend=attn_backend,
            x_enc=x_enc, cache=cache, cache_pos=cache_pos, **kw)
        x = x + attn_out
        x = x + self.mlp(self.mlp_ln(x), **kw)
        return x, extra, cache


def _selective(saves: frozenset):
    """torch's selective-checkpoint policy that keeps the outputs of the
    ops in ``saves`` and recomputes the rest."""
    def policy(ctx, op, *args, **kwargs):
        keep = getattr(op, "overloadpacket", None) in saves
        return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if keep
                else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _remat_contexts(policy: Optional[str], generator: Optional[torch.Generator]):
    """``context_fn`` of a checkpointed layer: the selective checkpoint's
    two contexts for ``policy``, and ``generator``'s state saved before the
    forward, set back for the recompute (the same dropout masks) and
    restored after it (the draws that follow are unchanged)."""
    saves = REMAT_SAVES[policy]
    if saves:
        # the kernels' forwards through their ops, which the policy can name
        fwd, rec = torch_checkpoint.create_selective_checkpoint_contexts(_selective(saves))
        fwd, rec = _both(named_ops.through_ops(), fwd), _both(named_ops.through_ops(), rec)
    else:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    if generator is None:
        return fwd, rec
    state = {}

    @contextlib.contextmanager
    def forward():
        state["before"] = generator.get_state()
        with fwd:
            yield

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(state["before"])
        try:
            with rec:
                yield
        finally:
            generator.set_state(now)

    return forward(), recompute()


class TransformerEncoder(nn.Module):
    """Stack of pre-LN layers ``layer00``, ``layer01``, ... + ``final_ln``.

    Returns a dict with
      hidden_state [B, S, H] (compute dtype);
      attn_colsum  [B, S] fp32, summed over layers (collect='colsum');
      attn_probs   [B, num_layers, S, S] fp32 head-meaned (collect='probs');
      new_cache    the cache's buffers (with ``cache``).
    """

    def __init__(self, hp: TransformerHParams, device=None):
        super().__init__()
        self.hp = hp
        for i in range(hp.num_layers):
            self.add_module(f"layer{i:02d}", TransformerLayer(hp, device=device))
        self.final_ln = LayerNorm(hp.hidden_size, device=device)

    def init_cache(self, batch_size: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """Zeroed per-layer key and value buffers {'k00', 'v00', ...}
        [B, max_len, heads, d] on the module's device, in ``dtype`` (the
        compute dtype by default); under tensor parallelism this model
        rank's heads."""
        hp = self.hp
        tp = self.layer00.attention.tp
        heads = hp.num_heads if tp is None else hp.num_heads // tp.model
        shape = (batch_size, max_len, heads, hp.hidden_size // hp.num_heads)
        kw = dict(dtype=hp.dtype if dtype is None else dtype,
                  device=self.final_ln.gamma.device)
        out: Dict[str, torch.Tensor] = {}
        for i in range(hp.num_layers):
            out[f"k{i:02d}"] = torch.zeros(shape, **kw)
            out[f"v{i:02d}"] = torch.zeros(shape, **kw)
        return out

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], *,
                collect: str = "none", attn_backend: str = "auto",
                num_layers: Optional[int] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                x_enc: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos: int = 0) -> Dict[str, torch.Tensor]:
        """x_enc: the cross-attention source [B, Sk, H]. cache: the buffers
        of ``init_cache``, written in place at ``cache_pos`` (mask
        [B, Sq, max_len]) and returned under 'new_cache'."""
        hp = self.hp
        x = x.to(hp.dtype)
        if mask is not None:
            mask = mask.to(torch.float32)
        if x_enc is not None:
            x_enc = x_enc.to(hp.dtype)

        n = hp.num_layers if num_layers is None else num_layers
        if not 0 < n <= hp.num_layers:
            raise ValueError(f"num_layers={n} outside 1..{hp.num_layers}")
        remat = hp.remat and cache is None and torch.is_grad_enabled()
        colsum = None
        probs_all = []
        new_cache: Dict[str, torch.Tensor] = {}
        for i in range(n):
            layer = getattr(self, f"layer{i:02d}")
            kw = dict(deterministic=deterministic, generator=generator, x_enc=x_enc)
            if cache is not None:
                x, extra, c = layer(x, mask, collect, attn_backend, **kw,
                                    cache={"k": cache[f"k{i:02d}"], "v": cache[f"v{i:02d}"]},
                                    cache_pos=cache_pos)
                new_cache[f"k{i:02d}"], new_cache[f"v{i:02d}"] = c["k"], c["v"]
            elif remat:
                x, extra, _ = torch_checkpoint.checkpoint(
                    layer, x, mask, collect, attn_backend, **kw, use_reentrant=False,
                    context_fn=lambda: _remat_contexts(
                        hp.remat_policy, None if deterministic else generator))
            else:
                x, extra, _ = layer(x, mask, collect, attn_backend, **kw)
            if collect == "colsum":
                colsum = extra if colsum is None else colsum + extra
            elif collect == "probs":
                probs_all.append(extra)
        out: Dict[str, torch.Tensor] = {}
        if collect == "colsum":
            out["attn_colsum"] = colsum
        elif collect == "probs":
            out["attn_probs"] = torch.stack(probs_all, dim=1)
        if cache is not None:
            out["new_cache"] = new_cache
        out["hidden_state"] = self.final_ln(x)
        return out
