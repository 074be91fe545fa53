"""Grover, the decoder-only LM of the ASR denoiser (counterpart of
merlot_tpu/models/grover.py), for training and serving.

Per layer, the reference's residual layout:
  h = LN1( (h + attn(h)) + mlp(LN0(h + attn(h))) )
attention reads the un-normalized stream, ``mlp_ln0`` comes before the MLP
and ``mlp_ln1`` after the residual add. Embeddings are word + position
with an ``embed_norm`` LN; the logits are tied to the word embedding, no
bias. Parameters and module names follow the flax tree one for one
(``convert.load_flax_params`` moves them).

Training (no cache): hidden dropout at the JAX package's two sites, after
``out_proj`` and after the MLP's ``output``, at ``hidden_dropout_prob``,
drawn from the caller's ``torch.Generator`` when ``deterministic=False``.
Like the JAX package, no attention-prob dropout is applied, whatever
``attention_probs_dropout_prob`` says. ``grover_lm_loss`` is the weighted
next-token cross-entropy with the x``target_bonus`` weight on denoise
targets.

Caches are preallocated per layer and written in place at
``position_offset``: the flat cache holds ``k00``/``v00``... as
[B, max_len, H, D]; the stacked cache (``cfg.stacked_kv``) holds
``kv00``... as [B, max_len, 2*H*D], keys in columns [:H*D] and values in
[H*D:], so with ``fused_qkv`` the new chunk is the k‖v column slice of the
qkv product. The cache's dtype is the model dtype; slots past the position
hold zeros and the causal mask gives them probability 0.

Attention, fp32 softmax throughout: without a cache the device's training
backend (``ops.attention.training_backend``): on a card K1 forward and K2
backward through ``FlashAttention``, with the causal mask expanded to a
contiguous [B, S, S]; on the CPU the plain path (the JAX package uses
XLA's einsums there, the same function). With a cache,
``ops.cuda_attention``: K3 over the stacked cache, K1 over the flat one,
on CUDA tensors (a shape they refuse raises), their plain versions on CPU
tensors.

Sampling (``top_p_sample``, ``top_k_sample``, ``make_seq2seq_sampler``)
draws from an explicit ``torch.Generator``: the same distributions as the
JAX package, not the same streams.

Pipeline parallelism (``parallel/pipeline.py``, a mesh with a stage axis):
``GroverStage`` is one rank's stage, its contiguous L/n_stage layers
(``stages.{j}``) with the replicated ``word_embed``, ``pos_embed`` and
``embed_norm``, initialised from a seed as the whole ``GroverLM`` would be
(the same weights at any number of stages). ``grover_pipeline_forward``
runs the embedding and ``embed_norm`` on stage 0, the layers per
microbatch through the GPipe schedule, and on the last stage assembles
the [B, S, H] output in JAX's order and the tied head over the whole
batch. ``stack_grover_params`` / ``unstack_grover_params`` /
``shard_grover_pp_params`` move numpy flat trees between the standard
form, JAX's stacked ``stages/...`` form and one stage's leaves.

Tensor parallelism (``parallel.mesh.shard_params`` sets ``tp`` on each
layer and the LM): q/k/v and ``intermediate`` are column-parallel (this
model rank's heads and hidden columns), ``out_proj`` and ``output``
row-parallel with their biases added once after the model group's sum;
``word_embed``, the LM head and the norms stay replicated (the JAX rules
leave ``word_embed`` whole: 50270 = 2 * 5 * 11 * 457). The KV cache, flat
or stacked, holds this rank's heads, and the fused qkv product is this
rank's q | k | v columns, so K3 runs at the local head count. Every rank
of the model group computes the same logits: the last sum's bytes are the
same on each.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from merlot_tpu_torch.nn.layers import DenseTN, LayerNorm, dropout, init_params, trunc_normal_
from merlot_tpu_torch.ops import cuda_attention
from merlot_tpu_torch.ops.activations import gelu
from merlot_tpu_torch.ops.attention import attention_core, training_backend
from merlot_tpu_torch.ops.sampling import gumbel_noise, top_k_indices
from merlot_tpu_torch.parallel.tensor_parallel import row_parallel

MASK_PENALTY = 1e10


@dataclass(frozen=True)
class GroverConfig:
    vocab_size: int = 50270
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    initializer_range: float = 0.02
    pad_token_id: int = 0
    use_bfloat16: bool = False
    # serving only: one [H, 3H] qkv projection per layer (fuse_qkv_for_serving)
    fused_qkv: bool = False
    # serving only: one [B, max_len, 2H] cache buffer per layer (keys ‖ values)
    stacked_kv: bool = False

    @classmethod
    def from_json_file(cls, path: str) -> "GroverConfig":
        with open(path) as f:
            d = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def d_head(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_bfloat16 else torch.float32


class GroverLayer(nn.Module):
    def __init__(self, cfg: GroverConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        hs = c.hidden_size

        def dense(n_in, n_out):
            return DenseTN(n_in, n_out, dtype=c.dtype,
                           initializer_range=c.initializer_range, device=device)

        if c.fused_qkv:
            self.qkv = dense(hs, 3 * hs)
        else:
            self.query, self.key, self.value = (dense(hs, hs) for _ in range(3))
        self.out_proj = dense(hs, hs)
        self.mlp_ln0 = LayerNorm(hs, device=device)
        self.intermediate = dense(hs, c.intermediate_size)
        self.output = dense(c.intermediate_size, hs)
        self.mlp_ln1 = LayerNorm(hs, device=device)
        self.tp = None  # the mesh, once shard_params has cut the heads

    def check_tp(self, model: int) -> None:
        if self.cfg.num_attention_heads % model:
            raise ValueError(f"tensor parallelism: {self.cfg.num_attention_heads} heads "
                             f"do not split over model={model}")

    def forward(self, h: torch.Tensor, mask: torch.Tensor, kv_write_pos: int = 0,
                cache_k: Optional[torch.Tensor] = None,
                cache_v: Optional[torch.Tensor] = None,
                cache_kv: Optional[torch.Tensor] = None, *,
                attn_backend: str = "plain", deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """h [B, S, H]; mask [B or 1, S, K] over the key axis (the whole
        cache when one is given, else S; [B, S, S] for the 'cuda' backend).
        A given cache takes the chunk's keys and values at
        ``kv_write_pos``, in place. Without a cache the attention runs on
        ``attn_backend``; the hidden dropout draws from ``generator``
        unless ``deterministic``."""
        c, tp = self.cfg, self.tp
        b, s, _ = h.shape
        m = 1 if tp is None else tp.model
        # this model rank's heads and their columns
        hs, nh, d = c.hidden_size // m, c.num_attention_heads // m, c.d_head
        h_in = h if tp is None else tp.copy_to_model(h)
        if c.fused_qkv:
            qkv = self.qkv(h_in)
            q = qkv[..., :hs].reshape(b, s, nh, d)
            kv_flat = qkv[..., hs:]     # the k‖v columns: the stacked cache's rows
            k_flat, v_flat = kv_flat[..., :hs], kv_flat[..., hs:]
        else:
            q = self.query(h_in).reshape(b, s, nh, d)
            k_flat, v_flat = self.key(h_in), self.value(h_in)
            kv_flat = None

        end = kv_write_pos + s
        if cache_kv is not None:
            if kv_flat is None:
                kv_flat = torch.cat([k_flat, v_flat], dim=-1)
            cache_kv[:, kv_write_pos:end] = kv_flat
            # the mask is 0 past `end` and every row sees its own slot, so
            # the kernel reads only the live slots
            ctx = cuda_attention.flash_attention_stacked(q, cache_kv, mask,
                                                         softmax_fp32=True, kv_len=end)
        elif cache_k is not None:
            cache_k[:, kv_write_pos:end] = k_flat.reshape(b, s, nh, d)
            cache_v[:, kv_write_pos:end] = v_flat.reshape(b, s, nh, d)
            # the cache is in the model dtype, as q is
            ctx, _ = cuda_attention.flash_attention(q.contiguous(), cache_k, cache_v, mask,
                                                    softmax_fp32=True)
        else:
            ctx, _ = attention_core(q, k_flat.reshape(b, s, nh, d),
                                    v_flat.reshape(b, s, nh, d), mask,
                                    backend=attn_backend, softmax_fp32=True)
        drop = dict(deterministic=deterministic, generator=generator)
        ctx = ctx.to(q.dtype).reshape(b, s, hs)
        attn = self.out_proj(ctx) if tp is None else row_parallel(self.out_proj, ctx, tp)
        x = h + dropout(attn, c.hidden_dropout_prob, **drop)
        y = self.mlp_ln0(x)
        if tp is None:
            y = self.output(gelu(self.intermediate(y)))
        else:
            y = row_parallel(self.output, gelu(self.intermediate(tp.copy_to_model(y))), tp)
        return self.mlp_ln1(x + dropout(y, c.hidden_dropout_prob, **drop))


class GroverLM(nn.Module):
    def __init__(self, cfg: GroverConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.word_embed = nn.Parameter(torch.empty(
            (c.vocab_size, c.hidden_size), dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            (c.max_position_embeddings, c.hidden_size), dtype=torch.float32,
            device=device))
        self.embed_norm = LayerNorm(c.hidden_size, device=device)
        for i in range(c.num_hidden_layers):
            setattr(self, f"layer{i:02d}", GroverLayer(c, device=device))
        self.tp = None  # the mesh, once shard_params has cut the layers

    def init_weights(self, gen: torch.Generator) -> None:
        trunc_normal_(self.word_embed, self.cfg.initializer_range, gen)
        trunc_normal_(self.pos_embed, self.cfg.initializer_range, gen)

    def layers(self):
        return [getattr(self, f"layer{i:02d}") for i in range(self.cfg.num_hidden_layers)]

    def forward(self, input_ids: torch.Tensor, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                position_offset: int = 0, return_hidden: bool = False,
                compute_logits: bool = True, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                attn_backend: Optional[str] = None):
        """Without a cache: causal within the sequence, attention on
        ``attn_backend`` (default: the device's ``training_backend``). With
        a cache (see ``empty_cache``): the chunk is written at
        ``position_offset`` and attention covers cache positions <
        position_offset + S. ``deterministic=False`` applies the hidden
        dropout, drawn from ``generator`` (required then). Returns (logits
        [B, S, vocab] fp32 or None, cache or None), and the final hidden
        states [B, S, H] third with ``return_hidden``."""
        c = self.cfg
        b, s = input_ids.shape
        dev = input_ids.device
        if not deterministic and generator is None:
            raise ValueError("GroverLM: deterministic=False needs a generator for the dropout")
        backend = attn_backend or training_backend(dev)
        h = self.word_embed[input_ids]
        h = self.embed_norm(h + self.pos_embed[position_offset:position_offset + s][None])

        q_pos = position_offset + torch.arange(s, device=dev)
        k_len = s if cache is None else next(iter(cache.values())).shape[1]
        # one [1, S, K] mask for every layer and batch element; K1 (the
        # flat cache) takes a [B, S, K] one
        mask = (torch.arange(k_len, device=dev)[None] <= q_pos[:, None]
                ).to(torch.float32)[None]
        # and so does the kernel backend without a cache (made once: every
        # layer saves the same tensor for its backward)
        if (cache is not None and not c.stacked_kv) or (cache is None and backend == "cuda"):
            mask = mask.expand(b, s, k_len).contiguous()

        kw = dict(attn_backend=backend, deterministic=deterministic, generator=generator)
        for i, layer in enumerate(self.layers()):
            if cache is None:
                h = layer(h, mask, **kw)
            elif c.stacked_kv:
                h = layer(h, mask, position_offset, cache_kv=cache[f"kv{i:02d}"], **kw)
            else:
                h = layer(h, mask, position_offset, cache_k=cache[f"k{i:02d}"],
                          cache_v=cache[f"v{i:02d}"], **kw)

        logits = lm_logits_for_hidden(self.word_embed, c, h) if compute_logits else None
        if return_hidden:
            return logits, cache, h
        return logits, cache

    def empty_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Per-layer zeroed KV buffers in the model dtype, on the model's
        device: {'k00','v00',...} [B, max_len, H, D], or with
        ``cfg.stacked_kv`` {'kv00',...} [B, max_len, 2H] (keys ‖ values);
        under tensor parallelism this model rank's heads (H / model)."""
        c = self.cfg
        m = 1 if self.tp is None else self.tp.model
        kw = dict(dtype=c.dtype, device=self.word_embed.device)
        out: Dict[str, torch.Tensor] = {}
        for i in range(c.num_hidden_layers):
            if c.stacked_kv:
                out[f"kv{i:02d}"] = torch.zeros((batch_size, max_len, 2 * c.hidden_size // m),
                                                **kw)
            else:
                shape = (batch_size, max_len, c.num_attention_heads // m, c.d_head)
                out[f"k{i:02d}"] = torch.zeros(shape, **kw)
                out[f"v{i:02d}"] = torch.zeros(shape, **kw)
        return out


class GroverStage(nn.Module):
    """Stage ``stage_rank`` of ``n_stage`` of a pipeline-parallel GroverLM:
    global layers [stage_rank L/n_stage, (stage_rank + 1) L/n_stage) as
    ``stages.{j}``, and the replicated embeddings and ``embed_norm`` (stage
    0 uses them for the input, the last stage ``word_embed`` for the tied
    head)."""

    def __init__(self, cfg: GroverConfig, n_stage: int, stage_rank: int, device=None):
        super().__init__()
        if n_stage < 1 or cfg.num_hidden_layers % n_stage:
            raise ValueError(f"pipeline parallelism: {cfg.num_hidden_layers} layers do not "
                             f"split into {n_stage} stages (num_hidden_layers % pp must be 0)")
        if not 0 <= stage_rank < n_stage:
            raise ValueError(f"stage {stage_rank} of {n_stage}")
        self.cfg = c = cfg
        self.n_stage, self.stage_rank = n_stage, stage_rank
        self.word_embed = nn.Parameter(torch.empty(
            (c.vocab_size, c.hidden_size), dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            (c.max_position_embeddings, c.hidden_size), dtype=torch.float32,
            device=device))
        self.embed_norm = LayerNorm(c.hidden_size, device=device)
        per = c.num_hidden_layers // n_stage
        self.stages = nn.ModuleList([GroverLayer(c, device=device) for _ in range(per)])

    @property
    def first_layer(self) -> int:
        return self.stage_rank * len(self.stages)

    def init_tree(self, gen: torch.Generator) -> None:
        """Draw what ``init_params`` draws for the whole GroverLM, in its
        order (embeddings, ``embed_norm``, layer00 ...), keeping this
        stage's layers: the other layers' draws go to a scratch layer."""
        trunc_normal_(self.word_embed, self.cfg.initializer_range, gen)
        trunc_normal_(self.pos_embed, self.cfg.initializer_range, gen)
        init_params(self.embed_norm, gen)
        scratch = None
        for i in range(self.cfg.num_hidden_layers):
            j = i - self.first_layer
            if 0 <= j < len(self.stages):
                init_params(self.stages[j], gen)
                continue
            if scratch is None:
                scratch = GroverLayer(self.cfg, device=self.word_embed.device)
            init_params(scratch, gen)


def grover_pipeline_forward(stage: GroverStage, input_ids: torch.Tensor, *,
                            mesh, num_microbatches: int,
                            generator: Optional[torch.Generator] = None,
                            attn_backend: Optional[str] = None):
    """The training forward with the layer stack pipeline-parallel over
    ``mesh``'s stage axis (None: every layer in this process, the
    one-process run of the same schedule). Returns (logits, pipeline):
    on the last stage the [B, S, vocab] fp32 logits of the whole batch
    (the microbatches' outputs reassembled as JAX's ``out.reshape(b, s,
    H)``), None elsewhere; and the ``parallel.pipeline.Pipeline``, whose
    ``backward`` runs the reverse schedule after the loss's backward.
    With ``generator`` the hidden dropout is keyed per (layer, microbatch)
    from one seed drawn from it (the same draw on every stage), else none.
    Stage 0 does the embedding and ``embed_norm``; the causal mask is made
    once per microbatch shape, [mb, S, S] contiguous for the kernels."""
    from merlot_tpu_torch.parallel.pipeline import microbatch, pipeline_apply
    c = stage.cfg
    b, s = input_ids.shape
    dev = input_ids.device
    first = mesh is None or mesh.is_first_stage
    last = mesh is None or mesh.is_last_stage
    backend = attn_backend or training_backend(dev)
    if first:
        h = stage.word_embed[input_ids]
        h = stage.embed_norm(h + stage.pos_embed[:s][None])
        h_mb = microbatch(h, num_microbatches)
    else:  # later stages read only its shape
        h_mb = microbatch(torch.empty((b, s, c.hidden_size), device=dev), num_microbatches)
    mb = h_mb.shape[1]
    mask = (torch.arange(s, device=dev)[None] <= torch.arange(s, device=dev)[:, None]
            ).to(torch.float32)[None]
    if backend == "cuda":
        mask = mask.expand(mb, s, s).contiguous()
    seed = None
    if generator is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())

    def layer_fn(layer, hh, gen=None):
        return layer(hh, mask, attn_backend=backend, deterministic=gen is None,
                     generator=gen)

    pipe = pipeline_apply(layer_fn, list(stage.stages), h_mb, mesh, generator_seed=seed)
    if not last:
        return None, pipe
    out = pipe.outputs.reshape(b, s, c.hidden_size)
    return lm_logits_for_hidden(stage.word_embed, c, out), pipe


def lm_logits_for_hidden(word_embed: torch.Tensor, cfg: GroverConfig,
                         h: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits, fp32. With ``use_bfloat16`` the table is
    rounded to h's dtype first (the JAX package's bf16 operands with fp32
    accumulation); the product itself runs on fp32 operands, which hold
    bf16 values exactly, so no rounding of the result to bf16 happens (a
    bf16 matmul would round it). TF32 must be off."""
    table = word_embed.to(h.dtype) if cfg.use_bfloat16 else word_embed
    return torch.matmul(h.float(), table.float().t())


def pooled_hidden(hidden: torch.Tensor, input_ids: torch.Tensor,
                  clf_token: int) -> torch.Tensor:
    """Hidden state at the first occurrence of clf_token per row."""
    idx = (input_ids == clf_token).to(torch.float32).argmax(dim=1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


def grover_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor, is_target: torch.Tensor,
                   pad_token_id: int = 0, target_bonus: float = 4.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted next-token cross-entropy. logits [B, S, V] align with
    input_ids [B, S]; the targets are input_ids shifted left, pad-filled.
    Each non-pad target weighs 1, plus ``target_bonus`` where
    ``is_target``; the sums are over the weights plus 1e-5. Log-softmax in
    fp32. Returns (loss, {'loss', 'ctx_loss', 'trg_loss'}), the last two
    the loss's parts off and on the targets."""
    targets = torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], pad_token_id)],
                        dim=1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_tok = -logp.gather(-1, targets[..., None].long())[..., 0]
    is_t = is_target.float()
    w = (targets != pad_token_id).float() + is_t * target_bonus
    denom = w.sum() + 1e-5
    loss = (w * per_tok).sum() / denom
    ctx_loss = ((1 - is_t) * w * per_tok).sum() / denom
    trg_loss = (is_t * w * per_tok).sum() / denom
    return loss, {"loss": loss, "ctx_loss": ctx_loss, "trg_loss": trg_loss}


# ----------------------------------------------------------------------
# parameter trees (numpy leaves keyed by '/'-joined flax path)
# ----------------------------------------------------------------------
def stack_grover_params(flat: Mapping[str, np.ndarray], n_stage: int
                        ) -> Dict[str, np.ndarray]:
    """Standard leaves -> the pipeline-parallel form: the uniform
    ``layer{i:02d}/...`` subtrees become ``stages/...`` leaves [n_stage,
    L/n_stage, ...] (``parallel.pipeline.stack_stage_params``); the rest as
    is. JAX's ``stack_grover_params`` on a flat tree."""
    from merlot_tpu_torch.parallel.pipeline import stack_stage_params
    names = sorted({p.split("/")[0] for p in flat if p.startswith("layer")})
    layers = [{p[len(n) + 1:]: v for p, v in flat.items() if p.split("/")[0] == n}
              for n in names]
    out = {p: v for p, v in flat.items() if not p.startswith("layer")}
    out.update({f"stages/{k}": v for k, v in stack_stage_params(layers, n_stage).items()})
    return out


def shard_grover_pp_params(flat_pp: Mapping[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's ``GroverStage`` leaves from a stacked tree: its slice of
    ``stages`` as ``stages/{j}/...``, the rest (replicated) whole; a tree
    split in another number of stages is refused."""
    from merlot_tpu_torch.convert import stage_tree
    return stage_tree(flat_pp, mesh.stage_rank, mesh.stage)


def unstack_grover_params(flat: Mapping[str, np.ndarray],
                          num_layers: int) -> Dict[str, np.ndarray]:
    """A pipeline-parallel checkpoint's ``stages/...`` leaves [n_stage,
    L/n_stage, ...] -> standard ``layer{i:02d}/...`` leaves; the rest as is."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in flat.items():
        if not path.startswith("stages/"):
            out[path] = leaf
            continue
        arr = np.asarray(leaf)
        arr = arr.reshape((num_layers,) + arr.shape[2:])
        for i in range(num_layers):
            out[f"layer{i:02d}/{path[len('stages/'):]}"] = arr[i]
    return out


def fuse_qkv_for_serving(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Standard leaves -> those of a ``fused_qkv`` model: per layer the
    query/key/value kernels [H, H] become one ``qkv`` kernel [H, 3H] by
    column concatenation (biases likewise); a no-op on a fused tree."""
    out = dict(flat)
    layers = {p.split("/")[0] for p in flat if p.split("/")[1:2] == ["query"]}
    for layer in sorted(layers):
        for part in ("kernel", "bias"):
            out[f"{layer}/qkv/{part}"] = np.concatenate(
                [out.pop(f"{layer}/{k}/{part}") for k in ("query", "key", "value")],
                axis=-1)
    return out


def cast_params_for_serving(model: nn.Module) -> nn.Module:
    """Store every fp32 parameter of two or more dims in bf16, in place (the
    norm scales and biases stay fp32). Use with ``use_bfloat16=True``."""
    for p in model.parameters():
        if p.dtype == torch.float32 and p.dim() >= 2:
            p.data = p.data.to(torch.bfloat16)
    return model


# ----------------------------------------------------------------------
# sampling
# ----------------------------------------------------------------------
def _categorical(generator: Optional[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick."""
    return (logits + gumbel_noise(logits.shape, generator, logits.device)).argmax(dim=-1)


def _top_p_full_sort(generator: Optional[torch.Generator], logits: torch.Tensor,
                     p: float) -> torch.Tensor:
    """The reference's literal algorithm: sort the full vocab by prob, keep
    the ranks whose inclusive cumsum is < p plus rank 0, sample in sorted
    space."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    keep = sorted_probs.cumsum(dim=-1) < p
    keep[:, 0] = True
    sorted_logits = logits.gather(-1, order) - (~keep).to(torch.float32) * MASK_PENALTY
    pick = _categorical(generator, sorted_logits)
    return order.gather(-1, pick[:, None])[:, 0]


def top_p_sample(generator: Optional[torch.Generator], logits: torch.Tensor,
                 p: float, ignore_ids: Optional[torch.Tensor] = None,
                 k_prefilter: int = 128) -> torch.Tensor:
    """Nucleus sampling with the reference's keep rule: the tokens whose
    inclusive cumulative mass is < p, plus the argmax. logits [B, V] fp32
    -> [B] int64.

    With ``k_prefilter`` > 0 the full sort becomes a staged per-row ladder
    of top-k's (k, 8k, 64k while below the vocab; 128 -> 1024 -> 8192 at
    the default), each with the exact full-vocab softmax from one
    logsumexp: a row is served by the first stage whose top-k provably
    holds its nucleus (the k-th inclusive cumsum >= p), and rows no stage
    holds fall back to the full sort. Every stage samples the reference
    distribution exactly; among equal logits the lower index ranks first,
    as in XLA's TopK, so ties give the reference's kept set. A later stage runs only if some row needs it
    (one host sync per stage)."""
    if ignore_ids is not None:
        logits = logits - ignore_ids.to(torch.float32)[None] * MASK_PENALTY
    if p > 0.999999:
        return _categorical(generator, logits)
    vocab = logits.shape[-1]
    if not k_prefilter or k_prefilter >= vocab:
        return _top_p_full_sort(generator, logits, p)

    lse = torch.logsumexp(logits, dim=-1, keepdim=True)

    def stage(k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fits [B] bool, sample [B]) from the top-k kept set."""
        top_idx = top_k_indices(logits, k)
        top_logits = logits.gather(-1, top_idx)
        csum = torch.exp(top_logits - lse).cumsum(dim=-1)
        keep = csum < p
        keep[:, 0] = True
        pick = _categorical(generator, top_logits - (~keep).to(torch.float32) * MASK_PENALTY)
        return csum[:, -1] >= p, top_idx.gather(-1, pick[:, None])[:, 0]

    ladder = [k_prefilter]
    while len(ladder) < 3 and ladder[-1] * 8 < vocab:
        ladder.append(ladder[-1] * 8)
    fits, best = stage(ladder[0])
    for k in ladder[1:]:
        if bool(fits.all()):
            return best
        f_k, s_k = stage(k)
        best = torch.where(fits, best, s_k)
        fits = fits | f_k
    if bool(fits.all()):
        return best
    return torch.where(fits, best, _top_p_full_sort(generator, logits, p))


def top_k_sample(generator: Optional[torch.Generator], logits: torch.Tensor, k: int,
                 ignore_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k sampling: the k largest logits, renormalized. [B, V] -> [B]."""
    if ignore_ids is not None:
        logits = logits - ignore_ids.to(torch.float32)[None] * MASK_PENALTY
    top_idx = top_k_indices(logits, k)
    top_logits = logits.gather(-1, top_idx)
    pick = _categorical(generator, top_logits)
    return top_idx.gather(-1, pick[:, None])[:, 0]


def make_seq2seq_sampler(model: GroverLM, max_len: int, prefix_len: int,
                         p_for_topp: float = 0.95, eos_token: int = 3,
                         ignore_pad_only: bool = True, k_prefilter: int = 128,
                         report_probs: bool = True) -> Callable:
    """Build ``fn(initial_context [B, L0] (pad = generate here), generator)
    -> (tokens [B, max_len] int64, probs [B, max_len] fp32)``.

    Positions < prefix_len (at least 1, at most every row's context length,
    below max_len) are processed in one prefill pass without the logits
    head; the context-token probabilities come from the hidden states in
    128-position chunks. Then one token per step: each sampled token is
    overridden by the context token where the context has one (the
    force-fed denoising interface), until every row has produced
    ``eos_token`` (or is all pad) or ``max_len`` is reached. With
    ``report_probs=False`` the probability chain is skipped, the probs are
    all zero and the tokens are the same (the chain draws nothing)."""
    cfg = model.cfg
    if not 0 < prefix_len < max_len:
        raise ValueError(f"need 0 < prefix_len ({prefix_len}) < max_len ({max_len})")
    pad = cfg.pad_token_id

    @torch.inference_mode()
    def fn(initial_context, generator: Optional[torch.Generator] = None):
        dev = model.word_embed.device
        ctx = torch.as_tensor(np.asarray(initial_context), device=dev).long()
        b, l0 = ctx.shape
        ignore_ids = ((torch.arange(cfg.vocab_size, device=dev) == pad)
                      if ignore_pad_only else None)
        tokens = torch.full((b, max_len), pad, dtype=torch.long, device=dev)
        tokens[:, :prefix_len] = ctx[:, :prefix_len]
        probs = torch.zeros((b, max_len), dtype=torch.float32, device=dev)
        row_valid = (ctx != pad).any(dim=1)

        cache = model.empty_cache(b, max_len)
        _, cache, h = model(ctx[:, :prefix_len], cache=cache, position_offset=0,
                            return_hidden=True, compute_logits=False)
        if report_probs:
            # exp(logit_target - logsumexp) == softmax(...)[target]
            for c0 in range(0, prefix_len - 1, 128):
                c1 = min(c0 + 128, prefix_len - 1)
                lg = lm_logits_for_hidden(model.word_embed, cfg, h[:, c0:c1])
                tp = lg.gather(-1, ctx[:, c0 + 1:c1 + 1, None])[..., 0]
                probs[:, c0 + 1:c1 + 1] = torch.exp(tp - torch.logsumexp(lg, dim=-1))
        logits_last = lm_logits_for_hidden(model.word_embed, cfg,
                                           h[:, prefix_len - 1])

        def pick_token(pos: int, logits_last: torch.Tensor):
            sampled = top_p_sample(generator, logits_last, p_for_topp, ignore_ids,
                                   k_prefilter=k_prefilter)
            # force-feed: where the padded context still has a token at pos
            ctx_tok = ctx[:, min(pos, l0 - 1)]
            tok = torch.where((ctx_tok != pad) & (pos < l0), ctx_tok, sampled)
            if not report_probs:
                return tok, torch.zeros((b,), dtype=torch.float32, device=dev)
            lg_tok = logits_last.gather(-1, tok[:, None])[:, 0]
            return tok, torch.exp(lg_tok - torch.logsumexp(logits_last, dim=-1))

        tokens[:, prefix_len], probs[:, prefix_len] = pick_token(prefix_len, logits_last)
        pos = prefix_len + 1
        while pos < max_len:
            done = (tokens == eos_token).any(dim=1) | ~row_valid
            if bool(done.all()):
                break
            logits, cache = model(tokens[:, pos - 1:pos], cache=cache,
                                  position_offset=pos - 1)
            tokens[:, pos], probs[:, pos] = pick_token(pos, logits[:, 0])
            pos += 1
        return tokens, probs

    return fn
