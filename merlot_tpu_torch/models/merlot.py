"""MerlotModel — the joint video-frame + caption encoder (counterpart of
merlot_tpu/models/merlot.py).

Per forward:
  * every frame runs through the ViT backbone; CLS#1 is the image-side
    contrastive feature, CLS#0 + the 2x2-pooled grid feed the joint encoder;
  * with ``mask_input``, a language-only tower (the first
    ``num_lang_transformer_hidden_layers`` layers of the joint encoder when
    ``share_params``) gives per-chunk CLS contrastive features and the
    attention mass each token receives, which guides SpanBERT masking;
  * vision tokens get a per-segment index PE (the shuffled index for the
    temporal-ordering objective) plus a fresh 2-D grid PE, then an fp32 LN;
  * the joint bidirectional transformer runs over [viz ‖ lang] under the
    dense validity mask.

Hidden dropout runs unless ``deterministic``, from ``generator``, which also
makes the masking draws unless ``masking_draws`` gives them. The parameter
tree mirrors the flax one name for name (see convert.py).

Tensor parallelism (``parallel.mesh.shard_params`` sets ``tp``): the
towers' attention and MLPs are cut over the model axis
(nn/transformer.py), ``word_embeddings`` and ``lm_output_bias`` over the
vocabulary: the lookup sums the model ranks' rows and ``lm_logits`` gives
this rank's [..., V / model] slice. The lang-only tower's colsum is the
global one, so every model rank of one data index masks the same tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from merlot_tpu_torch.core import trace
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.nn.layers import (DenseTN, LayerNorm, _param, dropout,
                                        trunc_normal_)
from merlot_tpu_torch.nn.transformer import TransformerEncoder, TransformerHParams
from merlot_tpu_torch.nn.vit import PositionEmbedder2D, VisionBackbone
from merlot_tpu_torch.ops.activations import gelu
from merlot_tpu_torch.ops.masking import attention_guided_span_mask
from merlot_tpu_torch.parallel.tensor_parallel import vocab_parallel_embedding


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(x.square().sum(dim=dim, keepdim=True), min=eps))


class ProjectAndNorm(nn.Module):
    """Optional gelu-dense + LN, then dense + L2 normalize (fp32)."""

    def __init__(self, in_dim: int, out_dim: int, add_intermediate: bool = False,
                 initializer_range: float = 0.02, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, initializer_range=initializer_range,
                  device=device)
        self.add_intermediate = add_intermediate
        if add_intermediate:
            self.intermediate = DenseTN(in_dim, out_dim, **kw)
            self.ln = LayerNorm(out_dim, device=device)
            in_dim = out_dim
        self.proj = DenseTN(in_dim, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.add_intermediate:
            x = self.ln(gelu(self.intermediate(x)))
        return _l2_normalize(self.proj(x), dim=-1)


class TemporalHead(nn.Module):
    """Pairwise 4-way ordering MLP (fp32)."""

    def __init__(self, hidden_size: int, initializer_range: float = 0.02,
                 device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, initializer_range=initializer_range,
                  device=device)
        self.intermediate = DenseTN(2 * hidden_size, hidden_size, **kw)
        self.ln0 = LayerNorm(hidden_size, device=device)
        self.logits = DenseTN(hidden_size, 4, **kw)

    def forward(self, h_joint: torch.Tensor) -> torch.Tensor:
        return self.logits(self.ln0(gelu(self.intermediate(h_joint))))


class MerlotModel(nn.Module):
    def __init__(self, cfg: MerlotConfig, device=None):
        super().__init__()
        c = cfg
        if c.scan_layers or c.fused_qkv_params:
            raise NotImplementedError(
                "scan_layers / fused_qkv_params change the parameter tree and "
                "are not ported")
        self.cfg = c
        dtype = torch.bfloat16 if c.use_bfloat16 else torch.float32
        self.compute_dtype = dtype
        # fused_qkv and stem_space_to_depth are the same math over the same
        # parameters; the port runs the unfused form. fuse_ln_matmul, remat
        # and remat_policy are passed on to all three towers.

        vit_hp = TransformerHParams(
            hidden_size=c.hidden_size, num_layers=c.vit_num_layers,
            num_heads=c.num_attention_heads, intermediate_size=c.intermediate_size,
            initializer_range=c.initializer_range,
            hidden_dropout_prob=(c.vit_hidden_dropout_prob
                                 if c.vit_hidden_dropout_prob is not None
                                 else c.hidden_dropout_prob),
            attention_probs_dropout_prob=c.attention_probs_dropout_prob,
            dtype=dtype, softmax_fp32=c.attention_softmax_fp32,
            fuse_ln_matmul=c.fuse_ln_matmul, remat=c.remat, remat_policy=c.remat_policy)
        self.vision_backbone = VisionBackbone(
            patch_size=c.patch_size, hidden_size=c.hidden_size,
            num_cls_emb=c.num_cls_emb, resnet_layers=tuple(c.resnet_layers),
            spatial_pool_size=c.spatial_pool_size, vit_hp=vit_hp,
            initializer_range=c.initializer_range, dtype=dtype, device=device)

        joint_hp = dataclasses.replace(vit_hp, num_layers=c.num_hidden_layers,
                                       hidden_dropout_prob=c.hidden_dropout_prob)
        self.encoder = TransformerEncoder(joint_hp, device=device)
        if not c.share_params:
            self.langonly_encoder = TransformerEncoder(
                dataclasses.replace(joint_hp,
                                    num_layers=c.num_lang_transformer_hidden_layers),
                device=device)

        h = c.hidden_size
        self.word_embeddings = _param(c.vocab_size, h, device=device)
        self.position_embeddings = _param(c.max_position_embeddings, h, device=device)
        self.embed_norm = LayerNorm(h, device=device)
        self.langonly_position_embeddings = _param(c.max_position_embeddings, h,
                                                   device=device)
        self.langonly_embed_norm = LayerNorm(h, device=device)

        self.img_idx_pe = _param(c.max_vision_pos_embeddings, h, device=device)
        self.final_pe = PositionEmbedder2D(h, max_nimg=1, num_cls_emb=1,
                                           initializer_range=c.initializer_range,
                                           device=device)
        self.viz_final_ln = LayerNorm(h, device=device)

        # lm head, tied to word_embeddings
        if c.do_projection:
            self.lm_projection = DenseTN(h, h, dtype=torch.float32,
                                         initializer_range=c.initializer_range,
                                         device=device)
            self.lm_projection_ln = LayerNorm(h, device=device)
        if c.do_bias:
            self.lm_output_bias = _param(c.vocab_size, device=device)

        self.contrastive_lang_proj = ProjectAndNorm(
            h, c.contrastive_dim, add_intermediate=c.do_projection,
            initializer_range=c.initializer_range, device=device)
        self.contrastive_viz_proj = ProjectAndNorm(
            h, c.contrastive_dim, add_intermediate=c.do_projection,
            initializer_range=c.initializer_range, device=device)
        self.lang_viz_temporal = TemporalHead(h, c.initializer_range, device=device)
        self.viz_viz_temporal = TemporalHead(h, c.initializer_range, device=device)
        self.tp = None  # the mesh, once shard_params has cut the vocabulary

    def init_weights(self, gen: torch.Generator):
        """This module's own tables; submodules initialise themselves."""
        r = self.cfg.initializer_range
        for t in (self.word_embeddings, self.position_embeddings,
                  self.langonly_position_embeddings, self.img_idx_pe):
            trunc_normal_(t, r, gen)
        if self.cfg.do_bias:
            with torch.no_grad():
                self.lm_output_bias.zero_()

    # ------------------------------------------------------------------
    def embed_words(self, ids_2d: torch.Tensor, which: str = "joint",
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Word + position embedding, LN (fp32), dropout, cast to the compute
        dtype."""
        L = ids_2d.shape[1]
        if L > self.cfg.max_position_embeddings:
            raise ValueError(f"{L} tokens > {self.cfg.max_position_embeddings}")
        if self.tp is None:
            word = self.word_embeddings[ids_2d.long()]
        else:
            word = vocab_parallel_embedding(self.word_embeddings, ids_2d, self.tp)
        if which == "joint":
            normed = self.embed_norm(word + self.position_embeddings[:L][None])
        else:
            normed = self.langonly_embed_norm(
                word + self.langonly_position_embeddings[:L][None])
        normed = dropout(normed, self.cfg.hidden_dropout_prob,
                         deterministic=deterministic, generator=generator)
        return normed.to(self.compute_dtype)

    def vision_pos_emb(self, B: int, group: int, viz_chunk_len: int,
                       num_h: int, num_w: int,
                       shuffled_idx_img: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-segment index PE plus 2-D grid PE; fp32 [B or 1, P, H]."""
        c = self.cfg
        n = group * c.num_imgs
        if shuffled_idx_img is None:
            pe = self.img_idx_pe[:n]
            pe = pe[:, None].expand(n, viz_chunk_len, c.hidden_size)
            pe = pe.reshape(1, n * viz_chunk_len, c.hidden_size)
        else:
            pe = self.img_idx_pe[shuffled_idx_img.reshape(-1).long()]
            pe = pe[:, None].expand(pe.shape[0], viz_chunk_len, c.hidden_size)
            pe = pe.reshape(B, group * viz_chunk_len, c.hidden_size)
        grid_pe = self.final_pe(num_h, num_w, 1)                   # [(1+hw), H]
        return pe + grid_pe.repeat(n, 1)[None]

    # ------------------------------------------------------------------
    def forward(self, image: torch.Tensor, input_ids: torch.Tensor, *,
                mask_input: bool = False,
                shuffled_idx_img: Optional[torch.Tensor] = None,
                img_mask: Optional[torch.Tensor] = None,
                collect_attention: str = "none",
                deterministic: bool = True,
                attn_backend: str = "auto",
                generator: Optional[torch.Generator] = None,
                masking_draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
        """Forward pass.

        image: [n_images, h, w, 3] in [0, 1] (or uint8);
        input_ids: [batch, num_chunks, L_chunk] int, or [batch, L];
        mask_input: run the lang-only tower and attention-guided masking;
        shuffled_idx_img: [batch, num_chunks] per-segment PE index;
        img_mask: [batch, num_chunks] validity (None = all valid);
        collect_attention: 'none' | 'probs' (adds cross-modal telemetry);
        generator: dropout masks and, unless ``masking_draws`` gives them
        (``ops.masking.masking_draws``), the masking draws.
        """
        c = self.cfg
        drop = dict(deterministic=deterministic, generator=generator)
        dev = image.device
        if input_ids.dim() == 2:
            batch_size, lang_chunk_len = input_ids.shape
            num_chunks = group = 1
            input_ids3 = input_ids[:, None]
        else:
            batch_size, num_chunks, lang_chunk_len = input_ids.shape
            group = c.num_chunks_in_group or num_chunks
            if num_chunks % group:
                raise ValueError(f"{num_chunks} chunks not in groups of {group}")
            input_ids3 = input_ids
        B = batch_size * (num_chunks // group)
        L = lang_chunk_len * group

        # ---------------- vision tower --------------------------------
        with trace.span("model.vision"):
            vinfo = self.vision_backbone(image, attn_backend=attn_backend, **drop)
            num_h, num_w = vinfo["num_h"], vinfo["num_w"]
            viz_chunk_len = num_h * num_w + 1
            P = viz_chunk_len * group

            img_trg_h = vinfo["cls"][:, 1].float()
            image_feats = torch.cat([vinfo["cls"][:, 0:1], vinfo["seq"]], dim=1).float()

            img_batch_size = batch_size // c.num_texts
            if img_mask is None:
                img_mask2 = torch.ones((B // c.num_texts, c.num_imgs), dtype=torch.bool,
                                       device=dev)
            else:
                img_mask2 = img_mask.reshape(B // c.num_texts, c.num_imgs).bool()
            if c.num_imgs > 1 or c.num_texts > 1:
                image_feats = image_feats.reshape(img_batch_size, c.num_imgs,
                                                  *image_feats.shape[1:])
                if c.num_texts > 1:
                    image_feats = image_feats[:, None].expand(
                        -1, c.num_texts, *image_feats.shape[1:])
                    image_feats = image_feats.reshape(B, c.num_imgs,
                                                      *image_feats.shape[3:])
                    img_mask2 = img_mask2[:, None].expand(-1, c.num_texts, -1)
                    img_mask2 = img_mask2.reshape(B, c.num_imgs)

            image_feats = image_feats.reshape(B, P * c.num_imgs, c.hidden_size)
            img_valid = img_mask2[:, :, None].expand(-1, -1, P).reshape(B, P * c.num_imgs)
            image_feats = image_feats + self.vision_pos_emb(
                B, group, viz_chunk_len, num_h, num_w, shuffled_idx_img)
            image_feats = self.viz_final_ln(image_feats).to(self.compute_dtype)

        # ---------------- language tower + masking --------------------
        out: Dict[str, Any] = {}
        ids_to_use = input_ids3.reshape(B, L)
        if mask_input:
            with trace.span("model.language"):
                lang_trg_h, attn_mass = self._langonly(
                    input_ids3, batch_size, num_chunks, lang_chunk_len,
                    attn_backend=attn_backend, **drop)
            out["lang_trg_h"] = lang_trg_h
            # the mass only ranks tokens (JAX's top_k passes it no gradient)
            with trace.span("model.masking"):
                masked_ids, masked_idx = attention_guided_span_mask(
                    ids_to_use, attn_mass.detach().reshape(B, L),
                    vocab_size=c.vocab_size, masking_rate=c.masking_rate,
                    topk_perc=c.masking_use_topk_from_attn_perc,
                    choose_topk_prob=c.masking_choose_topk_prob,
                    do_spanbert=c.masking_do_spanbert,
                    spanbert_len_probs=c.masking_spanbert_len_probs,
                    use_attn=c.masking_use_attn, generator=generator,
                    draws=masking_draws)
            out["lang_mask_info"] = {"masked_ids": masked_ids,
                                     "masked_idx": masked_idx}
            ids_to_use = masked_ids

        # ---------------- joint encoder -------------------------------
        with trace.span("model.joint"):
            lang_embs = self.embed_words(ids_to_use, which="joint", **drop)
            lang_valid = ids_to_use != 0
            encoder_input = torch.cat([image_feats, lang_embs], dim=1)
            is_valid = torch.cat([img_valid, lang_valid], dim=1)
            attention_mask = (is_valid[:, None] & is_valid[:, :, None]).float()
            if c.disable_pairwise_lang_attn:
                # vision attends everywhere; lang chunks only within their segment
                seg = torch.cat([
                    torch.zeros(P * c.num_imgs, dtype=torch.int64, device=dev),
                    1 + torch.arange(L, device=dev) // lang_chunk_len])
                can = ((seg[:, None] == seg[None]) | (seg == 0)[None]
                       | (seg == 0)[:, None])
                attention_mask = attention_mask * can.float()[None]

            einfo = self.encoder(encoder_input, attention_mask,
                                 collect="probs" if collect_attention == "probs" else "none",
                                 attn_backend=attn_backend, **drop)
            hidden = einfo["hidden_state"]
        out.update({
            "encoder_hidden_states": {
                "viz": hidden[:, :P * c.num_imgs].float(),
                "lang": hidden[:, P * c.num_imgs:].float(),
            },
            "img_trg_h": img_trg_h,
            "is_valid": is_valid,
            "shapes": {"B": B, "L": L, "P": P, "viz_chunk_len": viz_chunk_len,
                       "lang_chunk_len": lang_chunk_len, "group": group,
                       "num_h": num_h, "num_w": num_w,
                       "batch_size": batch_size, "num_chunks": num_chunks},
            "input_ids": input_ids3,
        })
        if collect_attention == "probs":
            out["attention_log"] = self._attention_log(
                einfo["attn_probs"], is_valid, P * c.num_imgs)
        return out

    def _langonly(self, input_ids3, batch_size, num_chunks, lang_chunk_len, *,
                  attn_backend, deterministic, generator):
        """Language-only tower: per-chunk CLS features [batch*num_chunks, H]
        fp32 and the attention mass each token receives, summed over layers."""
        c = self.cfg
        if c.langonly_num_chunks_in_group is not None:
            g = c.langonly_num_chunks_in_group
            if num_chunks % g:
                raise ValueError(f"{num_chunks} chunks not in groups of {g}")
            ids_2d = input_ids3.reshape(batch_size * (num_chunks // g),
                                        lang_chunk_len * g)
        else:
            ids_2d = input_ids3.reshape(batch_size, lang_chunk_len * num_chunks)
        drop = dict(deterministic=deterministic, generator=generator)
        word_embs = self.embed_words(ids_2d, which="langonly", **drop)
        valid = ids_2d != 0
        mask = (valid[:, None] & valid[:, :, None]).float()
        enc = self.encoder if c.share_params else self.langonly_encoder
        n_layers = c.num_lang_transformer_hidden_layers if c.share_params else None
        info = enc(word_embs, mask, collect="colsum", attn_backend=attn_backend,
                   num_layers=n_layers, **drop)
        pooled = info["hidden_state"].reshape(
            batch_size * num_chunks, lang_chunk_len, c.hidden_size)[:, 0]
        return pooled.float(), info["attn_colsum"]

    def _attention_log(self, probs, is_valid, p_len):
        """Cross-modal attention-mass telemetry."""
        sp = probs.mean(dim=1).float()
        vf = is_valid.float()
        sp = sp * vf[:, None] * vf[:, :, None]
        sp = sp.mean(dim=0)
        sp = sp / sp.sum()
        pieces = {"viz": (0, p_len), "lang": (p_len, sp.shape[0])}
        log = {}
        for to_name, (ts, te) in pieces.items():
            for from_name, (fs, fe) in pieces.items():
                log[f"encoder/{from_name}2{to_name}"] = sp[ts:te, fs:fe].sum()
        return log

    # ------------------------------------------------------------------
    # heads
    # ------------------------------------------------------------------
    def lm_logits(self, hidden_state: torch.Tensor) -> torch.Tensor:
        """Tied-embedding LM head (fp32); under tensor parallelism this model
        rank's slice of the vocabulary, [..., V / model]."""
        c = self.cfg
        h = hidden_state.float()
        if c.do_projection:
            h = self.lm_projection_ln(gelu(self.lm_projection(h)))
        if self.tp is not None:
            h = self.tp.copy_to_model(h)
        logits = h @ self.word_embeddings.T
        if c.do_bias:
            logits = logits + self.lm_output_bias
        return logits

    def contrastive_features(self, lang_trg_h: torch.Tensor,
                             img_trg_h: torch.Tensor):
        return self.contrastive_lang_proj(lang_trg_h), self.contrastive_viz_proj(img_trg_h)

    def temporal_logits(self, xa: torch.Tensor, xb: torch.Tensor,
                        which: str = "lang_viz") -> torch.Tensor:
        """All-pairs 4-way temporal logits. xa, xb: [B, group, H] ->
        [B*group^2, 4]; pair (i, j) classes: 0 different video, 1 same
        position, 2 i<j, 3 i>j."""
        b, g, h = xa.shape
        xa_t = xa[:, :, None].expand(b, g, g, h).reshape(b, g * g, h)
        xb_t = xb[:, None].expand(b, g, g, h).reshape(b, g * g, h)
        h_joint = torch.cat([xa_t, xb_t], dim=2).reshape(b * g * g, 2 * h)
        head = self.lang_viz_temporal if which == "lang_viz" else self.viz_viz_temporal
        return head(h_joint.float())
