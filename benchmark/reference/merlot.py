"""Plain PyTorch reference of MERLOT: the model, the attention-guided span
masking, the three pretraining objectives and zero-shot story ordering.

A frozen copy of the port's plain paths (``models/{merlot,pretrain}.py``,
``nn/vit.py``, ``ops/masking.py``, ``ops/sampling.py``,
``downstream/sort_story/zero_shot.py``), without tensor or data
parallelism, kernels or fused norms. The generator is drawn from at the
port's sites in the port's order: the ViT's dropout, the language tower's,
the masking draws, then the joint tower's. ``RefMerlotConfig`` takes a
configuration's model keys, whose ``use_bfloat16`` and
``attention_softmax_fp32`` say where the configuration computes in bf16;
``precision`` says what the reference rounds those sites to: nothing
(float32, the reference), bf16 (a witness) or float8 (the control).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from benchmark.reference.nn import (FP32, DenseTN, EncoderHParams, GroupNorm, LayerNorm,
                                    Precision, TransformerEncoder, WSConv, _param,
                                    avg_pool_same, avg_pool_valid, cross_entropy, dropout,
                                    gelu)

MASK, SPECIAL_TOKEN_CUTOFF = 1, 100
OPTION_PROBS = (0.1, 0.8, 0.1)  # keep, MASK, random id


@dataclass(frozen=True)
class RefMerlotConfig:
    hidden_size: int = 768
    vocab_size: int = 50370
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    max_vision_pos_embeddings: int = 1024
    image_size: Tuple[int, int] = (192, 352)
    patch_size: int = 16
    spatial_pool_size: int = 2
    num_cls_emb: int = 2
    resnet_layers: Tuple[int, ...] = ()
    num_vision_transformer_hidden_layers: Optional[int] = None
    num_lang_transformer_hidden_layers: int = 12
    num_chunks_in_group: Optional[int] = None
    hidden_dropout_prob: float = 0.1
    use_bfloat16: bool = True
    attention_softmax_fp32: bool = True
    do_projection: bool = False
    do_bias: bool = False
    masking_rate: float = 0.2
    masking_use_topk_from_attn_perc: float = 0.20
    masking_choose_topk_prob: float = 0.5
    masking_do_spanbert: bool = True
    masking_spanbert_len_probs: Tuple[float, ...] = (0.625, 0.25, 0.125)
    masking_use_attn: bool = True
    contrastive_size: Optional[int] = None
    contrast_temp: float = 0.05
    contrast_coef: float = 1.0
    temporal_coef: float = 1.0
    image_shuffle_prob: float = 0.0
    precision: str = "fp32"
    remat: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RefMerlotConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})


def reference_config(model_keys: Dict[str, Any], *, precision: str = "fp32",
                     remat: bool = False) -> RefMerlotConfig:
    return dataclasses.replace(RefMerlotConfig.from_dict(model_keys), precision=precision,
                               remat=remat)


# ---------------------------------------------------------------------------
# sampling and masking


def top_k_indices(values, k):
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


def gumbel_noise(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_categorical(log_probs, shape, generator, device):
    n = int(np.prod(shape))
    probs = torch.softmax(log_probs.float(), dim=-1).to(device)
    return torch.multinomial(probs, n, replacement=True, generator=generator).reshape(shape)


def masking_draws(batch, length, *, vocab_size, masking_rate, spanbert_len_probs,
                  generator, device):
    m = int(length * masking_rate)
    len_logp = torch.log(torch.tensor(spanbert_len_probs, dtype=torch.float32))
    opt_logp = torch.log(torch.tensor(OPTION_PROBS, dtype=torch.float32))
    return {
        "gumbel": gumbel_noise((batch, length), generator, device),
        "lo": sample_categorical(len_logp, (batch, m), generator, device),
        "hi": sample_categorical(len_logp, (batch, m), generator, device),
        "option": sample_categorical(opt_logp, (batch * length,), generator, device),
        "random_ids": torch.randint(SPECIAL_TOKEN_CUTOFF, vocab_size, (batch * length,),
                                    generator=generator, device=device),
    }


def span_mask(ids_in, attn_mass, c: RefMerlotConfig, generator):
    """Attention-guided SpanBERT masking: (masked ids [B, L], masked
    positions [B, int(L * rate)] ascending)."""
    b, length = ids_in.shape
    dev = ids_in.device
    num_topk = int(length * c.masking_use_topk_from_attn_perc)
    num = int(length * c.masking_rate)
    draws = masking_draws(b, length, vocab_size=c.vocab_size, masking_rate=c.masking_rate,
                          spanbert_len_probs=c.masking_spanbert_len_probs,
                          generator=generator, device=dev)
    ids = ids_in.long()
    is_special = (ids < SPECIAL_TOKEN_CUTOFF).float()
    positions = torch.arange(length, device=dev)
    p = c.masking_choose_topk_prob
    t = c.masking_use_topk_from_attn_perc
    nontopk_val = 0.01
    topk_val = nontopk_val * p * (1.0 - t) / (t * (1.0 - p))
    if c.masking_use_attn and attn_mass is not None:
        top = top_k_indices(attn_mass.float() * (1.0 - is_special), num_topk)
        important = torch.zeros((b, length), dtype=torch.bool, device=dev)
        important.scatter_(1, top, True)
        weight = important.float() * (topk_val - nontopk_val) + nontopk_val
    else:
        weight = torch.ones((b, length), dtype=torch.float32, device=dev)
    log_mask = torch.log(weight) - 1e8 * is_special
    idx = top_k_indices(log_mask + draws["gumbel"], num).flip(-1)
    if c.masking_do_spanbert:
        start, end = idx - draws["lo"], idx + draws["hi"]
        covers = ((positions[None, None] >= start[..., None])
                  & (positions[None, None] <= end[..., None]))
        which = torch.argmax(covers.float(), dim=1).float() * (1.0 - is_special)
        which = which + 0.5 * weight / weight.max()
        mask_idx = top_k_indices(which, num)
    else:
        mask_idx = idx
    mask_idx = torch.sort(mask_idx, dim=1).values
    do_mask = torch.zeros((b, length), dtype=torch.bool, device=dev)
    do_mask.scatter_(1, mask_idx, True)
    option = draws["option"] * do_mask.reshape(-1).long()
    flat = ids.reshape(-1)
    masked = torch.where(option == 0, flat,
                         torch.where(option == 1, torch.full_like(flat, MASK),
                                     draws["random_ids"].long()))
    return masked.reshape(b, length).to(ids_in.dtype), mask_idx


# ---------------------------------------------------------------------------
# the vision tower


class PositionEmbedder2D(nn.Module):
    def __init__(self, d, num_cls_emb=1, m=64, device=None):
        super().__init__()
        self.d, self.num_cls_emb = d, num_cls_emb
        self.pos_embs = _param(1, m, m, d, device=device)
        self.cls_emb = _param(1, num_cls_emb, d, device=device) if num_cls_emb else None

    def forward(self, num_h, num_w):
        grid = self.pos_embs[:1, :num_h, :num_w].reshape(1, num_h * num_w, self.d)
        if self.cls_emb is not None:
            grid = torch.cat([self.cls_emb[:1], grid], dim=1)
        return grid.reshape(self.num_cls_emb + num_h * num_w, self.d)


class BottleneckBlock(nn.Module):
    def __init__(self, cin, filters, strides, use_projection, p: Precision, device):
        super().__init__()
        kw = dict(p=p, device=device)
        self.p, self.strides, self.use_projection = p, strides, use_projection
        if use_projection:
            self.proj_conv = WSConv(cin, 4 * filters, 1, **kw)
            self.proj_gn = GroupNorm(4 * filters, device, p)
        self.conv1 = WSConv(cin, filters, 1, **kw)
        self.gn1 = GroupNorm(filters, device, p)
        self.conv2 = WSConv(filters, filters, 3, **kw)
        self.gn2 = GroupNorm(filters, device, p)
        self.conv3 = WSConv(filters, 4 * filters, 1, **kw)
        self.gn3 = GroupNorm(4 * filters, device, p)

    def forward(self, x):
        shortcut, st = x, self.strides
        if self.use_projection:
            s = avg_pool_same(x, st, st, self.p) if st > 1 else x
            shortcut = self.proj_gn(self.proj_conv(s))
        y = self.gn1(self.conv1(x), relu=True)
        y = self.gn2(self.conv2(y), relu=True)
        if st > 1:
            y = avg_pool_same(y, st, st, self.p)
        return self.gn3(self.conv3(y), residual=shortcut, relu=True)


class LiteResNet(nn.Module):
    def __init__(self, layers, width=64, p: Precision = FP32, remat=False, device=None):
        super().__init__()
        w, kw = width, dict(p=p, device=device)
        self.p, self.remat = p, remat
        self.stem_conv0 = WSConv(3, w // 2, 3, strides=2, **kw)
        self.stem_gn0 = GroupNorm(w // 2, device, p)
        self.stem_conv1 = WSConv(w // 2, w // 2, 3, **kw)
        self.stem_gn1 = GroupNorm(w // 2, device, p)
        self.stem_conv2 = WSConv(w // 2, w, 3, **kw)
        self.stem_gn2 = GroupNorm(w, device, p)
        self.block_names, cin = [], w
        for i, blocks in enumerate(layers):
            filters = w * 2 ** i
            for b in range(blocks):
                name = f"group{i + 1}_block{b}"
                self.add_module(name, BottleneckBlock(
                    cin, filters, (1 if i == 0 else 2) if b == 0 else 1, b == 0, p,
                    device))
                self.block_names.append(name)
                cin = 4 * filters
        self.out_channels = cin

    def stem(self, x):
        x = self.stem_gn0(self.stem_conv0(x), relu=True)
        x = self.stem_gn1(self.stem_conv1(x), relu=True)
        x = self.stem_gn2(self.stem_conv2(x), relu=True)
        return avg_pool_same(x, 2, 2, self.p)

    def forward(self, x):
        remat = self.remat and torch.is_grad_enabled()
        run = (lambda f, t: torch_checkpoint.checkpoint(f, t, use_reentrant=False)
               ) if remat else (lambda f, t: f(t))
        x = run(self.stem, x)
        for name in self.block_names:
            x = run(getattr(self, name), x)
        return x


class VisionBackbone(nn.Module):
    def __init__(self, c: "RefMerlotConfig", vit_hp: EncoderHParams, device):
        super().__init__()
        h, p = c.hidden_size, vit_hp.p
        self.patch, self.h, self.prec = c.patch_size, h, p
        self.num_cls_emb, self.sp = c.num_cls_emb, c.spatial_pool_size
        self.has_resnet = len(c.resnet_layers) > 0
        if self.has_resnet:
            self.resnet = LiteResNet(tuple(c.resnet_layers), 64, p, c.remat, device)
            self.post_resnet_proj = WSConv(self.resnet.out_channels, h, 1,
                                           weight_standardization=False, use_bias=True,
                                           p=p, device=device)
        else:
            self.patch_conv = WSConv(3, h, c.patch_size, strides=c.patch_size,
                                     weight_standardization=False, use_bias=True,
                                     padding="VALID", p=p, device=device)
        self.pos_emb2d = PositionEmbedder2D(h, c.num_cls_emb, device=device)
        self.patches_pre_ln = LayerNorm(h, device)
        self.encoder = TransformerEncoder(vit_hp, device)

    def forward(self, image, deterministic, generator):
        b, h0, w0, _ = image.shape
        if image.dtype == torch.uint8:
            image = image.float() * (1.0 / 255.0)
        p = self.prec
        img = p(p(image.float()) - 0.5)
        x = (self.post_resnet_proj(self.resnet(img)) if self.has_resnet
             else self.patch_conv(img))
        h1, w1, d = h0 // self.patch, w0 // self.patch, self.h
        x = x.reshape(b, h1 * w1, d).float()
        x = torch.cat([x.new_zeros(b, self.num_cls_emb, d), x], dim=1)
        x = self.patches_pre_ln(x + self.pos_emb2d(h1, w1)[None])
        hidden = self.encoder(x, None, deterministic=deterministic,
                              generator=generator)["hidden_state"]
        cls, seq = hidden[:, :self.num_cls_emb], hidden[:, self.num_cls_emb:]
        sp = self.sp
        if sp > 1:
            seq = avg_pool_valid(seq.reshape(b, h1, w1, d), sp, sp, p)
            h1, w1 = h1 // sp, w1 // sp
            seq = seq.reshape(b, h1 * w1, d)
        return {"cls": cls, "seq": seq, "num_h": h1, "num_w": w1}


# ---------------------------------------------------------------------------
# the model


def _l2_normalize(x, eps=1e-12):
    return x / torch.sqrt(torch.clamp(x.square().sum(dim=-1, keepdim=True), min=eps))


class ProjectAndNorm(nn.Module):
    def __init__(self, d_in, d_out, add_intermediate, device):
        super().__init__()
        self.add_intermediate = add_intermediate
        if add_intermediate:
            self.intermediate = DenseTN(d_in, d_out, device=device)
            self.ln = LayerNorm(d_out, device)
            d_in = d_out
        self.proj = DenseTN(d_in, d_out, device=device)

    def forward(self, x):
        if self.add_intermediate:
            x = self.ln(gelu(self.intermediate(x)))
        return _l2_normalize(self.proj(x))


class TemporalHead(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.intermediate = DenseTN(2 * h, h, device=device)
        self.ln0 = LayerNorm(h, device)
        self.logits = DenseTN(h, 4, device=device)

    def forward(self, x):
        return self.logits(self.ln0(gelu(self.intermediate(x))))


class MerlotModel(nn.Module):
    def __init__(self, c: RefMerlotConfig, device=None):
        super().__init__()
        self.cfg = c
        # the sites the configuration computes in bf16, rounded to c.precision
        p = Precision(c.precision) if c.use_bfloat16 else FP32
        self.p = p
        h = c.hidden_size
        vit_hp = EncoderHParams(
            hidden_size=h, num_layers=c.num_vision_transformer_hidden_layers
            or c.num_hidden_layers, num_heads=c.num_attention_heads,
            intermediate_size=c.intermediate_size, hidden_dropout_prob=c.hidden_dropout_prob,
            p=p, p_sm=FP32 if c.attention_softmax_fp32 else p, remat=c.remat)
        self.vision_backbone = VisionBackbone(c, vit_hp, device)
        self.encoder = TransformerEncoder(
            dataclasses.replace(vit_hp, num_layers=c.num_hidden_layers), device)
        self.word_embeddings = _param(c.vocab_size, h, device=device)
        self.position_embeddings = _param(c.max_position_embeddings, h, device=device)
        self.embed_norm = LayerNorm(h, device)
        self.langonly_position_embeddings = _param(c.max_position_embeddings, h, device=device)
        self.langonly_embed_norm = LayerNorm(h, device)
        self.img_idx_pe = _param(c.max_vision_pos_embeddings, h, device=device)
        self.final_pe = PositionEmbedder2D(h, 1, device=device)
        self.viz_final_ln = LayerNorm(h, device)
        if c.do_projection:
            self.lm_projection = DenseTN(h, h, device=device)
            self.lm_projection_ln = LayerNorm(h, device)
        if c.do_bias:
            self.lm_output_bias = _param(c.vocab_size, device=device)
        d = c.contrastive_size or h
        self.contrastive_lang_proj = ProjectAndNorm(h, d, c.do_projection, device)
        self.contrastive_viz_proj = ProjectAndNorm(h, d, c.do_projection, device)
        self.lang_viz_temporal = TemporalHead(h, device)
        self.viz_viz_temporal = TemporalHead(h, device)

    def embed_words(self, ids_2d, which, deterministic, generator):
        length = ids_2d.shape[1]
        word = self.word_embeddings[ids_2d.long()]
        if which == "joint":
            normed = self.embed_norm(word + self.position_embeddings[:length][None])
        else:
            normed = self.langonly_embed_norm(
                word + self.langonly_position_embeddings[:length][None])
        normed = dropout(normed, self.cfg.hidden_dropout_prob, deterministic=deterministic,
                         generator=generator)
        return self.p(normed)

    def forward(self, image, input_ids, *, mask_input=False, shuffled_idx_img=None,
                deterministic=True, generator=None) -> Dict[str, Any]:
        c = self.cfg
        drop = dict(deterministic=deterministic, generator=generator)
        dev = image.device
        batch_size, num_chunks, chunk_len = input_ids.shape
        group = c.num_chunks_in_group or num_chunks
        B, L = batch_size * (num_chunks // group), chunk_len * group

        vinfo = self.vision_backbone(image, **drop)
        num_h, num_w = vinfo["num_h"], vinfo["num_w"]
        viz_chunk_len = num_h * num_w + 1
        P = viz_chunk_len * group
        img_trg_h = vinfo["cls"][:, 1].float()
        feats = torch.cat([vinfo["cls"][:, 0:1], vinfo["seq"]], dim=1).float()
        feats = feats.reshape(B, P, c.hidden_size)
        if shuffled_idx_img is None:
            pe = self.img_idx_pe[:group][:, None].expand(group, viz_chunk_len, c.hidden_size)
            pe = pe.reshape(1, P, c.hidden_size)
        else:
            pe = self.img_idx_pe[shuffled_idx_img.reshape(-1).long()]
            pe = pe[:, None].expand(pe.shape[0], viz_chunk_len, c.hidden_size)
            pe = pe.reshape(B, P, c.hidden_size)
        feats = feats + (pe + self.final_pe(num_h, num_w).repeat(group, 1)[None])
        feats = self.p(self.viz_final_ln(feats))

        out: Dict[str, Any] = {}
        ids = input_ids.reshape(B, L)
        if mask_input:
            ids_lang = input_ids.reshape(batch_size, chunk_len * num_chunks)
            embs = self.embed_words(ids_lang, "langonly", **drop)
            valid = ids_lang != 0
            info = self.encoder(embs, (valid[:, None] & valid[:, :, None]).float(),
                                collect="colsum",
                                num_layers=c.num_lang_transformer_hidden_layers, **drop)
            out["lang_trg_h"] = info["hidden_state"].reshape(
                batch_size * num_chunks, chunk_len, c.hidden_size)[:, 0].float()
            ids, out["masked_idx"] = span_mask(
                ids, info["attn_colsum"].detach().reshape(B, L), c, generator)
        lang = self.embed_words(ids, "joint", **drop)
        img_valid = torch.ones((B, P), dtype=torch.bool, device=dev)
        is_valid = torch.cat([img_valid, ids != 0], dim=1)
        mask = (is_valid[:, None] & is_valid[:, :, None]).float()
        hidden = self.encoder(torch.cat([feats, lang], dim=1), mask, **drop)["hidden_state"]
        out.update({"viz": hidden[:, :P].float(), "lang": hidden[:, P:].float(),
                    "img_trg_h": img_trg_h, "input_ids": input_ids,
                    "shapes": {"B": B, "L": L, "group": group, "lang_chunk_len": chunk_len,
                               "viz_chunk_len": viz_chunk_len}})
        return out

    def lm_logits(self, h):
        h = h.float()
        if self.cfg.do_projection:
            h = self.lm_projection_ln(gelu(self.lm_projection(h)))
        logits = h @ self.word_embeddings.T
        return logits + self.lm_output_bias if self.cfg.do_bias else logits

    def temporal_logits(self, xa, xb, which):
        b, g, h = xa.shape
        xa_t = xa[:, :, None].expand(b, g, g, h).reshape(b, g * g, h)
        xb_t = xb[:, None].expand(b, g, g, h).reshape(b, g * g, h)
        joint = torch.cat([xa_t, xb_t], dim=2).reshape(b * g * g, 2 * h)
        head = self.lang_viz_temporal if which == "lang_viz" else self.viz_viz_temporal
        return head(joint.float())


# ---------------------------------------------------------------------------
# the pretraining objectives


def _temporal_labels(video_src_ids, group):
    ga = torch.arange(group, device=video_src_ids.device)
    xa, xb = ga[:, None], ga[None]
    pos = (xa == xb).long() + 2 * (xa < xb).long() + 3 * (xa > xb).long()
    same = video_src_ids[:, None] == video_src_ids[:, :, None]
    return torch.where(same, pos[None], torch.zeros_like(pos)).reshape(-1)


class MerlotPretrainModel(nn.Module):
    """total loss = masked LM + contrastive + temporal, as the port writes
    them for one process; the MerlotModel lives under ``merlot``."""

    def __init__(self, c: RefMerlotConfig, device=None):
        super().__init__()
        self.cfg = c
        self.merlot = MerlotModel(c, device)

    def forward(self, batch, generator):
        """(total loss, {the contrastive loss's two directions})."""
        c, m = self.cfg, self.merlot
        fwd = m(batch["images"], batch["input_ids"], mask_input=True,
                shuffled_idx_img=batch["shuffled_idx_img"], deterministic=False,
                generator=generator)
        s = fwd["shapes"]
        B, L, group, H = s["B"], s["L"], s["group"], c.hidden_size
        # masked LM
        idx = fwd["masked_idx"]
        pooled = torch.gather(fwd["lang"], 1, idx[..., None].expand(-1, -1, H))
        targets = torch.gather(fwd["input_ids"].reshape(B, L), 1, idx).reshape(-1)
        raw = cross_entropy(m.lm_logits(pooled.reshape(-1, H)), targets)
        valid = (targets != 0).to(raw.dtype)
        lang = (valid * raw).sum() / (valid.sum() + 1e-5)
        # contrastive
        lx = m.contrastive_lang_proj(fwd["lang_trg_h"])
        vx = m.contrastive_viz_proj(fwd["img_trg_h"])
        labels = torch.arange(lx.shape[0], device=lx.device)
        logits = (lx @ vx.T) / c.contrast_temp
        l2v = cross_entropy(logits, labels).mean()
        v2l = cross_entropy(logits.T, labels).mean()
        contr = c.contrast_coef * (l2v + v2l) / 2.0
        # temporal
        total = lang + contr
        if c.temporal_coef > 0.0:
            h_lang = fwd["lang"].reshape(B, group, s["lang_chunk_len"], H)[:, :, 0]
            h_viz = fwd["viz"].reshape(B, group, s["viz_chunk_len"], H)[:, :, 0]
            easy = batch["shuffled_idx_img"].reshape(B, group) < 64
            tl = _temporal_labels(batch["video_src_ids"].reshape(B, group), group)
            w = ((~(easy[:, :, None] & easy[:, None])).float() * 0.99 + 0.01).reshape(-1)
            parts = {}
            for name, xa in (("lang_viz", h_lang), ("viz_viz", h_viz)):
                parts[name] = (cross_entropy(m.temporal_logits(xa, h_viz, name), tl) * w).mean()
            temporal = parts["lang_viz"]
            if c.image_shuffle_prob > 0:
                temporal = temporal + parts["viz_viz"]
            total = total + temporal * c.temporal_coef
        return total, {"contr/lang_to_viz": l2v, "contr/viz_to_lang": v2l}


# ---------------------------------------------------------------------------
# zero-shot story ordering

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(key, x0, x1):
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def shuffled_frame_idx(rows: int, n: int) -> torch.Tensor:
    """The zero-shot method's fixed frame-PE permutations + 64 [rows, n]:
    ``uniform(fold_in(PRNGKey(123), 1234), (rows * n,))``, each row's
    stable argsort (JAX's threefry, reproduced)."""
    y0, y1 = _threefry((0, 123), np.array([0], np.uint32), np.array([1234], np.uint32))
    key = (int(y0[0]), int(y1[0]))
    i = np.arange(rows * n, dtype=np.uint64)
    a, b = _threefry(key, (i >> np.uint64(32)).astype(np.uint32),
                     (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    u = (((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    idx = np.argsort(u.reshape(rows, n), axis=1, kind="stable")
    return torch.from_numpy(idx).long() + 64


@torch.no_grad()
def zero_shot_logits(model: MerlotModel, images, sentences, dup: int = 2):
    """The temporal heads' logits of one batch {lang_viz, viz_viz}
    [stories*dup*n*n, 4], after the method's x``dup`` tiling of the rows."""
    b, n, h, w, _ = images.shape
    imgs = images.repeat(dup, 1, 1, 1, 1).reshape(b * dup * n, h, w, 3)
    sents = sentences.repeat(dup, 1, 1)[:, :, :32]
    idx = shuffled_frame_idx(b * dup, n).to(images.device)
    fwd = model(imgs, sents, shuffled_idx_img=idx)
    s, H = fwd["shapes"], model.cfg.hidden_size
    h_lang = fwd["lang"].reshape(s["B"], s["group"], s["lang_chunk_len"], H)[:, :, 0]
    h_viz = fwd["viz"].reshape(s["B"], s["group"], s["viz_chunk_len"], H)[:, :, 0]
    return {name: model.temporal_logits(xa, h_viz, name)
            for name, xa in (("lang_viz", h_lang), ("viz_viz", h_viz))}


def zero_shot_probs(logits: Dict[str, torch.Tensor], stories: int, n: int, dup: int = 2):
    """Classes 1..3's probs, read back in the method's (kept) duplicate
    order and meaned: {lang_viz_probs, viz_viz_probs} [stories, n, n, 3]."""
    return {f"{k}_probs": torch.softmax(v, dim=-1)[:, 1:].reshape(stories, dup, n, n, 3)
            .mean(dim=1) for k, v in logits.items()}

