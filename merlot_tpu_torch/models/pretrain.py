"""Pretraining objectives: masked LM, contrastive matching, temporal ordering
(counterpart of merlot_tpu/models/pretrain.py).

total = lang + contrastive + temporal, with metrics under ``lang/``,
``contr/`` and ``temporal/``. The contrastive loss is written globally,
``CE(lang @ viz.T / temp, arange(N))`` over the whole batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.ops.losses import cross_entropy_with_logits


def mask_loss(model: MerlotModel, fwd: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    s = fwd["shapes"]
    B, L = s["B"], s["L"]
    hidden = fwd["encoder_hidden_states"]["lang"]          # [B, L, H] fp32
    masked_idx = fwd["lang_mask_info"]["masked_idx"]       # [B, M]
    ids_2d = fwd["input_ids"].reshape(B, L)

    pooled = torch.gather(hidden, 1, masked_idx[..., None].expand(
        -1, -1, hidden.shape[-1]))                          # [B, M, H]
    targets = torch.gather(ids_2d, 1, masked_idx)           # [B, M]

    logits = model.lm_logits(pooled.reshape(-1, hidden.shape[-1]))
    targets_flat = targets.reshape(-1)
    raw = cross_entropy_with_logits(logits, targets_flat)

    is_valid = (targets_flat != 0).to(raw.dtype)
    denom = is_valid.sum() + 1e-5
    loss = (is_valid * raw).sum() / denom
    is_right = logits.argmax(-1) == targets_flat.long()
    acc = (is_valid * is_right.float()).sum() / denom
    return loss, {"loss": loss, "acc": acc}


def contrastive_loss(model: MerlotModel, fwd: Dict[str, Any],
                     cfg: MerlotConfig) -> Tuple[torch.Tensor, Dict]:
    lang_x, viz_x = model.contrastive_features(fwd["lang_trg_h"], fwd["img_trg_h"])
    n = lang_x.shape[0]
    labels = torch.arange(n, device=lang_x.device)
    logits = (lang_x @ viz_x.T) / cfg.contrast_temp
    l2v = cross_entropy_with_logits(logits, labels).mean()
    v2l = cross_entropy_with_logits(logits.T, labels).mean()
    losses = {"lang_to_viz": l2v, "viz_to_lang": v2l}
    losses["loss_all"] = cfg.contrast_coef * (l2v + v2l) / 2.0
    return losses["loss_all"], losses


def _allpairs_temporal_labels(video_src_ids: torch.Tensor, group: int) -> torch.Tensor:
    """4-way labels for every segment pair: 0 different video, 1 same
    position, 2 i<j, 3 i>j. video_src_ids [B, group] -> [B*group*group]."""
    ga = torch.arange(group, device=video_src_ids.device)
    xa, xb = ga[:, None], ga[None]
    pos_label = ((xa == xb).long() + 2 * (xa < xb).long() + 3 * (xa > xb).long())
    same_video = video_src_ids[:, None] == video_src_ids[:, :, None]
    labels = torch.where(same_video, pos_label[None], torch.zeros_like(pos_label))
    return labels.reshape(-1)


def temporal_loss(model: MerlotModel, fwd: Dict[str, Any], cfg: MerlotConfig,
                  shuffled_idx_img: torch.Tensor,
                  video_src_ids: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    s = fwd["shapes"]
    B, group = s["B"], s["group"]
    h_lang = fwd["encoder_hidden_states"]["lang"].reshape(
        B, group, s["lang_chunk_len"], cfg.hidden_size)[:, :, 0]
    h_viz = fwd["encoder_hidden_states"]["viz"].reshape(
        B, group, s["viz_chunk_len"], cfg.hidden_size)[:, :, 0]

    # "easy" = PE index below 64 (the loader's shuffle offset decides)
    is_easy = shuffled_idx_img.reshape(B, group) < 64
    labels = _allpairs_temporal_labels(video_src_ids.reshape(B, group), group)

    info: Dict[str, torch.Tensor] = {}
    for name in ("lang_viz", "viz_viz"):
        xa = h_lang if name == "lang_viz" else h_viz
        logits = model.temporal_logits(xa, h_viz, which=name)   # [B*g*g, 4]
        easy_pair = is_easy[:, :, None] & is_easy[:, None]
        w = ((~easy_pair).float() * 0.99 + 0.01).reshape(-1)
        raw = cross_entropy_with_logits(logits, labels) * w
        info[f"{name}_loss"] = raw.mean()
        right = logits.argmax(-1) == labels
        info[f"{name}_acc"] = (right.float() * w).sum() / (w.sum() + 1e-5)

    loss = info["lang_viz_loss"]
    if cfg.image_shuffle_prob > 0:
        loss = loss + info["viz_viz_loss"]
    info["loss"] = loss
    return loss * cfg.temporal_coef, info


class MerlotPretrainModel(nn.Module):
    """Forward + all three objectives; returns (total_loss, metrics, fwd).

    The batch dict holds
      images           [img_batch*num_chunks, h, w, 3] float
      input_ids        [batch, num_chunks, L] int
      shuffled_idx_img [batch*num_chunks] int (flat, like the reference loader)
      video_src_ids    [batch, num_chunks] int
    The ``MerlotModel`` lives under ``merlot``, as in the flax tree.
    """

    def __init__(self, cfg: MerlotConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.merlot = MerlotModel(cfg, device=device)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = False,
                attn_backend: str = "auto",
                generator: Optional[torch.Generator] = None,
                masking_draws: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.cfg
        fwd = self.merlot(
            batch["images"], batch["input_ids"], mask_input=True,
            shuffled_idx_img=batch["shuffled_idx_img"], deterministic=deterministic,
            attn_backend=attn_backend, generator=generator,
            masking_draws=masking_draws)

        lang_l, lang_m = mask_loss(self.merlot, fwd)
        contr_l, contr_m = contrastive_loss(self.merlot, fwd, cfg)
        if cfg.temporal_coef > 0.0:
            temp_l, temp_m = temporal_loss(self.merlot, fwd, cfg,
                                           batch["shuffled_idx_img"],
                                           batch["video_src_ids"])
        else:
            temp_l, temp_m = 0.0, {}

        metrics = {f"lang/{k}": v for k, v in lang_m.items()}
        metrics.update({f"contr/{k}": v for k, v in contr_m.items()})
        metrics.update({f"temporal/{k}": v for k, v in temp_m.items()})
        loss = lang_l + contr_l + temp_l
        return loss, metrics, fwd
