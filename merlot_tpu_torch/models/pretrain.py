"""Pretraining objectives: masked LM, contrastive matching, temporal ordering
(counterpart of merlot_tpu/models/pretrain.py).

total = lang + contrastive + temporal, with metrics under ``lang/``,
``contr/`` and ``temporal/``. The contrastive loss is written globally,
``CE(lang @ viz.T / temp, arange(N))`` over the whole batch.

Data parallelism (``mesh``, ``parallel.mesh.Mesh``): every term is written
over the global batch, the ranks' batches concatenated in rank order, as
the JAX package writes it and GSPMD partitions it. Each function then
returns this rank's share of the global value, so that the shares (and
their gradients) summed over the ranks give the global loss and metrics:
  * the masked LM's and the accuracies' denominators (valid tokens, pair
    weights) are summed over the ranks;
  * the contrastive loss gathers every rank's features (a gather whose
    backward sums each gradient into its owner) into the global N x N
    logits; this rank's rows give its share of lang->viz, its columns its
    share of viz->lang (each a mean over its rows x n / N);
  * the temporal means are over the global pairs (n / N of the local mean).
At world size 1 each share is computed by the same operations as without
a mesh, so its value is the same to the bit.

Tensor parallelism (the model's ``tp``): the masked LM's logits are this
model rank's slice of the vocabulary, so its cross-entropy and argmax are
the vocab-parallel ones (``parallel/tensor_parallel.py``); every other
term is replicated over the model ranks and sums over the data axis only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.ops.losses import cross_entropy_with_logits
from merlot_tpu_torch.parallel.mesh import Mesh
from merlot_tpu_torch.parallel.tensor_parallel import (vocab_parallel_argmax,
                                                       vocab_parallel_cross_entropy)


def mask_loss(model: MerlotModel, fwd: Dict[str, Any],
              mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict]:
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
    tp = model.tp
    if tp is None:
        raw = cross_entropy_with_logits(logits, targets_flat)
    else:
        raw = vocab_parallel_cross_entropy(logits, targets_flat, tp)

    is_valid = (targets_flat != 0).to(raw.dtype)
    count = is_valid.sum()
    if mesh is not None:
        count = mesh.all_reduce_sum(count)
    denom = count + 1e-5
    loss = (is_valid * raw).sum() / denom
    best = logits.argmax(-1) if tp is None else vocab_parallel_argmax(logits, tp)
    is_right = best == targets_flat.long()
    acc = (is_valid * is_right.float()).sum() / denom
    return loss, {"loss": loss, "acc": acc}


def contrastive_loss(model: MerlotModel, fwd: Dict[str, Any], cfg: MerlotConfig,
                     mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict]:
    lang_x, viz_x = model.contrastive_features(fwd["lang_trg_h"], fwd["img_trg_h"])
    n = lang_x.shape[0]
    if mesh is None:
        labels = torch.arange(n, device=lang_x.device)
        logits = (lang_x @ viz_x.T) / cfg.contrast_temp
        l2v = cross_entropy_with_logits(logits, labels).mean()
        v2l = cross_entropy_with_logits(logits.T, labels).mean()
    else:
        lang_all, viz_all = mesh.all_gather_rows(lang_x), mesh.all_gather_rows(viz_x)
        share = n / lang_all.shape[0]
        lo = mesh.rank * n
        labels = torch.arange(lo, lo + n, device=lang_x.device)
        logits = (lang_all @ viz_all.T) / cfg.contrast_temp
        l2v = cross_entropy_with_logits(logits[lo:lo + n], labels).mean() * share
        v2l = cross_entropy_with_logits(logits[:, lo:lo + n].T, labels).mean() * share
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
                  shuffled_idx_img: torch.Tensor, video_src_ids: torch.Tensor,
                  mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict]:
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
        w_sum = w.sum()
        if mesh is None:
            info[f"{name}_loss"] = raw.mean()
        else:  # this rank's n of the ranks' n * data pairs
            info[f"{name}_loss"] = raw.mean() * (1.0 / mesh.data)
            w_sum = mesh.all_reduce_sum(w_sum)
        right = logits.argmax(-1) == labels
        info[f"{name}_acc"] = (right.float() * w).sum() / (w_sum + 1e-5)

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
                collect_attention: str = "none",
                attn_backend: str = "auto",
                generator: Optional[torch.Generator] = None,
                masking_draws: Optional[Dict[str, torch.Tensor]] = None,
                mesh: Optional[Mesh] = None):
        """``mesh``: the batch is this rank's rows of the global batch and
        the loss and metrics are this rank's shares of the global ones
        (the module docstring). ``collect_attention='probs'`` adds the
        joint encoder's cross-modal attention mass to the metrics under
        ``attn/``."""
        cfg = self.cfg
        fwd = self.merlot(
            batch["images"], batch["input_ids"], mask_input=True,
            shuffled_idx_img=batch["shuffled_idx_img"],
            collect_attention=collect_attention, deterministic=deterministic,
            attn_backend=attn_backend, generator=generator,
            masking_draws=masking_draws)

        lang_l, lang_m = mask_loss(self.merlot, fwd, mesh)
        contr_l, contr_m = contrastive_loss(self.merlot, fwd, cfg, mesh)
        if cfg.temporal_coef > 0.0:
            temp_l, temp_m = temporal_loss(self.merlot, fwd, cfg,
                                           batch["shuffled_idx_img"],
                                           batch["video_src_ids"], mesh)
        else:
            temp_l, temp_m = 0.0, {}

        metrics = {f"lang/{k}": v for k, v in lang_m.items()}
        metrics.update({f"contr/{k}": v for k, v in contr_m.items()})
        metrics.update({f"temporal/{k}": v for k, v in temp_m.items()})
        if "attention_log" in fwd:
            metrics.update({f"attn/{k}": v for k, v in fwd["attention_log"].items()})
        loss = lang_l + contr_l + temp_l
        return loss, metrics, fwd

    def debug_forward(self, batch: Dict[str, torch.Tensor],
                      masking_draws: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, Any]:
        """The PREDICT-mode debug export (reference model/modeling.py:759-787):
        the forward with dropout off on the plain attention, collecting the
        joint encoder's head-meaned probs; returns the loss, the metrics
        (with the ``attn/`` telemetry), the lang tower's masked ids and
        positions, and the joint encoder's hidden states. The masking draws
        are ``masking_draws`` (``ops.masking.masking_draws``), else drawn
        from the device's default generator."""
        loss, metrics, fwd = self(batch, deterministic=True, collect_attention="probs",
                                  attn_backend="plain", masking_draws=masking_draws)
        return {"loss": loss, "metrics": metrics,
                "masked_ids": fwd["lang_mask_info"]["masked_ids"],
                "masked_idx": fwd["lang_mask_info"]["masked_idx"],
                "encoder_hidden_states": fwd["encoder_hidden_states"]}
