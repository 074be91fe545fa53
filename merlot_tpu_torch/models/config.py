"""Typed model config: a copy of ``merlot_tpu.models.config.MerlotConfig``.

Copied rather than imported because importing anything under ``merlot_tpu``
loads jax and flax (``merlot_tpu/__init__.py``), and this package never
does. The fields, defaults and ``from_dict`` are identical, so a config
built for one package builds the other. Execution-strategy fields that the
PyTorch port does not implement (``scan_layers``, ``remat``,
``fused_qkv*``, ``stem_space_to_depth``) are kept so that configs parse
unchanged; the modules refuse or ignore them. ``fuse_ln_matmul`` is ported
(K5, ``ops/cuda_ln_matmul.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MerlotConfig:
    # core shapes
    hidden_size: int = 768
    vocab_size: int = 50370
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    max_vision_pos_embeddings: int = 1024   # model/modeling.py:308
    initializer_range: float = 0.02

    # vision
    image_size: Tuple[int, int] = (192, 352)
    patch_size: int = 16
    spatial_pool_size: int = 2
    num_cls_emb: int = 2                    # vision_transformer.py:183
    resnet_layers: Tuple[int, ...] = ()
    num_vision_transformer_hidden_layers: Optional[int] = None
    vit_hidden_dropout_prob: Optional[float] = None

    # towers
    num_lang_transformer_hidden_layers: int = 12
    share_params: bool = True
    disable_pairwise_lang_attn: bool = False
    langonly_num_chunks_in_group: Optional[int] = None

    # grouping / duplication
    num_chunks_in_group: Optional[int] = None  # None -> all chunks in one group
    num_imgs: int = 1
    num_texts: int = 1

    # dropout / precision
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.0
    use_bfloat16: bool = True

    # lm head
    do_projection: bool = False
    do_bias: bool = False

    # masking (model/modeling.py:390-399 defaults)
    masking_rate: float = 0.2
    masking_use_topk_from_attn_perc: float = 0.20
    masking_choose_topk_prob: float = 0.5
    masking_do_spanbert: bool = True
    masking_spanbert_len_probs: Tuple[float, ...] = (0.625, 0.25, 0.125)
    masking_use_attn: bool = True

    # contrastive (model/modeling.py:495-525)
    contrastive_size: Optional[int] = None  # None -> hidden_size
    contrast_temp: float = 0.05
    contrast_coef: float = 1.0

    # temporal (model/modeling.py:622-668)
    temporal_coef: float = 1.0
    image_shuffle_prob: float = 0.0

    # execution strategy (TPU-first; no reference analogue)
    scan_layers: bool = False   # lax.scan over transformer layers
    remat: bool = False         # checkpoint each layer in backward
    # remat policy: None (recompute all) | 'dots' (save matmul outputs,
    # recompute elementwise) | 'dots_no_batch' (save weight-stationary only)
    remat_policy: Optional[str] = None
    # fp32 softmax (default, safer) vs compute-dtype softmax (the
    # reference's bf16 behaviour; halves attention HBM traffic)
    attention_softmax_fp32: bool = True
    # fuse pre-LNs into their consumer matmuls (the LN+matmul kernel K5 on
    # a card, its plain version on the CPU; identical math + param tree)
    fuse_ln_matmul: bool = False
    # one [H, 3H] q/k/v projection per attention (bit-identical outputs,
    # unchanged param tree; see TransformerHParams.fused_qkv)
    fused_qkv: bool = False
    # canonical fused form: the param tree stores one attention/qkv
    # entry per attention (no apply-time concat); checkpoints stay in
    # the reference-split form via train/checkpoint.{fuse,unfuse}_qkv_tree
    # at the save/restore boundary. See TransformerHParams.fused_qkv_params.
    fused_qkv_params: bool = False
    # run the RGB stem conv as a stride-1 2x2 conv over the
    # space-to-depth input (mathematically identical, MXU-friendlier
    # contraction dim; param tree/checkpoints unchanged). See
    # nn.layers.WSConv.space_to_depth.
    stem_space_to_depth: bool = False

    # checkpoint warm start
    init_checkpoint: Optional[str] = None

    # data-layout flag kept for config compat; the JAX rebuild never
    # transposes (XLA handles NHWC layouts natively)
    transpose_input: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MerlotConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in names:
                continue  # data-section keys may be merged in; ignore unknowns
            if isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    # ------------------------------------------------------------------
    @property
    def d_head(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def vit_num_layers(self) -> int:
        return self.num_vision_transformer_hidden_layers or self.num_hidden_layers

    @property
    def contrastive_dim(self) -> int:
        return self.contrastive_size or self.hidden_size

    def eval_mode(self) -> "MerlotConfig":
        """Copy with dropout zeroed (the reference zeroes both when
        is_training=False, model/modeling.py:88-90)."""
        return dataclasses.replace(
            self, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            vit_hidden_dropout_prob=0.0)
