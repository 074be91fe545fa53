"""Convert the reference's released TF1 checkpoints into this package's
parameters (counterpart of merlot_tpu/tools/convert_tf_checkpoint.py).

The reference restores weights by TF1 name intersection
(utils/model_utils.py:388-413). This package's parameters are named by
their flax paths (``convert.flax_path``), so conversion is an explicit
name map from the reference's variable scopes to those paths:

  * transformer blocks (utils/transformer.py): ``layerNN/query_layer`` etc.,
    with ``LayerNorm_<name>`` scopes from layer_norm's naming rule
    (utils/model_utils.py:115);
  * the hybrid ResNet (utils/vision_transformer.py:118-170): anonymous
    tf.layers scopes enumerate ``conv2d, conv2d_1, ...`` / ``GroupNorm,
    GroupNorm_1, ...`` sequentially within each block_group, in creation
    order (projection conv+GN first in each group's block 0);
  * embedders create their variable directly under the calling scope
    (model/modeling.py:275-292, 305-311).

Tensor layouts transfer 1:1 (TF dense kernels are [in, out] as in the flax
layout; conv kernels are HWIO in both), so conversion is renaming alone.
``convert_arrays`` returns a flat ``{flax path: array}`` dict, which
``train.checkpoint.save_params_checkpoint`` writes as a params-only
checkpoint directory
(``params.npz`` + ``meta.json``): the zero-shot CLI reads it from
``output_dir/checkpoints/ckpt_N``, the pretraining and VCR warm starts
(``model.init_checkpoint``) from the directory, and the denoise server's
``--ckpt`` from its ``params.npz``.

Reading a TF checkpoint needs tensorflow, imported inside
``load_tf_checkpoint_arrays`` only; ``convert_arrays`` takes a numpy dict
keyed by TF name, so a machine without TF converts arrays read elsewhere.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from merlot_tpu_torch.convert import flax_layout, flax_path
from merlot_tpu_torch.models.config import MerlotConfig


# ----------------------------------------------------------------------
# name-map construction
# ----------------------------------------------------------------------
def _transformer_layer_map(tf_scope: str, our_scope: str, num_layers: int
                           ) -> Dict[str, str]:
    m: Dict[str, str] = {}
    for i in range(num_layers):
        tf_l = f"{tf_scope}/layer{i:02d}"
        our_l = f"{our_scope}/layer{i:02d}"
        m[f"{tf_l}/LayerNorm_attn_ln0/gamma"] = f"{our_l}/attn_ln/gamma"
        m[f"{tf_l}/LayerNorm_attn_ln0/beta"] = f"{our_l}/attn_ln/beta"
        for tf_name, our_name in (("query_layer", "query"),
                                  ("key_layer", "key"),
                                  ("value_layer", "value"),
                                  ("context_projection_layer", "out_proj")):
            m[f"{tf_l}/{tf_name}/kernel"] = f"{our_l}/attention/{our_name}/kernel"
            m[f"{tf_l}/{tf_name}/bias"] = f"{our_l}/attention/{our_name}/bias"
        m[f"{tf_l}/LayerNorm_mlp_ln0/gamma"] = f"{our_l}/mlp_ln/gamma"
        m[f"{tf_l}/LayerNorm_mlp_ln0/beta"] = f"{our_l}/mlp_ln/beta"
        for p in ("kernel", "bias"):
            m[f"{tf_l}/intermediate/{p}"] = f"{our_l}/mlp/intermediate/{p}"
            m[f"{tf_l}/output/{p}"] = f"{our_l}/mlp/output/{p}"
    m[f"{tf_scope}/LayerNorm_ln_final/gamma"] = f"{our_scope}/final_ln/gamma"
    m[f"{tf_scope}/LayerNorm_ln_final/beta"] = f"{our_scope}/final_ln/beta"
    return m


def _resnet_map(tf_scope: str, our_scope: str,
                resnet_layers: Tuple[int, ...]) -> Dict[str, str]:
    """Map the reference's sequentially numbered conv/GN scopes to the
    named blocks. Creation order per group: block0 = proj conv+GN, then
    conv1/gn1, conv2/gn2, conv3/gn3; later blocks have no projection."""
    def tf_idx(i):  # anonymous-scope suffix convention
        return "" if i == 0 else f"_{i}"

    m: Dict[str, str] = {}
    stem = f"{tf_scope}/stem"
    for i in range(3):
        m[f"{stem}/conv2d{tf_idx(i)}/kernel"] = f"{our_scope}/stem_conv{i}/kernel"
        m[f"{stem}/GroupNorm_stem{i}/gamma"] = f"{our_scope}/stem_gn{i}/gamma"
        m[f"{stem}/GroupNorm_stem{i}/beta"] = f"{our_scope}/stem_gn{i}/beta"

    for g, blocks in enumerate(resnet_layers):
        tf_g = f"{tf_scope}/block_group{g + 1}"
        idx = 0
        for b in range(blocks):
            our_b = f"{our_scope}/group{g + 1}_block{b}"
            parts = ([("proj_conv", "proj_gn")] if b == 0 else []) + \
                [("conv1", "gn1"), ("conv2", "gn2"), ("conv3", "gn3")]
            for conv_name, gn_name in parts:
                m[f"{tf_g}/conv2d{tf_idx(idx)}/kernel"] = f"{our_b}/{conv_name}/kernel"
                m[f"{tf_g}/GroupNorm{tf_idx(idx)}/gamma"] = f"{our_b}/{gn_name}/gamma"
                m[f"{tf_g}/GroupNorm{tf_idx(idx)}/beta"] = f"{our_b}/{gn_name}/beta"
                idx += 1
    return m


def merlot_tf_name_map(cfg: MerlotConfig, root: str = "merlot",
                       include_vcr_heads: bool = False) -> Dict[str, str]:
    """{tf_variable_name: flax path} for a MerlotModel tree rooted at
    ``root`` (MerlotPretrainModel and VCRModel root it at 'merlot'; the
    VCR heads sit beside it)."""
    m: Dict[str, str] = {}
    vb = "vision_backbone"
    vt = f"{vb}/vision_transformer"
    ours_vb = f"{root}/vision_backbone"

    if cfg.resnet_layers:
        m.update(_resnet_map(f"{vt}/resnet50lite", f"{ours_vb}/resnet",
                             tuple(cfg.resnet_layers)))
        m[f"{vt}/conv_postresnet_proj/kernel"] = f"{ours_vb}/post_resnet_proj/kernel"
        m[f"{vt}/conv_postresnet_proj/bias"] = f"{ours_vb}/post_resnet_proj/bias"
    else:
        m[f"{vt}/conv2d/kernel"] = f"{ours_vb}/patch_conv/kernel"
        m[f"{vt}/conv2d/bias"] = f"{ours_vb}/patch_conv/bias"

    m[f"{vt}/pos_embs/pos_embs"] = f"{ours_vb}/pos_emb2d/pos_embs"
    m[f"{vt}/pos_embs/cls_emb"] = f"{ours_vb}/pos_emb2d/cls_emb"
    m[f"{vt}/LayerNorm_ctx_patches_pre_ln/gamma"] = f"{ours_vb}/patches_pre_ln/gamma"
    m[f"{vt}/LayerNorm_ctx_patches_pre_ln/beta"] = f"{ours_vb}/patches_pre_ln/beta"
    m.update(_transformer_layer_map(vt, f"{ours_vb}/encoder", cfg.vit_num_layers))

    # the vision-side PEs and final LN live under vision_backbone in TF but
    # on the model here
    m[f"{vb}/img_idx_pe"] = f"{root}/img_idx_pe"
    m[f"{vb}/final_pe/pos_embs"] = f"{root}/final_pe/pos_embs"
    m[f"{vb}/final_pe/cls_emb"] = f"{root}/final_pe/cls_emb"
    m[f"{vb}/LayerNorm_final_ln/gamma"] = f"{root}/viz_final_ln/gamma"
    m[f"{vb}/LayerNorm_final_ln/beta"] = f"{root}/viz_final_ln/beta"

    # language embeddings
    m["word_embeddings/word_embeddings"] = f"{root}/word_embeddings"
    m["position_embeddings/position_embeddings"] = f"{root}/position_embeddings"
    m["position_embeddings/LayerNorm_embed_norm/gamma"] = f"{root}/embed_norm/gamma"
    m["position_embeddings/LayerNorm_embed_norm/beta"] = f"{root}/embed_norm/beta"
    m["langonly_embeddings/position_embeddings"] = f"{root}/langonly_position_embeddings"
    m["langonly_embeddings/LayerNorm_embed_norm/gamma"] = f"{root}/langonly_embed_norm/gamma"
    m["langonly_embeddings/LayerNorm_embed_norm/beta"] = f"{root}/langonly_embed_norm/beta"

    # joint encoder (shared with the lang tower when share_params)
    m.update(_transformer_layer_map("encoder", f"{root}/encoder", cfg.num_hidden_layers))
    if not cfg.share_params:
        m.update(_transformer_layer_map("langonly_encoder", f"{root}/langonly_encoder",
                                        cfg.num_lang_transformer_hidden_layers))

    # lm head
    if cfg.do_projection:
        m["lm_head/projection/kernel"] = f"{root}/lm_projection/kernel"
        m["lm_head/projection/bias"] = f"{root}/lm_projection/bias"
        m["lm_head/LayerNorm/gamma"] = f"{root}/lm_projection_ln/gamma"
        m["lm_head/LayerNorm/beta"] = f"{root}/lm_projection_ln/beta"
    if cfg.do_bias:
        m["lm_head/output_bias"] = f"{root}/lm_output_bias"

    # contrastive projections
    for side in ("lang", "viz"):
        ours = f"{root}/contrastive_{side}_proj"
        if cfg.do_projection:
            m[f"contrastive/{side}_proj_intermediate/kernel"] = f"{ours}/intermediate/kernel"
            m[f"contrastive/{side}_proj_intermediate/bias"] = f"{ours}/intermediate/bias"
            m[f"contrastive/LayerNorm_{side}_proj_ln/gamma"] = f"{ours}/ln/gamma"
            m[f"contrastive/LayerNorm_{side}_proj_ln/beta"] = f"{ours}/ln/beta"
        m[f"contrastive/{side}_proj/kernel"] = f"{ours}/proj/kernel"
        m[f"contrastive/{side}_proj/bias"] = f"{ours}/proj/bias"

    # temporal heads
    for which in ("lang_viz", "viz_viz"):
        tf_s = f"{which}_temporal"
        ours = f"{root}/{which}_temporal"
        m[f"{tf_s}/intermediate/kernel"] = f"{ours}/intermediate/kernel"
        m[f"{tf_s}/intermediate/bias"] = f"{ours}/intermediate/bias"
        m[f"{tf_s}/LayerNorm_ln0/gamma"] = f"{ours}/ln0/gamma"
        m[f"{tf_s}/LayerNorm_ln0/beta"] = f"{ours}/ln0/beta"
        m[f"{tf_s}/logits/kernel"] = f"{ours}/logits/kernel"
        m[f"{tf_s}/logits/bias"] = f"{ours}/logits/bias"

    if include_vcr_heads:
        for mode in ("answer", "rationale"):
            for i, our_name in ((0, "mlp0"), (1, "mlp1")):
                m[f"{mode}_cls/classifier_mlp{i}/kernel"] = f"{mode}_cls/{our_name}/kernel"
                m[f"{mode}_cls/classifier_mlp{i}/bias"] = f"{mode}_cls/{our_name}/bias"
    return m


def grover_tf_name_map(num_layers: int, root: str = "") -> Dict[str, str]:
    """newslm scope -> GroverLM tree (data/groverdenoise/lm/modeling.py)."""
    p = f"{root}/" if root else ""
    m = {
        "newslm/embeddings/word_embed": f"{p}word_embed",
        "newslm/embeddings/pos_embed": f"{p}pos_embed",
        "newslm/embeddings/LayerNorm_embed_norm/gamma": f"{p}embed_norm/gamma",
        "newslm/embeddings/LayerNorm_embed_norm/beta": f"{p}embed_norm/beta",
    }
    for i in range(num_layers):
        tf_l = f"newslm/layer{i:02d}"
        our_l = f"{p}layer{i:02d}"
        for tf_name, our_name in (("query_layer", "query"),
                                  ("key_layer", "key"),
                                  ("value_layer", "value"),
                                  ("context_projection_layer", "out_proj")):
            m[f"{tf_l}/{tf_name}/kernel"] = f"{our_l}/{our_name}/kernel"
            m[f"{tf_l}/{tf_name}/bias"] = f"{our_l}/{our_name}/bias"
        for ln in ("mlp_ln0", "mlp_ln1"):
            m[f"{tf_l}/LayerNorm_{ln}/gamma"] = f"{our_l}/{ln}/gamma"
            m[f"{tf_l}/LayerNorm_{ln}/beta"] = f"{our_l}/{ln}/beta"
        for dense in ("intermediate", "output"):
            m[f"{tf_l}/{dense}/kernel"] = f"{our_l}/{dense}/kernel"
            m[f"{tf_l}/{dense}/bias"] = f"{our_l}/{dense}/bias"
    return m


# ----------------------------------------------------------------------
# conversion
# ----------------------------------------------------------------------
def load_tf_checkpoint_arrays(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Read every variable of a TF checkpoint into numpy (needs
    tensorflow), but the Adam slots and the global step."""
    import tensorflow as tf  # a tooling dependency, never a runtime one
    reader = tf.train.load_checkpoint(ckpt_path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if "adam_m" in name or "adam_v" in name or name == "global_step":
            continue
        out[name] = reader.get_tensor(name)
    return out


def convert_arrays(tf_arrays: Mapping[str, np.ndarray], name_map: Mapping[str, str],
                   template: Optional[nn.Module] = None,
                   verbose: bool = True) -> Dict[str, np.ndarray]:
    """Apply the name map -> flat ``{flax path: array}``. A TF name missing
    from the arrays is reported and skipped. With a ``template`` (a module
    of this package), the result holds exactly its parameters: each mapped
    leaf shape-checked against the template's (flax layout) and cast to
    its dtype, a leaf of another shape reported and the template's kept,
    and every leaf the map does not reach kept from the template (the
    name-intersection warm start; the template is not changed)."""
    converted: Dict[str, np.ndarray] = {}
    for tf_name, our_path in name_map.items():
        if tf_name not in tf_arrays:
            if verbose:
                print(f"convert: {tf_name} not in checkpoint, skipping")
            continue
        converted[our_path] = np.asarray(tf_arrays[tf_name])
    if verbose:
        print(f"convert: mapped {len(converted)}/{len(name_map)} variables")
    if template is None:
        return converted

    merged = {flax_path(n): flax_layout(n, p.detach().float().cpu().numpy())
              for n, p in template.named_parameters()}
    initialized = 0
    for path, leaf in converted.items():
        if path not in merged:
            continue
        if leaf.shape != merged[path].shape:
            if verbose:
                print(f"warm_start: shape mismatch at {path}: {leaf.shape} vs "
                      f"{merged[path].shape}, skipping")
            continue
        merged[path] = leaf.astype(merged[path].dtype)
        initialized += 1
    if verbose:
        print(f"warm_start: initialized {initialized}/{len(merged)} leaves")
    return merged
