"""merlot_tpu_torch MerlotModel and weight bridge vs merlot_tpu on the CPU.

The flax model is initialised by JAX over every head, so that its tree
holds every parameter; ``convert.load_flax_params`` moves it into the port.
Tolerance: fp32 atol/rtol 1e-4 on hidden states and heads (sums run in
another order in each framework and compound through the two towers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from merlot_tpu.models.config import MerlotConfig as JaxConfig
from merlot_tpu.models.merlot import MerlotModel as JaxModel
from merlot_tpu_torch.convert import load_flax_params, params_from_flax
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel

FP32 = dict(atol=1e-4, rtol=1e-4)

# tests/test_downstream.py TINY_STORY_CFG
TINY = dict(hidden_size=64, vocab_size=50370, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, image_size=(32, 64),
            patch_size=16, spatial_pool_size=2, use_bfloat16=False,
            num_vision_transformer_hidden_layers=2,
            num_lang_transformer_hidden_layers=2, num_chunks_in_group=5,
            hidden_dropout_prob=0.0)
VARIANTS = {
    "patch": TINY,
    "resnet_heads": dict(TINY, resnet_layers=(1, 1, 1), do_projection=True,
                         do_bias=True, share_params=False,
                         disable_pairwise_lang_attn=True),
}


def _init_all(mdl, imgs, ids, sidx):
    """Touch every parameter of the flax model."""
    fwd = mdl(imgs, ids, mask_input=False, shuffled_idx_img=sidx,
              deterministic=True)
    s = fwd["shapes"]
    h = fwd["encoder_hidden_states"]
    mdl.embed_words(ids.reshape(s["B"], -1), which="langonly")
    mdl.lm_logits(h["lang"])
    mdl.contrastive_features(fwd["img_trg_h"], fwd["img_trg_h"])
    x = h["viz"][:, :s["group"]]
    mdl.temporal_logits(x, x, which="lang_viz")
    mdl.temporal_logits(x, x, which="viz_viz")
    if not mdl.cfg.share_params:
        mdl.langonly_encoder(h["lang"], None)
    return 0


def _inputs(seed=0, batch=2, n=5, L=32, hw=(32, 64)):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (batch * n, *hw, 3)).astype(np.float32)
    ids = rng.integers(100, 50357, (batch, n, L)).astype(np.int32)
    ids[:, :, 20:] = 0                       # lang padding: fully masked rows
    ids[0, 1, 5:] = 0
    sidx = np.stack([rng.permutation(n) for _ in range(batch)]).astype(np.int32) + 64
    return imgs, ids, sidx


def build_pair(kw, seed=0):
    """(flax model, flax variables, port model with the same weights)."""
    jcfg = JaxConfig(**kw).eval_mode()
    jm = JaxModel(jcfg)
    imgs, ids, sidx = _inputs()
    variables = jax.jit(lambda k: jm.init(
        k, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(sidx),
        method=_init_all))(jax.random.PRNGKey(seed))
    tm = MerlotModel(MerlotConfig(**dataclasses.asdict(jcfg)))
    load_flax_params(tm, _flat(variables))
    return jm, variables, tm


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            flatten_dict(variables["params"], sep="/").items()}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return (request.param,) + build_pair(VARIANTS[request.param])


def test_converter_uses_every_leaf_and_sets_every_parameter(pair):
    name, _, variables, tm = pair
    flat = _flat(variables)
    sd = params_from_flax(flat)
    assert set(sd) == set(tm.state_dict())
    # layouts: DenseTN [in, out] -> [out, in]; WSConv HWIO -> OIHW
    k = flat["encoder/layer00/attention/query/kernel"]
    np.testing.assert_array_equal(
        tm.encoder.layer00.attention.query.weight.detach().numpy(), k.T)
    if name == "resnet_heads":
        k = flat["vision_backbone/resnet/stem_conv0/kernel"]
        np.testing.assert_array_equal(
            tm.vision_backbone.resnet.stem_conv0.weight.detach().numpy(),
            k.transpose(3, 2, 0, 1))


def test_converter_raises_on_unused_unset_and_misshapen(pair):
    _, _, variables, tm = pair
    flat = _flat(variables)
    with pytest.raises(KeyError, match="no port parameter"):
        load_flax_params(tm, dict(flat, extra=np.zeros(3, np.float32)))
    with pytest.raises(KeyError, match="no flax leaf"):
        load_flax_params(tm, {k: v for k, v in flat.items()
                              if k != "viz_final_ln/gamma"})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(tm, dict(flat, img_idx_pe=flat["img_idx_pe"][:3]))


def test_model_forward_matches_jax(pair):
    name, jm, variables, tm = pair
    imgs, ids, sidx = _inputs(seed=1)

    def run(mdl, imgs, ids, sidx, **kw):
        fwd = mdl(imgs, ids, mask_input=False, shuffled_idx_img=sidx,
                  collect_attention="probs", **kw)
        h = fwd["encoder_hidden_states"]
        s = fwd["shapes"]
        x = h["viz"].reshape(s["B"], s["group"], s["viz_chunk_len"], -1)[:, :, 0]
        lt, vt = mdl.contrastive_features(fwd["img_trg_h"], fwd["img_trg_h"])
        return {"viz": h["viz"], "lang": h["lang"], "img_trg_h": fwd["img_trg_h"],
                "lm": mdl.lm_logits(h["lang"][:, :4]), "lang_proj": lt,
                "viz_proj": vt, "temporal": mdl.temporal_logits(x, x, "viz_viz"),
                "is_valid": fwd["is_valid"], **fwd["attention_log"]}

    want = jax.jit(lambda v, *a: jm.apply(v, *a, deterministic=True, method=run))(
        variables, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(sidx))
    with torch.no_grad():
        got = run(tm, torch.from_numpy(imgs), torch.from_numpy(ids),
                  torch.from_numpy(sidx))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key].float() if key != "is_valid"
                                              else got[key]),
                                   np.asarray(want[key]), err_msg=key, **FP32)


def test_model_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        MerlotModel(MerlotConfig(**dict(TINY, scan_layers=True)))
    # attention-prob dropout (0 in every config) is refused in training
    tm = MerlotModel(MerlotConfig(**dict(TINY, attention_probs_dropout_prob=0.1)))
    imgs, ids, _ = _inputs()
    with pytest.raises(NotImplementedError):
        tm(torch.from_numpy(imgs), torch.from_numpy(ids), deterministic=False)
