"""merlot_tpu_torch MerlotAdamW vs merlot_tpu MerlotAdamW on the CPU.

Both optimizers step the same fp32 parameters with the same gradients
(numpy, from a seed) for several steps; the port names its parameters as
torch does and resolves the overrides on their flax paths.

encode_v / decode_v are bit-exact on the same inputs. Over the steps the
fp32 moments agree to 1e-6 of their largest value, not bit for bit: XLA's CPU backend
contracts ``b1*m + (1-b1)*g`` into one FMA, which moves ~4% of the
elements by an ulp. So the bf16 state is bit-exact wherever the fp32
moments are (>= 97% of its elements) and otherwise one bf16 step away
(2^-7 relative); the parameters agree to 1e-6 relative (the port also
folds the bias correction into the LR in double precision, JAX in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from merlot_tpu.train.optimizer import AdamWConfig as JaxConfig
from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
from merlot_tpu.train.optimizer import decode_v as jax_decode_v
from merlot_tpu.train.optimizer import encode_v as jax_encode_v
from merlot_tpu_torch.convert import flax_path
from merlot_tpu_torch.train.optimizer import (AdamWConfig, MerlotAdamW,
                                              decode_v, encode_v)
from torch_port_helpers import flat_params

# configs/pretrain_4seg.yaml, optimizer block (warmup shortened so that a few
# steps cross it), plus a frozen table to check lr = 0
YAML_OVERRIDES = [
    [["attn_ln", "mlp_ln", "final_ln", "embed_norm", "patches_pre_ln",
      "viz_final_ln", "/ln", "/gn", "proj_gn", "bias", "gamma", "beta"],
     {"weight_decay_rate": 0}],
]
OPT = {"type": "adam_optimizer", "learning_rate": 0.0003, "num_train_steps": 460000,
       "num_warmup_steps": 2, "weight_decay_rate": 0.1, "beta_2": 0.98,
       "clip_norm": 0.0, "use_bfloat16_adam": True, "param_overrides": YAML_OVERRIDES}
FROZEN = [[["langonly_position_embeddings"], {"learning_rate": 0}]]

# torch name -> (shape, weight decay the yaml's overrides give it)
PARAMS = {
    "merlot.encoder.layer00.attn_ln.gamma": ((16,), 0.0),
    "merlot.encoder.layer00.attention.query.weight": ((16, 16), 0.1),
    "merlot.encoder.layer00.attention.query.bias": ((16,), 0.0),
    "merlot.encoder.layer00.mlp.intermediate.weight": ((32, 16), 0.1),
    "merlot.encoder.final_ln.beta": ((16,), 0.0),
    "merlot.vision_backbone.resnet.group1_block0.proj_gn.beta": ((8,), 0.0),
    "merlot.vision_backbone.resnet.group1_block0.gn1.gamma": ((8,), 0.0),
    "merlot.vision_backbone.resnet.stem_conv0.weight": ((8, 3, 3, 3), 0.1),
    "merlot.vision_backbone.patches_pre_ln.beta": ((16,), 0.0),
    "merlot.vision_backbone.pos_emb2d.pos_embs": ((1, 4, 4, 16), 0.1),
    "merlot.contrastive_lang_proj.ln.gamma": ((16,), 0.0),
    "merlot.contrastive_lang_proj.proj.weight": ((16, 16), 0.1),
    "merlot.word_embeddings": ((50, 16), 0.1),
    "merlot.langonly_position_embeddings": ((12, 16), 0.1),
    "merlot.lm_output_bias": ((50,), 0.0),
    "merlot.viz_final_ln.gamma": ((16,), 0.0),
}


def _params(seed):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(shape) * 0.05).astype(np.float32)
            for n, (shape, _) in PARAMS.items()}


def _jax_tree(flat_torch):
    return unflatten_dict({tuple(flax_path(n).split("/")): jnp.asarray(a)
                           for n, a in flat_torch.items()})


def _flat_jax(tree):
    """flax-path leaves -> torch names"""
    by_path = {flax_path(n): n for n in PARAMS}
    return {by_path[p]: a for p, a in flat_params(tree).items()}


def test_overrides_resolve_on_flax_paths():
    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    jopt = JaxAdamW(JaxConfig.from_config(OPT))
    for name, (_, wd) in PARAMS.items():
        hp = opt._resolve(flax_path(name))
        assert hp == jopt._resolve(flax_path(name)), name
        assert hp["weight_decay_rate"] == wd, name


def test_flax_path_inverts_the_name_map():
    assert (flax_path("merlot.encoder.layer03.attention.query.weight")
            == "merlot/encoder/layer03/attention/query/kernel")
    assert flax_path("merlot.embed_norm.gamma") == "merlot/embed_norm/gamma"


def test_encode_decode_v_bit_exact():
    rng = np.random.default_rng(0)
    v = np.concatenate([np.abs(rng.standard_normal(4000)) * 10.0 ** rng.integers(-30, 3, 4000),
                        [0.0, 1e-30, 1.0, 1.00390625, 3.0e38]]).astype(np.float32)
    enc = encode_v(torch.from_numpy(v))
    want = np.asarray(jax_encode_v(jnp.asarray(v)))
    np.testing.assert_array_equal(enc.view(torch.int16).numpy(), want.view(np.int16))
    np.testing.assert_array_equal(decode_v(enc).numpy(),
                                  np.asarray(jax_decode_v(jnp.asarray(want))))


@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
@pytest.mark.parametrize("bf16_state", [True, False])
def test_steps_match_jax(clip_norm, bf16_state):
    cfg = dict(OPT, clip_norm=clip_norm, use_bfloat16_adam=bf16_state, verbose=True,
               param_overrides=YAML_OVERRIDES + FROZEN)
    opt, jopt = MerlotAdamW(AdamWConfig.from_config(cfg)), JaxAdamW(JaxConfig.from_config(cfg))
    p0 = _params(0)
    params = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    state = opt.init(params)
    jparams = _jax_tree(p0)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(1)
    bit_exact = []
    for step in range(4):
        grads = {n: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
                 for n, a in p0.items()}
        metrics = opt.update({n: torch.from_numpy(g) for n, g in grads.items()},
                             state, params)
        jparams, jstate, jmetrics = jupdate(_jax_tree(grads), jstate, jparams)
        assert state["step"] == int(jstate["step"]) == step + 1
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       rtol=1e-6, err_msg=k)
        want_p = _flat_jax(jparams)
        for n in params:
            np.testing.assert_allclose(params[n].numpy(), want_p[n], rtol=1e-6,
                                       atol=1e-9, err_msg=n)
            for key in ("m", "v"):
                got = state[key][n]
                want = _flat_jax(jstate[key])[n]
                if bf16_state:
                    same = got.view(torch.int16).numpy() == np.asarray(want).view(np.int16)
                    bit_exact.append(same.mean())
                    dec = (decode_v(got), jax_decode_v(jnp.asarray(want))) if key == "v" \
                        else (got.float(), want.astype(np.float32))
                    np.testing.assert_allclose(dec[0].numpy(), np.asarray(dec[1]),
                                               rtol=2.0 ** -7, err_msg=f"{key} {n}")
                else:
                    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max(),
                                               err_msg=f"{key} {n}")
    if bf16_state:
        assert np.mean(bit_exact) >= 0.97, np.mean(bit_exact)
    frozen = "merlot.langonly_position_embeddings"
    np.testing.assert_array_equal(params[frozen].numpy(), p0[frozen])
    assert not state["m"][frozen].any() and not state["v"][frozen].any()


def test_lr_schedule_matches_jax():
    cfg = dict(OPT, num_warmup_steps=10, num_train_steps=100)
    opt, jopt = MerlotAdamW(AdamWConfig.from_config(cfg)), JaxAdamW(JaxConfig.from_config(cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(opt.lr_scale(step),
                                   float(jopt.lr_scale(jnp.asarray(step))), rtol=1e-6)
