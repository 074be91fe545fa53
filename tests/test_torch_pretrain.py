"""merlot_tpu_torch MerlotPretrainModel (the pretrain forward: lang-only
tower, masking, joint encoder and the three objectives) vs merlot_tpu on
the CPU, at the tiny flagship config (__graft_entry__._flagship_config,
tiny=True) in fp32 with dropout 0.

The masking draws are JAX's: its masking key is re-derived from the
flax rng stream and its five draws handed to the port, so both mask the
same positions. Tolerance: fp32 atol/rtol 1e-4 on hidden states, logits
and metrics (sums run in another order in each framework, compounded
through the towers; measured differences stay below 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_tpu.models.pretrain import _allpairs_temporal_labels as jax_labels
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import (MerlotPretrainModel,
                                              _allpairs_temporal_labels)
from merlot_tpu_torch.nn.layers import dropout
from torch_port_helpers import (build_pair, pretrain_masking_draws, tiny_batch,
                                tiny_config, to_torch)

FP32 = dict(atol=1e-4, rtol=1e-4)


def _outputs(mdl, batch, **kw):
    """Loss, metrics and the tensors the objectives read."""
    loss, metrics, fwd = mdl(batch, deterministic=True, **kw)
    m = mdl.model if hasattr(mdl, "model") else mdl.merlot
    s = fwd["shapes"]
    h = fwd["encoder_hidden_states"]
    xl = h["lang"].reshape(s["B"], s["group"], s["lang_chunk_len"], -1)[:, :, 0]
    xv = h["viz"].reshape(s["B"], s["group"], s["viz_chunk_len"], -1)[:, :, 0]
    return {"loss": loss, **metrics, "viz": h["viz"], "lang": h["lang"],
            "lang_trg_h": fwd["lang_trg_h"], "img_trg_h": fwd["img_trg_h"],
            "lm_logits": m.lm_logits(h["lang"][:, :5]),
            "temporal_lang_viz": m.temporal_logits(xl, xv, "lang_viz"),
            "temporal_viz_viz": m.temporal_logits(xv, xv, "viz_viz"),
            "masked_ids": fwd["lang_mask_info"]["masked_ids"],
            "masked_idx": fwd["lang_mask_info"]["masked_idx"]}


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_config()
    batch = tiny_batch(cfg)
    return (cfg, batch) + build_pair(cfg, batch)


def test_pretrain_forward_matches_jax(pair):
    cfg, batch, jm, variables, tm = pair
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda v, b, k: jm.apply(v, b, method=_outputs,
                                            rngs={"masking": k}))(variables, batch, key)
    draws = pretrain_masking_draws(jm, variables, key, cfg, batch)
    with torch.no_grad():
        got = _outputs(tm, to_torch(batch), masking_draws=draws)
    assert set(got) == set(want)
    assert {"lang/loss", "lang/acc", "contr/loss_all", "temporal/loss"} <= set(got)
    for k in ("masked_ids", "masked_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in sorted(set(want) - {"masked_ids", "masked_idx"}):
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k]), err_msg=k, **FP32)


def test_torch_draws_and_dropout(pair):
    """With its own generator the port masks int(L * 0.2) positions per row
    and is reproducible; dropout changes the loss only when it is on."""
    cfg, batch, _, _, _ = pair
    tm = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, hidden_dropout_prob=0.1))))
    tm.load_state_dict(pair[4].state_dict())
    tb = to_torch(batch)
    runs = {}
    with torch.no_grad():
        for name, det, seed in (("a", True, 0), ("b", True, 0), ("c", False, 0)):
            g = torch.Generator().manual_seed(seed)
            loss, _, fwd = tm(tb, deterministic=det, generator=g)
            runs[name] = (float(loss), fwd["lang_mask_info"]["masked_idx"])
    assert runs["a"][1].shape == (4, int(16 * cfg.masking_rate))
    assert runs["a"][0] == runs["b"][0]
    torch.testing.assert_close(runs["a"][1], runs["b"][1])
    assert np.isfinite(runs["c"][0]) and runs["c"][0] != runs["a"][0]


def test_dropout_keeps_and_scales():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500, dtype=torch.bfloat16)
    y = dropout(x, 0.1, deterministic=False, generator=g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y[kept].float(), torch.full_like(y[kept].float(),
                                                                (1 / 0.9)), rtol=4e-3, atol=0)
    assert dropout(x, 0.1, deterministic=True) is x


def test_allpairs_temporal_labels_match_jax():
    rng = np.random.default_rng(3)
    vid = rng.integers(0, 3, (5, 4)).astype(np.int32)
    want = jax_labels(jnp.asarray(vid), 4)
    got = _allpairs_temporal_labels(torch.from_numpy(vid), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
