"""The ported slice: zero-shot story ordering, merlot_tpu_torch vs merlot_tpu.

JAX ``make_zero_shot_fn`` and the port's run the same weights (moved by
``convert.load_flax_params``) on the same numpy-made stories, with JAX's
fixed frame permutation passed to the port. Compared: the per-row
(pre-average) temporal logits and the duplicate-averaged probs; then
``run_zero_shot`` writes h5 that the JAX package's scorer reads.

Tolerances: fp32 atol/rtol 1e-4 on logits (two 2-layer towers of sums in
another order) and 1e-5 on probs (a softmax of those logits, values in
[0, 1]); bf16 2e-2 on probs (every op of the towers rounds to bf16).
"""

import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from merlot_tpu.downstream.sort_story.score_permutations import score_h5
from merlot_tpu.downstream.sort_story.zero_shot import \
    make_zero_shot_fn as jax_make_zero_shot_fn
from merlot_tpu.models.config import MerlotConfig as JaxConfig
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.downstream.sort_story.zero_shot import (
    default_shuffled_idx, duplicate_inputs, make_zero_shot_fn, run_zero_shot,
    zero_shot_logits)
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel

BATCH, N, DUP = 2, 5, 2
# tests/test_downstream.py TINY_STORY_CFG
TINY = dict(hidden_size=64, vocab_size=50370, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, image_size=(32, 64),
            patch_size=16, spatial_pool_size=2, use_bfloat16=False,
            num_vision_transformer_hidden_layers=2,
            num_lang_transformer_hidden_layers=2, num_chunks_in_group=5,
            hidden_dropout_prob=0.0)
VARIANTS = {
    "patch_fp32": TINY,
    "resnet_fp32": dict(TINY, resnet_layers=(1, 1, 1)),
    "patch_bf16": dict(TINY, use_bfloat16=True),
}


def _stories(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (BATCH, N, 32, 64, 3)).astype(np.float32)
    sents = rng.integers(100, 50357, (BATCH, N, 32)).astype(np.int32)
    for b in range(BATCH):
        for n in range(N):
            sents[b, n, rng.integers(4, 32):] = 0       # lang padding
    return images, sents


def _jax_shuffled_idx():
    """The fixed permutation JAX make_zero_shot_fn draws (zero_shot.py)."""
    key = jax.random.fold_in(jax.random.PRNGKey(123), 1234)
    u = jax.random.uniform(key, (BATCH * DUP * N,))
    return np.asarray(jnp.argsort(u.reshape(BATCH * DUP, N), axis=1)) + 64


def _init_all(mdl, imgs, sents, sidx):
    """Touch every parameter, so that the tree fills the port's model."""
    fwd = mdl(imgs, sents, mask_input=False, shuffled_idx_img=sidx,
              deterministic=True)
    h = fwd["encoder_hidden_states"]
    mdl.embed_words(sents.reshape(sents.shape[0], -1), which="langonly")
    mdl.contrastive_features(fwd["img_trg_h"], fwd["img_trg_h"])
    x = h["viz"][:, :N]
    mdl.temporal_logits(x, x, which="lang_viz")
    mdl.temporal_logits(x, x, which="viz_viz")
    return 0


def _jax_row_logits(mdl, imgs, sents, sidx, cfg):
    """The JAX zero-shot fn's ``run`` up to the logits."""
    fwd = mdl(imgs, sents, mask_input=False, shuffled_idx_img=sidx,
              deterministic=True)
    s = fwd["shapes"]
    h = fwd["encoder_hidden_states"]
    h_lang = h["lang"].reshape(s["B"], s["group"], s["lang_chunk_len"], -1)[:, :, 0]
    h_viz = h["viz"].reshape(s["B"], s["group"], s["viz_chunk_len"], -1)[:, :, 0]
    return {"lang_viz": mdl.temporal_logits(h_lang, h_viz, "lang_viz"),
            "viz_viz": mdl.temporal_logits(h_viz, h_viz, "viz_viz")}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def slice_run(request):
    kw = VARIANTS[request.param]
    jcfg = JaxConfig(**kw)
    model, jfn, _ = jax_make_zero_shot_fn(jcfg, BATCH, N)
    images, sents = _stories()
    sidx = _jax_shuffled_idx()
    imgs_dup = jnp.tile(jnp.asarray(images), (DUP, 1, 1, 1, 1)).reshape(-1, 32, 64, 3)
    sents_dup = jnp.tile(jnp.asarray(sents), (DUP, 1, 1))
    variables = jax.jit(lambda k: model.init(k, imgs_dup, sents_dup,
                                             jnp.asarray(sidx),
                                             method=_init_all))(jax.random.PRNGKey(0))
    want_probs = jfn(variables, jnp.asarray(images), jnp.asarray(sents))
    want_logits = jax.jit(lambda v: model.apply(
        v, imgs_dup, sents_dup, jnp.asarray(sidx), jcfg,
        method=_jax_row_logits))(variables)

    tm = MerlotModel(MerlotConfig(**dataclasses.asdict(jcfg.eval_mode())))
    load_flax_params(tm, {k: np.asarray(v) for k, v in
                          flatten_dict(variables["params"], sep="/").items()})
    return dict(name=request.param, model=tm, images=images, sents=sents,
                sidx=sidx, want_probs=want_probs, want_logits=want_logits)


def _tol(name, fp32):
    return dict(atol=2e-2, rtol=2e-2) if name.endswith("bf16") else fp32


def test_row_logits_match_jax(slice_run):
    r = slice_run
    imgs, sents = duplicate_inputs(torch.from_numpy(r["images"]),
                                   torch.from_numpy(r["sents"]))
    with torch.no_grad():
        got = zero_shot_logits(r["model"], imgs, sents,
                               torch.from_numpy(r["sidx"]), "plain")
    for name in ("lang_viz", "viz_viz"):
        assert got[name].shape == (BATCH * DUP * N * N, 4)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(r["want_logits"][name]),
                                   **_tol(r["name"], dict(atol=1e-4, rtol=1e-4)))


def test_probs_match_jax(slice_run):
    r = slice_run
    fn = make_zero_shot_fn(BATCH, N, shuffled_idx=torch.from_numpy(r["sidx"]))
    got = fn(r["model"], torch.from_numpy(r["images"]), torch.from_numpy(r["sents"]))
    for name in ("lang_viz", "viz_viz"):
        p = got[f"{name}_probs"]
        assert p.shape == (BATCH, N, N, 3) and p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(r["want_probs"][f"{name}_probs"]),
                                   **_tol(r["name"], dict(atol=1e-5, rtol=1e-5)))
    # the duplicate-order fault both packages share: rows are tiled
    # [s0, s1, s0, s1], so output b averages rows b*DUP..b*DUP+DUP-1, which
    # hold different stories of the batch
    imgs, sents = duplicate_inputs(torch.from_numpy(r["images"]),
                                   torch.from_numpy(r["sents"]))
    with torch.no_grad():
        logits = zero_shot_logits(r["model"], imgs, sents,
                                  torch.from_numpy(r["sidx"]), "plain")
    rows = torch.softmax(logits["lang_viz"], -1)[:, 1:].reshape(BATCH * DUP, N, N, 3)
    for b in range(BATCH):
        torch.testing.assert_close(got["lang_viz_probs"][b],
                                   rows[b * DUP:(b + 1) * DUP].mean(dim=0))


def test_kernel_backend_matches_plain_on_cpu(slice_run):
    r = slice_run
    args = (r["model"], torch.from_numpy(r["images"]), torch.from_numpy(r["sents"]))
    sidx = torch.from_numpy(r["sidx"])
    a = make_zero_shot_fn(BATCH, N, shuffled_idx=sidx, attn_backend="cuda")(*args)
    b = make_zero_shot_fn(BATCH, N, shuffled_idx=sidx, attn_backend="plain")(*args)
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=1e-5, rtol=1e-5)


def test_run_zero_shot_writes_h5_the_jax_scorer_reads(slice_run, tmp_path):
    r = slice_run
    batch = {"images": r["images"], "sentences": r["sents"],
             "story_id": np.array([7, 8]),
             "permutation_identity_encode": np.array([0, 3])}
    path = str(tmp_path / "logits.h5")
    n = run_zero_shot(r["model"], [batch], path, BATCH, N,
                      shuffled_idx=torch.from_numpy(r["sidx"]))
    assert n == 2
    with h5py.File(path, "r") as h5:
        assert sorted(h5) == ["7", "8"]
        np.testing.assert_allclose(h5["8/lang_viz_probs"][()],
                                   np.asarray(r["want_probs"]["lang_viz_probs"][1]),
                                   **_tol(r["name"], dict(atol=1e-5, rtol=1e-5)))
        assert int(h5["8/permutation_identity_encode"][()]) == 3
    metrics = score_h5(path)
    assert set(metrics) == {"spearman", "absolute_distance", "pairwise"}


def test_default_shuffled_idx_is_fixed_permutations():
    a = default_shuffled_idx(BATCH, N)
    assert a.shape == (BATCH * DUP, N)
    assert torch.equal(a, default_shuffled_idx(BATCH, N))
    assert torch.equal(a.sort(dim=1).values - 64,
                       torch.arange(N).expand(BATCH * DUP, N))


def _jax_perms(batch, dup, n):
    key = jax.random.fold_in(jax.random.PRNGKey(123), 1234)
    u = jax.random.uniform(key, (batch * dup * n,)).reshape(batch * dup, n)
    return np.asarray(u), np.asarray(jnp.argsort(u, axis=1)) + 64


@pytest.mark.parametrize("batch,dup,n", [(1, 2, 5), (2, 2, 5), (4, 2, 16), (3, 3, 7),
                                         (1, 2, 8192)])
def test_default_shuffled_idx_is_jaxs_draw(batch, dup, n):
    """Bit for bit JAX's permutations; at n = 8192 the 23-bit uniforms of a
    row hold ties, so the argsort's stability is checked too."""
    u, want = _jax_perms(batch, dup, n)
    got = default_shuffled_idx(batch, n, dup)
    assert got.dtype == torch.int64 and got.shape == (batch * dup, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if n == 8192:
        assert any(len(np.unique(row)) < n for row in u)


def test_default_permutations_forward_equals_jax_array(slice_run):
    r = slice_run
    args = (r["model"], torch.from_numpy(r["images"]), torch.from_numpy(r["sents"]))
    a = make_zero_shot_fn(BATCH, N)(*args)
    b = make_zero_shot_fn(BATCH, N, shuffled_idx=torch.from_numpy(r["sidx"]))(*args)
    for k in a:
        assert torch.equal(a[k], b[k])
