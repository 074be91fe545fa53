"""Grover denoiser training in the port (models/grover.py's training
forward and ``grover_lm_loss``, tools/grover_data.py, tools/grover_train.py)
against the JAX package on the CPU, with the same weights (moved by
``convert.load_flax_params``) and numpy-made inputs, at a tiny size (2
layers, hidden 64, 4 heads, sequences of at most 32).

Tolerances:
  * the loss and its metrics 1e-5 relative (the same fp32 formulas, sums in
    another order);
  * fp32 logits 1e-4 abs/rel, as tests/test_torch_grover.py;
  * the grads of the loss 2e-4 of each tensor's largest |grad| plus 1e-6 of
    the largest of all, and one train step's parameters and moments as in
    tests/torch_port_helpers.py (the step's tolerances);
  * the dropout's keep share within 5 standard deviations of 1 - p; the
    kept elements are x / (1 - p) exactly, the rest 0;
  * the tfrecord bytes, batches and the resumed run's losses exactly.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_tpu.models import grover as jg
from merlot_tpu.tools import grover_data as jdata
from merlot_tpu.train.optimizer import AdamWConfig as JaxAdamWConfig
from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
from merlot_tpu.train.train_step import make_loss_train_step as jax_make_loss_train_step
from merlot_tpu_torch.convert import flax_path, load_flax_params
from merlot_tpu_torch.models import grover as tg
from merlot_tpu_torch.ops import cuda_attention
from merlot_tpu_torch.tools import denoise_server, grover_data, grover_train
from merlot_tpu_torch.train.checkpoint import CheckpointManager, load_params
from merlot_tpu_torch.train.train_step import make_loss_train_step
from torch_port_helpers import (check_step_grads, check_step_params_and_state, close_to_scale,
                                flat_params)
from torch_port_helpers import flax_layout as to_flax

TINY = dict(vocab_size=503, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
B, S = 3, 24
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, b=B, s=S):
    """ids [b, s + 1] with padded tails, is_target on each row's tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 500, (b, s + 1)).astype(np.int32)
    is_target = np.zeros_like(ids)
    for r in range(b):
        n = int(rng.integers(s // 2, s + 2))
        ids[r, n:] = 0
        is_target[r, int(rng.integers(1, max(2, n))):n] = 1
    return {"input_ids": ids, "is_target": is_target}


@pytest.fixture(scope="module")
def pair():
    """JAX variables of the tiny model, and the port model with its weights."""
    batch = _batch()
    jm = jg.GroverLM(jg.GroverConfig(**TINY))
    variables = jax.jit(lambda i: jm.init(jax.random.PRNGKey(0), i))(
        jnp.asarray(batch["input_ids"][:, :-1]))
    return jm, variables, batch


def _port(variables, **kw):
    tm = tg.GroverLM(tg.GroverConfig(**dict(TINY, **kw)))
    load_flax_params(tm, flat_params(variables["params"]))
    return tm


def _jax_loss(jm, params, batch, bonus=4.0):
    ids = jnp.asarray(batch["input_ids"][:, :-1])
    logits, _ = jm.apply({"params": params}, ids)
    return jg.grover_lm_loss(logits, ids, jnp.asarray(batch["is_target"][:, 1:]),
                             target_bonus=bonus)


@pytest.mark.parametrize("bonus", [4.0, 0.0])
def test_grover_lm_loss_matches_jax(bonus):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (B, S, 50)).astype(np.float32)
    batch = _batch(2)
    ids, is_t = batch["input_ids"][:, :-1] % 50, batch["is_target"][:, 1:]
    loss, metrics = tg.grover_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                                      torch.from_numpy(is_t), target_bonus=bonus)
    jloss, jmetrics = jg.grover_lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                                        jnp.asarray(is_t), target_bonus=bonus)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics) == {"loss", "ctx_loss", "trg_loss"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **TOL)
    np.testing.assert_allclose(float(metrics["ctx_loss"] + metrics["trg_loss"]), float(loss),
                               **TOL)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_training_forward_and_grads_match_jax(pair, monkeypatch, backend):
    """The no-cache forward's logits and the loss's grads against jax.grad,
    on the plain path and through FlashAttention on CPU tensors (the
    kernels' plain versions, fed the [B, S, S] causal mask)."""
    jm, variables, batch = pair
    tm = _port(variables)
    seen = []
    for name in ("flash_attention_plain", "attention_bwd_plain"):
        real = getattr(cuda_attention, name)

        def spy(q3, k3, v3, mask, *a, _real=real, _name=name, **kw):
            seen.append((_name, tuple(mask.shape)))
            return _real(q3, k3, v3, mask, *a, **kw)
        monkeypatch.setattr(cuda_attention, name, spy)
    cuda_attention.launches = cuda_attention.bwd_launches = 0

    ids = batch["input_ids"][:, :-1]
    t_ids = torch.from_numpy(ids)
    logits, _ = tm(t_ids, attn_backend=backend)
    j_logits, _ = jax.jit(lambda v, i: jm.apply(v, i))(variables, jnp.asarray(ids))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)
    loss, _ = tg.grover_lm_loss(logits, t_ids, torch.from_numpy(batch["is_target"][:, 1:]))
    loss.backward()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jm, p, batch)[0]))(variables["params"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    jgrads = flat_params(jgrads)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in tm.named_parameters():
        close_to_scale(to_flax(name, p.grad.numpy()), jgrads[flax_path(name)], 2e-4, name,
                       atol=floor)
    assert cuda_attention.launches == cuda_attention.bwd_launches == 0
    if backend == "cuda":
        n = TINY["num_hidden_layers"]
        assert seen == [("flash_attention_plain", (B, S, S))] * n + \
                       [("attention_bwd_plain", (B, S, S))] * n
    else:
        assert seen == []


def test_train_step_matches_jax(pair):
    """One make_loss_train_step step of each package with grover_train's
    AdamW block (no warmup, so that the step moves the weights)."""
    jm, variables, batch = pair
    tm = _port(variables)
    lr, bonus = 3e-4, 4.0
    jopt = JaxAdamW(JaxAdamWConfig(
        learning_rate=lr, num_train_steps=100, num_warmup_steps=0,
        weight_decay_rate=0.01, beta_2=0.98, clip_norm=1.0,
        param_overrides=((("embed_norm", "mlp_ln", "bias", "gamma", "beta"),
                          {"weight_decay_rate": 0.0}),)))

    def jax_loss_fn(p, b, key):
        ids = b["input_ids"][:, :-1]
        logits, _ = jm.apply({"params": p}, ids, deterministic=False, rngs={"dropout": key})
        return jg.grover_lm_loss(logits, ids, b["is_target"][:, 1:], target_bonus=bonus)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = variables["params"]
    jstate = jopt.init(params)
    key = jax.random.PRNGKey(3)
    jgrads = jax.jit(jax.grad(lambda p: jax_loss_fn(p, jbatch, key)[0]))(params)
    new_params, new_state, jmetrics = jax_make_loss_train_step(jax_loss_fn, jopt,
                                                                donate=False)(
        params, jstate, jbatch, key)

    opt = grover_train.grover_optimizer(lr, 100, 0)
    state = opt.init(dict(tm.named_parameters()))
    loss_fn = grover_train.make_grover_loss(tm.cfg, bonus)
    metrics = make_loss_train_step(loss_fn, opt, device="cpu")(
        tm, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    stepped = (tm, state, metrics, flat_params(jgrads), flat_params(new_params),
               {k: flat_params(new_state[k]) for k in ("m", "v")}, jmetrics)
    check_step_grads(stepped)
    check_step_params_and_state(stepped)

    # which parameters decay: JAX's resolution of the same block
    no_decay = {flax_path(n) for n, _ in tm.named_parameters()
                if opt._resolve(flax_path(n))["weight_decay_rate"] == 0.0}
    assert no_decay == {p for p in flat_params(params)
                        if jopt._resolve(p)["weight_decay_rate"] == 0.0}
    assert "embed_norm/gamma" in no_decay and "layer01/mlp_ln1/beta" in no_decay
    assert "layer00/query/bias" in no_decay and "layer00/query/kernel" not in no_decay
    assert "word_embed" not in no_decay and "pos_embed" not in no_decay


def test_hidden_dropout_keep_share_and_scale(pair, monkeypatch):
    """Both sites of every layer: kept elements scaled by 1 / (1 - p), the
    rest 0, the keep share near 1 - p; and the draws are the generator's."""
    _, variables, batch = pair
    p = 0.3
    tm = _port(variables, hidden_dropout_prob=p)
    calls = []
    real = tg.dropout

    def spy(x, rate, **kw):
        y = real(x, rate, **kw)
        calls.append((x.detach(), y.detach(), rate))
        return y
    monkeypatch.setattr(tg, "dropout", spy)
    ids = torch.from_numpy(batch["input_ids"][:, :-1])
    with torch.no_grad():
        a, _ = tm(ids, deterministic=False, generator=torch.Generator().manual_seed(5))
        b, _ = tm(ids, deterministic=False, generator=torch.Generator().manual_seed(5))
        c, _ = tm(ids, deterministic=False, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    sites = calls[:2 * TINY["num_hidden_layers"]]
    for x, y, rate in sites:
        assert rate == p and x.shape == (B, S, TINY["hidden_size"])
        kept = y != 0
        torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
        n = x.numel()
        share = kept.float().mean().item()
        assert abs(share - (1 - p)) <= 5 * ((p * (1 - p) / n) ** 0.5), share
    with pytest.raises(ValueError, match="generator"):
        tm(ids, deterministic=False)


def test_no_attention_prob_dropout(pair):
    """hidden_dropout_prob 0 and attention_probs_dropout_prob 0.1: the
    training forward is the deterministic one exactly (JAX applies no
    attention-prob dropout to Grover)."""
    _, variables, batch = pair
    tm = _port(variables, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1)
    ids = torch.from_numpy(batch["input_ids"][:, :-1])
    with torch.no_grad():
        train, _ = tm(ids, deterministic=False, generator=torch.Generator().manual_seed(1))
        det, _ = tm(ids)
    assert torch.equal(train, det)


# ----------------------------------------------------------------------
# data


def _sequences(seed, n, max_len):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(1, 500, int(rng.integers(3, max_len))).tolist() for _ in range(n)]
    targets = [[int(t) for t in rng.integers(0, 2, len(s))] for s in seqs]
    return seqs, targets


@pytest.mark.parametrize("with_targets", [True, False])
def test_lm_shard_bytes_and_batches_match_jax(tmp_path, with_targets):
    seqs, targets = _sequences(3, 11, 40)
    tgt = targets if with_targets else None
    paths = {}
    for name, mod in (("port", grover_data), ("jax", jdata)):
        paths[name] = [str(tmp_path / f"{name}-{i}.tfrecord") for i in range(2)]
        assert mod.write_lm_shard(paths[name][0], seqs[:6], 31, pad_id=0,
                                  is_target=None if tgt is None else tgt[:6]) == 6
        mod.write_lm_shard(paths[name][1], seqs[6:], 31, pad_id=0,
                           is_target=None if tgt is None else tgt[6:])
    for a, b in zip(paths["port"], paths["jax"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    for kw in (dict(is_training=True, seed=2), dict(is_training=False)):
        got = grover_data.lm_batches(paths["port"], 31, 3, **kw)
        want = jdata.lm_batches(paths["jax"], 31, 3, **kw)
        n = 8 if kw["is_training"] else 3
        for _ in range(n):
            g, w = next(got), next(want)
            assert g.keys() == w.keys() == {"input_ids", "is_target"}
            for k in g:
                assert g[k].dtype == w[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])
        if not kw["is_training"]:
            with pytest.raises(StopIteration):
                next(got)
    # a later start: the stream from its first batch with `start` dropped
    full = grover_data.lm_batches(paths["port"], 31, 3, seed=2)
    want = [next(full) for _ in range(9)][5:]
    later = grover_data.lm_batches(paths["port"], 31, 3, seed=2, start=5)
    for w in want:
        g = next(later)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_classification_shard_bytes_and_batches_match_jax(tmp_path):
    seqs, _ = _sequences(4, 9, 30)
    labels = list(np.random.default_rng(5).integers(0, 3, len(seqs)))
    paths = {}
    for name, mod in (("port", grover_data), ("jax", jdata)):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        assert mod.write_classification_shard(paths[name], seqs, labels, 24) == len(seqs)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for kw in (dict(is_training=True, seed=1), dict(is_training=False)):
        got = list(zip(range(5), grover_data.classification_batches([paths["port"]], 24, 2,
                                                                    **kw)))
        want = list(zip(range(5), jdata.classification_batches([paths["jax"]], 24, 2, **kw)))
        assert len(got) == len(want) == (5 if kw["is_training"] else 4)
        for (_, g), (_, w) in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


# ----------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("grover_cli")
    cfg = dict(TINY, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    (d / "tiny.json").write_text(json.dumps(cfg))
    seqs, targets = _sequences(6, 20, 40)
    grover_data.write_lm_shard(str(d / "lm-0.tfrecord"), seqs, 32, is_target=targets)
    return d


def _argv(d, out, steps=6):
    return ["--config", str(d / "tiny.json"), "--train_files", str(d / "lm-*.tfrecord"),
            "--output_dir", str(out), "--seq_length", "32", "--batch_size", "4",
            "--learning_rate", "1e-3", "--num_train_steps", str(steps),
            "--num_warmup_steps", "2", "--checkpoint_every", "3", "--log_every", "1",
            "--device", "cpu"]


def _losses(out):
    return {x["step"]: x["loss"] for x in map(json.loads, open(out / "train_metrics.jsonl"))
            if "loss" in x}


def test_grover_train_cli_resumes_and_serves(cli_setup):
    """Six steps straight; three more from the straight run's ckpt_3 give
    its losses at steps 4-6 exactly; the Denoiser serves ckpt_6's
    params.npz with the trained model's logits."""
    d = cli_setup
    a = grover_train.main(_argv(d, d / "a"))
    la = _losses(d / "a")
    assert sorted(la) == list(range(1, 7)) and all(np.isfinite(list(la.values())))
    assert CheckpointManager(str(d / "a" / "checkpoints")).all_steps() == [3, 6]
    os.makedirs(d / "b" / "checkpoints")
    shutil.copytree(d / "a" / "checkpoints" / "ckpt_3", d / "b" / "checkpoints" / "ckpt_3")
    grover_train.main(_argv(d, d / "b"))
    lb = _losses(d / "b")
    assert sorted(lb) == [4, 5, 6]
    assert all(lb[s] == la[s] for s in lb), (la, lb)

    model = a["trainer"].model.eval()
    ckpt = os.path.join(d / "a" / "checkpoints", "ckpt_6", "params.npz")
    den = denoise_server.Denoiser(str(d / "tiny.json"), ckpt, max_len=40, device="cpu")
    ids = torch.from_numpy(_batch(9, 2, 20)["input_ids"][:, :20].astype(np.int64))
    with torch.no_grad():
        want, _ = model(ids)
        got, _ = den.model(ids, cache=den.model.empty_cache(2, 40))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    flat = load_params(os.path.join(d / "a" / "checkpoints", "ckpt_6"))
    trained = {flax_path(n): to_flax(n, p.detach().numpy()) for n, p in model.named_parameters()}
    assert flat.keys() == trained.keys()
    assert all(np.array_equal(flat[k], trained[k]) for k in flat)


def test_grover_train_cli_refuses_pipeline_parallel(cli_setup, tmp_path):
    """--pp 2 in one process: the world must be the stages (one rank each
    under torchrun; tests/test_torch_pipeline.py runs them)."""
    with pytest.raises(ValueError, match="world size must equal pp"):
        grover_train.main(_argv(cli_setup, tmp_path / "pp") + ["--pp", "2",
                                                               "--microbatches", "2"])
    with pytest.raises(ValueError, match="no files"):
        grover_train.main(_argv(cli_setup, tmp_path / "none")[:2] + [
            "--train_files", str(tmp_path / "missing-*"), "--output_dir", str(tmp_path),
            "--device", "cpu"])
