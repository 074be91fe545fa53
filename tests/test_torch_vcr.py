"""VCR finetuning and its eval sidecar, merlot_tpu_torch vs merlot_tpu.

Byte for byte: ``build_vcr_example`` and ``prepare_vcr_shard``, the drawn
overlays (bbox and segm) and ``VCRTokenizer``'s ids and tags. Bit for bit:
the joint loader in training (shuffle buffer, random scale, two epochs),
untrained, and the eval loader; the port's ``start`` equals the full
stream from that batch on. Within 1e-5 (absolute and relative, fp32, 2
layers, width 64, 32x64 images): the train-mode and eval-mode logits, the
loss and accuracy, and ``validate``'s log-probs; its accuracy and
predictions equal. One train step against JAX's ``make_loss_train_step``
(dropout 0): the loss within 1e-5 relative, the grads and updated state
within ``tests/test_torch_train_step.py``'s tolerances
(``torch_port_helpers``). The train CLI end to end on the CPU from a
pretrain checkpoint, resumed bit for bit; the sidecar's poll.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_tpu.downstream.vcr import data_prep as jprep
from merlot_tpu.downstream.vcr.dataloader import vcr_eval_batches as jax_eval_batches
from merlot_tpu.downstream.vcr.dataloader import vcr_joint_batches as jax_joint_batches
from merlot_tpu.downstream.vcr.modeling import VCRModel as JaxVCR
from merlot_tpu.downstream.vcr.modeling import vcr_loss_and_metrics as jax_loss
from merlot_tpu.downstream.vcr.validate import evaluate_checkpoint as jax_evaluate
from merlot_tpu.models.config import MerlotConfig as JaxConfig
from merlot_tpu.train.optimizer import AdamWConfig as JaxAdamWConfig
from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
from merlot_tpu.train.train_step import make_loss_train_step as jax_make_loss_train_step
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.downstream.vcr import data_prep, train, validate
from merlot_tpu_torch.downstream.vcr.dataloader import vcr_eval_batches, vcr_joint_batches
from merlot_tpu_torch.downstream.vcr.modeling import VCRModel, vcr_loss_and_metrics
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.nn.layers import init_params
from merlot_tpu_torch.train.checkpoint import CheckpointManager
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import make_loss_train_step
from tests.test_downstream import _write_synthetic_vcr_shard
from torch_port_helpers import (OPT, check_step_grads, check_step_params_and_state,
                                flat_params)

# tests/test_downstream.py's VCR config
TINY = dict(hidden_size=64, vocab_size=50370, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, image_size=(32, 64),
            patch_size=16, spatial_pool_size=2, use_bfloat16=False,
            num_vision_transformer_hidden_layers=2,
            num_lang_transformer_hidden_layers=2, hidden_dropout_prob=0.0,
            num_texts=4, max_position_embeddings=256)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny ops: more intra-op threads only contend with the other test
    processes. Results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# data preparation

OBJECTS = ["person", "person", "car", "dog", "person"]
ITEM = {
    "img_id": "val-42", "annot_id": "val-1234", "objects": OBJECTS,
    "img_fn": "img.png", "metadata_fn": "img.json",
    "question": ["What", "is", [0], "doing", "with", [2, 3], "?"],
    "answer_choices": [["[0]", "is", "driving", "."], [[1], "is", "walking", [3], "."],
                       ["Nothing", "."], [[0, 1, 4], "are", "waiting", "."]],
    "answer_label": 1,
    "rationale_choices": [["Because", [1], "holds", "a", "leash", "."], ["No", "idea", "."],
                          [[4], "'s", "car", "is", "red", "."], ["The", "dog", "barks", "."]],
    "rationale_label": 0,
}


@pytest.fixture(scope="module")
def vcr_tokenizers():
    return data_prep.VCRTokenizer(), jprep.VCRTokenizer()


@pytest.mark.parametrize("stream", ITEM["answer_choices"] + ITEM["rationale_choices"]
                         + [ITEM["question"], [[2], "and", [0, 1], "."]])
def test_vcr_tokenizer_matches_jax(vcr_tokenizers, stream):
    port, jax_tok = vcr_tokenizers
    ids, tags = port(stream, OBJECTS)
    assert (ids, tags) == jax_tok(stream, OBJECTS)
    assert len(ids) == len(tags) > 0


@pytest.mark.parametrize("mode", ["answer", "rationale"])
def test_collect_mentions_matches_jax(mode):
    assert data_prep.collect_mentions(ITEM, mode) == jprep.collect_mentions(ITEM, mode)


def _photo(seed=0, hw=(60, 80)):
    from PIL import Image
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8))


BOXES = [[5, 5, 40, 30, 0.9], [45, 10, 75, 50, 0.8], [0, 0, 79, 59, 0.5],
         [30.7, 20.2, 60.9, 58.1, 0.4], [10, 40, 20, 55, 0.7]]
SEGMS = [[[(10, 10), (30, 10), (20, 25)]], [[(50, 12), (70, 15), (72, 45), (48, 40)]],
         [], [[(5, 50), (15, 52)], [(60, 5), (70, 5), (65, 18)]], [[(1, 1)]]]


@pytest.mark.parametrize("kind,shapes", [("bbox", BOXES), ("segm", SEGMS)])
@pytest.mark.parametrize("mentions,objects", [([0], [1]), ([0, 1, 4], [2, 3]), ([], [])])
def test_draw_grounding_pixels_match_jax(kind, shapes, mentions, objects):
    got = data_prep.draw_grounding(_photo(), shapes, mentions, objects, kind=kind)
    want = jprep.draw_grounding(_photo(), shapes, mentions, objects, kind=kind)
    assert got.mode == want.mode == "RGB"
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_build_vcr_example_bytes_match_jax(vcr_tokenizers):
    rng = np.random.default_rng(1)
    drawn = {f"{m}/{d}": bytes(rng.integers(0, 256, 64, dtype=np.uint8))
             for m in ("answer", "rationale") for d in ("bbox", "segm")}
    port, jax_tok = vcr_tokenizers
    assert data_prep.build_vcr_example(ITEM, drawn, port) == \
        jprep.build_vcr_example(ITEM, drawn, jax_tok)


def test_prepare_vcr_shard_bytes_match_jax(tmp_path):
    _photo(3, (60, 80)).save(tmp_path / "img.png")
    (tmp_path / "img.json").write_text(json.dumps({"boxes": BOXES, "segms": SEGMS}))
    items = [ITEM, dict(ITEM, annot_id="val-1235", answer_label=3, rationale_label=2)]
    (tmp_path / "ann.jsonl").write_text("".join(json.dumps(i) + "\n" for i in items))
    for fold in (0, 1):
        n = data_prep.prepare_vcr_shard(str(tmp_path / "ann.jsonl"), str(tmp_path),
                                        str(tmp_path / "p.tfrecord"), fold, 2)
        jprep.prepare_vcr_shard(str(tmp_path / "ann.jsonl"), str(tmp_path),
                                str(tmp_path / "j.tfrecord"), fold, 2)
        assert n == 1
        assert (tmp_path / "p.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()


# ----------------------------------------------------------------------
# loaders

CONFIG = {"image_size": [32, 64], "draw": "segm", "shuffle_buffer_size": 4}


@pytest.fixture(scope="module")
def vcr_shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcr")
    paths = [str(d / f"train-{i}.tfrecord") for i in range(2)]
    _write_synthetic_vcr_shard(paths[0], n=5, img_hw=(40, 60), seed=0)
    _write_synthetic_vcr_shard(paths[1], n=4, img_hw=(50, 44), seed=1)
    return paths


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "annot_id":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("kw,n", [(dict(seed=0), 10), (dict(seed=5, config=dict(draw="bbox")), 10),
                                  (dict(is_training=False), 4)],
                         ids=["train_two_epochs", "train_bbox", "untrained"])
def test_vcr_joint_batches_match_jax(vcr_shards, kw, n):
    """Batch 2 over 9 examples: the training runs read 10 batches, past the
    second epoch's start (a fresh file order, the buffer shuffling anew)."""
    kw = dict(kw)
    config = dict(CONFIG, **kw.pop("config", {}))
    take = lambda it: [next(it) for _ in range(n)]
    got = take(vcr_joint_batches(vcr_shards, config, 2, **kw))
    want = take(jax_joint_batches(vcr_shards, config, 2, **kw))
    _equal_batches(got, want)
    assert got[0]["images"].shape == (4, 32, 64, 3)
    assert got[0]["lm_input"].shape == (16, 184) and got[0]["lm_targets"].shape == (4,)


@pytest.mark.parametrize("start", [1, 4, 7])
def test_vcr_joint_batches_start_is_the_streams_tail(vcr_shards, start):
    full = vcr_joint_batches(vcr_shards, CONFIG, 2, seed=3)
    want = [next(full) for _ in range(start + 3)][start:]
    late = vcr_joint_batches(vcr_shards, CONFIG, 2, seed=3, start=start)
    _equal_batches([next(late) for _ in range(3)], want)


@pytest.mark.parametrize("mode", ["answer", "rationale"])
def test_vcr_eval_batches_match_jax(vcr_shards, mode):
    got = list(vcr_eval_batches(vcr_shards, CONFIG, 4, mode=mode))
    want = list(jax_eval_batches(vcr_shards, CONFIG, 4, mode=mode))
    _equal_batches(got, want)
    assert len(got) == 2 and got[0]["lm_input"].shape == (4, 4, 184)


# ----------------------------------------------------------------------
# the model


def _init_all(mdl, images, lm_input):
    """The training forward, then every MerlotModel parameter the heads do
    not reach, so that the tree fills the port's model."""
    mdl(images, lm_input)
    m, h = mdl.merlot, mdl.cfg.hidden_size
    m.embed_words(lm_input[:, :32], which="langonly")
    z = jnp.zeros((2, h), jnp.float32)
    m.contrastive_features(z, z)
    x = jnp.zeros((1, 2, h), jnp.float32)
    m.temporal_logits(x, x, which="lang_viz")
    m.temporal_logits(x, x, which="viz_viz")
    return 0


def _batch(seed=0, examples=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(100, 50357, (examples * 8, 184)).astype(np.int32)
    for row in ids:
        row[rng.integers(12, 60):] = 0
    return {"images": rng.uniform(0, 1, (examples * 2, 32, 64, 3)).astype(np.float32),
            "lm_input": ids,
            "lm_targets": rng.integers(0, 4, examples * 2).astype(np.int32)}


@pytest.fixture(scope="module")
def vcr_pair():
    jcfg = JaxConfig(**TINY)
    jm = JaxVCR(jcfg)
    b = _batch()
    variables = jax.jit(lambda k: jm.init(k, jnp.asarray(b["images"]),
                                          jnp.asarray(b["lm_input"]), method=_init_all)
                        )(jax.random.PRNGKey(0))
    tm = VCRModel(MerlotConfig(**dataclasses.asdict(jcfg)))
    load_flax_params(tm, flat_params(variables["params"]))
    return jm, variables, tm, b


def test_vcr_head_init_is_the_prior():
    tm = VCRModel(MerlotConfig(**TINY))
    init_params(tm, torch.Generator().manual_seed(0))
    for head in (tm.answer_cls, tm.rationale_cls):
        assert torch.equal(head.mlp1.bias, torch.full((1,), -np.log(3.0), dtype=torch.float32))
        assert torch.equal(head.mlp0.bias, torch.zeros(32))
    with pytest.raises(ValueError, match="num_texts"):
        VCRModel(MerlotConfig(**dict(TINY, num_texts=1)))


@pytest.mark.parametrize("mode", [None, "answer", "rationale"])
def test_vcr_logits_match_jax(vcr_pair, mode):
    jm, variables, tm, b = vcr_pair
    if mode is None:           # training mode, dropout 0
        want = jax.jit(lambda v, i, t: jm.apply(v, i, t, deterministic=False))(
            variables, b["images"], b["lm_input"])
        got = tm(torch.from_numpy(b["images"]), torch.from_numpy(b["lm_input"]),
                 deterministic=False)
        assert got.shape == (4, 4)
    else:
        images, ids = b["images"][:2], b["lm_input"][:8].reshape(2, 4, 184)
        want = jax.jit(lambda v, i, t: jm.apply(v, i, t, mode=mode))(variables, images, ids)
        with torch.no_grad():
            got = tm(torch.from_numpy(images), torch.from_numpy(ids), mode=mode)
        assert got.shape == (2, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_vcr_train_logit_order_is_answer_then_rationale(vcr_pair):
    """Row 2e is example e's answer logits, row 2e+1 its rationale logits:
    the order of its [answer, rationale] targets."""
    _, _, tm, b = vcr_pair
    with torch.no_grad():
        train = tm(torch.from_numpy(b["images"]), torch.from_numpy(b["lm_input"]))
        for e in range(2):
            for k, mode in enumerate(("answer", "rationale")):
                r = 2 * e + k
                one = tm(torch.from_numpy(b["images"][r:r + 1]),
                         torch.from_numpy(b["lm_input"][4 * r:4 * r + 4]), mode=mode)
                torch.testing.assert_close(train[r], one[0], **TOL)


def test_vcr_loss_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (6, 4)).astype(np.float32)
    targets = rng.integers(0, 4, 6).astype(np.int32)
    loss, metrics = vcr_loss_and_metrics(torch.from_numpy(logits), torch.from_numpy(targets))
    jloss, jmetrics = jax_loss(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **TOL)


def test_vcr_train_step_matches_jax(vcr_pair):
    jm, variables, _, b = vcr_pair
    tm = VCRModel(MerlotConfig(**TINY))
    load_flax_params(tm, flat_params(variables["params"]))

    def jax_loss_fn(p, batch, key):
        logits = jm.apply({"params": p}, batch["images"], batch["lm_input"],
                          deterministic=False, rngs={"dropout": key})
        return jax_loss(logits, batch["lm_targets"])

    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    jopt = JaxAdamW(JaxAdamWConfig.from_config(OPT))
    params = variables["params"]
    jstate = jopt.init(params)
    key = jax.random.PRNGKey(3)
    jgrads = jax.jit(jax.grad(lambda p: jax_loss_fn(p, jbatch, key)[0]))(params)
    new_params, new_state, jmetrics = jax_make_loss_train_step(jax_loss_fn, jopt,
                                                                donate=False)(
        params, jstate, jbatch, key)

    def loss_fn(model, batch, generator):
        logits = model(batch["images"], batch["lm_input"], deterministic=False,
                       generator=generator)
        return vcr_loss_and_metrics(logits, batch["lm_targets"])

    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    state = opt.init(dict(tm.named_parameters()))
    metrics = make_loss_train_step(loss_fn, opt, device="cpu")(
        tm, state, {k: torch.from_numpy(v) for k, v in b.items()}, None)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]))
    for p in tm.parameters():     # the parameters no head reaches: no grad
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    stepped = (tm, state, metrics, flat_params(jgrads), flat_params(new_params),
               {k: flat_params(new_state[k]) for k in ("m", "v")}, jmetrics)
    check_step_grads(stepped)
    check_step_params_and_state(stepped)


# ----------------------------------------------------------------------
# the eval sidecar


@pytest.mark.parametrize("mode", ["answer", "rationale"])
def test_evaluate_checkpoint_matches_jax(vcr_pair, vcr_shards, tmp_path, mode):
    jm, variables, tm, _ = vcr_pair
    acc = validate.evaluate_checkpoint(tm, vcr_shards, CONFIG, 2, mode,
                                       predictions_path=str(tmp_path / "p.jsonl"))
    jacc = jax_evaluate(jm, variables["params"], vcr_shards, CONFIG, 2, mode,
                        predictions_path=str(tmp_path / "j.jsonl"))
    assert acc == jacc
    got = [json.loads(x) for x in open(tmp_path / "p.jsonl")]
    want = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("annot_id", "prediction", "label")} == \
            {k: w[k] for k in ("annot_id", "prediction", "label")}
        np.testing.assert_allclose(g["log_probs"], w["log_probs"], **TOL)
    assert validate.evaluate_checkpoint(tm, vcr_shards, CONFIG, 2, mode, max_examples=3) == \
        jax_evaluate(jm, variables["params"], vcr_shards, CONFIG, 2, mode, max_examples=3)


# ----------------------------------------------------------------------
# the CLIs

YAML = """\
data:
  train_file: "{d}/train-*.tfrecord"
  val_file: "{d}/train-*.tfrecord"
  draw: "segm"
  shuffle_buffer_size: 4
model:
  init_checkpoint: "{init}"
{model}
device:
  output_dir: "{out}"
  train_batch_size: 2
  val_batch_size: 2
  iterations_per_loop: 2
  log_every: 1
optimizer:
  learning_rate: 1.0e-3
  num_train_steps: 4
  num_warmup_steps: 1
  use_bfloat16_adam: true
  clip_norm: 0.0
downstream:
  task: "vcr"
  mode: "rationale"
validate:
  eval_samples: 4
  eval_timeout: {timeout}
"""


def _yaml(d, out, init, timeout=60, **model):
    kw = dict(TINY, **dict(dict(hidden_dropout_prob=0.1, use_bfloat16=True), **model))
    lines = "\n".join(f"  {k}: {json.dumps(list(v) if isinstance(v, tuple) else v)}"
                      for k, v in kw.items())
    return YAML.format(d=d, out=out, init=init, model=lines, timeout=timeout)


@pytest.fixture(scope="module")
def pretrain_ckpt(tmp_path_factory):
    """A pretrain checkpoint at the tiny width with 1024 positions (VCR's
    config has 256, so its two position tables are skipped)."""
    d = tmp_path_factory.mktemp("pretrain")
    model = MerlotPretrainModel(MerlotConfig(**dict(TINY, num_texts=1,
                                                    max_position_embeddings=1024)))
    init_params(model, torch.Generator().manual_seed(7))
    opt = MerlotAdamW(AdamWConfig(learning_rate=1e-4, num_train_steps=1))
    params = dict(model.named_parameters())
    mgr = CheckpointManager(str(d / "checkpoints"))
    mgr.save(5, params, opt.init(params))
    return mgr.path(5), params


def _state_equal(t1, s1, t2, s2):
    for (n, a), (_, b) in zip(t1.model.named_parameters(), t2.model.named_parameters()):
        assert torch.equal(a, b), n
    assert s1["step"] == s2["step"]
    for group in ("m", "v"):
        for n in s1[group]:
            assert torch.equal(s1[group][n].view(torch.int16),
                               s2[group][n].view(torch.int16)), (group, n)


def neat_config(text, tmp_path):
    from merlot_tpu_torch.core.config import NeatConfig
    (tmp_path / "v.yaml").write_text(text)
    return NeatConfig.from_yaml(str(tmp_path / "v.yaml"))


def test_train_cli_warm_starts_and_resumes_bit_exact(vcr_shards, pretrain_ckpt, tmp_path,
                                                     capsys):
    d = os.path.dirname(vcr_shards[0])
    init, src = pretrain_ckpt
    for name in ("a", "b"):
        (tmp_path / f"{name}.yaml").write_text(_yaml(d, tmp_path / name, init))
    a = train.main([str(tmp_path / "a.yaml"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warm_start: shape mismatch at merlot/position_embeddings" in out
    assert "warm_start: shape mismatch at merlot/langonly_position_embeddings" in out
    n_vcr = len(list(a["trainer"].model.parameters()))
    assert f"warm_start: initialized {len(src) - 2}/{n_vcr} leaves" in out
    assert a["trainer"].ckpt.all_steps() == [2, 4] and a["opt_state"]["step"] == 4
    lines = [json.loads(x) for x in open(tmp_path / "a" / "train_metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(x["loss"]) and 0 <= x["accuracy"] <= 1 for x in lines)

    # b resumes from a's step-2 checkpoint: its warm start must not apply,
    # its stream starts at batch 2, and it ends where a ended, bit for bit
    os.makedirs(tmp_path / "b" / "checkpoints")
    shutil.copytree(a["trainer"].ckpt.path(2), tmp_path / "b" / "checkpoints" / "ckpt_2")
    b = train.main([str(tmp_path / "b.yaml"), "--device", "cpu"])
    assert "warm_start" not in capsys.readouterr().out
    b_lines = [json.loads(x) for x in open(tmp_path / "b" / "train_metrics.jsonl")]
    assert [x["step"] for x in b_lines] == [3, 4]
    assert [x["loss"] for x in b_lines] == [x["loss"] for x in lines[2:]]
    _state_equal(a["trainer"], a["opt_state"], b["trainer"], b["opt_state"])

    # the sidecar over a's checkpoints, with an unreadable one beside them
    os.makedirs(tmp_path / "a" / "checkpoints" / "ckpt_3")
    (tmp_path / "a" / "checkpoints" / "ckpt_3" / "params.npz").write_bytes(b"not a zip")
    seen = validate.watch_and_validate(
        neat_config(_yaml(d, tmp_path / "a", init, timeout=1.0), tmp_path),
        poll_seconds=0.2, device="cpu")
    assert sorted(seen) == [2, 4] and all(0 <= v <= 1 for v in seen.values())
    assert "skipping step 3" in capsys.readouterr().out
    logged = [json.loads(x) for x in open(tmp_path / "a" / "eval" / "eval_metrics.jsonl")]
    assert [(x["step"], x["rationale_accuracy"]) for x in logged] == sorted(seen.items())


def test_sidecar_accuracy_is_evaluate_checkpoints(vcr_pair, vcr_shards, tmp_path):
    """watch_and_validate loads a checkpoint and logs evaluate_checkpoint's
    accuracy at eval_samples."""
    _, _, tm, _ = vcr_pair
    opt = MerlotAdamW(AdamWConfig(learning_rate=1e-4, num_train_steps=1))
    params = dict(tm.named_parameters())
    CheckpointManager(str(tmp_path / "o" / "checkpoints")).save(6, params, opt.init(params))
    config = neat_config(_yaml(os.path.dirname(vcr_shards[0]), tmp_path / "o", "",
                                timeout=0.5, use_bfloat16=False, hidden_dropout_prob=0.0),
                          tmp_path)
    seen = validate.watch_and_validate(config, poll_seconds=0.1, device="cpu")
    merged = dict(config.merged_data_model(), **config.downstream)
    assert seen == {6: validate.evaluate_checkpoint(tm, config.data["val_file_expanded"],
                                                    merged, 2, "rationale", 4)}


def test_train_cli_refuses_model_parallelism(vcr_shards, tmp_path):
    text = _yaml(os.path.dirname(vcr_shards[0]), tmp_path / "o", "").replace(
        "  log_every: 1\n", "  log_every: 1\n  model_parallelism: 2\n")
    (tmp_path / "c.yaml").write_text(text)
    with pytest.raises(NotImplementedError, match="model_parallelism"):
        train.main([str(tmp_path / "c.yaml"), "--device", "cpu"])


@pytest.mark.parametrize("entry", [train.main, validate.main], ids=["train", "validate"])
def test_clis_run_on_cuda_unless_asked(vcr_shards, tmp_path, entry):
    (tmp_path / "c.yaml").write_text(_yaml(os.path.dirname(vcr_shards[0]), tmp_path / "o", ""))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry([str(tmp_path / "c.yaml")])
