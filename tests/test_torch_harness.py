"""merlot_tpu_torch.train.harness (the Trainer), metrics and the pretrain
CLI on the CPU, at a tiny config (2 layers, 64 wide, 4 chunks, 64x96
frames, fp32, dropout on).

On the CPU the step is deterministic, so a resumed run must equal an
uninterrupted one bit for bit (params, bf16 moments and losses). The event
files are compared with the JAX package's MetricsLogger's for the same
metrics, value for value.
"""

import dataclasses
import glob
import json
import math
import os

import pytest
import torch
from torch import nn

import __graft_entry__ as graft
from merlot_tpu.train.metrics import MetricsLogger as JaxMetricsLogger
from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train import pretrain
from merlot_tpu_torch.train.harness import Trainer
from merlot_tpu_torch.train.metrics import read_events
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import make_loss_train_step
from torch_port_helpers import tiny_batch, to_torch

OPT = dict(learning_rate=1e-3, num_train_steps=10, num_warmup_steps=1, clip_norm=0.0,
           use_bfloat16_adam=True, weight_decay_rate=0.01)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ops here are tiny: torch's intra-op threads would only contend
    with the other test processes for the cores (a step took 50x longer
    in a loaded run). Results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = dataclasses.replace(graft._flagship_config(tiny=True), use_bfloat16=False,
                              hidden_dropout_prob=0.1)
    return MerlotConfig(**dataclasses.asdict(cfg))


def _batches(cfg, n):
    jcfg = graft._flagship_config(tiny=True)
    return [to_torch(tiny_batch(jcfg, seed=i, image_seed=100 + i)) for i in range(n)]


def _trainer(out, **kw):
    cfg = _cfg()
    model = MerlotPretrainModel(cfg)
    opt = MerlotAdamW(AdamWConfig(**OPT))
    return Trainer(model, opt, output_dir=str(out), device="cpu", **kw), cfg


def _state_equal(t1, s1, t2, s2):
    for (n, a), (_, b) in zip(t1.model.named_parameters(), t2.model.named_parameters()):
        assert torch.equal(a, b), n
    assert s1["step"] == s2["step"]
    for group in ("m", "v"):
        for n in s1[group]:
            assert torch.equal(s1[group][n].view(torch.int16),
                               s2[group][n].view(torch.int16)), (group, n)


def test_trainer_logs_checkpoints_and_writes_jax_events(tmp_path):
    trainer, cfg = _trainer(tmp_path / "run", log_every=1, checkpoint_every=2)
    state = trainer.init_state()
    state = trainer.run(state, iter(_batches(cfg, 4)), num_steps=4)
    assert state["step"] == 4
    assert trainer.ckpt.all_steps() == [2, 4]

    lines = [json.loads(x) for x in open(tmp_path / "run" / "train_metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    assert all(math.isfinite(x["loss"]) for x in lines)
    assert all("perf/steps_per_sec" in x for x in lines)

    # the same metrics through JAX's MetricsLogger: the same event records
    jax_logger = JaxMetricsLogger(str(tmp_path / "jax"))
    for x in lines:
        jax_logger.log(x["step"], {k: v for k, v in x.items()
                                   if k not in ("step", "time", "steps_per_sec")},
                       echo=False)
    jax_logger.close()
    ours = read_events(glob.glob(str(tmp_path / "run" / "train" / "events.out.tfevents.*"))[0])
    theirs = read_events(glob.glob(str(tmp_path / "jax" / "train" / "events.out.tfevents.*"))[0])
    assert len(ours) == len(theirs) == 5
    assert ours[0]["file_version"] == theirs[0]["file_version"] == "brain.Event:2"
    for a, b in zip(ours[1:], theirs[1:]):
        assert a["step"] == b["step"]
        a, b = dict(a["summary"]), dict(b["summary"])
        # steps_per_sec is each logger's own clock
        a.pop("steps_per_sec", None)
        b.pop("steps_per_sec", None)
        assert a == b
        assert {"loss", "lang/loss", "contr/loss_all", "learning_rate"} <= set(a)


def test_resume_is_bit_exact(tmp_path):
    batches = _batches(_cfg(), 4)
    t1, _ = _trainer(tmp_path / "a", log_every=10, checkpoint_every=10)
    s1 = t1.run(t1.init_state(), iter(batches), num_steps=4)

    t2, _ = _trainer(tmp_path / "b", log_every=10, checkpoint_every=2)
    t2.run(t2.init_state(), iter(batches[:2]), num_steps=2)
    # a fresh trainer and model restore from step 2 and continue
    t3, _ = _trainer(tmp_path / "b", log_every=10, checkpoint_every=10)
    s3 = t3.init_state()
    assert s3["step"] == 2
    s3 = t3.run(s3, iter(batches[2:]), num_steps=4)
    _state_equal(t1, s1, t3, s3)


def test_nan_guard_refuses_to_checkpoint(tmp_path):
    trainer, cfg = _trainer(tmp_path / "nan", log_every=100, checkpoint_every=2)
    batches = _batches(cfg, 2)
    batches[1]["images"][0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="refusing to checkpoint"):
        trainer.run(trainer.init_state(), iter(batches), num_steps=10)
    assert trainer.ckpt.latest_step() is None


def test_loss_train_step_with_a_toy_loss(tmp_path):
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(3, 8), nn.Tanh(), nn.Linear(8, 1))
    opt = MerlotAdamW(AdamWConfig(learning_rate=3e-2, num_train_steps=40, clip_norm=1.0))
    x = torch.randn(32, 3)
    data = {"x": x, "y": (x ** 2).sum(-1, keepdim=True)}

    def loss_fn(mdl, batch, generator):
        noise = torch.randn(batch["x"].shape, generator=generator) * 1e-3
        err = mdl(batch["x"] + noise) - batch["y"]
        return (err ** 2).mean(), {"abs_err": err.abs().mean()}

    trainer = Trainer(model, opt, output_dir=str(tmp_path), log_every=5,
                      checkpoint_every=20, device="cpu")
    trainer.step_fn = make_loss_train_step(loss_fn, opt, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    state = trainer.run(state, iter([data] * 40), num_steps=40)
    lines = [json.loads(x) for x in open(tmp_path / "train_metrics.jsonl")]
    assert lines[-1]["loss"] < 0.5 * lines[0]["loss"]
    assert {"abs_err", "learning_rate", "gradnorms/_overall"} <= set(lines[-1])
    assert trainer.ckpt.all_steps() == [20, 40] and state["step"] == 40


YAML = """\
data:
  train_file: "{d}/train-*.tfrecord"
  val_file: "{d}/val-*.tfrecord"
  num_chunks: 4
  chunk_text_len: 8
  augment_prob: 0.8
  shuffle_chunks: true
  shuffle_buffer_size: 4
  num_threads: 2
model:
  num_chunks_in_group: 2
  masking_use_attn: true
  resnet_layers: [1, 1, 1]
  image_size: [64, 96]
  hidden_size: 64
  intermediate_size: 128
  num_attention_heads: 4
  num_hidden_layers: 2
  num_vision_transformer_hidden_layers: 2
  num_lang_transformer_hidden_layers: 2
  use_bfloat16: true
  attention_softmax_fp32: false
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
validate:
  eval_samples: 4
"""


def test_pretrain_cli_end_to_end_and_resume(tmp_path):
    d = tmp_path / "shards"
    d.mkdir()
    write_synthetic_shard(str(d / "train-0.tfrecord"), 5, 4, seed=0, img_hw=(72, 128))
    write_synthetic_shard(str(d / "val-0.tfrecord"), 4, 4, seed=1, img_hw=(72, 128))
    runs = {}
    for name in ("a", "b"):
        (tmp_path / f"{name}.yaml").write_text(YAML.format(d=d, out=tmp_path / name))
    runs["a"] = pretrain.main([str(tmp_path / "a.yaml"), "--device", "cpu"])
    a = runs["a"]["trainer"]
    assert a.ckpt.all_steps() == [2, 4]
    assert runs["a"]["opt_state"]["step"] == 4
    means = runs["a"]["eval"]
    assert {"loss", "lang/loss", "contr/loss_all", "temporal/loss"} <= set(means)
    assert all(math.isfinite(v) for v in means.values())
    lines = [json.loads(x) for x in open(tmp_path / "a" / "train_metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3, 4, 4]
    assert "eval/loss" in lines[-1]

    # b starts from a's step-2 checkpoint, skips the 2 batches it used and
    # ends where a ended, bit for bit
    os.makedirs(tmp_path / "b" / "checkpoints")
    os.rename(a.ckpt.path(2), tmp_path / "b" / "checkpoints" / "ckpt_2")
    runs["b"] = pretrain.main([str(tmp_path / "b.yaml"), "--device", "cpu"])
    b_lines = [json.loads(x) for x in open(tmp_path / "b" / "train_metrics.jsonl")]
    assert [x["step"] for x in b_lines] == [3, 4, 4]
    assert [x["loss"] for x in b_lines[:2]] == [x["loss"] for x in lines[2:4]]
    _state_equal(a, runs["a"]["opt_state"], runs["b"]["trainer"], runs["b"]["opt_state"])
    assert runs["b"]["eval"] == means


def test_cli_runs_on_cuda_unless_asked(tmp_path):
    (tmp_path / "c.yaml").write_text(YAML.format(d=tmp_path, out=tmp_path / "c"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main([str(tmp_path / "c.yaml")])
