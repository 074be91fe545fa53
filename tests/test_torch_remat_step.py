"""The slice as a whole on the CPU: the pretraining step under per-layer
remat (``remat``/``remat_policy`` in the config) and
``MerlotPretrainModel.debug_forward``, at the tiny flagship config (2
layers per tower, hidden 64; ``torch_port_helpers.tiny_config``).

  * one port step with ``remat: true`` against JAX's remat step from the
    same weights, batch and masking draws (dropout 0): the step checks and
    tolerances of ``torch_port_helpers``;
  * with hidden dropout on, one generator seed: the port's forward and
    backward under every policy (the plain attention and the kernels'
    plain versions, unfused and with the fused LayerNorm) and its train
    step equal the run without remat bit for bit, and leave the generator
    in the same state;
  * ``remat: true`` in a YAML reaches all three towers through the port's
    own reader in the pretraining CLI (whose run equals the run without
    remat bit for bit) and in VCR finetuning's builder;
  * ``debug_forward`` against JAX's on the same weights and draws: loss and
    metrics (the ``attn/`` telemetry among them) 1e-4, the masked ids and
    positions exactly, the hidden states 1e-4.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import init_train_state, make_train_step
from torch_port_helpers import (OPT, build_pair, check_step_grads,
                                check_step_loss_and_metrics, check_step_params_and_state,
                                pretrain_masking_draws, step_both, tiny_batch, tiny_config,
                                to_torch)

FP32 = dict(atol=1e-4, rtol=1e-4)
POLICIES = [None, "dots", "dots_no_batch", "probs", "probs_dots"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: test files may run side by side, and
    torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stepped():
    return step_both(tiny_config(remat=True))


def test_remat_step_loss_and_metrics_match_jax(stepped):
    check_step_loss_and_metrics(stepped)


def test_remat_step_grads_match_jax(stepped):
    check_step_grads(stepped)


def test_remat_step_params_and_state_match_jax(stepped):
    check_step_params_and_state(stepped)


# ----------------------------------------------------------------------
# remat against no remat in the port, dropout on

@pytest.fixture(scope="module")
def seeded():
    """The tiny config with hidden dropout 0.1, its seeded weights and a
    batch."""
    cfg = MerlotConfig(**dataclasses.asdict(tiny_config()))
    cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.1)
    model = MerlotPretrainModel(cfg)
    init_train_state(model, MerlotAdamW(AdamWConfig.from_config(OPT)), seed=0)
    return cfg, model.state_dict(), to_torch(tiny_batch(tiny_config()))


def _forward_backward(seeded, backend, **cfg_kw):
    cfg, weights, batch = seeded
    model = MerlotPretrainModel(dataclasses.replace(cfg, **cfg_kw))
    model.load_state_dict(weights)
    g = torch.Generator().manual_seed(11)
    loss, metrics, fwd = model(batch, deterministic=False, attn_backend=backend, generator=g)
    loss.backward()
    return ([loss, fwd["lang_mask_info"]["masked_idx"]]
            + [p.grad for p in model.parameters()], g.get_state())


@pytest.mark.parametrize("backend,fused", [("plain", False), ("cuda", False), ("cuda", True)])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_forward_backward_bit_for_bit(seeded, policy, backend, fused):
    """The three towers under remat: the loss, the masked positions (from
    the lang tower's colsum), every grad and the generator's state equal
    the run without remat."""
    want, want_state = _forward_backward(seeded, backend, fuse_ln_matmul=fused)
    got, got_state = _forward_backward(seeded, backend, fuse_ln_matmul=fused, remat=True,
                                       remat_policy=policy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_state, want_state)


def _steps(cfg, weights, batch, n=2):
    model = MerlotPretrainModel(cfg)
    model.load_state_dict(weights)
    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, device="cpu")
    g = torch.Generator().manual_seed(3)
    metrics = [step(model, state, batch, g) for _ in range(n)]
    return model, state, metrics, g.get_state()


def test_remat_train_steps_bit_for_bit(seeded):
    """Two train steps on one generator (the second step's masks follow the
    first's draws): metrics, parameters and Adam moments equal."""
    cfg, weights, batch = seeded
    want = _steps(cfg, weights, batch)
    got = _steps(dataclasses.replace(cfg, remat=True, remat_policy="probs_dots"), weights,
                 batch)
    for mg, mw in zip(got[2], want[2]):
        assert {k: float(v) for k, v in mg.items()} == {k: float(v) for k, v in mw.items()}
    for (n, a), (_, b) in zip(got[0].named_parameters(), want[0].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n in want[1][k]:
            assert torch.equal(got[1][k][n], want[1][k][n]), (k, n)
    assert torch.equal(got[3], want[3])


# ----------------------------------------------------------------------
# remat from a YAML through the port's own reader

YAML = """\
data:
  train_file: "{d}/train-*.tfrecord"
  num_chunks: 4
  chunk_text_len: 8
  shuffle_buffer_size: 4
  num_threads: 1
model:
  num_chunks_in_group: 2
  resnet_layers: [1, 1, 1]
  image_size: [64, 96]
  hidden_size: 64
  intermediate_size: 128
  num_attention_heads: 4
  num_hidden_layers: 2
  num_vision_transformer_hidden_layers: 2
  num_lang_transformer_hidden_layers: 2
  hidden_dropout_prob: 0.1
  use_bfloat16: false
{remat}
device:
  output_dir: "{out}"
  train_batch_size: 2
  iterations_per_loop: 2
  log_every: 1
optimizer:
  learning_rate: 1.0e-3
  num_train_steps: 2
  num_warmup_steps: 1
  use_bfloat16_adam: true
  clip_norm: 0.0
downstream:
  task: "vcr"
"""


def _encoders(merlot):
    return (merlot.vision_backbone.encoder, merlot.encoder)


def test_yaml_remat_reaches_the_pretraining_cli_and_vcr(tmp_path):
    from merlot_tpu_torch.core.config import NeatConfig
    from merlot_tpu_torch.downstream.vcr.train import build_vcr_train
    from merlot_tpu_torch.train import pretrain
    d = tmp_path / "shards"
    d.mkdir()
    write_synthetic_shard(str(d / "train-0.tfrecord"), 4, 4, seed=0, img_hw=(72, 128))
    runs = {}
    for name, remat in (("off", ""), ("on", "  remat: true\n  remat_policy: probs")):
        path = tmp_path / f"{name}.yaml"
        path.write_text(YAML.format(d=d, out=tmp_path / name, remat=remat))
        model, _, _ = pretrain.build_pretrain_setup(NeatConfig.from_yaml(str(path)),
                                                    device="cpu")
        vcr_path = tmp_path / f"vcr_{name}.yaml"     # VCR's four texts per image
        vcr_path.write_text(YAML.format(d=d, out=tmp_path / f"vcr_{name}",
                                        remat=remat + "\n  num_texts: 4"))
        vcr_model, _, _ = build_vcr_train(NeatConfig.from_yaml(str(vcr_path)), device="cpu")
        for enc in _encoders(model.merlot) + _encoders(vcr_model.merlot):
            assert (enc.hp.remat, enc.hp.remat_policy) == (
                (True, "probs") if remat else (False, None))
        runs[name] = pretrain.main([str(path), "--device", "cpu"])
        runs[name]["lines"] = [json.loads(x) for x in
                               open(tmp_path / name / "train_metrics.jsonl")]
    assert len(runs["on"]["lines"]) == 2
    for a, b in zip(runs["on"]["lines"], runs["off"]["lines"]):
        assert {k: v for k, v in a.items() if "time" not in k and "per_s" not in k} == \
            {k: v for k, v in b.items() if "time" not in k and "per_s" not in k}
    for (n, a), (_, b) in zip(runs["on"]["trainer"].model.named_parameters(),
                              runs["off"]["trainer"].model.named_parameters()):
        assert torch.equal(a, b), n


# ----------------------------------------------------------------------
# debug_forward

def test_debug_forward_matches_jax():
    cfg = tiny_config()
    batch = tiny_batch(cfg)
    jm, variables, tm = build_pair(cfg, batch)
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda v, b, k: jm.apply(v, b, method=jm.debug_forward,
                                            rngs={"masking": k}))(variables, batch, key)
    draws = pretrain_masking_draws(jm, variables, key, cfg, batch)
    with torch.no_grad():
        got = tm.debug_forward(to_torch(batch), draws)
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"])
    assert {"attn/encoder/viz2viz", "attn/encoder/lang2viz", "attn/encoder/viz2lang",
            "attn/encoder/lang2lang"} <= set(got["metrics"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **FP32)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(got["metrics"][k]), float(v), err_msg=k, **FP32)
    for k in ("masked_ids", "masked_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, v in want["encoder_hidden_states"].items():
        np.testing.assert_allclose(got["encoder_hidden_states"][k].numpy(), np.asarray(v),
                                   err_msg=k, **FP32)
