"""merlot_tpu_torch.train.checkpoint on the CPU: the port's own format
(flax-path .npz in the flax layout, bf16 moments as uint16 bit patterns,
written atomically) against itself, the JAX model and
``convert.load_flax_params``, at the tiny flagship config in fp32.

Save then restore is bit-exact (params, bf16 m and v, the step). The JAX
MerlotPretrainModel, given a port checkpoint's params by flax path with
numpy alone, reproduces the port's forward within the model tolerance of
tests/test_torch_pretrain.py (fp32 atol/rtol 1e-4).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train import checkpoint
from merlot_tpu_torch.train.checkpoint import CheckpointManager, warm_start
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import init_train_state
from torch_port_helpers import (OPT, build_pair, flat_params, pretrain_masking_draws,
                                tiny_batch, tiny_config, to_torch)

FP32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ops here are tiny: torch's intra-op threads would only contend
    with the other test processes for the cores (a step took 50x longer
    in a loaded run). Results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(cfg, seed):
    model = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    state = init_train_state(model, opt, seed=seed)
    return model, opt, state


def _fill_moments(state, seed):
    """Nonzero bf16 moments (v with negative entries: the sign-bit form)."""
    g = torch.Generator().manual_seed(seed)
    for group in ("m", "v"):
        for t in state[group].values():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    state["step"] = 17


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def pair(cfg):
    """(batch, flax model, its variables): one JAX init for the file."""
    batch = tiny_batch(cfg)
    jm, variables, _ = build_pair(cfg, batch)
    return batch, jm, variables


def test_save_restore_is_bit_exact(cfg, tmp_path):
    model, _, state = _port_model(cfg, seed=1)
    _fill_moments(state, 2)
    assert next(iter(state["m"].values())).dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(17, dict(model.named_parameters()), state)
    assert mgr.all_steps() == [17] and mgr.latest_step() == 17
    meta = json.loads((tmp_path / "checkpoints" / "ckpt_17" / "meta.json").read_text())
    assert meta == {"step": 17, "dtypes": {"params": "float32", "m": "bfloat16",
                                           "v": "bfloat16"}}

    other, _, other_state = _port_model(cfg, seed=3)
    assert not torch.equal(next(other.parameters()), next(model.parameters()))
    mgr.restore(17, other, other_state)
    assert other_state["step"] == 17
    for (n, a), (_, b) in zip(model.named_parameters(), other.named_parameters()):
        assert torch.equal(a, b), n
    for group in ("m", "v"):
        for n, t in state[group].items():
            got = other_state[group][n]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), t.view(torch.int16)), (group, n)


def test_params_file_is_flax_paths_in_the_flax_layout(cfg, tmp_path):
    model, _, state = _port_model(cfg, seed=1)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt_1"), dict(model.named_parameters()),
                               state)
    params = checkpoint.load_params(str(tmp_path / "ckpt_1"))
    assert "merlot/encoder/layer00/attention/query/kernel" in params
    w = model.merlot.encoder.layer00.attention.query.weight
    np.testing.assert_array_equal(
        params["merlot/encoder/layer00/attention/query/kernel"], w.detach().numpy().T)
    with np.load(tmp_path / "ckpt_1" / "opt_state.npz") as z:
        stored = z["m/merlot/encoder/layer00/attention/query/kernel"]
    assert stored.dtype == np.uint16 and stored.shape == tuple(w.shape[::-1])
    fresh = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    load_flax_params(fresh, params)
    for (n, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert torch.equal(a, b), n


def test_jax_model_reads_a_port_checkpoint(cfg, pair, tmp_path):
    batch, jm, variables = pair
    model, _, state = _port_model(cfg, seed=4)  # the port's own weights
    checkpoint.save_checkpoint(str(tmp_path / "ckpt_4"), dict(model.named_parameters()),
                               state)
    with np.load(tmp_path / "ckpt_4" / "params.npz") as z:  # numpy alone
        params = unflatten_dict({tuple(k.split("/")): z[k] for k in z.files})
    jax_vars = {"params": jax.tree.map(np.asarray, params)}
    assert (jax.tree.structure(jax_vars) == jax.tree.structure(
        jax.tree.map(np.asarray, variables)))
    key = jax.random.PRNGKey(5)
    loss, metrics, _ = jax.jit(lambda v, b, k: jm.apply(
        v, b, deterministic=True, rngs={"masking": k}))(jax_vars, batch, key)
    draws = pretrain_masking_draws(jm, jax_vars, key, cfg, batch)
    with torch.no_grad():
        got_loss, got, _ = model(to_torch(batch), deterministic=True, masking_draws=draws)
    np.testing.assert_allclose(float(got_loss), float(loss), **FP32)
    for k in ("lang/loss", "contr/loss_all", "temporal/loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), err_msg=k, **FP32)


def test_warm_start_equals_load_flax_params(cfg, pair, tmp_path):
    _, _, variables = pair
    flat = flat_params(variables["params"])
    mismatched = "merlot/encoder/layer01/attention/query/kernel"
    extra = dict(flat, **{"not/in/the/model": np.ones(3, np.float32),
                          mismatched: np.ones((3, 3), np.float32)})
    np.savez(tmp_path / "jax_flat.npz", **extra)

    want = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    load_flax_params(want, flat)
    got, _, _ = _port_model(cfg, seed=9)
    init = warm_start(got, str(tmp_path / "jax_flat.npz"))
    n_params = len(list(got.parameters()))
    assert len(init) == n_params - 1 and mismatched not in init
    for (n, a), (_, b) in zip(got.named_parameters(), want.named_parameters()):
        if n != "merlot.encoder.layer01.attention.query.weight":
            assert torch.equal(a, b), n

    # a port checkpoint directory is a warm-start source too
    params = dict(want.named_parameters())
    checkpoint.save_checkpoint(str(tmp_path / "ckpt_1"), params,
                               MerlotAdamW(AdamWConfig.from_config(OPT)).init(params))
    again, _, _ = _port_model(cfg, seed=11)
    assert len(warm_start(again, str(tmp_path / "ckpt_1"))) == n_params
    for (n, a), (_, b) in zip(again.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), n


def test_interrupted_write_is_never_the_latest(cfg, tmp_path, monkeypatch):
    model, _, state = _port_model(cfg, seed=1)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(2, dict(model.named_parameters()), state)

    # a crash mid-write: the second file fails to be written
    real = np.savez
    calls = []

    def crash(path, **arrays):
        calls.append(path)
        if len(calls) == 2:
            raise OSError("disk full")
        real(path, **arrays)

    monkeypatch.setattr(checkpoint.np, "savez", crash)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(4, dict(model.named_parameters()), state)
    monkeypatch.setattr(checkpoint.np, "savez", real)
    assert mgr.latest_step() == 2 and mgr.all_steps() == [2]
    assert not os.path.exists(mgr.path(4))

    # a process killed mid-write leaves its temporary directory behind
    left = tmp_path / "checkpoints" / ".tmp-ckpt_6-abc"
    left.mkdir()
    (left / "params.npz").write_bytes(b"partial")
    assert mgr.latest_step() == 2

    # a re-save of a step replaces it whole
    state["step"] = 5
    mgr.save(2, dict(model.named_parameters()), state)
    assert json.loads((tmp_path / "checkpoints" / "ckpt_2" / "meta.json").read_text())[
        "step"] == 5
    assert mgr.all_steps() == [2]


def test_save_is_on_the_disk_before_it_is_named(cfg, tmp_path, monkeypatch):
    """Every file and the temporary directory are fsynced before the rename
    that names the checkpoint, and the parent directory after it."""
    model, _, state = _port_model(cfg, seed=1)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    events = []
    real_fsync, real_rename = os.fsync, os.rename

    def fsync(fd):
        events.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        real_fsync(fd)

    def rename(src, dst):
        events.append(("rename", str(src), str(dst)))
        real_rename(src, dst)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "rename", rename)
    mgr.save(2, dict(model.named_parameters()), state)
    final = mgr.path(2)
    (named,) = [i for i, e in enumerate(events) if e[0] == "rename" and e[2] == final]
    tmp = os.path.realpath(events[named][1])
    before = {e[1] for e in events[:named] if e[0] == "fsync"}
    assert before == {tmp} | {os.path.join(tmp, n) for n in
                              (checkpoint.PARAMS_FILE, checkpoint.OPT_FILE, checkpoint.META_FILE)}
    assert ("fsync", os.path.realpath(mgr.directory)) in events[named + 1:]
