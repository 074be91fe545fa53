"""The port's checkpoint tools (merlot_tpu_torch.tools.{convert_tf_checkpoint,
download_checkpoint,import_jax_checkpoint}) against the JAX package's, on
the CPU at small sizes:

  (a) the TF name maps equal JAX's, for five MERLOT configs and Grover's
      with and without a root;
  (b) each map covers the port model's parameters exactly, one for one;
  (c) a TF1 checkpoint with the reference's names (written by
      ``tf.compat.v1.train.Saver``, as tests/test_tf_convert.py writes one)
      read and converted by both packages: the forward outputs agree
      within fp32 atol/rtol 1e-4 (tests/test_torch_model.py's bound),
      Grover's logits within 1e-4 (tests/test_torch_grover.py's);
  (d) ``download_checkpoint`` against a ``file://`` directory standing in
      for the bucket, its model shrunk to the tiny widths, then the
      zero-shot CLI on the result: probs within 1e-5 of JAX's
      ``run_zero_shot`` on JAX's conversion (the zero-shot tolerance);
  (e) orbax checkpoints of the JAX package imported without orbax or jax:
      a train state with bf16 Adam restored with its moments bit for bit
      and one more step within tests/test_torch_train_step.py's bounds; a
      params-only tree served within 1e-4 of JAX's server; a
      ``grover_train --pp 2`` ``stages/`` tree unstacked by the server's
      ``load_npz_params``; a scan-layout tree unstacked exactly; unknown
      trees refused with nothing written;
and every reader of a params-only checkpoint (the zero-shot CLI, the
pretraining and VCR warm starts, the server's ``--ckpt``) takes one, while
``load_checkpoint`` refuses it by name.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax.traverse_util import unflatten_dict

from merlot_tpu.models import grover as jg
from merlot_tpu.models.config import MerlotConfig as JaxConfig
from merlot_tpu.tools import convert_tf_checkpoint as jconv
from merlot_tpu.tools import denoise_server as jds
from merlot_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from merlot_tpu.train.optimizer import AdamWConfig as JaxAdamWConfig
from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
from merlot_tpu_torch.convert import flax_path, load_flax_params
from merlot_tpu_torch.downstream.sort_story import get_zero_shot_logits as cli
from merlot_tpu_torch.downstream.vcr.modeling import VCRModel
from merlot_tpu_torch.models import grover as tg
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.tools import convert_tf_checkpoint as conv
from merlot_tpu_torch.tools import denoise_server as tds
from merlot_tpu_torch.tools import download_checkpoint as dl
from merlot_tpu_torch.tools import import_jax_checkpoint as imp
from merlot_tpu_torch.train import checkpoint
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import init_train_state, make_train_step
from torch_port_helpers import (OPT, build_pair, check_step_params_and_state, close_to_scale,
                                flat_params, flax_layout, pretrain_masking_draws, tiny_batch,
                                tiny_config, to_torch)

FP32 = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = 1e-4
PROBS_TOL = dict(atol=1e-5, rtol=1e-5)

# tests/test_tf_convert.py's config
CFG = dict(hidden_size=64, vocab_size=400, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, image_size=(64, 96), patch_size=16, spatial_pool_size=2,
           resnet_layers=(1, 2, 1), num_vision_transformer_hidden_layers=2,
           num_lang_transformer_hidden_layers=2, num_chunks_in_group=2, use_bfloat16=False,
           hidden_dropout_prob=0.0, do_projection=True, do_bias=True, image_shuffle_prob=0.4)
VARIANTS = {
    "test_config": {},
    "unshared_towers": {"share_params": False, "num_lang_transformer_hidden_layers": 3},
    "no_resnet": {"resnet_layers": ()},
    "no_projection_no_bias": {"do_projection": False, "do_bias": False},
}
GROVER = {"vocab_size": 50270, "hidden_size": 32, "num_hidden_layers": 2,
          "num_attention_heads": 2, "intermediate_size": 64, "max_position_embeddings": 128}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny ops: more intra-op threads only contend with the other test
    processes. Results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_paths(model):
    return {flax_path(n) for n, _ in model.named_parameters()}


def _noisy(flat, seed):
    """The leaves moved off any initialisation, so that a leaf a converter
    drops or misplaces shows."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flat.items()}


def _write_tf_checkpoint(prefix, arrays):
    tf = pytest.importorskip("tensorflow")
    prefix.parent.mkdir(parents=True, exist_ok=True)
    with tf.compat.v1.Graph().as_default():
        variables = [tf.compat.v1.get_variable(name, initializer=tf.constant(val))
                     for name, val in arrays.items()]
        saver = tf.compat.v1.train.Saver(variables)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(prefix))
    return str(prefix)


def _grover_config(tmp_path):
    path = tmp_path / "grover.json"
    path.write_text(json.dumps(GROVER))
    return str(path)


@pytest.fixture(scope="module")
def grover_params():
    """JAX GroverLM parameters at GROVER, by flax path (one JAX init for the
    file; tests move them with ``_noisy``)."""
    model = jg.GroverLM(jg.GroverConfig(**GROVER))
    ids = jnp.ones((1, 4), jnp.int32)
    return flat_params(jax.jit(lambda: model.init(jax.random.PRNGKey(0), ids))()["params"])


@pytest.fixture(scope="module")
def pair():
    """The tiny flagship config and batch, JAX's model and variables, and
    the port model on them (one JAX init for the file)."""
    cfg = tiny_config()
    batch = tiny_batch(cfg)
    jm, variables, tm = build_pair(cfg, batch)
    return dict(cfg=cfg, batch=batch, jm=jm, variables=variables, tm=tm)


# ----------------------------------------------------------------------
# (a), (b): the name maps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_merlot_name_map_equals_jax(variant):
    kw = dict(CFG, **VARIANTS[variant])
    assert conv.merlot_tf_name_map(MerlotConfig(**kw)) == \
        jconv.merlot_tf_name_map(JaxConfig(**kw))


def test_merlot_name_map_with_vcr_heads_equals_jax():
    assert conv.merlot_tf_name_map(MerlotConfig(**CFG), include_vcr_heads=True) == \
        jconv.merlot_tf_name_map(JaxConfig(**CFG), include_vcr_heads=True)


@pytest.mark.parametrize("root", ["", "lm"])
@pytest.mark.parametrize("num_layers", [2, 24])
def test_grover_name_map_equals_jax(root, num_layers):
    assert conv.grover_tf_name_map(num_layers, root=root) == \
        jconv.grover_tf_name_map(num_layers, root=root)


def _bijective_cover(name_map, model):
    assert len(set(name_map.values())) == len(name_map)
    assert set(name_map.values()) == _port_paths(model)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_merlot_name_map_covers_the_pretrain_model(variant):
    cfg = MerlotConfig(**dict(CFG, **VARIANTS[variant]))
    _bijective_cover(conv.merlot_tf_name_map(cfg), MerlotPretrainModel(cfg))


def test_merlot_name_map_covers_the_vcr_model():
    cfg = MerlotConfig(**dict(CFG, num_texts=4))
    _bijective_cover(conv.merlot_tf_name_map(cfg, include_vcr_heads=True), VCRModel(cfg))


def test_grover_name_map_covers_the_grover_model():
    cfg = tg.GroverConfig(**GROVER)
    _bijective_cover(conv.grover_tf_name_map(cfg.num_hidden_layers), tg.GroverLM(cfg))


# ----------------------------------------------------------------------
# (c): a TF1 checkpoint with the reference's names


@pytest.fixture(scope="module")
def merlot_tf(pair, tmp_path_factory):
    """The tiny flagship pair (JAX variables, the port model on them), and
    a TF checkpoint of moved weights under the reference's names, with an
    Adam slot and the global step beside them, one variable left out and
    one of another shape."""
    cfg, batch, jm, variables, tm = (pair[k] for k in ("cfg", "batch", "jm", "variables", "tm"))
    name_map = conv.merlot_tf_name_map(MerlotConfig(**dataclasses.asdict(cfg)))
    moved = _noisy(flat_params(variables["params"]), 1)
    arrays = {tf: moved[ours] for tf, ours in name_map.items()}
    missing, reshaped = "encoder/layer01/output/bias", "lm_head/output_bias"
    del arrays[missing]
    arrays[reshaped] = np.zeros(7, np.float32)
    arrays["encoder/layer00/query_layer/kernel/adam_m"] = np.ones((64, 64), np.float32)
    arrays["global_step"] = np.int64(5)
    prefix = _write_tf_checkpoint(tmp_path_factory.mktemp("tf") / "model.ckpt", arrays)
    return dict(cfg=cfg, batch=batch, jm=jm, variables=variables, tm=tm, prefix=prefix,
                name_map=name_map, moved=moved, missing=name_map[missing],
                reshaped=name_map[reshaped])


def test_tf_reader_skips_the_adam_slots_and_step(merlot_tf):
    arrays = conv.load_tf_checkpoint_arrays(merlot_tf["prefix"])
    assert set(arrays) == set(jconv.load_tf_checkpoint_arrays(merlot_tf["prefix"]))
    assert "global_step" not in arrays and not any("adam_" in k for k in arrays)
    assert len(arrays) == len(merlot_tf["name_map"]) - 1


def test_convert_with_a_template_keeps_what_the_checkpoint_lacks(merlot_tf):
    r = merlot_tf
    arrays = conv.load_tf_checkpoint_arrays(r["prefix"])
    template = flat_params(r["variables"]["params"])
    before = {n: p.detach().clone() for n, p in r["tm"].named_parameters()}
    got = conv.convert_arrays(arrays, r["name_map"], template=r["tm"], verbose=False)
    assert set(got) == _port_paths(r["tm"])
    for path, leaf in got.items():
        want = template[path] if path in (r["missing"], r["reshaped"]) else r["moved"][path]
        assert leaf.dtype == np.float32 and np.array_equal(leaf, want), path
    for n, p in r["tm"].named_parameters():  # the template is not changed
        assert torch.equal(p, before[n]), n
    bare = conv.convert_arrays(arrays, r["name_map"], verbose=False)
    assert set(bare) == set(r["name_map"].values()) - {r["missing"]}


def test_tf_checkpoint_forward_matches_jax(merlot_tf):
    r = merlot_tf
    cfg, batch, jm = r["cfg"], r["batch"], r["jm"]
    jparams = jconv.convert_arrays(jconv.load_tf_checkpoint_arrays(r["prefix"]), r["name_map"],
                                   params_template=r["variables"]["params"], verbose=False)
    model = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    load_flax_params(model, conv.convert_arrays(conv.load_tf_checkpoint_arrays(r["prefix"]),
                                                r["name_map"], template=r["tm"], verbose=False))
    jvars = {"params": jparams}
    key = jax.random.PRNGKey(5)
    loss, metrics, _ = jax.jit(lambda v, b, k: jm.apply(
        v, b, deterministic=True, rngs={"masking": k}))(jvars, batch, key)
    draws = pretrain_masking_draws(jm, jvars, key, cfg, batch)
    with torch.no_grad():
        got_loss, got, _ = model(to_torch(batch), deterministic=True, masking_draws=draws)
    np.testing.assert_allclose(float(got_loss), float(loss), **FP32)
    for k in ("lang/loss", "contr/loss_all", "temporal/loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), err_msg=k, **FP32)


def test_grover_tf_checkpoint_logits_match_jax(tmp_path, grover_params):
    name_map = conv.grover_tf_name_map(GROVER["num_hidden_layers"])
    moved = _noisy(grover_params, 2)
    prefix = _write_tf_checkpoint(tmp_path / "model.ckpt",
                                  {tf: moved[ours] for tf, ours in name_map.items()})
    jparams = jconv.convert_arrays(jconv.load_tf_checkpoint_arrays(prefix), name_map,
                                   verbose=False)
    model = tg.GroverLM(tg.GroverConfig(**GROVER))
    load_flax_params(model, conv.convert_arrays(conv.load_tf_checkpoint_arrays(prefix),
                                                name_map, verbose=False))
    ids = np.random.default_rng(0).integers(1, 50000, (2, 9)).astype(np.int32)
    jm = jg.GroverLM(jg.GroverConfig(**GROVER))
    want, _ = jax.jit(lambda v, i: jm.apply(v, i))({"params": jparams}, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ----------------------------------------------------------------------
# (d): download_checkpoint, then the zero-shot CLI

ZS = dict(hidden_size=64, vocab_size=50370, num_hidden_layers=2, num_attention_heads=4,
          intermediate_size=128, image_size=(32, 64), patch_size=16, spatial_pool_size=2,
          resnet_layers=(1, 1, 1), num_vision_transformer_hidden_layers=2,
          num_lang_transformer_hidden_layers=2, num_chunks_in_group=5, use_bfloat16=False,
          hidden_dropout_prob=0.0, do_projection=True, do_bias=True, contrastive_size=768)
ZS_YAML = """\
data:
  val_file: "{shard}"
  num_chunks: 5
model:
{model}
device:
  output_dir: "{out}"
  val_batch_size: 2
optimizer:
  learning_rate: 1.0e-4
  num_train_steps: 1
"""


def _zs_params():
    """A port MerlotPretrainModel's parameters at ZS from seed 0, by flax
    path (``merlot/...``) in the flax layout."""
    from merlot_tpu_torch.nn.layers import init_params
    model = MerlotPretrainModel(MerlotConfig(**ZS))
    init_params(model, torch.Generator().manual_seed(0))
    return {flax_path(n): flax_layout(n, p.detach().numpy()) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def downloaded(tmp_path_factory):
    """The bucket as a file:// directory holding a TF checkpoint at ZS's
    shapes (the released names); ``download`` and ``convert`` with the
    released config shrunk to ZS; a story shard and the CLI's YAML."""
    from merlot_tpu_torch.downstream.sort_story.data import write_synthetic_story_shard
    d = tmp_path_factory.mktemp("download")
    name_map = conv.merlot_tf_name_map(MerlotConfig(**ZS))
    moved = _noisy(_zs_params(), 3)
    arrays = {tf: moved[ours] for tf, ours in name_map.items()}
    _write_tf_checkpoint(d / "bucket" / "checkpoint_5segments" / "model.ckpt", arrays)
    mp = pytest.MonkeyPatch()
    mp.setattr(dl, "BASE", f"file://{d / 'bucket'}")
    mp.setattr(dl, "released_config", lambda segments: MerlotConfig(**ZS))
    try:
        dl.main(["--segments", "5", "--out_dir", str(d / "tf"),
                 "--converted", str(d / "out" / "checkpoints" / "ckpt_0")])
    finally:
        mp.undo()
    shard = str(d / "val.tfrecord")
    assert write_synthetic_story_shard(shard, num_stories=3, img_hw=(40, 72), seed=1,
                                       pad_to_batch_size=2) == 4
    model = "\n".join(f"  {k}: {json.dumps(list(v) if isinstance(v, tuple) else v)}"
                      for k, v in ZS.items())
    (d / "zs.yaml").write_text(ZS_YAML.format(shard=shard, model=model, out=d / "out"))
    return dict(dir=d, arrays=arrays, name_map=name_map, shard=shard)


def test_download_fetches_the_three_files_once(downloaded, monkeypatch, capsys):
    d = downloaded["dir"]
    assert sorted(os.listdir(d / "tf")) == sorted(dl.CKPT_FILES)
    for name in dl.CKPT_FILES:
        assert (d / "tf" / name).read_bytes() == \
            (d / "bucket" / "checkpoint_5segments" / name).read_bytes()
    monkeypatch.setattr(dl, "BASE", "file:///nonexistent")
    assert dl.download(5, str(d / "tf")) == str(d / "tf" / "model.ckpt")
    assert capsys.readouterr().out.count("exists: ") == 3


def test_download_writes_a_params_only_checkpoint(downloaded):
    ckpt = downloaded["dir"] / "out" / "checkpoints" / "ckpt_0"
    assert sorted(os.listdir(ckpt)) == ["meta.json", "params.npz"]
    assert json.loads((ckpt / "meta.json").read_text()) == {
        "step": None, "opt_state": False, "dtypes": {"params": "float32"}}
    params = checkpoint.load_params(str(ckpt))
    assert set(params) == set(downloaded["name_map"].values())
    for tf, ours in downloaded["name_map"].items():
        assert np.array_equal(params[ours], downloaded["arrays"][tf]), ours


def test_zero_shot_cli_reads_the_download(downloaded, monkeypatch):
    from merlot_tpu.downstream.sort_story.dataloader import story_batches as jax_story_batches
    from merlot_tpu.downstream.sort_story.zero_shot import run_zero_shot as jax_run_zero_shot
    d = downloaded["dir"]
    monkeypatch.chdir(d)
    assert cli.main([str(d / "zs.yaml"), "--device", "cpu"]) == {
        "path": "logits_val.npz", "stories": 3}
    jparams = jconv.convert_arrays(downloaded["arrays"],
                                   jconv.merlot_tf_name_map(JaxConfig(**ZS)), verbose=False)
    merged = {"num_chunks": 5, "image_size": list(ZS["image_size"])}
    h5_path = str(d / "jax.h5")
    assert jax_run_zero_shot({"params": jparams["merlot"]}, JaxConfig(**ZS),
                             jax_story_batches([downloaded["shard"]], merged, 2), h5_path,
                             batch_size=2, num_chunks=5) == 3
    import h5py
    with np.load(d / "logits_val.npz") as z, h5py.File(h5_path, "r") as h5:
        assert sorted({k.split("/")[0] for k in z.files}) == sorted(h5.keys())
        for sid in h5:
            for name in ("lang_viz_probs", "viz_viz_probs"):
                np.testing.assert_allclose(z[f"{sid}/{name}"], h5[sid][name][()], **PROBS_TOL)


# ----------------------------------------------------------------------
# the readers of a params-only checkpoint


@pytest.mark.parametrize("source", ["directory", "npz"])
def test_pretraining_warm_start_reads_a_converted_checkpoint(downloaded, source):
    ckpt = downloaded["dir"] / "out" / "checkpoints" / "ckpt_0"
    model = MerlotPretrainModel(MerlotConfig(**ZS))
    path = str(ckpt if source == "directory" else ckpt / "params.npz")
    assert len(checkpoint.warm_start(model, path, verbose=False)) == \
        len(downloaded["name_map"])
    want = checkpoint.load_params(str(ckpt))
    for n, p in model.named_parameters():
        assert np.array_equal(flax_layout(n, p.detach().numpy()), want[flax_path(n)]), n


def test_vcr_warm_start_reads_a_converted_checkpoint(downloaded):
    ckpt = str(downloaded["dir"] / "out" / "checkpoints" / "ckpt_0")
    from merlot_tpu_torch.nn.layers import init_params
    model = VCRModel(MerlotConfig(**dict(ZS, num_texts=4)))
    init_params(model, torch.Generator().manual_seed(0))
    heads = {n: p.detach().clone() for n, p in model.named_parameters()
             if not n.startswith("merlot.")}
    init = checkpoint.warm_start(model, ckpt, verbose=False)
    assert set(init) == set(downloaded["name_map"].values())
    for n, p in model.named_parameters():
        if n in heads:
            assert torch.equal(p, heads[n]), n


def test_server_ckpt_reads_a_converted_checkpoint(tmp_path, grover_params):
    name_map = conv.grover_tf_name_map(GROVER["num_hidden_layers"])
    moved = _noisy(grover_params, 4)
    checkpoint.save_params_checkpoint(str(tmp_path / "grover"), conv.convert_arrays(
        {tf: moved[ours] for tf, ours in name_map.items()}, name_map, verbose=False))
    den = tds.Denoiser(_grover_config(tmp_path), str(tmp_path / "grover" / "params.npz"),
                       device="cpu", batch_window_ms=0.0)
    model = tg.GroverLM(tg.GroverConfig(**GROVER))
    load_flax_params(model, moved)
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 50000, (2, 7)))
    with torch.no_grad():
        got, _ = den.model(ids)
        want, _ = model(ids)
    torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_load_checkpoint_refuses_a_params_only_checkpoint(downloaded):
    model = MerlotPretrainModel(MerlotConfig(**ZS))
    state = MerlotAdamW(AdamWConfig.from_config(OPT)).init(dict(model.named_parameters()))
    with pytest.raises(ValueError, match="parameters only"):
        checkpoint.load_checkpoint(str(downloaded["dir"] / "out" / "checkpoints" / "ckpt_0"),
                                   model, state)


def test_params_only_checkpoint_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="float32"):
        checkpoint.save_params_checkpoint(str(tmp_path / "c"), {"a": np.zeros(2, np.float16)})
    assert not (tmp_path / "c").exists()


# ----------------------------------------------------------------------
# (e): JAX's orbax checkpoints


def _orbax_save(path, tree):
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree)
    ckptr.wait_until_finished()
    return str(path)


@pytest.fixture(scope="module")
def jax_train_state(pair, tmp_path_factory):
    """One JAX train step of the tiny flagship pair (bf16 Adam, the yaml's
    optimizer), its state saved by JAX's CheckpointManager at step 1, and
    JAX's next step (its grads and metrics) from that checkpoint restored
    by orbax; JAX's grads from the restored weights moved by one ulp (each
    element times 1 +- 2^-23): JAX's own spread at this state. A step is
    make_train_step's (merlot_tpu/train/train_step.py: the masking key from
    fold_in(root, step); dropout is 0), its grads and update compiled
    apart."""
    d = tmp_path_factory.mktemp("orbax_train")
    cfg, batch, jm = pair["cfg"], pair["batch"], pair["jm"]
    jopt = JaxAdamW(JaxAdamWConfig.from_config(OPT))
    root = jax.random.PRNGKey(3)

    def loss_fn(p, key):
        loss, metrics, _ = jm.apply({"params": p}, batch, deterministic=False,
                                    rngs={"masking": key, "dropout": key})
        return loss, metrics

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    update = jax.jit(jopt.update)

    def step(params, state, step_no):
        k_mask, _ = jax.random.split(jax.random.fold_in(root, step_no))
        (loss, metrics), grads = grad_fn(params, k_mask)
        new_params, new_state, opt_metrics = update(grads, state, params)
        return new_params, new_state, dict(metrics, **opt_metrics, loss=loss), grads, k_mask

    params, state, _, _, _ = step(pair["variables"]["params"],
                                  jopt.init(pair["variables"]["params"]), 0)
    mgr = JaxCheckpointManager(str(d / "checkpoints"))
    mgr.save(1, {"params": params, "opt_state": state})
    restored = mgr.restore(1, {"params": params, "opt_state": state})
    _, _, metrics, grads, k_mask = step(restored["params"], restored["opt_state"], 1)
    rng = np.random.default_rng(0)
    nudged = jax.tree.map(lambda a: np.asarray(a) * (
        1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -23).astype(np.float32),
        restored["params"])
    draws = pretrain_masking_draws(jm, {"params": restored["params"]}, k_mask, cfg, batch)
    return dict(cfg=cfg, batch=batch, src=mgr.path(1), params=flat_params(params),
                moments={g: flat_params(state[g]) for g in ("m", "v")}, draws=draws,
                grads=flat_params(grads), nudged_grads=flat_params(grad_fn(nudged, k_mask)[1]),
                metrics=metrics, update=update, restored=restored)


@pytest.fixture(scope="module")
def imported_train_state(jax_train_state, tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("imported") / "ckpt_1")
    summary = imp.import_checkpoint(jax_train_state["src"], dst)
    return dst, summary


def test_import_train_state_without_orbax_or_jax(jax_train_state, tmp_path):
    """The importer's run in a fresh interpreter loads neither orbax nor
    jax nor the JAX package."""
    import subprocess
    import sys
    script = ("import sys\n"
              "from merlot_tpu_torch.tools import import_jax_checkpoint as imp\n"
              f"imp.main([{jax_train_state['src']!r}, {str(tmp_path / 'out')!r}])\n"
              "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'orbax', 'merlot_tpu', 'tensorflow'))\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert '"step": 1' in proc.stdout
    assert sorted(os.listdir(tmp_path / "out")) == ["meta.json", "opt_state.npz", "params.npz"]


def test_imported_moments_are_bit_for_bit_jax(jax_train_state, imported_train_state):
    dst, summary = imported_train_state
    r = jax_train_state
    assert summary == {"step": 1, "params": len(r["params"]), "m": len(r["params"]),
                       "v": len(r["params"])}
    model = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(r["cfg"])))
    state = init_train_state(model, MerlotAdamW(AdamWConfig.from_config(OPT)), seed=7)
    checkpoint.load_checkpoint(dst, model, state)
    assert state["step"] == 1
    for n, p in model.named_parameters():
        path = flax_path(n)
        assert np.array_equal(flax_layout(n, p.detach().numpy()), r["params"][path]), n
        for g in ("m", "v"):
            t = state[g][n]
            assert t.dtype == torch.bfloat16
            got = flax_layout(n, t.view(torch.int16).numpy()).view(np.uint16)
            assert np.array_equal(got, r["moments"][g][path].view(np.uint16)), (g, n)


def test_step_from_an_imported_state_matches_jax(jax_train_state, imported_train_state):
    """The step tests' bounds (tests/torch_port_helpers.py). The grads'
    are widened per tensor by JAX's own spread, how far one ulp of the
    weights moves JAX's grads: after JAX's first step the
    zero-initialised residual GroupNorm scales sit at +-lr, and the
    ResNet's grads are that sensitive (one ulp moves JAX's by up to
    2.4e-6 there, beyond the step tests' floor, 1e-6 of the largest grad:
    1.35e-6). The new weights and moments are held to the step tests'
    bounds against JAX's update of the same state by the port's grads,
    beside the loss and metrics against JAX's whole step."""
    dst, _ = imported_train_state
    r = jax_train_state
    model = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(r["cfg"])))
    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    state = init_train_state(model, opt, seed=7)
    checkpoint.load_checkpoint(dst, model, state)
    metrics = make_train_step(model, opt, device="cpu")(
        model, state, to_torch(r["batch"]), None, masking_draws=r["draws"])
    assert state["step"] == 2
    np.testing.assert_allclose(float(metrics["loss"]), float(r["metrics"]["loss"]), rtol=1e-5)
    for k in sorted(r["metrics"]):
        np.testing.assert_allclose(float(metrics[k]), float(r["metrics"][k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in r["grads"].values())
    grads = {}
    for name, p in model.named_parameters():
        path = flax_path(name)
        grads[path] = flax_layout(name, p.grad.numpy())
        spread = float(np.abs(r["nudged_grads"][path] - r["grads"][path]).max())
        close_to_scale(grads[path], r["grads"][path], 2e-4, name, atol=floor + spread)
    new_params, new_state, _ = r["update"](
        unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in grads.items()}),
        r["restored"]["opt_state"], r["restored"]["params"])
    check_step_params_and_state((model, state, metrics, grads, flat_params(new_params),
                                 {g: flat_params(new_state[g]) for g in ("m", "v")}, None))


@pytest.mark.parametrize("form", ["params_key", "bare"])
def test_params_only_tree_is_served_as_jax_serves_it(tmp_path, grover_params, form):
    params = unflatten_dict({tuple(k.split("/")): v
                             for k, v in _noisy(grover_params, 5).items()})
    src = _orbax_save(tmp_path / "orbax", {"params": params} if form == "params_key" else params)
    imp.import_checkpoint(src, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["meta.json", "params.npz"]
    cfg_path = _grover_config(tmp_path)
    jd = jds.Denoiser(cfg_path, src, batch_window_ms=0.0)
    td = tds.Denoiser(cfg_path, str(tmp_path / "port" / "params.npz"), device="cpu",
                      batch_window_ms=0.0)
    ids = np.random.default_rng(2).integers(1, 50000, (2, 11)).astype(np.int32)
    want, _ = jax.jit(lambda v, i: jd.model.apply(v, i))(jd.params, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = td.model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_pipeline_stages_tree_is_kept_and_unstacked_by_the_server(tmp_path, grover_params):
    flat = _noisy(grover_params, 6)
    stacked = jg.stack_grover_params(
        {"params": unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})}, 2)
    jopt = JaxAdamW(JaxAdamWConfig.from_config(OPT))
    src = _orbax_save(tmp_path / "orbax", {"params": stacked["params"],
                                           "opt_state": jopt.init(stacked["params"])})
    assert imp.import_checkpoint(src, str(tmp_path / "port"))["step"] == 0
    with np.load(tmp_path / "port" / "params.npz") as z:
        assert z["stages/query/kernel"].shape == (2, 1, 32, 32)
    with np.load(tmp_path / "port" / "opt_state.npz") as z:
        assert z["m/stages/query/kernel"].dtype == np.uint16
    got = tds.load_npz_params(str(tmp_path / "port" / "params.npz"),
                              GROVER["num_hidden_layers"])
    assert set(got) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(got[k], v), k


def test_scan_layout_tree_is_unstacked(tmp_path, pair):
    """The scan layout as JAX's ``stack_for_scan`` makes it (nn.scan's:
    ``.../layers/layer/<leaf>`` with a leading layer axis) for both
    encoders; the import gives the unrolled tree back exactly."""
    cfg = pair["cfg"]
    flat = flat_params(pair["variables"]["params"])
    tree = unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    jconv.stack_for_scan(tree, "merlot/encoder", cfg.num_hidden_layers)
    jconv.stack_for_scan(tree, "merlot/vision_backbone/encoder", cfg.vit_num_layers)
    assert tree["merlot"]["encoder"]["layers"]["layer"]["attention"]["query"]["kernel"].shape \
        == (cfg.num_hidden_layers, 64, 64)
    src = _orbax_save(tmp_path / "orbax", {"params": tree})
    imp.import_checkpoint(src, str(tmp_path / "port"))
    got = checkpoint.load_params(str(tmp_path / "port"))
    assert set(got) == set(flat) == _port_paths(pair["tm"])
    for path, leaf in flat.items():
        assert np.array_equal(got[path], leaf), path
    load_flax_params(MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg))), got)


@pytest.mark.parametrize("use_ocdbt", [True, False])
@pytest.mark.parametrize("use_zarr3", [True, False])
def test_every_orbax_store_layout_is_read(tmp_path, use_ocdbt, use_zarr3):
    params = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
              "b": {"bias": np.linspace(-1, 1, 5).astype(np.float32)}}
    moments = {"a": {"kernel": jnp.asarray(np.arange(6).reshape(2, 3) - 2.5, jnp.bfloat16)},
               "b": {"bias": -jnp.ones(5, jnp.bfloat16)}}
    tree = {"params": params, "opt_state": {"step": jnp.int32(9), "m": moments, "v": moments}}
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt, use_zarr3=use_zarr3)
    ocp.Checkpointer(handler).save(os.path.abspath(tmp_path / "orbax"),
                                   args=ocp.args.PyTreeSave(tree))
    imp.import_checkpoint(str(tmp_path / "orbax"), str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta == {"step": 9, "dtypes": {"params": "float32", "m": "bfloat16",
                                          "v": "bfloat16"}}
    got = checkpoint.load_params(str(tmp_path / "port"))
    assert np.array_equal(got["a/kernel"], params["a"]["kernel"])
    assert np.array_equal(got["b/bias"], params["b"]["bias"])
    with np.load(tmp_path / "port" / "opt_state.npz") as z:
        for g in ("m", "v"):
            assert np.array_equal(z[f"{g}/a/kernel"],
                                  np.asarray(moments["a"]["kernel"]).view(np.uint16))


UNKNOWN = {
    "optax_tuple_state": ({"params": {"w": np.ones(2, np.float32)},
                           "opt_state": [{"mu": np.ones(2, np.float32)}]},
                          "list or tuple"),
    "key_beside_params": ({"params": {"w": np.ones(2, np.float32)},
                           "rng": np.zeros(2, np.uint32)}, "beside params"),
    "other_optimizer": ({"params": {"w": np.ones(2, np.float32)},
                         "opt_state": {"count": np.int32(0), "mu": {"w": np.ones(2, np.float32)}}},
                        "MerlotAdamW"),
    "moments_not_mirroring": ({"params": {"w": np.ones(2, np.float32)},
                               "opt_state": {"step": np.int32(0),
                                             "m": {"w": np.ones(2, np.float32)},
                                             "v": {"u": np.ones(2, np.float32)}}},
                              "does not mirror"),
    "opt_state_alone": ({"opt_state": {"step": np.int32(0)}}, "without params"),
    "integer_params": ({"params": {"w": np.ones(2, np.int32)}}, "float32"),
}


@pytest.mark.parametrize("kind", sorted(UNKNOWN))
def test_unknown_tree_is_refused_and_nothing_written(tmp_path, kind):
    tree, message = UNKNOWN[kind]
    handler = ocp.PyTreeCheckpointHandler()
    ocp.Checkpointer(handler).save(os.path.abspath(tmp_path / "orbax"),
                                   args=ocp.args.PyTreeSave(tree))
    with pytest.raises(ValueError, match=message):
        imp.import_checkpoint(str(tmp_path / "orbax"), str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()
    assert sorted(os.listdir(tmp_path)) == ["orbax"]


def test_import_refuses_what_is_not_an_orbax_checkpoint(tmp_path):
    (tmp_path / "src").mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        imp.import_checkpoint(str(tmp_path / "src"), str(tmp_path / "port"))
    (tmp_path / "port").mkdir()
    with pytest.raises(FileExistsError):
        imp.import_checkpoint(str(tmp_path / "src"), str(tmp_path / "port"))
