"""The zero-shot story-ordering entry points, merlot_tpu_torch vs merlot_tpu.

Writers byte for byte (``story_example``, ``write_story_tfrecords`` from a
SIS json and images), the loader's batches bit for bit (eval and the
shuffled training order), the scorer's best permutations and metrics equal
on the same probs, the ``.npz`` and an ``.h5`` of the same arrays scored
identically, the download's command list, and the CLI end to end on the
CPU from a pretrain-rooted checkpoint of JAX weights: its probs within
1e-5 (absolute and relative, fp32, the zero-shot slice's tolerance) of
JAX's ``run_zero_shot`` on the same shard. JAX's own CLI is shown to fail
on such a checkpoint (ROADMAP Queue 3).
"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from merlot_tpu.downstream.sort_story import data as jdata
from merlot_tpu.downstream.sort_story import download as jdownload
from merlot_tpu.downstream.sort_story import get_zero_shot_logits as jcli
from merlot_tpu.downstream.sort_story import score_permutations as jscore
from merlot_tpu.downstream.sort_story.dataloader import story_batches as jax_story_batches
from merlot_tpu.downstream.sort_story.zero_shot import run_zero_shot as jax_run_zero_shot
from merlot_tpu.models.config import MerlotConfig as JaxConfig
from merlot_tpu.models.merlot import MerlotModel as JaxMerlot
from merlot_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.downstream.sort_story import data, download
from merlot_tpu_torch.downstream.sort_story import get_zero_shot_logits as cli
from merlot_tpu_torch.downstream.sort_story import score_permutations as score
from merlot_tpu_torch.downstream.sort_story.dataloader import story_batches
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train.checkpoint import CheckpointManager
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW

N, BATCH, DUP = 5, 2, 2
# tests/test_downstream.py TINY_STORY_CFG
TINY = dict(hidden_size=64, vocab_size=50370, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, image_size=(32, 64),
            patch_size=16, spatial_pool_size=2, use_bfloat16=False,
            num_vision_transformer_hidden_layers=2,
            num_lang_transformer_hidden_layers=2, num_chunks_in_group=5,
            hidden_dropout_prob=0.0)
PROBS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny ops: more intra-op threads only contend with the other test
    processes. Results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path):
    from merlot_tpu_torch.data.tfrecord import read_tfrecords
    return list(read_tfrecords(str(path)))


# ----------------------------------------------------------------------
# writers


@pytest.mark.parametrize("perm", [(0, 1, 2, 3, 4), (4, 2, 0, 3, 1), (1, 0, 2, 4, 3)])
def test_story_example_bytes_match_jax(perm):
    rng = np.random.default_rng(sum(perm))
    texts = [list(rng.integers(100, 50357, int(rng.integers(1, 40)))) for _ in range(5)]
    jpegs = [bytes(rng.integers(0, 256, int(rng.integers(10, 200)), dtype=np.uint8))
             for _ in range(5)]
    assert data.story_example(12345, texts, jpegs, perm) == \
        jdata.story_example(12345, texts, jpegs, perm)


def _sis(tmp_path, num_stories=3):
    """A SIS json (annotations in shuffled order) and PNG photos."""
    from PIL import Image
    rng = np.random.default_rng(7)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    anns = []
    for s in range(num_stories):
        for order in rng.permutation(5):
            fid = f"{1000 + 10 * s + order}"
            Image.fromarray(rng.integers(0, 256, (50 + 7 * order, 90, 3), dtype=np.uint8)
                            ).save(img_dir / f"{fid}.png")
            anns.append([{"story_id": str(40 + s), "worker_arranged_photo_order": int(order),
                          "photo_flickr_id": fid,
                          "original_text": f"story {s} sentence {order}, the end."}])
    path = tmp_path / "sis.json"
    path.write_text(json.dumps({"annotations": anns}))
    return str(path), str(img_dir)


@pytest.mark.parametrize("kw", [dict(just_one_perm=False),
                                dict(just_one_perm=True, pad_to_batch_size=4),
                                dict(fold=1, num_folds=2, pad_to_batch_size=7)],
                         ids=["all_perms", "one_perm_padded", "fold"])
def test_write_story_tfrecords_bytes_match_jax(tmp_path, kw):
    sis, images = _sis(tmp_path)
    n = data.write_story_tfrecords(sis, images, str(tmp_path / "port.tfrecord"), **kw)
    n_jax = jdata.write_story_tfrecords(sis, images, str(tmp_path / "jax.tfrecord"), **kw)
    assert n == n_jax
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()
    if "pad_to_batch_size" in kw:
        assert n % kw["pad_to_batch_size"] == 0


def test_cli_main_writes_the_writers_shard(tmp_path):
    sis, images = _sis(tmp_path, num_stories=2)
    data.main(["--story_json", sis, "--image_dir", images, "--out",
               str(tmp_path / "cli.tfrecord"), "--just_one_perm", "--pad_to_batch_size", "3"])
    jdata.write_story_tfrecords(sis, images, str(tmp_path / "jax.tfrecord"),
                                just_one_perm=True, pad_to_batch_size=3)
    assert (tmp_path / "cli.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()


def test_synthetic_story_shard_matches_jax(tmp_path):
    """The JAX writer's draws; its bytes where the JPEG route is libjpeg (as
    here: the route encodes PIL's bytes), else equal but for the frames.
    Padding repeats the last Example."""
    from merlot_tpu_torch.data import _native
    from merlot_tpu_torch.data.tfrecord import parse_example
    n = data.write_synthetic_story_shard(str(tmp_path / "p.tfrecord"), num_stories=2,
                                         just_one_perm=False, seed=3, img_hw=(24, 40),
                                         pad_to_batch_size=7)
    jdata.write_synthetic_story_shard(str(tmp_path / "j.tfrecord"), num_stories=2,
                                      just_one_perm=False, seed=3, img_hw=(24, 40))
    got, want = _records(tmp_path / "p.tfrecord"), _records(tmp_path / "j.tfrecord")
    assert n == len(got) == 245 and len(want) == 240
    assert all(g == got[239] for g in got[240:])
    if _native.jpeg_route() == "libjpeg":
        assert got[:240] == want
    for g, w in zip(got, want):
        g, w = parse_example(g), parse_example(w)
        assert set(g) == set(w)
        assert all(np.array_equal(g[k], w[k]) for k in g
                   if not k.endswith(("_encoded", "_sha256")))


# ----------------------------------------------------------------------
# loader


@pytest.fixture(scope="module")
def story_shard(tmp_path_factory):
    d = tmp_path_factory.mktemp("stories")
    path = str(d / "stories.tfrecord")
    jdata.write_synthetic_story_shard(path, num_stories=12, just_one_perm=True,
                                      img_hw=(40, 56), seed=0)
    return path


@pytest.mark.parametrize("kw", [dict(), dict(is_training=True, seed=0),
                                dict(is_training=True, seed=3)],
                         ids=["eval", "train_seed0", "train_seed3"])
def test_story_batches_match_jax(story_shard, kw):
    config = {"image_size": [32, 64], "num_chunks": 5, "shuffle_buffer_size": 4}
    got = list(story_batches([story_shard], config, 3, **kw))
    want = list(jax_story_batches([story_shard], config, 3, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    if kw:
        assert [int(s) for b in got for s in b["story_id"]] != list(range(12))


# ----------------------------------------------------------------------
# scorer


def _random_probs(rng, n_stories):
    p = rng.dirichlet(np.ones(3), (n_stories, N, N)).astype(np.float32)
    return [p[i] for i in range(n_stories)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_matches_jax(seed):
    probs = _random_probs(np.random.default_rng(seed), 6)
    got = [score.best_permutation(p) for p in probs]
    assert got == [jscore.best_permutation(p) for p in probs]
    assert score.evaluate_stories(got) == jscore.evaluate_stories(got)
    for story in got + [(0, 1, 2, 3, 4), (4, 3, 2, 1, 0)]:
        assert score.spearman_acc(story) == jscore.spearman_acc(story)
        assert score.absolute_distance(story) == jscore.absolute_distance(story)
        assert score.pairwise_acc(story) == jscore.pairwise_acc(story)


def test_npz_and_h5_scored_identically(tmp_path):
    """The port's .npz and an .h5 of the same arrays: the port's scorer on
    either equals JAX's score_h5 on the .h5, for both modalities; the
    story ids are out of order and of several digits (int order, not
    string order)."""
    rng = np.random.default_rng(4)
    sids = [11, 2, 100, 7]
    arrays = {}
    for sid in sids:
        arrays[f"{sid}/permutation_identity_encode"] = np.int64(901234)
        arrays[f"{sid}/sentences"] = rng.integers(0, 50000, (N, 32)).astype(np.int32)
        for name in ("lang_viz", "viz_viz"):
            arrays[f"{sid}/{name}_probs"] = _random_probs(rng, 1)[0]
    np.savez(tmp_path / "l.npz", **arrays)
    with h5py.File(tmp_path / "l.h5", "w") as h5:
        for key, value in arrays.items():
            h5.create_dataset(key, data=value)
    for modality in ("lang_viz", "viz_viz"):
        want = jscore.score_h5(str(tmp_path / "l.h5"), modality)
        assert score.score_file(str(tmp_path / "l.npz"), modality) == want
        assert score.score_file(str(tmp_path / "l.h5"), modality) == want
        loaded = score.load_probs(str(tmp_path / "l.npz"), modality)
        for p, sid in zip(loaded, sorted(sids)):
            assert np.array_equal(p, arrays[f"{sid}/{modality}_probs"])


def test_baseline_tsv_parses_as_pandas_does(tmp_path):
    import pandas as pd
    path = tmp_path / "base.tsv"
    path.write_text("0,1,2,3,4\n4,3,2,1,0\n\n2,0,1,4,3\n")
    want = (pd.read_csv(path, delimiter="\t", names=["story"])["story"]
            .apply(lambda x: [int(y) for y in x.split(",")]).tolist())
    assert score.read_baseline_tsv(str(path)) == want


def test_scorer_main_prints_metrics(tmp_path, capsys):
    arrays = {f"{sid}/lang_viz_probs": p for sid, p in
              enumerate(_random_probs(np.random.default_rng(5), 3))}
    np.savez(tmp_path / "l.npz", **arrays)
    (tmp_path / "b.tsv").write_text("0,1,2,3,4\n")
    metrics = score.main([str(tmp_path / "l.npz"), "--baseline_tsv", str(tmp_path / "b.tsv")])
    out = capsys.readouterr().out
    assert f"spearman: {metrics['spearman']:.4f}" in out
    assert "baseline:\n  spearman: 1.0000" in out


# ----------------------------------------------------------------------
# download


@pytest.mark.parametrize("present", [(), ("SIS-with-labels.tar.gz", "sis", "val_images.tar.gz")],
                         ids=["fresh", "partly_present"])
def test_download_runs_jaxs_commands(tmp_path, monkeypatch, present):
    calls = {}
    for name, mod in (("port", download), ("jax", jdownload)):
        d = tmp_path / name
        d.mkdir()
        for p in present:
            (d / p).write_text("")
        seen = calls.setdefault(name, [])
        monkeypatch.setattr(mod.subprocess, "run",
                            lambda cmd, check, _seen=seen, _d=str(d): _seen.append(
                                [c.replace(_d, "D") for c in cmd]))
        mod.main(["--working_dir", str(d)])
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == (6 if not present else 3)


# ----------------------------------------------------------------------
# the CLI from a checkpoint


def _init_all(mdl, imgs, sents, sidx):
    """Touch every parameter, so that the tree fills the port's model."""
    fwd = mdl(imgs, sents, mask_input=False, shuffled_idx_img=sidx, deterministic=True)
    mdl.embed_words(sents.reshape(sents.shape[0], -1), which="langonly")
    mdl.contrastive_features(fwd["img_trg_h"], fwd["img_trg_h"])
    x = fwd["encoder_hidden_states"]["viz"][:, :N]
    mdl.temporal_logits(x, x, which="lang_viz")
    mdl.temporal_logits(x, x, which="viz_viz")
    return 0


CLI_YAML = """\
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


def _model_yaml():
    lines = []
    for k, v in TINY.items():
        v = list(v) if isinstance(v, tuple) else v
        lines.append(f"  {k}: {json.dumps(v)}")
    return "\n".join(lines)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """JAX weights for TINY; a shard of 3 stories padded to the batch (4
    Examples); a pretrain-rooted port checkpoint of the weights under
    ``port/``, the same tree in orbax under ``jax/``."""
    d = tmp_path_factory.mktemp("cli")
    shard = str(d / "val.tfrecord")
    assert data.write_synthetic_story_shard(shard, num_stories=3, img_hw=(40, 72),
                                            seed=1, pad_to_batch_size=BATCH) == 4
    jcfg = JaxConfig(**TINY)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 1, (BATCH * DUP * N, 32, 64, 3)), jnp.float32)
    sents = jnp.asarray(rng.integers(100, 50357, (BATCH * DUP, N, 32)), jnp.int32)
    sidx = jnp.tile(jnp.arange(N, dtype=jnp.int32) + 64, (BATCH * DUP, 1))
    variables = jax.jit(lambda k: JaxMerlot(jcfg).init(
        k, imgs, sents, sidx, method=_init_all))(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}

    model = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(jcfg)))
    load_flax_params(model, {f"merlot/{k}": v for k, v in flat.items()})
    opt = MerlotAdamW(AdamWConfig(learning_rate=1e-4, num_train_steps=1))
    params = dict(model.named_parameters())
    CheckpointManager(str(d / "port" / "checkpoints")).save(3, params, opt.init(params))
    for name in ("port", "jax"):
        (d / f"{name}.yaml").write_text(CLI_YAML.format(shard=shard, model=_model_yaml(),
                                                        out=d / name))
    return dict(dir=d, shard=shard, jcfg=jcfg, variables=variables)


def test_cli_matches_jax_run_zero_shot(cli_run, monkeypatch):
    r = cli_run
    monkeypatch.chdir(r["dir"])
    got = cli.main([str(r["dir"] / "port.yaml"), "--device", "cpu"])
    assert got == {"path": "logits_val.npz", "stories": 3}

    merged = {"num_chunks": N, "image_size": list(TINY["image_size"])}
    h5_path = str(r["dir"] / "jax.h5")
    assert jax_run_zero_shot({"params": r["variables"]["params"]}, r["jcfg"],
                             jax_story_batches([r["shard"]], merged, BATCH), h5_path,
                             batch_size=BATCH, num_chunks=N) == 3
    with np.load(r["dir"] / "logits_val.npz") as z, h5py.File(h5_path, "r") as h5:
        assert sorted({k.split("/")[0] for k in z.files}) == sorted(h5.keys()) == ["0", "1", "2"]
        for sid in h5:
            for name in ("lang_viz_probs", "viz_viz_probs"):
                np.testing.assert_allclose(z[f"{sid}/{name}"], h5[sid][name][()], **PROBS_TOL)
            assert np.array_equal(z[f"{sid}/sentences"], h5[sid]["sentences"][()])
            assert int(z[f"{sid}/permutation_identity_encode"]) == \
                int(h5[sid]["permutation_identity_encode"][()]) == 901234
        assert np.all(np.isfinite(z["2/lang_viz_probs"]))
    score.score_file(str(r["dir"] / "logits_val.npz"))


def test_jax_cli_fails_on_a_pretrain_rooted_checkpoint(cli_run, monkeypatch):
    """JAX's CLI applies the checkpoint's tree to a bare MerlotModel: with a
    pretrain checkpoint's ``merlot/`` root it finds no parameter, with a
    bare model's tree it runs. The port's CLI takes the subtree."""
    r = cli_run
    monkeypatch.chdir(r["dir"])
    ckpt = JaxCheckpointManager(str(r["dir"] / "jax" / "checkpoints"))
    ckpt.save(1, {"params": {"merlot": r["variables"]["params"]}})
    monkeypatch.setattr("sys.argv", ["get_zero_shot_logits", str(r["dir"] / "jax.yaml")])
    with pytest.raises(Exception, match="Could not find parameter"):
        jcli.main()
    ckpt.save(2, {"params": r["variables"]["params"]})
    jcli.main()
    with h5py.File(r["dir"] / "logits_val.h5", "r") as h5:
        assert sorted(h5.keys()) == ["0", "1", "2"]


def test_merlot_subtree_takes_the_pretrain_root():
    leaf = np.zeros(1)
    assert cli.merlot_subtree({"merlot/a/b": leaf, "merlot/c": leaf}) == {"a/b": leaf, "c": leaf}
    assert cli.merlot_subtree({"a/b": leaf}) == {"a/b": leaf}
    assert cli.merlot_subtree({"merlot/a": leaf, "answer_cls/b": leaf}) == \
        {"merlot/a": leaf, "answer_cls/b": leaf}


def test_cli_refuses_a_group_that_is_not_the_story(cli_run, tmp_path):
    text = (cli_run["dir"] / "port.yaml").read_text().replace("num_chunks: 5", "num_chunks: 30")
    (tmp_path / "c.yaml").write_text(text)
    with pytest.raises(ValueError, match="num_chunks"):
        cli.main([str(tmp_path / "c.yaml"), "--device", "cpu"])


def test_cli_runs_on_cuda_unless_asked(cli_run):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(cli_run["dir"] / "port.yaml")])
