"""merlot_tpu_torch.parallel: data parallelism and ZeRO-1 on torch.distributed,
held against one process and against merlot_tpu.parallel.mesh.

  * the ZeRO-1 layout: for every leaf of the tiny pretrain model, the VCR
    model and grover-tiny, the port's ``zero1_partition_spec`` and its axis
    in the port's layout are JAX's at data sizes 1, 2, 3, 4 and 8;
  * world size 1: the global losses through a mesh equal today's functions
    (a one-rank gloo group in this process);
  * two gloo ranks (this file run as a script, twice, each with a time
    limit and a free port) against one process on the concatenated batch:
    a DP pretrain step and two ZeRO-1 steps (loss, metrics, parameters, the
    gathered moments within 1e-5 of each tensor's scale), each rank's moment
    bytes, ZeRO-1 checkpoints crossing world sizes 2 -> 1 and 1 -> 2 and the
    resumed steps, a VCR ZeRO-1 step, zero-shot (bit for bit; a row split
    would change the output) and the VCR sidecar; and the 2-rank ZeRO-1
    step against JAX's ``make_train_step(mesh=make_mesh(data=2), zero1=True)``
    on JAX's masking draws, within test_torch_train_step.py's tolerances;
  * ``tools/multiprocess_smoke.py --num-procs 2 --device cpu``.

The fp32 tiny configs run with dropout 0: with it, a world-N step draws its
dropout masks per rank, a one-process step from one generator."""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from merlot_tpu_torch.convert import flax_layout, flax_path, load_flax_params  # noqa: E402
from merlot_tpu_torch.models.config import MerlotConfig  # noqa: E402
from merlot_tpu_torch.models.merlot import MerlotModel  # noqa: E402
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel  # noqa: E402
from merlot_tpu_torch.nn.layers import init_params  # noqa: E402
from merlot_tpu_torch.parallel import mesh as pm  # noqa: E402
from merlot_tpu_torch.tools.multiprocess_smoke import tiny_config  # noqa: E402
from merlot_tpu_torch.train.checkpoint import load_params  # noqa: E402
from merlot_tpu_torch.train.harness import Trainer  # noqa: E402
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW, decode_v  # noqa: E402
from merlot_tpu_torch.train.train_step import make_loss_train_step  # noqa: E402

WORLD = 2
TIMEOUT_S = 120
RTOL = 1e-5
# AdamW with the features ZeRO-1 must keep: the global-norm clip,
# per-parameter weight decay, a frozen parameter (lr 0) and the per-scope
# grad norms. fp32 moments: a bf16 moment takes the rounding noise of the
# ranks' sums as a whole bf16 step now and then (the JAX twin below runs
# bf16 moments, with test_torch_train_step.py's bounds for them)
OPT = dict(learning_rate=1e-3, num_train_steps=10, num_warmup_steps=0,
           weight_decay_rate=0.1, clip_norm=1.0, use_bfloat16_adam=False, verbose=True,
           param_overrides=((("bias", "gamma", "beta", "/ln"), {"weight_decay_rate": 0.0}),
                            (("word_embeddings",), {"learning_rate": 0.0})))
STEPS = 3
GLOBAL_EXAMPLES = 4
# tests/test_torch_vcr.py's and tests/test_torch_sort_story.py's tiny models
VCR_TINY = dict(hidden_size=64, vocab_size=50370, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128, image_size=(32, 64),
                patch_size=16, spatial_pool_size=2, use_bfloat16=False,
                num_vision_transformer_hidden_layers=2,
                num_lang_transformer_hidden_layers=2, hidden_dropout_prob=0.0,
                num_texts=4, max_position_embeddings=256)
VCR_CONFIG = {"image_size": [32, 64], "draw": "segm", "shuffle_buffer_size": 4}
STORY_TINY = dict(VCR_TINY, num_texts=1, num_chunks_in_group=5,
                  max_position_embeddings=512)
STORY_CONFIG = {"num_chunks": 5, "image_size": [32, 64]}
GROVER_TINY = dict(vocab_size=503, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, max_position_embeddings=64)


# one intra-op thread in this process and the ones it starts: the ops are
# tiny, and more threads only contend with the other test processes
# (results do not depend on the thread count)
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# inputs, made from numpy seeds, the same in every process

def pretrain_batches():
    """STEPS global batches of the tiny smoke model: 4 examples x 2 chunks
    x 8 tokens with padded tails, 32x32 frames."""
    out = []
    for s in range(STEPS):
        rng = np.random.default_rng(100 + s)
        ids = rng.integers(100, 50357, (GLOBAL_EXAMPLES, 2, 8)).astype(np.int32)
        for b in range(GLOBAL_EXAMPLES):
            for c in range(2):
                ids[b, c, rng.integers(3, 9):] = 0
        out.append({
            "images": rng.uniform(0, 1, (GLOBAL_EXAMPLES * 2, 32, 32, 3)).astype(np.float32),
            "input_ids": ids,
            "shuffled_idx_img": np.tile(np.array([0, 1], np.int32), GLOBAL_EXAMPLES),
            "video_src_ids": np.repeat(np.arange(GLOBAL_EXAMPLES, dtype=np.int32),
                                       2).reshape(GLOBAL_EXAMPLES, 2)})
    return out


def vcr_batch():
    rng = np.random.default_rng(7)
    ids = rng.integers(100, 50357, (2 * 8, 184)).astype(np.int32)
    for row in ids:
        row[rng.integers(12, 60):] = 0
    return {"images": rng.uniform(0, 1, (2 * 2, 32, 64, 3)).astype(np.float32),
            "lm_input": ids, "lm_targets": rng.integers(0, 4, 2 * 2).astype(np.int32)}


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def seeded(model):
    init_params(model, torch.Generator().manual_seed(0))
    return model


def pretrain_trainer(out, mesh=None, zero1=False):
    model = seeded(MerlotPretrainModel(tiny_config()))
    return Trainer(model, MerlotAdamW(AdamWConfig(**OPT)), output_dir=str(out), log_every=1,
                   checkpoint_every=1, device="cpu", mesh=mesh, zero1=zero1)


def rows(batch, mesh):
    return torch_batch(pm.shard_batch(batch, mesh)) if mesh is not None else torch_batch(batch)


def vcr_step(mesh=None, zero1=False):
    """One VCR step of the seeded tiny model: (loss, metrics, the
    parameters by flax path)."""
    from merlot_tpu_torch.downstream.vcr.modeling import VCRModel, vcr_loss_and_metrics
    model = seeded(VCRModel(MerlotConfig(**VCR_TINY)))
    opt = MerlotAdamW(AdamWConfig(learning_rate=1e-3, num_train_steps=10, num_warmup_steps=0))
    params = dict(model.named_parameters())
    state = opt.init(params, mesh if zero1 else None)

    def loss_fn(m, b, g):
        logits = m(b["images"], b["lm_input"], deterministic=False, generator=g)
        return vcr_loss_and_metrics(logits, b["lm_targets"], mesh)

    step = make_loss_train_step(loss_fn, opt, device="cpu", mesh=mesh, zero1=zero1)
    metrics = step(model, state, rows(vcr_batch(), mesh), torch.Generator().manual_seed(5))
    return ({k: float(v) for k, v in metrics.items()},
            {flax_path(n): p.detach().numpy().copy() for n, p in params.items()})


def zero_shot(out_path, files, batch_size, mesh=None):
    from merlot_tpu_torch.downstream.sort_story.dataloader import story_batches
    from merlot_tpu_torch.downstream.sort_story.zero_shot import run_zero_shot
    model = seeded(MerlotModel(MerlotConfig(**STORY_TINY).eval_mode())).eval()
    return run_zero_shot(model, story_batches(files, STORY_CONFIG, batch_size), str(out_path),
                         batch_size=batch_size, num_chunks=5, mesh=mesh)


def vcr_validate(pred_path, files, mesh=None):
    from merlot_tpu_torch.downstream.vcr import validate
    from merlot_tpu_torch.downstream.vcr.modeling import VCRModel
    model = seeded(VCRModel(MerlotConfig(**VCR_TINY).eval_mode())).eval()
    return validate.evaluate_checkpoint(model, files, VCR_CONFIG, 2, "answer",
                                        predictions_path=str(pred_path), mesh=mesh)


def moment_bytes(state):
    return sum(t.numel() * t.element_size() for g in ("m", "v") for t in state[g].values())


# ----------------------------------------------------------------------
# the rank: this file run as a script

def _jax_step_rank(d, mesh):
    """The port's ZeRO-1 step on JAX's weights and masking draws."""
    from merlot_tpu_torch.train.train_step import make_train_step
    spec = json.loads((d / "jax_cfg.json").read_text())
    cfg = MerlotConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec.items()})
    model = MerlotPretrainModel(cfg)
    with np.load(d / "jax_params.npz") as z:
        load_flax_params(model, {k: z[k] for k in z.files})
    opt_cfg = json.loads((d / "jax_opt.json").read_text())
    opt = MerlotAdamW(AdamWConfig.from_config(opt_cfg))
    params = dict(model.named_parameters())
    state = opt.init(params, mesh)
    with np.load(d / "jax_batch.npz") as z:
        batch = {k: z[k] for k in z.files}
    with np.load(d / "jax_draws.npz") as z:
        draws = {k: z[k] for k in z.files}
    rows_ = draws["gumbel"].shape[0] // mesh.data
    mine = {}
    for k, v in draws.items():
        per = v.shape[0] // (rows_ * mesh.data)
        mine[k] = torch.from_numpy(v[mesh.rank * rows_ * per:(mesh.rank + 1) * rows_ * per])
    step = make_train_step(model, opt, device="cpu", mesh=mesh, zero1=True)
    metrics = step(model, state, rows(batch, mesh), None, masking_draws=mine)
    whole = opt.full_state(state, params, mesh)
    if mesh.rank == 0:
        np.savez(d / "jax_port_out.npz",
                 **{f"param/{n}": p.detach().numpy() for n, p in params.items()},
                 **{f"grad/{n}": (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                    for n, p in params.items()},
                 **{f"{g}/{n}": whole[g][n].view(torch.int16).numpy()
                    for g in ("m", "v") for n in params})
        (d / "jax_port_metrics.json").write_text(
            json.dumps({k: float(v) for k, v in metrics.items()}))


def _rank_main(rank: int, port: int, d: Path, ports) -> None:
    torch.set_num_threads(1)
    pm.init_multihost(init_method=f"tcp://127.0.0.1:{port}", world_size=WORLD, rank=rank,
                      device="cpu")
    mesh = pm.make_mesh()
    batches = pretrain_batches()
    # (a) one DP step; two ZeRO-1 steps, checkpointed (gathered) at each
    t = pretrain_trainer(d / "dp", mesh)
    t.run(t.init_state(), (rows(b, mesh) for b in batches), num_steps=1)
    t = pretrain_trainer(d / "z1", mesh, zero1=True)
    state = t.run(t.init_state(), (rows(b, mesh) for b in batches), num_steps=2)
    # (b) this rank's moment bytes
    params = dict(t.model.named_parameters())
    axes = t.optimizer.zero1_axes(params, mesh)
    (d / f"bytes_{rank}.json").write_text(json.dumps({
        "state": moment_bytes(state),
        "expected": sum(2 * 4 * (p.numel() // WORLD if n in axes else p.numel())
                        for n, p in params.items()),
        "whole": sum(2 * 4 * p.numel() for p in params.values()),
        "sharded": len(axes)}))
    # (c) the one-process run's step-2 checkpoint resumed at world 2, ZeRO-1
    t = pretrain_trainer(d / "resume_w2", mesh, zero1=True)
    state = t.init_state()
    assert state["step"] == 2
    t.run(state, (rows(b, mesh) for b in batches[2:]), num_steps=STEPS)
    # (d) a VCR step, ZeRO-1
    metrics, params = vcr_step(mesh, zero1=True)
    if rank == 0:
        np.savez(d / "vcr_params.npz", **params)
        (d / "vcr_metrics.json").write_text(json.dumps(metrics))
    # (e) zero-shot, whole batches over the ranks; the VCR sidecar
    stories = json.loads((d / "story_files.json").read_text())
    n = zero_shot(d / "zs_w2.npz", stories, 2, mesh)
    acc = vcr_validate(d / "pred_w2.jsonl", json.loads((d / "vcr_files.json").read_text()),
                       mesh)
    if rank == 0:
        (d / "eval_w2.json").write_text(json.dumps({"stories": n, "accuracy": acc}))
    # evaluate over the ranks: each rank's rows of the global batches
    t = pretrain_trainer(d / "eval_w2", mesh)
    t.init_state()
    means = t.evaluate(rows(b, mesh) for b in batches[:2])
    if rank == 0:
        (d / "eval_means_w2.json").write_text(json.dumps(means))
    # against JAX: the ZeRO-1 step on JAX's weights and draws
    _jax_step_rank(d, mesh)
    pm.leave(mesh)
    # the CLIs as torchrun starts them, use_zero1 on: each joins a group
    # of its own from the environment
    from merlot_tpu_torch.downstream.vcr import train as vcr_train
    from merlot_tpu_torch.train import pretrain
    for main, name, cli_port in ((pretrain.main, "cli_pretrain", ports[0]),
                                 (vcr_train.main, "cli_vcr", ports[1])):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(cli_port))
        main([str(d / f"{name}_w2.yaml"), "--device", "cpu"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(d: Path):
    ports = [str(_free_port()) for _ in range(3)]
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = []
    for r in range(WORLD):
        with open(d / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(r), ports[0], str(d),
                 *ports[1:]], env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, d: Path):
    """Wait for the ranks, each within TIMEOUT_S; a rank that fails or
    hangs (then all are killed) fails the run with its output."""
    for p in procs:
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} exited {p.returncode}:\n{(d / f'rank{r}.log').read_text()[-4000:]}"


# ----------------------------------------------------------------------
# the JAX twin of the 2-rank ZeRO-1 step

def _jax_inputs(d: Path):
    """JAX's tiny flagship model, batch and masking draws written for the
    ranks; returns what the JAX ZeRO-1 step gives."""
    import jax

    from merlot_tpu.parallel.mesh import (make_mesh, shard_batch, shard_opt_state,
                                          shard_params)
    from merlot_tpu.train.optimizer import AdamWConfig as JaxConfig
    from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
    from merlot_tpu.train.train_step import make_train_step as jax_make_train_step
    from merlot_tpu.models.config import MerlotConfig as JaxMerlotConfig
    from torch_port_helpers import (OPT as STEP_OPT, build_pair, flat_params,
                                    pretrain_masking_draws)

    cfg = JaxMerlotConfig(**dataclasses.asdict(tiny_config()))
    batch = {k: jax.numpy.asarray(v) for k, v in pretrain_batches()[0].items()}
    jm, variables, _ = build_pair(cfg, batch)
    root = jax.random.PRNGKey(3)
    k_mask, _ = jax.random.split(jax.random.fold_in(root, 0))
    draws = pretrain_masking_draws(jm, variables, k_mask, cfg, batch)
    (d / "jax_cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    (d / "jax_opt.json").write_text(json.dumps(STEP_OPT))
    np.savez(d / "jax_params.npz", **flat_params(variables["params"]))
    np.savez(d / "jax_batch.npz", **{k: np.asarray(v) for k, v in batch.items()})
    np.savez(d / "jax_draws.npz", **{k: v.numpy() for k, v in draws.items()})

    def compute():
        def loss_fn(p):
            return jm.apply({"params": p}, batch, deterministic=False,
                            rngs={"masking": k_mask, "dropout": k_mask})[0]
        jgrads = jax.jit(jax.grad(loss_fn))(variables["params"])
        mesh = make_mesh(data=2, devices=jax.devices()[:2])
        jopt = JaxAdamW(JaxConfig.from_config(STEP_OPT))
        with mesh:
            params = shard_params(variables["params"], mesh)
            state = shard_opt_state(jopt.init(params), mesh)
            step = jax_make_train_step(jm, jopt, donate=False, mesh=mesh, zero1=True)
            new_params, new_state, jmetrics = step(params, state, shard_batch(batch, mesh),
                                                   root)
        return (flat_params(jgrads), flat_params(new_params),
                {k: flat_params(new_state[k]) for k in ("m", "v")},
                {k: float(v) for k, v in jmetrics.items()})
    return compute


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the 2-rank job and its one-process references write."""
    d = tmp_path_factory.mktemp("parallel")
    batches = pretrain_batches()
    # the one-process reference, checkpointed at every step
    ref = pretrain_trainer(d / "ref")
    ref.run(ref.init_state(), (torch_batch(b) for b in batches), num_steps=STEPS)
    shutil.copytree(d / "ref" / "checkpoints" / "ckpt_2",
                    d / "resume_w2" / "checkpoints" / "ckpt_2")
    from merlot_tpu_torch.downstream.sort_story.data import write_synthetic_story_shard
    story = str(d / "stories.tfrecord")
    write_synthetic_story_shard(story, num_stories=4, img_hw=(40, 56), seed=0)
    (d / "story_files.json").write_text(json.dumps([story]))
    from tests.test_downstream import _write_synthetic_vcr_shard
    (d / "vcr_shards").mkdir()
    vcr = [str(d / "vcr_shards" / f"train-{i}.tfrecord") for i in range(2)]
    _write_synthetic_vcr_shard(vcr[0], n=5, img_hw=(40, 60), seed=0)
    _write_synthetic_vcr_shard(vcr[1], n=4, img_hw=(50, 44), seed=1)
    (d / "vcr_files.json").write_text(json.dumps(vcr))
    jax_compute = _jax_inputs(d)
    _cli_configs(d, vcr)

    procs = _launch(d)
    try:  # the one-process references and JAX while the ranks run
        out = {"dir": d, "jax": jax_compute(), "vcr_ref": vcr_step(),
               "zs_n": zero_shot(d / "zs_w1.npz", [story], 2),
               "zs_rows_n": zero_shot(d / "zs_rows.npz", [story], 1),
               "acc_w1": vcr_validate(d / "pred_w1.jsonl", vcr),
               "eval_means_w1": _eval_w1(d, batches)}
        from merlot_tpu_torch.downstream.vcr import train as vcr_train
        vcr_train.main([str(d / "cli_vcr_w1.yaml"), "--device", "cpu"])
    finally:
        _wait(procs, d)
    # the world-2 ZeRO-1 checkpoint at step 2 resumed by one process
    shutil.copytree(d / "z1" / "checkpoints" / "ckpt_2",
                    d / "resume_w1" / "checkpoints" / "ckpt_2")
    t = pretrain_trainer(d / "resume_w1")
    state = t.init_state()
    assert state["step"] == 2
    t.run(state, (torch_batch(b) for b in batches[2:]), num_steps=STEPS)
    # the pretraining CLI's world-2 ZeRO-1 checkpoint resumed by the CLI in
    # one process
    from merlot_tpu_torch.train import pretrain
    shutil.copytree(d / "cli_pretrain_w2" / "checkpoints" / "ckpt_2",
                    d / "cli_pretrain_w1" / "checkpoints" / "ckpt_2")
    out["cli_resumed"] = pretrain.main([str(d / "cli_pretrain_w1.yaml"), "--device", "cpu"])
    return out


def _eval_w1(d, batches):
    t = pretrain_trainer(d / "eval_w1")
    t.init_state()
    return t.evaluate(torch_batch(b) for b in batches[:2])


def _cli_configs(d: Path, vcr_files) -> None:
    """The pretraining CLI's tiny YAML (tests/test_torch_harness.py's) on two
    train shards, and VCR's (tests/test_torch_vcr.py's, warm started from a
    seeded pretrain checkpoint; dropout 0, fp32 compute and moments, as
    the other comparisons with one process), each at world 2 with
    use_zero1 and at world 1."""
    from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
    from merlot_tpu_torch.train.checkpoint import CheckpointManager
    from test_torch_harness import YAML as PRETRAIN_YAML
    from test_torch_vcr import TINY as VCR_CLI_TINY
    from test_torch_vcr import _yaml as vcr_yaml
    shards = d / "cli_shards"
    shards.mkdir()
    for i in range(2):
        write_synthetic_shard(str(shards / f"train-{i}.tfrecord"), 4, 4, seed=i,
                              img_hw=(72, 128))
    model = seeded(MerlotPretrainModel(MerlotConfig(**dict(
        VCR_CLI_TINY, num_texts=1, max_position_embeddings=1024))))
    params = dict(model.named_parameters())
    init = CheckpointManager(str(d / "cli_init"))
    init.save(1, params, MerlotAdamW(AdamWConfig()).init(params))
    vcr_dir = os.path.dirname(vcr_files[0])
    zero1 = "device:\n  use_zero1: true\n"
    for w in (1, 2):
        # world 2 trains 2 steps (a checkpoint at 2); world 1 resumes to 4;
        # no evaluation (no val shard matches)
        text = PRETRAIN_YAML.format(d=shards, out=d / f"cli_pretrain_w{w}").replace(
            "val-*.tfrecord", "none-*.tfrecord").replace(
            "num_train_steps: 4", f"num_train_steps: {2 * (3 - w)}")
        vtext = vcr_yaml(vcr_dir, d / f"cli_vcr_w{w}", init.path(1), hidden_dropout_prob=0.0,
                         use_bfloat16=False).replace("use_bfloat16_adam: true",
                                                     "use_bfloat16_adam: false").replace(
            "num_train_steps: 4", "num_train_steps: 2")
        if w == 2:
            text, vtext = (x.replace("device:\n", zero1) for x in (text, vtext))
        (d / f"cli_pretrain_w{w}.yaml").write_text(text)
        (d / f"cli_vcr_w{w}.yaml").write_text(vtext)


def _jsonl(path):
    """The logged train steps (rows with a loss) by step."""
    return {r["step"]: r for r in map(json.loads, open(path)) if "loss" in r}


def _close(got, want, name, atol=0.0):
    """Within RTOL of the tensor's largest |value|, plus ``atol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert got.shape == want.shape, name
    assert err <= RTOL * scale + atol + 1e-12, f"{name}: {err} > {RTOL} x {scale} + {atol}"


def _ckpt(path):
    """(params, m, v) of a checkpoint by flax path, the moments decoded."""
    meta = json.loads((path / "meta.json").read_text())
    params = load_params(str(path))
    with np.load(path / "opt_state.npz") as z:
        mom = {}
        for k in z.files:
            g, p = k.split("/", 1)
            t = torch.from_numpy(z[k])
            if meta["dtypes"][g] == "bfloat16":
                t = t.view(torch.int16).view(torch.bfloat16)
            mom.setdefault(g, {})[p] = (decode_v(t) if g == "v" else t.float()).numpy()
    return params, mom["m"], mom["v"], meta["step"]


TIMING = {"step", "time", "perf/steps_per_sec", "perf/data_wait_s"}


def _same_run(got_dir, want_dir, steps):
    got = _jsonl(got_dir / "train_metrics.jsonl")
    want = _jsonl(want_dir / "train_metrics.jsonl")
    for s in steps:
        assert set(got[s]) - TIMING == set(want[s]) - TIMING
        for k in set(want[s]) - TIMING:
            _close(got[s][k], want[s][k], f"step {s} {k}")
        gp, gm, gv, gstep = _ckpt(got_dir / "checkpoints" / f"ckpt_{s}")
        wp, wm, wv, wstep = _ckpt(want_dir / "checkpoints" / f"ckpt_{s}")
        assert gstep == wstep == s
        for what, g, w in (("param", gp, wp), ("m", gm, wm), ("v", gv, wv)):
            assert set(g) == set(w)
            # some gradients are 0 analytically (the key biases') and hold
            # only rounding noise, which Adam carries into their leaves:
            # 1e-6 of the largest value of all bounds them
            floor = 1e-6 * max(float(np.abs(a).max()) for a in w.values())
            for k in w:
                _close(g[k], w[k], f"step {s} {what} {k}", atol=floor)


# ----------------------------------------------------------------------
# the ZeRO-1 layout against JAX's

def _jax_tree(which):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    if which == "pretrain":
        from merlot_tpu.models.config import MerlotConfig as JaxConfig
        from merlot_tpu.models.pretrain import MerlotPretrainModel as JaxPretrain
        cfg = tiny_config()
        jm = JaxPretrain(JaxConfig(**dataclasses.asdict(cfg)))
        batch = {k: jnp.asarray(v) for k, v in pretrain_batches()[0].items()}
        tree = jax.eval_shape(lambda k: jm.init({"params": k, "masking": k}, batch,
                                                deterministic=True), jax.random.PRNGKey(0))
        port = MerlotPretrainModel(cfg)
    elif which == "vcr":
        from merlot_tpu.downstream.vcr.modeling import VCRModel as JaxVCR
        from merlot_tpu.models.config import MerlotConfig as JaxConfig
        from merlot_tpu_torch.downstream.vcr.modeling import VCRModel
        from test_torch_vcr import _init_all
        b = vcr_batch()
        jm = JaxVCR(JaxConfig(**VCR_TINY))
        tree = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(b["images"]),
                                                jnp.asarray(b["lm_input"]),
                                                method=_init_all), jax.random.PRNGKey(0))
        port = VCRModel(MerlotConfig(**VCR_TINY))
    else:
        from merlot_tpu.models import grover as jg
        from merlot_tpu_torch.models import grover as tg
        jm = jg.GroverLM(jg.GroverConfig(**GROVER_TINY))
        tree = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, 16), jnp.int32)),
                              jax.random.PRNGKey(0))
        port = tg.GroverLM(tg.GroverConfig(**GROVER_TINY))
    return flatten_dict(tree["params"], sep="/"), dict(port.named_parameters())


@pytest.fixture(scope="module")
def trees():
    return {w: _jax_tree(w) for w in ("pretrain", "vcr", "grover")}


@pytest.mark.parametrize("which", ["pretrain", "vcr", "grover"])
def test_param_partition_spec_matches_jax(trees, which):
    from merlot_tpu.parallel.mesh import param_partition_spec as jax_spec
    jtree, port = trees[which]
    assert {flax_path(n) for n in port} == set(jtree)
    named = 0
    for n, p in port.items():
        path = flax_path(n)
        assert pm.flax_shape(n, p.shape) == tuple(jtree[path].shape), n
        want = tuple(jax_spec(path, jtree[path]))
        assert pm.param_partition_spec(path, jtree[path]) == want, n
        named += "model" in want
    assert named > 0


@pytest.mark.parametrize("data", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("which", ["pretrain", "vcr", "grover"])
def test_zero1_partition_spec_matches_jax(trees, which, data):
    """The spec on the flax path and shape, and the axis in the port's
    layout: the same logical axis (a matmul kernel's [in, out] is the port's
    [out, in], a conv's HWIO its OIHW)."""
    from merlot_tpu.parallel.mesh import zero1_partition_spec as jax_spec
    jtree, port = trees[which]
    sharded = 0
    for n, p in port.items():
        path = flax_path(n)
        want = tuple(jax_spec(path, jtree[path], data))
        assert pm.zero1_partition_spec(path, jtree[path], data) == want, n
        axis = pm.zero1_axis(n, tuple(p.shape), data)
        if "data" not in want:
            assert axis is None, n
            continue
        sharded += 1
        assert p.shape[axis] == jtree[path].shape[want.index("data")]
        # the same elements lie at index 0 of the port's axis and of JAX's
        probe = np.arange(p.numel()).reshape(tuple(p.shape))
        flax = flax_layout(n, probe)
        assert set(np.take(probe, 0, axis=axis).ravel()) == \
            set(np.take(flax, 0, axis=want.index("data")).ravel()), n
    if data in (1, 2):  # nothing to split at 1; every tiny model has even axes
        assert (sharded > 0) == (data == 2)


def test_zero1_named_axis_is_not_free():
    """A rule's axis is taken even with the model axis at 1: the query
    kernel [H, H] is (None, 'model'), so 'data' goes on axis 0, which is
    the port's axis 1 ([out, in])."""
    spec = pm.zero1_partition_spec("merlot/encoder/layer00/attention/query/kernel",
                                   np.zeros((64, 64)), 2)
    assert spec == ("data", "model")
    assert pm.zero1_axis("merlot.encoder.layer00.attention.query.weight", (64, 64), 2) == 1


# ----------------------------------------------------------------------
# world size 1: the global losses are today's

def test_global_losses_at_world_1_equal_todays():
    port = _free_port()
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=1, rank=0)
    try:
        mesh = pm.make_mesh()
        model = seeded(MerlotPretrainModel(tiny_config()))
        batch = torch_batch(pretrain_batches()[0])
        outs = []
        for m in (None, mesh):
            model.zero_grad()
            loss, metrics, _ = model(batch, deterministic=True,
                                     generator=torch.Generator().manual_seed(0), mesh=m)
            loss.backward()
            outs.append((loss.detach(), {k: v.detach() for k, v in metrics.items()},
                         [None if p.grad is None else p.grad.clone()
                          for p in model.parameters()]))
        (l0, m0, g0), (l1, m1, g1) = outs
        assert torch.equal(l0, l1)
        assert m0.keys() == m1.keys()
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        assert any(a is not None for a in g0)
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(g0, g1))
    finally:
        torch.distributed.destroy_process_group()


# ----------------------------------------------------------------------
# two gloo ranks against one process

def test_dp_step_equals_one_process(runs):
    _same_run(runs["dir"] / "dp", runs["dir"] / "ref", [1])


def test_zero1_steps_equal_one_process(runs):
    _same_run(runs["dir"] / "z1", runs["dir"] / "ref", [1, 2])


def test_zero1_rank_holds_half_of_the_sharded_moments(runs):
    for r in range(WORLD):
        b = json.loads((runs["dir"] / f"bytes_{r}.json").read_text())
        assert b["sharded"] > 0
        assert b["state"] == b["expected"] < b["whole"]


@pytest.mark.parametrize("direction", ["w2_to_w1", "w1_to_w2"])
def test_zero1_checkpoint_crosses_world_sizes(runs, direction):
    """A checkpoint holds whole moments: world 2's (ZeRO-1) restores in one
    process, one process's restores at world 2 with ZeRO-1, and each
    resumed step 3 equals the uninterrupted run's."""
    d = runs["dir"]
    got = d / ("resume_w1" if direction == "w2_to_w1" else "resume_w2")
    if direction == "w2_to_w1":
        a, b = _ckpt(d / "z1" / "checkpoints" / "ckpt_2"), _ckpt(got / "checkpoints" / "ckpt_2")
        assert all(np.array_equal(a[i][k], b[i][k]) for i in range(3) for k in a[i])
    _same_run(got, d / "ref", [3])


def test_vcr_zero1_step_equals_one_process(runs):
    d = runs["dir"]
    metrics = json.loads((d / "vcr_metrics.json").read_text())
    want_metrics, want_params = runs["vcr_ref"]
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        _close(metrics[k], v, k)
    with np.load(d / "vcr_params.npz") as z:
        assert set(z.files) == set(want_params)
        floor = 1e-6 * max(float(np.abs(a).max()) for a in want_params.values())
        for k in z.files:
            _close(z[k], want_params[k], k, atol=floor)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_zero_shot_whole_batches_equal_one_process_bit_for_bit(runs):
    d = runs["dir"]
    got, want = _npz(d / "zs_w2.npz"), _npz(d / "zs_w1.npz")
    assert json.loads((d / "eval_w2.json").read_text())["stories"] == runs["zs_n"] == 4
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # a row split runs each story alone: its output is not the batch's
    rows_ = _npz(d / "zs_rows.npz")
    assert any(not np.array_equal(rows_[k], want[k]) for k in want if k.endswith("_probs"))


def test_vcr_validate_over_ranks_equals_one_process(runs):
    d = runs["dir"]
    assert json.loads((d / "eval_w2.json").read_text())["accuracy"] == runs["acc_w1"]
    got = [json.loads(x) for x in open(d / "pred_w2.jsonl")]
    want = [json.loads(x) for x in open(d / "pred_w1.jsonl")]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("annot_id", "prediction", "label")} == \
            {k: w[k] for k in ("annot_id", "prediction", "label")}
        np.testing.assert_allclose(g["log_probs"], w["log_probs"], rtol=0, atol=1e-6)


def test_evaluate_over_ranks_equals_one_process(runs):
    got = json.loads((runs["dir"] / "eval_means_w2.json").read_text())
    want = runs["eval_means_w1"]
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def test_pretrain_cli_under_two_ranks_with_zero1(runs):
    """The CLI as two gloo ranks with use_zero1: rank 0 logs every step and
    writes the checkpoints, and one process resumes the CLI from the
    world-2 ZeRO-1 checkpoint."""
    d = runs["dir"]
    logged = _jsonl(d / "cli_pretrain_w2" / "train_metrics.jsonl")
    assert sorted(logged) == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in logged.values())
    assert sorted(os.listdir(d / "cli_pretrain_w2" / "checkpoints")) == ["ckpt_2"]
    resumed = runs["cli_resumed"]
    assert resumed["opt_state"]["step"] == 4
    assert sorted(_jsonl(d / "cli_pretrain_w1" / "train_metrics.jsonl")) == [3, 4]


def test_vcr_cli_under_two_ranks_equals_one_process(runs):
    """Every rank reads the whole stream and keeps its rows: with dropout
    off the world-2 ZeRO-1 run logs the one-process run's metrics."""
    d = runs["dir"]
    got = _jsonl(d / "cli_vcr_w2" / "train_metrics.jsonl")
    want = _jsonl(d / "cli_vcr_w1" / "train_metrics.jsonl")
    assert sorted(got) == sorted(want) == [1, 2]
    for s in want:
        assert set(got[s]) - TIMING == set(want[s]) - TIMING
        for k in set(want[s]) - TIMING:
            _close(got[s][k], want[s][k], f"step {s} {k}")


# ----------------------------------------------------------------------
# the 2-rank ZeRO-1 step against JAX's

def test_zero1_step_matches_jax(runs):
    """The port's world-2 ZeRO-1 step on JAX's weights, batch and masking
    draws against JAX's ``make_train_step(mesh=make_mesh(data=2),
    zero1=True)``, with test_torch_train_step.py's checks."""
    from torch_port_helpers import (check_step_grads, check_step_loss_and_metrics,
                                    check_step_params_and_state)
    d = runs["dir"]
    jgrads, jparams, jstate, jmetrics = runs["jax"]
    tm = MerlotPretrainModel(tiny_config())
    out = _npz(d / "jax_port_out.npz")
    state = {"step": 1, "m": {}, "v": {}}
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(torch.from_numpy(out[f"param/{n}"]))
            p.grad = torch.from_numpy(out[f"grad/{n}"])
            for g in ("m", "v"):
                state[g][n] = torch.from_numpy(out[f"{g}/{n}"]).view(torch.bfloat16)
    metrics = json.loads((d / "jax_port_metrics.json").read_text())
    stepped = (tm, state, metrics, jgrads, jparams, jstate, jmetrics)
    check_step_loss_and_metrics(stepped)
    check_step_grads(stepped)
    check_step_params_and_state(stepped)


# ----------------------------------------------------------------------
# the smoke tool

def test_multiprocess_smoke_tool(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD)
    r = subprocess.run([sys.executable, "-m", "merlot_tpu_torch.tools.multiprocess_smoke",
                        "--num-procs", "2", "--device", "cpu", "--workdir",
                        str(tmp_path / "mp")], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=TIMEOUT_S)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-3000:]}"
    assert "MULTIPROCESS SMOKE OK" in r.stdout


def test_cuda_rank_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "0")
    if torch.cuda.is_available():
        monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.init_multihost(device="cuda", world_size=1, rank=0)


def test_model_parallelism_raises_naming_tensor_parallelism():
    """A model axis needs ranks: one process without torchrun refuses it,
    as do the entry points whose JAX twins have none (VCR, zero-shot)."""
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(model=2)
    with pytest.raises(ValueError, match="tensor parallelism"):
        pm.join_from_env("cpu", model=2)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        pm.refuse_model_axis(2, "VCR CLI", "merlot_tpu/downstream/vcr/train.py:42")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4:])
