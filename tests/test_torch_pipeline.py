"""merlot_tpu_torch's pipeline parallelism (the mesh's stage axis,
parallel/pipeline.py, Grover's stages and ``grover_train --pp``) on gloo CPU
ranks, held against merlot_tpu's (tests/test_pipeline.py, whose tiny config
this file uses: Grover vocab 128, hidden 32, 8 layers, 4 heads; B 8 x S 12
in M 4 microbatches) on the conftest's 8 virtual CPU devices, with JAX's
weights moved by ``convert.load_flax_params`` and numpy-seeded inputs.

  * four ranks (this file run as a script, a time limit each): at stage 4
    ``pipeline_apply``'s outputs and, through the hand-written reverse
    schedule, the layers' grads and the input's against JAX's
    ``pipeline_apply`` and ``jax.grad`` on a ("stage",) mesh; at data 2 x
    stage 2 the same against JAX's ``data_axis`` composition on a (2, 2)
    mesh; ``grover_pipeline_forward``'s logits against JAX's GroverLM (and
    the port's own); keyed dropout at stage 4; the refusal of a stage axis
    beside a model axis;
  * two ranks: one ``--pp 2`` train step (dropout 0) against JAX's
    ``make_loss_train_step`` over its ``grover_pipeline_forward`` at pp 2
    (loss, metrics, grads, the updated stacked parameters and moments);
    keyed dropout at stage 2; then the CLI as torchrun starts it: ``--pp 2
    --microbatches 2`` from JAX's initial weights against JAX's
    ``grover_train.main`` (the twin of ``test_grover_train_cli_pp``), a run
    to step 2 resumed to 4 against the straight run (the twin of
    ``test_grover_train_resumes_from_checkpoint``), and the trained ranks'
    forward, which ``load_npz_params`` must give back from the checkpoint;
  * in this process: the stacked trees bit for bit against JAX's, the
    whole model's seeded init split into stages, the no-decay set on the
    stacked paths, and the refusals by name.

Tolerances: outputs and logits within 2e-5 of the largest |value| (JAX's
own pipeline test: 2e-5), grads within 5e-5 of each tensor's largest
|grad| plus 1e-6 of the largest of all (JAX's: 5e-5); the train step as
tests/test_torch_grover_train.py (loss 1e-5 relative, metrics 2e-4, grads
2e-4 of each tensor's largest, parameters and moments as
tests/torch_port_helpers.py); the CLI's losses against JAX's 1e-4 relative
(four AdamW steps at lr 1e-3 from the same weights, sums in another
order); keyed dropout, the resumed losses and the stacked trees exactly;
the checkpoint's logits against the ranks' 2e-5.
"""

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
for p in (str(REPO), str(REPO / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from merlot_tpu_torch.convert import (flax_layout, flax_path, load_flax_params,  # noqa: E402
                                      params_from_flax, stacked_tree, stage_tree)
from merlot_tpu_torch.models import grover as tg  # noqa: E402
from merlot_tpu_torch.nn.layers import init_params  # noqa: E402
from merlot_tpu_torch.parallel import mesh as pm  # noqa: E402
from merlot_tpu_torch.parallel import pipeline as pp  # noqa: E402
from merlot_tpu_torch.tools import grover_train  # noqa: E402
from merlot_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

TIMEOUT_S = 150
CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=8, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
B, S, M, N_STAGE = 8, 12, 4, 4
DROPOUT = 0.3
# tests/test_pipeline.py's CLI config
CLI = dict(vocab_size=1024, hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
           intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0)
CLI_ARGS = ["--seq_length", "33", "--batch_size", "4", "--num_warmup_steps", "0",
            "--learning_rate", "1e-3", "--checkpoint_every", "2", "--pp", "2",
            "--microbatches", "2"]
CLI_STEPS = 4
LR = 3e-4
FWD_TOL, GRAD_TOL = 2e-5, 5e-5
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# inputs

def hidden():
    return np.random.default_rng(0).standard_normal((B, S, CFG["hidden_size"])).astype(
        np.float32)


def cotangent():
    """The weights of the outputs in the pipeline tests' loss, sum(out * r)
    (a sum of squares of the LayerNormed outputs would leave the input's
    gradient at rounding noise)."""
    return np.random.default_rng(2).standard_normal((M, B // M, S, CFG["hidden_size"])).astype(
        np.float32)


def lm_batch(seed=1):
    """ids [B, S + 1] below the vocabulary with padded tails, is_target on
    each row's tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG["vocab_size"], (B, S + 1)).astype(np.int32)
    is_target = np.zeros_like(ids)
    for r in range(B):
        n = int(rng.integers(S // 2, S + 2))
        ids[r, n:] = 0
        is_target[r, int(rng.integers(1, max(2, n))):n] = 1
    return {"input_ids": ids, "is_target": is_target}


def grover_cfg(dropout=0.0):
    return tg.GroverConfig(**dict(CFG, hidden_dropout_prob=dropout))


def layer_modules(d: Path, lo: int, n: int):
    """GroverLayers lo .. lo + n - 1 with JAX's per-layer weights."""
    with np.load(d / "layers.npz") as z:
        flat = {k: z[k] for k in z.files}
    out = []
    for i in range(lo, lo + n):
        layer = tg.GroverLayer(grover_cfg())
        load_flax_params(layer, {k.split("/", 1)[1]: v for k, v in flat.items()
                                 if k.split("/")[0] == f"layer{i}"})
        out.append(layer)
    return out


def stage_model(d: Path, mesh, dropout=0.0):
    """This rank's GroverStage with JAX's GroverLM weights (stacked, then cut)."""
    with np.load(d / "grover.npz") as z:
        flat = {k: z[k] for k in z.files}
    stage = tg.GroverStage(grover_cfg(dropout), mesh.stage, mesh.stage_rank)
    load_flax_params(stage, tg.shard_grover_pp_params(tg.stack_grover_params(flat, mesh.stage),
                                                      mesh))
    return stage


def layer_fn(layer, h):
    mask = torch.tril(torch.ones((S, S)))[None]
    return layer(h, mask)


def stage_grads(layers, mesh):
    """The stages' layer grads gathered into JAX's stacked flax layout."""
    grads = {f"stages.{j}.{n}": p.grad for j, layer in enumerate(layers)
             for n, p in layer.named_parameters()}
    whole = mesh.gather_stages(grads)
    if whole is None:  # gathered on stage 0
        return None
    return {flax_path(k)[len("stages/"):]: flax_layout(k, v.numpy()) for k, v in whole.items()}


def keyed_logits(stage, mesh, ids, seed):
    with torch.no_grad():
        logits, _ = tg.grover_pipeline_forward(
            stage, torch.from_numpy(ids), mesh=mesh, num_microbatches=M,
            generator=torch.Generator().manual_seed(seed))
    return logits


# ----------------------------------------------------------------------
# the ranks

def _pipeline_grads(d: Path, mesh, tag: str, data_axis=False):
    """pipeline_apply at ``mesh`` with the loss sum(out * r): the last
    stage writes its outputs, stage 0 its input grads, the chief the
    stacked layer grads."""
    per = CFG["num_hidden_layers"] // mesh.stage
    layers = layer_modules(d, mesh.stage_rank * per, per)
    h_mb = pp.microbatch(torch.from_numpy(hidden()), M).requires_grad_(True)
    pipe = pp.pipeline_apply(layer_fn, layers, h_mb, mesh, data_axis=data_axis)
    if mesh.is_last_stage:
        r = torch.from_numpy(cotangent())
        if data_axis:
            r = pp._local_rows(r, mesh)
        (pipe.outputs * r).sum().backward()
        np.save(d / f"{tag}_out_d{mesh.rank}.npy", pipe.outputs.detach().numpy())
    dh = pipe.backward()
    if mesh.is_first_stage:
        np.save(d / f"{tag}_dh_d{mesh.rank}.npy", dh.numpy())
    grads = stage_grads(layers, mesh)
    assert (grads is not None) == mesh.is_first_stage
    if mesh.is_chief:
        np.savez(d / f"{tag}_grads.npz", **grads)


def _train_step(d: Path, mesh):
    """One --pp step of the CLI's loss and AdamW block from JAX's weights:
    the chief writes the metrics, the grads, the parameters and moments."""
    from merlot_tpu_torch.train.train_step import make_pipeline_loss_train_step
    stage = stage_model(d, mesh)
    opt = grover_train.grover_optimizer(LR, 100, 0)
    state = opt.init(dict(stage.named_parameters()))
    step = make_pipeline_loss_train_step(
        grover_train.make_grover_pipeline_loss(stage.cfg, 4.0, mesh, M), opt, mesh=mesh,
        device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in lm_batch().items()}
    metrics = step(stage, state, batch, torch.Generator().manual_seed(0))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": mesh.gather_stages({n: p.grad for n, p in stage.named_parameters()}),
           "params": mesh.gather_stages(dict(stage.named_parameters())),
           "m": mesh.gather_stages(state["m"]), "v": mesh.gather_stages(state["v"])}
    if mesh.is_chief:
        torch.save(out, d / "train_step.pt")


def _keyed(d: Path, mesh):
    stage = stage_model(d, mesh, DROPOUT)
    ids = lm_batch()["input_ids"][:, :-1]
    runs = [keyed_logits(stage, mesh, ids, seed) for seed in (1, 1, 2)]
    if mesh.is_last_stage:
        np.savez(d / f"keyed_pp{mesh.stage}.npz", *[r.numpy() for r in runs])


def _rank_main(world: int, rank: int, d: Path, ports) -> None:
    torch.set_num_threads(1)
    pm.init_multihost(init_method=f"tcp://127.0.0.1:{ports[0]}", world_size=world,
                      rank=rank, device="cpu")
    if world == 4:
        mesh = pm.make_mesh(stage=4)
        assert (mesh.stage_rank, mesh.rank, mesh.data) == (rank, 0, 1)
        _pipeline_grads(d, mesh, "stage4")
        try:
            pm.make_mesh(model=2, stage=2)
        except NotImplementedError as e:
            (d / f"refusal_{rank}.txt").write_text(str(e))
        stage = stage_model(d, mesh)
        with torch.no_grad():
            logits, _ = tg.grover_pipeline_forward(
                stage, torch.from_numpy(lm_batch()["input_ids"][:, :-1]), mesh=mesh,
                num_microbatches=M)
        if mesh.is_last_stage:
            np.save(d / "logits_pp4.npy", logits.numpy())
        _keyed(d, mesh)
        mesh = pm.make_mesh(data=2, stage=2)
        assert (mesh.rank, mesh.stage_rank) == divmod(rank, 2)
        _pipeline_grads(d, mesh, "data2_stage2", data_axis=True)
        pm.leave(mesh)
        return
    mesh = pm.make_mesh(stage=2)
    _train_step(d, mesh)
    _keyed(d, mesh)
    pm.leave(mesh)
    # the CLI as torchrun starts it, a group of its own each time
    cfg_path, shard = str(d / "cli.json"), str(d / "cli-00.tfrecord")

    def cli(out, steps, port):
        os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        return grover_train.main(["--config", cfg_path, "--train_files", shard,
                                  "--output_dir", str(out), "--num_train_steps", str(steps),
                                  "--log_every", "1", "--device", "cpu"] + CLI_ARGS)

    cli(d / "cli_a", CLI_STEPS, ports[1])
    # the straight run's ckpt_2 in a fresh directory (the other rank waits
    # for this one in the CLI's rendezvous)
    if rank == 0:
        shutil.copytree(d / "cli_a" / "checkpoints" / "ckpt_2",
                        d / "cli_b" / "checkpoints" / "ckpt_2")
    print("-- resume", flush=True)
    trained = cli(d / "cli_b", CLI_STEPS, ports[2])["trainer"].model
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(k)
    pm.init_multihost(init_method=f"tcp://127.0.0.1:{ports[3]}", world_size=2, rank=rank,
                      device="cpu")
    mesh = pm.make_mesh(stage=2)
    ids = np.load(d / "cli_ids.npy")
    with torch.no_grad():
        logits, _ = tg.grover_pipeline_forward(trained, torch.from_numpy(ids), mesh=mesh,
                                               num_microbatches=2)
    if mesh.is_last_stage:
        np.save(d / "cli_trained_logits.npy", logits.numpy())
    pm.leave(mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'tests'}", **ONE_THREAD)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _launch(world: int, d: Path):
    ports = [str(_free_port()) for _ in range(4)]
    procs = []
    for r in range(world):
        with open(d / f"rank{world}_{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(world), str(r), str(d)]
                + ports, env=_env(), stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait(jobs, d: Path):
    """Wait for every rank, each within TIMEOUT_S; a rank that fails or
    hangs (then all are killed) fails the run with its output."""
    procs = [(w, r, p) for w, ps in jobs for r, p in enumerate(ps)]
    for _, _, p in procs:
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, _, q in procs:
                q.kill()
                q.wait()
    for w, r, p in procs:
        assert p.returncode == 0, \
            f"rank {r} of {w} exited {p.returncode}:\n" \
            f"{(d / f'rank{w}_{r}.log').read_text()[-4000:]}"


# ----------------------------------------------------------------------
# JAX's side

def jax_setup(d: Path) -> dict:
    """JAX's weights for the ranks: 8 GroverLayers as tests/test_pipeline.py
    makes them, a GroverLM of the same config, and the CLI's initial
    weights in the --pp 2 form as a port checkpoint at step 0."""
    import jax
    import jax.numpy as jnp
    from merlot_tpu.models import grover as jg
    from merlot_tpu.tools.grover_data import lm_batches, write_lm_shard
    from torch_port_helpers import flat_params
    cfg = jg.GroverConfig(**CFG)
    mask = jnp.tril(jnp.ones((S, S), jnp.float32))[None]
    layer = jg.GroverLayer(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.num_hidden_layers)
    init = jax.jit(lambda k, h: layer.init(k, h, mask))
    h = jnp.asarray(hidden())
    layer_params = [init(k, h[:1])["params"] for k in keys]
    np.savez(d / "layers.npz", **{f"layer{i}/{k}": v for i, lp in enumerate(layer_params)
                                  for k, v in flat_params(lp).items()})
    model = jg.GroverLM(cfg)
    ids = jnp.asarray(lm_batch()["input_ids"][:, :-1])
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), ids)
    np.savez(d / "grover.npz", **flat_params(variables["params"]))

    # the CLI: tests/test_pipeline.py's shard and config; JAX's CLI draws
    # its weights from the first batch, so the port's runs start from a
    # checkpoint of them at step 0
    (d / "cli.json").write_text(json.dumps(CLI))
    seq_rng = np.random.default_rng(0)
    seqs = [seq_rng.integers(3, 1024, 34).tolist() for _ in range(8)]
    tgts = [[0] * 17 + [1] * 17 for _ in range(8)]
    write_lm_shard(str(d / "cli-00.tfrecord"), seqs, seq_length=33, is_target=tgts)
    first = next(lm_batches([str(d / "cli-00.tfrecord")], 33, 4))
    cli_model = jg.GroverLM(jg.GroverConfig(**CLI))
    cli_params = cli_model.init({"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(1)},
                                jnp.asarray(first["input_ids"][:, :-1]))["params"]
    stacked = flat_params(jg.stack_grover_params({"params": cli_params}, 2)["params"])
    params = params_from_flax(stacked)
    zeros = {n: torch.zeros_like(t) for n, t in params.items()}
    save_checkpoint(str(d / "cli_a" / "checkpoints" / "ckpt_0"), params,
                    {"step": 0, "m": zeros, "v": dict(zeros)})
    np.save(d / "cli_ids.npy", np.asarray(first["input_ids"][:2, :32], np.int64))
    return {"layer_params": layer_params, "variables": variables, "layer": layer,
            "mask": mask}


def jax_refs(d: Path, setup: dict) -> dict:
    """JAX's outputs and grads of the pipeline (stage 4, and data 2 x stage
    2), GroverLM's logits, the --pp 2 train step, and the CLI's losses."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    from merlot_tpu.models import grover as jg
    from merlot_tpu.parallel.pipeline import microbatch, pipeline_apply, stack_stage_params
    from merlot_tpu.tools import grover_train as jgt
    from merlot_tpu.train import harness as jharness
    from merlot_tpu.train.optimizer import AdamWConfig as JaxAdamWConfig
    from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
    from merlot_tpu.train.train_step import make_loss_train_step
    from torch_port_helpers import flat_params

    layer, mask = setup["layer"], setup["mask"]

    def layer_fn_j(p, hh):
        return layer.apply({"params": p}, hh, mask)[0]

    out = {}
    h_mb = microbatch(jnp.asarray(hidden()), M)
    for tag, n_stage, shape, data_axis in (("stage4", 4, (4,), None),
                                           ("data2_stage2", 2, (2, 2), "data")):
        names = ("stage",) if data_axis is None else ("data", "stage")
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), names)
        stacked = stack_stage_params(setup["layer_params"], n_stage)
        x = h_mb if data_axis is None else jax.device_put(
            h_mb, NamedSharding(mesh, P(None, "data")))

        def loss(p, xx, mesh=mesh, data_axis=data_axis):
            o = pipeline_apply(layer_fn_j, p, xx, mesh=mesh, data_axis=data_axis)
            return jnp.sum(o.astype(jnp.float32) * jnp.asarray(cotangent())), o

        (_, o), (gp, gh) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            stacked, x)
        out[tag] = {"out": np.asarray(o), "grads": flat_params(gp), "dh": np.asarray(gh)}

    cfg = jg.GroverConfig(**CFG)
    model = jg.GroverLM(cfg)
    variables = setup["variables"]
    batch = {k: jnp.asarray(v) for k, v in lm_batch().items()}
    ids = batch["input_ids"][:, :-1]
    out["logits"] = np.asarray(jax.jit(lambda v, i: model.apply(v, i)[0])(variables, ids))

    # one --pp 2 step: make_loss_train_step over grover_pipeline_forward
    mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("stage",))
    pp_params = jg.stack_grover_params(variables, 2)["params"]

    def loss_fn(p, b, key):
        i = b["input_ids"][:, :-1]
        logits = jg.grover_pipeline_forward({"params": p}, cfg, i, mesh=mesh2,
                                            num_microbatches=M, dropout_rng=key)
        return jg.grover_lm_loss(logits, i, b["is_target"][:, 1:], target_bonus=4.0)

    jopt = JaxAdamW(JaxAdamWConfig(
        learning_rate=LR, num_train_steps=100, num_warmup_steps=0, weight_decay_rate=0.01,
        beta_2=0.98, clip_norm=1.0,
        param_overrides=((grover_train.NO_DECAY, {"weight_decay_rate": 0.0}),)))
    key = jax.random.PRNGKey(3)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, key)[0]))(pp_params)
    new_params, new_state, metrics = make_loss_train_step(loss_fn, jopt, donate=False)(
        pp_params, jopt.init(pp_params), batch, key)
    out["train_step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                         "grads": flat_params(grads), "params": flat_params(new_params),
                         **{g: flat_params(new_state[g]) for g in ("m", "v")},
                         "no_decay": {p for p in flat_params(pp_params)
                                      if jopt._resolve(p)["weight_decay_rate"] == 0.0}}

    # the CLI: JAX's --pp 2 run, every step logged
    jout = d / "cli_jax"
    logged = functools.partial(jharness.Trainer, log_every=1)
    orig = jgt.Trainer
    jgt.Trainer = logged
    try:
        jgt.main(["--config", str(d / "cli.json"), "--train_files",
                  str(d / "cli-00.tfrecord"), "--output_dir", str(jout),
                  "--num_train_steps", str(CLI_STEPS)] + CLI_ARGS)
    finally:
        jgt.Trainer = orig
    out["cli_losses"] = _losses(jout)
    return out


def _losses(out: Path):
    return {x["step"]: x["loss"] for x in map(json.loads, open(out / "train_metrics.jsonl"))
            if "loss" in x}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4- and 2-rank jobs and JAX's references, computed meanwhile."""
    d = tmp_path_factory.mktemp("pipeline")
    setup = jax_setup(d)
    jobs = [(4, _launch(4, d)), (2, _launch(2, d))]
    try:
        refs = jax_refs(d, setup)
    finally:
        _wait(jobs, d)
    return {"dir": d, "jax": refs, "setup": setup}


# ----------------------------------------------------------------------
# comparisons

def _close(got, want, name, rtol, atol=0.0):
    """Within ``rtol`` of the tensor's largest |value|, plus ``atol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rtol * scale + atol + 1e-12, f"{name}: {err} > {rtol} x {scale} + {atol}"


def _grads_close(got, want, rtol=GRAD_TOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    floor = 1e-6 * max(float(np.abs(g).max()) for g in want.values())
    for n in want:
        _close(got[n], want[n], n, rtol, atol=floor)


def _flax(tree):
    """Gathered port tensors (torch names) -> numpy by flax path, flax layout."""
    return {flax_path(n): flax_layout(n, t.detach().float().numpy()) for n, t in tree.items()}


@pytest.mark.parametrize("tag", ["stage4", "data2_stage2"])
def test_pipeline_forward_matches_jax(job, tag):
    d, ref = job["dir"], job["jax"][tag]
    rows = [np.load(d / f"{tag}_out_d{i}.npy") for i in range(1 if tag == "stage4" else 2)]
    _close(np.concatenate(rows, axis=1), ref["out"], "outputs", FWD_TOL)


@pytest.mark.parametrize("tag", ["stage4", "data2_stage2"])
def test_pipeline_grads_match_jax(job, tag):
    """The reverse schedule's layer grads (summed over the data group at
    data 2) and the input's, against jax.grad through the ppermute scan."""
    d, ref = job["dir"], job["jax"][tag]
    with np.load(d / f"{tag}_grads.npz") as z:
        _grads_close({k: z[k] for k in z.files}, ref["grads"])
    dh = np.concatenate([np.load(d / f"{tag}_dh_d{i}.npy")
                         for i in range(1 if tag == "stage4" else 2)], axis=1)
    _close(dh, ref["dh"], "input grads", GRAD_TOL)


def test_grover_pipeline_forward_matches_jax_and_lm(job):
    d = job["dir"]
    got = np.load(d / "logits_pp4.npy")
    _close(got, job["jax"]["logits"], "logits vs JAX", FWD_TOL)
    lm = tg.GroverLM(grover_cfg())
    with np.load(d / "grover.npz") as z:
        load_flax_params(lm, {k: z[k] for k in z.files})
    with torch.no_grad():
        want, _ = lm(torch.from_numpy(lm_batch()["input_ids"][:, :-1]))
    _close(got, want.numpy(), "logits vs GroverLM", FWD_TOL)


def test_stacked_trees_match_jax_bit_for_bit(job):
    """stack_stage_params / stack_grover_params against JAX's on the same
    leaves, their inverses, and one stage's leaves and back."""
    import jax
    from merlot_tpu.models import grover as jg
    from merlot_tpu.parallel.pipeline import stack_stage_params as jax_stack
    from torch_port_helpers import flat_params
    setup = job["setup"]
    flat_layers = [flat_params(lp) for lp in setup["layer_params"]]
    for n_stage in (1, 2, 4):
        want = flat_params(jax.device_get(jax_stack(setup["layer_params"], n_stage)))
        got = pp.stack_stage_params(flat_layers, n_stage)
        assert set(got) == set(want)
        assert all(got[k].shape == want[k].shape and np.array_equal(got[k], want[k])
                   for k in want)
        back = pp.unstack_stage_params(got)
        assert all(np.array_equal(b[k], a[k]) for a, b in zip(flat_layers, back) for k in a)
        for s in range(n_stage):  # each rank's [L/n_stage, ...] slice
            mine = pp.shard_stage_params(got, pm.Mesh(data=1, rank=0, backend="gloo",
                                                      stage=n_stage, stage_rank=s))
            assert all(np.array_equal(mine[k], got[k][s]) for k in got)
    variables = setup["variables"]
    flat = flat_params(variables["params"])
    for n_stage in (2, 4):
        want = flat_params(jax.device_get(jg.stack_grover_params(variables, n_stage))["params"])
        got = tg.stack_grover_params(flat, n_stage)
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
        back = tg.unstack_grover_params(got, CFG["num_hidden_layers"])
        assert set(back) == set(flat) and all(np.array_equal(back[k], flat[k]) for k in flat)
        stages = [stage_tree(got, s, n_stage) for s in range(n_stage)]
        again = stacked_tree(stages)
        assert set(again) == set(got) and all(np.array_equal(again[k], got[k]) for k in got)


def test_seeded_stages_are_the_whole_models_init():
    """GroverStage's init draws the whole GroverLM's stream: each stage
    holds the one-process model's layers and the same replicated leaves."""
    cfg = grover_cfg()
    lm = tg.GroverLM(cfg)
    init_params(lm, torch.Generator().manual_seed(5))
    whole = dict(lm.named_parameters())
    for n_stage in (1, 2, 4, 8):
        for s in range(n_stage):
            stage = tg.GroverStage(cfg, n_stage, s)
            init_params(stage, torch.Generator().manual_seed(5))
            per = CFG["num_hidden_layers"] // n_stage
            for n, p in stage.named_parameters():
                parts = n.split(".")
                key = n if parts[0] != "stages" else \
                    f"layer{s * per + int(parts[1]):02d}." + ".".join(parts[2:])
                assert torch.equal(p, whole[key]), (n_stage, s, n)


def test_keyed_dropout_per_layer_and_microbatch(job):
    """The same generator state gives the same logits, another state others
    (dropout fired), and stages 2 and 4 equal the one-process run of the
    same keyed schedule bit for bit."""
    d = job["dir"]
    with np.load(d / "grover.npz") as z:
        flat = {k: z[k] for k in z.files}
    one = tg.GroverStage(grover_cfg(DROPOUT), 1, 0)
    load_flax_params(one, stage_tree(tg.stack_grover_params(flat, 1), 0))
    ids = lm_batch()["input_ids"][:, :-1]
    ref = [keyed_logits(one, None, ids, seed).numpy() for seed in (1, 2)]
    np.testing.assert_array_equal(ref[0], keyed_logits(one, None, ids, 1).numpy())
    assert np.abs(ref[0] - ref[1]).max() > 1e-3
    with torch.no_grad():
        plain, _ = tg.grover_pipeline_forward(one, torch.from_numpy(ids), mesh=None,
                                              num_microbatches=M)
    assert np.abs(ref[0] - plain.numpy()).max() > 1e-3
    for n in (2, 4):
        with np.load(d / f"keyed_pp{n}.npz") as z:
            a1, a2, b1 = (z[f"arr_{i}"] for i in range(3))
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(a1, ref[0])
        np.testing.assert_array_equal(b1, ref[1])


def test_pp2_train_step_matches_jax(job):
    """One --pp 2 step (dropout 0) against JAX's make_loss_train_step over
    grover_pipeline_forward: loss, metrics, grads, updated parameters and
    moments in JAX's stacked form."""
    from torch_port_helpers import STEP
    got = torch.load(job["dir"] / "train_step.pt", weights_only=False)
    want = job["jax"]["train_step"]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    grads = _flax(got["grads"])
    _grads_close(grads, want["grads"], 2e-4)
    params, moments = _flax(got["params"]), {g: _flax(got[g]) for g in ("m", "v")}
    assert set(params) == set(want["params"])
    floor = {g: 1e-6 * max(float(np.abs(a).max()) for a in want[g].values())
             for g in ("m", "v")}
    for path in want["params"]:
        _close(params[path], want["params"][path], path, 1e-6, atol=1e-3 * STEP)
        for g in ("m", "v"):
            err = np.abs(moments[g][path] - want[g][path])
            bound = 2.0 ** -7 * np.abs(want[g][path]) + 2e-4 * np.abs(want[g][path]).max() \
                + floor[g]
            assert (err <= bound).all(), f"{g} {path}: {err.max()}"


def test_no_decay_set_matches_jax_on_stacked_paths(job):
    """grover_train's no-decay block resolves each stage parameter on JAX's
    stacked path: the same leaves decay as in JAX's --pp tree."""
    from merlot_tpu_torch.train.optimizer import _resolve_path
    opt = grover_train.grover_optimizer(LR, 100, 0)
    stage = tg.GroverStage(grover_cfg(), 2, 1)
    no_decay = {_resolve_path(n) for n, _ in stage.named_parameters()
                if opt._resolve(_resolve_path(n))["weight_decay_rate"] == 0.0}
    assert no_decay == job["jax"]["train_step"]["no_decay"]
    assert "stages/mlp_ln0/gamma" in no_decay and "stages/query/kernel" not in no_decay
    assert flax_path("stages.3.query.weight") == "stages/3/query/kernel"


def test_grover_train_cli_pp_matches_jax(job):
    """grover_train --pp 2 --microbatches 2 under torchrun's variables (two
    gloo ranks) from JAX's initial weights: the losses of every step
    against JAX's --pp 2 run; a checkpoint at every second step."""
    d = job["dir"]
    got, want = _losses(d / "cli_a"), job["jax"]["cli_losses"]
    assert sorted(got) == sorted(want) == list(range(1, CLI_STEPS + 1))
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, err_msg=f"step {s}")
    assert sorted(os.listdir(d / "cli_a" / "checkpoints")) == ["ckpt_0", "ckpt_2", "ckpt_4"]


def test_grover_train_cli_pp_resumes(job):
    """The straight run's ckpt_2 resumed to step 4 in a fresh directory (a
    run cut after its second step): the restore and the steps trained are
    said, and the losses of steps 3-4 equal the straight run's bit for
    bit."""
    d = job["dir"]
    text = (d / "rank2_0.log").read_text().split("-- resume")[1]
    assert "restoring checkpoint at step 2" in text
    assert "trained 2 steps" in text
    straight, resumed = _losses(d / "cli_a"), _losses(d / "cli_b")
    assert sorted(resumed) == [3, 4]
    assert all(resumed[s] == straight[s] for s in resumed), (straight, resumed)


def test_pp_checkpoint_unstacks_into_the_same_logits(job):
    """The --pp 2 checkpoint holds JAX's [pp, L/pp, ...] stages/ leaves;
    the server's load_npz_params unstacks them into a GroverLM whose logits
    are the trained ranks' forward."""
    from merlot_tpu_torch.tools.denoise_server import load_npz_params
    d = job["dir"]
    ckpt = d / "cli_b" / "checkpoints" / f"ckpt_{CLI_STEPS}"
    with np.load(ckpt / "params.npz") as z:
        shapes = {k: z[k].shape for k in z.files}
    stages = {k: v for k, v in shapes.items() if k.startswith("stages/")}
    assert stages and all(v[:2] == (2, 2) for v in stages.values())
    assert shapes["stages/query/kernel"] == (2, 2, 32, 32)
    with np.load(ckpt / "opt_state.npz") as z:
        assert z["m/stages/intermediate/kernel"].shape == (2, 2, 32, 64)
    lm = tg.GroverLM(tg.GroverConfig(**CLI))
    load_flax_params(lm, load_npz_params(str(ckpt / "params.npz"), CLI["num_hidden_layers"]))
    with torch.no_grad():
        want, _ = lm(torch.from_numpy(np.load(d / "cli_ids.npy")))
    _close(np.load(d / "cli_trained_logits.npy"), want.numpy(), "logits", FWD_TOL)


def _refuse(what, d):
    cfg_path = str(d / "cli.json")
    argv = ["--config", cfg_path, "--train_files", str(d / "cli-00.tfrecord"),
            "--output_dir", str(d / "refused"), "--seq_length", "33", "--device", "cpu"]
    if what == "layers":
        with pytest.raises(ValueError, match=r"4 layers do not split into 3 stages"):
            grover_train.main(argv + ["--pp", "3", "--batch_size", "6"])
        with pytest.raises(ValueError, match=r"do not split into 3 stages"):
            tg.GroverStage(grover_cfg(), 3, 0)
    elif what == "microbatches":
        with pytest.raises(ValueError, match=r"batch_size 4 does not split into 3 microbatches"):
            grover_train.main(argv + ["--pp", "2", "--batch_size", "4", "--microbatches", "3"])
        with pytest.raises(ValueError, match=r"8 rows does not split into 3"):
            pp.microbatch(torch.zeros((8, 2)), 3)
    elif what == "world":
        with pytest.raises(ValueError, match=r"world size must\s+equal pp"):
            grover_train.main(argv + ["--pp", "2", "--batch_size", "4", "--microbatches", "2"])
    elif what == "model_axis":
        for r in range(4):
            assert "no JAX path composes pipeline and tensor parallelism" in \
                (d / f"refusal_{r}.txt").read_text()
    elif what == "restore":
        ckpt = str(d / "cli_a" / "checkpoints" / "ckpt_2")
        cfg = tg.GroverConfig(**CLI)
        opt = grover_train.grover_optimizer(1e-3, 4, 0)
        at4 = tg.GroverStage(cfg, 4, 1)
        with pytest.raises(ValueError, match=r"split in 2 pipeline stages, not 4"):
            load_checkpoint(ckpt, at4, opt.init(dict(at4.named_parameters())),
                            pm.Mesh(data=1, rank=0, backend="gloo", stage=4, stage_rank=1))
        whole = tg.GroverLM(cfg)
        with pytest.raises(ValueError, match=r"written at pp=2"):
            load_checkpoint(ckpt, whole, opt.init(dict(whole.named_parameters())))
        # the CLI at --pp 1 on the --pp 2 run's directory
        out = d / "refused_pp1"
        shutil.copytree(d / "cli_a" / "checkpoints" / "ckpt_2", out / "checkpoints" / "ckpt_2")
        with pytest.raises(ValueError, match=r"written at pp=2"):
            grover_train.main(argv[:4] + ["--output_dir", str(out), "--seq_length", "33",
                                          "--batch_size", "4", "--device", "cpu"])


@pytest.mark.parametrize("what", ["layers", "microbatches", "world", "model_axis", "restore"])
def test_refusals_by_name(job, what):
    _refuse(what, job["dir"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4:])
