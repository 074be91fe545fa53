"""merlot_tpu_torch's tensor parallelism (the mesh's model axis) on gloo CPU
ranks, held against one process and against merlot_tpu at JAX's own TP test
sizes: MERLOT hidden 64, 4 heads, vocab 400, 2 layers per tower
(tests/test_collectives.py's CFG), Grover vocab 503, hidden 32, 4 heads, 2
layers (tests/test_grover.py's TP test).

  * every leaf of ``MerlotPretrainModel`` and ``GroverLM``: the port's cut
    axis is the one JAX's ``param_partition_spec`` names on the same flax
    path, and cutting then joining gives each leaf back bit for bit; the
    refusals (a model size that does not divide the heads, the vocabulary
    or the hidden columns; VCR and the other data-only entry points);
  * four ranks (this file run as a script, a time limit each), data 2 x
    model 2 with ZeRO-1: two Trainer steps equal one process on the
    concatenated batch (dropout 0, as tests/test_torch_parallel.py), the
    checkpoint written there restores at (1, 1) and, in the two-rank job,
    at (1, 2); then the same ranks as one model group of 4 (1 head per
    rank): Grover's cached prefill and decode logits against JAX's
    single-device apply; then the pretraining CLI at (2, 2) with use_zero1;
  * two ranks, data 1 x model 2: one pretrain step with dropout on against
    one process (the same generator on every model rank: the same masks),
    and one with attention-prob dropout on as well (each rank's heads'
    share of the mask drawn over all heads),
    one step from JAX's weights and masking draws against JAX's
    ``make_train_step`` (test_torch_train_step.py's tolerances), Grover's
    logits against JAX (both cache layouts), ``Denoiser.run_batch`` at
    tp 2 against tp 1 at argmax sampling, and the pretraining CLI at
    model_parallelism 2 against one process;
  * ``denoise_server --tp 2`` under torchrun answers ``POST /api/ask`` as
    ``--tp 1`` does.

Tolerances: the port against one process, fp32, the same function with
the model group's sums in another order: loss and metrics rtol 1e-5, each
gradient within 1e-5 of its tensor's largest |grad| plus 1e-6 of the
largest of all (the key biases' are 0 analytically and hold only rounding
noise), ZeRO-1 parameters as tests/test_torch_parallel.py; Grover logits
2e-4 abs/rel as JAX's own TP test.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
for p in (str(REPO), str(REPO / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from merlot_tpu_torch.convert import (flax_axes, flax_layout, flax_path,  # noqa: E402
                                      load_flax_params)
from merlot_tpu_torch.models import grover as tg  # noqa: E402
from merlot_tpu_torch.models.config import MerlotConfig  # noqa: E402
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel  # noqa: E402
from merlot_tpu_torch.nn.layers import init_params  # noqa: E402
from merlot_tpu_torch.parallel import mesh as pm  # noqa: E402
from merlot_tpu_torch.train.harness import Trainer  # noqa: E402
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW  # noqa: E402
from merlot_tpu_torch.train.train_step import (init_train_state, make_train_step,  # noqa: E402
                                               step_generator)

TIMEOUT_S = 150
RTOL = 1e-5
REMAT_POLICIES = (None, "probs_dots")
MERLOT = dict(hidden_size=64, vocab_size=400, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, image_size=(32, 32), patch_size=16, spatial_pool_size=1,
              use_bfloat16=False, num_vision_transformer_hidden_layers=2,
              num_lang_transformer_hidden_layers=2, num_chunks_in_group=2,
              image_shuffle_prob=0.4)
GROVER = dict(vocab_size=503, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
# the server test's vocabulary is the tokenizer's
SERVER = dict(vocab_size=50270, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=128)
SERVE = dict(max_len=48, top_p=1e-6, max_ctx=32, batch_window_ms=0.0)
# AdamW with what the model axis touches: the global-norm clip, the
# per-scope norms, per-parameter weight decay; fp32 moments. Epsilon 1e-4:
# Adam's first step moves an element by lr * g / (|g| + epsilon), so where
# g is within rounding noise of 0 (a few elements of the position tables
# at this init) the noise of another sum order moves the parameter by lr *
# noise / epsilon: 2e-6 at epsilon 1e-6 (the parameters' bound is 1.4e-6),
# 100 times less here
OPT = dict(learning_rate=1e-3, num_train_steps=10, num_warmup_steps=0, weight_decay_rate=0.1,
           clip_norm=1.0, use_bfloat16_adam=False, verbose=True, epsilon=1e-4,
           param_overrides=((("bias", "gamma", "beta", "/ln"), {"weight_decay_rate": 0.0}),))
EXAMPLES = 4
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# inputs and the runs both sides make

def merlot_cfg(dropout=0.0, **kw):
    return MerlotConfig(**MERLOT, hidden_dropout_prob=dropout, **kw)


def pretrain_batch(seed=0):
    """4 examples x 2 chunks x 8 tokens with padded tails, 32x32 frames."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(100, 400, (EXAMPLES, 2, 8)).astype(np.int32)
    for b in range(EXAMPLES):
        for c in range(2):
            ids[b, c, rng.integers(3, 9):] = 0
    return {"images": rng.uniform(0, 1, (EXAMPLES * 2, 32, 32, 3)).astype(np.float32),
            "input_ids": ids,
            "shuffled_idx_img": np.tile(np.array([0, 1], np.int32), EXAMPLES),
            "video_src_ids": np.repeat(np.arange(EXAMPLES, dtype=np.int32),
                                       2).reshape(EXAMPLES, 2)}


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def rows(batch, mesh):
    return torch_batch(pm.shard_batch(batch, mesh) if mesh is not None else batch)


def seeded_step(mesh=None, dropout=0.1, **cfg_kw):
    """One step of the seeded model (the whole model's init, cut over
    ``mesh``'s model axis): (metrics, gradients, new parameters), whole."""
    model = MerlotPretrainModel(merlot_cfg(dropout, **cfg_kw))
    opt = MerlotAdamW(AdamWConfig(**OPT))
    state = init_train_state(model, opt, seed=0, tp=mesh)
    step = make_train_step(model, opt, device="cpu", mesh=mesh)
    metrics = step(model, state, torch_batch(pretrain_batch()), step_generator(0, 0))
    return (({k: float(v) for k, v in metrics.items()},) + whole(model, mesh))


def whole(model, mesh):
    """(gradients, parameters) by name, gathered over the model group."""
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach()
             for n, p in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}
    if mesh is not None:
        grads, params = mesh.gather_model(grads), mesh.gather_model(params)
    return grads, params


def jax_weights_step(d: Path, mesh=None):
    """One step from JAX's weights and masking draws (``jax_inputs``) with
    test_torch_train_step.py's optimizer: (metrics, gradients)."""
    from torch_port_helpers import OPT as STEP_OPT
    with np.load(d / "jax_params.npz") as z:
        flat = {k: z[k] for k in z.files}
    with np.load(d / "jax_draws.npz") as z:
        draws = {k: torch.from_numpy(z[k]) for k in z.files}
    model = pm.shard_params(MerlotPretrainModel(merlot_cfg()), mesh)
    load_flax_params(model, flat, mesh)
    opt = MerlotAdamW(AdamWConfig.from_config(STEP_OPT))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, device="cpu", mesh=mesh)
    metrics = step(model, state, torch_batch(pretrain_batch()), None, masking_draws=draws)
    return {k: float(v) for k, v in metrics.items()}, whole(model, mesh)[0]


def trainer(out, mesh=None, zero1=False):
    model = MerlotPretrainModel(merlot_cfg())
    return Trainer(model, MerlotAdamW(AdamWConfig(**OPT)), output_dir=str(out), log_every=1,
                   checkpoint_every=2, device="cpu", mesh=mesh, zero1=zero1)


def grover_logits(d: Path, mesh=None, fused=False):
    """The port's cached prefill logits of 6 tokens and one decode step
    from JAX's weights (``jax_grover``), cut over ``mesh``."""
    cfg = tg.GroverConfig(**GROVER, fused_qkv=fused, stacked_kv=fused)
    with np.load(d / "grover_params.npz") as z:
        flat = {k: z[k] for k in z.files}
    if fused:
        flat = tg.fuse_qkv_for_serving(flat)
    model = pm.shard_params(tg.GroverLM(cfg).eval(), mesh)
    load_flax_params(model, flat, mesh)
    ids = torch.from_numpy(np.load(d / "grover_ids.npy")).long()
    with torch.no_grad():
        cache = model.empty_cache(2, 16)
        prefill, cache = model(ids, cache=cache, position_offset=0)
        decode, _ = model(ids[:, :1], cache=cache, position_offset=ids.shape[1])
    return prefill.numpy(), decode.numpy()


def serve_ctxs():
    rng = np.random.default_rng(0)
    return [list(rng.integers(10, 50000, n)) for n in (11, 7, 20)]


# ----------------------------------------------------------------------
# the ranks

def _rank_main(world: int, rank: int, port: int, d: Path, cli_port: int) -> None:
    torch.set_num_threads(1)
    pm.init_multihost(init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                      device="cpu")
    chief = rank == 0
    if world == 4:
        mesh = pm.make_mesh(data=2, model=2)
        t = trainer(d / "z1_tp", mesh, zero1=True)
        t.run(t.init_state(), (rows(b, mesh) for b in (pretrain_batch(s) for s in (1, 2))),
              num_steps=2)
        mesh4 = pm.make_mesh(data=1, model=4)
        assert (mesh4.model_rank, mesh4.rank) == (rank, 0)
        if chief:
            np.savez(d / "grover_tp4.npz", *grover_logits(d, mesh4))
        else:
            grover_logits(d, mesh4)
        name = "cli_z1_tp"
    else:
        mesh = pm.make_mesh(model=2)
        out = {"step": seeded_step(mesh), "jax_step": jax_weights_step(d, mesh),
               # attention-prob dropout: each rank's heads' share of one mask
               "step_prob_dropout": seeded_step(mesh, attention_probs_dropout_prob=0.1),
               # per-layer remat: the recompute replays the model axis's
               # collectives and the dropout masks
               "remat_steps": {p: seeded_step(mesh, remat=True, remat_policy=p)
                               for p in REMAT_POLICIES},
               "grover": grover_logits(d, mesh), "grover_fused": grover_logits(d, mesh, True)}
        from merlot_tpu_torch.tools.denoise_server import Denoiser
        den = Denoiser(str(d / "server.json"), None, tp=2, device="cpu", mesh=mesh, **SERVE)
        if chief:
            out["run_batch"] = den.run_batch(serve_ctxs(), den.tok.end_article)
            den.stop()
        else:
            den.follow()
        # the (2, 2) ZeRO-1 checkpoint restored at (1, 2)
        t = trainer(d / "restore_tp2", mesh)
        out["restored_step"] = t.init_state()["step"]
        out["restored"] = mesh.gather_model({n: p.detach()
                                             for n, p in t.model.named_parameters()})
        if chief:
            torch.save(out, d / "tp2.pt")
        name = "cli_tp"
    pm.leave(mesh)
    # the CLI as torchrun starts it: a group of its own from the environment
    from merlot_tpu_torch.train import pretrain
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(cli_port))
    pretrain.main([str(d / f"{name}.yaml"), "--device", "cpu"])


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
    ports = [str(_free_port()) for _ in range(2)]
    procs = []
    for r in range(world):
        with open(d / f"rank{world}_{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(world), str(r),
                 ports[0], str(d), ports[1]], env=_env(), stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def _wait(procs, world: int, d: Path):
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
            f"rank {r} exited {p.returncode}:\n{(d / f'rank{world}_{r}.log').read_text()[-4000:]}"


# ----------------------------------------------------------------------
# the references: JAX's and one process's

def jax_grover(d: Path) -> None:
    """JAX's tiny Grover (the TP test's width): weights, ids, and its
    single-device cached prefill and decode logits."""
    import jax
    import jax.numpy as jnp
    from merlot_tpu.models import grover as jg
    from torch_port_helpers import flat_params
    model = jg.GroverLM(jg.GroverConfig(**GROVER))
    ids = np.random.default_rng(0).integers(1, 500, (2, 6)).astype(np.int32)
    variables = jax.jit(lambda i: model.init(jax.random.PRNGKey(0), i))(jnp.asarray(ids))
    step = jax.jit(lambda v, i, c, o: model.apply(v, i, cache=c, position_offset=o),
                   static_argnums=3)
    prefill, cache = step(variables, jnp.asarray(ids), model.empty_cache(2, 16), 0)
    decode, _ = step(variables, jnp.asarray(ids[:, :1]), cache, ids.shape[1])
    np.savez(d / "grover_params.npz", **flat_params(variables["params"]))
    np.save(d / "grover_ids.npy", ids)
    np.savez(d / "grover_jax.npz", np.asarray(prefill), np.asarray(decode))


def jax_inputs(d: Path):
    """JAX's tiny pretrain model, its masking draws for ``pretrain_batch``
    (written for the ranks); returns a function that runs JAX's
    ``make_train_step`` and ``jax.grad`` on them: (metrics, grads by flax
    path)."""
    import jax
    import jax.numpy as jnp
    from merlot_tpu.models.config import MerlotConfig as JaxConfig
    from merlot_tpu.models.pretrain import MerlotPretrainModel as JaxPretrain
    from merlot_tpu.train.optimizer import AdamWConfig as JaxOptConfig
    from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
    from merlot_tpu.train.train_step import make_train_step as jax_make_train_step
    from torch_port_helpers import OPT as STEP_OPT
    from torch_port_helpers import flat_params, pretrain_masking_draws
    cfg = JaxConfig(**MERLOT, hidden_dropout_prob=0.0)
    batch = {k: jnp.asarray(v) for k, v in pretrain_batch().items()}
    jm = JaxPretrain(cfg)
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        b, deterministic=True))(batch)
    root = jax.random.PRNGKey(3)
    k_mask, _ = jax.random.split(jax.random.fold_in(root, 0))
    draws = pretrain_masking_draws(jm, variables, k_mask, cfg, batch)
    np.savez(d / "jax_params.npz", **flat_params(variables["params"]))
    np.savez(d / "jax_draws.npz", **{k: v.numpy() for k, v in draws.items()})

    def compute():
        params = variables["params"]

        def loss_fn(p):
            return jm.apply({"params": p}, batch, deterministic=False,
                            rngs={"masking": k_mask, "dropout": k_mask})[0]

        grads = jax.jit(jax.grad(loss_fn))(params)
        opt = JaxAdamW(JaxOptConfig.from_config(STEP_OPT))
        _, _, metrics = jax_make_train_step(jm, opt, donate=False)(
            params, opt.init(params), batch, root)
        return {k: float(v) for k, v in metrics.items()}, flat_params(grads)

    return compute


CLI_MODEL = """\
  hidden_size: 64
  intermediate_size: 128
  num_attention_heads: 4
  num_hidden_layers: 2
  num_vision_transformer_hidden_layers: 2
  num_lang_transformer_hidden_layers: 2
  use_bfloat16: false
  hidden_dropout_prob: {dropout}
"""


def cli_configs(d: Path) -> None:
    """The pretraining CLI's tiny YAML (tests/test_torch_harness.py's) in
    fp32 on two train shards, 2 steps, a checkpoint at 2: at model 2
    (dropout on) and one process, and at data 2 x model 2 with use_zero1
    (dropout 0)."""
    from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
    from test_torch_harness import YAML
    shards = d / "cli_shards"
    shards.mkdir()
    for i in range(2):
        write_synthetic_shard(str(shards / f"train-{i}.tfrecord"), 4, 4, seed=i,
                              img_hw=(72, 128))
    for name, extra, dropout in (("cli_tp", "  model_parallelism: 2\n", 0.1),
                                 ("cli_one", "", 0.1),
                                 ("cli_z1_tp", "  model_parallelism: 2\n  use_zero1: true\n",
                                  0.0)):
        text = YAML.format(d=shards, out=d / name).replace(
            "val-*.tfrecord", "none-*.tfrecord").replace(
            "num_train_steps: 4", "num_train_steps: 2").replace(
            "device:\n", "device:\n" + extra).replace(
            "use_bfloat16_adam: true", "use_bfloat16_adam: false")
        start = text.index("  hidden_size:")
        end = text.index("  attention_softmax_fp32:")
        text = text[:start] + CLI_MODEL.format(dropout=dropout) + text[end:]
        (d / f"{name}.yaml").write_text(text)


def _jsonl(path):
    """The logged train steps (rows with a loss) by step."""
    return {r["step"]: r for r in map(json.loads, open(path)) if "loss" in r}


def _close(got, want, name, rtol=RTOL, atol=0.0):
    """Within ``rtol`` of the tensor's largest |value|, plus ``atol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rtol * scale + atol + 1e-12, f"{name}: {err} > {rtol} x {scale} + {atol}"


def _grads_close(got, want, rtol=RTOL):
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    assert set(got) == set(want)
    for n in want:
        _close(got[n], want[n], n, rtol=rtol, atol=floor)


def _ckpt_params(path: Path):
    with np.load(path / "params.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank job (data 2 x model 2, then model 4) and its references."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    jax_grover(d)
    (d / "server.json").write_text(json.dumps(SERVER))
    cli_configs(d)
    procs = _launch(4, d)
    try:  # while the ranks run: JAX's inputs and the one-process runs
        out = {"dir": d, "jax": jax_inputs(d)}
        t = trainer(d / "z1_one")
        t.run(t.init_state(), (rows(b, None) for b in (pretrain_batch(s) for s in (1, 2))),
              num_steps=2)
    finally:
        _wait(procs, 4, d)
    shutil.copytree(d / "z1_tp" / "checkpoints", d / "restore_one" / "checkpoints")
    shutil.copytree(d / "z1_tp" / "checkpoints", d / "restore_tp2" / "checkpoints")
    t = trainer(d / "restore_one")
    out["restored_step"] = t.init_state()["step"]
    out["restored"] = {n: p.detach() for n, p in t.model.named_parameters()}
    return out


@pytest.fixture(scope="module")
def two(four):
    """The 2-rank job (data 1 x model 2) and its references."""
    from merlot_tpu_torch.tools.denoise_server import Denoiser
    from merlot_tpu_torch.train import pretrain
    d = four["dir"]
    procs = _launch(2, d)
    try:
        out = {"step": seeded_step(), "jax_step": jax_weights_step(d),
               "step_prob_dropout": seeded_step(attention_probs_dropout_prob=0.1),
               "jax": four["jax"]()}
        den = Denoiser(str(d / "server.json"), None, tp=1, device="cpu", **SERVE)
        out["run_batch"] = den.run_batch(serve_ctxs(), den.tok.end_article)
        pretrain.main([str(d / "cli_one.yaml"), "--device", "cpu"])
    finally:
        _wait(procs, 2, d)
    out["tp"] = torch.load(d / "tp2.pt", weights_only=False)
    return out


# ----------------------------------------------------------------------
# the layout against JAX's rules

def _trees():
    merlot = MerlotPretrainModel(merlot_cfg())
    grover = tg.GroverLM(tg.GroverConfig(**GROVER))
    fused = tg.GroverLM(tg.GroverConfig(**GROVER, fused_qkv=True, stacked_kv=True))
    return {"merlot": merlot, "grover": grover, "grover_fused": fused}


@pytest.mark.parametrize("which", ["merlot", "grover"])
def test_cut_axis_is_jax_param_partition_spec(which):
    from merlot_tpu.parallel.mesh import param_partition_spec as jax_spec
    model = _trees()[which]
    cut = 0
    for name, p in model.named_parameters():
        path = flax_path(name)
        fshape = tuple(p.shape[a] for a in flax_axes(name, p.dim()))
        spec = tuple(jax_spec(path, np.zeros(fshape, np.float32)))
        want = (flax_axes(name, p.dim())[spec.index("model")]
                if "model" in spec else None)
        got = pm.tp_layout(name, p.dim())
        assert (got and got[0]) == want and (got is None or got[1] == 1), (path, got, spec)
        cut += got is not None
    assert cut == {"merlot": 41, "grover": 20}[which]


@pytest.mark.parametrize("which", ["merlot", "grover", "grover_fused"])
@pytest.mark.parametrize("model", [2, 4])
def test_cut_then_join_is_bit_for_bit(which, model):
    net = _trees()[which]
    init_params(net, torch.Generator().manual_seed(0))
    for name, p in net.named_parameters():
        layout = pm.tp_layout(name, p.dim())
        if layout is None or p.shape[layout[0]] % (layout[1] * model):
            continue  # replicated, or a vocabulary that this size does not split
        pieces = [pm.tp_cut(p.data, layout, model, r) for r in range(model)]
        assert all(t.shape[layout[0]] * model == p.shape[layout[0]] for t in pieces)
        assert torch.equal(pm.tp_join(pieces, layout), p.data), name


def test_fused_qkv_slice_is_the_ranks_q_k_v():
    """A fused qkv leaf is cut in three blocks: rank r holds q_r | k_r | v_r,
    the columns of its own query, key and value slices."""
    flat = {}
    for i, k in enumerate(("query", "key", "value")):
        flat[f"layer00/{k}/kernel"] = np.arange(32 * 32, dtype=np.float32).reshape(32, 32) + i
        flat[f"layer00/{k}/bias"] = np.zeros(32, np.float32)
    fused = tg.fuse_qkv_for_serving(flat)["layer00/qkv/kernel"].T
    layout = pm.tp_layout("layer00.qkv.weight", 2)
    assert layout == (0, 3)
    got = pm.tp_cut(torch.from_numpy(fused.copy()), layout, 2, 1)
    want = np.concatenate([flat[f"layer00/{k}/kernel"].T[16:] for k in
                           ("query", "key", "value")])
    np.testing.assert_array_equal(got.numpy(), want)


def _fake_mesh(model):
    """A mesh's place without process groups: enough to cut."""
    return pm.Mesh(data=1, rank=0, backend="gloo", model=model, model_rank=0)


@pytest.mark.parametrize("what", ["heads", "vocab", "hidden", "grover_heads"])
def test_model_size_that_does_not_divide_raises(what):
    if what == "grover_heads":
        net, model = tg.GroverLM(tg.GroverConfig(**GROVER)), 8
    else:
        kw = {"heads": dict(num_attention_heads=2, hidden_size=64),
              "vocab": dict(vocab_size=402),
              "hidden": dict(intermediate_size=130)}[what]
        net, model = MerlotPretrainModel(MerlotConfig(**dict(MERLOT, **kw))), 4
    before = {n: p.shape for n, p in net.named_parameters()}
    with pytest.raises(ValueError, match="tensor parallelism"):
        pm.shard_params(net, _fake_mesh(model))
    assert {n: p.shape for n, p in net.named_parameters()} == before  # nothing cut


def test_a_module_is_cut_once():
    net = pm.shard_params(tg.GroverLM(tg.GroverConfig(**GROVER)), _fake_mesh(2))
    with pytest.raises(ValueError, match="already cut"):
        pm.shard_params(net, _fake_mesh(2))


def test_data_only_entry_points_refuse_a_model_axis(tmp_path):
    from merlot_tpu_torch.downstream.sort_story import get_zero_shot_logits
    from merlot_tpu_torch.downstream.vcr import train as vcr_train
    from merlot_tpu_torch.downstream.vcr import validate as vcr_validate
    from test_torch_vcr import _yaml as vcr_yaml
    path = tmp_path / "vcr.yaml"
    path.write_text(vcr_yaml(tmp_path, tmp_path / "out", tmp_path / "init").replace(
        "device:\n", "device:\n  model_parallelism: 2\n"))
    for main, where in ((vcr_train.main, "vcr/train.py:42"),
                        (vcr_validate.main, "vcr/validate.py"),
                        (get_zero_shot_logits.main, "sort_story/zero_shot.py")):
        with pytest.raises(NotImplementedError, match=f"runs at model=1.*{where}"):
            main([str(path), "--device", "cpu"])


# ----------------------------------------------------------------------
# four ranks: data 2 x model 2, then one model group of 4

def test_zero1_steps_at_data_2_model_2_equal_one_process(four):
    d = four["dir"]
    got = _ckpt_params(d / "z1_tp" / "checkpoints" / "ckpt_2")
    want = _ckpt_params(d / "z1_one" / "checkpoints" / "ckpt_2")
    floor = 1e-6 * max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k, atol=floor)
    with np.load(d / "z1_tp" / "checkpoints" / "ckpt_2" / "opt_state.npz") as z, \
            np.load(d / "z1_one" / "checkpoints" / "ckpt_2" / "opt_state.npz") as w:
        assert set(z.files) == set(w.files)
        for k in w.files:
            _close(z[k], w[k], k,
                   atol=1e-6 * max(float(np.abs(w[j]).max()) for j in w.files
                                   if j[0] == k[0]))


@pytest.mark.parametrize("where", ["one process", "model 2"])
def test_checkpoint_at_data_2_model_2_restores(four, two, where):
    """Whole leaves: restored at (1, 1) and at (1, 2), bit for bit."""
    d = four["dir"]
    want = _ckpt_params(d / "z1_tp" / "checkpoints" / "ckpt_2")
    step, got = ((four["restored_step"], four["restored"]) if where == "one process"
                 else (two["tp"]["restored_step"], two["tp"]["restored"]))
    assert step == 2
    assert {flax_path(n) for n in got} == set(want)
    for n, t in got.items():
        np.testing.assert_array_equal(flax_layout(n, t.numpy()), want[flax_path(n)])


@pytest.mark.parametrize("model", [2, 4])
def test_grover_cached_logits_match_jax(four, two, model):
    d = four["dir"]
    with np.load(d / "grover_jax.npz") as z:
        want = (z["arr_0"], z["arr_1"])
    if model == 4:
        with np.load(d / "grover_tp4.npz") as z:
            got = (z["arr_0"], z["arr_1"])
    else:
        got = two["tp"]["grover"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_pretrain_cli_at_data_2_model_2_with_zero1(four):
    d = four["dir"]
    logged = _jsonl(d / "cli_z1_tp" / "train_metrics.jsonl")
    assert sorted(logged) == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in logged.values())
    assert sorted(os.listdir(d / "cli_z1_tp" / "checkpoints")) == ["ckpt_2"]
    ckpt = _ckpt_params(d / "cli_z1_tp" / "checkpoints" / "ckpt_2")
    assert ckpt["merlot/word_embeddings"].shape == (50370, 64)  # whole leaves


# ----------------------------------------------------------------------
# two ranks: data 1 x model 2

def test_step_with_dropout_equals_one_process(two):
    (m_got, g_got, _), (m_want, g_want, _) = two["tp"]["step"], two["step"]
    assert set(m_got) == set(m_want)
    for k in m_want:
        np.testing.assert_allclose(m_got[k], m_want[k], rtol=RTOL, atol=1e-7, err_msg=k)
    _grads_close({n: g.numpy() for n, g in g_got.items()},
                 {n: g.numpy() for n, g in g_want.items()})


def test_step_with_attention_prob_dropout_equals_one_process(two):
    """Hidden and attention-prob dropout on: each rank keeps its heads'
    share of the keep mask drawn over all heads, so the step equals one
    process's (ranks that each drew a mask over their own heads would drop
    heads 0-1's pattern on heads 2-3 too)."""
    (m_got, g_got, _) = two["tp"]["step_prob_dropout"]
    (m_want, g_want, _) = two["step_prob_dropout"]
    assert m_want["loss"] != two["step"][0]["loss"]        # the dropout acts
    for k in m_want:
        np.testing.assert_allclose(m_got[k], m_want[k], rtol=RTOL, atol=1e-7, err_msg=k)
    _grads_close({n: g.numpy() for n, g in g_got.items()},
                 {n: g.numpy() for n, g in g_want.items()})


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_step_at_model_2_equals_one_process(two, policy):
    """Per-layer remat at model=2 with dropout on: the step equals the same
    ranks' step without remat bit for bit (every rank recomputes with the
    same collectives in the same order and replays the same masks), and so
    one process within the bounds of the step without remat."""
    got, tp, one = two["tp"]["remat_steps"][policy], two["tp"]["step"], two["step"]
    assert got[0] == tp[0]
    for a, b in zip(got[1:], tp[1:]):
        assert set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in b)
    for k in one[0]:
        np.testing.assert_allclose(got[0][k], one[0][k], rtol=RTOL, atol=1e-7, err_msg=k)
    _grads_close({n: g.numpy() for n, g in got[1].items()},
                 {n: g.numpy() for n, g in one[1].items()})


def test_step_matches_jax(two):
    """From JAX's weights and masking draws, dropout 0: the loss, every
    metric and the gathered gradients against JAX's ``make_train_step``
    and ``jax.grad``, as tests/test_torch_train_step.py holds one process;
    and against one process of the port."""
    from torch_port_helpers import close_to_scale, flax_layout
    jmetrics, jgrads = two["jax"]
    metrics, grads = two["tp"]["jax_step"]
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=1e-5)
    for k in sorted(jmetrics):
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=2e-4, atol=1e-6, err_msg=k)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in grads.items():
        close_to_scale(flax_layout(name, g.numpy()), jgrads[flax_path(name)], 2e-4, name,
                       atol=floor)
    one_metrics, one_grads = two["jax_step"]
    for k in one_metrics:
        np.testing.assert_allclose(metrics[k], one_metrics[k], rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    _grads_close({n: g.numpy() for n, g in grads.items()},
                 {n: g.numpy() for n, g in one_grads.items()})


def test_grover_fused_stacked_cache_matches_jax(four, two):
    """Each rank's fused q | k | v and stacked cache of its own heads."""
    with np.load(four["dir"] / "grover_jax.npz") as z:
        want = (z["arr_0"], z["arr_1"])
    for g, w in zip(two["tp"]["grover_fused"], want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_denoiser_run_batch_at_tp_2_equals_tp_1(two):
    got, want = two["tp"]["run_batch"], two["run_batch"]
    assert len(got) == len(want) == 3
    for (tt, tp), (wt, wp) in zip(got, want):
        np.testing.assert_array_equal(tt, wt)
        np.testing.assert_allclose(tp, wp, atol=1e-5)


def test_pretrain_cli_at_model_2_equals_one_process(two, four):
    d = four["dir"]
    got, want = (_jsonl(d / n / "train_metrics.jsonl") for n in ("cli_tp", "cli_one"))
    assert sorted(got) == sorted(want) == [1, 2]
    for step in want:
        for k, v in want[step].items():
            if k.startswith("perf/") or k == "step":  # the host's clock
                continue
            np.testing.assert_allclose(got[step][k], v, rtol=RTOL, atol=1e-7,
                                       err_msg=f"{step} {k}")
    p_got, p_want = (_ckpt_params(d / n / "checkpoints" / "ckpt_2")
                     for n in ("cli_tp", "cli_one"))
    floor = 1e-6 * max(float(np.abs(v).max()) for v in p_want.values())
    for k in p_want:
        _close(p_got[k], p_want[k], k, atol=floor)


# ----------------------------------------------------------------------
# the server under torchrun

def _post(port: int, text: str) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/ask",
                                 data=json.dumps({"noisyasr": text}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_denoise_server_tp_2_under_torchrun_answers_as_tp_1(tmp_path):
    from merlot_tpu_torch.tools.denoise_server import Denoiser
    cfg = tmp_path / "server.json"
    cfg.write_text(json.dumps(SERVER))
    port = _free_port()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "merlot_tpu_torch.tools.denoise_server", "--config", str(cfg),
           "--tp", "2", "--device", "cpu", "--port", str(port), "--top_p", "1e-6",
           "--max_len", "48", "--batch_window", "0", "--log", str(tmp_path / "log.jsonl")]
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(cmd, env=_env(), stdout=log, stderr=subprocess.STDOUT, cwd=tmp_path)
    text = "so today were gonna make pasta with a to mate sauce"
    try:
        want = Denoiser(str(cfg), None, tp=1, device="cpu",
                        **dict(SERVE, max_ctx=1280)).denoise(text)
        deadline = time.time() + TIMEOUT_S
        while "READY FOR GENERATION" not in (tmp_path / "server.log").read_text():
            assert proc.poll() is None and time.time() < deadline, \
                (tmp_path / "server.log").read_text()[-4000:]
            time.sleep(0.5)
        got = _post(port, text)
        assert got["gen"] == want[0]
        assert got["ppl"] == pytest.approx(want[1], rel=1e-4)
    finally:
        # torchrun passes SIGTERM on to both ranks (and itself exits 1):
        # rank 0 drains, then releases rank 1
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "server.log").read_text()
    assert "drained, exiting" in text and "Traceback" not in text.split("drained")[0], \
        text[-4000:]
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 1


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
               int(sys.argv[5]))
