"""Multi-process data-parallel smoke test (counterpart of
merlot_tpu/tools/multiprocess_smoke.py).

N processes join one torch.distributed process group (NCCL, one card per
rank; gloo with ``--device cpu``), each reads a disjoint slice of the input
files, as the reference's per-host input_fn does (model/dataloader.py:
146-167), and they run one data-parallel train step of a tiny pretrain
model together (the gradients summed over the ranks, the contrastive
features gathered). Process 0 then checks the loss against a fresh
one-process run on the global batch, the ranks' batches concatenated in
rank order: ``|loss difference| < 1e-5``, and prints ``MULTIPROCESS SMOKE
OK``.

    python -m merlot_tpu_torch.tools.multiprocess_smoke --num-procs 2 [--device cpu]

The tool re-runs itself once per process (``--process-id``) and once more
for the one-process reference (``--mode single``), each with a time limit.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

TIMEOUT_S = 600
LOCAL_BATCH = 4
LOADER_CONFIG = {"num_chunks": 2, "image_size": [32, 32], "chunk_text_len": 8,
                 "num_chunks_in_group": 2, "image_shuffle_prob": 0.0,
                 "shuffle_chunks": False}


def _pick_free_port() -> int:
    """Bind-then-release an ephemeral port for the rendezvous (a fixed port
    collides when two runs share the host)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_config():
    """The JAX tool's tiny MerlotConfig: one layer per tower, width 32, fp32,
    no dropout."""
    from merlot_tpu_torch.models.config import MerlotConfig
    return MerlotConfig(
        hidden_size=32, vocab_size=50370, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64, image_size=(32, 32),
        patch_size=16, spatial_pool_size=1, use_bfloat16=False,
        num_vision_transformer_hidden_layers=1,
        num_lang_transformer_hidden_layers=1, num_chunks_in_group=2,
        hidden_dropout_prob=0.0, image_shuffle_prob=0.0)


def host_batch(workdir: str, process_id: int, num_procs: int) -> Dict[str, np.ndarray]:
    """The first batch of process ``process_id``'s loader over its slice of
    the files."""
    from merlot_tpu_torch.data.pretrain_loader import PretrainLoader
    files = sorted(glob.glob(os.path.join(workdir, "*.tfrecord")))
    if len(files) != 2 * num_procs:
        raise ValueError(f"expected {2 * num_procs} shards in {workdir}: {files}")
    loader = PretrainLoader(files, LOADER_CONFIG, batch_size=LOCAL_BATCH,
                            host_id=process_id, num_hosts=num_procs, num_threads=1,
                            shuffle_buffer=0, seed=0, repeat=False)
    return next(iter(loader))


def one_step(batch: Dict[str, np.ndarray], device, mesh=None) -> float:
    """The loss of one train step of the tiny model from seed 0."""
    import torch

    from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
    from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
    from merlot_tpu_torch.train.train_step import (init_train_state, make_train_step,
                                                   step_generator)
    model = MerlotPretrainModel(tiny_config(), device=device)
    optimizer = MerlotAdamW(AdamWConfig(learning_rate=1e-3, num_warmup_steps=1,
                                        num_train_steps=10))
    state = init_train_state(model, optimizer, seed=0)
    step = make_train_step(model, optimizer, device=device, mesh=mesh)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    metrics = step(model, state, batch, step_generator(0, 0, device))
    return float(metrics["loss"])


def worker(process_id: int, num_procs: int, workdir: str, port: int, device: str) -> None:
    from merlot_tpu_torch.parallel.mesh import init_multihost, leave, make_mesh
    os.environ["LOCAL_RANK"] = str(process_id)
    dev = init_multihost(init_method=f"tcp://127.0.0.1:{port}", world_size=num_procs,
                         rank=process_id, device=device)
    mesh = make_mesh()
    try:
        loss = one_step(host_batch(workdir, process_id, num_procs), dev, mesh)
    finally:
        leave(mesh)
    if process_id == 0:
        with open(os.path.join(workdir, "loss_multiproc.txt"), "w") as f:
            f.write(repr(loss))
    print(f"[proc {process_id}] backend {mesh.backend} world {mesh.data} device {dev} "
          f"loss={loss}", flush=True)


def single_process_reference(workdir: str, num_procs: int, device: str) -> float:
    """The same global batch in one process, without a process group."""
    import torch
    parts = [host_batch(workdir, pid, num_procs) for pid in range(num_procs)]
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    return one_step(batch, dev)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-procs", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--workdir", default="mp_smoke")
    ap.add_argument("--mode", choices=["multi", "single"], default="multi")
    ap.add_argument("--port", type=int, default=0,
                    help="rendezvous port (0: pick a free one)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (NCCL, one card per process) or 'cpu' (gloo)")
    args = ap.parse_args(argv)

    if args.process_id is not None:
        worker(args.process_id, args.num_procs, args.workdir, args.port, args.device)
        return
    if args.mode == "single":
        print(repr(single_process_reference(args.workdir, args.num_procs, args.device)))
        return

    os.makedirs(args.workdir, exist_ok=True)
    from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
    for i in range(2 * args.num_procs):
        write_synthetic_shard(os.path.join(args.workdir, f"train-{i:02d}.tfrecord"),
                              num_examples=2, num_chunks=2, img_hw=(32, 32), seed=i)

    port = args.port or _pick_free_port()
    me = [sys.executable, "-m", "merlot_tpu_torch.tools.multiprocess_smoke",
          "--num-procs", str(args.num_procs), "--workdir", args.workdir,
          "--device", args.device]
    procs = [subprocess.Popen(me + ["--process-id", str(pid), "--port", str(port)])
             for pid in range(args.num_procs)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise SystemExit(f"a process failed: exit codes {rcs}")
    with open(os.path.join(args.workdir, "loss_multiproc.txt")) as f:
        loss_mp = float(f.read())

    out = subprocess.run(me + ["--mode", "single"], capture_output=True, text=True,
                         timeout=TIMEOUT_S, check=True)
    loss_sp = float(out.stdout.strip().splitlines()[-1])
    diff = abs(loss_mp - loss_sp)
    print(f"multi-process loss={loss_mp} single-process loss={loss_sp} diff={diff:.2e}")
    if not diff < 1e-5:
        raise SystemExit(f"the losses differ by {diff:.2e}")
    print("MULTIPROCESS SMOKE OK")


if __name__ == "__main__":
    main()
