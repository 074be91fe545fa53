"""Pretraining entry point (counterpart of merlot_tpu/train/pretrain.py):

    python -m merlot_tpu_torch.train.pretrain config.yaml [--device cpu]
    torchrun --nproc_per_node N -m merlot_tpu_torch.train.pretrain config.yaml

The model/train.py analogue (reference: model/train.py:9-26): load the YAML
NeatConfig, build the pretrain model and AdamW from its sections, stream
tfrecords through the async host loader onto the card, and run the train
step for optimizer.num_train_steps steps, checkpointing every
device.iterations_per_loop steps; then a held-out evaluation when
data.val_file matches files. The run is on the CUDA device unless
``--device cpu`` asks for the CPU.

A run resumed from a checkpoint at step k starts the data stream at its
k-th batch (``PretrainLoader.batches(k)``, which passes over the first k
without parsing them). It is the same stream for the same files, config and
seed, so the resumed run sees the batches an uninterrupted run would have
seen (the JAX package restarts the stream).

Launched as N ranks (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT), the CLI joins the process group (NCCL, one card per rank;
gloo with ``--device cpu``) and lays the ranks out as the JAX CLI's mesh,
``make_mesh(data=N // M, model=M)`` with M = ``device.model_parallelism``:
  * the data axis: each data index's loader reads its own slice of the
    files (``host_id`` the data index, ``num_hosts`` the data size) at
    ``train_batch_size // (N // M)`` examples a batch, the global batch
    being the indices' batches in order; the M model ranks of one index
    read the same rows;
  * the model axis (tensor parallelism): the attention heads, the MLP's
    hidden columns and MERLOT's vocabulary are cut over the M ranks
    (``parallel.mesh.shard_params``), after the seeded init of the whole
    model. The JAX CLI cuts the parameters by these rules only with
    ``use_zero1`` (``merlot_tpu/train/harness.py``); without it its model
    axis holds replicas that compute the same function. Here they are cut
    whenever M > 1: the numbers are the same;
  * ``device.use_zero1`` splits the Adam moments of each model rank's
    slices over the data axis (ZeRO-1);
  * global rank 0 writes the metrics and checkpoints (whole leaves: a
    checkpoint restores at any other (data, model)).
The evaluation reads the whole validation stream on every rank and keeps
its data index's rows of each batch. Without those variables the run is
one process, as before (``use_zero1`` then has nothing to split, as at
data size 1 in JAX; ``model_parallelism > 1`` raises).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Sequence

from merlot_tpu_torch.core.config import NeatConfig
from merlot_tpu_torch.data.pretrain_loader import PretrainLoader, device_iterator
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.parallel.mesh import Mesh, join_from_env, leave, shard_batch
from merlot_tpu_torch.train.harness import Trainer
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import _device


def build_pretrain_setup(config: NeatConfig, device="cuda", mesh: Optional[Mesh] = None):
    """(model, optimizer, loader) from a NeatConfig; the loader is None
    when data.train_file matches no file. With ``mesh`` the loader is this
    data index's: its slice of the files, ``train_batch_size // data`` a
    batch. The model is whole: the Trainer's ``init_state`` cuts it over
    the mesh's model axis."""
    model = MerlotPretrainModel(MerlotConfig.from_dict(config.model), device=_device(device))
    optimizer = MerlotAdamW(AdamWConfig.from_config(config.optimizer))

    files = config.data.get("train_file_expanded") or []
    loader = None
    world, rank = (mesh.data, mesh.rank) if mesh is not None else (1, 0)
    if files:
        loader = PretrainLoader(
            files, config.merged_data_model(),
            batch_size=config.device["train_batch_size"] // world, is_training=True,
            host_id=rank, num_hosts=world,
            num_threads=config.data.get("num_threads", 8),
            shuffle_buffer=config.data.get("shuffle_buffer_size", 256))
    return model, optimizer, loader


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). Returns the
    trainer (its model holds the trained parameters), the optimizer state
    and the evaluation's means (empty without a validation set)."""
    ap = argparse.ArgumentParser(description="MERLOT pretraining")
    ap.add_argument("config_file", help="Path to the config.yaml")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    config = NeatConfig.from_yaml(args.config_file)
    device, mesh = join_from_env(args.device, config.device.get("model_parallelism", 1))
    try:
        return _run(config, device, mesh)
    finally:
        leave(mesh)


def _run(config: NeatConfig, device, mesh: Optional[Mesh]) -> Dict[str, Any]:
    model, optimizer, loader = build_pretrain_setup(config, device, mesh)
    if loader is None:
        raise ValueError("data.train_file matched no files")

    trainer = Trainer(
        model, optimizer, output_dir=config.device["output_dir"],
        log_every=config.device.get("log_every", 50),
        checkpoint_every=config.device.get("iterations_per_loop", 1000),
        device=device, mesh=mesh, zero1=config.device.get("use_zero1", False))
    feed = dict(images_bf16=config.model.get("use_bfloat16", True),
                # data.infeed_u8: 1 B/px copies, dequantized in the backbone
                images_u8=config.data.get("infeed_u8", False))
    opt_state = trainer.init_state(init_checkpoint=config.model.get("init_checkpoint"))
    # a resumed run continues the data stream where the checkpoint left it
    host = loader.batches(int(opt_state["step"]))
    opt_state = trainer.run(opt_state, device_iterator(host, device, **feed),
                            num_steps=config.optimizer["num_train_steps"])

    means: Dict[str, float] = {}
    val_files = config.data.get("val_file_expanded") or []
    if val_files:
        vbs = config.device.get("val_batch_size", 8)
        val_loader = PretrainLoader(
            val_files, config.merged_data_model(), batch_size=vbs,
            is_training=False, num_threads=config.data.get("num_threads", 8),
            shuffle_buffer=0, repeat=False)
        eval_samples = config.validate.get("eval_samples")
        val = iter(val_loader)
        if mesh is not None:  # every rank reads the stream and keeps its rows
            val = (shard_batch(b, mesh) for b in val)
        means = trainer.evaluate(
            device_iterator(val, device, **feed),
            max_batches=(eval_samples // vbs) if eval_samples else None,
            log_step=int(opt_state["step"]))
        if trainer.is_chief:
            print("eval:", {k: round(v, 4) for k, v in sorted(means.items())})
    return {"trainer": trainer, "opt_state": opt_state, "eval": means}


if __name__ == "__main__":
    main()
