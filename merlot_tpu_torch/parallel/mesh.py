"""Process groups, data parallelism and ZeRO-1 (counterpart of
merlot_tpu/parallel/mesh.py).

The JAX package builds a ``(data, model)`` device mesh and lets GSPMD
partition one global program over it. Here a rank is a process with one
device, launched by ``torchrun`` or ``tools/multiprocess_smoke.py``:

  * ``init_multihost`` joins the process group from ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` (or
    explicit arguments): NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU;
  * ``make_mesh(data, model=1)`` returns the data group as a ``Mesh``;
    tensor parallelism (``model > 1``) is not here yet;
  * the batch of a step is the concatenation of the ranks' batches in rank
    order (``local_rows`` cuts a global batch to this rank's rows), and
    every loss is written over that global batch (``models/pretrain.py``):
    each rank computes its share and the shares' gradients are summed
    (``all_reduce_``), which is what GSPMD's psum computes;
  * ZeRO-1: ``zero1_partition_spec`` decides, as the JAX package does, on
    which axis of a leaf's flax layout the Adam moments are split over the
    data ranks; ``zero1_axis`` maps it to this package's layout. The
    optimizer keeps only this rank's slice of such a leaf's moments,
    updates that slice of the parameter and gathers the parameter
    (``gather_shards``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from merlot_tpu_torch.convert import flax_axes, flax_path

# gradient all-reduce and parameter all-gather buckets, in elements
BUCKET_ELEMENTS = 1 << 26


def init_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                   rank: Optional[int] = None, device="cuda") -> torch.device:
    """Join the process group and return this rank's device.

    Without arguments the group comes from the environment torchrun sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). On CUDA each rank owns ``cuda:LOCAL_RANK`` and the
    backend is NCCL; a rank whose ``LOCAL_RANK`` has no card raises. On the
    CPU (``device="cpu"``) the backend is gloo. Nothing falls back from one
    to the other."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0 if rank is None else rank))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank with LOCAL_RANK={local} has no CUDA device "
                               f"({torch.cuda.device_count()} visible); pass "
                               f"device='cpu' for gloo on the CPU")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev_type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    kw: Dict[str, Any] = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    if dev_type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def launched_distributed() -> bool:
    """True when the process was launched as a rank (torchrun's variables)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_from_env(device="cuda", model: int = 1) -> Tuple[torch.device, Optional["Mesh"]]:
    """What a CLI runs on: (this rank's device, its data mesh) when the
    process was launched as a rank, else (``device``, None), the one
    process of a run without torchrun. Refuses ``model > 1`` either way."""
    refuse_model_parallelism(model)
    if not launched_distributed():
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("asked for CUDA but no CUDA device is present "
                               "(pass device='cpu' to run on the CPU)")
        return torch.device(device), None
    dev = init_multihost(device=device)
    mesh = make_mesh()
    print(f"process group: backend {mesh.backend}, world {mesh.data}, rank {mesh.rank}, "
          f"device {dev}", flush=True)
    return dev, mesh


def leave(mesh: Optional["Mesh"]) -> None:
    """Destroy the process group a CLI joined (nothing without a mesh)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data ranks (the default process group): their number, this
    rank's index and the group's backend."""
    data: int
    rank: int
    backend: str

    # --- collectives -------------------------------------------------
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor (no gradient)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated on dim 0, in rank order, with a
        backward that sums each piece's gradient over the ranks into its
        owner."""
        return _GatherRows.apply(x, self)

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place, through flat buckets
        of at most BUCKET_ELEMENTS elements (one bucket per dtype run)."""
        for bucket in _buckets(list(tensors)):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def gather_shards(self, shards: Mapping[str, torch.Tensor],
                      axes: Mapping[str, int]) -> Dict[str, torch.Tensor]:
        """Whole leaves from this rank's slices: ``shards[n]`` is the
        slice of leaf n on axis ``axes[n]`` (``shard_leaf``), the same
        shape on every rank. One all-gather per bucket."""
        out: Dict[str, torch.Tensor] = {}
        names = list(shards)
        for bucket in _buckets([shards[n] for n in names], names):
            flat = torch.cat([shards[n].reshape(-1) for n in bucket])
            parts = [torch.empty_like(flat) for _ in range(self.data)]
            dist.all_gather(parts, flat)
            off = 0
            for n in bucket:
                t = shards[n]
                pieces = [p[off:off + t.numel()].view_as(t) for p in parts]
                out[n] = torch.cat(pieces, dim=axes[n])
                off += t.numel()
        return out

    def barrier(self) -> None:
        dist.barrier()

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj`` (picklable), in rank order."""
        out: List[Any] = [None] * self.data
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(mesh.data)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo = ctx.mesh.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def _buckets(tensors: List[torch.Tensor], keys: Optional[List[Any]] = None) -> List[list]:
    """Consecutive runs of one dtype and device, each at most
    BUCKET_ELEMENTS elements (a larger tensor is a bucket of its own)."""
    keys = tensors if keys is None else keys
    out: List[list] = []
    size, kind = 0, None
    for t, k in zip(tensors, keys):
        if not out or (t.dtype, t.device) != kind or size + t.numel() > BUCKET_ELEMENTS:
            out.append([])
            size, kind = 0, (t.dtype, t.device)
        out[-1].append(k)
        size += t.numel()
    return out


def refuse_model_parallelism(model: int) -> None:
    """Raise on a model axis > 1: tensor parallelism is not ported yet."""
    if model != 1:
        raise NotImplementedError(
            f"model_parallelism={model}: tensor parallelism is not ported yet (the "
            f"next item of ROADMAP Queue 1, M7b item 3); data parallelism and "
            f"use_zero1 run under torchrun")


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The data ranks of the initialised process group: all of them.
    Tensor parallelism (model > 1) is ROADMAP's next item."""
    refuse_model_parallelism(model)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    world = dist.get_world_size()
    data = world if data is None else data
    if data * model != world:
        raise ValueError(f"data {data} x model {model} != world size {world}")
    return Mesh(data=data, rank=dist.get_rank(), backend=dist.get_backend())


# ---------------------------------------------------------------------------
# Parameter partition rules: regex over the flax path, first match wins,
# default replicated; 2-D kernels in flax's [in, out]. The port has no
# tensor parallelism yet: the rules decide only which axes ZeRO-1 may use.
# ---------------------------------------------------------------------------
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # attention projections: the head dim
    (r"attention/(query|key|value)/kernel$", (None, "model")),
    (r"attention/(query|key|value)/bias$", ("model",)),
    (r"attention/qkv/kernel$", (None, "model")),
    (r"attention/qkv/bias$", ("model",)),
    (r"attention/out_proj/kernel$", ("model", None)),
    # MLP: the intermediate dim
    (r"mlp/intermediate/kernel$", (None, "model")),
    (r"mlp/intermediate/bias$", ("model",)),
    (r"mlp/output/kernel$", ("model", None)),
    # embeddings: the vocab dim
    (r"word_embeddings$", ("model", None)),
    (r"lm_output_bias$", ("model",)),
    # Grover's flat layerNN/{proj} paths
    (r"layer\d+/(query|key|value)/kernel$", (None, "model")),
    (r"layer\d+/(query|key|value)/bias$", ("model",)),
    (r"layer\d+/out_proj/kernel$", ("model", None)),
    (r"layer\d+/intermediate/kernel$", (None, "model")),
    (r"layer\d+/intermediate/bias$", ("model",)),
    (r"layer\d+/output/kernel$", ("model", None)),
)

Spec = Tuple[Optional[str], ...]


def _shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


def param_partition_spec(path: str, leaf: Any) -> Spec:
    """The tensor-parallel spec of the leaf at flax path ``path`` (flax
    layout): one entry per axis, () when replicated."""
    ndim = len(_shape(leaf))
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            if len(spec) == ndim:
                return tuple(spec)
            if len(spec) < ndim:  # a leading stacked-layers axis
                return (None,) * (ndim - len(spec)) + tuple(spec)
    return ()


def zero1_partition_spec(path: str, leaf: Any, data_size: int) -> Spec:
    """The leaf's tensor-parallel spec with ``"data"`` on its largest free
    axis divisible by ``data_size`` (the last such axis on a tie, as
    ``max`` over (size, axis) picks). An axis a rule names is not free even
    when the model axis has size 1. A leaf with no such axis keeps its
    spec: replicated over the data ranks."""
    shape = _shape(leaf)
    spec = list(param_partition_spec(path, leaf))
    spec += [None] * (len(shape) - len(spec))
    free = [(shape[i], i) for i in range(len(shape))
            if spec[i] is None and data_size > 1
            and shape[i] % data_size == 0 and shape[i] >= data_size]
    if free:
        _, axis = max(free)
        spec[axis] = "data"
    return tuple(spec)


def flax_shape(torch_name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The flax-layout shape of the parameter ``torch_name`` of ``shape``."""
    return tuple(shape[a] for a in flax_axes(torch_name, len(shape)))


@dataclasses.dataclass(frozen=True)
class _Shaped:
    shape: Tuple[int, ...]


def zero1_axis(torch_name: str, shape: Sequence[int], data_size: int) -> Optional[int]:
    """The axis (this package's layout) on which ZeRO-1 splits the moments
    of parameter ``torch_name``, or None when they stay whole."""
    spec = zero1_partition_spec(flax_path(torch_name),
                                _Shaped(flax_shape(torch_name, shape)), data_size)
    if "data" not in spec:
        return None
    return flax_axes(torch_name, len(shape))[spec.index("data")]


def zero1_axes(params: Mapping[str, torch.Tensor], data_size: int) -> Dict[str, int]:
    """{name: axis} of the parameters whose moments ZeRO-1 splits."""
    out = {}
    for n, p in params.items():
        ax = zero1_axis(n, tuple(p.shape), data_size)
        if ax is not None:
            out[n] = ax
    return out


def shard_leaf(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` on ``axis`` (a view)."""
    n = t.shape[axis] // mesh.data
    return t.narrow(axis, mesh.rank * n, n)


def local_rows(x, mesh: Mesh):
    """This rank's rows of a global batch array (dim 0 split evenly)."""
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.data} ranks")
    k = n // mesh.data
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch."""
    return {k: local_rows(v, mesh) for k, v in batch.items()}
