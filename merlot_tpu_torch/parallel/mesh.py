"""Process groups, data parallelism, ZeRO-1, tensor parallelism and the
pipeline's stage axis (counterpart of merlot_tpu/parallel/mesh.py and of
the mesh merlot_tpu/parallel/pipeline.py runs on).

The JAX package builds a ``(data, model)`` device mesh and lets GSPMD
partition one global program over it. Here a rank is a process with one
device, launched by ``torchrun`` or ``tools/multiprocess_smoke.py``:

  * ``init_multihost`` joins the process group from ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` (or
    explicit arguments): NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU;
  * ``make_mesh(data, model)`` lays the ranks out as JAX's grid,
    ``devices.reshape(data, model)``: rank ``d * model + m`` is model rank
    m of data index d, so the model ranks of one data index are
    contiguous. The ``Mesh`` holds this rank's data index (``rank``, of
    ``data``) and model index (``model_rank``, of ``model``) and a group
    for each axis;
  * the data axis: the batch of a step is the concatenation of the data
    indices' batches in order (``local_rows`` cuts a global batch to this
    index's rows), and every loss is written over that global batch
    (``models/pretrain.py``): each index computes its share and the
    shares' gradients are summed over the data group (``all_reduce_``),
    which is what GSPMD's psum computes;
  * ZeRO-1: ``zero1_partition_spec`` decides, as the JAX package does, on
    which axis of a leaf's flax layout the Adam moments are split over the
    data group (never an axis the model axis splits); ``zero1_axis`` maps
    it to this package's layout. The optimizer keeps only this rank's
    slice of such a leaf's moments, updates that slice of the parameter
    and gathers the parameter (``gather_shards``);
  * the model axis (tensor parallelism, Megatron's layout where JAX has
    GSPMD's): ``shard_params`` cuts every leaf that ``_PARAM_RULES`` shards
    to this model rank's slice (``tp_layout``) and hands the mesh to the
    modules that run a collective. The attention heads and the MLP's
    hidden columns are column-parallel, ``out_proj`` and ``mlp/output``
    row-parallel, MERLOT's word embeddings and LM bias vocab-parallel
    (``parallel/tensor_parallel.py``). Two autograd functions carry the
    collectives: ``copy_to_model`` (identity forward, a sum over the model
    group backward) where a replicated activation enters column-parallel
    products, and ``reduce_from_model`` (the sum forward, identity
    backward) where row-parallel partial sums leave them. Every
    activation outside those products is replicated over the model ranks
    of one data index, and each of those ranks draws the same dropout
    masks from the same generator state.

  * the stage axis (pipeline parallelism, ``parallel/pipeline.py``):
    ``make_mesh(data, stage=S)`` lays the ranks out as JAX's pipeline tests
    do, ``devices.reshape(data, stage)``: rank ``d * S + s`` is stage s of
    data index d. The ``Mesh`` holds the stage index (``stage_rank``), the
    stage group (the S stages of one data index) and the global ranks of
    the previous and next stages. No JAX path composes a stage axis with a
    model axis (``pipeline_apply`` takes ``axis`` and ``data_axis`` only),
    so ``make_mesh`` refuses both above 1.

A collective over a group of one rank is skipped when the mesh has a model
or a stage axis (it would copy); at model 1 and stage 1 the data
collectives run on the default group as they always have.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from merlot_tpu_torch.convert import flax_axes, flax_path, stage_leaf

# gradient all-reduce and parameter all-gather buckets, in elements
BUCKET_ELEMENTS = 1 << 26


def init_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                   rank: Optional[int] = None, device="cuda",
                   backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Without arguments the group comes from the environment torchrun sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). On CUDA each rank owns ``cuda:LOCAL_RANK`` and the
    backend is NCCL; a rank whose ``LOCAL_RANK`` has no card raises. On the
    CPU (``device="cpu"``) the backend is gloo. ``backend="gloo"`` on CUDA
    is asked for by name: gloo takes CUDA tensors through the host, and
    lets ranks share a card (NCCL refuses two ranks on one device).
    Nothing falls back from one backend to the other."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0 if rank is None else rank))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"rank with LOCAL_RANK={local} has no CUDA device "
                               f"({torch.cuda.device_count()} visible); pass "
                               f"device='cpu' for gloo on the CPU")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev_type == "cpu":
        dev, backend = torch.device("cpu"), backend or "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    if backend not in ("nccl", "gloo") or (dev_type == "cpu" and backend != "gloo"):
        raise ValueError(f"backend {backend!r} on {dev_type}")
    kw: Dict[str, Any] = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def launched_distributed() -> bool:
    """True when the process was launched as a rank (torchrun's variables)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_from_env(device="cuda", model: int = 1, stage: int = 1,
                  backend: Optional[str] = None) -> Tuple[torch.device, Optional["Mesh"]]:
    """What a CLI runs on: (this rank's device, its mesh of ``model``
    model ranks or ``stage`` pipeline stages per data index) when the
    process was launched as a rank, else (``device``, None), the one
    process of a run without torchrun, which has neither axis (``model >
    1`` or ``stage > 1`` raises). ``backend`` as ``init_multihost`` takes it."""
    if not launched_distributed():
        if model != 1:
            raise ValueError(
                f"model_parallelism={model}: tensor parallelism runs one process per "
                f"device; launch {model} ranks per data index under torchrun "
                f"(torchrun --nproc_per_node N ...)")
        if stage != 1:
            raise ValueError(
                f"pipeline parallelism over {stage} stages runs one process per stage; "
                f"launch {stage} ranks under torchrun (torchrun --nproc_per_node {stage} ...)")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("asked for CUDA but no CUDA device is present "
                               "(pass device='cpu' to run on the CPU)")
        return torch.device(device), None
    dev = init_multihost(device=device, backend=backend)
    mesh = make_mesh(model=model, stage=stage)
    print(f"process group: backend {mesh.backend}, world {dist.get_world_size()}, "
          f"rank {dist.get_rank()}, device {dev}, data {mesh.data} x model {mesh.model} "
          f"x stage {mesh.stage}", flush=True)
    return dev, mesh


def refuse_model_axis(model: int, entry: str, where: str) -> None:
    """Raise on ``model_parallelism > 1`` for an entry point whose JAX twin
    has no model axis (it builds ``make_mesh(data=n, model=1)`` at
    ``where`` whatever the config says)."""
    if model != 1:
        raise NotImplementedError(
            f"model_parallelism={model}: JAX's {entry} runs at model=1 ({where} builds "
            f"make_mesh(data=n, model=1) whatever the config says), so this one has no "
            f"tensor parallelism either; the pretraining CLI and the Grover server take "
            f"a model axis")


def leave(mesh: Optional["Mesh"]) -> None:
    """Destroy the process group a CLI joined (nothing without a mesh)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) or (data, stage) grid: its
    data index ``rank`` of ``data``, model index ``model_rank`` of
    ``model`` and stage index ``stage_rank`` of ``stage``, the backend, and
    the group of each axis (None: the default group, which is the data
    group at model 1 and stage 1)."""
    data: int
    rank: int
    backend: str
    model: int = 1
    model_rank: int = 0
    stage: int = 1
    stage_rank: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    stage_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_chief(self) -> bool:
        """Global rank 0: the one that writes metrics and checkpoints."""
        return self.rank == 0 and self.model_rank == 0 and self.stage_rank == 0

    @property
    def _data_solo(self) -> bool:
        """A data group of one rank beside a model or a stage axis: nothing
        to sum."""
        return self.data == 1 and (self.model > 1 or self.stage > 1)

    # --- the stage axis ----------------------------------------------
    @property
    def is_first_stage(self) -> bool:
        return self.stage_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_rank == self.stage - 1

    @property
    def prev_rank(self) -> Optional[int]:
        """The global rank of the previous stage of this data index."""
        return None if self.is_first_stage else self.rank * self.stage + self.stage_rank - 1

    @property
    def next_rank(self) -> Optional[int]:
        """The global rank of the next stage of this data index."""
        return None if self.is_last_stage else self.rank * self.stage + self.stage_rank + 1

    @property
    def last_stage_rank(self) -> int:
        """The global rank of this data index's last stage."""
        return (self.rank + 1) * self.stage - 1

    def stage_all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the stage group, in place, through flat
        buckets (the replicated leaves' gradients)."""
        if self.stage == 1:
            return
        for bucket in _buckets(list(tensors)):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=self.stage_group)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def stage_all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the stage group, as a new tensor."""
        out = t.detach().clone()
        if self.stage > 1:
            dist.all_reduce(out, group=self.stage_group)
        return out

    def from_last_stage(self, obj: Any) -> Any:
        """The last stage's ``obj`` (picklable) on every stage of this data
        index."""
        if self.stage == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.last_stage_rank, group=self.stage_group)
        return box[0]

    def gather_stages(self, tensors: Mapping[str, torch.Tensor]
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """The whole stacked leaves from the stages' layers, on this data
        index's first stage (None on the others): each stage's
        ``stages.{j}.<leaf>`` stacked on a new axis 0 ([L/stage, ...]) and
        gathered into ``stages.<leaf>`` [stage, L/stage, ...]
        (``convert.stage_leaf`` names), JAX's ``stack_grover_params``
        form; the other tensors (replicated) as they are. A collective
        (one gather per bucket): every stage calls it."""
        layers: Dict[str, Dict[int, torch.Tensor]] = {}
        out: Dict[str, torch.Tensor] = {}
        for n, t in tensors.items():
            parsed = stage_leaf(n)
            if parsed is None:
                out[n] = t
            else:
                j, leaf = parsed
                layers.setdefault(f"stages.{leaf}", {})[j] = t
        local = {n: torch.stack([by_j[j] for j in sorted(by_j)]) for n, by_j in layers.items()}
        if self.stage == 1:
            return {**out, **{n: t[None] for n, t in local.items()}}
        first = self.rank * self.stage
        mine = dist.get_rank() == first
        names = list(local)
        for bucket in _buckets([local[n] for n in names], names):
            flat = torch.cat([local[n].reshape(-1) for n in bucket])
            parts = [torch.empty_like(flat) for _ in range(self.stage)] if mine else None
            dist.gather(flat, parts, dst=first, group=self.stage_group)
            if mine:
                off = 0
                for n in bucket:
                    t = local[n]
                    out[n] = torch.stack([p[off:off + t.numel()].view_as(t) for p in parts])
                    off += t.numel()
        return out if mine else None

    # --- data-axis collectives --------------------------------------
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data group, as a new tensor (no gradient)."""
        out = t.detach().clone()
        if not self._data_solo:
            dist.all_reduce(out, group=self.data_group)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data indices' ``x`` concatenated on dim 0, in order, with a
        backward that sums each piece's gradient over the data group into
        its owner."""
        if self._data_solo:
            return x
        return _GatherRows.apply(x, self)

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the data group, in place, through flat
        buckets of at most BUCKET_ELEMENTS elements (one bucket per dtype run)."""
        if self._data_solo:
            return
        for bucket in _buckets(list(tensors)):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=self.data_group)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def gather_shards(self, shards: Mapping[str, torch.Tensor],
                      axes: Mapping[str, int]) -> Dict[str, torch.Tensor]:
        """Whole leaves from the data indices' slices: ``shards[n]`` is the
        slice of leaf n on axis ``axes[n]`` (``shard_leaf``), the same
        shape on every rank. One all-gather per bucket."""
        return _gather(shards, self.data, self.data_group, self._data_solo,
                       lambda n, pieces: torch.cat(pieces, dim=axes[n]))

    def barrier(self) -> None:
        dist.barrier()

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every data index's ``obj`` (picklable), in order."""
        if self._data_solo:
            return [obj]
        out: List[Any] = [None] * self.data
        dist.all_gather_object(out, obj, group=self.data_group)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Global rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    # --- model-axis collectives -------------------------------------
    def model_all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the model group ('sum', 'max' or 'min') as a
        new tensor, without a gradient. A bf16 sum is taken in fp32 and
        rounded once, whatever the backend's own bf16 arithmetic."""
        dtype = torch.float32 if t.dtype == torch.bfloat16 and op == "sum" else t.dtype
        out = t.detach().to(dtype, copy=True).contiguous()
        dist.all_reduce(out, op=_OPS[op], group=self.model_group)
        return out.to(t.dtype)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the gradient summed over the model group
        backward: where a replicated tensor enters this rank's columns."""
        return _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group forward; identity backward (the
        sum is replicated, and so is its gradient): where row-parallel
        partial sums leave."""
        return _ReduceFromModel.apply(x, self)

    def local_slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This model rank's slice of the whole parameter ``name`` (this
        package's name and layout): ``t`` itself where the rules replicate
        it or the model axis has size 1. Raises where the model size does
        not divide the sharded axis."""
        layout = tp_layout(name, t.dim()) if self.model > 1 else None
        if layout is None:
            return t
        return tp_cut(t, layout, self.model, self.model_rank, name)

    def gather_model(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole parameters (or moments) from the model ranks' slices,
        keyed by parameter name; replicated ones as they are. One
        all-gather per bucket over the model group."""
        if self.model == 1:
            return dict(tensors)
        layouts = {n: tp_layout(n, t.dim()) for n, t in tensors.items()}
        cut = {n: t.contiguous() for n, t in tensors.items() if layouts[n] is not None}
        whole = _gather(cut, self.model, self.model_group, False,
                        lambda n, pieces: tp_join(pieces, layouts[n]))
        return {n: whole.get(n, t) for n, t in tensors.items()}


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _gather(shards: Mapping[str, torch.Tensor], size: int, group, solo: bool, join
            ) -> Dict[str, torch.Tensor]:
    """join(name, [each rank's piece of shards[name], in rank order]) for
    every name, the pieces moved by one all-gather per bucket."""
    if solo:
        return {n: join(n, [t]) for n, t in shards.items()}
    out: Dict[str, torch.Tensor] = {}
    names = list(shards)
    for bucket in _buckets([shards[n] for n in names], names):
        flat = torch.cat([shards[n].reshape(-1) for n in bucket])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        off = 0
        for n in bucket:
            t = shards[n]
            out[n] = join(n, [p[off:off + t.numel()].view_as(t) for p in parts])
            off += t.numel()
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(mesh.data)]
        dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.data_group)
        lo = ctx.mesh.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.model_all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
        return mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


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


def make_mesh(data: Optional[int] = None, model: int = 1, stage: int = 1) -> Mesh:
    """The (data, model) or (data, stage) grid over the initialised process
    group's ranks, JAX's ``devices.reshape(data, model)`` (``reshape(data,
    stage)``): rank ``d * model + m`` (``d * stage + s``). Every rank must
    call it (each axis group is made by all ranks). At model 1 and stage 1
    the data group is the default group. A stage axis beside a model axis
    is refused: no JAX path composes them."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    world = dist.get_world_size()
    if stage > 1 and model > 1:
        raise NotImplementedError(
            f"a stage axis ({stage}) beside a model axis ({model}): no JAX path composes "
            f"pipeline and tensor parallelism (pipeline_apply takes a stage axis and a "
            f"data axis only), so neither does this package")
    if stage < 1 or world % stage:
        raise ValueError(f"pipeline parallelism: stage {stage} does not divide the world "
                         f"size {world}")
    if stage > 1:
        data = world // stage if data is None else data
        if data * stage != world:
            raise ValueError(f"data {data} x stage {stage} != world size {world}")
        rank, backend = dist.get_rank(), dist.get_backend()
        d, s = divmod(rank, stage)
        groups = {}
        for i in range(data):
            groups["stage", i] = dist.new_group(list(range(i * stage, (i + 1) * stage)))
        for j in range(stage):
            groups["data", j] = dist.new_group(list(range(j, world, stage)))
        return Mesh(data=data, rank=d, backend=backend, stage=stage, stage_rank=s,
                    data_group=groups["data", s], stage_group=groups["stage", d])
    if model < 1 or world % model:
        raise ValueError(f"tensor parallelism: model {model} does not divide the world "
                         f"size {world}")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"data {data} x model {model} != world size {world}")
    rank, backend = dist.get_rank(), dist.get_backend()
    if model == 1:
        return Mesh(data=data, rank=rank, backend=backend)
    d, m = divmod(rank, model)
    groups = {}
    for i in range(data):
        groups["model", i] = dist.new_group(list(range(i * model, (i + 1) * model)))
    for j in range(model):
        groups["data", j] = dist.new_group(list(range(j, world, model)))
    return Mesh(data=data, rank=d, backend=backend, model=model, model_rank=m,
                data_group=groups["data", m], model_group=groups["model", d])


# ---------------------------------------------------------------------------
# Parameter partition rules: regex over the flax path, first match wins,
# default replicated; 2-D kernels in flax's [in, out]. They decide which
# axis the model axis cuts (``tp_layout``) and which axes ZeRO-1 may use.
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
    # Grover's flat layerNN/{proj} paths; its word_embed stays replicated
    (r"layer\d+/(query|key|value)/kernel$", (None, "model")),
    (r"layer\d+/(query|key|value)/bias$", ("model",)),
    (r"layer\d+/out_proj/kernel$", ("model", None)),
    (r"layer\d+/intermediate/kernel$", (None, "model")),
    (r"layer\d+/intermediate/bias$", ("model",)),
    (r"layer\d+/output/kernel$", ("model", None)),
)
# Grover's serving form fuses each layer's q/k/v columns into one qkv
# product (models/grover.py ``fuse_qkv_for_serving``; the JAX server turns
# it off under its model axis, its rules having none for it). Here each
# model rank fuses its own q, k and v columns: the qkv leaf is cut in three
# blocks, each as query/key/value are, so a rank holds q_r | k_r | v_r.
_FUSED_QKV = r"layer\d+/qkv/(kernel|bias)$"

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


def tp_layout(torch_name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """(axis in this package's layout, blocks) of the model axis's cut of
    parameter ``torch_name``, or None where it is replicated: the axis the
    rules name, cut in ``blocks`` equal blocks (3 for Grover's fused qkv,
    else 1), each block cut evenly over the model ranks."""
    path = flax_path(torch_name)
    blocks = 3 if re.search(_FUSED_QKV, path) else 1
    spec = ((None,) * (ndim - 1) + ("model",) if blocks == 3
            else param_partition_spec(path, _Shaped((0,) * ndim)))
    if "model" not in spec:
        return None
    return flax_axes(torch_name, ndim)[spec.index("model")], blocks


def tp_cut(t: torch.Tensor, layout: Tuple[int, int], model: int, model_rank: int,
           name: str = "") -> torch.Tensor:
    """Model rank ``model_rank``'s slice of ``t`` (contiguous) under
    ``layout``; raises where ``model`` does not divide a block, as JAX's
    ``device_put`` raises on an uneven shard."""
    axis, blocks = layout
    size = t.shape[axis]
    if size % (blocks * model):
        raise ValueError(f"tensor parallelism: {name or 'a leaf'} has {size} on the axis "
                         f"the model axis splits, which does not divide into "
                         f"{blocks} x {model}")
    n = size // (blocks * model)
    parts = t.unflatten(axis, (blocks, size // blocks)).narrow(axis + 1, model_rank * n, n)
    return parts.flatten(axis, axis + 1).contiguous()


def tp_join(pieces: Sequence[torch.Tensor], layout: Tuple[int, int]) -> torch.Tensor:
    """The inverse of ``tp_cut``: the whole tensor from every model rank's
    slice, in rank order."""
    axis, blocks = layout
    parts = [p.unflatten(axis, (blocks, p.shape[axis] // blocks)) for p in pieces]
    return torch.cat(parts, dim=axis + 1).flatten(axis, axis + 1)


def shard_params(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Cut every parameter of ``module`` that the rules shard to this model
    rank's slice, in place, and hand ``mesh`` to each submodule that runs a
    model-axis collective (those with a ``tp`` attribute). Cuts whole
    parameters, once (a module already cut raises); checks every cut and
    every module's own condition (``check_tp``: the heads must divide)
    before it changes anything. A no-op without a mesh or at model 1."""
    if mesh is None or mesh.model == 1:
        return module
    holders = [m for m in module.modules() if hasattr(m, "tp")]
    if any(m.tp is not None for m in holders):
        raise ValueError("shard_params: the module is already cut over a model axis")
    for m in holders:
        if hasattr(m, "check_tp"):
            m.check_tp(mesh.model)
    cut = {n: mesh.local_slice(n, p.data) for n, p in module.named_parameters()}
    for n, p in module.named_parameters():
        p.data = cut[n]
    for m in holders:
        m.tp = mesh
    return module


def zero1_partition_spec(path: str, leaf: Any, data_size: int) -> Spec:
    """The leaf's tensor-parallel spec with ``"data"`` on its largest free
    axis divisible by ``data_size`` (the last such axis on a tie, as
    ``max`` over (size, axis) picks). An axis a rule names is not free even
    when the model axis has size 1, so a free axis has the same size in a
    model rank's slice as in the whole leaf. A leaf with no such axis keeps
    its spec: replicated over the data ranks."""
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
    of parameter ``torch_name`` (of ``shape``: this model rank's slice),
    or None when they stay whole."""
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
    """This data index's slice of ``t`` on ``axis`` (a view)."""
    n = t.shape[axis] // mesh.data
    return t.narrow(axis, mesh.rank * n, n)


def local_rows(x, mesh: Mesh):
    """This data index's rows of a global batch array (dim 0 split evenly)."""
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.data} ranks")
    k = n // mesh.data
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This data index's rows of every array of a global batch."""
    return {k: local_rows(v, mesh) for k, v in batch.items()}
