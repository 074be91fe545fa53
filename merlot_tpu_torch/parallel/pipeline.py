"""GPipe pipeline parallelism over the mesh's stage axis (counterpart of
merlot_tpu/parallel/pipeline.py).

The JAX package stacks the uniform layers' parameters on a leading
[n_stage] axis sharded over a ``stage`` mesh axis and runs the fill/drain
schedule as one ``lax.scan`` of ``ppermute`` hops; ``jax.grad`` transposes
the hops into the reverse pipeline. Here a stage is a process (a rank of
``parallel.mesh.make_mesh(stage=S)``) holding its contiguous L/S layers as
modules, and point-to-point ops have no autograd, so both schedules are
written out:

  * the forward (``pipeline_apply``): for each microbatch in order, stage 0
    takes it from ``h_mb``, every later stage receives it from the previous
    stage; the stage runs its layers in order and sends the result on. The
    last stage keeps the outputs in microbatch order. Each stage keeps each
    microbatch's input (a leaf that requires grad) and output, with the
    graph between them;
  * the backward (``Pipeline.backward``): GPipe's order, all forwards and
    then the backwards in reverse microbatch order. For each microbatch a
    stage receives dy from the next stage (the last stage takes it from
    the gradient the loss's backward left on its outputs), backpropagates
    dy through y's graph (``_vjp``), which adds the layers' parameter
    gradients into their ``.grad``, and sends the input's gradient to the
    previous stage. Stage 0 stacks those into the gradient of ``h_mb`` and
    carries on into ``h_mb``'s own graph (the embeddings). The gradients
    are those of ``loss.backward()`` through the sequential stack, summed
    over the microbatches in reverse order;
  * the hop: every op of a pair is posted in the same order on both sides
    (forward sends ascend, backward sends descend, each with its own tag),
    so no rank waits on one that waits on it. Under NCCL (a card per rank)
    a hop sends the CUDA tensor itself through ``batch_isend_irecv``. Under
    gloo on CUDA tensors (the ranks that share one card: NCCL refuses two
    ranks on one device) the tensor moves through a pinned host buffer,
    which is gloo's transport here: every layer still runs on the card.
    Under gloo on the CPU it is sent as it is;
  * dropout: with ``generator_seed`` each (global layer, microbatch) pair
    draws from a generator of its own seeded from (seed, layer, microbatch),
    as JAX folds its key per (layer, microbatch): the same seed gives the
    same masks at any number of stages, and at one stage (``mesh`` None or
    of stage 1) this is the one-process run of the same keyed schedule;
  * the data axis: with ``data_axis`` the microbatches' rows (axis 1) are
    split over the mesh's data indices, each runs the same schedule on its
    rows and returns them, and the backward sums the stage layers'
    parameter gradients over the data group (what the shard_map
    transpose's psum does in JAX).

The bubble is GPipe's (n_stage - 1) / (M + n_stage - 1) of a step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from merlot_tpu_torch.parallel.mesh import Mesh


def stack_stage_params(layer_params: Sequence[Mapping[str, np.ndarray]],
                       n_stage: int) -> Dict[str, np.ndarray]:
    """[L] per-layer flat trees (numpy leaves keyed by flax path) -> one
    tree of leaves [n_stage, L/n_stage, ...]: axis 0 the stage, axis 1 the
    layer within it. The layers must be shape-uniform."""
    n_layers = len(layer_params)
    if n_stage < 1 or n_layers % n_stage:
        raise ValueError(f"pipeline parallelism: {n_layers} layers do not split into "
                         f"{n_stage} stages")
    per = n_layers // n_stage
    keys = list(layer_params[0])
    if any(set(p) != set(keys) for p in layer_params):
        raise ValueError("stack_stage_params: the layers' trees differ")
    return {k: np.stack([np.asarray(p[k]) for p in layer_params]).reshape(
        (n_stage, per) + np.shape(layer_params[0][k])) for k in keys}


def unstack_stage_params(stacked: Mapping[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """The inverse of ``stack_stage_params``: the [L] per-layer trees."""
    first = np.asarray(next(iter(stacked.values())))
    n = first.shape[0] * first.shape[1]
    flat = {k: np.asarray(v).reshape((n,) + np.shape(v)[2:]) for k, v in stacked.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def shard_stage_params(stacked: Mapping[str, np.ndarray], mesh: Mesh
                       ) -> Dict[str, np.ndarray]:
    """This rank's stage of a stacked tree: every leaf's [L/n_stage, ...]
    slice (the counterpart of ``stage_param_shardings`` and
    ``shard_stage_params``, which place axis 0 on the stage axis)."""
    out = {}
    for k, v in stacked.items():
        if np.shape(v)[0] != mesh.stage:
            raise ValueError(f"{k} is split in {np.shape(v)[0]} stages; the mesh has "
                             f"{mesh.stage}")
        out[k] = np.asarray(v)[mesh.stage_rank]
    return out


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]: microbatch i is rows [i B/M, (i+1) B/M)."""
    b = x.shape[0]
    if num_microbatches < 1 or b % num_microbatches:
        raise ValueError(f"a batch of {b} rows does not split into {num_microbatches} "
                         f"microbatches")
    return x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))


def layer_generator(seed: int, layer: int, mb: int, device) -> torch.Generator:
    """The dropout generator of (global layer, microbatch) under ``seed``."""
    (mixed,) = np.random.SeedSequence([seed, layer, mb]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed))


class Hops:
    """Point-to-point transfers between neighbouring stages (the module
    docstring's hop), with their bytes, the host time spent in them
    (``seconds``: waits for the peer included) and, through pinned host
    buffers, in the copies to and from the card (``copy_seconds``)."""

    def __init__(self, mesh: Mesh, device: torch.device):
        self.device = device
        self.nccl = mesh.backend == "nccl"
        # gloo's send/recv read a CUDA tensor's pointer as a host one, so a
        # card's tensors move through pinned host memory
        self.via_host = not self.nccl and device.type == "cuda"
        self.pending: List[Any] = []
        self.seconds = 0.0
        self.copy_seconds = 0.0
        self.bytes = 0

    def send(self, t: torch.Tensor, dst: int, tag: int) -> None:
        t0 = time.perf_counter()
        t = t.detach().contiguous()
        if self.via_host:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            self.copy_seconds += time.perf_counter() - t0
            self.pending.append((dist.isend(buf, dst, tag=tag), buf))
        elif self.nccl:
            (work,) = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst, tag=tag)])
            self.pending.append((work, t))
        else:
            self.pending.append((dist.isend(t, dst, tag=tag), t))
        self.bytes += t.numel() * t.element_size()
        self.seconds += time.perf_counter() - t0

    def recv(self, shape, dtype: torch.dtype, src: int, tag: int) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.via_host:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            dist.recv(buf, src, tag=tag)
            t1 = time.perf_counter()
            out = buf.to(self.device)
            self.copy_seconds += time.perf_counter() - t1
        else:
            out = torch.empty(shape, dtype=dtype, device=self.device)
            if self.nccl:
                (work,) = dist.batch_isend_irecv([dist.P2POp(dist.irecv, out, src, tag=tag)])
                work.wait()
            else:
                dist.recv(out, src, tag=tag)
        self.bytes += out.numel() * out.element_size()
        self.seconds += time.perf_counter() - t0
        return out

    def wait(self) -> None:
        t0 = time.perf_counter()
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()
        self.seconds += time.perf_counter() - t0


@dataclasses.dataclass
class Pipeline:
    """One forward of the schedule on this rank, kept for its backward.
    ``outputs``: the last stage's [M, mb, ...] outputs, a leaf that
    requires grad when the forward recorded a graph (compute the loss from
    it, backward, then call ``backward``); None on other stages."""
    outputs: Optional[torch.Tensor]
    h_mb: torch.Tensor
    xs: List[torch.Tensor]
    ys: List[torch.Tensor]
    mesh: Optional[Mesh]
    hops: Optional[Hops]
    params: List[torch.nn.Parameter]
    data_axis: bool

    @property
    def first(self) -> bool:
        return self.mesh is None or self.mesh.is_first_stage

    @property
    def last(self) -> bool:
        return self.mesh is None or self.mesh.is_last_stage

    def backward(self) -> Optional[torch.Tensor]:
        """The reverse schedule (module docstring). Returns the gradient of
        ``h_mb`` on stage 0 (this data index's rows with ``data_axis``),
        None elsewhere; the graphs are freed."""
        m = len(self.ys)
        if self.last:
            if self.outputs is None or self.outputs.grad is None:
                raise RuntimeError("Pipeline.backward on the last stage needs the gradient "
                                   "of its outputs: backward from the loss first")
            dys = self.outputs.grad
        dxs: List[Optional[torch.Tensor]] = [None] * m
        for i in reversed(range(m)):
            y = self.ys[i]
            dy = dys[i] if self.last else self.hops.recv(y.shape, y.dtype,
                                                         self.mesh.next_rank, m + i)
            _vjp(y, dy)
            x = self.xs[i]
            dx = torch.zeros_like(x) if x.grad is None else x.grad
            if self.first:
                dxs[i] = dx
            else:
                self.hops.send(dx, self.mesh.prev_rank, m + i)
            self.xs[i] = self.ys[i] = None
        if self.hops is not None:
            self.hops.wait()
        if self.data_axis and self.mesh is not None:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.mesh.all_reduce_([p.grad for p in self.params])
        if not self.first:
            return None
        dh = torch.stack(dxs)
        if self.h_mb.requires_grad:
            rows = self.h_mb
            if self.data_axis:
                rows = _local_rows(rows, self.mesh)
            _vjp(rows, dh)
        return dh


def _vjp(y: torch.Tensor, dy: torch.Tensor) -> None:
    """``torch.autograd.backward(y, dy)``, as the backward of the scalar
    sum(y * dy), whose gradient at y is dy exactly: given a gradient tensor,
    torch's autograd first imports its symbolic-shapes module (sympy),
    seconds in a fresh process."""
    (y * dy).sum().backward()


def _local_rows(h_mb: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This data index's rows of every microbatch (axis 1)."""
    if mesh is None or mesh.data == 1:
        return h_mb
    mb = h_mb.shape[1]
    if mb % mesh.data:
        raise ValueError(f"microbatches of {mb} rows do not split over {mesh.data} data "
                         f"indices")
    k = mb // mesh.data
    return h_mb[:, mesh.rank * k:(mesh.rank + 1) * k]


def pipeline_apply(layer_fn: Callable[..., torch.Tensor], stage_layers: Sequence[Any],
                   h_mb: torch.Tensor, mesh: Optional[Mesh] = None,
                   generator_seed: Optional[int] = None,
                   data_axis: bool = False) -> Pipeline:
    """Run microbatches through the staged layer stack (the fill/drain
    forward of the module docstring).

    Args:
      layer_fn: ``(layer, h) -> h``, or with ``generator_seed`` ``(layer, h,
        generator) -> h`` (the generator of this (global layer,
        microbatch)). Anything every layer shares (a mask) is closed over.
      stage_layers: this rank's L/n_stage layers, in order (global layers
        ``stage_rank * len(stage_layers) + j``).
      h_mb: [M, mb, ...] microbatched activations. Stage 0 reads them;
        later stages read only their shape, dtype and device. With
        ``data_axis`` the rows of each microbatch are the global ones and
        this data index runs its share.
      mesh: the (data, stage) mesh; None runs every layer in this process.

    Returns the ``Pipeline`` (its ``outputs`` on the last stage, [M, mb,
    ...] in microbatch order), whose ``backward`` runs the reverse
    schedule.
    """
    grad = torch.is_grad_enabled()
    first = mesh is None or mesh.is_first_stage
    last = mesh is None or mesh.is_last_stage
    multi = mesh is not None and mesh.stage > 1
    hops = Hops(mesh, h_mb.device) if multi else None
    per = len(stage_layers)
    offset = 0 if mesh is None else mesh.stage_rank * per
    local = _local_rows(h_mb, mesh) if data_axis else h_mb
    m = local.shape[0]
    shape, dtype = tuple(local.shape[1:]), local.dtype
    xs, ys = [], []
    for i in range(m):
        x = local[i].detach() if first else hops.recv(shape, dtype, mesh.prev_rank, i)
        if grad:
            x.requires_grad_(True)
        h = x
        for j, layer in enumerate(stage_layers):
            if generator_seed is None:
                h = layer_fn(layer, h)
            else:
                h = layer_fn(layer, h, layer_generator(generator_seed, offset + j, i,
                                                       h.device))
        if not last:
            hops.send(h, mesh.next_rank, i)
        xs.append(x)
        ys.append(h)
    if hops is not None:
        hops.wait()
    outputs = None
    if last:
        outputs = torch.stack([y.detach() for y in ys])
        if grad:
            outputs.requires_grad_(True)
    params = [p for layer in stage_layers if isinstance(layer, torch.nn.Module)
              for p in layer.parameters()]
    if not grad:
        xs, ys = [], []
    return Pipeline(outputs=outputs, h_mb=h_mb, xs=xs, ys=ys, mesh=mesh, hops=hops,
                    params=params, data_axis=data_axis)
