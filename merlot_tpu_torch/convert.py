"""Weight bridge: flax parameter leaves -> this package's state_dict, and
torch parameter names -> flax paths.

Flax paths map to torch names one for one ("vision_backbone/resnet/
stem_conv0/kernel" -> "vision_backbone.resnet.stem_conv0.weight";
``flax_path`` is the inverse). Layouts differ only for the matmul and conv
kernels:
  * DenseTN kernel [in, out]  -> weight [out, in];
  * WSConv kernel HWIO        -> weight OIHW.
Every other leaf keeps its shape. ``torch_layout`` and ``flax_layout`` move
one array between the two layouts without changing its dtype (checkpoints
store the optimizer's moments in the flax layout too).

Pipeline parallelism: JAX's stacked tree (``stack_grover_params``) holds
the layers as ``stages/<leaf>`` leaves [n_stage, L/n_stage, ...]. A stage
module of this package holds its own layers as ``stages.{j}.<leaf>``
(``stage_leaf``), and the name ``stages.<leaf>`` (no layer index) stands
for a whole stacked leaf in this package's layout: the two leading axes,
then the leaf's own (``flax_axes``, ``torch_layout``). ``stage_tree``
turns a stacked tree into one stage's leaves, ``stacked_tree`` the leaves
of every stage back into the stacked tree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


STAGES = "stages"


def _stacked(parts: Sequence[str]) -> bool:
    """A whole stacked leaf: ``stages`` then the leaf's own name, no layer
    index."""
    return len(parts) > 1 and parts[0] == STAGES and not parts[1].isdigit()


def stage_leaf(torch_name: str) -> Optional[Tuple[int, str]]:
    """(j, leaf) of a stage module's parameter ``stages.{j}.<leaf>``; None
    for any other name."""
    parts = torch_name.split(".")
    if len(parts) > 2 and parts[0] == STAGES and parts[1].isdigit():
        return int(parts[1]), ".".join(parts[2:])
    return None


def torch_axes(path: str, ndim: int) -> Tuple[int, ...]:
    """For each axis of this package's layout of the leaf at flax path
    ``path``, its axis in the flax layout (the inverse of ``flax_axes``)."""
    parts = path.split("/")
    if _stacked(parts):  # [n_stage, L/n_stage] then the leaf's own axes
        return (0, 1) + tuple(2 + a for a in torch_axes("/".join(parts[1:]), ndim - 2))
    if parts[-1] == "kernel":
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (3, 2, 0, 1)
        raise ValueError(f"{path}: kernel of rank {ndim}")
    return tuple(range(ndim))


def torch_layout(path: str, arr: np.ndarray) -> np.ndarray:
    """The leaf at flax path ``path`` in this package's layout (C order)."""
    return np.array(arr.transpose(torch_axes(path, arr.ndim)), order="C")


def flax_axes(torch_name: str, ndim: int) -> Tuple[int, ...]:
    """For each axis of the flax layout of parameter ``torch_name``, its
    axis in this package's layout (kernels [in, out] <- [out, in], HWIO <-
    OIHW; every other leaf the same; a stacked ``stages.<leaf>`` keeps its
    two leading axes)."""
    parts = torch_name.split(".")
    if _stacked(parts):
        return (0, 1) + tuple(2 + a for a in flax_axes(".".join(parts[1:]), ndim - 2))
    if parts[-1] == "weight":
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)
        raise ValueError(f"{torch_name}: weight of rank {ndim}")
    return tuple(range(ndim))


def flax_layout(torch_name: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of ``torch_layout``, keyed by the torch name."""
    return np.array(arr.transpose(flax_axes(torch_name, arr.ndim)), order="C")


def to_torch_layout(path: str, arr: np.ndarray, device=None) -> torch.Tensor:
    """``torch_layout`` as a tensor on ``device`` (the CPU when None): on a
    card the array goes there as it is and its axes move there (a host's
    transposing copy of a large kernel is slow)."""
    if device is None or torch.device(device).type == "cpu":
        return torch.from_numpy(torch_layout(path, arr))
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t.permute(torch_axes(path, t.dim())).contiguous()


def params_from_flax(flat: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """flat: numpy leaves keyed by flax path, '/'-separated, without the
    leading 'params' collection. Returns fp32 tensors keyed by torch name,
    on ``device`` (the CPU when None)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        if parts[-1] == "kernel":
            parts[-1] = "weight"
        out[".".join(parts)] = to_torch_layout(path, np.asarray(leaf, dtype=np.float32), device)
    return out


def flax_path(torch_name: str) -> str:
    """The flax path of a parameter from its torch name: the inverse of the
    name map of ``params_from_flax`` ("merlot.encoder.layer00.attention.
    query.weight" -> "merlot/encoder/layer00/attention/query/kernel"). Only
    the matmul and conv kernels are named ``weight`` in this package."""
    parts = torch_name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                     mesh=None) -> None:
    """Load flax leaves into ``model``. Raises if a leaf has no home in the
    model, if a model parameter is left unset, or on a shape mismatch.
    With ``mesh`` (``parallel.mesh.Mesh``, a model cut by its
    ``shard_params``), the leaves are whole and each rank loads its model
    rank's slice (``Mesh.local_slice``). The leaves move to the model's
    device before their axes do."""
    first = next(model.parameters(), None)
    sd = params_from_flax(flat, None if first is None else first.device)
    if mesh is not None:
        sd = {k: mesh.local_slice(k, t) for k, t in sd.items()}
    own = model.state_dict()
    unused = sorted(set(sd) - set(own))
    unset = sorted(set(own) - set(sd))
    if unused:
        raise KeyError(f"flax leaves with no port parameter: {unused}")
    if unset:
        raise KeyError(f"port parameters with no flax leaf: {unset}")
    bad = [f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
           for k in sd if sd[k].shape != own[k].shape]
    if bad:
        raise ValueError(f"shape mismatches: {bad}")
    model.load_state_dict(sd, strict=True)


def stage_tree(flat: Mapping[str, np.ndarray], stage_rank: int,
               n_stage: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A stacked tree (flax paths; ``stages/<leaf>`` [n_stage, L/n_stage,
    ...]) -> the leaves of stage ``stage_rank``'s module: ``stages/{j}/<leaf>``
    for its layers j, the rest (replicated) as they are. With ``n_stage``,
    a tree split in another number of stages is refused by name."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        if not _stacked(parts):
            out[path] = leaf
            continue
        arr = np.asarray(leaf)
        if n_stage is not None and arr.shape[0] != n_stage:
            raise ValueError(f"{path} is split in {arr.shape[0]} pipeline stages, not "
                             f"{n_stage}: restore it at pp={arr.shape[0]}")
        for j in range(arr.shape[1]):
            out["/".join([STAGES, str(j)] + parts[1:])] = arr[stage_rank, j]
    return out


def stacked_tree(stages: Sequence[Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The inverse of ``stage_tree``: every stage's leaves, in stage order,
    -> the stacked tree (the replicated leaves from stage 0)."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[str, list] = {}
    for s, flat in enumerate(stages):
        for path, leaf in flat.items():
            parts = path.split("/")
            if len(parts) > 2 and parts[0] == STAGES and parts[1].isdigit():
                rows = layers.setdefault("/".join([STAGES] + parts[2:]), [[] for _ in stages])
                rows[s].append((int(parts[1]), np.asarray(leaf)))
            elif s == 0:
                out[path] = leaf
    for path, rows in layers.items():
        out[path] = np.stack([np.stack([a for _, a in sorted(r, key=lambda x: x[0])])
                              for r in rows])
    return out
