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
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def torch_layout(path: str, arr: np.ndarray) -> np.ndarray:
    """The leaf at flax path ``path`` in this package's layout (C order)."""
    if path.split("/")[-1] == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
    return np.array(arr, order="C")


def flax_axes(torch_name: str, ndim: int) -> Tuple[int, ...]:
    """For each axis of the flax layout of parameter ``torch_name``, its
    axis in this package's layout (kernels [in, out] <- [out, in], HWIO <-
    OIHW; every other leaf the same)."""
    if torch_name.split(".")[-1] == "weight":
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)
        raise ValueError(f"{torch_name}: weight of rank {ndim}")
    return tuple(range(ndim))


def flax_layout(torch_name: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of ``torch_layout``, keyed by the torch name."""
    return np.array(arr.transpose(flax_axes(torch_name, arr.ndim)), order="C")


def params_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """flat: numpy leaves keyed by flax path, '/'-separated, without the
    leading 'params' collection. Returns fp32 tensors keyed by torch name."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        if parts[-1] == "kernel":
            parts[-1] = "weight"
        arr = torch_layout(path, np.asarray(leaf, dtype=np.float32))
        out[".".join(parts)] = torch.from_numpy(arr)
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
    rank's slice (``Mesh.local_slice``)."""
    sd = params_from_flax(flat)
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
