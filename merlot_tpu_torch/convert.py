"""Weight bridge: flax parameter leaves -> this package's state_dict, and
torch parameter names -> flax paths.

Flax paths map to torch names one for one ("vision_backbone/resnet/
stem_conv0/kernel" -> "vision_backbone.resnet.stem_conv0.weight";
``flax_path`` is the inverse). Layouts differ only for the matmul and conv
kernels:
  * DenseTN kernel [in, out]  -> weight [out, in];
  * WSConv kernel HWIO        -> weight OIHW.
Every other leaf keeps its shape.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def params_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """flat: numpy leaves keyed by flax path, '/'-separated, without the
    leading 'params' collection. Returns fp32 tensors keyed by torch name."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        arr = np.asarray(leaf, dtype=np.float32)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
        out[".".join(parts)] = torch.from_numpy(np.array(arr, order="C"))
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


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load flax leaves into ``model``. Raises if a leaf has no home in the
    model, if a model parameter is left unset, or on a shape mismatch."""
    sd = params_from_flax(flat)
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
