"""Checkpoint save/restore and warm start (counterpart of
merlot_tpu/train/checkpoint.py).

The JAX package checkpoints with orbax; this package has its own format,
which numpy alone reads:

    checkpoints/ckpt_{step}/
        params.npz     every parameter by flax path ("merlot/encoder/
                       layer00/attention/query/kernel"), in the flax layout
                       (kernel [in, out], conv HWIO) and the reference-split
                       q/k/v form, so ``convert.load_flax_params`` and the
                       JAX package read it as it is;
        opt_state.npz  the AdamW moments as "m/<flax path>" and
                       "v/<flax path>", in the same layout;
        meta.json      the optimizer step and the dtype of each group;
                       numpy has no bfloat16, so bf16 arrays are stored as
                       their uint16 bit patterns and meta.json says so.

A params-only checkpoint (``save_params_checkpoint``: weights converted
from the reference's TF checkpoints or imported from the JAX package's) has
no ``opt_state.npz``, and its ``meta.json`` says ``"opt_state": false``.

A checkpoint is written into a hidden temporary directory and renamed to
``ckpt_{step}`` only when complete, so an interrupted write never leaves a
directory that ``latest_step`` picks. Its files and the temporary directory
are fsynced before the rename and the parent directory after it, so that a
host crash or a power loss cannot leave a ``ckpt_{step}`` whose files are
truncated or empty.

``warm_start`` grafts every parameter whose flax path is in both the model
and a source (a checkpoint directory or a flax-path ``.npz``), with a shape
check, like the reference's name-intersection warm start
(utils/model_utils.py:388-413). Nothing is ever deleted
(``keep_checkpoint_max=None``).

A checkpoint always holds whole leaves. Under tensor parallelism (a
``mesh`` with a model axis) ``load_checkpoint`` and ``warm_start`` cut each
to this model rank's slice (``Mesh.local_slice``) before they load it.
A pipeline-parallel run's checkpoint holds JAX's ``--pp`` form: its layers
as ``stages/<leaf>`` [pp, L/pp, ...] (parameters and moments). Under a
``mesh`` with a stage axis ``load_checkpoint`` loads this stage's slice
(``convert.stage_tree``); a checkpoint written at another ``pp``, or one
without ``stages/`` leaves, is refused by name, and so is a ``stages/``
checkpoint restored without a stage axis (JAX's template shapes refuse
both). The denoise server reads either form (``load_npz_params``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from merlot_tpu_torch.convert import (STAGES, flax_axes, flax_path, load_flax_params,
                                      params_from_flax, stage_tree, to_torch_layout)

PARAMS_FILE = "params.npz"
OPT_FILE = "opt_state.npz"
META_FILE = "meta.json"
_STORED = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as its uint16 bit pattern."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.cpu().numpy()
    return arr.view(np.uint16) if arr.dtype == np.int16 else arr


def _flax_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    """A host copy of parameter ``name``'s tensor in the flax layout, its
    axes moved on the tensor's device (bf16 as uint16 bit patterns)."""
    return _to_numpy(t.detach().permute(flax_axes(name, t.dim())).contiguous())


def _group_dtype(tensors: Mapping[str, torch.Tensor], group: str) -> str:
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _STORED:
        raise ValueError(f"checkpoint group {group} has dtypes {dtypes}: "
                         f"one of float32 or bfloat16 is supported")
    return _STORED[dtypes.pop()]


def _fsync(path: str) -> None:
    """Flush a file's or a directory's data and metadata to the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_checkpoint(path: str, params: Mapping[str, np.ndarray], meta: Dict[str, Any],
                     moments: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """Write a checkpoint directory at ``path`` from host arrays by flax
    path in the flax layout (bf16 as uint16 bit patterns): ``params.npz``,
    ``opt_state.npz`` when ``moments`` ("m/<path>", "v/<path>") is given,
    and ``meta``. It is written into a hidden temporary directory, fsynced
    and renamed into place (a re-save of the same path replaces it whole)."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{os.path.basename(path)}-", dir=parent)
    try:
        np.savez(os.path.join(tmp, PARAMS_FILE), **params)
        names = [PARAMS_FILE]
        if moments is not None:
            np.savez(os.path.join(tmp, OPT_FILE), **moments)
            names.append(OPT_FILE)
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        for name in names + [META_FILE]:
            _fsync(os.path.join(tmp, name))
        _fsync(tmp)
        if os.path.exists(path):  # a re-save of the same step
            old = tempfile.mkdtemp(prefix=f".old-{os.path.basename(path)}-", dir=parent)
            os.rename(path, os.path.join(old, "ckpt"))
            os.rename(tmp, path)
            _fsync(parent)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
            _fsync(parent)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    opt_state: Dict[str, Any]) -> None:
    """Write ``params`` (torch name -> tensor) and ``opt_state`` (the
    AdamW state: step, m, v) to the directory ``path``, atomically."""
    meta = {"step": int(opt_state["step"]),
            "dtypes": {"params": _group_dtype(params, "params"),
                       "m": _group_dtype(opt_state["m"], "m"),
                       "v": _group_dtype(opt_state["v"], "v")}}
    write_checkpoint(path, {flax_path(n): _flax_numpy(n, p) for n, p in params.items()}, meta,
                     {f"{g}/{flax_path(n)}": _flax_numpy(n, t)
                      for g in ("m", "v") for n, t in opt_state[g].items()})


def save_params_checkpoint(path: str, params: Mapping[str, np.ndarray]) -> None:
    """Write float32 leaves by flax path (flax layout) as a params-only
    checkpoint directory: no ``opt_state.npz``, and a ``meta.json`` whose
    ``opt_state`` is false. Every reader of parameters takes it (the
    zero-shot CLI, the warm starts, the server's ``--ckpt`` on its
    ``params.npz``); ``load_checkpoint`` refuses it by name."""
    bad = sorted(k for k, v in params.items() if np.asarray(v).dtype != np.float32)
    if bad:
        raise ValueError(f"params-only checkpoints hold float32 leaves: {bad[:5]}")
    write_checkpoint(path, params, {"step": None, "opt_state": False,
                                    "dtypes": {"params": "float32"}})


def load_params(path: str) -> Dict[str, np.ndarray]:
    """The parameters of a checkpoint directory, by flax path, in the flax
    layout (what ``convert.load_flax_params`` takes)."""
    with np.load(os.path.join(path, PARAMS_FILE)) as z:
        return {k: z[k] for k in z.files}


def load_checkpoint(path: str, model: nn.Module, opt_state: Dict[str, Any],
                    mesh=None) -> None:
    """Restore a checkpoint directory into ``model``'s parameters and the
    AdamW state ``opt_state`` (whose tensors keep their dtype and device),
    in place; with ``mesh``, this model rank's slices of them (this
    stage's under a stage axis)."""
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    if not meta.get("opt_state", True):
        raise ValueError(f"{path} holds parameters only (no optimizer state): warm-start "
                         f"from it (model.init_checkpoint) instead of resuming it")
    params = load_params(path)
    n_stage = 1 if mesh is None else mesh.stage
    written = {v.shape[0] for k, v in params.items() if k.split("/")[0] == STAGES}
    if n_stage > 1 and not written:
        raise ValueError(f"{path} holds no stages/ leaves (written at pp=1); this run has "
                         f"pp={n_stage}")
    if n_stage == 1 and written:
        raise ValueError(f"{path} holds stages/ leaves (written at pp={written.pop()}); "
                         f"restore it at that pp")
    if n_stage > 1:
        params = stage_tree(params, mesh.stage_rank, n_stage)
    load_flax_params(model, params, mesh)
    with np.load(os.path.join(path, OPT_FILE)) as z:
        moments = z
        if n_stage > 1:  # this stage's slices of the stacked moments
            moments = {}
            for g in ("m", "v"):
                part = stage_tree({k[len(g) + 1:]: z[k] for k in z.files
                                   if k.startswith(g + "/")}, mesh.stage_rank, n_stage)
                moments.update({f"{g}/{k}": v for k, v in part.items()})
        for g in ("m", "v"):
            stored = meta["dtypes"][g]
            for n, t in opt_state[g].items():
                key = f"{g}/{flax_path(n)}"
                if key not in moments:
                    raise KeyError(f"{path}: no {key}")
                arr = moments[key]
                if stored == "bfloat16":  # the uint16 bit patterns
                    arr = arr.view(np.int16)
                src = to_torch_layout(flax_path(n), arr, t.device)
                if stored == "bfloat16":
                    src = src.view(torch.bfloat16)
                if mesh is not None:
                    src = mesh.local_slice(n, src)
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(f"{key}: {tuple(src.shape)} {src.dtype} in the "
                                     f"checkpoint, {tuple(t.shape)} {t.dtype} in the state")
                with torch.no_grad():
                    t.copy_(src)
    opt_state["step"] = int(meta["step"])


class CheckpointManager:
    """Step-numbered checkpoints under ``directory/ckpt_{step}``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}")

    def save(self, step: int, params: Mapping[str, torch.Tensor],
             opt_state: Dict[str, Any]) -> None:
        save_checkpoint(self.path(step), params, opt_state)

    def restore(self, step: int, model: nn.Module, opt_state: Dict[str, Any],
                mesh=None) -> None:
        load_checkpoint(self.path(step), model, opt_state, mesh)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def warm_start(model: nn.Module, source: Union[str, Mapping[str, np.ndarray]],
               name_transform: Optional[Callable[[str], str]] = None,
               verbose: bool = True, mesh=None) -> List[str]:
    """Graft every parameter whose flax path is in both ``model`` and
    ``source`` (a checkpoint directory, a flax-path ``.npz`` file, or such
    a mapping), in place; with ``mesh``, this model rank's slice of each
    whole leaf. Shape mismatches are skipped with a warning, as the TF1
    warm start loads whatever intersects. Returns the flax paths that were
    initialized."""
    if isinstance(source, str):
        if os.path.isdir(source):
            source = load_params(source)
        else:
            with np.load(source) as z:
                source = {k: z[k] for k in z.files}
    target = {flax_path(n): p for n, p in model.named_parameters()}
    initialized: List[str] = []
    for src_path, leaf in source.items():
        path = name_transform(src_path) if name_transform else src_path
        if path not in target:
            continue
        if np.ndim(leaf) != target[path].dim():
            tensor = None
        else:
            ((name, tensor),) = params_from_flax({path: leaf}).items()
            if mesh is not None:
                try:
                    tensor = mesh.local_slice(name, tensor)
                except ValueError:  # does not cut: a leaf of another shape
                    tensor = None
        if tensor is None or tuple(tensor.shape) != tuple(target[path].shape):
            if verbose:
                print(f"warm_start: shape mismatch at {path}: {np.shape(leaf)} vs "
                      f"{tuple(target[path].shape)} (torch layout), skipping")
            continue
        with torch.no_grad():
            target[path].copy_(tensor.to(target[path].dtype))
        initialized.append(path)
    if verbose:
        print(f"warm_start: initialized {len(initialized)}/{len(target)} leaves")
    return initialized
