"""Import a checkpoint of the JAX package (orbax) into this package's format:

    python -m merlot_tpu_torch.tools.import_jax_checkpoint SRC DST

SRC is one directory written by orbax's ``StandardCheckpointer``: a JAX
training run's ``checkpoints/ckpt_{step}``, a denoise server's ``--ckpt``,
or ``download_checkpoint --converted``. It is read with tensorstore alone
(imported inside ``read_orbax``; neither orbax nor jax is loaded): the
tree comes from ``_METADATA``'s ``key_metadata`` tuples, each leaf from its
zarr array in the ``ocdbt`` or plain file store, as ``use_ocdbt`` and
``use_zarr3`` say.

DST, a new directory, is a checkpoint of this package
(``train/checkpoint.py``):
  * ``params/...`` -> ``params.npz`` by flax path (float32 only, as JAX
    trains them);
  * ``opt_state/m/...`` and ``opt_state/v/...`` -> ``opt_state.npz`` as
    ``m/<path>`` and ``v/<path>``, bf16 as its uint16 bits (JAX's sign-bit
    ``encode_v`` moments come across bit for bit), and ``opt_state/step``
    -> ``meta.json``'s ``step``, with each group's dtype;
  * a tree without ``opt_state`` (``{"params": ...}`` or the parameters at
    the top, as JAX's server and warm starts read it:
    ``state.get("params", state)``) gives a params-only checkpoint.

Layouts: a pipeline-parallel tree (``stages/<leaf>`` [pp, L/pp, ...],
``grover_train --pp``) is kept as it is, which ``load_checkpoint`` under a
stage axis and the server's ``load_npz_params`` read. A scan-layout tree
(``.../layers/layer/...`` with a leading layer axis) is unstacked into
``.../layerNN/...``. Any other tree (a list or tuple node, a key beside
``params`` and ``opt_state``, an optimizer state other than MerlotAdamW's
``step``/``m``/``v``, moments that do not mirror the parameters, a leaf
that is not an array, parameters not float32) is refused by name before
anything is written.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from merlot_tpu_torch.train.checkpoint import save_params_checkpoint, write_checkpoint

METADATA = "_METADATA"
DICT_KEY = 2  # orbax's KeyType.DICT in key_metadata
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
SCAN = ("layers", "layer")

Path = Tuple[str, ...]


def tree_paths(src: str) -> Tuple[Dict[Path, str], dict]:
    """The leaves of an orbax checkpoint, {key path: value type}, and its
    ``_METADATA``. A node that is not a dict is refused."""
    meta_file = os.path.join(src, METADATA)
    if not os.path.exists(meta_file):
        raise ValueError(f"{src}: no {METADATA}; not a checkpoint of orbax's "
                         f"StandardCheckpointer")
    with open(meta_file) as f:
        meta = json.load(f)
    leaves: Dict[Path, str] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        path = tuple(str(k["key"]) for k in keys)
        if any(k["key_type"] != DICT_KEY for k in keys):
            raise ValueError(f"{src}: {'/'.join(path)} lies under a list or tuple node: "
                             f"not a tree of dicts as the JAX package writes")
        leaves[path] = entry["value_metadata"]["value_type"]
    return leaves, meta


def read_orbax(src: str, paths: Sequence[Path], meta: dict) -> Dict[Path, np.ndarray]:
    """Read the leaves ``paths`` of the orbax checkpoint ``src`` with
    tensorstore (bf16 as ml_dtypes' bfloat16)."""
    import tensorstore as ts  # a tooling dependency, never a runtime one
    src = os.path.abspath(src)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    out: Dict[Path, np.ndarray] = {}
    for path in paths:
        name = ".".join(path)  # orbax's parameter name of this key path
        if meta.get("use_ocdbt"):
            kvstore = {"driver": "ocdbt", "base": f"file://{src}", "path": name}
        else:
            kvstore = {"driver": "file", "path": os.path.join(src, name) + "/"}
        store = ts.open({"driver": driver, "kvstore": kvstore}, open=True).result()
        out[path] = np.asarray(store.read().result())
    return out


def split_tree(leaves: Mapping[Path, str], src: str) -> Tuple[Dict[Path, Path], bool]:
    """{key path in the checkpoint: (group, path in the group...)} with the
    group 'params', 'm', 'v' or 'step', and whether the tree has an
    optimizer state; refuses a tree of another form by name."""
    bad = sorted("/".join(p) for p, t in leaves.items() if t not in ARRAY_TYPES)
    if bad:
        raise ValueError(f"{src}: leaves that are not arrays: {bad[:5]}")
    top = {p[0] for p in leaves}
    if "params" not in top:
        if "opt_state" in top:
            raise ValueError(f"{src}: an opt_state without params")
        return {p: ("params",) + p for p in leaves}, False
    if top - {"params", "opt_state"}:
        raise ValueError(f"{src}: keys {sorted(top - {'params', 'opt_state'})} beside "
                         f"params and opt_state")
    groups: Dict[Path, Path] = {}
    for p in leaves:
        if p[0] == "params":
            groups[p] = p
        elif p[1:2] in (("m",), ("v",)) and len(p) > 2:
            groups[p] = p[1:]
        elif p[1:] == ("step",):
            groups[p] = ("step",)
        else:
            raise ValueError(f"{src}: {'/'.join(p)} is not in MerlotAdamW's state "
                             f"(step, m, v)")
    if "opt_state" not in top:
        return groups, False
    params = {g[1:] for g in groups.values() if g[0] == "params"}
    for moment in ("m", "v"):
        have = {g[1:] for g in groups.values() if g[0] == moment}
        if have != params:
            raise ValueError(f"{src}: opt_state/{moment} does not mirror params: "
                             f"{sorted('/'.join(q) for q in have ^ params)[:5]}")
    if ("step",) not in groups.values():
        raise ValueError(f"{src}: an opt_state without its step")
    return groups, True


def unstack_scan(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Scan-layout leaves (``.../layers/layer/<leaf>`` [L, ...]) ->
    ``.../layerNN/<leaf>``; every other leaf as it is."""
    out: Dict[str, np.ndarray] = {}
    depth: Dict[str, int] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        at = next((i for i in range(len(parts) - 1) if tuple(parts[i:i + 2]) == SCAN), None)
        if at is None:
            out[path] = leaf
            continue
        site = "/".join(parts[:at])
        n = depth.setdefault(site, leaf.shape[0] if leaf.ndim else -1)
        if leaf.ndim == 0 or leaf.shape[0] != n:
            raise ValueError(f"{path}: leading axis {leaf.shape[:1]}, the scan over {site} "
                             f"has {n} layers")
        for i in range(n):
            out["/".join(parts[:at] + [f"layer{i:02d}"] + parts[at + 2:])] = leaf[i]
    return out


def _group_dtype(arrays: Mapping[str, np.ndarray], group: str, src: str) -> str:
    dtypes = {str(a.dtype) for a in arrays.values()}
    if len(dtypes) != 1 or not dtypes <= {"float32", "bfloat16"}:
        raise ValueError(f"{src}: {group} has dtypes {sorted(dtypes)}: one of float32 or "
                         f"bfloat16 is supported")
    return dtypes.pop()


def import_checkpoint(src: str, dst: str) -> dict:
    """Import the orbax checkpoint ``src`` into the new directory ``dst``;
    returns what was written (the step, the leaf count per group)."""
    if os.path.exists(dst):
        raise FileExistsError(f"{dst} exists")
    leaves, meta = tree_paths(src)
    groups, with_opt = split_tree(leaves, src)
    arrays = read_orbax(src, sorted(leaves), meta)
    parts: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "m": {}, "v": {}}
    step: Optional[int] = None
    for path, (group, *rest) in groups.items():
        if group == "step":
            step = int(arrays[path])
        else:
            parts[group]["/".join(rest)] = arrays[path]
    parts = {g: unstack_scan(flat) for g, flat in parts.items()}
    if _group_dtype(parts["params"], "params", src) != "float32":
        raise ValueError(f"{src}: params are not float32")
    if not with_opt:
        save_params_checkpoint(dst, parts["params"])
        return {"step": None, "params": len(parts["params"])}
    dtypes = {g: _group_dtype(parts[g], g, src) for g in ("params", "m", "v")}
    moments = {f"{g}/{k}": (a.view(np.uint16) if dtypes[g] == "bfloat16" else a)
               for g in ("m", "v") for k, a in parts[g].items()}
    write_checkpoint(dst, parts["params"], {"step": step, "dtypes": dtypes}, moments)
    return {"step": step, **{g: len(parts[g]) for g in ("params", "m", "v")}}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="JAX orbax checkpoint -> this package's format")
    ap.add_argument("src", help="an orbax StandardCheckpointer directory")
    ap.add_argument("dst", help="the checkpoint directory to write (must not exist)")
    args = ap.parse_args(argv)
    print(f"imported {args.src} -> {args.dst}: {json.dumps(import_checkpoint(args.src, args.dst))}")


if __name__ == "__main__":
    main()
