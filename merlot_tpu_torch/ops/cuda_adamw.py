"""Multi-tensor AdamW for Hopper: the optimizer's update over every leaf in
two launches (``csrc/adamw.cu``, built with nvcc at first use and called
through ctypes).

``sumsq`` launches ``merlot_sumsq``: per-leaf sums of squares of a list of
fp32 tensors, on the device and deterministic. ``adamw`` launches ``merlot_adamw``: one AdamW step over
lists of (p, g, m, v), with the hyperparameters of each leaf's group.
Their plain version is the per-leaf loop of ``train/optimizer.py``
(``adamw_leaf``), which ``MerlotAdamW.update`` runs for CPU tensors; for
CUDA tensors it launches these kernels or raises.

A ``Lists`` holds the device table of one list of leaves (a caller keeps
one per list it passes): the views' pointers and row strides, each leaf's
group, and the chunks the grid walks (``chunk_table``). The leaves' words
go up every call (the gradients are new tensors every step), the chunks
only when a size, layout, dtype, device or group differs from the last
call's; each upload is one non-blocking copy from a fresh pinned buffer
(the caching host allocator keeps a buffer out of use until its copy has
run). Any ``narrow`` of a contiguous tensor is ``rows`` runs of ``width``
elements ``row_stride`` apart (``rows_view``), so ZeRO-1's slices go
through without copies.

``launches`` counts both kernels' launches, ``tensors`` the leaves the
update kernel updated (set them to 0 to reset).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from merlot_tpu_torch._build import load_library

# launches of merlot_sumsq and merlot_adamw, and the leaves merlot_adamw
# updated, since the last reset (set them to 0 to reset)
launches = 0
tensors = 0

CHUNK = 16384        # elements of one row a block takes at a time
LEAF_WORDS = 10      # struct Leaf in adamw.cu: 4 pointers, 4 row strides, group, first chunk
GROUP_FIELDS = 8     # struct Group: lr, b1, 1-b1, b2, 1-b2, eps, wd, wd > 0
MAX_GROUPS = 32      # kMaxGroups: the groups travel in the launch's parameters


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the library."""
    lib = load_library("adamw")
    if lib.merlot_adamw.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.merlot_sumsq.argtypes = [ptr, i, i, ptr, ptr, i, ptr]
        lib.merlot_sumsq.restype = i
        lib.merlot_adamw.argtypes = [ptr, i, i, ptr, i, ptr, i, i, ptr]
        lib.merlot_adamw.restype = i
        lib.merlot_adamw_blocks_per_sm.argtypes = [i]
        lib.merlot_adamw_blocks_per_sm.restype = i
    return lib


@lru_cache(maxsize=None)
def _grid_cap(device_index: int, which: int) -> int:
    """The persistent grid of kernel ``which`` (0 sumsq, 1 the update over
    fp32 moments, 2 over bf16): as many blocks as the card holds at once."""
    with torch.cuda.device(device_index):
        per_sm = load_kernel().merlot_adamw_blocks_per_sm(which)
    if per_sm < 1:
        raise RuntimeError(f"cuda_adamw: occupancy query failed ({per_sm})")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def rows_view(t: torch.Tensor) -> Tuple[int, int, int]:
    """(rows, width, row_stride) of a view whose elements are ``rows`` runs
    of ``width`` contiguous elements, ``row_stride`` apart (a contiguous
    tensor is one row; any ``narrow`` of one is such a view); raises on
    any other layout."""
    if t.numel() == 0:
        return 0, 0, 0
    runs: List[List[int]] = []  # [size, stride] of merged dims, innermost first
    for size, stride in reversed(list(zip(t.shape, t.stride()))):
        if size == 1:
            continue
        if runs and stride == runs[-1][0] * runs[-1][1]:
            runs[-1][0] *= size
        else:
            runs.append([size, stride])
    if not runs:
        return 1, 1, 1
    (width, inner), outer = runs[0], runs[1:]
    if inner != 1 or len(outer) > 1 or (outer and outer[0][1] < width):
        raise ValueError(f"cuda_adamw: a view of shape {tuple(t.shape)} and strides "
                         f"{t.stride()} is not rows of contiguous elements apart")
    return (outer[0][0], width, outer[0][1]) if outer else (1, width, width)


def leaf_layout(views: Sequence[torch.Tensor]) -> Tuple[int, int, List[int]]:
    """(rows, width, [row stride of each view]) of views of one shape: the
    rows of the views that are not contiguous (they must agree), which a
    contiguous view takes too."""
    shape = views[0].shape
    if any(v.shape != shape for v in views):
        raise ValueError(f"cuda_adamw: a leaf's views differ in shape: "
                         f"{[tuple(v.shape) for v in views]}")
    descs = [rows_view(v) for v in views]
    rows, width, _ = max(descs, key=lambda d: d[0])
    strides = []
    for r, w, s in descs:
        if (r, w) == (rows, width):
            strides.append(s)
        elif r == 1 and w == rows * width:
            strides.append(width)
        else:
            raise ValueError(f"cuda_adamw: views of shape {tuple(shape)} cut into rows "
                             f"differently: {descs}")
    return rows, width, strides


def chunk_table(rows: Sequence[int], widths: Sequence[int], chunk: int = CHUNK
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The work list of leaves of ``rows`` x ``width`` elements: int32
    (leaf, row, first column, length) per chunk, at most ``chunk`` elements
    of one row, a leaf's chunks together and in order; and each leaf's
    first chunk (int64)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    widths = np.asarray(widths, dtype=np.int64).reshape(-1)
    per_row = -(-widths // chunk)
    counts = rows * per_row
    first = np.cumsum(counts) - counts
    leaf = np.repeat(np.arange(len(rows), dtype=np.int64), counts)
    j = np.arange(int(counts.sum()), dtype=np.int64) - first[leaf]
    row, col = j // per_row[leaf], j % per_row[leaf] * chunk
    length = np.minimum(chunk, widths[leaf] - col)
    return np.stack([leaf, row, col, length], axis=1).astype(np.int32), first


def group_row(lr: float, b1: float, b2: float, eps: float, wd: float) -> np.ndarray:
    """A group's scalars as float32, each cast from its Python double as
    ATen casts a scalar operand: lr (the schedule and the bias correction
    folded in), b1, 1 - b1, b2, 1 - b2, eps, wd, and 1 where wd > 0."""
    return np.array([lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, 1.0 if wd > 0 else 0.0],
                    dtype=np.float64).astype(np.float32)


class Lists:
    """The device table of one list of leaves: a ticket counter (word 0,
    which merlot_sumsq leaves at 0), LEAF_WORDS int64 a leaf, then the
    int32 chunks."""

    def __init__(self):
        self._key: Optional[tuple] = None
        self._words = np.zeros((0, LEAF_WORDS), np.int64)
        self._chunks = np.zeros((0, 4), np.int32)
        self.buf: Optional[torch.Tensor] = None
        self.n_chunks = 0

    def table(self, views: Sequence[torch.Tensor], groups: Sequence[int],
              dtypes: Sequence[torch.dtype]) -> torch.Tensor:
        """The device table of leaves of ``len(dtypes)`` views each, one
        shape a leaf, the i-th of dtype ``dtypes[i]`` (``views`` flat, leaf
        by leaf; all on one CUDA device), leaf j in group ``groups[j]``. The
        layout's key is flat lists (a contiguous view's layout is its size,
        dtype and device), so a step allocates no object per view."""
        k = len(dtypes)
        key = ([t.numel() for t in views], [t.device for t in views],
               [t.dtype if t.is_contiguous() else (t.dtype, t.shape, t.stride())
                for t in views], list(groups))
        relaid = key != self._key
        if relaid:
            self._relayout(views, key[3], dtypes)
        words = self._words
        words[:, :k] = np.array([t.data_ptr() for t in views], np.int64).reshape(-1, k)
        if relaid:  # the whole table
            host = np.concatenate([np.zeros(1, np.int64), words.reshape(-1),
                                   self._chunks.reshape(-1).view(np.int64)])
            self.buf = torch.empty(host.size, dtype=torch.int64, device=views[0].device)
            self.buf.copy_(torch.from_numpy(host).pin_memory(), non_blocking=True)
            self._key = key
        else:  # the leaves' words
            self.buf[1:1 + words.size].copy_(torch.from_numpy(words.reshape(-1)).pin_memory(),
                                             non_blocking=True)
        return self.buf

    def _relayout(self, views: Sequence[torch.Tensor], groups: List[int],
                  dtypes: Sequence[torch.dtype]) -> None:
        """Checks the views, then the leaves' row strides, groups and first
        chunks, and the chunks."""
        k = len(dtypes)
        dev = views[0].device
        if dev.type != "cuda":
            raise ValueError(f"cuda_adamw: tensors on {dev}, not on a CUDA device")
        if len(views) != k * len(groups):
            raise ValueError(f"cuda_adamw: {len(views)} views for {len(groups)} leaves of {k}")
        for i, t in enumerate(views):
            if t.device != dev:
                raise ValueError(f"cuda_adamw: tensors on {t.device} and {dev}")
            if t.dtype != dtypes[i % k]:
                raise ValueError(f"cuda_adamw: a {t.dtype} tensor where the kernel "
                                 f"takes {dtypes[i % k]}")
        rows = [leaf_layout(views[i:i + k]) for i in range(0, len(views), k)]
        if any(r * w >= 2 ** 31 for r, w, _ in rows):
            raise ValueError("cuda_adamw: a leaf of 2^31 elements or more")
        self._chunks, first = chunk_table([r for r, _, _ in rows], [w for _, w, _ in rows])
        self._words = np.zeros((len(groups), LEAF_WORDS), np.int64)
        self._words[:, 4:4 + k] = np.array([st for _, _, st in rows], np.int64)
        self._words[:, 8], self._words[:, 9] = groups, first
        self.n_chunks = len(self._chunks)


def _grid(dev: torch.device, n_chunks: int, which: int) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return max(1, min(n_chunks, _grid_cap(index, which)))


def sumsq(xs: Sequence[torch.Tensor], lists: Lists) -> torch.Tensor:
    """Launch merlot_sumsq over fp32 CUDA tensors ``xs`` (one launch, no
    host sync): their sums of squares, fp32 [len(xs)]."""
    global launches
    buf = lists.table(xs, [0] * len(xs), (torch.float32,))
    dev, n, n_chunks = buf.device, len(xs), lists.n_chunks
    scratch = torch.empty(n_chunks + (n + 1) // 2, dtype=torch.float64, device=dev)
    out = scratch[n_chunks:].view(torch.float32)[:n]
    lib = load_kernel()
    with torch.cuda.device(dev):
        err = lib.merlot_sumsq(buf.data_ptr(), n, n_chunks, out.data_ptr(), scratch.data_ptr(),
                               _grid(dev, n_chunks, 0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merlot_sumsq failed: cudaError_t {err}")
    launches += 1
    return out


def adamw(views: Sequence[torch.Tensor], groups: Sequence[int], table: np.ndarray,
          clip: Optional[torch.Tensor], lists: Lists) -> None:
    """Launch merlot_adamw: one AdamW step, in place, over leaves given as
    ``views`` p, g, m, v, p, g, m, v, ... (one shape a leaf; p and g fp32;
    m and v both bf16, v sign-bit encoded, or both fp32), leaf i with the
    scalars of row ``groups[i]`` of ``table`` (``group_row``s, float32
    [G, 8]); ``clip``: a CUDA fp32 scalar that scales every g, or None. One
    launch, no host sync."""
    global launches, tensors
    if not views:
        return
    state = views[2].dtype
    if state not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cuda_adamw: moments of {state}; the kernel takes fp32 or bf16")
    table = np.ascontiguousarray(table, dtype=np.float32)
    if table.ndim != 2 or table.shape[1] != GROUP_FIELDS or len(table) > MAX_GROUPS:
        raise ValueError(f"cuda_adamw: a group table of shape {table.shape}; the kernel "
                         f"takes at most {MAX_GROUPS} rows of {GROUP_FIELDS}")
    if min(groups) < 0 or max(groups) >= len(table):
        raise ValueError("cuda_adamw: a leaf's group is not in the table")
    buf = lists.table(views, groups, (torch.float32, torch.float32, state, state))
    dev = buf.device
    if clip is not None and (clip.device != dev or clip.dtype != torch.float32
                             or clip.numel() != 1):
        raise ValueError("cuda_adamw: clip must be one fp32 value on the leaves' device")
    lib = load_kernel()
    with torch.cuda.device(dev):
        err = lib.merlot_adamw(buf.data_ptr(), len(groups), lists.n_chunks,
                               table.ctypes.data, len(table),
                               None if clip is None else clip.data_ptr(),
                               int(state == torch.bfloat16),
                               _grid(dev, lists.n_chunks, 1 + int(state == torch.bfloat16)),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merlot_adamw failed: cudaError_t {err}")
    launches += 1
    tensors += len(groups)
