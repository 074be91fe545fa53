"""Attention kernels for Hopper, forward (K1), backward (K2) and the cached
forward over a stacked KV cache (K3), and their plain PyTorch versions.

Counterpart of merlot_tpu/ops/pallas_attention.py ``flash_attention``:
``_flash_fwd`` (K1), ``_flash_bwd_pallas`` (K2) and the custom_vjp
``_flash_p``/``_fwd``/``_bwd`` around them, which becomes
``FlashAttention``, a ``torch.autograd.Function``. The kernels are
``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``, built with nvcc at
first use and called through ctypes. They take the natural [B, S, H*D]
layout, an optional multiplicative [B, Sq, Sk] fp32 mask, fp32 or bf16
softmax; the forward optionally returns the colsum [B, Sk] fp32, and the
backward takes its cotangent.

K3 (``flash_attention_stacked``, ``csrc/attention_stacked.cu``) is the
counterpart of ``flash_attention_stacked``: Grover's serving attention over
one [B, Sk, 2*H*D] cache buffer per layer, keys in columns [:H*D] and
values in [H*D:], with a mask of [B or 1, Sq, Sk]. Forward only. Its decode
kernel (Sq <= 8) reads only the live slots below ``kv_len``, one
thread-block cluster per (batch element, head) whose size ``decode_plan``
picks from the shape alone.

The fp32 routes of K1 and K2 (``csrc/attention_fp32.cuh``) sort the mask's
64 x 64 tiles into all 0, all 1 and mixed once per call (``new_tile_class``
holds the classes) and skip the all-0 tiles wherever that changes nothing;
the forward's classes and row max and sum go to the backward with it.

``FlashAttention`` and ``flash_attention_stacked`` launch the kernels for
CUDA tensors and use the plain versions for CPU tensors; they never fall
back from one to the other. ``launches``, ``bwd_launches`` and
``stacked_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from merlot_tpu_torch._build import load_library
from merlot_tpu_torch.ops import named_ops
from merlot_tpu_torch.ops.attention import (_plain_attention, attention_probs,
                                            attention_scores)

MAX_KERNEL_SEQ = 2048
MAX_HEAD_DIM = 128
TILE = 64  # query rows and keys of the kernels' tiles

# launches of K1, K2 and K3 since the last reset (set them to 0 to reset)
launches = 0
bwd_launches = 0
stacked_launches = 0

# K1's ablation variants (``attention_fwd_variant_cuda``; no model path
# launches them): the softmax removed (p = round(s)), and the softmax
# without its pass for the row max and sum (max = 0, sum = 1). Both are
# wrong on purpose: only their times mean anything.
VARIANTS = {"mm_only": 1, "no_max": 2}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def kernel_supported(sq: int, sk: int, d_head: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes the kernels take (the wrappers and
    ``attention_core(backend='cuda')`` raise on any other). bf16 runs on the tensor cores in 16-wide head-dim steps, so
    its head dim must be a multiple of 16; fp32 takes any head dim."""
    if dtype not in _DTYPE_CODE:
        return False
    if dtype == torch.bfloat16 and d_head % 16:
        return False
    return sq <= MAX_KERNEL_SEQ and sk <= MAX_KERNEL_SEQ and d_head <= MAX_HEAD_DIM


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K1's library."""
    lib = load_library("attention_fwd")
    fn = lib.merlot_attention_fwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 9 + [i] * 7 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        var = lib.merlot_attention_fwd_variant
        var.argtypes = fn.argtypes + [i]
        var.restype = i
    return lib


def load_bwd_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K2's library."""
    lib = load_library("attention_bwd")
    fn = lib.merlot_attention_bwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i, ptr] + [i] * 7 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return lib


def load_stacked_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K3's library."""
    lib = load_library("attention_stacked")
    fn = lib.merlot_attention_stacked_fwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i] * 10 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.merlot_attention_decode_smem.argtypes = [i] * 5
        lib.merlot_attention_decode_smem.restype = ctypes.c_long
        lib.merlot_attention_decode_max_clusters.argtypes = [i] * 5
        lib.merlot_attention_decode_max_clusters.restype = ctypes.c_int
    return lib


# K3's decode launch (csrc/attention_stacked.cu): query rows it takes,
# warps per block, rows of a TMA box (a block's key range is a multiple of
# it), rows of a ring stage, the ring's bytes and most stages, the largest
# cluster, the shared memory a block may use, and the H100's SMs: a plan
# gives the grid at least one block per SM
DECODE_ROWS = 8
DECODE_WARPS = 4
DECODE_BOX_ROWS = 8
DECODE_STAGE_ROWS = 32
DECODE_RING_BYTES = 32 * 1024
DECODE_MAX_STAGES = 32
DECODE_MAX_CLUSTER = 16
MAX_SMEM = 227 * 1024
SM_COUNT = 132
_DEC_ALIGN = 128


def _align(n: int) -> int:
    return -(-n // _DEC_ALIGN) * _DEC_ALIGN


def decode_chunk_rows(kv_len: int, cluster: int) -> int:
    """Keys of each block's range: ceil(kv_len / cluster) rounded up to a
    whole TMA box."""
    n = -(-kv_len // cluster)
    return -(-n // DECODE_BOX_ROWS) * DECODE_BOX_ROWS


def decode_stages(sk: int, d: int, elem: int, cluster: int) -> int:
    """Stages of a block's ring: enough for all its key and value rows at
    kv_len = sk, at most DECODE_RING_BYTES, a multiple of the warps (each
    stage is read by one warp), at most DECODE_MAX_STAGES."""
    need = 2 * -(-decode_chunk_rows(sk, cluster) // DECODE_STAGE_ROWS)
    n = min(need, DECODE_RING_BYTES // (DECODE_STAGE_ROWS * d * elem))
    return min(DECODE_MAX_STAGES, -(-n // DECODE_WARPS) * DECODE_WARPS)


def decode_smem_bytes(sq: int, sk: int, d: int, elem: int, cluster: int) -> int:
    """A decode block's shared memory (``decode_layout`` in
    attention_stacked.cu): the ring, the score rows (sized for kv_len = sk),
    the warps' partial contexts, the ranks' partial contexts of its
    elements, the ranks' and the warps' row max and sum, the stages'
    mbarriers, and the base's alignment."""
    gather_ld = -(-sq * d // cluster)
    return (_align(decode_stages(sk, d, elem, cluster) * DECODE_STAGE_ROWS * d * elem)
            + _align(sq * decode_chunk_rows(sk, cluster) * 4)
            + _align(DECODE_WARPS * sq * d * 4) + _align(cluster * gather_ld * 4)
            + _align(DECODE_MAX_CLUSTER * DECODE_ROWS * 8)
            + _align((DECODE_WARPS + 1) * DECODE_ROWS * 8) + 8 * DECODE_MAX_STAGES
            + _DEC_ALIGN)


def decode_plan(b: int, h: int, sq: int, sk: int, d: int, elem: int) -> dict:
    """K3's decode launch for [b, sq, h*d] queries over a cache of sk slots,
    elem bytes each: the smallest power-of-two cluster (1 to 16 blocks) that
    gives the grid a block for every SM. The shape alone decides it, so the
    launch does not change with kv_len."""
    cluster = 1
    while cluster < DECODE_MAX_CLUSTER and b * h * cluster < SM_COUNT:
        cluster *= 2
    return {"cluster": cluster, "blocks": b * h * cluster,
            "rows_per_block": decode_chunk_rows(sk, cluster),
            "stages": decode_stages(sk, d, elem, cluster),
            "smem_bytes": decode_smem_bytes(sq, sk, d, elem, cluster)}


_decode_plan = lru_cache(maxsize=None)(decode_plan)


@lru_cache(maxsize=None)
def _check_decode_plan(device_index: int, sq: int, sk: int, d: int, is_bf16: int,
                       cluster: int, smem: int) -> None:
    """Raise unless the kernel agrees with the plan's shared memory and the
    card can hold at least one of its clusters (once per plan and card)."""
    lib = load_stacked_kernel()
    with torch.cuda.device(device_index):
        got = lib.merlot_attention_decode_smem(sq, sk, d, is_bf16, cluster)
        if got != smem:
            raise RuntimeError(f"attention_stacked: plan shared memory {smem} != "
                               f"kernel's {got}")
        n = lib.merlot_attention_decode_max_clusters(sq, sk, d, is_bf16, cluster)
    if n < 1:
        raise RuntimeError(f"attention_stacked: a cluster of {cluster} blocks with {smem} "
                           f"bytes of shared memory cannot be scheduled on this card ({n})")


def _check_inputs(name: str, q3, k3, v3, mask, num_heads: int,
                  like_q=(), fp32=()) -> Tuple[int, int, int, int]:
    """Validate a launch's tensors; returns (B, Sq, Sk, d_head). ``like_q``
    must match q3's shape and dtype; ``fp32`` are fp32 tensors of any
    shape (their shapes are the caller's to check)."""
    present = [t for t in (q3, k3, v3, mask, *like_q, *fp32) if t is not None]
    if any(t.device.type != "cuda" or t.device != q3.device for t in present):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if q3.dtype not in _DTYPE_CODE or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise ValueError(f"{name}: q/k/v must share dtype fp32 or bf16, "
                         f"got {q3.dtype}, {k3.dtype}, {v3.dtype}")
    if not all(t.is_contiguous() for t in present):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in present):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if q3.dim() != 3 or k3.dim() != 3 or v3.shape != k3.shape:
        raise ValueError(f"{name}: bad shapes {tuple(q3.shape)}, "
                         f"{tuple(k3.shape)}, {tuple(v3.shape)}")
    b, sq, hd = q3.shape
    sk = k3.shape[1]
    if k3.shape[0] != b or k3.shape[2] != hd or hd % num_heads != 0:
        raise ValueError(f"{name}: bad shapes {tuple(q3.shape)}, "
                         f"{tuple(k3.shape)} for {num_heads} heads")
    d = hd // num_heads
    if not kernel_supported(sq, sk, d, q3.dtype):
        raise ValueError(f"{name}: unsupported Sq={sq} Sk={sk} d={d} for {q3.dtype}")
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape) != (b, sq, sk)):
        raise ValueError(f"{name}: mask must be fp32 {(b, sq, sk)}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    for t in like_q:
        if t.shape != q3.shape or t.dtype != q3.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does not match "
                             f"q {tuple(q3.shape)} {q3.dtype}")
    if any(t is not None and t.dtype != torch.float32 for t in fp32):
        raise ValueError(f"{name}: expected fp32")
    return b, sq, sk, d


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def attention_fwd_cuda(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                       mask: Optional[torch.Tensor], *, num_heads: int,
                       softmax_fp32: bool, collect_colsum: bool,
                       stats: Optional[torch.Tensor] = None,
                       tile_class: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K1. q3 [B, Sq, H*D]; k3/v3 [B, Sk, H*D], contiguous CUDA
    tensors of one dtype (fp32, or bf16 with a head dim that is a multiple
    of 16); mask [B, Sq, Sk] contiguous fp32 or None. stats: None, or a
    [3, B, H, Sq] fp32 buffer (``new_stats``) whose first two planes
    receive each row's softmax max and sum, for ``attention_bwd_cuda``.
    tile_class: for fp32 with a mask, a ``new_tile_class`` buffer that
    receives the mask's tile classes (for ``attention_bwd_cuda``), or None
    (one is made). Returns (ctx [B, Sq, H*D] in q3.dtype, colsum [B, Sk]
    fp32 or None)."""
    global launches
    out = _fwd_launch("attention_fwd_cuda", q3, k3, v3, mask, num_heads, softmax_fp32,
                      collect_colsum, None, stats, tile_class)
    launches += 1
    return out


def new_stats(q3: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The [3, B, H, Sq] fp32 buffer of the softmax's row max and sum (K1
    writes them) and D = rowsum(dP * P) (K2 writes it)."""
    b, sq, _ = q3.shape
    return torch.empty((3, b, num_heads, sq), dtype=torch.float32, device=q3.device)


def tile_class_shape(mask: torch.Tensor) -> Tuple[int, int, int]:
    """[Bm, ceil(Sq / 64), ceil(Sk / 64)]: a [Bm, Sq, Sk] mask's tiles."""
    bm, sq, sk = mask.shape
    return bm, -(-sq // TILE), -(-sk // TILE)


def new_tile_class(mask: torch.Tensor) -> torch.Tensor:
    """The uint8 buffer that receives the classes (0 all 0, 1 all 1, 2
    mixed) of a mask's 64 x 64 tiles (``tile_class_shape``), filled by the
    fp32 kernels."""
    return torch.empty(tile_class_shape(mask), dtype=torch.uint8, device=mask.device)


def _tile_class_for(name: str, tile_class, q3, mask):
    """The tile-class buffer a launch passes: None unless fp32 with a mask;
    a new one when none is given; else the given one, checked."""
    if q3.dtype != torch.float32 or mask is None:
        return None
    if tile_class is None:
        return new_tile_class(mask)
    want = tile_class_shape(mask)
    if (tile_class.dtype != torch.uint8 or tuple(tile_class.shape) != want
            or not tile_class.is_contiguous() or tile_class.device != q3.device):
        raise ValueError(f"{name}: tile_class must be contiguous uint8 {want} on {q3.device}, "
                         f"got {tile_class.dtype} {tuple(tile_class.shape)}")
    return tile_class


def _check_stats(name: str, stats, q3, num_heads: int) -> None:
    b, sq, _ = q3.shape
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (3, b, num_heads, sq)
            or not stats.is_contiguous() or stats.device != q3.device):
        raise ValueError(f"{name}: stats must be contiguous fp32 {(3, b, num_heads, sq)} "
                         f"on {q3.device}, got {stats.dtype} {tuple(stats.shape)}")


def attention_fwd_variant_cuda(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                               mask: Optional[torch.Tensor], *, num_heads: int,
                               softmax_fp32: bool, collect_colsum: bool, variant: str
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch one of K1's ablation variants (``VARIANTS``), bf16 with a
    head dim of 64 only, for timing; arguments and results as for
    ``attention_fwd_cuda``."""
    if q3.dtype != torch.bfloat16:
        raise ValueError("attention_fwd_variant_cuda: bf16 only")
    return _fwd_launch("attention_fwd_variant_cuda", q3, k3, v3, mask, num_heads,
                       softmax_fp32, collect_colsum, VARIANTS[variant])


def _fwd_launch(name, q3, k3, v3, mask, num_heads, softmax_fp32, collect_colsum,
                variant, stats=None, tile_class=None):
    b, sq, sk, d = _check_inputs(name, q3, k3, v3, mask, num_heads)
    if stats is not None:
        _check_stats(name, stats, q3, num_heads)
    tile_class = _tile_class_for(name, tile_class, q3, mask)
    lib = load_kernel()
    out = torch.empty_like(q3)
    part = colsum = None
    if collect_colsum:
        n_tiles = -(-sq // TILE)
        part = torch.empty((b, num_heads, n_tiles, sk), dtype=torch.float32,
                           device=q3.device)
        colsum = torch.empty((b, sk), dtype=torch.float32, device=q3.device)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    args = (_ptr(q3), _ptr(k3), _ptr(v3), _ptr(mask), _ptr(out), _ptr(part),
            _ptr(colsum), _ptr(stats), _ptr(tile_class), b, sq, sk, num_heads, d,
            _DTYPE_CODE[q3.dtype], int(softmax_fp32), 1.0 / (d ** 0.5), stream)
    err = (lib.merlot_attention_fwd(*args) if variant is None
           else lib.merlot_attention_fwd_variant(*args, variant))
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel failed: cudaError_t {err}")
    return out, colsum


def attention_bwd_cuda(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                       mask: Optional[torch.Tensor], g3: torch.Tensor,
                       gcol: Optional[torch.Tensor], *, num_heads: int,
                       softmax_fp32: bool, stats: Optional[torch.Tensor] = None,
                       tile_class: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2. q3/k3/v3/mask as for ``attention_fwd_cuda``; g3 the
    cotangent of ctx (like q3, contiguous); gcol the cotangent of the
    colsum [B, Sk] fp32 or None; stats the buffer K1 filled with the row max
    and sum on the same inputs, and for fp32 with a mask tile_class the
    classes K1 wrote beside them; or None for both: K2 then computes them
    first (K1's stats-only pass). Returns (dq, dk, dv) in the input
    dtype."""
    global bwd_launches
    b, sq, sk, d = _check_inputs("attention_bwd_cuda", q3, k3, v3, mask, num_heads,
                                 like_q=(g3,), fp32=(gcol,))
    if gcol is not None and tuple(gcol.shape) != (b, sk):
        raise ValueError(f"attention_bwd_cuda: gcol must be {(b, sk)}, "
                         f"got {tuple(gcol.shape)}")
    saved = stats is not None
    if saved:
        _check_stats("attention_bwd_cuda", stats, q3, num_heads)
        if q3.dtype == torch.float32 and mask is not None and tile_class is None:
            raise ValueError("attention_bwd_cuda: saved fp32 stats need K1's tile_class")
    else:
        stats = new_stats(q3, num_heads)
        tile_class = None
    tile_class = _tile_class_for("attention_bwd_cuda", tile_class, q3, mask)
    lib = load_bwd_kernel()
    dq, dk, dv = torch.empty_like(q3), torch.empty_like(k3), torch.empty_like(v3)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    err = lib.merlot_attention_bwd(
        _ptr(q3), _ptr(k3), _ptr(v3), _ptr(mask), _ptr(g3), _ptr(gcol),
        _ptr(dq), _ptr(dk), _ptr(dv), _ptr(stats), int(saved), _ptr(tile_class), b, sq, sk,
        num_heads, d, _DTYPE_CODE[q3.dtype], int(softmax_fp32), 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel failed: cudaError_t {err}")
    bwd_launches += 1
    return dq, dk, dv


def _check_stacked(q3, kv3, mask, num_heads: int) -> Tuple[int, int, int, int]:
    """Validate K3's tensors; returns (B, Sq, Sk, d_head)."""
    name = "attention_stacked_fwd_cuda"
    present = [t for t in (q3, kv3, mask) if t is not None]
    if any(t.device.type != "cuda" or t.device != q3.device for t in present):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if q3.dtype not in _DTYPE_CODE or kv3.dtype != q3.dtype:
        raise ValueError(f"{name}: q/kv must share dtype fp32 or bf16, "
                         f"got {q3.dtype}, {kv3.dtype}")
    if not all(t.is_contiguous() for t in present):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in present):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if q3.dim() != 3 or kv3.dim() != 3 or q3.shape[2] % num_heads != 0:
        raise ValueError(f"{name}: bad shapes {tuple(q3.shape)}, {tuple(kv3.shape)} "
                         f"for {num_heads} heads")
    b, sq, hd = q3.shape
    sk = kv3.shape[1]
    if tuple(kv3.shape) != (b, sk, 2 * hd):
        raise ValueError(f"{name}: kv must be {(b, sk, 2 * hd)}, got {tuple(kv3.shape)}")
    d = hd // num_heads
    # the decode path reads a head's row in 16-byte vectors
    if not kernel_supported(sq, sk, d, q3.dtype) or d % (16 // q3.element_size()):
        raise ValueError(f"{name}: unsupported Sq={sq} Sk={sk} d={d} for {q3.dtype}")
    if mask is not None and (mask.dtype != torch.float32 or mask.dim() != 3
                             or mask.shape[0] not in (1, b)
                             or tuple(mask.shape[1:]) != (sq, sk)):
        raise ValueError(f"{name}: mask must be fp32 {(b, sq, sk)} or {(1, sq, sk)}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    return b, sq, sk, d


def _live_len(kv_len: Optional[int], sk: int) -> int:
    """kv_len, or sk for None; raises unless 1 <= kv_len <= sk."""
    if kv_len is None:
        return sk
    if not 1 <= kv_len <= sk:
        raise ValueError(f"attention_stacked: kv_len {kv_len} not in [1, {sk}]")
    return int(kv_len)


def attention_stacked_fwd_cuda(q3: torch.Tensor, kv3: torch.Tensor,
                               mask: Optional[torch.Tensor], *, num_heads: int,
                               softmax_fp32: bool, kv_len: Optional[int] = None
                               ) -> torch.Tensor:
    """Launch K3. q3 [B, Sq, H*D]; kv3 [B, Sk, 2*H*D] with keys in columns
    [:H*D] and values in [H*D:], contiguous CUDA tensors of one dtype (fp32,
    or bf16 with a head dim that is a multiple of 16); mask [B, Sq, Sk] or
    [1, Sq, Sk] (one for the whole batch) contiguous fp32, or None. kv_len:
    the live slots (None: all Sk); the caller promises that the mask is 0 at
    every slot >= kv_len for every query row and that every query row
    attends to some slot below kv_len, so the result is the one over all Sk
    slots. The decode kernel (Sq <= 8) then reads nothing past kv_len.
    Returns ctx [B, Sq, H*D] in q3.dtype."""
    global stacked_launches
    b, sq, sk, d = _check_stacked(q3, kv3, mask, num_heads)
    live = _live_len(kv_len, sk)
    lib = load_stacked_kernel()
    is_bf16 = _DTYPE_CODE[q3.dtype]
    cluster = 1
    if sq <= DECODE_ROWS:
        plan = _decode_plan(b, num_heads, sq, sk, d, q3.element_size())
        cluster = plan["cluster"]
        _check_decode_plan(q3.device.index if q3.device.index is not None
                           else torch.cuda.current_device(),
                           sq, sk, d, is_bf16, cluster, plan["smem_bytes"])
    out = torch.empty_like(q3)
    tile_class = (_tile_class_for("attention_stacked_fwd_cuda", None, q3, mask)
                  if sq > DECODE_ROWS else None)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    err = lib.merlot_attention_stacked_fwd(
        _ptr(q3), _ptr(kv3), _ptr(mask), _ptr(out), _ptr(tile_class), b, sq, sk, live,
        num_heads, d,
        int(mask is not None and mask.shape[0] == b), is_bf16, int(softmax_fp32), cluster,
        1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"attention_stacked kernel failed: cudaError_t {err}")
    stacked_launches += 1
    return out


def flash_attention_stacked_plain(q3: torch.Tensor, kv3: torch.Tensor,
                                  mask: Optional[torch.Tensor], *, num_heads: int,
                                  softmax_fp32: bool, kv_len: Optional[int] = None
                                  ) -> torch.Tensor:
    """K3's function in plain PyTorch, same arguments and result: the keys
    and values are the two column halves of kv3; with kv_len, the cache and
    the mask are cut to their first kv_len slots."""
    b, sq, hd = q3.shape
    sk = _live_len(kv_len, kv3.shape[1])
    kv3 = kv3[:, :sk]
    if mask is not None:
        mask = mask[..., :sk]
    d = hd // num_heads
    ctx, _ = _plain_attention(
        q3.reshape(b, sq, num_heads, d), kv3[..., :hd].reshape(b, sk, num_heads, d),
        kv3[..., hd:].reshape(b, sk, num_heads, d), mask, collect="none",
        softmax_fp32=softmax_fp32)
    return ctx.reshape(b, sq, hd)


def flash_attention_stacked(q: torch.Tensor, kv: torch.Tensor,
                            mask: Optional[torch.Tensor], *,
                            softmax_fp32: bool = False,
                            kv_len: Optional[int] = None) -> torch.Tensor:
    """Forward-only attention over a stacked KV buffer (serving). q
    [B, Sq, H, D]; kv [B, Sk, 2*H*D], keys in columns [:H*D], values in
    [H*D:]; mask [B or 1, Sq, Sk] (1 = attend) or None; kv_len the live
    slots (None: all Sk) under the contract of ``attention_stacked_fwd_cuda``.
    Returns ctx [B, Sq, H, D]: K3 on CUDA tensors (a shape it refuses
    raises), the plain version on CPU tensors."""
    b, sq, h, d = q.shape
    q3 = q.reshape(b, sq, h * d)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32, kv_len=kv_len)
    if q.device.type == "cuda":
        ctx = attention_stacked_fwd_cuda(q3.contiguous(), kv, mask, **kw)
    elif q.device.type == "cpu":
        ctx = flash_attention_stacked_plain(q3, kv, mask, **kw)
    else:
        raise ValueError(f"flash_attention_stacked: no path for device {q.device}")
    return ctx.reshape(b, sq, h, d)


def flash_attention_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                          mask: Optional[torch.Tensor], *, num_heads: int,
                          softmax_fp32: bool, collect_colsum: bool
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's function in plain PyTorch, same arguments and results (the
    saved stats' plain version is ``softmax_stats_plain``)."""
    b, sq, hd = q3.shape
    sk = k3.shape[1]
    d = hd // num_heads
    ctx, colsum = _plain_attention(
        q3.reshape(b, sq, num_heads, d), k3.reshape(b, sk, num_heads, d),
        v3.reshape(b, sk, num_heads, d), mask,
        collect="colsum" if collect_colsum else "none",
        softmax_fp32=softmax_fp32)
    return ctx.reshape(b, sq, hd), colsum


def softmax_stats_plain(q3: torch.Tensor, k3: torch.Tensor, mask: Optional[torch.Tensor],
                        *, num_heads: int, softmax_fp32: bool) -> torch.Tensor:
    """The statistics K1 saves, in plain PyTorch: [2, B, H, Sq] fp32, each
    row's max of the rounded, masked scores and its fp32 sum of
    exp(score - max)."""
    b, sq, hd = q3.shape
    sk = k3.shape[1]
    d = hd // num_heads
    s = attention_scores(q3.reshape(b, sq, num_heads, d), k3.reshape(b, sk, num_heads, d),
                         mask, softmax_fp32=softmax_fp32).float()
    mx = s.amax(dim=-1)
    return torch.stack([mx, torch.exp(s - mx[..., None]).sum(dim=-1)])


def attention_bwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        mask: Optional[torch.Tensor], g3: torch.Tensor,
                        gcol: Optional[torch.Tensor], *, num_heads: int,
                        softmax_fp32: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch (the TPU kernel's ``_attn_bwd_kernel``),
    same arguments and results: P recomputed as the forward computes it and
    held in fp32, every product on fp32 operands."""
    b, sq, hd = q3.shape
    sk = k3.shape[1]
    d = hd // num_heads
    scale = 1.0 / (d ** 0.5)
    q, do = (t.reshape(b, sq, num_heads, d) for t in (q3, g3))
    k, v = (t.reshape(b, sk, num_heads, d) for t in (k3, v3))
    p = attention_probs(q, k, mask, softmax_fp32=softmax_fp32).float()
    do, q, k, v = do.float(), q.float(), k.float(), v.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    if gcol is not None:
        dp = dp + (gcol.float() / num_heads)[:, None, None, :]
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if mask is not None:
        ds = ds * mask.float()[:, None]
    ds = ds * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return (dq.reshape(b, sq, hd).to(q3.dtype), dk.reshape(b, sk, hd).to(k3.dtype),
            dv.reshape(b, sk, hd).to(v3.dtype))


def attention_fwd_body(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                       mask: Optional[torch.Tensor], num_heads: int, softmax_fp32: bool,
                       collect_colsum: bool, save_stats: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``FlashAttention``'s forward, also as one dispatcher op
    (``attention_fwd_op``) so that torch's selective checkpoint can name
    it (``nn.transformer``'s remat policy 'probs' keeps its outputs, and
    the recompute then launches nothing; ``named_ops`` says when the op is
    taken): K1 on CUDA tensors, its plain version on CPU tensors. Returns (ctx,
    colsum, stats, tile_class); with ``save_stats`` on a card, stats is
    K1's row max and sum (``new_stats``) and tile_class the mask's tile
    classes (fp32 with a mask), which K2 reads. What is not made is an
    empty tensor."""
    kw = dict(num_heads=num_heads, softmax_fp32=softmax_fp32, collect_colsum=collect_colsum)
    stats = tile_class = None
    if q3.device.type == "cuda":
        if save_stats:
            stats = new_stats(q3, num_heads)
            tile_class = _tile_class_for("flash_attention", None, q3, mask)
        out, colsum = attention_fwd_cuda(q3, k3, v3, mask, stats=stats,
                                         tile_class=tile_class, **kw)
    elif q3.device.type == "cpu":
        out, colsum = flash_attention_plain(q3, k3, v3, mask, **kw)
    else:
        raise ValueError(f"flash_attention: no path for device {q3.device}")
    return tuple(q3.new_empty(0, dtype=torch.float32) if t is None else t
                 for t in (out, colsum, stats, tile_class))


attention_fwd_op = torch.library.custom_op("merlot_tpu_torch::attention_fwd",
                                           attention_fwd_body, mutates_args=())
# the op as the dispatcher names it (what a selective checkpoint sees)
ATTENTION_FWD = torch.ops.merlot_tpu_torch.attention_fwd


def _present(t: torch.Tensor) -> Optional[torch.Tensor]:
    return None if t.numel() == 0 else t


class FlashAttention(torch.autograd.Function):
    """Attention with K1 as its forward and K2 as its backward on CUDA
    tensors, and their plain versions on CPU tensors (the custom_vjp
    ``_flash_p`` of the JAX package). Inputs as for ``attention_fwd_cuda``;
    returns (ctx, colsum or None). The forward is ``attention_fwd_body``,
    through its op inside ``named_ops.through_ops()``."""

    @staticmethod
    def forward(ctx, q3, k3, v3, mask, num_heads: int, softmax_fp32: bool,
                collect_colsum: bool):
        # K2 takes the softmax's row max and sum from K1, and in fp32 the
        # mask's tile classes
        fwd = ATTENTION_FWD if named_ops.active() else attention_fwd_body
        out, colsum, stats, tile_class = (_present(t) for t in fwd(
            q3, k3, v3, mask, num_heads, softmax_fp32, collect_colsum,
            any(ctx.needs_input_grad[:3])))
        ctx.save_for_backward(q3, k3, v3, mask, stats, tile_class)
        ctx.num_heads, ctx.softmax_fp32 = num_heads, softmax_fp32
        ctx.set_materialize_grads(False)
        return out, colsum

    @staticmethod
    def backward(ctx, g_ctx, g_colsum):
        q3, k3, v3, mask, stats, tile_class = ctx.saved_tensors
        g3 = torch.zeros_like(q3) if g_ctx is None else g_ctx.contiguous()
        gcol = None if g_colsum is None else g_colsum.float().contiguous()
        kw = dict(num_heads=ctx.num_heads, softmax_fp32=ctx.softmax_fp32)
        if q3.device.type == "cuda":
            dq, dk, dv = attention_bwd_cuda(q3, k3, v3, mask, g3, gcol, stats=stats,
                                            tile_class=tile_class, **kw)
        else:
            dq, dk, dv = attention_bwd_plain(q3, k3, v3, mask, g3, gcol, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], *, collect: str = "none",
                    softmax_fp32: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """attention_core-compatible entry. q [B, Sq, H, D]; k/v [B, Sk, H, D];
    mask [B, Sq, Sk] (1 = attend) or None. Returns (ctx [B, Sq, H, D],
    colsum [B, Sk] fp32 or None), differentiable through
    ``FlashAttention``."""
    if collect not in ("none", "colsum"):
        raise ValueError(f"bad collect={collect}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    ctx, colsum = FlashAttention.apply(
        q.reshape(b, sq, h * d), k.reshape(b, sk, h * d), v.reshape(b, sk, h * d),
        mask, h, softmax_fp32, collect == "colsum")
    return ctx.reshape(b, sq, h, d), colsum
