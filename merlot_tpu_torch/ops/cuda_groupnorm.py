"""Fused GroupNorm(+residual+ReLU) for Hopper, forward (K4) and backward
(K4B), and its plain PyTorch versions (counterpart of
merlot_tpu/ops/pallas_groupnorm.py).

The kernel is ``csrc/groupnorm.cu``, built with nvcc at first use and called
through ctypes. It computes ``relu(group_norm(x) + residual)`` over a
channels-last [B, ..., C] tensor in the operation order of the TPU kernel
``_gn_kernel`` (``norms.group_norm_act_plain``) and emits the fp32 group
statistics (mean, rstd) [B, G] for the saved-stats backward. One launch per
call: one thread-block cluster per image, whose size and resident rows
``launch_plan`` picks from the shape alone.

K4B (the same library) is its backward from the saved statistics: one
cluster per image on the same kind of plan (two resident slabs, x and dy,
in place of one), then a second small launch that sums the images'
per-channel partials in order into dgamma and dbeta.

``GroupNormAct`` is the custom_vjp ``_gn_act_p``: on CUDA tensors its
forward launches K4 and its backward K4B; on CPU tensors it runs the plain
versions (``norms.group_norm_act_plain`` and ``norms.group_norm_act_bwd``),
never one in place of the other. ``group_norm_act`` picks the
implementation by ``backend``: 'plain' is the unfused composition
``norms.group_norm_act``, 'cuda' is ``GroupNormAct``, and 'auto' (the
default, ``BACKEND``, on forward-only and training calls alike) is
``GroupNormAct`` on a CUDA tensor, which raises on a shape the kernels
refuse, and the composition on every other tensor (the CPU parity tests'
path). The JAX package defaults to its composition ('xla'), which XLA fuses
on the TPU; on the H100 the composition is ~15 ATen passes forward and ~25
backward. ``launches`` counts K4 launches, ``bwd_launches`` K4B calls (two
launches each). While a profiler records, every call counts ``gn.kernel``
in the port's trace: 1 where it ran the kernels, 0 where it ran the
composition.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from merlot_tpu_torch._build import load_library
from merlot_tpu_torch.core import trace
from merlot_tpu_torch.ops import norms

BACKEND = "auto"

# launches of K4, and calls of K4B, since the last reset (set to 0 to reset)
launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# the kernel's launch (csrc/groupnorm.cu): threads per block at most, bulk
# copies per block, the largest cluster, and the shared memory a block may
# use so that two blocks fit on an SM (228 KB, 1 KB of it per block kept by
# the card)
MAX_THREADS = 256
PIECES = 4
MAX_CLUSTER = 16
SMEM_TARGET = 113 * 1024
MAX_SMEM = 227 * 1024


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(res_rows: int, c: int, groups: int, elem: int, slabs: int = 1) -> int:
    """A block's shared memory: its resident rows (K4: of x; K4B, slabs=2:
    of x and dy), the threads' channel sums (of x and x^2; of dyg and
    dyg * x_hat), the per-channel and per-group partials, the group stats,
    the mbarriers (``layout`` in groupnorm.cu)."""
    v = c // (16 // elem)
    r = MAX_THREADS // v
    return (_round16(slabs * res_rows * c * elem) + _round16(2 * r * c * 4)
            + _round16(2 * c * 4) + 2 * _round16(2 * groups * 4) + PIECES * 8)


def launch_plan(hw: int, c: int, groups: int, elem: int, slabs: int = 1) -> dict:
    """K4's launch (K4B's with slabs=2) for images of hw rows of c channels,
    elem bytes each: the smallest power-of-two cluster (up to 16 blocks)
    whose blocks each keep their ceil(hw / cluster) rows of every slab
    resident within SMEM_TARGET; where even 16 cannot (K4: a slab over
    ~1.6 MB), 16 blocks keep what fits and read the rest of their rows from
    global memory."""
    fixed = smem_bytes(0, c, groups, elem, slabs)
    cap = max(0, (SMEM_TARGET - fixed) // (slabs * c * elem))
    cluster = 1
    while cluster < MAX_CLUSTER and -(-hw // cluster) > cap:
        cluster *= 2
    rows = -(-hw // cluster)
    res_rows = min(rows, cap)
    return {"cluster": cluster, "rows_per_block": rows, "res_rows": res_rows,
            "smem_bytes": smem_bytes(res_rows, c, groups, elem, slabs)}


_launch_plan = lru_cache(maxsize=None)(launch_plan)


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K4's and K4B's library."""
    lib = load_library("groupnorm")
    fn = lib.merlot_group_norm_act
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i] * 6 + [ctypes.c_float] + [i] * 3 + [ptr]
        fn.restype = ctypes.c_int
        lib.merlot_group_norm_act_bwd.argtypes = [ptr] * 11 + [i] * 8 + [ptr]
        lib.merlot_group_norm_act_bwd.restype = ctypes.c_int
        lib.merlot_group_norm_smem.argtypes = [i] * 5
        lib.merlot_group_norm_smem.restype = ctypes.c_long
        lib.merlot_group_norm_max_clusters.argtypes = [i] * 6
        lib.merlot_group_norm_max_clusters.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _check_plan(device_index: int, c: int, groups: int, is_bf16: int, cluster: int,
                res_rows: int, smem: int, slabs: int) -> None:
    """Raise unless the kernel (K4, slabs=1; K4B, 2) agrees with the plan's
    shared memory and the card can hold at least one of its clusters (once
    per plan and card)."""
    lib = load_kernel()
    with torch.cuda.device(device_index):
        got = lib.merlot_group_norm_smem(res_rows, c, groups, is_bf16, slabs)
        if got != smem:
            raise RuntimeError(f"groupnorm: plan shared memory {smem} != kernel's {got}")
        n = lib.merlot_group_norm_max_clusters(c, groups, is_bf16, cluster, res_rows, slabs)
    if n < 1:
        raise RuntimeError(f"groupnorm: a cluster of {cluster} blocks with {smem} bytes "
                           f"of shared memory cannot be scheduled on this card ({n})")


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           residual: Optional[torch.Tensor], num_groups: int) -> Tuple[int, int, int]:
    """Validate K4's tensors; returns (B, HW, C)."""
    name = "group_norm_act_cuda"
    present = [t for t in (x, gamma, beta, residual) if t is not None]
    if any(t.device.type != "cuda" or t.device != x.device for t in present):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if x.dtype not in _DTYPE_CODE or (residual is not None and residual.dtype != x.dtype):
        raise ValueError(f"{name}: x (and residual) must be fp32 or bf16, got {x.dtype}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"{name}: gamma and beta must be fp32")
    # the convolutions hand back channels-last memory: the NHWC view must be
    # contiguous, and nothing is copied here
    if not all(t.is_contiguous() for t in present):
        raise ValueError(f"{name}: inputs must be contiguous (channels-last x)")
    if x.data_ptr() % 16 or (residual is not None and residual.data_ptr() % 16):
        raise ValueError(f"{name}: x and residual must be 16-byte aligned")
    if x.dim() < 2 or (residual is not None and residual.shape != x.shape):
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)}, "
                         f"{None if residual is None else tuple(residual.shape)}")
    b, c = x.shape[0], x.shape[-1]
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"{name}: gamma/beta must be [{c}]")
    if not kernel_supported(c, num_groups, x.dtype):
        raise ValueError(f"{name}: unsupported C={c}, groups={num_groups} for {x.dtype}")
    return b, x.numel() // (b * c), c


def kernel_supported(c: int, num_groups: int, dtype: torch.dtype) -> bool:
    """Channel counts and dtypes K4 and K4B take: each thread reads 16 bytes
    of one row, so C must be a multiple of 8 (bf16) or 4 (fp32), and a
    block spans at most 256 such vectors (C <= 2048 bf16, 1024 fp32)."""
    if dtype not in _DTYPE_CODE or num_groups <= 0 or c % num_groups:
        return False
    per_vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return c % per_vec == 0 and c // per_vec <= 256


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``GroupNormAct`` runs the kernels on ``x`` (else the plain
    versions, on the CPU)."""
    return x.device.type == "cuda"


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None else torch.cuda.current_device()


def group_norm_act_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        residual: Optional[torch.Tensor], *, num_groups: int,
                        epsilon: float, relu: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4. x [B, ..., C] contiguous channels-last CUDA tensor, fp32 or
    bf16; gamma/beta [C] fp32; residual like x or None. Returns (out like x,
    mean [B, G] fp32, rstd [B, G] fp32)."""
    global launches
    b, hw, c = _check(x, gamma, beta, residual, num_groups)
    lib = load_kernel()
    is_bf16 = _DTYPE_CODE[x.dtype]
    plan = _launch_plan(hw, c, num_groups, x.element_size())
    _check_plan(_device_index(x), c, num_groups, is_bf16, plan["cluster"], plan["res_rows"],
                plan["smem_bytes"], 1)
    out = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.merlot_group_norm_act(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), b, hw, c, num_groups, is_bf16, int(relu),
        epsilon, plan["cluster"], plan["rows_per_block"], plan["res_rows"], stream)
    if err != 0:
        raise RuntimeError(f"groupnorm kernel failed: cudaError_t {err}")
    launches += 1
    return out, mean, rstd


def group_norm_act_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            out: Optional[torch.Tensor], has_residual: bool,
                            num_groups: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                       Optional[torch.Tensor]]:
    """Launch K4B, ``norms.group_norm_act_bwd`` on CUDA tensors: dy, x and
    (with ReLU) K4's output ``out`` [B, ..., C] contiguous, one dtype; gamma
    [C], mean and rstd [B, G] fp32 (K4's). Returns (dx like x, dgamma and
    dbeta [C] fp32, dresidual or None: dy under the ReLU's mask, or dy
    itself without the ReLU)."""
    global bwd_launches
    # out is held to what K4 asks of a residual: x's shape, dtype and layout
    b, hw, c = _check(x, gamma, gamma, out, num_groups)
    name = "group_norm_act_bwd_cuda"
    if (dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape
            or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError(f"{name}: dy must be a contiguous, 16-byte aligned tensor like x")
    for t in (mean, rstd):
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (b, num_groups)):
            raise ValueError(f"{name}: mean and rstd must be [{b}, {num_groups}] fp32 "
                             f"on x's device")
    lib = load_kernel()
    is_bf16 = _DTYPE_CODE[x.dtype]
    plan = _launch_plan(hw, c, num_groups, x.element_size(), 2)
    _check_plan(_device_index(x), c, num_groups, is_bf16, plan["cluster"], plan["res_rows"],
                plan["smem_bytes"], 2)
    dx = torch.empty_like(x)
    masked = has_residual and out is not None
    dres = torch.empty_like(x) if masked else (dy if has_residual else None)
    scratch = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.merlot_group_norm_act_bwd(
        x.data_ptr(), dy.data_ptr(), None if out is None else out.data_ptr(),
        gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dres.data_ptr() if masked else None, scratch.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), b, hw, c, num_groups, is_bf16, plan["cluster"],
        plan["rows_per_block"], plan["res_rows"], stream)
    if err != 0:
        raise RuntimeError(f"groupnorm backward kernel failed: cudaError_t {err}")
    bwd_launches += 1
    return dx, dgamma, dbeta, dres


class GroupNormAct(torch.autograd.Function):
    """``relu(group_norm(x) + residual)`` with K4 as its forward and K4B as
    its backward on CUDA tensors, the plain versions on CPU tensors; the
    backward works from the saved (x, mean, rstd) and, with ReLU, the
    output (the custom_vjp ``_gn_act_p`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, num_groups: int, epsilon: float,
                relu: bool):
        if _on_card(x):
            out, mean, rstd = group_norm_act_cuda(x, gamma, beta, residual,
                                                  num_groups=num_groups,
                                                  epsilon=epsilon, relu=relu)
        elif x.device.type == "cpu":
            out, mean, rstd = norms.group_norm_act_plain(x, gamma, beta, residual,
                                                         num_groups, epsilon, relu)
        else:
            raise ValueError(f"group_norm_act: no path for device {x.device}")
        ctx.save_for_backward(x, gamma, mean, rstd, out if relu else None)
        ctx.num_groups, ctx.has_residual = num_groups, residual is not None
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd, out = ctx.saved_tensors
        bwd = group_norm_act_bwd_cuda if _on_card(x) else norms.group_norm_act_bwd
        dx, dgamma, dbeta, dres = bwd(dy.contiguous(), x, gamma, mean, rstd, out,
                                      ctx.has_residual, ctx.num_groups)
        return dx, dgamma, dbeta, dres, None, None, None


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                   residual: Optional[torch.Tensor] = None, num_groups: int = 32,
                   epsilon: float = 1e-4, relu: bool = False,
                   backend: Optional[str] = None) -> torch.Tensor:
    """``relu(group_norm(x) + residual)`` over channels-last x. backend
    'plain' runs the unfused composition; 'cuda' runs ``GroupNormAct`` (K4
    and K4B on a CUDA tensor, raising on what they refuse; their plain
    versions on a CPU tensor); 'auto' runs 'cuda' on a CUDA tensor and
    'plain' elsewhere; None takes ``BACKEND``."""
    backend = BACKEND if backend is None else backend
    if backend == "auto":
        backend = "cuda" if _on_card(x) else "plain"
    if backend == "plain":
        trace.count("gn.kernel", 0.0)
        return norms.group_norm_act(x, gamma, beta, residual=residual,
                                    num_groups=num_groups, epsilon=epsilon, relu=relu)
    if backend == "cuda":
        trace.count("gn.kernel", float(_on_card(x)))
        return GroupNormAct.apply(x, gamma, beta, residual, num_groups, epsilon, relu)
    raise ValueError(f"bad GroupNorm backend={backend!r}, want 'auto', 'plain' or 'cuda'")
