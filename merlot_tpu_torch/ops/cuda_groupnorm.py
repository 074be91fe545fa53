"""Fused GroupNorm(+residual+ReLU) for Hopper (K4) and its plain PyTorch
version (counterpart of merlot_tpu/ops/pallas_groupnorm.py).

The kernel is ``csrc/groupnorm.cu``, built with nvcc at first use and called
through ctypes. It computes ``relu(group_norm(x) + residual)`` over a
channels-last [B, ..., C] tensor in the operation order of the TPU kernel
``_gn_kernel`` (``norms.group_norm_act_plain``) and emits the fp32 group
statistics (mean, rstd) [B, G] for the saved-stats backward.

``GroupNormAct`` is the custom_vjp ``_gn_act_p``: its forward launches K4 for
CUDA tensors and runs the plain version for CPU tensors, never one in place
of the other; its backward is ``norms.group_norm_act_bwd`` in PyTorch, as
JAX's backward is XLA math. ``group_norm_act`` picks the implementation by
``backend``: 'plain' is the unfused composition ``norms.group_norm_act``,
'cuda' is ``GroupNormAct``. ``BACKEND`` (forward-only paths) and
``TRAIN_BACKEND`` (training) are the defaults, both 'plain', as JAX defaults
both of its module switches to 'xla'. ``launches`` counts K4 launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from merlot_tpu_torch._build import load_library
from merlot_tpu_torch.ops import norms

BACKEND = "plain"
TRAIN_BACKEND = "plain"

# launches of K4 since the last reset (set it to 0 to reset)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K4's library."""
    lib = load_library("groupnorm")
    fn = lib.merlot_group_norm_act
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i] * 6 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        ws = lib.merlot_group_norm_workspace
        ws.argtypes = [i] * 4
        ws.restype = ctypes.c_long
    return lib


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
    """Channel counts and dtypes K4 takes: each thread reads 16 bytes of one
    row, so C must be a multiple of 8 (bf16) or 4 (fp32), and a block spans
    at most 256 such vectors (C <= 2048 bf16, 1024 fp32)."""
    if dtype not in _DTYPE_CODE or num_groups <= 0 or c % num_groups:
        return False
    per_vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return c % per_vec == 0 and c // per_vec <= 256


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
    out = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    part = torch.empty(lib.merlot_group_norm_workspace(b, hw, c, is_bf16),
                       dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.merlot_group_norm_act(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), b, hw, c, num_groups,
        is_bf16, int(relu), epsilon, stream)
    if err != 0:
        raise RuntimeError(f"groupnorm kernel failed: cudaError_t {err}")
    launches += 1
    return out, mean, rstd


class GroupNormAct(torch.autograd.Function):
    """``relu(group_norm(x) + residual)`` with K4 as its forward on CUDA
    tensors and the plain version on CPU tensors; the backward is
    ``norms.group_norm_act_bwd`` from the saved (x, mean, rstd) and, with
    ReLU, the output (the custom_vjp ``_gn_act_p`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, num_groups: int, epsilon: float,
                relu: bool):
        if x.device.type == "cuda":
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
        dx, dgamma, dbeta, dres = norms.group_norm_act_bwd(
            dy, x, gamma, mean, rstd, out, ctx.has_residual, ctx.num_groups)
        return dx, dgamma, dbeta, dres, None, None, None


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                   residual: Optional[torch.Tensor] = None, num_groups: int = 32,
                   epsilon: float = 1e-4, relu: bool = False,
                   backend: Optional[str] = None) -> torch.Tensor:
    """``relu(group_norm(x) + residual)`` over channels-last x. backend
    'plain' runs the unfused composition; 'cuda' runs ``GroupNormAct`` (K4
    on a CUDA tensor, raising on what K4 refuses; its plain version on a CPU
    tensor); None takes ``BACKEND``."""
    backend = BACKEND if backend is None else backend
    if backend == "plain":
        return norms.group_norm_act(x, gamma, beta, residual=residual,
                                    num_groups=num_groups, epsilon=epsilon, relu=relu)
    if backend == "cuda":
        return GroupNormAct.apply(x, gamma, beta, residual, num_groups, epsilon, relu)
    raise ValueError(f"bad GroupNorm backend={backend!r}, want 'plain' or 'cuda'")
