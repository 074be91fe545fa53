"""Attention forward kernel (K1) for Hopper, and its plain PyTorch version.

Counterpart of merlot_tpu/ops/pallas_attention.py ``flash_attention`` /
``_flash_fwd``. The kernel is ``csrc/attention_fwd.cu``, built with nvcc at
first use and called through ctypes. It takes the natural [B, S, H*D]
layout, an optional multiplicative [B, Sq, Sk] fp32 mask, fp32 or bf16
softmax, and optionally returns the colsum [B, Sk] fp32.

``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` for CPU tensors; it never falls back from one to
the other. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from merlot_tpu_torch._build import load_library
from merlot_tpu_torch.ops.attention import _plain_attention

MAX_KERNEL_SEQ = 2048
MAX_HEAD_DIM = 128

# kernel launches since the last reset (set it to 0 to reset)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def kernel_supported(sq: int, sk: int, d_head: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes the kernel takes; callers use the plain path
    otherwise. bf16 runs on the tensor cores in 16-wide head-dim steps, so
    its head dim must be a multiple of 16; fp32 takes any head dim."""
    if dtype not in _DTYPE_CODE:
        return False
    if dtype == torch.bfloat16 and d_head % 16:
        return False
    return sq <= MAX_KERNEL_SEQ and sk <= MAX_KERNEL_SEQ and d_head <= MAX_HEAD_DIM


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = load_library("attention_fwd")
    fn = lib.merlot_attention_fwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i] * 7 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        tile = lib.merlot_attention_fwd_q_tile
        tile.argtypes = []
        tile.restype = i
    return lib


def attention_fwd_cuda(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                       mask: Optional[torch.Tensor], *, num_heads: int,
                       softmax_fp32: bool, collect_colsum: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel. q3 [B, Sq, H*D]; k3/v3 [B, Sk, H*D], contiguous
    CUDA tensors of one dtype (fp32, or bf16 with a head dim that is a
    multiple of 16); mask [B, Sq, Sk] contiguous
    fp32 or None. Returns (ctx [B, Sq, H*D] in q3.dtype, colsum [B, Sk]
    fp32 or None)."""
    global launches
    tensors = [q3, k3, v3] + ([mask] if mask is not None else [])
    if any(t.device.type != "cuda" or t.device != q3.device for t in tensors):
        raise ValueError("attention_fwd_cuda: all tensors must be on one CUDA device")
    if q3.dtype not in _DTYPE_CODE or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise ValueError(f"attention_fwd_cuda: q/k/v must share dtype fp32 or bf16, "
                         f"got {q3.dtype}, {k3.dtype}, {v3.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_fwd_cuda: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("attention_fwd_cuda: inputs must be 16-byte aligned")
    if q3.dim() != 3 or k3.dim() != 3 or v3.shape != k3.shape:
        raise ValueError(f"attention_fwd_cuda: bad shapes {tuple(q3.shape)}, "
                         f"{tuple(k3.shape)}, {tuple(v3.shape)}")
    b, sq, hd = q3.shape
    sk = k3.shape[1]
    if k3.shape[0] != b or k3.shape[2] != hd or hd % num_heads != 0:
        raise ValueError(f"attention_fwd_cuda: bad shapes {tuple(q3.shape)}, "
                         f"{tuple(k3.shape)} for {num_heads} heads")
    d = hd // num_heads
    if not kernel_supported(sq, sk, d, q3.dtype):
        raise ValueError(f"attention_fwd_cuda: unsupported Sq={sq} Sk={sk} d={d} "
                         f"for {q3.dtype}")
    if mask is not None and (mask.dtype != torch.float32
                             or tuple(mask.shape) != (b, sq, sk)):
        raise ValueError(f"attention_fwd_cuda: mask must be fp32 {(b, sq, sk)}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")

    lib = load_kernel()
    out = torch.empty_like(q3)
    part = colsum = None
    if collect_colsum:
        tile = lib.merlot_attention_fwd_q_tile()
        n_tiles = -(-sq // tile)
        part = torch.empty((b, num_heads, n_tiles, sk), dtype=torch.float32,
                           device=q3.device)
        colsum = torch.empty((b, sk), dtype=torch.float32, device=q3.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(q3.device).cuda_stream
    err = lib.merlot_attention_fwd(
        ptr(q3), ptr(k3), ptr(v3), ptr(mask), ptr(out), ptr(part), ptr(colsum),
        b, sq, sk, num_heads, d, _DTYPE_CODE[q3.dtype], int(softmax_fp32),
        1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel failed: cudaError_t {err}")
    launches += 1
    return out, colsum


def flash_attention_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                          mask: Optional[torch.Tensor], *, num_heads: int,
                          softmax_fp32: bool, collect_colsum: bool
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch, same arguments and results."""
    b, sq, hd = q3.shape
    sk = k3.shape[1]
    d = hd // num_heads
    ctx, colsum = _plain_attention(
        q3.reshape(b, sq, num_heads, d), k3.reshape(b, sk, num_heads, d),
        v3.reshape(b, sk, num_heads, d), mask,
        collect="colsum" if collect_colsum else "none",
        softmax_fp32=softmax_fp32)
    return ctx.reshape(b, sq, hd), colsum


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], *, collect: str = "none",
                    softmax_fp32: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """attention_core-compatible entry. q [B, Sq, H, D]; k/v [B, Sk, H, D];
    mask [B, Sq, Sk] (1 = attend) or None. Returns (ctx [B, Sq, H, D],
    colsum [B, Sk] fp32 or None). CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    if collect not in ("none", "colsum"):
        raise ValueError(f"bad collect={collect}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    args = (q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
            v.reshape(b, sk, h * d), mask)
    kw = dict(num_heads=h, softmax_fp32=softmax_fp32,
              collect_colsum=collect == "colsum")
    if q.device.type == "cuda":
        ctx, colsum = attention_fwd_cuda(*args, **kw)
    elif q.device.type == "cpu":
        ctx, colsum = flash_attention_plain(*args, **kw)
    else:
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return ctx.reshape(b, sq, h, d), colsum
