"""LayerNorm fused into its consumer matmuls for Hopper (K5) and its plain
PyTorch version (counterpart of merlot_tpu/ops/pallas_ln_matmul.py).

The kernel is ``csrc/ln_matmul.cu``, built with nvcc at first use and called
through ctypes: per row of x the LayerNorm in fp32 (the two-term
``x*s - mean*s + beta`` form), z rounded to the compute dtype and kept in
shared memory, then the J consumer products with fp32 sums on wgmma, each
rounded to the compute dtype before its bias is added. z is never written
to device memory. ``launch_plan`` is its tile walk: the units of clusters of
two blocks and the W ring's depth, from the shape and the number of
clusters the card holds at once.

``LnMatmul`` is the custom_vjp ``_ln_matmul_full``: its forward launches K5
for CUDA tensors and runs ``norms.ln_matmul_plain`` for CPU tensors, never
one in place of the other. It saves (x, gamma, beta, the stacked fp32
weights), not z, and its backward ``ln_matmul_bwd`` is ``_full_bwd``'s
math in PyTorch: z
recomputed, dW_j = z^T dy_j and db_j = sum dy_j in fp32, dz = sum_j dy_j W_j
with fp32 sums, then the LayerNorm backward. Its products have bf16
operands and fp32 results, as ``preferred_element_type=float32`` gives in
JAX: on a card a cuBLAS bf16 GEMM with an fp32 output (``torch.mm``'s
``out_dtype``), elsewhere the operands widened to fp32 (exact). ``launches``
counts K5 launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence, Tuple

import torch

from merlot_tpu_torch._build import load_library
from merlot_tpu_torch.ops import norms

MAX_K = 1024

# launches of K5 since the last reset (set it to 0 to reset)
launches = 0


def kernel_supported(k: int, n: int, dtype: torch.dtype) -> bool:
    """Shapes and dtypes K5 takes: bf16, K a multiple of 64 up to MAX_K (z
    for a block's rows is held in shared memory), N a multiple of 8. fp32 is
    refused: no config on the port's paths runs the fused LayerNorm in
    fp32 (the CPU runs the plain version)."""
    return dtype == torch.bfloat16 and k % 64 == 0 and 0 < k <= MAX_K and n % 8 == 0


# the kernel's tiles (csrc/ln_matmul.cu): blocks per cluster, rows of x per
# block, output columns per tile, k per W stage, W stages at most, and the
# shared memory a block may use
CLUSTER = 2
BLOCK_ROWS = 64
TILE_N = 256
K_BLOCK = 64
MAX_STAGES = 4
SMEM_ALIGN = 1024
MAX_SMEM = 227 * 1024


def smem_bytes(stages: int, k: int) -> int:
    """Dynamic shared memory of a block: z for its rows (bf16), the W ring,
    the output tile (bf16), the mbarriers (2 per stage, x landed, z free),
    the alignment slack. The same sum as ``smem_bytes`` in ln_matmul.cu."""
    return SMEM_ALIGN + BLOCK_ROWS * k * 2 + stages * TILE_N * K_BLOCK * 2 + \
        BLOCK_ROWS * TILE_N * 2 + (2 * MAX_STAGES + 2) * 8


def launch_plan(m: int, k: int, n: int, j: int, max_clusters: int) -> dict:
    """K5's tile walk for x [m, k] and J = j consumers of n columns: clusters
    of two blocks of 64 rows; the (128-row pair block, 256-column tile)
    units in row-major order, cut into one contiguous range per persistent
    cluster (at most as many clusters as the card holds at once); the
    deepest W ring that fits beside z and the output tiles."""
    stages = next(s for s in range(MAX_STAGES, 1, -1) if smem_bytes(s, k) <= MAX_SMEM)
    pair_blocks = -(-m // (CLUSTER * BLOCK_ROWS))
    col_tiles = -(-(j * n) // TILE_N)
    units = pair_blocks * col_tiles
    return {"stages": stages, "pair_blocks": pair_blocks, "col_tiles": col_tiles,
            "clusters": min(units, max_clusters), "smem_bytes": smem_bytes(stages, k)}


_launch_plan = lru_cache(maxsize=None)(launch_plan)


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K5's library."""
    lib = load_library("ln_matmul")
    fn = lib.merlot_ln_matmul
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 6 + [i] * 4 + [ctypes.c_float, i, ptr]
        fn.restype = ctypes.c_int
        lib.merlot_ln_matmul_smem.argtypes = [i]
        lib.merlot_ln_matmul_smem.restype = ctypes.c_long
        lib.merlot_ln_matmul_max_clusters.argtypes = [i]
        lib.merlot_ln_matmul_max_clusters.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def max_clusters(device_index: int, k: int) -> int:
    """Clusters of K5 the card holds at once at depth k (once per card and
    k); raises if the kernel's shared memory disagrees with the plan's or
    no cluster fits."""
    lib = load_kernel()
    with torch.cuda.device(device_index):
        got = lib.merlot_ln_matmul_smem(k)
        want = launch_plan(1, k, 8, 1, 1)["smem_bytes"]
        if got != want:
            raise RuntimeError(f"ln_matmul: plan shared memory {want} != kernel's {got}")
        n = lib.merlot_ln_matmul_max_clusters(k)
    if n < 1:
        raise RuntimeError(f"ln_matmul: no cluster of {CLUSTER} blocks with {got} bytes "
                           f"of shared memory fits on this card ({n})")
    return n


def ln_matmul_cuda(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w: torch.Tensor, bias: torch.Tensor, *, num_out: int,
                   epsilon: float) -> torch.Tensor:
    """Launch K5. x2 [M, K] bf16; gamma/beta [K] fp32; w [J*N, K] bf16 (the J
    consumers' [N, K] weights stacked); bias [J*N] bf16; all contiguous CUDA
    tensors on one device. Returns y [J, M, N] bf16."""
    global launches
    name = "ln_matmul_cuda"
    ts = (x2, gamma, beta, w, bias)
    if any(t.device.type != "cuda" or t.device != x2.device for t in ts):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    # the kernel reads gamma and beta 16 bytes at a time and the bias 4
    if x2.data_ptr() % 16 or w.data_ptr() % 16 or gamma.data_ptr() % 16 \
            or beta.data_ptr() % 16:
        raise ValueError(f"{name}: x, w, gamma and beta must be 16-byte aligned")
    if bias.data_ptr() % 4:
        raise ValueError(f"{name}: bias must be 4-byte aligned")
    if x2.dim() != 2 or w.dim() != 2 or num_out <= 0 or w.shape[0] % num_out:
        raise ValueError(f"{name}: bad shapes {tuple(x2.shape)}, {tuple(w.shape)} "
                         f"for {num_out} outputs")
    m, k = x2.shape
    jn = w.shape[0]
    n = jn // num_out
    if (w.shape[1] != k or tuple(bias.shape) != (jn,) or tuple(gamma.shape) != (k,)
            or tuple(beta.shape) != (k,)):
        raise ValueError(f"{name}: bad shapes x {tuple(x2.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)}, gamma {tuple(gamma.shape)}")
    if w.dtype != x2.dtype or bias.dtype != x2.dtype or not kernel_supported(k, n, x2.dtype):
        raise ValueError(f"{name}: unsupported K={k} N={n} for x {x2.dtype}, "
                         f"w {w.dtype}, bias {bias.dtype}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"{name}: gamma and beta must be fp32")
    lib = load_kernel()
    index = x2.device.index if x2.device.index is not None else torch.cuda.current_device()
    plan = _launch_plan(m, k, n, num_out, max_clusters(index, k))
    out = torch.empty((num_out, m, n), dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = lib.merlot_ln_matmul(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                               w.data_ptr(), bias.data_ptr(), out.data_ptr(), m, k, n,
                               num_out, epsilon, plan["clusters"], stream)
    if err != 0:
        raise RuntimeError(f"ln_matmul kernel failed: cudaError_t {err}")
    launches += 1
    return out


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32: the exact products of the operands summed in fp32."""
    if a.dtype == torch.bfloat16 and a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class LnMatmul(torch.autograd.Function):
    """``stack_j(layer_norm(x) @ W_j^T + b_j)`` with K5 as its forward on
    CUDA tensors and the plain version on CPU tensors. x [..., K] in the
    compute dtype; gamma/beta [K] fp32; ws [J, N, K] and bs [J, N] the
    stacked fp32 master weights and biases. Returns y [J, ..., N] in x's
    dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, ws, bs, epsilon: float):
        j, n, k = ws.shape
        cdtype = x.dtype
        x2 = x.view(-1, k)
        if x.device.type == "cuda":
            y = ln_matmul_cuda(x2, gamma, beta, ws.to(cdtype).view(j * n, k),
                               bs.to(cdtype).view(j * n), num_out=j, epsilon=epsilon)
        elif x.device.type == "cpu":
            y = torch.stack(norms.ln_matmul_plain(x2, gamma, beta, ws.unbind(0),
                                                  bs.unbind(0), epsilon))
        else:
            raise ValueError(f"ln_matmul: no path for device {x.device}")
        ctx.save_for_backward(x, gamma, beta, ws)
        ctx.epsilon = epsilon
        return y.view(j, *x.shape[:-1], n)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, ws = ctx.saved_tensors
        return (*ln_matmul_bwd(dy, x, gamma, beta, ws, ctx.epsilon), None)


def ln_matmul_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, ws: torch.Tensor, epsilon: float
                  ) -> Tuple[torch.Tensor, ...]:
    """``LnMatmul``'s backward (``_full_bwd``) from its saved (x, gamma,
    beta, ws [J, N, K]) and dy [J, ..., N]: z recomputed, dW_j = dy_j^T z
    and db_j = sum dy_j in fp32, dz = sum_j dy_j W_j with fp32 sums, then the
    LayerNorm backward. Returns (dx in x's dtype, dgamma, dbeta, dws, dbs)
    fp32."""
    j, n, k = ws.shape
    cdtype = x.dtype
    xf = x.reshape(-1, k).float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    g32 = gamma.float()
    scale = rstd * g32
    # the forward's z (two-term form + beta), recomputed
    z = (xf * scale - mean * scale + beta.float()).to(cdtype)
    dy2 = dy.reshape(j, -1, n)
    dws = torch.stack([_mm_f32(dy2[i].t(), z) for i in range(j)])
    dbs = dy2.float().sum(dim=1)
    # dz summed over the consumers, then the LayerNorm backward
    dz = _mm_f32(dy2.permute(1, 0, 2).reshape(-1, j * n), ws.to(cdtype).reshape(j * n, k))
    x_hat = (xf - mean) * rstd
    dgamma = (dz * x_hat).sum(dim=0)
    dbeta = dz.sum(dim=0)
    dx_hat = dz * g32
    m1 = dx_hat.mean(dim=-1, keepdim=True)
    m2 = (dx_hat * x_hat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dx_hat - m1 - x_hat * m2)).to(cdtype).reshape(x.shape)
    return dx, dgamma, dbeta, dws, dbs


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
              epsilon: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """``tuple(linear(layer_norm(x), W_j) + b_j)`` with the LayerNorm fused
    into the products. x [..., K] in the compute dtype; gamma/beta [K] fp32;
    each W_j [N, K] fp32 (all N equal), b_j [N] fp32. One output per
    consumer, differentiable through ``LnMatmul`` (K5 on CUDA tensors,
    raising on what K5 refuses; the plain version on CPU tensors)."""
    y = LnMatmul.apply(x, gamma, beta, torch.stack(tuple(weights)),
                       torch.stack(tuple(biases)), epsilon)
    return tuple(y.unbind(0))
