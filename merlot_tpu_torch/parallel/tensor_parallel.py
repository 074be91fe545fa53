"""The layers of tensor parallelism over a mesh's model axis: what GSPMD
derives for the JAX package from merlot_tpu/parallel/mesh.py's rules,
written out (Megatron's layout). ``parallel.mesh.shard_params`` cuts the
weights; the modules call these where a cut weight is used:

  * ``row_parallel``: a product whose weight holds this rank's input
    columns (``out_proj``, ``mlp/output``): the partial products summed
    over the model group, rounded once, then the replicated bias;
  * ``vocab_parallel_embedding``: a lookup in this rank's rows of the
    vocabulary, summed over the model group (exact: one row is nonzero);
  * ``vocab_parallel_cross_entropy`` and ``vocab_parallel_argmax``: over
    logits whose last axis is this rank's slice of the vocabulary.

Every function returns a tensor replicated over the model ranks: each of
them receives the same bytes from the all-reduce.
"""

from __future__ import annotations

import torch

from merlot_tpu_torch.ops.cuda_ln_matmul import mm_f32
from merlot_tpu_torch.parallel.mesh import Mesh


class _PartialProduct(torch.autograd.Function):
    """x @ w^T with an fp32 result (a rank's partial sum, rounded only once
    the model group has summed it), and ``F.linear``'s backward in the
    operands' dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        y = mm_f32(x.reshape(-1, x.shape[-1]), w.t())
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dw = g.reshape(-1, g.shape[-1]).t().matmul(x.reshape(-1, x.shape[-1]))
        return g.matmul(w), dw


def row_parallel(dense, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``dense(x)`` (a ``DenseTN``) where x holds this model rank's input
    columns and ``dense.weight`` its [out, in / model] slice: the partial
    products summed over the model group in fp32, rounded to the compute
    dtype once as the whole product is, then the bias (replicated) added
    once."""
    y = _PartialProduct.apply(x.to(dense.dtype), dense.weight.to(dense.dtype))
    return mesh.reduce_from_model(y).to(dense.dtype) + dense.bias.to(dense.dtype)


def _local_ids(ids: torch.Tensor, n: int, mesh: Mesh):
    """(ids in this rank's [n]-row slice of the vocabulary, clamped into
    it; whether each id lies in the slice)."""
    local = ids.long() - mesh.model_rank * n
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh
                             ) -> torch.Tensor:
    """``whole_table[ids]`` from this model rank's rows ``table`` [V / model,
    H] (rank r holds ids [r V / model, (r + 1) V / model)): each rank looks
    up the ids in its slice, zeros the others, and the model group sums."""
    local, inside = _local_ids(ids, table.shape[0], mesh)
    return mesh.reduce_from_model(table[local] * inside[..., None].to(table.dtype))


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mesh: Mesh) -> torch.Tensor:
    """Per-example CE (``ops.losses.cross_entropy_with_logits``) of logits
    [..., V / model], this model rank's slice of the vocabulary: the max,
    the sum of exponentials and the label's logit each reduced over the
    model group. ``logsumexp - logit[label]``, with the max as the shift."""
    m = mesh.model_all_reduce(logits.detach().amax(dim=-1), "max")
    z = logits - m[..., None]
    sum_exp = mesh.reduce_from_model(torch.exp(z).sum(dim=-1))
    local, inside = _local_ids(labels, logits.shape[-1], mesh)
    picked = z.gather(-1, local[..., None])[..., 0] * inside.to(z.dtype)
    return torch.log(sum_exp) - mesh.reduce_from_model(picked)


def vocab_parallel_argmax(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole vocabulary's argmax of logits [..., V / model] (the lowest
    index among equal largest logits, as ``argmax`` picks)."""
    n = logits.shape[-1]
    idx = logits.detach().argmax(dim=-1)
    best = logits.detach().gather(-1, idx[..., None])[..., 0]
    top = mesh.model_all_reduce(best, "max")
    cand = torch.where(best == top, idx + mesh.model_rank * n,
                       torch.full_like(idx, n * mesh.model))
    return mesh.model_all_reduce(cand, "min")
