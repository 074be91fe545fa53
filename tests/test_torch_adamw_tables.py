"""The pure-Python parts of the multi-tensor AdamW kernel's wrapper
(``ops/cuda_adamw.py``), on the CPU: the (rows, width, row_stride)
descriptor of views, the chunk list the kernel's grid walks, the group
table's float32 scalars, and the optimizer's hyperparameter groups. The
kernel itself runs only on a card (``test_torch_cuda_adamw.py``)."""

import numpy as np
import pytest
import torch

from merlot_tpu_torch.ops import cuda_adamw
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW, _leaf_plan

SHAPES = [(12,), (6, 8), (4, 6, 10), (3, 5, 7, 4), (1, 9, 1, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_rows_view_of_narrow_views_on_each_axis(shape):
    base = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    for axis, size in enumerate(shape):
        for start, n in {(0, size), (size // 2, size - size // 2), (1, max(size - 2, 0))}:
            view = base.narrow(axis, start, n)
            rows, width, stride = cuda_adamw.rows_view(view)
            assert rows * width == view.numel()
            if not view.numel():
                continue
            got = torch.as_strided(base, (rows, width), (stride, 1), view.storage_offset())
            assert torch.equal(got, view.reshape(rows, width)), (axis, start, n)


def test_rows_view_refuses_other_layouts():
    w = torch.zeros(6, 4)
    for bad in (w.t(), w[:, ::2], w[::2, ::2], torch.zeros(3, 1).expand(3, 4)):
        with pytest.raises(ValueError, match="rows of contiguous elements"):
            cuda_adamw.rows_view(bad)
    assert cuda_adamw.rows_view(torch.zeros(1, 1)) == (1, 1, 1)
    assert cuda_adamw.rows_view(w) == (1, 24, 24)
    assert cuda_adamw.rows_view(w[2:5]) == (1, 12, 12)


def test_leaf_layout_takes_the_slices_rows():
    p, m = torch.zeros(8, 10), torch.zeros(8, 5)
    assert cuda_adamw.leaf_layout([p.narrow(1, 5, 5), p.narrow(1, 5, 5), m, m]) == \
        (8, 5, [10, 10, 5, 5])
    assert cuda_adamw.leaf_layout([p, p, p, p]) == (1, 80, [80, 80, 80, 80])
    with pytest.raises(ValueError, match="differ in shape"):
        cuda_adamw.leaf_layout([p, m])
    a = torch.zeros(4, 2, 10)[:, :, :5]    # 8 rows of 5
    b = torch.zeros(4, 3, 5)[:, :2, :]     # 4 rows of 10
    with pytest.raises(ValueError, match="cut into rows differently"):
        cuda_adamw.leaf_layout([a, b])


@pytest.mark.parametrize("chunk", [1, 4, 7, 16384])
def test_chunks_cover_every_element_once(chunk):
    rng = np.random.default_rng(chunk)
    rows = [0, 1, 1, 3, 5, 1, 2] + list(rng.integers(0, 6, 20))
    widths = [0, 1, 29, 8, 0, 40, 16384 * 2 + 3] + list(rng.integers(0, 50, 20))
    chunks, first = cuda_adamw.chunk_table(rows, widths, chunk)
    assert chunks.dtype == np.int32 and chunks.shape[1] == 4 and first.dtype == np.int64
    seen = [np.zeros((r, w), np.int64) for r, w in zip(rows, widths)]
    for leaf, row, col, length in chunks:
        assert 0 < length <= chunk
        seen[leaf][row, col:col + length] += 1
    assert all((s == 1).all() for s in seen)
    # a leaf's chunks together, in order, from its first
    assert (np.diff(chunks[:, 0]) >= 0).all()
    counts = np.bincount(chunks[:, 0], minlength=len(rows))
    assert (first == np.cumsum(counts) - counts).all()
    empty_chunks, empty_first = cuda_adamw.chunk_table([], [], chunk)
    assert empty_chunks.shape == (0, 4) and empty_first.shape == (0,)


@pytest.mark.parametrize("hp", [(3e-4, 0.9, 0.98, 1e-6, 0.1), (1.234e-3, 0.8, 0.999, 1e-8, 0.0),
                                (7.77e-5, 0.95, 0.9995, 1e-7, 1e-4)])
def test_group_row_is_atens_float32_cast(hp):
    lr, b1, b2, eps, wd = hp
    row = cuda_adamw.group_row(lr, b1, b2, eps, wd)
    want = [lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, 1.0 if wd > 0 else 0.0]
    assert row.dtype == np.float32 and row.shape == (cuda_adamw.GROUP_FIELDS,)
    for got, x in zip(row, want):
        assert np.float32(got).tobytes() == torch.tensor(x, dtype=torch.float32).numpy().tobytes()


def test_leaf_plan_groups_and_frozen_leaves():
    cfg = AdamWConfig(weight_decay_rate=0.1, param_overrides=(
        (("bias", "gamma"), {"weight_decay_rate": 0.0}), (("frozen/",), {"learning_rate": 0.0})))
    names = ("encoder.layer00.query.weight", "encoder.layer00.query.bias",
             "encoder.layer00.attn_ln.gamma", "frozen.table.weight", "head.weight")
    plan = MerlotAdamW(cfg)._params_plan(names)
    k = _leaf_plan(plan)
    assert "frozen.table.weight" not in k.live and len(k.live) == 4
    assert len(k.groups) == 2 and len(k.group_of) == 4
    for n, gi in zip(k.live, k.group_of):
        hp = dict(next(h for m, _, h in plan if m == n))
        assert k.groups[gi] == hp
    assert k.scopes == ["encoder/layer00", "frozen/table", "head/kernel"]
    assert [k.scopes[i] for i in k.scope_of] == [
        "/".join(path.split("/")[:2]) for _, path, _ in plan]
    assert k.wd_half == [hp["weight_decay_rate"] * 0.5 for _, _, hp in plan]


def test_table_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda_adamw.Lists().table([torch.zeros(3)], [0], (torch.float32,))
