"""The multi-tensor AdamW kernel (``csrc/adamw.cu`` through
``ops/cuda_adamw.py``) against the plain loop (``train/optimizer.py``'s
``adamw_leaf`` and ``MerlotAdamW``'s CPU path) on the same CUDA tensors.
Marked ``gpu``; skipped where no card is present. Run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda_adamw.py``
(tests/conftest.py imports jax, which the GPU machine may lack).

Tolerances: the update is bit for bit the plain loop's given the same clip
factor (p, and m and v as their int16 or int32 bits): the kernel runs the
same fp32 operations in the same order, one rounding each. The sums of
squares are fp64 inside the kernel: within 1e-6 of fp64 sums, and two
runs agree bit for bit.
"""

import pytest
import torch

from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.ops import cuda_adamw
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW, adamw_leaf, leaf_lr
from merlot_tpu_torch.train.train_step import init_train_state, make_train_step

pytestmark = pytest.mark.gpu

# 1-element leaves, odd sizes, sizes not a multiple of 8, rows of a matrix,
# and one leaf of 40 M elements
SHAPES = [(1,), (7,), (13, 5), (1, 1, 3), (1000,), (768, 3072), (50370, 3), (40_000_000,)]
GROUPS = [dict(learning_rate=3e-4, beta_1=0.9, beta_2=0.98, epsilon=1e-6),
          dict(learning_rate=1e-3, beta_1=0.8, beta_2=0.999, epsilon=1e-8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def assert_same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    diff = int((bits(a) != bits(b)).sum())
    assert diff == 0, f"{what}: {diff} of {a.numel()} elements differ"


def leaves_of(cuda, shapes, state_dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for s in shapes:
        p = torch.randn(s, generator=g, device=cuda)
        m = (0.01 * torch.randn(s, generator=g, device=cuda)).to(state_dtype)
        v = (1e-4 * torch.rand(s, generator=g, device=cuda)).to(state_dtype)
        out.append([p, m, v])
    return out


def grads_of(cuda, shapes, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda) * 10.0 ** (i % 5 - 3)
            for i, s in enumerate(shapes)]


def group_table(hps):
    import numpy as np
    return lambda scale, t: np.stack([cuda_adamw.group_row(
        leaf_lr(hp, scale, t), hp["beta_1"], hp["beta_2"], hp["epsilon"],
        hp["weight_decay_rate"]) for hp in hps])


@pytest.mark.parametrize("bf16_state", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("clipped", [False, True])
def test_update_bit_for_bit(cuda, bf16_state, wd, clipped):
    """Steps 1, 2 and 3 (each checked) over every shape, two groups, the
    state fresh from randn: p, m and v equal the plain loop's bits."""
    state = torch.bfloat16 if bf16_state else torch.float32
    hps = [dict(h, weight_decay_rate=wd if i == 0 else 0.0) for i, h in enumerate(GROUPS)]
    groups = [i % 2 for i in range(len(SHAPES))]
    table = group_table(hps)
    kernel = leaves_of(cuda, SHAPES, state, seed=1)
    plain = [[t.clone() for t in leaf] for leaf in kernel]
    lists = cuda_adamw.Lists()
    for t in (1.0, 2.0, 3.0):
        grads = grads_of(cuda, SHAPES, seed=int(t))
        clip = torch.tensor(0.37, device=cuda) if clipped else None
        views = [x for (p, m, v), g in zip(kernel, grads) for x in (p, g, m, v)]
        cuda_adamw.adamw(views, groups, table(0.5, t), clip, lists)
        for (p, m, v), g, gi in zip(plain, grads, groups):
            adamw_leaf(p, g if clip is None else g * clip, m, v, hps[gi],
                       leaf_lr(hps[gi], 0.5, t), bf16_state)
        for shape, a, b in zip(SHAPES, kernel, plain):
            for name, x, y in zip("pmv", a, b):
                assert_same_bits(x, y, f"step {t}, {name} of {shape}")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bf16_state", [True, False])
def test_zero1_slices_match_the_whole_leaf(cuda, axis, bf16_state):
    """Rank 1 of 2's ``narrow`` on each axis (an odd width: rows that start
    off the 16-byte grid) gives the bits of the whole leaf's update, sliced."""
    state = torch.bfloat16 if bf16_state else torch.float32
    shape = (96, 42, 5) if axis == 1 else (96, 42)
    hp = dict(GROUPS[0], weight_decay_rate=0.1)
    table = group_table([hp])(1.0, 1.0)
    (p, m, v), = leaves_of(cuda, [shape], state, seed=3)
    (g,) = grads_of(cuda, [shape], seed=4)
    n = shape[axis] // 2
    p0, p_part = p.clone(), p.clone()
    m_part, v_part = (t.narrow(axis, n, n).clone() for t in (m, v))
    cuda_adamw.adamw([p_part.narrow(axis, n, n), g.narrow(axis, n, n), m_part, v_part],
                     [0], table, None, cuda_adamw.Lists())
    cuda_adamw.adamw([p, g, m, v], [0], table, None, cuda_adamw.Lists())
    assert_same_bits(p_part.narrow(axis, n, n), p.narrow(axis, n, n), "p's slice")
    assert_same_bits(p_part.narrow(axis, 0, n), p0.narrow(axis, 0, n), "rank 0's slice")
    assert_same_bits(m_part, m.narrow(axis, n, n), "m's slice")
    assert_same_bits(v_part, v.narrow(axis, n, n), "v's slice")


class OneRankOfTwo:
    """ZeRO-1's data axis of 2 seen from rank 1: ``gather_shards`` puts
    rank 0's slices, taken from ``whole``, beside this rank's."""
    data, rank = 2, 1

    def __init__(self, whole):
        self.whole = whole

    def gather_shards(self, shards, axes):
        return {n: torch.cat([self.whole[n].narrow(axes[n], 0, s.shape[axes[n]]), s],
                             dim=axes[n]) for n, s in shards.items()}


def small_merlot(cuda):
    cfg = MerlotConfig(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                       contrastive_size=128, num_hidden_layers=1,
                       num_vision_transformer_hidden_layers=1,
                       num_lang_transformer_hidden_layers=1, image_size=(64, 96),
                       resnet_layers=(1, 1, 1), num_chunks_in_group=2,
                       attention_softmax_fp32=False)
    return MerlotPretrainModel(cfg, device=cuda)


@pytest.mark.parametrize("bf16_state", [True, False])
def test_zero1_update_matches_the_plain_path(cuda, bf16_state):
    """MerlotAdamW.update with ZeRO-1 (rank 1 of 2: slices on axes 0-3 of a
    small MERLOT's leaves go in as views) against the plain loop on clones,
    two steps: the gathered parameters and the moments' slices bit for bit."""
    model = small_merlot(cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    params = {n: torch.randn(p.shape, generator=g, device=cuda)
              for n, p in model.named_parameters()}
    cfg = AdamWConfig(weight_decay_rate=0.1, clip_norm=0.0, use_bfloat16_adam=bf16_state,
                      param_overrides=((("bias", "gamma", "beta"),
                                        {"weight_decay_rate": 0.0}),))
    kern, ref = MerlotAdamW(cfg), MerlotAdamW(cfg)
    mesh = OneRankOfTwo({n: p.clone() for n, p in params.items()})
    axes = kern.zero1_axes(params, mesh)
    assert set(axes.values()) == {0, 1, 2, 3}
    state = kern.init(params, mesh)
    plain_params = {n: p.clone() for n, p in params.items()}
    plain_state = {"step": 0, "m": {n: t.clone() for n, t in state["m"].items()},
                   "v": {n: t.clone() for n, t in state["v"].items()}}
    for step in range(2):
        grads = {n: torch.randn(p.shape, generator=g, device=cuda)
                 for n, p in params.items()}
        kern.update(grads, state, params, mesh=mesh)
        ref._step(grads, plain_state, plain_params, axes, mesh, None, None, kernel=False)
        whole = mesh.gather_shards({n: plain_params[n].narrow(
            a, plain_params[n].shape[a] // 2, plain_params[n].shape[a] // 2).contiguous()
            for n, a in axes.items()}, axes)
        for n in axes:
            plain_params[n].copy_(whole[n])
        plain_state["step"] += 1
        for n in params:
            assert_same_bits(params[n], plain_params[n], f"step {step}, p of {n}")
            assert_same_bits(state["m"][n], plain_state["m"][n], f"step {step}, m of {n}")
            assert_same_bits(state["v"][n], plain_state["v"][n], f"step {step}, v of {n}")


def named_leaves(cuda):
    shapes = {"encoder.layer00.query.weight": (64, 64), "encoder.layer00.query.bias": (64,),
              "encoder.layer00.attn_ln.gamma": (64,), "frozen.table.weight": (33, 7),
              "head.kernel.weight": (5, 1)}
    g = torch.Generator(device=cuda).manual_seed(7)
    params = {n: torch.randn(s, generator=g, device=cuda) for n, s in shapes.items()}
    grads = {n: torch.randn(s, generator=g, device=cuda) for n, s in shapes.items()}
    return params, grads


class OneGroup:
    """A model or stage group of one: its sums are the rank's own."""
    model_all_reduce = stage_all_reduce_sum = staticmethod(lambda t: t)


@pytest.mark.parametrize("bf16_state", [True, False])
@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
@pytest.mark.parametrize("split", [None, "tp", "pp"])
def test_merlot_adamw_update_matches_the_plain_path(cuda, bf16_state, clip_norm, split):
    """MerlotAdamW.update on CUDA (the kernels) against its plain path on
    clones of the same CUDA tensors, three steps, with a frozen leaf and
    the verbose metrics, alone or with a ``tp`` or ``pp`` group (whose
    norms sum the per-leaf vector through ``_tp_totals``): p, m and v bit
    for bit without the clip (with it, each path's own clip factor: within
    1e-6, and m and v within a bf16 ulp), the frozen leaf's p, m and v
    untouched, the metrics' keys and dtypes the same and their values
    within 1e-5."""
    groups = {"tp": OneGroup(), "pp": None} if split == "tp" else \
        {"tp": None, "pp": OneGroup() if split == "pp" else None}
    cfg = AdamWConfig(learning_rate=1e-3, num_warmup_steps=2, num_train_steps=10,
                      weight_decay_rate=0.1, clip_norm=clip_norm, use_bfloat16_adam=bf16_state,
                      verbose=True,
                      param_overrides=((("bias", "gamma"), {"weight_decay_rate": 0.0}),
                                       (("frozen/",), {"learning_rate": 0.0})))
    kern, ref = MerlotAdamW(cfg), MerlotAdamW(cfg)
    params, grads = named_leaves(cuda)
    state = kern.init(params)
    plain_params = {n: p.clone() for n, p in params.items()}
    plain_state = {"step": 0, "m": {n: t.clone() for n, t in state["m"].items()},
                   "v": {n: t.clone() for n, t in state["v"].items()}}
    frozen = "frozen.table.weight"
    frozen_before = params[frozen].clone()
    cuda_adamw.launches = cuda_adamw.tensors = 0
    for step in range(3):
        got = kern.update(grads, state, params, **groups)
        want = ref._step(grads, plain_state, plain_params, {}, None, groups["tp"],
                         groups["pp"], kernel=False)
        plain_state["step"] += 1
        assert got.keys() == want.keys()
        for k in got:
            if torch.is_tensor(want[k]):
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0, msg=k)
            else:
                assert got[k] == want[k], k
        for n in params:
            pairs = [(params[n], plain_params[n], "p")] + [
                (state[k][n], plain_state[k][n], k) for k in "mv"]
            for a, b, name in pairs:
                if clip_norm == 0.0:
                    assert_same_bits(a, b, f"step {step}, {name} of {n}")
                else:
                    torch.testing.assert_close(a.float().abs(), b.float().abs(),
                                               rtol=1e-6 if name == "p" else 2.0 ** -7,
                                               atol=0, msg=f"step {step}, {name} of {n}")
    assert_same_bits(params[frozen], frozen_before, "the frozen leaf")
    assert not state["m"][frozen].any() and not state["v"][frozen].any()
    assert state["step"] == 3
    # per step: the gradients' sums, the parameters' (verbose), the update
    assert cuda_adamw.launches == 9 and cuda_adamw.tensors == 3 * (len(params) - 1)


def test_sumsq_against_the_plain_sums(cuda):
    """The per-leaf sums within 1e-6 of fp64 sums; a second run, and a
    fresh table (a new ticket counter), give the same bits."""
    xs = grads_of(cuda, SHAPES, seed=8)
    lists = cuda_adamw.Lists()
    per = cuda_adamw.sumsq(xs, lists)
    assert per.dtype == torch.float32 and per.shape == (len(xs),)
    exact = torch.stack([x.double().square().sum() for x in xs])
    torch.testing.assert_close(per.double(), exact, rtol=1e-6, atol=0)
    assert_same_bits(cuda_adamw.sumsq(xs, lists), per, "a second run's sums")
    assert_same_bits(cuda_adamw.sumsq(xs, cuda_adamw.Lists()), per, "a fresh table's sums")


def test_one_train_step_runs_the_kernels(cuda):
    """One make_train_step step of a small MERLOT: the update's two
    launches, every non-frozen leaf in the update kernel."""
    model = small_merlot(cuda)
    opt = MerlotAdamW(AdamWConfig(weight_decay_rate=0.1, clip_norm=0.0,
                                  use_bfloat16_adam=True,
                                  param_overrides=((("bias",), {"weight_decay_rate": 0.0}),)))
    state = init_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, device=cuda)
    examples, chunks, tokens = 2, 4, 8
    g = torch.Generator(device=cuda).manual_seed(0)
    n_img = examples * chunks
    batch = {"images": torch.rand((n_img, 64, 96, 3), generator=g, device=cuda),
             "input_ids": torch.randint(100, 50357, (examples, chunks, tokens), generator=g,
                                        device=cuda),
             "shuffled_idx_img": torch.arange(2, device=cuda).repeat(n_img // 2),
             "video_src_ids": torch.arange(n_img // 2, device=cuda).repeat_interleave(2)
             .reshape(examples, chunks)}
    cuda_adamw.launches = cuda_adamw.tensors = 0
    metrics = step(model, state, batch, torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    live = sum(1 for _, _, hp in opt._params_plan(tuple(dict(model.named_parameters())))
               if hp["learning_rate"] != 0.0)
    assert cuda_adamw.launches == 2
    assert cuda_adamw.tensors == live == len(list(model.parameters()))
    assert torch.isfinite(metrics["gradnorms/_overall"]) and state["step"] == 1


def test_wrapper_refuses(cuda):
    p = torch.zeros(8, device=cuda)
    m = torch.zeros(8, device=cuda, dtype=torch.bfloat16)
    table = group_table([dict(GROUPS[0], weight_decay_rate=0.0)])(1.0, 1.0)
    lists = cuda_adamw.Lists()
    with pytest.raises(ValueError, match="tensors on"):
        cuda_adamw.adamw([p, torch.zeros(8), m, m.clone()], [0], table, None, lists)
    with pytest.raises(ValueError, match="where the kernel takes"):
        cuda_adamw.adamw([p.half(), p, m, m.clone()], [0], table, None, lists)
    with pytest.raises(ValueError, match="where the kernel takes"):
        cuda_adamw.adamw([p, p.clone(), m, m.float()], [0], table, None, lists)
    with pytest.raises(ValueError, match="3 views for 1 leaves of 4"):
        cuda_adamw.adamw([p, p.clone(), m], [0], table, None, lists)
    with pytest.raises(ValueError, match="the kernel takes fp32 or bf16"):
        cuda_adamw.adamw([p, p.clone(), m.half(), m.half()], [0], table, None, lists)
    with pytest.raises(ValueError, match="rows of contiguous elements"):
        w = torch.zeros(6, 4, device=cuda)
        cuda_adamw.adamw([w.t(), w.t(), w.t().contiguous(), w.t().contiguous()], [0],
                         table, None, lists)
    with pytest.raises(ValueError, match="tensors on"):
        cuda_adamw.sumsq([p, torch.zeros(3)], lists)
    with pytest.raises(ValueError, match="where the kernel takes"):
        cuda_adamw.sumsq([p, p.double()], cuda_adamw.Lists())
