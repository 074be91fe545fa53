"""AdamW with warmup -> linear decay, regex param overrides and bf16 Adam
state (counterpart of merlot_tpu/train/optimizer.py).

  * linear warmup to the peak LR then linear decay to 0, pre-scaled so the
    peak equals ``learning_rate`` right after warmup;
  * bias correction folded into the LR;
  * decoupled weight decay;
  * regex -> hyperparameter ``param_overrides``, matched against each
    parameter's flax path (``convert.flax_path``: "merlot/encoder/layer00/
    attn_ln/gamma", ".../query/kernel"), so the yaml's patterns ("/ln",
    "/gn", "bias", ...) select what they select in the JAX package;
    ``learning_rate: 0`` freezes a parameter;
  * optional global-norm clipping;
  * bf16 optimizer state with the sign-bit trick for the second moment
    (``encode_v``/``decode_v``): v >= 0, so a negative stored value means
    "multiply by 1.00390625 on decode".

State: {'step': int, 'm': {name: tensor}, 'v': {name: tensor}}. ``update``
writes the new parameters and state in place (the JAX package returns new
trees; in place, the step holds one copy of each).

ZeRO-1 (``mesh`` given to ``init`` and ``update``): the moments of each
parameter that ``parallel.mesh.zero1_axes`` splits hold only this rank's
slice; ``update`` takes the whole gradients (summed over the ranks), keeps
the global-norm clip and the metrics of the whole gradients, updates this
rank's slice of the moments and of the parameter, then gathers the
parameter's slices from the ranks. The other parameters update whole on
every rank. Every element gets the arithmetic of the unsharded update.
``full_state`` gathers a sharded state into whole moments (what a
checkpoint holds) and ``shard_state`` cuts whole moments to this rank's.

Tensor parallelism (``tp``, a mesh with a model axis, given to
``update``): the parameters, gradients and moments are this model rank's
slices (``parallel.mesh.shard_params``), and each element is updated as a
whole one would be. The global-norm clip and the ``gradnorms/*`` and
``weight_decay_loss`` metrics count each cut leaf's squares summed over
the model group and each replicated leaf's once (every model rank holds
the same copy of it). ZeRO-1 then splits this model rank's slice over the
data group.

The update runs two ways. CUDA parameters update through the
multi-tensor kernel (``ops/cuda_adamw.py``, ``csrc/adamw.cu``): one launch
for the per-leaf sums of squares of the gradients, one for the AdamW step
of every non-frozen leaf, with the plain loop's arithmetic bit for bit
given the same clip factor; ZeRO-1's slices go in as views. CPU
parameters take the plain loop, leaf by leaf in ATen (``adamw_leaf``):
the path the tests hold against the JAX package, and the kernel's plain
version. Both take the global norm, the clip factor and the metrics from
one vector of per-leaf sums of squares, which stays on the device.

Pipeline parallelism (``pp``, a mesh with a stage axis, given to
``update``): the parameters are one stage's (``models.grover.GroverStage``:
its layers as ``stages.{j}.*`` and the replicated leaves, whose gradients
the step has summed over the stage group). The clip and the norms count
the layers' squares summed over the stage group and the replicated leaves'
once. Hyperparameters resolve on JAX's stacked path (``stages/<leaf>``,
no layer index), so a regex matches what it matches in JAX's PP tree.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from merlot_tpu_torch.convert import flax_path, stage_leaf
from merlot_tpu_torch.core import trace
from merlot_tpu_torch.ops import cuda_adamw
from merlot_tpu_torch.parallel.mesh import Mesh, shard_leaf, tp_layout, zero1_axes

MISSING_PRECISION = 1.00390625  # 1 + 2^-8
GRADNORM_DEPTH = 2  # ``verbose`` groups grad norms by this many path levels


def encode_v(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 with the sign bit recording a x1.00390625 correction."""
    b = v.to(torch.bfloat16)
    bf = b.float()
    err0 = (bf - v).abs()
    err1 = (bf * MISSING_PRECISION - v).abs()
    return torch.where(err0 <= err1, b, -b)


def decode_v(stored: torch.Tensor) -> torch.Tensor:
    v_abs = stored.abs().float()
    return torch.where(stored.float() > 0, v_abs, v_abs * MISSING_PRECISION)


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    num_train_steps: int = 100000
    num_warmup_steps: int = 0
    weight_decay_rate: float = 1e-4
    beta_1: float = 0.9
    beta_2: float = 0.98
    epsilon: float = 1e-6
    clip_norm: float = 1.0          # <= 0 disables
    use_bfloat16_adam: bool = False
    verbose: bool = False           # per-scope gradnorm telemetry
    # list of [regex_list, {hyperparam: value}]
    param_overrides: Tuple = ()

    @classmethod
    def from_config(cls, optimizer_section: Dict[str, Any]) -> "AdamWConfig":
        if optimizer_section.get("type", "adam_optimizer") != "adam_optimizer":
            raise ValueError(f"unsupported optimizer {optimizer_section.get('type')}")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in optimizer_section.items() if k in names}
        if kw.get("param_overrides") is not None:
            kw["param_overrides"] = tuple(
                (tuple(regexes), dict(over)) for regexes, over in kw["param_overrides"])
        else:
            kw["param_overrides"] = ()
        return cls(**kw)


_OVERRIDABLE = ("learning_rate", "weight_decay_rate", "beta_1", "beta_2", "epsilon")


def _path_key(name: str) -> Tuple[str, ...]:
    """The order the JAX package visits leaves in (sorted dict keys, level
    by level)."""
    return tuple(flax_path(name).split("/"))


def _resolve_path(name: str) -> str:
    """The flax path whose hyperparameters a parameter takes: a stage's
    layer ``stages.{j}.<leaf>`` resolves on JAX's ``stages/<leaf>``."""
    parsed = stage_leaf(name)
    return flax_path(name if parsed is None else f"stages.{parsed[1]}")


def _tp_totals(groups: Sequence[Sequence[str]], sq: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], tp: Optional[Mesh],
               pp: Optional[Mesh] = None) -> List[torch.Tensor]:
    """For each group of parameter names, the sum of ``sq`` over the whole
    leaves: the cut leaves' parts summed over the model group (``tp``) or
    a stage's layers over the stage group (``pp``), one all-reduce for
    every group; the replicated leaves' counted once."""
    if pp is not None:
        cut = {n for g in groups for n in g if stage_leaf(n) is not None}
        reduce = pp.stage_all_reduce_sum
    else:
        cut = {n for g in groups for n in g if tp_layout(n, params[n].dim()) is not None}
        reduce = tp.model_all_reduce
    zero = next(iter(sq.values())).new_zeros(())
    part = reduce(torch.stack([sum((sq[n] for n in g if n in cut), zero) for g in groups]))
    return [part[i] + sum((sq[n] for n in g if n not in cut), zero)
            for i, g in enumerate(groups)]


def leaf_lr(hp: Mapping[str, float], scale: float, t: float) -> float:
    """A leaf's step size at step ``t`` (1-based): its learning rate times
    the schedule's ``scale``, the bias correction folded in."""
    lr = hp["learning_rate"] * scale
    return lr * math.sqrt(1.0 - hp["beta_2"] ** t) / (1.0 - hp["beta_1"] ** t)


def clip_factor(clip_norm: float, global_norm: torch.Tensor) -> torch.Tensor:
    """The global-norm clip's factor on the gradients."""
    return torch.clamp(clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)


def adamw_leaf(p: torch.Tensor, g: torch.Tensor, m0: torch.Tensor, v0: torch.Tensor,
               hp: Mapping[str, float], lr: float, bf16_state: bool) -> None:
    """One leaf's AdamW step in place, in ATen: p, and the moments m0 and v0
    (bf16 with the sign-bit v, or fp32), from the gradient g (clipped
    already) and the step size ``lr`` (``leaf_lr``). The plain version of
    the multi-tensor kernel."""
    b1, b2, eps = hp["beta_1"], hp["beta_2"], hp["epsilon"]
    g32 = g.float()
    m = m0.float() if bf16_state else m0
    v = decode_v(v0) if bf16_state else v0
    m = b1 * m + (1.0 - b1) * g32
    v = b2 * v + (1.0 - b2) * (g32.square() + 1e-30)
    upd = m / (torch.sqrt(v) + eps)
    if hp["weight_decay_rate"] > 0:
        upd = upd + hp["weight_decay_rate"] * p.float()
    p.copy_(p.float() - lr * upd)
    if bf16_state:
        m0.copy_(m.to(torch.bfloat16))
        v0.copy_(encode_v(v))
    else:
        m0.copy_(m)
        v0.copy_(v)


@dataclass
class _LeafPlan:
    """What the update keeps of a plan: the non-frozen leaves and the
    hyperparameter group of each, the groups' hyperparameters, and for the
    ``verbose`` metrics each leaf's scope and weight decay x 0.5 (their
    tensors on each device in ``on_device``)."""
    live: List[str]
    group_of: List[int]
    groups: List[Dict[str, float]]
    scopes: List[str]
    scope_of: List[int]
    wd_half: List[float]
    on_device: Dict[Any, Tuple[torch.Tensor, torch.Tensor]]

    def tensors(self, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``scope_of`` (int64) and ``wd_half`` (fp32) on ``dev``, made
        once (from pinned memory without a sync on CUDA)."""
        if dev not in self.on_device:
            host = (torch.tensor(self.scope_of, dtype=torch.int64),
                    torch.tensor(self.wd_half, dtype=torch.float32))
            self.on_device[dev] = tuple(
                t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
                for t in host)
        return self.on_device[dev]


def _leaf_plan(plan: Sequence[Tuple[str, str, Dict[str, float]]]) -> _LeafPlan:
    keys: Dict[Tuple, int] = {}
    scopes: Dict[str, int] = {}
    live, group_of, scope_of = [], [], []
    for n, path, hp in plan:
        scope_of.append(scopes.setdefault("/".join(path.split("/")[:GRADNORM_DEPTH]),
                                          len(scopes)))
        if hp["learning_rate"] != 0.0:  # not frozen
            live.append(n)
            group_of.append(keys.setdefault(tuple(sorted(hp.items())), len(keys)))
    return _LeafPlan(live, group_of, [dict(k) for k in keys], list(scopes), scope_of,
                     [hp["weight_decay_rate"] * 0.5 for _, _, hp in plan], {})


class MerlotAdamW:
    """Per-parameter-hyperparameter AdamW over named parameters."""

    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self._plan_names: Tuple[str, ...] = ()
        self._plan: List[Tuple[str, str, Dict[str, float]]] = []
        self._axes_key: Tuple = ()
        self._axes: Dict[str, int] = {}
        self._leaves: Optional[_LeafPlan] = None
        # the kernels' device tables: the gradients' and the parameters'
        # sums of squares, the update's leaves
        self._lists = {k: cuda_adamw.Lists() for k in ("grads", "params", "update")}

    def _resolve(self, path: str) -> Dict[str, float]:
        """Hyperparameters of the parameter at flax path ``path``."""
        c = self.cfg
        hp = {"learning_rate": c.learning_rate,
              "weight_decay_rate": c.weight_decay_rate,
              "beta_1": c.beta_1, "beta_2": c.beta_2, "epsilon": c.epsilon}
        for regexes, over in c.param_overrides:
            for k in over:
                if k not in _OVERRIDABLE:
                    raise ValueError(f"{k} is not an overridable hyperparameter")
            if any(re.search(rx, path) for rx in regexes):
                hp.update(over)
        return hp

    def _params_plan(self, names: Tuple[str, ...]
                     ) -> List[Tuple[str, str, Dict[str, float]]]:
        """(name, flax path, hyperparameters) of each parameter, in the
        JAX package's leaf order; resolved once for a set of names."""
        if names != self._plan_names:
            self._plan = [(n, _resolve_path(n), self._resolve(_resolve_path(n)))
                          for n in sorted(names, key=_path_key)]
            self._plan_names = names
            self._leaves = None
        return self._plan

    def zero1_axes(self, params: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, int]:
        """{name: axis} of the parameters whose moments ZeRO-1 splits over
        ``mesh``; resolved once for a set of names and shapes."""
        key = (mesh.data, tuple((n, tuple(p.shape)) for n, p in params.items()))
        if key != self._axes_key:
            self._axes = zero1_axes(params, mesh.data)
            self._axes_key = key
        return self._axes

    def init(self, params: Mapping[str, torch.Tensor],
             mesh: Optional[Mesh] = None) -> Dict[str, Any]:
        """Zero moments; with ``mesh`` (ZeRO-1), this rank's slices."""
        dtype = torch.bfloat16 if self.cfg.use_bfloat16_adam else torch.float32
        axes = self.zero1_axes(params, mesh) if mesh is not None else {}

        def zeros(n, p):
            return torch.zeros_like(shard_leaf(p, axes[n], mesh) if n in axes else p,
                                    dtype=dtype)

        return {"step": 0,
                "m": {n: zeros(n, p) for n, p in params.items()},
                "v": {n: zeros(n, p) for n, p in params.items()}}

    def full_state(self, state: Dict[str, Any], params: Mapping[str, torch.Tensor],
                   mesh: Optional[Mesh]) -> Dict[str, Any]:
        """The state with whole moments: ZeRO-1's slices gathered from the
        ranks (a collective: every rank calls it); ``state`` itself without
        a mesh."""
        if mesh is None:
            return state
        axes = self.zero1_axes(params, mesh)
        out = {"step": state["step"]}
        for g in ("m", "v"):
            whole = mesh.gather_shards({n: state[g][n] for n in axes}, axes)
            out[g] = {n: whole.get(n, t) for n, t in state[g].items()}
        return out

    def shard_state(self, full: Dict[str, Any], params: Mapping[str, torch.Tensor],
                    mesh: Optional[Mesh]) -> Dict[str, Any]:
        """The inverse of ``full_state``: this rank's slices of whole
        moments (copies)."""
        if mesh is None:
            return full
        axes = self.zero1_axes(params, mesh)
        return {"step": full["step"],
                **{g: {n: shard_leaf(t, axes[n], mesh).clone() if n in axes else t
                       for n, t in full[g].items()} for g in ("m", "v")}}

    def lr_scale(self, step: int) -> float:
        """Warmup then linear decay; peak = 1.0 right after warmup."""
        c = self.cfg
        t = float(step)
        T = float(c.num_train_steps)
        W = float(c.num_warmup_steps)
        base = T / (T - W + 1.0) if c.num_warmup_steps else 1.0
        decay = base * max(0.0, 1.0 - min(t, T) / T)
        if c.num_warmup_steps and t < W:
            return t / W
        return decay

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor],
               mesh: Optional[Mesh] = None, tp: Optional[Mesh] = None,
               pp: Optional[Mesh] = None) -> Dict[str, Any]:
        """One step: writes the new params and state in place and returns
        the metrics. Frozen params (lr == 0) and their state are left as
        they are. ``mesh``: the state is ZeRO-1's (``init(params, mesh)``)
        and ``grads`` are the whole gradients (of this model rank's
        slices), the same on every data index. ``tp``: the parameters are
        cut over its model axis, ``pp``: one stage's (the module
        docstring). CUDA parameters go through the multi-tensor kernel,
        CPU ones through the plain loop."""
        with trace.span("step.update"):
            plan = self._params_plan(tuple(params))
            axes = self.zero1_axes(params, mesh) if mesh is not None else {}
            device = params[plan[0][0]].device
            if device.type not in ("cuda", "cpu"):
                raise ValueError(f"MerlotAdamW: no update for parameters on {device}")
            metrics = self._step(grads, state, params, axes, mesh, tp, pp,
                                 kernel=device.type == "cuda")

            live = [n for n, _, hp in plan if n in axes and hp["learning_rate"] != 0.0]
            if live:
                whole = mesh.gather_shards(
                    {n: shard_leaf(params[n], axes[n], mesh).contiguous() for n in live}, axes)
                for n in live:
                    params[n].copy_(whole[n])
            state["step"] += 1
            return metrics

    def _sumsq(self, xs: List[torch.Tensor], which: str, kernel: bool) -> torch.Tensor:
        """Per-leaf sums of squares of ``xs`` (fp32 [len(xs)]): the kernel
        with the table of list ``which``, or leaf by leaf in ATen."""
        if kernel:
            return cuda_adamw.sumsq(xs, self._lists[which])
        return torch.stack([x.float().square().sum() for x in xs])

    def _step(self, grads, state, params, axes, mesh, tp, pp, kernel: bool
              ) -> Dict[str, Any]:
        """The norms and the step of this rank's leaves (``update`` without
        ZeRO-1's gather): through the multi-tensor kernel (``kernel``; no
        host sync), or the plain loop leaf by leaf in ATen. Both take the
        metrics and the clip factor from the gradients' per-leaf sums of
        squares."""
        c = self.cfg
        plan = self._params_plan(tuple(params))
        if self._leaves is None:
            self._leaves = _leaf_plan(plan)
        k = self._leaves
        names = [n for n, _, _ in plan]
        step = state["step"]
        scale = self.lr_scale(step)
        split = tp is not None or pp is not None

        def group_sums(groups: List[List[str]], sq: torch.Tensor) -> List[torch.Tensor]:
            return _tp_totals(groups, dict(zip(names, sq.unbind())), params, tp, pp)

        # global-norm clip
        sq = self._sumsq([grads[n] for n in names], "grads", kernel)
        total = group_sums([names], sq)[0] if split else sq.sum()
        global_norm = torch.sqrt(total)
        clip = clip_factor(c.clip_norm, global_norm) if c.clip_norm > 0.0 else None

        metrics: Dict[str, Any] = {"learning_rate": c.learning_rate * scale,
                                   "gradnorms/_overall": global_norm}
        if c.verbose:
            # the clipped gradients' norms by scope, and the decoupled
            # weight-decay "loss" of the parameters before this step
            scope_of, wd_half = k.tensors(global_norm.device)
            sq_g = sq if clip is None else sq * clip.square()
            sq_p = wd_half * self._sumsq([params[n] for n in names], "params", kernel)
            if not split:
                by_scope = torch.zeros(len(k.scopes), device=sq.device).index_add_(
                    0, scope_of, sq_g)
                wd_loss = sq_p.sum()
            else:
                members: List[List[str]] = [[] for _ in k.scopes]
                for n, s in zip(names, k.scope_of):
                    members[s].append(n)
                by_scope = torch.stack(group_sums(members, sq_g))
                (wd_loss,) = group_sums([names], sq_p)
            for scope, norm in zip(k.scopes, torch.sqrt(by_scope).unbind()):
                metrics[f"gradnorms/{scope}"] = norm
            metrics["weight_decay_loss"] = wd_loss

        t = step + 1.0
        views: List[torch.Tensor] = []  # p, g, m, v of each live leaf
        for n in k.live:
            p, g = params[n], grads[n]
            if n in axes:  # this rank's slice
                p, g = shard_leaf(p, axes[n], mesh), shard_leaf(g, axes[n], mesh)
            views += (p, g, state["m"][n], state["v"][n])
        if not kernel:
            for i, gi in enumerate(k.group_of):
                p, g, m, v = views[4 * i:4 * i + 4]
                hp = k.groups[gi]
                adamw_leaf(p, g if clip is None else g * clip.to(g.dtype), m, v, hp,
                           leaf_lr(hp, scale, t), c.use_bfloat16_adam)
        elif views:
            table = np.stack([cuda_adamw.group_row(leaf_lr(hp, scale, t), hp["beta_1"],
                                                   hp["beta_2"], hp["epsilon"],
                                                   hp["weight_decay_rate"])
                              for hp in k.groups])
            cuda_adamw.adamw(views, k.group_of, table, clip, self._lists["update"])
        return metrics
