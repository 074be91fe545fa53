"""The numbers that decide ``correct``, each beside its limit.

Training is judged by the worst leaf: the gap between the program's norm
of a leaf and the reference's, over the reference's norm of that leaf or
of the median leaf, whichever is larger (some gradients are all but 0).
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone, so the parameters' change
leaves them out (by that rule, not by name).
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Any, Dict, List, Mapping, Optional

import torch

NEGLIGIBLE_GRAD = 1e-3


@torch.no_grad()
def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def leaf_gaps(got: Mapping[str, float], ref: Mapping[str, float],
              skip: Optional[set] = None) -> Dict[str, float]:
    """|got - ref| / max(ref, median ref) per leaf; a leaf missing from
    ``got`` reads as 0 and a NaN as inf."""
    names = [n for n in ref if not skip or n not in skip]
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        g = got.get(n, 0.0)
        out[n] = float("inf") if g != g else abs(g - ref[n]) / max(ref[n], med, 1e-30)
    return out


def negligible_leaves(ref_grad_norms: Mapping[str, float]) -> set:
    med = statistics.median(ref_grad_norms.values())
    return {n for n, v in ref_grad_norms.items() if v < NEGLIGIBLE_GRAD * med}


# the numbers a training cell can compare; its workload's limits name the
# ones it does
TRAINING_NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "grad_gap_median", "change_gap",
                    "change_gap_median", "contrastive_gap", "contrastive_grad_gap")
# leaves whose first gradient only the contrastive loss reaches (its two
# heads): the root mean square of their leaf gaps is contrastive_grad_gap
CONTRASTIVE_LEAVES = "contrastive_"
# a number over loss parts: the root mean square, over the steps and the
# parts, of their relative gaps
PART_NUMBERS = {"contrastive_gap": ("contr/lang_to_viz", "contr/viz_to_lang")}


def _step_gaps(got, ref):
    rel = [abs(a - b) / abs(b) if a == a else float("inf") for a, b in zip(got, ref)]
    return rel if len(got) == len(ref) and rel else [float("inf")]


def training_values(prog: Mapping, ref: Mapping) -> Dict[str, Any]:
    """``prog`` and ``ref``: {'losses': [...], 'parts': [{part: value}]
    a step, 'grad': {leaf: norm}, 'change': {leaf: norm}}. Every number of
    ``TRAINING_NUMBERS`` that both have, and the worst leaves under
    'worst'."""
    skip = negligible_leaves(ref["grad"])
    rel = _step_gaps(prog["losses"], ref["losses"])
    grad, change = leaf_gaps(prog["grad"], ref["grad"]), leaf_gaps(prog["change"], ref["change"], skip)
    worst = lambda d: max(d, key=d.get)  # noqa: E731
    out = {"loss_gap": max(rel), "loss1_gap": rel[0],
           "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
           "change_gap": max(change.values()),
           "change_gap_median": statistics.median(change.values()),
           "worst": {"grad": worst(grad), "change": worst(change), "skipped": len(skip)}}
    rms = lambda v: math.sqrt(sum(g * g for g in v) / len(v))  # noqa: E731
    for number, names in PART_NUMBERS.items():
        if ref.get("parts") and all(n in ref["parts"][0] for n in names):
            gaps = [g for n in names
                    for g in _step_gaps([p.get(n, float("nan")) for p in prog["parts"]],
                                        [p[n] for p in ref["parts"]])]
            out[number] = rms(gaps)
    heads = [v for n, v in grad.items() if CONTRASTIVE_LEAVES in n]
    if heads:
        out["contrastive_grad_gap"] = rms(heads)
    return out


def training_checks(prog: Mapping, ref: Mapping, limits: Mapping[str, float]
                    ) -> Dict[str, Dict[str, float]]:
    """The numbers ``limits`` names, each {'value', 'limit'}."""
    values = training_values(prog, ref)
    return {k: {"value": values.get(k, float("inf")), "limit": limits[k]}
            for k in TRAINING_NUMBERS if k in limits}


def passed(checks: Mapping[str, Mapping[str, float]]) -> bool:
    """Every number finite and at or under its limit; a number that could
    not be read (NaN) fails."""
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Mapping[str, Mapping[str, float]]) -> None:
    """The compared numbers as the last lines of standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()


def rows_max_gap(got: List[Mapping[str, torch.Tensor]],
                 ref: List[Mapping[str, torch.Tensor]]) -> float:
    """The widest gap of any element of any key between two lists of
    outputs (a NaN or a missing output reads as inf)."""
    worst = 0.0
    for g, r in zip(got, ref):
        for k, rv in r.items():
            if k not in g or g[k].shape != rv.shape:
                return float("inf")
            d = (g[k].float() - rv.float()).abs().max().item()
            if d != d:
                return float("inf")
            worst = max(worst, d)
    return worst if len(got) == len(ref) else float("inf")
