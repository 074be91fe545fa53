"""Permutation scorer for zero-shot story ordering (counterpart of
merlot_tpu/downstream/sort_story/score_permutations.py; numpy on the host).

    python -m merlot_tpu_torch.downstream.sort_story.score_permutations \
        logits_val.npz [--baseline_tsv preds.tsv]

For each story and each of the 5! = 120 candidate orderings, sum the
log-probs of the pairwise cells the ordering implies (class "same" where
the positions match, "earlier"/"later" otherwise) and take the argmax;
then report the Spearman correlation, the absolute distance and the
pairwise accuracy against the identity order. Reads the port's ``.npz``
(``zero_shot.run_zero_shot``) and, where h5py imports, the JAX package's
``.h5``; stories are taken in ``int(story_id)`` order either way. A
baseline's predictions (a tsv of one column, each row a comma-separated
order) can be scored beside them.
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np


def score_permutation(probs: np.ndarray, xa_perm: Sequence[int],
                      xb_perm: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """probs [g, g, 3] (classes: same / a<b / a>b) -> (eq, gtlt) prob mats."""
    g = len(xa_perm)
    eq = np.ones((g, g))
    gtlt = np.ones((g, g))
    for i, ti in enumerate(xa_perm):
        for j, tj in enumerate(xb_perm):
            if ti == tj:
                eq[i, j] = probs[i, j, 0]
            elif ti < tj:
                gtlt[i, j] = probs[i, j, 1]
            else:
                gtlt[i, j] = probs[i, j, 2]
    return eq, gtlt


def best_permutation(probs: np.ndarray, g: int = 5) -> Tuple[int, ...]:
    best, best_score = None, -np.inf
    for perm in itertools.permutations(range(g)):
        eq, gtlt = score_permutation(probs, np.arange(g), perm)
        score = np.log(eq).sum() + np.log(gtlt).sum()
        if score > best_score:
            best, best_score = perm, score
    return best


def spearman_acc(story: Sequence[int]) -> float:
    from scipy import stats
    return stats.spearmanr(story, list(range(len(story))))[0]


def absolute_distance(story: Sequence[int]) -> float:
    return float(np.mean(np.abs(np.asarray(story) - np.arange(len(story)))))


def pairwise_acc(story: Sequence[int]) -> float:
    n = len(story)
    correct = sum(1 for i in range(n) for j in range(i + 1, n) if story[i] < story[j])
    return correct / (n * (n - 1) // 2)


def evaluate_stories(stories: List[Sequence[int]]) -> Dict[str, float]:
    return {
        "spearman": float(np.mean([spearman_acc(s) for s in stories])),
        "absolute_distance": float(np.mean([absolute_distance(s) for s in stories])),
        "pairwise": float(np.mean([pairwise_acc(s) for s in stories])),
    }


def load_probs(path: str, modality: str = "lang_viz") -> List[np.ndarray]:
    """Each story's [g, g, 3] probs of ``modality``, in int(story_id)
    order, from the port's ``.npz`` or the JAX package's ``.h5``."""
    key = f"{modality}_probs"
    if path.endswith(".h5"):
        import h5py
        with h5py.File(path, "r") as h5:
            return [np.asarray(h5[sid][key]) for sid in sorted(h5.keys(), key=int)]
    with np.load(path) as z:
        sids = {name.split("/")[0] for name in z.files}
        return [z[f"{sid}/{key}"] for sid in sorted(sids, key=int)]


def score_file(path: str, modality: str = "lang_viz") -> Dict[str, float]:
    """The three metrics over the best permutation of every story in the
    file (``.npz`` or ``.h5``)."""
    return evaluate_stories([best_permutation(p) for p in load_probs(path, modality)])


def read_baseline_tsv(path: str) -> List[List[int]]:
    """A baseline's predicted orders: one row per story, comma-separated
    ints; blank rows are skipped."""
    with open(path) as f:
        return [[int(y) for y in line.strip().split(",")] for line in f if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="logits file: the port's .npz or the JAX package's .h5")
    ap.add_argument("--baseline_tsv", default=None,
                    help="optional baseline predictions tsv (comma-separated orders)")
    args = ap.parse_args(argv)

    metrics = score_file(args.path)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    if args.baseline_tsv:
        print("baseline:")
        for k, v in evaluate_stories(read_baseline_tsv(args.baseline_tsv)).items():
            print(f"  {k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
