"""The readings a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \\
        [--first-seed N] [--out FILE]

For each seed: the program's run as the benchmark makes it (set-up, a
short window, the program's state freed) judged against the float32
reference (the lower readings). On the first ``--control-seeds`` seeds
also, each judged against the same float32 reference: the control (the
reference put in the program's place in the precision below the
configuration's: float8, e4m3 values and e5m2 gradients, where a bf16
configuration computes in bf16; TF32 for a float32 one), the reference
over half of each batch (the fault "half of the batch left out, the mean
taken over the rest"), and the reference rounded to the configuration's
own bf16 (a witness of what bf16's rounding alone moves). A step that
returns its state unchanged reads 1 on ``change_gap`` by its measure and
needs no run. For the pretraining step it also records the share of
masked positions that the program's and the reference's masking choose
differently (``masked_moved``). Each seed's numbers go to standard output
as one JSON line, and all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def masked_positions(record: dict):
    """Records the masked positions the program's and the reference's
    masking choose (a look at what moves the pretrain step's numbers)."""
    from merlot_tpu_torch.models import merlot as program
    from benchmark.reference import merlot as reference

    def keep(side, f):
        def wrapped(*a, **kw):
            out = f(*a, **kw)
            record.setdefault(side, []).append(out[1].detach().cpu())
            return out
        return wrapped
    saved = (program.attention_guided_span_mask, reference.span_mask)
    program.attention_guided_span_mask = keep("program", saved[0])
    reference.span_mask = keep("reference", saved[1])
    try:
        yield record
    finally:
        program.attention_guided_span_mask, reference.span_mask = saved


def moved_share(record: dict, steps: int) -> list:
    """Per step, the share of masked positions the program chose that the
    float32 reference did not."""
    out = []
    for p, r in zip(record.get("program", [])[:steps], record.get("reference", [])[:steps]):
        same = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(p, r))
        out.append(1.0 - same / p.numel())
    return out


def seed_readings(cell, window_steps: int, controls: bool) -> dict:
    """One seed's readings: the program's numbers and, with ``controls``,
    the control's (and a training cell's half-batch fault's), each against
    the float32 reference; values only, limits left out."""
    import torch

    from benchmark.harness import compare
    from benchmark.harness.cell import TrainingCell, tf32

    unlimited = {k: float("inf") for k in cell.ctx.limits}
    if isinstance(cell, TrainingCell):
        unlimited = {k: float("inf") for k in compare.TRAINING_NUMBERS}
    t0 = time.perf_counter()
    record: dict = {}
    pretrain = cell.ctx.params.get("cell") == "pretrain"
    look = (lambda: masked_positions(record)) if pretrain else contextlib.nullcontext
    with look():
        cell.setup()
    outs = [cell.step()[1] for _ in range(window_steps)]
    if cell.dev.type == "cuda":
        torch.cuda.synchronize()
    cell.release()
    row = {"seed": cell.ctx.seed, "setup_and_window_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    if isinstance(cell, TrainingCell):
        with tf32(False), look():
            ref = cell.reference_run()
        row["reference_s"] = time.perf_counter() - t0
        if pretrain:
            row["masked_moved"] = moved_share(record, cell.check_steps)
        row["program"] = compare.training_values(cell.program_readings(), ref)
        row["losses"] = {"program": cell.prog_losses, "reference": ref["losses"]}
        if controls:
            row["control"] = compare.training_values(cell.control_run(), ref)
            with tf32(False):
                half = cell.reference_run(fault="half_batch")
            row["half_batch"] = compare.training_values(half, ref)
            if cell.control == "fp8":
                with tf32(False):
                    row["bf16_reference"] = compare.training_values(cell.reference_run("bf16"), ref)
    else:
        row["program"] = cell.check(outs)
        row["reference_s"] = time.perf_counter() - t0
        if controls:
            picked = cell.judged(len(outs))
            ctrl = cell.control_run()
            with tf32(False):
                ref = cell.reference_probs()
            gap = compare.rows_max_gap([ctrl[outs[j][0]] for j in picked],
                                       [ref[outs[j][0]] for j in picked])
            row["control"] = {"prob_gap": {"value": gap, "limit": float("inf")}}
            with tf32(False):
                bf16 = cell.reference_probs("bf16")
            gap = compare.rows_max_gap([bf16[outs[j][0]] for j in picked],
                                       [ref[outs[j][0]] for j in picked])
            row["bf16_reference"] = {"prob_gap": {"value": gap, "limit": float("inf")}}
            with tf32(False):
                half = cell.reference_probs(fault="half_batch")
            gap = compare.rows_max_gap([half[outs[j][0]] for j in picked],
                                       [ref[outs[j][0]] for j in picked])
            row["half_batch"] = {"prob_gap": {"value": gap, "limit": float("inf")}}
    return {k: ({n: c["value"] if isinstance(c, dict) and "value" in c else c
                 for n, c in v.items()}
                if k in ("program", "control", "half_batch", "bf16_reference") else v)
            for k, v in row.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--window-steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import registry
    from benchmark.harness.cell import Context

    wl = registry.workload(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    unlimited = {k: float("inf") for k in wl["limits"]}
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        ctx = Context(config=registry.config(wl["config"]), params=wl["params"],
                      limits=unlimited, seed=seed, device=torch.device("cuda", 0))
        cell = registry.traffic(wl["traffic"]).Cell(ctx)
        row = seed_readings(cell, args.window_steps, i < args.control_seeds)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del cell
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
