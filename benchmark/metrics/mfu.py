"""The whole step's share of the card's peak, in %: the model's operations
a step, counted from shapes (forward and backward, no recompute, no
optimizer; ``harness/counts.py``), times the window's steps, over the
window's seconds and the published peak of the configuration's type
(989 TFLOP/s bf16, 67 TFLOP/s float32)."""


def read(r):
    w = r.window
    if not w["steps"] or not r.flops_per_step:
        return None
    return 100.0 * r.flops_per_step * w["steps"] / (w["seconds"] * r.peak_flops)
