"""The device's idle share of the traced window, in %: the window's wall
time less the union of the intervals in which an operation ran on the
card (torch.profiler, the card alone), over the window."""


def read(r):
    t = r.trace
    if not t["window_s"] or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
