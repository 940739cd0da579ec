"""device_idle_pct.invert: 100 (1 - busy / window) over the traced
sub-window of an inverse cell, busy the union of the kernels' intervals:
the host's work in the optimizer loop and autograd shows here."""


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    if ctx["family"] != "invert" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
