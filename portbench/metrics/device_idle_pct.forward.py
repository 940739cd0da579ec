"""device_idle_pct.forward: 100 (1 - busy / window) over the traced
sub-window of a forward cell, busy the union of the kernels' intervals."""


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    if ctx["family"] != "forward" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
