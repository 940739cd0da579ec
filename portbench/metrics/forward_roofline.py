"""forward_roofline: the least time of one request's work (roofline.py,
from the cell's shapes) over the device's busy time per request in the
traced sub-window, in %.  Nothing to read outside the forward cells or
without a trace."""

from portbench import roofline


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    if ctx["family"] != "forward" or not t or not ctx["units"] or t["busy_s"] <= 0:
        return None
    return 100.0 * roofline.least_s(*ctx["work"]) / (t["busy_s"] / ctx["units"])
