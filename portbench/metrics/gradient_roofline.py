"""gradient_roofline: the least time of one inverse iteration's work
(roofline.py: the forward, its adjoint, the loss and Adam's update, from
the cell's shapes) over the device's busy time per iteration in the traced
sub-window, in %.  Nothing to read outside the inverse cells or without a
trace."""

from portbench import roofline


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    if ctx["family"] != "invert" or not t or not ctx["units"] or t["busy_s"] <= 0:
        return None
    return 100.0 * roofline.least_s(*ctx["work"]) / (t["busy_s"] / ctx["units"])
