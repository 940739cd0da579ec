"""Kernels written by hand for Hopper, one module per ``fdes_tpu/pallas/`` file.

Sources live in ``fdes_tpu_torch/csrc/`` and build on first use
(``_build.py``); importing this package builds nothing.

Every kernel wrapper counts its launches on the card in ``<wrapper>.launches``
(a routed one also by kernel in ``launches_by_route``).  The wrappers enter
one registry as their module is imported (``count_launches``):
``reset_launches()`` zeroes every count, and ``launch_count()`` sums the
launches of the wrappers that count kernel launches, which the spans of
``profiling`` read.
"""

_counted: list = []  # every registered wrapper
_kernels: list = []  # those whose count is of kernel launches


def count_launches(*wrappers, routes: tuple[str, ...] = (), calls: bool = False) -> None:
    """Enter ``wrappers`` in the registry with their counts at 0, and with
    ``launches_by_route`` over ``routes`` where given.  ``calls``: their
    counts are of calls that run other wrappers' launches (the panel
    engine's whole loops), left out of ``launch_count``."""
    for w in wrappers:
        w.launches = 0
        if routes:
            w.launches_by_route = dict.fromkeys(routes, 0)
        if w not in _counted:
            _counted.append(w)
            if not calls:
                _kernels.append(w)


def reset_launches() -> None:
    """Zero the count of every registered wrapper."""
    for w in _counted:
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)


def launch_count() -> int:
    """Kernel launches counted since the last reset, over every wrapper."""
    return sum(w.launches for w in _kernels)


def registered() -> tuple:
    """Every wrapper in the registry, in the order it entered."""
    return tuple(_counted)
