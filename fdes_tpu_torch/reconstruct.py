"""Inverse reconstruction engine (SURVEY.md C13/C14, L6, §3.2).

Counterpart of ``fdes_tpu.reconstruct``.  Each iteration evaluates the loss
and its gradient with respect to the potential stack (autograd through the
multislice: the adjoint kernels on engine "pallas") and takes one
``torch.optim`` step, optionally followed by a projection (positivity).

The host does not wait for the device each iteration: the loss and gradient
norm stay on the device and are fetched in chunks of ``metrics_every``
iterations, as in the JAX package.  (``torch.optim.LBFGS`` is the exception:
its line search reads the loss on the host at every evaluation.)

Checkpoint/resume (SURVEY.md §5): every ``checkpoint_every`` iterations V,
the optimizer's ``state_dict()`` and the iteration count go into one .npz,
written to a temporary file and renamed into place, so a crash leaves the
previous checkpoint whole; ``resume`` restarts from it.

Spans of ``profiling``: ``setup.optimizer`` (V's copy and the optimizer's
construction); ``reconstruct.step`` an iteration (the request of the
inverse), inside it ``reconstruct.optimizer`` (the optimizer's step, its
self time the update) and inside that the closure's ``reconstruct.loss``
and ``reconstruct.backward``; ``reconstruct.flush`` and
``reconstruct.result`` (the final V) with counter ``fetch_bytes``, and
``reconstruct.checkpoint`` with counter ``checkpoint_bytes``.

The optimizers are ``torch.optim``'s, set to the optax defaults the JAX
package uses.  For a real V they take the same steps; for a complex
(absorptive) V they do not: optax's adam keeps one second moment |g|^2 per
complex entry, ``torch.optim.Adam`` one per real and imaginary part.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ._collectives import all_gather, pmax, psum
from .profiling import count, span


@dataclasses.dataclass
class ReconResult:
    """Terminal state of a reconstruction run."""

    v: np.ndarray
    losses: np.ndarray
    iterations: int
    wall_s: float
    #: median per-step wall (s) over the metric chunks after the first — the
    #: steady-state rate; ``wall_s`` also carries one-time costs (cuFFT
    #: plans, the final checkpoint and result transfers)
    median_step_s: float = 0.0


class LBFGS(torch.optim.Optimizer):
    """L-BFGS with the update rule of ``optax.lbfgs`` (``scale_by_lbfgs``).

    One ``step(closure)`` is one iteration: the two-loop product of the last
    10 curvature pairs with the gradient, the identity scaled by y.s / y.y
    of the newest pair (by min(1, 1/|g|) at the first step), and a
    strong-Wolfe line search of at most 20 evaluations from a unit step
    (PyTorch's own, ``torch.optim.lbfgs._strong_wolfe``): optax.lbfgs's
    defaults.  A pair is
    the change of the parameters and of the gradient between two steps, so
    a projection applied between steps is part of it; it is kept whenever
    y.s != 0, as optax keeps it.  ``torch.optim.LBFGS`` drops
    pairs with y.s <= 1e-10, an absolute cut that a potential in V*Å (where
    gradients are ~1e-8) crosses long before it is recovered: the tilt-series
    gate then stalls at 1.3e-3.  Complex parameters are optimised as pairs of
    reals.
    """

    HISTORY_SIZE = 10
    MAX_LS = 20

    def __init__(self, params, group=None):
        super().__init__(params, {})
        #: the process group over which the parameters are split (a row
        #: block of V under a 'grid' mesh): dot products, norms and the line
        #: search's scalars are then summed over it; None for whole ones
        self.group = group

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> float:
        return float(psum(a.dot(b), self.group))

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([torch.view_as_real(p.grad).reshape(-1) if p.is_complex()
                          else p.grad.reshape(-1) for p in self._params()])

    def _flat_params(self) -> torch.Tensor:
        return torch.cat([torch.view_as_real(p).reshape(-1) if p.is_complex() else p.reshape(-1)
                          for p in self._params()])

    def _add(self, t: float, d: torch.Tensor) -> None:
        i = 0
        for p in self._params():
            pr = torch.view_as_real(p) if p.is_complex() else p
            n = pr.numel()
            pr.add_(d[i : i + n].view_as(pr), alpha=t)
            i += n

    @torch.no_grad()
    def step(self, closure):
        from torch.optim.lbfgs import _strong_wolfe

        closure = torch.enable_grad()(closure)
        state = self.state[self._params()[0]]
        orig_loss = closure()
        g, x = self._flat_grad(), self._flat_params()
        mem = state.setdefault("memory", [])  # [(s, y, 1/y.s)], oldest first
        if "x" in state:
            s, y = x - state["x"], g - state["g"]
            ys = self._dot(y, s)
            if ys != 0.0:
                mem.append((s, y, 1.0 / ys))
                del mem[: -self.HISTORY_SIZE]
        q = g.neg()
        alphas = []
        for s, y, rho in reversed(mem):
            a = rho * self._dot(s, q)
            q.add_(y, alpha=-a)
            alphas.append(a)
        if mem:
            s, y, _ = mem[-1]
            q.mul_(self._dot(y, s) / self._dot(y, y))
        else:
            gnorm = float(g.norm()) if self.group is None else math.sqrt(self._dot(g, g))
            q.mul_(1.0 / gnorm if gnorm > 1.0 else 1.0)
        for (s, y, rho), a in zip(mem, reversed(alphas)):
            q.add_(s, alpha=a - rho * self._dot(y, q))
        d = q

        x0 = [p.detach().clone() for p in self._params()]

        # The line search reads its vectors through d.abs().max() and
        # g.dot(d) alone (so in PyTorch 2.11 and 2.13; the 'grid' LBFGS cases
        # of tests/test_torch_gridshard.py and test_torch_cli.py hold it to
        # one process).  Split over a group, it is handed one-element
        # stand-ins that give the global values: d as [max |d|] and each
        # gradient as [g.d / max |d|].
        if self.group is None:
            ls_d, ls_g, scale = d, g, None
        else:
            scale = float(pmax(d.abs().max(), self.group)) or 1.0
            ls_d = d.new_tensor([scale])
            ls_g = d.new_tensor([self._dot(g, d) / scale])

        def evaluate(x, t, _):
            self._add(t, d)
            loss = float(closure())
            grad = self._flat_grad()
            if scale is not None:
                grad = d.new_tensor([self._dot(grad, d) / scale])
            for p, xp in zip(self._params(), x):
                p.copy_(xp)
            return loss, grad

        _, _, t, _ = _strong_wolfe(
            evaluate, x0, 1.0, ls_d, float(orig_loss), ls_g, ls_g.dot(ls_d), max_ls=self.MAX_LS
        )
        self._add(t, d)
        state["x"], state["g"] = x, g
        return orig_loss


#: optax's defaults where torch.optim's differ: adamw's weight decay is 1e-4
#: in optax and 1e-2 in torch.
_OPTIMIZERS: dict[str, Callable[..., Callable]] = {
    "sgd": lambda lr, **kw: functools.partial(torch.optim.SGD, lr=lr, **kw),
    "momentum": lambda lr, **kw: functools.partial(
        torch.optim.SGD, lr=lr, momentum=0.9, dampening=0.0, **kw
    ),
    "adam": lambda lr, **kw: functools.partial(torch.optim.Adam, lr=lr, eps=1e-8, **kw),
    "adamw": lambda lr, **kw: functools.partial(
        torch.optim.AdamW, lr=lr, eps=1e-8, **{"weight_decay": 1e-4, **kw}
    ),
    # the line search sets the step, so lr is ignored, as in the JAX package
    "lbfgs": lambda lr, **kw: functools.partial(LBFGS, **kw),
}


def make_optimizer(
    name: str = "adam", lr: float = 1.0, **kwargs
) -> Callable[[list[torch.Tensor]], torch.optim.Optimizer]:
    """Named optimizer for the CLI/config layer (SURVEY.md C14).

    Returns a factory: called with the list of parameters, it builds the
    ``torch.optim`` optimizer.  ``kwargs`` go to its constructor.
    """
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; options: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](lr, **kwargs)


def positive_projection(v: torch.Tensor) -> torch.Tensor:
    """Project the potential onto V >= 0 (elementwise; complex potentials
    clip both channels — the absorptive part is nonnegative too)."""
    if v.is_complex():
        return torch.complex(v.real.clamp_min(0.0), v.imag.clamp_min(0.0))
    return v.clamp_min(0.0)


def save_checkpoint(path: str, v: torch.Tensor, opt_state: dict, iteration: int) -> None:
    """Write V, an optimizer ``state_dict()`` and the iteration to one .npz.

    The file appears whole or not at all: it is written under a temporary
    name and renamed into place.
    """
    buf = io.BytesIO()
    torch.save(opt_state, buf)
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        iteration=iteration,
        v=v.detach().cpu().numpy(),
        opt_state=np.frombuffer(buf.getvalue(), dtype=np.uint8),
    )
    os.replace(tmp, path)


def load_checkpoint(
    path: str, map_location: torch.device | str | None = None
) -> tuple[torch.Tensor, dict, int]:
    """Restore (v, opt_state, iteration) written by save_checkpoint; raises
    FileNotFoundError if absent.  The optimizer state is read with
    ``weights_only=True``: tensors, numbers and containers only."""
    with np.load(path) as z:
        v = torch.as_tensor(z["v"], device=map_location)
        blob = z["opt_state"].tobytes()
        iteration = int(z["iteration"])
    opt_state = torch.load(io.BytesIO(blob), map_location=map_location, weights_only=True)
    return v, opt_state, iteration


class MetricsWriter:
    """Append-only JSONL metrics (SURVEY.md §5 metrics row).

    Values must already be host scalars — the writer never forces a device
    sync of its own.
    """

    def __init__(self, path: str | None):
        self.path = path or None
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)

    def write(self, **kv: Any) -> None:
        if self.path:
            self._fh.write(json.dumps(kv) + "\n")

    def close(self) -> None:
        if self.path:
            self._fh.close()


#: the optimizers that run on this rank's rows of V under a 'grid' mesh:
#: elementwise ones, and LBFGS with its dots over the grid; and the names of
#: their per-parameter state of V's shape (LBFGS's are x, g and memory)
_ROW_OPTIMIZERS = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW, LBFGS)
_ROW_STATE = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "momentum_buffer")


class _RowShare:
    """V's split over a mesh's 'grid' axis: this rank's rows of every slice
    (group None: V whole, in one process or replicated over the ranks)."""

    def __init__(self, v: torch.Tensor, mesh):
        grid = mesh is not None and "grid" in mesh.axis_names
        self.mesh = mesh
        self.group = mesh.group("grid") if grid else None
        self.n = mesh.shape["grid"] if grid else 1
        self.index = mesh.index("grid") if grid else 0
        self.slices, self.device = v.shape[0], v.device

    def norm(self, g: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(g)
        return n if self.group is None else psum(n * n, self.group).sqrt()

    def agree(self, exists: bool, path: str) -> bool:
        """exists, the same on every rank: a checkpoint that some ranks see
        and others do not would split their iteration counts."""
        if self.mesh is None or self.mesh.group(self.mesh.axis_names) is None:
            return exists
        flag = torch.tensor(float(exists), device=self.device)
        seen = int(psum(flag, self.mesh.group(self.mesh.axis_names)))
        if 0 < seen < self.mesh.devices.size:
            raise RuntimeError(f"checkpoint {path!r} is seen by {seen} of "
                               f"{self.mesh.devices.size} ranks; put it on storage every rank "
                               "reads")
        return exists

    def _map(self, state: dict, fn) -> dict:
        """An optimizer's ``state_dict()`` with fn applied to each of its
        tensors that holds V's rows, found by name: adam's and momentum's
        buffers (V's shape), LBFGS's x, g and memory pairs (a flat view of
        V's reals).  Any other entry has no known layout, and raises."""
        out = {**state, "state": {}}
        for key, entries in state["state"].items():
            mapped = {}
            for name, x in entries.items():
                if name == "step":
                    mapped[name] = x
                elif name in _ROW_STATE or name in ("x", "g"):
                    mapped[name] = None if x is None else fn(x)
                elif name == "memory":
                    mapped[name] = [(fn(s), fn(y), rho) for s, y, rho in x]
                else:
                    raise ValueError(f"optimizer state {name!r} has no known layout under a "
                                     "'grid' mesh")
            out["state"][key] = mapped
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole of a tensor of this rank's size: V's (S, ny/n, nx) rows,
        or a flat view of their reals (slice-major, so each slice's rows are
        one run)."""
        if self.group is None:
            return t
        whole = all_gather(t.reshape(self.slices, -1), self.group, dim=1)
        return whole.reshape(self.slices, -1, *t.shape[2:]) if t.ndim == 3 else whole.reshape(-1)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's share of a whole tensor (gather's inverse)."""
        if self.group is None:
            return t
        mine = t.reshape(self.slices, -1).chunk(self.n, dim=1)[self.index]
        return (mine.reshape(self.slices, -1, *t.shape[2:]) if t.ndim == 3
                else mine.reshape(-1)).contiguous()

    def gather_state(self, state: dict) -> dict:
        return state if self.group is None else self._map(state, self.gather)

    def take_state(self, state: dict) -> dict:
        return state if self.group is None else self._map(state, self.take)


def _backward_checked(loss: torch.Tensor, it: int, grad_norm: Callable[[], torch.Tensor]) -> None:
    """loss.backward() with the loss and the gradient's norm (``grad_norm()``,
    the same on every rank) read on the host: a non-finite one raises
    FloatingPointError naming iteration ``it``.  Anomaly mode's own NaN check
    is off for this backward, since its error is a RuntimeError told apart
    only by its text; the gradient is read instead."""
    if not torch.isfinite(loss):
        raise FloatingPointError(f"invert: loss {loss.item()} at iteration {it}")
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        loss.backward()
    gn = grad_norm()
    if not torch.isfinite(gn):
        raise FloatingPointError(f"invert: gradient norm {gn.item()} at iteration {it}")


def reconstruct(
    loss_fn: Callable[..., torch.Tensor],
    v0: torch.Tensor,
    *,
    loss_args: tuple = (),
    iterations: int = 100,
    optimizer: Callable[[list[torch.Tensor]], torch.optim.Optimizer] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 50,
    resume: bool = False,
    metrics_path: str | None = None,
    metrics_every: int = 16,
    callback: Callable[[int, float, torch.Tensor], None] | None = None,
    project: Callable[[torch.Tensor], torch.Tensor] | None = None,
    mesh=None,
) -> ReconResult:
    """Gradient-descent reconstruction of the potential stack.

    loss_fn(v, *loss_args): scalar loss of the (S, ny, nx) potential (see
    loss.make_loss).  optimizer: a make_optimizer factory (default adam,
    lr 1).  V lives on v0's device and dtype.

    mesh: the sharding.Mesh of a sharded run, every rank calling with its
    own share and loss_fn giving every rank the global loss and this rank's
    gradient (loss.make_loss with the mesh).  Under a 'grid' axis v0 is this
    rank's (S, ny/n, nx) rows of V: the optimizer's dot products and norms,
    the gradient norm of the metrics and the line search run over the axis,
    and the checkpoint and the result hold the whole V, gathered (the
    checkpoint's file is the one a single process writes, and on resume
    each rank reads its rows).  Rank 0 alone writes the metrics and the
    checkpoint.

    project: optional constraint projection applied to V after each update
    (projected gradient descent), e.g. positive_projection.

    callback contract: ``callback(it, loss, v)`` fires at metric FLUSH time
    (every ``metrics_every`` iterations), and every call in a flushed chunk
    receives the CURRENT v — the latest iterate, not the iterate of ``it``.
    That is the price of fetching the metrics in chunks; a callback that
    needs v at each iteration sets metrics_every=1 and pays a sync each.

    Under autograd's anomaly mode with its NaN check
    (``torch.autograd.set_detect_anomaly(True, check_nan=True)``, which the
    CLI's ``--debug-nans`` turns on for its run, as the JAX package's sets
    ``jax_debug_nans``), each iteration's loss and gradient norm are read on
    the host, and a non-finite one raises FloatingPointError naming the
    iteration.  Without it nothing is read.
    """
    with span("setup.optimizer"):  # a first torch.optim optimizer imports torch._dynamo
        v = v0.detach().clone().requires_grad_(True)
        opt = (optimizer or make_optimizer("adam", 1.0))([v])
    rows = _RowShare(v, mesh)
    if rows.group is not None and not isinstance(opt, _ROW_OPTIMIZERS):
        raise ValueError(f"{type(opt).__name__} is not known to run on V's rows under a 'grid' "
                         f"mesh; use one of {[o.__name__ for o in _ROW_OPTIMIZERS]}")
    if isinstance(opt, LBFGS):
        opt.group = rows.group
    writer = mesh is None or mesh.rank == 0

    start = 0
    if resume and checkpoint_path and rows.agree(os.path.exists(checkpoint_path),
                                                  checkpoint_path):
        v_ck, opt_state, start = load_checkpoint(checkpoint_path, map_location=v.device)
        with torch.no_grad():
            v.copy_(rows.take(v_ck))
        opt.load_state_dict(rows.take_state(opt_state))

    def save(iteration: int) -> None:
        with span("reconstruct.checkpoint"):
            v_all, state = rows.gather(v.detach()), rows.gather_state(opt.state_dict())
            if writer:
                save_checkpoint(checkpoint_path, v_all, state, iteration)
                count("checkpoint_bytes", os.path.getsize(checkpoint_path))

    metrics = MetricsWriter(metrics_path if writer else None)
    losses: list[float] = []
    pending: list[tuple[int, torch.Tensor, torch.Tensor]] = []
    step_walls: list[float] = []
    t0 = chunk_t0 = time.perf_counter()

    def flush(callbacks: bool = True) -> None:
        nonlocal chunk_t0
        if not pending:
            return
        with span("reconstruct.flush"):
            # one device->host transfer for the whole chunk
            stacked = torch.stack([x for _, lv, gn in pending for x in (lv, gn)])
            count("fetch_bytes", stacked.numel() * stacked.element_size())
            values = stacked.cpu().reshape(-1, 2).tolist()
            its = [it for it, _, _ in pending]
            pending.clear()
            dt = (time.perf_counter() - chunk_t0) / len(its)
            step_walls.append(dt)
            for it, (lv, gn) in zip(its, values):
                losses.append(lv)
                metrics.write(iter=it, loss=lv, grad_norm=gn, step_s=dt)
        if callbacks and callback is not None:
            for it, (lv, _) in zip(its, values):
                callback(it, lv, v.detach())
        chunk_t0 = time.perf_counter()

    check_nans = torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()

    def step(it: int) -> tuple[torch.Tensor, torch.Tensor]:
        first: list[tuple[torch.Tensor, torch.Tensor]] = []

        def closure():
            opt.zero_grad()
            with span("reconstruct.loss"):
                loss = loss_fn(v, *loss_args)
            with span("reconstruct.backward"):
                if check_nans:
                    _backward_checked(loss, it, lambda: rows.norm(v.grad.detach()))
                else:
                    loss.backward()
            if not first:  # LBFGS evaluates again in its line search
                first.append((loss.detach(), rows.norm(v.grad.detach())))
            return loss

        with span("reconstruct.optimizer"):
            opt.step(closure)
        if project is not None:
            with torch.no_grad():
                v.copy_(project(v))
        return first[0]

    try:
        for it in range(start, iterations):
            with span("reconstruct.step"):
                loss, gnorm = step(it)
            pending.append((it, loss, gnorm))
            if len(pending) >= max(metrics_every, 1):
                flush()
            if checkpoint_path and (it + 1) % checkpoint_every == 0:
                flush()  # metrics and callbacks precede their checkpoint
                save(it + 1)
        flush()
    except BaseException:
        # keep the metrics of the iterations that ran; the original error
        # propagates, so a failing fetch here must not replace it
        with contextlib.suppress(Exception):
            flush(callbacks=False)
        raise
    finally:
        metrics.close()
    if checkpoint_path:
        save(iterations)
    walls = step_walls[1:] if len(step_walls) > 1 else step_walls
    with span("reconstruct.result"):
        v_all = rows.gather(v.detach())
        count("fetch_bytes", v_all.numel() * v_all.element_size())
        v_host = v_all.cpu().numpy()
    return ReconResult(
        v=v_host,
        losses=np.asarray(losses),
        iterations=iterations,
        wall_s=time.perf_counter() - t0,
        median_step_s=float(np.median(walls)) if walls else 0.0,
    )
