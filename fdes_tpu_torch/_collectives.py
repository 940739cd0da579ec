"""Differentiable collectives over a process group (torch.distributed).

The sharded paths (sharding.py, gridshard.py) move data between ranks only
through these functions, each but ``pmax`` a ``torch.autograd.Function``
whose backward is the collective's adjoint:

* ``all_to_all(x, group, split_dim, concat_dim)``: ``jax.lax.all_to_all``
  with ``tiled=True``.  x is cut into n blocks along ``split_dim``, block j
  goes to group rank j, and the blocks received are concatenated along
  ``concat_dim`` in group-rank order.  Its backward is the reverse
  all-to-all (the two dims swapped);
* ``psum(x, group)``: the sum over the group.  Its backward is the identity:
  every rank holds the summed value, and a loss that every rank holds sends
  each rank's own cotangent back to its own input;
* ``pvary(x, group)``: the identity on a tensor that every rank of the group
  holds alike (V under a measurement split).  Its backward is the psum, the
  transpose of replication: the gradient of a replicated input is the sum of
  the ranks' gradients;
* ``all_gather(x, group, dim)``: the group's blocks concatenated along
  ``dim`` in group-rank order.  Its backward keeps this rank's block, for a
  loss that every rank holds;
* ``shift(x, group)``: ``jax.lax.ppermute`` by one, cyclic: rank i's x goes
  to rank i + 1 and the last rank's to rank 0.  Its backward shifts the
  other way;
* ``pmax(x, group)``: the elementwise maximum over the group, for the
  optimizer's host-side scalars (not differentiable).

A group of None means one process and no communication: each function is
then the identity (the gather of one block), so the sharded code runs
unchanged in a single process.  A complex tensor travels as
``torch.view_as_real``: NCCL and gloo see a real dtype.  The differentiable
ones are permutations or sums with real coefficients, so PyTorch's
convention for the gradient of a complex tensor passes through them
unchanged.

``collective_clock()`` times the collectives on the host clock while it is
open, each between two device synchronisations (so the time is the
collective's own, and the device work before it is not counted).
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

_clock: dict | None = None


@contextlib.contextmanager
def collective_clock():
    """Yield {"calls": n, "seconds": s}, the collectives run while open."""
    global _clock
    outer, _clock = _clock, {"calls": 0, "seconds": 0.0}
    try:
        yield _clock
    finally:
        _clock = outer


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _run(fn, t: torch.Tensor) -> None:
    """fn(), timed into the open clock."""
    if _clock is None:
        fn()
        return
    _sync(t)
    t0 = time.perf_counter()
    fn()
    _sync(t)
    _clock["calls"] += 1
    _clock["seconds"] += time.perf_counter() - t0


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    split_dim %= x.ndim
    concat_dim %= x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"into {n} blocks")
    # all_to_all_single cuts dim 0: the split dim goes to the front, and each
    # block received goes back to x's layout before the concatenation
    send = x.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _run(lambda: dist.all_to_all_single(_real(recv), _real(send), group=group), send)
    return torch.cat([b.movedim(0, split_dim) for b in recv.chunk(n, 0)], dim=concat_dim)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    _run(lambda: dist.all_reduce(_real(y), group=group), y)
    return y


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """x of rank i to rank i + step (cyclic), as one all_to_all_single whose
    only non-empty block goes to that rank."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    send = x.contiguous()
    recv = torch.empty_like(send)
    rows = send.shape[0]
    ins = [rows if j == (r + step) % n else 0 for j in range(n)]
    outs = [rows if j == (r - step) % n else 0 for j in range(n)]
    _run(lambda: dist.all_to_all_single(_real(recv), _real(send), output_split_sizes=outs,
                                        input_split_sizes=ins, group=group), send)
    return recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.args = (dist.get_rank(group), n, dim)
        src = x.contiguous()
        blocks = [torch.empty_like(src) for _ in range(n)]
        _run(lambda: dist.all_gather([_real(b) for b in blocks], _real(src), group=group), src)
        return torch.cat(blocks, dim=dim)

    @staticmethod
    def backward(ctx, g):
        r, n, dim = ctx.args
        return g.chunk(n, dim)[r].contiguous(), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all (module docstring); the identity for group None."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, every rank holding it; backward the identity."""
    if group is None:
        return x
    return _Psum.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """Identity on a tensor replicated over the group; backward the psum."""
    if group is None:
        return x
    return _Pvary.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the group (not differentiable)."""
    if group is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    _run(lambda: dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group), y)
    return y


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks concatenated along dim, in group-rank order."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """x of rank i arrives at rank i + 1 (cyclic) along dim 0's rows."""
    if group is None:
        return x
    return _Shift.apply(x, group)
