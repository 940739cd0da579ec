"""Process meshes and measurement-axis sharding (SURVEY.md C19/C20, §2.1/§2.2).

Counterpart of ``fdes_tpu.sharding`` on ``torch.distributed``, in SPMD
style: one process per rank, started by ``torchrun`` on a cluster (or by
``torch.multiprocessing``), each holding its own share of the work.

* ``init_distributed`` joins the process group (a no-op for one process);
* ``make_mesh`` lays the world's ranks out row-major on named axes, flat
  ``('data',)`` by default, ``('host', 'chip')`` or ``('data', 'grid')``
  with a shape, and makes one process group for every set of its axes;
* the measurement axis (defoci, tilts, probe positions) is split over the
  whole mesh (``shard_measurements``: this rank's rows); the potential V is
  held whole by every rank;
* ``sharded_value_and_grad``: each rank's loss and gradient of its share,
  summed over the mesh as the CLI's loss sums them, equal to one process's.

A mesh in a single process that never joined a group (world of 1) has no
groups: every collective is then the identity, and the sharded code runs as
the single-process code does.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ._collectives import psum, pvary


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    *,
    device: torch.device | str = "cuda",
) -> None:
    """Join the process group; a no-op for a single process or once joined.

    With no arguments it reads ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and without it is a single
    process.  Explicit arguments are for processes started by hand (tests):
    ``coordinator`` is an init URL (``tcp://host:port``, ``file:///path``)
    or ``host:port``.  ``backend=None`` means ``"nccl"`` on ``cuda`` and
    ``"gloo"`` on ``cpu``; ``"gloo"`` on ``cuda`` puts several ranks on one
    card (NCCL refuses two ranks on one GPU).  On ``cuda`` each rank takes
    the card of its local rank, modulo the cards there are.
    """
    if dist.is_initialized():
        return
    by_hand = coordinator is not None or num_processes is not None
    if not by_hand and "WORLD_SIZE" not in os.environ:
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if by_hand:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("init_distributed needs coordinator, num_processes and process_id "
                             "together")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
        local = process_id
    else:
        dist.init_process_group(backend, init_method="env://")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The world's ranks on named axes, row-major (``devices`` holds the
    ranks, in place of JAX's devices).  ``group(axes)`` is the process group
    of the ranks that share this rank's place on every other axis: the group
    a collective over those axes runs in (None where there is no one to talk
    to: a single process, or an axis set of size 1)."""

    axis_names: tuple[str, ...]
    devices: np.ndarray
    rank: int
    groups: dict

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def index(self, axis: str) -> int:
        """This rank's place along ``axis`` (``jax.lax.axis_index``)."""
        pos = np.argwhere(self.devices == self.rank)[0]
        return int(pos[self.axis_names.index(axis)])

    def group(self, axes):
        """Process group over ``axes`` (a name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups[frozenset(axes)] if axes else None


def make_mesh(axis_names: tuple[str, ...] = ("data",), shape: tuple[int, ...] | None = None) -> Mesh:
    """Mesh over all ranks of the world (1 without a process group).

    Default: flat 1-D ('data',) mesh.  Pass axis_names=('host', 'chip') with
    shape=(nhosts, chips_per_host), or ('data', 'grid'), to lay the ranks
    out on two axes.  Every rank must call it, in the same order as every
    other mesh it makes: it makes the process groups of the mesh.
    """
    axis_names = tuple(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required when len(axis_names) > 1")
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name axes {axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks; the world has "
                         f"{world}")
    devices = np.arange(world).reshape(shape)
    groups = {}
    for k in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(range(len(axis_names)), k):
            groups[frozenset(axis_names[a] for a in axes)] = _axes_group(devices, axes, rank)
    return Mesh(axis_names, devices, rank, groups)


def _axes_group(devices: np.ndarray, axes: tuple[int, ...], rank: int):
    """The group of ``rank`` along ``axes``; makes every such group, since
    dist.new_group is called by every rank for every group."""
    if not dist.is_initialized():
        return None
    rest = [a for a in range(devices.ndim) if a not in axes]
    blocks = np.transpose(devices, rest + list(axes)).reshape(-1, int(np.prod(
        [devices.shape[a] for a in axes])))
    if blocks.shape[1] == devices.size:
        return dist.group.WORLD
    mine = None
    for ranks in blocks:
        g = dist.new_group([int(r) for r in ranks]) if len(ranks) > 1 else None
        if rank in ranks:
            mine = g
    return mine


def data_axis_size(mesh: Mesh) -> int:
    return int(np.prod(mesh.devices.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """How an array lies on a mesh, as a PartitionSpec: the mesh axes its
    leading dimension is split over (``()`` replicated)."""

    mesh: Mesh
    spec: tuple

    def local(self, a):
        """This rank's block of a whole array so laid out."""
        axes = self.spec[0] if self.spec else None
        if axes is None:
            return a
        return a[share(a.shape[0], self.mesh, (axes,) if isinstance(axes, str) else axes)]


def measurement_sharding(mesh: Mesh, batch_ndim_spec: tuple | None = None) -> Layout:
    """Layout of a (M, ...) measurement-series array: M over all axes."""
    return Layout(mesh, batch_ndim_spec or (tuple(mesh.axis_names),))


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, ())


def share(n: int, mesh: Mesh, axes: tuple[str, ...] | None = None) -> slice:
    """This rank's rows of n split over ``axes`` (default: the whole mesh),
    in the mesh's row-major order of those axes."""
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    parts, idx = 1, 0
    for a in axes:
        parts, idx = parts * mesh.shape[a], idx * mesh.shape[a] + mesh.index(a)
    rows = n // parts
    return slice(idx * rows, (idx + 1) * rows)


def shard_measurements(mesh: Mesh, *arrays):
    """This rank's rows of each (M, ...) array, M split over the whole mesh.

    M must divide by the mesh size (pad at the call site; forward models
    treat padded rows as extra work whose output is discarded).
    """
    n = data_axis_size(mesh)
    out = []
    for a in arrays:
        if a.shape[0] % n != 0:
            raise ValueError(
                f"leading (measurement) dim {a.shape[0]} not divisible by "
                f"mesh size {n}; pad the series"
            )
        out.append(measurement_sharding(mesh).local(a))
    return out[0] if len(out) == 1 else tuple(out)


def sharded_value_and_grad(
    loss_fn: Callable[..., torch.Tensor],
    mesh: Mesh,
    batch_argnums: tuple[int, ...],
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Data-parallel value_and_grad over the mesh.

    loss_fn(v, *args) must return a SUM-over-measurements scalar, so that
    the ranks' losses and gradients combine by a sum.  Every rank calls
    f(v, *args) with the whole arrays: the arguments listed in batch_argnums
    (0 = first of *args) are split on their leading axis
    (``shard_measurements``), each rank evaluating loss_fn on its rows;
    everything else, v included, is replicated.  Returns (loss, grad), both
    summed over the mesh: the loss and gradient of one process over the
    whole series.

    The sums are the ones the CLI's loss makes (loss.make_loss with the
    mesh): v enters marked replicated (``pvary``, whose backward sums the
    ranks' gradients) and the loss is summed once (``psum``, whose backward
    is the identity).  A further sum of the gradient would multiply it by
    the mesh size (the bug class fdes_tpu.sharding's docstring pins).
    """
    group = mesh.group(mesh.axis_names)

    def fn(v, *args):
        args = [shard_measurements(mesh, a) if i in batch_argnums else a
                for i, a in enumerate(args)]
        v = v.detach().requires_grad_(True)
        loss = psum(loss_fn(pvary(v, group), *args), group)
        (g,) = torch.autograd.grad(loss, v)
        return loss.detach(), g

    return fn
