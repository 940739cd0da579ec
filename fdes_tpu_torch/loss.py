"""Image-mismatch cost for inverse scattering (SURVEY.md C12, L6).

Counterpart of ``fdes_tpu.loss``.  The reference's cost is the least-squares
image mismatch L = sum_m ||I_sim,m - I_obs,m||^2; here it is one PyTorch
expression whose gradient with respect to V comes from autograd through the
multislice (the adjoint kernels on engine "pallas").  Optional Tikhonov/TV
regularisers act on the potential stack.
"""

from __future__ import annotations

import torch

from ._collectives import psum, shift


def l2_mismatch(i_sim: torch.Tensor, i_obs: torch.Tensor) -> torch.Tensor:
    """0.5 * sum((I_sim - I_obs)^2), summed over ALL axes -> scalar.

    The 0.5 makes dL/dI = (I_sim - I_obs), the reference's error-wave seed
    2*(I - I_obs) up to its factor 2, which only rescales the step size.
    """
    r = i_sim - i_obs
    return 0.5 * torch.sum(r * r)


def poisson_nll(
    i_sim: torch.Tensor, i_obs: torch.Tensor, dose: float = 1.0, eps: float = 1e-12
) -> torch.Tensor:
    """Poisson negative log-likelihood for dose-limited (counting) data.

    For counts n = Poisson(dose*I) the maximum-likelihood mismatch is
    L = sum(dose*I_sim - n*log(dose*I_sim)) (+ a constant in n), with i_obs
    in COUNTS and i_sim the noise-free model intensity.  eps keeps the log
    away from I = 0.
    """
    lam = dose * i_sim + eps
    return torch.sum(lam - i_obs * torch.log(lam))


def tikhonov(v_stack: torch.Tensor, weight: float) -> torch.Tensor:
    """weight * 0.5 * ||V||^2 — ridge regulariser on the potential."""
    return weight * 0.5 * torch.sum(v_stack * v_stack)


def total_variation(
    v_stack: torch.Tensor, weight: float, eps: float = 1e-6, group=None
) -> torch.Tensor:
    """Isotropic 3-D total variation (smoothed), periodic differences.

    eps keeps the sqrt smooth at zero so the gradient is finite everywhere.
    ``group``: the process group over which V's rows are split (v_stack is
    this rank's (S, ny/n, nx) row block, ranks in row order); the periodic y
    difference of the first row then takes the last row of the rank before
    (a cyclic shift), and the result is this rank's part of the sum.
    """
    dz = v_stack - torch.roll(v_stack, 1, dims=0)
    if group is None:
        dy = v_stack - torch.roll(v_stack, 1, dims=1)
    else:
        above = shift(v_stack[:, -1].contiguous(), group).unsqueeze(1)
        dy = v_stack - torch.cat([above, v_stack[:, :-1]], dim=1)
    dx = v_stack - torch.roll(v_stack, 1, dims=2)
    return weight * torch.sum(torch.sqrt(dz * dz + dy * dy + dx * dx + eps * eps))


def make_loss(
    forward,
    i_obs: torch.Tensor | None,
    l2_weight: float = 0.0,
    tv_weight: float = 0.0,
    kind: str = "l2",
    dose: float = 1.0,
    *,
    mesh=None,
    grid_axis: str | None = None,
    data_axes: tuple[str, ...] = (),
):
    """loss(V, *fwd_args) = mismatch(forward(V, *fwd_args), I_obs) + reg.

    ``forward`` is any of the forward.py series functions reduced to
    (v_stack, *args) -> images.  ``kind`` selects the data term: 'l2' (the
    reference's least squares) or 'poisson' (i_obs in counts, ``dose`` the
    counts per unit intensity).

    ``i_obs=None`` returns a loss with signature (v, i_obs, *fwd_args): the
    observed data travels as an argument (reconstruct's ``loss_args``), as
    in the JAX package.

    ``mesh`` (sharding.Mesh): a sharded loss, each rank calling it on its
    share.  ``forward`` returns this rank's share of the series, its rows
    split over ``grid_axis`` (then v_stack is this rank's row block of V) and
    its measurements over ``data_axes``; the data term is summed over both,
    the regularisers of V over ``grid_axis`` alone (V is the same on every
    rank of the data axes).  Every rank gets the global loss, and its
    backward gives each rank its own share's gradient (the sums' backward is
    the identity); summing V's gradient over the data axes is the forward's
    part (``_collectives.pvary``, as gridshard's series do with their
    ``data_axis``).
    """
    if kind not in ("l2", "poisson"):
        raise ValueError(f"unknown loss kind {kind!r}")
    grid = mesh.group(grid_axis) if mesh is not None and grid_axis else None
    everywhere = mesh.group(((grid_axis,) if grid_axis else ()) + tuple(data_axes)) if (
        mesh is not None) else None

    def data_term(v_stack, sim, obs):
        if kind == "poisson":
            data = poisson_nll(sim, obs, dose)
        else:
            data = l2_mismatch(sim, obs)
        regs = []
        if l2_weight:
            regs.append(tikhonov(v_stack, l2_weight))
        if tv_weight:
            regs.append(total_variation(v_stack, tv_weight, group=grid))
        if mesh is not None:
            data = psum(data, everywhere)
            regs = [psum(r, grid) for r in regs]
        for r in regs:
            data = data + r
        return data

    if i_obs is None:

        def loss_fn_arg(v_stack, i_obs, *fwd_args):
            return data_term(v_stack, forward(v_stack, *fwd_args), i_obs)

        return loss_fn_arg

    def loss_fn(v_stack, *fwd_args):
        return data_term(v_stack, forward(v_stack, *fwd_args), i_obs)

    return loss_fn
