"""Worlds of gloo ranks for the port's sharded CPU tests.

``World(nprocs, folder, suite)`` starts ``nprocs`` processes with
torch.multiprocessing (spawn), each joining one gloo process group through a
``file://`` rendezvous in ``folder``.  Every rank reads ``folder/inputs.npz``
(numpy arrays the test made from a seed), runs every check of the suite in
turn, and rank 0 saves the checks' results as ``folder/results.npz``:
``"<check>.<key>"`` arrays, or ``"<check>.error"`` with the traceback of a
check that raised.  The tests then compare each check with its reference on
their own, one parametrised case a check; they compute their references
while the world runs, and then ``join`` it.  A world that outlives its
``timeout`` is killed, and every check reads as failed.

This module imports no JAX: the ranks run the port alone.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

TIMEOUT_S = 150.0


class World:
    """A world of gloo ranks running one suite; ``join`` waits for it."""

    def __init__(self, nprocs: int, folder: str, suite: str, timeout: float = TIMEOUT_S):
        ctx = torch.multiprocessing.get_context("spawn")
        self.nprocs, self.folder, self.timeout = nprocs, folder, timeout
        self.procs = [ctx.Process(target=_rank_main, args=(r, nprocs, folder, suite),
                                  daemon=True) for r in range(nprocs)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def join(self) -> dict:
        """Rank 0's results, or {"error": why} when the world failed or
        timed out (its ranks then killed)."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        late = [p for p in self.procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
        logs = ""
        for r in range(self.nprocs):
            path = os.path.join(self.folder, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as fh:
                    logs += f"--- rank {r}\n" + fh.read()[-3000:]
        if late:
            return {"error": f"world of {self.nprocs} ranks timed out after {self.timeout} s"
                             f"\n{logs}"}
        if any(p.exitcode != 0 for p in self.procs):
            return {"error": f"ranks exited {[p.exitcode for p in self.procs]}\n{logs}"}
        with np.load(os.path.join(self.folder, "results.npz")) as z:
            return {k: z[k] for k in z.files}


def _rank_main(rank: int, nprocs: int, folder: str, suite: str) -> None:
    log = open(os.path.join(folder, f"rank{rank}.log"), "w", buffering=1)
    sys.stdout = sys.stderr = log
    torch.set_num_threads(1)
    from fdes_tpu_torch.sharding import init_distributed

    init_distributed(f"file://{os.path.join(folder, 'rendezvous')}", nprocs, rank,
                     device="cpu")
    with np.load(os.path.join(folder, "inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    results = {}
    for name, check in SUITES[suite]():
        try:
            out = check(inputs, folder)
        except Exception:  # noqa: BLE001 - the test that reads this check fails with it
            results[f"{name}.error"] = np.array(traceback.format_exc())
        else:
            results.update({f"{name}.{k}": np.asarray(v) for k, v in out.items()})
    if rank == 0:
        np.savez(os.path.join(folder, "results.npz"), **results)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    log.close()


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


# ---- sharding: measurement-axis sharding -----------------------------------


def _sharding_checks():
    from fdes_tpu_torch._collectives import all_gather, pvary
    from fdes_tpu_torch.forward import hrtem_tilt_series, stem_raster
    from fdes_tpu_torch.grids import Grid
    from fdes_tpu_torch.gridshard import gather_rows, multislice_gridsharded, shard_field_inputs
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.prism import plan_prism, prism_raster, prism_smatrix
    from fdes_tpu_torch.sharding import (
        data_axis_size,
        make_mesh,
        shard_measurements,
        sharded_value_and_grad,
    )

    n = _world()
    mesh = make_mesh()
    two = make_mesh(axis_names=("host", "chip"), shape=(2, n // 2))
    grid_mesh = make_mesh(axis_names=("grid",))
    group = mesh.group("data")

    def meshes(inp, folder):
        message = ""
        try:
            make_mesh(axis_names=("a", "b"))
        except ValueError as e:
            message = str(e)
        return {"size": data_axis_size(mesh), "devices": mesh.devices,
                "two_shape": two.devices.shape, "two_index": [two.index("host"), two.index("chip")],
                "no_shape": message}

    def tilt_loss(inp):
        sigma = float(inp["tilt_sigma"])
        ctf1 = _t(inp["tilt_ctf1"])

        def loss_fn(v, p0, pr, obs):
            r = hrtem_tilt_series(v, p0, pr, sigma, ctf1) - obs
            return 0.5 * torch.sum(r * r)

        return loss_fn

    def grad(inp, folder):
        f = sharded_value_and_grad(tilt_loss(inp), mesh, batch_argnums=(0, 1, 2))
        loss, g = f(torch.zeros_like(_t(inp["tilt_v"])), _t(inp["tilt_psi0s"]),
                    _t(inp["tilt_props"]), _t(inp["tilt_obs"]))
        return {"loss": loss.item(), "grad": _np(g)}

    def sharded_loss(inp, folder):
        sigma = float(inp["tilt_sigma"])
        ctf1 = _t(inp["tilt_ctf1"])

        def fwd(v, p0, pr):
            return hrtem_tilt_series(pvary(v, group), p0, pr, sigma, ctf1)

        loss_fn = make_loss(fwd, None, mesh=mesh, data_axes=("data",))
        p0, pr, obs = shard_measurements(mesh, _t(inp["tilt_psi0s"]), _t(inp["tilt_props"]),
                                         _t(inp["tilt_obs"]))
        v = torch.zeros_like(_t(inp["tilt_v"])).requires_grad_(True)
        loss = loss_fn(v, obs, p0, pr)
        loss.backward()
        return {"loss": loss.item(), "grad": _np(v.grad)}

    def indivisible(inp, folder):
        try:
            shard_measurements(mesh, _t(inp["tilt_psi0s"])[:5])
        except ValueError as e:
            return {"message": str(e)}
        return {"message": ""}

    def stem(inp, folder):
        sig = stem_raster(_t(inp["stem_v"]), _t(inp["stem_stencil"]), _t(inp["stem_qy"]),
                          _t(inp["stem_qx"]), shard_measurements(mesh, _t(inp["stem_pos"])),
                          _t(inp["stem_prop"]), float(inp["stem_sigma"]), _t(inp["stem_masks"]))
        return {"signals": _np(all_gather(sig, group, dim=-1))}

    def prism(inp, folder):
        (ny, nx), (py, px) = inp["stem_shape"].tolist(), inp["stem_pixel"].tolist()
        grid = Grid(ny, nx, py, px)
        plan = plan_prism(grid, inp["stem_stencil"], interp=1)
        smat = prism_smatrix(plan, _t(inp["stem_v"]), _t(inp["stem_prop"]),
                             float(inp["stem_sigma"]), dtype=torch.complex128)
        sig = prism_raster(smat, plan, shard_measurements(mesh, _t(inp["stem_pos"])),
                           _t(inp["stem_masks"]))
        return {"signals": _np(all_gather(sig, group, dim=-1))}

    def train(inp, folder):
        """test_multiprocess.py's train step: each rank fits its tilts, V
        whole on every rank; one adam step; then a grid-sharded rollout."""
        sigma = float(inp["train_sigma"])
        ctf = _t(inp["train_ctf"])

        def fwd(v, p0, pr):
            return hrtem_tilt_series(pvary(v, group), p0, pr, sigma, ctf, remat_chunk=2)

        loss_fn = make_loss(fwd, None, mesh=mesh, data_axes=("data",))
        props, obs = shard_measurements(mesh, _t(inp["train_props"]), _t(inp["train_obs"]))
        psi0s = torch.ones_like(props)
        v = _t(inp["train_v0"]).clone().requires_grad_(True)
        opt = torch.optim.Adam([v], lr=1.0, eps=1e-8)  # optax.adam(1.0)
        loss = loss_fn(v, obs, psi0s, props)
        loss.backward()
        opt.step()
        with torch.no_grad():
            loss2 = loss_fn(v, obs, psi0s, props)
        prop0 = _t(inp["train_props"][0])
        p0, vs, pr = shard_field_inputs(grid_mesh, torch.ones_like(prop0), _t(inp["train_vtrue"]),
                                        prop0)
        with torch.no_grad():
            exit_wave = gather_rows(multislice_gridsharded(p0, vs, pr, sigma, grid_mesh),
                                    grid_mesh)
        return {"losses": [loss.item(), loss2.item()], "v1": _np(v),
                "exit_wave": _np(exit_wave)}

    return [("meshes", meshes), ("grad", grad), ("sharded_loss", sharded_loss),
            ("indivisible", indivisible), ("stem", stem), ("prism", prism), ("train", train)]


# ---- gridshard: the field's rows over 'grid' -------------------------------


def _gridshard_checks():
    from fdes_tpu_torch._collectives import all_gather, psum
    from fdes_tpu_torch.gridshard import (
        col_block,
        exit_intensity_gridsharded,
        fft2_distributed,
        gather_rows,
        hrtem_defocus_series_gridsharded,
        hrtem_tilt_series_gridsharded,
        ifft2_distributed,
        multislice_gridsharded,
        multislice_gridsharded_streamed,
        row_block,
        shard_field_inputs,
    )
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.reconstruct import make_optimizer, reconstruct
    from fdes_tpu_torch.sharding import make_mesh

    n = _world()
    mesh = make_mesh(axis_names=("grid",))
    # ('data', 'grid'): 2 x 1 in a world of 2 (the data axis alone), 2 x 2 in 4
    dg = make_mesh(axis_names=("data", "grid"), shape=(2, n // 2))

    def field(inp, m=mesh):
        return shard_field_inputs(m, _t(inp["psi0"]), _t(inp["v"]), _t(inp["prop"]))

    def fft2(inp, folder):
        spec = fft2_distributed(row_block(_t(inp["fft_x"]), mesh), mesh)
        back = ifft2_distributed(spec, mesh)
        return {"spec": _np(all_gather(spec, mesh.group("grid"), dim=-1)),
                "back": _np(gather_rows(back, mesh))}

    def indivisible(inp, folder):
        out = {}
        for key, shape in (("rows", (66, 64)), ("cols", (64, 63))):
            z = torch.zeros(shape, dtype=torch.complex128)
            try:
                shard_field_inputs(mesh, z, z.real[None], z)
                out[key] = ""
            except ValueError as e:
                out[key] = str(e)
        return out

    def multislice(inp, folder):
        sigma = float(inp["sigma"])
        psi = multislice_gridsharded(*field(inp), sigma, mesh)
        remat = multislice_gridsharded(*field(inp), sigma, mesh, remat_chunk=2)
        return {"exit": _np(gather_rows(psi, mesh)), "remat": _np(gather_rows(remat, mesh))}

    def streamed(inp, folder):
        atoms = tuple(_t(inp[k]) for k in ("x", "y", "sp", "w"))
        psi = multislice_gridsharded_streamed(
            row_block(_t(inp["psi0"]), mesh), atoms, col_block(_t(inp["ff_full"]), mesh),
            col_block(_t(inp["prop"]), mesh), float(inp["sigma"]), mesh,
            shape=tuple(inp["psi0"].shape), pixel=tuple(inp["pixel"]))
        return {"exit": _np(gather_rows(psi, mesh))}

    def gradient(inp, folder, key="v"):
        psi0, v, prop = shard_field_inputs(mesh, _t(inp["psi0"]), _t(inp[key]), _t(inp["prop"]))
        v.requires_grad_(True)
        i = exit_intensity_gridsharded(psi0, v, prop, float(inp["sigma"]), mesh, remat_chunk=2)
        loss = psum(torch.sum(i * row_block(_t(inp["tgt"]), mesh)), mesh.group("grid"))
        loss.backward()
        return {"loss": loss.item(), "grad": _np(gather_rows(v.grad, mesh))}

    def defocus(inp, folder):
        psi0, v, prop = field(inp)
        imgs = hrtem_defocus_series_gridsharded(v, psi0, prop, float(inp["sigma"]),
                                                col_block(_t(inp["ctfs"]), mesh), mesh)
        return {"images": _np(gather_rows(imgs, mesh))}

    def tilt(inp, folder):
        imgs = hrtem_tilt_series_gridsharded(
            row_block(_t(inp["v"]), mesh), row_block(_t(inp["psi0_stack"]), mesh),
            col_block(_t(inp["prop_stack"]), mesh), float(inp["sigma"]),
            col_block(_t(inp["ctf_tilt"]), mesh), mesh)
        return {"images": _np(gather_rows(imgs, mesh))}

    def quadrature(inp, folder):
        psi0, v, prop = field(inp)
        imgs = hrtem_defocus_series_gridsharded(
            v, psi0, prop, float(inp["sigma"]), col_block(_t(inp["quads"]), mesh), mesh,
            weights=_t(inp["weights"]))
        return {"images": _np(gather_rows(imgs, mesh))}

    def inverse_loss(inp, tv=0.0, l2=0.0, m=mesh, data_axis=None):
        sigma = float(inp["sigma"])

        def fwd(v_, psi0_, prop_, ctfs_):
            return hrtem_defocus_series_gridsharded(v_, psi0_, prop_, sigma, ctfs_, m,
                                                    data_axis=data_axis, remat_chunk=2)

        return make_loss(fwd, None, tv_weight=tv, l2_weight=l2, mesh=m,
                         grid_axis="grid", data_axes=(data_axis,) if data_axis else ())

    def inverse(inp, folder, tv=0.0):
        psi0, v, prop = field(inp)
        v.requires_grad_(True)
        loss = inverse_loss(inp, tv, 0.01 if tv else 0.0)(v, row_block(_t(inp["i_obs2"]), mesh), psi0, prop,
                                      col_block(_t(inp["ctfs2"]), mesh))
        loss.backward()
        return {"loss": loss.item(), "grad": _np(gather_rows(v.grad, mesh))}

    def lbfgs(inp, folder):
        psi0, v, prop = field(inp)
        res = reconstruct(inverse_loss(inp, l2=0.01), torch.zeros_like(v),
                          loss_args=(row_block(_t(inp["i_obs2"]), mesh), psi0, prop,
                                     col_block(_t(inp["ctfs2"]), mesh)),
                          iterations=2, optimizer=make_optimizer("lbfgs"), mesh=mesh)
        return {"v": res.v, "losses": res.losses}

    def composition(inp, folder):
        sigma = float(inp["sigma"])
        psi0, v, prop = field(inp, dg)
        d = dg.index("data")
        ctfs = col_block(_t(inp["ctfs"])[2 * d:2 * d + 2], dg)
        obs = row_block(_t(inp["i_obs4"])[2 * d:2 * d + 2], dg)
        imgs = hrtem_defocus_series_gridsharded(v, psi0, prop, sigma, ctfs, dg, data_axis="data",
                                                remat_chunk=2)
        whole = all_gather(gather_rows(imgs, dg), dg.group("data"), dim=0)
        v.requires_grad_(True)
        loss = inverse_loss(inp, m=dg, data_axis="data")(v, obs, psi0, prop, ctfs)
        loss.backward()
        return {"images": _np(whole), "loss": loss.item(),
                "grad": _np(gather_rows(v.grad, dg))}

    return [("fft2", fft2), ("indivisible", indivisible), ("multislice", multislice),
            ("streamed", streamed), ("gradient", gradient),
            ("absorptive_gradient", lambda inp, f: gradient(inp, f, "v_abs")),
            ("defocus", defocus), ("tilt", tilt), ("quadrature", quadrature),
            ("inverse", inverse), ("inverse_tv", lambda inp, f: inverse(inp, f, tv=0.3)),
            ("lbfgs", lbfgs), ("composition", composition)]


# ---- cli: python -m fdes_tpu_torch.cli under a mesh ------------------------


def _cli_checks():
    from fdes_tpu_torch import cli

    def run(folder, tag, *extra):
        argv = [os.path.join(folder, "c.toml"), "--device", "cpu", "--set",
                f"output_dir={os.path.join(folder, tag)}", "--set", "mesh.distributed=true",
                *extra]
        rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli exited {rc}")
        return {"rc": rc}

    grid = ("--set", 'mesh.axis_names=["grid"]', "--set", f"mesh.shape=[{_world()}]")
    data = ("--set", 'mesh.axis_names=["data"]', "--set", f"mesh.shape=[{_world()}]")
    invert = ("--mode", "invert", "--set", "recon.checkpoint_every=1")

    lbfgs = ("--set", "recon.optimizer=lbfgs")

    def resume(folder, tag, *extra):
        run(folder, tag, *grid, *invert, *extra, "--set", "recon.iterations=2")
        return run(folder, tag, *grid, *invert, *extra, "--set", "recon.iterations=3",
                   "--resume")

    return [("hrtem", lambda inp, f: run(f, "hrtem", *data)),
            ("forward", lambda inp, f: run(f, "forward", "--mode", "forward", *grid)),
            ("invert", lambda inp, f: run(f, "invert", *grid, *invert,
                                           "--set", "recon.iterations=3")),
            ("resume", lambda inp, f: resume(f, "invert_resume")),
            ("invert_lbfgs", lambda inp, f: run(f, "invert_lbfgs", *grid, *invert, *lbfgs,
                                                 "--set", "recon.iterations=3")),
            ("resume_lbfgs", lambda inp, f: resume(f, "invert_lbfgs_resume", *lbfgs))]


SUITES = {"sharding": _sharding_checks, "gridshard": _gridshard_checks, "cli": _cli_checks}
