"""The port's grid (tensor-parallel) sharding against fdes_tpu.gridshard.

tests/test_gridshard.py one for one, in worlds of gloo ranks on the CPU: a
world of 2 ranks (a 'grid' axis of 2, and ('data', 'grid') = 2 x 1) and one
of 4 (a 'grid' axis of 4, and 2 x 2), each started once for all its checks
(tests/torch_mesh_worker.py).  The inputs are Si[110] at 64^2 x 8 slices in
complex128, made here with the JAX package; the JAX references run on the
8-device CPU mesh of conftest.py.  Tolerance: 1e-10 relative (norm) in
complex128, values and gradients.  A complex (absorptive) V's gradient is
the conjugate of JAX's (PyTorch's convention; ROADMAP.md, Rules that tests
pin), through the collectives too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

torch = pytest.importorskip("torch")

import fdes_tpu as f  # noqa: E402
from fdes_tpu.forward import hrtem_defocus_series  # noqa: E402
from fdes_tpu.gridshard import (  # noqa: E402
    exit_intensity_gridsharded,
    hrtem_defocus_series_gridsharded,
    hrtem_tilt_series_gridsharded,
    multislice_gridsharded,
    multislice_gridsharded_streamed,
    shard_field_inputs,
)
from fdes_tpu.loss import make_loss  # noqa: E402
from fdes_tpu.optics import Aberrations, ctf_quadrature_series, ctf_series  # noqa: E402
from fdes_tpu.potential import (  # noqa: E402
    build_potential,
    pad_atoms_per_slice,
    species_factors_full,
)
from fdes_tpu.sharding import make_mesh  # noqa: E402

import torch_mesh_worker  # noqa: E402

TOL = 1e-10
WORLDS = (2, 4)
KV = 300e3


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def problem(si110_small, tmp_path_factory):
    """(inputs, the references of every check, each world's results): both
    worlds run while the references are computed."""
    inp = _inputs(si110_small)
    worlds = {}
    for n in WORLDS:
        folder = tmp_path_factory.mktemp(f"gridshard_world{n}")
        np.savez(folder / "inputs.npz", **inp)
        worlds[n] = torch_mesh_worker.World(n, str(folder), "gridshard")
    try:
        want = _references(inp, si110_small)
    finally:
        results = {n: w.join() for n, w in worlds.items()}
    return inp, want, results


def _inputs(si110_small):
    """The checks' inputs (numpy), Si[110] at 64^2 x 8 slices."""
    spec, grid, sliced = si110_small
    lam, sigma = f.wavelength_A(KV), f.interaction_sigma(KV)
    rng = np.random.default_rng(5)
    v = np.asarray(build_potential(sliced, grid, dtype=jnp.float64))
    prop = np.asarray(f.fresnel_propagator(grid, lam, sliced.dz))
    psi0 = np.asarray(f.plane_wave(grid, lam, dtype=jnp.complex128))
    ctfs = np.asarray(ctf_series(grid, lam, np.asarray([-200.0, -100.0, 100.0, 200.0])))
    tilts = [(0.0, 0.0), (5e-3, 0.0), (0.0, -5e-3), (3e-3, 3e-3)]
    prop_stack = np.stack([f.fresnel_propagator(grid, lam, sliced.dz, tilt_xy_rad=t)
                           for t in tilts])
    quads, weights = ctf_quadrature_series(
        grid, lam, np.asarray([-150.0, 150.0]), base=Aberrations(), defocus_spread_A=30.0,
        source_semiangle_rad=2e-4, n_defocus=3, n_tilt=3)
    x, y, sp, w, _ = pad_atoms_per_slice(sliced, dtype=np.float64)
    inp = {
        "fft_x": rng.normal(size=(64, 48)) + 1j * rng.normal(size=(64, 48)),
        "psi0": psi0, "v": v, "prop": prop, "sigma": np.float64(sigma),
        "tgt": rng.normal(size=psi0.shape), "v_abs": v + 0.1j * np.abs(v),
        "ctfs": ctfs, "ctfs2": ctfs[[0, 2]],
        "psi0_stack": np.stack([psi0] * len(tilts)), "prop_stack": prop_stack,
        "ctf_tilt": np.asarray(ctf_series(grid, lam, np.asarray([-150.0])))[0],
        "quads": np.asarray(quads), "weights": np.asarray(weights),
        "x": x, "y": y, "sp": sp, "w": w,
        "ff_full": species_factors_full(grid, sliced.species),
        "pixel": np.asarray([grid.py, grid.px]),
    }
    inp["i_obs2"] = np.asarray(hrtem_defocus_series(v, psi0, prop, sigma, inp["ctfs2"])) * 1.05
    inp["i_obs4"] = np.asarray(hrtem_defocus_series(v, psi0, prop, sigma, ctfs)) * 0.97
    return inp


def _references(inp, si110_small):
    """The JAX references of every check on the 8-device mesh (and, for
    LBFGS, the port's own single process)."""
    _, grid, sliced = si110_small
    sigma = float(inp["sigma"])
    psi0, v, prop, ctfs = inp["psi0"], inp["v"], inp["prop"], inp["ctfs"]
    x, y, sp, w = (inp[k] for k in ("x", "y", "sp", "w"))
    prop_stack, weights = inp["prop_stack"], inp["weights"]
    mesh = make_mesh(axis_names=("grid",))
    put = lambda a, *s, m=mesh: jax.device_put(jnp.asarray(a), NamedSharding(m, P(*s)))  # noqa: E731
    psi0s, vs, props = shard_field_inputs(mesh, psi0, v, prop)
    want = {"fft2.spec": np.fft.fft2(inp["fft_x"]), "fft2.back": inp["fft_x"]}
    want["multislice.exit"] = np.asarray(multislice_gridsharded(psi0s, vs, props, sigma, mesh))
    want["multislice.remat"] = want["multislice.exit"]
    want["streamed.exit"] = np.asarray(jax.jit(
        lambda p0, at, ff, pr: multislice_gridsharded_streamed(
            p0, at, ff, pr, sigma, mesh, shape=grid.shape, pixel=(grid.py, grid.px))
    )(put(psi0, "grid", None), tuple(jnp.asarray(a) for a in (x, y, sp, w)),
      put(inp["ff_full"], None, None, "grid"), put(prop, None, "grid")))

    for key, vv in (("gradient", v), ("absorptive_gradient", inp["v_abs"])):
        def loss_sharded(v_):
            i = exit_intensity_gridsharded(psi0s, v_, props, sigma, mesh, remat_chunk=2)
            return jnp.sum(i * put(inp["tgt"], "grid", None))

        lv, g = jax.jit(jax.value_and_grad(loss_sharded))(put(vv, None, "grid", None))
        want[f"{key}.loss"], want[f"{key}.grad"] = float(lv), np.asarray(g)
    # PyTorch's gradient of a complex V: the conjugate of JAX's
    want["absorptive_gradient.grad"] = np.conj(want["absorptive_gradient.grad"])

    want["defocus.images"] = np.asarray(hrtem_defocus_series_gridsharded(
        vs, psi0s, props, sigma, put(ctfs, None, None, "grid"), mesh))
    want["tilt.images"] = np.asarray(hrtem_tilt_series_gridsharded(
        vs, put(inp["psi0_stack"], None, "grid", None), put(prop_stack, None, None, "grid"),
        sigma, put(inp["ctf_tilt"], None, "grid"), mesh))
    want["quadrature.images"] = np.asarray(hrtem_defocus_series_gridsharded(
        vs, psi0s, props, sigma, put(inp["quads"], None, None, None, "grid"), mesh,
        weights=jnp.asarray(weights)))

    for key, tv in (("inverse", 0.0), ("inverse_tv", 0.3)):
        def fwd(v_, psi0_, prop_, ctfs_):
            return hrtem_defocus_series_gridsharded(v_, psi0_, prop_, sigma, ctfs_, mesh,
                                                    remat_chunk=2)

        lv, g = jax.jit(jax.value_and_grad(
            make_loss(fwd, None, tv_weight=tv, l2_weight=0.01 if tv else 0.0)))(
            vs, put(inp["i_obs2"], None, "grid", None), psi0s, props,
            put(inp["ctfs2"], None, None, "grid"))
        want[f"{key}.loss"], want[f"{key}.grad"] = float(lv), np.asarray(g)

    dg = make_mesh(axis_names=("data", "grid"), shape=(2, 4))

    def fwd_dg(v_, psi0_, prop_, ctfs_):
        return hrtem_defocus_series_gridsharded(v_, psi0_, prop_, sigma, ctfs_, dg,
                                                data_axis="data", remat_chunk=2)

    args = (put(psi0, "grid", None, m=dg), put(prop, None, "grid", m=dg),
            put(ctfs, "data", None, "grid", m=dg))
    vdg = put(v, None, "grid", None, m=dg)
    want["composition.images"] = np.asarray(fwd_dg(vdg, *args))
    lv, g = jax.jit(jax.value_and_grad(make_loss(fwd_dg, None)))(
        vdg, put(inp["i_obs4"], "data", "grid", None, m=dg), *args)
    want["composition.loss"], want["composition.grad"] = float(lv), np.asarray(g)

    # LBFGS: the port's own single-process run of the same loss, for two
    # iterations, each of whose steps lowers it.  Where a step leaves the loss
    # where it was (a TV term near V = 0, or a third step here) the line
    # search's cubic fit of equal losses turns their round-off of 1e-16 into
    # 1e-7 or more in V, in one process as in several
    from fdes_tpu_torch.forward import hrtem_defocus_series as t_defocus
    from fdes_tpu_torch.loss import make_loss as t_make_loss
    from fdes_tpu_torch.reconstruct import make_optimizer, reconstruct

    t = {k: torch.as_tensor(np.array(inp[k])) for k in ("v", "psi0", "prop", "ctfs2", "i_obs2")}
    res = reconstruct(
        t_make_loss(lambda v_, p0, pr, c: t_defocus(v_, p0, pr, sigma, c, remat_chunk=2), None,
                    l2_weight=0.01),
        torch.zeros_like(t["v"]), loss_args=(t["i_obs2"], t["psi0"], t["prop"], t["ctfs2"]),
        iterations=2, optimizer=make_optimizer("lbfgs"))
    want["lbfgs.v"], want["lbfgs.losses"] = res.v, res.losses
    return want


def _got(problem, n, check):
    res = problem[2][n]
    assert "error" not in res, res.get("error")
    assert f"{check}.error" not in res, str(res[f"{check}.error"])
    return {k.split(".", 1)[1]: v for k, v in res.items() if k.startswith(check + ".")}


def _held(problem, n, check, keys):
    got = _got(problem, n, check)
    want = problem[1]
    for key in keys:
        assert got[key].shape == np.shape(want[f"{check}.{key}"]), key
        assert _rel(got[key], want[f"{check}.{key}"]) <= TOL, (key, _rel(
            got[key], want[f"{check}.{key}"]))


@pytest.mark.parametrize("n", WORLDS)
def test_distributed_fft2_matches_fft2(problem, n):
    """fft2_distributed's columns gathered: numpy's fft2 of the 64 x 48
    field; ifft2_distributed brings the rows back."""
    _held(problem, n, "fft2", ("spec", "back"))


@pytest.mark.parametrize("n", WORLDS)
def test_grid_shape_must_divide_mesh(problem, n):
    got = _got(problem, n, "indivisible")
    assert str(got["rows"]) == (
        f"grid 66x64 not divisible by mesh axis 'grid' size {n}" if n == 4 else "")
    assert str(got["cols"]) == f"grid 64x63 not divisible by mesh axis 'grid' size {n}"


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_multislice_equals_single_device(problem, n):
    _held(problem, n, "multislice", ("exit",))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_streamed_equals_streamed(problem, n):
    """The slice-by-slice build on row blocks (the halo row by the cyclic
    shift) against fdes_tpu's streamed 'grid' rollout."""
    _held(problem, n, "streamed", ("exit",))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_remat_equals_no_remat(problem, n):
    got = _got(problem, n, "multislice")
    assert _rel(got["remat"], got["exit"]) <= 1e-13


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_gradient_equals_single_device(problem, n):
    """dL/dV through the all-to-alls and the checkpointed chunks: the
    gathered rows equal JAX's gradient."""
    _held(problem, n, "gradient", ("loss", "grad"))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_absorptive_gradient_is_conj_of_jax(problem, n):
    """A complex (absorptive) V under 'grid': the gradient is the conjugate
    of jax.grad's, the convention of the port's unsharded engines."""
    _held(problem, n, "absorptive_gradient", ("loss", "grad"))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_defocus_series_equals_forward(problem, n):
    _held(problem, n, "defocus", ("images",))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_tilt_series_equals_forward(problem, n):
    _held(problem, n, "tilt", ("images",))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_inverse_step_equals_single_device(problem, n):
    """make_loss over the mesh: the global loss on every rank, and the rows
    of dL/dV, equal JAX's value_and_grad."""
    _held(problem, n, "inverse", ("loss", "grad"))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_inverse_step_with_tv(problem, n):
    """tv_weight > 0 (the periodic y difference across ranks by the cyclic
    shift) and a Tikhonov term, each summed over the rows."""
    _held(problem, n, "inverse_tv", ("loss", "grad"))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_lbfgs_global_dots(problem, n):
    """Two LBFGS iterations on row blocks (dot products, norms and the line
    search's scalars summed over 'grid'; the second from a curvature pair)
    equal the port's single process."""
    _held(problem, n, "lbfgs", ("v", "losses"))


@pytest.mark.parametrize("n", WORLDS)
def test_data_grid_mesh_composition(problem, n):
    """('data', 'grid') = 2 x n/2: the defoci over 'data', the rows over
    'grid'; the images, the loss and dL/dV (summed over 'data') equal JAX's
    on its (2, 4) mesh."""
    _held(problem, n, "composition", ("images", "loss", "grad"))


@pytest.mark.parametrize("n", WORLDS)
def test_gridsharded_defocus_quadrature_weights(problem, n):
    _held(problem, n, "quadrature", ("images",))
