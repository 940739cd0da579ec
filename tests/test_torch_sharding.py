"""The port's measurement-axis sharding against fdes_tpu.sharding.

tests/test_sharding.py and tests/test_multiprocess.py's train step one for
one, in worlds of gloo ranks on the CPU: a world of 2 ranks and one of 4,
each started once for all its checks (tests/torch_mesh_worker.py).  The
inputs are made here from seeds with numpy and the JAX package; the JAX
references run on the 8-device CPU mesh of conftest.py (single-device
values, which fdes_tpu's own tests hold equal to its sharded ones).
Tolerance: 1e-10 relative (norm) in complex128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import fdes_tpu as f  # noqa: E402
from fdes_tpu.detector import annular_mask  # noqa: E402
from fdes_tpu.forward import hrtem_tilt_series, stem_raster  # noqa: E402
from fdes_tpu.grids import Grid  # noqa: E402
from fdes_tpu.loss import l2_mismatch  # noqa: E402
from fdes_tpu.prism import plan_prism, prism_raster, prism_smatrix  # noqa: E402
from fdes_tpu.probe import probe_stencil  # noqa: E402

import torch_mesh_worker  # noqa: E402

TOL = 1e-10
WORLDS = (2, 4)
KV = 300e3


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """(references shared by both worlds, {n: (world n's results, its train
    step's references)}): both worlds run while the references are
    computed."""
    inp, refs = _problem()
    worlds, train = {}, {}
    for n in WORLDS:
        folder = tmp_path_factory.mktemp(f"sharding_world{n}")
        train_inp, train[n] = _train_problem(n)
        np.savez(folder / "inputs.npz", **inp, **train_inp)
        worlds[n] = torch_mesh_worker.World(n, str(folder), "sharding")
    try:
        want = refs()
        train = {n: t() for n, t in train.items()}
    finally:
        results = {n: w.join() for n, w in worlds.items()}
    return want, {n: (results[n], train[n]) for n in WORLDS}


def _problem():
    """test_sharding.py's inputs (numpy) and a function of their JAX
    references."""
    lam, sigma = f.wavelength_A(KV), f.interaction_sigma(KV)
    # test_sharding.py's 8-tilt series
    rng = np.random.default_rng(7)
    grid = Grid(ny=32, nx=32, py=0.4, px=0.4)
    v = rng.normal(size=(4, 32, 32)) * 20.0
    tilts = [(1e-3 * i, -5e-4 * i) for i in range(8)]
    psi0s = np.stack([np.asarray(f.plane_wave(grid, lam, dtype=jnp.complex128))] * 8)
    props = np.stack([f.fresnel_propagator(grid, lam, 1.8, tilt_xy_rad=t) for t in tilts])
    ctf1 = np.ones(grid.shape, np.complex128)
    i_obs = np.asarray(hrtem_tilt_series(v, psi0s, props, sigma, ctf1))

    def loss_fn(vv, p0, pr, obs):
        r = hrtem_tilt_series(vv, p0, pr, sigma, ctf1) - obs
        return 0.5 * jnp.sum(r * r)

    inp = {"tilt_v": v, "tilt_psi0s": psi0s, "tilt_props": props, "tilt_ctf1": ctf1,
           "tilt_obs": i_obs, "tilt_sigma": np.float64(sigma)}

    # test_sharding.py's STEM and PRISM rasters
    rng = np.random.default_rng(13)
    v_s = rng.normal(size=(3, 32, 32)) * 15.0
    prop = np.asarray(f.fresnel_propagator(grid, lam, 1.8))
    stencil = np.asarray(probe_stencil(grid, lam, 25e-3))
    pos = rng.random((16, 2)) * np.array(grid.extent)
    masks = np.stack([annular_mask(grid, lam, 0.0, 25e-3), annular_mask(grid, lam, 40e-3, 150e-3)])
    inp.update(stem_v=v_s, stem_prop=prop, stem_stencil=stencil, stem_qy=grid.qy()[:, None],
               stem_qx=grid.qx()[None, :], stem_pos=pos, stem_masks=masks,
               stem_sigma=np.float64(sigma), stem_shape=np.asarray(grid.shape),
               stem_pixel=np.asarray([grid.py, grid.px]))

    def refs():
        lv, g = jax.value_and_grad(loss_fn)(jnp.zeros_like(v), psi0s, props, i_obs)
        want = {"loss": float(lv), "grad": np.asarray(g)}
        want["stem"] = np.asarray(stem_raster(v_s, jnp.asarray(stencil), inp["stem_qy"],
                                              inp["stem_qx"], pos, prop, sigma, masks))
        plan = plan_prism(grid, stencil, interp=1)
        want["prism"] = np.asarray(prism_raster(
            prism_smatrix(plan, v_s, prop, sigma, dtype=jnp.complex128), plan, pos, masks))
        return want

    return inp, refs


def _train_problem(n):
    """test_multiprocess.py's train step at 2 n tilts: inputs, and a
    function of the references: the numpy f64 loss of the first step,
    optax.adam's V after it (one device) and the numpy exit wave of the
    grid-sharded rollout."""
    kv = 300e3
    grid = Grid(ny=32, nx=32, py=0.25, px=0.25)
    lam, sigma = f.wavelength_A(kv), f.interaction_sigma(kv)
    rng = np.random.default_rng(0)
    v_true = rng.normal(size=(4, 32, 32)) * 50.0
    v0 = 0.3 * v_true
    angs = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    props = np.stack([f.fresnel_propagator(grid, lam, 8.0, tilt_xy_rad=(0.02 * np.cos(a),
                                                                        0.02 * np.sin(a)))
                      for a in angs])
    ctf = f.ctf_series(grid, lam, np.array([100.0]))[0]

    def ref_exit(v, prop):
        psi = np.ones((32, 32), np.complex128)
        for j in range(4):
            psi = np.fft.ifft2(np.fft.fft2(psi * np.exp(1j * sigma * v[j])) * prop)
        return psi

    def ref_forward(v, prop):
        return np.abs(np.fft.ifft2(np.fft.fft2(ref_exit(v, prop)) * ctf)) ** 2

    i_obs = np.stack([ref_forward(v_true, p) for p in props])

    def loss_fn(v):
        sim = hrtem_tilt_series(v, jnp.ones(props.shape, jnp.complex128), props, sigma, ctf,
                                remat_chunk=2)
        return l2_mismatch(sim, i_obs)

    def refs():
        opt = optax.adam(1.0)
        g = jax.grad(loss_fn)(jnp.asarray(v0))
        updates, _ = opt.update(g, opt.init(jnp.asarray(v0)), jnp.asarray(v0))
        return {"loss": 0.5 * sum(float(np.sum((ref_forward(v0, p) - o) ** 2))
                                  for p, o in zip(props, i_obs)),
                "v1": np.asarray(optax.apply_updates(jnp.asarray(v0), updates)),
                "exit_wave": ref_exit(v_true, props[0])}

    inp = {"train_v0": v0, "train_vtrue": v_true, "train_props": props, "train_obs": i_obs,
           "train_ctf": ctf, "train_sigma": np.float64(sigma)}
    return inp, refs


def _got(problem, n, check):
    res = problem[1][n][0]
    assert "error" not in res, res.get("error")
    assert f"{check}.error" not in res, str(res[f"{check}.error"])
    return {k.split(".", 1)[1]: v for k, v in res.items() if k.startswith(check + ".")}


def test_single_process_mesh():
    """Without a process group the mesh is one rank with no groups: shares
    are whole and the collectives are identities."""
    from fdes_tpu_torch import sharding

    sharding.init_distributed(device="cpu")  # no torchrun environment: a no-op
    mesh = sharding.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.group("data") is None
    x = torch.arange(6.0)
    assert torch.equal(sharding.shard_measurements(mesh, x), x)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        sharding.make_mesh(axis_names=("data",), shape=(2,))


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_spans_the_world(problem, n):
    got = _got(problem, n, "meshes")
    assert int(got["size"]) == n and got["devices"].tolist() == list(range(n))


@pytest.mark.parametrize("n", WORLDS)
def test_two_axis_mesh(problem, n):
    got = _got(problem, n, "meshes")
    assert tuple(got["two_shape"]) == (2, n // 2)
    assert got["two_index"].tolist() == [0, 0]  # rank 0's place
    assert str(got["no_shape"]) == "shape required when len(axis_names) > 1"


@pytest.mark.parametrize("n", WORLDS)
def test_shard_map_grad_equals_single_device(problem, n):
    """sharded_value_and_grad: the loss and gradient of one device, not the
    gradient times the mesh size."""
    got = _got(problem, n, "grad")
    want = problem[0]
    assert abs(float(got["loss"]) - want["loss"]) <= TOL * abs(want["loss"])
    assert _rel(got["grad"], want["grad"]) <= TOL


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_loss_equals_replicated(problem, n):
    """The CLI's form: make_loss over the mesh, V marked replicated (pvary)
    so that its gradient sums over the ranks in the backward pass."""
    got = _got(problem, n, "sharded_loss")
    want = problem[0]
    assert abs(float(got["loss"]) - want["loss"]) <= TOL * abs(want["loss"])
    assert _rel(got["grad"], want["grad"]) <= TOL


@pytest.mark.parametrize("n", WORLDS)
def test_shard_measurements_rejects_indivisible(problem, n):
    got = _got(problem, n, "indivisible")
    assert str(got["message"]) == (
        f"leading (measurement) dim 5 not divisible by mesh size {n}; pad the series")


@pytest.mark.parametrize("n", WORLDS)
def test_stem_probe_axis_sharded_equals_replicated(problem, n):
    """Probe positions over the mesh, V whole: the gathered signals equal
    fdes_tpu's raster."""
    assert _rel(_got(problem, n, "stem")["signals"], problem[0]["stem"]) <= TOL


@pytest.mark.parametrize("n", WORLDS)
def test_prism_raster_probe_axis_sharded_equals_replicated(problem, n):
    """The S-matrix on every rank, the probe positions over the mesh."""
    assert _rel(_got(problem, n, "prism")["signals"], problem[0]["prism"]) <= TOL


@pytest.mark.parametrize("n", WORLDS)
def test_two_process_train_step(problem, n):
    """test_multiprocess.py: each rank fits its half (quarter) of the tilts;
    the summed loss equals the numpy f64 one, adam's step equals optax's on
    one device and lowers the loss; the grid-sharded rollout across the ranks
    equals numpy's exit wave."""
    got = _got(problem, n, "train")
    want = problem[1][n][1]
    loss1, loss2 = got["losses"].tolist()
    assert abs(loss1 - want["loss"]) <= TOL * want["loss"]
    assert loss2 < loss1
    assert _rel(got["v1"], want["v1"]) <= TOL
    assert _rel(got["exit_wave"], want["exit_wave"]) <= TOL
