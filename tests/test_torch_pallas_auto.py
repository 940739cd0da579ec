"""Where ``auto`` hands the slice step to the ``pallas`` engine (rows 1-3):
complex128 on every grid, and complex64 on grids outside the fused and panel
kernels' sizes.  The engine's choice, and the port on those runs against
fdes_tpu on the same numpy inputs: config 3's loss and dV in complex128, a
rollout at an off-grid size in complex64, and the CLI on the defaults against
the same run on ``xla``.

PyTorch's gradient of a real V equals jax.grad's (the conjugate convention
changes only complex gradients)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import forward as jfwd  # noqa: E402
from fdes_tpu import loss as jloss  # noqa: E402
from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.pallas import slice_step as jss  # noqa: E402
from fdes_tpu_torch import cli as tcli  # noqa: E402
from fdes_tpu_torch import forward as tfwd  # noqa: E402
from fdes_tpu_torch import loss as tloss  # noqa: E402
from fdes_tpu_torch import pipeline as tpipe  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.config import apply_overrides, load_config  # noqa: E402
from fdes_tpu_torch.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu_torch.kernels import slice_step as ks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "examples", "si110_hrtem.toml")
SIGMA = interaction_sigma(300e3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(autouse=True)
def _one_thread():
    """The problems here are at most 96^2: one intra-op thread runs them as
    fast as many, and does not compete with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "n,dtype,want",
    [
        (256, torch.complex128, "pallas"),
        (512, torch.complex128, "pallas"),
        (2048, torch.complex128, "pallas"),
        (1536, torch.complex64, "pallas"),
        (384, torch.complex64, "pallas"),
        # beside them, the grids the fused and panel kernels take
        (512, torch.complex64, "fscan"),
        (2048, torch.complex64, "panel"),
    ],
)
def test_resolve_auto_hands_pallas_complex128_and_off_grid_sizes(n, dtype, want):
    assert tprop._resolve_auto((n, n), dtype) == want
    step = tprop.make_slice_step("auto", shape=(n, n), dtype=dtype)
    if want == "pallas":
        assert step is ks.pallas_slice_step


@pytest.fixture(scope="module")
def config3_c128():
    """Config 3's loss cut to 64^2 x 8 slices (Si[110] 2x2x2, the file's 8
    defoci) in complex128 on the CPU, observed at V_true by the port."""
    cfg = apply_overrides(load_config(CONFIG), [
        "sim.ny=64", "sim.nx=64", "sim.nslices=8", "specimen.reps=[2,2,2]",
        "sim.dtype=complex128"])
    sim = tpipe.setup(cfg, device="cpu")
    step = tprop.make_slice_step("auto", shape=sim.grid.shape, dtype=sim.cdtype)

    def fwd(v):
        return tfwd.hrtem_defocus_series(v, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack,
                                         weights=sim.ctf_weights, slice_step=step)

    with torch.no_grad():
        i_obs = fwd(sim.v_stack)
    return sim, step, fwd, i_obs


def test_config3_loss_and_dv_on_auto_c128_equal_jax(config3_c128):
    """The loss and dV at V_true / 2 on ``auto`` (``pallas`` in complex128)
    equal jax.value_and_grad of the same loss on the JAX package's Pallas
    engine (interpret mode), to 1e-12."""
    sim, step, fwd, i_obs = config3_c128
    assert step is ks.pallas_slice_step and sim.cdtype == torch.complex128
    v_half = (0.5 * sim.v_stack).requires_grad_(True)
    loss = tloss.make_loss(fwd, i_obs)(v_half)
    loss.backward()

    def jax_fwd(v):
        return jfwd.hrtem_defocus_series(
            v, jnp.asarray(sim.psi0.numpy()), jnp.asarray(sim.propagator.numpy()), sim.sigma,
            jnp.asarray(sim.ctf_stack.numpy()),
            weights=None if sim.ctf_weights is None else jnp.asarray(sim.ctf_weights.numpy()),
            slice_step=lambda p, vs, pr, s: jss.pallas_slice_step(p, vs, pr, s, interpret=True))

    want_loss, want_dv = jax.value_and_grad(jloss.make_loss(jax_fwd, jnp.asarray(i_obs.numpy())))(
        jnp.asarray(v_half.detach().numpy()))
    assert want_dv.dtype == jnp.float64 and v_half.grad.dtype == torch.float64
    assert abs(loss.item() - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    assert _rel(v_half.grad.numpy(), want_dv) <= 1e-12


def test_multislice_on_auto_off_grid_equals_jax():
    """A rollout at 96^2 (no fused or panel kernel takes it: ``auto`` runs
    ``pallas``) in complex64 equals the JAX package's plain rollout at 1e-5."""
    n, s = 96, 8
    rng = np.random.default_rng(20)
    grid = Grid(ny=n, nx=n, py=0.3, px=0.3)
    prop = fresnel_propagator(grid, wavelength_A(300e3), 1.9).astype(np.complex64)
    v = rng.uniform(0.0, 1500.0, (s, n, n)).astype(np.float32)
    psi0 = np.exp(1j * rng.uniform(0.0, 0.2, (n, n))).astype(np.complex64)
    step = tprop.make_slice_step("auto", shape=(n, n), dtype=torch.complex64)
    assert step is ks.pallas_slice_step
    got = tprop.multislice(torch.as_tensor(psi0), torch.as_tensor(v), torch.as_tensor(prop), SIGMA,
                           slice_step=step)
    want = jprop.multislice(jnp.asarray(psi0), jnp.asarray(v), jnp.asarray(prop), SIGMA)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def _run(tmp_path, tag, *extra):
    out = tmp_path / tag
    assert tcli.main([CONFIG, "--device", "cpu", "--set", f"output_dir={out}", *extra]) == 0
    with open(out / "timing.json") as fh:
        return out, json.load(fh)


SMALL = ("--set", "sim.nslices=4", "--set", "specimen.reps=[1,1,1]")


def test_cli_invert_c128_on_defaults_equals_xla(tmp_path):
    """The accuracy tier (sim.dtype = complex128) of the inverse on the
    defaults runs ``pallas`` and recovers ``xla``'s V and losses within 1e-9
    (the gate chip_smoke's phase pallas_auto holds config 3 to)."""
    extra = ("--mode", "invert", "--set", "sim.ny=32", "--set", "sim.nx=32", *SMALL,
             "--set", "sim.dtype=complex128", "--set", "recon.iterations=3")
    runs = {tag: _run(tmp_path, tag, *extra, *eng)
            for tag, eng in (("auto", ()), ("xla", ("--set", "sim.engine=xla")))}
    # timing.json names no kind for a per-slice engine; auto's is pallas here
    assert (runs["auto"][1]["engine"], runs["auto"][1]["engine_kind"]) == ("auto", None)
    assert tprop._resolve_auto((32, 32), torch.complex128) == "pallas"
    got, want = (np.load(runs[k][0] / "reconstructed.npy") for k in ("auto", "xla"))
    assert got.dtype == want.dtype == np.float64 and np.isfinite(got).all()
    assert np.abs(want).max() > 1.0  # V moved
    assert _rel(got, want) <= 1e-9
    losses = {}
    for k in ("auto", "xla"):
        with open(runs[k][0] / "metrics.jsonl") as fh:
            losses[k] = [json.loads(line)["loss"] for line in fh]
    assert len(losses["auto"]) == 3
    np.testing.assert_allclose(losses["auto"], losses["xla"], rtol=1e-9)


def test_cli_hrtem_off_grid_on_defaults_equals_xla(tmp_path):
    """A field widened at the file's pixel to an off-grid 96^2 runs
    ``pallas`` on the defaults, its images ``xla``'s within 1e-5."""
    extra = ("--set", "sim.ny=96", "--set", "sim.nx=96", *SMALL)
    runs = {tag: _run(tmp_path, tag, *extra, *eng)
            for tag, eng in (("auto", ()), ("xla", ("--set", "sim.engine=xla")))}
    assert (runs["auto"][1]["engine"], runs["auto"][1]["engine_kind"]) == ("auto", None)
    assert tprop._resolve_auto((96, 96), torch.complex64) == "pallas"
    got, want = (np.load(runs[k][0] / "images.npy") for k in ("auto", "xla"))
    assert got.shape == want.shape == (8, 96, 96) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-5
