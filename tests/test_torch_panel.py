"""The port's panel engine against fdes_tpu's panel engine (its Pallas kernels
run in interpret mode on the CPU with the panel extents patched down, as
tests/test_pallas.py runs them) on the same numpy inputs; the plain panel
passes against numpy FFTs of the functions they stand for; and the engine's
refusals.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests hold the plain versions, their bit-reversed x-spectrum layout, the
batching rules and the engine's dispatch; the CUDA kernels are held against
the plain versions on the card (the last test here, and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import fused_scan as fsc  # noqa: E402
from fdes_tpu_torch.kernels import panel_scan as ps  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
N = 256
TOL = 5e-6  # times max|ref|: the tolerance of tests/test_pallas.py:472-629
EXACT = 1e-12  # complex128, max|got - want| / max|want|


@pytest.fixture(autouse=True)
def _one_thread():
    """256^2 with a few slices: one intra-op thread runs them as fast as
    many, and does not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fields():
    """Numpy inputs at 256^2: a wave, a second one, a 3-slice potential, the
    Fresnel propagator and two tilted ones, an absorptive 2-slice stack."""
    rng = np.random.default_rng(9)
    grid = Grid(ny=N, nx=N, py=0.3, px=0.3)
    psi = (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))).astype(np.complex64)
    v = (rng.normal(size=(3, N, N)) * 25.0).astype(np.float32)
    lam = wavelength_A(KV)
    prop = fresnel_propagator(grid, lam, 1.8).astype(np.complex64)
    props = np.stack([fresnel_propagator(grid, lam, 1.8, tilt_xy_rad=(t, 0.01))
                      for t in (0.0, 0.02)]).astype(np.complex64)
    v_abs = (v[:2] + 0.2j * np.abs(v[:2])).astype(np.complex64)
    return {"psi": psi, "psi_b": np.stack([psi, 1j * psi]), "v": v, "prop": prop,
            "props": props, "v_abs": v_abs}


@pytest.fixture(scope="module")
def jax_panel(fields):
    """The JAX panel engine's exit waves, each computed once: the panel
    extents patched to 64 rows and 128 columns so that a 256^2 plane streams
    4 row panels and 2 column panels per pass, as at 2048^2."""
    import fdes_tpu.pallas.panel_scan as jps

    f = fields
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "_ROWS", 64)
        mp.setattr(jps, "_COLS", 128)
        step = jprop.make_slice_step("panel", shape=(N, N), dtype=jnp.complex64, grad=False)
        assert step.kind == "panel" and not step.grad_capable

        def run(psi, v, prop):
            return np.asarray(jprop.multislice(jnp.asarray(psi), jnp.asarray(v),
                                               jnp.asarray(prop), SIGMA, slice_step=step))

        return {
            "s3": run(f["psi"], f["v"], f["prop"]),
            "s1": run(f["psi"], f["v"][:1], f["prop"]),
            # (B, n, n): the JAX engine maps over the waves one at a time
            "b2": run(f["psi_b"], f["v"][:2], f["prop"]),
            # the tilt series: vmap over (wave, propagator)
            "per_wave_p": np.asarray(jax.vmap(
                lambda p0, pr: jprop.multislice(p0, jnp.asarray(f["v"][:2]), pr, SIGMA,
                                                slice_step=step)
            )(jnp.asarray(f["psi_b"]), jnp.asarray(f["props"]))),
            "absorptive": run(f["psi"], f["v_abs"], f["prop"]),
        }


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _port(kind, psi, v, prop):
    step = tprop.make_slice_step(kind, shape=(N, N), dtype=torch.complex64, grad=False)
    with torch.no_grad():
        return tprop.multislice(_t(psi), _t(v), _t(prop), SIGMA, slice_step=step).numpy()


# ---- the engine against the JAX panel engine ------------------------------


@pytest.mark.parametrize("kind", ["panel", "panel_fast"])
@pytest.mark.parametrize("case", ["s3", "s1", "b2", "per_wave_p", "absorptive"])
def test_panel_engine_equals_jax(fields, jax_panel, kind, case):
    """Exit waves of the port's panel engine (its plain passes here) against
    the JAX panel engine's: three slices and one, two waves in one rollout,
    one propagator per wave, a complex absorptive V.  panel_fast runs the
    same float32 passes, so it is held to the same tolerance."""
    f = fields
    psi, v, prop = {
        "s3": (f["psi"], f["v"], f["prop"]),
        "s1": (f["psi"], f["v"][:1], f["prop"]),
        "b2": (f["psi_b"], f["v"][:2], f["prop"]),
        "per_wave_p": (f["psi_b"], f["v"][:2], f["props"]),
        "absorptive": (f["psi"], f["v_abs"], f["prop"]),
    }[case]
    got, want = _port(kind, psi, v, prop), jax_panel[case]
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_batched_waves_equal_per_wave_rollouts(fields):
    """B waves in one rollout give each wave's own rollout: with one
    propagator per wave, and with a single wave broadcast over them (the
    kernels treat the waves alike, bit for bit, on the card; the plain
    version's batched FFT rounds in another order)."""
    f = fields
    got = _port("panel", f["psi_b"], f["v"], f["props"])
    for b in range(2):
        want = _port("panel", f["psi_b"][b], f["v"], f["props"][b])
        np.testing.assert_allclose(got[b], want, atol=1e-6 * np.abs(want).max())
    broadcast = _port("panel", f["psi"], f["v"], f["props"])
    assert broadcast.shape == (2, N, N)
    want = _port("panel", f["psi"], f["v"], f["props"][1])
    np.testing.assert_allclose(broadcast[1], want, atol=1e-6 * np.abs(want).max())


def test_thickness_series_on_panel(fields):
    f = fields
    v = _t(np.concatenate([f["v"], f["v"][:1]]))
    step = tprop.make_slice_step("panel", shape=(N, N), grad=False)
    with torch.no_grad():
        series = tprop.multislice_thickness_series(_t(f["psi"]), v, _t(f["prop"]), SIGMA,
                                                   every=2, slice_step=step)
        assert tuple(series.shape) == (2, N, N)
        for k in range(2):
            prefix = tprop.multislice(_t(f["psi"]), v[: 2 * (k + 1)], _t(f["prop"]), SIGMA,
                                      slice_step=step)
            np.testing.assert_allclose(series[k].numpy(), prefix.numpy(), atol=1e-6)


# ---- the plain passes, complex128 --------------------------------------------


@pytest.fixture(scope="module")
def c128():
    """complex128 inputs: a wave, an x-spectrum plane, a 3-slice stack and its
    absorptive part, a propagator (one and two per wave)."""
    rng = np.random.default_rng(17)

    def cplx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    return {"psi": cplx(2, N, N), "a": cplx(2, N, N), "v": rng.uniform(0, 2000, (3, N, N)),
            "vi": rng.uniform(0, 200, (3, N, N)),
            "prop": np.exp(1j * rng.uniform(0, 6.28, (N, N))),
            "props": np.exp(1j * rng.uniform(0, 6.28, (2, N, N)))}


def _natural(a):
    """An x spectrum in bit-reversed order, in natural order."""
    return a[..., rt.bit_reversal(a.shape[-1]).numpy()]


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - want).max() <= EXACT * np.abs(want).max()


def _t_np(x):
    return np.exp(1j * SIGMA * x)


@pytest.mark.parametrize("name", ["init", "init_abs", "colpass", "colpass_per_wave",
                                  "rowpass", "rowpass_stack", "rowpass_stack_abs", "final"])
def test_plain_pass_equals_numpy(c128, name):
    """Each pass's plain version, after undoing its bit-reversed x spectrum,
    against numpy's FFT of the function it stands for."""
    d = c128
    psi, a, v, vi = d["psi"], d["a"], d["v"], d["vi"]
    a_nat = _natural(a)
    fft, ifft = np.fft.fft, np.fft.ifft
    damp = np.exp(-SIGMA * vi)
    if name == "init":
        got, want = ps.panel_init_ref(_t(v[0]), _t(psi), SIGMA), fft(_t_np(v[0]) * psi)
    elif name == "init_abs":
        got = ps.panel_init_abs_ref(_t(v[0]), _t(vi[0]), _t(psi), SIGMA)
        want = fft(damp[0] * _t_np(v[0]) * psi)
    elif name in ("colpass", "colpass_per_wave"):
        p = d["prop"] if name == "colpass" else d["props"]
        got = ps.panel_colpass_ref(_t(a), _t(p))
        want = ifft(fft(a_nat, axis=-2) * p, axis=-2) / N
    elif name == "rowpass":
        got = ps.panel_rowpass_ref(_t(v[1]), _t(a), SIGMA)
        want = fft(_t_np(v[1]) * N * ifft(a_nat))
    elif name == "rowpass_stack":
        got = ps.panel_rowpass_stack_ref(2, _t(v), _t(a), SIGMA)
        want = fft(_t_np(v[2]) * N * ifft(a_nat))
    elif name == "rowpass_stack_abs":
        got = ps.panel_rowpass_stack_abs_ref(1, _t(v), _t(vi), _t(a), SIGMA)
        want = fft(damp[1] * _t_np(v[1]) * N * ifft(a_nat))
    else:
        got, want = ps.panel_final_ref(_t(a)), N * ifft(a_nat)
    if name != "final":
        got = _natural(got.numpy())
    _close(got, want)


@pytest.mark.parametrize("absorptive", [False, True])
def test_plain_chain_equals_fused_scan_ref(c128, absorptive):
    """init -> col -> rowpass_stack -> col -> rowpass_stack -> col -> final
    is the multislice loop: equal to fused_scan_ref (or, for a complex V,
    the plain transmit-and-FFT loop) in complex128, and panel_scan_ref is
    that chain."""
    d = c128
    psi, v, pr = _t(d["psi"]), _t(d["v"]), _t(d["prop"])
    if absorptive:
        vr, vi = v, _t(d["vi"])
        a = ps.panel_init_abs_ref(vr[0], vi[0], psi, SIGMA)
        for j in (1, 2):
            a = ps.panel_rowpass_stack_abs_ref(j, vr, vi, ps.panel_colpass_ref(a, pr), SIGMA)
        want = psi
        for j in range(3):
            want = tprop.default_slice_step(want, torch.complex(vr[j], vi[j]), pr, SIGMA)
        v_in = torch.complex(vr, vi)
    else:
        a = ps.panel_init_ref(v[0], psi, SIGMA)
        for j in (1, 2):
            a = ps.panel_rowpass_stack_ref(j, v, ps.panel_colpass_ref(a, pr), SIGMA)
        want = fsc.fused_scan_ref(psi, v, pr, SIGMA)
        v_in = v
    got = ps.panel_final_ref(ps.panel_colpass_ref(a, pr))
    _close(got, want.numpy())
    assert torch.equal(ps.panel_scan_ref(psi, v_in, pr, SIGMA), got)
    assert torch.equal(ps.panel_scan(psi, v_in, pr, SIGMA), got)  # CPU: the plain version


def _dif(x):
    """Radix-2 decimation in frequency along the last axis: natural order
    in, bit-reversed out (the kernels' forward transform)."""
    n = x.shape[-1]
    x = x.astype(np.complex128).copy()
    h = n // 2
    while h >= 1:
        y = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        lo, hi = y[..., 0, :], y[..., 1, :]
        w = np.exp(-2j * np.pi * np.arange(h) / (2 * h))
        x = np.stack([lo + hi, (lo - hi) * w], axis=-2).reshape(x.shape)
        h //= 2
    return x


def _dit_inverse(x):
    """The kernels' unscaled inverse: bit-reversed in, natural out, times n."""
    n = x.shape[-1]
    x = x.astype(np.complex128).copy()
    h = 1
    while h < n:
        y = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        lo, hi = y[..., 0, :], y[..., 1, :]
        t = hi * np.exp(2j * np.pi * np.arange(h) / (2 * h))
        x = np.stack([lo + t, lo - t], axis=-2).reshape(x.shape)
        h *= 2
    return x


def test_plain_layout_is_the_kernels_transform(c128):
    """The plain passes keep what the kernels keep between passes: the init
    pass is a DIF transform along x, the column pass a DIF transform along
    y times prepare_propagator(P) / n^2 and a DIT inverse, the final pass a
    DIT inverse along x."""
    d = c128
    psi, v, p, a = d["psi"][0], d["v"][0], d["prop"], d["a"][0]
    _close(ps.panel_init_ref(_t(v), _t(psi), SIGMA), _dif(_t_np(v) * psi))
    pp = rt.prepare_propagator(_t(p)).numpy().astype(np.complex128)
    col = _dit_inverse((_dif(a.T) * pp.T / N**2)).T
    # the kernel multiplies by the complex64 propagator: compare with it
    _close(ps.panel_colpass_ref(_t(a), _t(p.astype(np.complex64))), col)
    _close(ps.panel_final_ref(_t(a)), _dit_inverse(a))


def test_prepare_propagator_is_bit_reversed_in_both_axes(fields):
    p = _t(fields["prop"])
    idx = rt.bit_reversal(N)
    pp = rt.prepare_propagator(p)
    assert pp.dtype == torch.complex64 and pp.is_contiguous()
    assert torch.equal(pp, p[idx[:, None], idx[None, :]])
    with pytest.raises(ValueError, match="supports axis sizes"):
        rt.prepare_propagator(p[:64, :64])


# ---- the engine's forms and refusals ---------------------------------------


@pytest.mark.parametrize("kind", ["panel", "panel_fast"])
@pytest.mark.parametrize("grad", [True, False])
def test_panel_is_forward_only_whatever_grad_says(fields, kind, grad):
    """make_slice_step('panel', grad=False) gives the forward-only engine: not
    grad-capable, and a gradient-requiring input raises instead of handing
    back a zero gradient.  grad=True (the default) gives the grad-capable
    engine, whose gradient with respect to psi0 and V is autograd's through
    the plain loop (tests/test_torch_panel_grad.py holds it against JAX).
    Under no_grad both run the forward rollout."""
    f = fields
    step = tprop.make_slice_step(kind, shape=(N, N), grad=grad)
    assert isinstance(step, fsc.WholeScanEngine) and step.kind == kind
    assert step.grad_capable == grad
    args = [_t(f["psi"]), _t(f["v"][:1]), _t(f["prop"])]
    if grad:
        psi, v = (a.clone().requires_grad_(True) for a in args[:2])
        out = tprop.multislice(psi, v, args[2], SIGMA, slice_step=step)
        (out.abs() ** 2).sum().backward()
        psi_x, v_x = (a.clone().requires_grad_(True) for a in args[:2])
        (tprop.multislice(psi_x, v_x, args[2], SIGMA).abs() ** 2).sum().backward()
        for got, want in ((v.grad, v_x.grad), (psi.grad, psi_x.grad)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=TOL * float(want.abs().max()))
    else:
        for i in range(3):
            req = [a.clone().requires_grad_(k == i) for k, a in enumerate(args)]
            with pytest.raises(RuntimeError, match="forward-only"):
                tprop.multislice(*req, SIGMA, slice_step=step)
    out = tprop.multislice(*args, SIGMA, slice_step=step)  # nothing requires a gradient
    assert not out.requires_grad and out.shape == (N, N)


def test_panel_refuses_remat_per_slice_calls_and_per_wave_v(fields):
    f = fields
    step = tprop.make_slice_step("panel", shape=(N, N))
    psi, v, prop = _t(f["psi"]), _t(f["v"]), _t(f["prop"])
    with pytest.raises(ValueError, match="forward-only"):
        tprop.multislice(psi, v, prop, SIGMA, remat_chunk=1,
                         slice_step=tprop.make_slice_step("panel", shape=(N, N), grad=False))
    with pytest.raises(TypeError, match="whole slice loop"):
        step(psi, v[0], prop, SIGMA)
    with torch.no_grad():
        with pytest.raises(ValueError, match="shared by the waves"):
            tprop.multislice(torch.stack([psi, psi]), torch.stack([v, v]), prop, SIGMA,
                             slice_step=step)
        with pytest.raises(ValueError, match="no slices"):
            ps.panel_scan(psi, v[:0], prop, SIGMA)
        with pytest.raises(ValueError, match="batch sizes differ"):
            ps.panel_scan(torch.stack([psi, psi]), v, torch.stack([prop] * 3), SIGMA)


@pytest.mark.parametrize("kind", ["panel", "panel_fast"])
@pytest.mark.parametrize("shape,match", [((384, 384), "supports axis sizes"),
                                         ((8192, 8192), "supports axis sizes"),
                                         ((256, 512), "square")])
def test_sizes_rejected_like_jax(kind, shape, match):
    with pytest.raises(ValueError, match=match):
        tprop.make_slice_step(kind, shape=shape, grad=False)
    with pytest.raises(ValueError):
        jprop.make_slice_step(kind, shape=shape, dtype=jnp.complex64, grad=False)


@pytest.mark.parametrize("n", ps.SIZES)
def test_panel_sizes_resolve(n):
    step = tprop.make_slice_step("panel", shape=(n, n), grad=False)
    assert step.kind == "panel"
    with pytest.raises(ValueError, match="needs shape"):
        tprop.make_slice_step("panel")


def test_wrapper_counts_stay_zero_on_the_cpu(fields):
    """Launch counts count calls that reached the card: the plain path adds
    nothing."""
    f = fields
    ps.reset_launches()
    with torch.no_grad():
        ps.panel_scan(_t(f["psi"]), _t(f["v"]), _t(f["prop"]), SIGMA)
        ps.panel_final(_t(f["psi"]))
    assert all(w.launches == 0 for w in (*ps.WRAPPERS, *ps.LOOPS))


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the panel kernels have no CPU form")
    return torch.device("cuda")


def test_panel_kernels_match_plain_on_card(fields, cuda):
    f = fields
    psi = _t(f["psi_b"]).to(cuda)
    v, props = _t(f["v"]).to(cuda), _t(f["props"]).to(cuda)
    for got, want in (
        (ps.panel_init(v[0], psi, SIGMA), ps.panel_init_ref(v[0], psi, SIGMA)),
        (ps.panel_colpass(psi, props), ps.panel_colpass_ref(psi, props)),
        (ps.panel_rowpass_stack(1, v, psi, SIGMA), ps.panel_rowpass_stack_ref(1, v, psi, SIGMA)),
        (ps.panel_final(psi), ps.panel_final_ref(psi)),
        (ps.panel_scan(psi, v, props, SIGMA), ps.panel_scan_ref(psi, v, props, SIGMA)),
    ):
        assert float((got - want).abs().max()) <= 4e-6 * float(want.abs().max())
    batched = ps.panel_scan(psi, v, props, SIGMA)
    for b in range(2):  # each wave of a batch as the wave alone, bit for bit
        assert torch.equal(batched[b], ps.panel_scan(psi[b], v, props[b], SIGMA))
    with pytest.raises(TypeError, match="complex64"):
        ps.panel_scan(psi.to(torch.complex128), v, props, SIGMA)
    with pytest.raises(ValueError, match="lazy conj"):
        ps.panel_final(psi.conj())


def test_absorptive_rollout_reads_v_in_place_on_card(fields, cuda):
    """panel_scan of a complex64 V on the card: its init and row passes on
    the kernel PANEL_ROUTE's ``row_abs`` names, counted there, the exit waves
    held to the plain rollout; V is read in place, so the call allocates its
    output and the prepared propagator and no float32 copy of V's parts."""
    f = fields
    psi, props = _t(f["psi_b"]).to(cuda), _t(f["props"]).to(cuda)
    v = _t(f["v_abs"]).to(cuda)
    prepared = rt.prepare_propagator(props)
    ps.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = ps.panel_scan(psi, v, props, SIGMA)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    want = ps.panel_scan_ref(psi, v, props, SIGMA)
    assert float((got - want).abs().max()) <= 4e-6 * float(want.abs().max())
    route = ps.panel_route(N, 2, "row_abs")
    assert ps.panel_init_abs.launches_by_route[route] == 1
    assert ps.panel_rowpass_stack_abs.launches_by_route[route] == v.shape[0] - 1
    assert peak <= got.nbytes + prepared.nbytes + 65536 < got.nbytes + prepared.nbytes + v.nbytes
