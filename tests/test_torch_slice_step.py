"""The slice-step kernels' plain versions and the "pallas" engine against
fdes_tpu/pallas/slice_step.py (Pallas in interpret mode on the CPU), the
wrappers' checks, and the kernels against their plain versions on a card.

Gradients: PyTorch's gradient of a complex tensor is the conjugate of the
cotangent JAX hands a VJP, so a JAX VJP is fed conj(g) for a PyTorch
gradient g, and its dpsi is compared with the conjugate of the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.pallas import slice_step as jss  # noqa: E402
from fdes_tpu_torch.kernels import slice_step as ks  # noqa: E402

SIGMA = interaction_sigma(300e3)
# max |port - jax| / max |jax|: one complex rotation or product, rounded in
# another order (and another sin/cos) than XLA's
TOL = {np.complex64: 1e-6, np.complex128: 1e-12}
REAL = {np.complex64: np.float32, np.complex128: np.float64}


def _rel_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def planes():
    """ψ, b and V at 128² (V at real potential magnitudes: phases of radians)."""
    rng = np.random.default_rng(11)
    n = 128
    psi = rng.normal(size=(3, n, n)) + 1j * rng.normal(size=(3, n, n))
    b = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    v = np.abs(rng.normal(size=(n, n))) * 3000.0
    va = 0.1 * np.abs(rng.normal(size=(n, n))) * 3000.0
    grid = Grid(ny=n, nx=n, py=0.3, px=0.3)
    prop = fresnel_propagator(grid, wavelength_A(300e3), 1.9)
    return psi, b, v, va, prop


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a).astype(dtype))


@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
def test_transmit_ref_equals_pallas(planes, cdt):
    psi, _, v, _, _ = planes
    rdt = REAL[cdt]
    got = ks.transmit_ref(_t(psi[0], cdt), _t(v, rdt), SIGMA)
    want = jss.pallas_transmit(jnp.asarray(psi[0].astype(cdt)), jnp.asarray(v.astype(rdt)),
                               SIGMA, True)
    assert _rel_max(got.numpy(), want) <= TOL[cdt]
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(ks.transmit(_t(psi[0], cdt), _t(v, rdt), SIGMA), got)


@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
def test_transmit_abs_ref_equals_pallas(planes, cdt):
    """The port takes V = Vr + 1j*Va as one complex plane, the TPU kernel
    its two real parts."""
    psi, _, v, va, _ = planes
    rdt = REAL[cdt]
    got = ks.transmit_abs_ref(_t(psi[0], cdt), _t(v + 1j * va, cdt), SIGMA)
    want = jss.pallas_transmit_abs(
        jnp.asarray(psi[0].astype(cdt)), jnp.asarray(v.astype(rdt)),
        jnp.asarray(va.astype(rdt)), SIGMA, True,
    )
    assert _rel_max(got.numpy(), want) <= TOL[cdt]
    assert torch.equal(ks.transmit_abs(_t(psi[0], cdt), _t(v + 1j * va, cdt), SIGMA), got)


@pytest.mark.parametrize("conj_b", [False, True])
@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
def test_cmul_ref_equals_pallas(planes, cdt, conj_b):
    psi, b, _, _, _ = planes
    got = ks.cmul_ref(_t(psi[0], cdt), _t(b, cdt), conj_b)
    want = jss._cmul(jnp.asarray(psi[0].astype(cdt)), jnp.asarray(b.astype(cdt)), conj_b, True)
    assert _rel_max(got.numpy(), want) <= TOL[cdt]
    assert torch.equal(ks.cmul(_t(psi[0], cdt), _t(b, cdt), conj_b), got)


def test_batched_psi_broadcasts_v_and_b(planes):
    psi, b, v, va, _ = planes
    cdt, rdt = np.complex64, np.float32
    out = ks.transmit(_t(psi, cdt), _t(v, rdt), SIGMA)
    out_abs = ks.transmit_abs(_t(psi, cdt), _t(v + 1j * va, cdt), SIGMA)
    out_mul = ks.cmul(_t(psi, cdt), _t(b, cdt))
    for i in range(psi.shape[0]):
        p = jnp.asarray(psi[i].astype(cdt))
        want = jss.pallas_transmit(p, jnp.asarray(v.astype(rdt)), SIGMA, True)
        assert _rel_max(out[i].numpy(), want) <= TOL[cdt]
        want = jss.pallas_transmit_abs(p, jnp.asarray(v.astype(rdt)),
                                       jnp.asarray(va.astype(rdt)), SIGMA, True)
        assert _rel_max(out_abs[i].numpy(), want) <= TOL[cdt]
        want = jss._cmul(p, jnp.asarray(b.astype(cdt)), False, True)
        assert _rel_max(out_mul[i].numpy(), want) <= TOL[cdt]


@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
@pytest.mark.parametrize("absorptive", [False, True])
def test_pallas_slice_step_equals_jax(planes, cdt, absorptive):
    psi, _, v, va, prop = planes
    vv = v + 1j * va if absorptive else v
    vdt = cdt if absorptive else REAL[cdt]
    got = ks.pallas_slice_step(_t(psi[0], cdt), _t(vv, vdt), _t(prop, cdt), SIGMA)
    want = jss.pallas_slice_step(
        jnp.asarray(psi[0].astype(cdt)), jnp.asarray(vv.astype(vdt)),
        jnp.asarray(prop.astype(cdt)), SIGMA, interpret=True,
    )
    assert got.dtype == _t(psi[0], cdt).dtype
    assert _rel_max(got.numpy(), want) <= 10 * TOL[cdt]  # two FFTs in two libraries


@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
@pytest.mark.parametrize("absorptive", [False, True])
def test_transmit_bwd_refs_equal_jax_vjp(planes, cdt, absorptive):
    """dV (and dVa) equal JAX's, dpsi the conjugate of JAX's, per wave."""
    psi, b, v, va, _ = planes
    rdt = REAL[cdt]
    p, g = psi[0].astype(cdt), b.astype(cdt)  # b serves as the upstream gradient
    if absorptive:
        vc = _t(v + 1j * va, cdt)
        dpsi, dv = ks.transmit_abs_bwd_ref(_t(p, cdt), vc, _t(g, cdt), SIGMA)
        assert dv.dtype == vc.dtype and dv.shape == vc.shape
        got = (dpsi, dv.real, dv.imag)  # dV = dVr + 1j*dVa, one complex plane
        _, vjp = jax.vjp(
            lambda pp, vr, vab: jss.pallas_transmit_abs(pp, vr, vab, SIGMA, True),
            jnp.asarray(p), jnp.asarray(v.astype(rdt)), jnp.asarray(va.astype(rdt)),
        )
        want = vjp(jnp.conj(jnp.asarray(g)))
        assert torch.equal(ks.transmit_abs_bwd(_t(p, cdt), vc, _t(g, cdt), SIGMA)[1], dv)
    else:
        got = ks.transmit_bwd_ref(_t(p, cdt), _t(v, rdt), _t(g, cdt), SIGMA)
        _, vjp = jax.vjp(lambda pp, vv: jss.pallas_transmit(pp, vv, SIGMA, True),
                         jnp.asarray(p), jnp.asarray(v.astype(rdt)))
        want = vjp(jnp.conj(jnp.asarray(g)))
        assert torch.equal(ks.transmit_bwd(_t(p, cdt), _t(v, rdt), _t(g, cdt), SIGMA)[1], got[1])
    assert _rel_max(got[0].numpy(), np.conj(want[0])) <= TOL[cdt]
    for dv, dv_jax in zip(got[1:], want[1:]):
        assert dv.dtype == _t(v, rdt).dtype
        assert _rel_max(dv.numpy(), dv_jax) <= 10 * TOL[cdt]  # a sum of two products


@pytest.mark.parametrize("absorptive", [False, True])
def test_transmit_bwd_batch_sums_dv(planes, absorptive):
    """With a batch of waves and one V, dV is the sum of the per-wave dVs."""
    psi, _, v, va, _ = planes
    cdt, rdt = np.complex128, np.float64
    g = np.conj(psi[::-1]).copy()
    if absorptive:
        got = ks.transmit_abs_bwd(_t(psi, cdt), _t(v + 1j * va, cdt), _t(g, cdt), SIGMA)
        each = [ks.transmit_abs_bwd(_t(psi[i], cdt), _t(v + 1j * va, cdt), _t(g[i], cdt), SIGMA)
                for i in range(3)]
    else:
        got = ks.transmit_bwd(_t(psi, cdt), _t(v, rdt), _t(g, cdt), SIGMA)
        each = [ks.transmit_bwd(_t(psi[i], cdt), _t(v, rdt), _t(g[i], cdt), SIGMA)
                for i in range(3)]
    for i in range(3):
        assert torch.equal(got[0][i], each[i][0])
    for k in range(1, len(got)):
        assert got[k].shape == v.shape
        assert _rel_max(got[k].numpy(), sum(e[k] for e in each).numpy()) <= 1e-14


def test_engine_backward_raises(planes):
    """The engine's gradients equal jax.vjp of the Pallas engine (dV equal,
    dpsi conjugate, real and complex V); asking for the propagator's raises."""
    psi, b, v, va, prop = planes
    cdt = np.complex128
    for vv in (v, v + 1j * va):
        vdt = cdt if np.iscomplexobj(vv) else np.float64
        p_t = _t(psi[0], cdt).requires_grad_(True)
        v_t = _t(vv, vdt).requires_grad_(True)
        out = ks.pallas_slice_step(p_t, v_t, _t(prop, cdt), SIGMA)
        out.backward(_t(b, cdt))
        _, vjp = jax.vjp(
            lambda pp, vs: jss.pallas_slice_step(pp, vs, jnp.asarray(prop), SIGMA, interpret=True),
            jnp.asarray(psi[0].astype(cdt)), jnp.asarray(vv.astype(vdt)),
        )
        d_psi, d_v = vjp(jnp.conj(jnp.asarray(b.astype(cdt))))
        assert _rel_max(p_t.grad.numpy(), np.conj(d_psi)) <= 1e-11
        # the complex V's gradient is dVr + i dVa, the conjugate of JAX's
        want_v = np.conj(d_v) if np.iscomplexobj(vv) else d_v
        assert _rel_max(v_t.grad.numpy(), want_v) <= 1e-11
    p_req = _t(prop, cdt).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="propagator"):
        ks.pallas_slice_step(_t(psi[0], cdt), _t(v, np.float64), p_req, SIGMA)
    with torch.no_grad():  # no gradient is taken, so nothing to refuse
        ks.pallas_slice_step(_t(psi[0], cdt), _t(v, np.float64), p_req, SIGMA)


def test_transmit_abs_saves_v_in_place_and_returns_complex_dv(planes):
    """The absorptive step saves the complex slice it is handed (V's own
    storage: no copy of its real and imaginary parts is made or saved), and
    its dV is one complex tensor, the conjugate of JAX's VJP for the complex V."""
    psi, b, v, va, prop = planes
    cdt = np.complex128
    v_stack = _t(np.stack([v + 1j * va, 0.5 * v + 1j * va]), cdt).requires_grad_(True)
    p_t = _t(psi[0], cdt).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = p_t
        for v_slice in v_stack.unbind(0):
            out = ks.pallas_slice_step(out, v_slice, _t(prop, cdt), SIGMA)
    base = v_stack.untyped_storage().data_ptr()
    v_saved = [t for t in saved if t.shape == v.shape and t.untyped_storage().data_ptr() == base]
    assert len(v_saved) == 2 and all(t.dtype == v_stack.dtype for t in v_saved)
    # nothing else of V's shape is saved but psi and the propagator
    assert not [t for t in saved if t.shape == v.shape and not t.is_complex()]
    out.backward(_t(b, cdt))
    assert v_stack.grad.dtype == v_stack.dtype

    def jax_rollout(pp, vs):
        for j in range(2):
            pp = jss.pallas_slice_step(pp, vs[j], jnp.asarray(prop), SIGMA, interpret=True)
        return pp

    _, vjp = jax.vjp(jax_rollout, jnp.asarray(psi[0].astype(cdt)),
                     jnp.asarray(v_stack.detach().numpy()))
    d_psi, d_v = vjp(jnp.conj(jnp.asarray(b.astype(cdt))))
    assert _rel_max(v_stack.grad.numpy(), np.conj(d_v)) <= 1e-11
    assert _rel_max(p_t.grad.numpy(), np.conj(d_psi)) <= 1e-11


@pytest.mark.parametrize("wrapper", ["transmit_abs", "transmit_abs_bwd"])
@pytest.mark.parametrize("case", ["strided", "conj", "neg", "dtype"])
def test_absorptive_wrappers_refuse_v_not_read_in_place(planes, wrapper, case):
    """The absorptive kernels read V's complex plane as it lies: a V that is
    not contiguous, a lazy conj or neg view, or not of psi's dtype is
    refused on every device, not copied."""
    psi, b, v, va, _ = planes
    p = _t(psi[0], np.complex64)
    vc = _t(v + 1j * va, np.complex64)
    bad = {
        "strided": vc.t(),
        "conj": vc.conj(),
        "neg": torch._neg_view(vc),
        "dtype": vc.to(torch.complex128),
    }[case]
    call = {"transmit_abs": lambda vv: ks.transmit_abs(p, vv, SIGMA),
            "transmit_abs_bwd": lambda vv: ks.transmit_abs_bwd(p, vv, p, SIGMA)}[wrapper]
    call(vc)  # the dense V of psi's dtype goes through
    with pytest.raises(TypeError if case == "dtype" else ValueError,
                       match={"strided": "contiguous", "conj": "conj", "neg": "neg",
                              "dtype": "dtype"}[case]):
        call(bad)


@pytest.mark.parametrize(
    "case",
    ["int_psi", "real_psi", "complex_v", "v_shape", "b_shape", "b_dtype", "abs_shapes",
     "g_shape", "g_dtype"],
)
def test_wrappers_raise_on_bad_input(planes, case):
    psi, b, v, va, _ = planes
    p, vv, bb = _t(psi[0], np.complex64), _t(v, np.float32), _t(b, np.complex64)
    call = {
        "g_shape": lambda: ks.transmit_bwd(p, vv, _t(psi, np.complex64), SIGMA),
        "g_dtype": lambda: ks.transmit_abs_bwd(p, bb, bb.to(torch.complex128), SIGMA),
        "int_psi": lambda: ks.transmit(torch.ones(128, 128, dtype=torch.int32), vv, SIGMA),
        "real_psi": lambda: ks.cmul(vv, vv),
        "complex_v": lambda: ks.transmit(p, bb, SIGMA),
        "v_shape": lambda: ks.transmit(p, vv[:64], SIGMA),
        "b_shape": lambda: ks.cmul(p, bb[:, :64]),
        "b_dtype": lambda: ks.cmul(p, bb.to(torch.complex128)),
        "abs_shapes": lambda: ks.transmit_abs(_t(psi, np.complex64), bb[None], SIGMA),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        call()


def test_cpu_calls_launch_nothing(planes):
    psi, b, v, _, _ = planes
    p, vv = _t(psi, np.complex64), _t(v, np.float32)
    ks.reset_launches()
    ks.transmit(p, vv, SIGMA)
    vc = _t(b, np.complex64)
    ks.transmit_abs(p, vc, SIGMA)
    ks.cmul(p, vc)
    ks.transmit_bwd(p, vv, p, SIGMA)
    ks.transmit_abs_bwd(p, vc, p, SIGMA)
    assert len(ks.WRAPPERS) == 5
    assert [w.launches for w in ks.WRAPPERS] == [0] * 5


def test_transmit_rows_is_the_table():
    """Row 1's planes a block row: TRANSMIT_ROWS' entry for the largest
    measured batch not above the launch's (0: the whole batch), never more
    than the batch, at least 1."""
    for cdt, rows in ks.TRANSMIT_ROWS.items():
        measured = sorted(rows)
        assert measured[0] == 1 and rows[1] == 0
        for b in range(0, 2 * measured[-1] + 1):
            entry = rows[max(k for k in measured if k <= max(b, 1))]
            assert ks.transmit_rows(b, cdt) == max(1, b if entry == 0 else min(entry, b))


@pytest.mark.parametrize("rows", [0, -1, 2.0, True, "4"])
def test_transmit_rows_argument_is_checked(planes, rows):
    """rows= takes a positive int or None, checked before the CPU dispatch;
    on the CPU any valid rows gives the plain version and launches nothing."""
    psi, _, v, _, _ = planes
    p, vv = _t(psi, np.complex64), _t(v, np.float32)
    with pytest.raises(ValueError, match="rows"):
        ks.transmit(p, vv, SIGMA, rows=rows)
    ks.reset_launches()
    for ok in (None, 1, 2, 64):
        assert torch.equal(ks.transmit(p, vv, SIGMA, rows=ok), ks.transmit_ref(p, vv, SIGMA))
    assert ks.transmit.launches == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
def test_kernels_match_plain_on_card(planes, cuda, cdt):
    psi, b, v, va, prop = planes
    rdt = REAL[cdt]
    p, vv, vc, bb = (_t(a, d).to(cuda)
                     for a, d in ((psi, cdt), (v, rdt), (v + 1j * va, cdt), (b, cdt)))
    g = p.flip(0).conj().resolve_conj()
    rng = np.random.default_rng(12)
    p8, g8 = (_t(rng.normal(size=(8, *v.shape)) + 1j * rng.normal(size=(8, *v.shape)), cdt)
              .to(cuda) for _ in range(2))
    odd = [t[..., 1:, 1:].contiguous() for t in (p, vv, g)]  # 127^2: 8-byte accesses
    ks.reset_launches()
    pairs = [
        (ks.transmit(p, vv, SIGMA), ks.transmit_ref(p, vv, SIGMA)),
        # rows 1 and 2 at batches 1 and 8 (3 above and below), and on an odd plane
        (ks.transmit(p[0], vv, SIGMA), ks.transmit_ref(p[0], vv, SIGMA)),
        (ks.transmit(p8, vv, SIGMA), ks.transmit_ref(p8, vv, SIGMA)),
        # block rows of 3 planes (the last row short) and of one
        (ks.transmit(p8, vv, SIGMA, rows=3), ks.transmit_ref(p8, vv, SIGMA)),
        (ks.transmit(p8, vv, SIGMA, rows=1), ks.transmit_ref(p8, vv, SIGMA)),
        (ks.transmit(odd[0], odd[1], SIGMA), ks.transmit_ref(*odd[:2], SIGMA)),
        *zip(ks.transmit_bwd(p[0], vv, g[0], SIGMA), ks.transmit_bwd_ref(p[0], vv, g[0], SIGMA)),
        *zip(ks.transmit_bwd(p8, vv, g8, SIGMA), ks.transmit_bwd_ref(p8, vv, g8, SIGMA)),
        *zip(ks.transmit_bwd(*odd, SIGMA), ks.transmit_bwd_ref(*odd, SIGMA)),
        (ks.transmit_abs(p, vc, SIGMA), ks.transmit_abs_ref(p, vc, SIGMA)),
        (ks.cmul(p, bb, True), ks.cmul_ref(p, bb, True)),
        *zip(ks.transmit_bwd(p, vv, g, SIGMA), ks.transmit_bwd_ref(p, vv, g, SIGMA)),
        *zip(ks.transmit_abs_bwd(p, vc, g, SIGMA), ks.transmit_abs_bwd_ref(p, vc, g, SIGMA)),
        # one plane, and an odd plane (8-byte accesses)
        (ks.transmit_abs(p[0], vc, SIGMA), ks.transmit_abs_ref(p[0], vc, SIGMA)),
        (ks.transmit_abs(p[:, 1:, 1:].contiguous(), vc[1:, 1:].contiguous(), SIGMA),
         ks.transmit_abs_ref(p[:, 1:, 1:], vc[1:, 1:], SIGMA)),
        *zip(ks.transmit_abs_bwd(p[:, 1:, 1:].contiguous(), vc[1:, 1:].contiguous(),
                                 g[:, 1:, 1:].contiguous(), SIGMA),
             ks.transmit_abs_bwd_ref(p[:, 1:, 1:], vc[1:, 1:], g[:, 1:, 1:], SIGMA)),
    ]
    torch.cuda.synchronize()
    assert [w.launches for w in ks.WRAPPERS] == [6, 3, 1, 4, 2]
    # dV summed over the batch in a fixed order: the same bits twice
    assert torch.equal(ks.transmit_abs_bwd(p, vc, g, SIGMA)[1],
                       ks.transmit_abs_bwd(p, vc, g, SIGMA)[1])
    assert torch.equal(ks.transmit_bwd(p8, vv, g8, SIGMA)[1], ks.transmit_bwd(p8, vv, g8, SIGMA)[1])
    tol = {np.complex64: 2e-6, np.complex128: 1e-12}[cdt]
    for got, want in pairs:
        assert _rel_max(got.cpu().numpy(), want.cpu().numpy()) <= tol
    with pytest.raises(ValueError, match="contiguous"):
        ks.transmit(p.transpose(-1, -2), vv, SIGMA)
    with pytest.raises(ValueError, match="conj"):
        ks.cmul(p, bb.conj())
    with pytest.raises(ValueError, match="conj"):
        ks.transmit_bwd(p, vv, g.conj(), SIGMA)
