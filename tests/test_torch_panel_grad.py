"""The port's panel gradient against fdes_tpu's panel grad engine (its Pallas
kernels run in interpret mode on the CPU with the panel extents patched down,
as tests/test_torch_panel.py runs them) on the same numpy inputs, both routes:
the store pair and, past the store cap, the per-slice adjoint under
checkpoints; the plain gradient passes against numpy FFTs of the functions
they stand for and against torch.autograd; and the engine's refusals.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests hold the reverse recursion those versions write out (the formulas the
CUDA kernels implement), the batching rules, the autograd.Functions and the
engine's dispatch; the kernels are held against the plain versions on the
card (the last test here, and chip_smoke.py).

PyTorch's gradient of a complex tensor is the conjugate of what jax.grad
returns: dV equals JAX's, dpsi0 the conjugate of JAX's.  The propagator is
tilted, so it is not symmetric: a conj(P) slip in the adjoint shows."""

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
from fdes_tpu_torch.kernels import adjoint_scan as adj  # noqa: E402
from fdes_tpu_torch.kernels import panel_scan as ps  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
N = 256
S = 3
ATOL = 2e-5  # times max|.|: the tolerance of tests/test_pallas.py:553-606
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
    """Numpy inputs at 256^2: a wave (and a second one), a 3-slice potential,
    a tilted propagator and a second tilt."""
    rng = np.random.default_rng(31)
    grid = Grid(ny=N, nx=N, py=0.3, px=0.3)
    psi = (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))).astype(np.complex64)
    v = (rng.normal(size=(S, N, N)) * 25.0).astype(np.float32)
    lam = wavelength_A(KV)
    props = np.stack([fresnel_propagator(grid, lam, 1.8, tilt_xy_rad=t)
                      for t in ((0.02, 0.01), (-0.01, 0.03))]).astype(np.complex64)
    return {"psi": psi, "psi_b": np.stack([psi, 1j * psi.conj()]), "v": v, "prop": props[0],
            "props": props}


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _jax_loss(out):
    return jnp.sum(jnp.abs(out) ** 2 * jnp.real(out))


def _torch_loss(out):
    return (out.abs() ** 2 * out.real).sum()


@pytest.fixture(scope="module")
def jax_grads(fields):
    """fdes_tpu's panel grad engine (loss, dV, dpsi0) of the loss of
    tests/test_pallas.py:580, on the store route and past its cap on the
    per-slice route; the panel extents patched to 64 rows and 128 columns so
    that a 256^2 plane streams 4 row panels and 2 column panels per pass."""
    import fdes_tpu.pallas.adjoint_scan as jadj
    import fdes_tpu.pallas.panel_scan as jps

    f = fields
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "_ROWS", 64)
        mp.setattr(jps, "_COLS", 128)
        step = jprop.make_slice_step("panel", shape=(N, N), dtype=jnp.complex64, grad=True)
        assert step.grad_capable

        def loss(v, p0):
            return _jax_loss(jprop.multislice(p0, v, jnp.asarray(f["prop"]), SIGMA,
                                              slice_step=step))

        for route, cap in (("store", None), ("per_slice", 1)):
            if cap:
                mp.setattr(jadj, "_STORE_CAP_BYTES", cap)
            val, (gv, gp) = jax.value_and_grad(loss, argnums=(0, 1))(
                jnp.asarray(f["v"]), jnp.asarray(f["psi"]))
            out[route] = (float(val), np.asarray(gv), np.asarray(gp))
    return out


def _port_grads(f, kind="panel", psi=None, v=None, prop=None):
    """(loss, dV, dpsi0) of the same loss through the port's engine."""
    step = tprop.make_slice_step(kind, shape=(N, N), dtype=torch.complex64, grad=True)
    psi_t = _t(f["psi"] if psi is None else psi).requires_grad_(True)
    v_t = _t(f["v"] if v is None else v).requires_grad_(True)
    loss = _torch_loss(tprop.multislice(psi_t, v_t, _t(f["prop"] if prop is None else prop),
                                        SIGMA, slice_step=step))
    loss.backward()
    return float(loss.detach()), v_t.grad.numpy(), psi_t.grad.numpy()


def _close(got, want, tol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


# ---- the engine against the JAX panel grad engine ---------------------------


@pytest.mark.parametrize("kind", ["panel", "panel_fast"])
@pytest.mark.parametrize("route", ["store", "per_slice"])
def test_panel_grad_equals_jax(fields, jax_grads, monkeypatch, kind, route):
    """Loss, dV and dpsi0 of the port's grad-capable panel engine (its plain
    passes here) against the JAX panel grad engine's, on the store route and,
    with both packages' store caps patched to 1 byte, on the per-slice route
    (dpsi0: the conjugate of JAX's)."""
    if route == "per_slice":
        monkeypatch.setattr(adj, "STORE_CAP_BYTES", 1)
    loss, dv, dpsi = _port_grads(fields, kind)
    j_loss, j_dv, j_dpsi = jax_grads[route]
    np.testing.assert_allclose(loss, j_loss, rtol=ATOL)
    _close(dv, j_dv)
    _close(dpsi, np.conj(j_dpsi))


def test_routes_take_their_passes(fields, monkeypatch):
    """The store route runs panel_diff_apply's autograd.Function over the
    store pair; past the cap each slice is a panel_slice_step under
    torch.utils.checkpoint.  On the CPU both go through the plain versions,
    so the routes are told apart by the passes they call."""
    calls = []
    for name in ("panel_scan_store_ref", "panel_scan_bwd_store_ref", "panel_bwd_tail_ref"):
        fn = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or
                            _fn(*a, **k))
    _port_grads(fields)
    assert calls == ["panel_scan_store_ref", "panel_scan_bwd_store_ref"]
    calls.clear()
    monkeypatch.setattr(adj, "STORE_CAP_BYTES", 1)
    _port_grads(fields)
    assert calls == ["panel_bwd_tail_ref"] * S


def test_remat_chunk_is_taken_and_ignored(fields):
    """A grad-capable panel engine bounds its own adjoint memory: remat_chunk
    changes nothing."""
    f = fields
    step = tprop.make_slice_step("panel", shape=(N, N), grad=True)
    grads = []
    for remat in (None, 1):
        v = _t(f["v"]).requires_grad_(True)
        out = tprop.multislice(_t(f["psi"]), v, _t(f["prop"]), SIGMA, remat_chunk=remat,
                               slice_step=step)
        _torch_loss(out).backward()
        grads.append(v.grad)
    assert torch.equal(grads[0], grads[1])


# ---- the plain passes, complex128 --------------------------------------------


@pytest.fixture(scope="module")
def c128():
    """complex128 inputs: waves, x-spectrum planes, an s stack, a 3-slice
    potential, a propagator and two per-wave ones."""
    rng = np.random.default_rng(19)

    def cplx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    return {"psi": cplx(2, N, N), "a": cplx(2, N, N), "s": cplx(2, S, N, N),
            "v": rng.uniform(0, 2000, (S, N, N)), "prop": np.exp(1j * rng.uniform(0, 6.28, (N, N))),
            "props": np.exp(1j * rng.uniform(0, 6.28, (2, N, N)))}


def _natural(a):
    """An x spectrum in bit-reversed order, in natural order."""
    return a[..., rt.bit_reversal(a.shape[-1]).numpy()]


def _exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - want).max() <= EXACT * np.abs(want).max()


def _t_np(x):
    return np.exp(1j * SIGMA * x)


@pytest.mark.parametrize("name", ["rowfwd", "bwd_tail", "init_store", "rowpass_stack_store",
                                  "col_bwd", "col_bwd_per_wave", "row_bwd_loop",
                                  "row_bwd_last"])
def test_plain_grad_pass_equals_numpy(c128, name):
    """Each gradient pass's plain version, its bit-reversed x spectra undone,
    against numpy's FFT of the function it stands for: bar_s = n ifft(bar),
    dV = sigma Im(bar_s conj(s)) summed over the two waves, bar_s conj(t)."""
    d = c128
    psi, a, s, v = d["psi"], d["a"], d["s"], d["v"]
    fft, ifft = np.fft.fft, np.fft.ifft
    bar_s = N * ifft(_natural(a))

    def dv_of(s_plane):
        return (SIGMA * (bar_s * s_plane.conj()).imag).sum(axis=0)

    if name == "rowfwd":
        _exact(_natural(ps.panel_rowfwd_ref(_t(a)).numpy()), fft(a))
    elif name == "bwd_tail":
        dpsi, dv = ps.panel_bwd_tail_ref(_t(v[1]), _t(psi), _t(a), SIGMA)
        _exact(dpsi, bar_s * _t_np(v[1]).conj())
        _exact(dv, dv_of(_t_np(v[1]) * psi))
    elif name == "init_store":
        got, s0 = ps.panel_init_store_ref(_t(v[0]), _t(psi), SIGMA)
        _exact(s0, _t_np(v[0]) * psi)
        _exact(_natural(got.numpy()), fft(_t_np(v[0]) * psi))
    elif name == "rowpass_stack_store":
        got, s2 = ps.panel_rowpass_stack_store_ref(2, _t(v), _t(a), SIGMA)
        want_s = _t_np(v[2]) * N * ifft(_natural(a))
        _exact(s2, want_s)
        _exact(_natural(got.numpy()), fft(want_s))
    elif name in ("col_bwd", "col_bwd_per_wave"):
        p = d["prop"] if name == "col_bwd" else d["props"]
        got = ps.panel_col_bwd_ref(_t(a), _t(p))
        _exact(_natural(got.numpy()), ifft(fft(_natural(a), axis=-2) * p.conj(), axis=-2) / N)
    elif name == "row_bwd_loop":
        got, dv = ps.panel_row_bwd_loop_ref(2, _t(v), _t(s), _t(a), SIGMA)
        _exact(_natural(got.numpy()), fft(bar_s * _t_np(v[2]).conj()))
        _exact(dv, dv_of(s[:, 2]))
    else:
        dpsi, dv = ps.panel_row_bwd_last_ref(_t(v[0]), _t(s[:, 0]), _t(a), SIGMA)
        _exact(dpsi, bar_s * _t_np(v[0]).conj())
        _exact(dv, dv_of(s[:, 0]))


def _inner(x, y):
    return complex((x.conj() * y).sum())


@pytest.mark.parametrize("per_wave_p", [False, True])
def test_gradient_passes_are_conjugate_transposes(c128, per_wave_p):
    """<C a, b> = <a, C^H b>: the column pass with conj(P) is the conjugate
    transpose of the column pass (the propagator neither symmetric nor
    real), and the seed Fx that of the final pass Fx^H, so the reverse loop
    needs no sign flips."""
    d = c128
    a, b = _t(d["a"]), _t(d["psi"])
    p = _t(d["props"] if per_wave_p else d["prop"])
    lhs = _inner(ps.panel_colpass_ref(a, p), b)
    rhs = _inner(a, ps.panel_col_bwd_ref(b, p))
    assert abs(lhs - rhs) <= EXACT * abs(lhs)
    lhs, rhs = _inner(ps.panel_final_ref(a), b), _inner(a, ps.panel_rowfwd_ref(b))
    assert abs(lhs - rhs) <= EXACT * abs(lhs)


@pytest.mark.parametrize("per_wave_p", [False, True])
def test_plain_store_pair_equals_autograd(c128, per_wave_p):
    """The plain store pair (the reverse recursion of the plain passes) gives
    torch.autograd's gradient through panel_scan_ref for an upstream g, in
    complex128, two waves, shared or per-wave propagator; the kept s is the
    transmitted wave of every slice."""
    d = c128
    p = _t(d["props"] if per_wave_p else d["prop"])
    psi = _t(d["psi"]).requires_grad_(True)
    v = _t(d["v"]).requires_grad_(True)
    g = _t(d["a"])
    out = ps.panel_scan_ref(psi, v, p, SIGMA)
    out.backward(g)
    with torch.no_grad():
        out_s, s = ps.panel_scan_store_ref(psi, v, p, SIGMA)
        dv, dpsi = ps.panel_scan_bwd_store_ref(s, v, p, g, SIGMA)
    _exact(out_s, out.detach().numpy())
    assert tuple(s.shape) == (2, S, N, N)
    _exact(s[:, 0], ps.panel_init_store_ref(v[0], psi, SIGMA)[1].detach().numpy())
    _exact(dv, v.grad.numpy())
    _exact(dpsi, psi.grad.numpy())


def test_two_waves_sum_their_dv(c128):
    """Two waves in one reverse loop: dV is the sum of each wave's own, dpsi0
    each wave's own (complex128, per-wave propagators)."""
    d = c128
    psi, v, p, g = _t(d["psi"]), _t(d["v"]), _t(d["props"]), _t(d["a"])
    _, s = ps.panel_scan_store_ref(psi, v, p, SIGMA)
    dv, dpsi = ps.panel_scan_bwd_store_ref(s, v, p, g, SIGMA)
    parts = [ps.panel_scan_bwd_store_ref(s[b : b + 1], v, p[b], g[b : b + 1], SIGMA)
             for b in range(2)]
    _exact(dv, (parts[0][0] + parts[1][0]).numpy())
    for b in range(2):
        _exact(dpsi[b], parts[b][1][0].numpy())


@pytest.mark.parametrize("route", ["store", "per_slice"])
def test_engine_batch_equals_per_wave_gradients(fields, monkeypatch, route):
    """A tilt series (two waves, one tilted propagator each) through the
    engine: dV is the sum of the two single-wave gradients, dpsi0 each
    wave's own, on both routes."""
    if route == "per_slice":
        monkeypatch.setattr(adj, "STORE_CAP_BYTES", 1)
    f = fields
    _, dv, dpsi = _port_grads(f, psi=f["psi_b"], prop=f["props"])
    singles = [_port_grads(f, psi=f["psi_b"][b], prop=f["props"][b]) for b in range(2)]
    _close(dv, singles[0][1] + singles[1][1], 1e-6)
    for b in range(2):
        _close(dpsi[b], singles[b][2], 1e-6)


# ---- the per-slice route's chunks ---------------------------------------------

S_LONG = 16  # four checkpointed chunks of pick_remat_chunk(16) = 4 slices


@pytest.fixture(scope="module")
def long_v():
    """A 16-slice potential at 256^2 (numpy, from a seed)."""
    rng = np.random.default_rng(37)
    return (rng.normal(size=(S_LONG, N, N)) * 25.0).astype(np.float32)


@pytest.fixture(scope="module")
def jax_long_grads(fields, long_v):
    """fdes_tpu's panel grad engine past its store cap (patched to 1 byte:
    the per-slice VJP under jax.checkpoint over V's (S/K, K, n, n) reshape)
    on the 16-slice potential, each wave of the two-tilt pair with its own
    propagator: (dV summed over the waves, dpsi0 of each wave)."""
    import fdes_tpu.pallas.adjoint_scan as jadj
    import fdes_tpu.pallas.panel_scan as jps

    f = fields
    dv, dpsi = 0.0, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "_ROWS", 64)
        mp.setattr(jps, "_COLS", 128)
        mp.setattr(jadj, "_STORE_CAP_BYTES", 1)
        step = jprop.make_slice_step("panel", shape=(N, N), dtype=jnp.complex64, grad=True)
        for b in range(2):
            def loss(v, p0, _b=b):
                return _jax_loss(jprop.multislice(p0, v, jnp.asarray(f["props"][_b]), SIGMA,
                                                  slice_step=step))

            gv, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(long_v),
                                                    jnp.asarray(f["psi_b"][b]))
            dv = dv + np.asarray(gv)
            dpsi.append(np.asarray(gp))
    return dv, np.stack(dpsi)


def test_per_slice_chunks_equal_store_route_and_jax(fields, long_v, jax_long_grads, monkeypatch):
    """Two waves (one tilted propagator each) through 16 slices: dV and dpsi0
    of the per-slice route (the store cap patched to 0: four checkpointed
    chunks) equal the store route's, and JAX's per-slice engine's (dV as it
    is, dpsi0 the conjugate of JAX's)."""
    f = fields
    grads = {}
    for route in ("store", "per_slice"):
        if route == "per_slice":
            monkeypatch.setattr(adj, "STORE_CAP_BYTES", 0)
        grads[route] = _port_grads(f, psi=f["psi_b"], v=long_v, prop=f["props"])[1:]
    for got, want in zip(grads["per_slice"], grads["store"]):
        _close(got, want)
    j_dv, j_dpsi = jax_long_grads
    _close(grads["per_slice"][0], j_dv)
    _close(grads["per_slice"][1], np.conj(j_dpsi))


def _graph(out: torch.Tensor, leaf: torch.Tensor) -> tuple[list[str], list[str]]:
    """(the kinds of the nodes reachable from out's grad_fn, the kinds of the
    nodes that hand their gradient to ``leaf``'s accumulator)."""
    kinds, into_leaf, seen, todo = [], [], set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        kinds.append(type(node).__name__)
        for nxt, _ in node.next_functions:
            if nxt is not None and getattr(nxt, "variable", None) is leaf:
                into_leaf.append(type(node).__name__)
            todo.append(nxt)
    return kinds, into_leaf


def test_per_slice_route_splits_v_once(fields, long_v, monkeypatch):
    """On the per-slice route V reaches the checkpointed chunks through one
    split: the graph between V and the exit waves holds one SplitBackward0,
    the only node that hands V its gradient, and no SliceBackward0 (a slice
    of V per chunk, whose backward fills a zeroed full-size dV for each
    chunk)."""
    monkeypatch.setattr(adj, "STORE_CAP_BYTES", 0)
    f = fields
    v = _t(long_v).requires_grad_(True)
    out = ps.panel_diff_apply(_t(f["psi_b"]), v, _t(f["props"]), SIGMA)
    kinds, into_v = _graph(out, v)
    assert "SliceBackward0" not in kinds
    assert kinds.count("SplitBackward0") == 1 and into_v == ["SplitBackward0"]
    assert kinds.count("_PanelStepBackward") == S_LONG


# ---- refusals and other potentials -------------------------------------------


def test_refusals(fields):
    """A propagator that requires a gradient raises (the panel gradient gives
    P none); a per-wave (B, S, n, n) V under a gradient raises naming the
    ROADMAP.md Queue 3 entry on it; the plain store pair takes (B, n, n) waves."""
    f = fields
    step = tprop.make_slice_step("panel", shape=(N, N), grad=True)
    psi, v = _t(f["psi"]), _t(f["v"])
    with pytest.raises(NotImplementedError, match="propagator"):
        tprop.multislice(psi, v.requires_grad_(True), _t(f["prop"]).requires_grad_(True), SIGMA,
                         slice_step=step)
    with pytest.raises(NotImplementedError, match="a per-wave V under a gradient"):
        tprop.multislice(_t(f["psi_b"]), torch.stack([v, v]).requires_grad_(True),
                         _t(f["prop"]), SIGMA, slice_step=step)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        ps.panel_scan_store(psi, v.detach(), _t(f["prop"]), SIGMA)


def test_complex_v_gradient_equals_xla(fields):
    """A complex (absorptive) V under a gradient goes slice by slice through
    the kernels around the library FFT: its gradient is xla's."""
    f = fields
    v_abs = (f["v"] + 0.2j * np.abs(f["v"])).astype(np.complex64)
    grads = {}
    for kind in ("panel", "xla"):
        step = tprop.make_slice_step(kind, shape=(N, N), grad=True)
        v = _t(v_abs).requires_grad_(True)
        out = tprop.multislice(_t(f["psi"]), v, _t(f["prop"]), SIGMA, slice_step=step)
        _torch_loss(out).backward()
        grads[kind] = v.grad.numpy()
    _close(grads["panel"], grads["xla"], 1e-5)


def test_wrapper_counts_stay_zero_on_the_cpu(fields, monkeypatch):
    """Launch counts count calls that reached the card: the plain gradient
    adds nothing on either route."""
    ps.reset_launches()
    _port_grads(fields)
    monkeypatch.setattr(adj, "STORE_CAP_BYTES", 1)
    _port_grads(fields)
    assert all(w.launches == 0 for w in (*ps.WRAPPERS, *ps.LOOPS))


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the panel kernels have no CPU form")
    return torch.device("cuda")


def test_panel_grad_kernels_match_plain_on_card(fields, cuda):
    """Rows 20-26 and the store pair against their plain versions, two waves
    with per-wave propagators; dV the same bits in two runs."""
    f = fields
    psi, a = _t(f["psi_b"]).to(cuda), _t(f["psi_b"][::-1]).to(cuda)
    v, props = _t(f["v"]).to(cuda), _t(f["props"]).to(cuda)
    s = torch.stack([psi, a, psi], dim=1).contiguous()
    pairs = [
        (ps.panel_rowfwd(a), ps.panel_rowfwd_ref(a)),
        (ps.panel_bwd_tail(v[1], psi, a, SIGMA), ps.panel_bwd_tail_ref(v[1], psi, a, SIGMA)),
        (ps.panel_init_store(v[0], psi, SIGMA), ps.panel_init_store_ref(v[0], psi, SIGMA)),
        (ps.panel_rowpass_stack_store(2, v, a, SIGMA),
         ps.panel_rowpass_stack_store_ref(2, v, a, SIGMA)),
        (ps.panel_col_bwd(a, props), ps.panel_col_bwd_ref(a, props)),
        (ps.panel_row_bwd_loop(1, v, s, a, SIGMA), ps.panel_row_bwd_loop_ref(1, v, s, a, SIGMA)),
        (ps.panel_row_bwd_last(v[0], psi, a, SIGMA),
         ps.panel_row_bwd_last_ref(v[0], psi, a, SIGMA)),
    ]
    out, kept = ps.panel_scan_store(psi, v, props, SIGMA)
    pairs.append(((out, kept), ps.panel_scan_store_ref(psi, v, props, SIGMA)))
    back = ps.panel_scan_bwd_store(kept, v, props, a, SIGMA)
    pairs.append((back, ps.panel_scan_bwd_store_ref(kept, v, props, a, SIGMA)))
    for got, want in pairs:
        for x, y in zip(got, want):
            assert float((x - y).abs().max()) <= 4e-6 * float(y.abs().max())
    again = ps.panel_scan_bwd_store(kept, v, props, a, SIGMA)
    assert all(torch.equal(x, y) for x, y in zip(back, again))
