"""The port's whole-loop adjoint against fdes_tpu's (its Pallas kernels run
in interpret mode on the CPU, as tests/test_pallas.py runs them) on the same
numpy inputs, and against torch.autograd.

On the CPU the port's wrappers take their plain PyTorch versions: the two
backward ones are the reverse recursion written out on torch.fft, the
formulas the CUDA kernels implement.  These tests hold that recursion, the
kept waves (s stack, checkpoints), the batching rules, the autograd.Function
and the engine's dispatch; the kernels are held against the plain versions on
the card (the last test here, and chip_smoke.py).

PyTorch's gradient of a complex tensor is the conjugate of what jax.grad
returns: dV equals JAX's, dpsi0 the conjugate of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.pallas import adjoint_scan as jadj  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.kernels import _build  # noqa: E402
from fdes_tpu_torch.kernels import adjoint_scan as adj  # noqa: E402
from fdes_tpu_torch.kernels import fused_scan as fsc  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
N = 128
S = 8
ATOL = 2e-5  # times max|.|: the tolerance of tests/test_pallas.py:711-719


@pytest.fixture(autouse=True)
def _one_thread():
    """128^2 with a few slices: one intra-op thread runs them as fast as
    many, and does not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fields():
    """The inputs of tests/test_pallas.py's fixture and of its
    _fscan_grad_case, as numpy arrays: psi, the potential stack, P."""
    rng = np.random.default_rng(3)
    grid = Grid(ny=N, nx=N, py=0.3, px=0.3)
    psi = (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))).astype(np.complex64)
    prop = fresnel_propagator(grid, wavelength_A(KV), 1.8).astype(np.complex64)
    v_stack = (np.random.default_rng(11).normal(size=(S, N, N)) * 25.0).astype(np.float32)
    return psi, v_stack, prop


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _waves(psi, b):
    return psi if b == 1 else np.stack([psi, 1j * psi, psi.conj()])


def _close(got, want, tol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def _torch_loss_grads(out_fn, psi, v_stack):
    """Exit waves and the gradients of sum(|out|^2 Re(out)) (the loss of
    tests/test_pallas.py:698) with respect to V and psi0."""
    p_t, v_t = _t(psi).requires_grad_(True), _t(v_stack).requires_grad_(True)
    out = out_fn(p_t, v_t)
    (out.abs() ** 2 * out.real).sum().backward()
    return out.detach().numpy(), v_t.grad.numpy(), p_t.grad.numpy()


# ---- against the JAX package ------------------------------------------------


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("seg", [0, 4, S])
def test_scan_diff_apply_equals_jax(fields, seg, b):
    """Exit waves, dV and dpsi0 through the store pair (seg 0) and the segment
    pair (two segments, one segment), one wave and a batch: jax.value_and_grad
    through the JAX package's scan_diff_apply on the same inputs."""
    psi, v_stack, prop = fields
    psi_in = _waves(psi, b)

    def jloss(vv, p0):
        out = jadj.scan_diff_apply(p0, vv, jnp.asarray(prop), SIGMA, None, seg=seg)
        return jnp.sum(jnp.abs(out) ** 2 * jnp.real(out)), out

    (_, want_out), (want_v, want_p) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(v_stack), jnp.asarray(psi_in))
    got_out, got_v, got_p = _torch_loss_grads(
        lambda p, v: adj.scan_diff_apply(p, v, _t(prop), SIGMA, seg=seg), psi_in, v_stack)
    assert got_out.shape == psi_in.shape and got_out.dtype == np.complex64
    assert got_v.dtype == np.float32
    _close(got_out, want_out)
    _close(got_v, want_v)
    _close(got_p, np.conj(want_p))


@pytest.mark.parametrize("seg", [0, 4])
def test_kept_waves_equal_jax_residuals(fields, seg):
    """What the forward keeps for the backward: the s stack, or the waves
    entering every seg-th slice, against the residuals of the JAX kernels."""
    psi, v_stack, prop = fields
    psi_b = _waves(psi, 3)
    jargs = (jnp.asarray(psi_b), jnp.asarray(v_stack), jnp.asarray(prop), SIGMA, None)
    if seg == 0:
        want_out, want_re, want_im = jadj._run_forward_store(*jargs)
        got_out, got = adj.fused_scan_store(_t(psi_b), _t(v_stack), _t(prop), SIGMA)
        assert tuple(got.shape) == (3, S, N, N)
    else:
        want_out, want_re, want_im = jadj._run_forward_ck(*jargs, seg)
        got_out, got = adj.fused_scan_ck(_t(psi_b), _t(v_stack), _t(prop), SIGMA, seg)
        assert tuple(got.shape) == (3, S // seg, N, N)
        np.testing.assert_array_equal(got[:, 0].numpy(), psi_b)  # the incoming wave itself
    _close(got_out.numpy(), want_out)
    _close(got.numpy(), np.asarray(want_re) + 1j * np.asarray(want_im))


def test_per_wave_propagator_grad_equals_jax_vmap(fields):
    """The tilt-series inverse's shape (tests/test_pallas.py:873-896): one
    propagator per wave, natively on the port's batch axis, against JAX's
    vmap over (wave, propagator) through its fscan engine."""
    psi, v_stack, prop = fields
    v3 = v_stack[:3]
    props = np.stack([prop, prop * np.exp(0.01j), prop * np.exp(-0.02j)]).astype(np.complex64)
    psi_b = _waves(psi, 3)
    jstep = jprop.make_slice_step("fscan", shape=(N, N), dtype=jnp.complex64, grad=True)

    def jloss(vv):
        out = jax.vmap(lambda p0, pr: jprop.multislice(p0, vv, pr, SIGMA, slice_step=jstep))(
            jnp.asarray(psi_b), jnp.asarray(props))
        return jnp.sum(jnp.abs(out) ** 2 * jnp.real(out))

    want_v = jax.grad(jloss)(jnp.asarray(v3))
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=True)
    _, got_v, _ = _torch_loss_grads(
        lambda p, v: tprop.multislice(p, v, _t(props), SIGMA, slice_step=step), psi_b, v3)
    _close(got_v, want_v)
    # one wave broadcast over the propagators: dpsi0 sums over them
    _, got_v1, got_p1 = _torch_loss_grads(
        lambda p, v: tprop.multislice(p, v, _t(props), SIGMA, slice_step=step), psi, v3)
    _, want_v1, want_p1 = _torch_loss_grads(
        lambda p, v: tprop.multislice(p.expand(3, N, N), v, _t(props), SIGMA), psi, v3)
    assert got_p1.shape == (N, N)
    _close(got_v1, want_v1)
    _close(got_p1, want_p1)


def test_fscan_grad_engine_through_multislice(fields):
    """make_slice_step('fscan', grad=True) through propagate.multislice, with
    remat_chunk accepted and ignored (tests/test_pallas.py:790-816): the
    gradient of JAX's fscan engine, and the plain engine's exit wave."""
    psi, v_stack, prop = fields
    v4 = v_stack[:4]
    jstep = jprop.make_slice_step("fscan", shape=(N, N), dtype=jnp.complex64, grad=True)
    want_v = jax.grad(lambda vv: jnp.sum(jnp.abs(jprop.multislice(
        jnp.asarray(psi), vv, jnp.asarray(prop), SIGMA, slice_step=jstep, remat_chunk=2)) ** 2)
    )(jnp.asarray(v4))
    step = tprop.make_slice_step("fscan", shape=(N, N), dtype=torch.complex64)  # grad=True
    assert step.grad_capable and step.kind == "fscan"
    v_t = _t(v4).requires_grad_(True)
    out = tprop.multislice(_t(psi), v_t, _t(prop), SIGMA, slice_step=step, remat_chunk=2)
    (out.abs() ** 2).sum().backward()
    _close(v_t.grad.numpy(), want_v)
    with torch.no_grad():
        plain = tprop.multislice(_t(psi), _t(v4), _t(prop), SIGMA)
    _close(out.detach().numpy(), plain.numpy())


# ---- against autograd, in complex128 ---------------------------------------


@pytest.mark.parametrize("per_wave_p", [False, True], ids=["shared_p", "per_wave_p"])
@pytest.mark.parametrize("seg", [0, 1, 2, S])
def test_plain_recursions_equal_autograd_c128(fields, seg, per_wave_p):
    """The reverse recursion written out (what the backward kernels are held
    to on the card) against torch.autograd through the plain forward loop, in
    complex128, for an arbitrary upstream gradient: <= 1e-12."""
    psi, v_stack, prop = fields
    rng = np.random.default_rng(5)
    p0 = _t(_waves(psi, 3).astype(np.complex128))
    g = _t(rng.normal(size=(3, N, N)) + 1j * rng.normal(size=(3, N, N)))
    pr = _t(prop.astype(np.complex128))
    if per_wave_p:
        pr = torch.stack([pr, pr * np.exp(0.3j), pr.conj().resolve_conj()])
    v = _t(v_stack.astype(np.float64))
    p1, v1 = p0.clone().requires_grad_(True), v.clone().requires_grad_(True)
    want_p, want_v = torch.autograd.grad(fsc.fused_scan_ref(p1, v1, pr, SIGMA), (p1, v1),
                                         grad_outputs=g)
    if seg == 0:
        out, kept = adj.fused_scan_store(p0, v, pr, SIGMA)
        got_v, got_p = adj.fused_scan_bwd_store(kept, v, pr, g, SIGMA)
    else:
        out, kept = adj.fused_scan_ck(p0, v, pr, SIGMA, seg)
        got_v, got_p = adj.fused_scan_bwd_ck(kept, v, pr, g, SIGMA, seg)
    assert got_v.shape == v.shape and got_v.dtype == torch.float64
    assert float((out - fsc.fused_scan_ref(p0, v, pr, SIGMA)).abs().max()) <= 1e-12
    for got, want in ((got_p, want_p), (got_v, want_v)):
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    # the autograd.Function hands the same gradients on
    p2, v2 = p0.clone().requires_grad_(True), v.clone().requires_grad_(True)
    fn_p, fn_v = torch.autograd.grad(adj.scan_diff_apply(p2, v2, pr, SIGMA, seg=seg), (p2, v2),
                                     grad_outputs=g)
    assert torch.equal(fn_p, got_p) and torch.equal(fn_v, got_v)


def test_backward_takes_a_lazy_conj_gradient(fields):
    """autograd may hand the backward a lazy conjugate view, whose memory holds
    the unconjugated values: the Function resolves it."""
    psi, v_stack, prop = fields
    v = _t(v_stack[:2]).requires_grad_(True)
    out = adj.scan_diff_apply(_t(psi), v, _t(prop), SIGMA)
    g = torch.ones_like(out) * (1 + 2j)
    (want,) = torch.autograd.grad(out, v, grad_outputs=g.conj().resolve_conj(), retain_graph=True)
    (got,) = torch.autograd.grad(out, v, grad_outputs=g.conj())
    assert torch.equal(got, want)


# ---- what is kept, and when -------------------------------------------------


def test_primal_pays_nothing(fields, monkeypatch):
    """When autograd is not recording, or no input requires a gradient, the
    grad-capable engine runs the plain scan and keeps no wave."""
    psi, v_stack, prop = fields

    def refuse(*a, **k):
        raise AssertionError("the forward kept waves for a backward nobody asked for")

    monkeypatch.setattr(adj, "fused_scan_store", refuse)
    monkeypatch.setattr(adj, "fused_scan_ck", refuse)
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=True)
    want = fsc.fused_scan_ref(_t(psi), _t(v_stack), _t(prop), SIGMA)
    out = step.whole_scan(_t(psi), _t(v_stack), _t(prop), SIGMA)
    assert not out.requires_grad and torch.equal(out, want)
    with torch.no_grad():
        out = step.whole_scan(_t(psi), _t(v_stack).requires_grad_(True), _t(prop), SIGMA)
    assert not out.requires_grad and torch.equal(out, want)
    with pytest.raises(AssertionError, match="nobody asked"):
        step.whole_scan(_t(psi), _t(v_stack).requires_grad_(True), _t(prop), SIGMA)


def test_only_the_gradients_asked_for(fields):
    psi, v_stack, prop = fields
    p_t = _t(psi).requires_grad_(True)
    out = adj.scan_diff_apply(p_t, _t(v_stack[:2]), _t(prop), SIGMA)
    (out.abs() ** 2).sum().backward()
    # |psi|^2 is conserved by the loop up to the band limit: a gradient near 2 psi
    assert p_t.grad.shape == (N, N) and float(p_t.grad.abs().max()) > 0


def test_store_budget_picks_the_pair(fields, monkeypatch):
    """seg=None: the store pair while the s stack fits the budget, the
    segment pair with pick_seg(S) past it; both give one gradient."""
    psi, v_stack, prop = fields
    calls = []
    for name in ("fused_scan_store", "fused_scan_ck"):
        real = getattr(adj, name)
        monkeypatch.setattr(adj, name,
                            lambda *a, _real=real, _name=name, **k: calls.append((_name, a[4:]))
                            or _real(*a, **k))
    grads = []
    for cap in (adj.STORE_CAP_BYTES, S * N * N * 8, S * N * N * 8 - 1):
        monkeypatch.setattr(adj, "STORE_CAP_BYTES", cap)
        v_t = _t(v_stack).requires_grad_(True)
        adj.scan_diff_apply(_t(psi), v_t, _t(prop), SIGMA).abs().pow(2).sum().backward()
        grads.append(v_t.grad)
    assert calls == [("fused_scan_store", ()), ("fused_scan_store", ()),
                     ("fused_scan_ck", (adj.pick_seg(S),))]
    _close(grads[2].numpy(), grads[0].numpy(), 1e-5)


@pytest.mark.parametrize("nslices,want", [(1, 1), (2, 2), (3, 3), (4, 2), (8, 4), (12, 4),
                                          (64, 8), (128, 16), (512, 32), (7, 7), (6, 3)])
def test_pick_seg_keeps_the_fewest_planes(nslices, want):
    seg = adj.pick_seg(nslices, 512)
    assert seg == want and nslices % seg == 0


# ---- refusals ----------------------------------------------------------------


def test_propagator_gradient_raises(fields):
    psi, v_stack, prop = fields
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=True)
    pr = _t(prop).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="propagator no gradient"):
        tprop.multislice(_t(psi), _t(v_stack), pr, SIGMA, slice_step=step)
    with torch.no_grad():  # nothing is recorded: nothing is lost
        tprop.multislice(_t(psi), _t(v_stack[:1]), pr, SIGMA, slice_step=step)


def test_per_wave_potential_under_a_gradient_raises(fields):
    psi, v_stack, prop = fields
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=True)
    v_b = _t(np.stack([v_stack[:2], 0.9 * v_stack[:2]]))
    with pytest.raises(NotImplementedError, match="a per-wave V under a gradient"):
        tprop.multislice(_t(psi), v_b.requires_grad_(True), _t(prop), SIGMA, slice_step=step)
    with pytest.raises(NotImplementedError, match="a per-wave V under a gradient"):
        tprop.multislice(_t(psi).requires_grad_(True), v_b.detach(), _t(prop), SIGMA,
                         slice_step=step)
    out = tprop.multislice(_t(psi), v_b.detach(), _t(prop), SIGMA, slice_step=step)
    assert tuple(out.shape) == (2, N, N)  # forward, it is the plain scan's batching


def test_bad_operands_raise(fields):
    psi, v_stack, prop = fields
    p, v, pr = _t(psi), _t(v_stack), _t(prop)
    with pytest.raises(ValueError, match="must divide"):
        adj.scan_diff_apply(p, v.requires_grad_(True), pr, SIGMA, seg=3)
    with pytest.raises(ValueError, match="must divide"):
        adj.fused_scan_ck(p[None], v.detach(), pr, SIGMA, 5)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        adj.fused_scan_store(p, v.detach(), pr, SIGMA)
    with pytest.raises(ValueError, match="kept waves"):
        adj.fused_scan_bwd_store(torch.zeros(1, S - 1, N, N, dtype=p.dtype), v.detach(), pr,
                                 p[None], SIGMA)
    with pytest.raises(ValueError, match="shared by the waves"):
        adj.fused_scan_store(p[None], v.detach()[None], pr, SIGMA)
    with pytest.raises(TypeError, match="must be real"):
        adj.scan_diff_apply(p.requires_grad_(True), v.detach().to(torch.complex64), pr, SIGMA)


def test_absorptive_potential_differentiates_through_the_slice_kernels(fields):
    """A complex V under a gradient goes slice by slice through
    pallas_slice_step on the grad-capable engine too."""
    psi, v_stack, prop = fields
    v_abs = _t((v_stack[:2] + 1j * 0.1 * np.abs(v_stack[:2])).astype(np.complex64))
    grads = []
    for kind in ("fscan", "xla"):
        step = tprop.make_slice_step(kind, shape=(N, N), grad=True)
        v_t = v_abs.clone().requires_grad_(True)
        tprop.multislice(_t(psi), v_t, _t(prop), SIGMA, slice_step=step).abs().pow(2).sum(
        ).backward()
        grads.append(v_t.grad.numpy())
    assert np.abs(grads[1]).max() > 0
    _close(grads[0], grads[1])


# ---- the build ---------------------------------------------------------------


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """Device code shared through a header: editing the header renames every
    library, so none is reused stale."""
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build._target("a")
    assert first == _build._target("a")
    (tmp_path / "shared.cuh").write_text("// two\n")
    second = _build._target("a")
    (tmp_path / "a.cu").write_text("// b\n")
    assert len({first, second, _build._target("a")}) == 3


def test_sources_share_one_header():
    src = _build._PKG / "csrc"
    assert {p.name for p in src.glob("*.cuh")} == {"fused_fft.cuh"}
    for name in ("fused_step", "adjoint_scan"):
        assert '#include "fused_fft.cuh"' in (src / f"{name}.cu").read_text()
    assert "adjoint_scan" in _build.sources()


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the whole-loop adjoint kernels have no CPU form")
    return torch.device("cuda")


def test_adjoint_kernels_match_plain_on_card(fields, cuda):
    psi, v_stack, prop = fields
    p = _t(_waves(psi, 3)).to(cuda)
    v, pr = _t(v_stack).to(cuda), _t(prop).to(cuda)
    g = p.flip(0).contiguous()
    tol = 2e-6 * S ** 0.5
    for seg, route in ((0, "tile"), (0, "wide"), (4, "tile"), (4, "wide")):
        if seg == 0:
            got = adj.fused_scan_store(p, v, pr, SIGMA, route=route)
            want = adj.fused_scan_store_ref(p, v, pr, SIGMA)
            back = adj.fused_scan_bwd_store(got[1], v, pr, g, SIGMA, route=route)
            again = adj.fused_scan_bwd_store(got[1], v, pr, g, SIGMA, route=route)
            back_want = adj.fused_scan_bwd_store_ref(want[1], v, pr, g, SIGMA)
        else:
            got = adj.fused_scan_ck(p, v, pr, SIGMA, seg, route=route)
            want = adj.fused_scan_ck_ref(p, v, pr, SIGMA, seg)
            back = adj.fused_scan_bwd_ck(got[1], v, pr, g, SIGMA, seg, route=route)
            again = adj.fused_scan_bwd_ck(got[1], v, pr, g, SIGMA, seg, route=route)
            back_want = adj.fused_scan_bwd_ck_ref(want[1], v, pr, g, SIGMA, seg)
        for a, b in zip((*got, *back), (*want, *back_want)):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        assert torch.equal(back[0], again[0])  # dV: a fixed order of summation
    with pytest.raises(TypeError, match="complex64"):
        adj.fused_scan_store(p.to(torch.complex128), v, pr, SIGMA)
    with pytest.raises(ValueError, match="lazy conj"):
        adj.fused_scan_bwd_store(got[1], v, pr, g.conj(), SIGMA)
