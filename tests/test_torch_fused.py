"""The port's fused slice step and whole-loop scan against fdes_tpu's Pallas
kernels (run in interpret mode on the CPU, as tests/test_pallas.py runs
them) on the same numpy inputs, and the engines' refusals.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests hold the plain versions, the batching rules, the propagator's
bit-reversed layout and the engines' dispatch; the CUDA kernels are held
against the plain versions on the card (the last test here, and
chip_smoke.py)."""

import warnings

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
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
N = 128
ATOL = 2e-5  # absolute, on O(1) waves: the tolerance of tests/test_pallas.py:341-459


@pytest.fixture(autouse=True)
def _one_thread():
    """The problems here are 128^2 with a few slices: one intra-op thread
    runs them as fast as many, and does not compete with the other test
    workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fields():
    """The inputs of tests/test_pallas.py's fixture, as numpy arrays."""
    rng = np.random.default_rng(3)
    grid = Grid(ny=N, nx=N, py=0.3, px=0.3)
    psi = (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))).astype(np.complex64)
    v = (rng.normal(size=(N, N)) * 30.0).astype(np.float32)
    prop = fresnel_propagator(grid, wavelength_A(KV), 1.8).astype(np.complex64)
    return psi, v, prop


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _jax_rollout(kind, psi, v_stack, prop, **kw):
    step = jprop.make_slice_step(kind, shape=(N, N), dtype=jnp.complex64, **kw)
    return np.asarray(
        jprop.multislice(jnp.asarray(psi), jnp.asarray(v_stack), jnp.asarray(prop), SIGMA,
                         slice_step=step)
    )


def _port_rollout(kind, psi, v_stack, prop, **kw):
    step = tprop.make_slice_step(kind, shape=(N, N), dtype=torch.complex64, **kw)
    with torch.no_grad():
        return tprop.multislice(_t(psi), _t(v_stack), _t(prop), SIGMA, slice_step=step).numpy()


# ---- values ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fused", "fused_fast"])
def test_fused_engine_equals_jax(fields, kind):
    """Three slices through the per-slice fused engine: the JAX package's
    Pallas kernel (engine 'fused', the float32-exact tier) on the same inputs.
    The port's fast tier runs the same float32 arithmetic, so it is held to
    the exact tier's tolerance too."""
    psi, v, prop = fields
    v_stack = np.stack([v, -0.3 * v, 0.7 * v])
    want = _jax_rollout("fused", psi, v_stack, prop)
    got = _port_rollout(kind, psi, v_stack, prop)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fused_step_batched_equals_jax_vmap(fields):
    """A batch of waves through one step, shared and per-wave propagator:
    jax.vmap over the Pallas step."""
    psi, v, prop = fields
    psi_b = np.stack([psi, 1j * psi, psi.conj()])
    props = np.stack([prop, prop * np.exp(0.01j), prop * np.exp(-0.02j)]).astype(np.complex64)
    jstep = jprop.make_slice_step("fused", shape=(N, N), dtype=jnp.complex64)
    want = jax.vmap(lambda p: jstep(p, jnp.asarray(v), jnp.asarray(prop), SIGMA))(
        jnp.asarray(psi_b))
    got = fs.fused_slice_step(_t(psi_b), _t(v), _t(prop), SIGMA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want_p = jax.vmap(lambda p, pr: jstep(p, jnp.asarray(v), pr, SIGMA))(
        jnp.asarray(psi_b), jnp.asarray(props))
    got_p = fs.fused_step(_t(psi_b), _t(v), _t(props), SIGMA)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)


@pytest.mark.parametrize(
    "kind,case",
    [("fscan", c) for c in ("single", "batch", "per_wave_p", "per_wave_v", "both")]
    + [("fscan_fast", "batch"), ("fscan_draft", "batch")],  # the tiers share one kernel
)
def test_fscan_equals_jax(fields, kind, case):
    """Four slices through the whole-loop engine with the kernel's batching
    rules: the JAX package's whole-loop Pallas kernel (engine 'fscan', its
    float32-exact tier) where it takes the case natively, else its per-item
    rollouts."""
    psi, v, prop = fields
    v_stack = np.stack([v, -0.3 * v, 0.7 * v, 0.1 * v])
    psi_b = np.stack([psi, 1j * psi, psi.conj()])
    props = np.stack([prop, prop * np.exp(0.01j), prop * np.exp(-0.02j)]).astype(np.complex64)
    v_cfgs = np.stack([v_stack, 0.9 * v_stack, 1.1 * v_stack]).astype(np.float32)
    psi_in = psi if case in ("single", "per_wave_v") else psi_b
    v_in = v_cfgs if case in ("per_wave_v", "both") else v_stack
    p_in = props if case in ("per_wave_p", "both") else prop
    got = _port_rollout(kind, psi_in, v_in, p_in, grad=False)
    if case in ("single", "batch"):
        want = _jax_rollout("fscan", psi_in, v_in, p_in, grad=False)
    else:
        want = np.stack([
            _jax_rollout("fscan", psi_in if psi_in.ndim == 2 else psi_in[i],
                         v_in if v_in.ndim == 3 else v_in[i],
                         p_in if p_in.ndim == 2 else p_in[i], grad=False)
            for i in range(3)
        ])
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fscan_draft_does_not_warn(fields):
    """The port's draft tier is the float32 kernel: it has no inaccuracy to
    warn of."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tprop.make_slice_step("fscan_draft", shape=(N, N), grad=False)


@pytest.mark.parametrize("kind", ["fused", "fscan"])
def test_absorptive_potential_goes_through_the_slice_kernels(fields, kind):
    """A complex (absorptive) V is routed slice by slice through
    pallas_slice_step by both engines, as the JAX engines route it."""
    psi, v, prop = fields
    v_abs = np.stack([v, 0.5 * v]).astype(np.complex64)
    v_abs = v_abs + 1j * 0.1 * np.abs(v_abs)
    want = np.asarray(jprop.multislice(jnp.asarray(psi), jnp.asarray(v_abs), jnp.asarray(prop),
                                       SIGMA))
    got = _port_rollout(kind, psi, v_abs, prop, grad=False)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    assert np.linalg.norm(got) < 0.99 * np.linalg.norm(psi)  # damped


def test_absorptive_potential_on_a_batch_of_waves_is_shared_not_per_wave(fields):
    """The whole-loop engine carries a batch of waves through one shared
    complex (S, n, n) stack, also when B equals S, and refuses a per-wave
    (B, S, n, n) complex stack, which the slice kernels do not take."""
    psi, v, prop = fields
    v_abs = np.stack([v, 0.5 * v]).astype(np.complex64)
    v_abs = v_abs + 1j * 0.1 * np.abs(v_abs)
    waves = np.stack([psi, 1j * psi[::-1]])  # B = S = 2
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=False)
    with torch.no_grad():
        got = step.whole_scan(_t(waves), _t(v_abs), _t(prop), SIGMA).numpy()
        for b in range(2):
            want = np.asarray(jprop.multislice(jnp.asarray(waves[b]), jnp.asarray(v_abs),
                                               jnp.asarray(prop), SIGMA))
            assert np.linalg.norm(got[b] - want) / np.linalg.norm(want) <= 1e-5
        with pytest.raises(ValueError, match="shared by the waves"):
            step.whole_scan(_t(waves), _t(np.stack([v_abs, v_abs])), _t(prop), SIGMA)


@pytest.mark.parametrize("kind", ["fused", "fscan"])
def test_thickness_series_on_fused_engines(fields, kind):
    psi, v, prop = fields
    v_stack = _t(np.stack([v, -0.3 * v, 0.7 * v, 0.1 * v]))
    step = tprop.make_slice_step(kind, shape=(N, N), grad=False)
    with torch.no_grad():
        series = tprop.multislice_thickness_series(_t(psi), v_stack, _t(prop), SIGMA, every=2,
                                                   slice_step=step)
        assert tuple(series.shape) == (2, N, N)
        for k in range(2):
            prefix = tprop.multislice(_t(psi), v_stack[: 2 * (k + 1)], _t(prop), SIGMA,
                                      slice_step=step)
            np.testing.assert_allclose(series[k].numpy(), prefix.numpy(), atol=1e-6)


# ---- the propagator's layout -------------------------------------------------


def _dif(x):
    """Radix-2 decimation in frequency along the last axis, no reordering:
    natural order in, bit-reversed out (the kernel's forward transform)."""
    n = x.shape[-1]
    x = x.astype(np.complex128).copy()
    h = n // 2
    while h >= 1:
        y = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        w = np.exp(-2j * np.pi * np.arange(h) / (2 * h))
        x = np.stack([a + b, (a - b) * w], axis=-2).reshape(x.shape)
        h //= 2
    return x


def _dit_inverse(x):
    """The kernel's inverse: the forward stages undone last to first, without
    the factor 1/2 per stage (bit-reversed in, natural out, times n)."""
    n = x.shape[-1]
    x = x.astype(np.complex128).copy()
    h = 1
    while h < n:
        y = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        t = b * np.exp(2j * np.pi * np.arange(h) / (2 * h))
        x = np.stack([a + t, a - t], axis=-2).reshape(x.shape)
        h *= 2
    return x


def test_prepared_propagator_is_what_the_kernel_transform_needs(fields):
    """The kernel never reorders its spectrum: with the forward transform
    leaving both axes bit-reversed and the inverse taking them back,
    multiplying by prepare_propagator(P) / n^2 in between is IFFT2(P FFT2(x))."""
    psi, _, prop = fields
    psi = psi.astype(np.complex128)
    idx = rt.bit_reversal(N).numpy()
    assert sorted(idx) == list(range(N)) and (idx[idx] == np.arange(N)).all()
    spectrum = _dif(_dif(psi).T).T  # along x, then along y
    np.testing.assert_allclose(spectrum, np.fft.fft2(psi)[np.ix_(idx, idx)], atol=1e-9)
    pp = rt.prepare_propagator(_t(prop)).numpy()
    assert pp.dtype == np.complex64 and pp.flags.c_contiguous
    out = _dit_inverse(_dit_inverse((spectrum * pp / N**2).T).T)
    np.testing.assert_allclose(out, np.fft.ifft2(np.fft.fft2(psi) * prop), atol=1e-6)
    stack = rt.prepare_propagator(_t(np.stack([prop, 2 * prop])))
    assert torch.equal(stack[1], 2 * stack[0]) and torch.equal(stack[0], _t(pp))


# ---- gradients ---------------------------------------------------------------


def test_fused_grad_equals_jax(fields):
    """The loss of tests/test_pallas.py:341-375 through the fused engine: dV
    equals jax.grad's through the Pallas kernels, dpsi0 its conjugate
    (PyTorch's gradient of a complex tensor is the conjugate of JAX's)."""
    psi, v, prop = fields
    v_stack = np.stack([v, -0.3 * v, 0.7 * v])
    rng = np.random.default_rng(13)
    tgt = (rng.random(psi.shape) + 1j * rng.random(psi.shape)).astype(np.complex64)
    jstep = jprop.make_slice_step("fused", shape=(N, N), dtype=jnp.complex64)

    def jloss(p, vs):
        out = jprop.multislice(p, vs, jnp.asarray(prop), SIGMA, slice_step=jstep)
        return jnp.sum(jnp.abs(out - tgt) ** 2)

    want_p, want_v = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(psi), jnp.asarray(v_stack))
    p_t, v_t = _t(psi).requires_grad_(True), _t(v_stack).requires_grad_(True)
    step = tprop.make_slice_step("fused", shape=(N, N), dtype=torch.complex64)
    out = tprop.multislice(p_t, v_t, _t(prop), SIGMA, remat_chunk=1, slice_step=step)
    ((out - _t(tgt)).abs() ** 2).sum().backward()
    want_v, want_p = np.asarray(want_v), np.conj(np.asarray(want_p))
    np.testing.assert_allclose(v_t.grad.numpy(), want_v, rtol=2e-4,
                               atol=2e-4 * np.abs(want_v).max())
    np.testing.assert_allclose(p_t.grad.numpy(), want_p, rtol=2e-4,
                               atol=2e-4 * np.abs(want_p).max())


@pytest.mark.parametrize("batch,per_wave_p", [((), False), ((3,), False), ((3,), True)])
def test_fused_step_bwd_equals_autograd_and_function(fields, batch, per_wave_p):
    """The adjoint's plain version (what the backward kernel is held to on
    the card) equals autograd through the plain step, with dV summed over
    the batch; and the autograd.Function built on the two wrappers hands
    the same gradients on."""
    psi, v, prop = fields
    rng = np.random.default_rng(7)
    shape = (*batch, N, N)
    p = _t((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))
    g = _t((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64))
    pr = _t(prop)
    if per_wave_p:
        pr = torch.stack([pr, pr * np.exp(0.3j), pr.conj().resolve_conj()])
    p1, v1 = p.clone().requires_grad_(True), _t(v).requires_grad_(True)
    out = fs.fused_slice_step_ref(p1, v1, pr, SIGMA)
    want_p, want_v = torch.autograd.grad(out, (p1, v1), grad_outputs=g)
    got_p, got_v = fs.fused_step_bwd(p, _t(v), g, pr, SIGMA)
    assert got_v.shape == (N, N) and got_v.dtype == torch.float32
    for got, want in ((got_p, want_p), (got_v, want_v)):
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    p2, v2 = p.clone().requires_grad_(True), _t(v).requires_grad_(True)
    out2 = fs._FusedStep.apply(p2, v2, pr, None, SIGMA)
    fn_p, fn_v = torch.autograd.grad(out2, (p2, v2), grad_outputs=g)
    assert torch.equal(fn_p, got_p) and torch.equal(fn_v, got_v)


# ---- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fscan", "fscan_fast", "fscan_draft"])
def test_fscan_grad_true_raises(fields, kind):
    """grad=True (the default, as in fdes_tpu) gives the grad-capable engine
    on the whole-loop adjoint.  What raises under it is what the adjoint does
    not differentiate: a propagator that requires a gradient, and a per-wave
    potential under a gradient.  Nothing hands back a silent zero."""
    psi, v, prop = fields
    for step in (tprop.make_slice_step(kind, shape=(N, N), grad=True),
                 tprop.make_slice_step(kind, shape=(N, N))):
        assert isinstance(step, fsc.WholeScanEngine) and step.grad_capable and step.kind == kind
    vs = _t(np.stack([v, v]))
    with pytest.raises(NotImplementedError, match="propagator no gradient"):
        step.whole_scan(_t(psi), vs, _t(prop).requires_grad_(True), SIGMA)
    with pytest.raises(NotImplementedError, match="a per-wave V under a gradient"):
        step.whole_scan(_t(psi), torch.stack([vs, vs]).requires_grad_(True), _t(prop), SIGMA)
    v_t = vs.clone().requires_grad_(True)
    step.whole_scan(_t(psi), v_t, _t(prop), SIGMA).abs().pow(2).sum().backward()
    assert float(v_t.grad.abs().max()) > 0


@pytest.mark.parametrize("which", ["psi0", "v_stack", "propagator"])
def test_fscan_refuses_a_gradient_requiring_input(fields, which):
    """An engine made with grad=False is forward-only and its result carries
    no graph: it raises instead of handing a loss a silent zero gradient;
    under no_grad it runs."""
    psi, v, prop = fields
    args = {"psi0": _t(psi), "v_stack": _t(np.stack([v, v])), "propagator": _t(prop)}
    args[which].requires_grad_(True)
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=False)
    with pytest.raises(RuntimeError, match="forward-only"):
        tprop.multislice(args["psi0"], args["v_stack"], args["propagator"], SIGMA,
                         slice_step=step)
    with torch.no_grad():
        out = tprop.multislice(args["psi0"], args["v_stack"], args["propagator"], SIGMA,
                               slice_step=step)
    assert not out.requires_grad and bool(torch.isfinite(out.abs()).all())


def test_fscan_refuses_remat_and_per_slice_calls(fields):
    psi, v, prop = fields
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=False)
    assert step.kind == "fscan" and not step.grad_capable
    with pytest.raises(ValueError, match="forward-only"):
        tprop.multislice(_t(psi), _t(np.stack([v, v])), _t(prop), SIGMA, remat_chunk=1,
                         slice_step=step)
    with pytest.raises(TypeError, match="whole slice loop"):
        step(_t(psi), _t(v), _t(prop), SIGMA)


@pytest.mark.parametrize("kind", ["fused", "fused_fast", "fscan", "fscan_fast"])
@pytest.mark.parametrize(
    "shape,match", [((128, 256), "square"), ((64, 64), "supports axis sizes"),
                    ((384, 384), "supports axis sizes"), ((2048, 2048), "at most 1024")])
def test_sizes_rejected_like_jax(kind, shape, match):
    with pytest.raises(ValueError, match=match):
        tprop.make_slice_step(kind, shape=shape, grad=False)
    with pytest.raises(ValueError):
        jprop.make_slice_step(kind, shape=shape, dtype=jnp.complex64, grad=False)


@pytest.mark.parametrize("kind", ["fused", "fscan", "auto", "auto_fast"])
def test_shape_is_required(kind):
    with pytest.raises(ValueError, match="needs shape"):
        tprop.make_slice_step(kind, grad=False)


def test_fused_refuses_propagator_gradient(fields):
    psi, v, prop = fields
    step = tprop.make_slice_step("fused", shape=(N, N))
    with pytest.raises(NotImplementedError, match="no gradient"):
        step(_t(psi), _t(v), _t(prop).requires_grad_(True), SIGMA)


def test_fused_scan_rejects_bad_operands(fields):
    psi, v, prop = fields
    p, vs, pr = _t(psi), _t(np.stack([v, v])), _t(prop)
    with pytest.raises(ValueError, match="batch sizes differ"):
        fsc.fused_scan(torch.stack([p, p]), vs, torch.stack([pr, pr, pr]), SIGMA)
    with pytest.raises(ValueError, match="v_stack must be"):
        fsc.fused_scan(p, vs[0], pr, SIGMA)
    with pytest.raises(ValueError, match="propagator must be"):
        fsc.fused_scan(p, vs, pr[:64], SIGMA)
    with pytest.raises(TypeError, match="must be real"):
        fsc.fused_scan(p, vs.to(torch.complex64), pr, SIGMA)
    with pytest.raises(ValueError, match="g is"):
        fs.fused_step_bwd(p, vs[0], torch.stack([p, p]), pr, SIGMA)


# ---- auto ------------------------------------------------------------------


def test_auto_resolves_by_shape_grad_and_batch():
    """auto/auto_fast: on a grid the fused kernels take, a forward rollout
    and a gradient both go to the whole-loop engine (the gradient to its
    grad-capable form); at 2048^2 and 4096^2 both go to the panel engine
    (a gradient to its grad-capable form); other grids go to the kernels
    around the library FFT."""
    from fdes_tpu_torch.kernels.slice_step import pallas_slice_step

    for kind in ("auto", "auto_fast"):
        step = tprop.make_slice_step(kind, shape=(512, 512), grad=False, batch=16)
        assert isinstance(step, fsc.WholeScanEngine) and step.kind == "fscan"
        assert not step.grad_capable
        assert tprop._resolve_auto((512, 512)) == "fscan"
        grad_step = tprop.make_slice_step(kind, shape=(256, 256), grad=True)
        assert isinstance(grad_step, fsc.WholeScanEngine) and grad_step.grad_capable
        assert grad_step.kind == "fscan"
        assert tprop.make_slice_step(kind, shape=(96, 96), grad=False) is pallas_slice_step
        assert tprop.make_slice_step(kind, shape=(512, 512), dtype=torch.complex128,
                                     grad=False) is pallas_slice_step
        assert tprop.make_slice_step(kind, shape=(256, 512), grad=False) is pallas_slice_step
        for n in (2048, 4096):
            for batch in (1, 4):
                step = tprop.make_slice_step(kind, shape=(n, n), grad=False, batch=batch)
                assert isinstance(step, fsc.WholeScanEngine) and step.kind == "panel"
                assert not step.grad_capable
            grad_step = tprop.make_slice_step(kind, shape=(n, n), grad=True)
            assert isinstance(grad_step, fsc.WholeScanEngine) and grad_step.grad_capable
            assert grad_step.kind == "panel"
            assert tprop.make_slice_step(kind, shape=(n, n), dtype=torch.complex128,
                                         grad=False) is pallas_slice_step
        assert tprop.make_slice_step(kind, shape=(8192, 8192), grad=False) is pallas_slice_step


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU form")
    return torch.device("cuda")


def test_fused_kernels_match_plain_on_card(fields, cuda):
    psi, v, prop = fields
    p, vv, pr = _t(np.stack([psi, 1j * psi])).to(cuda), _t(v).to(cuda), _t(prop).to(cuda)
    g = p.flip(0).contiguous()
    want = fs.fused_slice_step_ref(p, vv, pr, SIGMA)
    got = fs.fused_step(p, vv, pr, SIGMA)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    for a, b in zip(fs.fused_step_bwd(p, vv, g, pr, SIGMA),
                    fs.fused_step_bwd_ref(p, vv, g, pr, SIGMA)):
        assert float((a - b).abs().max()) <= 2e-6 * float(b.abs().max())
    vs = torch.stack([vv, -0.3 * vv, 0.7 * vv])
    want = fsc.fused_scan_ref(p, vs, pr, SIGMA)
    got = fsc.fused_scan(p, vs, pr, SIGMA)
    assert float((got - want).abs().max()) <= 4e-6 * float(want.abs().max())
    with pytest.raises(TypeError, match="complex64"):
        fsc.fused_scan(p.to(torch.complex128), vs, pr, SIGMA)
    with pytest.raises(TypeError, match="complex64"):
        fs.fused_step(p.to(torch.complex128), vv, pr, SIGMA)
    with pytest.raises(ValueError, match="lazy conj"):
        fs.fused_step(p.conj(), vv, pr, SIGMA)
