"""The port's multislice against the f64 golden and fdes_tpu.propagate,
values and gradients (PyTorch's gradient of a complex tensor is the
conjugate of what jax.grad returns)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.golden import golden_multislice  # noqa: E402
from fdes_tpu.grids import fresnel_propagator  # noqa: E402
from fdes_tpu.pallas.slice_step import pallas_slice_step as jax_pallas_step  # noqa: E402
from fdes_tpu.potential import build_potential  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
LAM = wavelength_A(KV)
REAL = {np.complex64: np.float32, np.complex128: np.float64}
# rel-norm tolerance against fdes_tpu at the working precision: the same
# rollout through two FFT libraries
TOL = {np.complex64: 1e-5, np.complex128: 1e-12}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def config1_potential(si110_config1):
    _, grid, sliced = si110_config1
    return np.array(build_potential(sliced, grid, dtype=jnp.float64))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_config1_exit_wave_c64_gate(si110_config1, config1_potential, engine):
    """The gate of tests/test_multislice.py: config-1 c64 exit wave within
    1e-5 of the f64 golden pipeline."""
    _, grid, sliced = si110_config1
    gold = golden_multislice(
        np.ones(grid.shape, np.complex128), config1_potential, grid, KV, sliced.dz
    )
    prop = torch.as_tensor(fresnel_propagator(grid, LAM, sliced.dz).astype(np.complex64))
    psi = tprop.multislice(
        torch.ones(grid.shape, dtype=torch.complex64),
        torch.as_tensor(config1_potential.astype(np.float32)), prop, SIGMA,
        slice_step=tprop.make_slice_step(engine),
    )
    assert psi.dtype == torch.complex64
    rel = _rel(psi.numpy(), gold)
    assert rel < 1e-5, f"config-1 c64 exit-wave rel-err {rel:.2e} exceeds 1e-5"


@pytest.fixture(scope="module")
def small_inputs(si110_small):
    _, grid, sliced = si110_small
    v = np.array(build_potential(sliced, grid, dtype=jnp.float64))
    prop = fresnel_propagator(grid, LAM, sliced.dz)
    return v, prop


@pytest.mark.parametrize("absorptive", [False, True])
@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_multislice_equals_jax(small_inputs, engine, cdt, absorptive):
    v, prop = small_inputs
    if absorptive:
        v = v + 1j * 0.1 * np.abs(v)
    vdt = cdt if absorptive else REAL[cdt]
    psi0 = np.ones(v.shape[1:], cdt)
    jstep = None
    if engine == "pallas":
        def jstep(p, vs, pr, s):
            return jax_pallas_step(p, vs, pr, s, interpret=True)
    want = jprop.multislice(
        jnp.asarray(psi0), jnp.asarray(v.astype(vdt)), jnp.asarray(prop.astype(cdt)), SIGMA,
        slice_step=jstep,
    )
    got = tprop.multislice(
        torch.as_tensor(psi0), torch.as_tensor(v.astype(vdt)),
        torch.as_tensor(prop.astype(cdt)), SIGMA, slice_step=tprop.make_slice_step(engine),
    )
    assert got.dtype == torch.as_tensor(psi0).dtype
    assert _rel(got.numpy(), want) <= TOL[cdt]


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_thickness_series_equals_prefix_rollouts_and_jax(small_inputs, engine):
    v, prop = small_inputs
    psi0 = torch.ones(v.shape[1:], dtype=torch.complex128)
    vt, pt = torch.as_tensor(v), torch.as_tensor(prop)
    step = tprop.make_slice_step(engine)
    series = tprop.multislice_thickness_series(psi0, vt, pt, SIGMA, every=2, slice_step=step)
    assert tuple(series.shape) == (4, *v.shape[1:])
    for k in range(4):
        prefix = tprop.multislice(psi0, vt[: 2 * (k + 1)], pt, SIGMA, slice_step=step)
        assert torch.equal(series[k], prefix)
    want = jprop.multislice_thickness_series(
        jnp.asarray(psi0.numpy()), jnp.asarray(v), jnp.asarray(prop), SIGMA, every=2
    )
    assert _rel(series.numpy(), want) <= 1e-12
    with pytest.raises(ValueError):
        tprop.multislice_thickness_series(psi0, vt, pt, SIGMA, every=3)


def test_batched_tilt_rollout_equals_one_by_one(small_inputs, si110_small):
    _, grid, sliced = si110_small
    v, _ = small_inputs
    tilts = [(0.0, 0.0), (2e-3, 0.0), (0.0, -3e-3)]
    props = torch.as_tensor(np.stack(
        [fresnel_propagator(grid, LAM, sliced.dz, tilt_xy_rad=t) for t in tilts]
    ).astype(np.complex64))
    psi0 = torch.ones((3, *grid.shape), dtype=torch.complex64)
    vt = torch.as_tensor(v.astype(np.float32))
    step = tprop.make_slice_step("pallas")
    batched = tprop.multislice(psi0, vt, props, SIGMA, slice_step=step)
    for i in range(3):
        one = tprop.multislice(psi0[i], vt, props[i], SIGMA, slice_step=step)
        assert _rel(batched[i].numpy(), one.numpy()) <= 1e-6


def _grads(v, prop, psi0, engine, remat_chunk):
    """d/dV and d/dpsi0 of sum |exit wave|^2 * w through the port."""
    v_t = torch.as_tensor(v).requires_grad_(True)
    p_t = torch.as_tensor(psi0).requires_grad_(True)
    out = tprop.multislice(p_t, v_t, torch.as_tensor(prop), SIGMA, remat_chunk=remat_chunk,
                           slice_step=tprop.make_slice_step(engine))
    w = torch.linspace(0.5, 1.5, out.numel(), dtype=torch.float64).reshape(out.shape)
    (out.abs() ** 2 * w).sum().backward()
    return v_t.grad, p_t.grad


def test_remat_chunk_rejected_until_training(small_inputs):
    """remat_chunk 1, 2 and S give the no-remat gradient on both engines; a
    chunk that does not divide S is rejected."""
    v, prop = small_inputs
    psi0 = np.ones(v.shape[1:], np.complex128)
    for engine in ("xla", "pallas"):
        want = _grads(v, prop, psi0, engine, None)
        for chunk in (1, 2, v.shape[0]):
            got = _grads(v, prop, psi0, engine, chunk)
            for a, b in zip(got, want):
                assert _rel(a.numpy(), b.numpy()) <= 1e-12
    with pytest.raises(ValueError, match="divide"):
        _grads(v, prop, psi0, "pallas", 3)


@pytest.mark.parametrize("absorptive", [False, True])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_multislice_grad_equals_jax(small_inputs, si110_small, engine, absorptive):
    """A tilt batch of waves through one V: dV equals jax.grad's, dpsi0 (and
    a complex V's gradient) its conjugate, at remat 2."""
    _, grid, sliced = si110_small
    v, _ = small_inputs
    if absorptive:
        v = v + 1j * 0.1 * np.abs(v)
    tilts = [(0.0, 0.0), (2e-3, -1e-3)]
    props = np.stack([fresnel_propagator(grid, LAM, sliced.dz, tilt_xy_rad=t) for t in tilts])
    rng = np.random.default_rng(5)
    psi0 = np.exp(1j * rng.uniform(0, 0.3, size=(2, *grid.shape)))
    got_v, got_p = _grads(v, props, psi0, engine, 2)

    def loss(vv, pp):
        out = jax.vmap(lambda p0, pr: jprop.multislice(p0, vv, pr, SIGMA, remat_chunk=2))(
            pp, jnp.asarray(props))
        w = jnp.linspace(0.5, 1.5, out.size).reshape(out.shape)
        return jnp.sum(jnp.abs(out) ** 2 * w)

    want_v, want_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(psi0))
    assert _rel(got_v.numpy(), np.conj(want_v) if absorptive else want_v) <= 1e-10
    assert _rel(got_p.numpy(), np.conj(want_p)) <= 1e-10


def _graph_kinds(out: torch.Tensor, leaf: torch.Tensor) -> tuple[list[str], list[str]]:
    """(the kinds of the nodes reachable from out's grad_fn, the kinds of the
    nodes that hand their gradient to ``leaf``'s accumulator).  A select or
    slice counts by its input's shape, ``SelectBackward0 of (8, 64, 64)``:
    ``.real``/``.imag`` of a complex slice are selects too."""
    kinds, into_leaf, seen, todo = [], [], set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        kind = type(node).__name__
        if kind in ("SelectBackward0", "SliceBackward0"):
            kind += f" of {tuple(node._saved_self_sym_sizes)}"
        kinds.append(kind)
        for nxt, _ in node.next_functions:
            if nxt is not None and getattr(nxt, "variable", None) is leaf:
                into_leaf.append(type(node).__name__)
            todo.append(nxt)
    return kinds, into_leaf


def _sliced_multislice(psi0, v_stack, propagator, sigma, remat_chunk, step):
    """multislice's per-slice loop as it stood before V was split once: a
    slice of V per chunk and a select of it per step (each one's backward
    zero-fills a full-size dV and adds it into V's)."""
    def run(psi, v_chunk):
        for j in range(v_chunk.shape[0]):
            psi = step(psi, v_chunk[j], propagator, sigma)
        return psi

    s = v_stack.shape[0]
    if not remat_chunk:
        return run(psi0, v_stack)
    psi = psi0
    for j in range(0, s, remat_chunk):
        psi = torch.utils.checkpoint.checkpoint(run, psi, v_stack[j : j + remat_chunk],
                                                use_reentrant=False)
    return psi


@pytest.mark.parametrize("absorptive", [False, True])
@pytest.mark.parametrize("remat", [None, 2])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_per_slice_loop_hands_v_over_once(small_inputs, engine, remat, absorptive):
    """V reaches the per-slice steps through one unbind (and, with remat, one
    split into chunks): no SelectBackward0 or SliceBackward0 on V's path,
    each slice's dV lands once, and dV is the same bits as the old slicing's."""
    v, prop = small_inputs
    if absorptive:
        v = v + 1j * 0.1 * np.abs(v)
    step = tprop.make_slice_step(engine) or tprop.default_slice_step
    rng = np.random.default_rng(7)
    psi0 = torch.as_tensor(np.exp(1j * rng.uniform(0, 0.3, size=v.shape[1:])))
    pt = torch.as_tensor(prop)
    w = torch.linspace(0.5, 1.5, psi0.numel(), dtype=torch.float64).reshape(psi0.shape)
    grads, graphs = [], []
    for rollout in (
        lambda vv: tprop.multislice(psi0, vv, pt, SIGMA, remat_chunk=remat, slice_step=step),
        lambda vv: _sliced_multislice(psi0, vv, pt, SIGMA, remat, step),
    ):
        v_t = torch.as_tensor(v).requires_grad_(True)
        out = rollout(v_t)
        graphs.append(_graph_kinds(out, v_t))
        (out.abs() ** 2 * w).sum().backward()
        grads.append(v_t.grad)
    (kinds, into_v), (old_kinds, _) = graphs
    of_v = [f"{k} of {v.shape}" for k in ("SelectBackward0", "SliceBackward0")]
    assert not [k for k in kinds if k in of_v]
    assert into_v == ["SplitBackward0" if remat else "UnbindBackward0"]
    assert kinds.count("UnbindBackward0") == (v.shape[0] // remat if remat else 1)
    # the old slicing, for contrast: a select of V per slice, or a slice of V
    # per chunk
    assert old_kinds.count(of_v[1] if remat else of_v[0]) == v.shape[0] // (remat or 1)
    assert grads[0].dtype == grads[1].dtype and torch.equal(grads[0], grads[1])


def test_thickness_series_hands_v_over_once(small_inputs):
    """The per-slice thickness series unbinds V once too: one node hands V
    its gradient."""
    v, prop = small_inputs
    v_t = torch.as_tensor(v + 1j * 0.1 * np.abs(v)).requires_grad_(True)
    series = tprop.multislice_thickness_series(
        torch.ones(v.shape[1:], dtype=torch.complex128), v_t, torch.as_tensor(prop), SIGMA,
        every=2, slice_step=tprop.make_slice_step("pallas"))
    kinds, into_v = _graph_kinds(series, v_t)
    assert f"SelectBackward0 of {v.shape}" not in kinds and into_v == ["UnbindBackward0"]


@pytest.mark.parametrize("nslices", [1, 2, 4, 7, 12, 16, 64, 100])
def test_pick_remat_chunk_equals_jax(nslices):
    assert tprop.pick_remat_chunk(nslices) == jprop.pick_remat_chunk(nslices)


def test_make_slice_step_kinds():
    from fdes_tpu_torch.kernels.slice_step import pallas_slice_step

    assert tprop.make_slice_step("xla") is None
    assert tprop.make_slice_step("pallas") is pallas_slice_step
    for kind in ("auto", "auto_fast"):  # a grid the fused kernels do not take
        assert tprop.make_slice_step(kind, shape=(96, 96)) is pallas_slice_step
    for kind in ("mxu", "mxu_fast", "mxu4", "radix", "radix_fast"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tprop.make_slice_step(kind)
    for kind in ("panel", "panel_fast"):
        step = tprop.make_slice_step(kind, shape=(256, 256))
        assert hasattr(step, "whole_scan") and step.kind == kind and step.grad_capable
        step = tprop.make_slice_step(kind, shape=(256, 256), grad=False)
        assert hasattr(step, "whole_scan") and step.kind == kind and not step.grad_capable
    for kind in ("fused", "fused_fast"):
        assert callable(tprop.make_slice_step(kind, shape=(128, 128)))
    for kind in ("fscan", "fscan_fast", "fscan_draft"):
        assert hasattr(tprop.make_slice_step(kind, shape=(128, 128), grad=False), "whole_scan")
    with pytest.raises(ValueError):
        tprop.make_slice_step("nope")
