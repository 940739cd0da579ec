"""The fused step's two routes (``STEP_ROUTE``: the tile kernels, or one
cooperative launch of ``wide_step_kernel``), its adjoint's one kernel
(``wide_step_bwd_kernel``) and the paths that reach them: the route table
and its reader (``route_row``, which every route table of the port reads
through), the ``route=`` argument, the launch counts, the ``fused`` engine
on a batch of
waves with one propagator per wave against fdes_tpu's Pallas step
(interpret mode, ``jax.vmap``), and the streamed forward that ``auto``
sends to the fused step.

On the CPU every route gives the plain version; the kernels are held to it
on the card (the last test here, and chip_smoke.py phase kernels_fused)."""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import potential as jpot  # noqa: E402
from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.specimen import SlicedAtoms  # noqa: E402
from fdes_tpu_torch import cli as tcli  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.kernels import _build  # noqa: E402
from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402
from fdes_tpu_torch.kernels.slice_step import pallas_slice_step  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
N = 128
B = 3
ATOL = 2e-5  # absolute, on O(1) waves: the tolerance of tests/test_pallas.py:341-459
GRAD_RTOL = 2e-4  # test_torch_fused.test_fused_grad_equals_jax's, relative to the peak


@pytest.fixture(autouse=True)
def _one_thread():
    """128^2 problems: one intra-op thread runs them as fast as many, and
    does not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def batch():
    """B waves, a real V, and one propagator per wave (a tilt series), as
    numpy arrays from a seed."""
    rng = np.random.default_rng(18)
    grid = Grid(ny=N, nx=N, py=0.3, px=0.3)
    psi = (rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N))).astype(np.complex64)
    v = (rng.normal(size=(N, N)) * 30.0).astype(np.float32)
    props = np.stack([fresnel_propagator(grid, wavelength_A(KV), 1.8, tilt_xy_rad=(t, 0.0))
                      for t in (0.0, 0.01, -0.02)]).astype(np.complex64)
    tgt = (rng.random((B, N, N)) + 1j * rng.random((B, N, N))).astype(np.complex64)
    return psi, v, props, tgt


# ---- the route table ---------------------------------------------------------


def test_step_route_is_the_table():
    """STEP_ROUTE covers the kernels' sizes and the measured wave counts
    (the 4-tilt series' four waves among them); step_route reads it by
    (n, b) alone: a measured count takes its row, a count between two rows
    the lower one, a count beyond the last the last row, and one below the
    first the first row."""
    assert set(fs.STEP_ROUTE) == set(fs.SIZES)
    for n, rows in fs.STEP_ROUTE.items():
        measured = sorted(rows)
        assert measured == [1, 3, 4, 8, 16, 64]
        assert set(rows.values()) <= set(fs.ROUTES)
        for b in measured:
            assert fs.step_route(n, b) == rows[b]
        for lo, hi in zip(measured, measured[1:]):
            assert all(fs.step_route(n, b) == rows[lo] for b in range(lo, hi))
        assert fs.step_route(n, 10 * measured[-1]) == rows[measured[-1]]
        assert fs.step_route(n, 0) == rows[measured[0]]


@pytest.mark.parametrize("table", ["STEP_ROUTE", "STORE_ROUTE", "SCAN_ROUTE", "PANEL_ROUTE"])
def test_every_route_table_reads_through_route_row(table):
    """The four route tables' readers share _runtime.route_row: each
    reader's answer at every count from 0 to past the last row is route_row's
    entry of the table's rows."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_scan as fsc
    from fdes_tpu_torch.kernels import panel_scan as ps

    tables = {
        "STEP_ROUTE": (fs.STEP_ROUTE, lambda n, b: fs.step_route(n, b)),
        "STORE_ROUTE": (adj.STORE_ROUTE, lambda n, b: (adj.store_route(n, b, "store"),
                                                       adj.store_route(n, b, "bwd_store"))),
        "SCAN_ROUTE": (fsc.SCAN_ROUTE, lambda n, b: fsc.scan_route(n, max(b, 1))),
        "PANEL_ROUTE": (ps.PANEL_ROUTE, lambda n, b: tuple(ps.panel_route(n, b, k)
                                                           for k in ps.KINDS)),
    }
    rows_by_n, reader = tables[table]
    for n, rows in rows_by_n.items():
        for b in range(0, 2 * max(rows) + 1):
            assert reader(n, b) == rt.route_row(rows, max(b, 1) if table == "SCAN_ROUTE" else b)


def test_route_argument_is_checked(batch):
    """route= takes "tile" or "wide" and nothing else, checked before the
    CPU dispatch; a CPU tensor goes to the plain version whatever the route,
    and moves no launch count; the adjoint, one kernel, takes no route."""
    psi, v, props, _ = (_t(a) for a in batch)
    g = psi.flip(0).contiguous()
    want = fs.fused_slice_step_ref(psi, v, props, SIGMA)
    want_b = fs.fused_step_bwd_ref(psi, v, g, props, SIGMA)
    fs.reset_launches()
    for route in (None, *fs.ROUTES):
        assert torch.equal(fs.fused_step(psi, v, props, SIGMA, route=route), want)
    got_b = fs.fused_step_bwd(psi, v, g, props, SIGMA)
    assert all(torch.equal(a, b) for a, b in zip(got_b, want_b))
    for bad in ("cluster", "scan", "", "Wide"):
        with pytest.raises(ValueError, match="route must be"):
            fs.fused_step(psi, v, props, SIGMA, route=bad)
    with pytest.raises(TypeError, match="route"):
        fs.fused_step_bwd(psi, v, g, props, SIGMA, route="wide")
    assert [w.launches for w in fs.WRAPPERS] == [0, 0]
    assert fs.fused_step.launches_by_route == {"tile": 0, "wide": 0}


def test_wide_kernels_are_built_from_the_shared_rows():
    """Both wide step kernels are in csrc/fused_step.cu; the row functions
    of the wide transform (wide_fwd_row, wide_bwd_row) and the partial dV
    sum live once, in csrc/fused_fft.cuh, which both sources include."""
    src = _build.SRC_DIR
    step, adjoint = ((src / f"{name}.cu").read_text() for name in ("fused_step", "adjoint_scan"))
    header = (src / "fused_fft.cuh").read_text()
    for kernel in ("wide_step_kernel", "wide_step_bwd_kernel"):
        assert f"__global__ void __launch_bounds__(kThreads) {kernel}(" in step
    for fn in ("void wide_fwd_row(", "void wide_bwd_row(", "void reduce_partials(",
               "int launch_cooperative("):
        assert fn in header
        assert fn not in step and fn not in adjoint
    for text in (step, adjoint):
        assert '#include "fused_fft.cuh"' in text


# ---- the runtime: one binding, one kernel query ------------------------------


class _FakeEntry:
    """A stand-in for a ctypes entry point: records its calls, fills a
    query's int array with 10, 11, ... and returns ``status``."""

    def __init__(self, status=0):
        self.calls, self.status = [], status

    def __call__(self, *args):
        self.calls.append(args)
        if isinstance(args[-1], ctypes.c_void_p):
            out = ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))
            for i in range(4):
                out[i] = 10 + i
        return self.status


class _FakeLibrary:
    def __init__(self, status=0):
        self.fdes_fake_c64 = _FakeEntry(status)
        self.fdes_fake_info = _FakeEntry()
        self.loads = 0

    def fdes_error_string(self, status):
        return b"fake error"


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()

    def load(name):
        assert name == "fake"
        lib.loads += 1
        return lib

    monkeypatch.setattr(rt._build, "load", load)
    monkeypatch.setattr(rt, "_bound", {})
    monkeypatch.setattr(rt, "_infos", {})
    return lib


def test_a_launch_binds_once_and_passes_the_card_and_its_stream(fake_library, monkeypatch):
    """The runtime's one binding: an entry point is bound to its argtypes
    once, called as (device index, *args, the current stream), and a
    non-zero status raises with the library's message."""
    argtypes = {"fdes_fake_c64": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
    streams = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: streams.append(device) or types.SimpleNamespace(
                            cuda_stream=1234))
    dev = torch.device("cuda", 3)
    for k in range(2):
        rt.launch("fake", argtypes, "fdes_fake_c64", dev, k)
    entry = fake_library.fdes_fake_c64
    assert entry.calls == [(3, 0, 1234), (3, 1, 1234)] and streams == [dev, dev]
    assert fake_library.loads == 1 and entry.argtypes == argtypes["fdes_fake_c64"]
    entry.status = 7
    with pytest.raises(RuntimeError, match=r"fdes_fake_c64: CUDA error 7 \(fake error\)"):
        rt.launch("fake", argtypes, "fdes_fake_c64", dev, 2)


def test_a_kernel_query_is_read_once_per_entry_card_and_arguments(fake_library):
    """The runtime's one kernel query: the entry point's int array read into
    named fields, queried once per (entry point, card, arguments) and
    shared; no stream is passed."""
    argtypes = {"fdes_fake_info": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
    query = fake_library.fdes_fake_info
    first = rt.kernel_info("fake", argtypes, "fdes_fake_info", rt.BLOCKS, torch.device("cuda", 0),
                           512)
    assert first == {"registers": 10, "shared_bytes": 11, "local_bytes": 12,
                     "resident_blocks": 13}
    assert rt.kernel_info("fake", argtypes, "fdes_fake_info", rt.BLOCKS,
                          torch.device("cuda", 0), 512) is first
    assert len(query.calls) == 1 and query.calls[0][:2] == (0, 512)
    rt.kernel_info("fake", argtypes, "fdes_fake_info", rt.BLOCKS, torch.device("cuda", 1), 512)
    rt.kernel_info("fake", argtypes, "fdes_fake_info", rt.BLOCKS, torch.device("cuda", 0), 256)
    assert [c[:2] for c in query.calls] == [(0, 512), (1, 512), (0, 256)]
    assert fake_library.loads == 1


# ---- the fused engine on a batch with one propagator per wave ---------------


def _jax_step():
    return jprop.make_slice_step("fused", shape=(N, N), dtype=jnp.complex64)


def test_batch_per_wave_p_forward_equals_jax_vmap(batch):
    """B = 3 waves through the fused engine's step, one propagator per
    wave: jax.vmap over the Pallas step (interpret mode)."""
    psi, v, props, _ = batch
    jstep = _jax_step()
    want = jax.vmap(lambda p, pr: jstep(p, jnp.asarray(v), pr, SIGMA))(
        jnp.asarray(psi), jnp.asarray(props))
    step = tprop.make_slice_step("fused", shape=(N, N), dtype=torch.complex64)
    with torch.no_grad():
        got = step(_t(psi), _t(v), _t(props), SIGMA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_batch_per_wave_p_gradient_equals_jax_vmap(batch):
    """The gradient of a loss over B = 3 waves, one propagator per wave,
    through the fused engine's step: dV (summed over the waves) equals
    jax.grad's through the vmapped Pallas step and its adjoint kernel, dpsi
    its conjugate (PyTorch's gradient of a complex tensor)."""
    psi, v, props, tgt = batch
    jstep = _jax_step()

    def jloss(p, vv):
        out = jax.vmap(lambda a, pr: jstep(a, vv, pr, SIGMA))(p, jnp.asarray(props))
        return jnp.sum(jnp.abs(out - tgt) ** 2)

    want_p, want_v = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(psi), jnp.asarray(v))
    p_t, v_t = _t(psi).requires_grad_(True), _t(v).requires_grad_(True)
    step = tprop.make_slice_step("fused", shape=(N, N), dtype=torch.complex64)
    ((step(p_t, v_t, _t(props), SIGMA) - _t(tgt)).abs() ** 2).sum().backward()
    want_v, want_p = np.asarray(want_v), np.conj(np.asarray(want_p))
    assert v_t.grad.shape == (N, N)
    np.testing.assert_allclose(v_t.grad.numpy(), want_v, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want_v).max())
    np.testing.assert_allclose(p_t.grad.numpy(), want_p, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want_p).max())


# ---- the streamed forward on auto --------------------------------------------


def _streamed_engine(n, dtype, engine="auto"):
    cfg = types.SimpleNamespace(sim=types.SimpleNamespace(engine=engine))
    sim = types.SimpleNamespace(grid=types.SimpleNamespace(shape=(n, n)), cdtype=dtype)
    step = tprop.make_slice_step(engine, shape=(n, n), dtype=dtype, grad=False)
    return tcli._streamed_step(cfg, sim, step)


@pytest.mark.parametrize("n,dtype,engine,want", [
    (128, torch.complex64, "auto", "fused"),
    (1024, torch.complex64, "auto_fast", "fused"),
    (128, torch.complex128, "auto", "pallas"),
    (2048, torch.complex64, "auto", "panel"),
])
def test_streamed_step_on_auto_resolves(n, dtype, engine, want):
    """cli._streamed_step: ``auto`` streams on the per-slice fused step
    where ``fscan`` would take the grid in complex64, on ``pallas`` in
    complex128, and keeps ``panel`` at 2048^2."""
    step = _streamed_engine(n, dtype, engine)
    if want == "fused":
        assert step.__module__ == fs.__name__ and step.__qualname__.startswith(
            "make_fused_slice_step")
    elif want == "pallas":
        assert step is pallas_slice_step
    else:
        assert getattr(step, "kind", None) == "panel"


def test_streamed_forward_on_auto_equals_jax():
    """The streamed rollout at 128^2 (40 random Si and Ga atoms in 3 slices)
    on the step ``auto`` resolves to: JAX's multislice_streamed on its fused
    Pallas step (interpret mode)."""
    rng = np.random.default_rng(5)
    nat, s = 40, 3
    grid = Grid(N, N, 0.21, 0.23)
    sliced = SlicedAtoms(
        x=rng.uniform(0, N * 0.23, nat), y=rng.uniform(0, N * 0.21, nat),
        slice_idx=rng.integers(0, s, nat).astype(np.int32),
        species_idx=rng.integers(0, 2, nat).astype(np.int32), weight=np.ones(nat),
        species=((14, 0.4), (31, 0.6)), nslices=s, dz=1.9,
    )
    x, y, sp, w, _ = jpot.pad_atoms_per_slice(sliced, np.float32)
    ff = jpot.species_factors_rfft(grid, sliced.species).astype(np.float32)
    prop = fresnel_propagator(grid, wavelength_A(KV), sliced.dz).astype(np.complex64)
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    want = np.asarray(jprop.multislice_streamed(
        jnp.ones(grid.shape, jnp.complex64), tuple(jnp.asarray(a) for a in (x, y, sp, w)),
        jnp.asarray(ff), jnp.asarray(prop), SIGMA, slice_step=_jax_step(), **kw))
    step = _streamed_engine(N, torch.complex64)
    with torch.no_grad():
        got = tprop.multislice_streamed(
            torch.ones(grid.shape, dtype=torch.complex64), tuple(_t(a) for a in (x, y, sp, w)),
            _t(ff), _t(prop), SIGMA, slice_step=step, **kw).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max())


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU form")
    return torch.device("cuda")


def test_wide_step_kernels_match_plain_on_card(batch, cuda):
    """Both routes of the step and the adjoint against the plain versions,
    shared and per-wave P, one launch counted a call (the step's on its
    route); the adjoint's dV (three waves: three wave groups, summed in
    order) the same bits over two runs."""
    psi, v, props, _ = (_t(a).to(cuda) for a in batch)
    g = psi.flip(0).contiguous()
    tol = 2e-6
    for pr in (props[0], props):
        want = fs.fused_slice_step_ref(psi, v, pr, SIGMA)
        want_b = fs.fused_step_bwd_ref(psi, v, g, pr, SIGMA)
        for route in fs.ROUTES:
            fs.reset_launches()
            got = fs.fused_step(psi, v, pr, SIGMA, route=route)
            got_b = fs.fused_step_bwd(psi, v, g, pr, SIGMA)
            assert fs.fused_step.launches_by_route[route] == 1
            assert [w.launches for w in fs.WRAPPERS] == [1, 1]
            for a, b in zip((got, *got_b), (want, *want_b)):
                assert float((a - b).abs().max()) <= tol * float(b.abs().max())
        one = fs.fused_step_bwd(psi, v, g, pr, SIGMA)
        two = fs.fused_step_bwd(psi, v, g, pr, SIGMA)
        assert torch.equal(one[1], two[1]) and torch.equal(one[0], two[0])
    with pytest.raises(TypeError, match="complex64"):
        fs.fused_step(psi.to(torch.complex128), v, props, SIGMA, route="wide")
