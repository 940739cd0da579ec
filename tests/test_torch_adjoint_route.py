"""The wide kernels of the whole-loop adjoint's store pair
(``wide_scan_store_kernel``, ``wide_scan_bwd_store_kernel`` in
csrc/adjoint_scan.cu, their transform in csrc/fused_fft.cuh) as a plain-torch
model of their index maps, and the route between them and the tile kernels.

The model follows the kernels' data: warp w of a pair, lane l and register m
hold element l + 32 m + (n/2) w of a row or column; the stage of half size
n/2 exchanges the two warps' values through the pair's buffer, the register
stages and the five shuffle stages follow in the kernels' order, each
thread computing its own half of a butterfly from its partner's value (the
other warp's, or lane l ^ h's), with twiddles read from the staged table as
the kernels build it; a column item is four columns of a plane, loaded into
a padded shared tile by the kernels' thread map.  It is held against
``torch.fft.fft2`` in complex128, and its store recursion (forward with the
s stack, reverse with dV summed over wave groups) in complex64 against the
JAX package's store pair in interpret mode.  The kernels themselves are held
against the plain versions on the card (the last test here, and
chip_smoke.py's kernels_adjoint phase)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.pallas import adjoint_scan as jadj  # noqa: E402
from fdes_tpu_torch.kernels import _build  # noqa: E402
from fdes_tpu_torch.kernels import adjoint_scan as adj  # noqa: E402
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402

SIGMA = interaction_sigma(300e3)
EXACT = 1e-12  # complex128: the model against torch.fft, max |d| / max |ref|
ATOL = 2e-5  # times max|.|: the tolerance of tests/test_torch_adjoint_scan.py
LANES = 32
COLS = adj.PAIRS_PER_BLOCK  # columns of a column item, one a pair of warps
PAD = 4  # Warp<L>::kColStride - N


@pytest.fixture(autouse=True)
def _one_thread():
    """Small problems: one intra-op thread, no contention between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(n: int, b: int, nslices: int, seed: int, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(b, n, n)) + 1j * rng.normal(size=(b, n, n))
    v = rng.normal(size=(nslices, n, n)) * 30.0
    prop = fresnel_propagator(Grid(ny=n, nx=n, py=0.3, px=0.3), wavelength_A(300e3), 1.8)
    real = np.float64 if dtype == np.complex128 else np.float32
    return psi.astype(dtype), v.astype(real), prop.astype(dtype)


# ---- the model ---------------------------------------------------------------


def _staged_twiddles(n: int, dtype) -> torch.Tensor:
    """init_staged_twiddles: tw[hs - 1 + jj] = exp(-2 pi i jj / (2 hs)) for
    hs = 1, 2, ..., n/2 and jj < hs (n - 1 entries)."""
    i = np.arange(n - 1)
    hs = 1 << np.floor(np.log2(i + 1)).astype(np.int64)
    return torch.as_tensor(np.exp(-1j * np.pi * (i + 1 - hs) / hs)).to(dtype)


_LANE = torch.arange(LANES)


def _to_wide(rows: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., 2, 32, R): warp w, lane l, register m hold element
    l + 32 m + (n/2) w."""
    n = rows.shape[-1]
    return rows.reshape(*rows.shape[:-1], 2, n // (2 * LANES), LANES).transpose(-1, -2)


def _from_wide(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2).reshape(*x.shape[:-3], -1)


def _shuffle(x: torch.Tensor, h: int) -> torch.Tensor:
    """__shfl_xor_sync(x, h) of every register: lane l gets lane l ^ h's."""
    return x[..., _LANE ^ h, :]


def _exchange(x: torch.Tensor) -> torch.Tensor:
    """wide_exchange: each warp writes its values to the pair's buffer at
    (n/2) w + l + 32 m and reads the other warp's places."""
    r = x.shape[-1]
    half = LANES * r
    places = (_LANE[:, None] + 32 * torch.arange(r)[None, :])  # (32, R)
    buf = torch.full((*x.shape[:-3], 2 * half), float("nan"), dtype=x.dtype)
    for w in (0, 1):
        buf[..., half * w + places] = x[..., w, :, :]
    assert not bool(buf.isnan().any())  # the two warps fill the buffer's n places
    return torch.stack([buf[..., half * (1 - w) + places] for w in (0, 1)], dim=-3)


_UPPER = torch.tensor([1.0, -1.0])  # the sign of each warp's own value


def _wide_forward(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """wide_fft_forward on (..., 2, 32, R): natural in, position l + 32 m +
    (n/2) w holds frequency bitrev_n(that position)."""
    r = x.shape[-1]
    n = 2 * LANES * r
    log2n = n.bit_length() - 1
    places = _LANE[:, None] + 32 * torch.arange(r)[None, :]
    sign = _UPPER.to(x.real.dtype)[:, None, None]
    w_upper = torch.stack([torch.ones_like(places, dtype=x.dtype), tw[n // 2 - 1 + places]])
    x = (sign * x + _exchange(x)) * w_upper  # half size n/2: lower a + b, upper (a - b) w
    for b in range(log2n - 2, 4, -1):  # registers m, m + d
        d = 1 << (b - 5)
        for m in range(r):
            if m & d:
                continue
            w = tw[(1 << b) - 1 + _LANE + 32 * (m & (d - 1))]
            a, c = x[..., m].clone(), x[..., m + d].clone()
            x[..., m], x[..., m + d] = a + c, (a - c) * w
    for b in range(4, -1, -1):  # lanes l, l ^ h
        h = 1 << b
        upper = (_LANE & h) != 0
        w = torch.where(upper, tw[h - 1 + (_LANE & (h - 1))], torch.ones((), dtype=x.dtype))
        lane_sign = torch.where(upper, -1.0, 1.0).to(x.real.dtype)
        x = (lane_sign[:, None] * x + _shuffle(x, h)) * w[:, None]
    return x


def _wide_inverse(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """wide_fft_inverse: bit-reversed in, natural out, unscaled."""
    r = x.shape[-1]
    n = 2 * LANES * r
    log2n = n.bit_length() - 1
    for b in range(5):  # lanes: the upper lane forms b conj(w) before the exchange
        h = 1 << b
        upper = (_LANE & h) != 0
        w = torch.where(upper, tw[h - 1 + (_LANE & (h - 1))].conj(),
                        torch.ones((), dtype=x.dtype))
        lane_sign = torch.where(upper, -1.0, 1.0).to(x.real.dtype)
        y = x * w[:, None]
        x = lane_sign[:, None] * y + _shuffle(y, h)
    x = x.clone()
    for b in range(5, log2n - 1):  # registers m, m + d
        d = 1 << (b - 5)
        for m in range(r):
            if m & d:
                continue
            w = tw[(1 << b) - 1 + _LANE + 32 * (m & (d - 1))]
            a, t = x[..., m].clone(), x[..., m + d] * w.conj()
            x[..., m], x[..., m + d] = a + t, a - t
    places = _LANE[:, None] + 32 * torch.arange(r)[None, :]
    w_upper = torch.stack([torch.ones_like(places, dtype=x.dtype), tw[n // 2 - 1 + places].conj()])
    y = x * w_upper  # half size n/2: the upper warp forms b conj(w) first
    return _UPPER.to(x.real.dtype)[:, None, None] * y + _exchange(y)


def _col_load_map(n: int) -> list[tuple[int, int, int, int]]:
    """wide_col_item's load loop: for thread index i (< 2n, in steps of the
    block) the 16-byte pair at row y, columns c, c + 1 of the item, and the
    tile places it goes to: (y, c, place of c, place of c + 1)."""
    stride = n + PAD
    out = []
    for i in range(2 * n):
        y, c = i >> 1, 2 * (i & 1)
        out.append((y, c, c * stride + y, (c + 1) * stride + y))
    return out


def _col_item(plane: torch.Tensor, c0: int, prepared: torch.Tensor, conj_p: bool, tw):
    """One column item of wide_col_item on (..., n, n) (returns a copy):
    columns c0 .. c0 + 3 through the padded tile, one pair of warps a
    column."""
    n = plane.shape[-1]
    stride = n + PAD
    tile = torch.zeros(*plane.shape[:-2], COLS * stride, dtype=plane.dtype)
    rows, cols, places = [], [], []
    for y, c, pa, pb in _col_load_map(n):
        rows += [y, y]
        cols += [c0 + c, c0 + c + 1]
        places += [pa, pb]
    rows, cols, places = (torch.tensor(t) for t in (rows, cols, places))
    tile[..., places] = plane[..., rows, cols]
    out = plane.clone()
    for pair in range(COLS):  # pair j transforms column j in its place of the tile
        x = _to_wide(tile[..., pair * stride: pair * stride + n])
        x = _wide_forward(x, tw)
        p = _to_wide(prepared[..., :, c0 + pair]) / (n * n)
        x = _wide_inverse(x * (p.conj() if conj_p else p), tw)
        tile[..., pair * stride: pair * stride + n] = _from_wide(x)
    out[..., rows, cols] = tile[..., places]
    return out


def _col_pass(plane, prepared, conj_p, tw):
    for c0 in range(0, plane.shape[-1], COLS):
        plane = _col_item(plane, c0, prepared, conj_p, tw)
    return plane


def _rows_forward(plane, tw):
    return _from_wide(_wide_forward(_to_wide(plane), tw))


def _rows_inverse(plane, tw):
    return _from_wide(_wide_inverse(_to_wide(plane), tw))


def _transmit(psi, v, sigma, conj=False):
    phase = v.to(psi.real.dtype) * sigma
    return psi * torch.complex(torch.cos(phase), -torch.sin(phase) if conj else torch.sin(phase))


def _model_store(psi0, v_stack, prepared, sigma):
    """wide_scan_store_kernel: (exit waves, s (B, S, n, n)).  The plane between
    passes is what the kernel keeps in its output: x spectrum bit-reversed
    after a row pass, y too inside a column item."""
    n = psi0.shape[-1]
    tw = _staged_twiddles(n, psi0.dtype)
    work, kept = psi0, []
    for k, v in enumerate(v_stack):
        psi = _rows_inverse(work, tw) if k else work
        s = _transmit(psi, v, sigma)
        kept.append(s)
        work = _col_pass(_rows_forward(s, tw), prepared, False, tw)
    return _rows_inverse(work, tw), torch.stack(kept, dim=1)


def _model_bwd_store(s, v_stack, prepared, g, sigma, groups):
    """wide_scan_bwd_store_kernel: (dV, dpsi0), dV summed over the waves of
    each of ``groups`` wave groups in order, then over the groups in order."""
    b, nslices, n = s.shape[0], s.shape[1], s.shape[-1]
    tw = _staged_twiddles(n, g.dtype)
    per = -(-b // groups)
    bar = _rows_forward(g, tw)
    dv = torch.empty(v_stack.shape, dtype=g.real.dtype)
    for k in range(nslices - 1, -1, -1):
        bar = _col_pass(bar, prepared, True, tw)
        bar_s = _rows_inverse(bar, tw)
        parts = []
        for g0 in range(0, b, per):
            acc = torch.zeros(n, n, dtype=g.real.dtype)
            for w in range(g0, min(g0 + per, b)):
                acc = acc + (bar_s[w] * s[w, k].conj()).imag
            parts.append(sigma * acc)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        dv[k] = total
        bar = _transmit(bar_s, v_stack[k], sigma, conj=True)
        if k:
            bar = _rows_forward(bar, tw)
    return dv, bar


# ---- the index maps against torch.fft ----------------------------------------


@pytest.mark.parametrize("n", [128, 256, 512])
def test_wide_transforms_are_the_dft(n):
    """The forward wide transform of rows is their DFT at bit-reversed
    positions; the inverse takes it back (times n), in complex128."""
    psi = torch.as_tensor(_fields(n, 1, 1, seed=n)[0][0, :8])
    tw = _staged_twiddles(n, psi.dtype)
    got = _rows_forward(psi, tw)
    want = torch.fft.fft(psi, dim=-1)[..., fs.bit_reversal(n)]
    assert float((got - want).abs().max()) <= EXACT * float(want.abs().max())
    back = _rows_inverse(got, tw)
    assert float((back - n * psi).abs().max()) <= EXACT * n * float(psi.abs().max())


@pytest.mark.parametrize("n", [128, 256, 512])
def test_staged_twiddles_are_read_side_by_side(n):
    """The table holds each half size's twiddles in one run (n - 1 entries);
    every stage reads inside it; in the register stages and the two warps'
    stage each half-warp's 16 lanes read 16 adjacent entries (16 distinct
    8-byte bank pairs: no conflict), in a shuffle stage of half size h the
    lanes read h entries (broadcasts)."""
    tw = _staged_twiddles(n, torch.complex128)
    assert tw.shape == (n - 1,)
    hs = 1
    while hs < n:
        jj = torch.arange(hs, dtype=torch.float64)
        want = torch.exp(-2j * np.pi * jj / (2 * hs))
        assert torch.allclose(tw[hs - 1: 2 * hs - 1], want, atol=1e-15)
        hs *= 2
    r = n // (2 * LANES)
    reads = [n // 2 - 1 + _LANE + 32 * m for m in range(r)]  # the two warps' stage
    for b in range(5, n.bit_length() - 2):  # the register stages
        reads += [(1 << b) - 1 + _LANE + 32 * (m & ((1 << (b - 5)) - 1)) for m in range(r)]
    for idx in reads:
        assert int(idx.max()) < n - 1
        for half in (idx[:16], idx[16:]):
            assert len(set((half % 16).tolist())) == 16
    for b in range(5):  # the shuffle stages
        h = 1 << b
        idx = h - 1 + (_LANE & (h - 1))
        assert len(set(idx.tolist())) == h and int(idx.max()) < n - 1


@pytest.mark.parametrize("n", [128, 256, 512])
def test_wide_spectrum_and_step_are_fft2(n):
    """Rows forward, then a column pass's forward wide transforms: the 2-D
    DFT at (bitrev(y'), bitrev(x')); and one slice's IFFT2(P FFT2(s))
    through rows, column items (P from prepare_propagator) and rows back is
    the step in natural order, in complex128."""
    psi, _, prop = _fields(n, 2, 1, seed=n + 1)
    s, p = torch.as_tensor(psi), torch.as_tensor(prop)
    tw = _staged_twiddles(n, s.dtype)
    br = fs.bit_reversal(n)
    rows = _rows_forward(s, tw)
    spectrum = _from_wide(_wide_forward(_to_wide(rows.transpose(-1, -2)), tw)).transpose(-1, -2)
    want = torch.fft.fft2(s)[..., br[:, None], br[None, :]]
    assert float((spectrum - want).abs().max()) <= EXACT * float(want.abs().max())
    prepared = p[br[:, None], br[None, :]]  # fs.prepare_propagator's order, in complex128
    assert torch.equal(fs.prepare_propagator(p), prepared.to(torch.complex64))
    got = _rows_inverse(_col_pass(rows, prepared, False, tw), tw)
    step = torch.fft.ifft2(torch.fft.fft2(s) * p)
    assert float((got - step).abs().max()) <= EXACT * float(step.abs().max())
    adjoint = _rows_inverse(_col_pass(rows, prepared, True, tw), tw)
    step_c = torch.fft.ifft2(torch.fft.fft2(s) * p.conj())
    assert float((adjoint - step_c).abs().max()) <= EXACT * float(step_c.abs().max())


@pytest.mark.parametrize("n", [128, 256, 512])
def test_column_item_covers_its_columns_once(n):
    """The load map of a column item writes every (row, column) of its four
    columns exactly once, to distinct tile places, and a pair's column is
    contiguous in the tile; the 8-byte tile stores of a half-warp (16 lanes)
    fall on 16 distinct 8-byte bank pairs."""
    loads = _col_load_map(n)
    cells = [(y, c) for y, c, _, _ in loads] + [(y, c + 1) for y, c, _, _ in loads]
    assert sorted(cells) == [(y, c) for y in range(n) for c in range(COLS)]
    places = [pa for _, _, pa, _ in loads] + [pb for _, _, _, pb in loads]
    assert len(set(places)) == len(places) == COLS * n
    stride = n + PAD
    for y, c, pa, pb in loads:
        assert pa == c * stride + y and pb == (c + 1) * stride + y
    for half in range(0, 2 * n, 16):
        for which in (2, 3):  # the first and the second store of each thread
            slots = {loads[i][which] % 16 for i in range(half, half + 16)}
            assert len(slots) == 16
    # items and row items cover one wave: n / 4 items of four columns, n rows
    assert n % COLS == 0 and (n // COLS) * COLS == n


# ---- the model's store recursion against the JAX package -----------------------


@pytest.mark.parametrize("b,per_wave_p,groups", [(1, False, 1), (3, False, 2), (3, True, 3)])
def test_wide_model_store_pair_equals_jax(b, per_wave_p, groups):
    """complex64 through the model of the wide kernels: exit waves and s of
    the store forward, dV (summed over wave groups in order) and dpsi0 of its
    backward, against JAX's store pair (interpret mode) on the same inputs;
    per wave where the propagator is per wave (JAX takes one P a call), dV
    then summed over the waves.  dpsi0 is the conjugate of JAX's (PyTorch's
    gradient convention), dV equal."""
    n, nslices = 128, 3
    psi, v, prop = _fields(n, b, nslices, seed=9 * b + groups, dtype=np.complex64)
    rng = np.random.default_rng(21)
    g = (rng.normal(size=(b, n, n)) + 1j * rng.normal(size=(b, n, n))).astype(np.complex64)
    props = (np.stack([prop * np.exp(0.3j * i) for i in range(b)]).astype(np.complex64)
             if per_wave_p else np.broadcast_to(prop, (b, n, n)))
    want_out, want_s, want_dpsi = [], [], []
    want_dv = np.zeros((nslices, n, n), np.float32)
    for i in range(b):
        jp = jnp.asarray(props[i])
        out, ssr, ssi = jadj._run_forward_store(jnp.asarray(psi[i:i + 1]), jnp.asarray(v), jp,
                                                SIGMA, None)
        dv, dpsi = jadj._run_backward_store(ssr, ssi, jnp.asarray(v), jp,
                                            jnp.asarray(np.conj(g[i:i + 1])), SIGMA, None)
        want_out.append(np.asarray(out)[0])
        want_s.append(np.asarray(ssr)[0] + 1j * np.asarray(ssi)[0])
        want_dpsi.append(np.conj(np.asarray(dpsi)[0]))
        want_dv += np.asarray(dv)
    p_t = torch.as_tensor(np.ascontiguousarray(props if per_wave_p else prop))
    prepared = fs.prepare_propagator(p_t)
    out, s = _model_store(torch.as_tensor(psi), torch.as_tensor(v), prepared, SIGMA)
    dv, dpsi = _model_bwd_store(s, torch.as_tensor(v), prepared, torch.as_tensor(g), SIGMA,
                                groups)
    assert out.dtype == torch.complex64 and dv.dtype == torch.float32
    for got, want in ((out, want_out), (s, want_s), (dpsi, want_dpsi), (dv, want_dv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL * np.abs(want).max(), rtol=0)


# ---- the route ---------------------------------------------------------------


def test_store_route_is_the_table():
    """STORE_ROUTE covers the kernels' sizes and the measured wave counts;
    store_route reads it by (n, b) alone: a measured count takes its row, a
    count between rows the row below, one above the last the last, one
    below the first the first; every entry names a route the library
    launches, and each route's kernels are ones it builds."""
    assert set(adj.STORE_ROUTE) == set(fs.SIZES)
    for n, rows in adj.STORE_ROUTE.items():
        measured = sorted(rows)
        assert measured == [1, 3, 8, 16, 64]
        for k, kernel in enumerate(("store", "bwd_store")):
            for b in measured:
                assert adj.store_route(n, b, kernel) == rows[b][k]
            for lo, hi in zip(measured, measured[1:]):
                assert all(adj.store_route(n, b, kernel) == rows[lo][k] for b in range(lo, hi))
            assert adj.store_route(n, 10 * measured[-1], kernel) == rows[measured[-1]][k]
            assert adj.store_route(n, 0, kernel) == rows[measured[0]][k]
        assert all(set(entry) <= set(adj.ROUTES) and len(entry) == 2 for entry in rows.values())
    with pytest.raises(ValueError, match="kernel must be"):
        adj.store_route(512, 1, "ck")
    src = (_build.SRC_DIR / "adjoint_scan.cu").read_text()
    for kernel in ("scan_store_kernel", "scan_bwd_store_kernel", "wide_scan_store_kernel",
                   "wide_scan_bwd_store_kernel"):
        assert kernel in adj.KERNELS
        assert f"__global__ void __launch_bounds__(kThreads) {kernel}(" in src
    assert "adjoint_scan" in _build.sources()


def test_route_argument_is_checked():
    """route= takes "tile" or "wide" and nothing else, on the CPU too (where
    both give the plain version); sizes outside the kernels' raise whatever
    the route."""
    psi, v, prop = (torch.as_tensor(a) for a in _fields(128, 2, 2, seed=6, dtype=np.complex64))
    g = psi.flip(0).contiguous()
    want = adj.fused_scan_store_ref(psi, v, prop, SIGMA)
    want_b = adj.fused_scan_bwd_store_ref(want[1], v, prop, g, SIGMA)
    for route in adj.ROUTES:
        got = adj.fused_scan_store(psi, v, prop, SIGMA, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got_b = adj.fused_scan_bwd_store(want[1], v, prop, g, SIGMA, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got_b, want_b))
    assert all(torch.equal(a, b) for a, b in zip(adj.wide_scan_store(psi, v, prop, SIGMA), want))
    assert all(torch.equal(a, b)
               for a, b in zip(adj.wide_scan_bwd_store(want[1], v, prop, g, SIGMA), want_b))
    for bad in ("cluster", "scan", ""):
        with pytest.raises(ValueError, match="route must be"):
            adj.fused_scan_store(psi, v, prop, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            adj.fused_scan_bwd_store(want[1], v, prop, g, SIGMA, route=bad)
    for m in (64, 2048):
        z = torch.zeros(1, m, m, dtype=torch.complex64)
        for route in adj.ROUTES:
            with pytest.raises(ValueError, match="axis sizes|at most 1024"):
                adj.fused_scan_store(z, torch.zeros(1, m, m), z[0], SIGMA, route=route)


def test_wide_wrappers_count_their_own_launches():
    """The wide wrappers are kernel wrappers of their own (WRAPPERS), with a
    launch count that only a launch on the card moves."""
    assert adj.wide_scan_store in adj.WRAPPERS and adj.wide_scan_bwd_store in adj.WRAPPERS
    psi, v, prop = (torch.as_tensor(a) for a in _fields(128, 1, 2, seed=7, dtype=np.complex64))
    before = (adj.wide_scan_store.launches, adj.fused_scan_store.launches)
    adj.wide_scan_store(psi, v, prop, SIGMA)
    assert (adj.wide_scan_store.launches, adj.fused_scan_store.launches) == before
    with pytest.raises(ValueError, match="CUDA card"):
        adj.grid_barrier(4, 1, device="cpu")


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide kernels have no CPU form")
    return torch.device("cuda")


def test_wide_kernels_match_plain_on_card(cuda):
    """Both wide kernels against the plain versions at 128^2 and 512^2, one
    and three waves, shared and per-wave P; dV bitwise equal over two runs;
    each launch counted on its own wrapper."""
    tol = 2e-6 * 4 ** 0.5
    for n, b in ((128, 3), (512, 1)):
        psi, v, prop = (torch.as_tensor(a).to(cuda)
                        for a in _fields(n, b, 4, seed=n + b, dtype=np.complex64))
        for pr in (prop, torch.stack([prop * np.exp(0.1j * i) for i in range(b)])):
            g = psi.flip(0).contiguous()
            before = (adj.wide_scan_store.launches, adj.wide_scan_bwd_store.launches)
            got = adj.wide_scan_store(psi, v, pr, SIGMA)
            want = adj.fused_scan_store_ref(psi, v, pr, SIGMA)
            back = adj.wide_scan_bwd_store(want[1], v, pr, g, SIGMA)
            again = adj.wide_scan_bwd_store(want[1], v, pr, g, SIGMA)
            back_want = adj.fused_scan_bwd_store_ref(want[1], v, pr, g, SIGMA)
            assert (adj.wide_scan_store.launches, adj.wide_scan_bwd_store.launches) == (
                before[0] + 1, before[1] + 2)
            for a, w in zip((*got, *back), (*want, *back_want)):
                assert float((a - w).abs().max()) <= tol * float(w.abs().max())
            assert torch.equal(back[0], again[0])
    with pytest.raises(TypeError, match="complex64"):
        adj.wide_scan_store(psi.to(torch.complex128), v, prop, SIGMA)
