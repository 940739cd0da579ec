"""The wide kernels of the whole-loop adjoint (the store pair
``wide_scan_store_kernel``, ``wide_scan_bwd_store_kernel`` and the segment
pair ``wide_scan_ck_kernel``, ``wide_scan_bwd_ck_kernel`` in
csrc/adjoint_scan.cu, their transform in csrc/fused_fft.cuh) as a plain-torch
model of their index maps, and the routes between them and the tile kernels.

The model follows the kernels' data: warp w of a pair, lane l and register m
hold element l + 32 m + (n/2) w of a row or column; the stage of half size
n/2 exchanges the two warps' values through the pair's buffer, the register
stages and the five shuffle stages follow in the kernels' order, each
thread computing its own half of a butterfly from its partner's value (the
other warp's, or lane l ^ h's), with twiddles read from the staged table as
the kernels build it; a column item is four columns of a plane, loaded into
a padded shared tile by the kernels' thread map.  It is held against
``torch.fft.fft2`` in complex128, and its recursions in complex64 against the
JAX package's kernels in interpret mode: the store pair (forward with the s
stack, reverse with dV summed over wave groups) and the segment pair (the
forward keeping the wave entering every seg-th slice; per segment, last to
first, the s_k recomputed from the checkpoint into a buffer of seg planes,
then the reverse loop over them, the carry kept in the row phases' order
across segment boundaries).  The kernels themselves are held against the
plain versions on the card (the last test here, and chip_smoke.py's
kernels_adjoint phase)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.pallas import adjoint_scan as jadj  # noqa: E402
from fdes_tpu_torch.kernels import _build  # noqa: E402
from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import adjoint_scan as adj  # noqa: E402
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402
from fdes_tpu_torch.propagate import PROBE_CHUNK_TARGET  # noqa: E402

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
    tw = _staged_twiddles(psi0.shape[-1], psi0.dtype)
    return _model_forward_sweep(psi0, v_stack, prepared, sigma, tw, keep_s=True)


def _model_forward_sweep(work, v_stack, prepared, sigma, tw, keep_s=False, seg=0, finish=True):
    """wide_forward_sweep over the slices of v_stack from the incoming waves
    ``work`` (natural order): (work, kept).  kept: with ``keep_s`` the s_k of
    every slice (B, len, n, n); with ``seg`` the wave entering every seg-th
    slice, natural psi before the transmit.  ``finish``: the last column
    phase and the final inverse row phase run, work is the exit wave; else
    the sweep stops after the last s_k (work is then None)."""
    kept = []
    for k, v in enumerate(v_stack):
        psi = _rows_inverse(work, tw) if k else work
        if seg and k % seg == 0:
            kept.append(psi)
        s = _transmit(psi, v, sigma)
        if keep_s:
            kept.append(s)
        work = None
        if finish or k < v_stack.shape[0] - 1:
            work = _col_pass(_rows_forward(s, tw), prepared, False, tw)
    out = _rows_inverse(work, tw) if finish else None
    return out, torch.stack(kept, dim=1)


def _model_ck(psi0, v_stack, prepared, sigma, seg):
    """wide_scan_ck_kernel: (exit waves, ck (B, S/seg, n, n))."""
    tw = _staged_twiddles(psi0.shape[-1], psi0.dtype)
    return _model_forward_sweep(psi0, v_stack, prepared, sigma, tw, seg=seg)


def _model_reverse_sweep(bar, s, v_stack, v0, prepared, sigma, groups, dv, tw):
    """wide_reverse_sweep over the slices v0 .. v0 + len(s) - 1 of v_stack,
    last to first, on the carry ``bar`` in the row phases' order (each row's
    bit-reversed x spectrum); returns the carry in that order, or natural
    after slice 0.  dV of each slice, summed over the waves of each of
    ``groups`` wave groups in order, then over the groups in order, goes to
    dv[v0 + k]."""
    b, nsl, n = s.shape[0], s.shape[1], s.shape[-1]
    per = -(-b // groups)
    for k in range(nsl - 1, -1, -1):
        bar = _col_pass(bar, prepared, True, tw)
        bar_s = _rows_inverse(bar, tw)
        parts = []
        for g0 in range(0, b, per):
            acc = torch.zeros(n, n, dtype=bar.real.dtype)
            for w in range(g0, min(g0 + per, b)):
                acc = acc + (bar_s[w] * s[w, k].conj()).imag
            parts.append(sigma * acc)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        dv[v0 + k] = total
        bar = _transmit(bar_s, v_stack[v0 + k], sigma, conj=True)
        if v0 + k:
            bar = _rows_forward(bar, tw)
    return bar


def _model_bwd_store(s, v_stack, prepared, g, sigma, groups):
    """wide_scan_bwd_store_kernel: (dV, dpsi0): the forward x of g, then the
    reverse loop over every slice."""
    tw = _staged_twiddles(s.shape[-1], g.dtype)
    dv = torch.empty(v_stack.shape, dtype=g.real.dtype)
    bar = _model_reverse_sweep(_rows_forward(g, tw), s, v_stack, 0, prepared, sigma, groups, dv,
                               tw)
    return dv, bar


def _model_bwd_ck(ck, v_stack, prepared, g, sigma, seg, groups):
    """wide_scan_bwd_ck_kernel: (dV, dpsi0).  The forward x of g; then per
    segment, last to first, its s_k recomputed from ck[:, i] into sbuf (B,
    seg, n, n; no column phase after the last) and the reverse loop over the
    segment.  The carry crosses each boundary in the row phases' order: no
    pass of its own there."""
    tw = _staged_twiddles(ck.shape[-1], g.dtype)
    dv = torch.empty(v_stack.shape, dtype=g.real.dtype)
    bar = _rows_forward(g, tw)
    for i in range(ck.shape[1] - 1, -1, -1):
        _, sbuf = _model_forward_sweep(ck[:, i], v_stack[i * seg:(i + 1) * seg], prepared, sigma,
                                       tw, keep_s=True, finish=False)
        assert tuple(sbuf.shape) == (ck.shape[0], seg, *ck.shape[2:])
        bar = _model_reverse_sweep(bar, sbuf, v_stack, i * seg, prepared, sigma, groups, dv, tw)
    return dv, bar


# ---- the index maps against torch.fft ----------------------------------------


@pytest.mark.parametrize("n", [128, 256, 512])
def test_wide_transforms_are_the_dft(n):
    """The forward wide transform of rows is their DFT at bit-reversed
    positions; the inverse takes it back (times n), in complex128."""
    psi = torch.as_tensor(_fields(n, 1, 1, seed=n)[0][0, :8])
    tw = _staged_twiddles(n, psi.dtype)
    got = _rows_forward(psi, tw)
    want = torch.fft.fft(psi, dim=-1)[..., rt.bit_reversal(n)]
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
    br = rt.bit_reversal(n)
    rows = _rows_forward(s, tw)
    spectrum = _from_wide(_wide_forward(_to_wide(rows.transpose(-1, -2)), tw)).transpose(-1, -2)
    want = torch.fft.fft2(s)[..., br[:, None], br[None, :]]
    assert float((spectrum - want).abs().max()) <= EXACT * float(want.abs().max())
    prepared = p[br[:, None], br[None, :]]  # rt.prepare_propagator's order, in complex128
    assert torch.equal(rt.prepare_propagator(p), prepared.to(torch.complex64))
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
    prepared = rt.prepare_propagator(p_t)
    out, s = _model_store(torch.as_tensor(psi), torch.as_tensor(v), prepared, SIGMA)
    dv, dpsi = _model_bwd_store(s, torch.as_tensor(v), prepared, torch.as_tensor(g), SIGMA,
                                groups)
    assert out.dtype == torch.complex64 and dv.dtype == torch.float32
    for got, want in ((out, want_out), (s, want_s), (dpsi, want_dpsi), (dv, want_dv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("b,seg,per_wave_p,groups", [
    (1, 1, False, 1), (1, 2, False, 1), (1, 4, True, 1), (3, 1, True, 3), (3, 2, False, 2),
    (3, 4, False, 2),
])
def test_wide_model_segment_pair_equals_jax(b, seg, per_wave_p, groups):
    """complex64 through the model of the wide segment pair: exit waves and
    checkpoints of its forward, dV (summed over wave groups in order) and
    dpsi0 of its backward (the s_k recomputed per segment, the carry kept in
    the row phases' order across the boundaries), against JAX's
    _run_forward_ck and _run_backward (interpret mode) on the same inputs,
    per wave where the propagator is per wave (dV then summed over the
    waves).  4 slices: seg 1, 2 and 4 give four, two and one segments."""
    n, nslices = 128, 4
    psi, v, prop = _fields(n, b, nslices, seed=5 * b + seg, dtype=np.complex64)
    rng = np.random.default_rng(23)
    g = (rng.normal(size=(b, n, n)) + 1j * rng.normal(size=(b, n, n))).astype(np.complex64)
    props = (np.stack([prop * np.exp(0.3j * i) for i in range(b)]).astype(np.complex64)
             if per_wave_p else None)
    calls = [(slice(i, i + 1), props[i]) for i in range(b)] if per_wave_p else [(slice(0, b),
                                                                                  prop)]
    want_out, want_ck, want_dpsi = [], [], []
    want_dv = np.zeros((nslices, n, n), np.float32)
    for waves, p in calls:
        jp = jnp.asarray(p)
        out, ckr, cki = jadj._run_forward_ck(jnp.asarray(psi[waves]), jnp.asarray(v), jp, SIGMA,
                                             None, seg)
        dv, dpsi = jadj._run_backward(ckr, cki, jnp.asarray(v), jp,
                                      jnp.asarray(np.conj(g[waves])), SIGMA, None, seg)
        want_out.append(np.asarray(out))
        want_ck.append(np.asarray(ckr) + 1j * np.asarray(cki))
        want_dpsi.append(np.conj(np.asarray(dpsi)))
        want_dv += np.asarray(dv)
    p_t = torch.as_tensor(np.ascontiguousarray(props if per_wave_p else prop))
    prepared = rt.prepare_propagator(p_t)
    out, ck = _model_ck(torch.as_tensor(psi), torch.as_tensor(v), prepared, SIGMA, seg)
    assert tuple(ck.shape) == (b, nslices // seg, n, n)
    assert torch.equal(ck[:, 0], torch.as_tensor(psi))  # the incoming wave itself
    dv, dpsi = _model_bwd_ck(ck, torch.as_tensor(v), prepared, torch.as_tensor(g), SIGMA, seg,
                             groups)
    assert out.dtype == torch.complex64 and dv.dtype == torch.float32
    for got, want in ((out, want_out), (ck, want_ck), (dpsi, want_dpsi), (dv, [want_dv])):
        want = np.concatenate(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("seg", [1, 2, 3, 6])
def test_wide_model_segment_pair_is_the_store_pair(seg):
    """The wide segment pair runs the wide store pair's arithmetic, only
    split into segments: through the model, on the same inputs and wave
    groups, its exit waves, recomputed s_k, dV and dpsi0 are the store
    pair's, bit for bit (complex128; chip_smoke.py holds the kernels to the
    same on the card)."""
    n, b, nslices = 128, 2, 6
    psi, v, prop = (torch.as_tensor(a) for a in _fields(n, b, nslices, seed=40 + seg))
    g = torch.as_tensor(_fields(n, b, 1, seed=50)[0])
    prepared = prop[rt.bit_reversal(n)[:, None], rt.bit_reversal(n)[None, :]]  # in complex128
    out_s, s = _model_store(psi, v, prepared, SIGMA)
    dv_s, dpsi_s = _model_bwd_store(s, v, prepared, g, SIGMA, 2)
    out_c, ck = _model_ck(psi, v, prepared, SIGMA, seg)
    dv_c, dpsi_c = _model_bwd_ck(ck, v, prepared, g, SIGMA, seg, 2)
    assert torch.equal(out_c, out_s)
    assert torch.equal(dv_c, dv_s) and torch.equal(dpsi_c, dpsi_s)
    # each checkpoint is the wave the store forward transmitted into s there
    phase = v[::seg].to(torch.float64) * SIGMA
    assert torch.allclose(ck * torch.polar(torch.ones_like(phase), phase), s[:, ::seg],
                          rtol=0, atol=1e-12 * float(s.abs().max()))


# ---- the routes --------------------------------------------------------------

#: pair: (route table, its reader, the reader's two kernel names, the measured
#: wave counts by size, the four wrappers (forward, backward, wide forward,
#: wide backward), the tile and wide kernels)
PAIRS = {
    "store": (adj.STORE_ROUTE, adj.store_route, ("store", "bwd_store"),
              dict.fromkeys(fs.SIZES, [1, 3, 8, 16, 64]),
              (adj.fused_scan_store, adj.fused_scan_bwd_store, adj.wide_scan_store,
               adj.wide_scan_bwd_store),
              ("scan_store_kernel", "scan_bwd_store_kernel", "wide_scan_store_kernel",
               "wide_scan_bwd_store_kernel")),
    "seg": (adj.SEG_ROUTE, adj.seg_route, ("ck", "bwd_ck"),
            {128: [128], 256: [128], 512: [64, 128], 1024: [8, 16, 64, 128]},
            (adj.fused_scan_ck, adj.fused_scan_bwd_ck, adj.wide_scan_ck, adj.wide_scan_bwd_ck),
            ("scan_ck_kernel", "scan_bwd_ck_kernel", "wide_scan_ck_kernel",
             "wide_scan_bwd_ck_kernel")),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_store_route_is_the_table(pair):
    """Each pair's route table (STORE_ROUTE, SEG_ROUTE) covers the kernels'
    sizes and the measured wave counts; its reader takes (n, b) alone: a
    measured count takes its row, a count between rows the row below, one
    above the last the last, one below the first the first; every entry
    names a route the library launches, each route's kernels are ones it
    builds, and the reader refuses the other pair's kernel names."""
    table, route_of, names, counts, _, kernels = PAIRS[pair]
    assert set(table) == set(fs.SIZES)
    for n, rows in table.items():
        measured = sorted(rows)
        assert measured == counts[n]
        for k, kernel in enumerate(names):
            for b in measured:
                assert route_of(n, b, kernel) == rows[b][k]
            for lo, hi in zip(measured, measured[1:]):
                assert all(route_of(n, b, kernel) == rows[lo][k] for b in range(lo, hi))
            assert route_of(n, 10 * measured[-1], kernel) == rows[measured[-1]][k]
            assert route_of(n, 0, kernel) == rows[measured[0]][k]
        assert all(set(entry) <= set(adj.ROUTES) and len(entry) == 2 for entry in rows.values())
    other = PAIRS["seg" if pair == "store" else "store"][2]
    for kernel in other:
        with pytest.raises(ValueError, match="kernel must be"):
            route_of(512, 1, kernel)
    src = (_build.SRC_DIR / "adjoint_scan.cu").read_text()
    for kernel in kernels:
        assert kernel in adj.KERNELS
        assert f"__global__ void __launch_bounds__(kThreads) {kernel}(" in src
    assert "adjoint_scan" in _build.sources()


def test_seg_route_rows_pass_the_cap():
    """SEG_ROUTE keeps a row only where its count of waves passes the store
    cap within SEG_DEPTH slices (seg_depth: the fewest slices past it), and
    every size has a row at the stem4d inverse's probe chunk."""
    for n, rows in adj.SEG_ROUTE.items():
        assert PROBE_CHUNK_TARGET in rows
        for b in rows:
            depth = adj.seg_depth(n, b)
            assert b * (depth - 1) * n * n * 8 <= adj.STORE_CAP_BYTES < b * depth * n * n * 8
            assert depth <= adj.SEG_DEPTH or list(rows) == [PROBE_CHUNK_TARGET]
    # the deep stem4d cell: 128 probes of 512^2 pass the cap from 129 slices
    assert (adj.seg_depth(512, 128), adj.seg_depth(1024, 128), adj.seg_depth(1024, 8)) == (
        129, 33, 513)


def _pair_calls(pair, psi, v, prop, sigma, seg=2):
    """(forward(route), backward(kept, g, route), the plain forward, the
    plain backward(kept, g), the wide wrappers' forward and backward) of a
    pair, with the segment length bound for the segment pair."""
    fwd, bwd, wfwd, wbwd = PAIRS[pair][4]
    extra = (seg,) if pair == "seg" else ()
    refs = ((adj.fused_scan_ck_ref, adj.fused_scan_bwd_ck_ref) if pair == "seg"
            else (adj.fused_scan_store_ref, adj.fused_scan_bwd_store_ref))
    return (lambda route: fwd(psi, v, prop, sigma, *extra, route=route),
            lambda kept, g, route: bwd(kept, v, prop, g, sigma, *extra, route=route),
            lambda: refs[0](psi, v, prop, sigma, *extra),
            lambda kept, g: refs[1](kept, v, prop, g, sigma, *extra),
            lambda: wfwd(psi, v, prop, sigma, *extra),
            lambda kept, g: wbwd(kept, v, prop, g, sigma, *extra))


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_route_argument_is_checked(pair):
    """route= takes "tile" or "wide" and nothing else, on the CPU too (where
    both give the plain version), for both kernels of each pair; sizes
    outside the kernels' raise whatever the route."""
    psi, v, prop = (torch.as_tensor(a) for a in _fields(128, 2, 2, seed=6, dtype=np.complex64))
    g = psi.flip(0).contiguous()
    fwd, bwd, fwd_ref, bwd_ref, wfwd, wbwd = _pair_calls(pair, psi, v, prop, SIGMA)
    want = fwd_ref()
    want_b = bwd_ref(want[1], g)
    for route in adj.ROUTES:
        assert all(torch.equal(a, b) for a, b in zip(fwd(route), want))
        assert all(torch.equal(a, b) for a, b in zip(bwd(want[1], g, route), want_b))
    assert all(torch.equal(a, b) for a, b in zip(wfwd(), want))
    assert all(torch.equal(a, b) for a, b in zip(wbwd(want[1], g), want_b))
    for bad in ("cluster", "scan", ""):
        with pytest.raises(ValueError, match="route must be"):
            fwd(bad)
        with pytest.raises(ValueError, match="route must be"):
            bwd(want[1], g, bad)
    for m in (64, 2048):
        z = torch.zeros(1, m, m, dtype=torch.complex64)
        for route in adj.ROUTES:
            with pytest.raises(ValueError, match="axis sizes|at most 1024"):
                _pair_calls(pair, z, torch.zeros(1, m, m), z[0], SIGMA, seg=1)[0](route)


def test_wide_wrappers_count_their_own_launches():
    """The wide wrappers are kernel wrappers of their own (WRAPPERS), with a
    launch count that only a launch on the card moves."""
    wide = (adj.wide_scan_store, adj.wide_scan_bwd_store, adj.wide_scan_ck, adj.wide_scan_bwd_ck)
    assert all(w in adj.WRAPPERS for w in wide)
    assert len(set(adj.WRAPPERS)) == len(adj.WRAPPERS) == 8
    psi, v, prop = (torch.as_tensor(a) for a in _fields(128, 1, 2, seed=7, dtype=np.complex64))
    before = [w.launches for w in adj.WRAPPERS]
    _, s = adj.wide_scan_store(psi, v, prop, SIGMA)
    adj.wide_scan_bwd_store(s, v, prop, psi, SIGMA)
    _, ck = adj.wide_scan_ck(psi, v, prop, SIGMA, 1)
    adj.wide_scan_bwd_ck(ck, v, prop, psi, SIGMA, 1)
    assert [w.launches for w in adj.WRAPPERS] == before
    with pytest.raises(ValueError, match="CUDA card"):
        adj.grid_barrier(4, 1, device="cpu")


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide kernels have no CPU form")
    return torch.device("cuda")


def test_wide_kernels_match_plain_on_card(cuda):
    """The four wide kernels against the plain versions at 128^2 and 512^2,
    one and three waves, shared and per-wave P, the segment pair in segments
    of 1 and 4; dV bitwise equal over two runs; each launch counted on its
    own wrapper; the segment pair's outputs the store pair's bits."""
    tol = 2e-6 * 4 ** 0.5
    for n, b in ((128, 3), (512, 1)):
        psi, v, prop = (torch.as_tensor(a).to(cuda)
                        for a in _fields(n, b, 4, seed=n + b, dtype=np.complex64))
        for pr in (prop, torch.stack([prop * np.exp(0.1j * i) for i in range(b)])):
            g = psi.flip(0).contiguous()
            for pair, seg in (("store", 0), ("seg", 1), ("seg", 4)):
                _, _, fwd_ref, bwd_ref, wfwd, wbwd = _pair_calls(pair, psi, v, pr, SIGMA, seg)
                counters = PAIRS[pair][4][2:]
                before = [w.launches for w in counters]
                got, want = wfwd(), fwd_ref()
                back, again = wbwd(want[1], g), wbwd(want[1], g)
                back_want = bwd_ref(want[1], g)
                assert [w.launches for w in counters] == [before[0] + 1, before[1] + 2]
                for a, w in zip((*got, *back), (*want, *back_want)):
                    assert float((a - w).abs().max()) <= tol * float(w.abs().max())
                assert torch.equal(back[0], again[0])
            out_s, s = adj.wide_scan_store(psi, v, pr, SIGMA)
            out_c, ck = adj.wide_scan_ck(psi, v, pr, SIGMA, 2)
            assert torch.equal(out_s, out_c)
            for a, w in zip(adj.wide_scan_bwd_ck(ck, v, pr, g, SIGMA, 2, groups=1),
                            adj.wide_scan_bwd_store(s, v, pr, g, SIGMA, groups=1)):
                assert torch.equal(a, w)
    with pytest.raises(TypeError, match="complex64"):
        adj.wide_scan_store(psi.to(torch.complex128), v, prop, SIGMA)
    with pytest.raises(TypeError, match="complex64"):
        adj.wide_scan_ck(psi.to(torch.complex128), v, prop, SIGMA, 2)
