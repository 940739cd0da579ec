"""The wide panel kernels (``panel_wide_col_kernel``, also in its build modes
(row 28), ``panel_wide_bwd_row_kernel``, ``panel_wide_row_kernel``, also in
its modes kVfused (row 29), kMidAbs and kInitAbs (rows 19 and 18), kInit and
kInitVc (row 13),
``panel_wide_g_row_kernel`` (row 27) and ``panel_wide_x_row_kernel`` (rows 17
and 20), in csrc/panel_scan.cu, and their three-round transform) as a numpy
model of their index maps, and the route between them and the tile kernels
(``kernels/panel_scan.PANEL_ROUTE``).

The model follows the kernels' data: an N-point transform is held by a group
of T = N/R threads (R = 8 values a thread up to 512 points, 16 above: one
warp at 256 points to eight at 4096), thread t and register m holding
position p in one of three layouts (t + T m; hi N/R + 2^b m + lo with t = lo
+ 2^b hi, b = log2 N - 2 log2 R; R t + m).  Each of three rounds runs the
radix-2 stages of the position bits that the registers hold, in the kernels'
order, with twiddles read from the staged table as the kernels build it, and
the group exchanges its values through a padded buffer in shared memory
between rounds.  A column item is C adjacent columns of a plane, copied 16
bytes at a time into a staged panel (rows one after the other, the halves of
a 4-column row swapped on every other group of four rows), read by column
into the groups' registers and written back the same way; a row item is one
row a group.  The model is held against ``np.fft`` in float64, and its
column pass, its conjugate, its backward row pass, its forward row pass
(with and without the store of s_j), its build column pass (the species'
products summed in registers), its fused row pass (V's row through one
more inverse transform), its absorptive row pass and init (the damped
transmit of a complex V), its init of a real V (and of V taken from a
complex plane's real parts), its g row pass (real rows through one forward
transform) and its transform-only row pass (the final and the seed: complex
rows of all the waves through one transform) against the JAX package's
panel passes in interpret mode.  The
kernels themselves are held against the plain versions on the card (the
last tests here, and chip_smoke.py's kernels_panel, kernels_panel_grad and
kernels_panel_stream phases)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch.kernels import _build  # noqa: E402
from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import panel_scan as ps  # noqa: E402

SIGMA = interaction_sigma(300e3)
EXACT = 1e-12  # float64: the model against np.fft, max |d| / max |ref|
ATOL = 2e-5  # times max|.|: the tolerance of tests/test_torch_panel_grad.py
N_JAX = 256  # the JAX passes' grid, their panel extents patched down
BASE = 128  # the JAX transform's matmul base (fdes_tpu/pallas/fused_step.py)
ROW_THREADS = 256  # csrc/panel_scan.cu kWideRowThreads


def _shape(n: int) -> tuple[int, int, int, int]:
    """(L, r, T, b) of an n-point transform (csrc/panel_scan.cu Rounds)."""
    big = n.bit_length() - 1
    r = 3 if big <= 9 else 4
    return big, r, n >> r, big - 2 * r


def _cols(n: int) -> int:
    """Columns of a wide column item (kWideCols)."""
    return 4 if n <= 2048 else 2


def _bitrev(n: int) -> np.ndarray:
    return rt.bit_reversal(n).numpy()


def _cplx(rng, *shape) -> np.ndarray:
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# ---- the model -----------------------------------------------------------------


def _staged_twiddles(n: int) -> np.ndarray:
    """init_staged_twiddles: tw[hs - 1 + jj] = exp(-2 pi i jj / (2 hs)) for
    hs = 1, 2, ..., n/2 and jj < hs (n - 1 entries)."""
    i = np.arange(n - 1)
    hs = 1 << np.floor(np.log2(i + 1)).astype(np.int64)
    return np.exp(-1j * np.pi * (i + 1 - hs) / hs)


def _pos(n: int, layout: int, t=None, m=None) -> np.ndarray:
    """rounds_pos: the position of register m of thread t in a layout,
    (T, R) over all threads and registers by default."""
    _, r, tt, b = _shape(n)
    t = np.arange(tt)[:, None] if t is None else t
    m = np.arange(1 << r)[None, :] if m is None else m
    if layout == 1:
        return t + tt * m
    if layout == 2:
        return (t >> b) * (n >> r) + (m << b) + (t & ((1 << b) - 1))
    return (1 << r) * t + m


def _pad(n: int, a: int, b_: int, p):
    """rounds_pad: the buffer place of position p in an exchange between
    layouts a and b_."""
    big, r, _, b = _shape(n)
    if {a, b_} == {1, 2}:
        return p + ((p >> (big - r)) << b)
    return p + (p >> r)


def _exchange(n: int, x: np.ndarray, fr: int, to: int) -> np.ndarray:
    """rounds_exchange on (..., T, R): every thread writes its registers at
    their padded places, then reads the places of the next layout."""
    _, r, _, _ = _shape(n)
    src, dst = _pad(n, fr, to, _pos(n, fr)), _pad(n, fr, to, _pos(n, to))
    assert len(set(src.ravel().tolist())) == n and int(src.max()) < n + n // (1 << r)
    buf = np.full((*x.shape[:-2], n + n // (1 << r)), np.nan, dtype=x.dtype)
    buf[..., src] = x
    out = buf[..., dst]
    assert not np.isnan(out).any()  # the next layout reads only what was written
    return out


def _stage(x: np.ndarray, tw: np.ndarray, d: int, hs: int, base, stride: int, inverse: bool):
    """rounds_stage: register pairs (m, m + d); the twiddle of a pair at
    tw[hs - 1 + base + stride (m mod d)], base per thread ((T, 1) or 0)."""
    base = np.asarray(base).reshape(-1)
    for m in range(x.shape[-1]):
        if m & d:
            continue
        w = tw[hs - 1 + base + stride * (m & (d - 1))]
        a, c = x[..., m].copy(), x[..., m + d].copy()
        if inverse:
            u = c * np.conj(w)
            x[..., m], x[..., m + d] = a + u, a - u
        else:
            x[..., m], x[..., m + d] = a + c, (a - c) * w
    return x


def _forward(n: int, x: np.ndarray) -> np.ndarray:
    """rounds_forward on (..., T, R): layout 1 natural in, layout 3
    bit-reversed out (position p holds frequency bitrev_n(p))."""
    _, r, tt, b = _shape(n)
    tw, t = _staged_twiddles(n), np.arange(tt)
    x = x.copy()
    for j in range(r - 1, -1, -1):
        x = _stage(x, tw, 1 << j, tt << j, t, tt, False)
    x = _exchange(n, x, 1, 2)
    for j in range(r - 1, -1, -1):
        x = _stage(x, tw, 1 << j, 1 << (b + j), t & ((1 << b) - 1), 1 << b, False)
    x = _exchange(n, x, 2, 3)
    for j in range(b - 1, -1, -1):
        x = _stage(x, tw, 1 << j, 1 << j, 0, 1, False)
    return x


def _inverse(n: int, x: np.ndarray) -> np.ndarray:
    """rounds_inverse: layout 3 bit-reversed in, layout 1 natural out,
    unscaled."""
    _, r, tt, b = _shape(n)
    tw, t = _staged_twiddles(n), np.arange(tt)
    x = x.copy()
    for j in range(b):
        x = _stage(x, tw, 1 << j, 1 << j, 0, 1, True)
    x = _exchange(n, x, 3, 2)
    for j in range(r):
        x = _stage(x, tw, 1 << j, 1 << (b + j), t & ((1 << b) - 1), 1 << b, True)
    x = _exchange(n, x, 2, 1)
    for j in range(r):
        x = _stage(x, tw, 1 << j, tt << j, t, tt, True)
    return x


def _rows_forward(rows: np.ndarray) -> np.ndarray:
    """Rows through the group's registers: loaded in layout 1, stored from
    layout 3 (the bit-reversed spectrum at its positions)."""
    n = rows.shape[-1]
    out = np.empty(rows.shape, dtype=complex)
    out[..., _pos(n, 3)] = _forward(n, rows[..., _pos(n, 1)])
    return out


def _rows_inverse(rows: np.ndarray) -> np.ndarray:
    n = rows.shape[-1]
    out = np.empty(rows.shape, dtype=complex)
    out[..., _pos(n, 1)] = _inverse(n, rows[..., _pos(n, 3)])
    return out


def _stage_at(y, c, cols: int):
    """stage_at: the place of (row y, column c) in a staged panel of C columns."""
    y, c = np.asarray(y), np.asarray(c)
    if cols == 4:
        return 4 * y + (c ^ (((y >> 2) & 1) << 1))
    return cols * y + c


def _fetch_map(n: int, cols: int):
    """wide_col_fetch (and the 16-byte stores, the same map): thread index i
    -> (row, first column of its 16-byte chunk, its place in the stage)."""
    i = np.arange(n * cols // 2)
    y, c = i // (cols // 2), 2 * (i % (cols // 2))
    return y, c, _stage_at(y, c, cols)


def _col_pass(plane: np.ndarray, prepared: np.ndarray, conj_p: bool):
    """panel_wide_col_kernel on (B, n, n) (prepared: (n, n) or one per wave):
    each item of C columns copied into the stage, group g's column read into
    its registers (layout 1), transformed (to layout 3), multiplied by P at
    the rows of layout 3, transformed back, written to the stage and
    stored."""
    b, n = plane.shape[0], plane.shape[-1]
    cols = _cols(n)
    y, c, at = _fetch_map(n, cols)
    rows1, rows3 = _pos(n, 1), _pos(n, 3)
    out = np.empty_like(plane)
    pp = prepared if prepared.ndim == 3 else np.broadcast_to(prepared, plane.shape)
    for wave in range(b):
        for c0 in range(0, n, cols):
            stage = np.full(cols * n, np.nan, dtype=plane.dtype)
            stage[at] = plane[wave, y, c0 + c]
            stage[at + 1] = plane[wave, y, c0 + c + 1]
            assert not np.isnan(stage).any()
            x = np.stack([stage[_stage_at(rows1, g, cols)] for g in range(cols)])
            p = np.stack([pp[wave, rows3, c0 + g] for g in range(cols)]) / (n * n)
            x = _inverse(n, _forward(n, x) * (p.conj() if conj_p else p))
            for g in range(cols):
                stage[_stage_at(rows1, g, cols)] = x[g]
            out[wave, y, c0 + c] = stage[at]
            out[wave, y, c0 + c + 1] = stage[at + 1]
    return out


def _bwd_row_pass(bar, s, v, sigma, forward=True, from_psi=False):
    """panel_wide_bwd_row_kernel: (out, dV) of the waves bar (B, n, n), s
    (B, n, n) (from_psi: psi), V (n, n): per row the waves in order, the dV
    sum of the waves before added to each wave's term."""
    bar_s = _rows_inverse(bar)
    t = np.exp(1j * sigma * v)
    s_eff = s * t if from_psi else s
    acc = 0.0
    for wave in range(bar.shape[0]):
        acc = (bar_s[wave] * s_eff[wave].conj()).imag + acc
    out = bar_s * t.conj()
    return (_rows_forward(out) if forward else out), sigma * acc


def _row_pass(b, v, sigma, store=False):
    """panel_wide_row_kernel: a = Fx(t Fx^H(b)) of the waves b (B, n, n) with
    V (n, n), and with ``store`` also s = t Fx^H(b).  Per row: b's row in
    layout 1, exchanged to layout 3, the inverse transform, the transmit by t
    = exp(i sigma V) (formed once a row for all the waves) at the positions of
    layout 1, where s is stored, the forward transform, and a's row exchanged
    from layout 3 to layout 1 and stored."""
    n = b.shape[-1]
    rows1 = _pos(n, 1)
    x = _inverse(n, _exchange(n, b[..., rows1], 1, 3))
    x = x * np.exp(1j * sigma * v)[:, rows1]  # (n rows, T, R), shared by the waves
    s = np.empty(b.shape, dtype=complex)
    s[..., rows1] = x
    a = np.empty(b.shape, dtype=complex)
    a[..., rows1] = _exchange(n, _forward(n, x), 3, 1)
    return (a, s) if store else a


def _row_abs_pass(b, vr, vi, sigma, init=False):
    """panel_wide_row_kernel's kMidAbs: a = Fx(t Fx^H(b)) of the waves b (B,
    n, n), t = exp(-sigma Vi) exp(i sigma Vr) of the absorptive V = Vr + i Vi
    (n, n); with ``init`` its kInitAbs: a = Fx(t psi), b the waves psi in
    natural order.  Per row: V's complex row loaded with b's in layout 1 and
    t formed there once for all the waves; b's row exchanged to layout 3 and
    through the inverse transform (kMidAbs) or transmitted as loaded
    (kInitAbs); the transmit at the positions of layout 1, the forward
    transform, and a's row exchanged from layout 3 to layout 1 and stored."""
    n = b.shape[-1]
    rows1 = _pos(n, 1)
    x = b[..., rows1]
    if not init:
        x = _inverse(n, _exchange(n, x, 1, 3))
    t = np.exp(-sigma * vi[:, rows1]) * np.exp(1j * sigma * vr[:, rows1])  # shared by the waves
    a = np.empty(b.shape, dtype=complex)
    a[..., rows1] = _exchange(n, _forward(n, x * t), 3, 1)
    return a


def _init_pass(psi, v0, sigma):
    """panel_wide_row_kernel's kInit (row 13): a = Fx(t psi) of the waves psi
    (B, n, n) in natural order, t = exp(i sigma V_0) of a real V_0 (n, n);
    with a complex ``v0`` its kInitVc, V_0 the plane's real parts (the
    streamed rollout's init).  Per row: V_0's row loaded with psi's in layout
    1 and t formed there once for all the waves; psi's row transmitted as
    loaded, the forward transform, and a's row exchanged from layout 3 to
    layout 1 and stored."""
    n = psi.shape[-1]
    rows1 = _pos(n, 1)
    t = np.exp(1j * sigma * np.real(v0)[:, rows1])  # shared by the waves
    a = np.empty(psi.shape, dtype=complex)
    a[..., rows1] = _exchange(n, _forward(n, psi[..., rows1] * t), 3, 1)
    return a


def _build_col_pass(gx, fp, chunk: int = 64):
    """panel_wide_col_kernel's build modes: Fy^H(sum_s F_s Fy(gx_s)) of the
    species planes gx (nsp, n, n) with the real factors fp (nsp, n, n) in
    prepare_factors' layout, into one plane.  Per item of C columns (``chunk``
    items at a time here) the species in turn: its item copied into a stage,
    group g's column read into registers (layout 1), the forward transform,
    times the factor at the rows of layout 3, added to the running sum in
    registers; then one inverse transform of the sum, written to the stage
    and stored."""
    nsp, n = gx.shape[0], gx.shape[-1]
    cols = _cols(n)
    y, c, at = _fetch_map(n, cols)
    rows1, rows3 = _pos(n, 1), _pos(n, 3)
    out = np.empty((n, n), dtype=complex)
    for first in range(0, n // cols, chunk):
        c0 = cols * np.arange(first, min(first + chunk, n // cols))[:, None]
        acc = None
        for sp in range(nsp):
            stage = np.full((len(c0), cols * n), np.nan, dtype=complex)
            stage[:, at] = gx[sp][y, c0 + c]
            stage[:, at + 1] = gx[sp][y, c0 + c + 1]
            assert not np.isnan(stage).any()
            x = np.stack([stage[:, _stage_at(rows1, g, cols)] for g in range(cols)], axis=1)
            f = np.stack([fp[sp][rows3, (c0 + g)[:, :, None]] for g in range(cols)], axis=1)
            z = _forward(n, x) * f
            acc = z if acc is None else acc + z
        x = _inverse(n, acc)
        for g in range(cols):
            stage[:, _stage_at(rows1, g, cols)] = x[:, g]
        out[y, c0 + c] = stage[:, at]
        out[y, c0 + c + 1] = stage[:, at + 1]
    return out


def _vfused_row_pass(vx, b, sigma):
    """panel_wide_row_kernel's kVfused: a = Fx(t Fx^H(b)) of the waves b (B,
    n, n), t = exp(i sigma V), V = Re(Fx^H(vx)).  Per row: vx's row in
    layout 1, exchanged to layout 3 and through the inverse transform, its
    real part kept in layout 1 and t formed once for all the waves; then
    b's row as in the row pass."""
    n = b.shape[-1]
    rows1 = _pos(n, 1)
    v = _inverse(n, _exchange(n, vx[:, rows1], 1, 3)).real  # (n rows, T, R)
    x = _inverse(n, _exchange(n, b[..., rows1], 1, 3)) * np.exp(1j * sigma * v)
    a = np.empty(b.shape, dtype=complex)
    a[..., rows1] = _exchange(n, _forward(n, x), 3, 1)
    return a


def _g_row_pass(g):
    """panel_wide_g_row_kernel: Fx of the real rows of planes g (nsp, n, n).
    Per row: the reals in layout 1, the imaginary parts 0 in registers, the
    forward transform (to layout 3), the exchange from layout 3 to layout 1
    and the store at the positions of layout 1."""
    n = g.shape[-1]
    rows1 = _pos(n, 1)
    x = g[..., rows1].astype(complex)
    out = np.empty(g.shape, dtype=complex)
    out[..., rows1] = _exchange(n, _forward(n, x), 3, 1)
    return out


def _x_row_pass(z, inverse):
    """panel_wide_x_row_kernel: the transform-only row pass over the rows of
    the waves z (B, n, n).  Per row: the row in layout 1; kFinal (``inverse``)
    the exchange to layout 3 and the inverse transform, natural order out
    (psi = Fx^H(b), b's x spectrum bit-reversed); kFwd the forward transform
    and the exchange from layout 3 back to layout 1 (Fx(g), the spectrum
    bit-reversed at its positions); the row stored from layout 1."""
    n = z.shape[-1]
    rows1 = _pos(n, 1)
    out = np.empty(z.shape, dtype=complex)
    if inverse:
        out[..., rows1] = _inverse(n, _exchange(n, z[..., rows1], 1, 3))
    else:
        out[..., rows1] = _exchange(n, _forward(n, z[..., rows1]), 3, 1)
    return out


def _flat_rows(n: int, waves: int, resident: int):
    """The rows each group of the transform-only kernel takes, in order (the
    g row kernel's walk over a flat range of waves * n rows): blocks =
    min(resident, ceil(rows / groups a block)), group j of block k starts at
    row k + j * blocks and steps blocks * groups rows.  {(block, group):
    rows}."""
    groups = ROW_THREADS // _shape(n)[2]
    rows = waves * n
    blocks = min(resident, -(-rows // groups))
    return {(k, j): list(range(k + j * blocks, rows, blocks * groups))
            for k in range(blocks) for j in range(groups)}


# ---- the transform and the layouts against np.fft -------------------------------


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
def test_rounds_transform_is_the_dft(n):
    """The three-round forward transform of rows (one to eight warps a
    transform) is their DFT at bit-reversed positions, and the inverse takes
    it back (times n), in float64."""
    rng = np.random.default_rng(n)
    rows = _cplx(rng, 3, n)
    got = _rows_forward(rows)
    want = np.fft.fft(rows, axis=-1)[..., _bitrev(n)]
    assert np.abs(got - want).max() <= EXACT * np.abs(want).max()
    back = _rows_inverse(got)
    assert np.abs(back - n * rows).max() <= EXACT * n * np.abs(rows).max()


@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_layouts_twiddles_and_banks(n):
    """16 values a thread past 512 points, 16 at 2048 and 4096 with four and
    eight warps; each layout covers the n positions once; every twiddle read
    lies in the staged table, a warp's round-1 reads are 32 adjacent entries
    and round 2's 2^b; 16 lanes' accesses of an exchange fall on 16 bank
    pairs, but those of layout 1 between layouts 1 and 3 at R = 8 (2
    ways)."""
    big, r, tt, b = _shape(n)
    assert (tt // 32, 1 << r) == {256: (1, 8), 2048: (4, 16), 4096: (8, 16)}[n]
    for layout in (1, 2, 3):
        assert sorted(_pos(n, layout).ravel().tolist()) == list(range(n))
    t = np.arange(tt)
    for j in range(r):  # round 1 of the warp of lanes 0..31, register 0
        idx = (tt << j) - 1 + t[:32]
        assert int(idx.max()) < n - 1 and len(set(idx.tolist())) == 32
    for j in range(r):  # round 2
        idx = (1 << (b + j)) - 1 + (t[:32] & ((1 << b) - 1))
        assert int(idx.max()) < n - 1 and len(set(idx.tolist())) == min(32, 1 << b)
    for fr, to in ((1, 2), (2, 3), (1, 3), (3, 1)):
        for layout in (fr, to):
            places = _pad(n, fr, to, _pos(n, layout))
            for m in range(1 << r):
                for half in range(0, tt, 16):
                    banks = (places[half: half + 16, m] % 16).tolist()
                    ways = max(banks.count(k) for k in banks)
                    assert ways == (2 if (r == 3 and {fr, to} == {1, 3} and layout == 1) else 1)


@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_column_item_covers_its_columns_once(n):
    """A column item's 16-byte copies and stores cover each (row, column) of
    its C columns once, the pair of a copy side by side in the stage; the
    groups' registers read each once; 16 lanes reading one column fall on 8
    bank pairs at C = 4 (the swizzle; 4 without it) and 8 at C = 2; the
    groups' padded buffers fit the stage."""
    cols = _cols(n)
    y, c, at = _fetch_map(n, cols)
    cells = sorted(zip(y.tolist(), c.tolist())) + sorted(zip(y.tolist(), (c + 1).tolist()))
    assert sorted(cells) == [(yy, cc) for yy in range(n) for cc in range(cols)]
    places = np.concatenate([at, at + 1])
    assert len(set(places.tolist())) == cols * n and int(places.max()) < cols * n
    assert np.array_equal(_stage_at(y, c + 1, cols), at + 1) and not (at % 2).any()
    reads = np.stack([_stage_at(_pos(n, 1), g, cols) for g in range(cols)])
    assert sorted(reads.ravel().tolist()) == list(range(cols * n))
    for g in range(cols):
        for m in range(reads.shape[-1]):
            for half in range(0, reads.shape[1], 16):
                assert len(set((reads[g, half: half + 16, m] % 16).tolist())) == 8
    if cols == 4:
        plain = 4 * np.arange(16)
        assert len(set((plain % 16).tolist())) == 4
    _, r, _, _ = _shape(n)
    assert cols * (n + n // (1 << r)) >= cols * n


@pytest.mark.parametrize("n", [256, 2048, 4096])
def test_row_item_covers_its_row_once(n):
    """A row group's registers hold each element of its row once in layout 1,
    which a warp loads 256 contiguous bytes at a time, and the backward row
    kernel's 256-thread blocks hold whole groups."""
    _, _, tt, _ = _shape(n)
    rows1 = _pos(n, 1)
    assert sorted(rows1.ravel().tolist()) == list(range(n))
    for m in range(rows1.shape[1]):
        assert np.array_equal(np.diff(rows1[:32, m]), np.ones(31, dtype=int))
    assert ROW_THREADS % tt == 0 and ROW_THREADS // tt >= 1


@pytest.mark.parametrize("n,waves", [(256, 1), (256, 8), (2048, 1), (2048, 4), (4096, 4)])
def test_flat_rows_cover_each_row_once(n, waves):
    """The transform-only kernel's groups (two 256-thread blocks an SM on 132
    SMs, at most one block a group's worth of rows) take every row of the
    waves once, so in place (src = dst) a row is read and written by one
    group alone, which reads it (a row ahead) before it writes it; four
    waves at 2048^2 give every resident group a row."""
    walk = _flat_rows(n, waves, 2 * 132)
    taken = sorted(y for rows in walk.values() for y in rows)
    assert taken == list(range(waves * n))
    busy = sum(1 for rows in walk.values() if rows)
    if (n, waves) == (2048, 4):
        assert busy == len(walk) == 2 * 132 * 2


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,waves", [(256, 1), (256, 4), (1024, 2), (2048, 1)])
def test_model_x_row_pass_is_the_plain_pass(n, waves, inverse):
    """The model's transform-only row pass against panel_final_ref (kFinal:
    psi = Fx^H(b)) and panel_rowfwd_ref (kFwd: Fx(g)) in complex128, the rows
    of all the waves alike."""
    rng = np.random.default_rng(n + 19 * waves + int(inverse))
    z = _cplx(rng, waves, n, n)
    plain = ps.panel_final_ref if inverse else ps.panel_rowfwd_ref
    ref = plain(torch.as_tensor(z)).numpy()
    got = _x_row_pass(z, inverse)
    assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()


@pytest.mark.parametrize("n", [256, 2048])
def test_model_passes_are_the_plain_passes(n):
    """The model's column pass (and its conjugate) and backward row pass
    against the plain passes in complex128, one wave at 2048^2 and two with
    per-wave P at 256^2."""
    rng = np.random.default_rng(n + 1)
    b = 2 if n == 256 else 1
    a, s = _cplx(rng, b, n, n), _cplx(rng, b, n, n)
    v = rng.uniform(0, 2000, (n, n))
    prop = np.exp(1j * rng.uniform(0, 6.28, (b, n, n) if b > 1 else (n, n)))
    br = _bitrev(n)
    prepared = prop[..., br[:, None], br[None, :]]
    for conj in (False, True):
        got = _col_pass(a, prepared, conj)
        ref = (ps.panel_col_bwd_ref if conj else ps.panel_colpass_ref)(
            torch.as_tensor(a), torch.as_tensor(prop)).numpy()
        assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()
    out, dv = _bwd_row_pass(a, s, v, SIGMA)
    ref_out, ref_dv = ps.panel_row_bwd_loop_ref(0, torch.as_tensor(v[None]),
                                                torch.as_tensor(s[:, None]), torch.as_tensor(a),
                                                SIGMA)
    assert np.abs(out - ref_out.numpy()).max() <= EXACT * np.abs(ref_out.numpy()).max()
    assert np.abs(dv - ref_dv.numpy()).max() <= 1e-10 * np.abs(ref_dv.numpy()).max()
    tail, dv_t = _bwd_row_pass(a, s, v, SIGMA, forward=False, from_psi=True)
    ref_tail, ref_dv_t = ps.panel_bwd_tail_ref(torch.as_tensor(v), torch.as_tensor(s),
                                               torch.as_tensor(a), SIGMA)
    assert np.abs(tail - ref_tail.numpy()).max() <= EXACT * np.abs(ref_tail.numpy()).max()
    assert np.abs(dv_t - ref_dv_t.numpy()).max() <= 1e-10 * np.abs(ref_dv_t.numpy()).max()


@pytest.mark.parametrize("n,waves", [(256, 2), (1024, 1), (2048, 1)])
def test_model_row_pass_is_the_plain_pass(n, waves):
    """The model's forward row pass, a and s_j, against panel_rowpass_stack_ref
    and panel_rowpass_stack_store_ref in complex128; with two waves t is
    formed once for both."""
    rng = np.random.default_rng(n + 7)
    b = _cplx(rng, waves, n, n)
    v = rng.uniform(0, 2000, (2, n, n))
    a, s = _row_pass(b, v[1], SIGMA, store=True)
    vt, bt = torch.as_tensor(v), torch.as_tensor(b)
    ref = ps.panel_rowpass_stack_ref(1, vt, bt, SIGMA).numpy()
    ref_a, ref_s = (z.numpy() for z in ps.panel_rowpass_stack_store_ref(1, vt, bt, SIGMA))
    assert np.abs(a - ref).max() <= EXACT * np.abs(ref).max()
    assert np.abs(a - ref_a).max() <= EXACT * np.abs(ref_a).max()
    assert np.abs(s - ref_s).max() <= EXACT * np.abs(ref_s).max()
    assert np.array_equal(_row_pass(b, v[1], SIGMA), a)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("n,waves", [(256, 1), (256, 2), (2048, 1), (2048, 2)])
def test_model_row_abs_pass_is_the_plain_pass(n, waves, init):
    """The model's absorptive row pass (kMidAbs) against
    panel_rowpass_stack_abs_ref on V_1 of a two-slice stack, and its init
    (kInitAbs) against panel_init_abs_ref, in complex128: Vr in [0, 2000)
    (phases up to 1.3 rad), Vi = 0.1 |Vr| (the absorptive factor of
    sim.absorptive_factor=0.1); with two waves t is formed once for both."""
    rng = np.random.default_rng(n + 17 * waves + int(init))
    b = _cplx(rng, waves, n, n)
    vr = rng.uniform(0, 2000, (2, n, n))
    vi = 0.1 * np.abs(vr)
    vrt, vit, bt = torch.as_tensor(vr), torch.as_tensor(vi), torch.as_tensor(b)
    if init:
        got = _row_abs_pass(b, vr[0], vi[0], SIGMA, init=True)
        ref = ps.panel_init_abs_ref(vrt[0], vit[0], bt, SIGMA).numpy()
    else:
        got = _row_abs_pass(b, vr[1], vi[1], SIGMA)
        ref = ps.panel_rowpass_stack_abs_ref(1, vrt, vit, bt, SIGMA).numpy()
    assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()


@pytest.mark.parametrize("vc", [False, True])
@pytest.mark.parametrize("n,waves", [(256, 1), (256, 2), (2048, 1), (2048, 2)])
def test_model_init_pass_is_the_plain_pass(n, waves, vc):
    """The model's init of a real V (kInit) against panel_init_ref in
    complex128, V_0 in [0, 2000) (phases up to 1.3 rad); with ``vc`` V_0 the
    real parts of a complex plane (kInitVc: the imaginary parts ignored); with
    two waves t is formed once for both."""
    rng = np.random.default_rng(n + 29 * waves + int(vc))
    psi = _cplx(rng, waves, n, n)
    v0 = rng.uniform(0, 2000, (n, n))
    plane = v0 + 1j * rng.uniform(-2000, 2000, (n, n)) if vc else v0
    ref = ps.panel_init_ref(torch.as_tensor(v0), torch.as_tensor(psi), SIGMA).numpy()
    got = _init_pass(psi, plane, SIGMA)
    assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()


@pytest.mark.parametrize("n,nsp", [(256, 1), (256, 2), (2048, 1), (2048, 2)])
def test_model_build_col_pass_is_the_plain_pass(n, nsp):
    """The model's build column pass against panel_build_colpass_ref in
    complex128, one species (kColBuild) and two summed in registers
    (kColBuildSum)."""
    rng = np.random.default_rng(n + nsp)
    gx, fp = _cplx(rng, nsp, n, n), rng.uniform(0, 1, (nsp, n, n))
    got = _build_col_pass(gx, fp)
    ref = ps.panel_build_colpass_ref(torch.as_tensor(gx), torch.as_tensor(fp)).numpy()
    assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()


@pytest.mark.parametrize("n,waves", [(256, 1), (256, 2), (2048, 1), (2048, 2)])
def test_model_vfused_row_pass_is_the_plain_pass(n, waves):
    """The model's fused row pass against panel_vfused_rowpass_ref in
    complex128, V's x spectrum of a potential in [0, 2000) (phases up to 1.3
    rad); with two waves V is built and t formed once for both."""
    rng = np.random.default_rng(n + 11 * waves)
    b = _cplx(rng, waves, n, n)
    vx = np.fft.fft(rng.uniform(0, 2000, (n, n)), axis=-1)[:, _bitrev(n)] / n
    got = _vfused_row_pass(vx, b, SIGMA)
    ref = ps.panel_vfused_rowpass_ref(torch.as_tensor(vx), torch.as_tensor(b), SIGMA).numpy()
    assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()


@pytest.mark.parametrize("n,nsp", [(256, 1), (256, 2), (2048, 1), (2048, 2)])
def test_model_g_row_pass_is_the_plain_pass(n, nsp):
    """The model's g row pass against panel_g_rowpass_ref in complex128, one
    plane (one species) and two, the rows of both in one launch."""
    rng = np.random.default_rng(n + 13 * nsp)
    g = rng.uniform(0, 1, (nsp, n, n))
    got = _g_row_pass(g)
    ref = ps.panel_g_rowpass_ref(torch.as_tensor(g)).numpy()
    assert np.abs(got - ref).max() <= EXACT * np.abs(ref).max()


# ---- the model's passes against the JAX package ---------------------------------


def _jax_order(n: int) -> np.ndarray:
    """The x spectrum's order between the JAX panel passes: position q * 128 +
    k1 holds frequency k1 * r + q, r = n / 128 (fused_step._prepared_prop)."""
    return np.arange(n).reshape(BASE, n // BASE).T.reshape(n)


@pytest.fixture(scope="module")
def jax_passes():
    """The JAX panel passes at 256^2 in interpret mode, the panel extents
    patched to 64 rows and 128 columns (as tests/test_torch_panel_grad.py
    runs them): colpass, col_bwd, row_bwd_loop, the forward row passes
    (panel_rowpass_stack, _panel_rowpass_mid_store) on one plane, and the
    streamed build's g row and column passes (_panel_g_rowpass,
    _panel_build_colpass, the species' planes at once) and fused row pass
    (_panel_vfused_rowpass, one plane), the absorptive row pass and init
    (_panel_rowpass_stack_abs, _panel_init_abs, one plane), the init of a
    real V (panel_init, one plane), and the final pass and the seed
    (panel_final, panel_rowfwd, one plane)."""
    import fdes_tpu.pallas.panel_scan as jps

    tabs = jps._tables(N_JAX)
    prec = jax.lax.Precision.HIGHEST
    mp = pytest.MonkeyPatch()
    mp.setattr(jps, "_ROWS", 64)
    mp.setattr(jps, "_COLS", 128)

    def col(a, prop, bwd):
        pl = jps._prepared_prop(jnp.asarray(prop), N_JAX)
        fn = jps._panel_col_bwd if bwd else jps.panel_colpass
        re, im = fn(jnp.asarray(a.real), jnp.asarray(a.imag), jnp.real(pl), jnp.imag(pl), tabs,
                    prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def row_bwd_loop(bar, s, v):
        re, im, dv = jps._panel_row_bwd_loop(
            0, jnp.asarray(v[None]), jnp.asarray(s.real[None]), jnp.asarray(s.imag[None]),
            jnp.asarray(bar.real), jnp.asarray(bar.imag), tabs, SIGMA, prec, True)
        return np.asarray(re) + 1j * np.asarray(im), np.asarray(dv)

    def row(b, v_stack, j, store):
        fn = jps._panel_rowpass_mid_store if store else jps.panel_rowpass_stack
        outs = [np.asarray(z) for z in fn(j, jnp.asarray(v_stack), jnp.asarray(b.real),
                                          jnp.asarray(b.imag), tabs, SIGMA, prec, True)]
        a = outs[0] + 1j * outs[1]
        return (a, outs[2] + 1j * outs[3]) if store else a

    def build_col(gx, ffp):
        re, im = jps._panel_build_colpass(jnp.asarray(gx.real), jnp.asarray(gx.imag),
                                          jnp.asarray(ffp), tabs, prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def g_row(g):
        re, im = jps._panel_g_rowpass(jnp.asarray(g), tabs, prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def vfused_row(vx, b):
        re, im = jps._panel_vfused_rowpass(jnp.asarray(vx.real), jnp.asarray(vx.imag),
                                           jnp.asarray(b.real), jnp.asarray(b.imag), tabs, SIGMA,
                                           prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def row_abs(b, vr_stack, vi_stack, j):
        re, im = jps._panel_rowpass_stack_abs(j, jnp.asarray(vr_stack), jnp.asarray(vi_stack),
                                              jnp.asarray(b.real), jnp.asarray(b.imag), tabs,
                                              SIGMA, prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def xform(z, inverse):
        fn = jps.panel_final if inverse else jps.panel_rowfwd
        re, im = fn(jnp.asarray(z.real), jnp.asarray(z.imag), tabs, prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def init_abs(psi, vr0, vi0):
        re, im = jps._panel_init_abs(jnp.asarray(vr0), jnp.asarray(vi0), jnp.asarray(psi.real),
                                     jnp.asarray(psi.imag), tabs, SIGMA, prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    def init(psi, v0):
        re, im = jps.panel_init(jnp.asarray(v0), jnp.asarray(psi.real), jnp.asarray(psi.imag),
                                tabs, SIGMA, prec, True)
        return np.asarray(re) + 1j * np.asarray(im)

    yield {"col": col, "row_bwd_loop": row_bwd_loop, "row": row, "build_col": build_col,
           "vfused_row": vfused_row, "g_row": g_row, "row_abs": row_abs, "init_abs": init_abs,
           "init": init, "xform": xform}
    mp.undo()


@pytest.fixture(scope="module")
def jax_fields():
    """complex64-valued inputs at 256^2: two x-spectrum planes in natural
    order, two s planes, a potential and two tilted propagators."""
    rng = np.random.default_rng(41)
    n = N_JAX
    grid = Grid(ny=n, nx=n, py=0.3, px=0.3)
    lam = wavelength_A(300e3)
    props = np.stack([fresnel_propagator(grid, lam, 1.8, tilt_xy_rad=t)
                      for t in ((0.02, 0.01), (-0.01, 0.03))]).astype(np.complex64)
    return {"x": _cplx(rng, 2, n, n).astype(np.complex64),
            "s": _cplx(rng, 2, n, n).astype(np.complex64),
            "v": (rng.normal(size=(n, n)) * 25.0).astype(np.float32), "props": props,
            "f": rng.uniform(0, 1, (2, n, n)).astype(np.float32),
            "vx": (np.fft.fft(rng.uniform(0, 2000, (n, n)), axis=-1) / n).astype(np.complex64)}


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("waves,per_wave_p", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("conj", [False, True])
def test_model_column_pass_equals_jax(jax_passes, jax_fields, waves, per_wave_p, conj):
    """The model's column pass (conj: with conj(P), the adjoint) against
    JAX's panel_colpass (_panel_col_bwd), one plane a call, on the same
    natural-order x spectrum placed in each package's order (bit-reversed
    here, JAX's digit order there).  JAX's adjoint is the transpose (its
    bilinear gradient convention): conj(C^T(conj(a))) is this one's C^H a."""
    f = jax_fields
    n = N_JAX
    x = f["x"][:waves]
    props = f["props"][:waves] if per_wave_p else np.broadcast_to(f["props"][0], (waves, n, n))
    br, jo = _bitrev(n), _jax_order(n)
    want = []
    for k in range(waves):
        a = x[k][:, jo]
        out = (np.conj(jax_passes["col"](np.conj(a), props[k], True)) if conj
               else jax_passes["col"](a, props[k], False))
        nat = np.empty_like(out)
        nat[:, jo] = out
        want.append(nat[:, br])
    p = props if per_wave_p else props[0]
    prepared = p[..., br[:, None], br[None, :]].astype(np.complex128)
    got = _col_pass(x[..., br].astype(np.complex128), prepared, conj)
    _close(got, np.stack(want))


@pytest.mark.parametrize("waves", [1, 2])
def test_model_backward_row_pass_equals_jax(jax_passes, jax_fields, waves):
    """The model's backward row pass (kBwdLoop) against JAX's
    _panel_row_bwd_loop, a wave at a time, dV summed over the waves.  JAX
    hands the conjugate cotangent: it gets conj(bar) and returns
    conj(out); dV is the same."""
    f = jax_fields
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    x, s, v = f["x"][:waves], f["s"][:waves], f["v"]
    want_out, want_dv = [], np.zeros((n, n))
    for k in range(waves):
        out, dv = jax_passes["row_bwd_loop"](np.conj(x[k][:, jo]), s[k], v)
        nat = np.empty_like(out)
        nat[:, jo] = np.conj(out)
        want_out.append(nat[:, br])
        want_dv = want_dv + dv
    got_out, got_dv = _bwd_row_pass(x[..., br].astype(np.complex128), s.astype(np.complex128),
                                    v.astype(np.float64), SIGMA)
    _close(got_out, np.stack(want_out))
    _close(got_dv, want_dv)


@pytest.mark.parametrize("waves", [1, 2])
@pytest.mark.parametrize("store", [False, True])
def test_model_row_pass_equals_jax(jax_passes, jax_fields, waves, store):
    """The model's forward row pass against JAX's panel_rowpass_stack (row 15)
    and, with the store of s_j, _panel_rowpass_mid_store (row 23), a wave at a
    time on V_1 of a two-slice stack: a in each package's x-spectrum order,
    s_j in natural order in both."""
    f = jax_fields
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    x = f["x"][:waves]
    v_stack = np.stack([0.5 * f["v"], f["v"]])
    want_a, want_s = [], []
    for k in range(waves):
        got = jax_passes["row"](x[k][:, jo], v_stack, 1, store)
        out, s = got if store else (got, None)
        nat = np.empty_like(out)
        nat[:, jo] = out
        want_a.append(nat[:, br])
        want_s.append(s)
    got = _row_pass(x[..., br].astype(np.complex128), v_stack[1].astype(np.float64), SIGMA,
                    store)
    got_a, got_s = got if store else (got, None)
    _close(got_a, np.stack(want_a))
    if store:
        _close(got_s, np.stack(want_s))


@pytest.mark.parametrize("waves", [1, 2])
@pytest.mark.parametrize("init", [False, True])
def test_model_row_abs_pass_equals_jax(jax_passes, jax_fields, waves, init):
    """The model's absorptive row pass against JAX's _panel_rowpass_stack_abs
    (row 19) on V_1 of a two-slice stack, and its init against
    _panel_init_abs (row 18) on V_0, a wave at a time, Vi = 0.1 |Vr|: b in
    each package's x-spectrum order (the init's psi natural in both), a in
    each package's order."""
    f = jax_fields
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    x = f["x"][:waves]
    vr = np.stack([0.5 * f["v"], f["v"]])
    vi = 0.1 * np.abs(vr)
    want = []
    for k in range(waves):
        out = (jax_passes["init_abs"](x[k], vr[0], vi[0]) if init
               else jax_passes["row_abs"](x[k][:, jo], vr, vi, 1))
        nat = np.empty_like(out)
        nat[:, jo] = out
        want.append(nat[:, br])
    j = 0 if init else 1
    b = x if init else x[..., br]
    got = _row_abs_pass(b.astype(np.complex128), vr[j].astype(np.float64),
                        vi[j].astype(np.float64), SIGMA, init=init)
    _close(got, np.stack(want))


@pytest.mark.parametrize("waves", [1, 2])
@pytest.mark.parametrize("vc", [False, True])
def test_model_init_pass_equals_jax(jax_passes, jax_fields, waves, vc):
    """The model's init of a real V (row 13) against JAX's panel_init, a wave
    at a time: psi natural in both, a in each package's x-spectrum order;
    with ``vc`` the model reads V_0 as the real parts of a complex plane (the
    streamed rollout's init), JAX its real V_0."""
    f = jax_fields
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    x, v0 = f["x"][:waves], f["v"]
    want = []
    for k in range(waves):
        nat = np.empty_like(x[k])
        nat[:, jo] = jax_passes["init"](x[k], v0)
        want.append(nat[:, br])
    plane = v0 + 1j * f["s"][0].real if vc else v0
    got = _init_pass(x.astype(np.complex128), plane.astype(np.complex128 if vc else np.float64),
                     SIGMA)
    _close(got, np.stack(want))


def test_absorptive_v_reads_a_complex_stack_in_place():
    """absorptive_v hands the kernels a complex64 V's own storage when Vr and
    Vi are its .real and .imag views (the stack, or one slice of it: equal
    data_ptr, no copy), and packs any other pair of planes once, exactly
    (separate float32 planes, float64 ones, strided or swapped views)."""
    rng = np.random.default_rng(3)
    v = torch.as_tensor(_cplx(rng, 3, 8, 8).astype(np.complex64))
    for z in (v, v[1]):
        got = ps.absorptive_v(z.real, z.imag)
        assert got.data_ptr() == z.data_ptr() and got.dtype == torch.complex64
        assert got.is_contiguous() and torch.equal(got, z)
    vr, vi = v.real.clone(), v.imag.clone()
    packed = ps.absorptive_v(vr, vi)
    assert packed.data_ptr() not in (v.data_ptr(), vr.data_ptr(), vi.data_ptr())
    assert packed.is_contiguous() and torch.equal(packed, v)
    for a, b in ((v.imag, v.real), (v.real[:, ::2], v.imag[:, ::2]),
                 (v.real.double(), v.imag.double()), (v.real.transpose(1, 2),
                                                       v.imag.transpose(1, 2))):
        got = ps.absorptive_v(a, b)
        assert got.dtype == torch.complex64 and got.is_contiguous()
        assert torch.equal(got, torch.complex(a.float(), b.float()))
        assert got.data_ptr() != v.data_ptr()


@pytest.mark.parametrize("nsp", [1, 2])
def test_model_build_col_pass_equals_jax(jax_passes, jax_fields, nsp):
    """The model's build column pass against JAX's _panel_build_colpass on
    the same natural-order x spectra of nsp species and the same real factors
    (natural in both axes), each placed in its package's order: x spectra and
    the output's columns bit-reversed here and in JAX's digit order there,
    the factors in both axes so (as prepare_factors' and _permuted_factors'
    panels, tests/test_torch_streamed.py)."""
    f = jax_fields
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    gx, fac = f["x"][:nsp], f["f"][:nsp]
    out = jax_passes["build_col"](gx[..., jo], fac[:, jo[:, None], jo[None, :]])
    nat = np.empty_like(out)
    nat[:, jo] = out
    got = _build_col_pass(gx[..., br].astype(np.complex128),
                          fac[:, br[:, None], br[None, :]].astype(np.float64))
    _close(got, nat[:, br])


@pytest.mark.parametrize("waves", [1, 2])
def test_model_vfused_row_pass_equals_jax(jax_passes, jax_fields, waves):
    """The model's fused row pass against JAX's _panel_vfused_rowpass, a wave
    at a time, V's x spectrum and the waves in each package's x-spectrum
    order."""
    f = jax_fields
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    x, vx = f["x"][:waves], f["vx"]
    want = []
    for k in range(waves):
        out = jax_passes["vfused_row"](vx[:, jo], x[k][:, jo])
        nat = np.empty_like(out)
        nat[:, jo] = out
        want.append(nat[:, br])
    got = _vfused_row_pass(vx[:, br].astype(np.complex128), x[..., br].astype(np.complex128),
                           SIGMA)
    _close(got, np.stack(want))


@pytest.mark.parametrize("nsp", [1, 2])
def test_model_g_row_pass_equals_jax(jax_passes, jax_fields, nsp):
    """The model's g row pass against JAX's _panel_g_rowpass on the same real
    planes (the species' delta planes, natural order), the x spectrum in each
    package's order: bit-reversed here, JAX's digit order there."""
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    g = jax_fields["f"][:nsp]
    out = jax_passes["g_row"](g)
    nat = np.empty_like(out)
    nat[..., jo] = out
    _close(_g_row_pass(g.astype(np.float64)), nat[..., br])


@pytest.mark.parametrize("waves", [1, 2])
@pytest.mark.parametrize("inverse", [False, True])
def test_model_x_row_pass_equals_jax(jax_passes, jax_fields, waves, inverse):
    """The model's transform-only row pass against JAX's panel_final (row 17:
    the x spectrum in each package's order in, psi natural out) and
    panel_rowfwd (row 20: g natural in, the x spectrum in each package's
    order out), a wave at a time."""
    n = N_JAX
    br, jo = _bitrev(n), _jax_order(n)
    x = jax_fields["x"][:waves]
    want = []
    for k in range(waves):
        if inverse:
            want.append(jax_passes["xform"](x[k][:, jo], True))
        else:
            nat = np.empty_like(x[k])
            nat[:, jo] = jax_passes["xform"](x[k], False)
            want.append(nat[:, br])
    got = _x_row_pass((x[..., br] if inverse else x).astype(np.complex128), inverse)
    _close(got, np.stack(want))


# ---- the route ---------------------------------------------------------------


def test_panel_route_is_the_table():
    """PANEL_ROUTE covers the panel sizes and the measured wave counts;
    panel_route reads it by (n, b) alone: a measured count takes its row, a
    count between rows the row below, one above the last the last; every
    entry names a route of the C entry points, whose codes match their
    enums, and each route's kernel is one the library builds."""
    assert set(ps.PANEL_ROUTE) == set(ps.SIZES)
    assert ps.KINDS == ("col", "bwd_row", "row", "row_store", "build_col", "row_abs", "init")
    for n, rows in ps.PANEL_ROUTE.items():
        measured = sorted(rows)
        assert measured == [1, 2, 4, 8]
        assert all(len(entry) == len(ps.KINDS) for entry in rows.values())
        for k, kind in enumerate(ps.KINDS):
            for b in range(1, 20):
                want = rows[max(m for m in measured if m <= b)][k]
                assert ps.panel_route(n, b, kind) == want and want in ps.ROUTES
    for bad in ("fwd_row", "rows", "store", "build", "vfused", "vfused_row", "g_row", "abs",
                "xform_row", "final"):
        with pytest.raises(ValueError, match="kind must be"):
            ps.panel_route(2048, 1, bad)
    src = (_build.SRC_DIR / "panel_scan.cu").read_text()
    enum = re.search(r"enum Route \{ kRouteTile = (\d), kRouteWide = (\d) \}", src)
    assert enum and [int(g) for g in enum.groups()] == [ps.ROUTES[k] for k in ("tile", "wide")]
    for kernel in ("panel_col_kernel", "panel_wide_col_kernel", "panel_bwd_row_kernel",
                   "panel_wide_bwd_row_kernel", "panel_row_kernel", "panel_wide_row_kernel",
                   "panel_build_col_kernel", "panel_wide_g_row_kernel", "panel_wide_x_row_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s*{kernel}\(", src)
    for mode in ("kColBuild", "kColBuildSum", "kVfused"):
        assert re.search(rf"launch_wide_(col|row)<LOG2N, {mode}>", src)
    # rows 19 and 18: the tile kernel on the complex plane, or the wide modes
    assert re.search(r"launch_row<LOG2N, MODE, true, true>", src)
    assert re.search(r"launch_wide_row<LOG2N, MODE == kInit \? kInitAbs : kMidAbs>", src)
    # row 13: the tile kernel or the wide kInit (kInitVc reading a complex
    # plane's real parts), on its route in the rollout, the streamed rollout
    # and its entry point
    assert re.search(r"launch_row<LOG2N, kInit, false, VC>", src)
    assert re.search(r"launch_wide_row<LOG2N, VC \? kInitVc : kInit>", src)
    for call in (r"<LOG2N>\(init_route, psi0, out, v,", r"<LOG2N, true>\(init_route, psi0, out, gx,",
                 r"<L, true>\(route, c2\(psi\)", r"<L>\(route, c2\(psi\)"):
        assert re.search(rf"launch_init_route{call}", src)
    # rows 27 and 29 have one kernel each, not routed, which the streamed
    # rollout launches; row 29's tile kernel is gone
    assert re.search(r"launch_g_row<LOG2N>\(g, gx, nsp", src)
    assert re.search(r"launch_vfused<LOG2N>\(vx, out, out", src)
    assert "panel_vfused_row_kernel" not in src
    # rows 17 and 20 have one kernel, the transform-only one, in every loop
    # and in their entry point; the tile kernel's forms of them are gone
    for call in (r"kFinal>\(out, out, nwaves", r"kFwd>\(g, dpsi, nwaves", r"kFinal>\(vx, gx, 1",
                 r"kFinal>\(c2\(b\)", r"kFwd>\(c2\(b\)"):
        assert re.search(rf"launch_x_row<(LOG2N|L), {call}", src)
    assert not re.search(r"launch_row<(LOG2N|L), k(Final|Fwd)>", src)
    assert "panel_scan" in _build.sources()


def test_route_argument_is_checked():
    """route= takes "tile" or "wide" and nothing else, on the CPU too: the
    column, backward row and stack row passes, the absorptive row pass and
    its init, the init of a real V, and the streamed build's column pass."""
    n = 256
    a = torch.zeros((1, n, n), dtype=torch.complex64)
    pp = torch.ones((n, n), dtype=torch.complex64)
    v = torch.zeros((2, n, n))
    for bad in ("cluster", "Wide", "", "wide_flat"):
        with pytest.raises(ValueError, match="route must be"):
            ps._colpass(a, pp, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_row_bwd_loop(1, v, a[:, None].expand(1, 2, n, n), a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_row_bwd_last(v[0], a, a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_bwd_tail(v[0], a, a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_rowpass_stack(1, v, a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_rowpass_stack_store(1, v, a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_build_colpass(a, v[:1], route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_rowpass_stack_abs(1, v, v, a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_init_abs(v[0], v[1], a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_init(v[0], a, SIGMA, route=bad)
        with pytest.raises(ValueError, match="route must be"):
            ps.panel_rowpass(v[0], a, SIGMA, route=bad)
    # the final and the seed have one kernel: no route to name
    for wrapper in (ps.panel_final, ps.panel_rowfwd):
        assert wrapper not in ps.ROUTED
        with pytest.raises(TypeError):
            wrapper(a, route="wide")


@pytest.mark.parametrize("route", [None, "tile", "wide", "cluster", "Tile"])
def test_rowpass_of_one_plane_takes_a_route(route):
    """panel_rowpass (row 16: one V plane, row 15's kind "row" on a stack of
    one) takes route= as the stack row pass does: on the CPU each valid
    name (or none, the table's) is the plain version, one and two waves, and
    no count moves; another name raises ValueError."""
    rng = np.random.default_rng(16)
    n = 256
    v = torch.as_tensor(rng.uniform(0, 2000, (n, n)).astype(np.float32))
    ps.reset_launches()
    for lead in ((), (2,)):
        b = torch.as_tensor(_cplx(rng, *lead, n, n).astype(np.complex64))
        if route not in (None, *ps.ROUTES):
            with pytest.raises(ValueError, match="route must be"):
                ps.panel_rowpass(v, b, SIGMA, route=route)
            continue
        got = ps.panel_rowpass(v, b, SIGMA, route=route)
        assert torch.equal(got, ps.panel_rowpass_ref(v, b, SIGMA))
        assert torch.equal(got, ps.panel_rowpass_stack_ref(0, v[None], b, SIGMA))
    assert ps.panel_rowpass.launches == 0
    assert ps.panel_rowpass.launches_by_route == {"tile": 0, "wide": 0}


def test_wide_wrappers_count_their_own_launches():
    """The routed wrappers (ROUTED, among WRAPPERS) count their launches by
    kernel as well as in all; on the CPU each, with either route named, is
    the plain version, and no count moves: only a launch on the card does."""
    assert all(w in ps.WRAPPERS for w in ps.ROUTED)
    rng = np.random.default_rng(5)
    n = 256
    a = torch.as_tensor(_cplx(rng, n, n).astype(np.complex64))
    s = torch.as_tensor(_cplx(rng, 2, n, n).astype(np.complex64))
    v = torch.as_tensor(rng.uniform(0, 2000, (2, n, n)).astype(np.float32))
    prop = torch.as_tensor(np.exp(1j * rng.uniform(0, 6.28, (n, n))).astype(np.complex64))
    ps.reset_launches()
    assert all(w.launches_by_route == {"tile": 0, "wide": 0} for w in ps.ROUTED)
    pairs = [(ps.panel_colpass(a, prop), ps.panel_colpass_ref(a, prop)),
             (ps.panel_col_bwd(a, prop), ps.panel_col_bwd_ref(a, prop))]
    for route in ps.ROUTES:
        pairs += [
            (ps.panel_row_bwd_loop(1, v, s, a, SIGMA, route=route),
             ps.panel_row_bwd_loop_ref(1, v, s, a, SIGMA)),
            (ps.panel_row_bwd_last(v[0], s[0], a, SIGMA, route=route),
             ps.panel_row_bwd_last_ref(v[0], s[0], a, SIGMA)),
            (ps.panel_bwd_tail(v[1], s[1], a, SIGMA, route=route),
             ps.panel_bwd_tail_ref(v[1], s[1], a, SIGMA)),
            (ps.panel_rowpass_stack(1, v, a, SIGMA, route=route),
             ps.panel_rowpass_stack_ref(1, v, a, SIGMA)),
            (ps.panel_rowpass_stack_store(1, v, s, SIGMA, route=route),
             ps.panel_rowpass_stack_store_ref(1, v, s, SIGMA)),
            (ps.panel_build_colpass(s, v, route=route), ps.panel_build_colpass_ref(s, v)),
            (ps.panel_rowpass_stack_abs(1, v, 0.1 * v, s, SIGMA, route=route),
             ps.panel_rowpass_stack_abs_ref(1, v, 0.1 * v, s, SIGMA)),
            (ps.panel_init_abs(v[0], 0.1 * v[0], s, SIGMA, route=route),
             ps.panel_init_abs_ref(v[0], 0.1 * v[0], s, SIGMA)),
            (ps.panel_init(v[0], s, SIGMA, route=route), ps.panel_init_ref(v[0], s, SIGMA)),
            (ps.panel_rowpass(v[1], s, SIGMA, route=route), ps.panel_rowpass_ref(v[1], s, SIGMA)),
        ]
    pairs += [(ps.panel_g_rowpass(v), ps.panel_g_rowpass_ref(v)),
              (ps.panel_vfused_rowpass(a, s, SIGMA), ps.panel_vfused_rowpass_ref(a, s, SIGMA)),
              (ps.panel_final(s), ps.panel_final_ref(s)),
              (ps.panel_rowfwd(s), ps.panel_rowfwd_ref(s))]
    for got, want in pairs:
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(w.launches == 0 for w in (*ps.WRAPPERS, *ps.LOOPS))
    assert all(w.launches_by_route == {"tile": 0, "wide": 0} for w in ps.ROUTED)


@pytest.mark.parametrize("row_route", ["tile", "wide"])
def test_loops_count_row_passes_by_route(row_route):
    """A whole loop's count (_count_loop, as panel_scan, panel_scan_store and
    panel_scan_bwd_store add their passes on the card): the S - 1 row passes
    with V_j on the row route, the column passes on the column route, the
    init of a real V on its own route, its store form and the final in all
    alone; an absorptive loop's init and row passes on the row route;
    panel_rowpass (one V plane, in no loop) is routed on its own."""
    assert ps.panel_rowpass_stack in ps.ROUTED and ps.panel_rowpass_stack_store in ps.ROUTED
    assert ps.panel_rowpass_stack_abs in ps.ROUTED and ps.panel_init_abs in ps.ROUTED
    assert ps.panel_init in ps.ROUTED and ps.panel_rowpass in ps.ROUTED
    assert ps.panel_init_store not in ps.ROUTED
    other = "tile" if row_route == "wide" else "wide"
    ps.reset_launches()
    try:
        ps._count_loop(8, ps.panel_init, ps.panel_colpass, ps.panel_rowpass_stack,
                       ps.panel_final, "wide", row_route, other)
        ps._count_loop(8, ps.panel_init_store, ps.panel_colpass, ps.panel_rowpass_stack_store,
                       ps.panel_final, "tile", row_route)
        ps._count_loop(4, ps.panel_init_abs, ps.panel_colpass, ps.panel_rowpass_stack_abs,
                       ps.panel_final, "tile", row_route)
        for w in (ps.panel_rowpass_stack, ps.panel_rowpass_stack_store):
            assert w.launches == 7 and w.launches_by_route == {row_route: 7, other: 0}
        assert ps.panel_rowpass_stack_abs.launches_by_route == {row_route: 3, other: 0}
        assert ps.panel_init_abs.launches_by_route == {row_route: 1, other: 0}
        assert ps.panel_init.launches_by_route == {row_route: 0, other: 1}
        assert ps.panel_colpass.launches_by_route == {"tile": 12, "wide": 8}
        assert (ps.panel_init.launches, ps.panel_init_store.launches,
                ps.panel_init_abs.launches, ps.panel_final.launches,
                ps.panel_rowpass_stack_abs.launches) == (1, 1, 1, 3, 3)
    finally:
        ps.reset_launches()


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide panel kernels have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def test_wide_kernels_match_plain_on_card(cuda):
    """The wide column pass (both conjugations) and the three backward row
    passes against the plain versions at 256^2 and 2048^2, two waves with
    per-wave P; dV the same bits in two runs; each launch counted on its
    wrapper under "wide"."""
    tol = 2e-6
    for n in (256, 2048):
        rng = np.random.default_rng(n)
        a = torch.as_tensor(_cplx(rng, 2, n, n).astype(np.complex64)).to(cuda)
        s = torch.as_tensor(_cplx(rng, 2, 3, n, n).astype(np.complex64)).to(cuda)
        v = torch.as_tensor(rng.uniform(0, 2000, (3, n, n)).astype(np.float32)).to(cuda)
        prop = torch.polar(torch.ones(2, n, n, device=cuda),
                           torch.as_tensor(rng.uniform(0, 6.28, (2, n, n)),
                                           dtype=torch.float32).to(cuda))
        pp = rt.prepare_propagator(prop)
        ps.reset_launches()
        for conj in (False, True):
            want = (ps.panel_col_bwd_ref if conj else ps.panel_colpass_ref)(a, prop)
            got = ps._colpass(a, pp, conj, route="wide")
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
        cases = [
            (lambda: ps.panel_row_bwd_loop(2, v, s, a, SIGMA, route="wide"),
             ps.panel_row_bwd_loop_ref(2, v, s, a, SIGMA)),
            (lambda: ps.panel_row_bwd_last(v[0], s[:, 0].contiguous(), a, SIGMA, route="wide"),
             ps.panel_row_bwd_last_ref(v[0], s[:, 0], a, SIGMA)),
            (lambda: ps.panel_bwd_tail(v[1], s[:, 1].contiguous(), a, SIGMA, route="wide"),
             ps.panel_bwd_tail_ref(v[1], s[:, 1], a, SIGMA)),
        ]
        for fn, want in cases:
            got, again = fn(), fn()
            for x, y in zip(got, want):
                assert float((x - y).abs().max()) <= 2 * tol * float(y.abs().max())
            assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert all(w.launches_by_route == {"tile": 0, "wide": w.launches} for w in ps.ROUTED)
        assert [w.launches for w in ps.ROUTED] == [1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0]


def test_wide_row_kernel_matches_plain_on_card(cuda):
    """The wide forward row pass (row 15) and its store form (row 23, s_j
    included) against the plain versions at every size, one and two waves,
    in place as the rollout runs it too; each launch counted on its wrapper
    under "wide"."""
    tol = 2e-6
    for n in ps.SIZES:
        for waves in (1, 2):
            rng = np.random.default_rng(n + waves)
            b = torch.as_tensor(_cplx(rng, waves, n, n).astype(np.complex64)).to(cuda)
            v = torch.as_tensor(rng.uniform(0, 2000, (3, n, n)).astype(np.float32)).to(cuda)
            ps.reset_launches()
            want_a, want_s = ps.panel_rowpass_stack_store_ref(2, v, b, SIGMA)
            got = ps.panel_rowpass_stack(2, v, b, SIGMA, route="wide")
            got_a, got_s = ps.panel_rowpass_stack_store(2, v, b, SIGMA, route="wide")
            for x, y in ((got, want_a), (got_a, want_a), (got_s, want_s)):
                assert float((x - y).abs().max()) <= tol * float(y.abs().max())
            flat = b.clone()
            ps._launch("fdes_panel_rowpass_stack_c64", cuda, n, 2, v.data_ptr(), flat.data_ptr(),
                       flat.data_ptr(), None, n * n, SIGMA, waves, ps.ROUTES["wide"])
            assert torch.equal(flat, got)
            assert [w.launches_by_route for w in (ps.panel_rowpass_stack,
                                                   ps.panel_rowpass_stack_store)] == [
                {"tile": 0, "wide": 1}] * 2


def test_wide_stream_kernels_match_plain_on_card(cuda):
    """The wide build column pass (one species: kColBuild; two and four summed
    in registers: kColBuildSum), the g row pass (one, two and four planes)
    and the fused row pass (kVfused, its one kernel: one and two waves, in
    place as the streamed rollout runs it too) against the plain versions at
    every size; each launch counted on its wrapper (under "wide" where it is
    routed)."""
    tol = 2e-6
    for n in ps.SIZES:
        rng = np.random.default_rng(n + 3)
        for nsp in (1, 2, 4):
            gx = torch.as_tensor(_cplx(rng, nsp, n, n).astype(np.complex64)).to(cuda)
            fp = torch.as_tensor(rng.uniform(0, 1, (nsp, n, n)).astype(np.float32)).to(cuda)
            ps.reset_launches()
            want = ps.panel_build_colpass_ref(gx, fp)
            got = ps.panel_build_colpass(gx, fp, route="wide")
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
            assert ps.panel_build_colpass.launches_by_route == {"tile": 0, "wide": 1}
            g = torch.as_tensor(rng.uniform(0, 1, (nsp, n, n)).astype(np.float32)).to(cuda)
            want = ps.panel_g_rowpass_ref(g)
            got = ps.panel_g_rowpass(g)
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
            assert ps.panel_g_rowpass.launches == 1
        vx = torch.as_tensor((np.fft.fft(rng.uniform(0, 2000, (n, n)), axis=-1)[:, _bitrev(n)]
                              / n).astype(np.complex64)).to(cuda)
        for waves in (1, 2):
            b = torch.as_tensor(_cplx(rng, waves, n, n).astype(np.complex64)).to(cuda)
            ps.reset_launches()
            want = ps.panel_vfused_rowpass_ref(vx, b, SIGMA)
            got = ps.panel_vfused_rowpass(vx, b, SIGMA)
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
            flat = b.clone()
            ps._launch("fdes_panel_vfused_rowpass_c64", cuda, n, vx.data_ptr(), flat.data_ptr(),
                       flat.data_ptr(), SIGMA, waves)
            assert torch.equal(flat, got)
            assert ps.panel_vfused_rowpass.launches == 1


def test_wide_abs_row_kernel_matches_plain_on_card(cuda):
    """The wide absorptive row pass (kMidAbs, row 19) and its init (kInitAbs,
    row 18) against the plain versions at every size, one and two waves, V
    the .real and .imag of one complex64 stack (read in place), the row pass
    in place as the rollout runs it too; each launch counted under "wide"."""
    tol = 2e-6
    for n in ps.SIZES:
        for waves in (1, 2):
            rng = np.random.default_rng(n + 5 * waves)
            b = torch.as_tensor(_cplx(rng, waves, n, n).astype(np.complex64)).to(cuda)
            vr = rng.uniform(0, 2000, (3, n, n))
            v = torch.as_tensor((vr + 0.1j * vr).astype(np.complex64)).to(cuda)
            ps.reset_launches()
            want = ps.panel_rowpass_stack_abs_ref(2, v.real, v.imag, b, SIGMA)
            got = ps.panel_rowpass_stack_abs(2, v.real, v.imag, b, SIGMA, route="wide")
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())
            want = ps.panel_init_abs_ref(v[0].real, v[0].imag, b, SIGMA)
            got_init = ps.panel_init_abs(v[0].real, v[0].imag, b, SIGMA, route="wide")
            assert float((got_init - want).abs().max()) <= tol * float(want.abs().max())
            flat = b.clone()
            ps._launch("fdes_panel_rowpass_stack_abs_c64", cuda, n, 2, v.data_ptr(),
                       flat.data_ptr(), flat.data_ptr(), SIGMA, waves, ps.ROUTES["wide"])
            assert torch.equal(flat, got)
            assert [w.launches_by_route for w in (ps.panel_rowpass_stack_abs,
                                                   ps.panel_init_abs)] == [
                {"tile": 0, "wide": 1}] * 2


def test_wide_init_row_kernel_matches_plain_on_card(cuda):
    """Row 13 on both of its kernels (the tile kernel and the wide row
    kernel's kInit) against panel_init_ref at every size with 1, 2, 4 and 8
    waves, and its streamed form (V_0 the real parts of a complex plane: the
    tile kernel's VC form and kInitVc) through the entry point; each wrapper
    launch counted under its route."""
    tol = 2e-6
    for n in ps.SIZES:
        for waves in (1, 2, 4, 8):
            rng = np.random.default_rng(n + 31 * waves)
            psi = torch.as_tensor(_cplx(rng, waves, n, n).astype(np.complex64)).to(cuda)
            vr = rng.uniform(0, 2000, (n, n))
            vc = torch.as_tensor((vr + 1j * rng.uniform(-2000, 2000, (n, n))).astype(
                np.complex64)).to(cuda)
            v0 = vc.real.contiguous()
            want = ps.panel_init_ref(v0, psi, SIGMA)
            ps.reset_launches()
            for route, code in ps.ROUTES.items():
                got = ps.panel_init(v0, psi, SIGMA, route=route)
                assert float((got - want).abs().max()) <= tol * float(want.abs().max())
                streamed = torch.empty_like(psi)
                ps._launch("fdes_panel_init_c64", cuda, n, psi.data_ptr(), vc.data_ptr(), 1,
                           streamed.data_ptr(), None, 0, SIGMA, waves, code)
                assert float((streamed - want).abs().max()) <= tol * float(want.abs().max())
            assert ps.panel_init.launches_by_route == {"tile": 1, "wide": 1}
            del psi, vc, v0, want, got, streamed
            torch.cuda.empty_cache()


def test_x_row_kernel_matches_plain_on_card(cuda):
    """The transform-only kernel, rows 17 (panel_final) and 20
    (panel_rowfwd), against the plain versions at 256^2 to 1024^2 with one,
    two and four waves (the rows of all the waves one flat range), in place
    as the rollouts run it too; each launch counted on its wrapper."""
    tol = 2e-6
    for n in (256, 512, 1024):
        for waves in (1, 2, 4):
            rng = np.random.default_rng(n + 23 * waves)
            z = torch.as_tensor(_cplx(rng, waves, n, n).astype(np.complex64)).to(cuda)
            ps.reset_launches()
            for forward, wrapper, plain in ((0, ps.panel_final, ps.panel_final_ref),
                                            (1, ps.panel_rowfwd, ps.panel_rowfwd_ref)):
                want, got = plain(z), wrapper(z)
                assert float((got - want).abs().max()) <= tol * float(want.abs().max())
                flat = z.clone()
                ps._launch("fdes_panel_final_c64", cuda, n, flat.data_ptr(), flat.data_ptr(),
                           forward, waves)
                assert torch.equal(flat, got)
            assert (ps.panel_final.launches, ps.panel_rowfwd.launches) == (1, 1)
