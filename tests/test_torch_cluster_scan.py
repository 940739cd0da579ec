"""The cluster kernel of the whole-loop scan (``cluster_scan_kernel`` in
csrc/fused_step.cu, its transform in csrc/fused_fft.cuh) as a plain-torch
model of its index maps, and the route between it and ``scan_kernel``.

The model follows the kernel's data: which rows each CTA of a cluster holds,
the x and R-point y transforms in decimation-in-frequency order, the twiddles
and the C-point transform of the cross step (radix 2, as in registers), the
pairs each CTA owns there, and the order the wrapper gathers P into.  It is
held against ``torch.fft.fft2`` in complex128 for C = 1, 4 and 16, and its
rollout against the JAX package's whole-loop kernel (interpret mode on the
CPU, as tests/test_torch_fused.py runs it).  The kernel itself is held
against the plain rollout on the card (the last test here, and
chip_smoke.py's kernels_fused phase)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import fused_scan as fsc  # noqa: E402
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402

SIGMA = interaction_sigma(300e3)
EXACT = 1e-12  # complex128: the model against torch.fft, max |d| / max |ref|
ATOL = 1e-5  # complex64 rollouts of O(1) waves against the JAX kernel


@pytest.fixture(autouse=True)
def _one_thread():
    """Small problems: one intra-op thread, no contention between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _br(n: int) -> torch.Tensor:
    return rt.bit_reversal(n)


def _shape(n: int) -> tuple[int, int]:
    c = fsc.CLUSTER_CTAS[n]
    return c, n // c


def _fields(n: int, b: int, nslices: int, seed: int, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(b, n, n)) + 1j * rng.normal(size=(b, n, n))
    v = rng.normal(size=(nslices, n, n)) * 30.0
    prop = fresnel_propagator(Grid(ny=n, nx=n, py=0.3, px=0.3), wavelength_A(300e3), 1.8)
    real = np.float64 if dtype == np.complex128 else np.float32
    return psi.astype(dtype), v.astype(real), prop.astype(dtype)


# ---- the model ---------------------------------------------------------------


def _tiles(psi: torch.Tensor, c: int) -> torch.Tensor:
    """(..., n, n) -> (..., C, R, n): CTA k's row r is the plane's row C r + k."""
    n = psi.shape[-1]
    return psi.reshape(*psi.shape[:-2], n // c, c, n).transpose(-3, -2)


def _untiles(t: torch.Tensor) -> torch.Tensor:
    c, r, n = t.shape[-3:]
    return t.transpose(-3, -2).reshape(*t.shape[:-3], r * c, n)


def _forward_local(t: torch.Tensor) -> torch.Tensor:
    """Each CTA's x transforms, then its R-point y transforms over its own
    rows, both unscaled with bit-reversed outputs (decimation in frequency)."""
    r, n = t.shape[-2:]
    t = torch.fft.fft(t, dim=-1)[..., _br(n)]
    return torch.fft.fft(t, dim=-2)[..., _br(r), :]


def _inverse_local(t: torch.Tensor) -> torch.Tensor:
    """The unscaled inverses of _forward_local (bit-reversed in, natural out)."""
    r, n = t.shape[-2:]
    t = r * torch.fft.ifft(t[..., _br(r), :], dim=-2)
    return n * torch.fft.ifft(t[..., _br(n)], dim=-1)


def _register_fft(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    """register_fft over dim -3 (the C slots): radix-2 decimation in
    frequency (natural in, bit-reversed out), or the inverse in time."""
    zs = list(z.unbind(-3))
    log2c = len(zs).bit_length() - 1
    for s in range(log2c):
        h = 1 << (s if inverse else log2c - 1 - s)
        for j in range(len(zs)):
            if j & h:
                continue
            w = np.exp(-2j * np.pi * (j & (h - 1)) / (2 * h))
            a, b = zs[j], zs[j + h]
            if inverse:
                t = b * np.conj(w)
                zs[j], zs[j + h] = a + t, a - t
            else:
                zs[j], zs[j + h] = a + b, (a - b) * w
    return torch.stack(zs, -3)


def _owned_rows(c: int, r: int, rank: int) -> slice:
    """The rows r' of every tile whose (r', x) pairs CTA ``rank`` owns in the
    cross step (cluster_cross: e = rank * kOwnedPairs + p, e = r' N + x')."""
    return slice(rank * (r // c), (rank + 1) * (r // c))


def _cross(t: torch.Tensor, prop: torch.Tensor | None, spectrum: list | None = None):
    """The cross step on all tiles (..., C, R, n): per owner, twiddles
    w_N^(k k_b), the C-point DFT, P / n^2 at the gathered places (prop
    (..., n, n) in the cluster order, None: skip), the inverse, the
    conjugate twiddles, written back where read.  ``spectrum`` collects the
    owners' spectra before P."""
    c, r, n = t.shape[-3:]
    kb = _br(r).to(torch.float64)
    k = torch.arange(c, dtype=torch.float64)
    tw = torch.exp(-2j * np.pi * (k[:, None] * kb[None, :]) / n).to(t.dtype)[..., None]
    out = t.clone()
    for rank in range(c):
        rows = _owned_rows(c, r, rank)
        z = _register_fft(t[..., :, rows, :] * tw[:, rows], inverse=False)
        if spectrum is not None:
            spectrum.append((rows, z))
        if prop is not None:
            z = z * _untiles_prop(prop, c)[..., :, rows, :] / (n * n)
        out[..., :, rows, :] = _register_fft(z, inverse=True) * tw[:, rows].conj()
    return out


def _untiles_prop(prop: torch.Tensor, c: int) -> torch.Tensor:
    """The gathered (..., n, n) propagator as (..., C, R, n): [j, r', x']."""
    n = prop.shape[-1]
    return prop.reshape(*prop.shape[:-2], c, n // c, n)


def _model_spectrum(psi: torch.Tensor) -> torch.Tensor:
    """(..., n, n): the spectrum the cluster holds at the multiply by P,
    [j R + r', x'] over all owners."""
    c, r = _shape(psi.shape[-1])
    spectrum = []
    _cross(_forward_local(_tiles(psi, c)), None, spectrum)
    out = torch.empty(*psi.shape[:-2], c, r, psi.shape[-1], dtype=psi.dtype)
    for rows, z in spectrum:
        out[..., :, rows, :] = z
    return out.reshape(psi.shape)


def _model_step(s: torch.Tensor, prop_gathered: torch.Tensor) -> torch.Tensor:
    """IFFT2(P FFT2(s)) as the cluster computes it, from the transmitted s."""
    c, _ = _shape(s.shape[-1])
    return _untiles(_inverse_local(_cross(_forward_local(_tiles(s, c)), prop_gathered)))


def _model_rollout(psi0, v_stack, prop, sigma):
    pg = rt.prepare_propagator(prop, "cluster") if prop.dtype == torch.complex64 else _gather(prop)
    psi = psi0
    for v in v_stack:
        phase = v.to(psi.real.dtype) * sigma
        psi = _model_step(psi * torch.complex(torch.cos(phase), torch.sin(phase)), pg)
    return psi


def _gather(prop: torch.Tensor) -> torch.Tensor:
    rows, cols = rt.cluster_order(prop.shape[-1])
    return prop[..., rows[:, None], cols[None, :]]


# ---- the index maps against torch.fft ----------------------------------------


@pytest.mark.parametrize("n", [128, 256, 512])
def test_cluster_spectrum_is_fft2(n):
    """The spectrum the cross step forms (C = 1, 4, 16 CTAs at 128^2, 256^2,
    512^2) is the 2-D DFT at the frequencies ``cluster_order`` names."""
    psi = torch.as_tensor(_fields(n, 2, 1, seed=n)[0])
    want = _gather(torch.fft.fft2(psi))
    got = _model_spectrum(psi)
    assert float((got - want).abs().max()) <= EXACT * float(want.abs().max())


@pytest.mark.parametrize("n", [128, 256, 512])
def test_cluster_step_with_the_gathered_propagator(n):
    """One slice's IFFT2(P FFT2(s)) through the model, with P gathered into
    the cluster order, is the step in natural order (complex128), and the
    wrapper's gather puts P's own values at those frequencies."""
    psi, _, prop = _fields(n, 2, 1, seed=n + 1)
    s, p = torch.as_tensor(psi), torch.as_tensor(prop)
    want = torch.fft.ifft2(torch.fft.fft2(s) * p)
    got = _model_step(s, _gather(p))
    assert float((got - want).abs().max()) <= EXACT * float(want.abs().max())
    rows, cols = rt.cluster_order(n)
    prepared = rt.prepare_propagator(p, "cluster")
    assert prepared.dtype == torch.complex64 and prepared.is_contiguous()
    assert torch.equal(prepared, p.to(torch.complex64)[rows[:, None], cols[None, :]])
    c, r = _shape(n)
    for j in (0, c - 1):
        for rp in (0, 1, r - 1):
            assert int(rows[j * r + rp]) == int(_br(r)[rp]) + r * int(_br(c)[j])
    assert torch.equal(cols, _br(n))
    per_wave = torch.stack([p, 1j * p])
    assert torch.equal(rt.prepare_propagator(per_wave, "cluster")[1], prepared * 1j)


@pytest.mark.parametrize("n", [128, 256, 512])
def test_cluster_rows_and_pairs_cover_the_plane_once(n):
    """Each row of the plane lies in exactly one CTA, and each (r', x') pair
    of the tiles is owned by exactly one CTA in the cross step."""
    c, r = _shape(n)
    rows = _untiles(_tiles(torch.arange(n * n).reshape(n, n), c))
    assert torch.equal(rows, torch.arange(n * n).reshape(n, n))
    owned = torch.cat([torch.arange(r)[_owned_rows(c, r, k)] for k in range(c)])
    assert torch.equal(owned, torch.arange(r))
    assert r * n == 16384  # the CTA's tile at every size (fused_fft.cuh, Cluster)


def test_cluster_order_refuses_other_grids():
    with pytest.raises(ValueError, match="cluster scan"):
        rt.prepare_propagator(torch.ones(1024, 1024, dtype=torch.complex64), "cluster")
    with pytest.raises(ValueError, match="cluster scan"):
        rt.prepare_propagator(torch.ones(256, 128, dtype=torch.complex64), "cluster")


# ---- the model's rollout against the JAX package ------------------------------


@pytest.mark.parametrize("n,b,nslices,per_wave_p", [
    (128, 3, 4, True), (256, 2, 6, False), (512, 1, 8, False),
])
def test_cluster_model_rollout_equals_jax(n, b, nslices, per_wave_p):
    """complex64 rollouts of 4-8 slices through the model of the cluster
    kernel: the JAX package's whole-loop kernel on the same inputs (per wave
    where a propagator is per wave); and the port's wrapper on the CPU (the
    plain rollout) within the same tolerance."""
    psi, v, prop = _fields(n, b, nslices, seed=7 * n, dtype=np.complex64)
    props = (np.stack([prop * np.exp(0.01j * i) for i in range(b)]).astype(np.complex64)
             if per_wave_p else prop)
    step = jprop.make_slice_step("fscan", shape=(n, n), dtype=jnp.complex64, grad=False)
    want = np.stack([
        np.asarray(jprop.multislice(jnp.asarray(psi[i]), jnp.asarray(v),
                                    jnp.asarray(props[i] if per_wave_p else props), SIGMA,
                                    slice_step=step))
        for i in range(b)
    ])
    got = _model_rollout(torch.as_tensor(psi), torch.as_tensor(v), torch.as_tensor(props), SIGMA)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    port = fsc.cluster_scan(torch.as_tensor(psi), torch.as_tensor(v), torch.as_tensor(props),
                            SIGMA)
    np.testing.assert_allclose(port.numpy(), want, atol=ATOL)


# ---- the route ---------------------------------------------------------------


def test_scan_route_is_the_table():
    """Every size of the kernels, 1024^2 too, has rows, 1024^2 without the
    cluster kernel; a grid outside the table takes scan_kernel; each
    measured (n, B) takes its row; a B between rows takes the row below it,
    one above the last row the last, one below the first the first; B = 0
    or S = 0 launches nothing."""
    assert fsc.scan_route(1024, 1) == fsc.SCAN_ROUTE[1024][1]
    assert "cluster" not in fsc.SCAN_ROUTE[1024].values()
    assert fsc.scan_route(2048, 4) == "scan"
    assert set(fsc.SCAN_ROUTE) == set(fs.SIZES)
    for n, rows in fsc.SCAN_ROUTE.items():
        measured = sorted(rows)
        for b in measured:
            assert fsc.scan_route(n, b) == rows[b]
            assert fsc.scan_route(n, b, nslices=128) == rows[b]
            assert set(rows.values()) <= {"scan", "cluster", "wide"}
        for lo, hi in zip(measured, measured[1:]):
            assert all(fsc.scan_route(n, b) == rows[lo] for b in range(lo, hi))
        assert fsc.scan_route(n, 10 * measured[-1]) == rows[measured[-1]]
        assert fsc.scan_route(n, 0) is None and fsc.scan_route(n, 3, nslices=0) is None


def test_fused_scan_without_slices_is_as_before():
    """S = 0 gives psi0 back whatever the route asks for (B = 0 launches
    nothing: scan_route gives None, above)."""
    psi, v, prop = (torch.as_tensor(a) for a in _fields(128, 2, 2, seed=5, dtype=np.complex64))
    for route in (None, "scan", "cluster", "wide"):
        assert torch.equal(fsc.fused_scan(psi, v[:0], prop, SIGMA, route=route), psi)


def test_fused_scan_route_argument_is_checked():
    psi, v, prop = (torch.as_tensor(a) for a in _fields(128, 1, 2, seed=6, dtype=np.complex64))
    with pytest.raises(ValueError, match="route"):
        fsc.fused_scan(psi, v, prop, SIGMA, route="panel")
    big = torch.zeros(1, 1024, 1024, dtype=torch.complex64)
    with pytest.raises(ValueError, match="cluster kernel takes"):
        fsc.cluster_scan(big, torch.zeros(1, 1024, 1024), big[0], SIGMA)
    want = fsc.fused_scan_ref(psi, v, prop, SIGMA)
    assert torch.equal(fsc.cluster_scan(psi, v, prop, SIGMA), want)
    assert torch.equal(fsc.fused_scan(psi, v, prop, SIGMA, route="scan"), want)


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cluster kernel has no CPU form")
    return torch.device("cuda")


def test_cluster_kernel_matches_plain_on_card(cuda):
    for n in (128, 256, 512):
        psi, v, prop = (torch.as_tensor(a).to(cuda)
                        for a in _fields(n, 3, 4, seed=n, dtype=np.complex64))
        want = fsc.fused_scan_ref(psi, v, prop, SIGMA)
        before = fsc.cluster_scan.launches
        got = fsc.cluster_scan(psi, v, prop, SIGMA)
        assert fsc.cluster_scan.launches == before + 1
        assert float((got - want).abs().max()) <= 4e-6 * float(want.abs().max())
        info = fsc.cluster_kernel_info(n, cuda)
        assert info["ctas_per_cluster"] == fsc.CLUSTER_CTAS[n]
        assert info["max_active_clusters"] >= 1
    with pytest.raises(TypeError, match="complex64"):
        fsc.cluster_scan(psi.to(torch.complex128), v, prop, SIGMA)
