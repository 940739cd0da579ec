"""The wide whole-loop forward (``wide_scan_kernel`` in csrc/fused_step.cu,
on the wide sweep of csrc/fused_fft.cuh) and its place in the route table
``kernels/fused_scan.SCAN_ROUTE``.

On the CPU ``route="wide"`` goes to the plain rollout like every route; the
kernel itself is held against the plain rollout on the card (the tests that
take the ``cuda`` fixture) and by chip_smoke.py's kernels_fused phase.  This
file imports no JAX, so that the card tests run where only PyTorch is:
``python -m pytest --noconftest tests/test_torch_wide_scan.py``."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu_torch import kernels  # noqa: E402
from fdes_tpu_torch.kernels import fused_scan as fsc  # noqa: E402
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SIGMA = 0.00065  # rad / (V A) at 300 kV, the order of interaction_sigma(300e3)


def _fields(n: int, b: int, nslices: int, *, per_wave_v=False, per_wave_p=False,
            broadcast_psi=False, seed=0, device="cpu"):
    """(psi0, V, P) in complex64 / float32: psi0 (n, n) when broadcast_psi
    else (b, n, n); V (b, S, n, n) per wave or (S, n, n); P (b, n, n) per
    wave or (n, n), unit modulus."""
    rng = np.random.default_rng(seed)
    shape = (n, n) if broadcast_psi else (b, n, n)
    psi = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    v = rng.uniform(0, 2000, ((b,) if per_wave_v else ()) + (nslices, n, n)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, ((b,) if per_wave_p else ()) + (n, n))
    prop = np.exp(1j * phase).astype(np.complex64)
    return tuple(torch.as_tensor(a, device=device) for a in (psi, v, prop))


#: (n, waves, slices, per-wave V, per-wave P, broadcast psi0)
BATCHING = [
    (128, 1, 3, False, False, False),
    (128, 3, 2, True, False, False),
    (256, 2, 2, False, True, False),
    (128, 3, 2, True, True, True),
    (128, 2, 2, False, True, True),
]


# ---- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("n,b,nslices,per_wave_v,per_wave_p,broadcast_psi", BATCHING)
def test_wide_route_on_the_cpu_is_the_plain_rollout(n, b, nslices, per_wave_v, per_wave_p,
                                                    broadcast_psi):
    """route="wide" and wide_scan on CPU tensors give fused_scan_ref's
    answer, with its batching: shared or per-wave V and P, a broadcast
    psi0; no launch is counted."""
    psi, v, prop = _fields(n, b, nslices, per_wave_v=per_wave_v, per_wave_p=per_wave_p,
                           broadcast_psi=broadcast_psi, seed=n + b)
    want = fsc.fused_scan_ref(psi, v, prop, SIGMA)
    assert want.shape == (b, n, n) or (b == 1 and want.shape == psi.shape)
    before = fsc.wide_scan.launches
    assert torch.equal(fsc.fused_scan(psi, v, prop, SIGMA, route="wide"), want)
    assert torch.equal(fsc.wide_scan(psi, v, prop, SIGMA), want)
    assert fsc.wide_scan.launches == before


def test_wide_scan_without_slices_is_psi0():
    psi, v, prop = _fields(128, 2, 2, seed=3)
    assert torch.equal(fsc.wide_scan(psi, v[:0], prop, SIGMA), psi)


def test_an_unknown_route_still_raises():
    psi, v, prop = _fields(128, 1, 1, seed=4)
    for bad in ("panel", "Wide", "", "tile"):
        with pytest.raises(ValueError, match="route must be"):
            fsc.fused_scan(psi, v, prop, SIGMA, route=bad)
    big = torch.zeros(1, 1024, 1024, dtype=torch.complex64)
    with pytest.raises(ValueError, match="cluster kernel takes"):
        fsc.fused_scan(big, torch.zeros(1, 1024, 1024), big[0], SIGMA, route="cluster")
    with pytest.raises(ValueError):  # the wide kernel takes 128^2 to 1024^2
        fsc.wide_scan(torch.zeros(1, 64, 64, dtype=torch.complex64), torch.zeros(1, 64, 64),
                      torch.zeros(64, 64, dtype=torch.complex64), SIGMA)


def test_wide_scan_is_in_the_launch_registry():
    """wide_scan counts its launches in the registry the spans read, beside
    fused_scan and cluster_scan, and nothing has launched it on the CPU."""
    registered = kernels.registered()
    for w in (fsc.fused_scan, fsc.cluster_scan, fsc.wide_scan):
        assert w in registered
    assert fsc.wide_scan.launches == 0
    assert fsc.ROUTES == ("scan", "cluster", "wide")


def test_scan_route_entries_are_kernels_of_their_sizes():
    """Every entry names one of the three kernels; "cluster" only where a
    cluster holds the plane (CLUSTER_CTAS), "wide" only at the wide
    transform's 128^2 to 1024^2; every size of the kernels has rows."""
    assert set(fsc.SCAN_ROUTE) == set(fs.SIZES)
    for n, rows in fsc.SCAN_ROUTE.items():
        assert set(rows.values()) <= set(fsc.ROUTES)
        if "cluster" in rows.values():
            assert n in fsc.CLUSTER_CTAS
        if "wide" in rows.values():
            assert 128 <= n <= 1024


@pytest.mark.parametrize("b", [1, 2, 3, 4, 7, 30, 64, 128])
def test_the_series_and_the_raster_read_the_table(b):
    """A B-wave launch at 512^2 (the series' one wave, a tilt series' few,
    the raster's chunks) takes the row at or below B."""
    rows = fsc.SCAN_ROUTE[512]
    assert fsc.scan_route(512, b) == rows[max(k for k in rows if k <= b)]


# ---- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide scan kernel has no CPU form")
    return torch.device("cuda")


def _scan_tol(nslices: int) -> float:
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke").scan_tol(nslices)
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_wide_scan_matches_plain_on_card(cuda, n):
    """The kernel against the plain rollout within chip_smoke.scan_tol(S) of
    the largest value, at 1 and 3 waves, shared and per-wave V and P, S = 0
    and 1 (and 4); the same bits on two runs; one launch a call."""
    for b in (1, 3):
        for per_wave in (False, True):
            for nslices in (0, 1, 4):
                psi, v, prop = _fields(n, b, nslices, per_wave_v=per_wave, per_wave_p=per_wave,
                                       seed=n + 10 * b + nslices, device=cuda)
                want = fsc.fused_scan_ref(psi, v, prop, SIGMA)
                before = fsc.wide_scan.launches
                got = fsc.wide_scan(psi, v, prop, SIGMA)
                again = fsc.wide_scan(psi, v, prop, SIGMA)
                assert fsc.wide_scan.launches == before + (2 if nslices else 0)
                err = float((got - want).abs().max())
                assert err <= _scan_tol(nslices) * float(want.abs().max()), (b, per_wave, nslices)
                assert torch.equal(got, again)
    info = fsc.wide_scan_kernel_info(n, cuda)
    assert info["resident_blocks"] >= 1 and info["registers"] > 0


def test_wide_scan_broadcasts_psi0_on_card(cuda):
    psi, v, prop = _fields(256, 3, 2, per_wave_v=True, broadcast_psi=True, seed=5, device=cuda)
    want = fsc.fused_scan_ref(psi, v, prop, SIGMA)
    got = fsc.wide_scan(psi, v, prop, SIGMA)
    assert got.shape == (3, 256, 256)
    assert float((got - want).abs().max()) <= _scan_tol(2) * float(want.abs().max())
    with pytest.raises(TypeError, match="complex64"):
        fsc.wide_scan(psi.to(torch.complex128), v, prop, SIGMA)


def test_a_series_on_fscan_launches_the_wide_kernel_once(cuda):
    """One defocus series at 512^2 on the fscan engine: one launch of
    wide_scan_kernel (the route's one-wave row), none of scan_kernel, and
    the images of the plain rollout."""
    from fdes_tpu_torch import forward, propagate

    assert fsc.scan_route(512, 1) == "wide"
    n, nslices, ndef = 512, 16, 3
    _, v, prop = _fields(n, 1, nslices, seed=11, device=cuda)
    psi0 = torch.ones(n, n, dtype=torch.complex64, device=cuda)
    rng = np.random.default_rng(12)
    ctf = torch.as_tensor(np.exp(1j * rng.uniform(0, 1, (ndef, n, n))).astype(np.complex64),
                          device=cuda)
    step = propagate.make_slice_step("fscan", shape=(n, n), grad=False)
    counts = (fsc.wide_scan.launches, fsc.fused_scan.launches, fsc.cluster_scan.launches)
    got = forward.hrtem_defocus_series(v, psi0, prop, SIGMA, ctf, slice_step=step)
    torch.cuda.synchronize()
    assert (fsc.wide_scan.launches, fsc.fused_scan.launches, fsc.cluster_scan.launches) == (
        counts[0] + 1, counts[1], counts[2])
    want = forward.hrtem_defocus_series(v, psi0, prop, SIGMA, ctf)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-5
