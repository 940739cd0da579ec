"""The package's one cache of prepared propagators
(fdes_tpu_torch.kernels._runtime.prepared_propagator): a hit is the same
tensor, an in-place change or a new tensor misses and gathers exactly what
the uncached gather (prepare_propagator) gathers, the bit-reversed entry is
the one the fused and the panel callers hand their kernels, an entry dies
with its propagator, a propagator that requires a gradient bypasses the
cache, and the index copies are made once per (n, device)."""

import gc
import os
import sys
import threading
import weakref

import pytest

torch = pytest.importorskip("torch")

from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import fused_scan as fsc  # noqa: E402
from fdes_tpu_torch.kernels import fused_step as fs  # noqa: E402
from fdes_tpu_torch.kernels import panel_scan as ps  # noqa: E402

CASES = [("bitrev", 128), ("bitrev", 256), ("cluster", 128), ("cluster", 256)]


def _prop(n, waves=(), seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (*waves, n, n)
    return torch.complex(torch.randn(shape, generator=g), torch.randn(shape, generator=g))


@pytest.mark.parametrize("layout,n", CASES)
@pytest.mark.parametrize("waves", [(), (3,)])
def test_a_hit_returns_the_same_tensor(layout, n, waves):
    p = _prop(n, waves)
    first = rt.prepared_propagator(p, layout)
    assert rt.prepared_propagator(p, layout) is first
    assert first.dtype == torch.complex64 and first.is_contiguous()
    assert torch.equal(first, rt.prepare_propagator(p, layout))


@pytest.mark.parametrize("layout,n", CASES)
def test_an_in_place_change_and_a_new_tensor_miss(layout, n):
    p = _prop(n)
    first = rt.prepared_propagator(p, layout)
    p.mul_(1j)  # bumps p._version
    changed = rt.prepared_propagator(p, layout)
    assert changed is not first
    assert torch.equal(changed, rt.prepare_propagator(p, layout))
    q = p.clone()
    fresh = rt.prepared_propagator(q, layout)
    assert fresh is not changed and torch.equal(fresh, changed)
    assert rt.prepared_propagator(p, layout) is changed  # q's entry left p's alone


def test_a_complex128_propagator_is_prepared_in_complex64():
    p = _prop(128).to(torch.complex128)
    got = rt.prepared_propagator(p)
    assert got.dtype == torch.complex64 and rt.prepared_propagator(p) is got
    assert torch.equal(got, rt.prepare_propagator(p))


@pytest.mark.parametrize("n", [256, 512])
def test_the_bitrev_entry_is_shared_by_the_fused_and_panel_callers(monkeypatch, n):
    """The fused step and the panel column pass hand their kernels the one
    bit-reversed entry.  The C calls are stubbed, and tensors report
    themselves on the card, so that the wrappers take their card paths
    here."""
    p = _prop(n)
    fused = rt.prepared_propagator(p)
    read = []  # the propagator pointer of each launch
    monkeypatch.setattr(fs, "_launch", lambda name, device, n, *args: read.append(args[2]))
    monkeypatch.setattr(ps, "_launch", lambda name, device, n, *args: read.append(args[1]))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    psi = torch.ones(n, n, dtype=torch.complex64)
    try:
        fs.fused_step(psi, torch.zeros(n, n), p, 0.01)
        ps.panel_colpass(psi, p)
    finally:
        fs.reset_launches()
    assert read == [fused.data_ptr()] * 2
    assert rt.prepared_propagator(p, "bitrev") is fused
    cluster = rt.prepared_propagator(p, "cluster")  # an entry of its own
    assert cluster is not fused and not torch.equal(cluster, fused)
    assert rt.prepared_propagator(p) is fused


@pytest.mark.parametrize("layout,n", CASES)
def test_an_entry_dies_with_its_propagator(layout, n):
    p = _prop(n)
    entry = weakref.ref(rt.prepared_propagator(p, layout))
    assert p in rt._prepared
    del p
    gc.collect()
    assert entry() is None


@pytest.mark.parametrize("layout,n", CASES)
def test_a_propagator_that_requires_grad_bypasses_the_cache(layout, n):
    p = _prop(n).requires_grad_()
    first = rt.prepared_propagator(p, layout)
    second = rt.prepared_propagator(p, layout)
    assert first is not second and p not in rt._prepared
    assert first.requires_grad  # the gather carries the graph: never kept
    assert torch.equal(first.detach(), rt.prepare_propagator(p.detach(), layout))
    with torch.no_grad():  # no graph to carry: cached
        kept = rt.prepared_propagator(p, layout)
        assert rt.prepared_propagator(p, layout) is kept and not kept.requires_grad


def test_inference_mode_bypasses_the_cache():
    p = _prop(128)
    with torch.inference_mode():
        first = rt.prepared_propagator(p)
        assert rt.prepared_propagator(p) is not first
        q = _prop(128)
    assert p not in rt._prepared
    assert rt.prepared_propagator(q) is not rt.prepared_propagator(q)  # an inference tensor
    assert torch.equal(first, rt.prepare_propagator(p))


def test_a_layout_and_a_shape_are_checked():
    with pytest.raises(ValueError, match="layout"):
        rt.prepared_propagator(_prop(128), "natural")
    with pytest.raises(ValueError, match=r"\(\.\.\., n, n\)"):
        rt.prepared_propagator(torch.ones(128, 256, dtype=torch.complex64))


@pytest.mark.parametrize("layout,n", CASES)
def test_index_copies_are_made_once_per_size_and_device(monkeypatch, layout, n):
    monkeypatch.setattr(rt, "_index_copies", {})
    copies = []
    from_numpy = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: copies.append(a.shape) or from_numpy(a))
    assert rt.bit_reversal(n) is rt.bit_reversal(n, "cpu")
    rows, cols = rt.cluster_order(n)
    again = rt.cluster_order(n, torch.device("cpu"))
    assert again[0] is rows and again[1] is cols and cols is rt.bit_reversal(n)
    assert copies == [(n,), (n,)]  # bitrev n, then the cluster rows
    for seed in range(3):  # three misses: no host copy
        rt.prepared_propagator(_prop(n, seed=seed), layout)
    assert copies == [(n,), (n,)]
    assert rt.bit_reversal(n).tolist() == rt._bit_reversal_host(n).tolist()


def test_threads_share_one_entry_a_propagator():
    shared = [_prop(128, seed=s) for s in range(4)]
    want = [rt.prepare_propagator(p) for p in shared]
    got, errors = [[] for _ in shared], []

    def work(k):
        try:
            for i in range(40):
                j = (k + i) % len(shared)
                got[j].append(rt.prepared_propagator(shared[j]))
                rt.prepared_propagator(_prop(128, seed=100 + k), "cluster")  # a miss
        except Exception as e:  # noqa: BLE001 - handed to the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    for outs, w in zip(got, want):
        assert len({id(o) for o in outs}) == 1 and torch.equal(outs[0], w)

# ---- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels that read the prepared propagator have no "
                    "CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def _card_fields(n, s, b, cuda, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    psi0 = torch.exp(1j * torch.rand(b, n, n, generator=g, device=cuda)).to(torch.complex64)
    v = 0.5 * torch.rand(s, n, n, generator=g, device=cuda)
    p = torch.exp(-1j * 3.0 * torch.rand(n, n, generator=g, device=cuda)).to(torch.complex64)
    return psi0, v, p


def _twice(run, p):
    """run(p) on a miss (p new to the cache) and then on a hit."""
    assert p not in rt._prepared
    miss = run(p)
    entry = rt.prepared_propagator(p)
    hit = run(p)
    assert rt.prepared_propagator(p) is entry
    return miss, hit


@pytest.mark.parametrize("route", ["wide", "scan", "cluster"])
def test_fused_scan_gives_the_same_bits_on_a_hit_and_a_miss_on_card(cuda, route):
    psi0, v, p = _card_fields(256, 8, 3, cuda)
    miss, hit = _twice(lambda q: fsc.fused_scan(psi0, v, q, 0.01, route=route), p)
    assert torch.equal(miss, hit)


def test_the_scan_adjoint_gives_the_same_bits_on_a_hit_and_a_miss_on_card(cuda):
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    psi0, v, p = _card_fields(256, 8, 2, cuda)

    def run(q):
        vv = v.clone().requires_grad_()
        out = adj.scan_diff_apply(psi0, vv, q, 0.01, seg=0)
        out.abs().square().sum().backward()
        return out.detach(), vv.grad

    (out0, dv0), (out1, dv1) = _twice(run, p)
    assert torch.equal(out0, out1) and torch.equal(dv0, dv1)


def test_the_panel_passes_give_the_same_bits_on_a_hit_and_a_miss_on_card(cuda):
    psi0, v, p = _card_fields(256, 4, 2, cuda)
    miss, hit = _twice(lambda q: ps.panel_scan(psi0, v, q, 0.01), p)
    assert torch.equal(miss, hit)

    def grad(q):
        vv = v.clone().requires_grad_()
        ps.panel_diff_apply(psi0, vv, q, 0.01).abs().square().sum().backward()
        return vv.grad

    assert torch.equal(*_twice(grad, p.clone()))
