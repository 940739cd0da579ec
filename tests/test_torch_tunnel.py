"""The port's readback watchdog and transfers (fdes_tpu_torch.tunnel), the
analog of tests/test_tunnel.py and of tests/test_profiling.py's watchdog
cases: a stalled readback is retried, a permanent stall times out within a
few seconds, an error raises at once, and complex and float64 buffers round
trip exactly with their dtypes."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu_torch.profiling import fetch_array as profiling_fetch_array  # noqa: E402
from fdes_tpu_torch.tunnel import fetch_array, fetch_scalar, safe_put  # noqa: E402


class _StallThenSucceed:
    """np.asarray blocks well past wait_s on the first call and returns at
    once on the second: a readback that recovers."""

    def __init__(self):
        self.calls = 0
        self._lock = threading.Lock()

    def __array__(self, dtype=None, copy=None):
        with self._lock:
            self.calls += 1
            first = self.calls == 1
        if first:
            time.sleep(2.0)
        return np.array([3.5], dtype=np.float32)


class _RaiseOnce:
    def __init__(self, err):
        self.calls = 0
        self._err = err

    def __array__(self, dtype=None, copy=None):
        self.calls += 1
        if self.calls == 1:
            raise self._err
        return np.array([[7.0]], dtype=np.float32)


class _StallForever:
    def __array__(self, dtype=None, copy=None):
        time.sleep(60.0)
        return np.zeros(1)


def test_stalled_fetch_is_retried_not_hung():
    obj = _StallThenSucceed()
    t0 = time.time()
    assert fetch_scalar(obj, tries=4, wait_s=0.2) == 3.5
    assert time.time() - t0 < 2.0  # a second attempt returned, not the stalled one
    assert obj.calls >= 2


@pytest.mark.parametrize("err", [RuntimeError("CUDA error: an illegal memory access"),
                                 ValueError("bad")])
def test_an_error_raises_at_once(err):
    obj = _RaiseOnce(err)
    with pytest.raises(type(err)):
        fetch_array(obj, tries=5, wait_s=0.01)
    assert obj.calls == 1


def test_permanent_stall_times_out():
    t0 = time.time()
    with pytest.raises(TimeoutError):
        fetch_array(_StallForever(), tries=2, wait_s=0.2)
    assert time.time() - t0 < 5.0


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float64, np.float32,
                                   np.int64])
def test_safe_put_round_trip_keeps_dtype(dtype):
    rng = np.random.default_rng(0)
    a = (rng.random((16, 8)) + 1j * rng.random((16, 8))).astype(dtype) if np.iscomplexobj(
        dtype(0)) else (rng.random((16, 8)) * 100).astype(dtype)
    x = safe_put(a, device="cpu")
    assert isinstance(x, torch.Tensor) and x.dtype == torch.from_numpy(a).dtype
    back = fetch_array(x)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)


def test_fetch_array_copies_and_resolves_views():
    """The result is the host's own copy, and a lazy conjugate view reads as
    its values."""
    x = torch.arange(6.0).reshape(2, 3) * torch.tensor(1 + 2j, dtype=torch.complex64)
    out = fetch_array(x)
    x.zero_()
    assert out[1, 2] == 5 * (1 + 2j)
    z = torch.tensor([1 + 1j, 2 - 3j], dtype=torch.complex128)
    np.testing.assert_array_equal(fetch_array(z.conj()), np.conj(z.numpy()))
    np.testing.assert_array_equal(profiling_fetch_array(-z), -z.numpy())


def test_safe_put_and_fetch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = np.exp(1j * np.linspace(0, 1, 1000))
    x = safe_put(a)
    assert x.is_cuda and x.dtype == torch.complex128
    np.testing.assert_array_equal(fetch_array(x), a)
