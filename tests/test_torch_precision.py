"""The matrix-product engines keep full float32 at every product (the
analog of tests/test_precision.py).

On the H100 a float32 or complex64 product runs on TF32 tensor cores when
``torch.backends.cuda.matmul.allow_tf32`` is on, with a 10-bit mantissa: a
forgotten pin degrades an engine on the card only, where no CPU value test
can see it.  So with the caller's flag on, a TorchFunctionMode reads the
flag at every matmul, einsum and ``@`` each engine calls here, and a
TorchDispatchMode at every ATen product (mm, bmm, ...) it runs, in the
forward and in the backward (which the function mode does not see): every
reading must be False, and the caller's True must be given back afterwards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from fdes_tpu_torch import propagate as tprop  # noqa: E402

PRODUCTS = {torch.matmul, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.Tensor.__rmatmul__, torch.mm, torch.bmm}
ATEN = torch.ops.aten
ATEN_PRODUCTS = {ATEN.mm, ATEN.bmm, ATEN.addmm, ATEN.baddbmm, ATEN.addbmm, ATEN.matmul,
                 ATEN.mv, ATEN.dot, ATEN.vdot}


class _FlagAtProducts(TorchFunctionMode):
    """Records allow_tf32 at each matrix product called through torch."""

    def __init__(self):
        super().__init__()
        self.readings = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.readings.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


class _FlagAtAtenProducts(TorchDispatchMode):
    """Records allow_tf32 at each ATen matrix product, the backward's too."""

    def __init__(self):
        super().__init__()
        self.readings = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in ATEN_PRODUCTS:
            self.readings.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def tf32_on():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize(
    "kind,n,batch",
    [
        ("mxu", 256, 1),
        ("mxu_fast", 256, 1),
        ("mxu4", 256, 1),
        ("mxu4_fast", 256, 1),
        ("mxu4", 256, 3),  # the batched path
        ("radix", 512, 1),  # the folded single stage
        ("radix_fast", 512, 1),
        ("radix", 1024, 1),  # the butterfly stages
    ],
)
def test_every_product_runs_in_full_fp32(tf32_on, kind, n, batch):
    rng = np.random.default_rng(0)
    shape = (batch, n, n) if batch > 1 else (n, n)
    psi = torch.as_tensor(np.exp(1j * rng.uniform(0, 1, shape)).astype(np.complex64))
    v = torch.as_tensor(rng.uniform(0, 30, (2, n, n)).astype(np.float32)).requires_grad_(True)
    prop = torch.as_tensor(np.exp(1j * rng.uniform(0, 6, (n, n))).astype(np.complex64))
    step = tprop.make_slice_step(kind, shape=(n, n))
    calls, aten = _FlagAtProducts(), _FlagAtAtenProducts()
    with calls, aten:
        out = tprop.multislice(psi, v, prop, 0.01, slice_step=step)
        forward = len(aten.readings)
        (out.real ** 2).sum().backward()
    assert calls.readings, f"{kind}: no matmul, einsum or @ called (engine changed?)"
    assert forward > 0, f"{kind}: no ATen product in the forward"
    assert len(aten.readings) > forward, f"{kind}: no ATen product in the backward"
    assert not any(calls.readings + aten.readings), f"{kind}@{n}: a product ran on TF32"
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert v.grad is not None and torch.isfinite(v.grad).all()
