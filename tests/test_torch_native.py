"""The port's C++ specimen reader (fdes_tpu_torch.native) against its Python
parser and against fdes_tpu.native: the same arrays, exactly, the analog of
tests/test_native.py (skipped likewise where no toolchain builds it)."""

import shutil
import warnings

import numpy as np
import pytest

from fdes_tpu import native as jnative
from fdes_tpu.specimen import load_xyz as jload_xyz
from fdes_tpu_torch import native
from fdes_tpu_torch import specimen as tspec

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain for the native reader")

FIELDS = ("positions", "numbers", "bfactors", "occupancies", "box")


def _write_xyz(tmp_path, lines, count=None, name="a.xyz"):
    n = count if count is not None else len(lines)
    p = tmp_path / name
    p.write_text(f"{n}\ncomment line\n" + "\n".join(lines) + "\n")
    return str(p)


def _random_lines(n, seed=1234):
    rng = np.random.default_rng(seed)
    syms = np.array(["Si", "O", "Au", "14"])[rng.integers(0, 4, n)]
    pos = rng.normal(size=(n, 3)) * 20.0
    cols = rng.integers(3, 6, n)  # with and without B and occupancy
    out = []
    for s, p, c, b, o in zip(syms, pos, cols, rng.random(n), rng.random(n)):
        extra = [f"{b:.6f}", f"{o:.6f}"][: c - 3]
        out.append(" ".join([s, *(f"{x:.9f}" for x in p), *extra]))
    return out


def test_native_equals_python_and_jax(tmp_path):
    path = _write_xyz(tmp_path, _random_lines(500))
    box = (50.0, 50.0, 50.0)
    got = tspec.load_xyz(path, box, bfactor=0.77, native=True)
    python = tspec.load_xyz(path, box, bfactor=0.77, native=False)
    jax_native = jload_xyz(path, box, bfactor=0.77, native=True)
    assert native.available() and jnative.available()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(python, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(jax_native, f))
    assert got.numbers.dtype == np.int32 and got.positions.dtype == np.float64


def test_parse_xyz_equals_jax_on_defaults_and_numeric_z(tmp_path):
    path = _write_xyz(tmp_path, ["Si 1.0 2.0 3.0", "14 4.0 5.0 6.0 0.3", "O 0.5 0.5 0.5 0.1 0.9"])
    got = native.parse_xyz(path, default_b=0.77)
    want = jnative.parse_xyz(path, default_b=0.77)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], [14, 14, 8])
    np.testing.assert_array_equal(got[2], [0.77, 0.3, 0.1])


@pytest.mark.parametrize("native_flag", [True, False])
@pytest.mark.parametrize("lines,count", [(["Qq 1 2 3"], None), (["Si 1 2"], 1)])
def test_malformed_atom_lines_raise_value_error(tmp_path, native_flag, lines, count):
    path = _write_xyz(tmp_path, lines, count)
    with pytest.raises(ValueError):
        tspec.load_xyz(path, (5.0, 5.0, 5.0), native=native_flag)
    with pytest.raises(ValueError):
        jnative.parse_xyz(path)


@pytest.mark.parametrize("native_flag", [True, False])
def test_bad_header_raises_value_error(tmp_path, native_flag):
    p = tmp_path / "h.xyz"
    p.write_text("not-a-count\nx\n")
    with pytest.raises(ValueError):
        tspec.load_xyz(str(p), (5.0, 5.0, 5.0), native=native_flag)


def test_bin_slices_equals_jax():
    rng = np.random.default_rng(3)
    z = np.concatenate([rng.normal(size=200) * 30.0, [-1e5, 1e5, 0.0, 2.5]])
    got = native.bin_slices(z, z0=0.0, dz=2.5, nslices=16)
    np.testing.assert_array_equal(got, jnative.bin_slices(z, z0=0.0, dz=2.5, nslices=16))
    np.testing.assert_array_equal(got, np.clip(np.floor(z / 2.5).astype(np.int64), 0, 15))


def test_species_index_equals_jax():
    spec = tspec.make_si110_supercell(reps=(1, 1, 1))
    bfac = spec.bfactors.copy()
    bfac[::3] = 0.9  # two species of one element
    zed = spec.numbers.copy()
    zed[::5] = 8
    soa, species = native.species_index(zed, bfac)
    want_soa, want_species = jnative.species_index(zed, bfac)
    np.testing.assert_array_equal(soa, want_soa)
    assert species == want_species and len(species) == 4


def test_unbuildable_reader_warns_once_and_reads_with_python(tmp_path, monkeypatch):
    """native=None falls back to Python with one warning carrying the
    compiler's message; native=True raises NativeUnavailable."""
    path = _write_xyz(tmp_path, _random_lines(20))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_state", {})
    with pytest.warns(UserWarning, match="g\\+\\+ failed") as record:
        got = tspec.load_xyz(path, (5.0, 5.0, 5.0), native=None)
    assert len(record) == 1 and "bad.cpp" in str(record[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a second fallback says nothing
        again = tspec.load_xyz(path, (5.0, 5.0, 5.0))
    want = tspec.load_xyz(path, (5.0, 5.0, 5.0), native=False)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(want, f))
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+ failed"):
        tspec.load_xyz(path, (5.0, 5.0, 5.0), native=True)
    assert not native.available()
    assert not list((tmp_path / "build").glob("*.so"))


def test_reader_builds_into_the_ports_build_directory():
    native._lib()
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "fdes_tpu_torch"
    assert native._target().exists()
    assert native._target().parent == native.BUILD_DIR
