"""The port's host layer against fdes_tpu: constants, grids, scattering,
specimen, optics, config and I/O copies give the same outputs; the port
imports no JAX and nothing of fdes_tpu."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import config as jcfg  # noqa: E402
from fdes_tpu import constants as jconst  # noqa: E402
from fdes_tpu import grids as jgrids  # noqa: E402
from fdes_tpu import optics as joptics  # noqa: E402
from fdes_tpu import scattering as jscat  # noqa: E402
from fdes_tpu import specimen as jspec  # noqa: E402
from fdes_tpu_torch import config as tcfg  # noqa: E402
from fdes_tpu_torch import constants as tconst  # noqa: E402
from fdes_tpu_torch import grids as tgrids  # noqa: E402
from fdes_tpu_torch import io as tio  # noqa: E402
from fdes_tpu_torch import optics as toptics  # noqa: E402
from fdes_tpu_torch import scattering as tscat  # noqa: E402
from fdes_tpu_torch import specimen as tspec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tgrid(grid):
    return tgrids.Grid(grid.ny, grid.nx, grid.py, grid.px)


@pytest.mark.parametrize("kv", [100e3, 200e3, 300e3])
def test_constants_equal(kv):
    assert tconst.wavelength_A(kv) == jconst.wavelength_A(kv)
    assert tconst.interaction_sigma(kv) == jconst.interaction_sigma(kv)
    assert tconst.lorentz_gamma(kv) == jconst.lorentz_gamma(kv)
    assert tconst.POTENTIAL_PREFACTOR == jconst.POTENTIAL_PREFACTOR


@pytest.mark.parametrize("tilt", [(0.0, 0.0), (2e-3, -1e-3)])
def test_grids_and_propagator_equal(si110_config1, tilt):
    _, grid, sliced = si110_config1
    tg = _tgrid(grid)
    lam = jconst.wavelength_A(300e3)
    for name in ("q2", "bandlimit_mask", "xy_grids", "q_grids"):
        np.testing.assert_array_equal(getattr(tg, name)(), getattr(grid, name)())
    assert tg.extent == grid.extent and tg.q_nyquist() == grid.q_nyquist()
    np.testing.assert_array_equal(
        tgrids.fresnel_propagator(tg, lam, sliced.dz, tilt_xy_rad=tilt),
        jgrids.fresnel_propagator(grid, lam, sliced.dz, tilt_xy_rad=tilt),
    )


@pytest.mark.parametrize("kind", ["wentzel", "moliere", "kirkland"])
def test_scattering_tables_equal(si110_config1, kind):
    _, grid, _ = si110_config1
    params = {14: np.linspace(0.1, 1.2, 12)} if kind == "kirkland" else None
    species = [(14, 0.45), (8, 0.3)] if kind != "kirkland" else [(14, 0.45)]
    got = tscat.species_form_factors(
        grid.q2(), species, tscat.ScatteringTable(kind=kind, params=params)
    )
    want = jscat.species_form_factors(
        grid.q2(), species, jscat.ScatteringTable(kind=kind, params=params)
    )
    np.testing.assert_array_equal(got, want)


def test_kirkland_table_loader_equal(tmp_path):
    p = tmp_path / "fparams.dat"
    rows = "\n".join(" ".join(f"{x:.6f}" for x in np.arange(4) + 4 * r + 1) for r in range(3))
    p.write_text(f"Z = 14, chisq= 0.1\n{rows}\nZ = 8, chisq=0.2\n{rows}\n")
    got, want = tscat.load_kirkland_table(str(p)), jscat.load_kirkland_table(str(p))
    assert got.params.keys() == want.params.keys()
    for z in want.params:
        np.testing.assert_array_equal(got.params[z], want.params[z])


@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_specimen_and_slicing_equal(jitter):
    got = tspec.make_si110_supercell(reps=(4, 3, 3), jitter=jitter, seed=7)
    want = jspec.make_si110_supercell(reps=(4, 3, 3), jitter=jitter, seed=7)
    for f in ("positions", "numbers", "bfactors", "occupancies", "box"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    gs, ws = tspec.slice_specimen(got, 16), jspec.slice_specimen(want, 16)
    for f in dataclasses.fields(ws):
        a, b = getattr(gs, f.name), getattr(ws, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_load_xyz_equal_native_and_python(tmp_path):
    p = tmp_path / "a.xyz"
    p.write_text("3\ncomment\nSi 0.0 0.5 1.0\nO 1.0 1.5 2.0 0.3\n14 2.0 2.5 3.0 0.4 0.5\n")
    got = tspec.load_xyz(str(p), (5.0, 5.0, 5.0), bfactor=0.2, native=False)
    want = jspec.load_xyz(str(p), (5.0, 5.0, 5.0), bfactor=0.2, native=False)
    native = tspec.load_xyz(str(p), (5.0, 5.0, 5.0), bfactor=0.2, native=True)
    default = tspec.load_xyz(str(p), (5.0, 5.0, 5.0), bfactor=0.2)
    for f in ("positions", "numbers", "bfactors", "occupancies", "box"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(native, f), getattr(got, f))
        np.testing.assert_array_equal(getattr(default, f), getattr(got, f))


#: names of fdes_tpu.__all__ that exist only for JAX (none is exported
#: today: grids.host_cast and phonon.jax_tree_add/jax_tree_scale are module
#: helpers)
JAX_ONLY = {"host_cast", "jax_tree_add", "jax_tree_scale"}


def test_package_exports_cover_fdes_tpu():
    import fdes_tpu
    import fdes_tpu_torch

    assert not set(fdes_tpu.__all__) - JAX_ONLY - set(fdes_tpu_torch.__all__)
    for name in fdes_tpu_torch.__all__:  # every name a class or function of the port
        obj = getattr(fdes_tpu_torch, name)
        assert callable(obj) and obj.__module__.startswith("fdes_tpu_torch."), name


ABERRATIONS = dict(cs=1.2e7, c5=1e9, a1=30.0, a1_angle=0.3, b2=200.0, a2=150.0,
                   s3=1e4, a3=2e4, a3_angle=0.7)


@pytest.mark.parametrize("envelope", [False, True])
def test_ctf_series_equal(si110_config1, envelope):
    _, grid, _ = si110_config1
    lam = jconst.wavelength_A(300e3)
    kw = dict(aperture_semiangle_rad=20e-3)
    if envelope:
        kw.update(defocus_spread_A=30.0, source_semiangle_rad=0.5e-3)
    defoci = np.array([-400.0, -100.0, 200.0])
    got = toptics.ctf_series(_tgrid(grid), lam, defoci, toptics.Aberrations(**ABERRATIONS), **kw)
    want = joptics.ctf_series(grid, lam, defoci, joptics.Aberrations(**ABERRATIONS), **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_ctf_quadrature_series_equal(si110_small):
    _, grid, _ = si110_small
    lam = jconst.wavelength_A(300e3)
    kw = dict(aperture_semiangle_rad=20e-3, defocus_spread_A=30.0,
              source_semiangle_rad=0.5e-3, n_defocus=3, n_tilt=3)
    defoci = np.array([-100.0, 100.0])
    got_c, got_w = toptics.ctf_quadrature_series(
        _tgrid(grid), lam, defoci, toptics.Aberrations(cs=1.2e7), **kw)
    want_c, want_w = joptics.ctf_quadrature_series(
        grid, lam, defoci, joptics.Aberrations(cs=1.2e7), **kw)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_w, want_w)


@pytest.mark.parametrize(
    "name", sorted(f for f in os.listdir(os.path.join(REPO, "examples")) if f.endswith(".toml"))
)
def test_config_loading_equal(name):
    path = os.path.join(REPO, "examples", name)
    overrides = ["sim.nslices=7", "optics.defoci_A=[-1.0, 2.0]", "seed=3"]
    got = tcfg.apply_overrides(tcfg.load_config(path), overrides)
    want = jcfg.apply_overrides(jcfg.load_config(path), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_errors_and_legacy_reader(tmp_path):
    with pytest.raises(KeyError):
        tcfg.config_from_dict({"sim": {"bogus_key": 1}})
    with pytest.raises(ValueError):
        tcfg.apply_overrides(tcfg.Config(), ["sim.ny.deep=1"])
    p = tmp_path / "legacy.txt"
    p.write_text("# c\nvoltage: 300e3\ngrid = 64 64\nname si\n")
    assert tcfg.load_legacy_params(str(p)) == jcfg.load_legacy_params(str(p))


def test_io_accepts_tensors(tmp_path):
    z = torch.randn(4, 6, dtype=torch.complex64)
    tio.write_npy(str(tmp_path / "a" / "z.npy"), z)
    np.testing.assert_array_equal(tio.read_npy(str(tmp_path / "a" / "z.npy")), z.numpy())
    tio.write_raw(str(tmp_path / "z.bin"), z)
    back = tio.read_raw(str(tmp_path / "z.bin"), (4, 6), np.float32, complex_interleaved=True)
    np.testing.assert_array_equal(back, z.numpy())
    with pytest.raises(ValueError):
        tio.read_raw(str(tmp_path / "z.bin"), (5, 6), np.float32)


_BLOCKED_IMPORT = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
sys.modules["fdes_tpu"] = None
import fdes_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fdes_tpu_torch.__path__, "fdes_tpu_torch.")]
assert "fdes_tpu_torch.kernels.panel_scan" in names, names
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "fdes_tpu.")) for k in sys.modules if sys.modules[k] is not None)
from fdes_tpu_torch.cli import main
rc = main([sys.argv[1], "--device", "cpu", "--set", "output_dir=" + sys.argv[2]])
assert rc == 0, rc
print("imported", len(names))
"""


def test_port_runs_with_jax_blocked(tmp_path):
    cfg = tmp_path / "toy.toml"
    cfg.write_text(
        'mode = "hrtem"\n[sim]\nny = 64\nnx = 64\nnslices = 4\n'
        '[specimen]\nreps = [1, 1, 1]\n[optics]\ndefoci_A = [-100.0, 100.0]\n'
    )
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(cfg), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "imported" in r.stdout
    imgs = np.load(tmp_path / "out" / "images.npy")
    assert imgs.shape == (2, 64, 64) and np.all(np.isfinite(imgs))


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_no_jax_or_fdes_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fdes_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "fdes_tpu", "optax"), (path, mod)


#: The kernel layer in the order it imports: each module imports only from
#: those before it.
KERNEL_CHAIN = ("__init__", "_build", "_runtime", "slice_step", "fused_step", "fused_scan",
                "adjoint_scan", "panel_scan")


@pytest.mark.parametrize("module", KERNEL_CHAIN)
def test_kernel_modules_import_only_downward(module):
    """A module of fdes_tpu_torch/kernels/ imports, at module or at function
    level, no kernel module after it in KERNEL_CHAIN, no underscore name of
    another module (nor reads one through a module it imported), and nothing
    of propagate."""
    kernels = os.path.join(REPO, "fdes_tpu_torch", "kernels")
    assert sorted(KERNEL_CHAIN) == sorted(n[:-3] for n in os.listdir(kernels) if n.endswith(".py"))
    below = KERNEL_CHAIN[:KERNEL_CHAIN.index(module)]
    tree = ast.parse(open(os.path.join(kernels, f"{module}.py")).read())
    modules = set()  # the names this module binds to kernel modules
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(a.name.startswith("fdes_tpu_torch") for a in node.names), module
        if not isinstance(node, ast.ImportFrom):
            continue
        where = (node.level, node.module)
        if node.level == 0:
            assert not (node.module or "").startswith("fdes_tpu_torch"), (module, where)
        elif node.level == 2:  # a module of the package beside kernels/
            assert "propagate" not in (node.module or "").split(".") + [a.name for a in
                                                                       node.names], module
        elif node.module is None:  # from . import ...
            for a in node.names:
                if a.name in KERNEL_CHAIN:
                    assert a.name in below, (module, a.name)
                    modules.add(a.asname or a.name)
                else:  # a name of the package's __init__
                    assert not a.name.startswith("_"), (module, a.name)
        else:
            assert node.module.split(".")[0] in below, (module, where)
            assert not any(a.name.startswith("_") for a in node.names), (module, where)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                and node.value.id in modules:
            assert not node.attr.startswith("_"), (module, node.value.id, node.attr)
