"""The port's frozen-phonon model against fdes_tpu.phonon on the same seeds:
the displaced specimens bit for bit, their slicing, and the incoherent mean
over tensors, tuples and dicts."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import phonon as jph  # noqa: E402
from fdes_tpu.specimen import make_si110_supercell as jmake  # noqa: E402
from fdes_tpu_torch import phonon as tph  # noqa: E402
from fdes_tpu_torch.specimen import make_si110_supercell as tmake  # noqa: E402


def test_thermal_sigma_equal():
    b = np.array([0.45, 0.0, 1.2])
    np.testing.assert_array_equal(tph.thermal_sigma_A(b), jph.thermal_sigma_A(b))
    np.testing.assert_allclose(8 * np.pi**2 * tph.thermal_sigma_A(b) ** 2, b, rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 7])
def test_phonon_configs_equal_jax_bit_for_bit(seed):
    got = tph.phonon_configs(tmake(reps=(2, 2, 1), bfactor=0.8), 3, seed=seed)
    want = jph.phonon_configs(jmake(reps=(2, 2, 1), bfactor=0.8), 3, seed=seed)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in ("positions", "numbers", "bfactors", "occupancies", "box"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
        assert (g.bfactors == 0).all()
    assert not np.array_equal(got[0].positions, got[1].positions)


def test_phonon_sliced_equal_jax():
    got = tph.phonon_sliced(tmake(reps=(2, 2, 2), bfactor=0.6), 2, 8, seed=3)
    want = jph.phonon_sliced(jmake(reps=(2, 2, 2), bfactor=0.6), 2, 8, seed=3)
    for g, w in zip(got, want):
        for field in ("x", "y", "slice_idx", "species_idx", "weight"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
        assert g.species == w.species and g.nslices == w.nslices and g.dz == w.dz


def test_phonon_configs_statistics():
    """The displacements are isotropic Gaussians of the B factor's RMS."""
    spec = tmake(reps=(2, 2, 1), bfactor=0.8)
    disp = np.stack([c.positions - spec.positions for c in tph.phonon_configs(spec, 200, seed=1)])
    np.testing.assert_allclose(disp.mean(), 0.0, atol=2e-3)
    np.testing.assert_allclose(disp.std(), tph.thermal_sigma_A(0.8), rtol=0.05)


def _leaves(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree) if isinstance(tree, tuple) else [tree]


@pytest.mark.parametrize("kind", ["tensor", "tuple", "dict"])
def test_phonon_average_equals_jax(kind):
    """The incoherent mean of intensity trees (a tensor, a tuple and a dict
    of tensors) against fdes_tpu's mean of the same arrays."""
    rng = np.random.default_rng(5)
    data = [rng.uniform(0, 1, (2, 8, 8)) for _ in range(3)]

    def tree(a, put):
        if kind == "tensor":
            return put(a)
        if kind == "tuple":
            return (put(a[0]), put(a[1]))
        return {"bf": put(a[0]), "adf": put(a[1])}

    got = tph.phonon_average(lambda i: tree(data[i], torch.as_tensor), range(3))
    want = jph.phonon_average(lambda i: tree(data[i], jnp.asarray), range(3))
    assert type(got) is type(tree(data[0], torch.as_tensor))
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)
