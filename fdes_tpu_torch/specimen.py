"""Specimen model: atom lists, slicing, and test fixtures (SURVEY.md C3).

A copy of the NumPy path of ``fdes_tpu.specimen``.  The reference loads an
atom coordinate file (x, y, z, Z, Debye-Waller B, occupancy) and z-sorts
atoms into slices on the host (SURVEY.md C3 [U?]).  Here the same happens in
NumPy on the host; the result is a set of FLAT arrays (one row per atom,
carrying its slice index) so build_potential can scatter every atom
of every slice in a single ``index_add_`` — no per-slice padding.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

SI_LATTICE_A = 5.431  # Å, conventional diamond-cubic silicon


@dataclasses.dataclass(frozen=True)
class Specimen:
    """A collection of atoms in a periodic orthogonal box.

    positions: (n, 3) float64, columns (x, y, z) in Å.
    numbers:   (n,) int32 atomic numbers Z.
    bfactors:  (n,) float64 Debye-Waller B in Å^2 (B = 8*pi^2*<u^2>).
    occupancies: (n,) float64 site occupancies in [0, 1].
    box:       (3,) float64 periodic box lengths (Lx, Ly, Lz) in Å.
    """

    positions: np.ndarray
    numbers: np.ndarray
    bfactors: np.ndarray
    occupancies: np.ndarray
    box: np.ndarray

    def __post_init__(self):
        n = self.positions.shape[0]
        if self.positions.shape != (n, 3):
            raise ValueError("positions must be (n, 3)")
        for name in ("numbers", "bfactors", "occupancies"):
            if getattr(self, name).shape != (n,):
                raise ValueError(f"{name} must be (n,)")

    @property
    def natoms(self) -> int:
        return self.positions.shape[0]


@dataclasses.dataclass(frozen=True)
class SlicedAtoms:
    """Flat per-atom arrays ready for build_potential.

    species is the unique list of (Z, B) pairs; species_idx maps each atom to
    a row of it.  slice_idx assigns each atom to one of nslices z-slices.
    All arrays share leading dimension natoms.
    """

    x: np.ndarray  # (n,) float64 Å
    y: np.ndarray  # (n,) float64 Å
    slice_idx: np.ndarray  # (n,) int32 in [0, nslices)
    species_idx: np.ndarray  # (n,) int32 in [0, nspecies)
    weight: np.ndarray  # (n,) float64 — occupancy
    species: tuple[tuple[int, float], ...]  # ((Z, B), ...)
    nslices: int
    dz: float  # Å


def slice_specimen(
    spec: Specimen, nslices: int, dz: float | None = None, z0: float = 0.0
) -> SlicedAtoms:
    """Bin atoms into ``nslices`` slices of thickness ``dz`` starting at z0.

    dz defaults to box_z / nslices.  Atoms are assigned to the slice
    containing their z coordinate; atoms outside [z0, z0 + nslices*dz) are
    clamped into the boundary slices (the reference's behavior for atoms on
    the exit face is unknown [U?]; clamping is the convention here and is
    exercised by tests).
    """
    if dz is None:
        dz = float(spec.box[2]) / nslices
    z = spec.positions[:, 2] - z0
    sidx = np.clip(np.floor(z / dz).astype(np.int64), 0, nslices - 1)

    pairs = list(zip(spec.numbers.tolist(), spec.bfactors.tolist()))
    species = tuple(sorted(set(pairs)))
    lookup = {p: i for i, p in enumerate(species)}
    species_idx = np.asarray([lookup[p] for p in pairs], dtype=np.int32)

    return SlicedAtoms(
        x=spec.positions[:, 0].astype(np.float64),
        y=spec.positions[:, 1].astype(np.float64),
        slice_idx=sidx.astype(np.int32),
        species_idx=species_idx,
        weight=spec.occupancies.astype(np.float64),
        species=species,
        nslices=int(nslices),
        dz=float(dz),
    )


def make_si110_supercell(
    reps: tuple[int, int, int] = (4, 3, 2),
    bfactor: float = 0.45,
    jitter: float = 0.0,
    seed: int = 0,
) -> Specimen:
    """Deterministic Si [110] supercell fixture (SURVEY.md §4 fixture row).

    Beam direction z is the crystal [110] axis.  The orthogonal repeat unit is
    x = [001] (period a), y = [1,-1,0]/sqrt2 (period a*sqrt2),
    z = [110]/sqrt2 (period a*sqrt2): 16 atoms, volume of two conventional
    cells.  ``reps`` tiles this unit; ``jitter`` adds seeded Gaussian
    displacements (Å) for frozen-phonon-style fixtures.
    """
    a = SI_LATTICE_A
    # Conventional diamond-cubic basis (fractional coords of the cubic cell).
    fcc = np.array([(0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0)])
    basis = np.concatenate([fcc, fcc + 0.25])  # 8 atoms / conventional cell
    # Orthonormal [110]-zone axes: rows are the new x, y, z in cubic coords.
    r = np.array(
        [
            [0.0, 0.0, 1.0],
            [1.0 / np.sqrt(2.0), -1.0 / np.sqrt(2.0), 0.0],
            [1.0 / np.sqrt(2.0), 1.0 / np.sqrt(2.0), 0.0],
        ]
    )
    cell = np.array([a, a * np.sqrt(2.0), a * np.sqrt(2.0)])  # new-frame unit
    # Generate enough conventional cells to fill the rotated unit, then wrap.
    pts = []
    for n1 in range(-2, 3):
        for n2 in range(-2, 3):
            for n3 in range(-2, 3):
                pts.append((basis + np.array([n1, n2, n3])) * a)
    pts = np.concatenate(pts) @ r.T  # rotate into the new frame
    # Dedupe atoms that wrap onto the same site: work in fractional coords
    # with a key that treats frac=1.0-eps and frac=0.0 as the same site.
    frac = np.mod(pts / cell, 1.0)
    key = np.mod(np.round(frac * 1e6).astype(np.int64), 10**6)
    _, keep = np.unique(key, axis=0, return_index=True)
    unit = (key[np.sort(keep)].astype(np.float64) / 1e6) * cell
    if unit.shape[0] != 16:
        raise AssertionError(f"Si[110] unit should have 16 atoms, got {unit.shape[0]}")

    nx, ny, nz = reps
    tiles = []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                tiles.append(unit + cell * np.array([ix, iy, iz]))
    pos = np.concatenate(tiles)
    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        pos = pos + rng.normal(scale=jitter, size=pos.shape)
    n = pos.shape[0]
    return Specimen(
        positions=pos,
        numbers=np.full((n,), 14, dtype=np.int32),
        bfactors=np.full((n,), float(bfactor)),
        occupancies=np.ones((n,)),
        box=cell * np.array([nx, ny, nz], dtype=np.float64),
    )


def load_xyz(
    path: str,
    box: tuple[float, float, float],
    bfactor: float = 0.0,
    native: bool | None = None,
) -> Specimen:
    """.xyz reader (symbol x y z [B [occ]]) — SURVEY.md C3 I/O.

    native=True reads with the C++ parser (fdes_tpu_torch.native, strtod
    speed for tomography-scale atom counts) and raises NativeUnavailable
    where it cannot be built; False reads with Python; None tries the C++
    parser and, where it cannot be built, warns once with the compiler's
    message and reads with Python (the JAX package falls back without a
    word).  Both parsers give the same arrays, and both raise ValueError on
    a malformed file.
    """
    if native is not False:
        from . import native as native_mod

        try:
            pos, numbers, bf, occ = native_mod.parse_xyz(path, default_b=bfactor)
        except native_mod.NativeUnavailable as e:
            if native:
                raise
            if native_mod.first_fallback():
                warnings.warn(f"load_xyz reads with Python: {e}", stacklevel=2)
        else:
            return Specimen(pos, numbers, bf, occ, np.asarray(box, dtype=np.float64))
    from .scattering import Z_OF_SYMBOL

    with open(path) as fh:
        lines = fh.read().split("\n")
    try:
        n = int(lines[0].strip())
        rows = [ln.split() for ln in lines[2 : 2 + n]]
        pos = np.asarray([[float(r[1]), float(r[2]), float(r[3])] for r in rows])
        numbers = np.asarray(
            [Z_OF_SYMBOL[r[0]] if not r[0].isdigit() else int(r[0]) for r in rows],
            dtype=np.int32,
        )
    except (IndexError, KeyError) as e:
        raise ValueError(f"{path}: malformed atom line ({e!r})") from None
    bf = np.asarray([float(r[4]) if len(r) > 4 else bfactor for r in rows])
    occ = np.asarray([float(r[5]) if len(r) > 5 else 1.0 for r in rows])
    return Specimen(pos, numbers, bf, occ, np.asarray(box, dtype=np.float64))
