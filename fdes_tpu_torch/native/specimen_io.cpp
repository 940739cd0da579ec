// Native specimen I/O: fast .xyz parsing and slice binning.
//
// The host-side C++ reader of the PyTorch port (counterpart of
// fdes_tpu/native/specimen_io.cpp, SURVEY.md C3/C18): large atom files
// (1e6-1e8 atoms) parse at strtod speed instead of Python-split speed.
// Built with g++ at first use and bound through ctypes
// (fdes_tpu_torch/native/__init__.py); specimen.load_xyz keeps a Python
// parser beside it.
//
// ABI: plain extern "C", fixed-width types, caller-allocated buffers.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Element symbols indexed by Z-1 (the table of fdes_tpu_torch/scattering.py).
const char* kSymbols[] = {
    "H",  "He", "Li", "Be", "B",  "C",  "N",  "O",  "F",  "Ne", "Na", "Mg",
    "Al", "Si", "P",  "S",  "Cl", "Ar", "K",  "Ca", "Sc", "Ti", "V",  "Cr",
    "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y",  "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I",  "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
    "Ta", "W",  "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po",
    "At", "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U",  "Np", "Pu", "Am", "Cm",
    "Bk", "Cf", "Es", "Fm", "Md", "No", "Lr"};
constexpr int kNumSymbols = sizeof(kSymbols) / sizeof(kSymbols[0]);

int symbol_to_z(const char* sym, int len) {
  if (len > 0 && std::isdigit(static_cast<unsigned char>(sym[0]))) {
    return std::atoi(sym);
  }
  for (int z = 0; z < kNumSymbols; ++z) {
    const char* s = kSymbols[z];
    int sl = static_cast<int>(std::strlen(s));
    if (sl == len && std::strncmp(s, sym, len) == 0) return z + 1;
  }
  return -1;
}

// Advance past whitespace (not newlines when stop_at_eol).
const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// Parse an .xyz file held in memory (buf, len):
//   line 0: atom count; line 1: comment; then: symbol x y z [B [occ]].
// Fills caller-allocated arrays of capacity `cap`:
//   xyz (cap*3 doubles, row-major), zed (cap int32), bfac, occ (cap doubles).
// default_b fills missing B columns.  Returns atoms parsed, or
//   -1: header unreadable   -2: capacity too small   -3: bad atom line.
int64_t fdes_parse_xyz(const char* buf, int64_t len, int64_t cap,
                       double default_b, double* xyz, int32_t* zed,
                       double* bfac, double* occ) {
  const char* p = buf;
  const char* end = buf + len;
  char* q = nullptr;
  long n = std::strtol(p, &q, 10);
  if (q == p || n < 0) return -1;
  p = next_line(p, end);  // rest of count line
  p = next_line(p, end);  // comment line
  if (n > cap) return -2;
  for (long i = 0; i < n; ++i) {
    p = skip_ws(p, end);
    if (p >= end) return -3;
    const char* sym = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    int z = symbol_to_z(sym, static_cast<int>(p - sym));
    if (z <= 0) return -3;
    zed[i] = z;
    double vals[5];
    int got = 0;
    for (; got < 5; ++got) {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') break;
      char* next = nullptr;
      double v = std::strtod(p, &next);
      if (next == p) break;
      vals[got] = v;
      p = next;
    }
    if (got < 3) return -3;
    xyz[3 * i + 0] = vals[0];
    xyz[3 * i + 1] = vals[1];
    xyz[3 * i + 2] = vals[2];
    bfac[i] = got > 3 ? vals[3] : default_b;
    occ[i] = got > 4 ? vals[4] : 1.0;
    p = next_line(p, end);
  }
  return n;
}

// Bin atom z coordinates into nslices slices of thickness dz from z0,
// clamping out-of-range atoms into the boundary slices (the same
// convention as specimen.slice_specimen — exercised by tests).
void fdes_bin_slices(const double* z, int64_t n, double z0, double dz,
                     int32_t nslices, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    double f = (z[i] - z0) / dz;
    int64_t idx = static_cast<int64_t>(f >= 0 ? f : f - 1);  // floor
    if (idx < 0) idx = 0;
    if (idx >= nslices) idx = nslices - 1;
    out[i] = static_cast<int32_t>(idx);
  }
}

// Deduplicate (Z, B) pairs into a species table and map each atom to its
// species row (the host step before the potential build's scatter,
// SURVEY.md §3.3).  species_z/species_b must have capacity n.  Returns the
// number of unique species.
int32_t fdes_species_index(const int32_t* zed, const double* bfac, int64_t n,
                           int32_t* species_of_atom, int32_t* species_z,
                           double* species_b) {
  int32_t nsp = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t found = -1;
    for (int32_t s = 0; s < nsp; ++s) {
      if (species_z[s] == zed[i] && species_b[s] == bfac[i]) {
        found = s;
        break;
      }
    }
    if (found < 0) {
      species_z[nsp] = zed[i];
      species_b[nsp] = bfac[i];
      found = nsp++;
    }
    species_of_atom[i] = found;
  }
  return nsp;
}

}  // extern "C"
