// The row-pass / column-pass FFT pipeline shared by the fused kernels, for
// Hopper (sm_90a): included by fused_step.cu (the step, its adjoint, the
// whole-loop scan), adjoint_scan.cu (the whole-loop adjoint) and
// panel_scan.cu (the panel passes for 256^2 to 4096^2 and their adjoints;
// bwd_row_tile, the adjoint of a row pass, serves the last two).
//
// A plane of N x N complex64 is transformed in two kinds of pass over tiles of
// 4096 elements (32 KB of shared memory): a row tile is 4096/N whole rows (1-D
// transforms along x), a column tile a panel of 4096/N adjacent columns (1-D
// transforms along y, with the propagator multiply between the forward and the
// inverse transform).  The 1-D transform is radix 2 in shared memory: forward
// decimation in frequency (natural order in, bit-reversed out), inverse
// decimation in time (bit-reversed in, natural out), so the spectrum stays in
// bit-reversed order in both axes and the caller hands the propagator in that
// order.  fused_step.cu's head comment has the whole design.  The end of the
// file holds the in-cluster transform of fused_step.cu's cluster_scan_kernel,
// which keeps a whole 128^2 to 512^2 plane in a thread-block cluster's shared
// memory instead of passing it through global memory between tiles.  "The
// wide transform" holds one 1-D transform in the registers of a pair of
// warps; its row functions (wide_fwd_row, wide_bwd_row), the ordered sum of
// partial dV planes and the cooperative launch serve adjoint_scan.cu's wide
// store pair and fused_step.cu's wide step and adjoint alike, and its forward
// sweep (wide_forward_sweep, the whole loop) adjoint_scan.cu's wide forward
// kernels and fused_step.cu's wide_scan_kernel.
//
// Everything here lives in an unnamed namespace: each library that includes
// the header compiles its own copy.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                    // complex elements per tile
constexpr int kTilePadded = kTile + kTile / 16;
constexpr int kMaxTwiddles = 512;              // N/2 at N = 1024, the kernels of n <= 1024
// Twiddles of an N-point transform, N/2: the panel kernels hold exactly this
// many, in dynamic shared memory (2,048 = 16 KB at N = 4096), so that the
// static tables of the kernels above keep their size.
template <int LOG2N>
constexpr int kTwiddlesOf = 1 << (LOG2N - 1);
constexpr int kMaxBlocks = 132 * 8;            // ordinary launches: grid-stride over tiles

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * b
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
// p * exp(i * phase)
__device__ __forceinline__ float2 transmit(float2 p, float phase) {
  float s, c;
  sincosf(phase, &s, &c);
  return make_float2(p.x * c - p.y * s, p.x * s + p.y * c);
}
// p * exp(i * phase) * exp(-damp): full-precision sincosf and expf
__device__ __forceinline__ float2 transmit(float2 p, float phase, float damp) {
  float s, c;
  sincosf(phase, &s, &c);
  const float d = expf(-damp);
  s *= d;
  c *= d;
  return make_float2(p.x * c - p.y * s, p.x * s + p.y * c);
}
// a, b (elements 2i, 2i + 1) times exp(i sigma v).  VC: v points at element
// 2i of a complex plane (float2 values, 4i floats in), whose real parts are
// the potentials; with ABS that plane is an absorptive potential vr + i vi,
// whose imaginary parts damp by exp(-sigma vi).
template <bool ABS, bool VC = false>
__device__ __forceinline__ void transmit_pair(float2* a, float2* b, const float* __restrict__ v,
                                              float sigma) {
  static_assert(!ABS || VC, "an absorptive potential is read as one complex plane");
  if constexpr (VC) {
    const float4 z = *reinterpret_cast<const float4*>(v);
    if constexpr (ABS) {
      *a = transmit(*a, sigma * z.x, sigma * z.y);
      *b = transmit(*b, sigma * z.z, sigma * z.w);
    } else {
      *a = transmit(*a, sigma * z.x);
      *b = transmit(*b, sigma * z.z);
    }
  } else {
    const float2 vv = *reinterpret_cast<const float2*>(v);
    *a = transmit(*a, sigma * vv.x);
    *b = transmit(*b, sigma * vv.y);
  }
}

// tw[k] = exp(-2*pi*i*k/N), k < N/2.
template <int LOG2N>
__device__ void init_twiddles(float2* tw) {
  constexpr int N = 1 << LOG2N;
  for (int k = threadIdx.x; k < N / 2; k += kThreads) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(k) / static_cast<float>(N), &s, &c);
    tw[k] = make_float2(c, s);
  }
}

// The staged twiddle table of a transform of up to N points, N - 1 entries:
// for each half size hs = 1, 2, 4, ..., N/2 the run tw[hs - 1 + jj] =
// exp(-2*pi*i*jj/(2*hs)), jj < hs.  The plain table (init_twiddles) holds
// only the N-point twiddles, which the smaller half sizes read at a stride of
// a power of two: in row transforms, where neighbouring threads differ in jj,
// those reads fall on one shared-memory bank.  In the staged table they lie
// side by side.  Its last run is the plain table, and its runs serve every
// transform of up to N points.
template <int LOG2N, int THREADS>
__device__ void init_staged_twiddles(float2* tw) {
  constexpr int N = 1 << LOG2N;
  for (int i = threadIdx.x; i < N - 1; i += THREADS) {
    const int hs = 1 << (31 - __clz(i + 1));
    float s, c;
    sincospif(-static_cast<float>(i + 1 - hs) / static_cast<float>(hs), &s, &c);
    tw[i] = make_float2(c, s);
  }
}

// K radix-2 stages on the 2^K elements x of one work item (stage_group),
// whose lowest lies at offset r in its half of size g = 1 << lg; tw is the
// plain table, or with STAGED the staged one.
template <int LOG2N, int K, bool INVERSE, bool STAGED = false>
__device__ __forceinline__ void group_butterflies(float2 (&x)[1 << K], const float2* tw, int lg,
                                                  int r) {
  constexpr int R = 1 << K;
  const int g = 1 << lg;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int ld = INVERSE ? s : K - 1 - s;  // log2 of the pair distance in registers
    const int d = 1 << ld;
    const int tshift = LOG2N - 1 - lg - ld;  // twiddle index step N / (2 * hs)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & d) continue;
      const int jj = r + (j & (d - 1)) * g;
      const float2 wv = STAGED ? tw[(g << ld) - 1 + jj] : tw[jj << tshift];
      const float2 a = x[j];
      const float2 b = x[j + d];
      if (INVERSE) {
        const float2 t = cmul_conj(b, wv);
        x[j] = cadd(a, t);
        x[j + d] = csub(a, t);
      } else {
        x[j] = cadd(a, b);
        x[j + d] = cmul(csub(a, b), wv);
      }
    }
  }
}

// K fused radix-2 stages on every transform of the tile.
//
// ROWS: element k of transform q lies at tile[pad(q * N + k)] (q < TILE/N);
// columns: at tile[pad(k * Q + q)], Q = TILE/N transforms side by side.
// TILE is kTile but for column tiles wider than one tile (col_tile's C).
// A work item holds the 2^K elements base + j * g, g = 1 << lg the smallest
// half size of the group.  Forward (decimation in frequency): half sizes
// g << (K-1), ..., 2g, g, in that order, a' = a + b, b' = (a - b) * w.
// Inverse (decimation in time): g, 2g, ..., g << (K-1), t = b * conj(w),
// a' = a + t, b' = a - t.  w = exp(-2*pi*i*jj/(2*hs)) for the pair whose lower
// element lies at offset jj in its half of size hs.
//
// THREADS (here and in fft_forward, fft_inverse): the block's threads; the
// tile passes run kThreads, the cluster kernel kClusterThreads.
//
// TRANSMIT (INVERSE rows, the last group of an inverse transform): then each
// element times exp(i sigma v[q N + k]) and the same group forward, the
// first group of the next forward transform: one pass for three.  STAGED: tw
// is the staged twiddle table (init_staged_twiddles).
template <int LOG2N, int K, bool ROWS, bool INVERSE, int TILE = kTile, int THREADS = kThreads,
          bool TRANSMIT = false, bool STAGED = false>
__device__ __forceinline__ void stage_group(float2* tile, const float2* tw, int lg,
                                            const float* v = nullptr, float sigma = 0.0f) {
  static_assert(!TRANSMIT || (ROWS && INVERSE), "the transmit sits between two row groups");
  constexpr int N = 1 << LOG2N;
  constexpr int Q = TILE / N;
  constexpr int R = 1 << K;
  constexpr int kItems = TILE >> K;
  constexpr int kItemsPerTransform = N >> K;
  const int g = 1 << lg;
  for (int u = threadIdx.x; u < kItems; u += THREADS) {
    int q, w;
    if (ROWS) {
      q = u / kItemsPerTransform;
      w = u % kItemsPerTransform;
    } else {
      q = u % Q;
      w = u / Q;
    }
    const int r = w & (g - 1);
    const int base = ((w >> lg) << (lg + K)) + r;
    float2 x[R];
    int at[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = base + j * g;
      at[j] = pad(ROWS ? q * N + k : k * Q + q);
      x[j] = tile[at[j]];
    }
    group_butterflies<LOG2N, K, INVERSE, STAGED>(x, tw, lg, r);
    if constexpr (TRANSMIT) {
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = transmit(x[j], sigma * v[q * N + base + j * g]);
      group_butterflies<LOG2N, K, false, STAGED>(x, tw, lg, r);
#pragma unroll
      for (int j = 0; j < R; ++j) tile[pad(q * N + base + j * g)] = x[j];  // at[] recomputed
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) tile[at[j]] = x[j];
    }
  }
}

// Forward transforms of the tile: natural order in, bit-reversed order out.
// FIRST = false: without the first group of three stages (done by a
// TRANSMIT stage_group).
template <int LOG2N, bool ROWS, int TILE = kTile, int THREADS = kThreads, bool FIRST = true,
          bool STAGED = false>
__device__ void fft_forward(float2* tile, const float2* tw) {
  int lg = LOG2N;
  if (!FIRST) lg -= 3;
  while (lg >= 3) {
    lg -= 3;
    stage_group<LOG2N, 3, ROWS, false, TILE, THREADS, false, STAGED>(tile, tw, lg);
    __syncthreads();
  }
  if (lg == 2) {
    stage_group<LOG2N, 2, ROWS, false, TILE, THREADS, false, STAGED>(tile, tw, 0);
    __syncthreads();
  } else if (lg == 1) {
    stage_group<LOG2N, 1, ROWS, false, TILE, THREADS, false, STAGED>(tile, tw, 0);
    __syncthreads();
  }
}

// Unscaled inverse transforms: bit-reversed order in, natural order out; the
// forward stages undone last to first, so inverse(forward(x)) = N * x.  LAST
// = false: without the last group of three stages (lg = LOG2N - 3, the
// group a forward transform starts with).
template <int LOG2N, bool ROWS, int TILE = kTile, int THREADS = kThreads, bool LAST = true,
          bool STAGED = false>
__device__ void fft_inverse(float2* tile, const float2* tw) {
  constexpr int kRem = LOG2N % 3;
  int lg = 0;
  if (kRem == 2) {
    stage_group<LOG2N, 2, ROWS, true, TILE, THREADS, false, STAGED>(tile, tw, 0);
    __syncthreads();
    lg = 2;
  } else if (kRem == 1) {
    stage_group<LOG2N, 1, ROWS, true, TILE, THREADS, false, STAGED>(tile, tw, 0);
    __syncthreads();
    lg = 1;
  }
  while (lg < (LAST ? LOG2N : LOG2N - 3)) {
    stage_group<LOG2N, 3, ROWS, true, TILE, THREADS, false, STAGED>(tile, tw, lg);
    __syncthreads();
    lg += 3;
  }
}

__device__ __forceinline__ void load_pair(const float2* p, float2* a, float2* b) {
  const float4 z = *reinterpret_cast<const float4*>(p);
  *a = make_float2(z.x, z.y);
  *b = make_float2(z.z, z.w);
}
__device__ __forceinline__ void store_pair(float2* p, float2 a, float2 b) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, b.x, b.y);
}

// One row tile: 4096 contiguous elements (4096/N rows) at src, written to dst
// (dst may be src).  inverse: undo the x transform of the previous step first.
// v != nullptr: multiply by exp(i*sigma*v) (v points at the tile's 4096
// potentials).  forward: transform along x.  src
// may have been written by other blocks before the last barrier, so it is
// read with plain loads.
//
// STORES (the forward pass under differentiation): the tile is in natural
// order between the inverse and the forward x transform, and only there;
// pre != nullptr receives it before the transmit (a checkpoint of psi_j),
// post != nullptr after it (s_j = t_j * psi_j), and dst == nullptr skips the
// final store.  VC: v is a complex plane whose real parts are the
// potentials (the streamed build's V_0); with ABS its imaginary parts damp
// (an absorptive potential, transmit_pair).
template <int LOG2N, bool STORES = false, bool ABS = false, bool VC = false>
__device__ void row_tile(float2* tile, const float2* tw, const float2* src, float2* dst,
                         const float* __restrict__ v, float sigma, bool inverse, bool forward,
                         float2* pre = nullptr, float2* post = nullptr) {
  constexpr int kVPair = VC ? 4 : 2;  // floats of v between elements 2i and 2i + 2
  const bool transmit_on_load = v != nullptr && !inverse;
  for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
    float2 a, b;
    load_pair(src + 2 * i, &a, &b);
    if (STORES && !inverse && pre != nullptr) store_pair(pre + 2 * i, a, b);
    if (transmit_on_load) transmit_pair<ABS, VC>(&a, &b, v + kVPair * i, sigma);
    if (STORES && !inverse && post != nullptr) store_pair(post + 2 * i, a, b);
    tile[pad(2 * i)] = a;
    tile[pad(2 * i + 1)] = b;
  }
  __syncthreads();
  if (inverse) {
    fft_inverse<LOG2N, true>(tile, tw);
    if (v != nullptr || (STORES && (pre != nullptr || post != nullptr))) {
      for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
        float2 a = tile[pad(2 * i)];
        float2 b = tile[pad(2 * i + 1)];
        if (STORES && pre != nullptr) store_pair(pre + 2 * i, a, b);
        if (v != nullptr) {
          transmit_pair<ABS, VC>(&a, &b, v + kVPair * i, sigma);
          tile[pad(2 * i)] = a;
          tile[pad(2 * i + 1)] = b;
        }
        if (STORES && post != nullptr) store_pair(post + 2 * i, a, b);
      }
      __syncthreads();
    }
  }
  if (forward) fft_forward<LOG2N, true>(tile, tw);
  if (!STORES || dst != nullptr) {
    for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
      store_pair(dst + 2 * i, tile[pad(2 * i)], tile[pad(2 * i + 1)]);
    }
  }
  __syncthreads();  // the next tile reuses the shared memory
}

// One column tile: the panel of C adjacent columns from column c0 of one
// wave's plane src, all N rows (C * N elements: one 4096-element tile for
// the default C, more for the panel scan's wider panels in dynamic shared
// memory), written to dst (dst may be src): forward y transform, times the
// propagator (bit-reversed order, conjugated for the adjoint) over N^2,
// inverse y transform.  Each row of the panel is loaded and stored as pairs
// of adjacent columns, so C >= 2 (at N = 4096 one tile is a single column).
template <int LOG2N, int C = kTile / (1 << LOG2N)>
__device__ void col_tile(float2* tile, const float2* tw, const float2* src, float2* dst, int c0,
                         const float2* __restrict__ prop, bool conj_p) {
  constexpr int N = 1 << LOG2N;
  constexpr int TILE = C * N;
  static_assert(C >= 2, "a column panel is at least two columns wide");
  for (int i = threadIdx.x; i < TILE / 2; i += kThreads) {
    const int e = 2 * i;
    float2 a, b;
    load_pair(src + static_cast<int64_t>(e / C) * N + c0 + e % C, &a, &b);
    tile[pad(e)] = a;
    tile[pad(e + 1)] = b;
  }
  __syncthreads();
  fft_forward<LOG2N, false, TILE>(tile, tw);
  const float scale = 1.0f / (static_cast<float>(N) * static_cast<float>(N));
  const float sign = conj_p ? -scale : scale;
  for (int i = threadIdx.x; i < TILE / 2; i += kThreads) {
    const int e = 2 * i;
    const float4 p =
        *reinterpret_cast<const float4*>(prop + static_cast<int64_t>(e / C) * N + c0 + e % C);
    tile[pad(e)] = cmul(tile[pad(e)], make_float2(p.x * scale, p.y * sign));
    tile[pad(e + 1)] = cmul(tile[pad(e + 1)], make_float2(p.z * scale, p.w * sign));
  }
  __syncthreads();
  fft_inverse<LOG2N, false, TILE>(tile, tw);
  for (int i = threadIdx.x; i < TILE / 2; i += kThreads) {
    const int e = 2 * i;
    store_pair(dst + static_cast<int64_t>(e / C) * N + c0 + e % C, tile[pad(e)],
               tile[pad(e + 1)]);
  }
  __syncthreads();  // the next tile reuses the shared memory
}

// Pairs of tile elements per thread: a dV accumulator holds this many float2.
constexpr int kPairsPerThread = kTile / 2 / kThreads;

// One wave's row tile of a reverse loop (the adjoint of a row pass), from src
// to dst (dst may be src): undo the x transform (the tile then holds bar_s),
// add Im(bar_s * conj(s)) to acc, scale by conj(t), t = exp(i sigma v), and
// transform along x again for the next slice's column pass (forward), or
// leave dpsi in natural order.  s points at the tile's s = t * psi of the
// forward pass; FROM_PSI: at the tile's psi instead, and s is formed here
// (the per-slice adjoint keeps psi, not s).
template <int LOG2N, bool FROM_PSI = false>
__device__ void bwd_row_tile(float2* tile, const float2* tw, const float2* src, float2* dst,
                             const float2* s, const float* __restrict__ v, float sigma,
                             bool forward, float2 (&acc)[kPairsPerThread]) {
  for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
    float2 x, y;
    load_pair(src + 2 * i, &x, &y);
    tile[pad(2 * i)] = x;
    tile[pad(2 * i + 1)] = y;
  }
  __syncthreads();
  fft_inverse<LOG2N, true>(tile, tw);
#pragma unroll
  for (int m = 0; m < kPairsPerThread; ++m) {
    const int i = threadIdx.x + m * kThreads;
    const float2 vv = *reinterpret_cast<const float2*>(v + 2 * i);
    float2 u0, u1;
    load_pair(s + 2 * i, &u0, &u1);
    const float2 b0 = tile[pad(2 * i)];
    const float2 b1 = tile[pad(2 * i + 1)];
    float sn, cs;
    sincosf(sigma * vv.x, &sn, &cs);
    if (FROM_PSI) u0 = cmul(u0, make_float2(cs, sn));
    tile[pad(2 * i)] = cmul_conj(b0, make_float2(cs, sn));
    sincosf(sigma * vv.y, &sn, &cs);
    if (FROM_PSI) u1 = cmul(u1, make_float2(cs, sn));
    tile[pad(2 * i + 1)] = cmul_conj(b1, make_float2(cs, sn));
    acc[m].x += b0.y * u0.x - b0.x * u0.y;  // Im(bar_s * conj(s))
    acc[m].y += b1.y * u1.x - b1.x * u1.y;
  }
  __syncthreads();
  if (forward) fft_forward<LOG2N, true>(tile, tw);
  for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
    store_pair(dst + 2 * i, tile[pad(2 * i)], tile[pad(2 * i + 1)]);
  }
  __syncthreads();
}

// ---- the in-cluster 2-D transform ------------------------------------------
//
// One wave's whole N x N plane held in the shared memory of a thread-block
// cluster of C CTAs (sm_90 distributed shared memory), so that a slice loop
// never takes the plane through global memory.  CTA c (its rank in the
// cluster) holds the R = N/C rows y = C r + c, row r at tile[pad(r N + x)]:
// 16,384 elements (136 KiB padded) at every size.  With w_M = exp(-2 pi i/M)
// and k = k_b + R k_a (k_b < R, k_a < C), the y transform of a column is
//
//   X[k_b + R k_a] = sum_c w_C^(c k_a) w_N^(c k_b) sum_r w_R^(r k_b) psi[C r + c]
//
// so a CTA transforms its rows along x and its own R rows along y (both in
// its shared memory, radix 2 as the tile passes), and one cross step per
// slice finishes the y transform: the (k_b, x) pairs are split among the C
// CTAs; the owner of a pair reads its C values, one from each CTA
// (map_shared_rank), applies the twiddles w_N^(c k_b), does the C-point DFT
// in registers, multiplies by P / N^2, does the C-point inverse DFT, undoes
// the twiddles, and writes the C values back where it read them.  Then each
// CTA undoes its R-point and x transforms locally.  The plane crosses the
// cluster once each way per slice, between two cluster barriers.
//
// Spectral order: the x and R-point transforms are decimation in frequency
// (bit-reversed out), the C-point one too (in registers), so position
// (r', x') of register slot j holds k_x = bitrev_N(x'), k_b = bitrev_R(r'),
// k_a = bitrev_C(j).  The caller gathers P into that order once per call:
// prop[j R N + r' N + x'] = P[bitrev_R(r') + R bitrev_C(j)][bitrev_N(x')].
// Cluster sizes: 1 at 128^2 (no distributed shared memory), 4 at 256^2, 16
// at 512^2 (a non-portable size); 1024^2 (8 MiB) fits no cluster.
constexpr int kClusterThreads = 512;

template <int LOG2N>
struct Cluster {
  static_assert(LOG2N >= 7 && LOG2N <= 9, "the cluster transform takes 128^2 to 512^2");
  static constexpr int N = 1 << LOG2N;
  static constexpr int LOG2C = LOG2N == 7 ? 0 : (LOG2N == 8 ? 2 : 4);
  static constexpr int C = 1 << LOG2C;
  static constexpr int LOG2R = LOG2N - LOG2C;
  static constexpr int R = 1 << LOG2R;
  static constexpr int kElems = R * N;                 // a CTA's share of the plane
  static constexpr int kPadded = kElems + kElems / 16;
  static constexpr int kOwnedPairs = (R / C) * N;      // cross-step pairs per CTA
  // tile, the staged twiddles (N - 1, and one to keep 16-byte alignment),
  // then the CTA's rows of one slice's V (kElems floats, 64 KiB): 204 KiB at
  // 512^2
  static constexpr size_t kVOffset = sizeof(float2) * (kPadded + N);
  static constexpr size_t kSmemBytes = kVOffset + sizeof(float) * kElems;
  static_assert(kVOffset % 16 == 0, "the V rows take 16-byte asynchronous copies");
};

// 16-byte asynchronous copy from global to shared memory (sm_80+ cp.async),
// and the wait for all of this thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the CTA's rows of one slice's potentials (v: the plane) to
// vrows (row r at vrows[r N + x]); cp_async_wait_all and a block barrier
// make them visible.
template <int LOG2N>
__device__ void cluster_prefetch_v(float* vrows, const float* __restrict__ v, int rank) {
  using S = Cluster<LOG2N>;
  for (int i = threadIdx.x; i < S::kElems / 4; i += kClusterThreads) {
    const int e = 4 * i;
    cp_async16(vrows + e,
               v + static_cast<int64_t>(S::C * (e >> LOG2N) + rank) * S::N + (e & (S::N - 1)));
  }
}

// w_N^m for 0 <= m < N from the plain table (N/2 entries).
template <int LOG2N>
__device__ __forceinline__ float2 twiddle_n(const float2* tw, int m) {
  constexpr int kHalf = 1 << (LOG2N - 1);
  const float2 t = tw[m & (kHalf - 1)];
  return m & kHalf ? make_float2(-t.x, -t.y) : t;
}

// The CTA's rows of a plane (src: its first element) into the tile, times
// exp(i sigma v) (vrows: the rows' potentials, cluster_prefetch_v's layout).
template <int LOG2N>
__device__ void cluster_load_rows(float2* tile, const float2* src, const float* vrows,
                                  float sigma, int rank) {
  using S = Cluster<LOG2N>;
  for (int i = threadIdx.x; i < S::kElems / 2; i += kClusterThreads) {
    const int e = 2 * i;
    const int64_t g = static_cast<int64_t>(S::C * (e >> LOG2N) + rank) * S::N + (e & (S::N - 1));
    float2 a, b;
    load_pair(src + g, &a, &b);
    transmit_pair<false>(&a, &b, vrows + e, sigma);
    tile[pad(e)] = a;
    tile[pad(e + 1)] = b;
  }
}

// The tile to the CTA's rows of a plane (dst: its first element).
template <int LOG2N>
__device__ void cluster_store_rows(const float2* tile, float2* dst, int rank) {
  using S = Cluster<LOG2N>;
  for (int i = threadIdx.x; i < S::kElems / 2; i += kClusterThreads) {
    const int e = 2 * i;
    const int64_t g = static_cast<int64_t>(S::C * (e >> LOG2N) + rank) * S::N + (e & (S::N - 1));
    store_pair(dst + g, tile[pad(e)], tile[pad(e + 1)]);
  }
}

// C-point transform of z in registers: forward decimation in frequency
// (natural in, bit-reversed out), or the inverse decimation in time
// (bit-reversed in, natural out, unscaled), twiddles from the staged table.
template <int LOG2C, bool INVERSE>
__device__ __forceinline__ void register_fft(float2 (&z)[1 << LOG2C], const float2* tw) {
  constexpr int C = 1 << LOG2C;
#pragma unroll
  for (int s = 0; s < LOG2C; ++s) {
    const int lh = INVERSE ? s : LOG2C - 1 - s;  // log2 of the half size
    const int h = 1 << lh;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j & h) continue;
      const float2 w = tw[h - 1 + (j & (h - 1))];  // w_(2h)^(j mod h)
      const float2 a = z[j];
      const float2 b = z[j + h];
      if (INVERSE) {
        const float2 t = cmul_conj(b, w);
        z[j] = cadd(a, t);
        z[j + h] = csub(a, t);
      } else {
        z[j] = cadd(a, b);
        z[j + h] = cmul(csub(a, b), w);
      }
    }
  }
}

// The cross step, between two cluster barriers: this CTA's pairs (rows r'
// rank R/C to (rank + 1) R/C - 1 of every CTA's tile) through the C-point
// DFT, P / N^2 (prop: the gathered propagator of this wave) and the inverse.
// tw: the staged twiddle table.
template <int LOG2N>
__device__ void cluster_cross(float2* tile, const float2* tw, const float2* __restrict__ prop,
                              int rank) {
  using S = Cluster<LOG2N>;
  const float2* tw_n = tw + S::N / 2 - 1;  // the plain N-point run
  cg::cluster_group cluster = cg::this_cluster();
  const float scale = 1.0f / (static_cast<float>(S::N) * static_cast<float>(S::N));
  // a thread's pairs are independent: with few values a pair (C <= 4),
  // several pairs' loads are in flight together
  constexpr int kPerThread = S::kOwnedPairs / kClusterThreads;
  constexpr int kUnroll = S::C == 1 ? 8 : (S::C == 4 ? 2 : 1);
#pragma unroll kUnroll
  for (int it = 0; it < kPerThread; ++it) {
    const int e = rank * S::kOwnedPairs + threadIdx.x + it * kClusterThreads;  // r' N + x'
    const int kb = S::LOG2R == 0 ? 0 : static_cast<int>(__brev(e >> LOG2N) >> (32 - S::LOG2R));
    float2 pv[S::C];
    float2 z[S::C];
#pragma unroll
    for (int j = 0; j < S::C; ++j) pv[j] = prop[j * S::kElems + e];
#pragma unroll
    for (int k = 0; k < S::C; ++k) {
      z[k] = cluster.map_shared_rank(tile, k)[pad(e)];
      if (k > 0) z[k] = cmul(z[k], twiddle_n<LOG2N>(tw_n, k * kb));
    }
    register_fft<S::LOG2C, false>(z, tw);
#pragma unroll
    for (int j = 0; j < S::C; ++j) z[j] = cmul(z[j], make_float2(pv[j].x * scale, pv[j].y * scale));
    register_fft<S::LOG2C, true>(z, tw);
#pragma unroll
    for (int k = 0; k < S::C; ++k) {
      if (k > 0) z[k] = cmul_conj(z[k], twiddle_n<LOG2N>(tw_n, k * kb));
      cluster.map_shared_rank(tile, k)[pad(e)] = z[k];
    }
  }
}

// ---- the wide transform ----------------------------------------------------
//
// One N-point transform held by a pair of warps, with no block barrier
// inside it: warp w of the pair, lane l, register m hold element k = l + 32 m
// + (N/2) w (R = N/64 registers: 2, 4, 8, 16 at N = 128 to 1024).  The
// radix-2 stage of half size N/2 pairs the two warps: each writes its N/2
// values to the pair's buffer in shared memory and reads the other's, between
// two 64-thread named barriers (bar.sync, one id a pair), each thread
// computing its own half of the butterflies.  The stages of pair distance 32
// to N/4 pair two registers of one lane; the five below pair lane l with lane
// l ^ h through __shfl_xor_sync.  Twiddles come from the staged table
// (init_staged_twiddles), where the lanes of a register stage read side by
// side.  The order is the tile passes' own: forward decimation in frequency
// (natural in, position p = l + 32 m + (N/2) w holds frequency
// bitrev_N(p)), inverse decimation in time (bit-reversed in, natural out,
// unscaled), so the spectrum stays bit-reversed in both axes and the
// propagator of prepare_propagator serves.  A transform of one warp (32
// values a lane at N = 1024) ran 1.3 to 1.8 times as long on the H100 at one
// wave; two warps a transform give one 512^2 wave eight busy warps an SM.
//
// A row item is one row a pair, loaded and stored straight from registers
// (256 contiguous bytes a warp instruction).  A column item is four adjacent
// columns of one wave's plane, a block of four pairs: the block loads the N
// x 4 panel with 16-byte accesses into shared memory, one padded column
// after the other (kColStride), behind one block barrier, and each pair
// transforms one column (y = l + 32 m + (N/2) w) in registers, the column's
// own place in the tile serving as the pair's exchange buffer.
// A block of kThreads threads (eight warps) holds kWidePairs transforms at once.
constexpr int kWidePairs = kThreads / 64;

template <int LOG2N>
struct Wide {
  static_assert(LOG2N >= 7 && LOG2N <= 10, "the wide transform takes 128 to 1024 points");
  static constexpr int N = 1 << LOG2N;
  static constexpr int H = N / 2;                  // elements a warp holds
  static constexpr int R = N / 64;                 // registers a lane
  static constexpr int kCols = kWidePairs;         // columns of a column item
  static constexpr int kColStride = N + 4;         // conflict-free 8-byte stores of the load
};

// A thread's place in its pair: lane, warp of the pair (0 lower, 1 upper),
// the pair's named barrier and its exchange buffer (N elements).
struct WidePlace {
  int lane;
  int w;
  int bar;
  float2* buf;
};

__device__ __forceinline__ WidePlace wide_place(float2* tile, int col_stride) {
  const int pair = threadIdx.x >> 6;
  return {static_cast<int>(threadIdx.x & 31), static_cast<int>((threadIdx.x >> 5) & 1), 1 + pair,
          tile + pair * col_stride};
}

__device__ __forceinline__ void pair_sync(int bar) {
  asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
}

// y = the other warp's x, element for element, through the pair's buffer.
template <int LOG2N>
__device__ __forceinline__ void wide_exchange(float2 (&y)[Wide<LOG2N>::R],
                                              const float2 (&x)[Wide<LOG2N>::R],
                                              const WidePlace& t) {
  using W = Wide<LOG2N>;
  pair_sync(t.bar);  // the buffer's last readers are done
#pragma unroll
  for (int m = 0; m < W::R; ++m) t.buf[W::H * t.w + t.lane + 32 * m] = x[m];
  pair_sync(t.bar);
#pragma unroll
  for (int m = 0; m < W::R; ++m) y[m] = t.buf[W::H * (1 - t.w) + t.lane + 32 * m];
}

// Forward N-point transform of x, natural in, bit-reversed out.
template <int LOG2N>
__device__ __forceinline__ void wide_fft_forward(float2 (&x)[Wide<LOG2N>::R], const float2* tw,
                                                 const WidePlace& t) {
  using W = Wide<LOG2N>;
  constexpr int R = W::R;
  const int lane = t.lane;
  {  // half size N/2: the two warps; lower a + b, upper (a - b) * w
    float2 y[R];
    wide_exchange<LOG2N>(y, x, t);
    const float sign = t.w ? -1.0f : 1.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float2 d = make_float2(fmaf(sign, x[m].x, y[m].x), fmaf(sign, x[m].y, y[m].y));
      x[m] = t.w ? cmul(d, tw[W::H - 1 + lane + 32 * m]) : d;
    }
  }
#pragma unroll
  for (int b = LOG2N - 2; b >= 5; --b) {  // half size 2^b: registers m, m + d
    const int d = 1 << (b - 5);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (m & d) continue;
      const float2 w = tw[(1 << b) - 1 + lane + 32 * (m & (d - 1))];
      const float2 a = x[m];
      const float2 c = x[m + d];
      x[m] = cadd(a, c);
      x[m + d] = cmul(csub(a, c), w);
    }
  }
#pragma unroll
  for (int b = 4; b >= 0; --b) {  // half size h = 2^b: lanes l, l ^ h
    const int h = 1 << b;
    const bool upper = lane & h;
    // lower: a + b; upper: (a - b) * w, a the partner's value
    const float2 w = upper ? tw[h - 1 + (lane & (h - 1))] : make_float2(1.0f, 0.0f);
    const float sign = upper ? -1.0f : 1.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float px = __shfl_xor_sync(0xffffffffu, x[m].x, h);
      const float py = __shfl_xor_sync(0xffffffffu, x[m].y, h);
      x[m] = cmul(make_float2(fmaf(sign, x[m].x, px), fmaf(sign, x[m].y, py)), w);
    }
  }
}

// Unscaled inverse of wide_fft_forward: bit-reversed in, natural out.
template <int LOG2N>
__device__ __forceinline__ void wide_fft_inverse(float2 (&x)[Wide<LOG2N>::R], const float2* tw,
                                                 const WidePlace& t) {
  using W = Wide<LOG2N>;
  constexpr int R = W::R;
  const int lane = t.lane;
#pragma unroll
  for (int b = 0; b <= 4; ++b) {  // half size h = 2^b: lanes l, l ^ h
    const int h = 1 << b;
    const bool upper = lane & h;
    // t = b * conj(w) formed on the upper lane before the exchange; then
    // lower: a + t, upper: a - t
    const float2 tv = tw[h - 1 + (lane & (h - 1))];
    const float2 w = upper ? make_float2(tv.x, -tv.y) : make_float2(1.0f, 0.0f);
    const float sign = upper ? -1.0f : 1.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float2 y = cmul(x[m], w);
      const float px = __shfl_xor_sync(0xffffffffu, y.x, h);
      const float py = __shfl_xor_sync(0xffffffffu, y.y, h);
      x[m] = make_float2(fmaf(sign, y.x, px), fmaf(sign, y.y, py));
    }
  }
#pragma unroll
  for (int b = 5; b < LOG2N - 1; ++b) {  // half size 2^b: registers m, m + d
    const int d = 1 << (b - 5);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (m & d) continue;
      const float2 w = tw[(1 << b) - 1 + lane + 32 * (m & (d - 1))];
      const float2 a = x[m];
      const float2 u = cmul_conj(x[m + d], w);
      x[m] = cadd(a, u);
      x[m + d] = csub(a, u);
    }
  }
  {  // half size N/2: the upper warp forms b * conj(w) before the exchange
    if (t.w) {
#pragma unroll
      for (int m = 0; m < R; ++m) x[m] = cmul_conj(x[m], tw[W::H - 1 + lane + 32 * m]);
    }
    float2 y[R];
    wide_exchange<LOG2N>(y, x, t);
    const float sign = t.w ? -1.0f : 1.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      x[m] = make_float2(fmaf(sign, x[m].x, y[m].x), fmaf(sign, x[m].y, y[m].y));
    }
  }
}

// One row (N elements at p) into / out of a pair's registers.
template <int LOG2N>
__device__ __forceinline__ void wide_load_row(float2 (&x)[Wide<LOG2N>::R], const float2* p,
                                              const WidePlace& t) {
#pragma unroll
  for (int m = 0; m < Wide<LOG2N>::R; ++m) x[m] = p[Wide<LOG2N>::H * t.w + t.lane + 32 * m];
}
template <int LOG2N>
__device__ __forceinline__ void wide_store_row(const float2 (&x)[Wide<LOG2N>::R], float2* p,
                                               const WidePlace& t) {
#pragma unroll
  for (int m = 0; m < Wide<LOG2N>::R; ++m) p[Wide<LOG2N>::H * t.w + t.lane + 32 * m] = x[m];
}

// One column item: columns c0 .. c0 + 3 of the plane (in place), forward y
// transform, times the propagator (bit-reversed, conjugated for the
// adjoint) over N^2, inverse y transform.  All threads of the block call
// it; tile holds kCols * kColStride elements, pair j's column at j *
// kColStride (t.buf).  p: this thread's values of P, element W::H * t.w +
// t.lane + 32 m of its column (wide_col_item loads them).
template <int LOG2N>
__device__ __forceinline__ void wide_col_item_of(float2* tile, const float2* tw, float2* plane,
                                                 int c0, const float2 (&p)[Wide<LOG2N>::R],
                                                 bool conj_p, const WidePlace& t) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  // thread i: row i / 2, columns 2 (i % 2) and 2 (i % 2) + 1 of the item
  for (int i = threadIdx.x; i < 2 * N; i += kThreads) {
    const int y = i >> 1;
    const int c = 2 * (i & 1);
    float2 a, b;
    load_pair(plane + static_cast<int64_t>(y) * N + c0 + c, &a, &b);
    tile[c * W::kColStride + y] = a;
    tile[(c + 1) * W::kColStride + y] = b;
  }
  __syncthreads();
  float2 x[W::R];
  wide_load_row<LOG2N>(x, t.buf, t);
  wide_fft_forward<LOG2N>(x, tw, t);
  const float scale = 1.0f / (static_cast<float>(N) * static_cast<float>(N));
  const float sign = conj_p ? -scale : scale;
#pragma unroll
  for (int m = 0; m < W::R; ++m) x[m] = cmul(x[m], make_float2(p[m].x * scale, p[m].y * sign));
  wide_fft_inverse<LOG2N>(x, tw, t);
  pair_sync(t.bar);  // the exchange's last reads are done
  wide_store_row<LOG2N>(x, t.buf, t);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * N; i += kThreads) {
    const int y = i >> 1;
    const int c = 2 * (i & 1);
    store_pair(plane + static_cast<int64_t>(y) * N + c0 + c, tile[c * W::kColStride + y],
               tile[(c + 1) * W::kColStride + y]);
  }
  __syncthreads();  // the next item reuses the tile
}

// wide_col_item_of with P read from prop (bit-reversed, N a row).
template <int LOG2N>
__device__ void wide_col_item(float2* tile, const float2* tw, float2* plane, int c0,
                              const float2* __restrict__ prop, bool conj_p, const WidePlace& t) {
  using W = Wide<LOG2N>;
  const int col = threadIdx.x >> 6;
  // this thread's values of P, in flight with the panel's loads: a load that
  // waits until after the forward transform costs a second round trip
  const float2* pc = prop + c0 + col;
  float2 p[W::R];
#pragma unroll
  for (int m = 0; m < W::R; ++m) {
    p[m] = __ldg(pc + static_cast<int64_t>(W::H * t.w + t.lane + 32 * m) * W::N);
  }
  wide_col_item_of<LOG2N>(tile, tw, plane, c0, p, conj_p, t);
}

// The row items of the wide kernels (adjoint_scan.cu's store pair, rows 9
// and 10; fused_step.cu's step and its adjoint, rows 6 and 7).  Item u of a
// row pass goes to block u % G, pair (u / G) % 4 of the G blocks, so that
// the rows of one wave spread over every block before any block takes a
// second row per pair.

// One row of a forward pass in a pair: src (the bit-reversed x spectrum
// when inverse, else natural psi) -> inverse x -> times t = exp(i sigma v),
// stored to s (STORE_S; the store forward) -> forward x -> dst.  v ==
// nullptr: the last row pass (natural order, into dst).  STORE_IN (the
// checkpointed forward): s != nullptr takes the row entering the slice
// instead, natural psi before the transmit.  With STORE_S a dst of nullptr
// ends the row after the s store (a recompute's last slice).
template <int LOG2N, bool STORE_S = true, bool STORE_IN = false>
__device__ __forceinline__ void wide_fwd_row(const float2* tw, const float2* src, float2* dst,
                                             float2* s, const float* __restrict__ v, float sigma,
                                             bool inverse, const WidePlace& t) {
  static_assert(!(STORE_S && STORE_IN), "a row stores s or its input, not both");
  using W = Wide<LOG2N>;
  float2 x[W::R];
  float vv[W::R];
  wide_load_row<LOG2N>(x, src, t);
  if (v != nullptr) {
    // in flight with the row: loaded beside sincosf (a branch each), one
    // load would wait for the other
#pragma unroll
    for (int m = 0; m < W::R; ++m) vv[m] = __ldg(v + W::H * t.w + t.lane + 32 * m);
  }
  if (inverse) wide_fft_inverse<LOG2N>(x, tw, t);
  if constexpr (STORE_IN) {
    if (s != nullptr) wide_store_row<LOG2N>(x, s, t);
  }
  if (v != nullptr) {
#pragma unroll
    for (int m = 0; m < W::R; ++m) x[m] = transmit(x[m], sigma * vv[m]);
    if constexpr (STORE_S) {
      wide_store_row<LOG2N>(x, s, t);
      if (dst == nullptr) return;
    }
    wide_fft_forward<LOG2N>(x, tw, t);
  }
  wide_store_row<LOG2N>(x, dst, t);
}

// One wave's row of a reverse pass in a pair: src (the bit-reversed x
// spectrum of bar) -> inverse x: bar_s; acc += Im(bar_s * conj(s)); times
// conj(t), t = exp(i sigma v) (vv: this thread's potentials of the row) ->
// forward x (forward), or natural (dpsi) -> dst.  Register m of the thread
// holds element (N/2) w + l + 32 m of the row throughout.  s points at the
// row of s = t psi (the store pair), or with FROM_PSI at psi's row, and s
// is formed here (the step's adjoint).
template <int LOG2N, bool FROM_PSI = false>
__device__ __forceinline__ void wide_bwd_row(const float2* tw, const float2* src, float2* dst,
                                             const float2* s, const float (&vv)[Wide<LOG2N>::R],
                                             float sigma, bool forward,
                                             float (&acc)[Wide<LOG2N>::R], const WidePlace& t) {
  using W = Wide<LOG2N>;
  float2 x[W::R];
  float2 u[W::R];  // s or psi, in flight with the row
  wide_load_row<LOG2N>(x, src, t);
  wide_load_row<LOG2N>(u, s, t);
  wide_fft_inverse<LOG2N>(x, tw, t);
#pragma unroll
  for (int m = 0; m < W::R; ++m) {
    if constexpr (FROM_PSI) {
      float sn, cs;
      sincosf(sigma * vv[m], &sn, &cs);
      const float2 tm = make_float2(cs, sn);
      u[m] = cmul(u[m], tm);
      acc[m] += x[m].y * u[m].x - x[m].x * u[m].y;
      x[m] = cmul_conj(x[m], tm);
    } else {
      acc[m] += x[m].y * u[m].x - x[m].x * u[m].y;
      float sn, cs;
      sincosf(sigma * vv[m], &sn, &cs);
      x[m] = cmul_conj(x[m], make_float2(cs, sn));
    }
  }
  if (forward) wide_fft_forward<LOG2N>(x, tw, t);
  wide_store_row<LOG2N>(x, dst, t);
}

// ---- the wide sweep --------------------------------------------------------
//
// The whole forward loop on the wide transform, shared by adjoint_scan.cu's
// store and segment kernels (rows 9, 11, 12's recompute) and fused_step.cu's
// wide_scan_kernel (row 8).

// The operands of a sweep: V (S, N, N) shared by the waves, the propagator
// bit-reversed, (N, N) or (B, N, N) with p_wave_stride = N*N.
struct SweepArgs {
  const float* v;       // (S, N, N)
  const float2* prop;   // bit-reversed, (N, N) or (B, N, N)
  int64_t p_wave_stride;
  int64_t nwaves;
  float sigma;
};

// The operands of wide_scan_kernel's sweep: V (B, S, N, N) with
// v_wave_stride = S*N*N elements from one wave's stack to the next (0:
// shared); pcols != nullptr when each block owns at most one column item,
// the same one every slice, and holds that item's kCols columns of P there
// (shared memory, column-major, N a column).
struct ScanSweepArgs : SweepArgs {
  int64_t v_wave_stride;
  const float2* pcols;
};

// A column item of wide_scan_kernel's sweep whose P is held (sw.pcols).
template <int LOG2N>
__device__ __forceinline__ void held_col_item(float2* tile, const float2* tw, const WidePlace& t,
                                              const ScanSweepArgs& sw, float2* plane, int c0) {
  using W = Wide<LOG2N>;
  const float2* pc = sw.pcols + (threadIdx.x >> 6) * W::N;
  float2 p[W::R];
#pragma unroll
  for (int m = 0; m < W::R; ++m) p[m] = pc[W::H * t.w + t.lane + 32 * m];
  wide_col_item_of<LOG2N>(tile, tw, plane, c0, p, false, t);
}

// The wide forward loop over nsl slices from v0, in place in work (B, N, N).
// in: the incoming waves, in_wave_stride elements apart.  keep (may be
// nullptr with neither flag): with STORE_S the s_k of every slice, at keep +
// b * keep_wave_stride + k * plane; with STORE_IN the wave entering every
// slice k with k % seg == 0, at keep + b * keep_wave_stride + (k / seg) *
// plane.  finish: run the last slice's column phase and the final inverse
// row phase, so work holds the exit wave in natural order; otherwise stop
// after the last slice's s is stored (STORE_S: a recompute needs no more),
// leaving work undefined.  Barriers: 2 per slice and none after the last row
// phase (2 * nsl when finish, 2 * (nsl - 1) otherwise).  Sweep: SweepArgs
// (the adjoint's kernels) or ScanSweepArgs (fused_step.cu's
// wide_scan_kernel: V per wave, P's columns held).
template <int LOG2N, bool STORE_S, bool STORE_IN, typename Sweep>
__device__ void wide_forward_sweep(cg::grid_group& grid, float2* tile, const float2* tw,
                                   const WidePlace& t, const Sweep& sw, const float2* in,
                                   int64_t in_wave_stride, float2* work, int v0, int nsl,
                                   float2* keep, int64_t keep_wave_stride, int seg, bool finish) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  const int64_t rows = sw.nwaves * N;
  const int64_t items = sw.nwaves * (N / W::kCols);
  const int64_t first = blockIdx.x + static_cast<int64_t>(threadIdx.x >> 6) * gridDim.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWidePairs;
  // the scan's additions behind `if constexpr`: the adjoint's instantiations keep their code
  constexpr bool kScan = std::is_same_v<Sweep, ScanSweepArgs>;
  const int last = finish ? nsl : nsl - 1;  // the last row phase
  for (int k = 0; k <= last; ++k) {
    const bool tail = k == nsl;  // the final inverse row phase
    for (int64_t u = first; u < rows; u += step) {  // u = b N + y
      const int64_t b = u >> LOG2N;
      const int64_t y = u & (N - 1);
      const float2* src = k == 0 ? in + b * in_wave_stride + y * N : work + u * N;
      float2* kept = nullptr;
      if (STORE_S && !tail) kept = keep + b * keep_wave_stride + k * kPlane + y * N;
      if (STORE_IN && !tail && k % seg == 0) {
        kept = keep + b * keep_wave_stride + (k / seg) * kPlane + y * N;
      }
      const float* v = tail ? nullptr : sw.v + (v0 + k) * kPlane + y * N;
      if constexpr (kScan) {
        if (!tail) v += b * sw.v_wave_stride;
      }
      float2* dst = finish || k < nsl - 1 ? work + u * N : nullptr;
      wide_fwd_row<LOG2N, STORE_S, STORE_IN>(tw, src, dst, kept, v, sw.sigma, k > 0, t);
    }
    if (k == last) break;
    grid.sync();
    for (int64_t i = blockIdx.x; i < items; i += gridDim.x) {
      const int64_t b = i / (N / W::kCols);
      const int c0 = static_cast<int>(i % (N / W::kCols)) * W::kCols;
      if constexpr (kScan) {
        if (sw.pcols != nullptr) {
          held_col_item<LOG2N>(tile, tw, t, sw, work + b * kPlane, c0);
          continue;
        }
      }
      wide_col_item<LOG2N>(tile, tw, work + b * kPlane, c0, sw.prop + b * sw.p_wave_stride,
                           false, t);
    }
    grid.sync();
  }
}

// dv = the sum of the ngroups partial planes at part, in the order 0, 1, ...
// (a reverse pass's wave groups, after the grid barrier that follows it).
template <int LOG2N>
__device__ void reduce_partials(const float* part, float* dv, int ngroups) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < kPlane / 4;
       i += stride) {
    float4 sum = reinterpret_cast<const float4*>(part)[i];
    for (int g = 1; g < ngroups; ++g) {
      const float4 p = reinterpret_cast<const float4*>(part + g * kPlane)[i];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    reinterpret_cast<float4*>(dv)[i] = sum;
  }
}

// Blocks of `kernel` (`threads` a block, `bytes` of dynamic shared memory;
// a cooperative kernel's defaults) that can be resident at once on this device.
inline int resident_blocks_of(const void* kernel, int device, int* blocks, int threads = kThreads,
                              size_t bytes = 0) {
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of `kernel` (kThreads a block, its one argument a)
// on min(resident blocks, nwaves * tiles_per_wave) blocks.  A launch the card
// refuses returns its error; nothing else runs in its place.
template <typename Args>
int launch_cooperative(const void* kernel, int device, Args a, int64_t nwaves,
                       int64_t tiles_per_wave, cudaStream_t stream) {
  int resident = 0;
  int err = resident_blocks_of(kernel, device, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  const int64_t ntiles = nwaves * tiles_per_wave;
  const int blocks = static_cast<int>(ntiles < resident ? ntiles : resident);
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0, stream);
}

}  // namespace

#define FDES_DISPATCH_N(n, call)                 \
  switch (n) {                                   \
    case 128: { constexpr int L = 7; return call; }   \
    case 256: { constexpr int L = 8; return call; }   \
    case 512: { constexpr int L = 9; return call; }   \
    case 1024: { constexpr int L = 10; return call; } \
    default: return cudaErrorInvalidValue;       \
  }

// The panel scan's sizes: 256^2 to 4096^2 (its own kernels; the macro above
// keeps refusing n > 1024 for the others).
#define FDES_DISPATCH_PANEL_N(n, call)           \
  switch (n) {                                   \
    case 256: { constexpr int L = 8; return call; }   \
    case 512: { constexpr int L = 9; return call; }   \
    case 1024: { constexpr int L = 10; return call; } \
    case 2048: { constexpr int L = 11; return call; } \
    case 4096: { constexpr int L = 12; return call; } \
    default: return cudaErrorInvalidValue;       \
  }

// The cluster scan's sizes: 128^2 to 512^2.
#define FDES_DISPATCH_CLUSTER_N(n, call)         \
  switch (n) {                                   \
    case 128: { constexpr int L = 7; return call; }   \
    case 256: { constexpr int L = 8; return call; }   \
    case 512: { constexpr int L = 9; return call; }   \
    default: return cudaErrorInvalidValue;       \
  }
