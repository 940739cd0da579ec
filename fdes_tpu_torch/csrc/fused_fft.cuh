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
// order.  fused_step.cu's head comment has the whole design.
//
// Everything here lives in an unnamed namespace: each library that includes
// the header compiles its own copy.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// a, b (elements 2i, 2i + 1) times exp(i sigma v), damped by exp(-sigma vi)
// when ABS; v and vi point at element 2i's potentials.
template <bool ABS>
__device__ __forceinline__ void transmit_pair(float2* a, float2* b, const float* __restrict__ v,
                                              const float* __restrict__ vi, float sigma) {
  const float2 vv = *reinterpret_cast<const float2*>(v);
  if constexpr (ABS) {
    const float2 ww = *reinterpret_cast<const float2*>(vi);
    *a = transmit(*a, sigma * vv.x, sigma * ww.x);
    *b = transmit(*b, sigma * vv.y, sigma * ww.y);
  } else {
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
template <int LOG2N, int K, bool ROWS, bool INVERSE, int TILE = kTile>
__device__ __forceinline__ void stage_group(float2* tile, const float2* tw, int lg) {
  constexpr int N = 1 << LOG2N;
  constexpr int Q = TILE / N;
  constexpr int R = 1 << K;
  constexpr int kItems = TILE >> K;
  constexpr int kItemsPerTransform = N >> K;
  const int g = 1 << lg;
  for (int u = threadIdx.x; u < kItems; u += kThreads) {
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
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int ld = INVERSE ? s : K - 1 - s;  // log2 of the pair distance in registers
      const int d = 1 << ld;
      const int tshift = LOG2N - 1 - lg - ld;  // twiddle index step N / (2 * hs)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j & d) continue;
        const int jj = r + (j & (d - 1)) * g;
        const float2 wv = tw[jj << tshift];
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
#pragma unroll
    for (int j = 0; j < R; ++j) tile[at[j]] = x[j];
  }
}

// Forward transforms of the tile: natural order in, bit-reversed order out.
template <int LOG2N, bool ROWS, int TILE = kTile>
__device__ void fft_forward(float2* tile, const float2* tw) {
  int lg = LOG2N;
  while (lg >= 3) {
    lg -= 3;
    stage_group<LOG2N, 3, ROWS, false, TILE>(tile, tw, lg);
    __syncthreads();
  }
  if (lg == 2) {
    stage_group<LOG2N, 2, ROWS, false, TILE>(tile, tw, 0);
    __syncthreads();
  } else if (lg == 1) {
    stage_group<LOG2N, 1, ROWS, false, TILE>(tile, tw, 0);
    __syncthreads();
  }
}

// Unscaled inverse transforms: bit-reversed order in, natural order out; the
// forward stages undone last to first, so inverse(forward(x)) = N * x.
template <int LOG2N, bool ROWS, int TILE = kTile>
__device__ void fft_inverse(float2* tile, const float2* tw) {
  constexpr int kRem = LOG2N % 3;
  int lg = 0;
  if (kRem == 2) {
    stage_group<LOG2N, 2, ROWS, true, TILE>(tile, tw, 0);
    __syncthreads();
    lg = 2;
  } else if (kRem == 1) {
    stage_group<LOG2N, 1, ROWS, true, TILE>(tile, tw, 0);
    __syncthreads();
    lg = 1;
  }
  while (lg < LOG2N) {
    stage_group<LOG2N, 3, ROWS, true, TILE>(tile, tw, lg);
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
// potentials), damped by exp(-sigma*vi) when ABS (an absorptive potential v +
// i vi, vi at the tile's imaginary parts).  forward: transform along x.  src
// may have been written by other blocks before the last barrier, so it is
// read with plain loads.
//
// STORES (the forward pass under differentiation): the tile is in natural
// order between the inverse and the forward x transform, and only there;
// pre != nullptr receives it before the transmit (a checkpoint of psi_j),
// post != nullptr after it (s_j = t_j * psi_j), and dst == nullptr skips the
// final store.
template <int LOG2N, bool STORES = false, bool ABS = false>
__device__ void row_tile(float2* tile, const float2* tw, const float2* src, float2* dst,
                         const float* __restrict__ v, float sigma, bool inverse, bool forward,
                         float2* pre = nullptr, float2* post = nullptr,
                         const float* __restrict__ vi = nullptr) {
  const bool transmit_on_load = v != nullptr && !inverse;
  for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
    float2 a, b;
    load_pair(src + 2 * i, &a, &b);
    if (STORES && !inverse && pre != nullptr) store_pair(pre + 2 * i, a, b);
    if (transmit_on_load) transmit_pair<ABS>(&a, &b, v + 2 * i, vi + 2 * i, sigma);
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
          transmit_pair<ABS>(&a, &b, v + 2 * i, vi + 2 * i, sigma);
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

// Blocks of a cooperative kernel (kThreads threads, static shared memory only)
// that can be resident at once on this device.
inline int resident_blocks_of(const void* kernel, int device, int* blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
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
