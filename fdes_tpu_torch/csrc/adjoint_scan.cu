// The whole-loop adjoint of the multislice scan, for Hopper (sm_90a): eight
// cooperative kernels that compute their own 2-D FFT (no cuFFT), and one
// that times grid barriers alone (grid_barrier_kernel, on no path).  Four
// are built from the row and column tile passes of fused_fft.cuh:
//
//   scan_store_kernel     the forward loop of fused_step.cu's scan_kernel that
//                         also stores s_j = t_j * psi_j of every slice
//                         (replaces fdes_tpu/pallas/adjoint_scan.py::_sfwd_kernel);
//   scan_bwd_store_kernel the reverse loop over the stored s_j: dV and dpsi0
//                         (replaces ::_bwd_store_kernel);
//   scan_ck_kernel        the forward loop that also stores the incoming psi at
//                         the start of every K-slice segment (replaces ::_ck_kernel);
//   scan_bwd_ck_kernel    per segment, last to first: recompute the segment's
//                         s_k from its checkpoint, then the reverse loop over
//                         them (replaces ::_bwd_scan_kernel).
//
// Four compute the same functions again on the wide transform of
// fused_fft.cuh (one 1-D transform a pair of warps), so that one wave fills
// the card; two sweeps (wide_forward_sweep, in fused_fft.cuh beside
// fused_step.cu's wide_scan_kernel, which runs it without a store, and
// wide_reverse_sweep) carry the loops of all four:
//
//   wide_scan_store_kernel     scan_store_kernel's function (also replaces
//                              ::_sfwd_kernel);
//   wide_scan_bwd_store_kernel scan_bwd_store_kernel's (also replaces
//                              ::_bwd_store_kernel);
//   wide_scan_ck_kernel        scan_ck_kernel's (also replaces ::_ck_kernel);
//   wide_scan_bwd_ck_kernel    scan_bwd_ck_kernel's (also replaces
//                              ::_bwd_scan_kernel); its carry stays in the row
//                              phases' order across segment boundaries, where
//                              the tile kernel takes it back to natural order
//                              and out again (one row pass and one barrier more
//                              a segment).
//
// kernels/adjoint_scan.STORE_ROUTE and SEG_ROUTE pick "tile" or "wide" for
// each kernel of a pair by (n, waves) from H100 rows, before the launch.  What
// held the tile kernels back at config 3's one wave of 512^2, and what the
// wide kernels do about it:
//  1. Half the card idle: a 4,096-element tile a block of 256 threads gives
//     64 blocks a 512^2 wave.  Here a row item is one row a pair of warps
//     and a column item four columns a block of four pairs: one wave is 512
//     row pairs and 128 column items, spread over min(resident, B N / 4)
//     blocks (128 at 512^2, one an SM, as the card places them; row u goes
//     to block u % G first), so ~8 warps of every SM work in each pass.
//  2. Block barriers inside each transform (three radix-2 stages between
//     two __syncthreads): a wide transform has none.  Its stages run in
//     registers (pair distance 32 to N/4), through __shfl_xor_sync (below
//     32) and, for the first forward and last inverse stage, through the
//     pair's shared buffer between two 64-thread named barriers.  The row
//     pass fuses inverse x, transmit, the s store and forward x in
//     registers, and s, dV and the rows go to memory as 256 contiguous bytes
//     a warp instruction straight from registers; V, P and s are loaded
//     with the row or panel they meet (loaded beside sincosf, one load
//     waited for the other).  A column item has three block barriers (load,
//     store, reuse) around four pair transforms.
//  3. Bank conflicts of the plain twiddle table at power-of-two strides: the
//     staged table (init_staged_twiddles), read side by side by the lanes.
//  4. Two grid barriers a slice stay (the plane crosses the grid once each
//     way); grid_barrier_kernel times them alone at the same grid size.
// The spectral order is the tile kernels' own (bit-reversed in both axes),
// so prepare_propagator's P serves both routes.
//
// The adjoint, in PyTorch's convention (g = dL/dRe + i dL/dIm of the exit
// wave), per slice j = S-1 .. 0 with bar = g at the start:
//
//   bar_s  = IFFT2[ conj(P) * FFT2[ bar ] ]
//   dV_j   = sigma * Im( bar_s * conj(s_j) )      summed over the B waves
//   bar    = bar_s * conj(t_j),  t_j = exp(i*sigma*V_j)
//   dpsi0  = bar after slice 0
//
// As in the forward scan a slice costs two tile passes and two grid barriers:
// a row pass [inverse x of slice j+1 | dV_{j+1}, * conj(t_{j+1}) | forward x],
// a column pass [forward y | * conj(P)/N^2 | inverse y]; one last row pass
// [inverse x | dV_0, * conj(t_0)] leaves dpsi0.  The carry lives in the dpsi0
// output (in L2 for a few waves).
//
// The TPU kernels walk a (slice, wave) grid in order and carry the wave and
// the dV sum in VMEM scratch; here blocks run in no order, so
//  * the forward passes walk over (wave, tile) pairs, as scan_kernel does;
//  * the backward row passes walk over (wave group, tile) pairs: one block
//    carries a row tile through the waves of its group and sums their dV in
//    registers.  With one group (few tiles to spare) the sum goes straight to
//    dV; with G > 1 groups each writes a partial plane, and after the next
//    barrier the blocks add the G partials in a fixed order.  No atomics: two
//    runs give the same bits.  Every tile of every dV_j is written exactly once.
//  * every block runs every grid barrier (the loops' bounds are kernel
//    arguments, equal for all blocks); K must divide S.
//
// Bounds (H100 SXM: 3.35 TB/s, 67 TFLOP/s FP32): beside the forward scan's
// work, the store variant writes, and its backward reads, 8 bytes per wave,
// pixel and slice; at 512^2 that is 2 MiB = 0.63 us per wave-slice against
// 0.75 us of operations, so the store pair sits where bytes and operations
// meet; the segment pair moves 1/K of that and recomputes every slice once.
// At config 3's shape (1 wave x 64 slices x 512^2) the bound is the bytes:
// 62.0 us for the store forward, 82.0 us for its backward, on either route.
// Times on the card: chip_smoke.py (group kernels_adjoint), quoted in PERF.md.
//
// Layout and conventions as fused_step.cu: interleaved complex64, C-contiguous,
// 16-byte aligned, N in {128, 256, 512, 1024}; the propagator bit-reversed,
// shared (p_wave_stride 0) or one per wave; V (S, N, N) float32 shared by the
// waves.  Every entry point launches on the caller's stream, allocates nothing
// (the wrapper hands in the scratch buffers), does not synchronise, and returns
// the cooperative launch's status.

#include "fused_fft.cuh"

namespace {

// The forward loop over nsl slices from v, in place in work (B, N, N).  in:
// the incoming waves, in_wave_stride elements apart.  s != nullptr: s_k of
// every slice goes to s + b * s_wave_stride + k * plane.  ck != nullptr: the
// incoming psi of every slice k with k % seg == 0 goes to
// ck + b * ck_wave_stride + (k / seg) * plane.  finish: run the last slice's
// column pass and the final inverse row pass, so work holds the exit wave;
// otherwise stop after the last slice's s is stored (a recompute needs no
// more), leaving work undefined.  Barriers: 2 per slice and none after the
// last row pass (2 * nsl when finish, 2 * (nsl - 1) otherwise).
template <int LOG2N>
__device__ void forward_sweep(cg::grid_group& grid, float2* tile, const float2* tw,
                              const SweepArgs& a, const float2* in, int64_t in_wave_stride,
                              float2* work, int v0, int nsl, float2* s, int64_t s_wave_stride,
                              float2* ck, int64_t ck_wave_stride, int seg, bool finish) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kTilesPerWave = kPlane / kTile;
  constexpr int C = kTile >> LOG2N;
  const int64_t ntiles = a.nwaves * kTilesPerWave;
  const int last = finish ? nsl : nsl - 1;  // the last row pass
  for (int k = 0; k <= last; ++k) {
    const bool transform = k < nsl && (finish || k < nsl - 1);
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int64_t b = t / kTilesPerWave;
      const int64_t r = t % kTilesPerWave;
      const float2* src = k == 0 ? in + b * in_wave_stride + r * kTile : work + t * kTile;
      const float* vt = k < nsl ? a.v + (v0 + k) * kPlane + r * kTile : nullptr;
      float2* post = s != nullptr && k < nsl ? s + b * s_wave_stride + k * kPlane + r * kTile
                                             : nullptr;
      float2* pre = ck != nullptr && k < nsl && k % seg == 0
                        ? ck + b * ck_wave_stride + (k / seg) * kPlane + r * kTile
                        : nullptr;
      float2* dst = transform || k == nsl ? work + t * kTile : nullptr;
      row_tile<LOG2N, true>(tile, tw, src, dst, vt, a.sigma, k > 0, transform, pre, post);
    }
    if (k == last) break;
    grid.sync();
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int64_t b = t / kTilesPerWave;
      const int c0 = static_cast<int>(t % kTilesPerWave) * C;
      float2* plane = work + b * kPlane;
      col_tile<LOG2N>(tile, tw, plane, plane, c0, a.prop + b * a.p_wave_stride, false);
    }
    grid.sync();
  }
}

struct GroupArgs {
  float* part;      // (ngroups, N, N) partial dV planes; unused when ngroups == 1
  int ngroups;      // wave groups of the backward row passes
  int per_group;    // waves per group (the last group may hold fewer)
};

// The reverse loop over the nsl slices from v0, last to first.  first: the
// incoming gradient in natural order (g, or bar itself); bar (B, N, N): the
// carry, on return the gradient of the wave entering slice v0 in natural
// order.  s: the stored s_k as in forward_sweep.  dV of slice v0 + k goes to
// dv + (v0 + k) * plane.  Barriers: 1 + 2 * nsl, the last one after the last
// row pass; the partials of slice v0 are reduced after it.
template <int LOG2N>
__device__ void reverse_sweep(cg::grid_group& grid, float2* tile, const float2* tw,
                              const SweepArgs& a, const GroupArgs& ga, const float2* first,
                              float2* bar, int v0, int nsl, const float2* s,
                              int64_t s_wave_stride, float* dv) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kTilesPerWave = kPlane / kTile;
  constexpr int C = kTile >> LOG2N;
  const int64_t ntiles = a.nwaves * kTilesPerWave;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    row_tile<LOG2N>(tile, tw, first + t * kTile, bar + t * kTile, nullptr, a.sigma, false, true);
  }
  grid.sync();
  const bool partial = ga.ngroups > 1;
  for (int k = nsl - 1; k >= 0; --k) {
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int64_t b = t / kTilesPerWave;
      const int c0 = static_cast<int>(t % kTilesPerWave) * C;
      float2* plane = bar + b * kPlane;
      col_tile<LOG2N>(tile, tw, plane, plane, c0, a.prop + b * a.p_wave_stride, true);
    }
    if (partial && k < nsl - 1) {
      reduce_partials<LOG2N>(ga.part, dv + (v0 + k + 1) * kPlane, ga.ngroups);
    }
    grid.sync();
    const float* vk = a.v + (v0 + k) * kPlane;
    float* out = partial ? ga.part : dv + (v0 + k) * kPlane;
    for (int64_t u = blockIdx.x; u < ga.ngroups * kTilesPerWave; u += gridDim.x) {
      const int64_t gi = u / kTilesPerWave;
      const int64_t r = u % kTilesPerWave;
      const int64_t b0 = gi * ga.per_group;
      const int64_t b1 = b0 + ga.per_group < a.nwaves ? b0 + ga.per_group : a.nwaves;
      float2 acc[kPairsPerThread];
#pragma unroll
      for (int m = 0; m < kPairsPerThread; ++m) acc[m] = make_float2(0.0f, 0.0f);
      for (int64_t b = b0; b < b1; ++b) {
        float2* tb = bar + (b * kTilesPerWave + r) * kTile;
        bwd_row_tile<LOG2N>(tile, tw, tb, tb, s + b * s_wave_stride + k * kPlane + r * kTile,
                            vk + r * kTile, a.sigma, k > 0, acc);
      }
      float* o = out + (partial ? gi * kPlane : 0) + r * kTile;
#pragma unroll
      for (int m = 0; m < kPairsPerThread; ++m) {
        const int i = threadIdx.x + m * kThreads;
        *reinterpret_cast<float2*>(o + 2 * i) =
            make_float2(a.sigma * acc[m].x, a.sigma * acc[m].y);
      }
    }
    grid.sync();
  }
  if (partial) reduce_partials<LOG2N>(ga.part, dv + v0 * kPlane, ga.ngroups);
}

struct FwdArgs {
  SweepArgs sweep;
  const float2* psi0;  // (B, N, N)
  float2* out;         // (B, N, N): the carried wave, then the exit wave
  float2* keep;        // s (B, S, N, N), or the checkpoints (B, S / seg, N, N)
  int nslices;
  int seg;             // checkpoint spacing (scan_ck_kernel)
};

template <int LOG2N>
__global__ void __launch_bounds__(kThreads) scan_store_kernel(FwdArgs a) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  cg::grid_group grid = cg::this_grid();
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  forward_sweep<LOG2N>(grid, tile, tw, a.sweep, a.psi0, kPlane, a.out, 0, a.nslices, a.keep,
                       a.nslices * kPlane, nullptr, 0, 1, true);
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads) scan_ck_kernel(FwdArgs a) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  cg::grid_group grid = cg::this_grid();
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  forward_sweep<LOG2N>(grid, tile, tw, a.sweep, a.psi0, kPlane, a.out, 0, a.nslices, nullptr, 0,
                       a.keep, (a.nslices / a.seg) * kPlane, a.seg, true);
}

struct BwdArgs {
  SweepArgs sweep;
  GroupArgs groups;
  const float2* keep;  // s (B, S, N, N), or the checkpoints (B, S / seg, N, N)
  const float2* g;     // (B, N, N)
  float2* dpsi;        // (B, N, N): the carry, then dpsi0
  float* dv;           // (S, N, N)
  float2* work;        // scan_bwd_ck_kernel: (B, N, N), the recomputed wave
  float2* sbuf;        // scan_bwd_ck_kernel: (B, seg, N, N), the recomputed s_k
  int nslices;
  int seg;
};

template <int LOG2N>
__global__ void __launch_bounds__(kThreads) scan_bwd_store_kernel(BwdArgs a) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  cg::grid_group grid = cg::this_grid();
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  reverse_sweep<LOG2N>(grid, tile, tw, a.sweep, a.groups, a.g, a.dpsi, 0, a.nslices, a.keep,
                       a.nslices * kPlane, a.dv);
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads) scan_bwd_ck_kernel(BwdArgs a) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  cg::grid_group grid = cg::this_grid();
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  const int nseg = a.nslices / a.seg;
  for (int i = nseg - 1; i >= 0; --i) {
    // the segment's s_k again, from the wave that entered it
    forward_sweep<LOG2N>(grid, tile, tw, a.sweep, a.keep + i * kPlane, nseg * kPlane, a.work,
                         i * a.seg, a.seg, a.sbuf, a.seg * kPlane, nullptr, 0, 1, false);
    grid.sync();
    reverse_sweep<LOG2N>(grid, tile, tw, a.sweep, a.groups, i == nseg - 1 ? a.g : a.dpsi, a.dpsi,
                         i * a.seg, a.seg, a.sbuf, a.seg * kPlane, a.dv);
  }
}

// ---- the wide kernels: rows 9 to 12 redesigned -----------------------------
//
// Row items are one row a pair of warps, column items four columns a block
// (fused_fft.cuh, "the wide transform"); the row functions wide_fwd_row and
// wide_bwd_row are fused_fft.cuh's, shared with fused_step.cu's step kernels.
// wide_forward_sweep (fused_fft.cuh) and wide_reverse_sweep below are the
// wide counterparts of forward_sweep and reverse_sweep; the four kernels are
// thin callers of them.

// bar = forward x of g, row by row (natural in, each row's bit-reversed x
// spectrum out): the carry's order inside the wide reverse loop.
template <int LOG2N>
__device__ void wide_seed_rows(const float2* tw, const WidePlace& t, const float2* g, float2* bar,
                               int64_t nwaves) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  const int64_t rows = nwaves * N;
  const int64_t first = blockIdx.x + static_cast<int64_t>(threadIdx.x >> 6) * gridDim.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWidePairs;
  for (int64_t u = first; u < rows; u += step) {
    float2 x[W::R];
    wide_load_row<LOG2N>(x, g + u * N, t);
    wide_fft_forward<LOG2N>(x, tw, t);
    wide_store_row<LOG2N>(x, bar + u * N, t);
  }
}

// The wide reverse loop over the nsl slices from v0, last to first, on the
// carry bar (B, N, N), which enters and leaves in the row phases' order
// (each row's x spectrum, bit-reversed), or leaves in natural order when v0
// == 0 (dpsi0): no pass of its own at a segment boundary.  A pair carries
// one row through the waves of its wave group and sums their dV in
// registers; with G > 1 groups each writes a partial plane, added in the
// order 0, 1, ... after the next barrier (reverse_sweep's rule), those of
// slice v0 after the last barrier.  s_k of slice v0 + k at s + b *
// s_wave_stride + k * plane; dV of slice v0 + k at dv + (v0 + k) * plane.
// Barriers: 2 * nsl, the last after the last row phase.
template <int LOG2N>
__device__ void wide_reverse_sweep(cg::grid_group& grid, float2* tile, const float2* tw,
                                   const WidePlace& t, const SweepArgs& sw, const GroupArgs& ga,
                                   float2* bar, int v0, int nsl, const float2* s,
                                   int64_t s_wave_stride, float* dv) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  const int64_t items = sw.nwaves * (N / W::kCols);
  const int64_t first = blockIdx.x + static_cast<int64_t>(threadIdx.x >> 6) * gridDim.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWidePairs;
  const bool partial = ga.ngroups > 1;
  const int64_t group_rows = static_cast<int64_t>(ga.ngroups) * N;
  for (int k = nsl - 1; k >= 0; --k) {
    for (int64_t i = blockIdx.x; i < items; i += gridDim.x) {
      const int64_t b = i / (N / W::kCols);
      const int c0 = static_cast<int>(i % (N / W::kCols)) * W::kCols;
      wide_col_item<LOG2N>(tile, tw, bar + b * kPlane, c0, sw.prop + b * sw.p_wave_stride, true,
                           t);
    }
    if (partial && k < nsl - 1) {
      reduce_partials<LOG2N>(ga.part, dv + (v0 + k + 1) * kPlane, ga.ngroups);
    }
    grid.sync();
    const float* vk = sw.v + (v0 + k) * kPlane;
    float* out = partial ? ga.part : dv + (v0 + k) * kPlane;
    for (int64_t u = first; u < group_rows; u += step) {  // u = group N + y
      const int64_t gi = u >> LOG2N;
      const int64_t y = u & (N - 1);
      const int64_t b0 = gi * ga.per_group;
      const int64_t b1 = b0 + ga.per_group < sw.nwaves ? b0 + ga.per_group : sw.nwaves;
      float acc[W::R];
      float vv[W::R];  // the row's potentials, loaded once for the group's waves
#pragma unroll
      for (int m = 0; m < W::R; ++m) {
        acc[m] = 0.0f;
        vv[m] = __ldg(vk + y * N + W::H * t.w + t.lane + 32 * m);
      }
      for (int64_t b = b0; b < b1; ++b) {
        float2* row = bar + (b * N + y) * N;
        wide_bwd_row<LOG2N>(tw, row, row, s + b * s_wave_stride + k * kPlane + y * N, vv,
                            sw.sigma, v0 + k > 0, acc, t);
      }
      float* o = out + (partial ? gi * kPlane : 0) + y * N;
#pragma unroll
      for (int m = 0; m < W::R; ++m) o[W::H * t.w + t.lane + 32 * m] = sw.sigma * acc[m];
    }
    grid.sync();
  }
  if (partial) reduce_partials<LOG2N>(ga.part, dv + v0 * kPlane, ga.ngroups);
}

// The store forward (row 9): scan_store_kernel's function, S slices of two
// passes and two grid barriers, then the last inverse row pass.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_scan_store_kernel(FwdArgs a) {
  using W = Wide<LOG2N>;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[W::N];  // the staged table: N - 1 entries
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  wide_forward_sweep<LOG2N, true, false>(grid, tile, tw, t, a.sweep, a.psi0, kPlane, a.out, 0,
                                         a.nslices, a.keep, a.nslices * kPlane, 1, true);
}

// The reverse loop over the stored s (row 10): scan_bwd_store_kernel's
// function: the forward x of g, a barrier, the reverse loop over all S.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_scan_bwd_store_kernel(BwdArgs a) {
  using W = Wide<LOG2N>;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[W::N];
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  wide_seed_rows<LOG2N>(tw, t, a.g, a.dpsi, a.sweep.nwaves);
  grid.sync();
  wide_reverse_sweep<LOG2N>(grid, tile, tw, t, a.sweep, a.groups, a.dpsi, 0, a.nslices, a.keep,
                            a.nslices * kPlane, a.dv);
}

// The checkpointed forward (row 11): scan_ck_kernel's function, the store
// forward's loop keeping the wave entering every seg-th slice instead of s.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_scan_ck_kernel(FwdArgs a) {
  using W = Wide<LOG2N>;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[W::N];
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  wide_forward_sweep<LOG2N, false, true>(grid, tile, tw, t, a.sweep, a.psi0, kPlane, a.out, 0,
                                         a.nslices, a.keep, (a.nslices / a.seg) * kPlane, a.seg,
                                         true);
}

// The reverse loop over the checkpoints (row 12): scan_bwd_ck_kernel's
// function.  Per segment i, last to first: its s_k recomputed from ck[:, i]
// into sbuf (the forward x of g shares the last segment's first row phase:
// they touch no common plane), a barrier, then the reverse loop over the
// segment.  The carry stays in dpsi in the row phases' order across the
// segment boundaries; slice 0's last row phase leaves it natural.  Barriers
// per segment: 2 seg - 1 + 2 seg.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_scan_bwd_ck_kernel(BwdArgs a) {
  using W = Wide<LOG2N>;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[W::N];
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  wide_seed_rows<LOG2N>(tw, t, a.g, a.dpsi, a.sweep.nwaves);
  const int nseg = a.nslices / a.seg;
  for (int i = nseg - 1; i >= 0; --i) {
    wide_forward_sweep<LOG2N, true, false>(grid, tile, tw, t, a.sweep, a.keep + i * kPlane,
                                           nseg * kPlane, a.work, i * a.seg, a.seg, a.sbuf,
                                           a.seg * kPlane, 1, false);
    grid.sync();
    wide_reverse_sweep<LOG2N>(grid, tile, tw, t, a.sweep, a.groups, a.dpsi, i * a.seg, a.seg,
                              a.sbuf, a.seg * kPlane, a.dv);
  }
}

// The grid barriers alone, for measurements (on no path): `rounds` barriers
// over the grid, by cg::grid_group::sync, or (light) by an arrive counter
// (one word of device memory the caller zeroes: a release add per block)
// and an acquire spin until it reaches the round's count.
__global__ void __launch_bounds__(kThreads) grid_barrier_kernel(unsigned int* counter,
                                                                    int rounds, int light) {
  if (!light) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < rounds; ++i) grid.sync();
    return;
  }
  unsigned int target = 0;
  for (int i = 0; i < rounds; ++i) {
    target += gridDim.x;
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
      unsigned int seen = 0;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      } while (seen < target);
    }
    __syncthreads();
  }
}

template <int LOG2N>
int launch_fwd(int device, FwdArgs a, bool checkpoints, cudaStream_t stream) {
  const void* kernel = checkpoints ? reinterpret_cast<const void*>(scan_ck_kernel<LOG2N>)
                                   : reinterpret_cast<const void*>(scan_store_kernel<LOG2N>);
  return launch_cooperative(kernel, device, a, a.sweep.nwaves,
                            (int64_t{1} << (2 * LOG2N)) / kTile, stream);
}

template <int LOG2N>
int launch_bwd(int device, BwdArgs a, bool checkpoints, cudaStream_t stream) {
  const void* kernel = checkpoints ? reinterpret_cast<const void*>(scan_bwd_ck_kernel<LOG2N>)
                                   : reinterpret_cast<const void*>(scan_bwd_store_kernel<LOG2N>);
  return launch_cooperative(kernel, device, a, a.sweep.nwaves,
                            (int64_t{1} << (2 * LOG2N)) / kTile, stream);
}

// A wide kernel over B waves: every resident block, at most one a column
// item (B N / 4: the row items then take four a block).
template <int LOG2N>
int launch_wide_fwd(int device, FwdArgs a, bool checkpoints, cudaStream_t stream) {
  const void* kernel = checkpoints
                           ? reinterpret_cast<const void*>(wide_scan_ck_kernel<LOG2N>)
                           : reinterpret_cast<const void*>(wide_scan_store_kernel<LOG2N>);
  return launch_cooperative(kernel, device, a, a.sweep.nwaves, (1 << LOG2N) / kWidePairs, stream);
}

template <int LOG2N>
int launch_wide_bwd(int device, BwdArgs a, bool checkpoints, cudaStream_t stream) {
  const void* kernel = checkpoints
                           ? reinterpret_cast<const void*>(wide_scan_bwd_ck_kernel<LOG2N>)
                           : reinterpret_cast<const void*>(wide_scan_bwd_store_kernel<LOG2N>);
  return launch_cooperative(kernel, device, a, a.sweep.nwaves, (1 << LOG2N) / kWidePairs, stream);
}

// out[0..3] = registers per thread, static shared bytes, local bytes per
// thread and resident blocks of kernel `which` (0 store, 1 backward over the
// store, 2 checkpoints, 3 backward over the checkpoints, 4 and 5 the wide
// kernels of the store pair, 6 and 7 those of the segment pair).
template <int LOG2N>
int kernel_info(int device, int which, int* out) {
  const void* kernels[] = {reinterpret_cast<const void*>(scan_store_kernel<LOG2N>),
                           reinterpret_cast<const void*>(scan_bwd_store_kernel<LOG2N>),
                           reinterpret_cast<const void*>(scan_ck_kernel<LOG2N>),
                           reinterpret_cast<const void*>(scan_bwd_ck_kernel<LOG2N>),
                           reinterpret_cast<const void*>(wide_scan_store_kernel<LOG2N>),
                           reinterpret_cast<const void*>(wide_scan_bwd_store_kernel<LOG2N>),
                           reinterpret_cast<const void*>(wide_scan_ck_kernel<LOG2N>),
                           reinterpret_cast<const void*>(wide_scan_bwd_ck_kernel<LOG2N>)};
  if (which < 0 || which > 7) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return resident_blocks_of(kernels[which], device, &out[3]);
}

SweepArgs sweep_args(const void* v, const void* prop, int64_t p_wave_stride, int64_t nwaves,
                     double sigma) {
  SweepArgs s;
  s.v = static_cast<const float*>(v);
  s.prop = static_cast<const float2*>(prop);
  s.p_wave_stride = p_wave_stride;
  s.nwaves = nwaves;
  s.sigma = static_cast<float>(sigma);
  return s;
}

}  // namespace

extern "C" {

const char* fdes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward loop under differentiation: psi0 (nwaves, n, n) -> out, and keep
// = s (nwaves, nslices, n, n) when seg == 0, or the checkpoints (nwaves,
// nslices / seg, n, n) of the waves entering slices 0, seg, 2 seg, ...
int fdes_scan_fwd_keep_c64(int device, int n, const void* psi0, const void* v, const void* prop,
                           void* out, void* keep, double sigma, int64_t nwaves, int nslices,
                           int seg, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || seg < 0 || (seg > 0 && nslices % seg != 0)) return cudaErrorInvalidValue;
  FwdArgs a;
  a.sweep = sweep_args(v, prop, p_wave_stride, nwaves, sigma);
  a.psi0 = static_cast<const float2*>(psi0);
  a.out = static_cast<float2*>(out);
  a.keep = static_cast<float2*>(keep);
  a.nslices = nslices;
  a.seg = seg > 0 ? seg : 1;
  FDES_DISPATCH_N(n, launch_fwd<L>(device, a, seg > 0, static_cast<cudaStream_t>(stream)))
}

// The reverse loop: g (nwaves, n, n) -> dpsi (nwaves, n, n) and dv (nslices,
// n, n) summed over the waves, from keep as fdes_scan_fwd_keep_c64 left it.
// part: (ngroups, n, n) float32 scratch when ngroups > 1; work (nwaves, n, n)
// and sbuf (nwaves, seg, n, n) complex64 scratch when seg > 0.
int fdes_scan_bwd_c64(int device, int n, const void* keep, const void* v, const void* prop,
                      const void* g, void* dpsi, void* dv, void* part, void* work, void* sbuf,
                      double sigma, int64_t nwaves, int nslices, int seg, int ngroups,
                      int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || seg < 0 || (seg > 0 && nslices % seg != 0) || ngroups < 1 ||
      ngroups > nwaves) {
    return cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.sweep = sweep_args(v, prop, p_wave_stride, nwaves, sigma);
  a.groups.part = static_cast<float*>(part);
  a.groups.per_group = static_cast<int>((nwaves + ngroups - 1) / ngroups);
  a.groups.ngroups = static_cast<int>((nwaves + a.groups.per_group - 1) / a.groups.per_group);
  a.keep = static_cast<const float2*>(keep);
  a.g = static_cast<const float2*>(g);
  a.dpsi = static_cast<float2*>(dpsi);
  a.dv = static_cast<float*>(dv);
  a.work = static_cast<float2*>(work);
  a.sbuf = static_cast<float2*>(sbuf);
  a.nslices = nslices;
  a.seg = seg > 0 ? seg : 1;
  FDES_DISPATCH_N(n, launch_bwd<L>(device, a, seg > 0, static_cast<cudaStream_t>(stream)))
}

// The store pair on the wide kernels: the forward as fdes_scan_fwd_keep_c64
// with seg 0 (keep = s), the backward as fdes_scan_bwd_c64 with seg 0.
int fdes_wide_scan_store_c64(int device, int n, const void* psi0, const void* v, const void* prop,
                             void* out, void* keep, double sigma, int64_t nwaves, int nslices,
                             int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || nwaves < 1) return cudaErrorInvalidValue;
  FwdArgs a;
  a.sweep = sweep_args(v, prop, p_wave_stride, nwaves, sigma);
  a.psi0 = static_cast<const float2*>(psi0);
  a.out = static_cast<float2*>(out);
  a.keep = static_cast<float2*>(keep);
  a.nslices = nslices;
  a.seg = 1;
  FDES_DISPATCH_N(n, launch_wide_fwd<L>(device, a, false, static_cast<cudaStream_t>(stream)))
}

int fdes_wide_scan_bwd_store_c64(int device, int n, const void* keep, const void* v,
                                 const void* prop, const void* g, void* dpsi, void* dv,
                                 void* part, double sigma, int64_t nwaves, int nslices,
                                 int ngroups, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || nwaves < 1 || ngroups < 1 || ngroups > nwaves) {
    return cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.sweep = sweep_args(v, prop, p_wave_stride, nwaves, sigma);
  a.groups.part = static_cast<float*>(part);
  a.groups.per_group = static_cast<int>((nwaves + ngroups - 1) / ngroups);
  a.groups.ngroups = static_cast<int>((nwaves + a.groups.per_group - 1) / a.groups.per_group);
  a.keep = static_cast<const float2*>(keep);
  a.g = static_cast<const float2*>(g);
  a.dpsi = static_cast<float2*>(dpsi);
  a.dv = static_cast<float*>(dv);
  a.work = nullptr;
  a.sbuf = nullptr;
  a.nslices = nslices;
  a.seg = 1;
  FDES_DISPATCH_N(n, launch_wide_bwd<L>(device, a, false, static_cast<cudaStream_t>(stream)))
}

// The segment pair on the wide kernels: the forward as fdes_scan_fwd_keep_c64
// with seg > 0 (keep = the checkpoints), the backward as fdes_scan_bwd_c64
// with seg > 0 (work and sbuf its scratch).
int fdes_wide_scan_ck_c64(int device, int n, const void* psi0, const void* v, const void* prop,
                          void* out, void* ck, double sigma, int64_t nwaves, int nslices, int seg,
                          int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || nwaves < 1 || seg < 1 || nslices % seg != 0) return cudaErrorInvalidValue;
  FwdArgs a;
  a.sweep = sweep_args(v, prop, p_wave_stride, nwaves, sigma);
  a.psi0 = static_cast<const float2*>(psi0);
  a.out = static_cast<float2*>(out);
  a.keep = static_cast<float2*>(ck);
  a.nslices = nslices;
  a.seg = seg;
  FDES_DISPATCH_N(n, launch_wide_fwd<L>(device, a, true, static_cast<cudaStream_t>(stream)))
}

int fdes_wide_scan_bwd_ck_c64(int device, int n, const void* ck, const void* v, const void* prop,
                              const void* g, void* dpsi, void* dv, void* part, void* work,
                              void* sbuf, double sigma, int64_t nwaves, int nslices, int seg,
                              int ngroups, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || nwaves < 1 || seg < 1 || nslices % seg != 0 || ngroups < 1 ||
      ngroups > nwaves) {
    return cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.sweep = sweep_args(v, prop, p_wave_stride, nwaves, sigma);
  a.groups.part = static_cast<float*>(part);
  a.groups.per_group = static_cast<int>((nwaves + ngroups - 1) / ngroups);
  a.groups.ngroups = static_cast<int>((nwaves + a.groups.per_group - 1) / a.groups.per_group);
  a.keep = static_cast<const float2*>(ck);
  a.g = static_cast<const float2*>(g);
  a.dpsi = static_cast<float2*>(dpsi);
  a.dv = static_cast<float*>(dv);
  a.work = static_cast<float2*>(work);
  a.sbuf = static_cast<float2*>(sbuf);
  a.nslices = nslices;
  a.seg = seg;
  FDES_DISPATCH_N(n, launch_wide_bwd<L>(device, a, true, static_cast<cudaStream_t>(stream)))
}

// `rounds` grid barriers over `blocks` blocks of the wide kernels' size, by
// cg::grid_group::sync (light == 0) or by the counter at `counter` (one
// zeroed unsigned int), in one cooperative launch.
int fdes_grid_barrier(int device, int blocks, int rounds, int light, void* counter,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || rounds < 0) return cudaErrorInvalidValue;
  unsigned int* c = static_cast<unsigned int*>(counter);
  void* args[] = {&c, &rounds, &light};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_barrier_kernel),
                                     dim3(blocks), dim3(kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
}

int fdes_adjoint_scan_info(int device, int n, int which, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_N(n, kernel_info<L>(device, which, out))
}

}  // extern "C"
