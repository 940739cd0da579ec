// The fused slice step and the whole-loop scan, for Hopper (sm_90a), with the
// 2-D FFT computed in the kernels' own bodies (no cuFFT).
//
//   one step:   psi <- IFFT2[ P * FFT2[ t * psi ] ],  t = exp(i*sigma*V), V real
//   the scan:   that step for slices j = 0..S-1 of a potential stack, for B
//               waves, in one cooperative launch.
//
// Replaces fdes_tpu/pallas/fused_step.py::_fwd_kernel and ::_bwd_kernel (the
// step and its adjoint) and fdes_tpu/pallas/fused_scan.py::_scan_kernel (the
// whole loop).  The TPU kernels hold whole planes in VMEM (tens of MiB) and
// transform them with 128-point matrix products; a 512^2 complex64 plane
// (2 MiB) fits in no SM's shared memory, so here a plane is transformed in two
// kinds of pass over tiles of 4096 elements (32 KB of shared memory):
//
//   row pass     a tile is 4096/N whole rows; 1-D transforms along x;
//   column pass  a tile is a panel of 4096/N adjacent columns, all N rows;
//                1-D transforms along y, with the propagator multiply between
//                the forward and the inverse transform.
//
// Between the two kinds of pass a plane goes through global memory (L2 holds
// 16 waves of 512^2).  The scan fuses the inverse x transform of slice j-1
// with the transmit and the forward x transform of slice j into one row pass,
// so a slice costs two plane round trips, and one final row pass gives the
// exit wave.  Blocks of the scan walk over (wave, tile) pairs and meet at a
// grid-wide barrier (cooperative groups) after every pass.
//
// The 1-D transform is radix 2 in shared memory: the forward one is decimation
// in frequency (natural order in, bit-reversed out), the inverse one decimation
// in time with conjugate twiddles (bit-reversed in, natural out), stage for
// stage the inverse of the forward one up to the factor 2 per stage.  So the
// spectrum lives in bit-reversed order in both axes and is never reordered:
// the caller hands the propagator in that order (P_br[a][b] =
// P[bitrev(a)][bitrev(b)], a gather made once per call), and the kernel applies
// the 1/N^2 of the inverse transform with the propagator multiply.  Up to three
// stages are fused in registers between two block barriers (8 elements per
// thread), and the tile is padded by one element in 16 against bank conflicts.
// Twiddles exp(-2*pi*i*k/N) come from sincospif on arguments that are exact in
// float32, once per block; the library is built without --use_fast_math.
//
// The adjoint (PyTorch's convention: g is dL/dRe + i dL/dIm of the output):
//   bar_s = IFFT2[ conj(P) * FFT2[ g ] ],
//   dpsi = bar_s * conj(t),   dV = sigma * Im(bar_s * conj(t * psi)),
// dV summed over the waves that share V, in registers, by the pair of warps
// that owns the row: no atomics.
//
// Bounds at 512^2 complex64 (H100 SXM: 3.35 TB/s, 67 TFLOP/s FP32): one step
// moves psi in, V, P, psi out = 7 MiB, 2.2 us by bytes, against 0.75 us for
// its ~50 MFLOP, so the step is bound by bytes.  In the scan only V_j is new
// per slice (1 MiB, shared by the waves), so a wave-slice is bound by its
// operations, 0.75 us.  scan_kernel is far from either (measured on an H100
// 80GB HBM3 at 700 W by chip_smoke.py: 7.4 us per wave-slice in a 16-wave
// scan): radix-2 stages through shared memory, panels of 8 columns (64-byte
// rows), two round trips through L2 per slice and two grid-wide barriers
// per slice.
//
// The step runs on one of two routes, picked by
// kernels/fused_step.STEP_ROUTE from H100 rows before the launch:
//  * "tile": three ordinary launches of the tile passes (row pass, column
//    pass, row pass).  One block a 4,096-element tile gives one wave 4, 16,
//    64 and 256 blocks at 128^2 to 1024^2: 28.8 us at one 512^2 wave.  It
//    keeps the rows where the wide kernel's second round of column items
//    costs more than two launches (PERF.md section 6).
//  * "wide" (wide_step_kernel): one cooperative launch on the wide transform
//    of fused_fft.cuh, the store pair's design (adjoint_scan.cu) at one slice
//    without the store of s: every resident block, a pair of warps a row and
//    a block four columns, the 1-D transforms in registers with two
//    exchanges, three phases between two grid barriers.  18.0 us at one
//    512^2 wave, in turns with the tile route (80 registers, 3 blocks an SM).
// The adjoint has one kernel, wide_step_bwd_kernel, of the same design: its
// last row phase spreads the rows of wave groups over the grid (V's row
// loaded once for the group, dV summed in registers, partial planes added in
// a fixed order after one more barrier); 17.9 us at one 512^2 wave (128
// registers, 2 blocks an SM).  Its tile form (a row pass, a column pass and
// a tail kernel that walked the waves in turn on one wave's blocks) won no
// row that mattered and was removed; PERF.md keeps its times.
//
// cluster_scan_kernel (128^2 to 512^2) removes the round trips and the grid
// barriers: one thread-block cluster carries one wave through all S slices
// with the plane in the cluster's shared memory (the in-cluster transform of
// fused_fft.cuh), clusters never wait on each other, and per wave-slice only
// V_j (1 MiB) and P (2 MiB, from L2) are read.  One wave runs on C SMs (16 at
// 512^2), so its own bound is 132/16 times the card's; the card's bound needs
// as many waves as resident clusters.
//
// wide_scan_kernel (128^2 to 1024^2) is the third design of the whole loop,
// and also replaces fdes_tpu/pallas/fused_scan.py::_scan_kernel: the wide
// store forward's sweep (adjoint_scan.cu, row 9) with no store, one
// cooperative launch.  Bound at 512^2: 0.76 us a wave-slice, by operations.
// At one wave scan_kernel leaves the card half idle (64 tiles of 4,096
// elements for 132 SMs, block barriers inside every transform, bank
// conflicts of the plain twiddle table) and cluster_scan_kernel runs on 16
// SMs; the wide transform gives one 512^2 wave 512 row pairs and 128 column
// items, one block an SM, the stages in registers and shuffles, the staged
// twiddle table, and two grid barriers a slice.  Where a block owns one
// column item for the whole sweep it holds that item's columns of P in
// shared memory.
//
// The Python wrapper picks among the three kernels by (N, B) from a table
// of measured rows.
//
// The transforms, the tiles and the two tile passes live in fused_fft.cuh,
// which adjoint_scan.cu (the whole-loop adjoint) shares.
//
// Layout: PyTorch's interleaved complex64 (float2), C-contiguous, 16-byte
// aligned; N in {128, 256, 512, 1024} ({128, 256, 512} for the cluster
// scan).  Every entry point launches on the caller's stream, allocates
// nothing, does not synchronise, and returns the first CUDA error (0 if
// none), so that a refused launch is reported by the Python wrapper.

#include "fused_fft.cuh"

namespace {

// Row pass over every tile of nwaves planes.  v: nullptr, or the potentials
// of one plane, shared by the waves.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const float2* src, float2* dst, const float* __restrict__ v, float sigma,
                int inverse, int forward, int64_t nwaves) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  constexpr int64_t kTilesPerWave = (int64_t{1} << (2 * LOG2N)) / kTile;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kTilesPerWave; t += gridDim.x) {
    const float* vt = v == nullptr ? nullptr : v + (t % kTilesPerWave) * kTile;
    row_tile<LOG2N>(tile, tw, src + t * kTile, dst + t * kTile, vt, sigma, inverse != 0,
                    forward != 0);
  }
}

// Column pass over every panel of nwaves planes, in place.  prop: the
// bit-reversed propagator of wave 0, p_wave_stride elements to the next
// wave's (0 when shared).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
col_pass_kernel(float2* buf, const float2* __restrict__ prop, int64_t p_wave_stride, int conj_p,
                int64_t nwaves) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kTilesPerWave = kPlane / kTile;
  constexpr int C = kTile >> LOG2N;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kTilesPerWave; t += gridDim.x) {
    const int64_t b = t / kTilesPerWave;
    const int c0 = static_cast<int>(t % kTilesPerWave) * C;
    float2* plane = buf + b * kPlane;
    col_tile<LOG2N>(tile, tw, plane, plane, c0, prop + b * p_wave_stride, conj_p != 0);
  }
}

struct ScanArgs {
  const float2* psi0;   // (B, N, N)
  float2* out;          // (B, N, N): the carried wave, then the exit wave
  const float* v;       // (S, N, N), or (B, S, N, N) with v_wave_stride = S*N*N
  const float2* prop;   // (N, N) bit-reversed, or (B, N, N) with p_wave_stride = N*N
  int64_t v_wave_stride;
  int64_t p_wave_stride;
  int64_t nwaves;
  int nslices;
  float sigma;
};

// The whole slice loop in one cooperative launch.  Per slice j: row pass
// [inverse x of slice j-1 | transmit with V_j | forward x], barrier, column
// pass [forward y | * P | inverse y], barrier; then one row pass [inverse x].
// Every block runs the same number of barriers.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  __shared__ float2 tile[kTilePadded];
  __shared__ float2 tw[kMaxTwiddles];
  cg::grid_group grid = cg::this_grid();
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kTilesPerWave = kPlane / kTile;
  constexpr int C = kTile >> LOG2N;
  const int64_t ntiles = a.nwaves * kTilesPerWave;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int j = 0; j <= a.nslices; ++j) {
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int64_t b = t / kTilesPerWave;
      const int64_t r = t % kTilesPerWave;
      const float2* src = (j == 0 ? a.psi0 : a.out) + t * kTile;
      const float* vt =
          j < a.nslices ? a.v + b * a.v_wave_stride + j * kPlane + r * kTile : nullptr;
      row_tile<LOG2N>(tile, tw, src, a.out + t * kTile, vt, a.sigma, j > 0, j < a.nslices);
    }
    if (j == a.nslices) break;
    grid.sync();
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int64_t b = t / kTilesPerWave;
      const int c0 = static_cast<int>(t % kTilesPerWave) * C;
      float2* plane = a.out + b * kPlane;
      col_tile<LOG2N>(tile, tw, plane, plane, c0, a.prop + b * a.p_wave_stride, false);
    }
    grid.sync();
  }
}

// The whole slice loop on the wide transform (row 8 redesigned): the store
// forward's sweep (fused_fft.cuh, wide_forward_sweep) with nothing kept.  Per
// slice j: rows [inverse x of slice j-1 | transmit with V_j | forward x],
// grid barrier, column items [forward y | * P / N^2 | inverse y], grid
// barrier; then the rows' inverse x leaves the exit wave in out.  V per wave
// through v_wave_stride (0: shared).  When the grid holds every column item
// at once (one wave up to 512^2), each block owns one item for the whole
// sweep and keeps its four columns of P in shared memory (16 KiB at 512^2),
// read once instead of from L2 every slice.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_scan_kernel(ScanArgs a) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr bool kHoldP = LOG2N <= 9;  // 1024^2: 32 KiB more than the 48 KiB static
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[N];  // the staged table: N - 1 entries
  __shared__ float2 pcols[kHoldP ? W::kCols * N : 1];
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  ScanSweepArgs sw;
  sw.v = a.v;
  sw.prop = a.prop;
  sw.p_wave_stride = a.p_wave_stride;
  sw.nwaves = a.nwaves;
  sw.sigma = a.sigma;
  sw.v_wave_stride = a.v_wave_stride;
  sw.pcols = nullptr;
  const int64_t items = a.nwaves * (N / W::kCols);
  if (kHoldP && items <= gridDim.x) {
    if (blockIdx.x < items) {  // thread i: row i / 2, columns 2 (i % 2) and 2 (i % 2) + 1
      const int c0 = static_cast<int>(blockIdx.x % (N / W::kCols)) * W::kCols;
      const float2* pb = a.prop + (blockIdx.x / (N / W::kCols)) * a.p_wave_stride;
      for (int i = threadIdx.x; i < 2 * N; i += kThreads) {
        const int y = i >> 1;
        const int c = 2 * (i & 1);
        load_pair(pb + static_cast<int64_t>(y) * N + c0 + c, &pcols[c * N + y],
                  &pcols[(c + 1) * N + y]);
      }
    }
    sw.pcols = pcols;
  }
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  wide_forward_sweep<LOG2N, false, false>(grid, tile, tw, t, sw, a.psi0, kPlane, a.out, 0,
                                          a.nslices, nullptr, 0, 1, true);
}

// The whole slice loop with each wave's plane resident in one cluster's
// shared memory.  Cluster k carries waves k, k + G, k + 2G, ... (G clusters
// in the grid).  Per slice j: [inverse x of slice j-1 | transmit with V_j |
// forward x | forward R-point y], cluster barrier, the cross step (C-point
// DFTs and P), cluster barrier, [inverse R-point y]; after the last slice
// the inverse x and one store of the exit wave.  The inverse x transform's
// last group of three radix-2 stages, the transmit and the forward one's
// first group are one pass over the tile.  V_(j+1)'s rows are copied to
// shared memory (cp.async) while slice j runs, so the transmit never waits
// on device memory.  A CTA touches another's shared memory only between the
// two barriers of a slice, so none leaves while its tile may still be read.
// nslices >= 1.
template <int LOG2N>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_scan_kernel(ScanArgs a) {
  using S = Cluster<LOG2N>;
  constexpr int E = S::kElems;
  constexpr int T = kClusterThreads;
  extern __shared__ float4 cluster_smem[];
  float2* tile = reinterpret_cast<float2*>(cluster_smem);
  float2* tw = tile + S::kPadded;  // staged: serves the N-, R- and C-point transforms
  float* vrows = reinterpret_cast<float*>(reinterpret_cast<char*>(cluster_smem) + S::kVOffset);
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t nclusters = gridDim.x / S::C;
  init_staged_twiddles<LOG2N, T>(tw);
  for (int64_t w = blockIdx.x / S::C; w < a.nwaves; w += nclusters) {
    const float* vw = a.v + w * a.v_wave_stride;
    cluster_prefetch_v<LOG2N>(vrows, vw, rank);
    for (int j = 0; j < a.nslices; ++j) {
      if (j > 0) fft_inverse<LOG2N, true, E, T, false, true>(tile, tw);
      cp_async_wait_all();
      __syncthreads();  // V_j's rows (and, at the start, the twiddles) are in
      if (j == 0) {
        cluster_load_rows<LOG2N>(tile, a.psi0 + w * kPlane, vrows, a.sigma, rank);
      } else {
        stage_group<LOG2N, 3, true, true, E, T, true, true>(tile, tw, LOG2N - 3, vrows, a.sigma);
      }
      __syncthreads();
      if (j + 1 < a.nslices) cluster_prefetch_v<LOG2N>(vrows, vw + (j + 1) * kPlane, rank);
      if (j == 0) {
        fft_forward<LOG2N, true, E, T, true, true>(tile, tw);
      } else {
        fft_forward<LOG2N, true, E, T, false, true>(tile, tw);
      }
      fft_forward<S::LOG2R, false, E, T, true, true>(tile, tw);
      cluster.sync();
      cluster_cross<LOG2N>(tile, tw, a.prop + w * a.p_wave_stride, rank);
      cluster.sync();
      fft_inverse<S::LOG2R, false, E, T, true, true>(tile, tw);
    }
    fft_inverse<LOG2N, true, E, T, true, true>(tile, tw);
    cluster_store_rows<LOG2N>(tile, a.out + w * kPlane, rank);
    __syncthreads();  // the next wave's load reuses the tile
  }
}

int blocks_for(int64_t ntiles) {
  return static_cast<int>(ntiles < kMaxBlocks ? ntiles : kMaxBlocks);
}

template <int LOG2N>
int launch_step(const float2* psi, const float* v, const float2* prop, float2* out, float sigma,
                int64_t nwaves, int64_t p_wave_stride, cudaStream_t stream) {
  constexpr int64_t kTilesPerWave = (int64_t{1} << (2 * LOG2N)) / kTile;
  const int blocks = blocks_for(nwaves * kTilesPerWave);
  row_pass_kernel<LOG2N><<<blocks, kThreads, 0, stream>>>(psi, out, v, sigma, 0, 1, nwaves);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  col_pass_kernel<LOG2N><<<blocks, kThreads, 0, stream>>>(out, prop, p_wave_stride, 0, nwaves);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_pass_kernel<LOG2N><<<blocks, kThreads, 0, stream>>>(out, out, nullptr, sigma, 1, 0, nwaves);
  return cudaGetLastError();
}

// ---- the wide step and its adjoint: rows 6 and 7 redesigned --------------
//
// One cooperative launch each, on the wide transform of fused_fft.cuh (one
// 1-D transform in the registers of a pair of warps): row items are one row
// a pair, column items four columns a block, spread over min(resident, B N
// / 4) blocks, with a grid barrier between the phases.

struct StepArgs {
  const float2* psi;    // (B, N, N)
  const float* v;       // (N, N), shared by the waves
  const float2* prop;   // bit-reversed, (N, N) or (B, N, N) with p_wave_stride = N*N
  const float2* g;      // the adjoint: the upstream gradient (B, N, N)
  float2* out;          // the step: the next wave; the adjoint: dpsi (B, N, N)
  float* dv;            // the adjoint: (N, N), summed over the waves
  float* part;          // the adjoint: (ngroups, N, N) partial dV planes when ngroups > 1
  int64_t p_wave_stride;
  int64_t nwaves;
  int ngroups;          // the adjoint's wave groups
  int per_group;        // waves per group (the last group may hold fewer)
  float sigma;
};

// The column phase of a step: every column item of the B planes at buf, in
// place, with P (conj_p: its conjugate).
template <int LOG2N>
__device__ __forceinline__ void wide_col_phase(float2* tile, const float2* tw, float2* buf,
                                               const StepArgs& a, bool conj_p,
                                               const WidePlace& t) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  const int64_t items = a.nwaves * (N / W::kCols);
  for (int64_t i = blockIdx.x; i < items; i += gridDim.x) {
    const int64_t b = i / (N / W::kCols);
    const int c0 = static_cast<int>(i % (N / W::kCols)) * W::kCols;
    wide_col_item<LOG2N>(tile, tw, buf + b * kPlane, c0, a.prop + b * a.p_wave_stride, conj_p, t);
  }
}

// Row 6: out = IFFT2[ P * FFT2[ t * psi ] ] in three phases: rows [transmit
// | forward x], barrier, columns [forward y | * P / N^2 | inverse y],
// barrier, rows [inverse x].
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_step_kernel(StepArgs a) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[N];  // the staged table: N - 1 entries
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  const int64_t rows = a.nwaves * N;
  const int64_t first = blockIdx.x + static_cast<int64_t>(threadIdx.x >> 6) * gridDim.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWidePairs;
  for (int64_t u = first; u < rows; u += step) {  // u = b N + y
    wide_fwd_row<LOG2N, false>(tw, a.psi + u * N, a.out + u * N, nullptr,
                               a.v + (u & (N - 1)) * N, a.sigma, false, t);
  }
  grid.sync();
  wide_col_phase<LOG2N>(tile, tw, a.out, a, false, t);
  grid.sync();
  for (int64_t u = first; u < rows; u += step) {
    wide_fwd_row<LOG2N, false>(tw, a.out + u * N, a.out + u * N, nullptr, nullptr, a.sigma, true,
                               t);
  }
}

// Row 7: the step's adjoint.  Rows [forward x of g], barrier, columns with
// conj(P), barrier, rows: a pair takes row y for the waves of its wave
// group, loads V's row once, and per wave undoes the x transform (bar_s),
// forms t, writes dpsi = bar_s * conj(t) and adds Im(bar_s * conj(t psi))
// to its registers (t kept in float2 registers across the waves was slower:
// more live registers through the transform, PERF.md section 6); the
// group's sum goes to dv (one group) or to its partial
// plane, and after one more barrier the partials are added in the order 0,
// 1, ...: no atomics, the same bits from run to run.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads) wide_step_bwd_kernel(StepArgs a) {
  using W = Wide<LOG2N>;
  constexpr int N = W::N;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  __shared__ float2 tile[W::kCols * W::kColStride];
  __shared__ float2 tw[N];
  cg::grid_group grid = cg::this_grid();
  init_staged_twiddles<LOG2N, kThreads>(tw);
  __syncthreads();
  const WidePlace t = wide_place(tile, W::kColStride);
  const int64_t rows = a.nwaves * N;
  const int64_t first = blockIdx.x + static_cast<int64_t>(threadIdx.x >> 6) * gridDim.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWidePairs;
  for (int64_t u = first; u < rows; u += step) {
    float2 x[W::R];
    wide_load_row<LOG2N>(x, a.g + u * N, t);
    wide_fft_forward<LOG2N>(x, tw, t);
    wide_store_row<LOG2N>(x, a.out + u * N, t);
  }
  grid.sync();
  wide_col_phase<LOG2N>(tile, tw, a.out, a, true, t);
  grid.sync();
  const bool partial = a.ngroups > 1;
  const int64_t group_rows = static_cast<int64_t>(a.ngroups) * N;
  for (int64_t u = first; u < group_rows; u += step) {  // u = group N + y
    const int64_t gi = u >> LOG2N;
    const int64_t y = u & (N - 1);
    const int64_t b0 = gi * a.per_group;
    const int64_t b1 = b0 + a.per_group < a.nwaves ? b0 + a.per_group : a.nwaves;
    float acc[W::R];
    float vv[W::R];  // the row's potentials, loaded once for the group's waves
#pragma unroll
    for (int m = 0; m < W::R; ++m) {
      acc[m] = 0.0f;
      vv[m] = __ldg(a.v + y * N + W::H * t.w + t.lane + 32 * m);
    }
    for (int64_t b = b0; b < b1; ++b) {
      float2* row = a.out + (b * N + y) * N;
      wide_bwd_row<LOG2N, true>(tw, row, row, a.psi + (b * N + y) * N, vv, a.sigma, false, acc,
                                t);
    }
    float* o = (partial ? a.part + gi * kPlane : a.dv) + y * N;
#pragma unroll
    for (int m = 0; m < W::R; ++m) o[W::H * t.w + t.lane + 32 * m] = a.sigma * acc[m];
  }
  if (partial) {
    grid.sync();
    reduce_partials<LOG2N>(a.part, a.dv, a.ngroups);
  }
}

// The wide kernels over B waves: every resident block, at most one a column
// item (B N / 4: the row items then take four a block).
template <int LOG2N>
int launch_wide_step(int device, StepArgs a, bool adjoint, cudaStream_t stream) {
  const void* kernel = adjoint ? reinterpret_cast<const void*>(wide_step_bwd_kernel<LOG2N>)
                               : reinterpret_cast<const void*>(wide_step_kernel<LOG2N>);
  return launch_cooperative(kernel, device, a, a.nwaves, (1 << LOG2N) / kWidePairs, stream);
}

// out[0..3] = registers per thread, static shared bytes, local bytes per
// thread and resident blocks of a cooperative kernel.
int cooperative_info(const void* kernel, int device, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return resident_blocks_of(kernel, device, &out[3]);
}

// cooperative_info of the wide step (adjoint == 0) or its adjoint.
template <int LOG2N>
int wide_step_info(int device, int adjoint, int* out) {
  const void* kernel = adjoint ? reinterpret_cast<const void*>(wide_step_bwd_kernel<LOG2N>)
                               : reinterpret_cast<const void*>(wide_step_kernel<LOG2N>);
  return cooperative_info(kernel, device, out);
}

template <int LOG2N>
int launch_scan(int device, ScanArgs a, cudaStream_t stream) {
  return launch_cooperative(reinterpret_cast<const void*>(scan_kernel<LOG2N>), device, a,
                            a.nwaves, (int64_t{1} << (2 * LOG2N)) / kTile, stream);
}

// The wide scan over B waves: every resident block, at most one a column item
// (B N / 4: the row items then take four a block).
template <int LOG2N>
int launch_wide_scan(int device, ScanArgs a, cudaStream_t stream) {
  if (a.nslices < 1 || a.nwaves < 1) return cudaErrorInvalidValue;
  int err = launch_cooperative(reinterpret_cast<const void*>(wide_scan_kernel<LOG2N>), device, a,
                               a.nwaves, (1 << LOG2N) / kWidePairs, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cooperative_info of scan_kernel (wide == 0) or wide_scan_kernel.
template <int LOG2N>
int scan_info(int device, int wide, int* out) {
  const void* kernel = wide ? reinterpret_cast<const void*>(wide_scan_kernel<LOG2N>)
                            : reinterpret_cast<const void*>(scan_kernel<LOG2N>);
  return cooperative_info(kernel, device, out);
}

// The cluster kernel's launch configuration for `clusters` clusters; the
// attributes it needs above 48 KB of shared memory and above 8 CTAs a cluster.
template <int LOG2N>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int64_t clusters,
                           cudaStream_t stream) {
  using S = Cluster<LOG2N>;
  cudaError_t err = cudaFuncSetAttribute(cluster_scan_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::kSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cluster_scan_kernel<LOG2N>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(clusters * S::C));
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = S::kSmemBytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S::C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// An ordinary launch of min(clusters, nwaves) clusters (clusters: what
// cudaOccupancyMaxActiveClusters reported, queried by the caller).  A launch
// the card refuses returns its error; nothing else runs in its place.
template <int LOG2N>
int launch_cluster_scan(ScanArgs a, int clusters, cudaStream_t stream) {
  if (clusters < 1 || a.nslices < 1 || a.nwaves < 1) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<LOG2N>(&cfg, &attr, a.nwaves < clusters ? a.nwaves : clusters,
                                          stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, cluster_scan_kernel<LOG2N>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int LOG2N>
int cluster_info(int* out) {
  cudaFuncAttributes attr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster_dim;
  cudaError_t err = cluster_config<LOG2N>(&cfg, &cluster_dim, 1, nullptr);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, cluster_scan_kernel<LOG2N>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(Cluster<LOG2N>::kSmemBytes);
  out[4] = Cluster<LOG2N>::C;
  return cudaOccupancyMaxActiveClusters(&out[5], cluster_scan_kernel<LOG2N>, &cfg);
}

// The arguments of the three whole-loop kernels, as their entry points take them.
ScanArgs scan_args(const void* psi0, const void* v, const void* prop, void* out, double sigma,
                   int64_t nwaves, int nslices, int64_t v_wave_stride, int64_t p_wave_stride) {
  ScanArgs a;
  a.psi0 = static_cast<const float2*>(psi0);
  a.out = static_cast<float2*>(out);
  a.v = static_cast<const float*>(v);
  a.prop = static_cast<const float2*>(prop);
  a.v_wave_stride = v_wave_stride;
  a.p_wave_stride = p_wave_stride;
  a.nwaves = nwaves;
  a.nslices = nslices;
  a.sigma = static_cast<float>(sigma);
  return a;
}

}  // namespace

extern "C" {

const char* fdes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// psi (nwaves, n, n) -> out, one slice step; v (n, n) shared by the waves;
// prop bit-reversed, (n, n) (p_wave_stride 0) or one per wave (n*n).
int fdes_fused_step_c64(int device, int n, const void* psi, const void* v, const void* prop,
                        void* out, double sigma, int64_t nwaves, int64_t p_wave_stride,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_N(n, launch_step<L>(static_cast<const float2*>(psi), static_cast<const float*>(v),
                                    static_cast<const float2*>(prop), static_cast<float2*>(out),
                                    static_cast<float>(sigma), nwaves, p_wave_stride,
                                    static_cast<cudaStream_t>(stream)))
}

// One slice step on wide_step_kernel: as fdes_fused_step_c64, in one
// cooperative launch.
int fdes_wide_step_c64(int device, int n, const void* psi, const void* v, const void* prop,
                       void* out, double sigma, int64_t nwaves, int64_t p_wave_stride,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nwaves < 1) return cudaErrorInvalidValue;
  StepArgs a{};
  a.psi = static_cast<const float2*>(psi);
  a.v = static_cast<const float*>(v);
  a.prop = static_cast<const float2*>(prop);
  a.out = static_cast<float2*>(out);
  a.p_wave_stride = p_wave_stride;
  a.nwaves = nwaves;
  a.ngroups = 1;
  a.per_group = 1;
  a.sigma = static_cast<float>(sigma);
  FDES_DISPATCH_N(n, launch_wide_step<L>(device, a, false, static_cast<cudaStream_t>(stream)))
}

// The step's adjoint on wide_step_bwd_kernel, in one cooperative launch:
// g (nwaves, n, n) -> dpsi (nwaves, n, n), dv (n, n) summed over the waves;
// part: (ngroups, n, n) float32 scratch when ngroups > 1.
int fdes_wide_step_bwd_c64(int device, int n, const void* psi, const void* v, const void* g,
                           const void* prop, void* dpsi, void* dv, void* part, double sigma,
                           int64_t nwaves, int ngroups, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nwaves < 1 || ngroups < 1 || ngroups > nwaves || (ngroups > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  StepArgs a{};
  a.psi = static_cast<const float2*>(psi);
  a.v = static_cast<const float*>(v);
  a.prop = static_cast<const float2*>(prop);
  a.g = static_cast<const float2*>(g);
  a.out = static_cast<float2*>(dpsi);
  a.dv = static_cast<float*>(dv);
  a.part = static_cast<float*>(part);
  a.p_wave_stride = p_wave_stride;
  a.nwaves = nwaves;
  a.per_group = static_cast<int>((nwaves + ngroups - 1) / ngroups);
  a.ngroups = static_cast<int>((nwaves + a.per_group - 1) / a.per_group);
  a.sigma = static_cast<float>(sigma);
  FDES_DISPATCH_N(n, launch_wide_step<L>(device, a, true, static_cast<cudaStream_t>(stream)))
}

// out[0..3] = registers per thread, static shared bytes, local bytes per
// thread and resident blocks of wide_step_kernel (adjoint == 0) or
// wide_step_bwd_kernel (adjoint == 1) for size n.
int fdes_wide_step_info(int device, int n, int adjoint, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_N(n, wide_step_info<L>(device, adjoint, out))
}

// The whole loop: psi0 (nwaves, n, n) through nslices slices -> out, in one
// cooperative launch.
int fdes_fused_scan_c64(int device, int n, const void* psi0, const void* v, const void* prop,
                        void* out, double sigma, int64_t nwaves, int nslices,
                        int64_t v_wave_stride, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ScanArgs a = scan_args(psi0, v, prop, out, sigma, nwaves, nslices, v_wave_stride,
                               p_wave_stride);
  FDES_DISPATCH_N(n, launch_scan<L>(device, a, static_cast<cudaStream_t>(stream)))
}

// The whole loop on wide_scan_kernel: as fdes_fused_scan_c64 (the same prop,
// bit-reversed), nwaves >= 1 and nslices >= 1.
int fdes_wide_scan_c64(int device, int n, const void* psi0, const void* v, const void* prop,
                       void* out, double sigma, int64_t nwaves, int nslices,
                       int64_t v_wave_stride, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ScanArgs a = scan_args(psi0, v, prop, out, sigma, nwaves, nslices, v_wave_stride,
                               p_wave_stride);
  FDES_DISPATCH_N(n, launch_wide_scan<L>(device, a, static_cast<cudaStream_t>(stream)))
}

// out[0..3] = registers per thread, static shared bytes, local bytes per
// thread, and resident blocks on the device, of wide_scan_kernel for size n.
int fdes_wide_scan_info(int device, int n, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_N(n, scan_info<L>(device, 1, out))
}

// The whole loop on cluster_scan_kernel: as fdes_fused_scan_c64, with prop
// gathered into the cluster order (fused_fft.cuh) and `clusters` the
// resident clusters that fdes_cluster_scan_info reported.
int fdes_cluster_scan_c64(int device, int n, const void* psi0, const void* v, const void* prop,
                          void* out, double sigma, int64_t nwaves, int nslices,
                          int64_t v_wave_stride, int64_t p_wave_stride, int clusters,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ScanArgs a = scan_args(psi0, v, prop, out, sigma, nwaves, nslices, v_wave_stride,
                               p_wave_stride);
  FDES_DISPATCH_CLUSTER_N(n, launch_cluster_scan<L>(a, clusters,
                                                    static_cast<cudaStream_t>(stream)))
}

// out[0..5] = registers per thread, static shared bytes, local bytes per
// thread, dynamic shared bytes per CTA, CTAs per cluster, and the clusters
// that can be resident at once (cudaOccupancyMaxActiveClusters) of the
// cluster kernel for size n.
int fdes_cluster_scan_info(int device, int n, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_CLUSTER_N(n, cluster_info<L>(out))
}

// out[0..3] = registers per thread, static shared bytes, local bytes per
// thread, and resident blocks on the device, of the scan kernel for size n.
int fdes_fused_scan_info(int device, int n, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_N(n, scan_info<L>(device, 0, out))
}

}  // extern "C"
