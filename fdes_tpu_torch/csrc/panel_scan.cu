// The panel scan's passes, for Hopper (sm_90a): the multislice loop on grids
// of 256^2 to 4096^2 as row and column passes over a plane in device memory,
// each pass an ordinary kernel launch, with the 2-D FFT computed in the
// kernels' own bodies (no cuFFT); and its adjoint, the panel gradient.
//
// Replaces the kernels of fdes_tpu/pallas/panel_scan.py:
//   panel_row_kernel<L, kInit, false>       _row_init_kernel           (:82)
//   panel_col_kernel<L> (conj_p false)      _col_kernel                (:247)
//   panel_row_kernel<L, kMid, false>        _row_mid_stack_kernel      (:125) and
//                                           _row_mid_kernel            (:101)
//   panel_row_kernel<L, kFinal, false>      _row_final_kernel          (:194)
//   panel_row_kernel<L, kInit, true>        _row_init_abs_kernel       (:150)
//   panel_row_kernel<L, kMid, true>         _row_mid_stack_abs_kernel  (:171)
//   panel_row_kernel<L, kFwd, false>        _row_fwd_kernel            (:206)
//   panel_bwd_row_kernel<L, kBwdTail>       _row_bwd_tail_kernel       (:219)
//   panel_row_kernel<L, kInitStore, false>  _row_init_store_kernel     (:582)
//   panel_row_kernel<L, kMidStore, false>   _row_mid_store_kernel      (:603)
//   panel_col_kernel<L> (conj_p true)       _col_bwd_kernel            (:626)
//   panel_bwd_row_kernel<L, kBwdLoop>       _row_bwd_loop_kernel       (:650)
//   panel_bwd_row_kernel<L, kBwdLast>       _row_bwd_last_kernel       (:679)
//   panel_g_row_kernel<L>                   _row_g_kernel              (:1045)
//   panel_build_col_kernel<L>               _col_build_kernel          (:1058)
//   panel_vfused_row_kernel<L>              _row_vfused_kernel         (:1086)
// and the whole loops _run_single / _run_single_abs (the rollout),
// _panel_loop_fwd and _panel_loop_bwd (the store-s gradient) as
// fdes_panel_scan_c64, fdes_panel_scan_store_c64 and
// fdes_panel_scan_bwd_store_c64, which issue every pass of a loop from C on
// the caller's stream.  The streamed rollout (panel_streamed) is a Python
// loop over slices: its scatter of atoms is tensor code between the passes.
//
// The field stays x-transformed between slices (panel_scan.py:16-34): with
// a_j = Fx(t_j psi_j), the x spectrum in bit-reversed order,
//
//   init       a_0     = Fx(t_0 psi_0)                        row pass
//   per slice  b_j     = Fy^H(P / N^2 * Fy(a_j))              column pass
//              a_{j+1} = Fx(t_{j+1} Fx^H(b_j))                row pass
//   final      psi_S   = Fx^H(b_{S-1})                        row pass
//
// with t = exp(i sigma V), or exp(-sigma Vi) exp(i sigma Vr) for an
// absorptive potential (the damped transmit, full-precision sincosf and
// expf), and Fx^H, Fy^H the unscaled inverse transforms: the 1/N^2 rides on
// the propagator, which the caller hands in bit-reversed order in both axes
// (P_br[a][b] = P[bitrev a][bitrev b]).  So b_j = Fx(psi_{j+1}) / N.  A slice
// costs one column pass and one row pass, 2S + 1 launches a rollout.  Under
// differentiation the row passes also store s_j = t_j psi_j in natural order
// (kInitStore, kMidStore: row_tile's `post`), for the B waves a stack
// (B, S, N, N).
//
// The adjoint, in PyTorch's convention (g = dL/dRe + i dL/dIm of the exit
// wave).  Fx^H is the conjugate transpose of Fx (Fx = Pi F, Pi the
// bit-reversal, Fx^H = F^H Pi^T) and the column pass's is the column pass
// with conj(P), so the reverse loop is the forward one with each pass
// replaced by its conjugate transpose, no sign flips (the TPU kernels flip
// signs for jax's bilinear pairing; here autograd hands the conjugate):
//
//   seed       bar   = Fx(g)                                  row pass kFwd
//   per slice  bar   = Fy^H(conj(P) / N^2 * Fy(bar))          column pass, conj_p
//              bar_s = Fx^H(bar)                              backward row pass:
//              dV_j  = sigma * Im(bar_s * conj(s_j))            summed over the waves
//              bar   = Fx(bar_s * conj(t_j))                    kBwdLoop, j > 0
//   last       dpsi0 = bar_s * conj(t_0)                        kBwdLast, j = 0
//
// 2S + 1 launches forward and 2S + 1 backward per gradient.  The per-slice
// adjoint (one slice: init, column, final forward) is kFwd, the column pass
// with conj_p and kBwdTail, which forms s = t psi from the kept psi.
//
// The TPU kernels stream (R, N) row panels and (N, 128) column panels of
// (re, im) plane pairs through VMEM, with 128-point matrix-product digits,
// and walk their grid in order.  Here a row tile is 4096 contiguous complex64
// elements (4096/N rows: 2 at 2048, 1 at 4096), a column tile C adjacent
// columns of all N rows, both in dynamic shared memory with the N/2 twiddles
// (a row tile at 4096 needs 51 KB, above the 48 KB of static shared memory);
// the 1-D transform is fused_fft.cuh's radix 2 (forward decimation in
// frequency, inverse decimation in time), so the spectrum is never reordered.
// The forward passes' blocks walk over (wave, tile) pairs, so B waves run in
// one launch per pass (the TPU engine maps over them one at a time).  The
// backward row passes' blocks walk over row tiles and carry each tile through
// the B waves in order, summing dV in registers (as adjoint_scan.cu's
// backward does within a wave group): no atomics, two runs give the same
// bits.  No grid-wide barrier: the stream orders the passes.
//
// The streamed build (panel_streamed): V_j never exists as a stack.  From
// the real per-species delta planes g_s of slice j (the scatter of its atoms)
//
//   row 27     G_s  = Fx(g_s)                                  g row pass, all species
//   row 28     Vx   = Fy^H(sum_s F_s * Fy(G_s))                build column pass
//   row 29     a    = Fx(t_j Fx^H(b)), V_j = Re(Fx^H(Vx))      fused row pass
//
// with F_s the real form factor of species s on the full grid, gathered as
// F_s[bitrev y][bitrev x] (the layout of Fy(Fx(.)), as the propagator) and
// scaled by 1/(py px N^2), so that V_j is slice_potential's.  Row 28 keeps the
// running sum of the species' products in its output plane in device memory,
// which the block alone owns for its panel (in spectral order; the last
// species' product is added in shared memory before the one inverse
// transform): no second tile in shared memory, which would halve the blocks
// resident at 2048^2 and does not fit beside a 4096-point panel of 4
// columns (2 x 136 KB), and no narrower panel; nsp = 1 (Si) moves no extra
// byte, each further species 16 bytes a pixel.  Row 29 transforms V's row
// tile, keeps its real part in shared memory (4 B a point) and carries the
// tile of each wave through the inverse transform, transmit and forward
// transform, so V is transformed once per tile for all the waves.
//
// Bounds (H100 SXM: 3.35 TB/s, 67 TFLOP/s FP32): at 2048^2 a complex64
// plane is 32 MiB and the planes do not stay in the 50 MB L2 between
// passes; a column pass moves a, P and b = 96 MiB (31 us), a row pass b, V
// and a = 80 MiB (25 us), so a slice is bound by its bytes at ~56 us, against
// ~14 us of operations (5 N^2 log2 N^2 per 2-D transform pair, per pass
// half of it).  The store passes add the s plane (+8 bytes a pixel), the
// backward row passes read s and write dV (+12).  The column tile's width C
// sets how much of each 32-byte sector a row of the panel uses: 4 columns
// read whole sectors.  This first version runs at about a third of the bound
// (H100 80GB HBM3 at 700 W, chip_smoke.py: a row pass 79 us, a column pass
// 95 us at 2048^2): radix-2 stages through shared memory, and a column tile
// of 4 x 2048 (77 KB) leaves 2 blocks per SM to hide the loads; a backward
// row pass of one wave has one block per row tile, 1,024 at 2048^2.
//
// Layout: PyTorch's interleaved complex64 (float2), C-contiguous, 16-byte
// aligned; N in {256, 512, 1024, 2048, 4096}; planes are (nwaves, N, N);
// offsets of waves and slices are 64-bit (a 4096^2 x 512 stack holds
// 8.6e9 elements).  Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns the first CUDA error
// (0 if none).

#include "fused_fft.cuh"

namespace {

// Row passes: kInit transmit, forward x; kMid inverse x, transmit, forward x;
// kFinal inverse x; kFwd forward x; kInitStore, kMidStore as kInit, kMid,
// storing s = t psi on the way.  Backward row passes (bwd_row_tile): kBwdLoop
// inverse x, dV, * conj(t), forward x; kBwdLast the same without the forward
// x; kBwdTail as kBwdLast with s formed from psi.
enum RowMode { kInit = 0, kMid = 1, kFinal = 2, kFwd = 3, kInitStore = 4, kMidStore = 5 };
enum BwdMode { kBwdLoop = 0, kBwdLast = 1, kBwdTail = 2 };

// Columns of a column panel: 4 at 2048 and 4096 (a row of the panel is one
// whole 32-byte sector; chosen by a sweep of 1 to 8 columns on an H100, see
// PERF.md), tiles of 8192 elements below.
template <int LOG2N>
constexpr int kPanelCols = LOG2N >= 11 ? 4 : 8192 >> LOG2N;

template <int LOG2N>
constexpr size_t row_smem_bytes() {
  return sizeof(float2) * (kTilePadded + kTwiddlesOf<LOG2N>);
}

template <int LOG2N>
constexpr size_t col_smem_bytes() {
  return sizeof(float2) * (kPanelCols<LOG2N> * (1 << LOG2N) * 17 / 16 + kTwiddlesOf<LOG2N>);
}

template <int LOG2N>
constexpr int64_t kTilesPerWave = (int64_t{1} << (2 * LOG2N)) / kTile;

int blocks_for(int64_t ntiles) {
  return static_cast<int>(ntiles < kMaxBlocks ? ntiles : kMaxBlocks);
}

// A row pass over every tile of nwaves planes (fused_fft.cuh's row_tile).
// vr, vi: one (N, N) plane of potentials shared by the waves (the wrapper
// points them at slice j of a stack); unused by kFinal and kFwd, vi unused
// unless ABS.  s: the store modes' s plane of wave 0, s_wave_stride elements
// to the next wave's.
template <int LOG2N, int MODE, bool ABS>
__global__ void __launch_bounds__(kThreads)
panel_row_kernel(const float2* src, float2* dst, const float* __restrict__ vr,
                 const float* __restrict__ vi, float2* s, int64_t s_wave_stride, float sigma,
                 int64_t nwaves) {
  constexpr bool kStore = MODE == kInitStore || MODE == kMidStore;
  constexpr bool kInverse = MODE == kMid || MODE == kMidStore || MODE == kFinal;
  constexpr bool kTransmit = MODE != kFinal && MODE != kFwd;
  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* tw = smem + kTilePadded;
  constexpr int64_t kTiles = kTilesPerWave<LOG2N>;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kTiles; t += gridDim.x) {
    const int64_t r = (t % kTiles) * kTile;
    row_tile<LOG2N, kStore, ABS>(tile, tw, src + t * kTile, dst + t * kTile,
                                 kTransmit ? vr + r : nullptr, sigma, kInverse, MODE != kFinal,
                                 nullptr, kStore ? s + (t / kTiles) * s_wave_stride + r : nullptr,
                                 ABS ? vi + r : nullptr);
  }
}

// A column pass over every panel of kPanelCols columns of nwaves planes.
// prop: the bit-reversed propagator of wave 0, p_wave_stride elements to the
// next wave's (0 when shared); conj_p: multiply by its conjugate (the
// adjoint).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
panel_col_kernel(const float2* src, float2* dst, const float2* __restrict__ prop,
                 int64_t p_wave_stride, bool conj_p, int64_t nwaves) {
  extern __shared__ float2 smem[];
  constexpr int N = 1 << LOG2N;
  constexpr int C = kPanelCols<LOG2N>;
  float2* tile = smem;
  float2* tw = smem + C * N * 17 / 16;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kPanels = N / C;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kPanels; t += gridDim.x) {
    const int64_t b = t / kPanels;
    const int c0 = static_cast<int>(t % kPanels) * C;
    col_tile<LOG2N, C>(tile, tw, src + b * kPlane, dst + b * kPlane, c0, prop + b * p_wave_stride,
                       conj_p);
  }
}

// A backward row pass over every row tile: each block carries its tiles
// through the nwaves waves in order (bwd_row_tile, src to dst), sums their
// Im(bar_s * conj(s)) in registers and writes sigma times the sum to dv, one
// (N, N) plane.  s: wave 0's s plane (kBwdTail: its psi), s_wave_stride
// elements to the next wave's; v: one (N, N) plane shared by the waves.
template <int LOG2N, int MODE>
__global__ void __launch_bounds__(kThreads)
panel_bwd_row_kernel(const float2* src, float2* dst, const float2* s, int64_t s_wave_stride,
                     const float* __restrict__ v, float* dv, float sigma, int64_t nwaves) {
  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* tw = smem + kTilePadded;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < kTilesPerWave<LOG2N>; t += gridDim.x) {
    const int64_t r = t * kTile;
    float2 acc[kPairsPerThread];
#pragma unroll
    for (int m = 0; m < kPairsPerThread; ++m) acc[m] = make_float2(0.0f, 0.0f);
    for (int64_t b = 0; b < nwaves; ++b) {
      bwd_row_tile<LOG2N, MODE == kBwdTail>(tile, tw, src + b * kPlane + r, dst + b * kPlane + r,
                                            s + b * s_wave_stride + r, v + r, sigma,
                                            MODE == kBwdLoop, acc);
    }
#pragma unroll
    for (int m = 0; m < kPairsPerThread; ++m) {
      const int i = threadIdx.x + m * kThreads;
      *reinterpret_cast<float2*>(dv + r + 2 * i) = make_float2(sigma * acc[m].x, sigma * acc[m].y);
    }
  }
}

// Row 27: the forward x transform of nplanes real (N, N) planes g (the
// species' delta planes of one slice) into complex dst, x in bit-reversed
// order; the imaginary parts are never loaded.
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
panel_g_row_kernel(const float* __restrict__ g, float2* dst, int64_t nplanes) {
  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* tw = smem + kTilePadded;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nplanes * kTilesPerWave<LOG2N>; t += gridDim.x) {
    const float* src = g + t * kTile;
    for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
      const float2 z = *reinterpret_cast<const float2*>(src + 2 * i);
      tile[pad(2 * i)] = make_float2(z.x, 0.0f);
      tile[pad(2 * i + 1)] = make_float2(z.y, 0.0f);
    }
    __syncthreads();
    fft_forward<LOG2N, true>(tile, tw);
    float2* out = dst + t * kTile;
    for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
      store_pair(out + 2 * i, tile[pad(2 * i)], tile[pad(2 * i + 1)]);
    }
    __syncthreads();  // the next tile reuses the shared memory
  }
}

// Row 28: per panel of kPanelCols columns, for each of the nsp species
// planes gx (nsp, N, N) the forward y transform times the species' real
// factor panel fp (nsp, N, N, in the order the transform leaves), summed
// over the species; then one inverse y transform into dst (N, N).  The sum
// of species 0 .. nsp - 2 waits in dst (the block's own columns; each thread
// reads back the elements it wrote).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
panel_build_col_kernel(const float2* __restrict__ gx, const float* __restrict__ fp, float2* dst,
                       int nsp) {
  extern __shared__ float2 smem[];
  constexpr int N = 1 << LOG2N;
  constexpr int C = kPanelCols<LOG2N>;
  constexpr int TILE = C * N;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  float2* tile = smem;
  float2* tw = smem + C * N * 17 / 16;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < N / C; t += gridDim.x) {
    const int c0 = static_cast<int>(t) * C;
    for (int sp = 0; sp < nsp; ++sp) {
      const float2* src = gx + sp * kPlane;
      for (int i = threadIdx.x; i < TILE / 2; i += kThreads) {
        const int e = 2 * i;
        float2 a, b;
        load_pair(src + static_cast<int64_t>(e / C) * N + c0 + e % C, &a, &b);
        tile[pad(e)] = a;
        tile[pad(e + 1)] = b;
      }
      __syncthreads();
      fft_forward<LOG2N, false, TILE>(tile, tw);
      const float* f = fp + sp * kPlane;
      for (int i = threadIdx.x; i < TILE / 2; i += kThreads) {
        const int e = 2 * i;
        const int64_t at = static_cast<int64_t>(e / C) * N + c0 + e % C;
        const float2 w = *reinterpret_cast<const float2*>(f + at);
        float2 a = tile[pad(e)];
        float2 b = tile[pad(e + 1)];
        a = make_float2(a.x * w.x, a.y * w.x);
        b = make_float2(b.x * w.y, b.y * w.y);
        if (sp > 0) {
          float2 pa, pb;
          load_pair(dst + at, &pa, &pb);
          a = cadd(a, pa);
          b = cadd(b, pb);
        }
        if (sp < nsp - 1) {
          store_pair(dst + at, a, b);
        } else {
          tile[pad(e)] = a;
          tile[pad(e + 1)] = b;
        }
      }
      __syncthreads();
    }
    fft_inverse<LOG2N, false, TILE>(tile, tw);
    for (int i = threadIdx.x; i < TILE / 2; i += kThreads) {
      const int e = 2 * i;
      store_pair(dst + static_cast<int64_t>(e / C) * N + c0 + e % C, tile[pad(e)],
                 tile[pad(e + 1)]);
    }
    __syncthreads();  // the next panel reuses the shared memory
  }
}

template <int LOG2N>
constexpr size_t vfused_smem_bytes() {
  return row_smem_bytes<LOG2N>() + sizeof(float) * kTile;
}

// Row 29: per row tile, V = Re(Fx^H(vx)) of the tile into shared memory
// (vx (N, N): V in x spectrum, natural y, from row 28), then for each of the
// nwaves waves a = Fx(exp(i sigma V) Fx^H(b)) (row_tile, src to dst; dst
// may be src).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
panel_vfused_row_kernel(const float2* __restrict__ vx, const float2* src, float2* dst,
                        float sigma, int64_t nwaves) {
  extern __shared__ float2 smem[];
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  float2* tile = smem;
  float2* tw = smem + kTilePadded;
  float* v = reinterpret_cast<float*>(tw + kTwiddlesOf<LOG2N>);
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < kTilesPerWave<LOG2N>; t += gridDim.x) {
    const int64_t r = t * kTile;
    for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
      float2 a, b;
      load_pair(vx + r + 2 * i, &a, &b);
      tile[pad(2 * i)] = a;
      tile[pad(2 * i + 1)] = b;
    }
    __syncthreads();
    fft_inverse<LOG2N, true>(tile, tw);
    for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
      *reinterpret_cast<float2*>(v + 2 * i) =
          make_float2(tile[pad(2 * i)].x, tile[pad(2 * i + 1)].x);
    }
    __syncthreads();
    for (int64_t b = 0; b < nwaves; ++b) {
      row_tile<LOG2N>(tile, tw, src + b * kPlane + r, dst + b * kPlane + r, v, sigma, true,
                      true);
    }
  }
}

// Launch a pass over ntiles tiles (grid-stride, at most kMaxBlocks blocks)
// with `bytes` of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel* kernel, int64_t ntiles, size_t bytes, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks_for(ntiles), kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int LOG2N, int MODE, bool ABS = false>
int launch_row(const float2* src, float2* dst, const float* vr, const float* vi, float2* s,
               int64_t s_wave_stride, float sigma, int64_t nwaves, cudaStream_t stream) {
  return launch(panel_row_kernel<LOG2N, MODE, ABS>, nwaves * kTilesPerWave<LOG2N>,
                row_smem_bytes<LOG2N>(), stream, src, dst, vr, vi, s, s_wave_stride, sigma,
                nwaves);
}

template <int LOG2N>
int launch_col(const float2* src, float2* dst, const float2* prop, int64_t p_wave_stride,
               bool conj_p, int64_t nwaves, cudaStream_t stream) {
  return launch(panel_col_kernel<LOG2N>, nwaves * ((1 << LOG2N) / kPanelCols<LOG2N>),
                col_smem_bytes<LOG2N>(), stream, src, dst, prop, p_wave_stride, conj_p, nwaves);
}

template <int LOG2N>
int launch_bwd_row(int mode, const float2* src, float2* dst, const float2* s,
                   int64_t s_wave_stride, const float* v, float* dv, float sigma, int64_t nwaves,
                   cudaStream_t stream) {
  constexpr int64_t kTiles = kTilesPerWave<LOG2N>;
  constexpr size_t kBytes = row_smem_bytes<LOG2N>();
  switch (mode) {
    case kBwdLoop:
      return launch(panel_bwd_row_kernel<LOG2N, kBwdLoop>, kTiles, kBytes, stream, src, dst, s,
                    s_wave_stride, v, dv, sigma, nwaves);
    case kBwdLast:
      return launch(panel_bwd_row_kernel<LOG2N, kBwdLast>, kTiles, kBytes, stream, src, dst, s,
                    s_wave_stride, v, dv, sigma, nwaves);
    case kBwdTail:
      return launch(panel_bwd_row_kernel<LOG2N, kBwdTail>, kTiles, kBytes, stream, src, dst, s,
                    s_wave_stride, v, dv, sigma, nwaves);
    default:
      return cudaErrorInvalidValue;
  }
}

// The whole rollout: init, (S - 1) x [column pass, row pass with V_j],
// column pass, final; every pass in place on out after the first.  STORE:
// the row passes also store s_j of wave b at s + b * S * N^2 + j * N^2.
template <int LOG2N, bool ABS, bool STORE = false>
int launch_scan(const float2* psi0, const float* vr, const float* vi, const float2* prop,
                float2* out, float2* s, float sigma, int64_t nwaves, int nslices,
                int64_t p_wave_stride, cudaStream_t stream) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int kFirst = STORE ? kInitStore : kInit;
  constexpr int kNext = STORE ? kMidStore : kMid;
  const int64_t s_stride = STORE ? nslices * kPlane : 0;
  int err = launch_row<LOG2N, kFirst, ABS>(psi0, out, vr, vi, s, s_stride, sigma, nwaves, stream);
  for (int64_t j = 1; err == cudaSuccess && j <= nslices; ++j) {
    err = launch_col<LOG2N>(out, out, prop, p_wave_stride, false, nwaves, stream);
    if (err != cudaSuccess) break;
    if (j < nslices) {
      err = launch_row<LOG2N, kNext, ABS>(out, out, vr + j * kPlane,
                                          ABS ? vi + j * kPlane : nullptr,
                                          STORE ? s + j * kPlane : nullptr, s_stride, sigma,
                                          nwaves, stream);
    } else {
      err = launch_row<LOG2N, kFinal>(out, out, nullptr, nullptr, nullptr, 0, sigma, nwaves,
                                      stream);
    }
  }
  return err;
}

// The reverse loop over the stored s (nwaves, S, N, N): seed, then per slice
// j = S-1 .. 0 a column pass with conj(P) and a backward row pass writing
// dV_j; every pass in place on dpsi, which ends as dpsi0.
template <int LOG2N>
int launch_scan_bwd(const float2* s, const float* v, const float2* prop, const float2* g,
                    float2* dpsi, float* dv, float sigma, int64_t nwaves, int nslices,
                    int64_t p_wave_stride, cudaStream_t stream) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  int err = launch_row<LOG2N, kFwd>(g, dpsi, nullptr, nullptr, nullptr, 0, sigma, nwaves, stream);
  for (int64_t j = nslices - 1; err == cudaSuccess && j >= 0; --j) {
    err = launch_col<LOG2N>(dpsi, dpsi, prop, p_wave_stride, true, nwaves, stream);
    if (err != cudaSuccess) break;
    err = launch_bwd_row<LOG2N>(j > 0 ? kBwdLoop : kBwdLast, dpsi, dpsi, s + j * kPlane,
                                nslices * kPlane, v + j * kPlane, dv + j * kPlane, sigma, nwaves,
                                stream);
  }
  return err;
}

// Registers, dynamic shared bytes, local bytes and resident blocks of a
// kernel launched with `bytes` of dynamic shared memory.
template <typename Kernel>
int info_of(Kernel* kernel, size_t bytes, int device, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(bytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm * sms;
  return err;
}

template <int LOG2N>
int kernel_info(int device, int which, int* out) {
  switch (which) {
    case 0:
      return info_of(panel_row_kernel<LOG2N, kMid, false>, row_smem_bytes<LOG2N>(), device, out);
    case 1:
      return info_of(panel_col_kernel<LOG2N>, col_smem_bytes<LOG2N>(), device, out);
    case 2:
      return info_of(panel_bwd_row_kernel<LOG2N, kBwdLoop>, row_smem_bytes<LOG2N>(), device, out);
    case 3:
      return info_of(panel_g_row_kernel<LOG2N>, row_smem_bytes<LOG2N>(), device, out);
    case 4:
      return info_of(panel_build_col_kernel<LOG2N>, col_smem_bytes<LOG2N>(), device, out);
    case 5:
      return info_of(panel_vfused_row_kernel<LOG2N>, vfused_smem_bytes<LOG2N>(), device, out);
    default:
      return cudaErrorInvalidValue;
  }
}

const float2* c2(const void* p) { return static_cast<const float2*>(p); }
const float* f1(const void* p) { return static_cast<const float*>(p); }
float2* o2(void* p) { return static_cast<float2*>(p); }
cudaStream_t st(void* p) { return static_cast<cudaStream_t>(p); }

}  // namespace

extern "C" {

const char* fdes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// psi (nwaves, n, n) -> a = Fx(t_0 psi), v0 (n, n) shared by the waves.
// s != nullptr: also s_0 = t_0 psi of wave b at s + b * s_wave_stride.
int fdes_panel_init_c64(int device, int n, const void* psi, const void* v0, void* out, void* s,
                        int64_t s_wave_stride, double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float f = static_cast<float>(sigma);
  if (s != nullptr) {
    FDES_DISPATCH_PANEL_N(n, (launch_row<L, kInitStore>(c2(psi), o2(out), f1(v0), nullptr, o2(s),
                                                        s_wave_stride, f, nwaves, st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kInit>(c2(psi), o2(out), f1(v0), nullptr, nullptr, 0, f,
                                                 nwaves, st(stream))))
}

// The same with the damped transmit of an absorptive potential vr0 + i vi0.
int fdes_panel_init_abs_c64(int device, int n, const void* psi, const void* vr0, const void* vi0,
                            void* out, double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kInit, true>(c2(psi), o2(out), f1(vr0), f1(vi0),
                                                      nullptr, 0, static_cast<float>(sigma),
                                                      nwaves, st(stream))))
}

// a (nwaves, n, n) -> b = Fy^H(P/n^2 * Fy(a)) (out may be a), or with
// conj(P) when conj_p; prop bit-reversed, (n, n) (p_wave_stride 0) or one
// per wave (n*n).
int fdes_panel_colpass_c64(int device, int n, const void* a, const void* prop, void* out,
                           int64_t p_wave_stride, int conj_p, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_col<L>(c2(a), o2(out), c2(prop), p_wave_stride, conj_p != 0,
                                         nwaves, st(stream)))
}

// b -> a = Fx(t_j Fx^H(b)), V_j = slice j of the (S, n, n) stack (or, with
// j = 0, one (n, n) plane).  s != nullptr: also s_j = t_j Fx^H(b) of wave b
// at s + b * s_wave_stride.
int fdes_panel_rowpass_stack_c64(int device, int n, int64_t j, const void* v_stack, const void* b,
                                 void* out, void* s, int64_t s_wave_stride, double sigma,
                                 int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* v = f1(v_stack) + j * static_cast<int64_t>(n) * n;
  const float f = static_cast<float>(sigma);
  if (s != nullptr) {
    FDES_DISPATCH_PANEL_N(n, (launch_row<L, kMidStore>(c2(b), o2(out), v, nullptr, o2(s),
                                                       s_wave_stride, f, nwaves, st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kMid>(c2(b), o2(out), v, nullptr, nullptr, 0, f, nwaves,
                                                st(stream))))
}

// The stack row pass with the damped transmit of slice j of vr + i vi.
int fdes_panel_rowpass_stack_abs_c64(int device, int n, int64_t j, const void* vr_stack,
                                     const void* vi_stack, const void* b, void* out, double sigma,
                                     int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t plane = static_cast<int64_t>(n) * n;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kMid, true>(c2(b), o2(out), f1(vr_stack) + j * plane,
                                                     f1(vi_stack) + j * plane, nullptr, 0,
                                                     static_cast<float>(sigma), nwaves,
                                                     st(stream))))
}

// b -> psi = Fx^H(b): the exit wave; or, forward != 0, a -> Fx(a): the
// adjoint's seed.
int fdes_panel_final_c64(int device, int n, const void* b, void* out, int forward, int64_t nwaves,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (forward) {
    FDES_DISPATCH_PANEL_N(n, (launch_row<L, kFwd>(c2(b), o2(out), nullptr, nullptr, nullptr, 0,
                                                  0.0f, nwaves, st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kFinal>(c2(b), o2(out), nullptr, nullptr, nullptr, 0,
                                                  0.0f, nwaves, st(stream))))
}

// A backward row pass (mode 0 kBwdLoop, 1 kBwdLast, 2 kBwdTail): bar
// (nwaves, n, n) -> out (may be bar), and dv (n, n) = sigma * sum over the
// waves of Im(bar_s * conj(s)); s (kBwdTail: psi) of wave b at
// s + b * s_wave_stride; v (n, n) shared by the waves.
int fdes_panel_bwd_row_c64(int device, int n, int mode, const void* bar, void* out, const void* s,
                           int64_t s_wave_stride, const void* v, void* dv, double sigma,
                           int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_bwd_row<L>(mode, c2(bar), o2(out), c2(s), s_wave_stride, f1(v),
                                             static_cast<float*>(dv), static_cast<float>(sigma),
                                             nwaves, st(stream)))
}

// The whole rollout of nslices >= 1 slices: psi0 (nwaves, n, n) -> out, V
// the real (S, n, n) stack vr (vi nullptr) or an absorptive vr + i vi.
int fdes_panel_scan_c64(int device, int n, const void* psi0, const void* vr, const void* vi,
                        const void* prop, void* out, double sigma, int64_t nwaves, int nslices,
                        int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  const float f = static_cast<float>(sigma);
  if (vi == nullptr) {
    FDES_DISPATCH_PANEL_N(n, (launch_scan<L, false>(c2(psi0), f1(vr), nullptr, c2(prop), o2(out),
                                                   nullptr, f, nwaves, nslices, p_wave_stride,
                                                   st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_scan<L, true>(c2(psi0), f1(vr), f1(vi), c2(prop), o2(out),
                                                nullptr, f, nwaves, nslices, p_wave_stride,
                                                st(stream))))
}

// The rollout under differentiation (a real V): as fdes_panel_scan_c64, and
// every s_j into s (nwaves, S, n, n).
int fdes_panel_scan_store_c64(int device, int n, const void* psi0, const void* v,
                              const void* prop, void* out, void* s, double sigma, int64_t nwaves,
                              int nslices, int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  FDES_DISPATCH_PANEL_N(n, (launch_scan<L, false, true>(c2(psi0), f1(v), nullptr, c2(prop),
                                                       o2(out), o2(s), static_cast<float>(sigma),
                                                       nwaves, nslices, p_wave_stride,
                                                       st(stream))))
}

// The reverse loop: g (nwaves, n, n) -> dpsi (nwaves, n, n) and dv (S, n, n)
// summed over the waves, from the s (nwaves, S, n, n) of the rollout.
int fdes_panel_scan_bwd_store_c64(int device, int n, const void* s, const void* v,
                                  const void* prop, const void* g, void* dpsi, void* dv,
                                  double sigma, int64_t nwaves, int nslices,
                                  int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  FDES_DISPATCH_PANEL_N(n, launch_scan_bwd<L>(c2(s), f1(v), c2(prop), c2(g), o2(dpsi),
                                              static_cast<float*>(dv), static_cast<float>(sigma),
                                              nwaves, nslices, p_wave_stride, st(stream)))
}

// Row 27: g (nplanes, n, n) float32 -> Fx(g) (nplanes, n, n) complex.
int fdes_panel_g_rowpass_c64(int device, int n, const void* g, void* out, int64_t nplanes,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch(panel_g_row_kernel<L>, nplanes * kTilesPerWave<L>,
                                  row_smem_bytes<L>(), st(stream), f1(g), o2(out), nplanes))
}

// Row 28: gx (nsp, n, n) -> out (n, n) = Fy^H(sum_s fp_s * Fy(gx_s)), fp the
// (nsp, n, n) real factor panels; out must not overlap gx or fp.
int fdes_panel_build_colpass_c64(int device, int n, const void* gx, const void* fp, void* out,
                                 int nsp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nsp < 1) return cudaErrorInvalidValue;
  FDES_DISPATCH_PANEL_N(n, launch(panel_build_col_kernel<L>, (1 << L) / kPanelCols<L>,
                                  col_smem_bytes<L>(), st(stream), c2(gx), f1(fp), o2(out), nsp))
}

// Row 29: b (nwaves, n, n) -> out = Fx(exp(i sigma V) Fx^H(b)) (out may be
// b), V = Re(Fx^H(vx)) of the (n, n) plane vx, shared by the waves.
int fdes_panel_vfused_rowpass_c64(int device, int n, const void* vx, const void* b, void* out,
                                  double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch(panel_vfused_row_kernel<L>, kTilesPerWave<L>,
                                  vfused_smem_bytes<L>(), st(stream), c2(vx), c2(b), o2(out),
                                  static_cast<float>(sigma), nwaves))
}

// out[0..3] = registers per thread, dynamic shared bytes, local bytes per
// thread and blocks resident at once on the device, of the row kernel
// (which 0), the column kernel (1), the backward row kernel (2), the g row
// kernel (3), the build column kernel (4) or the fused row kernel (5), for
// size n.
int fdes_panel_kernel_info(int device, int n, int which, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, kernel_info<L>(device, which, out))
}

}  // extern "C"
