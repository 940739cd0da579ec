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
//   panel_row_kernel<L, kInit, true, true>  _row_init_abs_kernel       (:150)
//   panel_row_kernel<L, kMid, true, true>   _row_mid_stack_abs_kernel  (:171)
//   panel_bwd_row_kernel<L, kBwdTail>       _row_bwd_tail_kernel       (:219)
//   panel_row_kernel<L, kInitStore, false>  _row_init_store_kernel     (:582)
//   panel_row_kernel<L, kMidStore, false>   _row_mid_store_kernel      (:603)
//   panel_col_kernel<L> (conj_p true)       _col_bwd_kernel            (:626)
//   panel_bwd_row_kernel<L, kBwdLoop>       _row_bwd_loop_kernel       (:650)
//   panel_bwd_row_kernel<L, kBwdLast>       _row_bwd_last_kernel       (:679)
//   panel_wide_g_row_kernel<L>              _row_g_kernel              (:1045)
//   panel_build_col_kernel<L>               _col_build_kernel          (:1058)
// and, redesigned for the H100 beside the first kernels of those rows,
//   panel_wide_col_kernel<L, C>             _col_kernel (:247) and _col_bwd_kernel (:626)
//   panel_wide_bwd_row_kernel<L, MODE>      _row_bwd_loop_kernel (:650), _row_bwd_last_kernel
//                                           (:679) and _row_bwd_tail_kernel (:219)
//   panel_wide_row_kernel<L, kMid>          _row_mid_stack_kernel      (:125)
//   panel_wide_row_kernel<L, kMidStore>     _row_mid_store_kernel      (:603)
//   panel_wide_col_kernel<L, C, kColBuild>  _col_build_kernel          (:1058) and
//   panel_wide_col_kernel<L, C, kColBuildSum>
//   panel_wide_row_kernel<L, kInitAbs>      _row_init_abs_kernel       (:150)
//   panel_wide_row_kernel<L, kMidAbs>       _row_mid_stack_abs_kernel  (:171)
//   panel_wide_row_kernel<L, kInit>         _row_init_kernel           (:82)
// (kernels/panel_scan.PANEL_ROUTE picks one kernel of each pair before the
// launch, by size and waves; the entry points take the choice as `route`),
// and with no tile kernel beside them (deleted once the wide one won every
// measured row)
//   panel_wide_row_kernel<L, kVfused>       _row_vfused_kernel         (:1086)
//   panel_wide_x_row_kernel<L, kFinal>      _row_final_kernel          (:194)
//   panel_wide_x_row_kernel<L, kFwd>        _row_fwd_kernel            (:206)
// and the whole loops _run_single / _run_single_abs (the rollout),
// _panel_loop_fwd and _panel_loop_bwd (the store-s gradient) and
// multislice_panel_streamed's scan (the streamed rollout, :1245-1255) as
// fdes_panel_scan_c64, fdes_panel_scan_store_c64,
// fdes_panel_scan_bwd_store_c64 and fdes_panel_streamed_c64, which issue
// every pass of a loop from C on the caller's stream.  The streamed
// rollout's scatter of atoms (fdes_tpu/potential.py scatter_slice_deltas, an
// XLA scatter-add there) is panel_scatter_kernel, behind a cudaMemsetAsync of
// the delta planes.
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
// absorptive potential V = Vr + i Vi (the damped transmit, full-precision
// sincosf and expf; V read in place as one complex64 plane), and Fx^H, Fy^H
// the unscaled inverse transforms: the 1/N^2 rides on the propagator, which
// the caller hands in bit-reversed order in both axes (P_br[a][b] =
// P[bitrev a][bitrev b]).  So b_j = Fx(psi_{j+1}) / N.  A slice
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
// the real per-species delta planes g_s of slice j (the scatter of its atoms,
// panel_scatter_kernel)
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
// in a row group's registers, keeps its real part there and carries the row
// of each wave through the inverse transform, transmit and forward
// transform, so V is transformed once per row for all the waves.
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
// The wide kernels (below, "the wide kernels") redo the column pass (bound
// 31 us at 2048^2, 120 us at 4096^2: 24 bytes a pixel) and the backward row
// pass (40 and 160 us: 32 bytes a pixel) on a transform held in registers.
// Against what held the tile kernels back: the 8 shared-memory round trips of
// a panel and its 9 block barriers become 2 exchanges a transform behind the
// group's own barriers, with the staged twiddle table (conflict-free reads);
// the column kernel's blocks stay resident (one an SM) and copy the next
// item into a second stage (cp.async) while they transform this one, and P
// is loaded with the item, not after the forward transform (but at 4096^2,
// where registers run out); the backward row kernel loads bar, s and V
// before the inverse transform, 256 contiguous bytes a warp instruction, and
// its 256-thread blocks (two row groups at 2048^2) walk over the rows, so a
// wave fills whole rounds of resident blocks but the last row of a group.
//
// The wide forward row kernel redoes the row pass with V_j (bound 25 us at
// 2048^2, 100 us at 4096^2: b and a of each wave and V once, 16 B + 4 B a
// pixel of one wave) and its store form (35 and 140 us: + 8 B of s_j a
// pixel).  The tile kernel ran them at 3.1x and 2.4x the bound: a block
// barrier after every radix-2 stage of both transforms, the transmit as a
// third sweep over the tile behind its own barrier, V loaded only after the
// inverse transform (beside sincosf, so the loads wait one behind the
// other), and V read and t formed once per wave.  Here a row is one group's
// registers from load to store, two exchanges a transform; V's row is
// loaded with b's, and t is formed once a row and kept through the waves
// (at 4096 points, where it would not fit in 128 registers beside the row,
// V is kept and t formed each wave); s_j is stored straight from the
// registers after the transmit in natural order (layout 1).  Two blocks an
// SM, so the barrier stalls of one group overlap another's loads.  b and a
// also move in layout 1: a load in layout 3 (16-byte vectors, no exchange
// before the inverse transform and after the forward one) was slower at
// 2048^2 in development runs.
//
// The streamed build's pair, rows 28 and 29, goes the same way (bounds 25
// and 30 us at 2048^2, 100 and 120 us at 4096^2; the tile kernels ran them at
// 3.8x and 3.6x).  Row 28 is a mode of the wide column kernel: an item of
// each species in turn copied ahead into the second stage, the factor read
// with the item (4 bytes a value, the rows of layout 3), and the species'
// products summed in registers, so the tile kernel's running sum in device
// memory (16 bytes a pixel a species past the first) goes; one inverse
// transform of the sum.  Row 29 is a mode of the wide forward row kernel:
// vx's row loaded with b's, through the exchange and the inverse x transform
// in the group's registers, its real part V kept in layout 1 (where b's row
// leaves its own inverse transform) and t formed from it once a row.  Its
// tile kernel (V's real part through a shared-memory tile) lost every
// measured row and was deleted.
//
// Row 27 (bound 15 us at 2048^2, 60 us at 4096^2: 4 bytes in and 8 out a
// pixel a species) is a sibling of the wide row kernel: the reals of a row
// loaded in layout 1, the transform in the group's registers, one exchange
// back to layout 1.  It replaced a kernel of shared-memory tiles that ran at
// 3.2x and 2.9x the bound (a block barrier after every radix-2 stage, a zero
// imaginary part written into the tile) and was slower at every measured
// size and species count.
//
// The absorptive row passes, rows 19 and 18 (bounds 30 us at 2048^2 and 120
// us at 4096^2: b and a of each wave 16 bytes a pixel, the complex V once 8),
// are the wide row kernel's modes kMidAbs and kInitAbs.  The tile kernels
// ran them at 2.7x and 2.2x the bound, behind the same block barriers as row
// 15's, and the wrapper first copied V's real and imaginary parts into two
// float32 stacks (16 GiB beside the 16 GiB complex stack at 2048^2 x 512).
// Here V is read in place: a group loads V_j's complex row (8 bytes a value,
// 256 contiguous bytes a warp instruction) with b's, forms t = exp(-sigma
// Vi) exp(i sigma Vr) once a row and keeps it in the registers kMid keeps V
// in; at 4096 points too, since (Vr, Vi) would take the same two registers a
// value.  kInitAbs transmits psi's row as it is loaded (natural order,
// layout 1) and runs the forward transform alone.
//
// The transform-only row passes, rows 17 and 20 (bound 20 us at 2048^2 and
// 80 us at 4096^2 a wave: 16 bytes a complex value, read once and written
// once), are panel_wide_x_row_kernel, a sibling of the g row kernel on
// complex rows.  The tile kernel ran them at 2.4x and 2.5x the bound, behind
// a block barrier after every radix-2 stage of a 4096-element tile, slower
// than cuFFT's batched 1-D transform of the same rows (1.5-1.8x on an H100
// 80GB HBM3 at 700 W) and than this kernel at every measured size and wave
// count.
//
// The init of a real V, row 13 (bound 25 us at 2048^2 and 100 us at 4096^2 a
// wave: psi and a 16 bytes a pixel a wave, V_0 4 bytes once), is the wide row
// kernel's mode kInit, kInitAbs without the damping.  The tile kernel ran it at
// 2.3x and 2.0x the bound (the transmit a sweep over the tile behind its own
// barrier, a block barrier after every radix-2 stage, V read and t formed once
// a wave), and it launches 2S times, with four waves, in a per-slice gradient
// of a tilt series.  Here a group loads psi's row in natural order (layout 1)
// with V_0's real row, forms t once a row and keeps it through the waves (at
// 4096 points V_0, as kMid), transmits the row as loaded and runs the forward
// transform alone.  kInitVc is the same with V_0 the real parts of a complex
// plane (the streamed rollout's init, its V_0 = Fx^H(vx) from the final pass).
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
// kInitStore, kMidStore as kInit, kMid, storing s = t psi on the way; the
// wide row kernel's kVfused as kMid with V built from its x spectrum,
// kInitAbs, kMidAbs as kInit, kMid with the damped transmit of a complex V,
// and kInitVc as kInit with V the real parts of a complex plane; the
// transform-only kernel's kFinal inverse x and kFwd forward x.
// Backward row passes (bwd_row_tile): kBwdLoop inverse x, dV, * conj(t),
// forward x; kBwdLast the same without the forward x; kBwdTail as kBwdLast
// with s formed from psi.
enum RowMode {
  kInit = 0, kMid = 1, kFinal = 2, kFwd = 3, kInitStore = 4, kMidStore = 5, kVfused = 6,
  kInitAbs = 7, kMidAbs = 8, kInitVc = 9
};
enum BwdMode { kBwdLoop = 0, kBwdLast = 1, kBwdTail = 2 };
// The wide column kernel's passes: kColProp the column pass with P (rows 14,
// 24); kColBuild row 28 of one species, kColBuildSum of several.
enum ColMode { kColProp = 0, kColBuild = 1, kColBuildSum = 2 };

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
// v: one (N, N) plane of potentials shared by the waves (the wrapper points
// it at slice j of a stack).  VC: v is a complex
// (N, N) plane (float2), its real parts the potentials (the streamed
// rollout's init from V_0 = Fx^H(vx)); with ABS an absorptive potential,
// its imaginary parts damping.  s: the store modes' s plane of wave 0,
// s_wave_stride elements to the next wave's.
template <int LOG2N, int MODE, bool ABS, bool VC = false>
__global__ void __launch_bounds__(kThreads)
panel_row_kernel(const float2* src, float2* dst, const float* __restrict__ v, float2* s,
                 int64_t s_wave_stride, float sigma, int64_t nwaves) {
  static_assert(MODE == kInit || MODE == kMid || MODE == kInitStore || MODE == kMidStore,
                "the tile row kernel runs rows 13, 15, 16, 18, 19, 22 and 23");
  constexpr bool kStore = MODE == kInitStore || MODE == kMidStore;
  constexpr bool kInverse = MODE == kMid || MODE == kMidStore;
  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* tw = smem + kTilePadded;
  constexpr int64_t kTiles = kTilesPerWave<LOG2N>;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kTiles; t += gridDim.x) {
    const int64_t r = (t % kTiles) * kTile;
    row_tile<LOG2N, kStore, ABS, VC>(tile, tw, src + t * kTile, dst + t * kTile,
                                     v + (VC ? 2 : 1) * r, sigma, kInverse, true, nullptr,
                                     kStore ? s + (t / kTiles) * s_wave_stride + r : nullptr);
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

// ---- the wide kernels: rows 14/24 and 25 (21, 26) redesigned -----------------
//
// The column pass and the backward row pass again, each 1-D transform held in
// the registers of a group of T = N/R threads (R values a thread: 8 up to 512
// points, 16 above; T = 32 to 256 threads, one to eight warps) from load to
// store.  A transform is three rounds of radix-2 stages in registers, each on
// the bits of the position that the thread's registers hold, with one
// exchange through the group's buffer in shared memory between rounds that
// hands each thread the next round's elements, behind named barriers of T
// threads: no shuffle stage and no block barrier inside a transform.  With L
// = log2 N, r = log2 R and b = L - 2r (1 to 4), position p lies at
//
//   layout 1  thread t, register m: p = t + T m             registers: bits L-r .. L-1
//   layout 2  t = lo + 2^b hi:      p = hi (N/R) + 2^b m + lo   bits b .. b+r-1
//   layout 3                        p = R t + m               bits 0 .. r-1
//
// The forward transform (decimation in frequency: natural in, bit-reversed
// out) runs round 1 on bits L-1 .. L-r in layout 1, round 2 on bits b+r-1 ..
// b in layout 2 and round 3 on bits b-1 .. 0 in layout 3; the inverse
// (decimation in time: bit-reversed in, natural out, unscaled) undoes them in
// reverse.  So position p holds frequency bitrev_N(p), the tile kernels'
// order: either kernel of a pass follows either kernel of the pass before, and
// prepare_propagator's P serves both.  Twiddles come from the staged table
// (init_staged_twiddles): a warp's round-1 reads are 32 adjacent entries,
// round 2's 2^b adjacent ones (broadcast to the lanes that share them), round
// 3's one entry.  The exchanges pad the buffer, p + 2^b (p >> (L - r))
// between layouts 1 and 2 and p + (p >> r) between layout 3 and the others,
// so that 16 lanes' 8-byte accesses fall on 16 bank pairs (layout 1's fall
// on 8 between layouts 1 and 3 at R = 8).
//
// The whole-loop adjoint's transform of a pair of warps (fused_fft.cuh, "the
// wide transform") runs its five lowest bits through __shfl_xor_sync stages
// and its highest across the warps through pairwise exchanges; extended to 4
// and 8 warps at 2048 and 4096 points, its exchanges, shuffles and twiddle
// reads come to about twice the shared-memory and shuffle traffic of this
// transform, which the panel kernels take instead.
template <int LOG2N>
struct Rounds {
  static constexpr int L = LOG2N;
  static constexpr int r = LOG2N <= 9 ? 3 : 4;  // log2 of the values a thread holds
  static constexpr int R = 1 << r;
  static constexpr int N = 1 << L;
  static constexpr int T = N / R;               // threads a transform
  static constexpr int b = L - 2 * r;           // bits of round 3
  static constexpr int kBuf = N + N / R;        // a group's padded exchange buffer
  static_assert(b >= 1 && b <= r && T >= 32, "three rounds of r bits cover 256 to 4096 points");
};

// A thread's place in its group: its index t (0 .. T - 1), the group's named
// barrier and its exchange buffer (Rounds::kBuf elements).
struct Group {
  int t;
  int bar;
  float2* buf;
};

// Position of register m of thread t in layout 1, 2 or 3.
template <int LOG2N, int LAYOUT>
__device__ __forceinline__ int rounds_pos(int t, int m) {
  using X = Rounds<LOG2N>;
  if (LAYOUT == 1) return t + X::T * m;
  if (LAYOUT == 2) return (t >> X::b) * (X::N / X::R) + (m << X::b) + (t & ((1 << X::b) - 1));
  return X::R * t + m;
}

// Place of position p in the buffer of an exchange between layouts A and B.
template <int LOG2N, int A, int B>
__device__ __forceinline__ int rounds_pad(int p) {
  using X = Rounds<LOG2N>;
  if ((A == 1 && B == 2) || (A == 2 && B == 1)) return p + ((p >> (X::L - X::r)) << X::b);
  return p + (p >> X::r);
}

template <int LOG2N>
__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(Rounds<LOG2N>::T) : "memory");
}

// x from layout FROM to layout TO through the group's buffer.
template <int LOG2N, int FROM, int TO>
__device__ __forceinline__ void rounds_exchange(float2 (&x)[Rounds<LOG2N>::R], const Group& g) {
  using X = Rounds<LOG2N>;
  group_sync<LOG2N>(g.bar);  // the buffer's last readers are done
#pragma unroll
  for (int m = 0; m < X::R; ++m) {
    g.buf[rounds_pad<LOG2N, FROM, TO>(rounds_pos<LOG2N, FROM>(g.t, m))] = x[m];
  }
  group_sync<LOG2N>(g.bar);
#pragma unroll
  for (int m = 0; m < X::R; ++m) {
    x[m] = g.buf[rounds_pad<LOG2N, FROM, TO>(rounds_pos<LOG2N, TO>(g.t, m))];
  }
}

// The radix-2 stage on register bit j (pairs m, m + d, d = 2^j) of a
// position bit of half size hs: the pair's offset in its half is base +
// stride (m mod d), its twiddle tw[hs - 1 + offset].  Forward a' = a + b, b'
// = (a - b) w; inverse t = b conj(w), a' = a + t, b' = a - t.
template <int R, bool INVERSE>
__device__ __forceinline__ void rounds_stage(float2 (&x)[R], const float2* tw, int d, int hs,
                                             int base, int stride) {
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (m & d) continue;
    const float2 w = tw[hs - 1 + base + stride * (m & (d - 1))];
    const float2 a = x[m];
    const float2 c = x[m + d];
    if (INVERSE) {
      const float2 u = cmul_conj(c, w);
      x[m] = cadd(a, u);
      x[m + d] = csub(a, u);
    } else {
      x[m] = cadd(a, c);
      x[m + d] = cmul(csub(a, c), w);
    }
  }
}

// Forward N-point transform of x: layout 1 natural in, layout 3 bit-reversed out.
template <int LOG2N>
__device__ __forceinline__ void rounds_forward(float2 (&x)[Rounds<LOG2N>::R], const float2* tw,
                                               const Group& g) {
  using X = Rounds<LOG2N>;
  constexpr int kLo = (1 << X::b) - 1;
#pragma unroll
  for (int j = X::r - 1; j >= 0; --j) {  // bit L - r + j: offset t + T (m mod d)
    rounds_stage<X::R, false>(x, tw, 1 << j, X::T << j, g.t, X::T);
  }
  rounds_exchange<LOG2N, 1, 2>(x, g);
#pragma unroll
  for (int j = X::r - 1; j >= 0; --j) {  // bit b + j: offset lo + 2^b (m mod d)
    rounds_stage<X::R, false>(x, tw, 1 << j, 1 << (X::b + j), g.t & kLo, 1 << X::b);
  }
  rounds_exchange<LOG2N, 2, 3>(x, g);
#pragma unroll
  for (int j = X::b - 1; j >= 0; --j) {  // bit j: offset m mod d
    rounds_stage<X::R, false>(x, tw, 1 << j, 1 << j, 0, 1);
  }
}

// Unscaled inverse of rounds_forward: layout 3 bit-reversed in, layout 1
// natural out.
template <int LOG2N>
__device__ __forceinline__ void rounds_inverse(float2 (&x)[Rounds<LOG2N>::R], const float2* tw,
                                               const Group& g) {
  using X = Rounds<LOG2N>;
  constexpr int kLo = (1 << X::b) - 1;
#pragma unroll
  for (int j = 0; j < X::b; ++j) rounds_stage<X::R, true>(x, tw, 1 << j, 1 << j, 0, 1);
  rounds_exchange<LOG2N, 3, 2>(x, g);
#pragma unroll
  for (int j = 0; j < X::r; ++j) {
    rounds_stage<X::R, true>(x, tw, 1 << j, 1 << (X::b + j), g.t & kLo, 1 << X::b);
  }
  rounds_exchange<LOG2N, 2, 1>(x, g);
#pragma unroll
  for (int j = 0; j < X::r; ++j) rounds_stage<X::R, true>(x, tw, 1 << j, X::T << j, g.t, X::T);
}

// Columns of a wide column item: 4 (a row of the item is one 32-byte sector)
// up to 2048, 2 at 4096, where two staged items of 4 columns (2 x 136 KiB
// with the groups' padding) do not fit in 227 KB beside the twiddles.
template <int LOG2N>
constexpr int kWideCols = LOG2N <= 11 ? 4 : 2;

// Threads of a wide column kernel's block (C groups) and of the wide backward
// row kernel's (256 / T row groups).
template <int LOG2N, int C>
constexpr int kWideColThreads = C * Rounds<LOG2N>::T;
constexpr int kWideRowThreads = 256;

// Dynamic shared memory of the column kernel: the staged twiddles (N - 1
// entries and one for 16-byte alignment), then two stages of C groups'
// padded buffers; a stage holds an item of C x N in its first C N places.
template <int LOG2N, int C>
constexpr size_t wide_col_smem_bytes() {
  return sizeof(float2) * ((1 << LOG2N) + size_t{2} * C * Rounds<LOG2N>::kBuf);
}

// Place of (row y, column c) of an item of C columns in its stage: row after
// row, as the rows lie in the plane (16-byte asynchronous copies), the two
// 16-byte halves of a 4-column row swapped on every other group of four rows,
// so that 16 lanes reading 16 rows of one column fall on 8 bank pairs, not 4.
template <int C>
__device__ __forceinline__ int stage_at(int y, int c) {
  return C == 4 ? 4 * y + (c ^ (((y >> 2) & 1) << 1)) : C * y + c;
}

// Start copying item `item` (wave item / (N/C), columns (item mod N/C) C ..
// + C - 1, every row) of the planes src into a stage, 16 bytes a copy;
// cp_async_wait_all and a block barrier make it visible.
template <int LOG2N, int C>
__device__ __forceinline__ void wide_col_fetch(float2* stage, const float2* src, int64_t item) {
  constexpr int N = 1 << LOG2N;
  constexpr int64_t kItems = N / C;
  constexpr int kChunks = C / 2;  // 16-byte chunks a row
  const float2* panel =
      src + (item / kItems) * (int64_t{1} << (2 * LOG2N)) + (item % kItems) * C;
  for (int i = threadIdx.x; i < N * kChunks; i += kWideColThreads<LOG2N, C>) {
    const int y = i / kChunks;
    const int c = 2 * (i % kChunks);
    cp_async16(stage + stage_at<C>(y, c), panel + static_cast<int64_t>(y) * N + c);
  }
}

// This thread's multipliers of a column item, at the rows of layout 3 of
// column pointer pc (P, complex) or fc (a build's real factor, into .x).
template <int LOG2N, bool REAL>
__device__ __forceinline__ void load_col_mult(float2 (&p)[Rounds<LOG2N>::R], const float2* pc,
                                              const float* fc, int t) {
#pragma unroll
  for (int m = 0; m < Rounds<LOG2N>::R; ++m) {
    const int64_t at = static_cast<int64_t>(rounds_pos<LOG2N, 3>(t, m)) << LOG2N;
    if (REAL) {
      p[m].x = __ldg(fc + at);
    } else {
      p[m] = __ldg(pc + at);
    }
  }
}

// Rows 14 and 24 redesigned (kColProp): the column pass b = Fy^H(P / N^2 *
// Fy(a)) (or with conj(P), conj_p) over every item of C adjacent columns of
// nplanes planes, group g of the block transforming column g of the item.
// Per item: this thread's values of P (the rows of layout 3) by __ldg, in
// flight with the item, except at 4096 points, where they would push the
// 512-thread block past its 128 registers into local memory and are loaded
// after the forward transform; the item from its stage into the groups'
// registers (layout 1); the forward y transform, the multiply, the inverse y
// transform, each group exchanging through its buffer in the stage; the item
// back to the stage in rows and out with 16-byte stores.  A block walks over
// items gridDim.x apart (gridDim.x = the resident blocks) and copies the next
// item into the other of two stages while it transforms this one.  src may be
// dst: a block reads an item before it writes it, and no other block touches
// it.
//
// Row 28 redesigned (kColBuild, kColBuildSum): the build column pass dst =
// Fy^H(sum_s F_s * Fy(gx_s)) of the nplanes species planes src = gx into one
// plane, fp the species' real factors; prop, p_wave_stride and conj_p unused.
// An output item takes the species' items in turn, each copied ahead like
// the column pass's next item, its factors (4 bytes a value) in flight with
// it; the products are summed in registers (kColBuildSum: acc), and the sum
// goes through the one inverse transform.  With several species the factors
// are loaded after the forward transform, as P at 4096 points: acc, the item
// and the factors would not fit in 128 registers together.
template <int LOG2N, int C, int MODE>
__global__ void __launch_bounds__(kWideColThreads<LOG2N, C>)
panel_wide_col_kernel(const float2* src, float2* dst, const float2* __restrict__ prop,
                      const float* __restrict__ fp, int64_t p_wave_stride, bool conj_p,
                      int64_t nplanes) {
  using X = Rounds<LOG2N>;
  constexpr int N = X::N;
  constexpr int R = X::R;
  constexpr int kBlock = kWideColThreads<LOG2N, C>;
  constexpr int kStage = C * X::kBuf;
  constexpr bool kBuild = MODE != kColProp;
  constexpr bool kLate = kBuild ? MODE == kColBuildSum : LOG2N == 12;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kItems = N / C;
  extern __shared__ float4 wide_smem[];
  float2* tw = reinterpret_cast<float2*>(wide_smem);
  float2* stages = tw + N;
  init_staged_twiddles<LOG2N, kBlock>(tw);
  const int col = threadIdx.x / X::T;
  Group g{static_cast<int>(threadIdx.x % X::T), 1 + col, nullptr};
  // output items, and the input items (species) each sums
  const int64_t items = kBuild ? kItems : nplanes * kItems;
  const int parts = kBuild ? static_cast<int>(nplanes) : 1;
  const float scale = 1.0f / (static_cast<float>(N) * static_cast<float>(N));
  const float sign = conj_p ? -scale : scale;
  int64_t item = blockIdx.x, next = 0;
  int part = 0, next_part = 0;
  if (item < items) wide_col_fetch<LOG2N, C>(stages, src, item);
  float2 acc[R];  // kColBuildSum: the sum over the species of this item so far
  for (int k = 0; item < items; ++k, item = next, part = next_part) {
    float2* stage = stages + ((k & 1) ? kStage : 0);
    const int64_t b = item / kItems;
    const int c0 = static_cast<int>(item % kItems) * C;
    const float2* pc = kBuild ? nullptr : prop + b * p_wave_stride + c0 + col;
    const float* fc = kBuild ? fp + part * kPlane + c0 + col : nullptr;
    float2 p[R];  // P, or the factor in .x
    // in flight with the item: a load after the transform waits a round trip
    if (!kLate) load_col_mult<LOG2N, kBuild>(p, pc, fc, g.t);
    cp_async_wait_all();
    __syncthreads();  // the item has landed; the other stage's readers are done
    const bool last = part == parts - 1;
    next = last ? item + gridDim.x : item;
    next_part = last ? 0 : part + 1;
    if (next < items) {
      wide_col_fetch<LOG2N, C>(stages + ((k & 1) ? 0 : kStage), src, next + next_part * kItems);
    }
    float2 x[R];
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = stage[stage_at<C>(rounds_pos<LOG2N, 1>(g.t, m), col)];
    __syncthreads();  // the item is in registers: the stage holds the groups' buffers
    g.buf = stage + col * X::kBuf;
    rounds_forward<LOG2N>(x, tw, g);
    if (kLate) load_col_mult<LOG2N, kBuild>(p, pc, fc, g.t);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (!kBuild) {
        x[m] = cmul(x[m], make_float2(p[m].x * scale, p[m].y * sign));
      } else if (MODE == kColBuild) {
        x[m] = make_float2(x[m].x * p[m].x, x[m].y * p[m].x);
      } else {
        const float2 z = make_float2(x[m].x * p[m].x, x[m].y * p[m].x);
        acc[m] = part == 0 ? z : cadd(acc[m], z);
      }
    }
    if (MODE == kColBuildSum) {
      if (!last) continue;
#pragma unroll
      for (int m = 0; m < R; ++m) x[m] = acc[m];
    }
    rounds_inverse<LOG2N>(x, tw, g);
    __syncthreads();  // every group's last exchange is read
#pragma unroll
    for (int m = 0; m < R; ++m) stage[stage_at<C>(rounds_pos<LOG2N, 1>(g.t, m), col)] = x[m];
    __syncthreads();
    float2* out = dst + b * kPlane + c0;
    for (int i = threadIdx.x; i < N * C / 2; i += kBlock) {
      const int y = i / (C / 2);
      const int c = 2 * (i % (C / 2));
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(y) * N + c) =
          *reinterpret_cast<const float4*>(stage + stage_at<C>(y, c));
    }
  }
}

// Row 25 redesigned (and with its other modes rows 26 and 21): the backward
// row pass of bwd_row_tile, one row a group.  A group takes rows gridDim.x
// apart (rows spread over the blocks first) and carries each through the
// nwaves waves in order: bar's row, s's row (kBwdTail: psi's) and V's row
// loaded into registers (layout 1, 256 contiguous bytes a warp instruction of
// bar and s) before the exchange to layout 3 and the inverse x transform;
// then Im(bar_s * conj(s)), times conj(t), the forward x transform and the
// exchange back (kBwdLoop), and the store, all in registers.  The row's dV sum
// waits in dv between waves (each thread reads back what it wrote), so no
// register holds it across a transform, and takes sigma after the last wave:
// the waves in a fixed order, no atomics, the same bits in two runs.
template <int LOG2N, int MODE>
__global__ void __launch_bounds__(kWideRowThreads)
panel_wide_bwd_row_kernel(const float2* src, float2* dst, const float2* s, int64_t s_wave_stride,
                          const float* __restrict__ v, float* dv, float sigma, int64_t nwaves) {
  using X = Rounds<LOG2N>;
  constexpr int N = X::N;
  constexpr int R = X::R;
  constexpr int kGroups = kWideRowThreads / X::T;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  extern __shared__ float4 wide_smem[];
  float2* tw = reinterpret_cast<float2*>(wide_smem);
  init_staged_twiddles<LOG2N, kWideRowThreads>(tw);
  __syncthreads();
  const int group = threadIdx.x / X::T;
  const Group g{static_cast<int>(threadIdx.x % X::T), 1 + group, tw + N + group * X::kBuf};
  const int64_t step = static_cast<int64_t>(gridDim.x) * kGroups;
  for (int64_t y = blockIdx.x + static_cast<int64_t>(group) * gridDim.x; y < N; y += step) {
    const int64_t r = y * N;
    float* dvr = dv + r;
    for (int64_t b = 0; b < nwaves; ++b) {
      float2 x[R];
      float2 u[R];
      float vv[R];
      const float2* xr = src + b * kPlane + r;
      const float2* sr = s + b * s_wave_stride + r;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int p = rounds_pos<LOG2N, 1>(g.t, m);
        x[m] = xr[p];
        u[m] = __ldg(sr + p);
        vv[m] = __ldg(v + r + p);
      }
      rounds_exchange<LOG2N, 1, 3>(x, g);
      rounds_inverse<LOG2N>(x, tw, g);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int p = rounds_pos<LOG2N, 1>(g.t, m);
        float sn, cs;
        sincosf(sigma * vv[m], &sn, &cs);
        if (MODE == kBwdTail) u[m] = cmul(u[m], make_float2(cs, sn));
        float acc = x[m].y * u[m].x - x[m].x * u[m].y;  // Im(bar_s * conj(s))
        if (b > 0) acc += dvr[p];
        dvr[p] = b == nwaves - 1 ? sigma * acc : acc;
        x[m] = cmul_conj(x[m], make_float2(cs, sn));
      }
      if (MODE == kBwdLoop) {
        rounds_forward<LOG2N>(x, tw, g);
        rounds_exchange<LOG2N, 3, 1>(x, g);
      }
      float2* out = dst + b * kPlane + r;
#pragma unroll
      for (int m = 0; m < R; ++m) out[rounds_pos<LOG2N, 1>(g.t, m)] = x[m];
    }
  }
}

// Dynamic shared memory of the wide row kernels (backward and forward): the
// staged twiddles and one padded exchange buffer a row group.
template <int LOG2N>
constexpr size_t wide_row_smem_bytes() {
  using X = Rounds<LOG2N>;
  return sizeof(float2) * (X::N + (kWideRowThreads / X::T) * X::kBuf);
}

// Rows 15 and 23 redesigned: the forward row pass a = Fx(t_j Fx^H(b)), t_j =
// exp(i sigma V_j), of kMid, and with kMidStore also s_j = t_j Fx^H(b), one
// row a group, the rows spread over the blocks as in the backward row kernel.
// A group loads V's row with wave 0's row of b (layout 1, 256 contiguous
// bytes a warp instruction), forms t = exp(i sigma V) once (full-precision
// sincosf) and carries it in registers through the nwaves waves of the row:
// per wave the exchange to layout 3, the inverse x transform, the transmit in
// layout 1 (kMidStore: s_j's row stored from there, natural order), the
// forward x transform, the exchange back and the store.  Two blocks an SM
// (128 registers a thread); at 4096 points, where t would not fit beside the
// row, the group keeps V and forms t again each wave.  src may be dst: a
// group reads a row before it writes it, and no other group touches that row.
//
// Row 29 redesigned (kVfused): the same pass with V = Re(Fx^H(vc)), vc (N, N)
// V's x spectrum from row 28 (bit-reversed x, natural y; v unused).  The
// group loads vc's row with wave 0's row of b (layout 1), takes it through the
// exchange to layout 3 and the inverse x transform in the registers t will
// hold, and keeps its real part in layout 1, the layout in which b's row
// leaves its own inverse transform, so V needs no exchange of its own; then
// as kMid.  vc is read and transformed once a row for all the waves.
//
// Rows 19 and 18 redesigned (kMidAbs, kInitAbs): the pass with the damped
// transmit t = exp(-sigma Vi) exp(i sigma Vr) of an absorptive potential, vc
// the complex (N, N) plane Vr + i Vi of slice j (v unused).  kMidAbs is kMid
// with V's complex row loaded with b's and t formed once a row at every size;
// kInitAbs (a = Fx(t_0 psi), src psi) skips the exchange and the inverse
// transform in front of the transmit.
//
// Row 13 redesigned (kInit, kInitVc): a = Fx(t_0 psi), src psi in natural
// order, as kInitAbs with t = exp(i sigma V_0), V_0 read from v (kInit) or as
// the real parts of the complex plane vc (kInitVc, v unused); t kept as in
// kMid (V_0 at 4096 points).
template <int LOG2N, int MODE>
__global__ void __launch_bounds__(kWideRowThreads, 2)
panel_wide_row_kernel(const float2* src, float2* dst, const float* __restrict__ v,
                      const float2* __restrict__ vc, float2* s, int64_t s_wave_stride, float sigma,
                      int64_t nwaves) {
  static_assert(MODE == kMid || MODE == kMidStore || MODE == kVfused || MODE == kInitAbs ||
                    MODE == kMidAbs || MODE == kInit || MODE == kInitVc,
                "the wide kernel runs rows 15, 23, 29, 19, 18 and 13");
  using X = Rounds<LOG2N>;
  constexpr int N = X::N;
  constexpr int R = X::R;
  constexpr int kGroups = kWideRowThreads / X::T;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr bool kAbs = MODE == kInitAbs || MODE == kMidAbs;
  // b arrives as an x spectrum; the inits take psi in natural order
  constexpr bool kInverse = MODE != kInitAbs && MODE != kInit && MODE != kInitVc;
  // V read from the complex plane vc
  constexpr bool kVc = MODE == kVfused || kAbs || MODE == kInitVc;
  // t takes two registers a value; a real V, kept in place of t at 4096
  // points, one
  constexpr bool kKeepT = LOG2N < 12 || kAbs;
  extern __shared__ float4 wide_smem[];
  float2* tw = reinterpret_cast<float2*>(wide_smem);
  init_staged_twiddles<LOG2N, kWideRowThreads>(tw);
  __syncthreads();
  const int group = threadIdx.x / X::T;
  const Group g{static_cast<int>(threadIdx.x % X::T), 1 + group, tw + N + group * X::kBuf};
  const int64_t step = static_cast<int64_t>(gridDim.x) * kGroups;
  for (int64_t y = blockIdx.x + static_cast<int64_t>(group) * gridDim.x; y < N; y += step) {
    const int64_t r = y * N;
    float2 x[R];
    // V in .x (kVfused: vc, then V = Re(Fx^H(vc)); kAbs: (Vr, Vi)), then t (kKeepT)
    float2 t[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int p = rounds_pos<LOG2N, 1>(g.t, m);
      x[m] = src[r + p];
      if (kVc) {
        t[m] = __ldg(vc + r + p);
      } else {
        t[m].x = __ldg(v + r + p);
      }
    }
    if (MODE == kVfused) {
      rounds_exchange<LOG2N, 1, 3>(t, g);
      rounds_inverse<LOG2N>(t, tw, g);
    }
    if (kKeepT) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float sn, cs;
        sincosf(sigma * t[m].x, &sn, &cs);
        if (kAbs) {
          const float d = expf(-sigma * t[m].y);
          sn *= d;
          cs *= d;
        }
        t[m] = make_float2(cs, sn);
      }
    }
    for (int64_t b = 0; b < nwaves; ++b) {
      if (b > 0) {
#pragma unroll
        for (int m = 0; m < R; ++m) x[m] = src[b * kPlane + r + rounds_pos<LOG2N, 1>(g.t, m)];
      }
      if (kInverse) {
        rounds_exchange<LOG2N, 1, 3>(x, g);
        rounds_inverse<LOG2N>(x, tw, g);
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float2 tm = t[m];
        if (!kKeepT) sincosf(sigma * t[m].x, &tm.y, &tm.x);
        x[m] = cmul(x[m], tm);
      }
      if (MODE == kMidStore) {
        float2* sr = s + b * s_wave_stride + r;
#pragma unroll
        for (int m = 0; m < R; ++m) sr[rounds_pos<LOG2N, 1>(g.t, m)] = x[m];
      }
      rounds_forward<LOG2N>(x, tw, g);
      rounds_exchange<LOG2N, 3, 1>(x, g);
      float2* out = dst + b * kPlane + r;
#pragma unroll
      for (int m = 0; m < R; ++m) out[rounds_pos<LOG2N, 1>(g.t, m)] = x[m];
    }
  }
}

// Row 27: the forward x transform of the real rows of nplanes (N, N)
// planes (the species' delta planes of one slice) into complex dst, x in
// bit-reversed order (the build column pass's input), one row a group,
// the rows of all the planes spread over the blocks as in the row kernels
// above.  A group holds its row's reals in layout 1 (4 bytes a value, 128
// contiguous bytes a warp instruction), sets the imaginary parts to 0 in
// registers, runs the forward transform and the exchange from layout 3 back
// to layout 1, and stores 8 bytes a value (256 contiguous bytes a warp
// instruction): one exchange past the transform's two, no transmit, no V.
// The reals of the group's next row are loaded before the transform of this
// one, so that their loads are in flight while it runs.
template <int LOG2N>
__global__ void __launch_bounds__(kWideRowThreads, 2)
panel_wide_g_row_kernel(const float* __restrict__ planes, float2* dst, int64_t nplanes) {
  using X = Rounds<LOG2N>;
  constexpr int N = X::N;
  constexpr int R = X::R;
  constexpr int kGroups = kWideRowThreads / X::T;
  extern __shared__ float4 wide_smem[];
  float2* tw = reinterpret_cast<float2*>(wide_smem);
  init_staged_twiddles<LOG2N, kWideRowThreads>(tw);
  __syncthreads();
  const int group = threadIdx.x / X::T;
  const Group g{static_cast<int>(threadIdx.x % X::T), 1 + group, tw + N + group * X::kBuf};
  const int64_t rows = nplanes * N;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kGroups;
  int64_t y = blockIdx.x + static_cast<int64_t>(group) * gridDim.x;
  float re[R];  // the reals of row y, loaded one iteration ahead
  if (y < rows) {
#pragma unroll
    for (int m = 0; m < R; ++m) re[m] = __ldg(planes + y * N + rounds_pos<LOG2N, 1>(g.t, m));
  }
  for (; y < rows; y += step) {
    float2 x[R];
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = make_float2(re[m], 0.0f);
    if (y + step < rows) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        re[m] = __ldg(planes + (y + step) * N + rounds_pos<LOG2N, 1>(g.t, m));
      }
    }
    rounds_forward<LOG2N>(x, tw, g);
    rounds_exchange<LOG2N, 3, 1>(x, g);
    float2* out = dst + y * N;
#pragma unroll
    for (int m = 0; m < R; ++m) out[rounds_pos<LOG2N, 1>(g.t, m)] = x[m];
  }
}

// Rows 17 and 20 (kFinal, kFwd): the transform-only row passes psi = Fx^H(b)
// (the exit wave; in the streamed rollout also slice 0's V) and Fx(g) (the
// adjoint's seed), one row a group, the rows of all nwaves planes one flat
// range (rows = nwaves N) spread over the blocks as in the g row kernel.  A
// group holds its row in layout 1 from load to store (256 contiguous bytes a
// warp instruction each way); kFwd runs the forward transform and the
// exchange from layout 3 back to layout 1, kFinal the exchange to layout 3
// and the inverse transform.  With no V, no t and no sincosf, the registers
// the row kernel spends on them hold the group's next row, loaded before
// this one's transform, so that its loads are in flight while it runs.  src
// may be dst: a group reads a row before it writes it, and no other group
// touches that row.
template <int LOG2N, int MODE>
__global__ void __launch_bounds__(kWideRowThreads, 2)
panel_wide_x_row_kernel(const float2* src, float2* dst, int64_t rows) {
  static_assert(MODE == kFwd || MODE == kFinal, "the transform-only kernel runs rows 20 and 17");
  using X = Rounds<LOG2N>;
  constexpr int N = X::N;
  constexpr int R = X::R;
  constexpr int kGroups = kWideRowThreads / X::T;
  extern __shared__ float4 wide_smem[];
  float2* tw = reinterpret_cast<float2*>(wide_smem);
  init_staged_twiddles<LOG2N, kWideRowThreads>(tw);
  __syncthreads();
  const int group = threadIdx.x / X::T;
  const Group g{static_cast<int>(threadIdx.x % X::T), 1 + group, tw + N + group * X::kBuf};
  const int64_t step = static_cast<int64_t>(gridDim.x) * kGroups;
  int64_t y = blockIdx.x + static_cast<int64_t>(group) * gridDim.x;
  float2 next[R];  // row y, loaded one iteration ahead
  if (y < rows) {
#pragma unroll
    for (int m = 0; m < R; ++m) next[m] = src[y * N + rounds_pos<LOG2N, 1>(g.t, m)];
  }
  for (; y < rows; y += step) {
    float2 x[R];
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = next[m];
    if (y + step < rows) {
#pragma unroll
      for (int m = 0; m < R; ++m) next[m] = src[(y + step) * N + rounds_pos<LOG2N, 1>(g.t, m)];
    }
    if (MODE == kFwd) {
      rounds_forward<LOG2N>(x, tw, g);
      rounds_exchange<LOG2N, 3, 1>(x, g);
    } else {
      rounds_exchange<LOG2N, 1, 3>(x, g);
      rounds_inverse<LOG2N>(x, tw, g);
    }
    float2* out = dst + y * N;
#pragma unroll
    for (int m = 0; m < R; ++m) out[rounds_pos<LOG2N, 1>(g.t, m)] = x[m];
  }
}

// The streamed build's scatter: g[idx[k]] += val[k] for the count corners of
// one slice (the atoms' bilinear corners, potential.bilinear_corners), one
// thread a corner, by atomicAdd into g, which the caller zeroes first
// (cudaMemsetAsync).  Corners that meet on a pixel add in no fixed order.
// An index outside the g_elems of g (a species index past the planes: the
// corners wrap in x and y) is not written: it sets g[0] to NaN, so that the
// planes and every pass after them come out NaN, checked on the card with
// no synchronisation of the host.
// Bound: the zeroed planes (4 bytes a pixel a species) and 12 bytes a corner.
__global__ void __launch_bounds__(kThreads)
panel_scatter_kernel(const int64_t* __restrict__ idx, const float* __restrict__ val, float* g,
                     int64_t count, int64_t g_elems) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; k < count;
       k += stride) {
    const int64_t i = __ldg(idx + k);
    if (i >= 0 && i < g_elems) {
      atomicAdd(g + i, __ldg(val + k));
    } else {
      atomicExch(g, __int_as_float(0x7fc00000));  // a quiet NaN; NaN + x stays NaN
    }
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

template <int LOG2N, int MODE, bool ABS = false, bool VC = false>
int launch_row(const float2* src, float2* dst, const float* v, float2* s, int64_t s_wave_stride,
               float sigma, int64_t nwaves, cudaStream_t stream) {
  return launch(panel_row_kernel<LOG2N, MODE, ABS, VC>, nwaves * kTilesPerWave<LOG2N>,
                row_smem_bytes<LOG2N>(), stream, src, dst, v, s, s_wave_stride, sigma, nwaves);
}

template <int LOG2N>
int launch_col(const float2* src, float2* dst, const float2* prop, int64_t p_wave_stride,
               bool conj_p, int64_t nwaves, cudaStream_t stream) {
  return launch(panel_col_kernel<LOG2N>, nwaves * ((1 << LOG2N) / kPanelCols<LOG2N>),
                col_smem_bytes<LOG2N>(), stream, src, dst, prop, p_wave_stride, conj_p, nwaves);
}

// Blocks of `kernel` (`threads` a block, `bytes` of dynamic shared memory)
// resident at once on the current device.
int resident_blocks_here(const void* kernel, int threads, size_t bytes, int* blocks) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return resident_blocks_of(kernel, device, blocks, threads, bytes);
}

// A wide column kernel's pass (MODE: ColMode): one block a resident slot, at
// most one an output item; nplanes the waves (kColProp) or the species.
template <int LOG2N, int MODE = kColProp>
int launch_wide_col(const float2* src, float2* dst, const float2* prop, const float* fp,
                    int64_t p_wave_stride, bool conj_p, int64_t nplanes, cudaStream_t stream) {
  constexpr int C = kWideCols<LOG2N>;
  auto* kernel = panel_wide_col_kernel<LOG2N, C, MODE>;
  constexpr int kBlock = kWideColThreads<LOG2N, C>;
  constexpr size_t kBytes = wide_col_smem_bytes<LOG2N, C>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = static_cast<cudaError_t>(
      resident_blocks_here(reinterpret_cast<const void*>(kernel), kBlock, kBytes, &resident));
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  const int64_t items = (MODE == kColProp ? nplanes : 1) * ((1 << LOG2N) / C);
  const int blocks = static_cast<int>(items < resident ? items : resident);
  kernel<<<blocks, kBlock, kBytes, stream>>>(src, dst, prop, fp, p_wave_stride, conj_p, nplanes);
  return cudaGetLastError();
}

// The routes of the routed passes (PANEL_ROUTE in kernels/panel_scan.py): the
// tile kernel or the wide kernel.
enum Route { kRouteTile = 0, kRouteWide = 1 };

template <int LOG2N>
int launch_col_route(int route, const float2* src, float2* dst, const float2* prop,
                     int64_t p_wave_stride, bool conj_p, int64_t nwaves, cudaStream_t stream) {
  switch (route) {
    case kRouteTile:
      return launch_col<LOG2N>(src, dst, prop, p_wave_stride, conj_p, nwaves, stream);
    case kRouteWide:
      return launch_wide_col<LOG2N>(src, dst, prop, nullptr, p_wave_stride, conj_p, nwaves,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks of a wide row kernel's launch over `rows` rows (backward or forward;
// N, one plane, by default): every resident block, at most one a row group;
// sets the kernel's shared-memory attribute.
template <int LOG2N, typename Kernel>
int wide_row_blocks(Kernel* kernel, int* blocks, int64_t rows = int64_t{1} << LOG2N) {
  constexpr size_t kBytes = wide_row_smem_bytes<LOG2N>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = static_cast<cudaError_t>(resident_blocks_here(reinterpret_cast<const void*>(kernel),
                                                      kWideRowThreads, kBytes, &resident));
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  constexpr int kGroups = kWideRowThreads / Rounds<LOG2N>::T;
  const int64_t items = (rows + kGroups - 1) / kGroups;
  *blocks = static_cast<int>(items < resident ? items : resident);
  return cudaSuccess;
}

template <int LOG2N, int MODE>
int launch_wide_bwd_row_m(const float2* src, float2* dst, const float2* s, int64_t s_wave_stride,
                          const float* v, float* dv, float sigma, int64_t nwaves,
                          cudaStream_t stream) {
  auto* kernel = panel_wide_bwd_row_kernel<LOG2N, MODE>;
  int blocks = 0;
  const int err = wide_row_blocks<LOG2N>(kernel, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWideRowThreads, wide_row_smem_bytes<LOG2N>(), stream>>>(
      src, dst, s, s_wave_stride, v, dv, sigma, nwaves);
  return cudaGetLastError();
}

template <int LOG2N, int MODE>
int launch_wide_row(const float2* src, float2* dst, const float* v, const float2* vc, float2* s,
                    int64_t s_wave_stride, float sigma, int64_t nwaves, cudaStream_t stream) {
  auto* kernel = panel_wide_row_kernel<LOG2N, MODE>;
  int blocks = 0;
  const int err = wide_row_blocks<LOG2N>(kernel, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWideRowThreads, wide_row_smem_bytes<LOG2N>(), stream>>>(
      src, dst, v, vc, s, s_wave_stride, sigma, nwaves);
  return cudaGetLastError();
}

// A forward row pass with V_j (kMid, or kMidStore with s) on its route.
template <int LOG2N, int MODE>
int launch_row_route(int route, const float2* src, float2* dst, const float* v, float2* s,
                     int64_t s_wave_stride, float sigma, int64_t nwaves, cudaStream_t stream) {
  switch (route) {
    case kRouteTile:
      return launch_row<LOG2N, MODE>(src, dst, v, s, s_wave_stride, sigma, nwaves, stream);
    case kRouteWide:
      return launch_wide_row<LOG2N, MODE>(src, dst, v, nullptr, s, s_wave_stride, sigma, nwaves,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Row 28 on its route: the tile kernel, or the wide column kernel's build
// mode (one species, or the sum of several).
template <int LOG2N>
int launch_build_col_route(int route, const float2* gx, const float* fp, float2* out, int nsp,
                           cudaStream_t stream) {
  switch (route) {
    case kRouteTile:
      return launch(panel_build_col_kernel<LOG2N>, (1 << LOG2N) / kPanelCols<LOG2N>,
                    col_smem_bytes<LOG2N>(), stream, gx, fp, out, nsp);
    case kRouteWide:
      if (nsp == 1) {
        return launch_wide_col<LOG2N, kColBuild>(gx, out, nullptr, fp, 0, false, 1, stream);
      }
      return launch_wide_col<LOG2N, kColBuildSum>(gx, out, nullptr, fp, 0, false, nsp, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// An absorptive row pass (kInit: row 18, a = Fx(t_0 psi); kMid: row 19) on
// its route, vc the complex (N, N) plane Vr + i Vi: the tile kernel reading
// it as a complex plane, or the wide row kernel's kInitAbs / kMidAbs.
template <int LOG2N, int MODE>
int launch_row_abs_route(int route, const float2* src, float2* dst, const float2* vc,
                         float sigma, int64_t nwaves, cudaStream_t stream) {
  static_assert(MODE == kInit || MODE == kMid, "rows 18 and 19");
  switch (route) {
    case kRouteTile:
      return launch_row<LOG2N, MODE, true, true>(src, dst, reinterpret_cast<const float*>(vc),
                                                 nullptr, 0, sigma, nwaves, stream);
    case kRouteWide:
      return launch_wide_row<LOG2N, MODE == kInit ? kInitAbs : kMidAbs>(
          src, dst, nullptr, vc, nullptr, 0, sigma, nwaves, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Row 13 (a = Fx(t_0 psi), a real V_0 shared by the waves) on its route: the
// tile kernel or the wide row kernel's kInit; with VC, v the complex (N, N)
// plane whose real parts are V_0 (the streamed rollout's init: the tile
// kernel's VC form or kInitVc).
template <int LOG2N, bool VC = false>
int launch_init_route(int route, const float2* src, float2* dst, const void* v, float sigma,
                      int64_t nwaves, cudaStream_t stream) {
  switch (route) {
    case kRouteTile:
      return launch_row<LOG2N, kInit, false, VC>(src, dst, static_cast<const float*>(v), nullptr,
                                                 0, sigma, nwaves, stream);
    case kRouteWide:
      return launch_wide_row<LOG2N, VC ? kInitVc : kInit>(
          src, dst, VC ? nullptr : static_cast<const float*>(v),
          VC ? static_cast<const float2*>(v) : nullptr, nullptr, 0, sigma, nwaves, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Row 29: the wide row kernel's kVfused, V = Re(Fx^H(vx)).
template <int LOG2N>
int launch_vfused(const float2* vx, const float2* src, float2* dst, float sigma, int64_t nwaves,
                  cudaStream_t stream) {
  return launch_wide_row<LOG2N, kVfused>(src, dst, nullptr, vx, nullptr, 0, sigma, nwaves,
                                         stream);
}

// Row 27: the g row kernel over the rows of all nplanes planes.
template <int LOG2N>
int launch_g_row(const float* g, float2* out, int64_t nplanes, cudaStream_t stream) {
  auto* kernel = panel_wide_g_row_kernel<LOG2N>;
  int blocks = 0;
  const int err = wide_row_blocks<LOG2N>(kernel, &blocks, nplanes << LOG2N);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWideRowThreads, wide_row_smem_bytes<LOG2N>(), stream>>>(g, out, nplanes);
  return cudaGetLastError();
}

// Rows 17 and 20: the transform-only kernel over the rows of nwaves planes.
template <int LOG2N, int MODE>
int launch_x_row(const float2* src, float2* dst, int64_t nwaves, cudaStream_t stream) {
  auto* kernel = panel_wide_x_row_kernel<LOG2N, MODE>;
  const int64_t rows = nwaves << LOG2N;
  int blocks = 0;
  const int err = wide_row_blocks<LOG2N>(kernel, &blocks, rows);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWideRowThreads, wide_row_smem_bytes<LOG2N>(), stream>>>(src, dst, rows);
  return cudaGetLastError();
}

// The scatter of one slice: g (g_elems floats) zeroed, then count corners
// added (at least one block, so that every call launches the kernel once).
int launch_scatter(const int64_t* idx, const float* val, int64_t count, float* g, int64_t g_elems,
                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(g, 0, g_elems * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const int blocks = count > 0 ? blocks_for((count + kThreads - 1) / kThreads) : 1;
  panel_scatter_kernel<<<blocks, kThreads, 0, stream>>>(idx, val, g, count, g_elems);
  return cudaGetLastError();
}

template <int LOG2N>
int launch_bwd_row(int mode, int route, const float2* src, float2* dst, const float2* s,
                   int64_t s_wave_stride, const float* v, float* dv, float sigma, int64_t nwaves,
                   cudaStream_t stream) {
  constexpr int64_t kTiles = kTilesPerWave<LOG2N>;
  constexpr size_t kBytes = row_smem_bytes<LOG2N>();
  if (route == kRouteWide) {
    switch (mode) {
      case kBwdLoop:
        return launch_wide_bwd_row_m<LOG2N, kBwdLoop>(src, dst, s, s_wave_stride, v, dv, sigma,
                                                      nwaves, stream);
      case kBwdLast:
        return launch_wide_bwd_row_m<LOG2N, kBwdLast>(src, dst, s, s_wave_stride, v, dv, sigma,
                                                      nwaves, stream);
      case kBwdTail:
        return launch_wide_bwd_row_m<LOG2N, kBwdTail>(src, dst, s, s_wave_stride, v, dv, sigma,
                                                      nwaves, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (route != kRouteTile) return cudaErrorInvalidValue;
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
// column pass, final; every pass in place on out after the first.  v: the
// real (S, N, N) stack, or with ABS the complex one (float2, read in place).
// STORE (a real V): the row passes also store s_j of wave b at s + b * S *
// N^2 + j * N^2.  col_route, row_route, init_route: the column passes', the
// row passes' with V_j and the init's kernels (Route); with ABS row_route
// also runs the init; STORE's init (row 22) has one kernel.
template <int LOG2N, bool ABS, bool STORE = false>
int launch_scan(const float2* psi0, const void* v, const float2* prop, float2* out, float2* s,
                float sigma, int64_t nwaves, int nslices, int64_t p_wave_stride, int col_route,
                int row_route, int init_route, cudaStream_t stream) {
  static_assert(!(ABS && STORE), "the store pair takes a real V");
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int kNext = STORE ? kMidStore : kMid;
  [[maybe_unused]] const float* vr = static_cast<const float*>(v);
  [[maybe_unused]] const float2* vc = static_cast<const float2*>(v);
  const int64_t s_stride = STORE ? nslices * kPlane : 0;
  int err;
  if constexpr (ABS) {
    err = launch_row_abs_route<LOG2N, kInit>(row_route, psi0, out, vc, sigma, nwaves, stream);
  } else if constexpr (STORE) {
    err = launch_row<LOG2N, kInitStore>(psi0, out, vr, s, s_stride, sigma, nwaves, stream);
  } else {
    err = launch_init_route<LOG2N>(init_route, psi0, out, v, sigma, nwaves, stream);
  }
  for (int64_t j = 1; err == cudaSuccess && j <= nslices; ++j) {
    err = launch_col_route<LOG2N>(col_route, out, out, prop, p_wave_stride, false, nwaves,
                                  stream);
    if (err != cudaSuccess) break;
    if (j < nslices) {
      float2* sj = STORE ? s + j * kPlane : nullptr;
      if constexpr (ABS) {
        err = launch_row_abs_route<LOG2N, kMid>(row_route, out, out, vc + j * kPlane, sigma,
                                                nwaves, stream);
      } else {
        err = launch_row_route<LOG2N, kNext>(row_route, out, out, vr + j * kPlane, sj, s_stride,
                                             sigma, nwaves, stream);
      }
    } else {
      err = launch_x_row<LOG2N, kFinal>(out, out, nwaves, stream);
    }
  }
  return err;
}

// The reverse loop over the stored s (nwaves, S, N, N): seed, then per slice
// j = S-1 .. 0 a column pass with conj(P) and a backward row pass writing
// dV_j; every pass in place on dpsi, which ends as dpsi0.  col_route,
// row_route: the column and backward row passes' kernels.
template <int LOG2N>
int launch_scan_bwd(const float2* s, const float* v, const float2* prop, const float2* g,
                    float2* dpsi, float* dv, float sigma, int64_t nwaves, int nslices,
                    int64_t p_wave_stride, int col_route, int row_route, cudaStream_t stream) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  int err = launch_x_row<LOG2N, kFwd>(g, dpsi, nwaves, stream);
  for (int64_t j = nslices - 1; err == cudaSuccess && j >= 0; --j) {
    err = launch_col_route<LOG2N>(col_route, dpsi, dpsi, prop, p_wave_stride, true, nwaves,
                                  stream);
    if (err != cudaSuccess) break;
    err = launch_bwd_row<LOG2N>(j > 0 ? kBwdLoop : kBwdLast, row_route, dpsi, dpsi,
                                s + j * kPlane,
                                nslices * kPlane, v + j * kPlane, dv + j * kPlane, sigma, nwaves,
                                stream);
  }
  return err;
}

// The streamed rollout (panel_streamed, a real V): per slice j the scatter of
// its corners (idx, val + j * corners) into the nsp delta planes g, row 27
// into gx, row 28 into vx; slice 0's V_0 = Re(Fx^H(vx)) as a final row pass
// into gx's first plane and the init reading its real parts; for j > 0 the
// column pass and row 29 (the vx of slice j), every pass in place on out;
// then the closing column pass and final.  The routes: row 28's, the
// column pass's and the init's kernels (Route).
template <int LOG2N>
int launch_streamed(const float2* psi0, const int64_t* idx, const float* val, int64_t corners,
                    int nslices, const float* fp, int nsp, const float2* prop, float2* out,
                    float* g, float2* gx, float2* vx, float sigma, int64_t nwaves,
                    int64_t p_wave_stride, int build_route, int col_route, int init_route,
                    cudaStream_t stream) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  auto build = [&](int64_t j) {
    int err = launch_scatter(idx + j * corners, val + j * corners, corners, g, nsp * kPlane,
                             stream);
    if (err == cudaSuccess) err = launch_g_row<LOG2N>(g, gx, nsp, stream);
    if (err == cudaSuccess) {
      err = launch_build_col_route<LOG2N>(build_route, gx, fp, vx, nsp, stream);
    }
    return err;
  };
  int err = build(0);
  if (err == cudaSuccess) err = launch_x_row<LOG2N, kFinal>(vx, gx, 1, stream);
  if (err == cudaSuccess) {
    err = launch_init_route<LOG2N, true>(init_route, psi0, out, gx, sigma, nwaves, stream);
  }
  for (int64_t j = 1; err == cudaSuccess && j < nslices; ++j) {
    err = launch_col_route<LOG2N>(col_route, out, out, prop, p_wave_stride, false, nwaves,
                                  stream);
    if (err == cudaSuccess) err = build(j);
    if (err == cudaSuccess) {
      err = launch_vfused<LOG2N>(vx, out, out, sigma, nwaves, stream);
    }
  }
  if (err == cudaSuccess) {
    err = launch_col_route<LOG2N>(col_route, out, out, prop, p_wave_stride, false, nwaves,
                                  stream);
  }
  if (err == cudaSuccess) err = launch_x_row<LOG2N, kFinal>(out, out, nwaves, stream);
  return err;
}

// Registers, dynamic shared bytes, local bytes and resident blocks of a
// kernel launched with `threads` a block and `bytes` of dynamic shared memory.
template <typename Kernel>
int info_of(Kernel* kernel, size_t bytes, int device, int* out, int threads = kThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(bytes);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return resident_blocks_of(reinterpret_cast<const void*>(kernel), device, &out[3], threads,
                            bytes);
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
      return info_of(panel_row_kernel<LOG2N, kMid, true, true>, row_smem_bytes<LOG2N>(), device,
                     out);
    case 4:
      return info_of(panel_build_col_kernel<LOG2N>, col_smem_bytes<LOG2N>(), device, out);
    case 6:
      return info_of(panel_wide_col_kernel<LOG2N, kWideCols<LOG2N>, kColProp>,
                     wide_col_smem_bytes<LOG2N, kWideCols<LOG2N>>(), device, out,
                     kWideColThreads<LOG2N, kWideCols<LOG2N>>);
    case 7:
      return info_of(panel_wide_bwd_row_kernel<LOG2N, kBwdLoop>, wide_row_smem_bytes<LOG2N>(),
                     device, out, kWideRowThreads);
    case 8:
      return info_of(panel_wide_row_kernel<LOG2N, kMid>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
    case 9:
      return info_of(panel_wide_row_kernel<LOG2N, kMidStore>, wide_row_smem_bytes<LOG2N>(),
                     device, out, kWideRowThreads);
    case 10:
      return info_of(panel_wide_col_kernel<LOG2N, kWideCols<LOG2N>, kColBuild>,
                     wide_col_smem_bytes<LOG2N, kWideCols<LOG2N>>(), device, out,
                     kWideColThreads<LOG2N, kWideCols<LOG2N>>);
    case 11:
      return info_of(panel_wide_row_kernel<LOG2N, kVfused>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
    case 12:
      return info_of(panel_wide_col_kernel<LOG2N, kWideCols<LOG2N>, kColBuildSum>,
                     wide_col_smem_bytes<LOG2N, kWideCols<LOG2N>>(), device, out,
                     kWideColThreads<LOG2N, kWideCols<LOG2N>>);
    case 13:
      return info_of(panel_wide_g_row_kernel<LOG2N>, wide_row_smem_bytes<LOG2N>(), device, out,
                     kWideRowThreads);
    case 14:
      return info_of(panel_wide_row_kernel<LOG2N, kMidAbs>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
    case 15:
      return info_of(panel_wide_row_kernel<LOG2N, kInitAbs>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
    case 16:
      return info_of(panel_wide_x_row_kernel<LOG2N, kFinal>, wide_row_smem_bytes<LOG2N>(),
                     device, out, kWideRowThreads);
    case 17:
      return info_of(panel_wide_x_row_kernel<LOG2N, kFwd>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
    case 18:
      return info_of(panel_wide_row_kernel<LOG2N, kInit>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
    case 19:
      return info_of(panel_wide_row_kernel<LOG2N, kInitVc>, wide_row_smem_bytes<LOG2N>(), device,
                     out, kWideRowThreads);
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

// psi (nwaves, n, n) -> a = Fx(t_0 psi), v0 (n, n) shared by the waves: real
// float32, or with v0_complex != 0 the real parts of a complex64 plane; route:
// the kernel (Route: 0 tile, 1 wide).  s != nullptr: also s_0 = t_0 psi of
// wave b at s + b * s_wave_stride, on the one kernel of row 22 (a real v0,
// route unused).
int fdes_panel_init_c64(int device, int n, const void* psi, const void* v0, int v0_complex,
                        void* out, void* s, int64_t s_wave_stride, double sigma, int64_t nwaves,
                        int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float f = static_cast<float>(sigma);
  if (s != nullptr) {
    if (v0_complex) return cudaErrorInvalidValue;
    FDES_DISPATCH_PANEL_N(n, (launch_row<L, kInitStore>(c2(psi), o2(out), f1(v0), o2(s),
                                                        s_wave_stride, f, nwaves, st(stream))))
  }
  if (v0_complex) {
    FDES_DISPATCH_PANEL_N(n, (launch_init_route<L, true>(route, c2(psi), o2(out), v0, f, nwaves,
                                                         st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_init_route<L>(route, c2(psi), o2(out), v0, f, nwaves,
                                                 st(stream))))
}

// The same with the damped transmit of an absorptive potential, v0 its
// complex (n, n) plane Vr + i Vi; route: the kernel (Route: 0 tile, 1 wide).
int fdes_panel_init_abs_c64(int device, int n, const void* psi, const void* v0, void* out,
                            double sigma, int64_t nwaves, int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, (launch_row_abs_route<L, kInit>(route, c2(psi), o2(out), c2(v0),
                                                           static_cast<float>(sigma), nwaves,
                                                           st(stream))))
}

// a (nwaves, n, n) -> b = Fy^H(P/n^2 * Fy(a)) (out may be a), or with
// conj(P) when conj_p; prop bit-reversed, (n, n) (p_wave_stride 0) or one
// per wave (n*n); route: the kernel (Route: 0 tile, 1 wide).
int fdes_panel_colpass_c64(int device, int n, const void* a, const void* prop, void* out,
                           int64_t p_wave_stride, int conj_p, int64_t nwaves, int route,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_col_route<L>(route, c2(a), o2(out), c2(prop), p_wave_stride,
                                               conj_p != 0, nwaves, st(stream)))
}

// b -> a = Fx(t_j Fx^H(b)), V_j = slice j of the (S, n, n) stack (or, with
// j = 0, one (n, n) plane).  s != nullptr: also s_j = t_j Fx^H(b) of wave b
// at s + b * s_wave_stride.  route: the kernel (Route: 0 tile, 1 wide).
int fdes_panel_rowpass_stack_c64(int device, int n, int64_t j, const void* v_stack, const void* b,
                                 void* out, void* s, int64_t s_wave_stride, double sigma,
                                 int64_t nwaves, int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* v = f1(v_stack) + j * static_cast<int64_t>(n) * n;
  const float f = static_cast<float>(sigma);
  if (s != nullptr) {
    FDES_DISPATCH_PANEL_N(n, (launch_row_route<L, kMidStore>(route, c2(b), o2(out), v, o2(s),
                                                             s_wave_stride, f, nwaves,
                                                             st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_row_route<L, kMid>(route, c2(b), o2(out), v, nullptr, 0, f,
                                                      nwaves, st(stream))))
}

// The stack row pass with the damped transmit of slice j of the complex
// (S, n, n) stack Vr + i Vi (out may be b); route: the kernel (Route: 0
// tile, 1 wide).
int fdes_panel_rowpass_stack_abs_c64(int device, int n, int64_t j, const void* v_stack,
                                     const void* b, void* out, double sigma, int64_t nwaves,
                                     int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float2* v = c2(v_stack) + j * static_cast<int64_t>(n) * n;
  FDES_DISPATCH_PANEL_N(n, (launch_row_abs_route<L, kMid>(route, c2(b), o2(out), v,
                                                          static_cast<float>(sigma), nwaves,
                                                          st(stream))))
}

// b -> psi = Fx^H(b): the exit wave; or, forward != 0, a -> Fx(a): the
// adjoint's seed (out may be b).
int fdes_panel_final_c64(int device, int n, const void* b, void* out, int forward, int64_t nwaves,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (forward) {
    FDES_DISPATCH_PANEL_N(n, (launch_x_row<L, kFwd>(c2(b), o2(out), nwaves, st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_x_row<L, kFinal>(c2(b), o2(out), nwaves, st(stream))))
}

// A backward row pass (mode 0 kBwdLoop, 1 kBwdLast, 2 kBwdTail): bar
// (nwaves, n, n) -> out (may be bar), and dv (n, n) = sigma * sum over the
// waves of Im(bar_s * conj(s)); s (kBwdTail: psi) of wave b at
// s + b * s_wave_stride; v (n, n) shared by the waves; route: the kernel
// (Route: 0 tile, 1 wide).
int fdes_panel_bwd_row_c64(int device, int n, int mode, const void* bar, void* out, const void* s,
                           int64_t s_wave_stride, const void* v, void* dv, double sigma,
                           int64_t nwaves, int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_bwd_row<L>(mode, route, c2(bar), o2(out), c2(s), s_wave_stride,
                                             f1(v),
                                             static_cast<float*>(dv), static_cast<float>(sigma),
                                             nwaves, st(stream)))
}

// The whole rollout of nslices >= 1 slices: psi0 (nwaves, n, n) -> out, V
// the real float32 (S, n, n) stack v, or with absorptive != 0 the complex64
// one (Vr + i Vi, read in place); col_route, row_route, init_route: the
// column passes', the row passes' with V_j and a real V's init's kernels (as
// the single passes' route; an absorptive V's init takes row_route).
int fdes_panel_scan_c64(int device, int n, const void* psi0, const void* v, int absorptive,
                        const void* prop, void* out, double sigma, int64_t nwaves, int nslices,
                        int64_t p_wave_stride, int col_route, int row_route, int init_route,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  const float f = static_cast<float>(sigma);
  if (!absorptive) {
    FDES_DISPATCH_PANEL_N(n, (launch_scan<L, false>(c2(psi0), v, c2(prop), o2(out), nullptr, f,
                                                   nwaves, nslices, p_wave_stride, col_route,
                                                   row_route, init_route, st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_scan<L, true>(c2(psi0), v, c2(prop), o2(out), nullptr, f,
                                                nwaves, nslices, p_wave_stride, col_route,
                                                row_route, init_route, st(stream))))
}

// The rollout under differentiation (a real V): as fdes_panel_scan_c64, and
// every s_j into s (nwaves, S, n, n); row_route: the store passes' kernel.
int fdes_panel_scan_store_c64(int device, int n, const void* psi0, const void* v,
                              const void* prop, void* out, void* s, double sigma, int64_t nwaves,
                              int nslices, int64_t p_wave_stride, int col_route, int row_route,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  FDES_DISPATCH_PANEL_N(n, (launch_scan<L, false, true>(c2(psi0), v, c2(prop), o2(out), o2(s),
                                                       static_cast<float>(sigma), nwaves, nslices,
                                                       p_wave_stride, col_route, row_route,
                                                       kRouteTile, st(stream))))
}

// The reverse loop: g (nwaves, n, n) -> dpsi (nwaves, n, n) and dv (S, n, n)
// summed over the waves, from the s (nwaves, S, n, n) of the rollout;
// col_route, row_route: the column and backward row passes' kernels.
int fdes_panel_scan_bwd_store_c64(int device, int n, const void* s, const void* v,
                                  const void* prop, const void* g, void* dpsi, void* dv,
                                  double sigma, int64_t nwaves, int nslices,
                                  int64_t p_wave_stride, int col_route, int row_route,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  FDES_DISPATCH_PANEL_N(n, launch_scan_bwd<L>(c2(s), f1(v), c2(prop), c2(g), o2(dpsi),
                                              static_cast<float*>(dv), static_cast<float>(sigma),
                                              nwaves, nslices, p_wave_stride, col_route,
                                              row_route, st(stream)))
}

// Row 27: g (nplanes, n, n) float32 -> Fx(g) (nplanes, n, n) complex.
int fdes_panel_g_rowpass_c64(int device, int n, const void* g, void* out, int64_t nplanes,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_g_row<L>(f1(g), o2(out), nplanes, st(stream)))
}

// The streamed build's scatter: g (g_elems floats) = 0, then g[idx[k]] +=
// val[k] for k < count (int64 indices, float32 weights; an index outside g
// makes g[0] NaN).
int fdes_panel_scatter_c64(int device, const void* idx, const void* val, int64_t count, void* g,
                           int64_t g_elems, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_scatter(static_cast<const int64_t*>(idx), f1(val), count, static_cast<float*>(g),
                        g_elems, st(stream));
}

// The streamed rollout of nslices >= 1 slices: psi0 (nwaves, n, n) -> out,
// V_j built per slice from idx, val (nslices, corners) (flat indices into nsp
// (n, n) delta planes, and weights) and fp (nsp, n, n) (prepare_factors);
// prop (n, n) or one per wave (p_wave_stride n^2); scratch g (nsp n^2
// floats), gx (nsp, n, n) and vx (n, n) complex.  build_route, col_route,
// init_route: row 28's, the column pass's and the init's kernels (Route: 0
// tile, 1 wide).
int fdes_panel_streamed_c64(int device, int n, const void* psi0, const void* idx,
                            const void* val, int64_t corners, int nslices, const void* fp, int nsp,
                            const void* prop, void* out, void* g, void* gx, void* vx,
                            double sigma, int64_t nwaves, int64_t p_wave_stride,
                            int build_route, int col_route, int init_route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1 || nsp < 1 || corners < 0) return cudaErrorInvalidValue;
  const int routes[] = {build_route, col_route, init_route};
  for (int route : routes) {
    if (route != kRouteTile && route != kRouteWide) return cudaErrorInvalidValue;
  }
  FDES_DISPATCH_PANEL_N(n, launch_streamed<L>(c2(psi0), static_cast<const int64_t*>(idx), f1(val),
                                              corners, nslices, f1(fp), nsp, c2(prop), o2(out),
                                              static_cast<float*>(g), o2(gx), o2(vx),
                                              static_cast<float>(sigma), nwaves, p_wave_stride,
                                              build_route, col_route, init_route, st(stream)))
}

// Row 28: gx (nsp, n, n) -> out (n, n) = Fy^H(sum_s fp_s * Fy(gx_s)), fp the
// (nsp, n, n) real factor panels; out must not overlap gx or fp; route: the
// kernel (Route: 0 tile, 1 wide).
int fdes_panel_build_colpass_c64(int device, int n, const void* gx, const void* fp, void* out,
                                 int nsp, int route, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nsp < 1) return cudaErrorInvalidValue;
  FDES_DISPATCH_PANEL_N(n, launch_build_col_route<L>(route, c2(gx), f1(fp), o2(out), nsp,
                                                     st(stream)))
}

// Row 29: b (nwaves, n, n) -> out = Fx(exp(i sigma V) Fx^H(b)) (out may be
// b), V = Re(Fx^H(vx)) of the (n, n) plane vx, shared by the waves.
int fdes_panel_vfused_rowpass_c64(int device, int n, const void* vx, const void* b, void* out,
                                  double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_vfused<L>(c2(vx), c2(b), o2(out), static_cast<float>(sigma),
                                            nwaves, st(stream)))
}

// out[0..3] = registers per thread, dynamic shared bytes, local bytes per
// thread and blocks resident at once on the device, of the row kernel
// (which 0), the column kernel (1), the backward row kernel (2), the row
// kernel of row 19 (3), the build column kernel (4), the wide column kernel
// (6), the wide backward row kernel (7), the wide row kernel of row 15 (8),
// of row 23 (9), of row 29 (11), of row 19 (14), of row 18 (15) or of row
// 13 (18; 19 its streamed form), the wide column kernel's build of one
// species (10) or of several (12), the wide g row kernel (13), or the
// transform-only kernel of row 17 (16) or row 20 (17), for size n.
int fdes_panel_kernel_info(int device, int n, int which, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, kernel_info<L>(device, which, out))
}

}  // extern "C"
