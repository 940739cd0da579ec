// The panel scan's passes, for Hopper (sm_90a): the multislice loop on grids
// of 256^2 to 4096^2 as row and column passes over a plane in device memory,
// each pass an ordinary kernel launch, with the 2-D FFT computed in the
// kernels' own bodies (no cuFFT).
//
// Replaces the forward half of fdes_tpu/pallas/panel_scan.py:
//   panel_row_kernel<L, kInit, false>   _row_init_kernel           (:82)
//   panel_col_kernel<L>                 _col_kernel                (:247)
//   panel_row_kernel<L, kMid, false>    _row_mid_stack_kernel      (:125) and
//                                       _row_mid_kernel            (:101)
//   panel_row_kernel<L, kFinal, false>  _row_final_kernel          (:194)
//   panel_row_kernel<L, kInit, true>    _row_init_abs_kernel       (:150)
//   panel_row_kernel<L, kMid, true>     _row_mid_stack_abs_kernel  (:171)
// and _run_single / _run_single_abs (the whole rollout) as
// fdes_panel_scan_c64, which issues every pass of a rollout from C on the
// caller's stream.
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
// costs one column pass and one row pass, 2S + 1 launches a rollout.
//
// The TPU kernels stream (R, N) row panels and (N, 128) column panels of
// (re, im) plane pairs through VMEM, with 128-point matrix-product digits.
// Here a row tile is 4096 contiguous complex64 elements (4096/N rows: 2 at
// 2048, 1 at 4096), a column tile C adjacent columns of all N rows, both in
// dynamic shared memory with the N/2 twiddles (a row tile at 4096 needs
// 51 KB, above the 48 KB of static shared memory); the 1-D transform is
// fused_fft.cuh's radix 2 (forward decimation in frequency, inverse
// decimation in time), so the spectrum is never reordered.  Blocks walk over
// (wave, tile) pairs, so B waves run in one launch per pass (the TPU engine
// maps over them one at a time); no grid-wide barrier: the stream orders
// the passes.
//
// Bounds (H100 SXM: 3.35 TB/s, 67 TFLOP/s FP32): at 2048^2 a complex64
// plane is 32 MiB and the planes do not stay in the 50 MB L2 between
// passes; a column pass moves a, P and b = 96 MiB (31 us), a row pass b, V
// and a = 80 MiB (25 us), so a slice is bound by its bytes at ~56 us, against
// ~14 us of operations (5 N^2 log2 N^2 per 2-D transform pair, per pass
// half of it).  The column tile's width C sets how much of each 32-byte
// sector a row of the panel uses: 4 columns read whole sectors.  This first
// version runs at about a third of the bound (H100 80GB HBM3 at 700 W,
// chip_smoke.py: a row pass 79 us, a column pass 95 us at 2048^2): radix-2
// stages through shared memory, and a column tile of 4 x 2048 (77 KB) leaves
// 2 blocks per SM to hide the loads.
//
// Layout: PyTorch's interleaved complex64 (float2), C-contiguous, 16-byte
// aligned; N in {256, 512, 1024, 2048, 4096}; planes are (nwaves, N, N);
// offsets of waves and slices are 64-bit (a 4096^2 x 512 stack holds
// 8.6e9 elements).  Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns the first CUDA error
// (0 if none).

#include "fused_fft.cuh"

namespace {

enum RowMode { kInit = 0, kMid = 1, kFinal = 2 };

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

int blocks_for(int64_t ntiles) {
  return static_cast<int>(ntiles < kMaxBlocks ? ntiles : kMaxBlocks);
}

// A row pass over every tile of nwaves planes (fused_fft.cuh's row_tile).
// kInit: transmit, forward x.  kMid: inverse x, transmit, forward x.  kFinal:
// inverse x.  vr, vi: one (N, N) plane of potentials shared by the waves (the
// wrapper points them at slice j of a stack); unused by kFinal, vi unused
// unless ABS.
template <int LOG2N, int MODE, bool ABS>
__global__ void __launch_bounds__(kThreads)
panel_row_kernel(const float2* src, float2* dst, const float* __restrict__ vr,
                 const float* __restrict__ vi, float sigma, int64_t nwaves) {
  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* tw = smem + kTilePadded;
  constexpr int64_t kTilesPerWave = (int64_t{1} << (2 * LOG2N)) / kTile;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kTilesPerWave; t += gridDim.x) {
    const int64_t r = (t % kTilesPerWave) * kTile;
    row_tile<LOG2N, false, ABS>(tile, tw, src + t * kTile, dst + t * kTile,
                                MODE == kFinal ? nullptr : vr + r, sigma, MODE != kInit,
                                MODE != kFinal, nullptr, nullptr, ABS ? vi + r : nullptr);
  }
}

// A column pass over every panel of kPanelCols columns of nwaves planes.
// prop: the bit-reversed propagator of wave 0, p_wave_stride elements to the
// next wave's (0 when shared).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
panel_col_kernel(const float2* src, float2* dst, const float2* __restrict__ prop,
                 int64_t p_wave_stride, int64_t nwaves) {
  extern __shared__ float2 smem[];
  constexpr int N = 1 << LOG2N;
  constexpr int C = kPanelCols<LOG2N>;
  float2* tile = smem;
  float2* tw = smem + C * N * 17 / 16;
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  constexpr int64_t kTilesPerWave = N / C;
  init_twiddles<LOG2N>(tw);
  __syncthreads();
  for (int64_t t = blockIdx.x; t < nwaves * kTilesPerWave; t += gridDim.x) {
    const int64_t b = t / kTilesPerWave;
    const int c0 = static_cast<int>(t % kTilesPerWave) * C;
    col_tile<LOG2N, C>(tile, tw, src + b * kPlane, dst + b * kPlane, c0, prop + b * p_wave_stride,
                       false);
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

template <int LOG2N, int MODE, bool ABS>
int launch_row(const float2* src, float2* dst, const float* vr, const float* vi, float sigma,
               int64_t nwaves, cudaStream_t stream) {
  constexpr int64_t kTilesPerWave = (int64_t{1} << (2 * LOG2N)) / kTile;
  return launch(panel_row_kernel<LOG2N, MODE, ABS>, nwaves * kTilesPerWave,
                row_smem_bytes<LOG2N>(), stream, src, dst, vr, vi, sigma, nwaves);
}

template <int LOG2N>
int launch_col(const float2* src, float2* dst, const float2* prop, int64_t p_wave_stride,
               int64_t nwaves, cudaStream_t stream) {
  return launch(panel_col_kernel<LOG2N>, nwaves * ((1 << LOG2N) / kPanelCols<LOG2N>),
                col_smem_bytes<LOG2N>(), stream, src, dst, prop, p_wave_stride, nwaves);
}

// The whole rollout: init, (S - 1) x [column pass, row pass with V_j],
// column pass, final; every pass in place on out after the first.
template <int LOG2N, bool ABS>
int launch_scan(const float2* psi0, const float* vr, const float* vi, const float2* prop,
                float2* out, float sigma, int64_t nwaves, int nslices, int64_t p_wave_stride,
                cudaStream_t stream) {
  constexpr int64_t kPlane = int64_t{1} << (2 * LOG2N);
  int err = launch_row<LOG2N, kInit, ABS>(psi0, out, vr, vi, sigma, nwaves, stream);
  for (int64_t j = 1; err == cudaSuccess && j <= nslices; ++j) {
    err = launch_col<LOG2N>(out, out, prop, p_wave_stride, nwaves, stream);
    if (err != cudaSuccess) break;
    if (j < nslices) {
      err = launch_row<LOG2N, kMid, ABS>(out, out, vr + j * kPlane, ABS ? vi + j * kPlane : nullptr,
                                         sigma, nwaves, stream);
    } else {
      err = launch_row<LOG2N, kFinal, false>(out, out, nullptr, nullptr, sigma, nwaves, stream);
    }
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
int kernel_info(int device, int column, int* out) {
  if (column) return info_of(panel_col_kernel<LOG2N>, col_smem_bytes<LOG2N>(), device, out);
  return info_of(panel_row_kernel<LOG2N, kMid, false>, row_smem_bytes<LOG2N>(), device, out);
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
int fdes_panel_init_c64(int device, int n, const void* psi, const void* v0, void* out,
                        double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kInit, false>(c2(psi), o2(out), f1(v0), nullptr,
                                                       static_cast<float>(sigma), nwaves,
                                                       st(stream))))
}

// The same with the damped transmit of an absorptive potential vr0 + i vi0.
int fdes_panel_init_abs_c64(int device, int n, const void* psi, const void* vr0, const void* vi0,
                            void* out, double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kInit, true>(c2(psi), o2(out), f1(vr0), f1(vi0),
                                                      static_cast<float>(sigma), nwaves,
                                                      st(stream))))
}

// a (nwaves, n, n) -> b = Fy^H(P/n^2 * Fy(a)) (out may be a); prop
// bit-reversed, (n, n) (p_wave_stride 0) or one per wave (n*n).
int fdes_panel_colpass_c64(int device, int n, const void* a, const void* prop, void* out,
                           int64_t p_wave_stride, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, launch_col<L>(c2(a), o2(out), c2(prop), p_wave_stride, nwaves,
                                         st(stream)))
}

// b -> a = Fx(t_j Fx^H(b)), V_j = slice j of the (S, n, n) stack.
int fdes_panel_rowpass_stack_c64(int device, int n, int64_t j, const void* v_stack, const void* b,
                                 void* out, double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t plane = static_cast<int64_t>(n) * n;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kMid, false>(c2(b), o2(out), f1(v_stack) + j * plane,
                                                      nullptr, static_cast<float>(sigma), nwaves,
                                                      st(stream))))
}

// The same with V one (n, n) plane.
int fdes_panel_rowpass_c64(int device, int n, const void* v, const void* b, void* out,
                           double sigma, int64_t nwaves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kMid, false>(c2(b), o2(out), f1(v), nullptr,
                                                      static_cast<float>(sigma), nwaves,
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
                                                     f1(vi_stack) + j * plane,
                                                     static_cast<float>(sigma), nwaves,
                                                     st(stream))))
}

// b -> psi = Fx^H(b): the exit wave.
int fdes_panel_final_c64(int device, int n, const void* b, void* out, int64_t nwaves,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, (launch_row<L, kFinal, false>(c2(b), o2(out), nullptr, nullptr, 0.0f,
                                                        nwaves, st(stream))))
}

// The whole rollout of nslices >= 1 slices: psi0 (nwaves, n, n) -> out, V
// the real (S, n, n) stack vr (vi nullptr) or an absorptive vr + i vi.
int fdes_panel_scan_c64(int device, int n, const void* psi0, const void* vr, const void* vi,
                        const void* prop, void* out, double sigma, int64_t nwaves, int nslices,
                        int64_t p_wave_stride, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nslices < 1) return cudaErrorInvalidValue;
  if (vi == nullptr) {
    FDES_DISPATCH_PANEL_N(n, (launch_scan<L, false>(c2(psi0), f1(vr), nullptr, c2(prop), o2(out),
                                                   static_cast<float>(sigma), nwaves, nslices,
                                                   p_wave_stride, st(stream))))
  }
  FDES_DISPATCH_PANEL_N(n, (launch_scan<L, true>(c2(psi0), f1(vr), f1(vi), c2(prop), o2(out),
                                                static_cast<float>(sigma), nwaves, nslices,
                                                p_wave_stride, st(stream))))
}

// out[0..3] = registers per thread, dynamic shared bytes, local bytes per
// thread and blocks resident at once on the device, of the row kernel
// (column 0) or of the column kernel (column 1), for size n.
int fdes_panel_kernel_info(int device, int n, int column, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FDES_DISPATCH_PANEL_N(n, kernel_info<L>(device, column, out))
}

}  // extern "C"
