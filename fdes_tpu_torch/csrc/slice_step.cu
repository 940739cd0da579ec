// Elementwise stages of the multislice slice step, for Hopper (sm_90a).
//
//   psi <- IFFT[ P * FFT[ t * psi ] ],  t = exp(i*sigma*V)  or, for the
//   absorptive (optical) potential V = Vr + i*Va, t = exp(i*sigma*Vr - sigma*Va).
//
// The FFTs stay in cuFFT (torch.fft), as the TPU engine leaves them to XLA.
// The kernels here are the transmit multiply, its absorptive variant, the
// complex multiply used for the Fresnel propagator (and, with conj(b), for its
// adjoint), and the two transmit adjoints.
//
// Adjoint convention: PyTorch's.  For a real loss L, the incoming gradient g
// of a complex output is dL/dRe + i dL/dIm (the conjugate of JAX's bilinear
// cotangent), so for out = t * psi
//   dpsi = g * conj(t),   dV = sigma * Im(g * conj(t*psi)),
//   and for the absorptive t = exp(i*sigma*Vr - sigma*Va):
//   dVr = sigma * Im(g * conj(t*psi)),   dVa = -sigma * Re(g * conj(t*psi)).
//
// Layout: PyTorch's interleaved complex (float2 for complex64, double2 for
// complex128), C-contiguous.  psi is (batch, plane): any leading dimensions
// flattened into `batch`, the broadcast operand (V, or P) is one `plane`.
// Each thread walks a grid-stride loop over the plane, reads the broadcast
// operand once, computes the transmission once, and applies it to every batch
// entry: 8- or 16-byte loads, neighbouring threads on neighbouring addresses.
// The adjoints sum dV over the batch in that same loop, in registers: each
// pixel's sum belongs to one thread, so no atomics are needed.
//
// Accuracy: sigma*V reaches several radians (sigma ~ 6.5e-4 rad/(V*A) at
// 300 kV; projected-potential peaks run to thousands of V*A), where the fast
// intrinsics __sinf/__cosf lose accuracy.  Full-precision sincosf/sincos and
// expf/exp are called, and the library is built without --use_fast_math.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() so that a refused launch is
// reported by the Python wrapper.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename R>
struct Complex;
template <>
struct Complex<float> {
  using T = float2;
};
template <>
struct Complex<double> {
  using T = double2;
};

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float exp_full(float x) { return expf(x); }
__device__ __forceinline__ double exp_full(double x) { return exp(x); }

// p * (c + i s)
template <typename C, typename R>
__device__ __forceinline__ C rotate(C p, R c, R s) {
  C o;
  o.x = p.x * c - p.y * s;
  o.y = p.x * s + p.y * c;
  return o;
}

constexpr int kThreads = 256;

int blocks_for(int64_t plane) {
  // Enough blocks to fill 132 SMs several times over; the grid-stride loop
  // covers the rest.
  const int64_t cap = 132 * 16;
  int64_t b = (plane + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < cap ? b : cap);
}

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_fwd_kernel (via
// _transmit_fwd).  Bound: bytes.  Per 512^2 c64 plane it moves V + psi in +
// psi out = 5 MiB, ~1.6 us at 3.35 TB/s; at the config-2 shape a launch costs
// about as much, so launch overhead is what the card sees.  Making it fast is
// later work: folding the transmit into cuFFT's load callback, or a CUDA graph
// over the slice loop.
template <typename R>
__global__ void transmit_kernel(const typename Complex<R>::T* __restrict__ psi,
                                const R* __restrict__ v,
                                typename Complex<R>::T* __restrict__ out, R sigma,
                                int64_t plane, int64_t batch) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
       i += stride) {
    R s, c;
    sin_cos(sigma * v[i], &s, &c);
    for (int64_t b = 0; b < batch; ++b) {
      const int64_t k = b * plane + i;
      out[k] = rotate(psi[k], c, s);
    }
  }
}

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_abs_fwd_kernel (via
// _transmit_abs_fwd).  Bound: bytes.  Per 512^2 c64 plane it moves Vr + Va +
// psi in + psi out = 6 MiB, ~1.9 us at 3.35 TB/s; launch overhead dominates at
// config 2.  Making it fast is later work: folding into cuFFT's load callback,
// or a CUDA graph over the slice loop.
template <typename R>
__global__ void transmit_abs_kernel(const typename Complex<R>::T* __restrict__ psi,
                                    const R* __restrict__ v_re, const R* __restrict__ v_abs,
                                    typename Complex<R>::T* __restrict__ out, R sigma,
                                    int64_t plane, int64_t batch) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
       i += stride) {
    R s, c;
    sin_cos(sigma * v_re[i], &s, &c);
    const R damp = exp_full(-sigma * v_abs[i]);
    c *= damp;
    s *= damp;
    for (int64_t b = 0; b < batch; ++b) {
      const int64_t k = b * plane + i;
      out[k] = rotate(psi[k], c, s);
    }
  }
}

// Replaces fdes_tpu/pallas/slice_step.py::_cmul_kernel (via _cmul): a * b, or
// a * conj(b), b one plane broadcast over the batch.  Bound: bytes.  Per
// 512^2 c64 plane it moves a + b + out = 6 MiB, 1.88 us at 3.35 TB/s.  The
// first version (8-byte accesses, the batch walked one plane after another,
// about two loads in flight a thread) lost to torch.mul.  This one: 16-byte
// accesses (W complex a vector: two complex64, one complex128), a block row
// (blockIdx.y) per group of kCmulUnroll planes whose loads of a are all issued
// before their products, b's vector in registers across the group.  Blocks
// start in order along the plane, so the card streams a few planes at a time:
// a grid of resident blocks striding over the plane with the whole batch in
// each thread (measured on the H100, chip_smoke.py) walked every plane at once
// and lost to torch.mul by 8 % at 16 planes.  An odd complex64 plane, or an
// operand not 16-byte aligned, takes the W = 1 instantiation (8-byte
// accesses).
template <typename R, int W>
struct Vec;
template <>
struct Vec<float, 2> {
  using T = float4;
};
template <>
struct Vec<float, 1> {
  using T = float2;
};
template <>
struct Vec<double, 1> {
  using T = double2;
};

// The k-th complex of a vector.
template <typename R>
__device__ __forceinline__ typename Complex<R>::T lane(float4 v, int k) {
  return k == 0 ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
}
template <typename R, typename V>
__device__ __forceinline__ typename Complex<R>::T lane(V v, int) {
  return v;
}
__device__ __forceinline__ float4 pack(const float2 (&c)[2]) {
  return make_float4(c[0].x, c[0].y, c[1].x, c[1].y);
}
template <typename C>
__device__ __forceinline__ C pack(const C (&c)[1]) {
  return c[0];
}

constexpr int kCmulUnroll = 4;  // planes of a whose loads are in flight together

template <typename R, int W>
__global__ void __launch_bounds__(kThreads)
cmul_kernel(const typename Vec<R, W>::T* __restrict__ a, const typename Vec<R, W>::T* __restrict__ b,
            typename Vec<R, W>::T* __restrict__ out, int conj_b, int64_t nvec, int64_t batch) {
  using C = typename Complex<R>::T;
  using V = typename Vec<R, W>::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nvec) return;
  const V bv = b[i];
  C bc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    bc[k] = lane<R>(bv, k);
    if (conj_b) bc[k].y = -bc[k].y;
  }
  for (int64_t j0 = static_cast<int64_t>(blockIdx.y) * kCmulUnroll; j0 < batch;
       j0 += static_cast<int64_t>(gridDim.y) * kCmulUnroll) {
    V av[kCmulUnroll];
#pragma unroll
    for (int u = 0; u < kCmulUnroll; ++u) {
      if (j0 + u < batch) av[u] = a[(j0 + u) * nvec + i];
    }
#pragma unroll
    for (int u = 0; u < kCmulUnroll; ++u) {
      if (j0 + u >= batch) break;
      C o[W];
#pragma unroll
      for (int k = 0; k < W; ++k) o[k] = rotate(lane<R>(av[u], k), bc[k].x, bc[k].y);
      out[(j0 + u) * nvec + i] = pack(o);
    }
  }
}

template <typename R, int W>
int launch_cmul_vec(const void* a, const void* b, void* out, int conj_b, int64_t plane,
                    int64_t batch, cudaStream_t stream) {
  using V = typename Vec<R, W>::T;
  const int64_t nvec = plane / W;
  const int64_t groups = (batch + kCmulUnroll - 1) / kCmulUnroll;
  const dim3 grid(static_cast<unsigned>((nvec + kThreads - 1) / kThreads),
                  static_cast<unsigned>(groups < 65535 ? groups : 65535));  // gridDim.y's limit
  cmul_kernel<R, W><<<grid, kThreads, 0, stream>>>(static_cast<const V*>(a),
                                                   static_cast<const V*>(b), static_cast<V*>(out),
                                                   conj_b, nvec, batch);
  return cudaGetLastError();
}

// g * conj(c + i s)
template <typename C, typename R>
__device__ __forceinline__ C rotate_conj(C g, R c, R s) {
  C o;
  o.x = g.x * c + g.y * s;
  o.y = g.y * c - g.x * s;
  return o;
}

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_bwd_kernel (via
// _pallas_transmit_bwd), re-derived for PyTorch's adjoint convention (top of
// file).  With u = t*psi (recomputed: cheaper than saving it through the
// FFTs), Im(g * conj(u)) = g.y*u.x - g.x*u.y.  Bound: bytes.  Per 512^2 c64
// plane it moves V + psi + g in, dpsi + dV out = 8 MiB, ~2.5 us at 3.35 TB/s;
// at the config-3 shape a launch costs about as much.  Making it fast is later
// work: a CUDA graph over the backward loop, or fusing into cuFFT callbacks.
template <typename R>
__global__ void transmit_bwd_kernel(const typename Complex<R>::T* __restrict__ psi,
                                    const R* __restrict__ v,
                                    const typename Complex<R>::T* __restrict__ g,
                                    typename Complex<R>::T* __restrict__ dpsi,
                                    R* __restrict__ dv, R sigma, int64_t plane,
                                    int64_t batch) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
       i += stride) {
    R s, c;
    sin_cos(sigma * v[i], &s, &c);
    R acc = 0;
    for (int64_t b = 0; b < batch; ++b) {
      const int64_t k = b * plane + i;
      const typename Complex<R>::T gk = g[k];
      const typename Complex<R>::T u = rotate(psi[k], c, s);
      dpsi[k] = rotate_conj(gk, c, s);
      acc += gk.y * u.x - gk.x * u.y;
    }
    dv[i] = sigma * acc;
  }
}

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_abs_bwd_kernel (via
// _pallas_transmit_abs_bwd), re-derived for PyTorch's convention.  With
// u = t*psi: dVr = sigma*Im(g*conj(u)), dVa = -sigma*Re(g*conj(u)) =
// -sigma*(g.x*u.x + g.y*u.y).  Bound: bytes.  Per 512^2 c64 plane it moves
// Vr + Va + psi + g in, dpsi + dVr + dVa out = 10 MiB, ~3.1 us at 3.35 TB/s;
// launch overhead is of the same size.
template <typename R>
__global__ void transmit_abs_bwd_kernel(const typename Complex<R>::T* __restrict__ psi,
                                        const R* __restrict__ v_re, const R* __restrict__ v_abs,
                                        const typename Complex<R>::T* __restrict__ g,
                                        typename Complex<R>::T* __restrict__ dpsi,
                                        R* __restrict__ dv_re, R* __restrict__ dv_abs, R sigma,
                                        int64_t plane, int64_t batch) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < plane;
       i += stride) {
    R s, c;
    sin_cos(sigma * v_re[i], &s, &c);
    const R damp = exp_full(-sigma * v_abs[i]);
    c *= damp;
    s *= damp;
    R acc_im = 0;
    R acc_re = 0;
    for (int64_t b = 0; b < batch; ++b) {
      const int64_t k = b * plane + i;
      const typename Complex<R>::T gk = g[k];
      const typename Complex<R>::T u = rotate(psi[k], c, s);
      dpsi[k] = rotate_conj(gk, c, s);
      acc_im += gk.y * u.x - gk.x * u.y;
      acc_re += gk.x * u.x + gk.y * u.y;
    }
    dv_re[i] = sigma * acc_im;
    dv_abs[i] = -sigma * acc_re;
  }
}

template <typename R>
int launch_transmit(int device, const void* psi, const void* v, void* out, double sigma,
                    int64_t plane, int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using C = typename Complex<R>::T;
  transmit_kernel<R><<<blocks_for(plane), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(psi), static_cast<const R*>(v), static_cast<C*>(out),
      static_cast<R>(sigma), plane, batch);
  return cudaGetLastError();
}

template <typename R>
int launch_transmit_abs(int device, const void* psi, const void* v_re, const void* v_abs,
                        void* out, double sigma, int64_t plane, int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using C = typename Complex<R>::T;
  transmit_abs_kernel<R><<<blocks_for(plane), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(psi), static_cast<const R*>(v_re), static_cast<const R*>(v_abs),
      static_cast<C*>(out), static_cast<R>(sigma), plane, batch);
  return cudaGetLastError();
}

template <typename R>
int launch_cmul(int device, const void* a, const void* b, void* out, int conj_b, int64_t plane,
                int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  // complex64: two elements a 16-byte vector where the plane is even and
  // every operand aligned, else one; complex128: one element, 16 bytes
  if (sizeof(R) == 4 && plane % 2 == 0 && aligned) {
    return launch_cmul_vec<R, sizeof(R) == 4 ? 2 : 1>(a, b, out, conj_b, plane, batch, s);
  }
  return launch_cmul_vec<R, 1>(a, b, out, conj_b, plane, batch, s);
}

template <typename R>
int launch_transmit_bwd(int device, const void* psi, const void* v, const void* g, void* dpsi,
                        void* dv, double sigma, int64_t plane, int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using C = typename Complex<R>::T;
  transmit_bwd_kernel<R><<<blocks_for(plane), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(psi), static_cast<const R*>(v), static_cast<const C*>(g),
      static_cast<C*>(dpsi), static_cast<R*>(dv), static_cast<R>(sigma), plane, batch);
  return cudaGetLastError();
}

template <typename R>
int launch_transmit_abs_bwd(int device, const void* psi, const void* v_re, const void* v_abs,
                            const void* g, void* dpsi, void* dv_re, void* dv_abs, double sigma,
                            int64_t plane, int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  using C = typename Complex<R>::T;
  transmit_abs_bwd_kernel<R>
      <<<blocks_for(plane), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const C*>(psi), static_cast<const R*>(v_re), static_cast<const R*>(v_abs),
          static_cast<const C*>(g), static_cast<C*>(dpsi), static_cast<R*>(dv_re),
          static_cast<R*>(dv_abs), static_cast<R>(sigma), plane, batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fdes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fdes_transmit_c64(int device, const void* psi, const void* v, void* out, double sigma,
                      int64_t plane, int64_t batch, void* stream) {
  return launch_transmit<float>(device, psi, v, out, sigma, plane, batch, stream);
}

int fdes_transmit_c128(int device, const void* psi, const void* v, void* out, double sigma,
                       int64_t plane, int64_t batch, void* stream) {
  return launch_transmit<double>(device, psi, v, out, sigma, plane, batch, stream);
}

int fdes_transmit_abs_c64(int device, const void* psi, const void* v_re, const void* v_abs,
                          void* out, double sigma, int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_abs<float>(device, psi, v_re, v_abs, out, sigma, plane, batch, stream);
}

int fdes_transmit_abs_c128(int device, const void* psi, const void* v_re, const void* v_abs,
                           void* out, double sigma, int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_abs<double>(device, psi, v_re, v_abs, out, sigma, plane, batch, stream);
}

int fdes_cmul_c64(int device, const void* a, const void* b, void* out, int conj_b, int64_t plane,
                  int64_t batch, void* stream) {
  return launch_cmul<float>(device, a, b, out, conj_b, plane, batch, stream);
}

int fdes_cmul_c128(int device, const void* a, const void* b, void* out, int conj_b,
                   int64_t plane, int64_t batch, void* stream) {
  return launch_cmul<double>(device, a, b, out, conj_b, plane, batch, stream);
}

int fdes_transmit_bwd_c64(int device, const void* psi, const void* v, const void* g, void* dpsi,
                          void* dv, double sigma, int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_bwd<float>(device, psi, v, g, dpsi, dv, sigma, plane, batch, stream);
}

int fdes_transmit_bwd_c128(int device, const void* psi, const void* v, const void* g, void* dpsi,
                           void* dv, double sigma, int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_bwd<double>(device, psi, v, g, dpsi, dv, sigma, plane, batch, stream);
}

int fdes_transmit_abs_bwd_c64(int device, const void* psi, const void* v_re, const void* v_abs,
                              const void* g, void* dpsi, void* dv_re, void* dv_abs, double sigma,
                              int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_abs_bwd<float>(device, psi, v_re, v_abs, g, dpsi, dv_re, dv_abs, sigma,
                                        plane, batch, stream);
}

int fdes_transmit_abs_bwd_c128(int device, const void* psi, const void* v_re, const void* v_abs,
                               const void* g, void* dpsi, void* dv_re, void* dv_abs, double sigma,
                               int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_abs_bwd<double>(device, psi, v_re, v_abs, g, dpsi, dv_re, dv_abs, sigma,
                                         plane, batch, stream);
}

}  // extern "C"
