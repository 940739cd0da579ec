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
//   dVr = sigma * Im(g * conj(t*psi)),   dVa = -sigma * Re(g * conj(t*psi)),
//   written as the complex dV = dVr + i dVa.
//
// Layout: PyTorch's interleaved complex (float2 for complex64, double2 for
// complex128), C-contiguous.  psi is (batch, plane): any leading dimensions
// flattened into `batch`, the broadcast operand (V, or P) is one `plane`; an
// absorptive V is one complex plane, read as it lies.  Each thread reads the
// broadcast operand once, computes the transmission once, and applies it to
// the batch entries it covers, neighbouring threads on neighbouring
// addresses: 16-byte vectors of psi (cmul_kernel's shape; 8-byte ones on an
// odd or unaligned plane), but for row 2, a pixel a thread.
// The adjoints sum dV over the whole batch in one thread, in registers: each
// pixel's sum belongs to one thread, in a fixed order, with no atomics.
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
#include <initializer_list>

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

// Replaces fdes_tpu/pallas/slice_step.py::_cmul_kernel (via _cmul): a * b, or
// a * conj(b), b one plane broadcast over the batch.  Bound: bytes.  Per
// 512^2 c64 plane it moves a + b + out = 6 MiB, 1.88 us at 3.35 TB/s.  The
// first version (8-byte accesses, the batch walked one plane after another,
// about two loads in flight a thread) lost to torch.mul.  This one: 16-byte
// accesses (W complex a vector: two complex64, one complex128), a block row
// (blockIdx.y) per group of kUnroll planes whose loads of a are all issued
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

// The absorptive transmission t = exp(i sigma Vr - sigma Va) of each complex
// pixel of a vector of V: full-precision sincos and exp.
template <typename R, typename V>
__device__ __forceinline__ void absorptive_t(V v, R sigma, typename Complex<R>::T* t) {
  constexpr int W = sizeof(V) / sizeof(typename Complex<R>::T);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const typename Complex<R>::T vk = lane<R>(v, k);
    R s, c;
    sin_cos(sigma * vk.x, &s, &c);
    const R damp = exp_full(-sigma * vk.y);
    t[k].x = c * damp;
    t[k].y = s * damp;
  }
}

constexpr int kUnroll = 4;  // planes whose loads are in flight together (cmul, rows 4 and 5)

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
  for (int64_t j0 = static_cast<int64_t>(blockIdx.y) * kUnroll; j0 < batch;
       j0 += static_cast<int64_t>(gridDim.y) * kUnroll) {
    V av[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < batch) av[u] = a[(j0 + u) * nvec + i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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
  const int64_t groups = (batch + kUnroll - 1) / kUnroll;
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

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_abs_fwd_kernel (via
// _transmit_abs_fwd), redesigned for the H100: psi * t, t = exp(i sigma Vr -
// sigma Va), V = Vr + i Va read in place as one complex plane.  Bound: bytes,
// 24 a complex64 pixel (V, psi in, out): 1.88 us at 512^2, 30.0 at 2048^2.
// The first version (8-byte accesses, Vr and Va from two real planes that the
// caller copied out of V, the batch walked one plane after another) took
// 45.5 us at 2048^2 and 162 at 4096^2 (H100, chip_smoke.py kernels, in
// turns).  This one is cmul_kernel's shape: 16-byte accesses (two complex64
// pixels a vector, or one complex128), t formed once per pixel and kept in
// registers, a block row (blockIdx.y) per group of kUnroll planes whose loads
// of psi are all issued before their products: 38.4 and 136.3 us.  Measured
// and not kept: loading psi ahead of t's sincos (the compiler does already),
// and two or four vectors a thread (slower at every size).  At 8 planes of
// 512^2 the first version stays ahead (11.0 against 12.6 us).  Not Triton:
// the file is CUDA and serves complex128 too.  No shared memory: a streaming
// pass.
template <typename R, int W>
__global__ void __launch_bounds__(kThreads)
transmit_abs_vec_kernel(const typename Vec<R, W>::T* __restrict__ psi,
                        const typename Vec<R, W>::T* __restrict__ v,
                        typename Vec<R, W>::T* __restrict__ out, R sigma, int64_t nvec,
                        int64_t batch) {
  using C = typename Complex<R>::T;
  using V = typename Vec<R, W>::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nvec) return;
  C t[W];
  absorptive_t<R>(v[i], sigma, t);
  for (int64_t j0 = static_cast<int64_t>(blockIdx.y) * kUnroll; j0 < batch;
       j0 += static_cast<int64_t>(gridDim.y) * kUnroll) {
    V pv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < batch) pv[u] = psi[(j0 + u) * nvec + i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u >= batch) break;
      C o[W];
#pragma unroll
      for (int k = 0; k < W; ++k) o[k] = rotate(lane<R>(pv[u], k), t[k].x, t[k].y);
      out[(j0 + u) * nvec + i] = pack(o);
    }
  }
}

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_abs_bwd_kernel (via
// _pallas_transmit_abs_bwd), redesigned for the H100.  With u = t*psi
// (recomputed), dpsi = g*conj(t) and dV = dVr + i dVa = sigma*Im(g*conj(u))
// - i sigma*Re(g*conj(u)) summed over the batch, PyTorch's convention for the
// complex V (the conjugate of jax.grad's).  V read and dV written in place as
// one complex plane each.  Bound: bytes, 40 a complex64 pixel (V, psi, g in,
// dpsi, dV out): 3.13 us at 512^2, 50.1 at 2048^2.  The first version read Vr
// and Va from two real planes and wrote dVr and dVa to two more, which the
// caller copied out of V and packed back into a complex dV: 70.1 us at 2048^2,
// 262 at 4096^2.  This one: 16-byte accesses, t once per pixel in registers,
// the loads of psi and g for kUnroll planes issued before their products:
// 61.7 and 226.2 us.  The whole batch stays in one thread so that each
// pixel's dV is summed in a fixed order (plane 0 first), with no atomics: the
// same bits from run to run.
template <typename R, int W>
__global__ void __launch_bounds__(kThreads)
transmit_abs_bwd_vec_kernel(const typename Vec<R, W>::T* __restrict__ psi,
                            const typename Vec<R, W>::T* __restrict__ v,
                            const typename Vec<R, W>::T* __restrict__ g,
                            typename Vec<R, W>::T* __restrict__ dpsi,
                            typename Vec<R, W>::T* __restrict__ dv, R sigma, int64_t nvec,
                            int64_t batch) {
  using C = typename Complex<R>::T;
  using V = typename Vec<R, W>::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nvec) return;
  C t[W];
  absorptive_t<R>(v[i], sigma, t);
  R acc_im[W], acc_re[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc_im[k] = acc_re[k] = 0;
  for (int64_t j0 = 0; j0 < batch; j0 += kUnroll) {
    V pv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < batch) {
        pv[u] = psi[(j0 + u) * nvec + i];
        gv[u] = g[(j0 + u) * nvec + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u >= batch) break;
      C d[W];
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const C gk = lane<R>(gv[u], k);
        const C uk = rotate(lane<R>(pv[u], k), t[k].x, t[k].y);
        d[k] = rotate_conj(gk, t[k].x, t[k].y);
        acc_im[k] += gk.y * uk.x - gk.x * uk.y;
        acc_re[k] += gk.x * uk.x + gk.y * uk.y;
      }
      dpsi[(j0 + u) * nvec + i] = pack(d);
    }
  }
  C o[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    o[k].x = sigma * acc_im[k];
    o[k].y = -sigma * acc_re[k];
  }
  dv[i] = pack(o);
}

// Real vectors of V: the W reals under a Vec<R, W> of psi.
template <typename R, int W>
struct RVec;
template <>
struct RVec<float, 1> {
  using T = float;
};
template <>
struct RVec<float, 2> {
  using T = float2;
};
template <>
struct RVec<double, 1> {
  using T = double;
};

__device__ __forceinline__ float rlane(float2 v, int k) { return k == 0 ? v.x : v.y; }
template <typename R>
__device__ __forceinline__ R rlane(R v, int) {
  return v;
}

// Rows 1 and 2 by precision, from H100 turns (scripts/against_checkout.py):
// row 1's planes whose loads are in flight together in one thread, and row
// 2's blocks of kThreads an SM that the compiler is asked to fit (8: at most
// 32 registers; 6: 40).
template <typename R>
constexpr int kFwdPlanes = sizeof(R) == 4 ? 2 : 1;
template <typename R>
constexpr int kBwdBlocks = sizeof(R) == 4 ? 8 : 6;
// complex128 row 2 from this batch on: no register cap (70 registers; at 128
// x 512^2 560.8 against 569.4 us with the cap, in turns; at one plane the cap
// leads, 7.74 against 8.16 us; 2-127 planes not measured)
constexpr int64_t kBwdUncappedFrom = 128;

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_fwd_kernel (via
// _transmit_fwd), redesigned for the H100: psi * t, t = exp(i sigma V), V
// real.  Bound: bytes, 4 + 16 a complex64 pixel and plane (V; psi in, out):
// 1.57 us at 512^2, 14.1 at 1536^2, 25.0 at 2048^2, 100.2 at 4096^2.  The
// first version (a grid-stride loop capped at 132 x 16 blocks, 8-byte
// accesses, the batch walked one plane after another) took 6.66, 23.7, 37.8
// and 130.5 us there.  This one: psi and out as 16-byte vectors (W = 2
// complex64 pixels, or one complex128), V's W reals as one word, t formed
// once a block row and kept in registers, the loads of kFwdPlanes planes
// issued before their products, and at most 32 registers, so that 8 blocks
// of 256 threads fill each SM and every vector of a plane is in flight at
// once: 6.59, 20.1, 33.0 and 114.1 us (H100, scripts/against_checkout.py,
// in turns).  A block row (blockIdx.y) covers `rows` planes, which the
// caller picks by batch (kernels/slice_step.py TRANSMIT_ROWS): the whole
// batch in one row forms t once a pixel; more rows put more threads on a
// large batch (16 x 512^2: 28.2 against 28.6 us; 128 x 512^2 complex128, two
// planes a row: 368.6 against 380.5).  A row of a few planes (cmul_kernel's
// grid, a row of 4) lost at 8 x 512^2 (12.4 against 10.9 us) and from 1536^2
// up.  Measured and not kept: four planes in flight (50 registers: 130.6 us
// at 4096^2), two in complex128 (7.6 against 7.0 us at 512^2), four pixels a
// thread (slower at 4-8 planes), and the streaming hints __ldcs/__stcs
// (faster alone at 1536^2, where repeated timing keeps V in L2, slower at 4-8
// planes; within 1-3 % in a rollout).  An odd complex64 plane, or an operand
// not 16-byte aligned, takes W = 1.  No shared memory: a streaming pass.
template <typename R, int W, bool kRows>
__global__ void __launch_bounds__(kThreads, 8)
transmit_vec_kernel(const typename Vec<R, W>::T* __restrict__ psi,
                    const typename RVec<R, W>::T* __restrict__ v,
                    typename Vec<R, W>::T* __restrict__ out, R sigma, int64_t nvec,
                    int64_t batch, int64_t rows) {
  using C = typename Complex<R>::T;
  using V = typename Vec<R, W>::T;
  constexpr int U = kFwdPlanes<R>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nvec) return;
  const typename RVec<R, W>::T vi = v[i];
  C t[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    R s, c;
    sin_cos(sigma * rlane(vi, k), &s, &c);
    t[k].x = c;
    t[k].y = s;
  }
  // kRows: this block row's planes, the pointers moved once; else the whole
  // batch, with none of that arithmetic (it cost 1-2 % at one plane)
  int64_t count = batch;
  if constexpr (kRows) {
    const int64_t first = static_cast<int64_t>(blockIdx.y) * rows;
    count = batch - first < rows ? batch - first : rows;
    psi += first * nvec;
    out += first * nvec;
  }
  for (int64_t j0 = 0; j0 < count; j0 += U) {
    V pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < count) pv[u] = psi[(j0 + u) * nvec + i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u >= count) break;
      C o[W];
#pragma unroll
      for (int k = 0; k < W; ++k) o[k] = rotate(lane<R>(pv[u], k), t[k].x, t[k].y);
      out[(j0 + u) * nvec + i] = pack(o);
    }
  }
}

// Replaces fdes_tpu/pallas/slice_step.py::_transmit_bwd_kernel (via
// _pallas_transmit_bwd), re-derived for PyTorch's adjoint convention (top of
// file) and redesigned for the H100.  With u = t*psi (recomputed: cheaper
// than saving it through the FFTs), dpsi = g*conj(t) and dV = sigma *
// Im(g*conj(u)) = sigma * (g.y*u.x - g.x*u.y) summed over the batch.  Bound:
// bytes, 8 + 24 a complex64 pixel and plane (V, psi, g in; dpsi, dV out):
// 2.50 us at 512^2, 8.14 at 4 x 512^2, 40.1 at 2048^2, 160.3 at 4096^2.  The
// first version (the grid-stride form of row 1) took 6.59, 8.69, 51.8 and
// 197.0 us there.  This one: a pixel a thread, t formed once and kept in
// registers, the whole batch in one thread, one plane after another, and at
// most 32 registers in complex64 (40 in complex128 below kBwdUncappedFrom
// planes): 6.58, 8.70, 49.7 and 182.6 us (H100, scripts/against_checkout.py,
// in turns).  Measured and not kept: two complex64 pixels a thread (16-byte
// accesses, 40-48 registers: 1-2 % faster from 1536^2 up, but behind the
// first version at 4 x 512^2); two planes' loads in flight (a tie in
// complex128 at 128 x 512^2).  The whole batch stays in one thread so that
// each pixel's dV is summed in a fixed order (plane 0 first), with no
// atomics: the same bits from run to run.
template <typename R, int Blocks>
__global__ void __launch_bounds__(kThreads, Blocks)
transmit_bwd_pixel_kernel(const typename Complex<R>::T* __restrict__ psi,
                          const R* __restrict__ v, const typename Complex<R>::T* __restrict__ g,
                          typename Complex<R>::T* __restrict__ dpsi, R* __restrict__ dv,
                          R sigma, int64_t plane, int64_t batch) {
  using C = typename Complex<R>::T;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  R s, c;
  sin_cos(sigma * v[i], &s, &c);
  R acc = 0;
  for (int64_t j = 0; j < batch; ++j) {
    const C gk = g[j * plane + i];
    const C uk = rotate(psi[j * plane + i], c, s);
    dpsi[j * plane + i] = rotate_conj(gk, c, s);
    acc += gk.y * uk.x - gk.x * uk.y;
  }
  dv[i] = sigma * acc;
}

// complex64: two pixels a 16-byte vector where the plane is even and every
// operand is 16-byte aligned, else one; complex128: one pixel, 16 bytes.
template <typename R>
bool two_a_vector(int64_t plane, std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return sizeof(R) == 4 && plane % 2 == 0 && any % 16 == 0;
}

template <typename R, int W>
int launch_transmit_vec(const void* psi, const void* v, void* out, R sigma, int64_t plane,
                        int64_t batch, int64_t rows, cudaStream_t stream) {
  using V = typename Vec<R, W>::T;
  using RV = typename RVec<R, W>::T;
  const int64_t nvec = plane / W;
  const int64_t fewest = (batch + 65534) / 65535;  // gridDim.y's limit
  if (rows < fewest) rows = fewest;
  const dim3 grid(static_cast<unsigned>((nvec + kThreads - 1) / kThreads),
                  static_cast<unsigned>((batch + rows - 1) / rows));
  const auto kernel =
      grid.y > 1 ? transmit_vec_kernel<R, W, true> : transmit_vec_kernel<R, W, false>;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const V*>(psi), static_cast<const RV*>(v),
                                        static_cast<V*>(out), sigma, nvec, batch, rows);
  return cudaGetLastError();
}

template <typename R>
int launch_transmit(int device, const void* psi, const void* v, void* out, double sigma,
                    int64_t plane, int64_t batch, int64_t rows, void* stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const R sg = static_cast<R>(sigma);
  if (two_a_vector<R>(plane, {psi, v, out})) {
    return launch_transmit_vec<R, sizeof(R) == 4 ? 2 : 1>(psi, v, out, sg, plane, batch, rows,
                                                          s);
  }
  return launch_transmit_vec<R, 1>(psi, v, out, sg, plane, batch, rows, s);
}

template <typename R>
int launch_cmul(int device, const void* a, const void* b, void* out, int conj_b, int64_t plane,
                int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (two_a_vector<R>(plane, {a, b, out})) {
    return launch_cmul_vec<R, sizeof(R) == 4 ? 2 : 1>(a, b, out, conj_b, plane, batch, s);
  }
  return launch_cmul_vec<R, 1>(a, b, out, conj_b, plane, batch, s);
}

template <typename R, int Blocks>
int launch_transmit_bwd_pixel(const void* psi, const void* v, const void* g, void* dpsi,
                              void* dv, R sigma, int64_t plane, int64_t batch,
                              cudaStream_t stream) {
  using C = typename Complex<R>::T;
  transmit_bwd_pixel_kernel<R, Blocks>
      <<<static_cast<unsigned>((plane + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          static_cast<const C*>(psi), static_cast<const R*>(v), static_cast<const C*>(g),
          static_cast<C*>(dpsi), static_cast<R*>(dv), sigma, plane, batch);
  return cudaGetLastError();
}

template <typename R>
int launch_transmit_bwd(int device, const void* psi, const void* v, const void* g, void* dpsi,
                        void* dv, double sigma, int64_t plane, int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const R sg = static_cast<R>(sigma);
  if constexpr (sizeof(R) == 8) {
    if (batch >= kBwdUncappedFrom) {
      return launch_transmit_bwd_pixel<R, 1>(psi, v, g, dpsi, dv, sg, plane, batch, s);
    }
  }
  return launch_transmit_bwd_pixel<R, kBwdBlocks<R>>(psi, v, g, dpsi, dv, sg, plane, batch, s);
}

template <typename R, int W>
int launch_transmit_abs_vec(const void* psi, const void* v, void* out, R sigma, int64_t plane,
                            int64_t batch, cudaStream_t stream) {
  using V = typename Vec<R, W>::T;
  const int64_t nvec = plane / W;
  const int64_t groups = (batch + kUnroll - 1) / kUnroll;
  const dim3 grid(static_cast<unsigned>((nvec + kThreads - 1) / kThreads),
                  static_cast<unsigned>(groups < 65535 ? groups : 65535));  // gridDim.y's limit
  transmit_abs_vec_kernel<R, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(psi), static_cast<const V*>(v), static_cast<V*>(out), sigma, nvec,
      batch);
  return cudaGetLastError();
}

template <typename R>
int launch_transmit_abs(int device, const void* psi, const void* v, void* out, double sigma,
                        int64_t plane, int64_t batch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const R sg = static_cast<R>(sigma);
  if (two_a_vector<R>(plane, {psi, v, out})) {
    return launch_transmit_abs_vec<R, sizeof(R) == 4 ? 2 : 1>(psi, v, out, sg, plane, batch, s);
  }
  return launch_transmit_abs_vec<R, 1>(psi, v, out, sg, plane, batch, s);
}

template <typename R, int W>
int launch_transmit_abs_bwd_vec(const void* psi, const void* v, const void* g, void* dpsi,
                                void* dv, R sigma, int64_t plane, int64_t batch,
                                cudaStream_t stream) {
  using V = typename Vec<R, W>::T;
  const int64_t nvec = plane / W;
  transmit_abs_bwd_vec_kernel<R, W>
      <<<static_cast<unsigned>((nvec + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          static_cast<const V*>(psi), static_cast<const V*>(v), static_cast<const V*>(g),
          static_cast<V*>(dpsi), static_cast<V*>(dv), sigma, nvec, batch);
  return cudaGetLastError();
}

template <typename R>
int launch_transmit_abs_bwd(int device, const void* psi, const void* v, const void* g,
                            void* dpsi, void* dv, double sigma, int64_t plane, int64_t batch,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const R sg = static_cast<R>(sigma);
  if (two_a_vector<R>(plane, {psi, v, g, dpsi, dv})) {
    return launch_transmit_abs_bwd_vec<R, sizeof(R) == 4 ? 2 : 1>(psi, v, g, dpsi, dv, sg, plane,
                                                                  batch, s);
  }
  return launch_transmit_abs_bwd_vec<R, 1>(psi, v, g, dpsi, dv, sg, plane, batch, s);
}

}  // namespace

extern "C" {

const char* fdes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows: the planes a block row covers (at least 1)
int fdes_transmit_c64(int device, const void* psi, const void* v, void* out, double sigma,
                      int64_t plane, int64_t batch, int64_t rows, void* stream) {
  return launch_transmit<float>(device, psi, v, out, sigma, plane, batch, rows, stream);
}

int fdes_transmit_c128(int device, const void* psi, const void* v, void* out, double sigma,
                       int64_t plane, int64_t batch, int64_t rows, void* stream) {
  return launch_transmit<double>(device, psi, v, out, sigma, plane, batch, rows, stream);
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

int fdes_transmit_abs_c64(int device, const void* psi, const void* v, void* out, double sigma,
                          int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_abs<float>(device, psi, v, out, sigma, plane, batch, stream);
}

int fdes_transmit_abs_c128(int device, const void* psi, const void* v, void* out, double sigma,
                           int64_t plane, int64_t batch, void* stream) {
  return launch_transmit_abs<double>(device, psi, v, out, sigma, plane, batch, stream);
}

int fdes_transmit_abs_bwd_c64(int device, const void* psi, const void* v, const void* g,
                              void* dpsi, void* dv, double sigma, int64_t plane, int64_t batch,
                              void* stream) {
  return launch_transmit_abs_bwd<float>(device, psi, v, g, dpsi, dv, sigma, plane, batch, stream);
}

int fdes_transmit_abs_bwd_c128(int device, const void* psi, const void* v, const void* g,
                               void* dpsi, void* dv, double sigma, int64_t plane, int64_t batch,
                               void* stream) {
  return launch_transmit_abs_bwd<double>(device, psi, v, g, dpsi, dv, sigma, plane, batch,
                                         stream);
}

}  // extern "C"
