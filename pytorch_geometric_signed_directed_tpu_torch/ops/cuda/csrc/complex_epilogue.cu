// MagNetConv's complex combine, bias and complex ReLU in one pass, forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these elementwise steps to
// XLA, which fuses them into the Chebyshev layer's einsums.  On the card
// they were PyTorch glue: two subtractions or additions, two bias adds, a
// comparison, two masking multiplies and a concatenation, each a pass over
// an [N, F] float32 tensor, and as many again in the backward.  Here the
// layer's weight products leave [o1 | o2] lane-stacked, row n holding o1[n]
// then o2[n] ([N, 2F]), and one launch writes
//
//   re = o1 - o2 + b,  im = o1 + o2 + b,  m = (re >= 0)
//   z  = [m * re | m * im]                      (m = 1 without activation)
//
// keeping m as one byte a node and lane for the backward.  The backward
// reads the incoming [d_re | d_im] and m once and writes
//
//   uv = [m d_re + m d_im | m d_im - m d_re]     (the gradient of [o1 | o2])
//   db = sum over rows of (m d_re + m d_im)      (the bias gradient)
//
// The operations are those of the PyTorch code they replace, in its order
// ((o1 - o2) + b, m * re), so z and uv carry the same bits; db is summed in
// float64 and rounded once.
//
// What bounds it: bytes.  The forward reads 8F and writes 8F + F bytes a
// row (the F bytes are the mask), the backward the same, with a few
// operations per lane: far below any arithmetic limit.  Design:
//   * Each thread owns one column group of V lanes (V = 4, one 16-byte
//     load a half, where F is a multiple of 4; else V = 1) and walks rows
//     with a grid stride.  A CTA of 256 threads spans a row with Lt threads
//     (the column groups rounded up to a power of two, at most 256) and
//     takes 256 / Lt rows at a time; wider rows take more CTAs along y.
//     The plan (V, Lt, row CTAs) is made by the wrapper, complex_epilogue.py.
//   * The bias gradient needs column sums over all rows without atomics:
//     each thread sums its rows in float64 registers, the CTA adds its row
//     lanes in a fixed order in shared memory and writes one float64
//     partial a lane, and a second launch adds the CTAs' partials in a
//     fixed order (a strided sum a thread, then a pairwise tree), so every
//     call gives the same bits.
//   * The kernels' names share no part with the sparse kernels' families
//     (port_bench/kernels/*.json), so a trace counts their time apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_mask(uint8_t* p, const float (&m)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t)(m[0] != 0.f) | ((uint32_t)(m[1] != 0.f) << 8) |
        ((uint32_t)(m[2] != 0.f) << 16) | ((uint32_t)(m[3] != 0.f) << 24);
  } else {
    *p = (uint8_t)(m[0] != 0.f);
  }
}

template <int V>
__device__ __forceinline__ void load_mask(const uint8_t* p, float (&m)[V]) {
  if constexpr (V == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int v = 0; v < 4; ++v) m[v] = ((w >> (8 * v)) & 0xff) ? 1.f : 0.f;
  } else {
    m[0] = *p ? 1.f : 0.f;
  }
}

// z = [m * (o1 - o2 + b) | m * (o1 + o2 + b)] of y = [o1 | o2]; `mask`
// (may be null) keeps m.  ACT: the complex ReLU; BIAS: add b.
template <int V, bool ACT, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    complex_epilogue_kernel(const float* __restrict__ y, const float* __restrict__ b,
                    float* __restrict__ z, uint8_t* __restrict__ mask,
                    int64_t n, int f, int lt) {
  const int col = threadIdx.x % lt;
  const int g = blockIdx.y * lt + col;
  if (g >= f / V) return;  // no barrier in this kernel
  const int j = g * V;
  const int rows = kThreads / lt;
  float bias[V];
#pragma unroll
  for (int v = 0; v < V; ++v) bias[v] = BIAS ? b[j + v] : 0.f;
  for (int64_t r = (int64_t)blockIdx.x * rows + threadIdx.x / lt; r < n;
       r += (int64_t)gridDim.x * rows) {
    const float* yr = y + r * 2 * f;
    float o1[V], o2[V], re[V], im[V], m[V];
    load<V>(yr + j, o1);
    load<V>(yr + f + j, o2);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      re[v] = o1[v] - o2[v];
      im[v] = o1[v] + o2[v];
      if (BIAS) {
        re[v] += bias[v];
        im[v] += bias[v];
      }
      if (ACT) {
        m[v] = re[v] >= 0.f ? 1.f : 0.f;
        re[v] = __fmul_rn(m[v], re[v]);
        im[v] = __fmul_rn(m[v], im[v]);
      }
    }
    float* zr = z + r * 2 * f;
    store<V>(zr + j, re);
    store<V>(zr + f + j, im);
    if (ACT && mask != nullptr) store_mask<V>(mask + r * f + j, m);
  }
}

// uv = [m d_re + m d_im | m d_im - m d_re] of dz = [d_re | d_im]; with
// BIAS, partial[blockIdx.x, lane] = this CTA's float64 sum of the first
// half.  MASK: m from `mask` (else 1).
template <int V, bool MASK, bool BIAS>
__global__ void __launch_bounds__(kThreads) complex_epilogue_backward_kernel(
    const float* __restrict__ dz, const uint8_t* __restrict__ mask,
    float* __restrict__ uv, double* __restrict__ partial, int64_t n, int f,
    int lt) {
  __shared__ double part[BIAS ? kThreads * V : 1];
  const int col = threadIdx.x % lt;
  const int g = blockIdx.y * lt + col;
  const bool active = g < f / V;
  const int j = g * V;
  const int rows = kThreads / lt;
  double acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0;
  if (active) {
    for (int64_t r = (int64_t)blockIdx.x * rows + threadIdx.x / lt; r < n;
         r += (int64_t)gridDim.x * rows) {
      const float* dr = dz + r * 2 * f;
      float d_re[V], d_im[V], u[V], w[V], m[V];
      load<V>(dr + j, d_re);
      load<V>(dr + f + j, d_im);
      if (MASK) load_mask<V>(mask + r * f + j, m);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (MASK) {
          d_re[v] = __fmul_rn(d_re[v], m[v]);
          d_im[v] = __fmul_rn(d_im[v], m[v]);
        }
        u[v] = d_re[v] + d_im[v];
        w[v] = d_im[v] - d_re[v];
        if (BIAS) acc[v] += (double)u[v];
      }
      float* ur = uv + r * 2 * f;
      store<V>(ur + j, u);
      store<V>(ur + f + j, w);
    }
  }
  if (BIAS) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[threadIdx.x * V + v] = acc[v];
    __syncthreads();
    if (threadIdx.x < lt && active) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        double s = 0.0;
        for (int q = 0; q < rows; ++q) s += part[(q * lt + col) * V + v];
        partial[(int64_t)blockIdx.x * f + j + v] = s;
      }
    }
  }
}

// db[lane] = sum over p of partial[p, lane], in float64, rounded once: one
// CTA a lane, a strided sum a thread, then a pairwise tree in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
    complex_bias_sum_kernel(const double* __restrict__ partial, int n_parts,
                           int f, float* __restrict__ db) {
  __shared__ double s[kReduceThreads];
  const int lane = blockIdx.x;
  double sum = 0.0;
  for (int p = threadIdx.x; p < n_parts; p += kReduceThreads)
    sum += partial[(int64_t)p * f + lane];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) db[lane] = (float)s[0];
}

bool plan_ok(int64_t n, int f, int vec, int lt, int ctas) {
  return n > 0 && f > 0 && (vec == 1 || (vec == 4 && f % 4 == 0)) &&
         lt >= 1 && lt <= kThreads && (lt & (lt - 1)) == 0 && ctas > 0;
}

dim3 grid_of(int f, int vec, int lt, int ctas) {
  const int groups = f / vec;
  return dim3(ctas, (groups + lt - 1) / lt);
}

template <int V>
void forward_dispatch(const float* y, const float* b, float* z, uint8_t* mask,
                      int64_t n, int f, int act, int lt, int ctas,
                      cudaStream_t s) {
  const dim3 grid = grid_of(f, V, lt, ctas);
#define PGSD_EPI(ACT, BIAS) \
  complex_epilogue_kernel<V, ACT, BIAS><<<grid, kThreads, 0, s>>>(y, b, z, mask, n, f, lt)
  if (act) {
    if (b) PGSD_EPI(true, true); else PGSD_EPI(true, false);
  } else {
    if (b) PGSD_EPI(false, true); else PGSD_EPI(false, false);
  }
#undef PGSD_EPI
}

template <int V>
void backward_dispatch(const float* dz, const uint8_t* mask, float* uv,
                       double* partial, int64_t n, int f, int lt, int ctas,
                       cudaStream_t s) {
  const dim3 grid = grid_of(f, V, lt, ctas);
#define PGSD_EPI_BW(MASK, BIAS)                                    \
  complex_epilogue_backward_kernel<V, MASK, BIAS><<<grid, kThreads, 0, s>>>( \
      dz, mask, uv, partial, n, f, lt)
  if (mask) {
    if (partial) PGSD_EPI_BW(true, true); else PGSD_EPI_BW(true, false);
  } else {
    if (partial) PGSD_EPI_BW(false, true); else PGSD_EPI_BW(false, false);
  }
#undef PGSD_EPI_BW
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream` is
// a cudaStream_t.  y, z, dz and uv are [n, 2f] float32, contiguous; mask
// [n, f] bytes; b and db [f] float32.  The plan: `vec` lanes a thread (4
// needs f % 4 == 0 and 16-byte aligned rows), `lt` threads across a row (a
// power of two, at most 256), `ctas` CTAs along the rows; the backward's
// `partial` is scratch of ctas * f doubles.  Each entry returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it does not take).

extern "C" int pgsd_complex_epilogue(const void* y, const void* b, void* z,
                                     void* mask, int64_t n, int f, int act,
                                     int vec, int lt, int ctas,
                                     void* stream) {
  if (!plan_ok(n, f, vec, lt, ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yp = static_cast<const float*>(y);
  const float* bp = static_cast<const float*>(b);
  float* zp = static_cast<float*>(z);
  uint8_t* mp = static_cast<uint8_t*>(mask);
  if (vec == 4)
    forward_dispatch<4>(yp, bp, zp, mp, n, f, act, lt, ctas, s);
  else
    forward_dispatch<1>(yp, bp, zp, mp, n, f, act, lt, ctas, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgsd_complex_epilogue_backward(const void* dz,
                                              const void* mask, void* uv,
                                              void* partial, void* db,
                                              int64_t n, int f, int vec,
                                              int lt, int ctas,
                                              void* stream) {
  if (!plan_ok(n, f, vec, lt, ctas) || (partial == nullptr) != (db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(dz);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  float* up = static_cast<float*>(uv);
  double* pp = static_cast<double*>(partial);
  if (vec == 4)
    backward_dispatch<4>(dp, mp, up, pp, n, f, lt, ctas, s);
  else
    backward_dispatch<1>(dp, mp, up, pp, n, f, lt, ctas, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  complex_bias_sum_kernel<<<f, kReduceThreads, 0, s>>>(
      pp, ctas, f, static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}
