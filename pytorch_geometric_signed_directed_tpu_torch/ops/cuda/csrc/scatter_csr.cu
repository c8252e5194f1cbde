// Row-sorted (CSR) segment sums for Hopper (sm_90a).
//
// Replaces the TPU kernel K1: pytorch_geometric_signed_directed_tpu/ops/
// pallas/scatter_mxu.py `_kernel` and its launcher `_scatter_matmul`, which
// turn a sorted segment sum into one-hot matmuls over 128-512-row windows
// because the TPU's matrix unit is cheap and its row scatter is not.  On
// the card neither holds: the same sum is a row-sorted gather-multiply-
// reduce, one group of threads for each output row, with no atomics.
//
// Two entry points:
//
//   pgsd_csr_dual_spmm   out[r, l] = sum_{e in row r} m[e, l],
//                        m[e, l] = msg((l < fa ? val_a[e] : val_b[e]) *
//                                      x[col[e], l])
//                        the gather, the lane-selected multiply and K1's
//                        segment sum fused; the MagNet path's apply, forward
//                        and (on the transposed CSR) backward.
//   pgsd_csr_scatter_sum out[r, l] = sum_{e in row r} msgs[e, l]
//                        K1's own contract, for row-sorted messages.
//
// msg() rounds the product to the message type: f32, or bf16 when x (or
// msgs) is bf16.  Sums are f32, in edge order, and every row is written,
// so a row without edges comes out 0 (K1's `visited` mask).
//
// What bounds it: bytes.  Per apply the work must read col, val_a and
// val_b once (12 B per edge), rowptr, x once and write out once; the
// arithmetic (2 flops per edge and lane) is far below the f32 rate.  The
// design keeps that traffic close to the least: each group loads one
// edge's (col, val_a, val_b) per thread in one coalesced load and passes
// them to the group by warp shuffles; the row of x that an edge gathers is
// read by neighbouring threads from neighbouring addresses; the output is
// written once, coalesced, with no zero-fill pass.  What it cannot avoid
// is that x rows are gathered once per edge; x itself is small enough to
// stay in L2 at the main path's sizes, so those re-reads are served from
// L2, not device memory.  Load balancing by degree, TMA and wgmma are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a product to the message type (f32 products are already rounded:
// __fmul_rn keeps the compiler from fusing them into the sum).
template <typename T>
__device__ __forceinline__ float round_msg(float v);
template <>
__device__ __forceinline__ float round_msg<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_msg<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// G threads (a group, G divides 32) own one output row; thread t of the
// group owns lanes f0 + k*G, k < KS, of the feature tile blockIdx.y.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned ones = G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u);
  return ones << (((threadIdx.x & 31) / G) * G);
}

template <typename T, int G, int KS>
__global__ void __launch_bounds__(kBlock) csr_dual_spmm_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const float* __restrict__ val_a, const float* __restrict__ val_b,
    const T* __restrict__ x, float* __restrict__ out, int n_rows,
    int width, int fa) {
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  if (row >= n_rows) return;  // the whole group leaves together
  const unsigned mask = group_mask<G>();
  const int f0 = blockIdx.y * (G * KS) + t;
  float acc[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) acc[k] = 0.f;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int base = start; base < end; base += G) {
    const int e = base + t;
    int c = 0;
    float a = 0.f, b = 0.f;
    if (e < end) {
      c = col[e];
      a = val_a[e];
      b = val_b[e];
    }
    const int n = min(G, end - base);
    for (int j = 0; j < n; ++j) {
      const int cj = __shfl_sync(mask, c, j, G);
      const float aj = __shfl_sync(mask, a, j, G);
      const float bj = __shfl_sync(mask, b, j, G);
      const T* xr = x + (int64_t)cj * width;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int f = f0 + k * G;
        if (f < width)
          acc[k] += round_msg<T>(__fmul_rn(f < fa ? aj : bj, to_f32(xr[f])));
      }
    }
  }
  float* o = out + (int64_t)row * width;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    if (f < width) o[f] = acc[k];
  }
}

template <typename T, int G, int KS>
__global__ void __launch_bounds__(kBlock) csr_scatter_sum_kernel(
    const int* __restrict__ rowptr, const T* __restrict__ msgs,
    float* __restrict__ out, int n_rows, int width) {
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  if (row >= n_rows) return;
  const int f0 = blockIdx.y * (G * KS) + t;
  float acc[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) acc[k] = 0.f;
  const int end = rowptr[row + 1];
  for (int e = rowptr[row]; e < end; ++e) {
    const T* m = msgs + (int64_t)e * width;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int f = f0 + k * G;
      if (f < width) acc[k] += to_f32(m[f]);
    }
  }
  float* o = out + (int64_t)row * width;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    if (f < width) o[f] = acc[k];
  }
}

template <int G, int KS>
dim3 grid_for(int n_rows, int width) {
  return dim3((n_rows + kBlock / G - 1) / (kBlock / G),
              (width + G * KS - 1) / (G * KS));
}

// Narrow widths pack several rows into a warp (G < 32); wide ones give
// each thread up to 8 lanes and tile anything past 256 over blockIdx.y.
template <typename T>
void dual_dispatch(const int* rowptr, const int* col, const float* va,
                   const float* vb, const T* x, float* out, int n, int w,
                   int fa, cudaStream_t s) {
#define PGSD_DUAL(G, KS)                                                   \
  csr_dual_spmm_kernel<T, G, KS><<<grid_for<G, KS>(n, w), kBlock, 0, s>>>( \
      rowptr, col, va, vb, x, out, n, w, fa)
  if (w <= 4) PGSD_DUAL(4, 1);
  else if (w <= 8) PGSD_DUAL(8, 1);
  else if (w <= 16) PGSD_DUAL(16, 1);
  else if (w <= 32) PGSD_DUAL(32, 1);
  else if (w <= 64) PGSD_DUAL(32, 2);
  else if (w <= 128) PGSD_DUAL(32, 4);
  else PGSD_DUAL(32, 8);
#undef PGSD_DUAL
}

template <typename T>
void scatter_dispatch(const int* rowptr, const T* msgs, float* out, int n,
                      int w, cudaStream_t s) {
#define PGSD_SCATTER(G, KS)                                                 \
  csr_scatter_sum_kernel<T, G, KS><<<grid_for<G, KS>(n, w), kBlock, 0, s>>>( \
      rowptr, msgs, out, n, w)
  if (w <= 4) PGSD_SCATTER(4, 1);
  else if (w <= 8) PGSD_SCATTER(8, 1);
  else if (w <= 16) PGSD_SCATTER(16, 1);
  else if (w <= 32) PGSD_SCATTER(32, 1);
  else if (w <= 64) PGSD_SCATTER(32, 2);
  else if (w <= 128) PGSD_SCATTER(32, 4);
  else PGSD_SCATTER(32, 8);
#undef PGSD_SCATTER
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  Each returns cudaGetLastError() after the launch.

extern "C" int pgsd_csr_dual_spmm(const void* rowptr, const void* col,
                                  const void* val_a, const void* val_b,
                                  const void* x, void* out, int n_rows,
                                  int width, int fa, int x_is_bf16,
                                  void* stream) {
  if (n_rows > 0 && width > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(rowptr);
    const int* c = static_cast<const int*>(col);
    const float* va = static_cast<const float*>(val_a);
    const float* vb = static_cast<const float*>(val_b);
    float* o = static_cast<float*>(out);
    if (x_is_bf16)
      dual_dispatch(rp, c, va, vb, static_cast<const __nv_bfloat16*>(x), o,
                    n_rows, width, fa, s);
    else
      dual_dispatch(rp, c, va, vb, static_cast<const float*>(x), o, n_rows,
                    width, fa, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pgsd_csr_scatter_sum(const void* rowptr, const void* msgs,
                                    void* out, int n_rows, int width,
                                    int msgs_is_bf16, void* stream) {
  if (n_rows > 0 && width > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(rowptr);
    float* o = static_cast<float*>(out);
    if (msgs_is_bf16)
      scatter_dispatch(rp, static_cast<const __nv_bfloat16*>(msgs), o,
                       n_rows, width, s);
    else
      scatter_dispatch(rp, static_cast<const float*>(msgs), o, n_rows,
                       width, s);
  }
  return static_cast<int>(cudaGetLastError());
}
