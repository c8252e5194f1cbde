// Row-sorted (CSR) segment sums for Hopper (sm_90a).
//
// Replaces two TPU kernels of pytorch_geometric_signed_directed_tpu/ops/
// pallas/scatter_mxu.py:
//   K1  `_kernel` and its launcher `_scatter_matmul`, which turn a sorted
//       segment sum into one-hot matmuls over 128-512-row windows because
//       the TPU's matrix unit is cheap and its row scatter is not;
//   K2  `_kernel_accum` and `_scatter_accum`, the same sum accumulating
//       into an output that already holds values (the aliased output of
//       the column-split and streamed giant-graph layouts).
// On the card neither TPU reason holds: the sum is a row-sorted gather-
// multiply-reduce, one group of threads for each output row, no atomics.
//
// Four entry points:
//
//   pgsd_csr_dual_spmm         out[r, l] = sum_{e in row r} m[e, l],
//                              m[e, l] = msg((l < fa ? val_a[e] : val_b[e])
//                                            * x[col[e], l])
//                              the gather, the lane-selected multiply and
//                              K1's segment sum fused; the MagNet path's
//                              apply, forward and (on the transposed CSR)
//                              backward.
//   pgsd_csr_scatter_sum       out[r, l] = sum_{e in row r} msgs[e, l]
//                              K1's own contract, for row-sorted messages.
//   pgsd_csr_dual_spmm_accum   out[row0 + r, l] += sum_{e in row r} m[e, l]
//                              over one block of a split or streamed layout
//                              (local rowptr, a row offset); K2.
//   pgsd_csr_scatter_accum     out[row0 + r, l] += sum_{e in row r}
//                              msgs[e, l]; K2's own contract.
//
// msg() rounds the product to the message type: f32, or bf16 when x (or
// msgs) is bf16.  Sums are f32, in edge order, compensated (Kahan): a
// power-law hub row of 3*10^5 edges summed plainly in f32 drifts by about
// 1e-5 of its value; the compensation keeps every row within a few ulp of
// the exact sum of its rounded messages.  The plain modes write
// every row, so a row without edges comes out 0 (K1's `visited` mask);
// the accumulate modes start each row's sum from its prior value and do
// not touch a row the block has no edge for.  A row split over two blocks
// cannot race: blocks launch in order on one stream.
//
// What bounds it: bytes.  Per apply the work must read col, val_a and
// val_b once (12 B per edge), rowptr, x once and write out once (and, in
// the accumulate modes, read out once); the arithmetic (2 flops per edge
// and lane) is far below the f32 rate.  The design keeps that traffic
// close to the least: each group loads one edge's (col, val_a, val_b) per
// thread in one coalesced load and passes them to the group by warp
// shuffles; the row of x that an edge gathers is read by neighbouring
// threads from neighbouring addresses; the output is written once,
// coalesced, with no zero-fill pass.  What it cannot avoid is that x rows
// are gathered once per edge; x (or the hot table of a split layout) is
// small enough to stay in L2 at the path's sizes, so most of those
// re-reads are served from L2.  One group walks one row serially, so a
// hub row of 10^5 edges sets a block's time on its own; load balancing by
// degree, TMA and wgmma are left for later work.

#include "csr_common.cuh"

namespace {

using namespace pgsd;

// ACCUM: start from out[row0 + row] and leave rows without edges alone.
template <typename T, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(kBlock) csr_dual_spmm_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const float* __restrict__ val_a, const float* __restrict__ val_b,
    const T* __restrict__ x, float* __restrict__ out, int n_rows,
    int width, int fa, int row0) {
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  if (row >= n_rows) return;  // the whole group leaves together
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (ACCUM && start == end) return;
  const unsigned mask = group_mask<G>();
  const int f0 = blockIdx.y * (G * KS) + t;
  float* o = out + ((int64_t)row0 + row) * width;
  float acc[KS], cmp[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    acc[k] = (ACCUM && f < width) ? o[f] : 0.f;
    cmp[k] = 0.f;
  }
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
          kahan_add(acc[k], cmp[k],
                    round_msg<T>(__fmul_rn(f < fa ? aj : bj, to_f32(xr[f]))));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    if (f < width) o[f] = acc[k];
  }
}

template <typename T, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(kBlock) csr_scatter_sum_kernel(
    const int* __restrict__ rowptr, const T* __restrict__ msgs,
    float* __restrict__ out, int n_rows, int width, int row0) {
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  if (row >= n_rows) return;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (ACCUM && start == end) return;
  const int f0 = blockIdx.y * (G * KS) + t;
  float* o = out + ((int64_t)row0 + row) * width;
  float acc[KS], cmp[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    acc[k] = (ACCUM && f < width) ? o[f] : 0.f;
    cmp[k] = 0.f;
  }
  for (int e = start; e < end; ++e) {
    const T* m = msgs + (int64_t)e * width;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int f = f0 + k * G;
      if (f < width) kahan_add(acc[k], cmp[k], to_f32(m[f]));
    }
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    if (f < width) o[f] = acc[k];
  }
}

template <typename T, bool ACCUM>
void dual_dispatch(const int* rowptr, const int* col, const float* va,
                   const float* vb, const T* x, float* out, int n, int w,
                   int fa, int row0, cudaStream_t s) {
#define PGSD_DUAL(G, KS)                                                   \
  csr_dual_spmm_kernel<T, G, KS, ACCUM>                                    \
      <<<grid_for<G, KS>(n, w), kBlock, 0, s>>>(rowptr, col, va, vb, x,    \
                                                out, n, w, fa, row0)
  PGSD_DISPATCH_WIDTH(w, PGSD_DUAL);
#undef PGSD_DUAL
}

template <typename T, bool ACCUM>
void scatter_dispatch(const int* rowptr, const T* msgs, float* out, int n,
                      int w, int row0, cudaStream_t s) {
#define PGSD_SCATTER(G, KS)                                                 \
  csr_scatter_sum_kernel<T, G, KS, ACCUM>                                   \
      <<<grid_for<G, KS>(n, w), kBlock, 0, s>>>(rowptr, msgs, out, n, w,    \
                                                row0)
  PGSD_DISPATCH_WIDTH(w, PGSD_SCATTER);
#undef PGSD_SCATTER
}

template <bool ACCUM>
int dual_entry(const void* rowptr, const void* col, const void* val_a,
               const void* val_b, const void* x, void* out, int n_rows,
               int width, int fa, int x_is_bf16, int row0, void* stream) {
  if (n_rows > 0 && width > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(rowptr);
    const int* c = static_cast<const int*>(col);
    const float* va = static_cast<const float*>(val_a);
    const float* vb = static_cast<const float*>(val_b);
    float* o = static_cast<float*>(out);
    if (x_is_bf16)
      dual_dispatch<__nv_bfloat16, ACCUM>(
          rp, c, va, vb, static_cast<const __nv_bfloat16*>(x), o, n_rows,
          width, fa, row0, s);
    else
      dual_dispatch<float, ACCUM>(rp, c, va, vb,
                                  static_cast<const float*>(x), o, n_rows,
                                  width, fa, row0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool ACCUM>
int scatter_entry(const void* rowptr, const void* msgs, void* out,
                  int n_rows, int width, int msgs_is_bf16, int row0,
                  void* stream) {
  if (n_rows > 0 && width > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(rowptr);
    float* o = static_cast<float*>(out);
    if (msgs_is_bf16)
      scatter_dispatch<__nv_bfloat16, ACCUM>(
          rp, static_cast<const __nv_bfloat16*>(msgs), o, n_rows, width,
          row0, s);
    else
      scatter_dispatch<float, ACCUM>(rp, static_cast<const float*>(msgs), o,
                                     n_rows, width, row0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  Each returns cudaGetLastError() after the launch.

extern "C" int pgsd_csr_dual_spmm(const void* rowptr, const void* col,
                                  const void* val_a, const void* val_b,
                                  const void* x, void* out, int n_rows,
                                  int width, int fa, int x_is_bf16,
                                  void* stream) {
  return dual_entry<false>(rowptr, col, val_a, val_b, x, out, n_rows, width,
                           fa, x_is_bf16, 0, stream);
}

extern "C" int pgsd_csr_scatter_sum(const void* rowptr, const void* msgs,
                                    void* out, int n_rows, int width,
                                    int msgs_is_bf16, void* stream) {
  return scatter_entry<false>(rowptr, msgs, out, n_rows, width, msgs_is_bf16,
                              0, stream);
}

extern "C" int pgsd_csr_dual_spmm_accum(const void* rowptr, const void* col,
                                        const void* val_a, const void* val_b,
                                        const void* x, void* out, int n_rows,
                                        int width, int fa, int x_is_bf16,
                                        int row0, void* stream) {
  return dual_entry<true>(rowptr, col, val_a, val_b, x, out, n_rows, width,
                          fa, x_is_bf16, row0, stream);
}

extern "C" int pgsd_csr_scatter_accum(const void* rowptr, const void* msgs,
                                      void* out, int n_rows, int width,
                                      int msgs_is_bf16, int row0,
                                      void* stream) {
  return scatter_entry<true>(rowptr, msgs, out, n_rows, width, msgs_is_bf16,
                             row0, stream);
}
