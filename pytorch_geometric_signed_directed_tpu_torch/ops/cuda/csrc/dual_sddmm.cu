// Fused scatter + SDDMM for the trainable-q backward on Hopper (sm_90a).
//
// Replaces two TPU kernels of pytorch_geometric_signed_directed_tpu/ops/
// pallas/scatter_mxu.py:
//   K3  `_dual_bwd_kernel` (math `_dual_bwd_math`, launcher
//       `_dual_bwd_matmul`, entry `dual_scatter_sddmm`): one pass over a
//       row-sorted operator with two outputs, the transposed apply of a
//       cotangent and the lane partials of its derivative by a scalar;
//   K4  `_dual_bwd_kernel_accum` (`_dual_bwd_accum`): K3 seeded from an
//       aliased prior (out, acc), for the blocks of a split or streamed
//       layout.
// The TPU kernels take a pre-gathered [E2, 2F] cotangent and contract it
// with one-hot matmuls; here one group of threads walks each row's edges,
// gathers g[col[e]] itself and keeps both sums in registers.
//
// For every row r of the operator (edges e in [rowptr[r], rowptr[r+1])):
//
//   out[row0 + r, l] = sum_e msg(sel_l(va, vb)[e] * g[col[e], l])
//   m[l]             = sum_e sel_l(wa, wb)[e] * g[col[e], l]
//   partial[cta, l] += x[row0 + r, l] * m[l]
//   acc[l]           = sum over CTAs of partial[cta, l]     (second launch)
//
// sel_l picks the a-value for lanes l < fa.  msg() rounds the apply's
// product to the type of g (f32 or bf16), as the forward kernels round
// their messages; the dq products stay in f32.  Both sums are f32 in edge
// order, compensated (kahan_add), so a hub row stays within a few ulp of
// the exact sum.  The dq fold is float64: x[r, l] * m[l] (with m's
// compensation) is exact in double, the partials of the rows of one CTA
// are summed in row order in shared memory, and a second launch sums the
// CTAs' partials in a fixed order (a strided sum per thread, then a
// pairwise tree) and rounds once to f32.  acc sums a product over every
// row: in f32 its rounding alone would be ~1e-5 of a lane whose terms
// cancel.  No float atomics, so every run gives the same bits, as K1 and
// K2 do.  The plain mode writes every row (a row without edges gives 0)
// and sets acc; the accumulate mode (K4) starts each row from out's prior
// value, leaves rows without edges untouched and adds into acc.
//
// What bounds it: bytes.  Per call the work reads rowptr, the 20 bytes of
// (col, va, vb, wa, wb) per edge, the g table and x once, and writes out
// once; the arithmetic (4 flops per edge and lane) is far below the f32
// rate.  The design keeps the traffic near the least, as K1 does: one
// coalesced load of an edge's five words per thread, passed to the group
// by shuffles; g rows read by neighbouring threads from neighbouring
// addresses; out written once; x read once, by the row's own group.  It
// cannot avoid gathering a g row once per edge (L2 serves most of those
// re-reads at the path's sizes), and one group walks a hub row serially;
// load balancing by degree is left for later work, as in K1.

#include "csr_common.cuh"

namespace {

using namespace pgsd;

constexpr int kReduceBlock = 256;

template <typename T, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(kBlock) csr_dual_sddmm_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const float* __restrict__ va, const float* __restrict__ vb,
    const float* __restrict__ wa, const float* __restrict__ wb,
    const T* __restrict__ g, const float* __restrict__ x,
    float* __restrict__ out, double* __restrict__ partial, int n_rows,
    int width, int fa, int row0) {
  // [row of this CTA][lane of this feature tile]
  __shared__ double part[kBlock * KS];
  const int t = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int row = blockIdx.x * (kBlock / G) + slot;
  const int f0 = blockIdx.y * (G * KS) + t;
  int start = 0, end = 0;
  if (row < n_rows) {  // groups past the last row still join the CTA sum
    start = rowptr[row];
    end = rowptr[row + 1];
  }
  const int64_t orow = ((int64_t)row0 + row) * width;
  float d[KS], dc[KS], m[KS], mc[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    d[k] = (ACCUM && start < end && f < width) ? out[orow + f] : 0.f;
    dc[k] = m[k] = mc[k] = 0.f;
  }
  const unsigned mask = group_mask<G>();
  for (int base = start; base < end; base += G) {
    const int e = base + t;
    int c = 0;
    float a = 0.f, b = 0.f, p = 0.f, q = 0.f;
    if (e < end) {
      c = col[e];
      a = va[e];
      b = vb[e];
      p = wa[e];
      q = wb[e];
    }
    const int n = min(G, end - base);
    for (int j = 0; j < n; ++j) {
      const int cj = __shfl_sync(mask, c, j, G);
      const float aj = __shfl_sync(mask, a, j, G);
      const float bj = __shfl_sync(mask, b, j, G);
      const float pj = __shfl_sync(mask, p, j, G);
      const float qj = __shfl_sync(mask, q, j, G);
      const T* gr = g + (int64_t)cj * width;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int f = f0 + k * G;
        if (f < width) {
          const float gv = to_f32(gr[f]);
          const bool lo = f < fa;
          kahan_add(d[k], dc[k], round_msg<T>(__fmul_rn(lo ? aj : bj, gv)));
          kahan_add(m[k], mc[k], __fmul_rn(lo ? pj : qj, gv));
        }
      }
    }
  }
  const bool write = row < n_rows && (!ACCUM || start < end);
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    const bool live = row < n_rows && f < width;
    if (write && f < width) out[orow + f] = d[k];
    // kahan_add leaves the sum's lost low part in -mc
    part[slot * (G * KS) + k * G + t] =
        live ? (double)x[orow + f] * ((double)m[k] - (double)mc[k]) : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < G * KS) {
    const int f = blockIdx.y * (G * KS) + threadIdx.x;
    double s = 0.0;
    for (int r = 0; r < kBlock / G; ++r)
      s += part[r * (G * KS) + threadIdx.x];
    if (f < width) partial[(int64_t)blockIdx.x * width + f] = s;
  }
}

// acc[f] (+)= sum over p of partial[p, f], in float64, rounded once: one
// CTA per lane, a strided sum per thread, then a pairwise tree in a fixed
// order.
__global__ void __launch_bounds__(kReduceBlock) reduce_partials_kernel(
    const double* __restrict__ partial, int n_parts, int width,
    float* __restrict__ acc, int accumulate) {
  __shared__ double s[kReduceBlock];
  const int f = blockIdx.x;
  double sum = 0.0;
  for (int p = threadIdx.x; p < n_parts; p += kReduceBlock)
    sum += partial[(int64_t)p * width + f];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = kReduceBlock / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    acc[f] = (float)(accumulate ? (double)acc[f] + s[0] : s[0]);
}

template <int G, int KS>
int parts_for(int n_rows) {
  return (n_rows + kBlock / G - 1) / (kBlock / G);
}

int n_parts(int n_rows, int w) {
#define PGSD_PARTS(G, KS) return parts_for<G, KS>(n_rows)
  PGSD_DISPATCH_WIDTH(w, PGSD_PARTS);
#undef PGSD_PARTS
}

template <typename T, bool ACCUM>
void sddmm_dispatch(const int* rowptr, const int* col, const float* va,
                    const float* vb, const float* wa, const float* wb,
                    const T* g, const float* x, float* out, double* partial,
                    int n, int w, int fa, int row0, cudaStream_t s) {
#define PGSD_SDDMM(G, KS)                                                  \
  csr_dual_sddmm_kernel<T, G, KS, ACCUM>                                   \
      <<<grid_for<G, KS>(n, w), kBlock, 0, s>>>(rowptr, col, va, vb, wa,   \
                                                wb, g, x, out, partial, n, \
                                                w, fa, row0)
  PGSD_DISPATCH_WIDTH(w, PGSD_SDDMM);
#undef PGSD_SDDMM
}

template <bool ACCUM>
int sddmm_entry(const void* rowptr, const void* col, const void* va,
                const void* vb, const void* wa, const void* wb, const void* g,
                const void* x, void* out, void* acc, void* partial,
                int n_rows, int width, int fa, int g_is_bf16, int row0,
                void* stream) {
  if (n_rows > 0 && width > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(rowptr);
    const int* c = static_cast<const int*>(col);
    const float* a = static_cast<const float*>(va);
    const float* b = static_cast<const float*>(vb);
    const float* p = static_cast<const float*>(wa);
    const float* q = static_cast<const float*>(wb);
    const float* xr = static_cast<const float*>(x);
    float* o = static_cast<float*>(out);
    double* part = static_cast<double*>(partial);
    if (g_is_bf16)
      sddmm_dispatch<__nv_bfloat16, ACCUM>(
          rp, c, a, b, p, q, static_cast<const __nv_bfloat16*>(g), xr, o,
          part, n_rows, width, fa, row0, s);
    else
      sddmm_dispatch<float, ACCUM>(rp, c, a, b, p, q,
                                   static_cast<const float*>(g), xr, o, part,
                                   n_rows, width, fa, row0, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_partials_kernel<<<width, kReduceBlock, 0, s>>>(
        part, n_parts(n_rows, width), width, static_cast<float*>(acc),
        ACCUM ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  `partial` is scratch of
// pgsd_csr_dual_sddmm_parts(n_rows, width) * width doubles.  The sddmm
// entries launch the row kernel and the partials' sum and return
// cudaGetLastError().

extern "C" int pgsd_csr_dual_sddmm_parts(int n_rows, int width) {
  return n_rows > 0 && width > 0 ? n_parts(n_rows, width) : 0;
}

extern "C" int pgsd_csr_dual_sddmm(const void* rowptr, const void* col,
                                   const void* va, const void* vb,
                                   const void* wa, const void* wb,
                                   const void* g, const void* x, void* out,
                                   void* acc, void* partial, int n_rows,
                                   int width, int fa, int g_is_bf16,
                                   void* stream) {
  return sddmm_entry<false>(rowptr, col, va, vb, wa, wb, g, x, out, acc,
                            partial, n_rows, width, fa, g_is_bf16, 0, stream);
}

extern "C" int pgsd_csr_dual_sddmm_accum(const void* rowptr, const void* col,
                                         const void* va, const void* vb,
                                         const void* wa, const void* wb,
                                         const void* g, const void* x,
                                         void* out, void* acc, void* partial,
                                         int n_rows, int width, int fa,
                                         int g_is_bf16, int row0,
                                         void* stream) {
  return sddmm_entry<true>(rowptr, col, va, vb, wa, wb, g, x, out, acc,
                           partial, n_rows, width, fa, g_is_bf16, row0,
                           stream);
}
