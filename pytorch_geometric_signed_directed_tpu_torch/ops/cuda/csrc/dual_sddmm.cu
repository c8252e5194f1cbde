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
// with one-hot matmuls; here a group of threads walks each row's edges,
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
// rate.  It cannot avoid gathering a g row once per edge (L2 serves most
// of those re-reads at the path's sizes).
//
// What held it back, and the design against it (as for K1/K2 in
// scatter_csr.cu):
//   * The edge walk is csr_common.cuh's PairSource, shared with the pair
//     forward: each chunk's five words are staged in shared memory by
//     coalesced loads and read back with broadcast loads (five warp
//     shuffles an edge made the first version issue-bound), and 8 gathers
//     of g (4 at 8 lanes a thread) are issued before any is added, then
//     added in edge order.
//   * Rows longer than piece_len edges (hubs) are cut into pieces by the
//     rowptr's RowSplit plan.  The first CTAs give one piece to each group:
//     the piece writes its out sum as one float64 partial, which the
//     fixed-order combine of the cut rows finishes, and adds its dq term
//     x[r] * m_piece into its CTA's slot as a row does.  That term is
//     linear in m, so the sum is the same in exact arithmetic, and the
//     fixed grid order keeps the bits the same from call to call.

#include "csr_common.cuh"

namespace {

using namespace pgsd;

constexpr int kReduceBlock = 256;

template <typename T, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(
    kBlock, (PairSource<T, G, KS, false>::MIN_CTAS)) csr_dual_sddmm_kernel(
    PairSource<T, G, KS, false> src, const int* __restrict__ rowptr, Split sp,
    const float* __restrict__ x, float* __restrict__ out,
    double* __restrict__ partial, int n_rows, int width, int row0) {
  constexpr int kSlots = kBlock / G;  // groups of a CTA
  // [group of this CTA][lane of this feature tile]
  __shared__ double part[kBlock * KS];
  const int t = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int piece_ctas = (sp.n_pieces + kSlots - 1) / kSlots;
  const int f0 = blockIdx.y * (G * KS) + t;
  float acc[2 * KS], cmp[2 * KS];
#pragma unroll
  for (int k = 0; k < 2 * KS; ++k) acc[k] = cmp[k] = 0.f;
  int xrow = -1;  // the row whose x multiplies this group's m (-1: none)
  if ((int)blockIdx.x < piece_ctas) {
    const int p = blockIdx.x * kSlots + slot;
    if (p < sp.n_pieces) {
      const int2 pc = sp.pieces[p];
      src.sum(pc.x, pc.y, width, f0, acc, cmp);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int f = f0 + k * G;
        // kahan_add leaves the sum's lost low part in -cmp
        if (f < width)
          sp.partial[(int64_t)p * width + f] =
              (double)acc[k] - (double)cmp[k];
      }
      xrow = sp.rows[piece_owner(sp, p)];
    }
  } else {
    const int row = (blockIdx.x - piece_ctas) * kSlots + slot;
    int start = 0, end = 0;
    if (row < n_rows) {
      start = rowptr[row];
      end = rowptr[row + 1];
    }
    if (row < n_rows && end - start <= sp.piece_len) {
      float* o = out + ((int64_t)row0 + row) * width;
      if (ACCUM && start < end) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int f = f0 + k * G;
          if (f < width) acc[k] = o[f];
        }
      }
      src.sum(start, end, width, f0, acc, cmp);
      if (!ACCUM || start < end) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int f = f0 + k * G;
          if (f < width) o[f] = acc[k];
        }
      }
      xrow = row;
    }
  }
  // every group, idle or not, fills its slot before the CTA's sum
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    const bool live = xrow >= 0 && f < width;
    part[slot * (G * KS) + k * G + t] =
        live ? (double)x[((int64_t)row0 + xrow) * width + f] *
                   ((double)acc[KS + k] - (double)cmp[KS + k])
             : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < G * KS) {
    const int f = blockIdx.y * (G * KS) + threadIdx.x;
    double s = 0.0;
    for (int r = 0; r < kSlots; ++r) s += part[r * (G * KS) + threadIdx.x];
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

// CTAs of the row kernel: the piece CTAs, then the row CTAs.
template <int G, int KS>
int parts_for(int n_rows, int n_pieces) {
  constexpr int kSlots = kBlock / G;
  return (n_pieces + kSlots - 1) / kSlots + (n_rows + kSlots - 1) / kSlots;
}

int n_parts(int n_rows, int w, int n_pieces) {
#define PGSD_PARTS(G, KS) return parts_for<G, KS>(n_rows, n_pieces)
  PGSD_DISPATCH_WIDTH(w, PGSD_PARTS);
#undef PGSD_PARTS
}

template <typename T, bool ACCUM>
void sddmm_dispatch(const int* rowptr, const int* col, const float* va,
                    const float* vb, const float* wa, const float* wb,
                    const T* g, const float* x, const Split& sp, float* out,
                    double* partial, int n, int w, int fa, int row0,
                    cudaStream_t s) {
#define PGSD_SDDMM(G, KS)                                                     \
  csr_dual_sddmm_kernel<T, G, KS, ACCUM>                                      \
      <<<dim3(parts_for<G, KS>(n, sp.n_pieces), (w + G * KS - 1) / (G * KS)), \
         kBlock, 0, s>>>(PairSource<T, G, KS, false>{col, va, vb, wa, wb, g,  \
                                                     fa},                     \
                         rowptr, sp, x, out, partial, n, w, row0)
  PGSD_DISPATCH_WIDTH(w, PGSD_SDDMM);
#undef PGSD_SDDMM
}

template <bool ACCUM>
int sddmm_entry(const void* rowptr, const void* col, const void* va,
                const void* vb, const void* wa, const void* wb, const void* g,
                const void* x, void* out, void* acc, void* partial,
                int n_rows, int width, int fa, int g_is_bf16, int row0,
                const Split& sp, void* stream) {
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
          rp, c, a, b, p, q, static_cast<const __nv_bfloat16*>(g), xr, sp, o,
          part, n_rows, width, fa, row0, s);
    else
      sddmm_dispatch<float, ACCUM>(rp, c, a, b, p, q,
                                   static_cast<const float*>(g), xr, sp, o,
                                   part, n_rows, width, fa, row0, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_partials_kernel<<<width, kReduceBlock, 0, s>>>(
        part, n_parts(n_rows, width, sp.n_pieces), width,
        static_cast<float*>(acc), ACCUM ? 1 : 0);
    return combine(sp, o, width, row0, ACCUM, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  `partial` is scratch of
// pgsd_csr_dual_sddmm_parts(n_rows, width, n_pieces) * width doubles; the
// plan (pieces, rows, ptr, counts, piece_len, piece scratch of n_pieces *
// width doubles) is scatter_csr.py's RowSplit of this rowptr.  The sddmm
// entries launch the row kernel, the partials' sum and, if any row is cut,
// the combine, and return cudaGetLastError().

extern "C" int pgsd_csr_dual_sddmm_parts(int n_rows, int width,
                                         int n_pieces) {
  return n_rows > 0 && width > 0 ? n_parts(n_rows, width, n_pieces) : 0;
}

extern "C" int pgsd_csr_dual_sddmm(const void* rowptr, const void* col,
                                   const void* va, const void* vb,
                                   const void* wa, const void* wb,
                                   const void* g, const void* x, void* out,
                                   void* acc, void* partial, int n_rows,
                                   int width, int fa, int g_is_bf16,
                                   const void* pieces, int n_pieces,
                                   const void* rows, const void* ptr,
                                   int n_long, int piece_len,
                                   void* piece_partial, void* stream) {
  return sddmm_entry<false>(
      rowptr, col, va, vb, wa, wb, g, x, out, acc, partial, n_rows, width, fa,
      g_is_bf16, 0,
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, piece_partial),
      stream);
}

extern "C" int pgsd_csr_dual_sddmm_accum(
    const void* rowptr, const void* col, const void* va, const void* vb,
    const void* wa, const void* wb, const void* g, const void* x, void* out,
    void* acc, void* partial, int n_rows, int width, int fa, int g_is_bf16,
    int row0, const void* pieces, int n_pieces, const void* rows,
    const void* ptr, int n_long, int piece_len, void* piece_partial,
    void* stream) {
  return sddmm_entry<true>(
      rowptr, col, va, vb, wa, wb, g, x, out, acc, partial, n_rows, width, fa,
      g_is_bf16, row0,
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, piece_partial),
      stream);
}
