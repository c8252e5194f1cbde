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
// multiply-reduce with no atomics.
//
// Two entry points, each with a plain and an accumulate (K2) mode:
//
//   pgsd_csr_dual_spmm   out[row0 + r, l] (+)= sum_{e in row r} m[e, l],
//                        m[e, l] = msg((l < fa ? val_a[e] : val_b[e])
//                                      * x[col[e], l])
//                        the gather, the lane-selected multiply and K1's
//                        segment sum fused; the MagNet path's apply,
//                        forward and (on the transposed CSR) backward.
//   pgsd_csr_scatter     out[row0 + r, l] (+)= sum_{e in row r} msgs[e, l]
//                        K1's (and K2's) own contract.
//
// msg() rounds the product to the message type: f32, or bf16 when x (or
// msgs) is bf16.  Sums are f32 in edge order, compensated (Kahan): a
// power-law hub row of 3*10^5 edges summed plainly in f32 drifts by about
// 1e-5 of its value.  The plain mode writes every row, so a row without
// edges comes out 0 (K1's `visited` mask); the accumulate mode adds into
// each row's prior value and does not touch a row without edges.  A row
// split over two blocks of a streamed layout cannot race: blocks launch in
// order on one stream.
//
// What bounds it: bytes.  Per call the work must read col, val_a and val_b
// once (12 B per edge), rowptr, x once and write out once (and, in the
// accumulate mode, read it once); the arithmetic (2 flops per edge and
// lane) is far below the f32 rate.  Edges gather x rows, which neighbouring
// threads read from neighbouring addresses; x (or the hot table of a split
// layout) mostly stays in L2 at the path's sizes.
//
// What held it back, and the design against it.  A group of threads that
// walks one row waits one memory latency per edge (~200 ns from L2, ~310
// ns from HBM on an H100), so a power-law hub row of 2*10^5 edges took 60
// ms on its own while the rest of the card sat idle.  So:
//   * Rows longer than piece_len edges are cut into pieces of at most
//     piece_len edges.  The plan (the cut rows, their pieces in edge order)
//     is built once per CSR on the host side (scatter_csr.py,
//     plan_row_split) and passed in.  The first CTAs of the launch give one
//     piece to each group, which writes its compensated sum as one float64
//     (sum - compensation, exact in double) to a scratch buffer; the other
//     CTAs give one short row to each group and skip the cut rows.  A
//     second launch adds each cut row's pieces in piece order to the row's
//     prior value (0 in the plain mode) in float64 and rounds once.  No
//     float atomics: every call gives the same bits.
//   * A group keeps depth<KS>() (4 or 8) gathers in flight: it stages the
//     (col, val_a, val_b) of a chunk of edges in shared memory, loads the
//     next chunk's while it works on the current one, issues the x-row
//     loads of a batch of edges before it adds any of them, then adds them
//     in edge order.  A piece's chain is about piece_len / depth
//     latencies, tens of microseconds.

#include "csr_common.cuh"

namespace {

using namespace pgsd;

// Tuning by lanes per thread KS: the CTAs per SM that the register budget
// must leave room for, and the loads a thread keeps in flight before it
// adds them.  At two lanes (widths 33-64, the giant path's 2F=64) the many
// short rows wait on latency, so occupancy pays more than depth; narrower
// widths and long rows take the deeper batch (timed on an H100 with
// scripts/ab_kernel_variants.py).
template <int KS>
__host__ __device__ constexpr int min_ctas() {
  return KS == 2 ? 4 : 2;
}

template <int KS>
__host__ __device__ constexpr int depth() {
  return KS == 2 || KS >= 8 ? 4 : 8;
}

// The message source of pgsd_csr_dual_spmm: message l of edge e is
// round(sel_l(va, vb)[e] * x[col[e], l]).  A group stages a chunk of C
// edges' (col, va, vb) in shared memory with one coalesced load per thread;
// every thread then reads an edge's three words with one broadcast 16-byte
// load (three warp shuffles an edge made the loop issue-bound).
template <typename T, int G, int KS>
struct DualSource {
  static constexpr int D = depth<KS>();
  static constexpr int S = D > G ? D / G : 1;  // edges a thread loads a chunk
  static constexpr int C = G * S;              // edges of a chunk
  const int* col;
  const float* va;
  const float* vb;
  const T* x;
  int fa;

  __device__ __forceinline__ void load(int base, int e1, int t,
                                       int4 (&q)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = base + s * G + t;
      q[s] = e < e1 ? make_int4(col[e], __float_as_int(va[e]),
                                __float_as_int(vb[e]), 0)
                    : make_int4(0, 0, 0, 0);
    }
  }

  // Adds staged edges [j0, j0 + D) (FULL) or [j0, n): D gathers issued,
  // then added in edge order.
  template <bool FULL>
  __device__ __forceinline__ void batch(const int4* edges, int j0, int n,
                                        int width, int f0, float (&acc)[KS],
                                        float (&cmp)[KS]) const {
    float xv[D][KS], av[D], bv[D];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (FULL || j0 + u < n) {
        const int4 q = edges[j0 + u];
        av[u] = __int_as_float(q.y);
        bv[u] = __int_as_float(q.z);
        const T* xr = x + (int64_t)q.x * width;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int f = f0 + k * G;
          xv[u][k] = f < width ? to_f32(xr[f]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (FULL || j0 + u < n) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int f = f0 + k * G;
          if (f < width)
            kahan_add(acc[k], cmp[k],
                      round_msg<T>(__fmul_rn(f < fa ? av[u] : bv[u],
                                             xv[u][k])));
        }
      }
    }
  }

  // Adds the messages of edges [e0, e1) to (acc, cmp), in edge order.
  __device__ __forceinline__ void sum(int e0, int e1, int width, int f0,
                                      float (&acc)[KS],
                                      float (&cmp)[KS]) const {
    __shared__ int4 stage[kBlock * S];
    int4* edges = stage + (threadIdx.x / G) * C;  // this group's chunk
    const int t = threadIdx.x % G;
    const unsigned mask = group_mask<G>();
    int4 q[S];
    load(e0, e1, t, q);
    for (int base = e0; base < e1; base += C) {
#pragma unroll
      for (int s = 0; s < S; ++s) edges[s * G + t] = q[s];
      __syncwarp(mask);
      load(base + C, e1, t, q);  // the next chunk's edges, early
      const int n = min(C, e1 - base);
      int j0 = 0;
      for (; j0 + D <= n; j0 += D)
        batch<true>(edges, j0, n, width, f0, acc, cmp);
      if (j0 < n) batch<false>(edges, j0, n, width, f0, acc, cmp);
      __syncwarp(mask);  // every read of the chunk before the next is staged
    }
  }
};

// The message source of pgsd_csr_scatter: row-ordered messages.
template <typename T, int G, int KS>
struct MsgSource {
  static constexpr int D = depth<KS>();
  const T* msgs;

  template <bool FULL>
  __device__ __forceinline__ void batch(int base, int e1, int width, int f0,
                                        float (&acc)[KS],
                                        float (&cmp)[KS]) const {
    float v[D][KS];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (FULL || base + u < e1) {
        const T* m = msgs + (int64_t)(base + u) * width;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int f = f0 + k * G;
          v[u][k] = f < width ? to_f32(m[f]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (FULL || base + u < e1) {
#pragma unroll
        for (int k = 0; k < KS; ++k)
          if (f0 + k * G < width) kahan_add(acc[k], cmp[k], v[u][k]);
      }
    }
  }

  __device__ __forceinline__ void sum(int e0, int e1, int width, int f0,
                                      float (&acc)[KS],
                                      float (&cmp)[KS]) const {
    int base = e0;
    for (; base + D <= e1; base += D)
      batch<true>(base, e1, width, f0, acc, cmp);
    if (base < e1) batch<false>(base, e1, width, f0, acc, cmp);
  }
};

// The long-row plan of one launch (see scatter_csr.py, RowSplit).
struct Split {
  const int2* pieces;  // [n_pieces] (first edge, end edge)
  const int* rows;     // [n_long] the cut rows
  const int* ptr;      // [n_long + 1] each cut row's pieces
  double* partial;     // [n_pieces, width] scratch
  int n_pieces;
  int n_long;
  int piece_len;
};

// CTAs [0, piece CTAs) sum one piece per group into `partial`; the rest
// sum one row of at most piece_len edges per group into `out`.  ACCUM:
// start from out[row0 + row] and leave rows without edges alone.
template <class Src, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(kBlock, min_ctas<KS>()) csr_rows_kernel(
    Src src, const int* __restrict__ rowptr, Split sp,
    float* __restrict__ out, int n_rows, int width, int row0) {
  constexpr int kSlots = kBlock / G;  // groups of a CTA
  const int piece_ctas = (sp.n_pieces + kSlots - 1) / kSlots;
  const int f0 = blockIdx.y * (G * KS) + threadIdx.x % G;
  float acc[KS], cmp[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) acc[k] = cmp[k] = 0.f;
  if ((int)blockIdx.x < piece_ctas) {
    const int p = blockIdx.x * kSlots + threadIdx.x / G;
    if (p >= sp.n_pieces) return;  // the whole group leaves together
    const int2 pc = sp.pieces[p];
    src.sum(pc.x, pc.y, width, f0, acc, cmp);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int f = f0 + k * G;
      // kahan_add leaves the sum's lost low part in -cmp
      if (f < width)
        sp.partial[(int64_t)p * width + f] = (double)acc[k] - (double)cmp[k];
    }
    return;
  }
  const int row = (blockIdx.x - piece_ctas) * kSlots + threadIdx.x / G;
  if (row >= n_rows) return;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (end - start > sp.piece_len) return;  // a cut row: its pieces sum it
  if (ACCUM && start == end) return;
  float* o = out + ((int64_t)row0 + row) * width;
  if (ACCUM) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int f = f0 + k * G;
      if (f < width) acc[k] = o[f];
    }
  }
  src.sum(start, end, width, f0, acc, cmp);
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int f = f0 + k * G;
    if (f < width) o[f] = acc[k];
  }
}

// out[row0 + rows[j], f] = (accum ? prior : 0) + the partials of row j's
// pieces in piece order, summed in float64 and rounded once.
__global__ void __launch_bounds__(kBlock) combine_pieces_kernel(
    Split sp, float* __restrict__ out, int width, int row0, int accum) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= (int64_t)sp.n_long * width) return;
  const int j = (int)(i / width);
  const int f = (int)(i % width);
  float* o = out + ((int64_t)row0 + sp.rows[j]) * width + f;
  double s = accum ? (double)*o : 0.0;
  for (int p = sp.ptr[j]; p < sp.ptr[j + 1]; ++p)
    s += sp.partial[(int64_t)p * width + f];
  *o = (float)s;
}

template <bool ACCUM, int G, int KS, class Src>
void launch_rows(Src src, const int* rowptr, const Split& sp, float* out,
                 int n, int w, int row0, cudaStream_t s) {
  constexpr int kSlots = kBlock / G;
  const dim3 grid((sp.n_pieces + kSlots - 1) / kSlots + (n + kSlots - 1) / kSlots,
                  (w + G * KS - 1) / (G * KS));
  csr_rows_kernel<Src, G, KS, ACCUM>
      <<<grid, kBlock, 0, s>>>(src, rowptr, sp, out, n, w, row0);
}

// The second launch, for the cut rows; returns cudaGetLastError().
int combine(const Split& sp, float* out, int w, int row0, bool accum,
            cudaStream_t s) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sp.n_long == 0) return static_cast<int>(err);
  const int64_t total = (int64_t)sp.n_long * w;
  combine_pieces_kernel<<<(unsigned)((total + kBlock - 1) / kBlock), kBlock,
                          0, s>>>(sp, out, w, row0, accum ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ACCUM>
void dual_dispatch(const int* rowptr, const int* col, const float* va,
                   const float* vb, const T* x, int fa, const Split& sp,
                   float* out, int n, int w, int row0, cudaStream_t s) {
#define PGSD_DUAL(G, KS)                                                    \
  launch_rows<ACCUM, G, KS>(DualSource<T, G, KS>{col, va, vb, x, fa}, rowptr, \
                            sp, out, n, w, row0, s)
  PGSD_DISPATCH_WIDTH(w, PGSD_DUAL);
#undef PGSD_DUAL
}

template <typename T, bool ACCUM>
void scatter_dispatch(const int* rowptr, const T* msgs, const Split& sp,
                      float* out, int n, int w, int row0, cudaStream_t s) {
#define PGSD_SCATTER(G, KS)                                                  \
  launch_rows<ACCUM, G, KS>(MsgSource<T, G, KS>{msgs}, rowptr, sp, out, n, w, \
                            row0, s)
  PGSD_DISPATCH_WIDTH(w, PGSD_SCATTER);
#undef PGSD_SCATTER
}

Split split_of(const void* pieces, int n_pieces, const void* rows,
               const void* ptr, int n_long, int piece_len, void* partial) {
  return Split{static_cast<const int2*>(pieces), static_cast<const int*>(rows),
               static_cast<const int*>(ptr), static_cast<double*>(partial),
               n_pieces, n_long, piece_len};
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  The plan (pieces, rows, ptr, counts, piece_len) is
// scatter_csr.py's RowSplit of this rowptr; `partial` is scratch of
// n_pieces * width doubles.  Each entry launches the row kernel and, if
// any row is cut, the combine, and returns cudaGetLastError().

extern "C" int pgsd_csr_dual_spmm(const void* rowptr, const void* col,
                                  const void* val_a, const void* val_b,
                                  const void* x, void* out, int n_rows,
                                  int width, int fa, int x_is_bf16, int accum,
                                  int row0, const void* pieces, int n_pieces,
                                  const void* rows, const void* ptr,
                                  int n_long, int piece_len, void* partial,
                                  void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const int* rp = static_cast<const int*>(rowptr);
  const int* c = static_cast<const int*>(col);
  const float* va = static_cast<const float*>(val_a);
  const float* vb = static_cast<const float*>(val_b);
  float* o = static_cast<float*>(out);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (x_is_bf16 && accum)
    dual_dispatch<__nv_bfloat16, true>(rp, c, va, vb, xh, fa, sp, o, n_rows,
                                       width, row0, s);
  else if (x_is_bf16)
    dual_dispatch<__nv_bfloat16, false>(rp, c, va, vb, xh, fa, sp, o, n_rows,
                                        width, row0, s);
  else if (accum)
    dual_dispatch<float, true>(rp, c, va, vb, xf, fa, sp, o, n_rows, width,
                               row0, s);
  else
    dual_dispatch<float, false>(rp, c, va, vb, xf, fa, sp, o, n_rows, width,
                                row0, s);
  return combine(sp, o, width, row0, accum != 0, s);
}

extern "C" int pgsd_csr_scatter(const void* rowptr, const void* msgs,
                                void* out, int n_rows, int width,
                                int msgs_is_bf16, int accum, int row0,
                                const void* pieces, int n_pieces,
                                const void* rows, const void* ptr, int n_long,
                                int piece_len, void* partial, void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const int* rp = static_cast<const int*>(rowptr);
  float* o = static_cast<float*>(out);
  const __nv_bfloat16* mh = static_cast<const __nv_bfloat16*>(msgs);
  const float* mf = static_cast<const float*>(msgs);
  if (msgs_is_bf16 && accum)
    scatter_dispatch<__nv_bfloat16, true>(rp, mh, sp, o, n_rows, width, row0,
                                          s);
  else if (msgs_is_bf16)
    scatter_dispatch<__nv_bfloat16, false>(rp, mh, sp, o, n_rows, width, row0,
                                           s);
  else if (accum)
    scatter_dispatch<float, true>(rp, mf, sp, o, n_rows, width, row0, s);
  else
    scatter_dispatch<float, false>(rp, mf, sp, o, n_rows, width, row0, s);
  return combine(sp, o, width, row0, accum != 0, s);
}
