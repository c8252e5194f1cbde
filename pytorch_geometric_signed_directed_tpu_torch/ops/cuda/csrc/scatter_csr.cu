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
// Three entry points, each with a plain and an accumulate (K2) mode:
//
//   pgsd_csr_dual_spmm   out[row0 + r, l] (+)= sum_{e in row r} m[e, l],
//                        m[e, l] = msg((l < fa ? val_a[e] : val_b[e])
//                                      * x[col[e], l])
//                        the gather, the lane-selected multiply and K1's
//                        segment sum fused; the MagNet path's apply,
//                        forward and (on the transposed CSR) backward.
//   pgsd_csr_pair_spmm   the same with two value pairs and two sums a lane,
//                        out[row0 + r, l]     (+)= sum_e msg(sel_l(va, vb)
//                                                   [e] * x[col[e], l])
//                        out[row0 + r, W + l] (+)= sum_e msg(sel_l(wa, wb)
//                                                   [e] * x[col[e], l])
//                        for l < W, the width of x: the trainable-q pair
//                        forward (y and dy/dq), which the TPU runs as K1
//                        over [E, 4F] messages built outside the kernel
//                        because its row gather is row-rate-bound.
//   pgsd_csr_scatter     out[row0 + r, l] (+)= sum_{e in row r} msgs[e, l]
//                        K1's (and K2's) own contract.
//
// msg() rounds the product to the message type: f32, or bf16 when x (or
// msgs) is bf16.  Sums are compensated f32 (Kahan) folded in float64
// where they meet: a power-law hub row of 3*10^5 edges summed plainly in
// f32 drifts by about 1e-5 of its value.  The plain mode writes every row,
// so a row without edges comes out 0 (K1's `visited` mask); the accumulate
// mode adds into each row's prior value and does not touch a row without
// edges.  A row split over two blocks of a streamed layout cannot race:
// blocks launch in order on one stream.
//
// What bounds them: bytes.  Per call the work must read col and the values
// once (12 B per edge, 20 B for the pair), rowptr, x (or msgs) once and
// write out once (and, in the accumulate mode, read it once); the
// arithmetic (2 flops per edge and lane and sum) is far below the f32 rate.
// Edges gather x rows, which neighbouring threads read from neighbouring
// addresses; x (or the hot table of a split layout) mostly stays in L2 at
// the path's sizes.  The pair entry reads each x element once per edge for
// both of its sums, so the [E, 4F] message tensor is never written.
//
// What held them back, and the design against it.  A group of threads that
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
//   * A group keeps 4 or 8 gathers in flight (depth<KS>() for the dual,
//     PairSource's own depth for the pair): it stages the
//     values of a chunk of edges in shared memory, loads the next chunk's
//     while it works on the current one, issues the x-row loads of a batch
//     of edges before it adds any of them, then adds them in edge order.  A
//     piece's chain is about piece_len / depth latencies, tens of
//     microseconds.
//   * pgsd_csr_scatter reads messages that lie contiguous in memory, a
//     row's [edges, W] block.  A row (or piece) gets TL * P threads of a
//     warp: each keeps V neighbouring lanes (one 16-byte load an edge: 4
//     f32 or 8 bf16), TL of them span a lane tile, and the P edge slots
//     take every P-th edge of the row (P = min(32 / TL, 8); a warp takes
//     32 / (TL * P) rows).  So one load covers P edges' lanes end to end
//     and a row's chain is about edges / (P * depth) latencies.  The P
//     strided sums meet in a butterfly of warp shuffles in float64, in a
//     fixed order: the same bits in every call.

#include "csr_common.cuh"

namespace {

using namespace pgsd;

// The message source of pgsd_csr_dual_spmm: message l of edge e is
// round(sel_l(va, vb)[e] * x[col[e], l]).  A group stages a chunk of C
// edges' (col, va, vb) in shared memory with one coalesced load per thread;
// every thread then reads an edge's three words with one broadcast 16-byte
// load (three warp shuffles an edge made the loop issue-bound).
template <typename T, int G, int KS>
struct DualSource {
  static constexpr int NS = 1;
  static constexpr int D = depth<KS>();
  static constexpr int MIN_CTAS = min_ctas<KS>();
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

// CTAs [0, piece CTAs) sum one piece per group into `partial`; the rest
// sum one row of at most piece_len edges per group into `out`.  A source
// keeps Src::NS sums a lane; sum s of lane f lands in column s * width + f
// of out (row stride NS * width) and of the partials.  ACCUM: start from
// out[row0 + row] and leave rows without edges alone.
template <class Src, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(kBlock, Src::MIN_CTAS) csr_rows_kernel(
    Src src, const int* __restrict__ rowptr, Split sp,
    float* __restrict__ out, int n_rows, int width, int row0) {
  constexpr int NS = Src::NS;
  constexpr int kSlots = kBlock / G;  // groups of a CTA
  const int piece_ctas = (sp.n_pieces + kSlots - 1) / kSlots;
  const int f0 = blockIdx.y * (G * KS) + threadIdx.x % G;
  const int64_t stride = (int64_t)NS * width;
  float acc[NS * KS], cmp[NS * KS];
#pragma unroll
  for (int k = 0; k < NS * KS; ++k) acc[k] = cmp[k] = 0.f;
  if ((int)blockIdx.x < piece_ctas) {
    const int p = blockIdx.x * kSlots + threadIdx.x / G;
    if (p >= sp.n_pieces) return;  // the whole group leaves together
    const int2 pc = sp.pieces[p];
    src.sum(pc.x, pc.y, width, f0, acc, cmp);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int f = f0 + k * G;
        // kahan_add leaves the sum's lost low part in -cmp
        if (f < width)
          sp.partial[p * stride + s * width + f] =
              (double)acc[s * KS + k] - (double)cmp[s * KS + k];
      }
    }
    return;
  }
  const int row = (blockIdx.x - piece_ctas) * kSlots + threadIdx.x / G;
  if (row >= n_rows) return;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (end - start > sp.piece_len) return;  // a cut row: its pieces sum it
  if (ACCUM && start == end) return;
  float* o = out + ((int64_t)row0 + row) * stride;
  if (ACCUM) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int f = f0 + k * G;
        if (f < width) acc[s * KS + k] = o[s * width + f];
      }
    }
  }
  src.sum(start, end, width, f0, acc, cmp);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int f = f0 + k * G;
      if (f < width) o[s * width + f] = acc[s * KS + k];
    }
  }
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
void pair_dispatch(const int* rowptr, const int* col, const float* va,
                   const float* vb, const float* wa, const float* wb,
                   const T* x, int fa, const Split& sp, float* out, int n,
                   int w, int row0, cudaStream_t s) {
#define PGSD_PAIR(G, KS)                                                     \
  launch_rows<ACCUM, G, KS>(                                                 \
      PairSource<T, G, KS, true>{col, va, vb, wa, wb, x, fa}, rowptr, sp, out, \
      n, w, row0, s)
  PGSD_DISPATCH_WIDTH(w, PGSD_PAIR);
#undef PGSD_PAIR
}

// ---------------------------------------------------------------------------
// pgsd_csr_scatter: one warp a row (or piece) of row-ordered messages

// V lanes of one message, as float: one 16-byte load (VEC) or V scalar
// loads of the lanes below width.
// V lanes of one message, as float: one 16-byte load (VEC) or V scalar
// loads of the lanes below width.
template <typename T, int V>
__device__ __forceinline__ void load_lanes(const T* m, int f0, int width,
                                           float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(m + f0);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = f0 + i < width ? to_f32(m[f0 + i]) : 0.f;
  }
}

// The edge slots P of a row at TL lane threads: a row (or piece) gets
// TL * P threads of a warp, and a warp takes 32 / (TL * P) rows.  At most
// 8 slots: on the trainable-q template's rows (~75 edges) at W=8, 8 or 4
// slots (2 or 4 rows a warp in f32) beat 16 by 4% (f32) and 27% (bf16)
// and 2 slots lose 6-16% (timed on an H100 with
// scripts/ab_kernel_variants.py).  scatter_csr.py mirrors the rule as
// MSG_SLOTS.
template <int TL>
__host__ __device__ constexpr int msg_slots() {
  return 32 / TL < 8 ? 32 / TL : 8;
}

// Loads a thread keeps in flight: 8 of 4 lanes, 4 of 8.
template <int V>
__host__ __device__ constexpr int msg_depth() {
  return V >= 8 ? 4 : 8;
}

// Thread (c, j) of a row's TL * P threads, c = its lane thread and j its
// edge slot, sums lanes [f0, f0 + V) of edges e0 + j, e0 + j + P, ...
// below e1 in edge order (compensated), D loads issued before any is
// added; returns in s the float64 sum of its row's P slots.  Every thread
// of the warp must call it (the fold is a warp shuffle).
template <typename T, int V, int TL, int P>
__device__ __forceinline__ void strided_sum(const T* msgs, int e0, int e1,
                                            int width, int f0, bool live,
                                            double (&s)[V]) {
  constexpr int D = msg_depth<V>();
  float acc[V], cmp[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = cmp[i] = 0.f;
  if (live) {
    for (int e = e0; e < e1; e += D * P) {
      float v[D][V];
#pragma unroll
      for (int u = 0; u < D; ++u)
        if (e + u * P < e1)
          load_lanes<T, V>(msgs + (int64_t)(e + u * P) * width, f0, width,
                           v[u]);
#pragma unroll
      for (int u = 0; u < D; ++u)
        if (e + u * P < e1) {
#pragma unroll
          for (int i = 0; i < V; ++i) kahan_add(acc[i], cmp[i], v[u][i]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = (double)acc[i] - (double)cmp[i];
  // the P edge slots meet in a butterfly: every slot ends with the same
  // bits, since each step adds two values in either order
#pragma unroll
  for (int d = TL; d < TL * P; d <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], d);
  }
}

// 8 loads of 4 lanes (or 4 of 8) in flight need more than the 64
// registers a thread has at 4 CTAs of 256 threads per SM.
template <int V>
__host__ __device__ constexpr int msg_min_ctas() {
  return V * msg_depth<V>() >= 32 ? 3 : 4;
}

// CTAs [0, piece CTAs) sum one piece per TL * P threads into `partial`;
// the rest one row of at most piece_len edges per TL * P threads into
// `out`.  Threads without a row or piece (past the end, a cut row, an
// empty row in the accumulate mode) sum nothing but join the fold.  Lane
// tile blockIdx.y holds lanes [y*TL*V, (y+1)*TL*V).
template <typename T, int V, int TL, bool ACCUM>
__global__ void __launch_bounds__(kBlock, msg_min_ctas<V>())
    csr_msgs_kernel(
    const T* __restrict__ msgs, const int* __restrict__ rowptr, Split sp,
    float* __restrict__ out, int n_rows, int width, int row0) {
  constexpr int P = msg_slots<TL>();
  constexpr int kSlots = kBlock / (TL * P);  // rows (pieces) of a CTA
  const int piece_ctas = (sp.n_pieces + kSlots - 1) / kSlots;
  const int slot = threadIdx.x / (TL * P);
  const int f0 = blockIdx.y * (TL * V) + (threadIdx.x % TL) * V;
  const int j = (threadIdx.x / TL) % P;
  const bool live = f0 < width;
  int e0 = 0, e1 = 0, p = -1, row = -1;
  if ((int)blockIdx.x < piece_ctas) {
    p = blockIdx.x * kSlots + slot;
    if (p < sp.n_pieces) {
      const int2 pc = sp.pieces[p];
      e0 = pc.x;
      e1 = pc.y;
    } else {
      p = -1;
    }
  } else {
    row = (blockIdx.x - piece_ctas) * kSlots + slot;
    if (row < n_rows) {
      e0 = rowptr[row];
      e1 = rowptr[row + 1];
      // a cut row: its pieces sum it
      if (e1 - e0 > sp.piece_len || (ACCUM && e0 == e1)) row = -1;
    } else {
      row = -1;
    }
    if (row < 0) e0 = e1 = 0;
  }
  double s[V];
  strided_sum<T, V, TL, P>(msgs, e0 + j, e1, width, f0, live, s);
  if (j != 0 || !live) return;
  if (p >= 0) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (f0 + i < width) sp.partial[(int64_t)p * width + f0 + i] = s[i];
  } else if (row >= 0) {
    float* o = out + ((int64_t)row0 + row) * width;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (f0 + i < width)
        o[f0 + i] = (float)(ACCUM ? (double)o[f0 + i] + s[i] : s[i]);
  }
}

template <typename T, int V, bool ACCUM>
int scatter_dispatch(const int* rowptr, const T* msgs, const Split& sp,
                     float* out, int n, int w, int row0, int tl,
                     cudaStream_t s) {
#define PGSD_MSGS(TL)                                                      \
  case TL: {                                                               \
    constexpr int kSlots = kBlock / (TL * msg_slots<TL>());                \
    const unsigned gx = (sp.n_pieces + kSlots - 1) / kSlots +              \
                        (n + kSlots - 1) / kSlots;                         \
    csr_msgs_kernel<T, V, TL, ACCUM>                                       \
        <<<dim3(gx, (w + TL * V - 1) / (TL * V)), kBlock, 0, s>>>(         \
            msgs, rowptr, sp, out, n, w, row0);                            \
    return 0;                                                              \
  }
  switch (tl) {
    PGSD_MSGS(1);
    PGSD_MSGS(2);
    PGSD_MSGS(4);
    PGSD_MSGS(8);
    PGSD_MSGS(16);
    PGSD_MSGS(32);
  }
#undef PGSD_MSGS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool ACCUM>
int scatter_by_vec(const int* rowptr, const void* msgs, const Split& sp,
                   float* out, int n, int w, int row0, int v, int tl,
                   cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* m = static_cast<const T*>(msgs);
  if (v == kVec)
    return scatter_dispatch<T, kVec, ACCUM>(rowptr, m, sp, out, n, w, row0,
                                            tl, s);
  if (v == 1)
    return scatter_dispatch<T, 1, ACCUM>(rowptr, m, sp, out, n, w, row0, tl,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  The plan (pieces, rows, ptr, counts, piece_len) is
// scatter_csr.py's RowSplit of this rowptr; `partial` is scratch of
// n_pieces * (the output's width) doubles.  Each entry launches the row
// kernel and, if any row is cut, the combine, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a geometry it does not
// take).

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

// `width` is x's; out has 2 * width columns and `partial` n_pieces *
// 2 * width doubles.
extern "C" int pgsd_csr_pair_spmm(const void* rowptr, const void* col,
                                  const void* val_a, const void* val_b,
                                  const void* w_a, const void* w_b,
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
  const float* wa = static_cast<const float*>(w_a);
  const float* wb = static_cast<const float*>(w_b);
  float* o = static_cast<float*>(out);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (x_is_bf16 && accum)
    pair_dispatch<__nv_bfloat16, true>(rp, c, va, vb, wa, wb, xh, fa, sp, o,
                                       n_rows, width, row0, s);
  else if (x_is_bf16)
    pair_dispatch<__nv_bfloat16, false>(rp, c, va, vb, wa, wb, xh, fa, sp, o,
                                        n_rows, width, row0, s);
  else if (accum)
    pair_dispatch<float, true>(rp, c, va, vb, wa, wb, xf, fa, sp, o, n_rows,
                               width, row0, s);
  else
    pair_dispatch<float, false>(rp, c, va, vb, wa, wb, xf, fa, sp, o, n_rows,
                                width, row0, s);
  return combine(sp, o, 2 * width, row0, accum != 0, s);
}

// `lanes` (V) and `lane_threads` (TL) are the wrapper's geometry
// (scatter_csr.py, _msg_geometry): V = 16 bytes of the message type when
// every row of msgs starts 16-byte aligned, else 1; TL a power of two up
// to 32.
extern "C" int pgsd_csr_scatter(const void* rowptr, const void* msgs,
                                void* out, int n_rows, int width,
                                int msgs_is_bf16, int accum, int row0,
                                int lanes, int lane_threads,
                                const void* pieces, int n_pieces,
                                const void* rows, const void* ptr, int n_long,
                                int piece_len, void* partial, void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const int* rp = static_cast<const int*>(rowptr);
  float* o = static_cast<float*>(out);
  int err;
  if (msgs_is_bf16 && accum)
    err = scatter_by_vec<__nv_bfloat16, true>(rp, msgs, sp, o, n_rows, width,
                                              row0, lanes, lane_threads, s);
  else if (msgs_is_bf16)
    err = scatter_by_vec<__nv_bfloat16, false>(rp, msgs, sp, o, n_rows, width,
                                               row0, lanes, lane_threads, s);
  else if (accum)
    err = scatter_by_vec<float, true>(rp, msgs, sp, o, n_rows, width, row0,
                                      lanes, lane_threads, s);
  else
    err = scatter_by_vec<float, false>(rp, msgs, sp, o, n_rows, width, row0,
                                       lanes, lane_threads, s);
  if (err) return err;
  return combine(sp, o, width, row0, accum != 0, s);
}
