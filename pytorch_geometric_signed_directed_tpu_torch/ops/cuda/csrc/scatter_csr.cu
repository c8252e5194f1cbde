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
//   pgsd_csr_scatter_indexed
//                        K1 over messages it reads by index: message e is
//                        [s_e | w_e * table[index[e]]] (with or without
//                        the scalar lane), summed as pgsd_csr_scatter
//                        sums the materialized messages, so the [E, F]
//                        gathered rows never lie in device memory (the
//                        motif attention's sums, the gather's backward).
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
//     microseconds.  The pair sums a batch's products plainly and adds the
//     batch sum compensated (one kahan_add a batch); the dual adds every
//     product compensated.  In the dual the batch sums lost: their
//     registers took the walk past 64 a thread, and with them an SM's
//     fourth CTA (P_s at W=32: 0.2993 -> 0.3739 ms, DGCN's A_in 0.1211 ->
//     0.1808), and on the 324,064-edge hub row their roundings, about
//     twice the per-edge error, came to 3.3e-5 at a value of 2.2, past
//     the f32 tolerance of tests/test_torch_cuda.py (H100 runs).
//   * The dual's bf16 products round two lanes at a time (one
//     cvt.rn.bf16x2.f32).  Its lanes stay strided by the group, one
//     scalar load each: a thread's KS neighbouring lanes in one 4- to
//     16-byte load lost to them by 2-15% on 10 of the 14 K1/K2 cases above
//     32 lanes, tied on 3 and won one by 1.5% (magnet_mxu 2F=64 bf16
//     0.2259 against 0.2053 ms, the bench DiGCL W=64 0.0685 against
//     0.0598; H100 runs, scripts/ab_kernel_variants.py).
//   * pgsd_csr_scatter reads messages that lie contiguous in memory, a
//     row's [edges, W] block.  A row (or piece) gets TL * P threads of a
//     warp: each keeps V neighbouring lanes (one 16-byte load an edge: 4
//     f32 or 8 bf16), TL of them span a lane tile, and the P edge slots
//     take every P-th edge of the row (P = min(32 / TL, 8); a warp takes
//     32 / (TL * P) rows).  So one load covers P edges' lanes end to end
//     and a row's chain is about edges / (P * depth) latencies.  The P
//     strided sums meet in a butterfly of warp shuffles in float64, in a
//     fixed order: the same bits in every call.
//
// Short rows.  A group per row waits out a chain of dependent loads
// (rowptr, the row's edges, the x rows, the store) for every row, which
// on the giant DIGRAC blocks (1.2-2.4M rows of ~2.3 edges) made K2 6x its
// byte bound and slower than one cuSPARSE addmm.  So the plan also holds
// row blocks (CSR-Adaptive's): runs of consecutive uncut rows of at most
// kBlockEdges / 2 edges each, fewer than kBlockEdges edges and at most
// kBlockRows rows in all, built once per CSR with the cut rows
// (scatter_csr.py, plan_row_split), and the list of the other uncut rows
// ("mid" rows).  Blocks are made only where such short rows are most of
// the rows.  A warp takes one block:
//   * its (first row, end row, first edge, end edge) in one 16-byte load;
//   * the block's rowptr slice and its (col, va, vb) with cp.async into
//     shared memory, and in the accumulate mode the prior out rows (one
//     contiguous span of 16-byte copies), all in flight at once;
//   * then every x row the block's edges need, 16-byte cp.async where x
//     rows are whole 16-byte lines (4-byte copies else);
//   * then (row, lane) pairs, several rows' lanes a warp at narrow widths
//     (W=5, 10): each thread sums its row's edges for its lane in edge
//     order, compensated as the group path does, and stores once.
// So a block costs about three latencies instead of three a row.  Mid rows
// keep a group each (the walk above, over the list) and cut rows their
// pieces.  The dual takes the block path up to kTile lanes, and above it
// in tiles of kTile lanes (a warp a tile of a block; the block's rowptr
// slice and edges staged once a tile, ~0.5 KB beside the tile's x rows,
// so a warp's stage stays the size it has at W=32) where the wrapper
// finds x far larger than L2 (scatter_csr.py, WIDE_BLOCK_L2).  There the
// gathers come from device memory and a block's copies, all in flight at
// once, beat the walk: the giant graph's cold block at 2F=64 0.8571 ->
// 0.7102 ms (f32), 0.7908 -> 0.6011 (bf16).  From an L2-resident table
// the walk won: the hot block 0.4965 against 0.5373, the bench SGCN dual
// at 2F=128 0.1857 against 0.3045 (H100 runs,
// scripts/ab_kernel_variants.py).  The pair keeps a group per row for
// every row.
//
// Messages at widths off a multiple of 4, or from a base that is not
// 16-byte aligned (pgsd_csr_scatter with V = 1), take csr_span_kernel at
// every width.  Up to kSpanWidth lanes, a row block's messages are one
// contiguous span, which a warp copies into shared memory with 16-byte
// cp.async from its first 16-byte boundary (the head and tail, under 16
// bytes, by plain loads); (row, lane) pairs then sum down the staged tile
// in edge order, compensated, each folded once into float64.  A mid row
// of at most kWalkEdges edges gives a thread to each of its (row, column)
// pairs, which walks its column down the row's edges with 8 loads in
// flight: neighbouring threads read neighbouring lanes, so the loads
// coalesce whatever the width, and no lane idles (a warp a mid row,
// staged, lost to this walk on the bench SNEA graph's rows of ~25 edges).
// A longer uncut row (the plan lists them: RowSplit.walks), and each
// piece of a cut row, takes a second kernel (csr_walk_kernel, launched
// only where there are any): a warp a tile of 32 columns, its 64 pairs
// (column, edge slot) pairs, 64 / C slots for a tile of C columns.  So a
// row of hundreds of edges at a narrow width does not wait out one
// thread's chain of loads, and long rows do not crowd into the warps of
// their neighbours' columns (at W = 1 a warp of pairs holds 32 rows).  At
// W = 1 and above kSpanWidth nothing is staged: every uncut row that is
// not walked by a warp is walked by threads.
//
// The three message kernels take their messages from a loader, a template
// parameter: RowMsgs reads the contiguous [E, W] messages of
// pgsd_csr_scatter, IndexedMsgs those of pgsd_csr_scatter_indexed, each
// from its table row (and its weight and scalar) at the moment the sum
// adds it.  What bounds an indexed sum is the table
// rows it gathers, 4 f32 lanes a 16-byte load where the rows are whole
// 16-byte lines (csr_msgs_kernel; a scalar lane is summed beside the row
// lanes by lane thread 0 of the first lane tile, as its own lane 0 is, so
// the [E, F + 1] sums of the motif attention need not take the V = 1
// path), else V = 1 with every row walked (no contiguous span to stage).
// Its sums are the sums of pgsd_csr_scatter over the materialized
// messages at the same geometry, bit for bit.  Its time is the table
// rows' gather: on the SDGNN cell's sums the rows come in no order from
// tables of 67-75 MB, past L2, at 0.25-0.5 TB/s (H100; the same rate as
// PyTorch's own gather of them).  A launch that gave a short row to TL
// threads, several rows a warp, read no faster (stack sums 10% faster,
// gather backwards 6-25% slower; PERF.md §6).
//
// kBlockEdges, kBlockRows and kWalkEdges were chosen by timing builds of
// other values (-DPGSD_BLOCK_EDGES=16, -DPGSD_BLOCK_ROWS=16,
// -DPGSD_WALK_EDGES=32 and 128) against these in turns on an H100
// (scripts/ab_kernel_variants.py --only giant_digrac,odd; PERF.md):
// blocks of 16 edges lost 20-31% on the giant DIGRAC blocks and 13-21% on
// the epinions-size SNEA graph, blocks of 16 rows up to 10% and 2%; a
// thread's walk of up to 32 edges lost 21-34% on the bench SNEA graph at
// W=17 and 34 (and won 4-6% on rows of 40-1,024 edges at W=1 and 5), of
// up to 128 edges 13-16% on those rows at W=1 and 5.

#include "csr_common.cuh"

namespace {

using namespace pgsd;

// ---------------------------------------------------------------------------
// The plan's row blocks (scatter_csr.py: RowSplit.blocks and .mids) and
// the asynchronous copies that stage them

// The row-block shape (see the header).  Macros only so that
// scripts/ab_kernel_variants.py can build other shapes with -D to time
// them; scatter_csr.py's bind() refuses a build whose shape is not its
// BLOCK_EDGES and BLOCK_ROWS.
#ifndef PGSD_BLOCK_EDGES
#define PGSD_BLOCK_EDGES 32
#endif
#ifndef PGSD_BLOCK_ROWS
#define PGSD_BLOCK_ROWS 32
#endif
constexpr int kBlockEdges = PGSD_BLOCK_EDGES;  // most edges of a block
constexpr int kBlockRows = PGSD_BLOCK_ROWS;    // most rows of a block

// The longest uncut row whose columns a thread each walks alone at V = 1
// (pgsd_csr_scatter); the plan lists longer ones (WALK_EDGES), which a
// warp each walks.  A macro for the same reason.
#ifndef PGSD_WALK_EDGES
#define PGSD_WALK_EDGES 64
#endif
constexpr int kWalkEdges = PGSD_WALK_EDGES;
constexpr int kTile = 32;        // lanes of a tile of the dual's block path
constexpr int kWarps = kBlock / 32;

struct Blocks {
  const int4* blocks;  // [n_blocks] (first row, end row, first edge, end edge)
  const int* mids;     // [n_mids] the uncut rows in no block
  const int* walks;    // [n_walks] the uncut rows of more than kWalkEdges
  int n_blocks;
  int n_mids;          // < 0 (the dual above kTile lanes, no blocks): every row
  int n_walks;
};

inline Blocks blocks_of(const void* blocks, int n_blocks, const void* mids,
                        int n_mids, const void* walks, int n_walks) {
  return Blocks{static_cast<const int4*>(blocks),
                static_cast<const int*>(mids),
                static_cast<const int*>(walks), n_blocks, n_mids, n_walks};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async: copies from device to shared memory that the thread does not
// wait for; cp_async_wait<N>() waits until at most N committed groups of
// this thread are still in flight (a __syncwarp after it shows the copies
// to the rest of the warp).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp-wide: starts the copy of the n elements at src into dst (16-byte
// aligned) and returns where element 0 lands, dst + (src's offset in its
// 16-byte line): the 16-byte lines by cp.async (the caller commits), the
// head and tail below 16 bytes by plain loads.
template <typename T>
__device__ __forceinline__ const T* stage_span(unsigned char* dst,
                                               const T* src, int n,
                                               int lane) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a1 = a0 + (uintptr_t)n * sizeof(T);
  const uintptr_t b0 = (a0 + 15) & ~(uintptr_t)15;
  const uintptr_t b1 = a1 & ~(uintptr_t)15;
  T* d = reinterpret_cast<T*>(dst + (a0 & 15));
  int head = n, lines = 0, tail = n;  // [0, head) and [tail, n) plain
  if (b0 <= b1) {
    head = (int)((b0 - a0) / sizeof(T));
    lines = (int)((b1 - b0) / 16);
    tail = (int)((b1 - a0) / sizeof(T));
  }
  unsigned char* dl = reinterpret_cast<unsigned char*>(d) + (b0 - a0);
  for (int c = lane; c < lines; c += 32)
    cp_async16(dl + 16 * c, reinterpret_cast<const void*>(b0 + 16 * (uintptr_t)c));
  if (lane < head) d[lane] = src[lane];
  if (tail + lane < n) d[tail + lane] = src[tail + lane];
  return d;
}

// q / d for 0 <= q < 4096 and 1 <= d <= 64, by a float reciprocal: (q +
// 0.5) / d lies at least 0.5 / d from an integer and the float product
// errs by under 2^-10, so truncation is exact (an integer division by a
// runtime divisor costs about twenty instructions).
struct Div {
  float inv;
  __device__ __forceinline__ explicit Div(int d) : inv(1.0f / d) {}
  __device__ __forceinline__ int operator()(int q) const {
    return __float2int_rz(((float)q + 0.5f) * inv);
  }
};

// A warp's shared memory in the dual's block path: one tile of up to
// kTile lanes of the x rows its block's edges gather; the accumulate mode
// also stages the tile of the block's prior out rows (one contiguous span
// where the tile is whole rows, with 16 bytes to spare for its offset in
// its line).
template <typename T, bool ACCUM>
struct __align__(16) BlockStage {
  float prior[ACCUM ? kBlockRows * kTile + 4 : 4];
  T x[kBlockEdges * kTile];  // x[col[j], c0 + l] at j * tile width + l
  int col[kBlockEdges];
  float va[kBlockEdges];
  float vb[kBlockEdges];
  int rp[kBlockRows + 1];  // rowptr[first row + i]
};

// Products rounded to the message type: bf16 two at a time (one
// cvt.rn.bf16x2.f32, each half rounded as round_msg rounds it), f32 as
// they are.
template <typename T, int N>
__device__ __forceinline__ void round_msgs(float (&p)[N]) {
  if constexpr (sizeof(T) == 2 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f = __bfloat1622float2(
          __float22bfloat162_rn(make_float2(p[i], p[i + 1])));
      p[i] = f.x;
      p[i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = round_msg<T>(p[i]);
  }
}

// The message source of pgsd_csr_dual_spmm: message l of edge e is
// round(sel_l(va, vb)[e] * x[col[e], l]).  A group stages a chunk of C
// edges' (col, va, vb) in shared memory with one coalesced load per thread;
// every thread then reads an edge's three words with one broadcast 16-byte
// load (three warp shuffles an edge made the loop issue-bound).  A batch
// of D gathers is issued before any is added; then each product, rounded
// to the message type (bf16 two lanes at a time), is added compensated in
// edge order.  Thread t of a group owns lanes tile + t + k * G, k < KS:
// neighbouring threads on neighbouring lanes.  It takes the plan's row
// blocks, in tiles of kTile lanes (above kTile lanes only where the
// wrapper finds x far larger than L2; else the launch walks every row).
template <typename T, int G, int KS>
struct DualSource {
  static constexpr int NS = 1;
  static constexpr int D = depth<KS>();
  static constexpr int MIN_CTAS = min_ctas<KS>();
  static constexpr int S = D > G ? D / G : 1;  // edges a thread loads a chunk
  static constexpr int C = G * S;              // edges of a chunk
  // the block path's tiles of kTile lanes in one lane tile (blockIdx.y)
  static constexpr int TILES = G * KS > kTile ? G * KS / kTile : 1;
  static constexpr int kStageBytes = kBlock * S * (int)sizeof(int4);
  using Value = T;
  // the CTA's dynamic shared memory: the walk's stage, or with row blocks
  // the warps' block stages if larger
  template <bool ACCUM>
  static constexpr int smem(bool blocks) {
    constexpr int b = kWarps * (int)sizeof(BlockStage<T, ACCUM>);
    return blocks && b > kStageBytes ? b : kStageBytes;
  }
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
  // then each product added compensated, in edge order.
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
        float p[KS];
#pragma unroll
        for (int k = 0; k < KS; ++k)
          p[k] = __fmul_rn(f0 + k * G < fa ? av[u] : bv[u], xv[u][k]);
        round_msgs<T, KS>(p);
#pragma unroll
        for (int k = 0; k < KS; ++k) kahan_add(acc[k], cmp[k], p[k]);
      }
    }
  }

  // Adds the messages of edges [e0, e1) to (acc, cmp), in edge order;
  // `smem` is the CTA's shared memory (at least kStageBytes).
  __device__ __forceinline__ void sum(int e0, int e1, int width, int f0,
                                      float (&acc)[KS], float (&cmp)[KS],
                                      unsigned char* smem) const {
    int4* edges = reinterpret_cast<int4*>(smem) + (threadIdx.x / G) * C;
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

  // Starts the copies of x[col[j], c0 + l], j < ne, l < tw, into st.x at
  // j * tw + l: 16-byte cp.async when x rows are whole 16-byte lines (then
  // so is the tile, which starts at a multiple of kTile lanes), else
  // 4-byte ones (bf16 in pairs of lanes); bf16 x of an odd width, or not
  // 4-byte aligned, by plain loads, 8 a thread in flight.
  template <bool ACCUM>
  __device__ __forceinline__ void gather(BlockStage<T, ACCUM>& st, int ne,
                                         int width, int c0, int tw,
                                         int lane) const {
    constexpr int kV = 16 / sizeof(T);  // elements of a 16-byte copy
    constexpr int kE = 4 / sizeof(T);   // elements of a 4-byte copy
    const T* xc = x + c0;
    const uintptr_t base = reinterpret_cast<uintptr_t>(x);
    if (width % kV == 0 && (base & 15) == 0) {
      const int per = tw / kV;
      const Div div(per);
      for (int q = lane; q < ne * per; q += 32) {
        const int j = div(q), c = (q - j * per) * kV;
        cp_async16(&st.x[j * tw + c], xc + (int64_t)st.col[j] * width + c);
      }
    } else if (width % kE == 0 && (base & 3) == 0) {
      const int per = tw / kE;
      const Div div(per);
      for (int q = lane; q < ne * per; q += 32) {
        const int j = div(q), c = (q - j * per) * kE;
        cp_async4(&st.x[j * tw + c], xc + (int64_t)st.col[j] * width + c);
      }
    } else {
      constexpr int B = 8;
      const Div div(tw);
      for (int q0 = lane; q0 < ne * tw; q0 += 32 * B) {
        T v[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int q = q0 + 32 * u;
          if (q < ne * tw) {
            const int j = div(q);
            v[u] = xc[(int64_t)st.col[j] * width + q - j * tw];
          }
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int q = q0 + 32 * u;
          if (q < ne * tw) st.x[q] = v[u];
        }
      }
    }
    cp_async_commit();
  }

  // Starts the copies of the tile [c0, c0 + tw) of the block's nr out
  // rows ob (row stride width) into st.prior, and returns where (row r,
  // lane l) lands: at r * tw + l.  Whole rows (tw == width) are one span;
  // a tile of wider rows takes 16-byte copies where its rows start on
  // 16-byte lines, else 4-byte ones.
  template <bool ACCUM>
  __device__ __forceinline__ const float* stage_prior(
      BlockStage<T, ACCUM>& st, const float* ob, int nr, int width, int tw,
      int lane) const {
    if (tw == width)
      return stage_span(reinterpret_cast<unsigned char*>(st.prior), ob,
                        nr * width, lane);
    if (width % 4 == 0 && (reinterpret_cast<uintptr_t>(ob) & 15) == 0) {
      const int per = tw / 4;
      const Div div(per);
      for (int q = lane; q < nr * per; q += 32) {
        const int r = div(q), c = (q - r * per) * 4;
        cp_async16(&st.prior[r * tw + c], ob + (int64_t)r * width + c);
      }
    } else {
      const Div div(tw);
      for (int q = lane; q < nr * tw; q += 32) {
        const int r = div(q);
        cp_async4(&st.prior[q], ob + (int64_t)r * width + q - r * tw);
      }
    }
    return st.prior;
  }

  // The block path: this warp sums lanes [c0, c0 + tw) of the rows of
  // block `blk` into out, tw = min(kTile, width - c0) (see the header).
  // Pair p = lane + 32 k is (row p / tw, lane c0 + p % tw); it sums its
  // row's edges in edge order, compensated.  ACCUM: each row from its
  // prior value (staged with the block's edges), and rows without edges
  // are left alone.
  template <bool ACCUM>
  __device__ __forceinline__ void block(const int4 blk,
                                        const int* __restrict__ rowptr,
                                        BlockStage<T, ACCUM>& st,
                                        float* __restrict__ out, int width,
                                        int row0, int c0) const {
    const int lane = threadIdx.x & 31;
    const int r0 = blk.x, nr = blk.y - blk.x, e0 = blk.z, ne = blk.w - blk.z;
    const int tw = min(kTile, width - c0);
    float* ob = out + ((int64_t)row0 + r0) * width + c0;
    for (int i = lane; i <= nr; i += 32) cp_async4(&st.rp[i], rowptr + r0 + i);
    if (lane < ne) {
      cp_async4(&st.col[lane], col + e0 + lane);
      cp_async4(&st.va[lane], va + e0 + lane);
      cp_async4(&st.vb[lane], vb + e0 + lane);
    }
    const float* prior =
        ACCUM ? stage_prior(st, ob, nr, width, tw, lane) : nullptr;
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    gather(st, ne, width, c0, tw, lane);
    cp_async_wait<0>();
    __syncwarp();
    const Div div(tw);
    for (int p = lane; p < nr * tw; p += 32) {
      const int r = div(p);
      const int l = p - r * tw;
      const int ja = st.rp[r] - e0, jb = st.rp[r + 1] - e0;
      if (ACCUM && ja == jb) continue;
      const bool lo = c0 + l < fa;
      float acc = ACCUM ? prior[p] : 0.f, cmp = 0.f;
      for (int j = ja; j < jb; ++j)
        kahan_add(acc, cmp,
                  round_msg<T>(__fmul_rn(lo ? st.va[j] : st.vb[j],
                                         to_f32(st.x[j * tw + l]))));
      ob[(int64_t)r * width + l] = acc;
    }
    __syncwarp();  // every read of the stage before the warp's next block
  }
};

// What the row kernel needs of a source beyond its walk: whether it takes
// the plan's row blocks (and in how many tiles of kTile lanes a lane tile),
// and the shared memory of its walk and its blocks (PairSource keeps its
// own).
template <class Src>
struct Traits {
  static constexpr bool kDual = false;
  static constexpr bool kBlocks = false;
  static constexpr int kTiles = 1;
  template <bool ACCUM>
  static constexpr int smem(bool) { return 0; }
};

template <typename T, int G, int KS>
struct Traits<DualSource<T, G, KS>> {
  using Src = DualSource<T, G, KS>;
  static constexpr bool kDual = true;
  static constexpr bool kBlocks = true;
  static constexpr int kTiles = Src::TILES;
  template <bool ACCUM>
  static constexpr int smem(bool blocks) {
    return Src::template smem<ACCUM>(blocks);
  }
};

// CTAs [0, piece CTAs) sum one piece per group into `partial`; the next
// ones sum one row of at most piece_len edges per group into `out`: the
// plan's mid rows for a source that takes blocks, else (or with
// bp.n_mids < 0) every row, cut ones skipped; the last ones, for a source
// that takes blocks, one tile of kTile lanes of one row block per warp.  A source keeps Src::NS sums a
// lane; sum s of lane f lands in column s * width + f of out (row stride
// NS * width) and of the partials.  ACCUM: start from out[row0 + row] and
// leave rows without edges alone.
template <class Src, int G, int KS, bool ACCUM>
__global__ void __launch_bounds__(kBlock, Src::MIN_CTAS) csr_rows_kernel(
    Src src, const int* __restrict__ rowptr, Split sp, Blocks bp,
    float* __restrict__ out, int n_rows, int width, int row0) {
  using Tr = Traits<Src>;
  constexpr int NS = Src::NS;
  constexpr int kSlots = kBlock / G;  // groups of a CTA
  extern __shared__ __align__(16) unsigned char smem[];  // Tr::smem<ACCUM>
  const int piece_ctas = (sp.n_pieces + kSlots - 1) / kSlots;
  // (a constant up to kTile lanes, where the dual always takes blocks)
  const bool every = !Tr::kBlocks || (KS > 1 && bp.n_mids < 0);
  const int n_listed = every ? n_rows : bp.n_mids;
  const int row_ctas = (n_listed + kSlots - 1) / kSlots;
  if ((int)blockIdx.x >= piece_ctas + row_ctas) {
    if constexpr (Tr::kBlocks) {
      // warp w of these CTAs: tile w % kTiles of this lane tile, of block
      // w / kTiles
      const int w = (blockIdx.x - piece_ctas - row_ctas) * kWarps +
                    threadIdx.x / 32;
      const int b = w / Tr::kTiles;
      const int c0 = (blockIdx.y * Tr::kTiles + w % Tr::kTiles) * kTile;
      if (b < bp.n_blocks && c0 < width)
        src.template block<ACCUM>(
            bp.blocks[b], rowptr,
            reinterpret_cast<BlockStage<typename Src::Value, ACCUM>*>(
                smem)[threadIdx.x / 32],
            out, width, row0, c0);
    }
    return;
  }
  const int f0 = blockIdx.y * (G * KS) + threadIdx.x % G;
  const int64_t stride = (int64_t)NS * width;
  float acc[NS * KS], cmp[NS * KS];
#pragma unroll
  for (int k = 0; k < NS * KS; ++k) acc[k] = cmp[k] = 0.f;
  if ((int)blockIdx.x < piece_ctas) {
    const int p = blockIdx.x * kSlots + threadIdx.x / G;
    if (p >= sp.n_pieces) return;  // the whole group leaves together
    const int2 pc = sp.pieces[p];
    if constexpr (Tr::kDual) src.sum(pc.x, pc.y, width, f0, acc, cmp, smem);
    else src.sum(pc.x, pc.y, width, f0, acc, cmp);
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
  const int i = (blockIdx.x - piece_ctas) * kSlots + threadIdx.x / G;
  if (i >= n_listed) return;
  const int row = every ? i : bp.mids[i];
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
  if constexpr (Tr::kDual) src.sum(start, end, width, f0, acc, cmp, smem);
  else src.sum(start, end, width, f0, acc, cmp);
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
void launch_rows(Src src, const int* rowptr, const Split& sp,
                 const Blocks& bp, float* out, int n, int w, int row0,
                 cudaStream_t s) {
  using Tr = Traits<Src>;
  constexpr int kSlots = kBlock / G;
  const int listed = !Tr::kBlocks || (KS > 1 && bp.n_mids < 0) ? n
                                                               : bp.n_mids;
  const int block_ctas =
      Tr::kBlocks ? (bp.n_blocks * Tr::kTiles + kWarps - 1) / kWarps : 0;
  const dim3 grid((sp.n_pieces + kSlots - 1) / kSlots +
                      (listed + kSlots - 1) / kSlots + block_ctas,
                  (w + G * KS - 1) / (G * KS));
  if (grid.x == 0) return;
  const int smem = Tr::template smem<ACCUM>(bp.n_blocks > 0);
  if (smem > 48 * 1024) {
    // above 48 KB a kernel takes dynamic shared memory only when told so,
    // once per device (not a stream operation: capture allows it)
    static bool raised[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && !raised[dev]) {
      cudaFuncSetAttribute(csr_rows_kernel<Src, G, KS, ACCUM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      raised[dev] = true;
    }
  }
  csr_rows_kernel<Src, G, KS, ACCUM>
      <<<grid, kBlock, smem, s>>>(src, rowptr, sp, bp, out, n, w, row0);
}

// The dual at (G, KS): row blocks up to kTile lanes always, above it only
// with `wide` (the wrapper's choice: x far larger than L2); without them
// the launch walks every uncut row (no block CTAs, n_mids < 0).
template <typename T, bool ACCUM, int G, int KS>
void dual_launch(const int* rowptr, const int* col, const float* va,
                 const float* vb, const T* x, int fa, const Split& sp,
                 const Blocks& bp, float* out, int n, int w, int row0,
                 bool wide, cudaStream_t s) {
  Blocks walked = bp;
  if (KS > 1 && !wide) {
    walked.n_blocks = 0;
    walked.n_mids = -1;
  }
  launch_rows<ACCUM, G, KS>(DualSource<T, G, KS>{col, va, vb, x, fa}, rowptr,
                            sp, walked, out, n, w, row0, s);
}

template <typename T, bool ACCUM>
void dual_dispatch(const int* rowptr, const int* col, const float* va,
                   const float* vb, const T* x, int fa, const Split& sp,
                   const Blocks& bp, float* out, int n, int w, int row0,
                   bool wide, cudaStream_t s) {
#define PGSD_DUAL(G, KS)                                                    \
  dual_launch<T, ACCUM, G, KS>(rowptr, col, va, vb, x, fa, sp, bp, out, n, \
                               w, row0, wide, s)
  PGSD_DISPATCH_WIDTH(w, PGSD_DUAL);
#undef PGSD_DUAL
}

template <typename T, bool ACCUM>
void pair_dispatch(const int* rowptr, const int* col, const float* va,
                   const float* vb, const float* wa, const float* wb,
                   const T* x, int fa, const Split& sp, const Blocks& bp,
                   float* out, int n, int w, int row0, cudaStream_t s) {
#define PGSD_PAIR(G, KS)                                                     \
  launch_rows<ACCUM, G, KS>(                                                 \
      PairSource<T, G, KS, true>{col, va, vb, wa, wb, x, fa}, rowptr, sp, bp, \
      out, n, w, row0, s)
  PGSD_DISPATCH_WIDTH(w, PGSD_PAIR);
#undef PGSD_PAIR
}

// ---------------------------------------------------------------------------
// pgsd_csr_scatter: one warp a row (or piece) of row-ordered messages

// V lanes of one message, as float: one 16-byte load (message rows
// start 16-byte aligned on this path).
template <typename T, int V>
__device__ __forceinline__ void load_lanes(const T* m, int f0,
                                           float (&v)[V]) {
  static_assert(V * sizeof(T) == 16, "V is 16 bytes of the message type");
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
}

// The message loaders of csr_msgs_kernel, csr_span_kernel and
// csr_walk_kernel.  Slot j is a message's place in the CSR's edge order;
// `cols` lanes of the message come from a row (lane off + c holds column
// c), and an indexed message may put one scalar lane before them.

// pgsd_csr_scatter: row-ordered messages, contiguous [E, width].
template <typename T>
struct RowMsgs {
  static constexpr bool kIndexed = false;
  using Type = T;
  const T* __restrict__ msgs;
  int width;
  __device__ __forceinline__ int cols() const { return width; }
  __device__ __forceinline__ int off() const { return 0; }
  // lanes [f0, f0 + V) of message j (16-byte aligned rows)
  template <int V>
  __device__ __forceinline__ void lanes(int j, int f0, float (&v)[V]) const {
    load_lanes<T, V>(msgs + (int64_t)j * width, f0, v);
  }
  // lane l of message j
  __device__ __forceinline__ float lane(int j, int l) const {
    return to_f32(msgs[(int64_t)j * width + l]);
  }
};

// pgsd_csr_scatter_indexed: message j is [s_j | w_j * table[index[j]]]
// (no scalar: [w_j * table[index[j]]]; no weight: w_j = 1), read at the
// moment it is added, so the [E, F] messages never lie in device memory.
// w_j and s_j are read at slot j.  Each product is rounded on its own
// (__fmul_rn: nvcc may not contract it into the sum), so a message equals
// the materialized w * row bit for bit.
struct IndexedMsgs {
  static constexpr bool kIndexed = true;
  using Type = float;
  const float* __restrict__ table;    // [M, F] f32, rows of F lanes
  const int64_t* __restrict__ index;  // [E] the table row of each slot
  const float* __restrict__ weight;   // [E] or null
  const float* __restrict__ scalar;   // [E] or null (no scalar lane)
  int F;
  __device__ __forceinline__ int cols() const { return F; }
  // with a scalar, lane 0 holds it and lane 1 + c column c
  __device__ __forceinline__ int off() const { return scalar ? 1 : 0; }
  __device__ __forceinline__ float w(int j) const {
    return weight ? weight[j] : 1.f;
  }
  __device__ __forceinline__ float scal(int j) const { return scalar[j]; }
  // columns [c0, c0 + 4) of the table row of message j (16-byte aligned
  // rows), times its weight
  template <int V>
  __device__ __forceinline__ void lanes(int j, int c0, float (&v)[V]) const {
    static_assert(V == 4, "an indexed row is read 4 f32 lanes a load");
    const float4 u =
        *reinterpret_cast<const float4*>(table + index[j] * F + c0);
    const float x = w(j);
    v[0] = __fmul_rn(x, u.x);
    v[1] = __fmul_rn(x, u.y);
    v[2] = __fmul_rn(x, u.z);
    v[3] = __fmul_rn(x, u.w);
  }
  __device__ __forceinline__ float lane(int j, int l) const {
    if (scalar && l == 0) return scal(j);
    return __fmul_rn(w(j), table[index[j] * F + l - off()]);
  }
};

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
// added; returns in s the float64 sum of its row's P slots.  An indexed
// message's scalar lane is summed beside them by the threads that `own`
// it (lane thread 0 of the first lane tile), as lane f0 of those threads
// is, into ss.  Every thread of the warp must call it (the fold is a warp
// shuffle).
template <class Ld, int V, int TL, int P>
__device__ __forceinline__ void strided_sum(const Ld& ld, int e0, int e1,
                                            int f0, bool live, bool own,
                                            double (&s)[V], double& ss) {
  constexpr int D = msg_depth<V>();
  float acc[V], cmp[V], sacc = 0.f, scmp = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = cmp[i] = 0.f;
  if (live) {
    for (int e = e0; e < e1; e += D * P) {
      float v[D][V], sv[D];
#pragma unroll
      for (int u = 0; u < D; ++u)
        if (e + u * P < e1) {
          ld.template lanes<V>(e + u * P, f0, v[u]);
          if constexpr (Ld::kIndexed)
            if (own) sv[u] = ld.scal(e + u * P);
        }
#pragma unroll
      for (int u = 0; u < D; ++u)
        if (e + u * P < e1) {
#pragma unroll
          for (int i = 0; i < V; ++i) kahan_add(acc[i], cmp[i], v[u][i]);
          if constexpr (Ld::kIndexed)
            if (own) kahan_add(sacc, scmp, sv[u]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = (double)acc[i] - (double)cmp[i];
  ss = (double)sacc - (double)scmp;
  // the P edge slots meet in a butterfly: every slot ends with the same
  // bits, since each step adds two values in either order
#pragma unroll
  for (int d = TL; d < TL * P; d <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], d);
    if constexpr (Ld::kIndexed) ss += __shfl_xor_sync(0xffffffffu, ss, d);
  }
}

// 8 loads of 4 lanes (or 4 of 8) in flight need more than the 64
// registers a thread has at 4 CTAs of 256 threads per SM.
constexpr int kMsgMinCtas = 3;

// CTAs [0, piece CTAs) sum one piece per TL * P threads into `partial`;
// the rest one row of at most piece_len edges per TL * P threads into
// `out`.  Threads without a row or piece (past the end, a cut row, an
// empty row in the accumulate mode) sum nothing but join the fold.  Lane
// tile blockIdx.y holds the loader's columns [y*TL*V, (y+1)*TL*V); `width`
// is the row stride of out and of the partials.
template <class Ld, int V, int TL, bool ACCUM>
__global__ void __launch_bounds__(kBlock, kMsgMinCtas)
    csr_msgs_kernel(
    const Ld ld, const int* __restrict__ rowptr, Split sp,
    float* __restrict__ out, int n_rows, int width, int row0) {
  constexpr int P = msg_slots<TL>();
  constexpr int kSlots = kBlock / (TL * P);  // rows (pieces) of a CTA
  const int piece_ctas = (sp.n_pieces + kSlots - 1) / kSlots;
  const int slot = threadIdx.x / (TL * P);
  const int f0 = blockIdx.y * (TL * V) + (threadIdx.x % TL) * V;
  const int j = (threadIdx.x / TL) % P;
  const int cols = ld.cols(), off = ld.off();
  const bool live = f0 < cols;
  bool own = false;  // the thread that sums the scalar lane
  if constexpr (Ld::kIndexed)
    own = ld.scalar && blockIdx.y == 0 && threadIdx.x % TL == 0;
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
  double s[V], ss;
  strided_sum<Ld, V, TL, P>(ld, e0 + j, e1, f0, live, own, s, ss);
  if (j != 0 || !live) return;
  if (p >= 0) {
    double* part = sp.partial + (int64_t)p * width + off;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (f0 + i < cols) part[f0 + i] = s[i];
    if constexpr (Ld::kIndexed)
      if (own) sp.partial[(int64_t)p * width] = ss;
  } else if (row >= 0) {
    float* o = out + ((int64_t)row0 + row) * width;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (f0 + i < cols)
        o[off + f0 + i] =
            (float)(ACCUM ? (double)o[off + f0 + i] + s[i] : s[i]);
    if constexpr (Ld::kIndexed)
      if (own) o[0] = (float)(ACCUM ? (double)o[0] + ss : ss);
  }
}

// The row kernel at the wrapper's TL, over the loader's `cols` columns
// (lane tiles of TL * V) into out rows of `w` lanes.
template <class Ld, int V, bool ACCUM>
int scatter_dispatch(const int* rowptr, const Ld& ld, int cols,
                     const Split& sp, float* out, int n, int w, int row0,
                     int tl, cudaStream_t s) {
#define PGSD_MSGS(TL)                                                      \
  case TL: {                                                               \
    constexpr int kSlots = kBlock / (TL * msg_slots<TL>());                \
    const unsigned gx = (sp.n_pieces + kSlots - 1) / kSlots +              \
                        (n + kSlots - 1) / kSlots;                         \
    csr_msgs_kernel<Ld, V, TL, ACCUM>                                      \
        <<<dim3(gx, (cols + TL * V - 1) / (TL * V)), kBlock, 0, s>>>(      \
            ld, rowptr, sp, out, n, w, row0);                              \
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

// ---------------------------------------------------------------------------
// pgsd_csr_scatter at widths off a multiple of 4, or from a base that is
// not 16-byte aligned (V = 1; see the header)

constexpr int kSpanWidth = 36;   // widest message of the staged row blocks
constexpr int kSpanBlock = 128;  // threads of a CTA of this path
constexpr int kSpanWarps = kSpanBlock / 32;

// A warp's stage: a block's span (fewer than kBlockEdges edges of up to
// kSpanWidth lanes), with 16 bytes to spare for its offset in its line,
// and the block's rowptr slice.  Sized for 36 lanes, not 64: the smaller
// stage leaves room for more warps an SM (timed on an H100 with
// scripts/ab_kernel_variants.py --only odd).  Wider messages are not
// staged: every uncut row is walked.
template <typename T>
struct __align__(16) SpanStage {
  unsigned char buf[kBlockEdges * kSpanWidth * sizeof(T) + 16];
  int rp[kBlockRows + 1];
};

// One row block per warp, staged as one span: pair p of the warp's pairs
// lane + 32 k is (row p / width, lane p % width), whose sum lands at
// element p of the block's out rows.
template <typename T, bool ACCUM>
__device__ __forceinline__ void span_block(const int4 blk,
                                           const T* __restrict__ msgs,
                                           const int* __restrict__ rowptr,
                                           SpanStage<T>& st,
                                           float* __restrict__ out,
                                           int width, int row0, int lane) {
  const int r0 = blk.x, nr = blk.y - blk.x, e0 = blk.z, ne = blk.w - blk.z;
  for (int k = lane; k <= nr; k += 32) cp_async4(&st.rp[k], rowptr + r0 + k);
  const T* m = stage_span(st.buf, msgs + (int64_t)e0 * width, ne * width,
                          lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  float* ob = out + ((int64_t)row0 + r0) * width;
  const Div div(width);
  for (int p = lane; p < nr * width; p += 32) {
    const int r = div(p);
    const int l = p - r * width;
    const int ja = st.rp[r] - e0, jb = st.rp[r + 1] - e0;
    if (ACCUM && ja == jb) continue;
    float acc = 0.f, cmp = 0.f;
    for (int j = ja; j < jb; ++j)
      kahan_add(acc, cmp, to_f32(m[j * width + l]));
    const double s = (double)acc - (double)cmp;
    ob[p] = (float)(ACCUM ? (double)ob[p] + s : s);
  }
}

// One warp sums edges [e0, e1) of one row or piece at its tile of 32
// columns (blockIdx.y).  The tile's C columns and S = 64 / C edge slots
// are the warp's 64 pairs q = lane + 32 k (k = 0, 1) as (column q % C,
// slot q / C): slot s sums its column over edges e0 + s, e0 + s + S, ...
// in edge order, compensated, with 8 loads of each of the thread's two
// pairs in flight.  The pairs' float64 sums meet in `fold` (the warp's 64
// doubles), where the thread of column c adds its slots in slot order and
// calls store(column, sum).  Every thread of the warp must call it.
template <class Ld, class Store>
__device__ __forceinline__ void warp_walk(const Ld& ld, int e0, int e1,
                                          int width, double* fold, int lane,
                                          Store store) {
  constexpr int D = 8;
  for (int c0 = 32 * blockIdx.y; c0 < width; c0 += 32 * gridDim.y) {
    const int C = min(width - c0, 32);
    const int S = 64 / C;
    float acc[2] = {0.f, 0.f}, cmp[2] = {0.f, 0.f};
    int l[2], slot[2];
    bool live[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      l[k] = c0 + q % C;
      slot[k] = q / C;
      live[k] = q < S * C;
    }
    for (int e = e0; e < e1; e += S * D) {
      float v[2][D];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int u = 0; u < D; ++u) {
          const int j = e + slot[k] + u * S;
          v[k][u] = live[k] && j < e1 ? ld.lane(j, l[k]) : 0.f;
        }
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int u = 0; u < D; ++u)
          if (live[k] && e + slot[k] + u * S < e1)
            kahan_add(acc[k], cmp[k], v[k][u]);
    }
    __syncwarp();  // the last pass's fold has been read
    fold[lane] = (double)acc[0] - (double)cmp[0];
    fold[lane + 32] = (double)acc[1] - (double)cmp[1];
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      double s = fold[c];
      for (int i = 1; i < S; ++i) s += fold[c + i * C];
      store(c0 + c, s);
    }
  }
}

// One (row, column) pair per thread: column l walked down edges [e0, e1)
// in edge order, compensated, 8 loads in flight, stored once at o.
template <class Ld, bool ACCUM>
__device__ __forceinline__ void walk_pair(const Ld& ld, int e0, int e1, int l,
                                          float* o) {
  constexpr int D = 8;
  float acc = 0.f, cmp = 0.f;
  for (int e = e0; e < e1; e += D) {
    float v[D];
#pragma unroll
    for (int u = 0; u < D; ++u)
      v[u] = e + u < e1 ? ld.lane(e + u, l) : 0.f;
#pragma unroll
    for (int u = 0; u < D; ++u)
      if (e + u < e1) kahan_add(acc, cmp, v[u]);
  }
  const double s = (double)acc - (double)cmp;
  *o = (float)(ACCUM ? (double)*o + s : s);
}

// CTAs [0, block CTAs) take a row block per warp (staged), the rest a
// (row, column) pair per thread of the listed rows: the plan's mid rows,
// or with `every` each row (W = 1, where a thread a row needs no stage,
// and W > kSpanWidth, and indexed messages, which have no span to stage;
// the plan's blocks are then not read).  Cut rows and rows of more than
// kWalkEdges edges are left to csr_walk_kernel.
template <class Ld, bool ACCUM>
__global__ void __launch_bounds__(kSpanBlock) csr_span_kernel(
    const Ld ld, const int* __restrict__ rowptr, Split sp,
    Blocks bp, float* __restrict__ out, int n_rows, int width, int row0,
    int every) {
  // the warps' stages, dynamic: a launch without blocks takes none, which
  // leaves room for more warps an SM
  extern __shared__ __align__(16) unsigned char smem[];
  const int block_ctas =
      every ? 0 : (bp.n_blocks + kSpanWarps - 1) / kSpanWarps;
  const int b = blockIdx.x;
  if (b < block_ctas) {
    const int warp = threadIdx.x / 32;
    const int i = b * kSpanWarps + warp;
    using T = typename Ld::Type;
    if constexpr (!Ld::kIndexed)
      if (i < bp.n_blocks)
        span_block<T, ACCUM>(bp.blocks[i], ld.msgs, rowptr,
                             reinterpret_cast<SpanStage<T>*>(smem)[warp],
                             out, width, row0, threadIdx.x & 31);
    return;
  }
  const int64_t q = (int64_t)(b - block_ctas) * kSpanBlock + threadIdx.x;
  const int n_listed = every ? n_rows : bp.n_mids;
  if (q >= (int64_t)n_listed * width) return;
  const int i = (int)(q / width);
  const int row = every ? i : bp.mids[i];
  const int l = (int)(q - (int64_t)i * width);
  const int e0 = rowptr[row], e1 = rowptr[row + 1];
  // a cut row (its pieces sum it), a walked row, or in the accumulate
  // mode an empty one
  if (e1 - e0 > kWalkEdges || e1 - e0 > sp.piece_len || (ACCUM && e0 == e1))
    return;
  walk_pair<Ld, ACCUM>(ld, e0, e1, l,
                       out + ((int64_t)row0 + row) * width + l);
}

// A warp per piece (into `partial`) and then per walked row (the plan's
// rows of more than kWalkEdges edges that are not cut, into `out`), and
// per tile of 32 columns (blockIdx.y): its own kernel, so that its two
// pairs of 8 loads in flight a thread do not take the registers of
// csr_span_kernel's many short walks.  (Tiles of 64 columns a warp lost
// 35% to the parent's scatter at W=34, where S = 1 left 30 of the second
// pairs idle; timed on an H100 with scripts/ab_kernel_variants.py --only
// odd.)
template <class Ld, bool ACCUM>
__global__ void __launch_bounds__(kSpanBlock) csr_walk_kernel(
    const Ld ld, const int* __restrict__ rowptr, Split sp,
    Blocks bp, float* __restrict__ out, int width, int row0) {
  __shared__ double fold[kSpanWarps][64];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int w = blockIdx.x * kSpanWarps + warp;
  if (w < sp.n_pieces) {
    const int2 pc = sp.pieces[w];
    double* part = sp.partial + (int64_t)w * width;
    warp_walk(ld, pc.x, pc.y, width, fold[warp], lane,
              [&](int c, double s) { part[c] = s; });
  } else if (w < sp.n_pieces + bp.n_walks) {
    const int row = bp.walks[w - sp.n_pieces];
    float* o = out + ((int64_t)row0 + row) * width;
    warp_walk(ld, rowptr[row], rowptr[row + 1], width, fold[warp], lane,
              [&](int c, double s) {
                o[c] = (float)(ACCUM ? (double)o[c] + s : s);
              });
  }
}

// V = 1: the short rows in one launch, the pieces and walked rows in a
// second where there are any (see above).
template <class Ld, bool ACCUM>
int span_dispatch(const int* rowptr, const Ld& ld, const Split& sp,
                  const Blocks& bp, float* out, int n, int w, int row0,
                  cudaStream_t s) {
  using T = typename Ld::Type;
  const bool every = Ld::kIndexed || w == 1 || w > kSpanWidth;
  const int64_t pairs = (int64_t)(every ? n : bp.n_mids) * w;
  const int64_t gx =
      (every ? 0 : (bp.n_blocks + kSpanWarps - 1) / kSpanWarps) +
      (pairs + kSpanBlock - 1) / kSpanBlock;
  const int smem =
      every || bp.n_blocks == 0 ? 0 : kSpanWarps * (int)sizeof(SpanStage<T>);
  if (gx)
    csr_span_kernel<Ld, ACCUM><<<(unsigned)gx, kSpanBlock, smem, s>>>(
        ld, rowptr, sp, bp, out, n, w, row0, every ? 1 : 0);
  const int walks = sp.n_pieces + bp.n_walks;
  if (walks)
    csr_walk_kernel<Ld, ACCUM>
        <<<dim3((walks + kSpanWarps - 1) / kSpanWarps, (w + 31) / 32),
           kSpanBlock, 0, s>>>(ld, rowptr, sp, bp, out, w, row0);
  return 0;
}

template <typename T, bool ACCUM>
int scatter_by_vec(const int* rowptr, const void* msgs, const Split& sp,
                   const Blocks& bp, float* out, int n, int w, int row0,
                   int v, int tl, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const RowMsgs<T> ld{static_cast<const T*>(msgs), w};
  if (v == kVec)
    return scatter_dispatch<RowMsgs<T>, kVec, ACCUM>(rowptr, ld, w, sp, out,
                                                     n, w, row0, tl, s);
  if (v == 1)
    return span_dispatch<RowMsgs<T>, ACCUM>(rowptr, ld, sp, bp, out, n, w,
                                            row0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Indexed messages (IndexedMsgs) into rows of w lanes: 4 lanes a load
// where the table's rows are whole 16-byte lines (v = 4), else the V = 1
// walks, every row walked (no span to stage).
int scatter_indexed(const int* rowptr, const IndexedMsgs& ld,
                    const Split& sp, const Blocks& bp, float* out, int n,
                    int w, int v, int tl, cudaStream_t s) {
  if (v == 4)
    return scatter_dispatch<IndexedMsgs, 4, false>(rowptr, ld, ld.F, sp, out,
                                                   n, w, 0, tl, s);
  if (v == 1)
    return span_dispatch<IndexedMsgs, false>(rowptr, ld, sp, bp, out, n, w,
                                             0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  The plan (pieces, rows, ptr, counts, piece_len; row
// blocks and mid rows) is scatter_csr.py's RowSplit of this rowptr;
// `partial` is scratch of n_pieces * (the output's width) doubles.  Each
// entry launches the row kernel and, if any row is cut, the combine, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a geometry it
// does not take).

// The most edges and rows of a row block that the kernels take, and the
// longest row a thread walks alone (scatter_csr.py's BLOCK_EDGES,
// BLOCK_ROWS and WALK_EDGES).
extern "C" void pgsd_csr_block_shape(int* edges, int* rows, int* walk) {
  *edges = kBlockEdges;
  *rows = kBlockRows;
  *walk = kWalkEdges;
}

// The lanes of a tile of the dual's row blocks (scatter_csr.py's
// BLOCK_TILE); a build that exports it takes the wide_blocks argument.
extern "C" int pgsd_csr_dual_tile() { return kTile; }

// `wide_blocks`: above kTile lanes, sum the plan's row blocks in tiles of
// kTile lanes (else every uncut row is walked); scatter_csr.py sets it
// where x is far larger than L2.
extern "C" int pgsd_csr_dual_spmm(const void* rowptr, const void* col,
                                  const void* val_a, const void* val_b,
                                  const void* x, void* out, int n_rows,
                                  int width, int fa, int x_is_bf16, int accum,
                                  int row0, int wide_blocks,
                                  const void* pieces, int n_pieces,
                                  const void* rows, const void* ptr,
                                  int n_long, int piece_len, void* partial,
                                  const void* blocks, int n_blocks,
                                  const void* mids, int n_mids,
                                  const void* walks, int n_walks,
                                  void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const Blocks bp =
      blocks_of(blocks, n_blocks, mids, n_mids, walks, n_walks);
  const int* rp = static_cast<const int*>(rowptr);
  const int* c = static_cast<const int*>(col);
  const float* va = static_cast<const float*>(val_a);
  const float* vb = static_cast<const float*>(val_b);
  float* o = static_cast<float*>(out);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  const bool wide = wide_blocks != 0;
  if (x_is_bf16 && accum)
    dual_dispatch<__nv_bfloat16, true>(rp, c, va, vb, xh, fa, sp, bp, o,
                                       n_rows, width, row0, wide, s);
  else if (x_is_bf16)
    dual_dispatch<__nv_bfloat16, false>(rp, c, va, vb, xh, fa, sp, bp, o,
                                        n_rows, width, row0, wide, s);
  else if (accum)
    dual_dispatch<float, true>(rp, c, va, vb, xf, fa, sp, bp, o, n_rows,
                               width, row0, wide, s);
  else
    dual_dispatch<float, false>(rp, c, va, vb, xf, fa, sp, bp, o, n_rows,
                                width, row0, wide, s);
  return combine(sp, o, width, row0, accum != 0, s);
}

// `width` is x's; out has 2 * width columns and `partial` n_pieces *
// 2 * width doubles.  The pair keeps a group per row for every row (the
// plan's blocks are not read).
extern "C" int pgsd_csr_pair_spmm(const void* rowptr, const void* col,
                                  const void* val_a, const void* val_b,
                                  const void* w_a, const void* w_b,
                                  const void* x, void* out, int n_rows,
                                  int width, int fa, int x_is_bf16, int accum,
                                  int row0, const void* pieces, int n_pieces,
                                  const void* rows, const void* ptr,
                                  int n_long, int piece_len, void* partial,
                                  const void* blocks, int n_blocks,
                                  const void* mids, int n_mids,
                                  const void* walks, int n_walks,
                                  void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const Blocks bp =
      blocks_of(blocks, n_blocks, mids, n_mids, walks, n_walks);
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
    pair_dispatch<__nv_bfloat16, true>(rp, c, va, vb, wa, wb, xh, fa, sp, bp,
                                       o, n_rows, width, row0, s);
  else if (x_is_bf16)
    pair_dispatch<__nv_bfloat16, false>(rp, c, va, vb, wa, wb, xh, fa, sp,
                                        bp, o, n_rows, width, row0, s);
  else if (accum)
    pair_dispatch<float, true>(rp, c, va, vb, wa, wb, xf, fa, sp, bp, o,
                               n_rows, width, row0, s);
  else
    pair_dispatch<float, false>(rp, c, va, vb, wa, wb, xf, fa, sp, bp, o,
                                n_rows, width, row0, s);
  return combine(sp, o, 2 * width, row0, accum != 0, s);
}

// `lanes` (V) and `lane_threads` (TL) are the wrapper's geometry
// (scatter_csr.py, _msg_geometry): V = 16 bytes of the message type when
// every row of msgs starts 16-byte aligned, else 1 (csr_span_kernel,
// which does not read TL); TL a power of two up to 32.
extern "C" int pgsd_csr_scatter(const void* rowptr, const void* msgs,
                                void* out, int n_rows, int width,
                                int msgs_is_bf16, int accum, int row0,
                                int lanes, int lane_threads,
                                const void* pieces, int n_pieces,
                                const void* rows, const void* ptr, int n_long,
                                int piece_len, void* partial,
                                const void* blocks, int n_blocks,
                                const void* mids, int n_mids,
                                const void* walks, int n_walks,
                                void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const Blocks bp =
      blocks_of(blocks, n_blocks, mids, n_mids, walks, n_walks);
  const int* rp = static_cast<const int*>(rowptr);
  float* o = static_cast<float*>(out);
  int err;
  if (msgs_is_bf16 && accum)
    err = scatter_by_vec<__nv_bfloat16, true>(rp, msgs, sp, bp, o, n_rows,
                                              width, row0, lanes,
                                              lane_threads, s);
  else if (msgs_is_bf16)
    err = scatter_by_vec<__nv_bfloat16, false>(rp, msgs, sp, bp, o, n_rows,
                                               width, row0, lanes,
                                               lane_threads, s);
  else if (accum)
    err = scatter_by_vec<float, true>(rp, msgs, sp, bp, o, n_rows, width,
                                      row0, lanes, lane_threads, s);
  else
    err = scatter_by_vec<float, false>(rp, msgs, sp, bp, o, n_rows, width,
                                       row0, lanes, lane_threads, s);
  if (err) return err;
  return combine(sp, o, width, row0, accum != 0, s);
}

// K1 over messages read by index (IndexedMsgs): message j of the CSR's
// slot order is [s[j] | w[j] * table[index[j]]], `cols` the table's
// width; out has cols + 1 columns (cols without a scalar) and `partial`
// n_pieces times as many doubles.  `weight` and `scalar` may be null
// (weight 1, no scalar lane).  `lanes` (4 where the table's rows are
// whole 16-byte lines, else 1) and `lane_threads` as for
// pgsd_csr_scatter, from the table's width.
extern "C" int pgsd_csr_scatter_indexed(
    const void* rowptr, const void* table, const void* index,
    const void* weight, const void* scalar, void* out, int n_rows,
    int cols, int lanes, int lane_threads,
    const void* pieces, int n_pieces, const void* rows, const void* ptr,
    int n_long, int piece_len, void* partial, const void* blocks,
    int n_blocks, const void* mids, int n_mids, const void* walks,
    int n_walks, void* stream) {
  const int width = cols + (scalar ? 1 : 0);
  if (n_rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp =
      split_of(pieces, n_pieces, rows, ptr, n_long, piece_len, partial);
  const Blocks bp =
      blocks_of(blocks, n_blocks, mids, n_mids, walks, n_walks);
  const IndexedMsgs ld{static_cast<const float*>(table),
                       static_cast<const int64_t*>(index),
                       static_cast<const float*>(weight),
                       static_cast<const float*>(scalar), cols};
  float* o = static_cast<float*>(out);
  const int err = scatter_indexed(static_cast<const int*>(rowptr), ld, sp, bp,
                                  o, n_rows, width, lanes, lane_threads, s);
  if (err) return err;
  return combine(sp, o, width, 0, false, s);
}
