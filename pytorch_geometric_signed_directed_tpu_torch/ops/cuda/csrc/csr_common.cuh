// Helpers shared by the row-sorted CSR kernels (scatter_csr.cu,
// dual_sddmm.cu): value conversion, message rounding, compensated sums, the
// warp-shuffle mask of a thread group, the plan of cut rows with its
// fixed-order combine, and the staged two-sum edge walk (PairSource) of the
// pair forward and of K3.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pgsd {

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

// sum += v with the running compensation c.  The _rn intrinsics keep the
// compiler from contracting or reordering the four steps.
__device__ __forceinline__ void kahan_add(float& sum, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(sum, y);
  c = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// G threads (a group, G divides 32) own one output row; thread t of the
// group owns lanes f0 + k*G, k < KS, of the feature tile blockIdx.y.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned ones = G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u);
  return ones << (((threadIdx.x & 31) / G) * G);
}

// The (G, KS) of a width: narrow widths pack several rows into a warp
// (G < 32); wide ones give each thread up to 8 lanes and tile anything
// past 256 over blockIdx.y.  LAUNCH(G, KS) is a macro of the caller.
#define PGSD_DISPATCH_WIDTH(w, LAUNCH) \
  if ((w) <= 4) LAUNCH(4, 1);          \
  else if ((w) <= 8) LAUNCH(8, 1);     \
  else if ((w) <= 16) LAUNCH(16, 1);   \
  else if ((w) <= 32) LAUNCH(32, 1);   \
  else if ((w) <= 64) LAUNCH(32, 2);   \
  else if ((w) <= 128) LAUNCH(32, 4);  \
  else LAUNCH(32, 8)

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

// ---------------------------------------------------------------------------
// The plan of cut rows (scatter_csr.py, RowSplit) and its combine

struct Split {
  const int2* pieces;  // [n_pieces] (first edge, end edge)
  const int* rows;     // [n_long] the cut rows
  const int* ptr;      // [n_long + 1] each cut row's pieces
  double* partial;     // [n_pieces, width] scratch
  int n_pieces;
  int n_long;
  int piece_len;
};

inline Split split_of(const void* pieces, int n_pieces, const void* rows,
                      const void* ptr, int n_long, int piece_len,
                      void* partial) {
  return Split{static_cast<const int2*>(pieces), static_cast<const int*>(rows),
               static_cast<const int*>(ptr), static_cast<double*>(partial),
               n_pieces, n_long, piece_len};
}

// The index j into sp.rows of the cut row that owns piece p: the last j
// with ptr[j] <= p (a cut row has at least one piece, so ptr rises).
__device__ __forceinline__ int piece_owner(const Split& sp, int p) {
  int lo = 0, hi = sp.n_long - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (sp.ptr[mid] <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// out[row0 + rows[j], f] = (accum ? prior : 0) + the partials of row j's
// pieces in piece order, summed in float64 and rounded once.  `width` is
// the row stride of both out and the partials.
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

// The launch that finishes the cut rows; returns cudaGetLastError().
inline int combine(const Split& sp, float* out, int w, int row0, bool accum,
                   cudaStream_t s) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sp.n_long == 0) return static_cast<int>(err);
  const int64_t total = (int64_t)sp.n_long * w;
  combine_pieces_kernel<<<(unsigned)((total + kBlock - 1) / kBlock), kBlock,
                          0, s>>>(sp, out, w, row0, accum ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The staged two-sum edge walk
//
// For the edges of one row (or piece) a group of G threads sums, per lane
// l = f0 + k*G of the gather table x:
//   acc[k]      += round(sel_l(va, vb)[e] * x[col[e], l])
//   acc[KS + k] += round?(sel_l(wa, wb)[e] * x[col[e], l])
// with sel_l the a-value for lanes below fa, round() to x's type, and the
// second product rounded only if ROUND_W (the pair forward rounds both
// messages; K3 keeps its dq products in f32).  One thread owns a lane and
// both sums that read it, so each x element is gathered once per edge.
// Each chunk's columns and (va, vb, wa, wb) are staged in shared memory
// by coalesced loads (the next chunk's early) and read back with
// broadcast loads: five warp shuffles an edge would make the loop
// issue-bound.  A batch of D gathers is issued before any is added, then
// they are added in edge order; the batch keeps only the gathered values
// in registers and reads each edge's four values when it adds them.  The
// batch's D products are summed plainly in f32 and the batch sum joins the
// running sum compensated (one kahan_add a batch instead of one an edge:
// four adds an edge were half of the loop's issue slots).  Over a hub row
// that stays within about twice the error of a compensated add per edge
// and over ten times below a plain f32 sum's (tests/test_torch_pair.py
// emulates all three).
//
// It keeps 8 gathers in flight up to 4 lanes a thread (4 at 8 lanes, whose
// 64 gathered values would spill): with only the gathered values held,
// the deeper batch fits the register budget of min_ctas<KS>() and was
// 4-17% faster than 4 on the trainable-q template and the hub CSR (timed
// on an H100 with scripts/ab_kernel_variants.py).
template <typename T, int G, int KS, bool ROUND_W>
struct PairSource {
  static constexpr int NS = 2;                 // sums a lane: out and w-out
  static constexpr int D = KS >= 8 ? 4 : 8;
  static constexpr int MIN_CTAS = min_ctas<KS>();
  static constexpr int S = D > G ? D / G : 1;  // edges a thread loads a chunk
  static constexpr int C = G * S;              // edges of a chunk
  // a group's chunk takes C + 1 entries when several groups share a warp:
  // with C alone their broadcast reads would fall in the same banks
  static constexpr int CP = C + (G < 32 ? 1 : 0);
  const int* col;
  const float* va;
  const float* vb;
  const float* wa;
  const float* wb;
  const T* x;
  int fa;

  __device__ __forceinline__ void load(int base, int e1, int t, int (&c)[S],
                                       float4 (&v)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = base + s * G + t;
      if (e < e1) {
        c[s] = col[e];
        v[s] = make_float4(va[e], vb[e], wa[e], wb[e]);
      } else {
        c[s] = 0;
        v[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // Adds staged edges [j0, j0 + D) (FULL) or [j0, n).
  template <bool FULL>
  __device__ __forceinline__ void batch(const int* cols, const float4* vals,
                                        int j0, int n, int width, int f0,
                                        float (&acc)[NS * KS],
                                        float (&cmp)[NS * KS]) const {
    float xv[D][KS];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (FULL || j0 + u < n) {
        const T* xr = x + (int64_t)cols[j0 + u] * width;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int f = f0 + k * G;
          xv[u][k] = f < width ? to_f32(xr[f]) : 0.f;
        }
      }
    }
    float bs[NS * KS];  // the batch's own sums, in edge order
#pragma unroll
    for (int k = 0; k < NS * KS; ++k) bs[k] = 0.f;
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (FULL || j0 + u < n) {
        const float4 ev = vals[j0 + u];
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const bool lo = f0 + k * G < fa;
          const float pw = __fmul_rn(lo ? ev.z : ev.w, xv[u][k]);
          bs[k] = __fadd_rn(
              bs[k], round_msg<T>(__fmul_rn(lo ? ev.x : ev.y, xv[u][k])));
          bs[KS + k] =
              __fadd_rn(bs[KS + k], ROUND_W ? round_msg<T>(pw) : pw);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NS * KS; ++k) kahan_add(acc[k], cmp[k], bs[k]);
  }

  // Adds the edges [e0, e1) to (acc, cmp), in edge order.
  __device__ __forceinline__ void sum(int e0, int e1, int width, int f0,
                                      float (&acc)[NS * KS],
                                      float (&cmp)[NS * KS]) const {
    __shared__ int stage_c[(kBlock / G) * CP];
    __shared__ float4 stage_v[(kBlock / G) * CP];
    int* cols = stage_c + (threadIdx.x / G) * CP;  // this group's chunk
    float4* vals = stage_v + (threadIdx.x / G) * CP;
    const int t = threadIdx.x % G;
    const unsigned mask = group_mask<G>();
    int c[S];
    float4 v[S];
    load(e0, e1, t, c, v);
    for (int base = e0; base < e1; base += C) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        cols[s * G + t] = c[s];
        vals[s * G + t] = v[s];
      }
      __syncwarp(mask);
      load(base + C, e1, t, c, v);  // the next chunk's edges, early
      const int n = min(C, e1 - base);
      int j0 = 0;
      for (; j0 + D <= n; j0 += D)
        batch<true>(cols, vals, j0, n, width, f0, acc, cmp);
      if (j0 < n) batch<false>(cols, vals, j0, n, width, f0, acc, cmp);
      __syncwarp(mask);  // every read of the chunk before the next is staged
    }
  }
};

}  // namespace pgsd
