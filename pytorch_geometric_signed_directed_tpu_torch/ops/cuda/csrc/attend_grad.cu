// The logit gradient of a softmax-weighted sum by destination, one value an
// edge, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package's motif attention
// (pytorch_geometric_signed_directed_tpu/nn/signed/motif_stack.py) leaves
// its backward's edge terms to XLA, which fuses the row gathers into the
// reductions.  PyTorch does not: the port's backward gathered T[src],
// out[dst] and dout[dst] into three [E, F] edge tensors (249 MB each at
// SDGNN's Epinions size) only to reduce each edge to one number.  Here
// each edge is reduced where its rows are read:
//
//   dpre[e] = slope'(pre[e]) * (alpha[e] * sum_f (T[src_e, f] - out[d, f])
//                                                  * dout[d, f]),  d = row[e]
//
// with slope'(p) = 1 for p >= 0, else `slope`.  Each difference and product
// is rounded to f32 on its own, as the PyTorch composition rounds them (the
// difference form is kept: T . dout - out . dout would cancel); the F
// products are summed in float64 and rounded once, then scaled as PyTorch
// scales them.
//
// What bounds it: bytes.  An edge reads its T row (F f32, a gather by
// source) and its destination's out and dout rows, which the edges of one
// destination share: they lie next to each other in the CSR's edge order,
// so a destination's rows come from device memory about once and from the
// cache for its other edges.  A group of G threads takes an edge (4 lanes
// a thread a 16-byte load where rows are whole 16-byte lines, else one
// lane), so a hub destination's thousands of edges spread over the card
// rather than down one walk.  The group's partial sums meet in a butterfly
// of warp shuffles in a fixed order: every call gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <bool VEC>
__global__ void __launch_bounds__(kBlock) attend_logit_grad_kernel(
    const int64_t* __restrict__ row, const int64_t* __restrict__ index,
    const float* __restrict__ table, const float* __restrict__ out,
    const float* __restrict__ dout, const float* __restrict__ alpha,
    const float* __restrict__ pre, float slope, float* __restrict__ dpre,
    int64_t n_edges, int F, int G) {
  const int64_t e = ((int64_t)blockIdx.x * kBlock + threadIdx.x) / G;
  const int t = threadIdx.x % G;
  double acc = 0.0;
  if (e < n_edges) {
    const float* tr = table + index[e] * F;
    const int64_t d = row[e];
    const float* orow = out + d * F;
    const float* grow = dout + d * F;
    if constexpr (VEC) {
      for (int c = 4 * t; c < F; c += 4 * G) {
        const float4 a = *reinterpret_cast<const float4*>(tr + c);
        const float4 b = *reinterpret_cast<const float4*>(orow + c);
        const float4 g = *reinterpret_cast<const float4*>(grow + c);
        acc += (double)__fmul_rn(__fsub_rn(a.x, b.x), g.x);
        acc += (double)__fmul_rn(__fsub_rn(a.y, b.y), g.y);
        acc += (double)__fmul_rn(__fsub_rn(a.z, b.z), g.z);
        acc += (double)__fmul_rn(__fsub_rn(a.w, b.w), g.w);
      }
    } else {
      for (int c = t; c < F; c += G)
        acc += (double)__fmul_rn(__fsub_rn(tr[c], orow[c]), grow[c]);
    }
  }
  // G divides 32: the group's threads meet within their warp
  for (int m = 1; m < G; m <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (t == 0 && e < n_edges) {
    const float dl = __fmul_rn(alpha[e], (float)acc);
    dpre[e] = __fmul_rn(dl, pre[e] >= 0.f ? 1.f : slope);
  }
}

}  // namespace

// Plain C interface for ctypes: device pointers; `row` and `index` [E]
// int64 (each edge's destination and its table row), table [M, F], out
// and dout [N, F], alpha, pre and dpre [E], all f32 and contiguous.  `vec`
// 1 where F % 4 == 0 and table, out and dout start 16-byte aligned; G, the
// threads an edge, a power of two up to 32.  Returns cudaGetLastError().
extern "C" int pgsd_attend_logit_grad(const void* row, const void* index,
                                      const void* table, const void* out,
                                      const void* dout, const void* alpha,
                                      const void* pre, float slope,
                                      void* dpre, int64_t n_edges, int F,
                                      int vec, int G, void* stream) {
  if (n_edges <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 1 || G > 32 || (G & (G - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t threads = n_edges * G;
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  const int64_t* r = static_cast<const int64_t*>(row);
  const int64_t* i = static_cast<const int64_t*>(index);
  const float* tb = static_cast<const float*>(table);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  const float* a = static_cast<const float*>(alpha);
  const float* p = static_cast<const float*>(pre);
  float* d = static_cast<float*>(dpre);
  if (vec)
    attend_logit_grad_kernel<true><<<grid, kBlock, 0, s>>>(
        r, i, tb, o, g, a, p, slope, d, n_edges, F, G);
  else
    attend_logit_grad_kernel<false><<<grid, kBlock, 0, s>>>(
        r, i, tb, o, g, a, p, slope, d, n_edges, F, G);
  return static_cast<int>(cudaGetLastError());
}
