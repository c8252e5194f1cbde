// Helpers shared by the row-sorted CSR kernels (scatter_csr.cu,
// dual_sddmm.cu): value conversion, message rounding, compensated sums and
// the warp-shuffle mask of a thread group.
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

template <int G, int KS>
inline dim3 grid_for(int n_rows, int width) {
  return dim3((n_rows + kBlock / G - 1) / (kBlock / G),
              (width + G * KS - 1) / (G * KS));
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

}  // namespace pgsd
