// Block-sparse-row SpMM over 128x128 dense float32 blocks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K5: pytorch_geometric_signed_directed_tpu/ops/
// pallas/bsr_spmm.py `_kernel` and its launcher `_bsr_matmul`.  The TPU
// grid walks (feature tile, nonzero block) in order and keeps the output
// tile of a block row resident in VMEM while consecutive blocks of that
// row add into it, at Precision.HIGHEST.  Here one CTA owns one (block
// row, feature tile): it loops over the row's blocks from a block-row
// pointer, stages each 128x128 block and the matching 128-row tile of x in
// shared memory, and sums with float32 FMAs in registers (no TF32, for
// parity with HIGHEST).  An empty block row writes zeros.
//
//   pgsd_bsr_spmm  out[r, f] = sum_{blocks i of block row r/128}
//                              sum_c blocks[i, r%128, c] *
//                                    x[block_cols[i]*128 + c, f]
//
// What bounds it: bytes at the bench's widths (2 and 32).  Each block is
// 64 KB read once for each feature tile, against 2*128*128*F flops; below
// F of about 80 the 3.35 TB/s memory rate, not the 67 TFLOP/s float32
// rate, sets the least time.  The design reads every block once per
// feature tile with coalesced 16-byte loads; the block's shared-memory
// rows are padded to 132 floats so that the 16-byte reads of threads that
// own different rows fall in different banks.  What it leaves: the loads
// of a block are not overlapped with the sums over the previous one, and
// a graph with fewer block rows than the card has SMs leaves SMs idle (the
// N=8192 graph has 64 block rows).  TMA double buffering, a split of long
// block rows and wgmma in TF32x3 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;           // block side
constexpr int kThreads = 256;
constexpr int kStride = kB + 4;   // padded shared-memory row of a block

template <int FT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kB * kStride + kB * FT);
}

// FT lanes of the feature tile; thread t owns lane t % FT of rows
// t / FT + k * (kThreads / FT), k < FT / 2.
template <int FT>
__global__ void __launch_bounds__(kThreads) bsr_spmm_kernel(
    const float* __restrict__ blocks, const int* __restrict__ block_rowptr,
    const int* __restrict__ block_cols, const float* __restrict__ x,
    float* __restrict__ out, int n_rows, int n_cols, int width) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);   // [kB][kStride]
  float* xs = bs + kB * kStride;                 // [kB][FT]
  constexpr int kGroups = kThreads / FT;
  constexpr int kRows = kB / kGroups;
  const int br = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int t = threadIdx.x;
  const int f = t % FT;
  const int rg = t / FT;
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;

  const int end = block_rowptr[br + 1];
  for (int i = block_rowptr[br]; i < end; ++i) {
    const int bc = block_cols[i];
    const float4* src =
        reinterpret_cast<const float4*>(blocks + (int64_t)i * kB * kB);
#pragma unroll 4
    for (int v = t; v < kB * kB / 4; v += kThreads) {
      const int r = v / (kB / 4);
      const int c4 = v % (kB / 4);
      *reinterpret_cast<float4*>(bs + r * kStride + c4 * 4) = src[v];
    }
    for (int v = t; v < kB * FT; v += kThreads) {
      const int gc = bc * kB + v / FT;
      const int gf = f0 + v % FT;
      xs[v] = (gc < n_cols && gf < width) ? x[(int64_t)gc * width + gf]
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kB; c += 4) {
      const float x0 = xs[(c + 0) * FT + f];
      const float x1 = xs[(c + 1) * FT + f];
      const float x2 = xs[(c + 2) * FT + f];
      const float x3 = xs[(c + 3) * FT + f];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + (rg + k * kGroups) * kStride + c);
        float a = acc[k];
        a = fmaf(b.x, x0, a);
        a = fmaf(b.y, x1, a);
        a = fmaf(b.z, x2, a);
        a = fmaf(b.w, x3, a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }
  const int gf = f0 + f;
  if (gf < width) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = br * kB + rg + k * kGroups;
      if (r < n_rows) out[(int64_t)r * width + gf] = acc[k];
    }
  }
}

template <int FT>
cudaError_t launch(const float* blocks, const int* brp, const int* bcols,
                   const float* x, float* out, int n_block_rows, int n_rows,
                   int n_cols, int width, cudaStream_t s) {
  // above 48 KB of shared memory a kernel must opt in (per device, so on
  // every launch: the call is a host-side attribute write)
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<FT>());
  if (err != cudaSuccess) return err;
  const dim3 grid(n_block_rows, (width + FT - 1) / FT);
  bsr_spmm_kernel<FT><<<grid, kThreads, smem_bytes<FT>(), s>>>(
      blocks, brp, bcols, x, out, n_rows, n_cols, width);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  Returns the launch's cudaGetLastError().
extern "C" int pgsd_bsr_spmm(const void* blocks, const void* block_rowptr,
                             const void* block_cols, const void* x,
                             void* out, int n_block_rows, int n_rows,
                             int n_cols, int width, void* stream) {
  if (n_block_rows <= 0 || width <= 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(blocks);
  const int* rp = static_cast<const int*>(block_rowptr);
  const int* bc = static_cast<const int*>(block_cols);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (width <= 2)
    err = launch<2>(b, rp, bc, xx, o, n_block_rows, n_rows, n_cols, width, s);
  else if (width <= 4)
    err = launch<4>(b, rp, bc, xx, o, n_block_rows, n_rows, n_cols, width, s);
  else if (width <= 8)
    err = launch<8>(b, rp, bc, xx, o, n_block_rows, n_rows, n_cols, width, s);
  else if (width <= 16)
    err = launch<16>(b, rp, bc, xx, o, n_block_rows, n_rows, n_cols, width,
                     s);
  else
    err = launch<32>(b, rp, bc, xx, o, n_block_rows, n_rows, n_cols, width,
                     s);
  return static_cast<int>(err);
}
