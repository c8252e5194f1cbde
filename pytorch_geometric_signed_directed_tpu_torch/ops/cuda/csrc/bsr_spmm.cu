// Block-sparse-row SpMM over 128x128 dense float32 blocks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K5: pytorch_geometric_signed_directed_tpu/ops/
// pallas/bsr_spmm.py `_kernel` and its launcher `_bsr_matmul`.  The TPU
// grid walks (feature tile, nonzero block) in order and keeps the output
// tile of a block row resident in VMEM while consecutive blocks of that
// row add into it, at Precision.HIGHEST.  Here the sum is f32 FMAs in
// registers (no TF32, for parity with HIGHEST), in two launches:
//
//   bsr_spmm_kernel    one CTA per (piece, feature tile): a piece is a run
//                      of at most `chunk` consecutive blocks of one block
//                      row (bsr_spmm.py, plan_block_split); the CTA sums
//                      block i's 128x128 values times the matching 128-row
//                      tile of x over its blocks and writes its 128 x FT
//                      partial to scratch;
//   bsr_reduce_kernel  out[r, f] = the partials of r's block row, added in
//                      piece order (0 for a block row without blocks).
//
//   pgsd_bsr_spmm  out[r, f] = sum_{blocks i of block row r/128}
//                              sum_c blocks[i, r%128, c] *
//                                    x[block_cols[i]*128 + c, f]
//
// What bounds it: bytes at the bench's widths (2 and 32).  Each block is
// 64 KB read once for each feature tile, against 2*128*128*F flops; below
// F of about 80 the 3.35 TB/s memory rate, not the 67 TFLOP/s float32
// rate, sets the least time.  What held the first design back: one CTA per
// block row left half the SMs idle on the 64-block-row graph, and each
// block's load waited on the FMAs over the one before.  The design against
// it: the pieces cut every block row so that the grid fills the card about
// four times over, whatever the block rows' lengths; each CTA streams its
// blocks through three shared-memory stages (two at the 32-lane tile, where
// three do not fit) with cp.async, so the next blocks load while the FMAs
// run over this one, and reads each block's column an iteration early so
// that no copy waits on it; from the 16-lane tile on, each thread keeps 4
// lanes of 4 rows in registers (8 shared loads for 64 FMAs, where one lane
// of 16 rows took 20); the partials are added in a fixed order by the
// second launch, so every call gives the same bits (no atomics).  Block
// rows in shared memory are padded to 132 floats so that the 16-byte reads
// of threads that own different rows fall in different banks.  The
// shared-memory opt-in runs once per device.  wgmma in TF32x3 is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;           // block side
constexpr int kThreads = 256;
constexpr int kStride = kB + 4;   // padded shared-memory row of a block
constexpr int kMaxDevices = 64;

// One stage: a padded block, then the x tile [kB][FT].
template <int FT>
__host__ __device__ constexpr int stage_floats() {
  return kB * kStride + kB * FT;
}

// Stages in flight: three where they fit the 227 KB a CTA may use, two for
// the widest tile.
template <int FT>
__host__ __device__ constexpr int stages() {
  return FT >= 32 ? 2 : 3;
}

template <int FT>
constexpr size_t smem_bytes() {
  return sizeof(float) * stages<FT>() * (size_t)stage_floats<FT>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES bytes (4, 8 or 16), or as many zero bytes when !ok (a source size
// of 0 reads nothing)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok = true) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of block i (block column bc) and its x tile into
// `stage`, as one group.  xvec: x rows are 16-byte aligned at f0 and the
// tile lies inside the width, so x moves 16 bytes a copy.
template <int FT>
__device__ __forceinline__ void load_stage(
    float* stage, const float* __restrict__ blocks,
    const float* __restrict__ x, int i, int bc, int f0, int n_cols,
    int width, bool xvec) {
  const int t = threadIdx.x;
  const float* src = blocks + (int64_t)i * kB * kB;
#pragma unroll 4
  for (int v = t; v < kB * kB / 4; v += kThreads)
    cp_async<16>(stage + (v / (kB / 4)) * kStride + (v % (kB / 4)) * 4,
                 src + 4 * v);
  float* xs = stage + kB * kStride;
  if constexpr (FT >= 4) {
    if (xvec) {
      for (int v = t; v < kB * FT / 4; v += kThreads) {
        const int gc = bc * kB + v / (FT / 4);
        const bool ok = gc < n_cols;
        cp_async<16>(
            xs + 4 * v,
            ok ? x + (int64_t)gc * width + f0 + 4 * (v % (FT / 4)) : x, ok);
      }
      cp_async_commit();
      return;
    }
  }
  for (int v = t; v < kB * FT; v += kThreads) {
    const int gc = bc * kB + v / FT;
    const int gf = f0 + v % FT;
    const bool ok = gc < n_cols && gf < width;
    cp_async<4>(xs + v, ok ? x + (int64_t)gc * width + gf : x, ok);
  }
  cp_async_commit();
}

// The FMAs of one CTA over its staged blocks.  Thread t owns kLanes lanes
// (lane group t % kLG) of kRows rows (t / kLG + i * kRG).  From a 16-lane
// tile on, a thread takes 4 lanes of 4 (or 2) rows and reads both tiles as
// float4, 8 shared loads for 64 FMAs; narrower tiles take 1 lane of
// kB / (kThreads / FT) rows.  Each output sums over c in order, 4 FMAs a
// step, the same for either mapping.
template <int FT>
struct Fma {
  static constexpr int kLanes = FT >= 16 ? 4 : 1;
  static constexpr int kLG = FT / kLanes;     // lane groups
  static constexpr int kRG = kThreads / kLG;  // row groups
  static constexpr int kRows = kB / kRG;
  float acc[kRows][kLanes];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) acc[i][l] = 0.f;
  }

  __device__ __forceinline__ void block(const float* bs, const float* xs) {
    const int lg = threadIdx.x % kLG;
    const int rg = threadIdx.x / kLG;
#pragma unroll 4
    for (int c = 0; c < kB; c += 4) {
      float xv[4][kLanes];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kLanes == 4) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (c + j) * FT + 4 * lg);
          xv[j][0] = v.x;
          xv[j][1] = v.y;
          xv[j][2] = v.z;
          xv[j][3] = v.w;
        } else {
          xv[j][0] = xs[(c + j) * FT + lg];
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(
            bs + (rg + i * kRG) * kStride + c);
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          float a = acc[i][l];
          a = fmaf(b.x, xv[0][l], a);
          a = fmaf(b.y, xv[1][l], a);
          a = fmaf(b.z, xv[2][l], a);
          a = fmaf(b.w, xv[3][l], a);
          acc[i][l] = a;
        }
      }
    }
  }

  // partial[piece, row, f0 + lane] for the lanes below the width
  __device__ __forceinline__ void store(float* partial, int piece, int f0,
                                        int width) const {
    const int lg = threadIdx.x % kLG;
    const int rg = threadIdx.x / kLG;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const int gf = f0 + lg * kLanes + l;
        if (gf < width)
          partial[((int64_t)piece * kB + rg + i * kRG) * width + gf] =
              acc[i][l];
      }
  }
};

// Blocks stream through stages<FT>() shared-memory stages: block i + S - 1
// is copied while the FMAs run over block i, and each block's column is
// read one iteration before its copies start.  Every iteration commits one
// copy group (an empty one past the piece's end), so waiting until S - 1
// groups are pending always means block i has landed.
template <int FT>
__global__ void __launch_bounds__(kThreads) bsr_spmm_kernel(
    const float* __restrict__ blocks, const int* __restrict__ block_cols,
    const int2* __restrict__ pieces, const float* __restrict__ x,
    float* __restrict__ partial, int n_cols, int width, int xvec_ok) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int S = stages<FT>();
  const int2 pc = pieces[blockIdx.x];
  const int f0 = blockIdx.y * FT;
  const bool xvec = xvec_ok && f0 + FT <= width;
  Fma<FT> fma;
  fma.zero();

#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (pc.x + k < pc.y)
      load_stage<FT>(smem + k * stage_floats<FT>(), blocks, x, pc.x + k,
                     block_cols[pc.x + k], f0, n_cols, width, xvec);
    else
      cp_async_commit();
  }
  int bc_ahead = pc.x + S - 1 < pc.y ? block_cols[pc.x + S - 1] : 0;
  for (int i = pc.x; i < pc.y; ++i) {
    const int k = i - pc.x;
    const int next = i + S - 1;
    if (next < pc.y) {
      // that stage was last read before the previous __syncthreads
      const int bc = bc_ahead;
      bc_ahead = next + 1 < pc.y ? block_cols[next + 1] : 0;
      load_stage<FT>(smem + ((k + S - 1) % S) * stage_floats<FT>(), blocks,
                     x, next, bc, f0, n_cols, width, xvec);
    } else {
      cp_async_commit();
    }
    cp_async_wait<S - 1>();  // block i has landed
    __syncthreads();
    const float* bs = smem + (k % S) * stage_floats<FT>();
    fma.block(bs, bs + kB * kStride);
    __syncthreads();  // a later iteration's copies overwrite this stage
  }
  fma.store(partial, blockIdx.x, f0, width);
}

// out[r, f] = sum over the pieces of block row r / kB, in piece order.
__global__ void __launch_bounds__(kThreads) bsr_reduce_kernel(
    const float* __restrict__ partial, const int* __restrict__ ptr,
    float* __restrict__ out, int n_rows, int width) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n_rows * width) return;
  const int r = (int)(i / width);
  const int f = (int)(i % width);
  const int br = r / kB;
  float s = 0.f;
  for (int p = ptr[br]; p < ptr[br + 1]; ++p)
    s += partial[((int64_t)p * kB + r % kB) * width + f];
  out[i] = s;
}

// Above 48 KB of shared memory a kernel must opt in, once per device.  Two
// host threads may both opt in the first time; the call is idempotent.
template <int FT>
cudaError_t opt_in() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(bsr_spmm_kernel<FT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<FT>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int FT>
cudaError_t launch(const float* blocks, const int* bcols, const int2* pieces,
                   const float* x, float* partial, int n_pieces, int n_cols,
                   int width, cudaStream_t s) {
  if (n_pieces == 0) return cudaSuccess;  // every block row is empty
  const cudaError_t err = opt_in<FT>();
  if (err != cudaSuccess) return err;
  const dim3 grid(n_pieces, (width + FT - 1) / FT);
  const int xvec =
      width % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bsr_spmm_kernel<FT><<<grid, kThreads, smem_bytes<FT>(), s>>>(
      blocks, bcols, pieces, x, partial, n_cols, width, xvec);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  (pieces, ptr) is bsr_spmm.py's plan of the block
// rows (n_pieces pieces; ptr has n_block_rows + 1 entries); `partial` is
// scratch of n_pieces * 128 * width floats.  Launches both kernels and
// returns cudaGetLastError().
extern "C" int pgsd_bsr_spmm(const void* blocks, const void* block_cols,
                             const void* x, void* out, void* partial,
                             const void* pieces, const void* ptr,
                             int n_pieces, int n_rows, int n_cols, int width,
                             void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(blocks);
  const int* bc = static_cast<const int*>(block_cols);
  const int2* pc = static_cast<const int2*>(pieces);
  const float* xx = static_cast<const float*>(x);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (width <= 2)
    err = launch<2>(b, bc, pc, xx, part, n_pieces, n_cols, width, s);
  else if (width <= 4)
    err = launch<4>(b, bc, pc, xx, part, n_pieces, n_cols, width, s);
  else if (width <= 8)
    err = launch<8>(b, bc, pc, xx, part, n_pieces, n_cols, width, s);
  else if (width <= 16)
    err = launch<16>(b, bc, pc, xx, part, n_pieces, n_cols, width, s);
  else
    err = launch<32>(b, bc, pc, xx, part, n_pieces, n_cols, width, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)n_rows * width;
  bsr_reduce_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(part, static_cast<const int*>(ptr),
                              static_cast<float*>(out), n_rows, width);
  return static_cast<int>(cudaGetLastError());
}
