// Block-sparse-row SpMM over 128x128 dense float32 blocks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K5: pytorch_geometric_signed_directed_tpu/ops/
// pallas/bsr_spmm.py `_kernel` and its launcher `_bsr_matmul`.  The TPU
// grid walks (feature tile, nonzero block) in order and keeps the output
// tile of a block row resident in VMEM while consecutive blocks of that
// row add into it, at Precision.HIGHEST.  Here, in two launches:
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
// What bounds it: bytes.  Each block is 64 KB read once a feature tile
// against 2*128*128*FT flops, 16 flop/byte at FT = 32, below the 20 at
// which the CUDA cores' 67 TFLOP/s float32 rate meets the 3.35 TB/s memory
// rate.  Summed in float32 FMAs, as an earlier design did, W = 32 needs
// about 80% of that FMA peak to keep up with memory (that design reached
// 31%, its 32-lane tile fitting two 82 KB stages, one CTA an SM).  The
// design against it:
//
// * Products on the tensor cores in 3xTF32: each operand v is split into
//   hi = tf32(v) and lo = tf32(v - hi), rounded to nearest with ties away
//   from zero (cvt.rna.tf32.f32's rounding, in two integer operations),
//   and every 8-deep K step adds a_lo*x_hi, a_hi*x_lo and a_hi*x_hi in
//   that order into float32 accumulators in registers.  The dropped
//   a_lo*x_lo and the rounding of the lo parts leave each product within
//   about 3 * 2^-22 of |a*x| (one TF32 product alone: 2^-11, which misses
//   the HIGHEST contract's 1e-5); the sums stay float32.  The products are
//   wgmma m64nFTk8: each of two warpgroups takes 64 rows of the block, its
//   A fragments (16 rows a warp) split in registers, and B, the slab's x
//   split once by all eight warps into hi and lo core matrices in shared
//   memory.  A ragged last feature tile is masked at the store, so one
//   path serves every width.
// * A ring of K-slabs: a block moves as four slabs of 32 columns (16 KB)
//   with the slab's 32 x rows, 3 to 6 stages a CTA and two CTAs an SM.  A
//   slab comes by one 2D bulk tensor copy (TMA) with the 128-byte swizzle,
//   so the A fragment loads (rows g, columns t) fall in 32 banks; x rows
//   are padded to a stride of 8 or 24 floats mod 32 for the split's loads.
// * A producer warp: its lane 0 issues the slab's tensor copy, its 32
//   lanes the x rows by cp.async (zero-filled past num_cols; 16 bytes a
//   copy where x is aligned and the tile inside the width), all tracked by
//   the stage's full mbarrier (expect_tx for the tensor copy,
//   cp.async.mbarrier.arrive.noinc for the lanes' copies).  The eight
//   consumer warps issue no copies; each frees a stage through its empty
//   mbarrier.  Block columns are read a block ahead.
// * The pieces fill the card in one wave whatever the block rows' lengths,
//   and the partials are added in a fixed order by the second launch:
//   every call gives the same bits (no atomics).

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached
                   // through the runtime's entry point, not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;                  // block side
constexpr int kSlab = 32;                // K columns of a block per slab
constexpr int kSlabsPerBlock = kB / kSlab;
constexpr int kWarps = 8;                // consumer warps, 16 rows each
constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;
constexpr uint32_t kSlabBytes = kB * kSlab * sizeof(float);
// dynamic shared memory a CTA may take so that two fit an SM (228 KB, 1 KB
// of it reserved a CTA)
constexpr int kCtaSmem = 113 * 1024;

template <int FT>
struct Layout {
  // x rows padded to 8 or 24 floats mod 32: lane (g, t) of the split reads
  // row t, lane g, and the four rows land 8 banks apart
  static constexpr int kXStride = FT % 32 == 8 ? FT : FT + 8;
  static constexpr int kABytes = kB * kSlab * sizeof(float);
  static constexpr int kXBytes = kSlab * kXStride * sizeof(float);
  static constexpr int kStageBytes = kABytes + kXBytes;
  // a slab's x split into hi and lo (32 FT words each), two buffers
  static constexpr int kSplitWords = 2 * kSlab * FT;
  static constexpr int kSplitBytes = 2 * kSplitWords * sizeof(uint32_t);
  // 1 KB of slack aligns the swizzled slabs; the barriers take 8 bytes
  // each, two a stage
  static constexpr int kStagesFit =
      (kCtaSmem - 1024 - 2 * 8 * 8 - kSplitBytes) / kStageBytes;
  static constexpr int kStages = kStagesFit > 8 ? 8 : kStagesFit;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  kSplitBytes + 2 * 8 * kStages;
  static constexpr int kAcc = FT / 2;    // a thread's m64nFT accumulators
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- copies ------------------------------------------------------------------

// BYTES bytes (4 or 16), or as many zero bytes when !ok (a source size of 0
// reads nothing)
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

// the barrier's phase waits for this thread's earlier cp.async copies (one
// of the arrivals it was initialised with)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the box at (column c0, row c1) of the blocks viewed as [NB * 128, 128]
__device__ __forceinline__ void tensor_copy(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// slab value (row r, column c) in shared memory: the 128-byte swizzle puts
// 16-byte chunk c / 4 of row r at (c / 4) ^ (r % 8)
__device__ __forceinline__ float slab_at(const float* as, int r, int c) {
  return as[r * kSlab + ((((c >> 2) ^ r) & 7) << 2) + (c & 3)];
}

// --- 3xTF32 ------------------------------------------------------------------

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer operations where the instruction takes about
// five: half a unit of the 13 dropped bits is added to the magnitude, then
// they are cleared.  Infinities stay; so do NaNs, but for one whose payload
// fills the top mantissa bits, which becomes a signed zero.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d (64 x N, the warpgroup's) += a (64 x 8 TF32 from registers: this warp's
// 16 rows, element i of lane (g, t) at row g + 8 (i % 2), column t + 4 (i /
// 2)) * b (8 x N TF32, K-major core matrices in shared memory).  Element i
// of n-tile n of d sits at d[4 n + i]: row g + 8 (i / 2), lane 8 n + 2 t +
// i % 2.
__device__ __forceinline__ void wgmma(float (&d)[4], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// B's descriptor (no swizzle): core matrices of 8 lanes by 4 K columns
// (128 bytes), the next along K 128 bytes on (LBO), along N 1024 on (SBO)
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32);
}

// --- the kernel --------------------------------------------------------------

// The producer warp: slab j (block pc.x + j / 4, columns 32 (j % 4) on)
// into stage j % S, once the consumers have freed it.
template <int FT>
__device__ __forceinline__ void produce(
    const CUtensorMap* map, const int* __restrict__ block_cols, int2 pc,
    const float* __restrict__ x, float* a_slabs, float* x_slabs,
    uint64_t* full, uint64_t* empty, int n_cols, int width, int f0,
    bool xvec) {
  using L = Layout<FT>;
  const int lane = threadIdx.x % 32;
  const int n_slabs = (pc.y - pc.x) * kSlabsPerBlock;
  int bc = 0;
  int bc_next = block_cols[pc.x];
  for (int j = 0; j < n_slabs; ++j) {
    const int s = j % L::kStages;
    const int blk = pc.x + j / kSlabsPerBlock;
    const int kq = j % kSlabsPerBlock;
    if (kq == 0) {
      bc = bc_next;
      if (blk + 1 < pc.y) bc_next = block_cols[blk + 1];
    }
    if (j >= L::kStages)
      mbar_wait(smem_addr(&empty[s]), (j / L::kStages - 1) & 1);
    const uint32_t bar = smem_addr(&full[s]);
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, kSlabBytes);
      tensor_copy(smem_addr(a_slabs + (size_t)s * L::kABytes / 4), map,
                  kq * kSlab, blk * kB, bar);
    }
    // the slab's x rows: gc0 .. gc0 + 31, lanes f0 .. f0 + FT - 1
    const uint32_t xs = smem_addr(x_slabs + (size_t)s * L::kXBytes / 4);
    const int gc0 = bc * kB + kq * kSlab;
    if (xvec) {
      for (int v = lane; v < kSlab * FT / 4; v += 32) {
        const int r = v / (FT / 4), c = 4 * (v % (FT / 4));
        const bool ok = gc0 + r < n_cols;
        cp_async<16>(xs + (r * L::kXStride + c) * 4,
                     ok ? x + (int64_t)(gc0 + r) * width + f0 + c : x, ok);
      }
    } else {
      // lanes past the width are left as they are: they reach only output
      // lanes that are not stored
      for (int v = lane; v < kSlab * FT; v += 32) {
        const int r = v / FT, c = v % FT;
        if (f0 + c >= width) continue;
        const bool ok = gc0 + r < n_cols;
        cp_async<4>(xs + (r * L::kXStride + c) * 4,
                    ok ? x + (int64_t)(gc0 + r) * width + f0 + c : x, ok);
      }
    }
    cp_async_arrive(bar);
  }
  cp_async_wait_all();
}

template <int FT>
__global__ void __launch_bounds__(kThreads, 2) bsr_spmm_kernel(
    const __grid_constant__ CUtensorMap map,
    const int* __restrict__ block_cols, const int2* __restrict__ pieces,
    const float* __restrict__ x, float* __restrict__ partial, int n_cols,
    int width, int xvec_ok) {
  using L = Layout<FT>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes from a 1024-byte aligned base
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* a_slabs = reinterpret_cast<float*>(base);
  float* x_slabs =
      reinterpret_cast<float*>(base + (size_t)L::kStages * L::kABytes);
  uint32_t* split_bufs = reinterpret_cast<uint32_t*>(
      base + (size_t)L::kStages * L::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + (size_t)L::kStages * L::kStageBytes + L::kSplitBytes);
  uint64_t* empty = full + L::kStages;
  const int2 pc = pieces[blockIdx.x];
  const int f0 = blockIdx.y * FT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      // the tensor copy's expect_tx and the 32 producer lanes' copies
      mbar_init(smem_addr(&full[s]), 33);
      mbar_init(smem_addr(&empty[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    produce<FT>(&map, block_cols, pc, x, a_slabs, x_slabs, full, empty,
                n_cols, width, f0, xvec_ok && f0 + FT <= width);
    return;
  }

  // consumer warp: rows m0 .. m0 + 15 of the block (warpgroup warp / 4
  // takes rows 64 (warp / 4) on), every lane of the feature tile
  const int m0 = warp * 16;
  const int g = lane >> 2, t = lane & 3;
  float acc[L::kAcc];
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i) acc[i] = 0.f;

  const int n_slabs = (pc.y - pc.x) * kSlabsPerBlock;
  for (int j = 0; j < n_slabs; ++j) {
    const int s = j % L::kStages;
    mbar_wait(smem_addr(&full[s]), (j / L::kStages) & 1);
    const float* as = a_slabs + (size_t)s * L::kABytes / 4;
    const float* xs = x_slabs + (size_t)s * L::kXBytes / 4;
    // the slab's x split once for all warps into core matrices (n / 8, k /
    // 4) = cm = 8 (n / 8) + k / 4: warp w takes cm = w, w + 8, ..., its
    // lane (g, t) the element (8 (n / 8) + g, 4 (k / 4) + t); hi, then lo
    // 32 FT words on
    uint32_t* sb = split_bufs + (j & 1) * L::kSplitWords;
#pragma unroll
    for (int cm = warp; cm < FT; cm += kWarps) {
      uint32_t hi, lo;
      split(xs[((cm % 8) * 4 + t) * L::kXStride + (cm / 8) * 8 + g], hi, lo);
      sb[cm * 32 + lane] = hi;
      sb[kSlab * FT + cm * 32 + lane] = lo;
    }
    // the tensor cores read the split through the async proxy; only the
    // consumer warps pass this barrier, and a buffer is written again two
    // slabs on, after every warp has passed it once more
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWarps) : "memory");

    uint32_t ahi[kSlab / 8][4], alo[kSlab / 8][4];
#pragma unroll
    for (int q = 0; q < kSlab / 8; ++q) {
      const int k = 8 * q;
      split(slab_at(as, m0 + g, k + t), ahi[q][0], alo[q][0]);
      split(slab_at(as, m0 + g + 8, k + t), ahi[q][1], alo[q][1]);
      split(slab_at(as, m0 + g, k + t + 4), ahi[q][2], alo[q][2]);
      split(slab_at(as, m0 + g + 8, k + t + 4), ahi[q][3], alo[q][3]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < kSlab / 8; ++q) {
      // K columns 8 q .. 8 q + 7: core matrices 2 q and 2 q + 1
      const uint64_t dhi = b_desc(sb + 2 * q * 32);
      const uint64_t dlo = b_desc(sb + kSlab * FT + 2 * q * 32);
      wgmma(acc, alo[q], dhi);
      wgmma(acc, ahi[q], dlo);
      wgmma(acc, ahi[q], dhi);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the A registers and this stage are free once the products are done
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < L::kAcc; ++i)
      asm volatile("" : "+f"(acc[i])::"memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
  }

  // partial[piece, row, f0 + lane] for the lanes below the width
  float* p = partial + ((int64_t)blockIdx.x * kB + m0 + g) * width;
#pragma unroll
  for (int n = 0; n < FT / 8; ++n) {
    const int f = f0 + n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gf = f + (i & 1);
      if (gf < width) p[(i >> 1) * 8 * width + gf] = acc[4 * n + i];
    }
  }
}

// out[r, f] = sum over the pieces of block row r / kB, in piece order.
__global__ void __launch_bounds__(kReduceThreads) bsr_reduce_kernel(
    const float* __restrict__ partial, const int* __restrict__ ptr,
    float* __restrict__ out, int n_rows, int width) {
  const int64_t i = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (int64_t)n_rows * width) return;
  const int r = (int)(i / width);
  const int f = (int)(i % width);
  const int br = r / kB;
  float s = 0.f;
  for (int p = ptr[br]; p < ptr[br + 1]; ++p)
    s += partial[((int64_t)p * kB + r % kB) * width + f];
  out[i] = s;
}

// The device's primary context is made current first: a host thread whose
// first runtime call this is (autograd's backward thread) has none yet,
// and the tensor map's encoding needs one.  Above 48 KB of shared memory a
// kernel must opt in, once per device; the carveout asks for the most
// shared memory so that two CTAs fit.  Two host threads may both opt in
// the first time; the calls are idempotent.
template <int FT>
cudaError_t opt_in() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(bsr_spmm_kernel<FT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<FT>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bsr_spmm_kernel<FT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (looked up once)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The blocks as a [n_blocks * 128, 128] float32 tensor, read in boxes of
// 128 rows by 32 columns with the 128-byte swizzle.
cudaError_t blocks_map(CUtensorMap* map, const float* blocks, int n_blocks) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {kB, (cuuint64_t)n_blocks * kB};
  const cuuint64_t strides[1] = {kB * sizeof(float)};
  const cuuint32_t box[2] = {kSlab, kB};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(blocks),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // the runtime's codes match the driver's where both name an error
  return static_cast<cudaError_t>(r);
}

template <int FT>
cudaError_t launch(const float* blocks, const int* bcols, const int2* pieces,
                   const float* x, float* partial, int n_pieces, int n_blocks,
                   int n_cols, int width, cudaStream_t s) {
  if (n_pieces == 0) return cudaSuccess;  // every block row is empty
  cudaError_t err = opt_in<FT>();
  if (err != cudaSuccess) return err;
  CUtensorMap map = {};
  err = blocks_map(&map, blocks, n_blocks);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_pieces, (width + FT - 1) / FT);
  const int xvec =
      width % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bsr_spmm_kernel<FT><<<grid, kThreads, Layout<FT>::kSmem, s>>>(
      map, bcols, pieces, x, partial, n_cols, width, xvec);
  return cudaGetLastError();
}

template <int FT>
void config(int* tile, int* stages, int* smem) {
  *tile = FT;
  *stages = Layout<FT>::kStages;
  *smem = (int)Layout<FT>::kSmem;
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream`
// is a cudaStream_t.  `blocks` holds n_blocks blocks and is 16-byte
// aligned; (pieces, ptr) is bsr_spmm.py's plan of the block rows
// (n_pieces pieces; ptr has n_block_rows + 1 entries); `partial` is
// scratch of n_pieces * 128 * width floats.  Launches both kernels and
// returns cudaGetLastError() (cudaErrorNotSupported where the driver has
// no cuTensorMapEncodeTiled).
extern "C" int pgsd_bsr_spmm(const void* blocks, const void* block_cols,
                             const void* x, void* out, void* partial,
                             const void* pieces, const void* ptr,
                             int n_pieces, int n_blocks, int n_rows,
                             int n_cols, int width, void* stream) {
  if (n_rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(blocks);
  const int* bc = static_cast<const int*>(block_cols);
  const int2* pc = static_cast<const int2*>(pieces);
  const float* xx = static_cast<const float*>(x);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (width <= 8)
    err = launch<8>(b, bc, pc, xx, part, n_pieces, n_blocks, n_cols, width, s);
  else if (width <= 16)
    err = launch<16>(b, bc, pc, xx, part, n_pieces, n_blocks, n_cols, width,
                     s);
  else if (width <= 32)
    err = launch<32>(b, bc, pc, xx, part, n_pieces, n_blocks, n_cols, width,
                     s);
  else
    err = launch<64>(b, bc, pc, xx, part, n_pieces, n_blocks, n_cols, width,
                     s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)n_rows * width;
  bsr_reduce_kernel<<<(unsigned)((total + kReduceThreads - 1) /
                                 kReduceThreads),
                      kReduceThreads, 0, s>>>(part, static_cast<const int*>(ptr),
                                              static_cast<float*>(out), n_rows,
                                              width);
  return static_cast<int>(cudaGetLastError());
}

// The feature tile that `width` takes, its ring's stages and the dynamic
// shared memory of a CTA, for reports.
extern "C" void pgsd_bsr_config(int width, int* tile, int* stages,
                                int* smem) {
  if (width <= 8)
    config<8>(tile, stages, smem);
  else if (width <= 16)
    config<16>(tile, stages, smem);
  else if (width <= 32)
    config<32>(tile, stages, smem);
  else
    config<64>(tile, stages, smem);
}
