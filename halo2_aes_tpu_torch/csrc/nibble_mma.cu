// K5: nibble products on the int8 tensor cores.
//
// Replaces the int8 products of halo2_aes_tpu/ops/mxu_field.py: _dot_i8
// (:174, a bf16 dot_general with f32 sums) and the raw int8 dot_general of
// BatchedDftMatmul (:311).  Both are XLA products on the TPU's matrix unit,
// not Pallas kernels.
//
//   out[g, r, b*olb + j] = sum_{s<4} conv[g, r, b*blk + 4j + s] << 4s
//   conv[g, r, :]        = nibbles(x[g, r, :L]) @ B[g]
//
// x: int32 (G, rows, L) 16-bit limbs; B: int8 (G, 4L, M) with entries in
// 0..15; M = nblk * blk; olb = ceil(blk / 4) limbs a column block; out:
// int32 (G, rows, nblk * olb).  Each product column sums at most 4L
// products of <= 225, and a limb folds four columns with weights up to
// 4096, so every output is <= 225 * 4L * 4369 < 2^31 for 4L <= 2184 (the
// wrapper's MAX_NIBBLES); the s32 accumulators stay far below that.
//
// Design.  A block of 8 warps owns 128 rows and 128 "padded" columns:
// each column block of blk product columns is laid out as olb limbs of 4
// columns (127 -> 128, 68 -> 68, 131 -> 132), padded columns reading B as
// zero, so a limb never straddles two blocks or two tiles.  Each warp
// holds 16 rows x 128 columns in 16 m16n8k32 accumulators.  The A
// fragments are made in registers from the limbs as they are loaded: a
// 16-bit limb is exactly the 4 int8 nibbles of one fragment register, so
// no int8 copy of x exists anywhere; a stage's limbs are loaded before its
// B bytes so that the two latencies overlap.  B is staged through shared
// memory 64 nibbles (two k-steps) at a time, transposed to column-major
// with an 80-byte column stride so the fragment reads hit 32 distinct
// banks.  K and M are padded to the tile inside the kernel.  The epilogue folds
// neighbouring column pairs with one shuffle, stages the limbs in shared
// memory and writes whole rows.
//
// What bounds it on an H100: bytes in and out (x, B, out) over 3.35 TB/s,
// or the band's non-zero multiply-adds over the int8 tensor cores' dense
// 989.5e12/s.  This first kernel multiplies the zero half of each band too
// and loads B a byte at a time without a copy pipeline; skipping zero
// tiles, wgmma and TMA are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;   // rows a block
constexpr int BN = 128;          // padded product columns a block (32 limbs)
constexpr int NT = BN / 8;       // n-tiles a warp
constexpr int BK = 64;           // nibbles a shared-memory stage
constexpr int SW = 20;           // 32-bit words a staged column (80 bytes)
constexpr int OS = BN / 4 + 1;   // words a staged output row

// a 16-bit limb -> its four nibbles, one a byte, lowest first
__device__ __forceinline__ uint32_t nibble_word(uint32_t v) {
  uint32_t t = (v & 0xFFu) | ((v & 0xFF00u) << 8);
  return (t & 0x000F000Fu) | ((t & 0x00F000F0u) << 4);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_limb(const int32_t* __restrict__ xg,
                                              int64_t row, int64_t rows,
                                              int limb, int L) {
  return (row < rows && limb < L)
             ? nibble_word((uint32_t)__ldg(xg + row * L + limb))
             : 0u;
}

__global__ void __launch_bounds__(THREADS, 2)
nibble_mma_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                  const int8_t* __restrict__ B, int64_t rows, int L, int M,
                  int blk) {
  __shared__ uint32_t bs[BN * SW];
  __shared__ uint32_t os[BM * OS];
  const int olb = (blk + 3) / 4;
  const int nlimbs = (M / blk) * olb;
  const int K = 4 * L;
  const int g = blockIdx.z;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int limb0 = blockIdx.y * (BN / 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int32_t* xg = x + (int64_t)g * rows * L;
  const int8_t* Bg = B + (int64_t)g * K * M;
  const int ntc = min(NT, (nlimbs - limb0 + 1) / 2);   // n-tiles with limbs

  // the B column this thread stages (-1: a padded column, zero)
  const int fc = threadIdx.x & (BN - 1);
  int fcol = -1;
  {
    const int limb = limb0 + fc / 4;
    if (limb < nlimbs) {
      const int b = limb / olb;
      const int cc = 4 * (limb - b * olb) + (fc & 3);
      if (cc < blk) fcol = b * blk + cc;
    }
  }

  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
  const int64_t ra = row0 + warp * 16 + gid;
  const int64_t rb = ra + 8;

  const int8_t* bcol = Bg + (fcol < 0 ? 0 : fcol);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // this stage's limbs of x, loaded first so that their latency
    // overlaps the B loads below
    uint32_t xa[BK / 32][4];
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      const int l0 = (k0 + 32 * s) / 4 + tig, l1 = l0 + 4;
      xa[s][0] = load_limb(xg, ra, rows, l0, L);
      xa[s][1] = load_limb(xg, rb, rows, l0, L);
      xa[s][2] = load_limb(xg, ra, rows, l1, L);
      xa[s][3] = load_limb(xg, rb, rows, l1, L);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 4 * BN / THREADS; ++j) {
      const int w = (threadIdx.x / BN) + j * (THREADS / BN);
      uint32_t word = 0;
      if (fcol >= 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = k0 + 4 * w + r;
          if (k < K) word |= (uint32_t)(uint8_t)__ldg(bcol + (int64_t)k * M) << (8 * r);
        }
      }
      bs[fc * SW + w] = word;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      if (k0 + 32 * s >= K) break;
      const uint32_t (&a)[4] = xa[s];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < ntc) {
          const uint32_t* col = bs + (nt * 8 + gid) * SW + s * 8 + tig;
          mma_s8(acc[nt], a, col[0], col[4]);
        }
      }
    }
  }

  // fold: this thread holds columns 2*tig, 2*tig+1 of each n-tile; a limb
  // is the four columns of two neighbouring threads
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint32_t lo = (uint32_t)acc[nt][0] + ((uint32_t)acc[nt][1] << 4);
    const uint32_t hi = (uint32_t)acc[nt][2] + ((uint32_t)acc[nt][3] << 4);
    const uint32_t lo_up = __shfl_down_sync(0xffffffffu, lo, 1);
    const uint32_t hi_up = __shfl_down_sync(0xffffffffu, hi, 1);
    if ((tig & 1) == 0) {
      const int lc = nt * 2 + (tig >> 1);
      os[(warp * 16 + gid) * OS + lc] = lo + (lo_up << 8);
      os[(warp * 16 + gid + 8) * OS + lc] = hi + (hi_up << 8);
    }
  }
  __syncthreads();
  const int nl = min(BN / 4, nlimbs - limb0);
  int32_t* og = out + (int64_t)g * rows * nlimbs;
  for (int i = threadIdx.x; i < BM * nl; i += THREADS) {
    const int r = i / nl, l = i - r * nl;
    const int64_t row = row0 + r;
    if (row < rows) og[row * nlimbs + limb0 + l] = (int32_t)os[r * OS + l];
  }
}

}  // namespace

extern "C" int nibble_mma_launch(void* out, const void* x, const void* b,
                                 int64_t groups, int64_t rows, int limbs,
                                 int m, int blk, void* stream) {
  const int olb = (blk + 3) / 4;
  const int nlimbs = (m / blk) * olb;
  dim3 grid((unsigned)((rows + BM - 1) / BM),
            (unsigned)((nlimbs + BN / 4 - 1) / (BN / 4)), (unsigned)groups);
  nibble_mma_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const int8_t*)b, rows, limbs, m, blk);
  return (int)cudaGetLastError();
}
