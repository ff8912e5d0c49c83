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
// and, with width > 0, each column block's olb limbs plus an addend row
// carried into width canonical 16-bit limbs (out[g, r, b*width + j]), the
// carry out of the top limb dropped.  x: int32 (G, rows, L) 16-bit limbs.
// B arrives packed (ops/cuda_nibble.py, pack): per (group, column tile,
// k-step of 32 nibble rows) the tile's chunks of 4 n-tiles (32 columns)
// that hold a non-zero entry, each n-tile 256 bytes in the core-matrix
// order of wgmma's K-major B (two 8 x 16-byte core matrices, k 0-15 then
// 16-31, a row per column), a bit mask of the chunks kept and an offset
// table in n-tiles.  A column tile is tl limbs = 4 tl padded columns
// (127 -> 128, 131 -> 132), ntc <= NT n-tiles, and holds whole column
// blocks where one fits (tl = k olb), so a block's carry stays inside one
// block of threads.  Every folded limb is <= 225 * 4L * 4369 < 2^31 for
// 4L <= 2184 (the wrapper's MAX_NIBBLES); the addend is canonical 16-bit
// limbs (each entry is taken mod 2^16, as the plain version takes it) and
// the carry ripples in 64 bits, so nothing wraps.
//
// Design.  A block owns BM = 64 rows and one column tile: one consumer
// warpgroup (4 warps of 16 rows) and one producer warp.  The producer
// streams each stage (two k-steps) into a DEPTH-slot ring in dynamic
// shared memory: its lane 0 copies the stage's kept chunks of B (one
// contiguous run of the packed data) with one cp.async.bulk, and all its lanes
// copy the block's rows of x for the stage with cp.async (16 bytes where
// rows are 16-byte aligned, else 4), zero-filling rows and limbs past the
// end; both complete on the slot's "full" mbarrier (complete_tx and
// cp.async.mbarrier.arrive).  Before reusing a slot it waits on the slot's
// "empty" mbarrier, one arrival per consumer warp; no block-wide barrier in
// the main loop.  The consumers make the A fragments in registers from
// the staged limbs (a 16-bit limb is exactly the 4 int8 nibbles of one
// fragment register, so no int8 copy of x exists anywhere; a staged row
// is padded to XW words so that the reads hit 32 distinct banks) and issue
// one wgmma.mma_async m64nNk32 s8 (A from registers, B from the ring by
// descriptor, N = 32 or the tile's last 8-24 columns) a kept chunk: a
// stage with no kept chunk copies nothing and multiplies nothing.  The
// epilogue folds neighbouring column pairs with one shuffle, stages the
// limbs in shared memory (over the ring), carries each block per row when
// width > 0 (one thread a row and block), and writes whole rows.
//
// What bounds it on an H100: bytes in and out (x, B, out) over 3.35 TB/s,
// or the band's non-zero multiply-adds over the int8 tensor cores' dense
// 989.5e12/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CWARPS = 4;                    // consumer warps: one warpgroup
constexpr int BLOCKS_SM = 3;                 // resident blocks an SM (__launch_bounds__)
constexpr int THREADS = 32 * (CWARPS + 1);   // and one producer warp
constexpr int BM = 16 * CWARPS;              // rows a block
constexpr int NT = 17;                       // n-tiles a column tile at most
constexpr int CHUNK = 4;                     // n-tiles a chunk (one m64n32k32)
constexpr int NCH = (NT + CHUNK - 1) / CHUNK;
constexpr int KS_STAGE = 2;                  // k-steps a ring stage
constexpr int DEPTH = 4;                     // ring slots
constexpr int FRAG = 256;                    // bytes of one (k-step, n-tile) of B
constexpr int B_BYTES = KS_STAGE * NT * FRAG; // B of one stage at most
constexpr int XW = 8 * KS_STAGE + 4;         // words a staged row of x (16-byte pad)
constexpr int SLOT = B_BYTES + BM * XW * 4;  // bytes of one ring slot
static_assert(SLOT % 128 == 0 && B_BYTES % 16 == 0, "ring slots must stay aligned");
static_assert(NT == CHUNK * (NCH - 1) + 1, "the last chunk is one n-tile");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 (or 4) bytes global -> shared, of which the first src_bytes are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// the barrier's current phase also waits for this thread's cp.asyncs
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one stage of the block's rows of x into the ring: E limbs (4 or 16
// bytes) a copy, 8 KS_STAGE limbs a row from limb l0, rows and limbs past
// the end zero-filled; a warp's lanes take consecutive copies
template <int E>
__device__ __forceinline__ void copy_rows(uint32_t* sx, const int32_t* xg,
                                          int64_t row0, int64_t rows, int L,
                                          int l0, int lane) {
  constexpr int PER_ROW = 8 * KS_STAGE / E;
#pragma unroll 4
  for (int c = lane; c < BM * PER_ROW; c += 32) {
    const int r = c / PER_ROW, q = c % PER_ROW;
    const int64_t row = row0 + r;
    const int limb = l0 + E * q;
    const int n = row < rows ? max(0, min(E, L - limb)) : 0;
    const int32_t* src = n ? xg + row * L + limb : xg;
    if (E == 4) cp_async16(sx + r * XW + E * q, src, 4u * n);
    else cp_async4(sx + r * XW + E * q, src, 4u * n);
  }
}

// a 16-bit limb -> its four nibbles, one a byte, lowest first
__device__ __forceinline__ uint32_t nibble_word(uint32_t v) {
  return __byte_perm(v & 0x0F0Fu, (v >> 4) & 0x0F0Fu, 0x5140);
}

// the shared-memory descriptor of one chunk of B: K-major, no swizzle; the
// two core matrices of an n-tile 128 bytes apart (leading byte offset),
// n-tiles 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4)
         | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[j] (n-tile j of a chunk of W) += this warpgroup's 64 rows of A (the
// warp's 16 in a) times the chunk's 8 W columns: wgmma m64n(8W)k32
template <int W>
__device__ __forceinline__ void wgmma_chunk(int (&d)[CHUNK][4],
                                            const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_chunk<1>(int (&d)[CHUNK][4],
                                               const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_chunk<2>(int (&d)[CHUNK][4],
                                               const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_chunk<3>(int (&d)[CHUNK][4],
                                               const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_chunk<4>(int (&d)[CHUNK][4],
                                               const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__global__ void __launch_bounds__(THREADS, BLOCKS_SM)
nibble_mma_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                  const uint8_t* __restrict__ packed,
                  const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ masks,
                  const int32_t* __restrict__ addend, int64_t rows, int L,
                  int ksteps, int tiles, int tl, int olb, int nlimbs, int width,
                  int addend_limbs, int osw, int x16) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[DEPTH];
  __shared__ __align__(8) uint64_t empty[DEPTH];
  const int g = blockIdx.z, tile = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t e0 = ((int64_t)g * tiles + tile) * ksteps;  // first k-step entry
  const int nstages = (ksteps + KS_STAGE - 1) / KS_STAGE;
  const int ntc = (tl + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[NCH][CHUNK][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0;

  if (warp == CWARPS) {
    // producer: one stage of B and x a slot, DEPTH stages in flight
    const int32_t* xg = x + (int64_t)g * rows * L;
    for (int i = 0; i < nstages; ++i) {
      const int slot = i % DEPTH;
      if (i >= DEPTH) mbar_wait(&empty[slot], ((i / DEPTH) + 1) & 1);
      const int ks0 = i * KS_STAGE, nks = min(KS_STAGE, ksteps - ks0);
      const int32_t first = __ldg(offsets + e0 + ks0);
      const uint32_t bytes = (uint32_t)(__ldg(offsets + e0 + ks0 + nks) - first) * FRAG;
      uint8_t* sb = smem + slot * SLOT;
      if (bytes) {
        uint32_t* sx = reinterpret_cast<uint32_t*>(sb + B_BYTES);
        if (x16) copy_rows<4>(sx, xg, row0, rows, L, ks0 * 8, lane);
        else copy_rows<1>(sx, xg, row0, rows, L, ks0 * 8, lane);
        cp_async_arrive(&full[slot]);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[slot], bytes);
        if (bytes) bulk_copy(sb, packed + (int64_t)first * FRAG, bytes, &full[slot]);
      }
    }
  } else {
    const int gid = lane >> 2, tig = lane & 3;
    for (int i = 0; i < nstages; ++i) {
      const int slot = i % DEPTH;
      // each k-step's masks and the place of its first kept n-tile in the
      // slot; a kept chunk c sits after the 4 n-tiles of each kept chunk
      // below it (only a tile's last chunk is narrower)
      uint32_t m[KS_STAGE];
      int at[KS_STAGE];
      const int32_t first = __ldg(offsets + e0 + i * KS_STAGE);
#pragma unroll
      for (int h = 0; h < KS_STAGE; ++h) {
        const int ks = i * KS_STAGE + h;
        m[h] = ks < ksteps ? (uint32_t)__ldg(masks + e0 + ks) : 0u;
        at[h] = ks < ksteps ? __ldg(offsets + e0 + ks) - first : 0;
      }
      mbar_wait(&full[slot], (i / DEPTH) & 1);
      const uint8_t* sb = smem + slot * SLOT;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(sb + B_BYTES)
                          + (16 * warp + gid) * XW + tig;
      uint32_t a[KS_STAGE][4];
#pragma unroll
      for (int h = 0; h < KS_STAGE; ++h) {
        a[h][0] = nibble_word(p[8 * h]);
        a[h][1] = nibble_word(p[8 * XW + 8 * h]);
        a[h][2] = nibble_word(p[8 * h + 4]);
        a[h][3] = nibble_word(p[8 * XW + 8 * h + 4]);
      }
      bool any = false;
#pragma unroll
      for (int h = 0; h < KS_STAGE; ++h) any |= m[h] != 0u;
      if (any) {
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < KS_STAGE; ++h) {
#pragma unroll
          for (int c = 0; c < NCH - 1; ++c) {
            if ((m[h] >> c) & 1u) {
              const int pos = at[h] + CHUNK * __popc(m[h] & ((1u << c) - 1u));
              const uint64_t desc = b_desc(sb + pos * FRAG);
              const int w = ntc - CHUNK * c;
              if (w >= 4) wgmma_chunk<4>(acc[c], a[h], desc);
              else if (w == 3) wgmma_chunk<3>(acc[c], a[h], desc);
              else if (w == 2) wgmma_chunk<2>(acc[c], a[h], desc);
              else wgmma_chunk<1>(acc[c], a[h], desc);
            }
          }
          if ((m[h] >> (NCH - 1)) & 1u)
            wgmma_chunk<1>(acc[NCH - 1], a[h],
                           b_desc(sb + (at[h] + CHUNK * __popc(m[h] & ((1u << (NCH - 1)) - 1u)))
                                  * FRAG));
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();   // every slot consumed: the ring becomes the output stage

  // fold: this thread holds columns 2*tig, 2*tig+1 of each n-tile; a limb
  // is the four columns of two neighbouring threads
  uint32_t* os = reinterpret_cast<uint32_t*>(smem);
  if (warp < CWARPS) {
    const int gid = lane >> 2, tig = lane & 3;
    const int r = 16 * warp + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int* c = acc[nt / CHUNK][nt % CHUNK];
      const uint32_t lo = (uint32_t)c[0] + ((uint32_t)c[1] << 4);
      const uint32_t hi = (uint32_t)c[2] + ((uint32_t)c[3] << 4);
      const uint32_t lo_up = __shfl_down_sync(0xffffffffu, lo, 1);
      const uint32_t hi_up = __shfl_down_sync(0xffffffffu, hi, 1);
      const int lc = nt * 2 + (tig >> 1);
      if ((tig & 1) == 0 && lc < tl) {
        os[r * osw + lc] = lo + (lo_up << 8);
        os[(r + 8) * osw + lc] = hi + (hi_up << 8);
      }
    }
  }
  __syncthreads();

  int first = tile * tl, nl = min(tl, nlimbs - first), ol = nlimbs, src = 0;
  if (width > 0) {
    // carry: one thread a row and column block, 64-bit ripple, the limbs
    // written after the tile's folded limbs
    const int bpt = tl / olb, nb = nl / olb;
    for (int i = threadIdx.x; i < BM * nb; i += THREADS) {
      const int r = i / nb, b = i - r * nb;
      const int64_t row = row0 + r;
      if (row >= rows) continue;
      const uint32_t* v = os + r * osw + b * olb;
      uint32_t* w = os + r * osw + tl + b * width;
      const int32_t* ad = addend_limbs ? addend + (g * rows + row) * addend_limbs : nullptr;
      uint64_t c = 0;
      for (int j = 0; j < width; ++j) {
        c += j < olb ? v[j] : 0u;
        c += j < addend_limbs ? (uint32_t)__ldg(ad + j) & 0xFFFFu : 0u;
        w[j] = (uint32_t)c & 0xFFFFu;
        c >>= 16;
      }
    }
    __syncthreads();
    first = tile * bpt * width;
    nl = nb * width;
    ol = (nlimbs / olb) * width;
    src = tl;
  }
  int32_t* og = out + (int64_t)g * rows * ol;
  for (int i = threadIdx.x; i < BM * nl; i += THREADS) {
    const int r = i / nl, l = i - r * nl;
    const int64_t row = row0 + r;
    if (row < rows) og[row * ol + first + l] = (int32_t)os[r * osw + src + l];
  }
}

}  // namespace

extern "C" int nibble_mma_launch(void* out, const void* x, const void* packed,
                                 const void* offsets, const void* masks,
                                 const void* addend, int64_t groups,
                                 int64_t rows, int limbs, int ksteps, int tiles,
                                 int tl, int olb, int nlimbs, int width,
                                 int addend_limbs, void* stream) {
  if (tl < 1 || tl > 2 * NT || (width > 0 && tl % olb != 0)) return (int)cudaErrorInvalidValue;
  const int x16 = (limbs % 4 == 0 && (uintptr_t)x % 16 == 0) ? 1 : 0;
  const int bpt = width > 0 ? tl / olb : 0;
  const int osw = (tl + bpt * width) | 1;   // odd: rows fall on distinct banks
  const size_t smem = (size_t)(DEPTH * SLOT > BM * osw * 4 ? DEPTH * SLOT : BM * osw * 4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nibble_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)tiles, (unsigned)groups);
  nibble_mma_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const uint8_t*)packed,
      (const int32_t*)offsets, (const int32_t*)masks, (const int32_t*)addend,
      rows, limbs, ksteps, tiles, tl, olb, nlimbs, width, addend_limbs, osw, x16);
  return (int)cudaGetLastError();
}
