// K2: one fused pass of the batched four-step NTT over Fr.
//
// Replaces the Pallas kernel of halo2_aes_tpu/ops/pallas_ntt.py (_pass_fn,
// _make_kernel, _stages) together with what stood around it: a transform
// of n = 2^k points per poly is n / T interleaved rows of length
// T = 2^lt <= 4096 (row `col` of poly `pc` holds the elements
// pc*n + i*ncols + col, ncols = n / T).  Every row runs all lt radix-2
// decimation-in-frequency stages on chip: stage s maps
// (u, v) = (x[lo], x[lo + h]), h = T >> (s + 1), to (u + v, (u - v) * w^(j << s))
// with j = lo mod h, and leaves frequency brev(p) at position p.
//
// What bounds it on an H100: per pass every element is read and written
// once (128 B in the int32 limb layout) against lt/2 butterflies of one
// add, one sub and one CIOS product, so at lt >= 9 the integer
// multiplier and the memory system are within a factor of two of each
// other, and anything that walks the stack again around the pass costs as
// much as the pass.  The design:
//  - the pass reads its rows strided straight from the flat natural-order
//    stack, W adjacent columns a tile (runs of W * 64 contiguous bytes),
//    multiplies by an optional per-index row on load (the coset shift) and
//    by an optional table in its epilogue (the mid twiddle of the
//    sub-transform the pass belongs to, with n^-1 folded in on the first
//    pass, indexed by tile position; or one scalar), and stores to the
//    place the next pass reads.  With the output stride B = 2^sb (a power
//    of two dividing ncols), frequency j of column col lands at
//    pc*n + ((col / B) * T + j) * B + col % B: B = 1 is the first pass of a
//    composed transform (column-major rows for the next pass), 1 < B < ncols
//    a middle pass (each of the B interleaved sub-transforms keeps its own
//    stride), B = ncols the last pass and the single pass of k <= lt, which
//    write natural order.  The bit reversal is __brev in the store; no
//    transpose, gather or multiply runs outside;
//  - twiddles are one table of the T/2 powers of the pass's root, loaded
//    into shared memory once per block as 8 words an entry (16 KB at
//    T = 1024); blocks are persistent and walk tiles in poly-fastest
//    order, so the tiles in flight share one stretch of the mid table in L2;
//  - stages run in registers: a thread holds 8 elements (64 registers of
//    data), runs three stages on them and exchanges through shared memory
//    between rounds: 10 stages in 4 rounds.  Indices are skewed (e + e/8 for
//    data, e + e/32 for twiddles) so the rounds' strides 1, 8, 64, 512
//    spread over the banks.
// The last pass (B = ncols) stores each tile exactly where it was read, and
// only after all of it is in shared memory, so it may run in place
// (out == x): it overwrites the previous pass's output.  A first or middle
// pass scatters a tile over other tiles' rows and never runs in place.
// W is chosen from lt so that two blocks of 256 threads fit one SM (tile +
// twiddles <= 113 KB) and narrowed while the tiles would not fill the card
// (a count = 1 transform); rows of 4096 (lt = 12: 144 KB of tile and 66 KB
// of twiddles) fit one block an SM.  Measured on an H100 (PERF.md,
// scripts/torch_ntt_variants.py): two stages a round are within 1% on a
// 45 x 2^20 pass pair and 5% slower on one 2^20 transform, one-column
// tiles 22% slower; three stages and the widths above stay.  At ~4.3e12
// wide multiply-adds a second the passes run at the rate of the G1 adder:
// the multiplier binds.  ptxas (nvcc 12.8, sm_90a): 128 registers (the cap
// of two blocks an SM), 116 bytes of spill stores, 120 bytes of stack.
#include "field.cuh"

#define NTT_THREADS 256
#define NTT_R 3  // stages a round: a thread holds 2^NTT_R elements
#define NTT_MAX_LT 12  // rows of at most 2^12 points

__device__ __forceinline__ int data_skew(int e) { return e + (e >> NTT_R); }
__device__ __forceinline__ int tw_skew(int e) { return e + (e >> 5); }

// R stages (s0 .. s0 + R - 1) on every group of 2^R elements of the tile
template <int R>
__device__ __forceinline__ void ntt_round(uint32_t* sm, const uint32_t* tws,
                                          int S, int Tc, int TWS, int W, int lt,
                                          int s0, const Modulus& m) {
  const int hbits = lt - s0 - R;  // log2 of the element stride in a group
  const int gbits = lt - R;       // log2 of the groups per column
  const int total = W << gbits;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx >> gbits;
    const int g = idx & ((1 << gbits) - 1);
    const int j = g & ((1 << hbits) - 1);
    const int base = ((g >> hbits) << (hbits + R)) + j;
    uint32_t* col = sm + c * Tc;
    uint32_t x[1 << R][8];
#pragma unroll
    for (int e = 0; e < (1 << R); ++e) {
      const int pe = data_skew(base + (e << hbits));
#pragma unroll
      for (int w = 0; w < 8; ++w) x[e][w] = col[w * S + pe];
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int half = 1 << (R - 1 - t);
#pragma unroll
      for (int e = 0; e < (1 << R); ++e) {
        if (e & half) continue;
        const int jj = j + ((e & (half - 1)) << hbits);
        const int te = tw_skew(jj << (s0 + t));
        uint32_t tw[8], a[8], d[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) tw[w] = tws[w * TWS + te];
        fe_add(a, x[e], x[e + half], m);
        fe_sub(d, x[e], x[e + half], m);
        fe_mont_mul(x[e + half], d, tw, m);
#pragma unroll
        for (int w = 0; w < 8; ++w) x[e][w] = a[w];
      }
    }
#pragma unroll
    for (int e = 0; e < (1 << R); ++e) {
      const int pe = data_skew(base + (e << hbits));
#pragma unroll
      for (int w = 0; w < 8; ++w) col[w * S + pe] = x[e][w];
    }
  }
}

__global__ void __launch_bounds__(NTT_THREADS, 2)
ntt_fused_kernel(int32_t* out, const int32_t* x,  // out may be x, see below
                 const int32_t* __restrict__ tw,
                 const int32_t* __restrict__ mul_in,
                 const int32_t* __restrict__ mul_out, int64_t mul_out_rows,
                 int64_t count, int k, int lt, int W, int sb,
                 int64_t ntiles, Modulus m) {
  extern __shared__ uint32_t smem[];
  const int T = 1 << lt;
  const int64_t n = (int64_t)1 << k;
  const int64_t ncols = n >> lt;
  const int Tc = T + (T >> NTT_R) + (W > 1 ? 32 / W : 0);
  const int S = W * Tc;
  const int TWS = (T >> 1) + (T >> 6) + 1;
  uint32_t* sm = smem;
  uint32_t* tws = smem + 8 * S;

  for (int e = threadIdx.x; e < (T >> 1); e += blockDim.x) {
    uint32_t v[8];
    fe_load(tw + (int64_t)e * 16, v);
    const int te = tw_skew(e);
#pragma unroll
    for (int w = 0; w < 8; ++w) tws[w * TWS + te] = v[w];
  }

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // rows of the tile: W adjacent columns of one poly, or (ncols == 1) W polys
    const int64_t pc0 = ncols == 1 ? tile * W : tile % count;
    const int64_t col0 = ncols == 1 ? 0 : (tile / count) * W;
    __syncthreads();  // the twiddles are in; the last tile's stores are done
    for (int idx = threadIdx.x; idx < W * T; idx += blockDim.x) {
      const int c = idx & (W - 1);
      const int i = idx / W;
      const int64_t pc = ncols == 1 ? pc0 + c : pc0;
      const int64_t col = ncols == 1 ? 0 : col0 + c;
      uint32_t v[8];
      if (pc < count) {
        const int64_t in_poly = (int64_t)i * ncols + col;
        fe_load(x + (pc * n + in_poly) * 16, v);
        if (mul_in != nullptr) {
          uint32_t s[8];
          fe_load(mul_in + in_poly * 16, s);
          fe_mont_mul(v, v, s, m);
        }
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) v[w] = 0;
      }
      const int pe = c * Tc + data_skew(i);
#pragma unroll
      for (int w = 0; w < 8; ++w) sm[w * S + pe] = v[w];
    }
    __syncthreads();
    const int first = lt % NTT_R;  // a shorter first round, then full ones
    if (first == 1) {
      ntt_round<1>(sm, tws, S, Tc, TWS, W, lt, 0, m);
      __syncthreads();
    }
#if NTT_R > 2
    if (first == 2) {
      ntt_round<2>(sm, tws, S, Tc, TWS, W, lt, 0, m);
      __syncthreads();
    }
#endif
    for (int s0 = first; s0 < lt; s0 += NTT_R) {
      ntt_round<NTT_R>(sm, tws, S, Tc, TWS, W, lt, s0, m);
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < W * T; idx += blockDim.x) {
      int c, p;
      if (((int64_t)1 << sb) < W) {  // the tile's columns land apart: p fastest
        p = idx & (T - 1);
        c = idx >> lt;
      } else {  // adjacent columns land adjacent: c fastest
        c = idx & (W - 1);
        p = idx / W;
      }
      const int64_t pc = ncols == 1 ? pc0 + c : pc0;
      const int64_t col = ncols == 1 ? 0 : col0 + c;
      if (pc >= count) continue;
      uint32_t v[8];
      const int pe = c * Tc + data_skew(p);
#pragma unroll
      for (int w = 0; w < 8; ++w) v[w] = sm[w * S + pe];
      const int64_t hi = col >> sb;  // the column within its sub-transform
      if (mul_out != nullptr) {
        uint32_t s[8];
        fe_load(mul_out + (((hi << lt) + p) % mul_out_rows) * 16, s);
        fe_mont_mul(v, v, s, m);
      }
      const int64_t j = lt ? (int64_t)(__brev((unsigned)p) >> (32 - lt)) : 0;
      const int64_t in_poly =
          (((hi << lt) + j) << sb) + (col & (((int64_t)1 << sb) - 1));
      fe_store(out + (pc * n + in_poly) * 16, v);
    }
  }
}

// The widest tile for this lt that leaves room for two blocks on one SM,
// halved while the grid would not give every SM two tiles.
static int ntt_tile_width(int lt, int64_t rows_total, int64_t ncols) {
  int W = lt >= 11 ? 1 : lt == 10 ? 2 : 4;
  while (W > 1 && (rows_total / W < 2 * 132 || (ncols > 1 && ncols % W)))
    W >>= 1;
  return W;
}

// sb: log2 of the output stride B (0 <= sb <= k - lt), see the kernel
extern "C" int ntt_fused_launch(void* out, const void* x, const void* tw,
                                const void* mul_in, const void* mul_out,
                                int64_t mul_out_rows, int64_t count, int k,
                                int lt, int sb, const uint32_t* p,
                                uint32_t n0, void* stream) {
  if (lt < 1 || lt > NTT_MAX_LT || k < lt || count < 1 || sb < 0 || sb > k - lt)
    return (int)cudaErrorInvalidValue;
  if (mul_out != nullptr && mul_out_rows < 1) return (int)cudaErrorInvalidValue;
  Modulus m = make_modulus(p, n0);
  const int T = 1 << lt;
  const int64_t ncols = ((int64_t)1 << k) >> lt;
  const int W = ntt_tile_width(lt, count * ncols, ncols);
  const int64_t ntiles =
      ncols == 1 ? (count + W - 1) / W : count * (ncols / W);
  const int Tc = T + (T >> NTT_R) + (W > 1 ? 32 / W : 0);
  const int TWS = (T >> 1) + (T >> 6) + 1;
  const size_t smem = (size_t)8 * (W * Tc + TWS) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ntt_fused_kernel,
                                                      NTT_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (int64_t)per_sm * sms;
  if (blocks > ntiles) blocks = ntiles;
  ntt_fused_kernel<<<(unsigned)blocks, NTT_THREADS, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const int32_t*)tw,
      (const int32_t*)mul_in, (const int32_t*)mul_out, mul_out_rows, count, k,
      lt, W, sb, ntiles, m);
  return (int)cudaGetLastError();
}
