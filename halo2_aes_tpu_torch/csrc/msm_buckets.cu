// K7: Pippenger bucket accumulation for the MSM over BN254 G1.
//
// Replaces the sorted-prefix tree of ops/msm.py (_window_sums: an int64
// digit sort a window group, a gathered copy of every table row, three
// leaf masks, lg fold levels, lg + 1 Fenwick masked adds and a bucket fold,
// ~200 launches a group; the reference's msm.py leaves it to XLA, no
// pallas_call).  Here one commitment is one bucket set over all of its
// pre-scaled windows: table row w*n + i (= 2^{cw} P_i) goes into bucket
// d_{w,i} of its set, and the commitment is sum_b b * B_b.  Without
// tables (from msm.TABLELESS_MIN_N points) the same kernels keep one set
// per window over the bare points, and the caller folds the window sums
// by Horner doublings.
//
// Ten kernels, in the order ops/cuda_msm.py launches them:
//  - msm_digits: one thread a scalar cuts the W digits of c bits from its
//    plain Fr limbs into a uint16 matrix: set s, row r at s * R + r (with
//    tables set = commitment, r = w*n + i; without, set = window, r = i);
//  - msm_histogram, msm_starts, msm_tilescan, msm_pass1, msm_histogram2,
//    msm_pass2: a stable sort of the nonzero digits by (set, bucket) in
//    two scatter passes of a few bits each (below), so every bucket lists
//    its rows ascending: the same lists as a stable sort, whatever the
//    tiling;
//  - msm_accumulate: the bucket-ordered list cut into equal slices, one a
//    thread: each thread reads its rows straight from the table by index
//    and adds them into a projective accumulator with the mixed addition
//    (algorithm 8, 11 products), writing a bucket that lies inside its
//    slice whole and the pieces of the buckets cut at its slice's ends;
//  - msm_merge: one thread a bucket adds its pieces in slice order;
//  - msm_reduce: one block a set forms sum_b b * B_b from segment-local
//    running sums on two levels (the segments' totals are the second
//    level's points) and trees: ~110 complete additions in a row at c = 12
//    (segments of 16 on both levels), against 8,190 for one chain of
//    running sums.
//
// Every addition is K3's field code in the plain versions' operation
// order, and every order of addition is fixed by the data alone (slices
// in list order, pieces in slice order, a fixed tree), so the projective
// limbs equal the plain version's bit for bit.
//
// What bounds it on an H100: the accumulation's 11 Montgomery products
// (~1,500 32-bit multiply-adds) per table row against 128 bytes of the
// table row read and 4 of its index: the integer multiplier, ~3:1 over
// memory.  For one commitment at 2^20 points (c = 12, W = 22):
// 22 x 2^20 mixed additions, 2.06 ms at 16.75e12 multiply-adds a second;
// 3.0 GB of reads, 0.90 ms at 3.35 TB/s.
#include "curve.cuh"

#define FULL_MASK 0xffffffffu

// ---------------------------------------------------------------------------
// digits
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
msm_digits_kernel(uint16_t* __restrict__ digits, const int32_t* __restrict__ scalars,
                  int64_t count_n, int64_t n, int c, int windows) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= count_n) return;
  uint32_t x[8];
  fe_load(scalars + q * 16, x);
  const int64_t j = q / n, i = q % n;
  const uint32_t mask = (1u << c) - 1u;
  uint16_t* out = digits + j * windows * n + i;
  for (int w = 0; w < windows; ++w) {
    const int bit = w * c, word = bit >> 5, off = bit & 31;
    uint32_t v = x[word] >> off;
    if (off + c > 32 && word + 1 < 8) v |= x[word + 1] << (32 - off);
    out[(int64_t)w * n] = (uint16_t)(v & mask);
  }
}

// ---------------------------------------------------------------------------
// counting sort
// ---------------------------------------------------------------------------

// The sort is two stable scatter passes (least significant digit first):
// pass 1 by the digit's low lb bits over the rows of each set in order,
// into a list of (row | high bits << rbits) words; pass 2 by (set, high
// bits) over that list in order, into the final rows.  Each pass has at
// most 2^lb (pass 1) or sets * 2^hb (pass 2) destinations a block, so its
// writes run in short contiguous streams that the L2 cache combines; one
// pass over 2^c destinations scattered one 4-byte word a 32-byte sector.
// A block walks its tile 256 places a step in order; a warp ranks equal
// keys by __match_any_sync, and the warps of a step by their counts in
// shared memory, so each pass is stable.

constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;

// exclusive scan of n counts in place from base, by one block of
// SORT_THREADS; returns the counts' total
__device__ int32_t block_scan(int32_t* data, int64_t n, int32_t base) {
  __shared__ int32_t part[SORT_THREADS];
  const int64_t per = (n + SORT_THREADS - 1) / SORT_THREADS;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  int32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += data[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int step = 1; step < SORT_THREADS; step <<= 1) {   // inclusive scan
    const int32_t v = threadIdx.x >= step ? part[threadIdx.x - step] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int32_t run = base + (threadIdx.x ? part[threadIdx.x - 1] : 0);
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t v = data[i];
    data[i] = run;
    run += v;
  }
  const int32_t total = part[SORT_THREADS - 1];
  __syncthreads();
  return total;
}

// block = pass-1 tile (s, t): totals[s * B + d] += the tile's nonzero
// digits d; counts1[(s * LB + lo) * tiles + t] = those with low bits lo
__global__ void __launch_bounds__(SORT_THREADS)
msm_histogram_kernel(int32_t* __restrict__ totals, int32_t* __restrict__ counts1,
                     const uint16_t* __restrict__ digits, int64_t R, int tiles,
                     int64_t tile_rows, int c, int lb) {
  extern __shared__ uint32_t cnt[];
  const int B = 1 << c, LB = 1 << lb;
  uint32_t* low = cnt + B;
  const int64_t s = blockIdx.x / tiles, t = blockIdx.x % tiles;
  for (int b = threadIdx.x; b < B + LB; b += SORT_THREADS) cnt[b] = 0;
  __syncthreads();
  const uint16_t* base = digits + s * R;
  const int64_t r0 = t * tile_rows;
  const int64_t r1 = r0 + tile_rows < R ? r0 + tile_rows : R;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += SORT_THREADS) {
    const uint32_t d = base[r];
    if (d) {
      atomicAdd(&cnt[d], 1u);
      atomicAdd(&low[d & (LB - 1)], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += SORT_THREADS)
    if (cnt[b]) atomicAdd(&totals[s * B + b], (int32_t)cnt[b]);
  for (int l = threadIdx.x; l < LB; l += SORT_THREADS)
    counts1[(s * LB + l) * tiles + t] = (int32_t)low[l];
}

// one block: starts[g] = sum of totals[< g], starts[nb] = the total
__global__ void __launch_bounds__(SORT_THREADS)
msm_starts_kernel(int32_t* __restrict__ starts, const int32_t* __restrict__ totals,
                  int64_t nb) {
  for (int64_t g = threadIdx.x; g < nb; g += SORT_THREADS) starts[g] = totals[g];
  __syncthreads();
  const int32_t total = block_scan(starts, nb, 0);
  if (threadIdx.x == 0) starts[nb] = total;
}

// block = a pass's bin: its tiles' counts scanned in place from the bin's
// first place.  Pass 1, bin (s, lo): the set's first place plus the
// nonzero digits of the set with lower low bits.  Pass 2, bin (s, hi):
// the first place of bucket (s, hi << lb).
__global__ void __launch_bounds__(SORT_THREADS)
msm_tilescan_kernel(int32_t* __restrict__ counts, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ totals, int tiles, int c, int lb,
                    int pass) {
  __shared__ int32_t base;
  const int B = 1 << c, LB = 1 << lb, HB = 1 << (c - lb);
  const int64_t bin = blockIdx.x;
  if (pass == 1) {
    const int64_t s = bin / LB, lo = bin % LB;
    int32_t sum = 0;
    for (int64_t i = threadIdx.x; i < (int64_t)HB * lo; i += SORT_THREADS)
      sum += totals[s * B + (i / lo) * LB + i % lo];
    for (int off = 16; off; off >>= 1) sum += __shfl_down_sync(FULL_MASK, sum, off);
    __shared__ int32_t warp_sum[SORT_WARPS];
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t v = starts[s * B];
      for (int w = 0; w < SORT_WARPS; ++w) v += warp_sum[w];
      base = v;
    }
  } else if (threadIdx.x == 0) {
    const int64_t s = bin / HB, hi = bin % HB;
    base = starts[s * B + hi * LB];
  }
  __syncthreads();
  block_scan(counts + bin * tiles, tiles, base);
}

// one step of a stable scatter pass: `key` (< nkeys, or nkeys to skip)
// goes to off[key] + the places taken by equal keys of earlier warps and
// lanes of the step; off[] advances past the step's keys.  wcnt holds
// SORT_WARPS x nkeys zeros between steps.
__device__ __forceinline__ int64_t stable_place(uint32_t key, int nkeys,
                                                int32_t* off, int32_t* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t peers = __match_any_sync(FULL_MASK, key);
  const uint32_t rank = __popc(peers & ((1u << lane) - 1u));
  const uint32_t count = __popc(peers);
  const bool live = key < (uint32_t)nkeys;
  if (live && rank == 0) wcnt[warp * nkeys + key] = count;
  __syncthreads();
  int64_t pos = -1;
  int32_t before = 0, after = 0;
  if (live) {
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int32_t v = wcnt[w * nkeys + key];
      if (w < warp) before += v;
      if (w > warp) after += v;
    }
    pos = off[key] + before + rank;
  }
  __syncthreads();
  if (live && rank == 0) {
    if (after == 0) off[key] += before + count;   // the last warp with the key
    wcnt[warp * nkeys + key] = 0;
  }
  __syncwarp();
  return pos;
}

// block = pass-1 tile (s, t): the set's rows in order, each with a nonzero
// digit to its place in list1 as (row | (digit >> lb) << rbits)
__global__ void __launch_bounds__(SORT_THREADS)
msm_pass1_kernel(uint32_t* __restrict__ list1, const int32_t* __restrict__ counts1,
                 const uint16_t* __restrict__ digits, int64_t R, int tiles,
                 int64_t tile_rows, int lb, int rbits) {
  extern __shared__ int32_t sh1[];
  const int LB = 1 << lb;
  int32_t* off = sh1;
  int32_t* wcnt = sh1 + LB;
  const int64_t s = blockIdx.x / tiles, t = blockIdx.x % tiles;
  for (int l = threadIdx.x; l < LB; l += SORT_THREADS)
    off[l] = counts1[(s * LB + l) * tiles + t];
  for (int i = threadIdx.x; i < SORT_WARPS * LB; i += SORT_THREADS) wcnt[i] = 0;
  __syncthreads();
  const uint16_t* base = digits + s * R;
  const int64_t r0 = t * tile_rows;
  const int64_t r1 = r0 + tile_rows < R ? r0 + tile_rows : R;
  for (int64_t r = r0 + threadIdx.x; r - threadIdx.x < r1; r += SORT_THREADS) {
    const uint32_t d = r < r1 ? base[r] : 0u;
    const uint32_t key = d ? (d & (LB - 1)) : (uint32_t)LB;
    const int64_t pos = stable_place(key, LB, off, wcnt);
    if (pos >= 0) list1[pos] = (uint32_t)r | ((d >> lb) << rbits);
  }
}

// the set holding list place p: the last s with starts[s * B] <= p
__device__ __forceinline__ int set_of(const int32_t* starts, int64_t p, int sets,
                                      int c) {
  int lo = 0, hi = sets;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (starts[(int64_t)mid << c] <= p) lo = mid; else hi = mid;
  }
  return lo;
}

// block = pass-2 tile t of list1: counts2[(s * HB + hi) * tiles + t]
__global__ void __launch_bounds__(SORT_THREADS)
msm_histogram2_kernel(int32_t* __restrict__ counts2, const uint32_t* __restrict__ list1,
                      const int32_t* __restrict__ starts, int sets, int tiles,
                      int64_t tile_places, int c, int lb, int rbits) {
  extern __shared__ uint32_t cnt2[];
  const int HB = 1 << (c - lb), nbins = sets * HB;
  const int64_t t = blockIdx.x;
  for (int b = threadIdx.x; b < nbins; b += SORT_THREADS) cnt2[b] = 0;
  __syncthreads();
  const int64_t total = starts[(int64_t)sets << c];
  const int64_t p0 = t * tile_places;
  const int64_t p1 = p0 + tile_places < total ? p0 + tile_places : total;
  for (int64_t p = p0 + threadIdx.x; p < p1; p += SORT_THREADS)
    atomicAdd(&cnt2[set_of(starts, p, sets, c) * HB + (list1[p] >> rbits)], 1u);
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += SORT_THREADS)
    counts2[(int64_t)b * tiles + t] = (int32_t)cnt2[b];
}

// block = pass-2 tile t: list1's places in order, each row to its final
// place in bin (set, high bits)
__global__ void __launch_bounds__(SORT_THREADS)
msm_pass2_kernel(int32_t* __restrict__ rows, const int32_t* __restrict__ counts2,
                 const uint32_t* __restrict__ list1, const int32_t* __restrict__ starts,
                 int sets, int tiles, int64_t tile_places, int c, int lb, int rbits) {
  extern __shared__ int32_t sh2[];
  const int HB = 1 << (c - lb), nbins = sets * HB;
  int32_t* off = sh2;
  int32_t* wcnt = sh2 + nbins;
  const int64_t t = blockIdx.x;
  for (int b = threadIdx.x; b < nbins; b += SORT_THREADS)
    off[b] = counts2[(int64_t)b * tiles + t];
  for (int i = threadIdx.x; i < SORT_WARPS * nbins; i += SORT_THREADS) wcnt[i] = 0;
  __syncthreads();
  const int64_t total = starts[(int64_t)sets << c];
  const int64_t p0 = t * tile_places;
  const int64_t p1 = p0 + tile_places < total ? p0 + tile_places : total;
  const uint32_t row_mask = (1u << rbits) - 1u;
  for (int64_t p = p0 + threadIdx.x; p - threadIdx.x < p1; p += SORT_THREADS) {
    uint32_t v = 0, key = (uint32_t)nbins;
    if (p < p1) {
      v = list1[p];
      key = set_of(starts, p, sets, c) * HB + (v >> rbits);
    }
    const int64_t pos = stable_place(key, nbins, off, wcnt);
    if (pos >= 0) rows[pos] = (int32_t)(v & row_mask);
  }
}

// ---------------------------------------------------------------------------
// accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_xy(uint32_t x[8], uint32_t y[8],
                                        const int32_t* px, const int32_t* py,
                                        int64_t stride, int32_t row) {
  fe_load(px + (int64_t)row * stride, x);
  fe_load(py + (int64_t)row * stride, y);
}

// Five blocks of 128 an SM (at most 102 registers a thread: 96, 200 bytes
// spilled): 20 warps.  With field.cuh's two-accumulator product, five ran
// 1% faster than four (128 registers, 32 bytes spilled) and 3-4% faster
// than three (166 registers, none spilled) at both cells' shapes: 8
// commitments over 2^20 points with tables, one over 2^22 without.  The
// wrapper cuts the list into one slice a resident thread
// (msm_accumulate_threads), so the threads run as one wave; a partial last
// wave cost 14-24%.
constexpr int ACC_THREADS = 128;
constexpr int ACC_BLOCKS_SM = 5;

// thread t sums list places [t * slice, (t + 1) * slice): a bucket that
// lies inside the slice goes to bucket[g]; the slice's first bucket, where
// it began before the slice or runs past it, to first[t]; the slice's last
// bucket, where it runs past the slice and is not its first, to last[t]
__global__ void __launch_bounds__(ACC_THREADS, ACC_BLOCKS_SM)
msm_accumulate_kernel(int32_t* __restrict__ bx, int32_t* __restrict__ by,
                      int32_t* __restrict__ bz, int32_t* __restrict__ fx,
                      int32_t* __restrict__ fy, int32_t* __restrict__ fz,
                      int32_t* __restrict__ lx, int32_t* __restrict__ ly,
                      int32_t* __restrict__ lz, const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ starts, int64_t nb,
                      const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                      int64_t stride, int64_t slice, int64_t threads,
                      const int32_t* __restrict__ one, Modulus m) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const int64_t total = starts[nb];
  const int64_t p0 = t * slice;
  if (p0 >= total) return;
  const int64_t p1 = p0 + slice < total ? p0 + slice : total;
  // the bucket holding p0: the last g with starts[g] <= p0
  int64_t lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (starts[mid] <= p0) lo = mid; else hi = mid;
  }
  int64_t g = lo;
  uint32_t one_w[8];
  fe_load(one, one_w);
  int64_t p = p0;
  bool first = true;
#pragma unroll 1
  for (;;) {
    const int64_t e = starts[g + 1];
    const int64_t seg_end = e < p1 ? e : p1;
    const int64_t seg_start = p;
    Pt acc;
    load_xy(acc.x, acc.y, px, py, stride, rows[p]);
#pragma unroll
    for (int w = 0; w < 8; ++w) acc.z[w] = one_w[w];
    ++p;
    uint32_t nx[8], ny[8];
    if (p < seg_end) load_xy(nx, ny, px, py, stride, rows[p]);
#pragma unroll 1
    while (p < seg_end) {
      uint32_t qx[8], qy[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        qx[w] = nx[w];
        qy[w] = ny[w];
      }
      ++p;
      if (p < seg_end) load_xy(nx, ny, px, py, stride, rows[p]);  // the next row
      pt_add_mixed(acc, acc, qx, qy, m);
    }
    if (seg_start == starts[g] && e <= p1) {
      pt_store(bx, by, bz, g, acc);
    } else if (first) {
      pt_store(fx, fy, fz, t, acc);
    } else {
      pt_store(lx, ly, lz, t, acc);
    }
    first = false;
    if (p >= p1) break;
    ++g;
    while (starts[g + 1] <= p) ++g;   // skip empty buckets
  }
}

// thread = bucket g: an empty bucket is the identity; one cut by slice ends
// is its first slice's piece plus the next slices' first pieces, in order
__global__ void __launch_bounds__(128)
msm_merge_kernel(int32_t* __restrict__ bx, int32_t* __restrict__ by,
                 int32_t* __restrict__ bz, const int32_t* __restrict__ fx,
                 const int32_t* __restrict__ fy, const int32_t* __restrict__ fz,
                 const int32_t* __restrict__ lx, const int32_t* __restrict__ ly,
                 const int32_t* __restrict__ lz, const int32_t* __restrict__ starts,
                 int64_t nb, int64_t slice, const int32_t* __restrict__ one,
                 Modulus m) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nb) return;
  const int64_t s0 = starts[g], e = starts[g + 1];
  Pt acc;
  if (s0 == e) {
    fe_load(one, acc.y);
#pragma unroll
    for (int w = 0; w < 8; ++w) acc.x[w] = acc.z[w] = 0;
    pt_store(bx, by, bz, g, acc);
    return;
  }
  const int64_t t0 = s0 / slice, t1 = (e - 1) / slice;
  if (t0 == t1) return;   // written whole by its slice
  if (s0 == t0 * slice) {
    pt_load(acc, fx, fy, fz, t0);
  } else {
    pt_load(acc, lx, ly, lz, t0);
  }
#pragma unroll 1
  for (int64_t t = t0 + 1; t <= t1; ++t) {
    Pt q;
    pt_load(q, fx, fy, fz, t);
    pt_add(acc, acc, q, m);
  }
  pt_store(bx, by, bz, g, acc);
}

// ---------------------------------------------------------------------------
// reduction: sum_b b * B_b a set
// ---------------------------------------------------------------------------

// S = sum_j j P_j and T = sum_j P_j over L = 2^lo points by running sums
// from the top (L = 1: S is the identity); P_j from `load(j)`
template <typename Load>
__device__ __forceinline__ void segment_sums(Pt& S, Pt& T, int L, Load load,
                                             const int32_t* one, const Modulus& m) {
  Pt q;
  load(T, L - 1);
  if (L == 1) {
    fe_load(one, S.y);
#pragma unroll
    for (int w = 0; w < 8; ++w) S.x[w] = S.z[w] = 0;
    return;
  }
  S = T;
#pragma unroll 1
  for (int j = L - 2; j >= 1; --j) {
    load(q, j);
    pt_add(T, T, q, m);
    pt_add(S, S, T, m);
  }
  load(q, 0);
  pt_add(T, T, q, m);
}

// sh[0] = sh[0] + ... + sh[n - 1] by a fixed tree (n a power of two; every
// thread of the block calls it)
__device__ __forceinline__ void tree_sum(Pt* sh, int n, const Modulus& m) {
#pragma unroll 1
  for (int w = n >> 1; w >= 1; w >>= 1) {
    if ((int)threadIdx.x < w) pt_add(sh[threadIdx.x], sh[threadIdx.x],
                                     sh[threadIdx.x + w], m);
    __syncthreads();
  }
}

// block = set, G = 2^(c - lo) threads.  Level 1: thread s sums its segment
// of L = 2^lo buckets: S_s = sum (b - sL) B_b, T_s = sum B_b; a tree adds the
// S_s.  Level 2, the same over the T_s with weights s: G2 = 2^(c - lo - lo2)
// threads over segments of L2 = 2^lo2, S2_q and T2_q, a tree adds the S2_q,
// and one thread forms V = sum q T2_q by running sums.  Since b = (b - sL)
// + L ((s - q L2) + L2 q), sum_b b B_b = sum S_s + L (sum S2_q + L2 V).
// Shared memory holds 2G points.
__global__ void __launch_bounds__(1024)
msm_reduce_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                  int32_t* __restrict__ oz, const int32_t* __restrict__ bx,
                  const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                  const int32_t* __restrict__ one, int c, int lo, int lo2,
                  Modulus m) {
  extern __shared__ Pt sh[];
  const int L = 1 << lo, G = 1 << (c - lo), L2 = 1 << lo2, G2 = G >> lo2;
  Pt* S = sh;
  Pt* T = sh + G;
  const int s = threadIdx.x;
  const int64_t b0 = ((int64_t)blockIdx.x << c) + (int64_t)s * L;
  segment_sums(S[s], T[s], L, [&](Pt& q, int j) { pt_load(q, bx, by, bz, b0 + j); },
               one, m);
  __syncthreads();
  tree_sum(S, G, m);
  Pt total = S[0];   // sum S_s
  __syncthreads();
  if (s < G2) {      // S2_q to S[q], T2_q to S[G2 + q]
    const Pt* Tq = T + s * L2;
    Pt s2, t2;
    segment_sums(s2, t2, L2, [&](Pt& q, int j) { q = Tq[j]; }, one, m);
    S[s] = s2;
    S[G2 + s] = t2;
  }
  __syncthreads();
  tree_sum(S, G2, m);
  if (s != 0) return;
  const Pt* T2 = S + G2;
  Pt V;
  if (G2 == 1) {
    fe_load(one, V.y);
#pragma unroll
    for (int w = 0; w < 8; ++w) V.x[w] = V.z[w] = 0;
  } else {
    Pt U = T2[G2 - 1];
    V = U;
#pragma unroll 1
    for (int j = G2 - 2; j >= 1; --j) {
      pt_add(U, U, T2[j], m);
      pt_add(V, V, U, m);
    }
  }
#pragma unroll 1
  for (int k = 0; k < lo2; ++k) pt_double(V, m);
  pt_add(V, S[0], V, m);     // sum S2_q + L2 V
#pragma unroll 1
  for (int k = 0; k < lo; ++k) pt_double(V, m);
  pt_add(V, total, V, m);    // sum S_s + L (...)
  pt_store(ox, oy, oz, blockIdx.x, V);
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

static unsigned blocks_of(int64_t n, int per) { return (unsigned)((n + per - 1) / per); }

extern "C" int msm_digits_launch(void* digits, const void* scalars, int64_t count_n,
                                 int64_t n, int c, int windows, void* stream) {
  if (count_n < 1 || n < 1 || c < 2 || c > 16 || windows < 1)
    return (int)cudaErrorInvalidValue;
  msm_digits_kernel<<<blocks_of(count_n, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint16_t*)digits, (const int32_t*)scalars, count_n, n, c, windows);
  return (int)cudaGetLastError();
}

// the counting sort: a memset and seven launches.  scratch holds totals
// (sets * 2^c), counts1 (sets * 2^lb * tiles1), counts2 (sets * 2^hb *
// tiles2) int32 words; list1 sets * R words
extern "C" int msm_sort_launch(void* rows, void* starts, void* list1, void* scratch,
                               const void* digits, int64_t sets, int64_t R, int c,
                               int lb, int tiles1, int64_t tile_rows, int tiles2,
                               int64_t tile_places, void* stream) {
  const int B = 1 << c, LB = 1 << lb, HB = 1 << (c - lb), rbits = 32 - (c - lb);
  const int64_t nbins2 = sets * HB;
  const size_t smem1 = (size_t)(B + LB) * 4, smem_p1 = (size_t)(1 + SORT_WARPS) * LB * 4;
  const size_t smem2 = (size_t)nbins2 * 4, smem_p2 = (size_t)(1 + SORT_WARPS) * nbins2 * 4;
  if (sets < 1 || R < 1 || c < 2 || lb < 1 || lb >= c || R > (1ll << rbits) ||
      tiles1 < 1 || (int64_t)tiles1 * tile_rows < R || tiles2 < 1 ||
      (int64_t)tiles2 * tile_places < sets * R || smem1 > 48 * 1024 ||
      smem_p2 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* totals = (int32_t*)scratch;
  int32_t* counts1 = totals + sets * B;
  int32_t* counts2 = counts1 + sets * LB * (int64_t)tiles1;
  cudaMemsetAsync(totals, 0, (size_t)sets * B * 4, st);
  msm_histogram_kernel<<<(unsigned)(sets * tiles1), SORT_THREADS, smem1, st>>>(
      totals, counts1, (const uint16_t*)digits, R, tiles1, tile_rows, c, lb);
  msm_starts_kernel<<<1, SORT_THREADS, 0, st>>>((int32_t*)starts, totals, sets * B);
  msm_tilescan_kernel<<<(unsigned)(sets * LB), SORT_THREADS, 0, st>>>(
      counts1, (const int32_t*)starts, totals, tiles1, c, lb, 1);
  msm_pass1_kernel<<<(unsigned)(sets * tiles1), SORT_THREADS, smem_p1, st>>>(
      (uint32_t*)list1, counts1, (const uint16_t*)digits, R, tiles1, tile_rows, lb,
      rbits);
  msm_histogram2_kernel<<<(unsigned)tiles2, SORT_THREADS, smem2, st>>>(
      counts2, (const uint32_t*)list1, (const int32_t*)starts, (int)sets, tiles2,
      tile_places, c, lb, rbits);
  msm_tilescan_kernel<<<(unsigned)nbins2, SORT_THREADS, 0, st>>>(
      counts2, (const int32_t*)starts, totals, tiles2, c, lb, 2);
  msm_pass2_kernel<<<(unsigned)tiles2, SORT_THREADS, smem_p2, st>>>(
      (int32_t*)rows, counts2, (const uint32_t*)list1, (const int32_t*)starts,
      (int)sets, tiles2, tile_places, c, lb, rbits);
  return (int)cudaGetLastError();
}

// accumulation and merge: two launches; buckets, first and last pieces as
// x, y, z planes each
extern "C" int msm_accumulate_launch(void* bx, void* by, void* bz, void* fx, void* fy,
                                     void* fz, void* lx, void* ly, void* lz,
                                     const void* rows, const void* starts, int64_t nb,
                                     const void* px, const void* py, int64_t stride,
                                     int64_t slice, int64_t threads, const void* one,
                                     const uint32_t* p, uint32_t n0, void* stream) {
  if (nb < 1 || stride < 16 || slice < 1 || threads < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Modulus m = make_modulus(p, n0);
  msm_accumulate_kernel<<<blocks_of(threads, ACC_THREADS), ACC_THREADS, 0, st>>>(
      (int32_t*)bx, (int32_t*)by, (int32_t*)bz, (int32_t*)fx, (int32_t*)fy,
      (int32_t*)fz, (int32_t*)lx, (int32_t*)ly, (int32_t*)lz,
      (const int32_t*)rows, (const int32_t*)starts, nb, (const int32_t*)px,
      (const int32_t*)py, stride, slice, threads, (const int32_t*)one, m);
  msm_merge_kernel<<<blocks_of(nb, 128), 128, 0, st>>>(
      (int32_t*)bx, (int32_t*)by, (int32_t*)bz, (const int32_t*)fx,
      (const int32_t*)fy, (const int32_t*)fz, (const int32_t*)lx,
      (const int32_t*)ly, (const int32_t*)lz, (const int32_t*)starts, nb, slice,
      (const int32_t*)one, m);
  return (int)cudaGetLastError();
}

// the accumulation threads the card holds at once
extern "C" int msm_accumulate_threads(int64_t* threads) {
  int dev = 0, sms = 0, blocks = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, msm_accumulate_kernel,
                                                ACC_THREADS, 0);
  *threads = (int64_t)sms * blocks * ACC_THREADS;
  return (int)cudaGetLastError();
}

extern "C" int msm_reduce_launch(void* ox, void* oy, void* oz, const void* bx,
                                 const void* by, const void* bz, const void* one,
                                 int64_t sets, int c, int lo, int lo2, const uint32_t* p,
                                 uint32_t n0, void* stream) {
  const int G = 1 << (c - lo);
  const size_t smem = 2 * (size_t)G * sizeof(Pt);
  if (sets < 1 || c < 2 || lo < 0 || lo2 < 0 || lo + lo2 > c || G > 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(msm_reduce_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)cudaGetLastError();
  msm_reduce_kernel<<<(unsigned)sets, G, smem, (cudaStream_t)stream>>>(
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (const int32_t*)bx,
      (const int32_t*)by, (const int32_t*)bz, (const int32_t*)one, c, lo, lo2,
      make_modulus(p, n0));
  return (int)cudaGetLastError();
}
