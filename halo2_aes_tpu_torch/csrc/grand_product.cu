// K6: one grand-product column (a lookup's z, or a permutation chunk's z)
// from its input columns, in three launches whatever the column's length.
//
// Replaces no TPU kernel: the reference builds the columns from eager field
// ops (two log-step scans for Montgomery's batch inversion, one more for the
// running product, one Fermat inversion) and leaves the fusion to XLA; the
// port ran them eagerly, at 2^20 rows ~60 full-column K1 passes, ~35 int64
// torch kernels a modular add and a 379-launch Fermat chain a column.
//
// The column: z[0] = init, z[j] = init * prod_{r<j} num_r / den_r, the
// rows' factors num_r / den_r set to 1 from row `usable` on, and a zero
// den_r giving the ratio 0 (as F.batch_inv maps 0 to 0: num_r := 0,
// den_r := 1); rows [n - bf, n) take the blinding rows.  With D the
// product of all den_r (never 0),
//     z[j] = init * D^-1 * prod_{r<j} num_r * prod_{r>=j} den_r,
// a prefix product of the numerators and a suffix product of the
// denominators with one inversion a column.  Launches:
//   reduce  one block a tile of TILE rows: the tile's products N_t, D_t
//   middle  one block a column: K_t = init * D^-1 * prod_{s<t} N_s *
//           prod_{s>t} D_s, D^-1 in one thread (fe_inv.cuh: binary
//           extended Euclid; a Fermat chain took ~270 us there)
//   finish  one block a tile: the factors again, the prefix and suffix
//           products inside the tile (a thread's ROWS rows in registers,
//           then a log-step scan over the block's threads), z = K_t * ...
// Two front ends give a row's factors (a template parameter): a lookup's
// (A+beta)(S+gamma) over (A'+beta)(S'+gamma), and a permutation chunk's
// prod_i (v_i + beta delta^i omega^row + gamma) over
// prod_i (v_i + beta delta^col' omega^row' + gamma), its sigma labels
// gathered from the proving key's maps inside the kernel.
//
// What bounds it on an H100: memory.  A 2^20-row lookup column reads its
// four inputs and writes z (320 B a row, 0.10 ms at 3.35 TB/s) against ~7
// products a row (0.06 ms of multiply-adds); the design reads the inputs
// twice (reduce and finish) instead of keeping O(n) intermediates in device
// memory, and the middle launch's inversion is one thread's serial loop,
// the same for a column of any length.
#include "fe_inv.cuh"
#include "field.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 2;                 // consecutive rows a thread
constexpr int TILE = THREADS * ROWS;    // rows a block (ops/cuda_grand.TILE)
constexpr int MID_THREADS = 512;        // threads of the middle launch's block
constexpr int MAX_COLS = 16;            // columns of a permutation chunk

struct Common {
  int32_t* out;                 // (segments * n, 16)
  uint4* agg;                   // (segments, tiles, 2) elements: N_t, D_t
  uint4* kt;                    // (segments, tiles) elements: K_t
  const int32_t* init;          // z[0] of every segment: one element
  const int32_t* blinding;      // (segments, bf, 16)
  int64_t n, usable, bf, tiles;
  uint32_t one[8];              // R mod p
  uint32_t r3[8];               // R^3 mod p
};

// table: beta, gamma
struct LookupFront {
  const int32_t *a, *s, *ap, *sp, *table;

  __device__ __forceinline__ void factors(int64_t seg, int64_t row, int64_t n,
                                          uint32_t num[8], uint32_t den[8],
                                          const Modulus& m) const {
    uint32_t b[8], g[8], x[8], y[8];
    fe_load(table, b);
    fe_load(table + 16, g);
    const int64_t off = (seg * n + row) * 16;
    fe_load(a + off, x);
    fe_add(x, x, b, m);
    fe_load(s + off, y);
    fe_add(y, y, g, m);
    fe_mont_mul(num, x, y, m);
    fe_load(ap + off, x);
    fe_add(x, x, b, m);
    fe_load(sp + off, y);
    fe_add(y, y, g, m);
    fe_mont_mul(den, x, y, m);
  }
};

// table: gamma, then beta * delta^i for every permutation column i
struct PermFront {
  const int32_t* fld;           // the columns' evaluations, n rows each
  const int64_t *map_col, *map_row;   // (m, n): sigma of column i, row j
  const int32_t *omega, *table;
  int cols;
  int64_t col[MAX_COLS];        // column of fld for the chunk's i-th
  int32_t idx[MAX_COLS];        // its permutation column

  __device__ __forceinline__ void factors(int64_t, int64_t row, int64_t n,
                                          uint32_t num[8], uint32_t den[8],
                                          const Modulus& m) const {
    uint32_t g[8], w[8], v[8], o[8], x[8], y[8];
    fe_load(table, g);
    fe_load(omega + row * 16, w);
#pragma unroll 1
    for (int c = 0; c < cols; ++c) {
      const int64_t i = idx[c];
      fe_load(fld + (col[c] * n + row) * 16, v);
      fe_add(v, v, g, m);                 // v + gamma
      fe_load(table + (1 + i) * 16, x);
      fe_mont_mul(x, x, w, m);            // beta delta^i omega^row
      fe_add(x, x, v, m);
      const int64_t mc = map_col[i * n + row];
      const int64_t mr = map_row[i * n + row];
      fe_load(table + (1 + mc) * 16, y);
      fe_load(omega + mr * 16, o);
      fe_mont_mul(y, y, o, m);            // beta sigma
      fe_add(y, y, v, m);
      if (c == 0) {
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8) { num[w8] = x[w8]; den[w8] = y[w8]; }
      } else {
        fe_mont_mul(num, num, x, m);
        fe_mont_mul(den, den, y, m);
      }
    }
  }
};

__device__ __forceinline__ bool fe_is_zero(const uint32_t x[8]) {
  uint32_t o = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) o |= x[w];
  return o == 0;
}

__device__ __forceinline__ void fe_copy(uint32_t r[8], const uint32_t x[8]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) r[w] = x[w];
}

__device__ __forceinline__ void get2(const uint4* p, int64_t i, uint32_t x[8]) {
  const uint4 lo = p[2 * i], hi = p[2 * i + 1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void put2(uint4* p, int64_t i, const uint32_t x[8]) {
  p[2 * i] = make_uint4(x[0], x[1], x[2], x[3]);
  p[2 * i + 1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// A row's masked factors: 1 / 1 from `usable` on (rows past n included);
// a zero denominator gives the ratio 0.
template <class Front>
__device__ __forceinline__ void row_factors(const Front& f, const Common& c,
                                            int64_t seg, int64_t row,
                                            uint32_t num[8], uint32_t den[8],
                                            const Modulus& m) {
  if (row < c.usable) {
    f.factors(seg, row, c.n, num, den, m);
    if (fe_is_zero(den)) {
#pragma unroll
      for (int w = 0; w < 8; ++w) { num[w] = 0; den[w] = c.one[w]; }
    }
  } else {
    fe_copy(num, c.one);
    fe_copy(den, c.one);
  }
}

// Over the block's T threads at once: a's exclusive prefix product (in
// thread order) into a, b's exclusive suffix product into b, and the
// product of every thread's b into total.  sh: 4 * T uint4.
template <int T>
__device__ __forceinline__ void block_scans(uint4* sh, uint32_t a[8], uint32_t b[8],
                                            uint32_t total[8], const uint32_t one[8],
                                            const Modulus& m) {
  const int t = threadIdx.x;
  const int rt = T - 1 - t;           // b scans in reverse thread order
  uint4* sa = sh;
  uint4* sb = sh + 2 * T;
  put2(sa, t, a);
  put2(sb, rt, b);
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d < T; d <<= 1) {
    uint32_t x[8], y[8];
    if (t >= d) get2(sa, t - d, x);
    if (rt >= d) get2(sb, rt - d, y);
    __syncthreads();
    if (t >= d) { fe_mont_mul(a, a, x, m); put2(sa, t, a); }
    if (rt >= d) { fe_mont_mul(b, b, y, m); put2(sb, rt, b); }
    __syncthreads();
  }
  if (t > 0) get2(sa, t - 1, a); else fe_copy(a, one);
  if (rt > 0) get2(sb, rt - 1, b); else fe_copy(b, one);
  get2(sb, T - 1, total);
  __syncthreads();
}

template <class Front>
__global__ void __launch_bounds__(THREADS)
grand_reduce_kernel(Front f, Common c, Modulus m) {
  __shared__ uint4 sh[4 * THREADS];
  const int64_t seg = blockIdx.y, tile = blockIdx.x;
  const int64_t row0 = tile * TILE + (int64_t)threadIdx.x * ROWS;
  uint32_t pn[8], pd[8], num[8], den[8];
  row_factors(f, c, seg, row0, pn, pd, m);
#pragma unroll
  for (int k = 1; k < ROWS; ++k) {
    row_factors(f, c, seg, row0 + k, num, den, m);
    fe_mont_mul(pn, pn, num, m);
    fe_mont_mul(pd, pd, den, m);
  }
  uint4* sn = sh;
  uint4* sd = sh + 2 * THREADS;
  const int t = threadIdx.x;
#pragma unroll 1
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (t >= half && t < 2 * half) { put2(sn, t - half, pn); put2(sd, t - half, pd); }
    __syncthreads();
    if (t < half) {
      get2(sn, t, num);
      get2(sd, t, den);
      fe_mont_mul(pn, pn, num, m);
      fe_mont_mul(pd, pd, den, m);
    }
    __syncthreads();
  }
  if (t == 0) {
    const int64_t i = seg * c.tiles + tile;
    put2(c.agg, 2 * i, pn);
    put2(c.agg, 2 * i + 1, pd);
  }
}

__global__ void __launch_bounds__(MID_THREADS) grand_middle_kernel(Common c, Modulus m) {
  __shared__ uint4 sh[4 * MID_THREADS];
  __shared__ uint32_t scale[8];
  const int64_t seg = blockIdx.x;
  const int64_t per = (c.tiles + MID_THREADS - 1) / MID_THREADS;
  const int64_t lo0 = (int64_t)threadIdx.x * per;
  const int64_t lo = lo0 < c.tiles ? lo0 : c.tiles;
  const int64_t hi = lo + per < c.tiles ? lo + per : c.tiles;
  const uint4* agg = c.agg + seg * c.tiles * 4;
  uint4* kt = c.kt + seg * c.tiles * 2;
  uint32_t pn[8], sd[8], total[8], x[8];
  fe_copy(pn, c.one);
  fe_copy(sd, c.one);
  for (int64_t t = lo; t < hi; ++t) {
    get2(agg, 2 * t, x);
    fe_mont_mul(pn, pn, x, m);
    get2(agg, 2 * t + 1, x);
    fe_mont_mul(sd, sd, x, m);
  }
  block_scans<MID_THREADS>(sh, pn, sd, total, c.one, m);
  if (threadIdx.x == 0) {
    // total = D R; its plain inverse D^-1 R^-1 times R^3 (a Montgomery
    // product) is D^-1 in Montgomery form
    uint32_t init[8], inv[8];
    fe_load(c.init, init);
    fe_inv_binary(inv, total, m.p);
    fe_mont_mul(inv, inv, c.r3, m);
    fe_mont_mul(inv, inv, init, m);
#pragma unroll
    for (int w = 0; w < 8; ++w) scale[w] = inv[w];
  }
  __syncthreads();
  // K_t: the suffix of the D_s backwards, then the scaled prefix of the N_s
  for (int64_t t = hi - 1; t >= lo; --t) {
    put2(kt, t, sd);
    get2(agg, 2 * t + 1, x);
    fe_mont_mul(sd, sd, x, m);
  }
  uint32_t s[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w] = scale[w];
  fe_mont_mul(pn, pn, s, m);
  for (int64_t t = lo; t < hi; ++t) {
    get2(kt, t, x);
    fe_mont_mul(x, x, pn, m);
    put2(kt, t, x);
    get2(agg, 2 * t, x);
    fe_mont_mul(pn, pn, x, m);
  }
}

template <class Front>
__global__ void __launch_bounds__(THREADS)
grand_finish_kernel(Front f, Common c, Modulus m) {
  __shared__ uint4 sh[4 * THREADS];
  const int64_t seg = blockIdx.y, tile = blockIdx.x;
  const int64_t row0 = tile * TILE + (int64_t)threadIdx.x * ROWS;
  uint32_t num[ROWS][8], sd[ROWS][8];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) row_factors(f, c, seg, row0 + k, num[k], sd[k], m);
  // sd[k]: the thread's suffix product of the denominators from row k on
#pragma unroll
  for (int k = ROWS - 2; k >= 0; --k) fe_mont_mul(sd[k], sd[k], sd[k + 1], m);
  uint32_t pn[8], sx[8], total[8], run[8];
  fe_copy(pn, num[0]);
#pragma unroll
  for (int k = 1; k < ROWS; ++k) fe_mont_mul(pn, pn, num[k], m);
  fe_copy(sx, sd[0]);
  block_scans<THREADS>(sh, pn, sx, total, c.one, m);
  get2(c.kt, seg * c.tiles + tile, run);
  fe_mont_mul(run, run, pn, m);
  fe_mont_mul(run, run, sx, m);
  const int64_t keep = c.n - c.bf;
  int32_t* out = c.out + seg * c.n * 16;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int64_t row = row0 + k;
    if (row < keep) {
      uint32_t z[8];
      fe_mont_mul(z, run, sd[k], m);
      fe_store(out + row * 16, z);
      fe_mont_mul(run, run, num[k], m);
    } else if (row < c.n) {
      const uint4* src = reinterpret_cast<const uint4*>(
          c.blinding + ((seg * c.bf) + (row - keep)) * 16);
      uint4* dst = reinterpret_cast<uint4*>(out + row * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = src[q];
    }
  }
}

template <class Front>
int launch_all(const Front& f, Common c, int64_t segments, const Modulus& m,
               cudaStream_t stream) {
  const dim3 tiles((unsigned)c.tiles, (unsigned)segments);
  grand_reduce_kernel<Front><<<tiles, THREADS, 0, stream>>>(f, c, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grand_middle_kernel<<<(unsigned)segments, MID_THREADS, 0, stream>>>(c, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grand_finish_kernel<Front><<<tiles, THREADS, 0, stream>>>(f, c, m);
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0, a lookup: in0..in3 = A, S, A', S' ((segments * n, 16) each),
//   table = beta, gamma;
// kind 1, a permutation chunk (one segment): in0 = the columns' evaluations,
//   in1 / in2 = the sigma maps' columns / rows ((m, n) int64), in3 = omega
//   powers (n, 16), table = gamma, beta * delta^i; cols columns of in0 at
//   col[], permutation columns idx[].
// scratch: 3 * segments * ceil(n / TILE) elements of 32 bytes.
extern "C" int grand_product_launch(
    int kind, void* out, void* scratch, const void* in0, const void* in1,
    const void* in2, const void* in3, const void* table, const void* init,
    const void* blinding, int64_t n, int64_t usable,
    int64_t bf, int64_t segments, int cols, const int64_t* col,
    const int32_t* idx, const uint32_t* p, uint32_t n0, const uint32_t* one,
    const uint32_t* r3, void* stream) {
  Modulus m = make_modulus(p, n0);
  Common c;
  c.out = (int32_t*)out;
  c.tiles = (n + TILE - 1) / TILE;
  c.agg = (uint4*)scratch;
  c.kt = c.agg + 4 * segments * c.tiles;
  c.init = (const int32_t*)init;
  c.blinding = (const int32_t*)blinding;
  c.n = n;
  c.usable = usable;
  c.bf = bf;
  for (int w = 0; w < 8; ++w) {
    c.one[w] = one[w];
    c.r3[w] = r3[w];
  }
  if (kind == 0) {
    LookupFront f{(const int32_t*)in0, (const int32_t*)in1, (const int32_t*)in2,
                  (const int32_t*)in3, (const int32_t*)table};
    return launch_all(f, c, segments, m, (cudaStream_t)stream);
  }
  if (cols < 1 || cols > MAX_COLS || segments != 1) return (int)cudaErrorInvalidValue;
  PermFront f;
  f.fld = (const int32_t*)in0;
  f.map_col = (const int64_t*)in1;
  f.map_row = (const int64_t*)in2;
  f.omega = (const int32_t*)in3;
  f.table = (const int32_t*)table;
  f.cols = cols;
  for (int i = 0; i < MAX_COLS; ++i) {
    f.col[i] = i < cols ? col[i] : 0;
    f.idx[i] = i < cols ? idx[i] : 0;
  }
  return launch_all(f, c, 1, m, (cudaStream_t)stream);
}
