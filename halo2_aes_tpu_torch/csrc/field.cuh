// 256-bit prime-field arithmetic for BN254 Fr / Fq on 8 x 32-bit words.
//
// Shared by every hand kernel: mont_mul.cu (K1), ntt.cu (K2), curve.cuh
// (K3 and K7), quotient_terms.cu (K4) and grand_product.cu (K6).  An
// element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256, canonical in [0, p).  In device memory elements keep the
// reference layout: 16 int32 limbs of 16 bits (64 bytes), loaded and
// stored two limbs per word.
//
// What bounds the arithmetic on an H100 is the 32-bit integer multiplier
// (64 lanes per SM and clock): a CIOS product is 128 32x32->64
// multiply-adds.  Every carry chain below is one PTX `asm` statement, so
// the carry flag never leaves it: the add/sub chains are add.cc/addc.cc
// (sub.cc/subc.cc), and a multiply-add chain is mad.lo.cc / madc.hi.cc
// pairs on the same multiplicands, which ptxas emits as one wide
// multiply-add with carry per pair.  A wide multiply-add writes and reads
// an aligned register pair, so the product keeps its sum in two
// accumulators whose pairs never change (fe_mont_mul): one for the
// products of the even words of a factor, one for those of the odd words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Modulus {
  uint32_t p[8];
  uint32_t n0;  // -p^-1 mod 2^32
};

static inline Modulus make_modulus(const uint32_t* p_host, uint32_t n0) {
  Modulus m;
  for (int i = 0; i < 8; ++i) m.p[i] = p_host[i];
  m.n0 = n0;
  return m;
}

// 16 int32 limbs (64 B, 16-byte aligned) -> 8 words
__device__ __forceinline__ void fe_load(const int32_t* src, uint32_t x[8]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = s[q];
    x[2 * q] = (v.x & 0xFFFFu) | (v.y << 16);
    x[2 * q + 1] = (v.z & 0xFFFFu) | (v.w << 16);
  }
}

__device__ __forceinline__ void fe_store(int32_t* dst, const uint32_t x[8]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v;
    v.x = x[2 * q] & 0xFFFFu;
    v.y = x[2 * q] >> 16;
    v.z = x[2 * q + 1] & 0xFFFFu;
    v.w = x[2 * q + 1] >> 16;
    d[q] = v;
  }
}

// r = t - p if t >= p (or the 257th bit `hi` is set), else t
__device__ __forceinline__ void fe_reduce_once(uint32_t r[8], const uint32_t t[8],
                                               uint32_t hi, const Modulus& m) {
  uint32_t d0, d1, d2, d3, d4, d5, d6, d7, borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d0), "=&r"(d1), "=&r"(d2), "=&r"(d3), "=&r"(d4), "=&r"(d5),
        "=&r"(d6), "=&r"(d7), "=&r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(m.p[0]), "r"(m.p[1]), "r"(m.p[2]),
        "r"(m.p[3]), "r"(m.p[4]), "r"(m.p[5]), "r"(m.p[6]), "r"(m.p[7]));
  const bool take = hi || !borrow;  // borrow is 0xFFFFFFFF when t < p
  r[0] = take ? d0 : t[0];
  r[1] = take ? d1 : t[1];
  r[2] = take ? d2 : t[2];
  r[3] = take ? d3 : t[3];
  r[4] = take ? d4 : t[4];
  r[5] = take ? d5 : t[5];
  r[6] = take ? d6 : t[6];
  r[7] = take ? d7 : t[7];
}

// The CIOS Montgomery product keeps T, its running sum, in two arrays of
// 8 words: T = e + o * 2^32, where e's word j sits at word offset j and
// o's one word up.  A row adds a[2j] * b_i to e's pair (2j, 2j+1) and
// a[2j+1] * b_i to o's pair (2j, 2j+1); the reduction adds p's even and
// odd words times m_i the same way.  Each mad.lo.cc / madc.hi.cc pair
// then writes one aligned register pair of its own array, the same pair
// in every row, so ptxas needs no register moves to re-pair them.  The shift
// by one word after each row costs no copies either: the arrays swap
// roles, o (now at offsets 0..7) becoming the next row's e and e (its
// word 0 reduced to 0) the next row's o, whose shift the next row's odd
// chain folds into its destinations (it reads o[j + 2] and writes o[j],
// as sppark's madc_n_rshift does).
//
// Headroom: with a, b < p, T < 2p after each shift (CIOS), so T < 2p 2^32
// before it and o <= T div 2^32 < 2p < 2^255: the carries the chains drop
// (out of o's top word) are zero, and so is the final sum's carry out of
// word 7.  BN254's Fr and Fq are below 2^254; ops/_build.modulus_args
// refuses a modulus from 2^254 on.  tests/test_torch_mont_schedule.py
// replays these chains word for word and checks that every dropped carry
// is 0.

// the first row: e = a_even * b0, o = a_odd * b0 (no carries)
__device__ __forceinline__ void fe_row_first(uint32_t e[8], uint32_t o[8],
                                             const uint32_t a[8], uint32_t b0) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const uint64_t ev = (uint64_t)a[j] * b0, od = (uint64_t)a[j + 1] * b0;
    e[j] = (uint32_t)ev;
    e[j + 1] = (uint32_t)(ev >> 32);
    o[j] = (uint32_t)od;
    o[j + 1] = (uint32_t)(od >> 32);
  }
}

// a later row's shift and odd products.  e is the last row's o, o the
// last row's e, whose word j the shift moves to offset j - 1 (o[0] == 0
// leaves): e[0] += o[1], then o[j] = o[j + 2] + a_odd * b at offset
// j + 1, the first carry entering o[0]; the carry out of o[7] is dropped
__device__ __forceinline__ void fe_row_odd(uint32_t e[8], uint32_t o[8],
                                           const uint32_t a[8], uint32_t b) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32 %8, %12, %13, 0;"
      : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// acc += (x[0] + x[2] 2^64 + x[4] 2^128 + x[6] 2^192) * y on acc's pairs,
// the carry out added to top
__device__ __forceinline__ void fe_mad_pairs(uint32_t acc[8], uint32_t& top,
                                             const uint32_t* x, uint32_t y) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(top)
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// the same with the carry out of acc[7] dropped
__device__ __forceinline__ void fe_mad_pairs_drop(uint32_t acc[8], const uint32_t* x,
                                                  uint32_t y) {
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
      : "r"(x[0]), "r"(x[2]), "r"(x[4]), "r"(x[6]), "r"(y));
}

// T += m_i * p with m_i = e[0] * n0 (o holds no word at offset 0), which
// makes e[0] zero
__device__ __forceinline__ void fe_row_reduce(uint32_t e[8], uint32_t o[8],
                                              const Modulus& m) {
  const uint32_t mi = e[0] * m.n0;
  fe_mad_pairs_drop(o, m.p + 1, mi);
  fe_mad_pairs(e, o[7], m.p, mi);
}

// one row b of a later word: the shift, a * b, the reduction
__device__ __forceinline__ void fe_row(uint32_t e[8], uint32_t o[8],
                                       const uint32_t a[8], uint32_t b,
                                       const Modulus& m) {
  fe_row_odd(e, o, a, b);
  fe_mad_pairs(e, o[7], a, b);
  fe_row_reduce(e, o, m);
}

// CIOS Montgomery product: r = a * b * 2^-256 mod p (a, b < p); r may
// alias a or b.  The rows alternate x and y as e; after the last row y
// sits at offsets 0..7 (y[0] == 0) and x at 1..8, so the shifted sum is
// x + y[1..7]
__device__ __forceinline__ void fe_mont_mul(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8], const Modulus& m) {
  uint32_t x[8], y[8];
  fe_row_first(x, y, a, b[0]);
  fe_row_reduce(x, y, m);
#pragma unroll
  for (int i = 1; i < 8; i += 2) {
    fe_row(y, x, a, b[i], m);
    if (i + 1 < 8) fe_row(x, y, a, b[i + 1], m);
  }
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
        "+r"(x[6]), "+r"(x[7])
      : "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]),
        "r"(y[7]));
  fe_reduce_once(r, x, 0, m);
}

__device__ __forceinline__ void fe_add(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8], const Modulus& m) {
  uint32_t s[8], c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=&r"(s[0]), "=&r"(s[1]), "=&r"(s[2]), "=&r"(s[3]), "=&r"(s[4]),
        "=&r"(s[5]), "=&r"(s[6]), "=&r"(s[7]), "=&r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  fe_reduce_once(r, s, c, m);
}

__device__ __forceinline__ void fe_sub(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8], const Modulus& m) {
  uint32_t d[8], mask;  // mask = 0xFFFFFFFF when a < b: then add p back
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(mask)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3]), "=&r"(r[4]),
        "=&r"(r[5]), "=&r"(r[6]), "=&r"(r[7])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]),
        "r"(d[6]), "r"(d[7]), "r"(m.p[0] & mask), "r"(m.p[1] & mask),
        "r"(m.p[2] & mask), "r"(m.p[3] & mask), "r"(m.p[4] & mask),
        "r"(m.p[5] & mask), "r"(m.p[6] & mask), "r"(m.p[7] & mask));
}
