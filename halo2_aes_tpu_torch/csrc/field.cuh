// 256-bit prime-field arithmetic for BN254 Fr / Fq on 8 x 32-bit words.
//
// Shared by mont_mul.cu (K1), ntt.cu (K2) and curve_add.cu (K3).  An
// element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256, canonical in [0, p).  In device memory elements keep the
// reference layout: 16 int32 limbs of 16 bits (64 bytes), loaded and
// stored two limbs per word.
//
// What bounds the arithmetic on an H100 is the 32-bit integer multiplier
// (64 lanes per SM and clock): a CIOS product is 128 32x32->64
// multiply-adds.  Every carry chain below is one PTX `asm` statement, so
// the carry flag never leaves it: the add/sub chains are add.cc/addc.cc
// (sub.cc/subc.cc), and a multiply-add row is two chains of
// mad.lo.cc / madc.hi.cc pairs on the same multiplicands (products at
// even, then at odd word offsets), which ptxas emits as one wide
// multiply-add with carry per pair instead of a wide multiply followed
// by 64-bit adds.
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

// t[0..9] += a[0..7] * b (the sum must fit 10 words): the products at
// even word offsets in one carry chain, those at odd offsets in a second
__device__ __forceinline__ void fe_mad_row(uint32_t t[10], const uint32_t a[8],
                                           uint32_t b) {
  asm("mad.lo.cc.u32 %0, %10, %14, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %14, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, %13, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, %13, %14, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// CIOS Montgomery product: r = a * b * 2^-256 mod p (a, b < p)
__device__ __forceinline__ void fe_mont_mul(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8], const Modulus& m) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    fe_mad_row(t, a, b[i]);
    fe_mad_row(t, m.p, t[0] * m.n0);  // now t[0] == 0: drop it
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0;
  }
  fe_reduce_once(r, t, t[8], m);
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
