// 256-bit prime-field arithmetic for BN254 Fr / Fq on 8 x 32-bit words.
//
// Shared by mont_mul.cu (K1), ntt.cu (K2) and curve_add.cu (K3).  An
// element is 8 little-endian 32-bit words in Montgomery form with
// R = 2^256, canonical in [0, p).  In device memory elements keep the
// reference layout: 16 int32 limbs of 16 bits (64 bytes), loaded and
// stored two limbs per word.
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
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)t[j] - m.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (s >> 63) & 1;
  }
  bool take = hi || !borrow;
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = take ? d[j] : t[j];
}

// CIOS Montgomery product: r = a * b * 2^-256 mod p (a, b < p)
__device__ __forceinline__ void fe_mont_mul(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8], const Modulus& m) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t mm = t[0] * m.n0;
    s = (uint64_t)mm * m.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)mm * m.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  fe_reduce_once(r, t, t[8], m);
}

__device__ __forceinline__ void fe_add(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8], const Modulus& m) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  fe_reduce_once(r, s, (uint32_t)c, m);
}

__device__ __forceinline__ void fe_sub(uint32_t r[8], const uint32_t a[8],
                                       const uint32_t b[8], const Modulus& m) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (v >> 63) & 1;
  }
  // a - b + p when it borrowed
  uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)d[j] + (m.p[j] & mask) + c;
    r[j] = (uint32_t)v;
    c = v >> 32;
  }
}
