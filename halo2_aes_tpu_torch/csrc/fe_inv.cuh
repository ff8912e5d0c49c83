// Inversion in a prime field by the binary extended Euclidean algorithm, on
// 8 little-endian 32-bit words in plain (not Montgomery) form.
//
// K6 inverts one element a column in one thread; a Fermat chain a^(p-2) is
// ~380 dependent Montgomery products there (~270 us on an H100), this ~500
// shifts and ~250 subtractions of 256-bit words (tens of microseconds).
// The data-dependent loop is fine for the prover: nothing here is secret.
// Plain C++ on purpose (no PTX), so that the CPU tests compile it with the
// host compiler and hold it against Python's pow(a, -1, p).
#pragma once

#include <cstdint>

// r = a - b; returns the borrow out (1 when a < b)
__device__ __forceinline__ uint32_t inv_sub(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint64_t d = (uint64_t)a[w] - b[w] - borrow;
    r[w] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// r = a + b; returns the carry out
__device__ __forceinline__ uint32_t inv_add(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    c += (uint64_t)a[w] + b[w];
    r[w] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// x = (x + top * 2^256) / 2
__device__ __forceinline__ void inv_shr(uint32_t x[8], uint32_t top) {
#pragma unroll
  for (int w = 0; w < 7; ++w) x[w] = (x[w] >> 1) | (x[w + 1] << 31);
  x[7] = (x[7] >> 1) | (top << 31);
}

__device__ __forceinline__ bool inv_is_one(const uint32_t x[8]) {
  uint32_t o = x[0] ^ 1u;
#pragma unroll
  for (int w = 1; w < 8; ++w) o |= x[w];
  return o == 0;
}

// r = a^-1 mod p for a in [1, p), p an odd prime: u = a, v = p, x1 = 1,
// x2 = 0, keeping x1 a = u and x2 a = v (mod p); halve the even one of u, v
// (x / 2 mod p is x >> 1, or (x + p) >> 1 for odd x), subtract the smaller
// from the larger, until u or v is 1.  x1, x2 stay canonical.
__device__ __forceinline__ void fe_inv_binary(uint32_t r[8], const uint32_t a[8],
                                              const uint32_t p[8]) {
  uint32_t u[8], v[8], x1[8], x2[8], d[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    u[w] = a[w];
    v[w] = p[w];
    x1[w] = 0;
    x2[w] = 0;
  }
  x1[0] = 1;
  while (!inv_is_one(u) && !inv_is_one(v)) {
    while (!(u[0] & 1u)) {
      inv_shr(u, 0);
      inv_shr(x1, (x1[0] & 1u) ? inv_add(x1, x1, p) : 0u);
    }
    while (!(v[0] & 1u)) {
      inv_shr(v, 0);
      inv_shr(x2, (x2[0] & 1u) ? inv_add(x2, x2, p) : 0u);
    }
    if (!inv_sub(d, u, v)) {                     // u >= v
#pragma unroll
      for (int w = 0; w < 8; ++w) u[w] = d[w];
      if (inv_sub(x1, x1, x2)) inv_add(x1, x1, p);
    } else {
      inv_sub(v, v, u);
      if (inv_sub(x2, x2, x1)) inv_add(x2, x2, p);
    }
  }
  const bool take_u = inv_is_one(u);
#pragma unroll
  for (int w = 0; w < 8; ++w) r[w] = take_u ? x1[w] : x2[w];
}
