// P2a / P2b: Montgomery multiplication on limb-major planes, two
// in-register arithmetics.
//
// Replaces the two Pallas kernels of scripts/pallas_pack_probe.py:
//   P2a  _fn_packed (body _kernel_packed): 16-bit-limb CIOS, every 32-bit
//        product split into its low and high 16 bits as it is added,
//        one conditional subtraction;
//   P2b  _fn13 (body _kernel13): the operands repacked in registers to
//        20 limbs of 13 bits (a shifted left by 4, so R' = 2^260 against
//        the external R = 2^256), a delayed-carry CIOS whose columns take
//        up to 40 products < 2^26 each without a carry split, one
//        conditional subtraction, repacked to 16-bit limbs.
// Both compute a * b * 2^-256 mod p for canonical a, b in (16, n) int32
// limb-major planes (limb i of element e at [i * n + e]); one thread per
// element, each limb plane read and written coalesced.
//
// What bounds them on an H100: the same 3 x 64 bytes per product as K1
// (the planes are the reference's int32-per-16-bit-limb bytes, only
// transposed), against 528 32-bit multiplies each followed by a mask, a
// shift and two adds (P2a) or 820 multiply-adds plus the repacking
// (P2b): unlike K1's 128 wide multiply-adds on 32-bit words, these
// kernels are bound by integer issue, not by memory.  The probe measures
// exactly that trade against K1.
#include <cstdint>
#include <cuda_runtime.h>

struct Planes16Mod {
  uint32_t p[16];  // 16-bit limbs of p
  uint32_t n0;     // -p^-1 mod 2^16
};

struct Planes13Mod {
  uint32_t p[20];  // 13-bit limbs of p
  uint32_t n0;     // -p^-1 mod 2^13
};

// a 13-bit column takes at most 40 products of two 13-bit limbs and one
// carry (< 2^19) from the column below: the sum must stay below 2^32
static_assert(40ull * 8191ull * 8191ull + (1ull << 19) < (1ull << 32),
              "13-bit delayed-carry column bound");

__global__ void mont_mul_planes16_kernel(int32_t* __restrict__ out,
                                         const int32_t* __restrict__ a,
                                         const int32_t* __restrict__ b,
                                         int64_t n, Planes16Mod m) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t x[16], y[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = (uint32_t)a[i * n + e];
    y[i] = (uint32_t)b[i * n + e];
  }
  uint32_t acc[33];
#pragma unroll
  for (int c = 0; c < 33; ++c) acc[c] = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t t = x[i] * y[j];
      acc[i + j] += t & 0xFFFFu;
      acc[i + j + 1] += t >> 16;
    }
    uint32_t mm = (acc[i] * m.n0) & 0xFFFFu;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t q = mm * m.p[j];
      acc[i + j] += q & 0xFFFFu;
      acc[i + j + 1] += q >> 16;
    }
    acc[i + 1] += acc[i] >> 16;
  }
  // carry-normalise the upper half: a value < 2p
  uint32_t limbs[16], carry = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t v = acc[16 + i] + carry;
    limbs[i] = v & 0xFFFFu;
    carry = v >> 16;
  }
  // conditional subtraction of p (16-bit borrow chain)
  uint32_t diff[16], borrow = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t v = limbs[i] + 0x10000u - m.p[i] - borrow;
    diff[i] = v & 0xFFFFu;
    borrow = 1u - (v >> 16);
  }
  const bool ge = borrow == 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i * n + e] = (int32_t)(ge ? diff[i] : limbs[i]);
}

// 16 x 16-bit limbs -> 20 x 13-bit limbs of the value << SHIFT; limb j
// covers source bits [13j - SHIFT, 13j - SHIFT + 13)
template <int SHIFT>
__device__ __forceinline__ void repack13(const uint32_t src[16], uint32_t dst[20]) {
#pragma unroll
  for (int j = 0; j < 20; ++j) {
    const int lo = 13 * j - SHIFT;
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int base = 16 * i;
      if (base + 16 <= lo || base >= lo + 13) continue;
      const int off = lo - base;
      v |= off >= 0 ? src[i] >> off : src[i] << -off;
    }
    dst[j] = v & 0x1FFFu;
  }
}

__global__ void mont_mul_planes13_kernel(int32_t* __restrict__ out,
                                         const int32_t* __restrict__ a,
                                         const int32_t* __restrict__ b,
                                         int64_t n, Planes13Mod m) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t a16[16], b16[16], x[20], y[20];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    a16[i] = (uint32_t)a[i * n + e];
    b16[i] = (uint32_t)b[i * n + e];
  }
  repack13<4>(a16, x);   // 16 a: compensates R' = 2^260 against R = 2^256
  repack13<0>(b16, y);
  uint32_t acc[41];
#pragma unroll
  for (int c = 0; c < 41; ++c) acc[c] = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
#pragma unroll
    for (int j = 0; j < 20; ++j) acc[i + j] += x[i] * y[j];
    uint32_t mm = (acc[i] * m.n0) & 0x1FFFu;
#pragma unroll
    for (int j = 0; j < 20; ++j) acc[i + j] += mm * m.p[j];
    acc[i + 1] += acc[i] >> 13;
  }
  uint32_t limbs[20], carry = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    uint32_t v = acc[20 + i] + carry;
    limbs[i] = v & 0x1FFFu;
    carry = v >> 13;
  }
  uint32_t diff[20], borrow = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    uint32_t v = limbs[i] + 0x2000u - m.p[i] - borrow;
    diff[i] = v & 0x1FFFu;
    borrow = 1u - (v >> 13);
  }
  const bool ge = borrow == 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) limbs[i] = ge ? diff[i] : limbs[i];
  // 20 x 13-bit limbs -> 16 x 16-bit limbs
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int lo = 16 * i;
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 20; ++j) {
      const int base = 13 * j;
      if (base + 13 <= lo || base >= lo + 16) continue;
      const int off = base - lo;
      v += off >= 0 ? limbs[j] << off : limbs[j] >> -off;
    }
    out[i * n + e] = (int32_t)(v & 0xFFFFu);
  }
}

extern "C" int mont_mul_planes16_launch(void* out, const void* a, const void* b,
                                        int64_t n, const uint32_t* p16,
                                        uint32_t n0, void* stream) {
  Planes16Mod m;
  for (int i = 0; i < 16; ++i) m.p[i] = p16[i];
  m.n0 = n0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  mont_mul_planes16_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, m);
  return (int)cudaGetLastError();
}

extern "C" int mont_mul_planes13_launch(void* out, const void* a, const void* b,
                                        int64_t n, const uint32_t* p13,
                                        uint32_t n0, void* stream) {
  Planes13Mod m;
  for (int i = 0; i < 20; ++i) m.p[i] = p13[i];
  m.n0 = n0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  mont_mul_planes13_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, m);
  return (int)cudaGetLastError();
}
