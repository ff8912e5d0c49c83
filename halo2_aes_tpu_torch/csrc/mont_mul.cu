// K1: elementwise Montgomery multiplication over Fr or Fq.
//
// Replaces the Pallas kernel of halo2_aes_tpu/ops/pallas_field.py (_fn,
// mont_mul_rows).  One thread per element: both operands in registers as
// 8 x 32-bit words, CIOS with 64-bit partial products, one conditional
// subtraction (field.cuh).  Operand rows are read at index i % rows, so
// a broadcast scalar (rows = 1) or a tiled table (rows = n against a
// count * n batch) needs no materialised copy.
#include "field.cuh"

__global__ void mont_mul_kernel(int32_t* __restrict__ out,
                                const int32_t* __restrict__ a,
                                const int32_t* __restrict__ b, int64_t n,
                                int64_t a_rows, int64_t b_rows, Modulus m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t ia = a_rows == n ? i : i % a_rows;
  int64_t ib = b_rows == n ? i : i % b_rows;
  uint32_t x[8], y[8], r[8];
  fe_load(a + ia * 16, x);
  fe_load(b + ib * 16, y);
  fe_mont_mul(r, x, y, m);
  fe_store(out + i * 16, r);
}

extern "C" int mont_mul_launch(void* out, const void* a, const void* b,
                               int64_t n, int64_t a_rows, int64_t b_rows,
                               const uint32_t* p, uint32_t n0,
                               void* stream) {
  Modulus m = make_modulus(p, n0);
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)b, n, a_rows, b_rows,
      m);
  return (int)cudaGetLastError();
}
