// K3: complete projective point addition on BN254 G1 (y^2 = x^3 + 3).
//
// Replaces the Pallas kernel of halo2_aes_tpu/ops/pallas_curve.py
// (_make_kernel, _fn): Renes-Costello-Batina 2015/1060 algorithm 7 for
// a = 0, b3 = 3 * b = 9.  One thread per point pair; six Fq inputs held
// in registers, the 12 Montgomery multiplies inlined from field.cuh, the
// add/sub chains in between.  The formula is complete, so there is no
// branch on identity, doubling or negation.
#include "field.cuh"

__device__ __forceinline__ void fe_mul_b3(uint32_t r[8], const uint32_t a[8],
                                          const Modulus& m) {
  uint32_t a2[8], a4[8], a8[8];
  fe_add(a2, a, a, m);
  fe_add(a4, a2, a2, m);
  fe_add(a8, a4, a4, m);
  fe_add(r, a8, a, m);
}

__global__ void curve_add_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                                 int32_t* __restrict__ z3,
                                 const int32_t* __restrict__ x1,
                                 const int32_t* __restrict__ y1,
                                 const int32_t* __restrict__ z1,
                                 const int32_t* __restrict__ x2,
                                 const int32_t* __restrict__ y2,
                                 const int32_t* __restrict__ z2, int64_t n,
                                 Modulus m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X1[8], Y1[8], Z1[8], X2[8], Y2[8], Z2[8];
  fe_load(x1 + i * 16, X1);
  fe_load(y1 + i * 16, Y1);
  fe_load(z1 + i * 16, Z1);
  fe_load(x2 + i * 16, X2);
  fe_load(y2 + i * 16, Y2);
  fe_load(z2 + i * 16, Z2);

  uint32_t t0[8], t1[8], t2[8], A[8], B[8], C[8], u[8], v[8];
  fe_mont_mul(t0, X1, X2, m);
  fe_mont_mul(t1, Y1, Y2, m);
  fe_mont_mul(t2, Z1, Z2, m);
  fe_add(u, X1, Y1, m);
  fe_add(v, X2, Y2, m);
  fe_mont_mul(A, u, v, m);
  fe_add(u, Y1, Z1, m);
  fe_add(v, Y2, Z2, m);
  fe_mont_mul(B, u, v, m);
  fe_add(u, X1, Z1, m);
  fe_add(v, X2, Z2, m);
  fe_mont_mul(C, u, v, m);

  uint32_t t3[8], t4[8], xz[8], t0_3[8], t2_b[8], z3t[8], t1m[8], y3b[8];
  fe_sub(u, A, t0, m);
  fe_sub(t3, u, t1, m);     // X1Y2 + X2Y1
  fe_sub(u, B, t1, m);
  fe_sub(t4, u, t2, m);     // Y1Z2 + Y2Z1
  fe_sub(u, C, t0, m);
  fe_sub(xz, u, t2, m);     // X1Z2 + X2Z1
  fe_add(u, t0, t0, m);
  fe_add(t0_3, u, t0, m);   // 3 X1X2
  fe_mul_b3(t2_b, t2, m);   // b3 Z1Z2
  fe_add(z3t, t1, t2_b, m);
  fe_sub(t1m, t1, t2_b, m);
  fe_mul_b3(y3b, xz, m);    // b3 (X1Z2 + X2Z1)

  uint32_t r[8];
  fe_mont_mul(u, t4, y3b, m);
  fe_mont_mul(v, t3, t1m, m);
  fe_sub(r, v, u, m);
  fe_store(x3 + i * 16, r);
  fe_mont_mul(u, t1m, z3t, m);
  fe_mont_mul(v, y3b, t0_3, m);
  fe_add(r, u, v, m);
  fe_store(y3 + i * 16, r);
  fe_mont_mul(u, z3t, t4, m);
  fe_mont_mul(v, t0_3, t3, m);
  fe_add(r, u, v, m);
  fe_store(z3 + i * 16, r);
}

extern "C" int curve_add_launch(void* x3, void* y3, void* z3, const void* x1,
                                const void* y1, const void* z1, const void* x2,
                                const void* y2, const void* z2, int64_t n,
                                const uint32_t* p, uint32_t n0, void* stream) {
  Modulus m = make_modulus(p, n0);
  const int threads = 128;
  int64_t blocks = (n + threads - 1) / threads;
  curve_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, (const int32_t*)x1,
      (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, n, m);
  return (int)cudaGetLastError();
}
