// G1 point arithmetic shared by K3 (curve_add.cu) and K7 (msm_buckets.cu):
// BN254 G1 (y^2 = x^3 + 3) in homogeneous projective coordinates over Fq,
// Renes-Costello-Batina 2015/1060 for a = 0, b3 = 3 * b = 9, in the
// operation order of the plain PyTorch versions (ops/cuda_curve.py,
// ops/cuda_msm.py), so projective limbs are bit-identical: algorithm 7
// (complete addition, 12 Montgomery products), algorithm 8 (mixed
// addition of an affine point that is not the identity, 11) and
// algorithm 9 (doubling, 8).  No branch on identity, doubling or negation.
#pragma once

#include "field.cuh"

struct Pt {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void pt_load(Pt& p, const int32_t* x, const int32_t* y,
                                        const int32_t* z, int64_t row) {
  fe_load(x + row * 16, p.x);
  fe_load(y + row * 16, p.y);
  fe_load(z + row * 16, p.z);
}

__device__ __forceinline__ void pt_store(int32_t* x, int32_t* y, int32_t* z,
                                         int64_t row, const Pt& p) {
  fe_store(x + row * 16, p.x);
  fe_store(y + row * 16, p.y);
  fe_store(z + row * 16, p.z);
}

__device__ __forceinline__ void fe_mul_b3(uint32_t r[8], const uint32_t a[8],
                                          const Modulus& m) {
  uint32_t a2[8], a4[8], a8[8];
  fe_add(a2, a, a, m);
  fe_add(a4, a2, a2, m);
  fe_add(a8, a4, a4, m);
  fe_add(r, a8, a, m);
}

// r = p + q (algorithm 7); r may be p or q
__device__ __forceinline__ void pt_add(Pt& r, const Pt& p, const Pt& q,
                                       const Modulus& m) {
  uint32_t t0[8], t1[8], t2[8], A[8], B[8], C[8], u[8], v[8];
  fe_mont_mul(t0, p.x, q.x, m);
  fe_mont_mul(t1, p.y, q.y, m);
  fe_mont_mul(t2, p.z, q.z, m);
  fe_add(u, p.x, p.y, m);
  fe_add(v, q.x, q.y, m);
  fe_mont_mul(A, u, v, m);
  fe_add(u, p.y, p.z, m);
  fe_add(v, q.y, q.z, m);
  fe_mont_mul(B, u, v, m);
  fe_add(u, p.x, p.z, m);
  fe_add(v, q.x, q.z, m);
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

  fe_mont_mul(u, t4, y3b, m);
  fe_mont_mul(v, t3, t1m, m);
  fe_sub(r.x, v, u, m);
  fe_mont_mul(u, t1m, z3t, m);
  fe_mont_mul(v, y3b, t0_3, m);
  fe_add(r.y, u, v, m);
  fe_mont_mul(u, z3t, t4, m);
  fe_mont_mul(v, t0_3, t3, m);
  fe_add(r.z, u, v, m);
}

// p = 2 p (algorithm 9)
__device__ __forceinline__ void pt_double(Pt& p, const Modulus& m) {
  uint32_t t0[8], t1[8], t2[8], t3[8], z8[8], t2b[8], y3s[8], t2b3[8], t0m[8];
  uint32_t u[8], v[8];
  fe_mont_mul(t0, p.y, p.y, m);
  fe_mont_mul(t1, p.y, p.z, m);
  fe_mont_mul(t2, p.z, p.z, m);
  fe_mont_mul(t3, p.x, p.y, m);
  fe_add(z8, t0, t0, m);
  fe_add(z8, z8, z8, m);
  fe_add(z8, z8, z8, m);    // 8 Y^2
  fe_mul_b3(t2b, t2, m);    // b3 Z^2
  fe_add(y3s, t0, t2b, m);
  fe_add(u, t2b, t2b, m);
  fe_add(t2b3, u, t2b, m);
  fe_sub(t0m, t0, t2b3, m);
  fe_mont_mul(u, t2b, z8, m);
  fe_mont_mul(p.z, t1, z8, m);
  fe_mont_mul(v, t0m, y3s, m);
  fe_add(p.y, u, v, m);
  fe_mont_mul(u, t0m, t3, m);
  fe_add(p.x, u, u, m);
}

// r = p + (x2, y2, 1) (algorithm 8): complete for any projective p and an
// affine (x2, y2) that is not the identity; r may be p
__device__ __forceinline__ void pt_add_mixed(Pt& r, const Pt& p,
                                             const uint32_t x2[8],
                                             const uint32_t y2[8],
                                             const Modulus& m) {
  uint32_t t0[8], t1[8], t3[8], t4[8], y3[8], u[8], v[8];
  fe_mont_mul(t0, p.x, x2, m);
  fe_mont_mul(t1, p.y, y2, m);
  fe_add(u, x2, y2, m);
  fe_add(v, p.x, p.y, m);
  fe_mont_mul(t3, u, v, m);
  fe_mont_mul(t4, y2, p.z, m);
  fe_mont_mul(y3, x2, p.z, m);
  fe_add(u, t0, t1, m);
  fe_sub(t3, t3, u, m);     // X1 Y2 + X2 Y1
  fe_add(t4, t4, p.y, m);   // Y1 + Y2 Z1
  fe_add(y3, y3, p.x, m);   // X1 + X2 Z1
  fe_add(u, t0, t0, m);
  fe_add(t0, u, t0, m);     // 3 X1 X2
  uint32_t t2[8], z3[8];
  fe_mul_b3(t2, p.z, m);    // b3 Z1
  fe_add(z3, t1, t2, m);
  fe_sub(t1, t1, t2, m);
  fe_mul_b3(v, y3, m);      // b3 (X1 + X2 Z1)
  fe_mont_mul(u, t4, v, m);
  fe_mont_mul(t2, t3, t1, m);
  fe_sub(r.x, t2, u, m);
  fe_mont_mul(u, v, t0, m);
  fe_mont_mul(t2, t1, z3, m);
  fe_add(r.y, t2, u, m);
  fe_mont_mul(u, t0, t3, m);
  fe_mont_mul(t2, z3, t4, m);
  fe_add(r.z, t2, u, m);
}
