// K3: complete projective point arithmetic on BN254 G1 (y^2 = x^3 + 3).
//
// Replaces the Pallas kernel of halo2_aes_tpu/ops/pallas_curve.py
// (_make_kernel, _fn): Renes-Costello-Batina 2015/1060 algorithm 7
// (addition) and algorithm 9 (doubling) for a = 0, b3 = 3 * b = 9, in the
// operation order of the plain versions, so projective limbs are
// bit-identical.  The formulas are complete: no branch on identity,
// doubling or negation.
//
// What bounds it on an H100: one addition is 12 Montgomery products
// (~1,540 32-bit multiply-adds) against 576 bytes of int32-limb traffic:
// the integer multiplier binds, about 2:1 over memory.  Alone the adder
// was never the MSM's cost; what its first interface (six equal-shape
// contiguous tensors) forced around it was: slice copies, materialised
// identities, gathers, selects, and one launch per tree level.  So the
// entries here are the shapes the MSM needs:
//  - curve_add: each operand is read in place at row
//    off + (r / inner) * outer + r % inner with r = i % rows, so the two
//    halves of a (G, m) level, a leading slice or one broadcast point need
//    no copy;
//  - curve_fold2: two levels of the pairing tree (node i with i + m/2) in
//    one launch: a thread reads the four leaves i + t*m/4, adds them in
//    registers and writes the two level-1 nodes and the level-2 node (the
//    Fenwick extraction reads every level); a leaf is read once, not twice;
//  - curve_add_masked: q is gathered by an int64 row index and replaced by
//    the identity (0, 1, 0) where its mask byte is clear: one Fenwick
//    level a launch;
//  - curve_double: `times` doublings of each point in registers.
// One thread per output row, 128 threads a block.  ptxas (nvcc 12.8,
// sm_90a), registers with no spills: curve_add 108, curve_fold2 178,
// curve_add_masked 104, curve_double 80.  At 2^19 pairs the adder runs
// ~4.3e12 wide multiply-adds a second, about half of the card's nominal
// 32-bit rate if a wide multiply-add takes two dispatch slots.
#include "field.cuh"

struct Pt {
  uint32_t x[8], y[8], z[8];
};

// Three coordinate tensors read in place: row r of the operand is at
// off + (r / inner) * outer + r % inner, r = i % rows
struct Operand {
  const int32_t *x, *y, *z;
  int64_t rows, inner, outer;
};

__device__ __forceinline__ int64_t operand_row(const Operand& o, int64_t i) {
  const int64_t r = o.rows == 1 ? 0 : i % o.rows;
  return o.inner >= o.rows ? r : (r / o.inner) * o.outer + r % o.inner;
}

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

__global__ void __launch_bounds__(128)
curve_add_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                 int32_t* __restrict__ z3, Operand a, Operand b, int64_t n,
                 Modulus m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, q;
  pt_load(p, a.x, a.y, a.z, operand_row(a, i));
  pt_load(q, b.x, b.y, b.z, operand_row(b, i));
  pt_add(p, p, q, m);
  pt_store(x3, y3, z3, i, p);
}

// Level 0 is (G, m) rows; out1 is level 1 (G, m/2), out2 level 2 (G, m/4);
// thread i of group g folds the leaves i + t * m/4.
__global__ void __launch_bounds__(128)
curve_fold2_kernel(int32_t* __restrict__ x1, int32_t* __restrict__ y1,
                   int32_t* __restrict__ z1, int32_t* __restrict__ x2,
                   int32_t* __restrict__ y2, int32_t* __restrict__ z2,
                   const int32_t* __restrict__ x0,
                   const int32_t* __restrict__ y0,
                   const int32_t* __restrict__ z0, int64_t groups, int64_t mq,
                   Modulus m) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= groups * mq) return;
  const int64_t g = t / mq, i = t % mq;
  const int64_t leaf = g * 4 * mq + i;
  const int64_t node1 = g * 2 * mq + i;
  // one adder body run three times (three inlined copies overflow the
  // instruction cache): leaves 0 + 2, leaves 1 + 3, then the two sums
  Pt s0, a, b;
#pragma unroll 1
  for (int step = 0; step < 3; ++step) {
    if (step < 2) {
      pt_load(a, x0, y0, z0, leaf + step * mq);
      pt_load(b, x0, y0, z0, leaf + (step + 2) * mq);
    } else {
      b = s0;  // a still holds the second level-1 node; p + q is symmetric
    }
    pt_add(a, a, b, m);
    if (step == 0) {
      pt_store(x1, y1, z1, node1, a);
      s0 = a;
    } else if (step == 1) {
      pt_store(x1, y1, z1, node1 + mq, a);
    } else {
      pt_store(x2, y2, z2, t, a);
    }
  }
}

__global__ void __launch_bounds__(128)
curve_add_masked_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                        int32_t* __restrict__ z3, Operand a,
                        const int32_t* __restrict__ qx,
                        const int32_t* __restrict__ qy,
                        const int32_t* __restrict__ qz,
                        const int64_t* __restrict__ index,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ one, int64_t n, Modulus m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, q;
  pt_load(p, a.x, a.y, a.z, operand_row(a, i));
  if (mask[i]) {
    pt_load(q, qx, qy, qz, index[i]);
  } else {
    fe_load(one, q.y);
#pragma unroll
    for (int w = 0; w < 8; ++w) q.x[w] = q.z[w] = 0;
  }
  pt_add(p, p, q, m);
  pt_store(x3, y3, z3, i, p);
}

__global__ void __launch_bounds__(128)
curve_double_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                    int32_t* __restrict__ z3, const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const int32_t* __restrict__ z, int64_t n, int times,
                    Modulus m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p;
  pt_load(p, x, y, z, i);
  for (int t = 0; t < times; ++t) pt_double(p, m);
  pt_store(x3, y3, z3, i, p);
}

static unsigned blocks_for(int64_t n) { return (unsigned)((n + 127) / 128); }

static bool operand_ok(const Operand& o) {
  return o.rows >= 1 && o.inner >= 1 && o.outer >= 0;
}

// operands as 3 pointers and (rows, inner, outer) each
extern "C" int curve_add_launch(void* x3, void* y3, void* z3, const void* x1,
                                const void* y1, const void* z1, int64_t rows1,
                                int64_t inner1, int64_t outer1, const void* x2,
                                const void* y2, const void* z2, int64_t rows2,
                                int64_t inner2, int64_t outer2, int64_t n,
                                const uint32_t* p, uint32_t n0, void* stream) {
  Operand a = {(const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1,
               rows1, inner1, outer1};
  Operand b = {(const int32_t*)x2, (const int32_t*)y2, (const int32_t*)z2,
               rows2, inner2, outer2};
  if (n < 1 || !operand_ok(a) || !operand_ok(b)) return (int)cudaErrorInvalidValue;
  curve_add_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, a, b, n, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int curve_fold2_launch(void* x1, void* y1, void* z1, void* x2,
                                  void* y2, void* z2, const void* x0,
                                  const void* y0, const void* z0,
                                  int64_t groups, int64_t m, const uint32_t* p,
                                  uint32_t n0, void* stream) {
  if (groups < 1 || m < 4 || m % 4) return (int)cudaErrorInvalidValue;
  curve_fold2_kernel<<<blocks_for(groups * (m / 4)), 128, 0,
                       (cudaStream_t)stream>>>(
      (int32_t*)x1, (int32_t*)y1, (int32_t*)z1, (int32_t*)x2, (int32_t*)y2,
      (int32_t*)z2, (const int32_t*)x0, (const int32_t*)y0, (const int32_t*)z0,
      groups, m / 4, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int curve_add_masked_launch(
    void* x3, void* y3, void* z3, const void* x1, const void* y1,
    const void* z1, int64_t rows1, const void* qx, const void* qy,
    const void* qz, const void* index, const void* mask, const void* one,
    int64_t n, const uint32_t* p, uint32_t n0, void* stream) {
  Operand a = {(const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1,
               rows1, rows1, 0};
  if (n < 1 || rows1 < 1) return (int)cudaErrorInvalidValue;
  curve_add_masked_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, a, (const int32_t*)qx,
      (const int32_t*)qy, (const int32_t*)qz, (const int64_t*)index,
      (const uint8_t*)mask, (const int32_t*)one, n, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int curve_double_launch(void* x3, void* y3, void* z3, const void* x,
                                   const void* y, const void* z, int64_t n,
                                   int times, const uint32_t* p, uint32_t n0,
                                   void* stream) {
  if (n < 1 || times < 0) return (int)cudaErrorInvalidValue;
  curve_double_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, (const int32_t*)x,
      (const int32_t*)y, (const int32_t*)z, n, times, make_modulus(p, n0));
  return (int)cudaGetLastError();
}
